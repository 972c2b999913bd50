"""Packed Paxos in the port (stateright_tpu_torch/models/paxos.py) against
the reference package's (stateright_tpu/models/paxos.py) on the CPU.

- the codec round-trips, and both packages' codecs agree word for word;
- 2c/3s: ``packed_step`` (next, valid, ovf) and ``packed_properties`` are
  bit-equal to ``jax.jit(jax.vmap(...))`` of the reference on sampled
  states;
- 3c/3s (W=46, A=672): the successor sets equal the reference object
  model's ``next_steps`` packed by the reference's ``pack`` (no JAX jit at
  that width: an XLA:CPU compile there takes minutes);
- 2c/3s to depth 9 on the port's engine equals the reference engine level
  by level, in its dispatch log and its discoveries.

The engine's pinned counts are in ``test_torch_paxos_engine.py``.
Everything is exact (integer work)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.actor.network import Envelope as RefEnvelope
from stateright_tpu.models.paxos import PackedPaxos as RefPaxos
from stateright_tpu_torch.models.paxos import PackedPaxos
from stateright_tpu_torch.ops.words import from_u32, to_u32

CPU = dict(device="cpu")
#: The reference engine's dispatch that the port's default reproduces: the
#: planes engine with shrink-exit on. Its candidate ladder adds no dispatch,
#: so one rung gives the port's dispatch log at any rung count.
REF_PLANES = dict(dedup="sorted", cand_ladder=1, shrink_exit="on")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test process: the suite runs several test
    processes on one machine, and torch's default of a thread per core in
    each oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def walk_sample(model, n, seed=7, walk=4000):
    """Random-walk sample of reachable object states (mixed depths)."""
    rng = random.Random(seed)
    init = model.init_states()[0]
    sample = {init}
    cur = init
    for _ in range(walk):
        steps = list(model.next_steps(cur))
        if not steps:
            cur = init
            continue
        _, cur = rng.choice(steps)
        sample.add(cur)
        if len(sample) >= n:
            break
    return sorted(sample, key=repr)


@pytest.mark.parametrize("clients,n", [(2, 150), (3, 100)])
def test_codec_round_trips_and_agrees_with_the_reference(clients, n):
    m, r = PackedPaxos(clients, 3), RefPaxos(clients, 3)
    assert (m.state_words, m.max_actions) == (r.state_words, r.max_actions)
    assert m._layout.fields == r._layout.fields
    assert np.array_equal(m.packed_init(), r.packed_init())
    for s in walk_sample(m._inner, n):
        words = m.pack(s)
        assert m.unpack(words) == s
        assert np.array_equal(r.pack(r.unpack(words)), words)


def test_2c_step_and_properties_bit_equal_to_the_reference():
    r, m = RefPaxos(2, 3), PackedPaxos(2, 3)
    words = np.stack([r.pack(s) for s in walk_sample(r._inner, 150)])
    nxt, valid, ovf = jax.jit(jax.vmap(r.packed_step))(jnp.asarray(words))
    props = jax.jit(jax.vmap(r.packed_properties))(jnp.asarray(words))
    pn, pv, po = m.packed_step(from_u32(words, "cpu"))
    assert np.array_equal(to_u32(pn), np.asarray(nxt))  # every slot, enabled or not
    assert np.array_equal(pv.numpy(), np.asarray(valid))
    assert np.array_equal(po.numpy(), np.asarray(ovf))
    assert np.array_equal(m.packed_properties(from_u32(words, "cpu")).numpy(), np.asarray(props))
    assert 0 < pv.sum() and not po.any()


def test_3c_successors_equal_the_reference_object_model():
    r, m = RefPaxos(3, 3), PackedPaxos(3, 3)
    assert (m.state_words, m.max_actions) == (46, 672)
    states = walk_sample(r._inner, 100)
    words = np.stack([r.pack(s) for s in states])
    nxt, valid, ovf = m.packed_step(from_u32(words, "cpu"))
    nxt, valid = to_u32(nxt), valid.numpy()
    assert not ovf.any()
    for i, s in enumerate(states):
        want = {}
        for action, ns in r._inner.next_steps(s):
            want[r._env_code[RefEnvelope(action.src, action.dst, action.msg)]] = r.pack(ns)
        assert set(np.flatnonzero(valid[i])) == set(want), i
        for code, ns in want.items():
            assert np.array_equal(nxt[i, code], ns), (i, code)
    props = m.packed_properties(from_u32(words, "cpu")).numpy()
    assert props[:, 0].all()
    assert np.array_equal(props[:, 1], [r._inner.property("value chosen").condition(None, s) for s in states])


@pytest.fixture(scope="module")
def ref_depth9():
    return RefPaxos(2, 3).checker().target_max_depth(9).spawn_xla(**REF_PLANES).join()


def _levels(c):
    return [(r["depth"], r["frontier"], r["generated"], r["unique"]) for r in c.level_log]


@pytest.mark.parametrize("levels_per_dispatch", [32, 1])
def test_2c_depth_9_equals_the_reference_engine(ref_depth9, levels_per_dispatch):
    r = ref_depth9
    c = PackedPaxos(2, 3).checker().target_max_depth(9).spawn_xla(
        levels_per_dispatch=levels_per_dispatch, **CPU).join()
    assert (c.state_count(), c.unique_state_count(), c.max_depth()) == (
        r.state_count(), r.unique_state_count(), r.max_depth()) == (1_772, 1_052, 9)
    assert _levels(c) == _levels(r)
    if levels_per_dispatch > 1:
        assert c.dispatch_log == r.dispatch_log
    want, got = r.discoveries(), c.discoveries()
    assert set(got) == set(want)
    for name in want:
        rm, pm = r.model(), c.model()
        assert [pm.pack(s).tolist() for s in got[name].into_states()] == [
            rm.pack(s).tolist() for s in want[name].into_states()]
