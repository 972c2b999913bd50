"""The port's batched device serializer
(stateright_tpu_torch/semantics/device.py) against the reference's
(stateright_tpu/semantics/device.py, ``jax.vmap`` over states) and the host
``LinearizabilityTester``: on every reachable state of Paxos 2c/3s, on a
random-walk sample of Paxos 3c/3s (1,680 interleavings), and on those
samples with their recorded returns scrambled, so that many histories are
not linearizable. Exact (bool results)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.models.paxos import PackedPaxos as RefPaxos
from stateright_tpu.semantics import device as ref_dev
from stateright_tpu_torch.models.paxos import PackedPaxos
from stateright_tpu_torch.semantics import device as port_dev
from stateright_tpu_torch.ops.words import from_u32, to_u32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test process: the suite runs several test
    processes on one machine, and torch's default of a thread per core in
    each oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def reachable_words(model):
    """Every reachable packed state of ``model``, by BFS over its batched
    ``packed_step`` on the CPU."""
    frontier = np.asarray(model.packed_init(), np.uint32)
    seen = {r.tobytes() for r in frontier}
    out = [frontier]
    while len(frontier):
        nxt, valid, ovf = model.packed_step(from_u32(frontier, "cpu"))
        assert not ovf.any()
        succ = np.unique(to_u32(nxt[valid]), axis=0)
        fresh = [r for r in succ if r.tobytes() not in seen]
        seen.update(r.tobytes() for r in fresh)
        frontier = np.stack(fresh) if fresh else np.zeros((0, model.state_words), np.uint32)
        out.append(frontier)
    return np.concatenate(out)


def walk_sample(model, n, seed=11, walk=6000):
    rng = random.Random(seed)
    init = model.init_states()[0]
    sample = {init}
    cur = init
    for _ in range(walk):
        steps = model.next_steps(cur)
        if not steps:
            cur = init
            continue
        _, cur = rng.choice(steps)
        sample.add(cur)
        if len(sample) >= n:
            break
    return sorted(sample, key=repr)


def scrambled(model, words, seed):
    """``words`` with each completed op's return code replaced at random
    (WriteOk, or ReadOk of any value): many such histories admit no
    serialization."""
    rng = np.random.default_rng(seed)
    L = model._layout
    out = []
    for row in words:
        f = L.unpack(row)
        for t in range(model.C):
            f[f"h{t}_ret"] = [int(rng.integers(1, model.C + 3)) if r else 0 for r in f[f"h{t}_ret"]]
        out.append(L.pack(**f))
    return np.stack(out)


def ref_serializable(model, words, real_time=True):
    fn = jax.jit(jax.vmap(lambda w: ref_dev.device_serializable(
        model._hist, w, ref_dev.DeviceRegister(), real_time=real_time)))
    return np.asarray(fn(jnp.asarray(words)))


def port_serializable(model, words, real_time=True):
    return port_dev.device_serializable(
        model._hist, from_u32(words, "cpu"), port_dev.DeviceRegister(), real_time=real_time
    ).numpy()


def host_linearizable(model, words):
    cache = {}
    out = []
    for row in words:
        key = row.tobytes()
        if key not in cache:
            cache[key] = model.unpack(row).history.serialized_history() is not None
        out.append(cache[key])
    return np.asarray(out)


@pytest.fixture(scope="module")
def paxos2():
    m = PackedPaxos(2, 3)
    words = reachable_words(m)
    assert len(words) == 16_668
    return m, RefPaxos(2, 3), words


def test_every_reachable_paxos_2c_state(paxos2):
    m, r, words = paxos2
    got = port_serializable(m, words)
    assert np.array_equal(got, ref_serializable(r, words))
    assert np.array_equal(got, host_linearizable(m, words))
    assert got.all()  # Paxos is linearizable


def test_scrambled_paxos_2c_histories(paxos2):
    m, r, words = paxos2
    words = scrambled(m, words[::7], seed=1)
    got = port_serializable(m, words)
    assert np.array_equal(got, ref_serializable(r, words))
    assert np.array_equal(got, host_linearizable(m, words))
    assert 0 < got.sum() < len(got)
    assert np.array_equal(port_serializable(m, words, False), ref_serializable(r, words, False))


def test_paxos_3c_sample_and_its_scrambled_histories():
    m, r = PackedPaxos(3, 3), RefPaxos(3, 3)
    assert port_dev.pattern_count(3, 2) == 1_680
    states = walk_sample(m._inner, 300)
    words = np.stack([m.pack(s) for s in states])
    mixed = np.concatenate([words, scrambled(m, words, seed=2)])
    got = port_serializable(m, mixed)
    assert np.array_equal(got, ref_serializable(r, mixed))
    assert np.array_equal(got, host_linearizable(m, mixed))
    assert got[: len(words)].all() and not got[len(words):].all()
    assert np.array_equal(port_serializable(m, mixed, False), ref_serializable(r, mixed, False))


def test_frontier_chunks_do_not_change_the_answer(monkeypatch, paxos2):
    m, _, words = paxos2
    words = scrambled(m, words[:500], seed=3)
    whole = port_serializable(m, words)
    monkeypatch.setattr(port_dev, "SERIAL_LANES", 20 * 7)  # 7 rows a chunk
    assert np.array_equal(port_serializable(m, words), whole)


def test_tables_match_the_reference():
    for T, slots in ((2, 3), (3, 3)):
        for a, b in zip(port_dev.interleaving_tables(T, slots), ref_dev.interleaving_tables(T, slots)):
            assert np.array_equal(a, b)
    assert [port_dev.pattern_count(t, 2) for t in (2, 3, 4)] == [20, 1_680, 369_600]
