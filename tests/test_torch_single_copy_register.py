"""The single-copy register in the port
(stateright_tpu_torch/models/single_copy_register.py) against the reference
package's (stateright_tpu/models/single_copy_register.py) on the CPU:

- the codec round-trips every reachable state, and both packages pack the
  reachable set to the same words;
- ``packed_step`` (valid, overflow and every enabled successor) and
  ``packed_properties`` equal ``jax.vmap`` of the reference's on every
  reachable state, unordered at 2c/1s and 2c/2s and ordered at 2c;
- the engine's counts: 93 unique at 2c/1s (single-copy-register.rs:110),
  57 under sequential consistency, the linearizability counterexample at
  2c/2s at the reference's depth, ``bench.py``'s ``EXPECTED_MATRIX`` 6,778 /
  4,243 at 3c/1s, and the ordered variant's counts equal to the reference
  object model's BFS.

Everything is exact (integer work)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.actor import Network as RefNetwork
from stateright_tpu.models import single_copy_register as ref
from stateright_tpu_torch.models import single_copy_register as port
from stateright_tpu_torch.ops.words import from_u32, to_u32

CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test process: the suite runs several test
    processes on one machine, and torch's default of a thread per core in
    each oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def reachable(model):
    """Every reachable object state of ``model``, by BFS over
    ``next_steps``, in discovery order."""
    seen = list(model.init_states())
    index = set(seen)
    i = 0
    while i < len(seen):
        for _, nxt in model.next_steps(seen[i]):
            if nxt not in index:
                index.add(nxt)
                seen.append(nxt)
        i += 1
    return seen


MODELS = {
    "2c1s": (lambda: port.PackedSingleCopyRegister(2, 1), lambda: ref.PackedSingleCopyRegister(2, 1)),
    "2c2s": (lambda: port.PackedSingleCopyRegister(2, 2), lambda: ref.PackedSingleCopyRegister(2, 2)),
    "2c1s_sequential": (
        lambda: port.PackedSingleCopyRegister(2, 1, consistency="sequential"),
        lambda: ref.PackedSingleCopyRegister(2, 1, consistency="sequential"),
    ),
    "ordered": (lambda: port.PackedSingleCopyRegisterOrdered(2),
                lambda: ref.PackedSingleCopyRegisterOrdered(2)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_codec_round_trips_every_reachable_state(name):
    m, r = (build() for build in MODELS[name])
    states = reachable(m._inner)
    words = np.stack([m.pack(s) for s in states])
    for s, row in zip(states, words):
        assert m.unpack(row) == s
    # Distinct states, distinct words; the same words as the reference's.
    assert len({row.tobytes() for row in words}) == len(states)
    ref_words = np.stack([r.pack(s) for s in reachable(r._inner)])
    assert sorted(row.tobytes() for row in words) == sorted(row.tobytes() for row in ref_words)
    assert m.state_words == r.state_words and m.max_actions == r.max_actions


@pytest.mark.parametrize("name", sorted(MODELS))
def test_step_and_properties_equal_the_reference_on_every_reachable_state(name):
    m, r = (build() for build in MODELS[name])
    words = np.stack([r.pack(s) for s in reachable(r._inner)])
    want_next, want_valid, want_ovf = (
        np.asarray(x) for x in jax.jit(jax.vmap(r.packed_step))(jnp.asarray(words)))
    want_props = np.asarray(jax.jit(jax.vmap(r.packed_properties))(jnp.asarray(words)))
    nxt, valid, ovf = m.packed_step(from_u32(words, "cpu"))
    assert np.array_equal(valid.numpy(), want_valid)
    assert np.array_equal(ovf.numpy(), want_ovf)
    assert not want_ovf.any()
    assert np.array_equal(to_u32(nxt)[want_valid], want_next[want_valid])
    assert np.array_equal(m.packed_properties(from_u32(words, "cpu")).numpy(), want_props)
    # The properties are the exact host conditions on every state.
    for row, props in zip(words, want_props):
        state = m.unpack(row)
        assert [bool(p.condition(m, state)) for p in m.properties()] == props.tolist()


@pytest.mark.parametrize("consistency, unique", [("linearizable", 93), ("sequential", 57)])
def test_one_server_full_coverage(consistency, unique):
    c = port.PackedSingleCopyRegister(2, 1, consistency=consistency).checker().spawn_xla(**CPU).join()
    assert c.unique_state_count() == unique
    c.assert_properties()
    path = c.discoveries()["value chosen"]
    c.assert_discovery("value chosen", path.into_actions())
    assert any(
        isinstance(env.msg, port.reg.GetOk) and env.msg.value is not None
        for env in path.last_state().network.iter_deliverable()
    )


def test_two_servers_find_the_linearizability_counterexample():
    c = port.PackedSingleCopyRegister(2, 2).checker().spawn_xla(**CPU).join()
    witness = c.discoveries()["linearizable"]
    assert witness.last_state().history.serialized_history() is None
    c.assert_discovery("linearizable", witness.into_actions())
    oracle = ref.single_copy_register_model(2, 2).checker().spawn_bfs().join()
    assert len(witness) == len(oracle.discoveries()["linearizable"])
    # The port's own host BFS gives the same shortest witness.
    own = port.single_copy_register_model(2, 2).checker().spawn_bfs().join()
    assert len(witness) == len(own.discoveries()["linearizable"])


def test_three_clients_expected_matrix():
    """``bench.py``'s ``EXPECTED_MATRIX["single-copy-register 3c/1s
    packed"]``, on the default fused path with the candidate ladder."""
    c = port.PackedSingleCopyRegister(3, 1).checker().spawn_xla(**CPU).join()
    assert (c.state_count(), c.unique_state_count()) == (6_778, 4_243)
    c.assert_properties()


def test_ordered_variant_equals_the_reference():
    c = port.PackedSingleCopyRegisterOrdered(2).checker().spawn_xla(**CPU).join()
    oracle = ref.single_copy_register_model(2, 1, RefNetwork.new_ordered()).checker().spawn_bfs().join()
    assert (c.state_count(), c.unique_state_count()) == (
        oracle.state_count(), oracle.unique_state_count()) == (121, 93)
    c.assert_properties()
    oracle.assert_properties()
    assert len(c.discoveries()["value chosen"]) == len(oracle.discoveries()["value chosen"])
    # The port's own host BFS gives the same counts and witness length.
    own = port.single_copy_register_model(2, 1, port.Network.new_ordered()).checker().spawn_bfs().join()
    assert (own.state_count(), own.unique_state_count()) == (121, 93)
    assert len(own.discoveries()["value chosen"]) == len(oracle.discoveries()["value chosen"])


def test_exactness_gate():
    """Up to 4 clients the serializer is exact; past the budget, or on
    request, the model declares the property host-verified."""
    assert not hasattr(port.PackedSingleCopyRegister(3, 1), "host_verified_properties")
    sampled = port.PackedSingleCopyRegister(3, 1, device_exact=False, pattern_limit=64)
    assert sampled.host_verified_properties == frozenset({"linearizable"})
    assert port.PackedSingleCopyRegister(5, 1).host_verified_properties == frozenset({"linearizable"})
    with pytest.raises(ValueError, match="exact device budget"):
        port.PackedSingleCopyRegister(5, 1, device_exact=True)
    with pytest.raises(ValueError, match="2-client"):
        port.PackedSingleCopyRegisterOrdered(3)
