"""Increment and increment-lock in the port
(stateright_tpu_torch/models/{increment,increment_lock}.py) against the
reference package's on the CPU:

- both packages pack every reachable state to the same words, and
  ``packed_step`` and ``packed_properties`` equal ``jax.vmap`` of the
  reference's on every reachable state at 3 threads;
- the counts: (61, 61) for increment-lock at 3 threads (``bench.py``
  ``EXPECTED_MATRIX``) through ``spawn_xla``, 13 unique states for the full
  space at 2 threads (increment.rs:31-105) on the host and the GPU engine,
  13 -> 8 with the host ``symmetry()`` on ``spawn_dfs``, and the ``fin``
  witness as long as the reference's;
- the device symmetry (``packed_representative``, ``symmetry_spec`` and
  ``symmetry().spawn_xla()``) equal to the reference's;
- the command line's host subcommands, and the one-line errors of what
  waits for a later slice.

Everything is exact (integer work)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.models import increment as ref_inc
from stateright_tpu.models import increment_lock as ref_lock
from stateright_tpu_torch.core import Property
from stateright_tpu_torch.models import increment as inc
from stateright_tpu_torch.models import increment_lock as lock
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
    "increment": (inc.PackedIncrement, ref_inc.PackedIncrement),
    "increment_lock": (lock.PackedIncrementLock, ref_lock.PackedIncrementLock),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_codec_equals_the_references(name):
    m, r = (cls(3) for cls in MODELS[name])
    assert (m.state_words, m.max_actions) == (r.state_words, r.max_actions) == (3, 3)
    states = reachable(m)
    words = np.stack([m.pack(s) for s in states])
    assert [m.unpack(row) for row in words] == states
    ref_words = np.stack([r.pack(s) for s in reachable(r)])
    assert np.array_equal(words, ref_words)
    assert np.array_equal(m.packed_init(), r.packed_init())


@pytest.mark.parametrize("name", sorted(MODELS))
def test_step_and_properties_equal_the_reference_on_every_reachable_state(name):
    m, r = (cls(3) for cls in MODELS[name])
    words = np.stack([r.pack(s) for s in reachable(r)])
    want_next, want_valid = (np.asarray(x) for x in jax.vmap(r.packed_step)(jnp.asarray(words)))
    want_props = np.asarray(jax.vmap(r.packed_properties)(jnp.asarray(words)))
    nxt, valid = m.packed_step(from_u32(words, "cpu"))
    assert nxt.shape == (len(words), 3, 3) and valid.dtype == torch.bool
    assert np.array_equal(valid.numpy(), want_valid)
    assert np.array_equal(to_u32(nxt)[want_valid], want_next[want_valid])
    assert np.array_equal(m.packed_properties(from_u32(words, "cpu")).numpy(), want_props)
    # Every enabled slot is the object model's successor of its thread.
    for row, succ, ok in zip(words, to_u32(nxt), valid.numpy()):
        steps = {a.thread: s for a, s in m.next_steps(m.unpack(row))}
        assert {k: m.unpack(succ[k]) for k in np.flatnonzero(ok)} == steps


def test_increment_lock_three_threads_expected_matrix():
    c = lock.PackedIncrementLock(3).checker().spawn_xla(**CPU).join()
    assert (c.state_count(), c.unique_state_count()) == (61, 61)
    c.assert_properties()
    host = lock.IncrementLock(3).checker().spawn_bfs().join()
    assert (host.state_count(), host.unique_state_count()) == (61, 61)


class _FullSpace:
    """An unreachable ``sometimes`` property in place of ``fin``, so that
    the search exhausts the space (as the reference's tests do)."""

    def properties(self):
        return [Property.sometimes("unreachable", lambda _m, _s: False)]

    def packed_properties(self, words):
        return torch.zeros((words.shape[0], 1), dtype=torch.bool, device=words.device)


class _IncrementFull(_FullSpace, inc.PackedIncrement):
    pass


def test_increment_full_space_and_symmetry():
    assert _IncrementFull(2).checker().spawn_bfs().join().unique_state_count() == 13
    assert _IncrementFull(2).checker().spawn_xla(**CPU).join().unique_state_count() == 13
    assert _IncrementFull(2).checker().symmetry().spawn_dfs().join().unique_state_count() == 8
    sym = inc.Increment(2).checker().symmetry().spawn_dfs().join()
    assert "fin" in sym.discoveries()


def test_increment_fin_witness_is_as_long_as_the_references():
    dev = inc.PackedIncrement(2).checker().spawn_xla(**CPU).join()
    want = ref_inc.Increment(2).checker().spawn_bfs().join().discoveries()["fin"]
    host = inc.Increment(2).checker().spawn_bfs().join().discoveries()["fin"]
    witness = dev.discoveries()["fin"]
    assert len(witness) == len(want) == len(host) == 4
    final = witness.last_state()
    assert sum(1 for _t, pc in final.s if pc == 3) != final.i
    dev.assert_discovery("fin", witness.into_actions())


def test_increment_lock_symmetry_agrees_on_properties():
    plain = lock.IncrementLock(3).checker().spawn_dfs().join()
    sym = lock.IncrementLock(3).checker().symmetry().spawn_dfs().join()
    ref_sym = ref_lock.IncrementLock(3).checker().symmetry().spawn_dfs().join()
    plain.assert_properties()
    sym.assert_properties()
    assert sym.unique_state_count() == ref_sym.unique_state_count() < plain.unique_state_count()


@pytest.mark.parametrize("module", [inc, lock])
def test_command_line(module, capsys):
    module.main(["check-host", "2"])
    module.main(["check-sym", "2"])
    module.main([])
    out = capsys.readouterr().out
    assert out.count("Done.") == 2 and "USAGE:" in out and "symmetry reduction" in out
    with pytest.raises(NotImplementedError, match="A10"):
        module.main(["explore"])


@pytest.mark.parametrize("cls,ref_cls", [(inc.PackedIncrement, ref_inc.PackedIncrement),
                                         (lock.PackedIncrementLock, ref_lock.PackedIncrementLock)])
def test_device_symmetry_equals_the_reference(cls, ref_cls):
    """The device symmetry at 3 threads gives the reference's results:
    ``packed_representative`` on every reachable state, the
    ``symmetry_spec``'s tag, and ``checker().symmetry().spawn_xla()``'s
    counts, tag and discoveries."""
    m, ref = cls(3), ref_cls(3)
    rows = np.stack([m.pack(s) for s in reachable(m)])
    got = to_u32(m.packed_representative(from_u32(rows, "cpu")))
    want = np.asarray(jax.vmap(ref.packed_representative)(jnp.asarray(rows)))
    np.testing.assert_array_equal(got, want)
    assert m.symmetry_spec.spec_hash() == ref.symmetry_spec.spec_hash()
    dev = m.checker().symmetry().spawn_xla(**CPU).join()
    want_run = ref.checker().symmetry().spawn_xla(dedup="sorted").join()
    assert dev.metrics()["symmetry"] == want_run.metrics()["symmetry"]
    assert (dev.state_count(), dev.unique_state_count(), dev.max_depth()) == (
        want_run.state_count(), want_run.unique_state_count(), want_run.max_depth())
    assert sorted(dev.discoveries()) == sorted(want_run.discoveries())
    for name, path in dev.discoveries().items():
        assert len(path) == len(want_run.discoveries()[name])
        dev.assert_discovery(name, path.into_actions())
