"""The port's host-verified property path (stateright_tpu_torch/xla.py:
the hv compaction in the superstep, the block's candidate accumulator and
``_confirm_hv_candidates``) and the serializer's sampled one-sided pass
(``semantics/device.py`` ``pattern_limit``), against the reference package
on the CPU:

- ``interleaving_tids(T, slots, limit)`` equals the reference's row for
  row, sampled and full;
- ``PackedSingleCopyRegister(2, 2, device_exact=False)``, a bounded 3c/1s
  ``device_exact=False`` run whose sampled pass flags rows the host clears,
  and the reference test's conservative-predicate model equal the
  reference engine in counts, discoveries and ``hv_stats``, on the fused
  path and on one level per dispatch;
- flagged rows past ``host_verified_cap`` with none confirmed raise, and a
  model's bad declarations raise.

Everything is exact (integer work)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.models import single_copy_register as ref
from stateright_tpu.semantics import device as ref_dev
from stateright_tpu_torch.core import Expectation, Model, Property
from stateright_tpu_torch.models import single_copy_register as port
from stateright_tpu_torch.ops.words import from_u32
from stateright_tpu_torch.semantics import device as port_dev

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


@pytest.mark.parametrize("T, slots, limit", [
    (2, 3, None), (3, 3, None), (3, 3, 64), (4, 3, 20_000), (5, 3, 1_000), (3, 3, 10_000),
])
def test_interleaving_tids_equal_the_reference(T, slots, limit):
    got = port_dev.interleaving_tids(T, slots, limit)
    assert np.array_equal(got, ref_dev.interleaving_tids(T, slots, limit))
    assert got.dtype == np.int8


def test_sampled_pass_equals_the_reference_and_is_one_sided():
    """At 3c/1s with 8 sampled patterns: the port's pass equals ``jax.vmap``
    of the reference's on reachable states, and where it says serializable
    so does the exact pass."""
    m = port.PackedSingleCopyRegister(3, 1, device_exact=False, pattern_limit=8)
    r = ref.PackedSingleCopyRegister(3, 1, device_exact=False, pattern_limit=8)
    deepest = [s for _, s in _bfs(m._inner, 3000)][-600:]
    words = from_u32(np.stack([m.pack(s) for s in deepest]), "cpu")
    got = m.device_linearizable_register(words, 8)
    want = jax.vmap(lambda w: r.device_linearizable_register(w, 8))(
        jnp.asarray(words.numpy().astype(np.uint32)))
    assert np.array_equal(got.numpy(), np.asarray(want))
    exact = m.device_linearizable_register(words)
    assert not (got & ~exact).any()
    assert (exact & ~got).any()  # the sample misses some serializations


def _bfs(model, limit):
    """``(depth, state)`` of the first ``limit`` states BFS reaches."""
    frontier = [(1, s) for s in model.init_states()]
    seen = {s for _, s in frontier}
    out = list(frontier)
    while frontier and len(out) < limit:
        depth, state = frontier.pop(0)
        for _, nxt in model.next_steps(state):
            if nxt not in seen:
                seen.add(nxt)
                frontier.append((depth + 1, nxt))
                out.append((depth + 1, nxt))
    return out[:limit]


class ConservativeSingleCopy(port.PackedSingleCopyRegister):
    """Both packages' conservative device predicate (the reference's
    ``tests/test_host_verified.py``): certainly linearizable iff unpoisoned
    with no completed read; every other row goes to the host."""

    host_verified_properties = frozenset({"linearizable"})

    def packed_properties(self, words):
        props = super().packed_properties(words).clone()
        props[:, 0] = self._hist.valid_with_no_return_geq(words, 1)
        return props


class RefConservativeSingleCopy(ref.PackedSingleCopyRegister):
    host_verified_properties = frozenset({"linearizable"})

    def packed_properties(self, words):
        props = super().packed_properties(words)
        return props.at[0].set(self._hist.valid_with_no_return_geq(words, 1))


CASES = {
    # (port model, reference model, max depth, spawn_xla keywords); the
    # first two run on both dispatch paths, the conservative ones fused.
    "2c2s": (lambda: port.PackedSingleCopyRegister(2, 2, device_exact=False),
             lambda: ref.PackedSingleCopyRegister(2, 2, device_exact=False), None, {}),
    "3c1s_sampled": (
        lambda: port.PackedSingleCopyRegister(3, 1, device_exact=False, pattern_limit=2),
        lambda: ref.PackedSingleCopyRegister(3, 1, device_exact=False, pattern_limit=2), 7,
        dict(frontier_capacity=256)),
    "conservative_2c1s": (lambda: ConservativeSingleCopy(2, 1), lambda: RefConservativeSingleCopy(2, 1),
                          None, dict(host_verified_cap=1024)),
    "conservative_2c2s": (lambda: ConservativeSingleCopy(2, 2), lambda: RefConservativeSingleCopy(2, 2),
                          None, dict(host_verified_cap=1024)),
}


def _run(model, depth, **kw):
    b = model.checker()
    if depth:
        b = b.target_max_depth(depth)
    return b.spawn_xla(**kw).join()


def _summary(c):
    return (
        c.state_count(), c.unique_state_count(), c.max_depth(),
        [(r["depth"], r["frontier"], r["generated"], r["unique"]) for r in c.level_log],
        {k: v for k, v in c.hv_stats.items() if k != "host_sec"},
        {name: len(path) for name, path in c.discoveries().items()},
    )


@pytest.mark.parametrize("case, levels_per_dispatch", [
    (case, lpd) for case in sorted(CASES) for lpd in (32, 1)
    if lpd == 32 or not case.startswith("conservative")
])
def test_host_verified_path_equals_the_reference(case, levels_per_dispatch):
    build, build_ref, depth, kw = CASES[case]
    r = _run(build_ref(), depth, levels_per_dispatch=levels_per_dispatch, **kw)
    c = _run(build(), depth, levels_per_dispatch=levels_per_dispatch, **kw, **CPU)
    assert _summary(c) == _summary(r)
    assert c.hv_stats["host_checked"] == c.hv_stats["cleared"] + c.hv_stats["confirmed"]
    if levels_per_dispatch > 1:
        assert c.dispatch_log == r.dispatch_log
    if case == "3c1s_sampled":
        assert c.hv_stats["cleared"] > 0  # the sampled pass flagged rows the host cleared
    for name, path in c.discoveries().items():
        c.assert_discovery(name, path.into_actions())
    if "linearizable" in c.discoveries():
        last = c.discoveries()["linearizable"].last_state()
        assert last.history.serialized_history() is None
    m = c.metrics()
    assert m["hv"] == c.hv_stats


def test_flagged_rows_past_the_cap_with_none_confirmed_raise():
    checker = ConservativeSingleCopy(2, 1).checker().spawn_xla(host_verified_cap=1, **CPU)
    with pytest.raises(RuntimeError, match="candidate states for host-verified property"):
        checker.join()


class _Counter(Model):
    state_words = 1
    max_actions = 1

    def __init__(self, hv, expectation=Expectation.ALWAYS):
        self.host_verified_properties = frozenset(hv)
        self._expectation = expectation

    def init_states(self):
        return [0]

    def actions(self, state, actions):
        actions.append(1)

    def next_state(self, state, action):
        return state + 1

    def properties(self):
        return [Property(self._expectation, "small", lambda _, s: s < 3)]

    def pack(self, state):
        return np.array([state], np.uint32)

    def unpack(self, words):
        return int(words[0])

    def packed_init(self):
        return np.array([[0]], np.uint32)

    def packed_step(self, words):
        return (words + 1)[:, None, :], torch.ones((words.shape[0], 1), dtype=torch.bool)

    def packed_properties(self, words):
        return words < 3


def test_declarations_are_checked():
    with pytest.raises(ValueError, match="not in properties"):
        _Counter({"large"}).checker().spawn_xla(**CPU)
    with pytest.raises(ValueError, match="eventually"):
        _Counter({"small"}, Expectation.EVENTUALLY).checker().spawn_xla(**CPU)
    # A conservative predicate that flags every row: the host confirms the
    # first real violation, in frontier order.
    c = _Counter({"small"}).checker().target_max_depth(6).spawn_xla(**CPU).join()
    assert [s for s in c.discoveries()["small"].into_states()] == [0, 1, 2, 3]
    assert c.hv_stats["confirmed"] == 1
    rows = from_u32(np.array([[2], [3]], np.uint32), "cpu")
    assert c.model().packed_properties(rows)[:, 0].tolist() == [True, False]
