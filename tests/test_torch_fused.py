"""The port's fused dispatch (``levels_per_dispatch`` > 1, the default) on
the CPU, against the reference package's fused dispatch and the port's
one-level path: counts, per-level counts, depth, witness paths and the
dispatch log; overflow, shrink-exit and target exits of a block; the gated
level's dead-level invariance and its freedom from host reads; capacity
hints; the launch counters of graph replays. Everything is exact."""

from dataclasses import astuple

import pytest
import torch

from stateright_tpu import xla as ref_xla
from stateright_tpu.models import two_phase_commit as ref
from stateright_tpu_torch import graphs
from stateright_tpu_torch import xla as port_xla
from stateright_tpu_torch.graphs import S
from stateright_tpu_torch.models import two_phase_commit as port
from stateright_tpu_torch.models.paxos import PackedPaxos
from stateright_tpu_torch.ops import _cuda
from stateright_tpu_torch.ops import sortedset as port_ss
from stateright_tpu_torch.ops.compact import compact
from stateright_tpu_torch.ops.merge import merge_insert
from stateright_tpu_torch.ops.words import DTYPE

CPU = dict(device="cpu")
EXPECTED_2PC = {3: (1_146, 288), 4: (8_258, 1_568), 5: (58_146, 8_832)}
#: The reference's planes engine with the port's block: one candidate rung,
#: shrink-exit on.
REF_PLANES = dict(dedup="sorted", cand_ladder=1, shrink_exit="on")
TINY = dict(frontier_capacity=16, table_capacity=16)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test process: the suite runs several test
    processes on one machine, and torch's default of a thread per core in
    each oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_FUSED = {}


def _fused(rm):
    """The port's default block at rm on the CPU, run once for the module:
    several tests read the same finished run (none mutates it)."""
    if rm not in _FUSED:
        _FUSED[rm] = port.PackedTwoPhaseSys(rm).checker().spawn_xla(**CPU).join()
    return _FUSED[rm]


def _levels(checker, keys=("depth", "frontier", "generated", "unique")):
    return [tuple(r[k] for k in keys) for r in checker.level_log]


def _assert_same_search(want, got):
    assert (got.state_count(), got.unique_state_count(), got.max_depth()) == (
        want.state_count(), want.unique_state_count(), want.max_depth()
    )
    assert _levels(got) == _levels(want)
    w, g = want.discoveries(), got.discoveries()
    assert set(g) == set(w)
    for name in w:
        # The two packages' state classes differ; compare their fields.
        assert [astuple(s) for s in g[name].into_states()] == [
            astuple(s) for s in w[name].into_states()
        ]
        assert g[name].into_actions() == w[name].into_actions()


@pytest.fixture
def tiny_cand_caps(monkeypatch):
    """The port starts every bucket's candidate buffer at 64 slots."""
    monkeypatch.setattr(port_xla, "default_cand_cap", lambda run_cap, a, backend: 64)


@pytest.fixture
def tiny_ref_cand_caps(monkeypatch, tiny_cand_caps):
    """Both engines start every bucket's candidate buffer at 64 slots."""
    monkeypatch.setattr(ref_xla, "default_cand_cap", lambda run_cap, a, backend, env=None: 64)


@pytest.mark.parametrize("rm, cand_ladder", [
    # The port's default (the candidate ladder at 3 rungs) keeps the plain
    # ids; the one-rung block is the extra case.
    pytest.param(rm, k, id=str(rm) if k == 3 else f"{rm}-cand_ladder=1")
    for k in (3, 1) for rm in sorted(EXPECTED_2PC)
])
def test_fused_matches_reference(rm, cand_ladder):
    """The port's block against the reference's planes engine at the same
    candidate ladder (the reference's CPU default, ``dedup="hash"``, runs
    one rung)."""
    r = ref.PackedTwoPhaseSys(rm).checker().spawn_xla(
        levels_per_dispatch=32, dedup="sorted", cand_ladder=cand_ladder, shrink_exit="on"
    ).join()
    if cand_ladder == 3:
        c = _fused(rm)
    else:
        c = port.PackedTwoPhaseSys(rm).checker().spawn_xla(cand_ladder=cand_ladder, **CPU).join()
    assert (c.state_count(), c.unique_state_count()) == EXPECTED_2PC[rm]
    _assert_same_search(r, c)
    # Block boundaries, shrink-exits, and each level's bucket and candidate
    # cap: the rung it ran at.
    assert c.dispatch_log == r.dispatch_log
    assert c.cand_retries == r.cand_retries
    keys = ("depth", "bucket", "cand_cap")
    assert _levels(c, keys) == _levels(r, keys)
    assert c.metrics()["shrink_exits"] == r.metrics()["shrink_exits"] == (rm > 3)
    assert sum(k for _, k in c.dispatch_log) == len(c.level_log)
    assert len(c.dispatch_log) < len(c.level_log)
    for name, path in c.discoveries().items():
        c.assert_discovery(name, path.into_actions())


@pytest.mark.parametrize("rm", sorted(EXPECTED_2PC))
def test_fused_equals_the_one_level_path(rm):
    one = port.PackedTwoPhaseSys(rm).checker().spawn_xla(levels_per_dispatch=1, **CPU).join()
    fused = _fused(rm)
    _assert_same_search(one, fused)
    assert len(one.dispatch_log) == len(one.level_log) > len(fused.dispatch_log)


@pytest.mark.parametrize("target", [("max_depth", 5), ("state_count", 500)])
def test_fused_targets_match_reference(target):
    kind, value = target

    def run(model, **kw):
        b = model.checker()
        b = b.target_max_depth(value) if kind == "max_depth" else b.target_state_count(value)
        return b.spawn_xla(levels_per_dispatch=32, **kw).join()

    r = run(ref.PackedTwoPhaseSys(4))
    c = run(port.PackedTwoPhaseSys(4), **CPU)
    assert (c.state_count(), c.unique_state_count(), c.max_depth()) == (
        r.state_count(), r.unique_state_count(), r.max_depth()
    )
    assert _levels(c) == _levels(r)
    assert c.dispatch_log == r.dispatch_log


def test_overflows_inside_blocks_commit_the_prefix(tiny_ref_cand_caps):
    """Tiny table, frontier and candidate buffers: every overflow kind fires
    inside a block, the levels before it commit, and the block boundaries
    equal the reference planes engine's."""
    r = ref.PackedTwoPhaseSys(3).checker().spawn_xla(
        levels_per_dispatch=32, **REF_PLANES, **TINY
    ).join()
    c = port.PackedTwoPhaseSys(3).checker().spawn_xla(**TINY, **CPU).join()
    m = c.metrics()
    assert m["table_grows"] and m["frontier_grows"] and m["cand_grows"]
    assert c.dispatch_log == r.dispatch_log
    # Blocks that commit some levels and then stop on an overflow (budget
    # left, frontier left, a retry follows), and retries that commit none.
    assert any(0 < k < 32 for _, k in c.dispatch_log[:-1])
    assert any(k == 0 for _, k in c.dispatch_log)
    assert sum(k for _, k in c.dispatch_log) == len(c.level_log)
    _assert_same_search(r, c)


def test_overflow_retries_keep_the_search_at_rm4(tiny_cand_caps):
    r = ref.PackedTwoPhaseSys(4).checker().spawn_xla(levels_per_dispatch=32).join()
    # (The reference at its default capacities: the search does not depend
    # on them.)
    c = port.PackedTwoPhaseSys(4).checker().spawn_xla(**TINY, **CPU).join()
    assert sum(k for _, k in c.dispatch_log) == len(c.level_log)
    _assert_same_search(r, c)


def test_shrink_exit_on_and_off():
    on = _fused(4)
    off = port.PackedTwoPhaseSys(4).checker().spawn_xla(shrink_exit="off", **CPU).join()
    _assert_same_search(on, off)
    assert on.metrics()["shrink_exit"] is True and on.metrics()["shrink_exits"] > 0
    assert off.metrics()["shrink_exit"] is False and off.metrics()["shrink_exits"] == 0
    assert on.dispatch_log == [(64, 2), (32768, 10), (64, 2)]
    assert off.dispatch_log == [(64, 2), (32768, 12)]
    with pytest.raises(ValueError, match="shrink_exit"):
        port.PackedTwoPhaseSys(3).checker().spawn_xla(shrink_exit="sometimes", **CPU)


def _loaded_carry(**inputs):
    """A rm=3 checker's carry loaded for its first block, then ``inputs``
    written over the block scalars (and the gate set to match)."""
    c = port.PackedTwoPhaseSys(3).checker().spawn_xla(**CPU)
    carry = c._program(64).carry
    c._load(carry, 64, budget=32, remaining=port_xla.NO_TARGET, shrink_below=0)
    for name, value in inputs.items():
        carry.s[S[name]] = value
    carry.s[S["live"]] = c._live(carry.s, carry.disc_found, carry.host_found)
    return c, carry


@pytest.mark.parametrize("closed", [
    dict(budget=0), dict(remaining=0), dict(t_ovf=1), dict(cc_ovf=1), "resolved",
])
def test_a_dead_level_leaves_the_carry_unchanged(closed):
    c, carry = _loaded_carry(**(closed if isinstance(closed, dict) else {}))
    if closed == "resolved":
        carry.host_found.fill_(True)
        carry.s[S["live"]] = c._live(carry.s, carry.disc_found, carry.host_found)
    assert int(carry.s[S["live"]]) == 0
    before = [t.clone() for t in carry.tensors()]
    c._gated_level(carry, 64, c._cand_cap_for(64))
    after = carry.tensors()
    assert len(after) == len(before)
    for a, b in zip(after, before):
        assert torch.equal(a, b)
    # The same carry with its gate open commits the level.
    open_checker, open_carry = _loaded_carry()
    open_checker._gated_level(open_carry, 64, open_checker._cand_cap_for(64))
    assert int(open_carry.s[S["committed"]]) == 1
    assert int(open_carry.s[S["tot_states"]]) == 7  # rm=3: 7 successors of the init state


def test_the_gated_level_reads_nothing_on_the_host(monkeypatch):
    """On the meta device every host read (``item``, ``bool``, ``tolist``,
    ``nonzero``, indexing by a 0-dim tensor) raises, so a gated level that
    runs there can be captured into a CUDA graph. The two kernels are
    replaced by stand-ins of their output shapes."""

    def fake_compact(mask, lanes, cap):
        return (torch.empty((len(lanes), cap), dtype=DTYPE, device=mask.device),
                torch.empty((), dtype=DTYPE, device=mask.device))

    def fake_merge(table, batch):
        return (torch.empty_like(table),
                torch.empty(batch.shape[1], dtype=torch.bool, device=table.device),
                torch.empty((), dtype=DTYPE, device=table.device))

    # 2pc, and Paxos: its family bodies, codec-overflow flag and on-device
    # linearizability check.
    checkers = [m.checker().spawn_xla(**CPU) for m in (port.PackedTwoPhaseSys(3), PackedPaxos(2, 3))]
    monkeypatch.setattr(port_xla, "compact", fake_compact)
    monkeypatch.setattr(port_ss, "merge_insert", fake_merge)
    meta = torch.device("meta")
    for c in checkers:
        monkeypatch.setattr(c, "_device", meta)
        carry = graphs.Carry(meta, c._W, c._P, 32, 1024)
        c._gated_level(carry, 256, 2048)
        with pytest.raises(RuntimeError, match="meta"):
            bool(carry.s[S["live"]])


def test_capacity_hints_size_the_next_checker(monkeypatch, tiny_cand_caps):
    monkeypatch.setattr(port_xla, "DEFAULT_TABLE_CAPACITY", 16)
    monkeypatch.setattr(port_xla, "DEFAULT_FRONTIER_CAPACITY", 16)
    model = port.PackedTwoPhaseSys(4)
    first = model.checker().spawn_xla(**CPU).join()
    m1 = first.metrics()
    assert m1["table_grows"] and m1["cand_grows"] and m1["frontier_capacity"] > 16
    assert port_xla.capacity_hints(model) == {
        "table_capacity": m1["table_capacity"],
        "frontier_capacity": m1["frontier_capacity"],
    }
    second = model.checker().spawn_xla(**CPU).join()
    m2 = second.metrics()
    assert (m2["table_grows"], m2["cand_grows"]) == (0, 0)
    # ``frontier_grows`` also counts the climbs up the bucket ladder from
    # the snug first bucket, which every check makes; the ceiling stays.
    assert m2["frontier_grows"] < m1["frontier_grows"]
    assert (m2["table_capacity"], m2["frontier_capacity"]) == (
        m1["table_capacity"], m1["frontier_capacity"]
    )
    assert _levels(second) == _levels(first)
    assert sum(k == 0 for _, k in second.dispatch_log) == 0  # no overflow retry
    # An explicit capacity wins over the hint.
    third = model.checker().spawn_xla(table_capacity=16, **CPU).join()
    assert third.metrics()["table_grows"] > 0
    assert _levels(third) == _levels(first)


def test_fused_metrics():
    m = _fused(3).metrics()
    assert m["levels_per_dispatch"] == 32 and m["shrink_exit"] is True
    # The CPU runs the gated level eagerly: no graphs, no dead replays.
    assert (m["graph_captures"], m["dead_replays"], m["shrink_exits"]) == (0, 0, 0)
    assert (m["dispatches"], m["levels_committed"]) == (1, 11)


def test_shrink_exit_metric_is_the_references_bool():
    """``metrics()["shrink_exit"]`` has the reference's type and value."""
    want = ref.PackedTwoPhaseSys(3).checker().spawn_xla(dedup="sorted").join().metrics()
    got = _fused(3).metrics()
    assert type(got["shrink_exit"]) is type(want["shrink_exit"]) is bool
    assert got["shrink_exit"] == want["shrink_exit"]


def test_graph_replays_count_their_kernel_launches(monkeypatch):
    """A launch made while a graph is captured counts as captured; each
    replay adds the graph's launches to the wrappers' counts."""
    monkeypatch.setattr(compact, "launches", 0)
    monkeypatch.setattr(compact, "captured", 0)
    monkeypatch.setattr(merge_insert, "launches", 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    _cuda.count_launch(compact)
    _cuda.count_launch(compact)
    assert (compact.launches, compact.captured) == (0, 2)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    _cuda.count_launch(compact)
    assert compact.launches == 1

    class Replayed:
        replays = 0

        def replay(self):
            self.replays += 1

    carry = graphs.Carry(torch.device("cpu"), 2, 3, 4, 16)
    prog = graphs.Program(carry, Replayed(), [(compact, 2), (merge_insert, 1)])
    for _ in range(3):
        prog.run(lambda: None)
    assert (prog.graph.replays, compact.launches, merge_insert.launches) == (3, 7, 3)
    ran = []
    prog.run(lambda: ran.append(1), eager=True)
    assert ran == [1] and prog.graph.replays == 3
