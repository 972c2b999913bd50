"""The port's multiplexed engine (``stateright_tpu_torch/xla_mux.py``) on the
CPU, held against its lanes' solo runs and the JAX package's
``MuxChecker``.

The cases of ``tests/test_mux.py`` but the census and the service drill
(``test_census_*``, ``test_smoke_mux``: ``analysis/`` and the service are
not ported, ROADMAP A10c-d):

- every lane equal to its solo run of the port (counts, depth, discoveries,
  every level's counts; the sorted set's table planes bit for bit; the hash
  set's visited pairs), and 2pc rm=3 lanes equal to the JAX package's
  ``MuxChecker`` lanes, under the sorted and the hash set; results are
  integers, tolerance 0;
- stragglers (depth- and state-count-capped lanes, a lane done after one
  level) and a lane left untouched, bit for bit, once it is done;
- K = 1, and K = 8 2pc rm=3 lanes in at most a third of 8 solo runs'
  dispatches;
- every ``MuxError`` and the lane telemetry.
"""

import json

import numpy as np
import pytest
import torch

from stateright_tpu.models import two_phase_commit as ref_2pc
from stateright_tpu.xla_mux import MuxChecker as RefMuxChecker
from stateright_tpu_torch import graphs
from stateright_tpu_torch.models.increment import PackedIncrement
from stateright_tpu_torch.models.increment_lock import PackedIncrementLock
from stateright_tpu_torch.models.single_copy_register import PackedSingleCopyRegister
from stateright_tpu_torch.models.two_phase_commit import PackedTwoPhaseSys
from stateright_tpu_torch.ops.words import to_u32
from stateright_tpu_torch.xla_mux import MuxChecker, MuxError

KW = dict(device="cpu", frontier_capacity=1 << 10, table_capacity=1 << 13)
REF_KW = dict(frontier_capacity=1 << 10, table_capacity=1 << 13)
#: Capacities small enough that the lanes grow their tables and frontiers.
SMALL = dict(device="cpu", frontier_capacity=1 << 6, table_capacity=1 << 6)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _summary(c):
    return (
        c.state_count(),
        c.unique_state_count(),
        c.max_depth(),
        {n: p.into_actions() for n, p in c.discoveries().items()},
        [(r["depth"], r["frontier"], r["generated"], r["unique"]) for r in c.level_log],
    )


def _pairs(c):
    """The visited set's (key, parent) pairs, sorted."""
    return sorted(zip(*(a.tolist() for a in c._ds.occupied_rows(c._table))))


def _lanes(model, k, dedup, builder=lambda b: b, **kw):
    return [builder(model.checker()).spawn_xla(dedup=dedup, **{**KW, **kw}) for _ in range(k)]


# --- exactness -------------------------------------------------------------


@pytest.mark.parametrize("dedup", ["hash", "sorted"])
@pytest.mark.parametrize(
    "factory",
    [lambda: PackedTwoPhaseSys(4), lambda: PackedIncrement(3), lambda: PackedIncrementLock(3)],
    ids=["2pc4", "increment", "increment-lock"],
)
def test_mux_lanes_bit_identical_to_solo(factory, dedup):
    """Each lane equals its solo run; at capacities small enough that every
    lane's table and frontier grow mid-run."""
    model = factory()
    solo = model.checker().spawn_xla(dedup=dedup, **SMALL).join()
    lanes = _lanes(model, 3, dedup, **SMALL)
    mux = MuxChecker(lanes)
    mux.run_to_completion()
    assert mux.is_done()
    for ln in lanes:
        assert _summary(ln) == _summary(solo)
        assert _pairs(ln) == _pairs(solo)
        if dedup == "sorted":
            # The sorted set's planes are a function of its contents.
            cap = min(ln._table.capacity, solo._table.capacity)
            for a, b in zip(ln._table[:ln._table.PLANES], solo._table[:solo._table.PLANES]):
                assert torch.equal(a[:cap], b[:cap])
    assert mux.state_count() == 3 * solo.state_count()
    assert mux.unique_state_count() == 3 * solo.unique_state_count()
    if isinstance(model, PackedTwoPhaseSys):
        assert lanes[0].metrics()["table_grows"] > 0 and lanes[0].metrics()["frontier_grows"] > 0


@pytest.mark.parametrize("dedup", ["hash", "sorted"])
def test_mux_lanes_equal_jax_mux(dedup):
    """Three 2pc rm=3 lanes through the port's mux and through the JAX
    package's: every lane's counts, depth, discoveries' lengths and
    per-level generated and unique counts equal."""
    model = PackedTwoPhaseSys(3)
    lanes = _lanes(model, 3, dedup)
    MuxChecker(lanes).run_to_completion()
    ref_model = ref_2pc.PackedTwoPhaseSys(3)
    ref_lanes = [ref_model.checker().spawn_xla(dedup=dedup, **REF_KW) for _ in range(3)]
    RefMuxChecker(ref_lanes).run_to_completion()

    def view(c):
        return (c.state_count(), c.unique_state_count(), c.max_depth(),
                {n: len(p.into_actions()) for n, p in c.discoveries().items()},
                [(r["generated"], r["unique"]) for r in c.level_log])

    for ln, rl in zip(lanes, ref_lanes):
        assert view(ln) == view(rl)
        assert view(ln)[:2] == (1_146, 288)


@pytest.mark.parametrize("dedup", ["hash", "sorted"])
def test_mux_straggler_lanes(dedup):
    """Uneven lane lifetimes: a depth-capped lane, a state-count-capped
    lane, a lane done after its first level and an uncapped lane each
    finish equal to a solo run with the same target."""
    model = PackedTwoPhaseSys(3)
    shapers = [
        lambda b: b.target_max_depth(2),
        lambda b: b.target_state_count(40),
        lambda b: b.target_state_count(1),  # done after its first level
        lambda b: b,
    ]
    solos = [_summary(sh(model.checker()).spawn_xla(dedup=dedup, **KW).join()) for sh in shapers]
    lanes = [sh(model.checker()).spawn_xla(dedup=dedup, **KW) for sh in shapers]
    mux = MuxChecker(lanes)
    mux.run_to_completion()
    assert [_summary(ln) for ln in lanes] == solos
    assert lanes[0].max_depth() < lanes[3].max_depth()
    assert lanes[2].state_count() < 40 <= lanes[1].state_count() < lanes[3].state_count()


def test_done_lane_is_left_untouched():
    """Once a lane is done, later blocks (and table growths of the others)
    leave its frontier, table planes and counts bit for bit as they were,
    and the lead lane, done first, counts none of the growths the running
    lane resolves."""
    model = PackedTwoPhaseSys(4)
    short, full = (model.checker().target_max_depth(2).spawn_xla(**SMALL),
                   model.checker().spawn_xla(**SMALL))
    mux = MuxChecker([short, full])
    mux._run_block()
    while not short.is_done():
        mux._run_block()
    before = ([t.clone() for t in (short._frontier, short._frontier_ebits, *short._table)],
              short.state_count(), short.unique_state_count(), len(short.level_log))
    mux.run_to_completion()
    after = ([short._frontier, short._frontier_ebits, *short._table], short.state_count(),
             short.unique_state_count(), len(short.level_log))
    assert all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
    assert before[1:] == after[1:]
    assert full.metrics()["table_grows"] > short.metrics()["table_grows"]
    assert short.metrics()["frontier_grows"] == 0 < full.metrics()["frontier_grows"]
    assert full.unique_state_count() == 1_568


def test_a_mux_table_growth_drops_the_old_programs_and_makes_no_solo_ones():
    """A lane's table growth under the mux drops the programs on the old
    capacity (solo and mux) and makes no solo program at the new one: the
    mux replays none."""
    model = PackedTwoPhaseSys(4)
    solo = model.checker().target_max_depth(3).spawn_xla(**SMALL).join()
    cache = solo._programs
    assert solo.metrics()["table_grows"] == 0 and {k[3] for k in cache.programs} == {1 << 6}
    lanes = [model.checker().spawn_xla(**SMALL) for _ in range(2)]
    MuxChecker(lanes).run_to_completion()
    assert [ln.metrics()["table_grows"] for ln in lanes] == [5, 5]
    assert not cache.programs
    assert {graphs.mux_shape(k)[0] for k in cache.mux_programs} == {lanes[0]._table_cap()}


def test_mux_k1_degenerates_bit_identically():
    model = PackedIncrementLock(3)
    solo = _summary(model.checker().spawn_xla(**KW).join())
    lane = model.checker().spawn_xla(**KW)
    mux = MuxChecker([lane])
    mux.run_to_completion()
    assert _summary(lane) == solo
    assert all(lanes == 1 for _, _, lanes, _ in mux.dispatch_log)
    assert mux.metrics()["mux_dispatches_saved"] == 0


def test_mux_dispatch_acceptance_k8():
    """K=8 2pc rm=3 lanes through the mux take at most a third of the
    dispatches of 8 solo runs, every lane equal to its solo run."""
    model = PackedTwoPhaseSys(3)
    solos = [model.checker().spawn_xla(**KW).join() for _ in range(8)]
    solo_dispatches = sum(len(c.dispatch_log) for c in solos)
    solo = _summary(solos[0])
    assert all(_summary(c) == solo for c in solos[1:])
    lanes = _lanes(model, 8, "auto")
    mux = MuxChecker(lanes)
    mux.run_to_completion()
    for ln in lanes:
        assert _summary(ln) == solo
    assert len(mux.dispatch_log) * 3 <= solo_dispatches, (mux.dispatch_log, solo_dispatches)


# --- typed ineligibility -----------------------------------------------------


def test_mux_error_pins():
    model = PackedTwoPhaseSys(3)
    with pytest.raises(MuxError, match="at least one lane"):
        MuxChecker([])
    ln = model.checker().spawn_xla(**KW)
    with pytest.raises(MuxError, match="distinct"):
        MuxChecker([ln, ln])
    with pytest.raises(MuxError, match="ONE model"):
        MuxChecker([ln, PackedTwoPhaseSys(3).checker().spawn_xla(**KW)])
    with pytest.raises(MuxError, match="disagree on dedup"):
        MuxChecker([ln, model.checker().spawn_xla(**{**KW, "dedup": "hash"})])
    with pytest.raises(MuxError, match="capacities"):
        MuxChecker([ln, model.checker().spawn_xla(device="cpu", frontier_capacity=1 << 9,
                                                  table_capacity=1 << 13)])
    with pytest.raises(MuxError, match="delta"):
        MuxChecker([model.checker().spawn_xla(dedup="delta", **KW)])
    with pytest.raises(MuxError, match="visitors"):
        MuxChecker([model.checker().visitor(lambda path: None).spawn_xla(**KW)])
    with pytest.raises(MuxError, match="levels_per_dispatch"):
        MuxChecker([ln, model.checker().spawn_xla(levels_per_dispatch=4, **KW)])


class _HvSingleCopy(PackedSingleCopyRegister):
    """The single-copy register with a property demoted to host
    verification: rejected typed."""

    host_verified_properties = frozenset({"linearizable"})


def test_mux_error_host_verified():
    lane = _HvSingleCopy(2, 1).checker().spawn_xla(device="cpu", frontier_capacity=1 << 10,
                                                   table_capacity=1 << 12)
    with pytest.raises(MuxError, match="host-verified"):
        MuxChecker([lane])


# --- lane telemetry --------------------------------------------------------------


def test_mux_lane_telemetry():
    model = PackedTwoPhaseSys(4)
    lanes = [model.checker().target_max_depth(5).spawn_xla(**SMALL),
             model.checker().spawn_xla(**SMALL)]
    mux = MuxChecker(lanes)
    mux.run_to_completion()
    assert mux.dispatch_log
    for run_cap, committed, k, active in mux.dispatch_log:
        assert k == 2 and 0 <= active <= k and committed >= 0
    for ln in lanes:
        assert all(len(t) == 2 for t in ln.dispatch_log)
        assert sum(c for _, c in ln.dispatch_log) == len(ln.level_log)
        for row in ln.level_log:
            assert {"bucket", "cand_cap", "lanes", "lanes_active"} <= set(row)
            assert row["lanes"] == 2 and 1 <= row["lanes_active"] <= 2
    # The capped lane's levels ran beside the other lane's; the rest alone.
    assert [r["lanes_active"] for r in lanes[1].level_log] == [2] * 4 + [1] * (
        len(lanes[1].level_log) - 4)
    m = mux.metrics()
    assert m["engine"] == "xla-mux" and m["mux_lanes"] == 2 and m["mux_lanes_active"] == 0
    assert m["dispatches"] == len(mux.dispatch_log)
    assert m["mux_dispatches_saved"] == sum(max(0, a - 1) for _, _, _, a in mux.dispatch_log) >= 1
    assert m["levels_committed"] == len(lanes[1].level_log)


@pytest.mark.parametrize("dedup", ["sorted", "hash"])
def test_mux_rows_carry_lane_words(dedup):
    """ROADMAP C1 on the mux's rows (the reference's ``xla_mux.py:419``):
    every lane's row carries ``lane_words``, the lane's structure's words
    at the row's candidate cap and the lane's table, as a solo run's
    rows do."""
    model = PackedTwoPhaseSys(3)
    lanes = _lanes(model, 2, dedup)
    MuxChecker(lanes).run_to_completion()
    solo = model.checker().spawn_xla(dedup=dedup, **KW).join()
    for ln in lanes:
        assert ln.metrics()["table_grows"] == 0
        assert [r["lane_words"] for r in ln.level_log] == [
            ln._ds.insert_lane_words(ln._table, r["cand_cap"]) for r in ln.level_log]
        assert all((r["lane_words"] > 0) == (dedup == "sorted") and r["lanes"] == 2
                   for r in ln.level_log)
    assert {r["lane_words"] for r in solo.level_log} >= {r["lane_words"] for r in lanes[0].level_log}


def test_mux_spans_and_program_keys(tmp_path):
    """Dispatch spans have flavor ``mux`` with the lanes; the mux program is
    keyed on its lanes, bucket, candidate cap and shape, and a table growth
    drops the programs on the old capacity."""
    from stateright_tpu_torch import graphs

    model = PackedTwoPhaseSys(4)
    trace = str(tmp_path / "trace.jsonl")
    lanes = [model.checker().spawn_xla(trace=trace, **SMALL) for _ in range(2)]
    mux = MuxChecker(lanes)
    mux.run_to_completion()
    with open(trace) as fh:
        spans = [s for s in map(json.loads, fh) if s["name"] == "dispatch"]
    assert len(spans) == len(mux.dispatch_log)
    assert all(s["attrs"]["flavor"] == "mux" and s["attrs"]["lanes"] == 2 for s in spans)
    keys = list(model.__dict__["_xla_programs"]["cpu"].mux_programs)
    cap = lanes[0]._table_cap()
    assert keys and all(k[:2] == ("mux", 2) and graphs.mux_shape(k) == (cap, 32, 0, "sorted")
                        for k in keys)
    assert np.all(to_u32(lanes[0]._frontier) == to_u32(lanes[1]._frontier))
