"""The port's sharded engine on the CPU, held against its pins and against
the port's own single-chip engine (which ``tests/test_torch_*.py`` hold
against the JAX package).

The cases of ``tests/test_sharded.py`` and the mesh cases of
``test_audit.py``, ``test_checkpoint.py``, ``test_obs.py``,
``test_symmetry.py``, ``test_packed_actor.py``, ``test_fused_dispatch.py``
and ``test_differential_fuzz.py`` that ``tests/test_torch_sharded.py`` does
not run against the JAX mesh engine:

- eventually-counterexamples (and the cycle false negative), both targets,
  fused against ``levels_per_dispatch=1``;
- symmetry (2pc rm=3 and rm=5 at the single-chip engine's reduced
  counts; host-verified properties refused);
- host-verified single-copy-register 2c/2s (equal to the single-chip
  engine, its witness re-executed) and 2c/1s (121 / 93);
- the delta set against the sorted set at rm=4 (1,568) with flushes and a
  growth, every set grown from tiny capacities (the sorted set's shards
  sorted and unique after its plane copies);
- the visitor, ping-pong (4,094), a differential graph;
- the audit under all three sets, and a key stored by two shards caught;
- spans, heartbeat and metrics series; the program keys (a solo check,
  D = 8 and D = 4 of one model instance and a repeat of each).

Results are integers, compared exactly (tolerance 0).
"""

import json

import numpy as np
import pytest
import torch

from stateright_tpu_torch import graphs
from stateright_tpu_torch.audit import audit_table
from stateright_tpu_torch.checker.visitor import PathRecorder
from stateright_tpu_torch.core import Property
from stateright_tpu_torch.models.single_copy_register import PackedSingleCopyRegister
from stateright_tpu_torch.models.two_phase_commit import PackedTwoPhaseSys, TwoPhaseSys
from stateright_tpu_torch.obs import heartbeat as hb_mod
from stateright_tpu_torch.obs import read_series
from stateright_tpu_torch.ops import deltaset
from stateright_tpu_torch.ops.words import to_u32
from stateright_tpu_torch.parallel import default_mesh
from stateright_tpu_torch.sym import SymmetryUnsupported
from stateright_tpu_torch.test_util import DGraph, PackedDGraph

KW = dict(frontier_capacity=1 << 10, table_capacity=1 << 13)
TINY = dict(frontier_capacity=1 << 7, table_capacity=1 << 9, route_capacity=4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mesh(d: int = 8):
    return default_mesh(d, device="cpu")


def summary(c):
    return (c.state_count(), c.unique_state_count(), c.max_depth(),
            {n: p.into_actions() for n, p in c.discoveries().items()})


# --- semantics ------------------------------------------------------------------


def eventually_odd():
    return Property.eventually("odd", lambda _, s: s % 2 == 1)


@pytest.mark.parametrize("paths, witness", [
    ([[0, 1], [0, 2]], [0, 2]),
    ([[0, 2, 4, 2]], None),  # the documented cycle false negative
])
def test_eventually_counterexamples(paths, witness):
    g = DGraph.with_property(eventually_odd())
    for p in paths:
        g = g.with_path(p)
    c = PackedDGraph(g).checker().spawn_xla(mesh=mesh(), frontier_capacity=1 << 8,
                                            table_capacity=1 << 11).join()
    got = c.discovery("odd")
    assert (got.into_states() if got else None) == witness


@pytest.mark.parametrize("target", ["count", "depth", "none"])
def test_fused_equals_one_level_a_dispatch(target):
    def spawn(lpd):
        b = PackedTwoPhaseSys(3).checker()
        if target == "count":
            b = b.target_state_count(100)
        elif target == "depth":
            b = b.target_max_depth(3)
        return b.spawn_xla(mesh=mesh(), levels_per_dispatch=lpd, **KW).join()

    a, b = spawn(1), spawn(32)
    assert summary(a) == summary(b)
    assert a.is_done() and b.is_done()
    if target == "count":
        assert b.state_count() >= 100 and len(b.dispatch_log) == 1
    elif target == "depth":
        assert b.max_depth() == 3
    else:
        assert b.unique_state_count() == 288 and len(a.dispatch_log) == 11


def test_a_four_shard_mesh_and_the_single_chip_engine_agree():
    c = PackedTwoPhaseSys(3).checker().spawn_xla(mesh=mesh(4), **KW).join()
    s = PackedTwoPhaseSys(3).checker().spawn_xla(device="cpu", **KW).join()
    host = TwoPhaseSys(3).checker().spawn_bfs().join()
    assert summary(c)[:3] == summary(s)[:3] == (1_146, 288, 11)
    assert set(c.discoveries()) == set(host.discoveries())
    for name, path in c.discoveries().items():
        model = TwoPhaseSys(3)
        assert model.property(name).condition(model, path.last_state())


@pytest.mark.parametrize("rm, caps, unique", [
    (3, KW, 80),
    (5, dict(frontier_capacity=1 << 9, table_capacity=1 << 12), 314),
])
def test_symmetry_equals_the_single_chip_engine(rm, caps, unique):
    m = PackedTwoPhaseSys(rm)
    c = m.checker().symmetry().spawn_xla(mesh=mesh(), **caps).join()
    s = m.checker().symmetry().spawn_xla(device="cpu", **caps).join()
    assert summary(c)[:3] == summary(s)[:3]
    assert c.unique_state_count() == unique
    if rm == 5:
        assert (c.state_count(), c.max_depth()) == (2_048, 17)
    c.assert_properties()
    assert c.metrics()["symmetry"] == f"spec:{m.symmetry_spec.spec_hash()[:12]}"


def test_symmetry_with_host_verified_properties_is_refused():
    class HvTwoPhase(PackedTwoPhaseSys):
        def __init__(self, rm):
            super().__init__(rm)
            self.host_verified_properties = frozenset({"commit agreement"})

    with pytest.raises(SymmetryUnsupported, match="host-verified"):
        HvTwoPhase(3).checker().symmetry().spawn_xla(mesh=mesh(), **KW)


HV = dict(frontier_capacity=1 << 9, table_capacity=1 << 11)


def test_host_verified_counterexample_equals_the_single_chip_engine():
    single = PackedSingleCopyRegister(2, 2, device_exact=False).checker().spawn_xla(
        device="cpu", **HV).join()
    c = PackedSingleCopyRegister(2, 2, device_exact=False).checker().spawn_xla(
        mesh=mesh(), **HV).join()
    assert "linearizable" in c.discoveries()
    assert set(c.discoveries()) == set(single.discoveries())
    assert (c.state_count(), c.unique_state_count()) == (single.state_count(),
                                                         single.unique_state_count())
    c.assert_discovery("linearizable", c.discoveries()["linearizable"].into_actions())
    assert c.hv_stats["confirmed"] == 1 and c.metrics()["hv"]["confirmed"] == 1


def test_host_verified_full_coverage():
    c = PackedSingleCopyRegister(2, 1, device_exact=False).checker().spawn_xla(
        mesh=mesh(), **HV).join()
    assert (c.state_count(), c.unique_state_count()) == (121, 93)
    assert "linearizable" not in c.discoveries()
    c.assert_properties()


# --- visited sets and growth ------------------------------------------------------


def test_the_delta_set_equals_the_sorted_set(monkeypatch):
    """Tiny delta tiers force flushes and a growth; counts and witnesses
    equal the sorted run's."""
    monkeypatch.setattr(deltaset, "MIN_DELTA", 16)
    a = PackedTwoPhaseSys(4).checker().spawn_xla(mesh=mesh(), dedup="sorted", **KW).join()
    b = PackedTwoPhaseSys(4).checker().spawn_xla(mesh=mesh(), dedup="delta",
                                                 frontier_capacity=1 << 10,
                                                 table_capacity=1 << 10).join()
    assert summary(a) == summary(b)
    assert b.unique_state_count() == 1_568
    m = b.metrics()
    assert m["delta_flushes"] > 0 and m["table_grows"] > 0, m
    assert audit_table(b)["ok"]


@pytest.mark.parametrize("dedup", ["sorted", "hash", "delta"])
def test_every_buffer_grows_from_tiny_capacities(dedup, monkeypatch):
    # A delta tier at its 1,024-row floor would hold every shard's keys.
    monkeypatch.setattr(deltaset, "MIN_DELTA", 16)
    c = PackedTwoPhaseSys(4).checker().spawn_xla(mesh=mesh(), dedup=dedup, **TINY).join()
    assert (c.state_count(), c.unique_state_count()) == (8_258, 1_568)
    m = c.metrics()
    assert all(m[k] > 0 for k in ("table_grows", "frontier_grows", "route_grows")), m
    assert audit_table(c)["ok"]
    c.assert_properties()
    if dedup == "sorted":
        # Each shard's prefix is sorted and unique, its pads zero.
        for t in c._tables:
            n = int(t.n)
            keys = (to_u32(t.key_hi).astype(np.uint64) << np.uint64(32)) | to_u32(t.key_lo)
            assert np.all(keys[1:n] > keys[:n - 1]) and not keys[n:].any()


@pytest.mark.parametrize("dedup", ["sorted", "hash", "delta"])
def test_the_audit_is_clean_under_every_set(dedup):
    c = PackedTwoPhaseSys(3).checker().spawn_xla(
        mesh=mesh(), dedup=dedup, frontier_capacity=1 << 9, table_capacity=1 << 10).join()
    report = audit_table(c)
    assert report == {"entries": 288, "distinct_keys": 288, "duplicate_keys": 0,
                      "unique_count": 288, "ok": True}


def test_the_audit_catches_a_key_stored_by_two_shards():
    c = PackedTwoPhaseSys(3).checker().spawn_xla(mesh=mesh(), **KW).join()
    donor, thief = c._tables[0], c._tables[1]
    n = int(thief.n)
    planes = [p.clone() for p in thief[:4]]
    for p, src in zip(planes, donor[:4]):
        p[n] = src[0]
    c._tables[1] = type(thief)(*planes, thief.n + 1)
    report = audit_table(c)
    assert report["duplicate_keys"] == 1 and not report["ok"]


# --- the paths through the engine ---------------------------------------------------


def test_the_visitor_sees_every_state_at_its_depth():
    """Every state once, by a path as long as the single-chip engine's (a
    state reached from two shards keeps the lower shard's parent, so the
    paths themselves may differ)."""
    def paths(**kw):
        rec, read = PathRecorder.new_with_accessor()
        PackedTwoPhaseSys(3).checker().visitor(rec).spawn_xla(**kw, **KW).join()
        return {p.last_state(): len(p.into_states()) for p in read()}

    got = paths(mesh=mesh())
    assert got == paths(device="cpu") and len(got) == 288


def test_ping_pong_on_the_mesh():
    from stateright_tpu_torch.actor.actor_test_util import PingPongCfg
    from stateright_tpu_torch.actor.packed import PackedPingPong

    c = PackedPingPong(PingPongCfg(False, 5), lossy=True).checker().spawn_xla(
        mesh=mesh(), frontier_capacity=1 << 10, table_capacity=1 << 14).join()
    s = PackedPingPong(PingPongCfg(False, 5), lossy=True).checker().spawn_xla(
        device="cpu", frontier_capacity=1 << 10, table_capacity=1 << 14).join()
    assert c.unique_state_count() == 4_094
    assert summary(c)[:3] == summary(s)[:3] and set(c.discoveries()) == set(s.discoveries())


def test_a_differential_graph_equals_the_single_chip_engine():
    import random

    rng = random.Random(2024)
    g = DGraph.with_property(Property.always("small", lambda _, s: s < 20))
    for _ in range(12):
        g = g.with_path([rng.randint(0, 24) for _ in range(rng.randint(2, 6))])
    caps = dict(frontier_capacity=1 << 8, table_capacity=1 << 11)
    c = PackedDGraph(g).checker().spawn_xla(mesh=mesh(), **caps).join()
    s = PackedDGraph(g).checker().spawn_xla(device="cpu", **caps).join()
    assert summary(c) == summary(s)


def test_spans_heartbeat_and_series(tmp_path):
    trace, hb, series = (str(tmp_path / n) for n in ("t.jsonl", "hb.json", "m.jsonl"))
    c = PackedTwoPhaseSys(4).checker().spawn_xla(
        mesh=mesh(), trace=trace, heartbeat=hb, metrics_to=series, metrics_every=1,
        **TINY).join()
    assert c.unique_state_count() == 1_568
    with open(trace) as fh:
        spans = [json.loads(line) for line in fh]
    disp = [r for r in spans if r["name"] == "dispatch"]
    assert len(disp) == len(c.dispatch_log)
    assert [r["attrs"]["committed"] for r in disp] == [n for _, n in c.dispatch_log]
    assert all(r["attrs"]["shards"] == 8 and r["attrs"]["compaction"] == "mesh" for r in disp)
    grows = [r for r in spans if r["name"] in ("grow_table", "grow_frontier")]
    m = c.metrics()
    assert len(grows) == m["table_grows"] + m["frontier_grows"]
    assert hb_mod.read(hb)["seq"] == len(c.dispatch_log)
    rows = read_series(series)
    assert rows and len(rows) <= len(c.dispatch_log)
    assert rows[-1]["metrics"]["engine"] == "xla-sharded"
    assert m["route_grows"] > 0 and m["dispatches"] == len(c.dispatch_log)


def test_program_keys_keep_the_solo_and_each_mesh_size_apart():
    """One model instance through a solo check, D = 8 and D = 4, then a
    repeat of each: every check exact, each mesh size its own program and
    carry, and a repeat makes no program. A growth from tiny capacities
    leaves only the grown shape's program and carry beside them."""
    model = PackedTwoPhaseSys(3)
    cache = graphs.cache_for(model, torch.device("cpu"))
    spawns = [dict(device="cpu"), dict(mesh=mesh(8)), dict(mesh=mesh(4))]

    def run(**kw):
        c = model.checker().spawn_xla(**kw).join()
        assert (c.state_count(), c.unique_state_count()) == (1_146, 288)
        return c

    first = [run(**spawn, **KW)._key() if "mesh" in spawn else run(**spawn, **KW)
             for spawn in spawns]
    made = (set(cache.programs), set(cache.shard_programs), set(cache.shard_carries))
    for spawn in spawns:
        run(**spawn, **KW)
    assert (set(cache.programs), set(cache.shard_programs), set(cache.shard_carries)) == made
    assert sorted(cache.shard_programs) == sorted(first[1:])
    assert [k[1] for k in first[1:]] == [8, 4] and cache.programs
    grown = run(mesh=mesh(8), **TINY)
    assert grown.metrics()["table_grows"] + grown.metrics()["route_grows"] > 0
    assert sorted(cache.shard_programs) == sorted(first[1:] + [grown._key()])
    assert set(cache.shard_carries) == {graphs.shard_shape(k) for k in cache.shard_programs}
