"""The port's sharded engine (``stateright_tpu_torch/parallel``) on the CPU,
held against the JAX package's mesh engine.

The port runs on ``default_mesh(D, device="cpu")`` (D shards on one
device), the reference on ``stateright_tpu.parallel.default_mesh(D)`` (the
8-device virtual CPU mesh of ``tests/conftest.py``). Results are integers
and fingerprint words, compared exactly (tolerance 0):

- ``spawn_xla(mesh=)`` dispatch, the one-shard fallback and the mesh's
  refusals;
- the owner bits on random fingerprints;
- 2pc rm=3 at D = 8 (fused) and rm=4 at D = 4 (one level a dispatch, read
  after every level), under the sorted and the hash set: counts, depth,
  discovered fingerprints, and each shard's table planes and frontier bit
  for bit, the capacities and the growth counters too;
- growth of the table, frontier and route slots from tiny capacities
  under the hash set (a rehash at every table growth);
- a mid-run checkpoint's payload equal to the JAX mesh engine's, and files
  crossing the two packages, the single-chip engine and mesh sizes;
- ``metrics()``'s key set: the reference mesh engine's and the port's
  graph counters.

The JAX runs are shared through module-scoped fixtures (rm <= 4).
"""

import numpy as np
import pytest
import torch

from stateright_tpu.models.two_phase_commit import PackedTwoPhaseSys as RefSys
from stateright_tpu.parallel import default_mesh as ref_mesh
from stateright_tpu.parallel.sharded import _owner_bits as ref_owner_bits
from stateright_tpu_torch.checkpoint import PAYLOAD_KEYS, checkpoint_arrays, load_checkpoint
from stateright_tpu_torch.models.two_phase_commit import PackedTwoPhaseSys
from stateright_tpu_torch.ops.words import to_u32
from stateright_tpu_torch.parallel import (
    Mesh,
    ShardedXlaChecker,
    default_mesh,
    owner_bits,
)
from stateright_tpu_torch.xla import XlaChecker

KW = dict(frontier_capacity=1 << 10, table_capacity=1 << 13)
#: Capacities small enough that the table, the frontier and the route
#: slots all grow (``tests/test_sharded.py``'s autogrowth cases).
TINY = dict(frontier_capacity=1 << 7, table_capacity=1 << 9, route_capacity=8)
PLANES = ("key_hi", "key_lo", "val_hi", "val_lo")
#: The keys the port's ``metrics()`` adds to the reference's (the last two
#: are a rank mesh's, None in one process).
PORT_EXTRAS = {"device", "graph_captures", "graph_capture_s", "dead_replays", "mesh_backend",
               "exchange"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mesh(d: int) -> Mesh:
    return default_mesh(d, device="cpu")


def ref_planes(c, D):
    """The reference's global planes, ``[D, Cl]`` a plane."""
    return [np.asarray(getattr(c._table, n)).reshape(D, -1) for n in PLANES]


def port_planes(c):
    return [np.stack([to_u32(getattr(t, n)) for t in c._tables]) for n in PLANES]


def snapshot(c, ref: bool):
    """Everything the two engines must agree on, as host values: counts,
    depths, pins, capacities, growth counters, each shard's planes,
    frontier rows, eventually-bits and count."""
    D = c._D
    m = c.metrics()
    if ref:
        planes = ref_planes(c, D)
        frontier = np.asarray(c._frontier).reshape(D, c._Fl, -1)
        ebits = np.asarray(c._frontier_ebits).reshape(D, c._Fl)
        counts = np.asarray(c._counts).astype(np.int64)
    else:
        planes = port_planes(c)
        frontier, ebits, counts = to_u32(c._frontier), to_u32(c._frontier_ebits), c._counts
    return {
        "counts": (c.state_count(), c.unique_state_count(), c._depth, c.max_depth()),
        "found": dict(c._found_names),
        "shapes": (c._Fl, c._Cl, c._K),
        "grows": [m[k] for k in ("table_grows", "frontier_grows", "route_grows")],
        "dispatch_log": list(c.dispatch_log),
        "planes": planes,
        "frontier": frontier,
        "ebits": ebits,
        "shard_counts": np.asarray(counts, dtype=np.int64),
    }


def assert_same(a, b):
    for key in ("counts", "found", "shapes", "grows", "dispatch_log"):
        assert a[key] == b[key], key
    for key in ("frontier", "ebits", "shard_counts"):
        assert np.array_equal(a[key], b[key]), key
    for x, y in zip(a["planes"], b["planes"]):
        assert np.array_equal(x, y)


# --- dispatch ------------------------------------------------------------------


def test_spawn_xla_dispatches_to_the_sharded_engine():
    c = PackedTwoPhaseSys(3).checker().spawn_xla(mesh=mesh(8), **KW)
    assert isinstance(c, ShardedXlaChecker)
    assert c.metrics()["shards"] == 8 and c.metrics()["device"] == "cpu"
    assert mesh(8).devices.size == 8 and mesh(8).axis_names == ("shards",)


def test_a_one_shard_mesh_falls_back_to_the_single_chip_engine():
    c = PackedTwoPhaseSys(3).checker().spawn_xla(mesh=mesh(1), route_capacity=8, **KW)
    assert type(c) is XlaChecker and c.metrics()["device"] == "cpu"
    assert c.join().unique_state_count() == 288
    assert default_mesh(device="cpu").devices.size == 1


@pytest.mark.parametrize("case", ["device", "devices", "size"])
def test_the_mesh_refuses(case):
    builder = PackedTwoPhaseSys(3).checker()
    if case == "device":
        with pytest.raises(ValueError, match="mesh's device"):
            builder.spawn_xla(mesh=mesh(8), device="cuda", **KW)
    elif case == "devices":
        with pytest.raises(NotImplementedError, match="one rank a card"):
            builder.spawn_xla(mesh=Mesh(["cpu", "meta"]), **KW)
    else:
        with pytest.raises(ValueError, match="power of two"):
            builder.spawn_xla(mesh=mesh(3), **KW)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_owner_bits_equal_the_references(shards):
    rng = np.random.default_rng(shards)
    hi = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    hi[:3] = [0, 0xFFFFFFFF, 0xFFFFFFFF]
    lo[:3] = [1, 0xFFFFFFFE, 0]
    want = ref_owner_bits(hi, lo, shards, np)
    got_np = owner_bits(hi.astype(np.int64), lo.astype(np.int64), shards)
    got_t = owner_bits(torch.from_numpy(hi.astype(np.int64)), torch.from_numpy(lo.astype(np.int64)),
                       shards)
    assert np.array_equal(got_np, want) and np.array_equal(got_t.numpy(), want)


# --- the runs against the JAX mesh engine ------------------------------------------------

#: ``(rm, D, levels_per_dispatch, capacities)`` of each compared configuration.
CASES = {
    "rm3-d8-fused": (3, 8, 32, KW),
    "rm4-d4-levels": (4, 4, 1, KW),
    "rm4-d8-tiny": (4, 8, 32, TINY),
}
#: The compared runs: every case under both sets, but the tiny one (whose
#: growths recompile the JAX engine's program at every shape) under the
#: hash set only, whose table growth is a rehash; the sorted set's plane
#: copy grows from the same capacities in ``test_torch_sharded_engine.py``.
RUNS = [(c, d) for c in CASES for d in ("sorted", "hash") if (c, d) != ("rm4-d8-tiny", "sorted")]
#: The level of the rm=4 one-level run at which both engines save.
SAVE_AT = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each run of :data:`RUNS` in both packages: the snapshots after every
    dispatch, ``{(case, dedup): (port, ref, snapshots)}``, and the rm=4
    run's checkpoint files (``files[dedup] = (port, ref)``)."""
    d = tmp_path_factory.mktemp("sharded")
    out, files = {}, {}
    for case, dedup in RUNS:
        rm, D, lpd, caps = CASES[case]
        kw = dict(dedup=dedup, levels_per_dispatch=lpd, **caps)
        ref = RefSys(rm).checker().spawn_xla(mesh=ref_mesh(D), **kw)
        port = PackedTwoPhaseSys(rm).checker().spawn_xla(mesh=mesh(D), **kw)
        snaps = ([], [])
        for _ in range(64):
            if ref.is_done() and port.is_done():
                break
            for c, s, is_ref in ((port, snaps[0], False), (ref, snaps[1], True)):
                c._run_block()
                s.append(snapshot(c, is_ref))
            if case == "rm4-d4-levels" and port._depth == SAVE_AT + 1:
                files[dedup] = (str(d / f"port-{dedup}.npz"), str(d / f"ref-{dedup}.npz"))
                port.save_checkpoint(files[dedup][0])
                ref.save_checkpoint(files[dedup][1])
        out[(case, dedup)] = (port, ref, snaps)
    return out, files


@pytest.mark.parametrize("key", RUNS, ids=str)
def test_every_shard_equals_the_jax_mesh_engine_after_every_dispatch(runs, key):
    port, ref, (ps, rs) = runs[0][key]
    assert len(ps) == len(rs) > 0
    for a, b in zip(ps, rs):
        assert_same(a, b)
    assert port.unique_state_count() == {3: 288, 4: 1_568}[CASES[key[0]][0]]
    port.assert_properties()
    assert {n: p.into_actions() for n, p in port.discoveries().items()} == {
        n: p.into_actions() for n, p in ref.discoveries().items()}


def test_growth_from_tiny_capacities_grows_every_buffer(runs):
    port, ref, _ = runs[0][("rm4-d8-tiny", "hash")]
    m = port.metrics()
    assert all(m[k] > 0 for k in ("table_grows", "frontier_grows", "route_grows")), m
    assert (port._Fl, port._Cl, port._K) == (ref._Fl, ref._Cl, ref._K)


@pytest.mark.parametrize("dedup", ["sorted", "hash"])
def test_a_mid_run_checkpoint_payload_equals_the_jax_mesh_engines(runs, dedup):
    port_file, ref_file = runs[1][dedup]
    a, b = load_checkpoint(port_file), load_checkpoint(ref_file)
    for key in PAYLOAD_KEYS:
        assert a[key].dtype == b[key].dtype == np.uint32
        assert np.array_equal(a[key], b[key]), key
    skip = {"payload_sha256", "written_unix_ts"}
    assert {k: v for k, v in a["meta"].items() if k not in skip} == {
        k: v for k, v in b["meta"].items() if k not in skip}
    assert a["meta"]["payload_sha256"] == b["meta"]["payload_sha256"]


def test_files_cross_the_packages_mesh_sizes_and_the_single_chip_engine(runs, tmp_path):
    """The rm=4 files written at level 5 by both packages' mesh engines at
    D = 4 resume to the full pins (8,258 / 1,568) in the port at D = 8 and
    on its single-chip engine, and the port's file in the JAX mesh engine at
    D = 4; a port single-chip file resumes at D = 8, whose file resumes at
    D = 2."""
    port_file, ref_file = runs[1]["sorted"]
    full = (8_258, 1_568)
    for path in (port_file, ref_file):
        for spawn in (dict(mesh=mesh(8)), dict(device="cpu")):
            c = PackedTwoPhaseSys(4).checker().spawn_xla(checkpoint=path, **KW, **spawn).join()
            assert (c.state_count(), c.unique_state_count()) == full
            c.assert_properties()
    r = RefSys(4).checker().spawn_xla(mesh=ref_mesh(4), checkpoint=port_file, **KW).join()
    assert (r.state_count(), r.unique_state_count()) == full
    solo = PackedTwoPhaseSys(4).checker().spawn_xla(device="cpu", levels_per_dispatch=1, **KW)
    for _ in range(5):
        solo._run_block()
    solo.save_checkpoint(str(tmp_path / "solo.npz"))
    m8 = PackedTwoPhaseSys(4).checker().spawn_xla(
        mesh=mesh(8), checkpoint=str(tmp_path / "solo.npz"), levels_per_dispatch=1, **KW)
    assert (m8.state_count(), m8.unique_state_count()) == (solo.state_count(),
                                                           solo.unique_state_count())
    m8._run_block()
    m8.save_checkpoint(str(tmp_path / "m8.npz"))
    m2 = PackedTwoPhaseSys(4).checker().spawn_xla(mesh=mesh(2), checkpoint=str(tmp_path / "m8.npz"),
                                                  **KW).join()
    assert (m2.state_count(), m2.unique_state_count()) == full
    assert m2.metrics()["resumed_from"] == str(tmp_path / "m8.npz")


def test_a_payload_lists_every_shard_in_the_references_order(runs):
    """The payload of a live port checker is its shards' occupied rows,
    shard by shard, and its live frontier rows, shard by shard."""
    port, ref, _ = runs[0][("rm3-d8-fused", "hash")]
    a = checkpoint_arrays(port)
    kh, kl = (np.asarray(getattr(ref._table, n)) for n in ("key_hi", "key_lo"))
    occ = (kh != 0) | (kl != 0)
    assert np.array_equal(a["key_hi"], kh[occ]) and np.array_equal(a["key_lo"], kl[occ])
    assert a["frontier"].shape == (0, port._W)


def test_metrics_hold_the_reference_mesh_engines_key_set(runs):
    port, ref, _ = runs[0][("rm3-d8-fused", "sorted")]
    pm, rm = port.metrics(), ref.metrics()
    assert set(pm) - set(rm) == PORT_EXTRAS and set(rm) <= set(pm)
    for k in ("engine", "dedup", "compaction", "ladder", "cand_ladder_k", "shrink_exit", "shards",
              "frontier_rows_per_shard", "table_slots_per_shard", "route_slots", "state_count",
              "unique_state_count", "depth", "max_depth", "frontier_count", "frontier_capacity",
              "table_capacity", "dispatches", "levels_committed", "table_grows", "route_grows"):
        assert pm[k] == rm[k], k
