"""The reference's compaction lowerings (``spawn_xla(compaction=)``)
against the port on the CPU. The port's engine compacts with the kernel
alone (``"pallas"``); the reference's ``"gather"``, ``"sort"`` and
``"bsearch"`` are functions in ``stateright_tpu_torch/ops/compact.py``,
the kernel's yardsticks, and not engine options (ROADMAP A11):

- each of ``compact_gather``, ``compact_sort`` and ``compact_bsearch``
  equals ``compact_plain`` on seeded cases: rank-1 and rank-2 masks, grid
  planes as strided views and per-state lanes broadcast with stride 0,
  ``cap`` below, at and above the mask's length, all-false and all-true
  masks, lane words up to ``2**32 - 1`` and words outside ``[0, 2**32)``
  in dropped slots, zeros past the survivors; and each reads nothing on
  the host (the meta device), so a CUDA graph can capture it;
- the port's engine equals the reference's run under each of its four
  lowerings (``tests/test_sortedset.py:227``,
  ``tests/test_pallas_compact.py:45``): 2pc rm=3 by counts, per-level
  rows, discoveries and witness paths, and a wide model (Paxos 2c/3s,
  W = 25) against ``"sort"`` and ``"bsearch"``;
- checkpoints carry no lowering, in either package, and a file saved
  under one lowering resumes in the other package;
- under the hash set the port runs the kernel, where the reference
  refuses ``"pallas"`` (its rows engine);
- every ``level_log`` row of the rm=3 runs under the sorted, delta and
  hash sets carries ``lane_words``, the reference's ``insert_lane_words``
  under its merge kernel (ROADMAP C1).

The reference runs are the expensive part (a CPU compile each), so each
configuration runs once, in module-scoped fixtures. Everything is exact
(tolerance 0: integer work)."""

from dataclasses import astuple

import numpy as np
import pytest
import torch

from stateright_tpu import checkpoint as ref_ck
from stateright_tpu.models import two_phase_commit as ref
from stateright_tpu.models.paxos import PackedPaxos as RefPaxos
from stateright_tpu_torch import checkpoint as ck
from stateright_tpu_torch.models import two_phase_commit as port
from stateright_tpu_torch.models.paxos import PackedPaxos
from stateright_tpu_torch.ops import sortedset as port_ss
from stateright_tpu_torch.ops.compact import LOWERINGS, compact_plain
from stateright_tpu_torch.ops.words import DTYPE
from stateright_tpu_torch.xla import UNPORTED_COMPACTIONS

CPU = dict(device="cpu")
#: ``tests/test_sortedset.py:227``'s engine settings.
KW = dict(frontier_capacity=1 << 6, table_capacity=1 << 9, dedup="sorted")
RM3 = (1_146, 288, 11)
#: The reference's four lowerings.
ORDER = ("gather", "sort", "bsearch", "pallas")
TENSOR_LOWERINGS = list(LOWERINGS.values())
#: Paxos 2c/3s cut at depth 6: the wide-W case at a CPU compile's cost.
PAXOS = dict(frontier_capacity=1 << 8, table_capacity=1 << 10, dedup="sorted")
PAXOS_DEPTH = 6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test process: the suite runs several test
    processes on one machine, and torch's default of a thread per core in
    each oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _final(c):
    return c.state_count(), c.unique_state_count(), c.max_depth()


def _levels(c):
    return [(r["depth"], r["frontier"], r["generated"], r["unique"]) for r in c.level_log]


def _assert_same_search(want, got):
    assert _final(got) == _final(want)
    assert _levels(got) == _levels(want)
    wd, gd = want.discoveries(), got.discoveries()
    assert set(gd) == set(wd) and gd
    for name in wd:
        assert [astuple(s) for s in gd[name].into_states()] == [
            astuple(s) for s in wd[name].into_states()]
        assert gd[name].into_actions() == wd[name].into_actions()


# --- the lowerings as functions ----------------------------------------------


def _words(rng, shape):
    """Seeded 32-bit words as int64, the extremes included."""
    w = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.int64)
    w.reshape(-1)[:2] = [0, 2**32 - 1]
    return torch.from_numpy(w)


def _grid_case(seed, f, a, density, cap):
    """The engine's grid compaction: the planes of an [F, A, W] grid
    (strided views) and three per-state lanes broadcast over A (stride 0)."""
    rng = np.random.default_rng(seed)
    grid = _words(rng, (f, a, 3))
    per_state = _words(rng, (3, f))
    mask = torch.from_numpy(rng.random((f, a)) < density)
    lanes = [grid[:, :, w] for w in range(3)] + [p[:, None].expand(f, a) for p in per_state]
    return mask, lanes, cap


def _stray_case(seed, m, cap):
    """Words outside ``[0, 2**32)`` (negative, bit 63 set, and past 32
    bits) in the slots the mask drops, 32-bit words in the kept ones."""
    rng = np.random.default_rng(seed)
    mask = torch.from_numpy(rng.random(m) < 0.5)
    mask[:3] = False
    lanes = []
    for _ in range(3):
        w = _words(rng, m)
        stray = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, m, dtype=np.int64))
        stray[:3] = torch.tensor([-1, -2**63, 2**40])
        lanes.append(torch.where(mask, w, stray))
    return mask, lanes, cap


def _flat_case(seed, m, density, cap):
    """The frontier compaction: a rank-1 mask over contiguous lanes, one
    of them a stride-0 broadcast of one word."""
    rng = np.random.default_rng(seed)
    mask = torch.from_numpy(rng.random(m) < density)
    return mask, list(_words(rng, (3, m))) + [torch.tensor(2**32 - 1).expand(m)], cap


CASES = {
    "grid_cap_below": lambda: _grid_case(1, 37, 11, 0.4, 64),
    "grid_cap_at_m": lambda: _grid_case(2, 37, 11, 0.4, 37 * 11),
    "grid_cap_above_m": lambda: _grid_case(3, 13, 5, 0.6, 1 << 8),
    "grid_all_false": lambda: _grid_case(4, 16, 9, 0.0, 32),
    "grid_all_true": lambda: _grid_case(5, 16, 9, 1.0, 32),
    "flat_cap_below": lambda: _flat_case(6, 1000, 0.3, 128),
    "flat_cap_at_m": lambda: _flat_case(7, 1000, 0.3, 1000),
    "flat_cap_above_m": lambda: _flat_case(8, 300, 0.5, 1 << 10),
    "flat_all_false": lambda: _flat_case(9, 257, 0.0, 64),
    "flat_all_true": lambda: _flat_case(10, 257, 1.0, 512),
    "flat_one_slot": lambda: _flat_case(11, 1, 1.0, 4),
    "flat_stray_words_dropped": lambda: _stray_case(13, 500, 300),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("lowering", TENSOR_LOWERINGS, ids=lambda f: f.__name__)
def test_each_lowering_equals_the_plain_version(lowering, case):
    mask, lanes, cap = CASES[case]()
    want, n_want = compact_plain(mask, lanes, cap)
    got, n_got = lowering(mask, lanes, cap)
    assert n_got.dtype == torch.int64 and n_got.shape == ()
    assert int(n_got) == int(n_want) == int(mask.sum())
    assert got.dtype == torch.int64 and got.shape == (len(lanes), cap)
    assert torch.equal(got, want)
    kept = min(int(n_want), cap)
    assert not got[:, kept:].any()  # zero past the survivors
    flat = mask.reshape(-1).nonzero().squeeze(1)[:kept]
    for p, lane in enumerate(lanes):  # survivors in array order
        assert torch.equal(got[p, :kept], lane.reshape(-1)[flat])


def test_the_lowerings_make_no_stacked_copy_and_leave_their_inputs():
    mask, lanes, cap = _grid_case(12, 21, 7, 0.5, 64)
    before = [lane.clone() for lane in lanes]
    for lowering in TENSOR_LOWERINGS:
        lowering(mask, lanes, cap)
        assert all(torch.equal(a, b) for a, b in zip(lanes, before))
        assert lanes[-1].stride() == (1, 0)


def test_the_lowerings_refuse_what_compact_refuses():
    mask = torch.ones(8, dtype=torch.bool)
    for lowering in TENSOR_LOWERINGS:
        with pytest.raises(ValueError, match="rank 1 or 2"):
            lowering(torch.ones((2, 2, 2), dtype=torch.bool), [torch.zeros((2, 2, 2))], 4)
        with pytest.raises(ValueError, match="int64 tensor of the mask's shape"):
            lowering(mask, [torch.zeros(8, dtype=torch.int32)], 4)
    assert set(LOWERINGS) == set(ORDER) - {"pallas"}


@pytest.mark.parametrize("lowering", TENSOR_LOWERINGS, ids=lambda f: f.__name__)
def test_each_lowering_reads_nothing_on_the_host(lowering):
    """On the meta device every host read raises, so a lowering that runs
    there can be captured into a CUDA graph: the grid's shape (strided
    planes and stride-0 lanes) and the frontier's."""
    meta = torch.device("meta")
    grid = torch.empty((256, 42, 5), dtype=DTYPE, device=meta)
    mask = torch.empty((256, 42), dtype=torch.bool, device=meta)
    lanes = [grid[:, :, w] for w in range(5)] + [
        torch.empty(256, dtype=DTYPE, device=meta)[:, None].expand(256, 42)]
    flat = [plane.reshape(-1) for plane in grid.unbind(2)]
    for m, ls, cap in ((mask, lanes, 2048), (mask.reshape(-1), flat, 256)):
        out, n = lowering(m, ls, cap)
        assert out.shape == (len(ls), cap) and n.shape == ()
        with pytest.raises(RuntimeError, match="meta"):
            bool(n)


# --- the engine against the JAX package ----------------------------------------


@pytest.fixture(scope="module")
def ref_rm3():
    """The reference's rm=3 under each lowering (its CPU compiles, once)."""
    return {c: ref.PackedTwoPhaseSys(3).checker().spawn_xla(compaction=c, **KW).join()
            for c in ORDER}


@pytest.fixture(scope="module")
def port_rm3():
    return port.PackedTwoPhaseSys(3).checker().spawn_xla(**KW, **CPU).join()


@pytest.mark.parametrize("compaction", ORDER)
def test_rm3_equals_the_references_run_under_each_lowering(ref_rm3, port_rm3, compaction):
    r, c = ref_rm3[compaction], port_rm3
    assert _final(c) == _final(r) == RM3
    assert r.metrics()["compaction"] == compaction
    assert c.metrics()["compaction"] == "pallas"
    _assert_same_search(r, c)
    c.assert_properties()
    for name, path in c.discoveries().items():
        c.assert_discovery(name, path.into_actions())


@pytest.fixture(scope="module")
def port_rm3_by_structure(port_rm3):
    """The port's rm=3 under each visited set at the lowering tests'
    capacities (the sorted run is ``port_rm3``)."""
    spawn = port.PackedTwoPhaseSys(3).checker().spawn_xla
    return {"sorted": port_rm3,
            **{d: spawn(**dict(KW, dedup=d), **CPU).join() for d in ("delta", "hash")}}


@pytest.mark.parametrize("dedup", ("sorted", "delta", "hash"))
def test_lane_words_are_the_references_under_its_merge_kernel(port_rm3_by_structure, dedup,
                                                             monkeypatch):
    """ROADMAP C1: every ``level_log`` row carries ``lane_words``, the
    reference's ``insert_lane_words`` at the row's table capacity and
    ``cand_cap`` under the setting in which its engine runs the merge
    kernel (``STPU_SORTEDSET_INSERT=pallas``, ``"sort"`` values, as on an
    accelerator; ``"pallas"`` compaction adds no term), and 0 under the
    hash set (the reference's rows engine). No reference run: its
    functions, with its module's knobs set for the test."""
    from types import SimpleNamespace

    from stateright_tpu.ops import deltaset as ref_ds
    from stateright_tpu.ops import sortedset as ref_ss

    monkeypatch.setattr(ref_ss, "INSERT_VIA", "pallas")
    monkeypatch.setattr(ref_ss, "VALUES_VIA", "sort")
    c = port_rm3_by_structure[dedup]
    assert _final(c) == RM3
    t = c._table
    if dedup != "hash":
        # No growth: every row's table is the final one.
        assert c.metrics()["table_grows"] == 0
    for r in c.level_log:
        if dedup == "sorted":
            want = ref_ss.insert_lane_words(SimpleNamespace(capacity=t.capacity), r["cand_cap"])
        elif dedup == "delta":
            want = ref_ds.insert_lane_words(SimpleNamespace(delta_capacity=t.delta_capacity),
                                            r["cand_cap"])
        else:
            want = 0
        assert r["lane_words"] == want, (dedup, r)
    if dedup == "sorted":
        # Both of the reference's branches: the kernel's batch words at the
        # run's 2,048-row candidate buffers, its sort lowering below 512.
        assert {r["lane_words"] for r in c.level_log} == {2_048 * 7}
        assert port_ss.insert_lane_words(t, 256) == (t.capacity + 256) * 12 == ref_ss.insert_lane_words(
            SimpleNamespace(capacity=t.capacity), 256)


@pytest.fixture(scope="module")
def port_paxos():
    return PackedPaxos(2, 3).checker().target_max_depth(PAXOS_DEPTH).spawn_xla(
        **PAXOS, **CPU).join()


@pytest.mark.parametrize("compaction", ["sort", "bsearch"])
def test_a_wide_model_equals_the_references_sort_and_bsearch(port_paxos, compaction):
    """Paxos 2c/3s (W = 25, A = 132), where the reference's ``"sort"``
    grid is a 26-operand sort and its ``"bsearch"`` a search of the
    grid's running count."""
    r = RefPaxos(2, 3).checker().target_max_depth(PAXOS_DEPTH).spawn_xla(
        compaction=compaction, **PAXOS).join()
    c = port_paxos
    assert _final(c) == _final(r) == (151, 103, PAXOS_DEPTH)
    assert _levels(c) == _levels(r)
    assert c.dispatch_log == r.dispatch_log
    want, got = r.discoveries(), c.discoveries()
    assert set(got) == set(want)
    for name in want:
        assert [c.model().pack(s).tolist() for s in got[name].into_states()] == [
            r.model().pack(s).tolist() for s in want[name].into_states()]


# --- checkpoints ---------------------------------------------------------------


def _partial(checker, levels=4):
    for _ in range(levels):
        checker._run_block()
    return checker


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """rm=3 stopped after 4 levels: saved by the port and by the reference
    under ``"sort"``."""
    d = tmp_path_factory.mktemp("ckpt")
    mine, theirs = str(d / "port.npz"), str(d / "ref_sort.npz")
    _partial(port.PackedTwoPhaseSys(3).checker().spawn_xla(
        levels_per_dispatch=1, **KW, **CPU)).save_checkpoint(mine)
    _partial(ref.PackedTwoPhaseSys(3).checker().spawn_xla(
        compaction="sort", levels_per_dispatch=1, **KW)).save_checkpoint(theirs)
    return {"port": mine, "reference": theirs}


def test_no_checkpoint_names_a_lowering(saved):
    """The reference writes no compaction into a file, and the port keeps
    it so: the payload and meta of the two saves of one search agree."""
    got, want = ck.load_checkpoint(saved["port"]), ref_ck.load_checkpoint(saved["reference"])
    for data in (got, want):
        meta = dict(data["meta"])
        assert not any("compaction" in str(k) or "compaction" in str(v) for k, v in meta.items())
        assert not any("compaction" in k for k in data)
    for key in ck.PAYLOAD_KEYS:
        assert np.array_equal(got[key], want[key]), key


def test_a_reference_sort_save_resumes_in_the_port(saved):
    c = port.PackedTwoPhaseSys(3).checker().spawn_xla(
        checkpoint=saved["reference"], **KW, **CPU).join()
    assert _final(c) == RM3
    assert c.metrics()["resumed_from"] == saved["reference"]
    c.assert_properties()


def test_a_port_save_resumes_in_the_reference_under_bsearch(saved):
    r = ref.PackedTwoPhaseSys(3).checker().spawn_xla(
        checkpoint=saved["port"], compaction="bsearch", **KW).join()
    assert _final(r) == RM3


# --- C1: the hash set and the kernel ---------------------------------------------


@pytest.fixture(scope="module")
def ref_hash():
    return ref.PackedTwoPhaseSys(3).checker().spawn_xla(dedup="hash").join()


@pytest.mark.parametrize("compaction", ORDER + ("auto",))
def test_the_hash_set_runs_the_kernel(ref_hash, compaction):
    """A logged difference (ROADMAP): the reference refuses
    ``compaction="bsearch"`` and ``"pallas"`` under ``dedup="hash"``
    (``tests/test_pallas_compact.py:65``), because its hash set runs in a
    rows engine that never reads the knob, and resolves ``"auto"`` there
    to ``"gather"`` or ``"sort"``. The port's hash set runs in its one
    plane-major engine, so ``"pallas"`` and ``"auto"`` run the kernel to
    the reference's hash run's counts, and the names the engine does not
    take raise there as under every visited set."""
    spawn = port.PackedTwoPhaseSys(3).checker().spawn_xla
    if compaction in UNPORTED_COMPACTIONS:
        with pytest.raises(ValueError, match="not an engine option of the port"):
            spawn(dedup="hash", compaction=compaction, **CPU)
        return
    c = spawn(dedup="hash", compaction=compaction, **CPU).join()
    assert _final(c) == _final(ref_hash) == RM3
    assert c.metrics()["compaction"] == "pallas"
    assert c.metrics()["dedup"] == "hash"
    assert c.discoveries().keys() == ref_hash.discoveries().keys()
