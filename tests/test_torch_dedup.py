"""The port's hash and delta visited sets (stateright_tpu_torch/ops/
hashset.py, deltaset.py) against the reference package's on the CPU, and
``spawn_xla(dedup=)`` on the port alone:

- the hash set's plain insert gives the JAX ``hashset.insert``'s planes,
  ``is_new`` and ``overflow`` bit for bit (slot layout included), over
  several batches into one table and through a forced overflow; the cases
  of the reference's ``tests/test_xla_engine.py`` (dedup and lookup,
  in-batch duplicates, inactive lanes, false claim conflicts, the
  batch-proportional claim buffer); the in-place insert's undo;
- the delta set's ``insert``, ``maintain`` and ``grow`` give the JAX
  ``deltaset``'s planes and counts; the cases of the reference's
  ``tests/test_deltaset.py`` (against the other structures, the flush,
  growth, the engine through flushes, growth, a checkpoint, symmetry and
  the tail shrink-exit);
- the engine's refusals, the program key (one model instance runs the
  sorted, hash and delta sets in turn, exact, and a repeat makes no
  program), and the gated level under each structure: no host read, and a
  closed gate leaves the carry bit for bit as it was.

Everything is exact (tolerance 0: integer work). The engine against the
JAX engine, and checkpoints across structures and packages, are in
``test_torch_dedup_engine.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stateright_tpu.ops import deltaset as ref_ds
from stateright_tpu.ops import hashset as ref_hs
from stateright_tpu_torch import graphs
from stateright_tpu_torch import xla as port_xla
from stateright_tpu_torch.graphs import S
from stateright_tpu_torch.models.increment import PackedIncrement
from stateright_tpu_torch.models.two_phase_commit import PackedTwoPhaseSys
from stateright_tpu_torch.ops import deltaset, hashset, sortedset
from stateright_tpu_torch.ops.words import DTYPE, from_u32, to_u32

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


def _words(a):
    return from_u32(np.asarray(a, dtype=np.uint32), "cpu")


def _batch(rng, m, universe, lo_universe=None):
    """Seeded ``(hi, lo, val_hi, val_lo, active)`` as uint32/bool numpy."""
    hi = rng.integers(1, universe, m, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(1, lo_universe or universe, m, dtype=np.uint64).astype(np.uint32)
    vh, vl = (rng.integers(0, 2**32, m, dtype=np.uint64).astype(np.uint32) for _ in range(2))
    return hi, lo, vh, vl, rng.integers(0, 2, m).astype(bool)


def _port(batch):
    *lanes, act = batch
    return [_words(a) for a in lanes] + [torch.as_tensor(act)]


def _ref(batch):
    return [jnp.asarray(a) for a in batch]


# --- the hash set (tests/test_xla_engine.py:29-105) ---------------------------


def test_hashset_insert_dedup_and_lookup():
    hs = hashset.make(256, "cpu")
    rng = np.random.default_rng(1)
    fp_hi = _words(rng.integers(1, 2**32, size=100, dtype=np.uint64))
    fp_lo = _words(rng.integers(1, 2**32, size=100, dtype=np.uint64))
    vals = _words(np.arange(1, 101))
    active = torch.ones(100, dtype=torch.bool)
    hs, is_new, ovf = hashset.insert(hs, fp_hi, fp_lo, vals, vals, active)
    assert int(is_new.sum()) == 100 and not bool(ovf.any())
    hs, is_new2, ovf2 = hashset.insert(hs, fp_hi, fp_lo, vals, vals, active)
    assert int(is_new2.sum()) == 0 and not bool(ovf2.any())
    found, vh, _ = hashset.lookup(hs, fp_hi, fp_lo)
    assert bool(found.all()) and torch.equal(vh, vals)


def test_hashset_in_batch_duplicates_elect_one_winner():
    hs = hashset.make(64, "cpu")
    fp_hi, fp_lo = _words([7, 7, 7, 9]), _words([1, 1, 1, 2])
    vals = _words([10, 20, 30, 40])
    hs, is_new, ovf = hashset.insert(hs, fp_hi, fp_lo, vals, vals, torch.ones(4, dtype=torch.bool))
    assert not bool(ovf.any())
    assert is_new.tolist() == [True, False, False, True]
    found, vh, _ = hashset.lookup(hs, fp_hi[:1], fp_lo[:1])
    assert bool(found[0]) and int(vh[0]) == 10


def test_hashset_inactive_lanes_ignored():
    hs = hashset.make(64, "cpu")
    fp = _words([5, 6])
    hs, is_new, _ = hashset.insert(hs, fp, fp, fp, fp, torch.tensor([True, False]))
    assert is_new.tolist() == [True, False]
    found, _, _ = hashset.lookup(hs, fp, fp)
    assert found.tolist() == [True, False]


def test_hashset_false_claim_conflicts_resolve():
    """m = 4 gives a 16-index claim buffer: slots 3 and 19 share index 3.
    The loser retries next round; every key inserts."""
    hs = hashset.make(1 << 12, "cpu")
    fp_hi = _words([3, 19, 3 + 16 * 7, 1024 + 3])  # lo = 0: the slot is hi
    fp_lo = _words([0, 0, 0, 0])
    vals = _words([1, 2, 3, 4])
    hs, is_new, ovf = hashset.insert(hs, fp_hi, fp_lo, vals, vals, torch.ones(4, dtype=torch.bool))
    assert is_new.tolist() == [True] * 4 and not bool(ovf.any())
    found, vh, _ = hashset.lookup(hs, fp_hi, fp_lo)
    assert bool(found.all()) and torch.equal(vh, vals)
    assert to_u32(hs.key_hi[[3, 19, 3 + 16 * 7, 1024 + 3]]).tolist() == [3, 19, 115, 1027]


@pytest.mark.parametrize("m,cap,want", [(64, 1 << 22, 128), (4, 1 << 12, 16), (3000, 1 << 12, 1 << 12),
                                        (1000, 1 << 20, 2048)])
def test_hashset_claim_buffer_is_batch_proportional(monkeypatch, m, cap, want):
    """The claim buffer is sized by the batch (a power of two of at least 16
    and 2m), capped at the table: an insert into a 2^22-slot table elects
    in a 128-entry buffer, as the reference's jaxpr shows."""
    assert hashset.claim_capacity(m, cap) == want
    seen = []
    full = torch.full

    def spy(size, *args, **kwargs):
        seen.append(size)
        return full(size, *args, **kwargs)

    hs = hashset.make(cap, "cpu")
    monkeypatch.setattr(torch, "full", spy)
    hashset.insert_(hs, *_port(_batch(np.random.default_rng(m), m, 2**32))[:4],
                    torch.ones(m, dtype=torch.bool))
    assert seen and all(s == (want,) for s in seen)


@pytest.mark.parametrize("max_probes", [32, 2])
def test_hashset_plain_insert_equals_the_reference_bit_for_bit(max_probes):
    """Six seeded batches into one table (heavy duplicates, near-unique,
    inactive lanes): every plane, ``is_new`` and ``overflow`` equal the JAX
    insert's, slot layout included. With two probes the table overflows."""
    rng = np.random.default_rng(7)
    ref, port = ref_hs.make(1 << 10, jnp), hashset.make(1 << 10, "cpu")
    overflowed = 0
    for rnd in range(6):
        batch = _batch(rng, 200, 300 if rnd % 2 else 2**32, 40)
        ref, r_new, r_ovf = ref_hs.insert(ref, *_ref(batch), max_probes=max_probes)
        port, p_new, p_ovf = hashset.insert(port, *_port(batch), max_probes=max_probes)
        np.testing.assert_array_equal(np.asarray(r_new), p_new.numpy())
        np.testing.assert_array_equal(np.asarray(r_ovf), p_ovf.numpy())
        for a, b in zip(ref, (port.key_hi, port.key_lo, port.val_hi, port.val_lo)):
            np.testing.assert_array_equal(np.asarray(a), to_u32(b))
        overflowed += int(p_ovf.sum())
    assert (overflowed > 0) == (max_probes == 2)
    assert torch.all(port.ticket == hashset.NO_TICKET)


def test_hashset_one_home_slot_past_the_probe_budget():
    """More distinct keys on one home slot than ``max_probes``: the first
    ``max_probes`` by batch index take the window in order, the rest
    overflow, as in the reference."""
    n, probes = 40, 8
    zeros = np.zeros(n, np.uint32)
    # lo = 0 puts a key's home at hi & (C - 1): slot 5 for every key here.
    batch = (5 + (np.arange(n, dtype=np.uint32) << 12), zeros, np.arange(n, dtype=np.uint32),
             zeros, np.ones(n, bool))
    ref, r_new, r_ovf = ref_hs.insert(ref_hs.make(1 << 12, jnp), *_ref(batch), max_probes=probes)
    port, p_new, p_ovf = hashset.insert(hashset.make(1 << 12, "cpu"), *_port(batch), max_probes=probes)
    assert p_new.tolist() == [True] * probes + [False] * (n - probes)
    assert p_ovf.tolist() == [False] * probes + [True] * (n - probes)
    np.testing.assert_array_equal(np.asarray(r_new), p_new.numpy())
    np.testing.assert_array_equal(np.asarray(r_ovf), p_ovf.numpy())
    np.testing.assert_array_equal(np.asarray(ref.key_hi), to_u32(port.key_hi))


def test_hashset_undo_clears_exactly_what_the_insert_filled():
    rng = np.random.default_rng(3)
    hs = hashset.make(1 << 9, "cpu")
    hashset.insert_(hs, *_port(_batch(rng, 80, 2**32)))
    before = [p.clone() for p in hs]
    batch = _port(_batch(rng, 120, 200))
    is_new, _, filled = hashset.insert_(hs, *batch)
    assert int(is_new.sum()) > 0 and int(filled[0]) == int(is_new.sum())
    hashset.undo_(hs, filled, torch.tensor(True))
    after_keep = [p.clone() for p in hs]
    hashset.undo_(hs, filled, torch.tensor(False))
    assert all(torch.equal(a, b) for a, b in zip(hs, before))
    assert not torch.equal(after_keep[0], before[0])


# --- the delta set (tests/test_deltaset.py:42-157, 198-217) --------------------


def _insert_with_flush(ds, *batch):
    """The engine's protocol: a delta-full insert flushes and retries."""
    out, is_new, ovf = deltaset.insert(ds, *batch)
    if not bool(ovf):
        return out, is_new
    flushed, f_ovf = deltaset.maintain(ds)
    assert not bool(f_ovf), "flush cannot fit main"
    out, is_new, ovf = deltaset.insert(flushed, *batch)
    assert not bool(ovf), "batch alone overflows the delta tier"
    return out, is_new


@pytest.mark.parametrize("universe", [40, 2**31])  # heavy duplicates / near-unique
def test_delta_insert_lookup_differential_vs_other_structures(universe):
    rng = np.random.default_rng(11)
    dl = deltaset.make(1 << 11, "cpu")
    ss = sortedset.make(1 << 12, "cpu")
    hs = hashset.make(1 << 13, "cpu")
    for rnd in range(10):
        batch = _port(_batch(rng, 257, universe))
        dl, d_new = _insert_with_flush(dl, *batch)
        ss, s_new, s_ovf = sortedset.insert(ss, *batch)
        hs, h_new, h_ovf = hashset.insert(hs, *batch)
        assert torch.equal(d_new, s_new) and torch.equal(d_new, h_new), rnd
        assert not bool(s_ovf) and not bool(h_ovf.any())
        q = _words(rng.integers(1, min(universe + 20, 2**32 - 1), 128, dtype=np.uint64))
        for a, b, c in zip(deltaset.lookup(dl, q, q), sortedset.lookup(ss, q, q),
                           hashset.lookup(hs, q, q)):
            assert torch.equal(a, b) and torch.equal(a, c), rnd


def _tiers_invariant(dl):
    for planes, n in ((dl[0:2], int(dl.n_main)), (dl[4:6], int(dl.n_delta))):
        kh, kl = (to_u32(p).astype(np.uint64) for p in planes)
        keys = (kh[:n] << np.uint64(32)) | kl[:n]
        assert np.all(keys[1:] > keys[:-1])
        assert not kh[n:].any() and not kl[n:].any()
    assert torch.equal(dl.main_keys, deltaset._fold_valid(dl.main_key_hi, dl.main_key_lo, dl.n_main))


def test_delta_flush_fires_and_preserves_membership():
    """Batches that overflow the 1,024-row delta tier of a 2^12 main force
    the flush-and-retry protocol; every key stays a member and the tiers
    stay sorted, unique, zero-padded and disjoint."""
    rng = np.random.default_rng(5)
    dl = deltaset.make(1 << 12, "cpu")
    seen = set()
    for _ in range(4):
        hi, lo, vh, vl, act = _batch(rng, 700, 2**31)
        dl, _ = _insert_with_flush(dl, *_port((hi, lo, vh, vl, act)))
        seen |= {(int(h), int(l)) for h, l, a in zip(hi, lo, act) if a}
    assert int(dl.n_main) > 0, "flush never fired"
    _tiers_invariant(dl)
    assert int(dl.n_main) + int(dl.n_delta) == len(seen)
    found, _, _ = deltaset.lookup(dl, _words([k[0] for k in seen]), _words([k[1] for k in seen]))
    assert bool(found.all())


def test_delta_grow_rebuilds_both_tiers():
    rng = np.random.default_rng(7)
    dl = deltaset.make(1 << 11, "cpu")
    hi, lo, vh, vl, act = _port(_batch(rng, 500, 2**31))
    dl, _, _ = deltaset.insert(dl, hi, lo, vh, vl, act)
    n_before = int(dl.n_main) + int(dl.n_delta)
    grown = deltaset.grow(dl, 1 << 13)
    assert grown.main_capacity == 1 << 13
    assert int(grown.n_main) == n_before and int(grown.n_delta) == 0
    found, _, _ = deltaset.lookup(grown, torch.where(act, hi, 1), torch.where(act, lo, 1))
    assert bool(torch.where(act, found, True).all())
    _tiers_invariant(grown)


def _ref_planes(ds):
    return [np.asarray(p).astype(np.int64) for p in (*ds[:8], ds.n_main, ds.n_delta)]


def _port_planes(ds):
    return [p.numpy() for p in (*ds[:8], ds.n_main, ds.n_delta)]


def _same_delta(ref, port, what):
    for i, (a, b) in enumerate(zip(_ref_planes(ref), _port_planes(port))):
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: plane {i}")
    _tiers_invariant(port)


def test_delta_insert_maintain_grow_equal_the_reference():
    """Seeded batches (duplicates, near-unique, inactive lanes) through
    insert, flushes when the delta overflows (the truncated overflow result
    compared too) and a growth: equal main and delta planes and counts."""
    rng = np.random.default_rng(3)
    ref, port = ref_ds.make(1 << 11, jnp), deltaset.make(1 << 11, "cpu")
    flushes = 0
    for rnd in range(10):
        batch = _batch(rng, 257, 300 if rnd % 2 else 2**31)
        r2, r_new, r_ovf = ref_ds.insert(ref, *_ref(batch))
        p2, p_new, p_ovf = deltaset.insert(port, *_port(batch))
        np.testing.assert_array_equal(np.asarray(r_new), p_new.numpy())
        assert bool(r_ovf) == bool(p_ovf)
        for i, (a, b) in enumerate(zip(_ref_planes(r2), _port_planes(p2))):
            np.testing.assert_array_equal(a, b, err_msg=f"insert {rnd}: plane {i}")
        if bool(p_ovf):
            (ref, r_f), (port, p_f) = ref_ds.maintain(ref), deltaset.maintain(port)
            assert bool(r_f) == bool(p_f) is False
            _same_delta(ref, port, f"flush {rnd}")
            flushes += 1
        else:
            ref, port = r2, p2
    assert flushes
    _same_delta(ref_ds.grow(ref, 1 << 12, jnp), deltaset.grow(port, 1 << 12), "grow")


def test_delta_maintain_overflow_equals_the_reference(monkeypatch):
    """A flush that main cannot hold reports overflow in both packages."""
    for mod in (ref_ds, deltaset):
        monkeypatch.setattr(mod, "MIN_DELTA", 64)
    rng = np.random.default_rng(9)
    ref, port = ref_ds.make(64, jnp), deltaset.make(64, "cpu")
    for _ in range(3):
        batch = _batch(rng, 40, 2**31)
        batch = (*batch[:4], np.ones(40, bool))
        ref, _, _ = ref_ds.insert(ref, *_ref(batch))
        port, _, _ = deltaset.insert(port, *_port(batch))
        (rf, r_ovf), (pf, p_ovf) = ref_ds.maintain(ref), deltaset.maintain(port)
        assert bool(r_ovf) == bool(p_ovf)
        if not bool(p_ovf):
            ref, port = rf, pf
    assert bool(p_ovf)


def _counts(c):
    return (c.state_count(), c.unique_state_count(), c.max_depth())


def test_engine_parity_dedup_delta():
    """``dedup="delta"`` reproduces the sorted engine's counts and witness
    paths through flushes (small tiers)."""
    kw = dict(frontier_capacity=1 << 6, table_capacity=1 << 10, **CPU)
    a = PackedTwoPhaseSys(3).checker().spawn_xla(dedup="sorted", **kw).join()
    b = PackedTwoPhaseSys(3).checker().spawn_xla(dedup="delta", **kw).join()
    assert _counts(a) == _counts(b) and b.unique_state_count() == 288
    da, db = a.discoveries(), b.discoveries()
    assert set(da) == set(db) and da
    for name in da:
        assert da[name].into_states() == db[name].into_states()


def test_engine_parity_delta_under_forced_growth():
    kw = dict(frontier_capacity=1 << 6, table_capacity=1 << 7, **CPU)
    a = PackedTwoPhaseSys(4).checker().spawn_xla(dedup="hash", **kw).join()
    b = PackedTwoPhaseSys(4).checker().spawn_xla(dedup="delta", **kw).join()
    assert _counts(a) == _counts(b) and b.unique_state_count() == 1_568
    assert a.metrics()["table_grows"] > 0 and b.metrics()["table_grows"] > 0


def test_checkpoint_crosses_into_delta(tmp_path):
    path = str(tmp_path / "ck.npz")
    a = PackedTwoPhaseSys(3).checker().spawn_xla(dedup="sorted", levels_per_dispatch=1, **CPU)
    for _ in range(4):
        a._run_block()
    a.save_checkpoint(path)
    b = PackedTwoPhaseSys(3).checker().spawn_xla(dedup="delta", checkpoint=path, **CPU).join()
    full = PackedTwoPhaseSys(3).checker().spawn_xla(dedup="delta", **CPU).join()
    assert _counts(b) == _counts(full) == (1146, 288, 11)


@pytest.mark.parametrize("dedup", ["hash", "delta"])
def test_engine_parity_symmetry(dedup):
    a = PackedIncrement(3).checker().symmetry().spawn_xla(dedup="sorted", **CPU).join()
    b = PackedIncrement(3).checker().symmetry().spawn_xla(dedup=dedup, **CPU).join()
    assert _counts(a) == _counts(b) == (27, 17, 5)


def test_engine_delta_flushes_during_tail_shrink(monkeypatch):
    """rm=5 with a 256-row delta tier forces many host-invoked flushes and
    the empty-delta growth cascade while the block's tail shrink-exit
    downshifts buckets: exact counts and an observed downshift."""
    from test_ladder import assert_tail_downshift

    monkeypatch.setattr(deltaset, "DELTA_SHIFT", 6)
    monkeypatch.setattr(deltaset, "MIN_DELTA", 256)
    c = PackedTwoPhaseSys(5).checker().spawn_xla(
        dedup="delta", frontier_capacity=1 << 13, table_capacity=1 << 14, **CPU).join()
    assert _counts(c) == (58_146, 8_832, 17)
    assert int(c._table.n_main) > 0 and c.metrics()["delta_flushes"] > 0
    assert c._table.delta_capacity > 256
    assert_tail_downshift(c.dispatch_log)


# --- the engine's surface ---------------------------------------------------------


def test_unknown_dedup_and_a_ladder_under_hash_raise_the_references_errors():
    with pytest.raises(ValueError, match=r"dedup must be 'auto', 'hash', 'sorted', or 'delta': 'bloom'"):
        PackedTwoPhaseSys(3).checker().spawn_xla(dedup="bloom", **CPU)
    with pytest.raises(ValueError, match="cand_ladder runs in the plane-major engine"):
        PackedTwoPhaseSys(3).checker().spawn_xla(dedup="hash", cand_ladder=3, **CPU)
    c = PackedTwoPhaseSys(3).checker().spawn_xla(dedup="hash", **CPU)
    assert c.metrics()["cand_ladder_k"] == 1 and c.metrics()["dedup"] == "hash"
    assert PackedTwoPhaseSys(3).checker().spawn_xla(**CPU).metrics()["dedup"] == "sorted"


def test_one_model_instance_runs_every_structure_and_a_repeat_makes_no_program():
    """Sorted, hash, delta and sorted again on one model instance: each
    exact, with its own carry and programs, and the fourth check makes no
    program (the program key holds the structure)."""
    m = PackedTwoPhaseSys(4)
    cache = graphs.cache_for(m, torch.device("cpu"))
    runs = []
    for dedup in ("sorted", "hash", "delta", "sorted"):
        before = set(cache.programs)
        c = m.checker().spawn_xla(dedup=dedup, **CPU).join()
        assert (c.state_count(), c.unique_state_count()) == (8_258, 1_568), dedup
        assert c.metrics()["dedup"] == dedup
        runs.append((dedup, set(cache.programs) - before))
    assert {k[6] for k in cache.programs} == {"sorted", "hash", "delta"}
    assert {k[3] for k in cache.carries} == {"sorted", "hash", "delta"}
    assert all(new for _, new in runs[:3]) and runs[3][1] == set()
    assert all(k[6] == dedup for dedup, new in runs[:3] for k in new)


def test_one_paxos_instance_holds_two_graph_sets():
    """ROADMAP C2 at a CPU size: one Paxos 2c/3s instance checked to depth
    10 under the sorted set, then the hash set, then the sorted set again,
    each equal to the first level by level and in its witnesses; the hash
    run makes its own programs beside the sorted run's and the third check
    makes none. (The card's case, a second graph set at Paxos 3c/3s's
    widest bucket on one instance, is ``chip_smoke.py``'s ``paxos3_hash``:
    CUDA graphs and their memory pool exist only there.)"""
    from stateright_tpu_torch.models.paxos import PackedPaxos

    def search(c):
        return (c.state_count(), c.unique_state_count(), c.max_depth(),
                [(r["depth"], r["frontier"], r["generated"], r["unique"]) for r in c.level_log],
                {n: p.into_actions() for n, p in c.discoveries().items()})

    m = PackedPaxos(2, 3)
    cache = graphs.cache_for(m, torch.device("cpu"))
    made, runs = [], []
    for dedup in ("sorted", "hash", "sorted"):
        before = set(cache.programs)
        c = m.checker().target_max_depth(10).spawn_xla(dedup=dedup, **CPU).join()
        assert c.metrics()["dedup"] == dedup
        runs.append(search(c))
        made.append(set(cache.programs) - before)
    assert runs[0][:2] == (3_314, 1_919)  # the JAX engine's at this depth
    assert runs[1] == runs[0] and runs[2] == runs[0]
    assert made[0] and made[1] and made[2] == set()
    assert {k[6] for k in made[1]} == {"hash"}
    assert {k[6] for k in cache.programs} == {"sorted", "hash"}


def test_the_capture_counts_the_idle_blocks_outside_its_own_pool(monkeypatch):
    """A capture empties the allocator's cache first for what that can hand
    back and its own pool cannot reuse: the unused blocks on the capture's
    card of the default pool and of other graph pools (a dead instance's,
    whose pool is freed by the emptying), not its own pool's free blocks
    (its live graphs keep them) nor another card's."""
    mib = 1 << 20

    class Pool:
        id = (1, 4)

    segments = [
        {"device": 0, "segment_pool_id": (0, 0), "total_size": 8 * mib, "allocated_size": 2 * mib},
        {"device": 0, "segment_pool_id": (1, 4), "total_size": 64 * mib, "allocated_size": 0},
        {"device": 0, "segment_pool_id": (2, 7), "total_size": 16 * mib, "allocated_size": 4 * mib},
        {"device": 1, "segment_pool_id": (0, 0), "total_size": 32 * mib, "allocated_size": 0},
        {"device": 0, "segment_pool_id": [0, 0], "total_size": 2 * mib, "allocated_size": 2 * mib},
    ]
    monkeypatch.setattr(torch.cuda, "memory_snapshot", lambda: segments)
    assert graphs.releasable_idle(torch.device("cuda", 0), Pool()) == 18 * mib
    assert graphs.releasable_idle(torch.device("cuda", 1), Pool()) == 32 * mib


def test_a_growth_retires_the_graph_pool_only_when_no_graph_is_left():
    """``ProgramCache.drop`` (a table growth) hands the graph pool back and
    starts another only when the cache holds no graph afterwards: another
    structure's graphs keep the pool, and an eager program holds none."""
    cache = graphs.ProgramCache(torch.device("cpu"))
    key = lambda cap, dedup: (64, 64, 1024, cap, 32, 0, dedup, 8, None)  # noqa: E731
    assert not cache.holds_graph()
    cache.programs[key(1024, "sorted")] = graphs.Program(None, graph=object())
    cache.programs[key(4096, "hash")] = graphs.Program(None, graph=object())
    cache.programs[key(8192, "delta")] = graphs.Program(None)
    cache.drop((1024, 32, 0, "sorted"))
    assert cache.holds_graph() and key(1024, "sorted") not in cache.programs
    cache.drop((4096, 32, 0, "hash"))
    assert not cache.holds_graph() and list(cache.programs) == [key(8192, "delta")]
    cache.shard_programs[("shard",)] = graphs.Program(None, graph=object())
    assert cache.holds_graph()


def test_each_structure_keeps_its_own_capacity_hint(monkeypatch):
    monkeypatch.setattr(port_xla, "DEFAULT_TABLE_CAPACITY", 64)
    m = PackedTwoPhaseSys(4)
    for dedup in ("hash", "delta"):
        first = m.checker().spawn_xla(dedup=dedup, **CPU).join()
        assert first.metrics()["table_grows"] > 0
        again = m.checker().spawn_xla(dedup=dedup, **CPU).join()
        assert again.metrics()["table_grows"] == 0
        assert again.metrics()["table_capacity"] == first.metrics()["table_capacity"]
    hints = {k: v for k, v in m.__dict__.items() if k.startswith(port_xla.TABLE_HINT)}
    assert set(hints) == {"_xla_table_cap_hint_hash", "_xla_table_cap_hint_delta"}
    assert all(v & (v - 1) == 0 for v in hints.values())  # make() takes them
    # ``capacity_hints`` reads the hint the structure's checker starts at.
    for dedup in ("hash", "delta"):
        want = {"table_capacity": hints[f"_xla_table_cap_hint_{dedup}"]}
        assert port_xla.capacity_hints(m, dedup).items() >= want.items()
    assert "table_capacity" not in port_xla.capacity_hints(m, "sorted")


def _carry_for(dedup, **kw):
    """A rm=3 checker's carry loaded for its first block."""
    c = PackedTwoPhaseSys(3).checker().spawn_xla(dedup=dedup, **kw, **CPU)
    carry = c._program(64).carry
    c._load(carry, 64, budget=32, remaining=port_xla.NO_TARGET, shrink_below=0)
    return c, carry


@pytest.mark.parametrize("dedup", ["hash", "delta"])
def test_a_closed_gate_leaves_the_carry_bit_for_bit(dedup):
    """A dead level inserts nothing into the hash set's planes, in place,
    and leaves every buffer of the carry as it was; with the gate open the
    level commits."""
    c, carry = _carry_for(dedup)
    carry.s[S["budget"]] = 0
    carry.s[S["live"]] = c._live(carry.s, carry.disc_found, carry.host_found)
    before = [t.clone() for t in carry.tensors()]
    c._gated_level(carry, 64, c._cand_cap_for(64))
    assert all(torch.equal(a, b) for a, b in zip(carry.tensors(), before))
    c, carry = _carry_for(dedup)
    c._gated_level(carry, 64, c._cand_cap_for(64))
    assert int(carry.s[S["committed"]]) == 1 and int(carry.s[S["tot_unique"]]) == 7
    assert sum(bool((p != 0).any()) for p in carry.table) > 0


def test_an_uncommitted_hash_level_is_undone():
    """A level that overflows the table commits nothing: the winners the
    hash set's in-place insert wrote are cleared again, and the carry is
    bit for bit as loaded. (rm=3's seven successors of the init state
    into 16 slots at one probe collide.)"""
    c, carry = _carry_for("hash", table_capacity=16, max_probes=1)
    before = [t.clone() for t in carry.tensors()]
    c._gated_level(carry, 64, c._cand_cap_for(64))
    assert int(carry.s[S["t_ovf"]]) == 1 and int(carry.s[S["committed"]]) == 0
    after = carry.tensors()
    assert all(torch.equal(a, b) for a, b in zip(after[1:], before[1:]))
    # Of the block scalars only the overflow flag and the gate moved.
    moved = {k for k in graphs.SLOTS if after[0][S[k]] != before[0][S[k]]}
    assert moved == {"t_ovf", "live"}


@pytest.mark.parametrize("dedup", ["hash", "delta"])
def test_the_gated_level_reads_nothing_on_the_host(monkeypatch, dedup):
    """On the meta device every host read raises, so a gated level that runs
    there can be captured into a CUDA graph. The kernels are replaced by
    stand-ins of their output shapes."""

    def fake_compact(mask, lanes, cap):
        return (torch.empty((len(lanes), cap), dtype=DTYPE, device=mask.device),
                torch.empty((), dtype=DTYPE, device=mask.device))

    def fake_merge(table, batch):
        return (torch.empty_like(table),
                torch.empty(batch.shape[1], dtype=torch.bool, device=table.device),
                torch.empty((), dtype=DTYPE, device=table.device))

    def fake_insert(hs, hi, lo, vh, vl, active, max_probes=32):
        m = hi.shape[0]
        return (torch.empty(m, dtype=torch.bool, device=hi.device),
                torch.empty(m, dtype=torch.bool, device=hi.device),
                torch.empty(m + 2, dtype=torch.int32, device=hi.device))

    c = PackedTwoPhaseSys(3).checker().spawn_xla(dedup=dedup, **CPU)
    monkeypatch.setattr(port_xla, "compact", fake_compact)
    monkeypatch.setattr(deltaset, "merge_insert", fake_merge)
    monkeypatch.setattr(hashset, "insert_", fake_insert)
    monkeypatch.setattr(hashset, "undo_", lambda hs, filled, keep: None)
    meta = torch.device("meta")
    monkeypatch.setattr(c, "_device", meta)
    carry = graphs.Carry(meta, c._W, c._P, 32, 1024, dedup=dedup)
    c._gated_level(carry, 256, 2048)
    with pytest.raises(RuntimeError, match="meta"):
        bool(carry.s[S["live"]])
