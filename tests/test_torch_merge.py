"""The plain version of the port's merge-insert
(stateright_tpu_torch/ops/merge.py) against the reference TPU kernel
(stateright_tpu/ops/pallas_merge.py, in interpret mode), and the port's
sorted set against the reference package's under both of its insert
lowerings: exact comparison, tolerance 0 (integer work)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.ops import sortedset as ref_ss
from stateright_tpu.ops.pallas_merge import merge_insert as ref_merge
from stateright_tpu_torch.ops import sortedset
from stateright_tpu_torch.ops.merge import merge_insert
from stateright_tpu_torch.ops.words import from_u32, to_u32

FULL = 0xFFFFFFFF
B, C, M = 256, 1024, 512


def _mk(rng, n_table, n_cand, key_space, c=C, m=M):
    """A sorted table and a (key, ticket)-sorted batch, pads all-ones (the
    fixtures of the reference kernel's own tests)."""
    tk = np.sort(rng.choice(key_space, n_table, replace=False)).astype(np.uint64)
    table = np.full((4, c), FULL, np.uint32)
    table[0, :n_table] = (tk >> 16).astype(np.uint32)
    table[1, :n_table] = (tk & 0xFFFF).astype(np.uint32)
    table[2, :n_table] = rng.integers(0, 2**32, n_table, dtype=np.uint32)
    table[3, :n_table] = rng.integers(0, 2**32, n_table, dtype=np.uint32)
    ck = rng.choice(key_space, n_cand, replace=True).astype(np.uint64)
    order = np.argsort(ck, kind="stable")
    batch = np.full((4, m), FULL, np.uint32)
    batch[0, :n_cand] = (ck >> 16).astype(np.uint32)[order]
    batch[1, :n_cand] = (ck & 0xFFFF).astype(np.uint32)[order]
    batch[2, :n_cand] = rng.integers(0, 2**32, n_cand, dtype=np.uint32)
    batch[3, :n_cand] = rng.integers(0, 2**32, n_cand, dtype=np.uint32)
    return table, batch


def _both(table, batch):
    mg, kb, nk = ref_merge(jnp.asarray(table), jnp.asarray(batch), block=B, interpret=True)
    pm, pk, pn = merge_insert(from_u32(table, "cpu"), from_u32(batch, "cpu"))
    return (np.asarray(mg), np.asarray(kb), int(nk)), (to_u32(pm), pk.numpy(), int(pn))


def _assert_same(ref, port, c=C):
    (mg, kb, nk), (pm, pk, pn) = ref, port
    assert pn == nk
    assert np.array_equal(pk, kb)
    rows = min(nk, c)
    assert np.array_equal(pm[:, :rows], mg[:, :rows])


@pytest.mark.parametrize("trial", range(4))
def test_plain_matches_pallas_interpret(trial):
    rng = np.random.default_rng(100 + trial)
    n_t = int(rng.integers(0, 900))
    n_c = int(rng.integers(0, 500))
    ks = rng.choice(2**20, 2000, replace=False)
    table, batch = _mk(rng, n_t, n_c, ks)
    _assert_same(*_both(table, batch))


def test_overflow_reports_total_and_flags():
    rng = np.random.default_rng(3)
    tk = np.sort(rng.choice(2**20, 400, replace=False)).astype(np.uint64)
    ck = np.sort(np.setdiff1d(
        rng.choice(2**20, 400, replace=False).astype(np.uint64), tk
    )[:200])
    table = np.full((4, 512), FULL, np.uint32)
    batch = np.full((4, M), FULL, np.uint32)
    table[0, :400] = (tk >> 16).astype(np.uint32)
    table[1, :400] = (tk & 0xFFFF).astype(np.uint32)
    batch[0, :200] = (ck >> 16).astype(np.uint32)
    batch[1, :200] = (ck & 0xFFFF).astype(np.uint32)
    ref, port = _both(table, batch)
    assert port[2] == 600 > 512
    _assert_same(ref, port, c=512)


def test_empty_inputs_and_a_duplicate_run_across_blocks():
    rng = np.random.default_rng(5)
    tk = np.sort(rng.choice(2**20, 300, replace=False)).astype(np.uint64)
    table = np.full((4, C), FULL, np.uint32)
    table[0, :300] = (tk >> 16).astype(np.uint32)
    table[1, :300] = (tk & 0xFFFF).astype(np.uint32)
    empty = np.full((4, M), FULL, np.uint32)
    _assert_same(*_both(table, empty))
    _assert_same(*_both(np.full((4, C), FULL, np.uint32), empty))
    batch = empty.copy()
    batch[0, :300] = 5
    batch[1, :300] = 9
    batch[2, :300] = np.arange(300, dtype=np.uint32)
    ref, port = _both(table, batch)
    _assert_same(ref, port)
    assert port[2] == 301 and port[1][0] and not port[1][1:].any()


def _random_set(rng, cap, n0, keys):
    return (
        (keys[:n0] >> 8).astype(np.uint32),
        (keys[:n0] & 0xFF).astype(np.uint32),
        rng.integers(0, 2**32, n0, dtype=np.uint32),
        rng.integers(0, 2**32, n0, dtype=np.uint32),
    )


@pytest.mark.parametrize("via", ["sort", "pallas"])
@pytest.mark.parametrize("trial", range(3))
def test_insert_matches_reference_sortedset(monkeypatch, via, trial):
    """Batches with in-batch duplicates, table hits and inactive rows:
    table planes, n, is_new (batch order) and overflow all equal."""
    rng = np.random.default_rng(11 + trial)
    cap, m = 512, 256
    monkeypatch.setenv("STPU_PALLAS_BLOCK", "64")
    monkeypatch.setattr(ref_ss, "INSERT_VIA", via)
    n0 = int(rng.integers(0, cap // 2))
    keys = rng.choice(2**18, n0 + m, replace=False).astype(np.uint64)
    entries = _random_set(rng, cap, n0, keys)
    pick = rng.integers(0, n0 + m, m)
    bh = (keys[pick] >> 8).astype(np.uint32)
    bl = (keys[pick] & 0xFF).astype(np.uint32)
    vh = rng.integers(0, 2**32, m, dtype=np.uint32)
    vl = rng.integers(0, 2**32, m, dtype=np.uint32)
    act = rng.integers(0, 4, m) > 0

    ss = ref_ss.from_entries(*map(jnp.asarray, entries), cap, jnp)
    want, want_new, want_ovf = ref_ss.insert(
        ss, *map(jnp.asarray, (bh, bl, vh, vl, act))
    )
    port = sortedset.from_entries(*entries, cap, "cpu")
    got, new, ovf = sortedset.insert(
        port, *(from_u32(a, "cpu") for a in (bh, bl, vh, vl)), torch.from_numpy(act)
    )
    assert int(got.n) == int(want.n)
    assert bool(ovf) == bool(want_ovf)
    assert np.array_equal(new.numpy(), np.asarray(want_new))
    for a, b in zip(got[:4], want[:4]):
        assert np.array_equal(to_u32(a), np.asarray(b))


def test_insert_overflow_matches_reference():
    rng = np.random.default_rng(21)
    cap, m = 64, 128
    keys = rng.choice(2**18, 200, replace=False).astype(np.uint64)
    entries = _random_set(rng, cap, 40, keys)
    bh = (keys[40:168] >> 8).astype(np.uint32)
    bl = (keys[40:168] & 0xFF).astype(np.uint32)
    vals = rng.integers(0, 2**32, (2, m), dtype=np.uint32)
    act = np.ones(m, bool)
    _, want_new, want_ovf = ref_ss.insert(
        ref_ss.from_entries(*map(jnp.asarray, entries), cap, jnp),
        jnp.asarray(bh), jnp.asarray(bl), jnp.asarray(vals[0]), jnp.asarray(vals[1]),
        jnp.asarray(act),
    )
    _, new, ovf = sortedset.insert(
        sortedset.from_entries(*entries, cap, "cpu"),
        from_u32(bh, "cpu"), from_u32(bl, "cpu"), from_u32(vals[0], "cpu"),
        from_u32(vals[1], "cpu"), torch.from_numpy(act),
    )
    assert bool(ovf) and bool(want_ovf)
    assert np.array_equal(new.numpy(), np.asarray(want_new))


def test_lookup_and_grow_match_reference():
    rng = np.random.default_rng(31)
    cap = 256
    keys = rng.choice(2**18, 300, replace=False).astype(np.uint64)
    entries = _random_set(rng, cap, 150, keys)
    ref = ref_ss.from_entries(*map(jnp.asarray, entries), cap, jnp)
    port = sortedset.grow(sortedset.from_entries(*entries, cap, "cpu"), 1024)
    assert port.capacity == 1024 and int(port.n) == 150
    qh = (keys >> 8).astype(np.uint32)
    ql = (keys & 0xFF).astype(np.uint32)
    want = ref_ss.lookup(ref, jnp.asarray(qh), jnp.asarray(ql))
    got = sortedset.lookup(port, from_u32(qh, "cpu"), from_u32(ql, "cpu"))
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(to_u32(got[1]), np.asarray(want[1]))
    assert np.array_equal(to_u32(got[2]), np.asarray(want[2]))


def test_cpu_tensors_take_the_plain_version():
    before = merge_insert.launches
    full = torch.full((4, 8), FULL)
    merge_insert(full, full)
    assert merge_insert.launches == before
