"""The plain version of the port's merge-insert
(stateright_tpu_torch/ops/merge.py) against the reference TPU kernel
(stateright_tpu/ops/pallas_merge.py, in interpret mode), and the port's
sorted set against the reference package's under both of its insert
lowerings: exact comparison, tolerance 0 (integer work). The CUDA
kernel's decomposition (merge-path diagonals, per-thread merge and keep
rule, tile counts and their scan) is replayed in numpy and held against
both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.ops import sortedset as ref_ss
from stateright_tpu.ops.pallas_merge import _merge_partition
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


PAD64 = np.uint64(2**64 - 1)


def _fold(planes):
    return (planes[0].astype(np.uint64) << np.uint64(32)) | planes[1].astype(np.uint64)


def _merge_path(t, b, d):
    """csrc/merge.cu ``merge_path``: the 32-lane bracket search of diagonal
    ``d`` (the largest i with t[i-1] <= b[d-i], ties to the table)."""
    lo, hi = max(0, d - len(b)), min(len(t), d)
    while lo < hi:
        step = (hi - lo + 31) >> 5
        at = np.minimum(lo + (np.arange(32) + 1) * step, hi)
        ok = t[at - 1] <= b[d - at]
        n = int(ok.sum())
        assert ok[:n].all(), "the lanes that hold are a prefix"
        if n == 0:
            hi = lo + step - 1
        else:
            first_fail = min(lo + (n + 1) * step, hi) if n < 32 else hi + 1
            lo, hi = min(lo + n * step, hi), first_fail - 1
    return lo


def _tiled_merge(table, batch, tile, per_thread=8):
    """The CUDA kernel's decomposition (csrc/merge.cu), step by step, in
    numpy: per-tile diagonals, each thread's sub-diagonal split and serial
    merge with the previous key max(t[ii-1], b[jj-1]) at the tile's start,
    per-tile keep counts and their exclusive scan (the look-back's result),
    then every kept row written once at its rank. Returns (merged,
    keep_batch, n_keep, tile diagonals, tile counts)."""
    c, m = table.shape[1], batch.shape[1]
    tk, bk = _fold(table), _fold(batch)
    n = c + m
    n_tiles = -(-n // tile)
    diag = [_merge_path(tk, bk, min(k * tile, n)) for k in range(n_tiles + 1)]
    keep_batch = np.zeros(m, bool)
    counts, kept_rows = [], []
    for k in range(n_tiles):
        d0, d1 = k * tile, min((k + 1) * tile, n)
        ii, jj = diag[k], d0 - diag[k]
        na = diag[k + 1] - ii
        nt = d1 - d0
        nb = nt - na
        keys = np.concatenate([tk[ii:ii + na], bk[jj:jj + nb]])
        a, b = keys[:na], keys[na:]
        before = (tk[ii - 1] if ii else 0, bk[jj - 1] if jj else 0)
        rows = []
        for t0 in range(0, tile, per_thread):
            dg = min(t0, nt)
            lo, hi = max(0, dg - nb), min(na, dg)
            while lo < hi:
                mid = (lo + hi + 1) >> 1
                if a[mid - 1] <= b[dg - mid]:
                    lo = mid
                else:
                    hi = mid - 1
            i, j = lo, dg - lo
            pa = a[i - 1] if i else before[0]
            pb = b[j - 1] if j else before[1]
            present = [p for p, has in ((pa, ii + i > 0), (pb, jj + j > 0)) if has]
            prev = max(present) if present else PAD64
            for v in range(per_thread):
                if dg + v >= nt:
                    break
                from_table = j >= nb or (i < na and a[i] <= b[j])
                if from_table:
                    u, src, row = i, table, ii + i
                    i += 1
                else:
                    u, src, row = na + j, batch, jj + j
                    j += 1
                key = keys[u]
                keep = key != PAD64 and (from_table or key != prev)
                if not from_table:
                    keep_batch[row] = keep
                if keep:
                    rows.append(src[:, row])
                prev = key
        counts.append(len(rows))
        kept_rows.append(rows)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    merged = np.zeros((4, c), np.uint32)
    for k, rows in enumerate(kept_rows):
        for x, row in enumerate(rows):
            if offsets[k] + x < c:
                merged[:, offsets[k] + x] = row
    return merged, keep_batch, int(offsets[-1]), diag, counts


def _tie_at_every_diagonal(c=C, m=M, n=400):
    """Table keys 0..n and batch keys 1..n: merged position 2x holds batch
    key x right after the equal table key, so every even tile and thread
    boundary falls between a table row and its equal batch row."""
    table = np.full((4, c), FULL, np.uint32)
    batch = np.full((4, m), FULL, np.uint32)
    table[0, : n + 1] = 0
    table[1, : n + 1] = np.arange(n + 1)
    batch[0, :n] = 0
    batch[1, :n] = np.arange(1, n + 1)
    table[2:, : n + 1] = 7
    batch[2:, :n] = 9
    return table, batch


def _decomposition_case(name):
    rng = np.random.default_rng(len(name))
    if name == "random":
        return _mk(rng, 700, 450, rng.choice(2**20, 2000, replace=False))
    if name == "dense_duplicates":
        return _mk(rng, 300, 500, rng.choice(2**20, 320, replace=False))
    if name == "run_across_tiles":
        table, batch = _mk(rng, 500, 0, rng.choice(2**20, 600, replace=False))
        batch[0, :450], batch[1, :450] = table[0, 250], table[1, 250]
        batch[2, :450] = np.arange(450, dtype=np.uint32)
        return table, batch
    if name == "tie_at_diagonals":
        return _tie_at_every_diagonal()
    if name == "all_pad_batch":
        return _mk(rng, 800, 0, rng.choice(2**20, 900, replace=False))
    if name == "all_pad_table":
        return _mk(rng, 0, 500, rng.choice(2**20, 900, replace=False))
    raise KeyError(name)


DECOMPOSITION_CASES = [
    "random", "dense_duplicates", "run_across_tiles", "tie_at_diagonals",
    "all_pad_batch", "all_pad_table",
]


@pytest.mark.parametrize("tile", [128, 512])
@pytest.mark.parametrize("case", DECOMPOSITION_CASES)
def test_kernel_decomposition_matches_plain_and_pallas(case, tile):
    """The merge kernel's math at a small tile size: equal, exactly, to the
    plain version and to the reference kernel in interpret mode."""
    table, batch = _decomposition_case(case)
    merged, keep_batch, n_keep, _, counts = _tiled_merge(table, batch, tile)
    assert sum(counts) == n_keep
    port = (merged, keep_batch, n_keep)
    ref, plain = _both(table, batch)
    _assert_same(ref, port)
    _assert_same(plain, port)


@pytest.mark.parametrize("tile", [128, 512])
@pytest.mark.parametrize("case", ["random", "tie_at_diagonals", "all_pad_table"])
def test_kernel_diagonals_match_reference_partition(case, tile):
    """The kernel's 32-lane merge-path search gives the reference's
    ``_merge_partition`` diagonals at the same block size."""
    table, batch = _decomposition_case(case)
    diag = _tiled_merge(table, batch, tile)[3]
    ii, jj = _merge_partition(*(jnp.asarray(p) for p in (table[0], table[1], batch[0], batch[1])), tile)
    assert diag == np.asarray(ii).tolist()
    assert np.array_equal(np.asarray(jj), np.arange(len(diag)) * tile - np.asarray(diag))


def test_kernel_decomposition_edges():
    """m = 1, a ragged last tile, an overflowing table, and a duplicate run
    long enough to span many tiles."""
    rng = np.random.default_rng(77)
    table, batch = _mk(rng, 200, 1, rng.choice(2**20, 300, replace=False), c=256, m=1)
    _assert_same(_both_plain(table, batch), _tiled_merge(table, batch, 128)[:3], c=256)
    tk = np.sort(rng.choice(2**19, 500, replace=False)).astype(np.uint64)
    table = np.full((4, 512), FULL, np.uint32)
    table[0, :500], table[1, :500] = tk >> 16, tk & 0xFFFF
    table[2, :500] = np.arange(500)
    ck = np.sort(rng.choice(2**19, 300) + 2**19).astype(np.uint64)
    batch = np.full((4, 300), FULL, np.uint32)
    batch[0, :300], batch[1, :300] = ck >> 16, ck & 0xFFFF
    batch[3, :300] = np.arange(300)
    got = _tiled_merge(table, batch, 128)
    assert got[2] == 500 + len(np.unique(ck)) > 512
    _assert_same(_both_plain(table, batch), got[:3], c=512)
    run = np.full((4, 1024), FULL, np.uint32)
    run[0, :1000], run[1, :1000] = 1, 2
    _assert_same(_both_plain(table, run), _tiled_merge(table, run, 128)[:3], c=512)


def _both_plain(table, batch):
    pm, pk, pn = merge_insert(from_u32(table, "cpu"), from_u32(batch, "cpu"))
    return to_u32(pm), pk.numpy(), int(pn)


def test_cpu_tensors_take_the_plain_version():
    before = merge_insert.launches
    full = torch.full((4, 8), FULL)
    merge_insert(full, full)
    assert merge_insert.launches == before
