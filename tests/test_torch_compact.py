"""The plain version of the port's stream compaction
(stateright_tpu_torch/ops/compact.py) against the reference TPU kernel
(stateright_tpu/ops/pallas_compact.py, in interpret mode) and numpy: exact
comparison, tolerance 0 (integer work). The CUDA kernel itself is held
against this plain version on the card by chip_smoke.py; here its
decomposition (byte fold, in-tile ranks, tile offsets) is replayed in numpy
and held against the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.ops.pallas_compact import compact_pallas_staged
from stateright_tpu_torch.ops import compact as compact_mod
from stateright_tpu_torch.ops.compact import compact
from stateright_tpu_torch.ops.words import from_u32, to_u32


@pytest.mark.parametrize("block", [128, 256])
def test_plain_matches_pallas_interpret(block):
    rng = np.random.default_rng(9 + block)
    P, M, cap = 5, 1 << 12, 1 << 11
    mask = rng.integers(0, 5, M) == 0
    planes = rng.integers(0, 2**32, (P, M), dtype=np.uint32)
    want = np.asarray(compact_pallas_staged(
        jnp.asarray(mask), jnp.asarray(planes), cap, block=block, interpret=True
    ))
    out, n = compact(torch.from_numpy(mask), list(from_u32(planes, "cpu")), cap)
    n = int(n)
    assert n == int(mask.sum())
    assert np.array_equal(to_u32(out)[:, :n], want[:, :n])
    assert np.array_equal(to_u32(out)[:, :n], planes[:, mask])


def test_overflow_drops_survivors_past_cap_and_counts_them():
    rng = np.random.default_rng(11)
    P, M, cap, block = 3, 1 << 10, 256, 128
    mask = np.ones(M, bool)
    planes = rng.integers(0, 2**32, (P, M), dtype=np.uint32)
    want = np.asarray(compact_pallas_staged(
        jnp.asarray(mask), jnp.asarray(planes), cap, block=block, interpret=True
    ))
    out, n = compact(torch.from_numpy(mask), list(from_u32(planes, "cpu")), cap)
    assert int(n) == M > cap
    assert out.shape == (P, cap)
    assert np.array_equal(to_u32(out), want[:, :cap])


@pytest.mark.parametrize("M,cap", [(1000, 300), (1, 4), (0, 8), (777, 2048)])
def test_ragged_shapes_match_numpy(M, cap):
    rng = np.random.default_rng(M)
    mask = rng.integers(0, 3, M) == 0
    planes = rng.integers(0, 2**32, (4, M), dtype=np.uint32)
    out, n = compact(torch.from_numpy(mask), list(from_u32(planes, "cpu")), cap)
    k = min(int(mask.sum()), cap)
    assert int(n) == int(mask.sum())
    assert np.array_equal(to_u32(out)[:, :k], planes[:, mask][:, :k])


def test_grid_views_match_numpy():
    """The engine's lane kinds: strided planes of an [F, A, W] grid and
    per-state lanes broadcast over the A action slots (stride 0)."""
    rng = np.random.default_rng(5)
    F, A, W, cap = 37, 12, 2, 200
    grid = rng.integers(0, 2**32, (F, A, W), dtype=np.uint32)
    per_state = rng.integers(0, 2**32, F, dtype=np.uint32)
    mask = rng.integers(0, 4, (F, A)) == 0
    tg, ts = from_u32(grid, "cpu"), from_u32(per_state, "cpu")
    lanes = [tg[:, :, w] for w in range(W)] + [ts[:, None].expand(F, A)]
    out, n = compact(torch.from_numpy(mask), lanes, cap)
    flat = mask.reshape(-1)
    want = np.stack(
        [grid[:, :, w].reshape(-1)[flat] for w in range(W)]
        + [np.repeat(per_state, A)[flat]]
    )
    k = min(int(flat.sum()), cap)
    assert int(n) == int(flat.sum())
    assert np.array_equal(to_u32(out)[:, :k], want[:, :k])


def _bits_of(words):
    """csrc/compact.cuh ``bits_of``: four mask bytes per uint32 word, any
    nonzero byte true (``__vcmpne4``), folded to bits 0..3."""
    ne = np.zeros_like(words)
    for b in range(4):
        ne |= np.where((words >> np.uint32(8 * b)) & np.uint32(0xFF), np.uint32(1 << (8 * b)), 0).astype(np.uint32)
    return (ne | ne >> np.uint32(7) | ne >> np.uint32(14) | ne >> np.uint32(21)) & np.uint32(0xF)


def test_byte_fold_of_the_kernel():
    rng = np.random.default_rng(1)
    raw = rng.choice(np.array([0, 1, 2, 0x80, 0xFF], np.uint8), (4096, 4))
    want = ((raw != 0) * (1 << np.arange(4))).sum(1)
    assert np.array_equal(_bits_of(raw.view("<u4").reshape(-1)), want)


def _tiled_compact(mask, planes, cap, threads, flags=16):
    """The CUDA kernel's decomposition (csrc/compact.cuh) in numpy: tiles of
    threads * flags mask bytes, each thread's flags folded to a bit mask
    (16-byte loads where aligned, scalar at the ragged edge), an exclusive
    scan of the threads' popcounts for the in-tile ranks, an exclusive scan
    of the tile totals (the look-back's result) for the tile offsets, and
    survivor r written to column r when r < cap."""
    m = mask.size
    tile = threads * flags
    raw = mask.astype(np.uint8)
    out = np.zeros((planes.shape[0], cap), np.uint32)
    offset = 0
    for base in range(0, m, tile):
        counts, positions = [], []
        for t in range(threads):
            k0 = base + t * flags
            if k0 + flags <= m:
                words = raw[k0:k0 + flags].view("<u4")
                bits = sum(int(w) << (4 * i) for i, w in enumerate(_bits_of(words)))
            else:
                bits = sum(1 << b for b in range(flags) if k0 + b < m and raw[k0 + b])
            positions.append([t * flags + b for b in range(flags) if bits >> b & 1])
            counts.append(bin(bits).count("1"))
        ranks = np.concatenate([[0], np.cumsum(counts)])
        pos = np.zeros(ranks[-1], np.int64)
        for t in range(threads):
            pos[ranks[t]:ranks[t + 1]] = positions[t]
        for x, p in enumerate(pos):
            if offset + x < cap:
                out[:, offset + x] = planes[:, base + p]
        offset += int(ranks[-1])
    return out, offset


@pytest.mark.parametrize("threads", [4, 32])
@pytest.mark.parametrize("M,cap", [(5000, 6000), (4097, 300), (64 * 16, 2048), (9, 4)])
def test_kernel_decomposition_matches_plain(M, cap, threads):
    rng = np.random.default_rng(M + threads)
    mask = rng.integers(0, 3, M) == 0
    planes = rng.integers(0, 2**32, (3, M), dtype=np.uint32)
    got, n = _tiled_compact(mask, planes, cap, threads)
    want, n_plain = compact(torch.from_numpy(mask), list(from_u32(planes, "cpu")), cap)
    k = min(n, cap)
    assert n == int(n_plain) == int(mask.sum())
    assert np.array_equal(got[:, :k], to_u32(want)[:, :k])


@pytest.mark.parametrize("n_lanes", [47, 49])
def test_kernel_decomposition_at_paxos_lane_counts(n_lanes):
    """Paxos 3c/3s (W = 46): the grid compaction's W + 3 = 49 lanes over an
    [F, 672] action grid, the frontier compaction's W + 1 = 47; past the
    32 lanes a launch took before."""
    assert n_lanes <= compact_mod.MAX_LANES
    rng = np.random.default_rng(n_lanes)
    F, A, cap = 13, 672, 64
    mask = rng.random((F, A)) < 4 / A
    planes = rng.integers(0, 2**32, (n_lanes, F * A), dtype=np.uint32)
    got, n = _tiled_compact(mask.reshape(-1), planes, cap, threads=32)
    lanes = [lane.reshape(F, A) for lane in from_u32(planes, "cpu")]
    want, n_plain = compact(torch.from_numpy(mask), lanes, cap)
    k = min(n, cap)
    assert n == int(n_plain) == int(mask.sum()) > 0
    assert want.shape == (n_lanes, cap)
    assert np.array_equal(got[:, :k], to_u32(want)[:, :k])
    assert np.array_equal(to_u32(want)[:, :k], planes[:, mask.reshape(-1)][:, :k])


def test_cpu_tensors_take_the_plain_version():
    before = compact.launches
    compact(torch.ones(8, dtype=torch.bool), [torch.arange(8)], 8)
    assert compact.launches == before


def test_rejects_bad_inputs():
    with pytest.raises(ValueError, match="bool"):
        compact(torch.ones(4, dtype=torch.int64), [torch.arange(4)], 4)
    with pytest.raises(ValueError, match="shape"):
        compact(torch.ones(4, dtype=torch.bool), [torch.arange(5)], 4)
    with pytest.raises(ValueError, match="lanes"):
        compact(torch.ones(4, dtype=torch.bool), [torch.arange(4)] * (compact_mod.MAX_LANES + 1), 4)


def test_other_devices_raise_instead_of_falling_back():
    meta = torch.ones(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        compact(meta, [torch.zeros(4, dtype=torch.int64, device="meta")], 4)


def test_kernel_build_is_keyed_by_source_and_needs_nvcc(monkeypatch):
    from stateright_tpu_torch.ops import _cuda

    path = _cuda.library_path("compact")
    assert path.parent == _cuda.BUILD and path.name.startswith("libcompact-")
    assert path == _cuda.library_path("compact") != _cuda.library_path("merge")
    assert _cuda.build([]) == 0.0
    monkeypatch.setattr(_cuda.shutil, "which", lambda _: None)
    monkeypatch.setattr(_cuda.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda._nvcc()
