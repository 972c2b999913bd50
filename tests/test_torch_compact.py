"""The plain version of the port's stream compaction
(stateright_tpu_torch/ops/compact.py) against the reference TPU kernel
(stateright_tpu/ops/pallas_compact.py, in interpret mode) and numpy: exact
comparison, tolerance 0 (integer work). The CUDA kernel itself is held
against this plain version on the card by chip_smoke.py."""

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
