"""Order-preserving stream compaction: the wrapper of ``csrc/compact.cu``.

Counterpart of ``stateright_tpu/ops/pallas_compact.py``
(``compact_pallas_staged``). The engine calls it twice per BFS level: to
compact the action grid into candidates (P = W + 3 lanes) and the
surviving candidates into the next frontier (P = W + 1 lanes).

Contract: the survivors of ``mask`` (any shape of rank 1 or 2), in array
order, lane by lane, into ``out[P, cap]``; ``n_valid`` is the TOTAL
survivor count, so ``n_valid > cap`` means the survivors past ``cap`` were
dropped. Columns from ``min(n_valid, cap)`` on are unspecified: callers
re-mask. Every lane has the mask's shape and may be any strided view of an
int64 tensor, a broadcast (stride 0) included, so the engine hands the
[F, A, W] grid's planes and the per-state lanes broadcast over the A action
slots to the kernel as they lie, with no stacked copy.

On a CPU tensor :func:`compact` runs :func:`compact_plain`; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _cuda
from .words import DTYPE

#: Lanes one launch takes (``stpu::kMaxLanes`` in ``csrc/compact.cuh``).
MAX_LANES = 64


def _check(mask: torch.Tensor, lanes: Sequence[torch.Tensor]) -> None:
    if mask.dtype != torch.bool or mask.dim() not in (1, 2):
        raise ValueError(f"mask must be a bool tensor of rank 1 or 2, got {mask.dtype} {tuple(mask.shape)}")
    if not 1 <= len(lanes) <= MAX_LANES:
        raise ValueError(f"compact takes 1..{MAX_LANES} lanes, got {len(lanes)}")
    for lane in lanes:
        if lane.dtype != DTYPE or lane.shape != mask.shape or lane.device != mask.device:
            raise ValueError(
                f"every lane must be an int64 tensor of the mask's shape "
                f"{tuple(mask.shape)} on {mask.device}, got {lane.dtype} "
                f"{tuple(lane.shape)} on {lane.device}"
            )


def compact_plain(
    mask: torch.Tensor, lanes: Sequence[torch.Tensor], cap: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: ``nonzero`` plus a gather per lane.
    Columns past the survivors are zero."""
    idx = mask.reshape(-1).nonzero().squeeze(1)
    take = min(idx.numel(), cap)
    out = torch.zeros((len(lanes), cap), dtype=DTYPE, device=mask.device)
    for p, lane in enumerate(lanes):
        out[p, :take] = lane.reshape(-1)[idx[:take]]
    return out, torch.tensor(idx.numel(), dtype=DTYPE, device=mask.device)


def _launch(
    mask: torch.Tensor, lanes: Sequence[torch.Tensor], cap: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    so = _cuda.lib("compact")
    if not mask.is_contiguous():
        raise ValueError("the mask must be contiguous")
    m = mask.numel()
    cols = 1 if mask.dim() == 1 else mask.shape[1]
    desc = []
    for lane in lanes:
        s1 = lane.stride(1) if lane.dim() == 2 else 0
        desc += [lane.data_ptr(), lane.stride(0), s1]
    out = torch.empty((len(lanes), cap), dtype=DTYPE, device=mask.device)
    n_valid = torch.empty((), dtype=DTYPE, device=mask.device)
    status = torch.empty(so.stpu_compact_status_words(m), dtype=DTYPE, device=mask.device)
    rc = so.stpu_compact(
        mask.data_ptr(), m, cols, (ctypes.c_int64 * len(desc))(*desc), len(lanes),
        out.data_ptr(), cap, status.data_ptr(), n_valid.data_ptr(),
        _cuda.stream_of(mask),
    )
    _cuda.check(so, rc, "compact")
    _cuda.count_launch(compact)
    return out, n_valid


def compact(
    mask: torch.Tensor, lanes: Sequence[torch.Tensor], cap: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [P, cap] int64, n_valid int64 scalar)``; see the module
    docstring. A CUDA mask launches the kernel (``compact.launches`` counts
    the launches, ``compact.captured`` those captured into a CUDA graph); a
    CPU mask runs the plain version."""
    _check(mask, lanes)
    if mask.device.type == "cuda":
        return _launch(mask, lanes, cap)
    if mask.device.type == "cpu":
        return compact_plain(mask, lanes, cap)
    raise ValueError(f"unsupported device {mask.device}")


compact.launches = 0
compact.captured = 0
