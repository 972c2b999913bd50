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

The reference's other lowerings of ``spawn_xla(compaction=)``
(``compact_1d``'s branches in ``stateright_tpu/xla.py``) are here as
yardsticks for the kernel, not as engine options: the engine compacts
with :func:`compact` alone and refuses their names (ROADMAP A11), and
``chip_smoke.py`` checks and times them beside it. They keep the same
contract and zero the columns past the survivors, on either device:
:func:`compact_gather`, :func:`compact_sort` and :func:`compact_bsearch`.
They are plain tensor operations with static shapes (no ``nonzero``, no
masked indexing, no host read), so a CUDA graph captures them, and they
work plane by plane: no stacked ``[P, m]`` copy of the lanes is made.
They need no priority key: the engine's grid is state-major
(``k = f*A + a``), so array order is semantic order, as the reference's
``"bsearch"`` grid build makes it. :data:`LOWERINGS` maps each
reference name to its function.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _cuda
from .words import DTYPE, MASK32

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


def _emit(mask, lanes, cap: int, take: int, n_valid, plane) -> torch.Tensor:
    """``out [P, cap]``: in row ``p``, ``plane(lanes[p])``, the first
    ``take`` survivors' words of that lane (anything past ``n_valid`` in
    them is garbage), and zero from ``min(n_valid, cap)`` on."""
    out = torch.zeros((len(lanes), cap), dtype=DTYPE, device=mask.device)
    for p, lane in enumerate(lanes):
        out[p, :take] = plane(lane)
    dead = torch.arange(take, device=mask.device) >= n_valid
    out[:, :take].masked_fill_(dead, 0)
    return out


def _gather_by(mask, lanes, cap: int, take: int, n_valid, order) -> torch.Tensor:
    """Each lane's words at the flat indices ``order`` (``take`` of them)
    of the mask, read through the lane's own strides: a grid plane or a
    broadcast lane is not copied."""
    if mask.dim() == 1:
        return _emit(mask, lanes, cap, take, n_valid, lambda lane: lane[order])
    cols = mask.shape[1]
    row, col = order // cols, order % cols
    return _emit(mask, lanes, cap, take, n_valid, lambda lane: lane[row, col])


def compact_gather(
    mask: torch.Tensor, lanes: Sequence[torch.Tensor], cap: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``"gather"``: one stable sort of the 0/1 invalid
    key over the flattened mask (its ``(key, iota)`` permutation sort),
    the first ``min(cap, m)`` indices of the permutation, and a gather of
    every lane by them."""
    _check(mask, lanes)
    take = min(cap, mask.numel())
    n_valid = mask.sum()
    invalid = (~mask.reshape(-1)).to(torch.uint8)
    order = torch.sort(invalid, stable=True).indices[:take]
    return _gather_by(mask, lanes, cap, take, n_valid, order), n_valid


def compact_sort(
    mask: torch.Tensor, lanes: Sequence[torch.Tensor], cap: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``"sort"``: the lanes ride the sort as payload, so
    no lane is gathered at random. ``torch.sort`` takes no payload, so each
    lane sorts one int64 word a slot, ``(invalid << 62) | (j << 32) |
    (lane[j] & MASK32)``, and keeps its low 32 bits. The words are distinct
    (``j`` is), so stability does not matter, and they fit a non-negative
    int64: the reference asserts ``m < 2**30``. A survivor's value comes
    back modulo ``2**32``: the engine's lanes are 32-bit words (``packing``
    masks every field to 32 bits), and a word outside ``[0, 2**32)`` in a
    dropped slot cannot disturb the order."""
    _check(mask, lanes)
    m = mask.numel()
    if m >= 1 << 30:
        raise ValueError(f"compact_sort takes fewer than 2**30 slots, got {m}")
    take = min(cap, m)
    n_valid = mask.sum()
    key = ((~mask).to(DTYPE) << 62) | (
        torch.arange(m, dtype=DTYPE, device=mask.device).view(mask.shape) << 32)

    def plane(lane):
        return torch.sort((key | (lane & MASK32)).reshape(-1)).values[:take] & MASK32

    return _emit(mask, lanes, cap, take, n_valid, plane), n_valid


def compact_bsearch(
    mask: torch.Tensor, lanes: Sequence[torch.Tensor], cap: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``"bsearch"``: no permutation sort. Survivor ``i``
    is the first slot whose running count of the mask reaches ``i + 1``:
    an int64 ``cumsum`` of the mask, a ``searchsorted`` of the ranks
    ``1..min(cap, m)`` over it (clamped to the last slot for the ranks
    past ``n_valid``), and one ascending gather of every lane."""
    _check(mask, lanes)
    m = mask.numel()
    take = min(cap, m)
    n_valid = mask.sum()
    running = torch.cumsum(mask.reshape(-1), 0)
    ranks = torch.arange(1, take + 1, dtype=running.dtype, device=mask.device)
    order = torch.searchsorted(running, ranks, side="left").clamp_(max=max(m - 1, 0))
    return _gather_by(mask, lanes, cap, take, n_valid, order), n_valid


#: The reference's tensor lowerings of ``spawn_xla(compaction=)`` by name,
#: the yardsticks of :func:`compact` (the reference's ``"pallas"``).
LOWERINGS = {
    "gather": compact_gather,
    "sort": compact_sort,
    "bsearch": compact_bsearch,
}
