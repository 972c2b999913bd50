"""Merge-insert of a presorted batch into the sorted visited table: the
wrapper of ``csrc/merge.cu``.

Counterpart of ``stateright_tpu/ops/pallas_merge.py`` (``merge_insert``).
Contract, equal to that kernel's: ``table [4, C]`` and ``batch [4, m]`` are
int64 planes ``(key_hi, key_lo, val_hi, val_lo)`` of 32-bit words; the
table is sorted by key and the batch by (key, ticket); pads carry the
all-ones key. Ties go to the table, and a batch row survives only if its
key differs from the previous merged key. Returns ``(merged [4, C],
keep_batch [m] bool in batch-sorted order, n_keep)``, where ``n_keep`` is
the TOTAL survivor count (above C means overflow) and rows of ``merged``
from ``min(n_keep, C)`` on are unspecified: callers re-mask.

On a CPU tensor :func:`merge_insert` runs :func:`merge_insert_plain`; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _cuda
from .words import DTYPE, PAD_KEY, fold_key

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _check(table: torch.Tensor, batch: torch.Tensor) -> None:
    for name, t in (("table", table), ("batch", batch)):
        if t.dtype != DTYPE or t.dim() != 2 or t.shape[0] != 4:
            raise ValueError(f"{name} must be int64 [4, n] planes, got {t.dtype} {tuple(t.shape)}")
    if table.device != batch.device:
        raise ValueError("table and batch must lie on one device")


def merge_insert_plain(table: torch.Tensor, batch: torch.Tensor) -> Result:
    """The plain PyTorch version: ``searchsorted`` co-ranks place every row
    at its merged position, then the keep rule and a ``nonzero`` gather."""
    c, m = table.shape[1], batch.shape[1]
    dev = table.device
    tkey = fold_key(table[0], table[1])
    bkey = fold_key(batch[0], batch[1])
    # Table row i -> i + #{batch < a_i}; batch row j -> j + #{table <= b_j}.
    pos_t = torch.arange(c, device=dev) + torch.searchsorted(bkey, tkey)
    pos_b = torch.arange(m, device=dev) + torch.searchsorted(tkey, bkey, right=True)
    planes = torch.empty((4, c + m), dtype=DTYPE, device=dev)
    planes[:, pos_t] = table
    planes[:, pos_b] = batch
    is_batch = torch.zeros(c + m, dtype=torch.bool, device=dev)
    is_batch[pos_b] = True
    key = fold_key(planes[0], planes[1])
    differs = torch.ones_like(is_batch)
    differs[1:] = key[1:] != key[:-1]
    keep = (key != PAD_KEY) & (~is_batch | differs)
    idx = keep.nonzero().squeeze(1)
    take = min(idx.numel(), c)
    merged = torch.zeros((4, c), dtype=DTYPE, device=dev)
    merged[:, :take] = planes[:, idx[:take]]
    return merged, keep[pos_b], torch.tensor(idx.numel(), dtype=DTYPE, device=dev)


def _launch(table: torch.Tensor, batch: torch.Tensor) -> Result:
    so = _cuda.lib("merge")
    if not (table.is_contiguous() and batch.is_contiguous()):
        raise ValueError("table and batch must be contiguous [4, n] planes")
    c, m = table.shape[1], batch.shape[1]
    dev = table.device
    keep_batch = torch.empty(m, dtype=torch.bool, device=dev)
    merged = torch.empty((4, c), dtype=DTYPE, device=dev)
    status = torch.empty(so.stpu_merge_status_words(c, m), dtype=DTYPE, device=dev)
    n_keep = torch.empty((), dtype=DTYPE, device=dev)
    rc = so.stpu_merge_insert(
        table.data_ptr(), c, batch.data_ptr(), m, keep_batch.data_ptr(),
        merged.data_ptr(), status.data_ptr(), n_keep.data_ptr(),
        _cuda.stream_of(table),
    )
    _cuda.check(so, rc, "merge_insert")
    _cuda.count_launch(merge_insert)
    return merged, keep_batch, n_keep


def merge_insert(table: torch.Tensor, batch: torch.Tensor) -> Result:
    """See the module docstring. CUDA planes launch the kernel
    (``merge_insert.launches`` counts the launches,
    ``merge_insert.captured`` those captured into a CUDA graph); CPU planes
    run the plain version."""
    _check(table, batch)
    if table.device.type == "cuda":
        return _launch(table, batch)
    if table.device.type == "cpu":
        return merge_insert_plain(table, batch)
    raise ValueError(f"unsupported device {table.device}")


merge_insert.launches = 0
merge_insert.captured = 0
