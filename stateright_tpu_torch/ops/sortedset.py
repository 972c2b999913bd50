"""Sort-merge visited set on the device.

Counterpart of ``stateright_tpu/ops/sortedset.py``. The visited set is a
key-sorted array of ``(fingerprint, parent)`` rows: the first ``n`` rows
are sorted ascending by ``(key_hi, key_lo)`` and unique, and rows from ``n``
on are (0, 0) pads — the same planes, so a checkpoint written by the JAX
package loads as they are. ``(0xFFFFFFFF, 0xFFFFFFFF)`` is reserved as the
in-merge pad key (``ops/fphash.py`` remaps both reserved pairs).

:func:`insert` follows the reference package's merge lowering
(``_insert_via_merge``): a batch presort by (key, ticket), the merge-insert
kernel (``ops/merge.py``), zeroing of the rows from the new count on, and
the inverse permutation of the keep flags back to batch order. Growth is a
plain copy; overflow is exact.

Planes are int64 tensors of 32-bit words (``ops/words.py``); ``n`` is a
0-dim int64 tensor on the set's device, so an insert never waits on the
host.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .merge import merge_insert
from .words import DTYPE, FULL, PAD_KEY, fold_key, from_u32, to_u32


class SortedSet(NamedTuple):
    key_hi: torch.Tensor  # [C] int64
    key_lo: torch.Tensor  # [C] int64
    val_hi: torch.Tensor  # [C] int64
    val_lo: torch.Tensor  # [C] int64
    n: torch.Tensor  # [] int64 — occupied prefix length

    #: The tensors a carry holds (``graphs.Carry``); the count follows.
    PLANES = 4

    @property
    def capacity(self) -> int:
        return self.key_hi.shape[0]


def _check_capacity(capacity: int, n: int = 0) -> None:
    if capacity < n or capacity & (capacity - 1) or capacity < 1:
        raise ValueError(f"capacity {capacity} must be a power of two holding {n} rows")


def make(capacity: int, device) -> SortedSet:
    """An empty sorted set with ``capacity`` row slots (a power of two)."""
    _check_capacity(capacity)
    z = torch.zeros(capacity, dtype=DTYPE, device=device)
    return SortedSet(z, z.clone(), z.clone(), z.clone(), torch.zeros((), dtype=DTYPE, device=device))


def from_entries(key_hi, key_lo, val_hi, val_lo, capacity: int, device) -> SortedSet:
    """Bulk build from unique ``(key, value)`` 32-bit word arrays (checkpoint
    restore). Sorts once on the host."""
    cols = [np.asarray(a, dtype=np.uint32) for a in (key_hi, key_lo, val_hi, val_lo)]
    n = len(cols[0])
    _check_capacity(capacity, n)
    order = np.lexsort((cols[1], cols[0]))
    planes = []
    for a in cols:
        out = np.zeros(capacity, np.uint32)
        out[:n] = a[order]
        planes.append(from_u32(out, device))
    return SortedSet(*planes, torch.tensor(n, dtype=DTYPE, device=device))


def insert(
    ss: SortedSet, fp_hi, fp_lo, val_hi, val_lo, active
) -> Tuple[SortedSet, torch.Tensor, torch.Tensor]:
    """Insert a batch; returns ``(ss', is_new, overflow)``.

    ``is_new[i]`` (in batch order) marks the single winner among in-batch
    duplicates — the lowest batch index — of a key not already present;
    winners' values are stored; ``overflow`` (a bool scalar) says the merged
    set does not fit, in which case the returned set is truncated and the
    caller grows and retries. ``ss`` itself is left as it was."""
    cap = ss.capacity
    dev = ss.key_hi.device
    kh = torch.where(active, fp_hi, FULL)
    kl = torch.where(active, fp_lo, FULL)
    # Presort by (key, ticket): a stable sort keeps equal keys in batch
    # order, so the merge's keep-first rule elects the lowest batch index.
    order = torch.sort(fold_key(kh, kl), stable=True).indices
    batch = torch.stack([kh[order], kl[order], val_hi[order], val_lo[order]])
    vis_valid = torch.arange(cap, device=dev) < ss.n
    table = torch.stack([
        torch.where(vis_valid, ss.key_hi, FULL),
        torch.where(vis_valid, ss.key_lo, FULL),
        ss.val_hi,
        ss.val_lo,
    ])
    merged, keep_sorted, n_keep = merge_insert(table, batch)
    new_n = torch.clamp(n_keep, max=cap)
    row_ok = torch.arange(cap, device=dev) < new_n
    merged = torch.where(row_ok, merged, 0)
    # The inverse permutation routes the keep flags back to batch order.
    is_new = torch.empty_like(keep_sorted)
    is_new[order] = keep_sorted
    return SortedSet(merged[0], merged[1], merged[2], merged[3], new_n), is_new, n_keep > cap


def lookup(ss: SortedSet, fp_hi, fp_lo):
    """Batched membership and value lookup: ``(found, val_hi, val_lo)``."""
    cap = ss.capacity
    # Rows from n on are (0, 0) pads; they search as the all-ones key,
    # which sorts last and no fingerprint equals.
    occupied = torch.arange(cap, device=ss.key_hi.device) < ss.n
    keys = torch.where(occupied, fold_key(ss.key_hi, ss.key_lo), PAD_KEY)
    q = fold_key(fp_hi, fp_lo)
    at = torch.clamp(torch.searchsorted(keys, q), max=cap - 1)
    hit = keys[at] == q
    return hit, torch.where(hit, ss.val_hi[at], 0), torch.where(hit, ss.val_lo[at], 0)


def occupied_rows(ss: SortedSet):
    """The occupied prefix ``(key_hi, key_lo, val_hi, val_lo)`` as host
    ``uint32`` arrays, sorted and unique, copied in one transfer."""
    n = int(ss.n)
    return list(to_u32(torch.stack([p[:n] for p in ss[:4]])))


def grow(ss: SortedSet, new_capacity: int) -> SortedSet:
    """Capacity growth is a plain copy — the sorted invariant does not
    depend on the capacity."""
    if new_capacity < ss.capacity:
        raise ValueError("sorted set cannot shrink")
    _check_capacity(new_capacity)
    pad = new_capacity - ss.capacity
    planes = [
        torch.cat([p, torch.zeros(pad, dtype=DTYPE, device=p.device)])
        for p in (ss.key_hi, ss.key_lo, ss.val_hi, ss.val_lo)
    ]
    return SortedSet(*planes, ss.n)
