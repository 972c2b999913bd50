"""Two-tier sort-merge visited set: a sorted MAIN tier and a sorted DELTA
tier, ``spawn_xla(dedup="delta")``.

Counterpart of ``stateright_tpu/ops/deltaset.py``. The flat sorted set
(``ops/sortedset.py``) costs every level in proportion to its capacity:
the merge copies every tile's table slice and the gated level commits
copies of the table planes. This structure bounds a level's table work
to the delta tier, LSM-style:

- membership in the main tier is a ``searchsorted`` of the batch's folded
  keys (``ops/words.fold_key``) over ``main_keys``, the main tier's folded
  keys with its pads at the largest key, kept beside the planes and made
  anew only when main changes (the reference's ``_bsearch_member``
  descends the two word planes instead);
- in-batch dedup, winner election and the merge into the delta tier are
  one ``merge_insert`` (``ops/merge.py``, a CUDA kernel) with the delta
  tier as its table;
- when the delta would overflow, the insert reports overflow and the
  caller flushes (:func:`maintain`, a ``merge_insert`` of the delta into
  main, invoked from the host between blocks) and retries, as the
  reference's engine does.

Same contract as the other structures: ``is_new`` in batch order, the
lowest batch index the winner among in-batch duplicates, its value
stored. The planes equal the reference's bit for bit. ``key_hi``/
``key_lo``/``val_hi``/``val_lo`` are the concatenated ``[main ‖ delta]``
planes (occupied rows not (0, 0), pads zero), which the checkpoint writer
and the audit read. ``(0xFFFFFFFF, 0xFFFFFFFF)`` is reserved as in the
flat sorted set.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .merge import merge_insert
from .words import DTYPE, FULL, PAD_KEY, fold_key, from_u32, to_u32


class DeltaSet(NamedTuple):
    """Tier planes: ``main_*`` rows ``[:n_main]`` sorted ascending by
    (hi, lo) and unique; ``delta_*`` rows ``[:n_delta]`` likewise; the two
    tiers disjoint; pads (0, 0)."""

    main_key_hi: torch.Tensor  # [C] int64 words
    main_key_lo: torch.Tensor
    main_val_hi: torch.Tensor
    main_val_lo: torch.Tensor
    delta_key_hi: torch.Tensor  # [Dc] int64 words
    delta_key_lo: torch.Tensor
    delta_val_hi: torch.Tensor
    delta_val_lo: torch.Tensor
    main_keys: torch.Tensor  # [C] int64: fold_key of main rows, PAD_KEY past n_main
    n_main: torch.Tensor  # [] int64
    n_delta: torch.Tensor  # [] int64

    #: The tensors a carry holds (``graphs.Carry``); the counts follow.
    PLANES = 9

    @property
    def capacity(self) -> int:
        """Total row slots (the growth rule's denominator)."""
        return self.main_capacity + self.delta_capacity

    @property
    def main_capacity(self) -> int:
        return self.main_key_hi.shape[0]

    @property
    def delta_capacity(self) -> int:
        return self.delta_key_hi.shape[0]

    @property
    def key_hi(self) -> torch.Tensor:
        return torch.cat([self.main_key_hi, self.delta_key_hi])

    @property
    def key_lo(self) -> torch.Tensor:
        return torch.cat([self.main_key_lo, self.delta_key_lo])

    @property
    def val_hi(self) -> torch.Tensor:
        return torch.cat([self.main_val_hi, self.delta_val_hi])

    @property
    def val_lo(self) -> torch.Tensor:
        return torch.cat([self.main_val_lo, self.delta_val_lo])


#: Delta-tier rows as a fraction of main capacity (1 / 2**DELTA_SHIFT).
DELTA_SHIFT = 4
#: Floor on delta-tier rows. Module-level so that tests can shrink it to
#: force the flush path on small state spaces.
MIN_DELTA = 1024


def _delta_cap(capacity: int) -> int:
    return max(capacity >> DELTA_SHIFT, MIN_DELTA)


def _fold_valid(hi, lo, n) -> torch.Tensor:
    """Folded keys of the first ``n`` rows, ``PAD_KEY`` after: sorted
    ascending when the rows are."""
    valid = torch.arange(hi.shape[0], device=hi.device) < n
    return torch.where(valid, fold_key(hi, lo), PAD_KEY)


def _padded(hi, lo, vh, vl, n) -> torch.Tensor:
    """``[4, R]`` merge planes: rows from ``n`` on carry the all-ones key."""
    valid = torch.arange(hi.shape[0], device=hi.device) < n
    return torch.stack([torch.where(valid, hi, FULL), torch.where(valid, lo, FULL), vh, vl])


def make(capacity: int, device) -> DeltaSet:
    """An empty set. ``capacity`` counts MAIN rows (a power of two); the
    delta tier adds ``capacity / 2**DELTA_SHIFT`` rows (at least
    ``MIN_DELTA``)."""
    if capacity < 1 or capacity & (capacity - 1):
        raise ValueError(f"capacity must be a power of two, got {capacity}")
    zc = [torch.zeros(capacity, dtype=DTYPE, device=device) for _ in range(4)]
    zd = [torch.zeros(_delta_cap(capacity), dtype=DTYPE, device=device) for _ in range(4)]
    zero = torch.zeros((), dtype=DTYPE, device=device)
    keys = torch.full((capacity,), PAD_KEY, dtype=DTYPE, device=device)
    return DeltaSet(*zc, *zd, keys, zero, zero.clone())


def from_entries(key_hi, key_lo, val_hi, val_lo, capacity: int, device) -> DeltaSet:
    """Bulk build from unique ``(key, value)`` 32-bit word arrays
    (checkpoint restore): every row sorted into the main tier, the delta
    empty."""
    cols = [np.asarray(a, dtype=np.uint32) for a in (key_hi, key_lo, val_hi, val_lo)]
    n = len(cols[0])
    if capacity < n or capacity < 1 or capacity & (capacity - 1):
        raise ValueError(f"capacity {capacity} cannot hold {n} entries")
    order = np.lexsort((cols[1], cols[0]))
    main = []
    for a in cols:
        out = np.zeros(capacity, np.uint32)
        out[:n] = a[order]
        main.append(from_u32(out, device))
    zd = [torch.zeros(_delta_cap(capacity), dtype=DTYPE, device=device) for _ in range(4)]
    count = torch.tensor(n, dtype=DTYPE, device=device)
    return DeltaSet(*main, *zd, _fold_valid(main[0], main[1], count), count,
                    torch.zeros((), dtype=DTYPE, device=device))


def _member(keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Membership of folded keys ``q`` in the sorted folded ``keys``."""
    at = torch.clamp(torch.searchsorted(keys, q), max=keys.shape[0] - 1)
    return keys[at] == q


def insert(ds: DeltaSet, fp_hi, fp_lo, val_hi, val_lo, active
           ) -> Tuple[DeltaSet, torch.Tensor, torch.Tensor]:
    """The sorted set's contract: ``is_new`` in batch order (the lowest
    index wins among in-batch duplicates of keys in neither tier), winners'
    values stored; ``overflow`` (a bool scalar) says the winners do not fit
    the delta tier: the caller flushes (:func:`maintain`) or grows and
    retries, and the returned set, truncated, is discarded. The main tier's
    tensors are returned as they were, not copied."""
    dc = ds.delta_capacity
    dev = ds.main_key_hi.device
    # Rows whose key is in main become pads, which the merge never keeps.
    fresh = active & ~_member(ds.main_keys, fold_key(fp_hi, fp_lo))
    kh = torch.where(fresh, fp_hi, FULL)
    kl = torch.where(fresh, fp_lo, FULL)
    # A stable sort keeps equal keys in batch order, so the merge's
    # keep-first rule elects the lowest batch index.
    order = torch.sort(fold_key(kh, kl), stable=True).indices
    batch = torch.stack([kh[order], kl[order], val_hi[order], val_lo[order]])
    table = _padded(ds.delta_key_hi, ds.delta_key_lo, ds.delta_val_hi, ds.delta_val_lo, ds.n_delta)
    merged, keep_sorted, n_keep = merge_insert(table, batch)
    new_n = torch.clamp(n_keep, max=dc)
    merged = torch.where(torch.arange(dc, device=dev) < new_n, merged, 0)
    is_new = torch.empty_like(keep_sorted)
    is_new[order] = keep_sorted
    out = ds._replace(delta_key_hi=merged[0], delta_key_lo=merged[1], delta_val_hi=merged[2],
                      delta_val_lo=merged[3], n_delta=new_n)
    return out, is_new, n_keep > dc


def maintain(ds: DeltaSet) -> Tuple[DeltaSet, torch.Tensor]:
    """The flush: the delta tier merged into main (one ``merge_insert``),
    the delta emptied. Returns ``(ds', overflow)``; overflow says the
    merged rows do not fit main, and the caller grows (``grow`` folds the
    delta in) and discards ``ds'``."""
    c = ds.main_capacity
    dev = ds.main_key_hi.device
    table = _padded(ds.main_key_hi, ds.main_key_lo, ds.main_val_hi, ds.main_val_lo, ds.n_main)
    batch = _padded(ds.delta_key_hi, ds.delta_key_lo, ds.delta_val_hi, ds.delta_val_lo, ds.n_delta)
    merged, _, n_keep = merge_insert(table, batch)
    new_n = torch.clamp(n_keep, max=c)
    merged = torch.where(torch.arange(c, device=dev) < new_n, merged, 0)
    zd = [torch.zeros_like(ds.delta_key_hi) for _ in range(4)]
    out = DeltaSet(*merged, *zd, _fold_valid(merged[0], merged[1], new_n), new_n,
                   torch.zeros_like(ds.n_delta))
    return out, n_keep > c


def lookup(ds: DeltaSet, fp_hi, fp_lo):
    """Batched membership and value lookup across both tiers: ``(found,
    val_hi, val_lo)``."""
    q = fold_key(fp_hi, fp_lo)
    out = []
    for keys, vh, vl in (
        (ds.main_keys, ds.main_val_hi, ds.main_val_lo),
        (_fold_valid(ds.delta_key_hi, ds.delta_key_lo, ds.n_delta), ds.delta_val_hi, ds.delta_val_lo),
    ):
        at = torch.clamp(torch.searchsorted(keys, q), max=keys.shape[0] - 1)
        out.append((keys[at] == q, vh[at], vl[at]))
    (hm, mh, ml), (hd, dh, dl) = out
    return (hm | hd, torch.where(hm, mh, torch.where(hd, dh, 0)),
            torch.where(hm, ml, torch.where(hd, dl, 0)))


def occupied_rows(ds: DeltaSet):
    """The occupied rows ``(key_hi, key_lo, val_hi, val_lo)`` as host
    ``uint32`` arrays in plane order: main's, then the delta's."""
    n_main, n_delta = int(ds.n_main), int(ds.n_delta)
    rows = torch.cat([torch.stack(ds[:4])[:, :n_main], torch.stack(ds[4:8])[:, :n_delta]], dim=1)
    return list(to_u32(rows))


def insert_lane_words(ds: DeltaSet, m: int) -> int:
    """32-bit words that one insert of an ``m``-lane batch carries as sort
    operands: the reference's ``insert_lane_words`` on an accelerator
    (``"sort"`` values): the 5-word presort and 2-word inverse a lane, and
    the delta tier's 4-word merge a row of the tier and the batch. The flush
    (:func:`maintain`) runs between levels and is not counted."""
    return m * 5 + m * 2 + (ds.delta_capacity + m) * 4


def grow(ds: DeltaSet, new_capacity: int) -> DeltaSet:
    """Grow the main tier and rescale the delta tier, folding the delta's
    rows into main. On the host, as the reference's: the minimum delta
    tier can out-hold a small main, so the new main is sized for the
    occupancy (at least twice the rows), not just the caller's doubling."""
    if new_capacity < ds.main_capacity:
        raise ValueError("delta set cannot shrink")
    rows = occupied_rows(ds)
    while new_capacity < 2 * len(rows[0]):
        new_capacity *= 2
    return from_entries(*rows, new_capacity, ds.main_key_hi.device)
