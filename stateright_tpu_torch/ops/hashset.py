"""Open-addressing visited set on the device: ``spawn_xla(dedup="hash")``.

Counterpart of ``stateright_tpu/ops/hashset.py``, with its contract:

- EMPTY is the key (0, 0), which ``ops/fphash.py`` never emits;
- the home slot of a fingerprint is ``(hi ^ (lo * 0x9E3779B1)) & (C - 1)``
  in 32-bit arithmetic, and probing is linear;
- among in-batch duplicates of a key absent before the batch the lowest
  batch index wins, and its value (the parent) is the one stored;
- ``overflow[i]`` says element i is still unresolved after ``max_probes``
  probe advances past other keys: the caller grows and retries.

Layout: one slot word a slot, ``slots`` ``[C, 4]`` int64, one 32-byte
sector of the card: the key ``(hi << 32) | lo``, the election's ticket
(``NO_TICKET`` at rest), the value ``(val_hi << 32) | val_lo`` and a pad
word (0). The kernel claims a slot's key and ticket with one 16-byte
compare-and-swap, so a hit or an in-batch duplicate settles on one read,
and a new key's value lands in the sector its key dirtied.
``key``/``ticket``/``val`` are views of the three words, and
``key_hi``/``key_lo``/``val_hi``/``val_lo`` give the reference's four
planes of words (the checkpoint writer and the audit read those), as the
reference's ``DeltaSet`` exposes its concatenated planes.

:func:`insert_` inserts in place and returns the insert's record,
``filled`` int32 ``[m + 2]``: ``filled[0]`` the number of slots the batch
filled (one a new key), ``filled[1]`` 1 where the kernel ran its exact path
(the reference's rounds), ``filled[2:2 + filled[0]]`` those slots; the
record is what :func:`undo_` clears. On a CPU set it runs
:func:`insert_plain`, the reference's round algorithm exactly: its planes
equal the JAX package's bit for bit, slot layout included, and its record
lists the slots in batch order. On a CUDA set it launches
``csrc/hashset.cu``, whose layout may differ where distinct keys contend
for one slot (they land in arrival order), and whose record lists the
slots in no order, while ``is_new``, ``overflow`` and the stored ``(key,
value)`` pairs are the reference's (see the kernel's note). :func:`insert`
is the functional form, on a copy.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import _cuda
from .words import DTYPE, MASK32, from_u32

#: The multiplier of the home-slot hash (the reference's).
GOLDEN = 0x9E3779B1
#: The ticket word's value at rest, and the election's sentinel.
NO_TICKET = 2**31 - 1
#: The words of a slot: key, ticket, value, pad.
KEY, TICKET, VAL, WORDS = 0, 1, 2, 4
#: A slot at rest, EMPTY.
EMPTY_SLOT = (0, NO_TICKET, 0, 0)


class HashSet(NamedTuple):
    slots: torch.Tensor  # [C, 4] int64: key (0 = EMPTY), ticket, value, pad

    #: The tensors a carry holds (``graphs.Carry``); a hash set keeps no count.
    PLANES = 1

    @property
    def capacity(self) -> int:
        return self.slots.shape[0]

    @property
    def key(self) -> torch.Tensor:
        """``[C]`` view: ``(hi << 32) | lo``, 0 = EMPTY."""
        return self.slots[:, KEY]

    @property
    def ticket(self) -> torch.Tensor:
        """``[C]`` view: ``NO_TICKET`` between inserts."""
        return self.slots[:, TICKET]

    @property
    def val(self) -> torch.Tensor:
        """``[C]`` view: ``(val_hi << 32) | val_lo``."""
        return self.slots[:, VAL]

    @property
    def key_hi(self) -> torch.Tensor:
        return (self.key >> 32) & MASK32

    @property
    def key_lo(self) -> torch.Tensor:
        return self.key & MASK32

    @property
    def val_hi(self) -> torch.Tensor:
        return (self.val >> 32) & MASK32

    @property
    def val_lo(self) -> torch.Tensor:
        return self.val & MASK32


def _pack(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return (hi << 32) | lo


def make(capacity: int, device) -> HashSet:
    """An empty hash set with ``capacity`` slots (a power of two)."""
    if capacity < 1 or capacity & (capacity - 1):
        raise ValueError(f"capacity must be a power of two, got {capacity}")
    return HashSet(torch.tensor(EMPTY_SLOT, dtype=DTYPE, device=device).repeat(capacity, 1))


def claim_capacity(m: int, capacity: int) -> int:
    """The reference's claim buffer: a power of two of at least 16 and of
    ``2 * m``, at most the table."""
    cap = 16
    while cap < 2 * m:
        cap *= 2
    return min(cap, capacity)


def home_slot(fp_hi: torch.Tensor, fp_lo: torch.Tensor, capacity: int) -> torch.Tensor:
    return (fp_hi ^ ((fp_lo * GOLDEN) & MASK32)) & (capacity - 1)


def insert_plain(hs: HashSet, fp_hi, fp_lo, val_hi, val_lo, active, max_probes: int = 32):
    """The plain PyTorch version of :func:`insert_`, in place: the
    reference's rounds, each electing one winner per claim-buffer index by
    a scatter-min of the batch index, until every element is resolved or
    out of probe budget (read on the host each round). Returns ``(is_new,
    overflow, filled)``; ``filled`` lists the winners' slots in batch
    order."""
    cap = hs.capacity
    m = fp_hi.shape[0]
    dev = hs.slots.device
    keys = _pack(fp_hi, fp_lo)
    vals = _pack(val_hi, val_lo)
    ticket = torch.arange(m, dtype=DTYPE, device=dev)
    claim_cap = claim_capacity(m, cap)
    slot = home_slot(fp_hi, fp_lo, cap)
    done = ~active
    is_new = torch.zeros(m, dtype=torch.bool, device=dev)
    probes = torch.zeros(m, dtype=DTYPE, device=dev)
    for _ in range(max_probes + m):
        live = ~done & (probes < max_probes)
        if not bool(live.any()):
            break
        k = hs.key[slot]
        occupied = k != 0
        match = live & occupied & (k == keys)
        done = done | match
        cand = live & ~match & ~occupied
        # One winner per claim index, the lowest batch index; distinct slots
        # sharing an index (a false conflict) only delay the loser a round.
        cidx = slot & (claim_cap - 1)
        claim = torch.full((claim_cap,), NO_TICKET, dtype=DTYPE, device=dev)
        claim.scatter_reduce_(0, cidx, torch.where(cand, ticket, NO_TICKET), "amin")
        winner = cand & (claim[cidx] == ticket)
        at = slot[winner]
        hs.key[at] = keys[winner]
        hs.val[at] = vals[winner]
        is_new = is_new | winner
        done = done | winner
        # Only advances past another key spend probe budget.
        bump = live & occupied & ~match
        probes = probes + bump.to(DTYPE)
        slot = torch.where(bump, (slot + 1) & (cap - 1), slot)
    at = slot[is_new].to(torch.int32)
    filled = torch.zeros(m + 2, dtype=torch.int32, device=dev)
    filled[0] = at.shape[0]
    filled[2:2 + at.shape[0]] = at
    return is_new, ~done, filled


def _check(hs: HashSet, lanes, active) -> None:
    m = active.shape[0]
    dev = hs.slots.device
    if hs.slots.dtype != DTYPE or hs.slots.dim() != 2 or hs.slots.shape[1] != WORDS:
        raise ValueError(f"hash set slots must be int64 [C, {WORDS}], got "
                         f"{hs.slots.dtype} {tuple(hs.slots.shape)}")
    for t in lanes:
        if t.dtype != DTYPE or t.shape != (m,) or t.device != dev:
            raise ValueError(f"batch lanes must be int64 [{m}] on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if active.dtype != torch.bool or active.device != dev:
        raise ValueError("active must be a bool tensor on the set's device")


def _launch(hs: HashSet, lanes, active, max_probes: int):
    so = _cuda.lib("hashset")
    if not hs.slots.is_contiguous():
        raise ValueError("hash set slots must be contiguous")
    lanes = [t.contiguous() for t in lanes]
    active = active.contiguous()
    m = active.shape[0]
    dev = hs.slots.device
    is_new = torch.empty(m, dtype=torch.bool, device=dev)
    overflow = torch.empty(m, dtype=torch.bool, device=dev)
    filled = torch.empty(m + 2, dtype=torch.int32, device=dev)
    # The exact path's scratch: slot and probe count an element, its state
    # byte, the reference's claim buffer.
    slot = torch.empty(m, dtype=torch.int32, device=dev)
    probes = torch.empty(m, dtype=torch.int32, device=dev)
    state = torch.empty(m, dtype=torch.uint8, device=dev)
    claim_cap = claim_capacity(m, hs.capacity)
    claim = torch.empty(claim_cap, dtype=torch.int32, device=dev)
    rc = so.stpu_hashset_insert(
        hs.slots.data_ptr(), hs.capacity, *(t.data_ptr() for t in lanes), active.data_ptr(), m,
        max_probes, is_new.data_ptr(), overflow.data_ptr(), filled.data_ptr(), slot.data_ptr(),
        probes.data_ptr(), state.data_ptr(), claim.data_ptr(), claim_cap,
        _cuda.stream_of(hs.slots),
    )
    _cuda.check(so, rc, "hashset insert")
    _cuda.count_launch(insert_)
    return is_new, overflow, filled


def insert_(hs: HashSet, fp_hi, fp_lo, val_hi, val_lo, active, max_probes: int = 32
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Insert a batch into ``hs`` in place; returns ``(is_new, overflow,
    filled)``, the first two in batch order, ``filled`` the insert's record
    (the slots it filled, for :func:`undo_`). A CUDA set launches the
    kernel (``insert_.launches`` counts the launches, ``insert_.captured``
    those captured into a CUDA graph); a CPU set runs :func:`insert_plain`.
    After an overflow the set holds a partial insert: the caller undoes it
    or discards the set."""
    if max_probes < 1:
        raise ValueError(f"max_probes must be at least 1, got {max_probes}")
    lanes = (fp_hi, fp_lo, val_hi, val_lo)
    _check(hs, lanes, active)
    if hs.slots.device.type == "cuda":
        return _launch(hs, lanes, active, max_probes)
    if hs.slots.device.type == "cpu":
        return insert_plain(hs, *lanes, active, max_probes)
    raise ValueError(f"unsupported device {hs.slots.device}")


insert_.launches = 0
insert_.captured = 0


def insert(hs: HashSet, fp_hi, fp_lo, val_hi, val_lo, active, max_probes: int = 32
           ) -> Tuple[HashSet, torch.Tensor, torch.Tensor]:
    """The reference's functional insert: ``(hs', is_new, overflow)``, with
    ``hs`` left as it was (the insert runs on a copy of its slots)."""
    out = HashSet(hs.slots.clone())
    is_new, overflow, _ = insert_(out, fp_hi, fp_lo, val_hi, val_lo, active, max_probes)
    return out, is_new, overflow


def undo_plain(hs: HashSet, filled: torch.Tensor, keep: torch.Tensor) -> None:
    """The plain PyTorch version of :func:`undo_` (it reads ``keep`` and the
    record's count on the host)."""
    if not bool(keep):
        at = filled[2:2 + int(filled[0])].to(DTYPE)
        hs.slots[at] = torch.tensor(EMPTY_SLOT, dtype=DTYPE, device=hs.slots.device)


def undo_(hs: HashSet, filled: torch.Tensor, keep: torch.Tensor) -> None:
    """Unless ``keep`` (a bool scalar on the set's device), clears the slots
    an in-place insert filled (its record ``filled``): exact, because a key
    present before the insert never moved and no probe chain of one passes
    a slot filled after it. A CUDA set launches the kernel's
    ``stpu_hashset_undo``, which reads ``keep`` and the record on the card,
    so the gated level can capture it (``undo_.launches``/``undo_.captured``
    count the launches); a CPU set runs :func:`undo_plain`."""
    if hs.slots.device.type == "cpu":
        return undo_plain(hs, filled, keep)
    if hs.slots.device.type != "cuda":
        raise ValueError(f"unsupported device {hs.slots.device}")
    if filled.dtype != torch.int32 or filled.device != hs.slots.device or filled.dim() != 1:
        raise ValueError("filled must be an insert's int32 record on the set's device")
    so = _cuda.lib("hashset")
    keep = keep.to(torch.bool).reshape(1)
    rc = so.stpu_hashset_undo(hs.slots.data_ptr(), filled.data_ptr(), keep.data_ptr(),
                              filled.shape[0] - 2, _cuda.stream_of(hs.slots))
    _cuda.check(so, rc, "hashset undo")
    _cuda.count_launch(undo_)


undo_.launches = 0
undo_.captured = 0


def lookup(hs: HashSet, fp_hi, fp_lo, *, max_probes: int = 32):
    """Batched membership and value lookup: ``(found, val_hi, val_lo)``."""
    cap = hs.capacity
    keys = _pack(fp_hi, fp_lo)
    slot = home_slot(fp_hi, fp_lo, cap)
    found = torch.zeros(fp_hi.shape, dtype=torch.bool, device=fp_hi.device)
    val = torch.zeros(fp_hi.shape, dtype=DTYPE, device=fp_hi.device)
    live = torch.ones_like(found)
    for _ in range(max_probes):
        k = hs.key[slot]
        occupied = k != 0
        match = live & occupied & (k == keys)
        val = torch.where(match, hs.val[slot], val)
        found = found | match
        live = live & occupied & ~match
        slot = (slot + 1) & (cap - 1)
    return found, torch.where(found, (val >> 32) & MASK32, 0), torch.where(found, val & MASK32, 0)


def occupied_rows(hs: HashSet):
    """The occupied slots' ``(key_hi, key_lo, val_hi, val_lo)`` as host
    ``uint32`` arrays, in slot order (the reference writer's order)."""
    occ = hs.key != 0
    rows = torch.stack([hs.key[occ], hs.val[occ]]).cpu().numpy()
    k, v = rows.view(np.uint64)
    m32 = np.uint64(MASK32)
    return [(a >> np.uint64(s) & m32).astype(np.uint32) for a in (k, v) for s in (32, 0)]


def insert_lane_words(hs: HashSet, m: int) -> int:
    """0: the hash set sorts nothing (the reference's ``lane_words`` of its
    hash set, whose rows engine sorts no lanes)."""
    return 0


def from_entries(key_hi, key_lo, val_hi, val_lo, capacity: int, device,
                 max_probes: int = 32) -> HashSet:
    """Rebuild by insertion (checkpoint restore, as the reference's
    ``_restore``): the rows in their order into ``capacity`` slots, doubled
    until no row overflows."""
    lanes = [from_u32(a, device) for a in (key_hi, key_lo, val_hi, val_lo)]
    active = torch.ones(lanes[0].shape[0], dtype=torch.bool, device=device)
    while True:
        hs = make(capacity, device)
        _, overflow, _ = insert_(hs, *lanes, active, max_probes)
        if not bool(overflow.any()):
            return hs
        capacity *= 2


def grow(hs: HashSet, new_capacity: int, max_probes: int = 32) -> HashSet:
    """A rehash into ``new_capacity`` slots, as the reference's: every slot
    of the old planes, in slot order, the occupied ones active."""
    if new_capacity < hs.capacity:
        raise ValueError("hash set cannot shrink")
    bigger = make(new_capacity, hs.key.device)
    _, overflow, _ = insert_(bigger, hs.key_hi, hs.key_lo, hs.val_hi, hs.val_lo, hs.key != 0,
                             max_probes)
    if bool(overflow.any()):
        raise RuntimeError("rehash overflow — pathological fingerprint distribution")
    return bigger
