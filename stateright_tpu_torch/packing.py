"""Reusable bit-packing toolkit for GPU-checkable (packed) models.

Counterpart of ``stateright_tpu/packing.py``: models *declare* layouts of
named bit-fields over 32-bit words and get a host pack/unpack and batched
tensor accessors, with loud overflow detection (the packed analogue of
stateright's panics on broken invariants).

- :class:`Layout` / :class:`LayoutBuilder` — named bit-fields over 32-bit
  words. Fields never span word boundaries; array fields are uniformly
  strided so an index held in a tensor can address them.
- :class:`SlotMultiset` — the packed non-duplicating network: K word-sized
  slots holding a sorted multiset of envelope codes.
- :class:`FifoLanes` — the packed ordered network (network.rs:57-67):
  bounded FIFO lanes, one per directed flow.
- :class:`BoundedHistory` — a fixed-width encoding of the backtracking
  consistency testers (``semantics/linearizability.rs:57-126``) for
  clients with statically bounded operation counts; converts exactly
  to/from :class:`~stateright_tpu_torch.semantics._backtracking.BacktrackingTester`.

Device side, words are ``[..., W]`` int64 tensors holding 32-bit values
(``ops/words.py``), batched over any leading shape, and an element index
is a Python int or an int64 tensor that broadcasts against the batch: a
read of a tensor index is a ``take_along_dim`` on the word axis, a write a
``scatter_``. :meth:`Layout.set` returns a new tensor like the reference's;
:meth:`Layout.set_` and the device methods of :class:`SlotMultiset`,
:class:`FifoLanes` and :class:`BoundedHistory` write in place, so a model's
transition bodies update one buffer per action family rather than a copy
per field. The reference's scatter-free
``_word_update`` works around an XLA:TPU miscompile and has no
counterpart here.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .ops.words import MASK32

#: An element index: a Python int, or an int64 tensor broadcast against the
#: batch.
Index = Union[int, torch.Tensor]


def bits_for(maxval: int) -> int:
    """Field width (>=1) that holds values ``0..maxval``."""
    return max(int(maxval).bit_length(), 1)


class PackedModelAdapter:
    """Object-level ``Model`` surface for packed models that wrap an inner
    object model in ``self._inner`` (the pattern of the packed Paxos
    model): every Model-API call resolves to the inner model via
    ``__getattr__``; only ``checker()`` binds to the packed wrapper itself
    so ``spawn_xla`` sees the packed functions beside the object-level
    contract."""

    def checker(self):
        from .checker.builder import CheckerBuilder

        return CheckerBuilder(self)

    def packed_init(self) -> np.ndarray:
        """Packed initial states: the inner model's, through ``pack``."""
        return np.stack([self.pack(s) for s in self._inner.init_states()])

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._inner, name)


class Field(NamedTuple):
    name: str
    bits: int  # bits per element
    count: int  # number of elements (1 for scalars)
    word: int  # first word index
    shift: int  # bit offset of element 0 in its word
    epw: int  # elements per word (array fields are word-aligned)
    is_array: bool  # declared via array()/words(): list-valued in pack/unpack


class OverflowError32(RuntimeError):
    """A value exceeded its declared field width at host pack time."""


class LayoutBuilder:
    """Accumulates fields; ``finish()`` freezes them into a :class:`Layout`.

    Scalars pack densely left-to-right within words. Array fields are
    word-aligned with a fixed stride (``32 // bits`` elements per word) so
    device code can address element ``i`` with a tensor ``i``.
    """

    def __init__(self) -> None:
        self._fields: Dict[str, Field] = {}
        self._word = 0
        self._bit = 0

    def _align_word(self) -> None:
        if self._bit:
            self._word += 1
            self._bit = 0

    def uint(self, name: str, bits: int) -> "LayoutBuilder":
        """A scalar field of ``bits`` (1..32) bits."""
        if not 1 <= bits <= 32:
            raise ValueError(f"field {name}: bits must be 1..32, got {bits}")
        if name in self._fields:
            raise ValueError(f"duplicate field {name}")
        if self._bit + bits > 32:
            self._align_word()
        self._fields[name] = Field(
            name, bits, 1, self._word, self._bit, max(32 // bits, 1), False
        )
        self._bit += bits
        if self._bit == 32:
            self._align_word()
        return self

    def flag(self, name: str) -> "LayoutBuilder":
        return self.uint(name, 1)

    def array(self, name: str, count: int, bits: int) -> "LayoutBuilder":
        """``count`` elements of ``bits`` bits, word-aligned, uniformly
        strided (indexable with a tensor index)."""
        if not 1 <= bits <= 32:
            raise ValueError(f"field {name}: bits must be 1..32, got {bits}")
        if name in self._fields:
            raise ValueError(f"duplicate field {name}")
        self._align_word()
        epw = 32 // bits
        self._fields[name] = Field(name, bits, count, self._word, 0, epw, True)
        self._word += (count + epw - 1) // epw
        return self

    def words(self, name: str, count: int) -> "LayoutBuilder":
        """``count`` full 32-bit words."""
        return self.array(name, count, 32)

    def finish(self) -> "Layout":
        self._align_word()
        return Layout(dict(self._fields), self._word)


def _lift(t: torch.Tensor, dims: int) -> torch.Tensor:
    """``t`` with leading unit axes up to ``dims`` axes."""
    return t.reshape((1,) * (dims - t.dim()) + tuple(t.shape))


def _where(cond, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.where`` whose ``cond`` may also be a Python bool (the
    ``enabled=True`` default), which makes no device tensor."""
    if isinstance(cond, bool):
        return a if cond else b
    return torch.where(cond, a, b)


class Layout:
    def __init__(self, fields: Dict[str, Field], words: int):
        self.fields = fields
        self.words = words

    # --- device accessors ----------------------------------------------------

    @staticmethod
    def _locate(f: Field, idx: Index) -> Tuple[Index, Index]:
        """(word index, bit shift) of element ``idx`` of ``f``."""
        if not f.is_array:
            return f.word, f.shift
        return f.word + idx // f.epw, (idx % f.epw) * f.bits

    def get(self, words: torch.Tensor, name: str, idx: Index = 0) -> torch.Tensor:
        """Field ``name`` (element ``idx`` for arrays) of every word vector
        in ``words[..., W]``: an int64 tensor of the batch shape broadcast
        with ``idx``'s."""
        f = self.fields[name]
        w, sh = self._locate(f, idx)
        if isinstance(w, int):
            word = words[..., w]
        else:
            w = _lift(w, words.dim() - 1)
            word = torch.take_along_dim(words, w.unsqueeze(-1), dim=-1).squeeze(-1)
        if f.bits == 32:
            return word
        return (word >> sh) & ((1 << f.bits) - 1)

    def set_(self, words: torch.Tensor, name: str, value, idx: Index = 0) -> None:
        """Write field ``name`` (element ``idx``) of every word vector in
        ``words[..., W]`` in place; ``value`` (masked to the field's width,
        as the reference's uint32 arithmetic does) and ``idx`` broadcast
        against the batch shape. ``words`` must be a tensor of its own
        memory, not a broadcast view."""
        f = self.fields[name]
        mask = (1 << f.bits) - 1
        w, sh = self._locate(f, idx)
        if isinstance(w, int):
            col = words[..., w]
            words[..., w] = (col & (MASK32 ^ (mask << sh))) | ((value & mask) << sh)
            return
        batch = words.shape[:-1]
        w = torch.broadcast_to(_lift(w, len(batch)), batch).unsqueeze(-1)
        cur = torch.gather(words, -1, w).squeeze(-1)
        new = (cur & (MASK32 ^ (mask << sh))) | ((value & mask) << sh)
        words.scatter_(-1, w, torch.broadcast_to(new, batch).unsqueeze(-1))

    def set(self, words: torch.Tensor, name: str, value, idx: Index = 0) -> torch.Tensor:
        """A new ``[..., W]`` tensor with field ``name`` set (the reference's
        functional ``Layout.set``); the batch is ``words``' broadcast with
        ``value``'s and ``idx``'s shapes."""
        batch = torch.broadcast_shapes(
            words.shape[:-1],
            *(torch.as_tensor(x).shape for x in (value, idx)),
        )
        out = words.expand(*batch, words.shape[-1]).clone()
        self.set_(out, name, value, idx)
        return out

    # --- host codec --------------------------------------------------------

    def pack(self, **values: Any) -> np.ndarray:
        """Pack named values (ints, or sequences for array fields) into a
        fresh word vector; unset fields are zero. Overflow raises."""
        out = np.zeros(self.words, dtype=np.uint32)
        for name, value in values.items():
            f = self.fields[name]
            elems = list(value) if f.is_array else [value]
            if len(elems) > f.count:
                raise OverflowError32(f"{name}: {len(elems)} elements > {f.count}")
            limit = 1 << f.bits
            for i, v in enumerate(elems):
                v = int(v)
                if not 0 <= v < limit:
                    raise OverflowError32(
                        f"{name}[{i}] = {v} exceeds {f.bits}-bit field"
                    )
                w = f.word + i // f.epw
                sh = (i % f.epw) * f.bits if f.is_array else f.shift
                out[w] |= np.uint32(v << sh)
        return out

    def unpack(self, words) -> Dict[str, Any]:
        """Host inverse of :meth:`pack`: field name -> int or list of ints."""
        words = [int(w) for w in words]
        out: Dict[str, Any] = {}
        for name, f in self.fields.items():
            mask = (1 << f.bits) - 1 if f.bits < 32 else 0xFFFFFFFF
            if not f.is_array:
                out[name] = (words[f.word] >> f.shift) & mask
            else:
                out[name] = [
                    (words[f.word + i // f.epw] >> ((i % f.epw) * f.bits)) & mask
                    for i in range(f.count)
                ]
        return out


# --------------------------------------------------------------------------
# Sorted-slot multiset: the packed non-duplicating network.
# --------------------------------------------------------------------------


class SlotMultiset:
    """K word-sized slots holding a canonical (sorted) multiset of envelope
    codes.

    Slot encoding: ``(code + 1) << count_bits | count - 1``: the +1 keeps 0
    for an empty slot even for code 0, and a present slot's count (at least
    1) is stored less one, so ``count_bits`` caps the multiplicity at
    ``2**count_bits``. ``count_bits=0`` is the duplicating set: presence
    only, and a delivery keeps the slot (redeliverable, network.rs:204).

    The slots are a view of a ``Layout`` ``words()`` field named ``field``.
    The device methods take ``words[..., W]``, update it in place and leave
    the slots sorted ascending (empty slots first), so equal multisets have
    equal words. They read no value back to the host and make no shape
    that depends on the data, so a CUDA graph can capture them.
    """

    def __init__(self, layout: Layout, field: str, code_bits: int, count_bits: int):
        f = layout.fields[field]
        if f.bits != 32:
            raise ValueError("SlotMultiset requires a words() field")
        if code_bits + 1 + count_bits > 32:
            raise ValueError("code_bits + count_bits must fit a word (with +1 code)")
        self.layout = layout
        self.field = field
        self.k = f.count
        self.base = f.word
        self.code_bits = code_bits
        self.count_bits = count_bits
        self.max_count = 1 << count_bits

    # --- device ops --------------------------------------------------------

    def slots(self, words: torch.Tensor) -> torch.Tensor:
        """The ``[..., K]`` slot words (a view of ``words``)."""
        return words[..., self.base:self.base + self.k]

    def _with_slots(self, words: torch.Tensor, slots: torch.Tensor) -> None:
        # Canonical: empty slots (0) first, then by code.
        words[..., self.base:self.base + self.k] = torch.sort(slots, dim=-1).values

    def decode(self, slots: torch.Tensor):
        """``(codes, counts, present)`` of raw ``[..., K]`` slots."""
        present = slots != 0
        codes = ((slots >> self.count_bits) - present.to(slots.dtype)) & MASK32
        counts = torch.where(present, (slots & (self.max_count - 1)) + 1, 0)
        return codes, counts, present

    def send(self, words: torch.Tensor, code, enabled=True) -> torch.Tensor:
        """Add one instance of ``code`` in place; returns the bool
        ``overflow``: no free slot for a new code, or its count is at the
        cap (nothing is written: a bump past the cap would carry into the
        code bits and decode as another envelope). ``code`` and
        ``enabled`` are Python scalars or tensors of the batch shape."""
        s = self.slots(words).clone()
        cb = self.count_bits
        code_col = code[..., None] if isinstance(code, torch.Tensor) else code
        present = s != 0
        match = present & ((s >> cb) == code_col + 1)
        has = match.any(-1)
        if cb == 0:  # duplicating set: membership only
            bumped = s
            count_ovf = torch.zeros_like(has)
        else:
            at_max = match & ((s & (self.max_count - 1)) == self.max_count - 1)
            count_ovf = at_max.any(-1)
            bumped = torch.where(match & ~at_max, s + 1, s)
        # The first empty slot (sorted slots put empties first), else 0.
        first_empty = torch.argmin(present.to(torch.int32), dim=-1, keepdim=True)
        can_insert = ~torch.gather(present, -1, first_empty).squeeze(-1)
        encoded = ((code_col + 1) << cb) & MASK32
        if isinstance(encoded, torch.Tensor):
            inserted = s.scatter(-1, first_empty, torch.broadcast_to(encoded, first_empty.shape))
        else:
            inserted = s.scatter(-1, first_empty, encoded)
        s_new = torch.where(has[..., None], bumped,
                            torch.where(can_insert[..., None], inserted, s))
        overflow = enabled & torch.where(has, count_ovf, ~can_insert)
        keep = enabled[..., None] if isinstance(enabled, torch.Tensor) else enabled
        self._with_slots(words, _where(keep, s_new, s))
        return overflow

    def remove_slot(self, words: torch.Tensor, i: Index, enabled=True) -> None:
        """Remove one instance from slot ``i`` in place (a delivery on a
        non-duplicating network, or a drop); a no-op where ``enabled`` is
        false."""
        s = self.slots(words).clone()
        if isinstance(i, torch.Tensor):
            idx = torch.broadcast_to(i, s.shape[:-1])[..., None]
            si = torch.gather(s, -1, idx).squeeze(-1)
        else:
            si = s[..., i]
        if self.count_bits:
            last = (si & (self.max_count - 1)) == 0
            new_si = torch.where(last, 0, si - 1)
        else:
            new_si = torch.zeros_like(si)
        new_si = _where(enabled, new_si, si)
        if isinstance(i, torch.Tensor):
            s.scatter_(-1, idx, new_si[..., None])
        else:
            s[..., i] = new_si
        self._with_slots(words, s)

    # --- host codec --------------------------------------------------------

    def host_pack(self, code_counts: Sequence[Tuple[int, int]]) -> List[int]:
        """Sorted slot words from ``(code, count)`` pairs; raises
        :class:`OverflowError32` past the slot count or a field width."""
        if len(code_counts) > self.k:
            raise OverflowError32(f"{len(code_counts)} distinct envelopes > {self.k} slots")
        codes = [c for c, _n in code_counts]
        if len(set(codes)) != len(codes):
            raise OverflowError32(
                "duplicate envelope codes — merge counts before packing "
                "(duplicates would break canonical slot words)"
            )
        slots = []
        for code, count in code_counts:
            if not 0 <= code < (1 << self.code_bits):
                raise OverflowError32(f"envelope code {code} exceeds {self.code_bits} bits")
            if not 1 <= count <= self.max_count:
                raise OverflowError32(f"envelope count {count} outside 1..{self.max_count}")
            slots.append(((code + 1) << self.count_bits) | (count - 1))
        slots.sort()
        return [0] * (self.k - len(slots)) + slots

    def host_unpack(self, slot_words: Sequence[int]) -> List[Tuple[int, int]]:
        """``(code, count)`` pairs of the present slots."""
        out = []
        for s in slot_words:
            s = int(s)
            if s == 0:
                continue
            code = (s >> self.count_bits) - 1
            count = (s & (self.max_count - 1)) + 1 if self.count_bits else 1
            out.append((code, count))
        return out


# --------------------------------------------------------------------------
# FIFO lanes: the packed ordered network.
# --------------------------------------------------------------------------


class FifoLanes:
    """``lanes`` directed flows, each a bounded FIFO of up to ``depth``
    message codes (the packed ordered network, network.rs:57-67). Only lane
    heads are deliverable; delivering pops the head and shifts the lane.

    Codes are stored +1 (0 = empty cell) in a strided array field of
    ``depth`` elements per lane, plus a length field per lane. The device
    methods take ``words[..., W]``, a lane index (a Python int or an int64
    tensor broadcast against the batch) and a bool ``enabled``; ``push`` and
    ``pop`` update ``words`` in place.
    """

    def __init__(self, builder: LayoutBuilder, name: str, lanes: int, depth: int, code_bits: int):
        if code_bits + 1 > 32:
            raise ValueError("code_bits must leave room for the +1 empty sentinel")
        self.lanes = lanes
        self.depth = depth
        self.code_bits = code_bits
        self.cells = f"{name}_cells"
        self.lens = f"{name}_lens"
        builder.array(self.cells, lanes * depth, min(code_bits + 1, 32))
        builder.array(self.lens, lanes, max(depth.bit_length(), 1))
        self.layout: Optional[Layout] = None

    def bind(self, layout: Layout) -> "FifoLanes":
        self.layout = layout
        return self

    # --- device ops --------------------------------------------------------

    def length(self, words: torch.Tensor, lane: Index) -> torch.Tensor:
        return self.layout.get(words, self.lens, lane)

    def head(self, words: torch.Tensor, lane: Index) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(code, nonempty)`` of the lane head; the code of an empty lane
        is ``-1 & MASK32``, as the reference's uint32 wraps."""
        raw = self.layout.get(words, self.cells, lane * self.depth)
        return (raw - 1) & MASK32, raw != 0

    def push(self, words: torch.Tensor, lane: Index, code, enabled=True) -> torch.Tensor:
        """Append ``code`` to the lane in place; returns the bool
        ``overflow`` (the lane was full; nothing is written)."""
        L = self.layout
        n = self.length(words, lane)
        overflow = (n >= self.depth) & enabled
        ok = enabled & ~overflow
        idx = lane * self.depth + torch.clamp(n, max=self.depth - 1)
        old = L.get(words, self.cells, idx)
        L.set_(words, self.cells, torch.where(ok, code + 1, old), idx)
        L.set_(words, self.lens, torch.where(ok, n + 1, n), lane)
        return overflow

    def pop(self, words: torch.Tensor, lane: Index, enabled=True) -> None:
        """Pop the lane head in place (deliver or drop), shifting the lane;
        a no-op on an empty lane or where ``enabled`` is false."""
        L = self.layout
        n = self.length(words, lane)
        do = (n > 0) & enabled
        for j in range(self.depth - 1):
            idx = lane * self.depth + j
            nxt = L.get(words, self.cells, idx + 1)
            L.set_(words, self.cells, torch.where(do, nxt, L.get(words, self.cells, idx)), idx)
        tail = lane * self.depth + (self.depth - 1)
        L.set_(words, self.cells, torch.where(do, 0, L.get(words, self.cells, tail)), tail)
        L.set_(words, self.lens, torch.where(do, n - 1, n), lane)

    # --- host codec --------------------------------------------------------

    def host_pack_lane(self, codes: Sequence[int]) -> Tuple[list, int]:
        """``(cells, length)`` of one lane holding ``codes`` (head first);
        raises :class:`OverflowError32` past the depth or the code width."""
        if len(codes) > self.depth:
            raise OverflowError32(f"{len(codes)} queued messages > depth {self.depth}")
        for c in codes:
            if not 0 <= c < (1 << self.code_bits):
                raise OverflowError32(f"message code {c} exceeds {self.code_bits} bits")
        return [c + 1 for c in codes] + [0] * (self.depth - len(codes)), len(codes)


# --------------------------------------------------------------------------
# Bounded consistency-tester history.
# --------------------------------------------------------------------------


class BoundedHistory:
    """Fixed-width encoding of a :class:`BacktrackingTester` whose threads
    and per-thread operation counts are statically bounded (register-style
    scripted clients, register.rs:94-260).

    Per thread t (identified by its position in ``thread_ids``):
      - ``h{t}_n``        completed-op count (0..max_ops)
      - ``h{t}_fl``       in-flight op code + 1 (0 = none)
      - ``h{t}_flpre``    per-peer prereq index + 2 at invocation
                          (0 = no entry; the tester omits peers with empty
                          history, linearizability.rs:114-126)
      - ``h{t}_op/_ret``  completed op/ret codes (+1; 0 unused)
      - ``h{t}_pre``      per-(slot, peer) prereq index + 2
      - ``h_valid``       the is_valid_history poison bit

    Op/ret codes are model-supplied small ints (closed universes).
    Conversion to/from the live tester object is exact, so packed states
    fingerprint-distinguish histories exactly like object states do.

    The device methods take ``words[..., W]`` and a bool ``enabled`` that
    broadcasts against the batch, and update ``words`` in place.
    """

    def __init__(
        self,
        builder: LayoutBuilder,
        thread_ids: Sequence[Any],
        max_ops: int,
        op_bits: int,
        ret_bits: int,
        real_time: bool = True,
    ):
        #: Whether invocations snapshot real-time prerequisites. True for
        #: LinearizabilityTester histories; False for
        #: SequentialConsistencyTester ones (sequential_consistency.rs
        #: records none) — the prereq fields then stay 0, so packed states
        #: collapse exactly like the host tester's equality does.
        self.real_time = real_time
        self.thread_ids = list(thread_ids)
        self.max_ops = max_ops
        self.op_bits = op_bits
        self.ret_bits = ret_bits
        T = len(self.thread_ids)
        self.peers = {
            t: [p for p in range(T) if p != t] for t in range(T)
        }
        pre_bits = max((max_ops + 2).bit_length(), 2)
        self.pre_bits = pre_bits
        builder.flag("h_valid")
        for t in range(T):
            builder.uint(f"h{t}_n", max(max_ops.bit_length(), 1))
            builder.uint(f"h{t}_fl", op_bits + 1)
            builder.array(f"h{t}_flpre", max(T - 1, 1), pre_bits)
            builder.array(f"h{t}_op", max_ops, op_bits + 1)
            builder.array(f"h{t}_ret", max_ops, ret_bits + 1)
            builder.array(f"h{t}_pre", max(max_ops * (T - 1), 1), pre_bits)
        self.layout: Optional[Layout] = None

    def bind(self, layout: Layout) -> "BoundedHistory":
        self.layout = layout
        return self

    # --- device ops --------------------------------------------------------

    def on_invoke(self, words: torch.Tensor, t: int, op_code, enabled=True) -> None:
        """Record an invocation on (static) thread ``t`` in place: op in
        flight + real-time prereqs snapshot (linearizability.rs:114-126).

        An invoke while another op is in flight is a *protocol* violation:
        the tester poisons ``is_valid_history`` (consistency_tester
        HistoryError semantics) and so does this — ``h_valid`` is cleared,
        matching how ``record_invocations`` swallows the HistoryError but
        keeps the poisoned tester."""
        L = self.layout
        # A poisoned history is frozen: the tester raises HistoryError on
        # every later call and record_* leave it unchanged.
        valid = L.get(words, "h_valid")
        enabled = (valid != 0) & enabled
        cur = L.get(words, f"h{t}_fl")
        misuse = enabled & (cur != 0)
        L.set_(words, "h_valid", torch.where(misuse, 0, valid))
        do = enabled & ~misuse
        L.set_(words, f"h{t}_fl", torch.where(do, op_code + 1, cur))
        if self.real_time:
            for pi, p in enumerate(self.peers[t]):
                pn = L.get(words, f"h{p}_n")
                # Tester semantics: peers with no completed ops are absent.
                pre = torch.where(pn > 0, pn + 1, 0)  # (n-1)+2
                cur = L.get(words, f"h{t}_flpre", pi)
                L.set_(words, f"h{t}_flpre", torch.where(do, pre, cur), pi)

    def on_return(self, words: torch.Tensor, t: int, ret_code, enabled=True) -> torch.Tensor:
        """Record a return on thread ``t`` in place: moves the in-flight op
        (with its prereqs) into the completed list. Returns the bool
        ``overflow``.

        ``overflow`` is True when the completed list is full (the static
        ``max_ops`` bound is too small for a reachable history) — models
        must route it into ``packed_step``'s overflow output so the engine
        fails loudly instead of silently truncating the history. A return
        with no in-flight op is a protocol violation and poisons
        ``h_valid`` like the tester does."""
        L = self.layout
        # Frozen once poisoned (see on_invoke).
        valid = L.get(words, "h_valid")
        enabled = (valid != 0) & enabled
        n = L.get(words, f"h{t}_n")
        fl = L.get(words, f"h{t}_fl")
        slot = torch.clamp(n, max=self.max_ops - 1)
        misuse = enabled & (fl == 0)
        overflow = enabled & (fl != 0) & (n >= self.max_ops)
        L.set_(words, "h_valid", torch.where(misuse, 0, valid))
        do = enabled & (fl != 0) & (n < self.max_ops)
        cur_op = L.get(words, f"h{t}_op", slot)
        L.set_(words, f"h{t}_op", torch.where(do, fl, cur_op), slot)
        cur_ret = L.get(words, f"h{t}_ret", slot)
        L.set_(words, f"h{t}_ret", torch.where(do, ret_code + 1, cur_ret), slot)
        npeer = max(len(self.peers[t]), 1)
        for pi, _ in enumerate(self.peers[t]):
            pre = L.get(words, f"h{t}_flpre", pi)
            idx = slot * npeer + pi
            cur = L.get(words, f"h{t}_pre", idx)
            L.set_(words, f"h{t}_pre", torch.where(do, pre, cur), idx)
            L.set_(words, f"h{t}_flpre", torch.where(do, 0, pre), pi)
        L.set_(words, f"h{t}_fl", torch.where(do, 0, fl))
        L.set_(words, f"h{t}_n", torch.where(do, n + 1, n))
        return overflow

    def valid_with_no_return_geq(self, words: torch.Tensor, min_ret_code: int) -> torch.Tensor:
        """Bool per word vector: the history is unpoisoned AND no completed
        op returned a code ``>= min_ret_code`` (``history_codecs`` assigns
        WriteOk code 0 and ReadOk codes ``>= 1``, so ``min_ret_code=1``
        reads "valid and no completed read"). Kept here so the +1
        slot-storage offset stays private to this class."""
        L = self.layout
        ok = L.get(words, "h_valid") != 0
        threshold = min_ret_code + 1  # slots store code+1; 0 = empty
        for t in range(len(self.thread_ids)):
            for j in range(self.max_ops):
                ok = ok & (L.get(words, f"h{t}_ret", j) < threshold)
        return ok

    # --- host codec --------------------------------------------------------

    def from_tester(self, tester, op_code, ret_code) -> Dict[str, Any]:
        """Field values for :meth:`Layout.pack` from a live tester.
        ``op_code``/``ret_code`` map op/ret objects to closed-universe ints."""
        T = len(self.thread_ids)
        values: Dict[str, Any] = {"h_valid": 1 if tester.is_valid_history else 0}
        for t in range(T):
            tid = self.thread_ids[t]
            completed = tester.history_by_thread.get(tid, [])
            if len(completed) > self.max_ops:
                raise OverflowError32(
                    f"thread {tid!r}: {len(completed)} completed ops > {self.max_ops}"
                )
            values[f"h{t}_n"] = len(completed)
            ops, rets, pres = [0] * self.max_ops, [0] * self.max_ops, [0] * max(
                self.max_ops * (T - 1), 1
            )
            for j, (prereqs, op, ret) in enumerate(completed):
                ops[j] = op_code(op) + 1
                rets[j] = ret_code(ret) + 1
                for pi, p in enumerate(self.peers[t]):
                    pid = self.thread_ids[p]
                    if pid in prereqs:
                        pres[j * max(T - 1, 1) + pi] = prereqs[pid] + 2
            values[f"h{t}_op"] = ops
            values[f"h{t}_ret"] = rets
            values[f"h{t}_pre"] = pres
            flpre = [0] * max(T - 1, 1)
            if tid in tester.in_flight_by_thread:
                prereqs, op = tester.in_flight_by_thread[tid]
                values[f"h{t}_fl"] = op_code(op) + 1
                for pi, p in enumerate(self.peers[t]):
                    pid = self.thread_ids[p]
                    if pid in prereqs:
                        flpre[pi] = prereqs[pid] + 2
            else:
                values[f"h{t}_fl"] = 0
            values[f"h{t}_flpre"] = flpre
        return values

    def to_tester(self, fields: Dict[str, Any], make_tester, code_op, code_ret):
        """Rebuild the tester from :meth:`Layout.unpack` output.
        ``make_tester()`` builds an empty tester; ``code_op``/``code_ret``
        invert the code maps."""
        tester = make_tester()
        tester.is_valid_history = bool(fields["h_valid"])
        T = len(self.thread_ids)
        for t in range(T):
            tid = self.thread_ids[t]
            n = fields[f"h{t}_n"]
            if n > 0 or fields[f"h{t}_fl"] != 0:
                tester.history_by_thread.setdefault(tid, [])
            for j in range(n):
                prereqs = {}
                for pi, p in enumerate(self.peers[t]):
                    raw = fields[f"h{t}_pre"][j * max(T - 1, 1) + pi]
                    if raw:
                        prereqs[self.thread_ids[p]] = raw - 2
                tester.history_by_thread[tid].append(
                    (
                        prereqs,
                        code_op(fields[f"h{t}_op"][j] - 1),
                        code_ret(fields[f"h{t}_ret"][j] - 1),
                    )
                )
            fl = fields[f"h{t}_fl"]
            if fl:
                prereqs = {}
                for pi, p in enumerate(self.peers[t]):
                    raw = fields[f"h{t}_flpre"][pi]
                    if raw:
                        prereqs[self.thread_ids[p]] = raw - 2
                tester.in_flight_by_thread[tid] = (prereqs, code_op(fl - 1))
        return tester
