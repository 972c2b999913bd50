"""Racy shared counter: the canonical symmetry-reduction demo.

Counterpart of ``stateright_tpu/models/increment.py``, with the transition
system of stateright's ``examples/increment.rs``: N threads each execute
``1: t = SHARED; 2: SHARED = t + 1; 3:`` with the two instructions atomic
but interleavable, so the final counter can undercount. The ``fin``
invariant ("SHARED equals the number of finished threads") is intentionally
violated.

stateright's doc comment enumerates the state space for 2 threads: 13
unique states without symmetry reduction, 8 with it (increment.rs:31-105).

- :class:`Increment` — the object-level ``Model``; states are nested
  tuples, canonicalized by sorting the per-thread slice.
- :class:`PackedIncrement` — the GPU form: the shared counter and the
  per-thread ``(t, pc)`` slices as :mod:`~stateright_tpu_torch.packing`
  fields (W = 3 words), one action slot per thread (A = N).
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Tuple

import numpy as np
import torch

from ..core import Model, Property
from ..packing import LayoutBuilder, bits_for
from ..sym import SymmetrySpec
from ..utils.variant import variant

Proc = Tuple[int, int]  # (thread-local value t, program counter pc)

Read = variant("Read", ["thread"])
Write = variant("Write", ["thread"])


class IncrementState(NamedTuple):
    """(shared counter, per-thread (t, pc) slices) — increment.rs:117-131."""

    i: int
    s: Tuple[Proc, ...]

    def representative(self) -> "IncrementState":
        """Threads are interchangeable: the canonical class member sorts the
        thread slice (increment.rs:142-151)."""
        return IncrementState(self.i, tuple(sorted(self.s)))


class Increment(Model):
    """The model (increment.rs:153-197): the initial state doubles as the
    model value, as in stateright."""

    def __init__(self, thread_count: int = 3):
        self.thread_count = thread_count

    def init_states(self) -> List[IncrementState]:
        return [IncrementState(0, tuple((0, 1) for _ in range(self.thread_count)))]

    def actions(self, state: IncrementState, actions: List[Any]) -> None:
        for thread_id, (_t, pc) in enumerate(state.s):
            if pc == 1:
                actions.append(Read(thread_id))
            elif pc == 2:
                actions.append(Write(thread_id))

    def next_state(self, last_state: IncrementState, action: Any):
        s = list(last_state.s)
        if isinstance(action, Read):
            s[action.thread] = (last_state.i, 2)
            return IncrementState(last_state.i, tuple(s))
        t, _pc = s[action.thread]
        s[action.thread] = (t, 3)
        return IncrementState(t + 1, tuple(s))

    def properties(self) -> List[Property]:
        return [
            Property.always(
                "fin",
                lambda _m, state: sum(1 for _t, pc in state.s if pc == 3) == state.i,
            )
        ]


class PackedIncrement(Increment):
    """The racy counter on the GPU engine (``spawn_xla``). Slot k is thread
    k's one enabled instruction: its program counter enables at most one
    (increment.rs:158-169). Thread k's ``(t, pc)`` elements are block k of
    the ``symmetry_spec``, whose canonicalization equals
    :meth:`packed_representative` bit for bit."""

    def __init__(self, thread_count: int = 3):
        super().__init__(thread_count)
        n = thread_count
        self._layout = (
            LayoutBuilder()
            .uint("i", bits_for(n))
            .array("t", n, bits_for(n))
            .array("pc", n, 2)  # 1..3
            .finish()
        )
        self.state_words = self._layout.words
        self.max_actions = n
        if n >= 2:
            self.symmetry_spec = SymmetrySpec.from_layout(
                self._layout, ["t", "pc"], group="threads", name="increment"
            )

    # --- host codec --------------------------------------------------------

    def pack(self, state: IncrementState):
        return self._layout.pack(
            i=state.i,
            t=[t for t, _pc in state.s],
            pc=[pc for _t, pc in state.s],
        )

    def unpack(self, words) -> IncrementState:
        f = self._layout.unpack(words)
        return IncrementState(
            f["i"], tuple(zip((int(x) for x in f["t"]), (int(x) for x in f["pc"])))
        )

    def packed_init(self):
        return np.stack([self.pack(s) for s in self.init_states()])

    # --- batched device functions ---------------------------------------------

    def packed_step(self, words: torch.Tensor):
        """``[F, W]`` -> ``([F, A, W], [F, A])``. Slot k: Read at pc=1
        (t := i, pc := 2), Write at pc=2 (i := t+1, pc := 3)."""
        L = self._layout
        i_val = L.get(words, "i")
        nxt, valid = [], []
        for k in range(self.thread_count):
            pc = L.get(words, "pc", k)
            t = L.get(words, "t", k)
            read_w = L.set(L.set(words, "t", i_val, k), "pc", 2, k)
            write_w = L.set(L.set(words, "i", t + 1), "pc", 3, k)
            is_read = pc == 1
            nxt.append(torch.where(is_read[:, None], read_w, write_w))
            valid.append(is_read | (pc == 2))
        return torch.stack(nxt, 1), torch.stack(valid, 1)

    def packed_properties(self, words: torch.Tensor) -> torch.Tensor:
        """``[F, W]`` -> ``[F, 1]``: ``fin``."""
        L = self._layout
        fin = sum((L.get(words, "pc", k) == 3).to(words.dtype) for k in range(self.thread_count))
        return (fin == L.get(words, "i"))[:, None]

    def packed_representative(self, words: torch.Tensor) -> torch.Tensor:
        """``[F, W]`` -> ``[F, W]``: the thread slice sorted by ``(t, pc)``
        (stable), the packed form of :meth:`IncrementState.representative`."""
        return sort_threads(self._layout, self.thread_count, words, pc_span=4)


def sort_threads(layout, n: int, words: torch.Tensor, pc_span: int) -> torch.Tensor:
    """The ``t``/``pc`` array elements of every row in ``words[F, W]``
    sorted by ``(t, pc)``, stably (``pc < pc_span``); a new tensor."""
    t = torch.stack([layout.get(words, "t", k) for k in range(n)], 1)  # [F, n]
    pc = torch.stack([layout.get(words, "pc", k) for k in range(n)], 1)
    order = torch.argsort(t * pc_span + pc, dim=1, stable=True)
    t, pc = t.gather(1, order), pc.gather(1, order)
    out = words.clone()
    for k in range(n):
        layout.set_(out, "t", t[:, k], k)
        layout.set_(out, "pc", pc[:, k], k)
    return out


def main(argv=None) -> None:
    """CLI mirroring increment.rs:199-254. ``check`` runs the GPU engine
    (``spawn_xla``, on the card); ``check-host`` and ``check-sym`` run the
    host DFS, the latter with symmetry reduction. ``explore`` serves the
    Explorer on the host engine (``serve``)."""
    import sys

    from ..report import WriteReporter

    args = list(sys.argv[1:] if argv is None else argv)
    cmd = args.pop(0) if args else None
    thread_count = int(args.pop(0)) if cmd and args else 3
    if cmd in ("check", "check-xla"):
        print(f"Model checking increment with {thread_count} threads on the GPU.")
        PackedIncrement(thread_count).checker().spawn_xla(
            frontier_capacity=1 << 12, table_capacity=1 << 16
        ).report(WriteReporter())
    elif cmd == "check-host":
        print(f"Model checking increment with {thread_count} threads.")
        Increment(thread_count).checker().spawn_dfs().report(WriteReporter())
    elif cmd == "check-sym":
        print(
            f"Model checking increment with {thread_count} threads "
            f"using symmetry reduction."
        )
        Increment(thread_count).checker().symmetry().spawn_dfs().report(WriteReporter())
    elif cmd == "explore":
        address = args.pop(0) if args else "localhost:3000"
        print(
            f"Exploring the state space of increment with {thread_count} "
            f"threads on {address}."
        )
        Increment(thread_count).checker().serve(address)
    else:
        print("USAGE:")
        print("  increment check [THREAD_COUNT]        (GPU engine)")
        print("  increment check-host [THREAD_COUNT]   (sequential host DFS)")
        print("  increment check-sym [THREAD_COUNT]")
        print("  increment check-xla [THREAD_COUNT]    (alias of check)")
        print("  increment explore [THREAD_COUNT] [ADDRESS]")


if __name__ == "__main__":
    main()
