"""Shared counter guarded by a lock: the fixed version of ``increment``.

Counterpart of ``stateright_tpu/models/increment_lock.py``, with the
transition system of stateright's ``examples/increment_lock.rs``: each
thread executes ``0: lock; 1: t = SHARED; 2: SHARED = t + 1; 3: unlock;
4:``, so the ``fin`` invariant ("SHARED equals the number of threads past
their write") and the ``mutex`` invariant ("at most one thread inside the
critical section") both hold — the checker finds no counterexample. At 3
threads the space is 61 generated and 61 unique states (``bench.py``
``EXPECTED_MATRIX``).

- :class:`IncrementLock` — the object-level ``Model``.
- :class:`PackedIncrementLock` — the GPU form: the counter, the lock bit
  and the per-thread ``(t, pc)`` slices as packing fields (W = 3 words), one
  action slot per thread (A = N).
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Tuple

import numpy as np
import torch

from ..core import Model, Property
from ..packing import LayoutBuilder, bits_for
from ..sym import SymmetrySpec
from ..utils.variant import variant
from .increment import sort_threads

Proc = Tuple[int, int]  # (thread-local value t, program counter pc)

Lock = variant("Lock", ["thread"])
Read = variant("Read", ["thread"])
Write = variant("Write", ["thread"])
Release = variant("Release", ["thread"])


class IncrementLockState(NamedTuple):
    """(shared counter, lock bit, per-thread (t, pc)) — increment_lock.rs:19-33."""

    i: int
    lock: bool
    s: Tuple[Proc, ...]

    def representative(self) -> "IncrementLockState":
        """Sort the interchangeable thread slice (increment_lock.rs:36-46)."""
        return IncrementLockState(self.i, self.lock, tuple(sorted(self.s)))


class IncrementLock(Model):
    """The model (increment_lock.rs:48-107)."""

    def __init__(self, thread_count: int = 3):
        self.thread_count = thread_count

    def init_states(self) -> List[IncrementLockState]:
        return [
            IncrementLockState(0, False, tuple((0, 0) for _ in range(self.thread_count)))
        ]

    def actions(self, state: IncrementLockState, actions: List[Any]) -> None:
        for thread_id, (_t, pc) in enumerate(state.s):
            if pc == 0 and not state.lock:
                actions.append(Lock(thread_id))
            elif pc == 1:
                actions.append(Read(thread_id))
            elif pc == 2:
                actions.append(Write(thread_id))
            elif pc == 3 and state.lock:
                actions.append(Release(thread_id))

    def next_state(self, last_state: IncrementLockState, action: Any):
        s = list(last_state.s)
        t, _pc = s[action.thread]
        if isinstance(action, Lock):
            s[action.thread] = (t, 1)
            return last_state._replace(lock=True, s=tuple(s))
        if isinstance(action, Read):
            s[action.thread] = (last_state.i, 2)
            return last_state._replace(s=tuple(s))
        if isinstance(action, Write):
            s[action.thread] = (t, 3)
            return last_state._replace(i=t + 1, s=tuple(s))
        s[action.thread] = (t, 4)
        return last_state._replace(lock=False, s=tuple(s))

    def properties(self) -> List[Property]:
        return [
            Property.always(
                "fin",
                lambda _m, state: sum(1 for _t, pc in state.s if pc >= 3) == state.i,
            ),
            Property.always(
                "mutex",
                lambda _m, state: sum(1 for _t, pc in state.s if 1 <= pc < 4) <= 1,
            ),
        ]


class PackedIncrementLock(IncrementLock):
    """The lock-guarded counter on the GPU engine (``spawn_xla``). Slot k is
    thread k's one enabled instruction, by program counter: Lock (pc=0,
    lock free), Read (1), Write (2), Release (3) (increment_lock.rs:61-73).
    Thread k's ``(t, pc)`` elements are block k of the ``symmetry_spec``,
    whose canonicalization equals :meth:`packed_representative` bit for
    bit."""

    def __init__(self, thread_count: int = 3):
        super().__init__(thread_count)
        n = thread_count
        self._layout = (
            LayoutBuilder()
            .uint("i", bits_for(n))
            .flag("lock")
            .array("t", n, bits_for(n))
            .array("pc", n, 3)  # 0..4
            .finish()
        )
        self.state_words = self._layout.words
        self.max_actions = n
        if n >= 2:
            self.symmetry_spec = SymmetrySpec.from_layout(
                self._layout, ["t", "pc"], group="threads", name="increment-lock"
            )

    def pack(self, state: IncrementLockState):
        return self._layout.pack(
            i=state.i,
            lock=int(state.lock),
            t=[t for t, _pc in state.s],
            pc=[pc for _t, pc in state.s],
        )

    def unpack(self, words) -> IncrementLockState:
        f = self._layout.unpack(words)
        return IncrementLockState(
            f["i"],
            bool(f["lock"]),
            tuple(zip((int(x) for x in f["t"]), (int(x) for x in f["pc"]))),
        )

    def packed_init(self):
        return np.stack([self.pack(s) for s in self.init_states()])

    def packed_step(self, words: torch.Tensor):
        """``[F, W]`` -> ``([F, A, W], [F, A])``."""
        L = self._layout
        i_val = L.get(words, "i")
        lock = L.get(words, "lock") != 0
        nxt, valid = [], []
        for k in range(self.thread_count):
            pc = L.get(words, "pc", k)
            t = L.get(words, "t", k)
            lock_w = L.set(L.set(words, "lock", 1), "pc", 1, k)
            read_w = L.set(L.set(words, "t", i_val, k), "pc", 2, k)
            write_w = L.set(L.set(words, "i", t + 1), "pc", 3, k)
            rel_w = L.set(L.set(words, "lock", 0), "pc", 4, k)
            p = pc[:, None]
            nxt.append(torch.where(p == 0, lock_w, torch.where(
                p == 1, read_w, torch.where(p == 2, write_w, rel_w))))
            ok = torch.where(pc == 0, ~lock, (pc == 1) | (pc == 2) | ((pc == 3) & lock))
            valid.append(ok)
        return torch.stack(nxt, 1), torch.stack(valid, 1)

    def packed_properties(self, words: torch.Tensor) -> torch.Tensor:
        """``[F, W]`` -> ``[F, 2]``: ``fin`` and ``mutex``."""
        L = self._layout
        pcs = [L.get(words, "pc", k) for k in range(self.thread_count)]
        fin = sum((pc >= 3).to(words.dtype) for pc in pcs)
        crit = sum(((pc >= 1) & (pc < 4)).to(words.dtype) for pc in pcs)
        return torch.stack([fin == L.get(words, "i"), crit <= 1], 1)

    def packed_representative(self, words: torch.Tensor) -> torch.Tensor:
        """``[F, W]`` -> ``[F, W]``: the thread slice sorted by ``(t, pc)``
        (stable), the packed form of :meth:`IncrementLockState.representative`."""
        return sort_threads(self._layout, self.thread_count, words, pc_span=8)


def main(argv=None) -> None:
    """CLI mirroring increment_lock.rs:109-161. ``check`` runs the GPU engine
    (``spawn_xla``, on the card); ``check-host`` and ``check-sym`` run the
    host DFS, the latter with symmetry reduction. ``explore`` waits for the
    Explorer (ROADMAP A10)."""
    import sys

    from ..report import WriteReporter

    args = list(sys.argv[1:] if argv is None else argv)
    cmd = args.pop(0) if args else None
    thread_count = int(args.pop(0)) if cmd and args else 3
    if cmd in ("check", "check-xla"):
        print(f"Model checking increment_lock with {thread_count} threads on the GPU.")
        PackedIncrementLock(thread_count).checker().spawn_xla(
            frontier_capacity=1 << 12, table_capacity=1 << 16
        ).report(WriteReporter())
    elif cmd == "check-host":
        print(f"Model checking increment_lock with {thread_count} threads.")
        IncrementLock(thread_count).checker().spawn_dfs().report(WriteReporter())
    elif cmd == "check-sym":
        print(
            f"Model checking increment_lock with {thread_count} threads "
            f"using symmetry reduction."
        )
        IncrementLock(thread_count).checker().symmetry().spawn_dfs().report(WriteReporter())
    elif cmd == "explore":
        raise NotImplementedError("explore waits for the Explorer (ROADMAP A10)")
    else:
        print("USAGE:")
        print("  increment_lock check [THREAD_COUNT]        (GPU engine)")
        print("  increment_lock check-host [THREAD_COUNT]   (sequential host DFS)")
        print("  increment_lock check-sym [THREAD_COUNT]")
        print("  increment_lock check-xla [THREAD_COUNT]    (alias of check)")


if __name__ == "__main__":
    main()
