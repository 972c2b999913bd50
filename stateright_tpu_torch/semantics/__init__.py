"""Consistency semantics: reference objects and concurrent-history testers.

The port's own copy of ``stateright_tpu/semantics/__init__.py`` (stateright's
``src/semantics.rs``), with the register, vector and write-once-register
specs and the two testers; the device form of the testers is
:mod:`.device`. Correctness of a concurrent system is defined by a
sequential "reference object" (:class:`SequentialSpec`) plus a consistency
model that constrains how concurrent operation histories may be serialized
against it:

- :class:`LinearizabilityTester` — real-time order across threads must be
  respected (semantics/linearizability.rs:57).
- :class:`SequentialConsistencyTester` — only per-thread program order must be
  respected (semantics/sequential_consistency.rs:55).

Testers ride inside the checker as auxiliary history state (``ActorModel``'s
``H`` parameter), so they must be cheap to clone, equality-comparable, and
fingerprintable — all provided here.
"""

from __future__ import annotations

from typing import Any, Iterable, Tuple


class SequentialSpec:
    """A sequential reference object (semantics.rs:73-98).

    Subclasses define ``invoke(op) -> ret`` mutating the object, plus
    ``clone``/``__eq__``/``__fingerprint_key__``.  Op/Ret values are
    small NamedTuples (the Python rendering of the reference's enums).
    """

    def invoke(self, op: Any) -> Any:
        raise NotImplementedError

    def clone(self) -> "SequentialSpec":
        raise NotImplementedError

    def is_valid_step(self, op: Any, ret: Any) -> bool:
        """Whether invoking ``op`` *might* return ``ret``.  Default mirrors
        the reference's (semantics.rs:88-90): invoke and compare.  NOTE: like
        the reference, this MUTATES the object (applies the op)."""
        return self.invoke(op) == ret

    def is_valid_history(self, ops: Iterable[Tuple[Any, Any]]) -> bool:
        """Whether a sequential (op, ret) history is valid (semantics.rs:92-97)."""
        return all(self.is_valid_step(op, ret) for op, ret in ops)


class ConsistencyTester:
    """Records operation invocations/returns of a concurrent system and
    decides whether the history satisfies a consistency model
    (semantics/consistency_tester.rs:15-43).

    ``on_invoke``/``on_return`` raise :class:`HistoryError` on protocol
    misuse (second in-flight op for a thread, return without invocation);
    the tester is poisoned thereafter and reports inconsistent.
    """

    def on_invoke(self, thread_id: Any, op: Any) -> "ConsistencyTester":
        raise NotImplementedError

    def on_return(self, thread_id: Any, ret: Any) -> "ConsistencyTester":
        raise NotImplementedError

    def is_consistent(self) -> bool:
        raise NotImplementedError

    def on_invret(self, thread_id: Any, op: Any, ret: Any) -> "ConsistencyTester":
        return self.on_invoke(thread_id, op).on_return(thread_id, ret)


class HistoryError(ValueError):
    """An operation history violated the recording protocol."""


from .linearizability import LinearizabilityTester  # noqa: E402
from .sequential_consistency import SequentialConsistencyTester  # noqa: E402
from . import register  # noqa: E402
from . import vec  # noqa: E402
from . import write_once_register  # noqa: E402

__all__ = [
    "ConsistencyTester",
    "HistoryError",
    "LinearizabilityTester",
    "SequentialConsistencyTester",
    "SequentialSpec",
    "register",
    "vec",
    "write_once_register",
]
