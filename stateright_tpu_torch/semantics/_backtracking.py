"""Shared backtracking serializer behind both consistency testers.

The port's own copy of ``stateright_tpu/semantics/_backtracking.py``.

The reference implements the search twice (semantics/linearizability.rs:197-284,
semantics/sequential_consistency.rs:127-225); the only semantic difference is
that the linearizability variant records, per operation, the index of the last
operation completed by every *other* thread at invocation time, and rejects
interleavings that would reorder an operation before one of those
prerequisites ("real time" order).  Sequential consistency is the same search
with no prerequisites.  We implement the search once, parameterized by whether
real-time prerequisites are recorded.

Determinism note: the reference iterates threads in ``BTreeMap`` (sorted)
order, which fixes *which* witness serialization is returned; we iterate
sorted thread ids for the same reason, and tests assert identical witnesses.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from . import ConsistencyTester, HistoryError, SequentialSpec


class BacktrackingTester(ConsistencyTester):
    _REAL_TIME = False  # overridden by LinearizabilityTester

    def __init__(self, init_ref_obj: SequentialSpec):
        self.init_ref_obj = init_ref_obj
        # thread_id -> list of completed ops: (prereqs, op, ret) where
        # prereqs maps peer thread -> index of its last completed op at
        # invocation time ({} when real time is not tracked).
        self.history_by_thread: Dict[Any, List[Tuple[dict, Any, Any]]] = {}
        # thread_id -> (prereqs, op) for the at-most-one in-flight op.
        self.in_flight_by_thread: Dict[Any, Tuple[dict, Any]] = {}
        self.is_valid_history = True

    # --- recording (consistency_tester.rs:15-43) --------------------------

    def on_invoke(self, thread_id: Any, op: Any) -> "BacktrackingTester":
        if not self.is_valid_history:
            raise HistoryError("Earlier history was invalid.")
        if thread_id in self.in_flight_by_thread:
            self.is_valid_history = False
            raise HistoryError(
                f"Thread already has an operation in flight. "
                f"thread_id={thread_id!r}, op={self.in_flight_by_thread[thread_id][1]!r}"
            )
        if self._REAL_TIME:
            prereqs = {
                tid: len(completed) - 1
                for tid, completed in self.history_by_thread.items()
                if tid != thread_id and completed
            }
        else:
            prereqs = {}
        self.in_flight_by_thread[thread_id] = (prereqs, op)
        self.history_by_thread.setdefault(thread_id, [])
        return self

    def on_return(self, thread_id: Any, ret: Any) -> "BacktrackingTester":
        if not self.is_valid_history:
            raise HistoryError("Earlier history was invalid.")
        if thread_id not in self.in_flight_by_thread:
            self.is_valid_history = False
            raise HistoryError(
                f"There is no in-flight invocation for this thread ID. "
                f"thread_id={thread_id!r}, unexpected_return={ret!r}"
            )
        prereqs, op = self.in_flight_by_thread.pop(thread_id)
        self.history_by_thread.setdefault(thread_id, []).append((prereqs, op, ret))
        return self

    def is_consistent(self) -> bool:
        return self.serialized_history() is not None

    def __len__(self) -> int:
        return len(self.in_flight_by_thread) + sum(
            len(h) for h in self.history_by_thread.values()
        )

    # --- the search (linearizability.rs:197-284) --------------------------

    def serialized_history(self) -> Optional[List[Tuple[Any, Any]]]:
        """A total order of (op, ret) consistent with the reference object
        and the consistency model, or None.  In-flight operations may —
        but need not — take effect."""
        if not self.is_valid_history:
            return None
        remaining = {
            tid: [(i, entry) for i, entry in enumerate(completed)]
            for tid, completed in self.history_by_thread.items()
        }
        return self._serialize(
            [], self.init_ref_obj, remaining, dict(self.in_flight_by_thread)
        )

    @classmethod
    def _real_time_violation(cls, prereqs: dict, remaining: dict) -> bool:
        """An op may not be scheduled while a peer op it observed as complete
        is still unscheduled (linearizability.rs:221-233)."""
        for peer_id, min_peer_time in prereqs.items():
            peer_ops = remaining.get(peer_id)
            if peer_ops and peer_ops[0][0] <= min_peer_time:
                return True
        return False

    @classmethod
    def _serialize(
        cls,
        valid_history: List[Tuple[Any, Any]],
        ref_obj: SequentialSpec,
        remaining: Dict[Any, List[Tuple[int, Tuple[dict, Any, Any]]]],
        in_flight: Dict[Any, Tuple[dict, Any]],
    ) -> Optional[List[Tuple[Any, Any]]]:
        if all(not ops for ops in remaining.values()):
            return valid_history  # in-flight ops need never return
        for thread_id in sorted(remaining):
            thread_remaining = remaining[thread_id]
            if not thread_remaining:
                # Maybe the thread's in-flight op takes effect here; its
                # return value is chosen by the reference object.
                if thread_id not in in_flight:
                    continue
                prereqs, op = in_flight[thread_id]
                if cls._real_time_violation(prereqs, remaining):
                    continue
                next_ref_obj = ref_obj.clone()
                ret = next_ref_obj.invoke(op)
                next_in_flight = dict(in_flight)
                del next_in_flight[thread_id]
                next_remaining = remaining
            else:
                (idx, (prereqs, op, ret)) = thread_remaining[0]
                next_remaining = dict(remaining)
                next_remaining[thread_id] = thread_remaining[1:]
                if cls._real_time_violation(prereqs, next_remaining):
                    continue
                next_ref_obj = ref_obj.clone()
                if not next_ref_obj.is_valid_step(op, ret):
                    continue
                next_in_flight = in_flight
            result = cls._serialize(
                valid_history + [(op, ret)], next_ref_obj, next_remaining, next_in_flight
            )
            if result is not None:
                return result
        return None

    # --- value semantics (testers ride in fingerprinted history state) ----

    def clone(self) -> "BacktrackingTester":
        dup = type(self)(self.init_ref_obj.clone())
        dup.history_by_thread = {
            tid: list(completed) for tid, completed in self.history_by_thread.items()
        }
        dup.in_flight_by_thread = dict(self.in_flight_by_thread)
        dup.is_valid_history = self.is_valid_history
        return dup

    def _canonical(self):
        return (
            type(self).__name__,
            self.init_ref_obj.__fingerprint_key__(),
            tuple(
                (tid, tuple((tuple(sorted(pr.items())), op, ret) for pr, op, ret in cs))
                for tid, cs in sorted(self.history_by_thread.items())
            ),
            tuple(
                (tid, tuple(sorted(pr.items())), op)
                for tid, (pr, op) in sorted(self.in_flight_by_thread.items())
            ),
            self.is_valid_history,
        )

    def __eq__(self, other: Any) -> bool:
        return type(other) is type(self) and other._canonical() == self._canonical()

    def __hash__(self) -> int:
        return hash(self._canonical())

    def __fingerprint_key__(self):
        return self._canonical()

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(init={self.init_ref_obj!r}, "
            f"history={self.history_by_thread!r}, "
            f"in_flight={self.in_flight_by_thread!r})"
        )
