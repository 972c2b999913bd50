"""Pending-timer sets: the port's own copy of ``stateright_tpu/actor/timers.py``
(stateright's ``src/actor/timers.rs``).

In the model a timeout is a nondeterministic action, so only the *set* of
pending timers matters — durations are irrelevant (model.rs:59-64)."""

from __future__ import annotations

from typing import Any, FrozenSet, Iterator


class Timers:
    """The set of timers currently set for one actor (timers.rs:8-48)."""

    __slots__ = ("_set",)

    def __init__(self, timers: FrozenSet[Any] = frozenset()):
        self._set = frozenset(timers)

    def set(self, timer: Any) -> "Timers":
        return Timers(self._set | {timer})

    def cancel(self, timer: Any) -> "Timers":
        return Timers(self._set - {timer})

    def contains(self, timer: Any) -> bool:
        return timer in self._set

    def __iter__(self) -> Iterator[Any]:
        # Deterministic iteration order regardless of PYTHONHASHSEED: sorted
        # by stable fingerprint (the reference gets determinism from its
        # fixed-key hasher's iteration order).
        from ..fingerprint import fingerprint

        return iter(sorted(self._set, key=fingerprint))

    def __len__(self) -> int:
        return len(self._set)

    def __eq__(self, other) -> bool:
        return isinstance(other, Timers) and self._set == other._set

    def __hash__(self) -> int:
        return hash(self._set)

    def __fingerprint_key__(self):
        return self._set

    def __rewrite__(self, plan) -> "Timers":
        """Each pending timer rewritten through a symmetry permutation, as
        stateright's ``Rewrite`` impls rewrite a set's elements; the JAX
        package's ``Timers`` has no such method, so its
        ``ActorModelState.representative`` raises on every state."""
        from ..utils.rewrite_plan import rewrite

        return Timers(frozenset(rewrite(t, plan) for t in self._set))

    def __repr__(self) -> str:
        return f"Timers({sorted(map(repr, self._set))})"
