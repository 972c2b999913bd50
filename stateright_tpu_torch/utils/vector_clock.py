"""Vector clocks.

The port's own copy of ``stateright_tpu/utils/vector_clock.py``
(stateright's ``src/util/vector_clock.rs``): classic vector clocks with
zero-suffix-insensitive equality and hashing (vector_clock.rs:12-107)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple


def _trim(values: Sequence[int]) -> Tuple[int, ...]:
    vals = tuple(values)
    end = len(vals)
    while end and vals[end - 1] == 0:
        end -= 1
    return vals[:end]


class VectorClock:
    __slots__ = ("_values",)

    def __init__(self, values: Sequence[int] = ()):
        self._values = _trim(values)

    def get(self, index: int) -> int:
        return self._values[index] if index < len(self._values) else 0

    def incremented(self, index: int) -> "VectorClock":
        vals = list(self._values) + [0] * max(0, index + 1 - len(self._values))
        vals[index] += 1
        return VectorClock(vals)

    def merge_max(self, other: "VectorClock") -> "VectorClock":
        n = max(len(self._values), len(other._values))
        return VectorClock([max(self.get(i), other.get(i)) for i in range(n)])

    def partial_cmp(self, other: "VectorClock") -> Optional[int]:
        """-1 if self < other, 0 if equal, 1 if self > other, None if
        concurrent (incomparable)."""
        n = max(len(self._values), len(other._values))
        less = any(self.get(i) < other.get(i) for i in range(n))
        greater = any(self.get(i) > other.get(i) for i in range(n))
        if less and greater:
            return None
        if less:
            return -1
        if greater:
            return 1
        return 0

    def __lt__(self, other):
        if not isinstance(other, VectorClock):
            return NotImplemented
        return self.partial_cmp(other) == -1

    def __le__(self, other):
        if not isinstance(other, VectorClock):
            return NotImplemented
        return self.partial_cmp(other) in (-1, 0)

    def __gt__(self, other):
        if not isinstance(other, VectorClock):
            return NotImplemented
        return self.partial_cmp(other) == 1

    def __ge__(self, other):
        if not isinstance(other, VectorClock):
            return NotImplemented
        return self.partial_cmp(other) in (0, 1)

    def __eq__(self, other) -> bool:
        return isinstance(other, VectorClock) and self._values == other._values

    def __hash__(self) -> int:
        return hash(self._values)

    def __fingerprint_key__(self):
        return self._values

    def __repr__(self) -> str:
        return f"VectorClock({list(self._values)!r})"

    def __str__(self) -> str:
        # Display parity with the reference (vector_clock.rs can_display):
        # stored elements then an ellipsis for the implicit zeros.
        return "<" + "".join(f"{v}, " for v in self._values) + "...>"
