"""Dense natural-key map.

The port's own copy of ``stateright_tpu/utils/densenatmap.py``
(stateright's ``src/util/densenatmap.rs``): a list-backed map for keys
densely packed in ``0..n`` (actor ids, process ids). Insertion at a gap
raises (densenatmap.rs:98-113)."""

from __future__ import annotations

from typing import Any, Iterator, List, Sequence, Tuple


class DenseNatMap:
    __slots__ = ("_values",)

    def __init__(self, values: Sequence[Any] = ()):
        self._values: List[Any] = list(values)

    @staticmethod
    def from_iter(values) -> "DenseNatMap":
        return DenseNatMap(list(values))

    def insert(self, key: int, value: Any) -> None:
        k = int(key)
        if k < len(self._values):
            self._values[k] = value
        elif k == len(self._values):
            self._values.append(value)
        else:
            raise IndexError(
                f"DenseNatMap keys must be dense: inserting {k} with len {len(self._values)}"
            )

    def get(self, key: int) -> Any:
        k = int(key)
        return self._values[k] if 0 <= k < len(self._values) else None

    def __getitem__(self, key: int) -> Any:
        return self._values[int(key)]

    def __setitem__(self, key: int, value: Any) -> None:
        self.insert(key, value)

    def __len__(self) -> int:
        return len(self._values)

    def __iter__(self) -> Iterator[Any]:
        return iter(self._values)

    def items(self) -> Iterator[Tuple[int, Any]]:
        return enumerate(self._values)

    def values(self) -> List[Any]:
        return list(self._values)

    def __eq__(self, other) -> bool:
        return isinstance(other, DenseNatMap) and self._values == other._values

    def __hash__(self) -> int:
        return hash(tuple(self._values))

    def __fingerprint_key__(self):
        return tuple(self._values)

    def __rewrite__(self, plan):
        """Reindexes by the plan's permutation (densenatmap.rs:223-238)."""
        return DenseNatMap(plan.reindex(self._values))

    def __repr__(self) -> str:
        return f"DenseNatMap({self._values!r})"
