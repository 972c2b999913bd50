"""Stack-like vector reference semantics (semantics/vec.rs:22-50).

The port's own copy of ``stateright_tpu/semantics/vec.py``.
"""

from __future__ import annotations

from typing import Any, Tuple

from ..utils.variant import variant
from . import SequentialSpec

Push = variant("Push", ["value"])
Pop = variant("Pop", [])
Len = variant("Len", [])
PushOk = variant("PushOk", [])
PopOk = variant("PopOk", ["value"])  # value None when empty
LenOk = variant("LenOk", ["length"])


class VecSpec(SequentialSpec):
    """Reference object over a growable vector: push/pop/len.  (Named
    ``Vec`` in the reference, where the spec is implemented directly on
    ``std::vec::Vec``.)"""

    __slots__ = ("items",)

    def __init__(self, items: Tuple[Any, ...] = ()):
        self.items = tuple(items)

    def invoke(self, op: Any) -> Any:
        if isinstance(op, Push):
            self.items = self.items + (op.value,)
            return PushOk()
        if isinstance(op, Pop):
            if not self.items:
                return PopOk(None)
            top, self.items = self.items[-1], self.items[:-1]
            return PopOk(top)
        if isinstance(op, Len):
            return LenOk(len(self.items))
        raise TypeError(f"unknown vec op {op!r}")

    def is_valid_step(self, op: Any, ret: Any) -> bool:
        if isinstance(op, Push) and isinstance(ret, PushOk):
            self.items = self.items + (op.value,)
            return True
        if isinstance(op, Pop) and isinstance(ret, PopOk):
            if not self.items:
                return ret.value is None
            top, rest = self.items[-1], self.items[:-1]
            if ret.value == top:
                self.items = rest
                return True
            return False
        if isinstance(op, Len) and isinstance(ret, LenOk):
            return len(self.items) == ret.length
        return False

    def clone(self) -> "VecSpec":
        return VecSpec(self.items)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, VecSpec) and self.items == other.items

    def __hash__(self) -> int:
        return hash(("VecSpec", self.items))

    def __repr__(self) -> str:
        return f"VecSpec({list(self.items)!r})"

    def __fingerprint_key__(self):
        return self.items
