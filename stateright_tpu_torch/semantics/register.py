"""Read/write register reference semantics (semantics/register.rs:9-49).

The port's own copy of ``stateright_tpu/semantics/register.py``.
"""

from __future__ import annotations

from typing import Any

from ..utils.variant import variant
from . import SequentialSpec

Write = variant("Write", ["value"])
Read = variant("Read", [])
WriteOk = variant("WriteOk", [])
ReadOk = variant("ReadOk", ["value"])


class Register(SequentialSpec):
    """A register holding a single value; reads observe the latest write."""

    __slots__ = ("value",)

    def __init__(self, value: Any):
        self.value = value

    def invoke(self, op: Any) -> Any:
        if isinstance(op, Write):
            self.value = op.value
            return WriteOk()
        if isinstance(op, Read):
            return ReadOk(self.value)
        raise TypeError(f"unknown register op {op!r}")

    def is_valid_step(self, op: Any, ret: Any) -> bool:
        # Specialized like register.rs:38-49.
        if isinstance(op, Write) and isinstance(ret, WriteOk):
            self.value = op.value
            return True
        if isinstance(op, Read) and isinstance(ret, ReadOk):
            return self.value == ret.value
        return False

    def clone(self) -> "Register":
        return Register(self.value)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Register) and self.value == other.value

    def __hash__(self) -> int:
        return hash(("Register", self.value))

    def __repr__(self) -> str:
        return f"Register({self.value!r})"

    def __fingerprint_key__(self):
        return self.value
