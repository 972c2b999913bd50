"""Write-once register reference semantics
(semantics/write_once_register.rs:9-58): the first write wins; later writes
of a *different* value fail, rewrites of the same value succeed.

The port's own copy of ``stateright_tpu/semantics/write_once_register.py``;
its device form is :class:`~stateright_tpu_torch.semantics.device.DeviceWORegister`.
"""

from __future__ import annotations

from typing import Any, Optional

from ..utils.variant import variant
from . import SequentialSpec

Write = variant("Write", ["value"])
Read = variant("Read", [])
WriteOk = variant("WriteOk", [])
WriteFail = variant("WriteFail", [])
ReadOk = variant("ReadOk", ["value"])  # value None while unwritten


class WORegister(SequentialSpec):
    __slots__ = ("value",)

    def __init__(self, value: Optional[Any] = None):
        self.value = value

    def invoke(self, op: Any) -> Any:
        if isinstance(op, Write):
            if self.value is None or self.value == op.value:
                self.value = op.value
                return WriteOk()
            return WriteFail()
        if isinstance(op, Read):
            return ReadOk(self.value)
        raise TypeError(f"unknown WORegister op {op!r}")

    def is_valid_step(self, op: Any, ret: Any) -> bool:
        # Specialized like write_once_register.rs:46-58.
        if isinstance(op, Write):
            if isinstance(ret, WriteOk):
                if self.value is None:
                    self.value = op.value
                    return True
                return self.value == op.value
            if isinstance(ret, WriteFail):
                return self.value is not None and self.value != op.value
            return False
        if isinstance(op, Read) and isinstance(ret, ReadOk):
            return self.value == ret.value
        return False

    def clone(self) -> "WORegister":
        return WORegister(self.value)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, WORegister) and self.value == other.value

    def __hash__(self) -> int:
        return hash(("WORegister", self.value))

    def __repr__(self) -> str:
        return f"WORegister({self.value!r})"

    def __fingerprint_key__(self):
        return self.value
