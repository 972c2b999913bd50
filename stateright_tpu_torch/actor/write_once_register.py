"""Write-once-register protocol interface + test client.

Counterpart of ``stateright_tpu/actor/write_once_register.py``
(stateright's ``src/actor/write_once_register.rs``): the register
protocol extended with ``PutFail`` (a later write of a different value is
rejected), recording glue onto a ``WORegister`` consistency tester, and the
same Put-then-Get scripted client.  Same design delta as
``actor/register.py``: servers are added unwrapped; the client is
:class:`WORegisterClient`.
"""

from __future__ import annotations

from ..semantics import HistoryError
from ..semantics.write_once_register import Read as WORead
from ..semantics.write_once_register import ReadOk as WOReadOk
from ..semantics.write_once_register import Write as WOWrite
from ..semantics.write_once_register import WriteFail as WOWriteFail
from ..semantics.write_once_register import WriteOk as WOWriteOk
from ..utils.variant import variant

Internal = variant("Internal", ["msg"])
Put = variant("Put", ["request_id", "value"])
Get = variant("Get", ["request_id"])
PutOk = variant("PutOk", ["request_id"])
PutFail = variant("PutFail", ["request_id"])
GetOk = variant("GetOk", ["request_id", "value"])


def wo_history_codecs(values):
    """Closed-universe op/ret codes for WORegister histories over ``values``
    (``values[0]`` is the unwritten ``None``) — the WORegister analogue of
    ``register.history_codecs``, for packed models running
    :class:`~stateright_tpu_torch.packing.BoundedHistory` over a
    ``LinearizabilityTester(WORegister(None))`` with the device check
    :class:`~stateright_tpu_torch.semantics.device.DeviceWORegister`.

    Returns ``(op_code, code_op, ret_code, code_ret)``:
    ``Read() = 0``, ``Write(v) = 1 + values.index(v)``;
    ``WriteOk() = 0``, ``WriteFail() = 1``, ``ReadOk(v) = 2 + values.index(v)``.
    """

    def op_code(op):
        return 0 if isinstance(op, WORead) else 1 + values.index(op.value)

    def code_op(c):
        return WORead() if c == 0 else WOWrite(values[c - 1])

    def ret_code(ret):
        if isinstance(ret, WOWriteOk):
            return 0
        if isinstance(ret, WOWriteFail):
            return 1
        return 2 + values.index(ret.value)

    def code_ret(c):
        if c == 0:
            return WOWriteOk()
        if c == 1:
            return WOWriteFail()
        return WOReadOk(values[c - 2])

    return op_code, code_op, ret_code, code_ret


def record_invocations(cfg, history, env):
    """Pass to ``ActorModel.record_msg_out`` (write_once_register.rs:39-61)."""
    if isinstance(env.msg, Get):
        history = history.clone()
        try:
            history.on_invoke(env.src, WORead())
        except HistoryError:
            pass
        return history
    if isinstance(env.msg, Put):
        history = history.clone()
        try:
            history.on_invoke(env.src, WOWrite(env.msg.value))
        except HistoryError:
            pass
        return history
    return None


def record_returns(cfg, history, env):
    """Pass to ``ActorModel.record_msg_in`` (write_once_register.rs:64-97).
    Note ``GetOk(v)`` maps to ``ReadOk(Some(v))`` — the in-protocol Get only
    returns once a value exists."""
    if isinstance(env.msg, GetOk):
        history = history.clone()
        try:
            history.on_return(env.dst, WOReadOk(env.msg.value))
        except HistoryError:
            pass
        return history
    if isinstance(env.msg, PutOk):
        history = history.clone()
        try:
            history.on_return(env.dst, WOWriteOk())
        except HistoryError:
            pass
        return history
    if isinstance(env.msg, PutFail):
        history = history.clone()
        try:
            history.on_return(env.dst, WOWriteFail())
        except HistoryError:
            pass
        return history
    return None


ClientState = variant("ClientState", ["awaiting", "op_count"])


class WORegisterClient:
    """Put-then-Get scripted client (write_once_register.rs:126-238);
    a ``PutFail`` response advances the script just like ``PutOk``."""

    def __init__(self, put_count: int, server_count: int):
        self.put_count = put_count
        self.server_count = server_count

    def on_start(self, id, out):
        from . import Id

        index = int(id)
        if index < self.server_count:
            raise ValueError(
                "WORegisterClient actors must be added to the model after servers."
            )
        if self.put_count == 0:
            return ClientState(awaiting=None, op_count=0)
        unique_request_id = 1 * index
        value = chr(ord("A") + index - self.server_count)
        out.send(Id(index % self.server_count), Put(unique_request_id, value))
        return ClientState(awaiting=unique_request_id, op_count=1)

    def on_msg(self, id, state, src, msg, out):
        from . import Id

        current = state.get()
        if current.awaiting is None:
            return
        index = int(id)
        acked = isinstance(msg, (PutOk, PutFail)) and msg.request_id == current.awaiting
        if acked:
            unique_request_id = (current.op_count + 1) * index
            if current.op_count < self.put_count:
                value = chr(ord("Z") - (index - self.server_count))
                out.send(
                    Id((index + current.op_count) % self.server_count),
                    Put(unique_request_id, value),
                )
            else:
                out.send(
                    Id((index + current.op_count) % self.server_count),
                    Get(unique_request_id),
                )
            state.set(
                ClientState(awaiting=unique_request_id, op_count=current.op_count + 1)
            )
        elif isinstance(msg, GetOk) and msg.request_id == current.awaiting:
            state.set(ClientState(awaiting=None, op_count=current.op_count + 1))

    def on_timeout(self, id, state, timer, out):
        pass
