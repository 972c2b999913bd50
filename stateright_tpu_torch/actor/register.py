"""Register protocol interface + test client for model checking.

Counterpart of ``stateright_tpu/actor/register.py`` (stateright's
``src/actor/register.rs``): a message protocol for
register-like systems (``Put``/``Get``/``PutOk``/``GetOk`` + ``Internal``),
glue that records those messages as consistency-tester invocations/returns
(register.rs:38-91), and a scripted client that Puts then Gets round-robin
across servers (register.rs:94-260).

Design delta: Rust wraps servers in ``RegisterActor::Server`` so one enum
covers both roles; under duck typing servers are added to the model directly
and the client is the plain :class:`RegisterClient` actor — so server states
appear unwrapped in ``actor_states``.

:class:`PackedClientsMixin` is the batched tensor form of the clients'
protocol half for packed models (``models/paxos.py``,
``models/single_copy_register.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..semantics import HistoryError
from ..semantics.register import Read as RegisterRead
from ..semantics.register import ReadOk as RegisterReadOk
from ..semantics.register import Write as RegisterWrite
from ..semantics.register import WriteOk as RegisterWriteOk
from ..utils.variant import variant

#: A message specific to the register system's internal protocol.
Internal = variant("Internal", ["msg"])
Put = variant("Put", ["request_id", "value"])
Get = variant("Get", ["request_id"])
PutOk = variant("PutOk", ["request_id"])
GetOk = variant("GetOk", ["request_id", "value"])


def record_invocations(cfg, history, env):
    """Pass to ``ActorModel.record_msg_out``: ``Get``→``Read`` invocation,
    ``Put``→``Write`` invocation by the sending client (register.rs:38-62).
    Invalid histories poison the tester rather than crash the check."""
    if isinstance(env.msg, Get):
        history = history.clone()
        try:
            history.on_invoke(env.src, RegisterRead())
        except HistoryError:
            pass
        return history
    if isinstance(env.msg, Put):
        history = history.clone()
        try:
            history.on_invoke(env.src, RegisterWrite(env.msg.value))
        except HistoryError:
            pass
        return history
    return None


def record_returns(cfg, history, env):
    """Pass to ``ActorModel.record_msg_in``: ``GetOk``→``ReadOk`` return,
    ``PutOk``→``WriteOk`` return to the receiving client (register.rs:64-91)."""
    if isinstance(env.msg, GetOk):
        history = history.clone()
        try:
            history.on_return(env.dst, RegisterReadOk(env.msg.value))
        except HistoryError:
            pass
        return history
    if isinstance(env.msg, PutOk):
        history = history.clone()
        try:
            history.on_return(env.dst, RegisterWriteOk())
        except HistoryError:
            pass
        return history
    return None


def linearizable_condition():
    """An ``always`` property condition: the history (a
    ``LinearizabilityTester`` riding in the model state) admits a legal
    serialization. ``serialized_history()`` is a backtracking search and
    histories recur across many states, so consistency is memoized per
    distinct history value (one cache per built model)."""
    cache: dict = {}

    def linearizable(_model, state) -> bool:
        h = state.history
        hit = cache.get(h)
        if hit is None:
            hit = h.serialized_history() is not None
            cache[h] = hit
        return hit

    return linearizable


def value_chosen_condition(_model=None, state=None) -> bool:
    """A ``sometimes`` property condition: some deliverable ``GetOk``
    carries a real (written) value — the register protocols' reachability
    check (e.g. single-copy-register.rs:73-82)."""
    for env in state.network.iter_deliverable():
        if isinstance(env.msg, GetOk) and env.msg.value is not None:
            return True
    return False


def history_codecs(values):
    """Closed-universe op/ret codes for register histories over ``values``
    (a list whose first element is the unwritten ``None``): used by packed
    models to run :class:`~stateright_tpu_torch.packing.BoundedHistory` over a
    ``LinearizabilityTester`` of the ``Register`` spec.

    Returns ``(op_code, code_op, ret_code, code_ret)``:
    ``Read() = 0``, ``Write(v) = 1 + values.index(v)``;
    ``WriteOk() = 0``, ``ReadOk(v) = 1 + values.index(v)``.
    """
    def op_code(op):
        if isinstance(op, RegisterRead):
            return 0
        return 1 + values.index(op.value)

    def code_op(c):
        return RegisterRead() if c == 0 else RegisterWrite(values[c - 1])

    def ret_code(ret):
        if isinstance(ret, RegisterWriteOk):
            return 0
        return 1 + values.index(ret.value)

    def code_ret(c):
        return RegisterWriteOk() if c == 0 else RegisterReadOk(values[c - 1])

    return op_code, code_op, ret_code, code_ret


ClientState = variant("ClientState", ["awaiting", "op_count"])


class PackedClientsMixin:
    """Shared batched machinery for packed models whose clients are
    :class:`RegisterClient` actors (register.rs:94-260, ``put_count=1``).

    Host codec + batched delivery bodies for the client-facing protocol
    half (PutOk/GetOk), over layout fields declared by :meth:`_client_layout`
    and a bounded history ``self._hist``
    (:class:`~stateright_tpu_torch.packing.BoundedHistory`). Expects on
    ``self``: ``S`` (server count), ``C`` (client count), ``_layout``,
    ``_hist``, ``_OverflowError32``.

    Client state encoding: ``cl_await`` 0 = idle, 1 = awaiting PutOk of
    request ``1*i``, 2 = awaiting GetOk of request ``2*i`` (i = S + k);
    ``cl_ops`` mirrors ``ClientState.op_count``.
    """

    def _client_layout(self, b) -> None:
        b.array("cl_await", self.C, 2)
        b.array("cl_ops", self.C, 2)

    def _client_values(self):
        """The closed register-value universe: the unwritten ``None`` plus
        each client's written value (client k writes chr('A'+k))."""
        return [None] + [chr(ord("A") + k) for k in range(self.C)]

    def _val_code(self, val) -> int:
        try:
            return self.values.index(val)
        except ValueError:
            raise self._OverflowError32(f"value outside universe: {val!r}") from None

    # --- host codec --------------------------------------------------------

    def _pack_clients(self, fields, state) -> None:
        S, C = self.S, self.C
        fields["cl_await"] = [0] * C
        fields["cl_ops"] = [0] * C
        for k in range(C):
            i = S + k
            cs = state.actor_states[S + k]
            if cs.awaiting is None:
                fields["cl_await"][k] = 0
            elif cs.awaiting == 1 * i:
                fields["cl_await"][k] = 1
            elif cs.awaiting == 2 * i:
                fields["cl_await"][k] = 2
            else:  # pragma: no cover - unreachable by construction
                raise self._OverflowError32(f"unexpected request id {cs.awaiting}")
            fields["cl_ops"][k] = cs.op_count

    def _unpack_clients(self, f, actor_states) -> None:
        S, C = self.S, self.C
        for k in range(C):
            i = S + k
            awaiting = {0: None, 1: 1 * i, 2: 2 * i}[f["cl_await"][k]]
            actor_states.append(
                ClientState(awaiting=awaiting, op_count=f["cl_ops"][k])
            )

    # --- family machinery --------------------------------------------------
    # Models enumerate a closed envelope universe into self._handlers
    # [(kind, static params)] in code order; these helpers group contiguous
    # same-kind runs into (kind, codes, param-table) families and run one
    # batched body per family over its whole parameter table.

    def _group_families(self, params_for):
        """Group ``self._handlers`` into families ``(kind, codes, params)``
        with uint32 parameter tables built by ``params_for(kind, params) ->
        list[int]``."""
        families = []
        start = 0
        while start < self._U:
            kind = self._handlers[start][0]
            end = start
            while end < self._U and self._handlers[end][0] == kind:
                end += 1
            rows = [
                params_for(kind, self._handlers[e][1]) for e in range(start, end)
            ]
            families.append(
                (
                    kind,
                    np.arange(start, end, dtype=np.uint32),
                    np.asarray(rows, dtype=np.uint32),
                )
            )
            start = end
        return families

    def _family_tables(self, device: torch.device):
        """The families as device tensors, made once per device (before any
        CUDA graph capture reads them): ``(kind, start, end, codes[1, n],
        params[1, n, cols])`` int64."""
        key = str(device)
        if key not in self._device_families:
            self._device_families[key] = [
                (kind, int(codes[0]), int(codes[-1]) + 1,
                 torch.as_tensor(codes.astype(np.int64), device=device)[None],
                 torch.as_tensor(prm.astype(np.int64), device=device)[None])
                for kind, codes, prm in self._families
            ]
        return self._device_families[key]

    def packed_step(self, words: torch.Tensor):
        """Every state's full action fan-out: ``words[F, W] -> (next[F, A,
        W], valid[F, A], ovf[F, A])``, action slot ``a`` = envelope code
        ``a``. Each family's body runs once over its whole parameter table,
        writing its successors in place into its slots of ``next``, which
        start as copies of the pre-state; ``ovf`` is each valid action's
        codec overflow."""
        F, W = words.shape
        nxt = words.new_empty((F, self.max_actions, W))
        valid = torch.empty((F, self.max_actions), dtype=torch.bool, device=words.device)
        ovf = torch.empty_like(valid)
        pre = words[:, None, :]
        for kind, start, end, codes, prm in self._family_tables(words.device):
            w = nxt[:, start:end]
            w.copy_(pre.expand_as(w))
            ok, o = getattr(self, "_body_" + kind)(pre, w, codes, prm)
            valid[:, start:end] = ok
            ovf[:, start:end] = o & ok
        return nxt, valid, ovf

    # --- presence-bit network helpers --------------------------------------
    # The universe's non-duplicating multiset packs as a "net" 1-bit array
    # (every register protocol here keeps counts at 1; a double send cannot
    # be represented and reports overflow).

    def _pack_presence_net(self, fields, state) -> None:
        """Pack ``state.network.counts`` as presence bits; leaving the
        universe or exceeding count 1 fails loudly."""
        net = [0] * self._U
        for env, count in state.network.counts.items():
            code = self._env_code.get(env)
            if code is None:
                raise self._OverflowError32(f"envelope outside universe: {env!r}")
            if count > 1:
                raise self._OverflowError32(
                    f"envelope count {count} > 1 (presence-bit codec): {env!r}"
                )
            net[code] = count
        fields["net"] = net

    def _net_take(self, words, w, e):
        """Consume the delivered envelope ``e`` from ``w`` in place; returns
        whether it was present in the pre-state ``words``."""
        L = self._layout
        L.set_(w, "net", 0, e)
        return L.get(words, "net", e) != 0

    def _net_send(self, w, idx, cond=None):
        """Set the presence bit of code ``idx`` in ``w`` in place (only
        where the bool ``cond`` holds, if given); returns whether it was
        already set."""
        L = self._layout
        was = L.get(w, "net", idx)
        L.set_(w, "net", 1 if cond is None else torch.where(cond, 1, was), idx)
        return was != 0

    def _set_if(self, w, cond, name, value, idx=0) -> None:
        """``Layout.set_`` where ``cond`` holds: the in-place form of the
        reference's ``where(cond, set(w, ...), w)``."""
        L = self._layout
        L.set_(w, name, torch.where(cond, value, L.get(w, name, idx)), idx)

    def device_linearizable_register(self, words, pattern_limit=None):
        """EXACT linearizability of each packed history in ``words[F, W]``,
        entirely on the device (``bool[F]``): the static-enumeration
        serializer (:func:`stateright_tpu_torch.semantics.device.device_serializable`)
        over the Register spec. With ``pattern_limit`` it is the sampled,
        one-sided pass of a host-verified property."""
        from ..semantics.device import DeviceRegister, device_serializable

        if not self._hist.real_time:
            raise ValueError(
                "device_linearizable_register needs a BoundedHistory with "
                "real_time=True: a prereq-free history would silently "
                "degrade the check to sequential consistency"
            )
        return device_serializable(self._hist, words, DeviceRegister(), real_time=True,
                                   pattern_limit=pattern_limit)

    def device_sequentially_consistent_register(self, words, pattern_limit=None):
        """EXACT sequential consistency of each packed history on the
        device: the same enumeration without the real-time constraint (the
        device counterpart of ``SequentialConsistencyTester``); recorded
        prereqs, if any, are ignored."""
        from ..semantics.device import DeviceRegister, device_serializable

        return device_serializable(self._hist, words, DeviceRegister(), real_time=False,
                                   pattern_limit=pattern_limit)

    # --- batched delivery bodies -------------------------------------------
    # Each takes the pre-state words[F, 1, W], this family's successors
    # w[F, n, W] (updated in place), the envelope codes e[1, n] and the
    # parameter table prm[1, n, cols]; returns (valid, overflow), [F, n].
    # The history thread index is a tensor, so history ops unroll over C
    # with masks.

    def _body_putok(self, words, w, e, prm):
        """PutOk -> client ``prm[0]``: record the WriteOk return, invoke the
        Read, send Get ``prm[1]`` (register.rs:170-185)."""
        L = self._layout
        p, get_code = prm[..., 0], prm[..., 1]
        deliv = self._net_take(words, w, e)
        ok = deliv & (L.get(words, "cl_await", p) == 1)
        L.set_(w, "cl_await", 2, p)
        L.set_(w, "cl_ops", 2, p)
        o = torch.zeros_like(ok)
        for t in range(self.C):
            on = ok & (p == t)
            o = o | self._hist.on_return(w, t, 0, enabled=on)  # WriteOk
            self._hist.on_invoke(w, t, 0, enabled=on)  # Read
        dup = self._net_send(w, get_code)
        return ok, ok & (o | dup)

    def _body_getok(self, words, w, e, prm):
        """GetOk -> client ``prm[0]``: record the ReadOk return with ret
        code ``prm[1]``; the script completes (register.rs:186-187)."""
        L = self._layout
        k, ret_code = prm[..., 0], prm[..., 1]
        deliv = self._net_take(words, w, e)
        ok = deliv & (L.get(words, "cl_await", k) == 2)
        L.set_(w, "cl_await", 0, k)
        L.set_(w, "cl_ops", 3, k)
        o = torch.zeros_like(ok)
        for t in range(self.C):
            o = o | self._hist.on_return(w, t, ret_code, enabled=ok & (k == t))
        return ok, ok & o

class RegisterClient:
    """A test client that performs ``put_count`` Puts, then one Get,
    round-robin across the servers (register.rs:94-260).

    Assumes servers occupy indices ``0..server_count`` so a server id is
    derivable as ``(client_index + k) % server_count`` (register.rs:118-120).
    Request ids are ``op_count * client_index``, unique per (client, op)
    because client indices exceed ``server_count >= 1``.
    """

    def __init__(self, put_count: int, server_count: int):
        self.put_count = put_count
        self.server_count = server_count

    def on_start(self, id, out):
        from . import Id

        index = int(id)
        if index < self.server_count:
            raise ValueError(
                "RegisterClient actors must be added to the model after servers."
            )
        if self.put_count == 0:
            return ClientState(awaiting=None, op_count=0)
        unique_request_id = 1 * index  # next will be 2 * index
        value = chr(ord("A") + index - self.server_count)
        out.send(Id(index % self.server_count), Put(unique_request_id, value))
        return ClientState(awaiting=unique_request_id, op_count=1)

    def on_msg(self, id, state, src, msg, out):
        from . import Id

        current = state.get()
        if current.awaiting is None:
            return
        index = int(id)
        if isinstance(msg, PutOk) and msg.request_id == current.awaiting:
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
