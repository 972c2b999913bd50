"""Single-copy register: each server exposes a rewritable register with no
consensus between servers.

Counterpart of ``stateright_tpu/models/single_copy_register.py``
(stateright's ``examples/single-copy-register.rs``): the system is
linearizable iff there is exactly one server (one copy); with two or more
servers clients can observe stale values and the ``linearizable`` property
yields a counterexample.

Exact-count oracles from stateright's own test (single-copy-register.rs:
110,136): 93 unique states at 2 clients / 1 server (full coverage); with 2
servers BFS stops at the linearizability counterexample.

The reference's ``Value::default()`` (``'\\u{0}'``) is rendered as ``None``,
the "unwritten" register value of the ``Register(None)`` spec.

:class:`PackedSingleCopyRegister` (the unordered non-duplicating network)
and :class:`PackedSingleCopyRegisterOrdered` (the ordered network, over
:class:`~stateright_tpu_torch.packing.FifoLanes`) are the GPU forms; their
delivery bodies run batched over the frontier and over each message
family's parameter table (``actor/register.py``'s ``PackedClientsMixin``).
The command line entry point (``check``/``explore``/``spawn``) waits for a
later slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..actor import Actor, ActorModel, Id, Network, Out, StateRef
from ..actor import register as reg
from ..actor.model_state import ActorModelState
from ..actor.network import Envelope, OrderedNetwork, UnorderedNonDuplicatingNetwork
from ..actor.timers import Timers
from ..core import Expectation
from ..packing import (
    BoundedHistory,
    FifoLanes,
    LayoutBuilder,
    OverflowError32,
    PackedModelAdapter,
    bits_for,
)
from ..semantics import LinearizabilityTester
from ..semantics.device import MAX_PATTERNS_EXACT, interleaving_tables, pattern_count
from ..semantics.register import Register
from ..semantics.sequential_consistency import SequentialConsistencyTester


class SingleCopyActor(Actor):
    """A server holding one unreplicated register value
    (single-copy-register.rs:18-46). The actor state *is* the value."""

    def on_start(self, id: Id, out: Out):
        return None  # the unwritten value (Value::default())

    def on_msg(self, id: Id, state: StateRef, src: Id, msg, out: Out) -> None:
        if isinstance(msg, reg.Put):
            state.set(msg.value)
            out.send(src, reg.PutOk(msg.request_id))
        elif isinstance(msg, reg.Get):
            out.send(src, reg.GetOk(msg.request_id, state.get()))


def single_copy_register_model(
    client_count: int = 2,
    server_count: int = 1,
    network: Optional[Network] = None,
    consistency: str = "linearizable",
) -> ActorModel:
    """The checkable model (single-copy-register.rs:55-86). ``consistency``
    selects the tester riding in the history: ``"linearizable"`` (the
    reference's configuration) or ``"sequential"``
    (``SequentialConsistencyTester``)."""
    if network is None:
        network = Network.new_unordered_nonduplicating()
    if consistency == "linearizable":
        tester, prop_name = LinearizabilityTester(Register(None)), "linearizable"
    elif consistency == "sequential":
        tester, prop_name = SequentialConsistencyTester(Register(None)), "sequentially consistent"
    else:
        raise ValueError(f"unknown consistency {consistency!r}")

    model = ActorModel(cfg=None, init_history=tester)
    for _ in range(server_count):
        model.actor(SingleCopyActor())
    for _ in range(client_count):
        model.actor(reg.RegisterClient(put_count=1, server_count=server_count))
    return (
        model.init_network(network)
        .property(Expectation.ALWAYS, prop_name, reg.linearizable_condition())
        .property(Expectation.SOMETIMES, "value chosen", reg.value_chosen_condition)
        .record_msg_in(reg.record_returns)
        .record_msg_out(reg.record_invocations)
    )


class PackedSingleCopyRegister(reg.PackedClientsMixin, PackedModelAdapter):
    """The single-copy register on the GPU engine (``spawn_xla``).

    - per-server register values and per-client script positions are
      layout fields;
    - the non-duplicating multiset network packs as 2-bit per-envelope
      counts over the *closed* envelope universe (each client performs one
      Put then one Get with statically known request ids and targets,
      register.rs:94-260): per client k, a block of ``3 + V`` codes (Put,
      PutOk, Get, GetOk(value) per value);
    - the tester's history packs exactly as a
      :class:`~stateright_tpu_torch.packing.BoundedHistory` (2 ops a client).

    The consistency property (``linearizable``, or ``sequentially
    consistent`` under ``consistency="sequential"``) is checked on the
    device exactly while the interleaving count fits ``MAX_PATTERNS_EXACT``
    (up to 4 clients). Past it, or with ``device_exact=False``, the model
    declares ``host_verified_properties``: the device runs the sampled
    one-sided pass over ``pattern_limit`` patterns and the engine confirms
    the flagged rows on the host.
    """

    #: Per-client op bound (one Put then one Get): sizes the packed history
    #: and the exact-vs-sampled gate.
    MAX_OPS = 2

    def __init__(
        self,
        client_count: int = 2,
        server_count: int = 1,
        consistency: str = "linearizable",
        device_exact: Optional[bool] = None,
        pattern_limit: int = 20_000,
    ):
        self._inner = single_copy_register_model(client_count, server_count, consistency=consistency)
        self._consistency = consistency
        self._prop_name = self._inner.properties()[0].name
        P = pattern_count(client_count, self.MAX_OPS)
        if device_exact is None:
            device_exact = P <= MAX_PATTERNS_EXACT
        elif device_exact and P > MAX_PATTERNS_EXACT:
            raise ValueError(
                f"{P} interleavings exceed the exact device budget "
                "(semantics.device.MAX_PATTERNS_EXACT)"
            )
        self._pattern_limit = None
        if not device_exact:
            self.host_verified_properties = frozenset({self._prop_name})
            self._pattern_limit = pattern_limit
        S, C = server_count, client_count
        self.S, self.C = S, C
        self._OverflowError32 = OverflowError32
        self.values = self._client_values()
        V = len(self.values)
        self.V = V

        B = 3 + V
        envs, handlers = [], []
        for k in range(C):
            i = S + k
            envs.append(Envelope(Id(i), Id(i % S), reg.Put(i, self.values[1 + k])))
            handlers.append(("put", [i % S, 1 + k, k * B + 1]))
            envs.append(Envelope(Id(i % S), Id(i), reg.PutOk(i)))
            handlers.append(("putok", [k, k * B + 2]))
            envs.append(Envelope(Id(i), Id((i + 1) % S), reg.Get(2 * i)))
            handlers.append(("get", [(i + 1) % S, k * B + 3]))
            for vi, v in enumerate(self.values):
                envs.append(Envelope(Id((i + 1) % S), Id(i), reg.GetOk(2 * i, v)))
                handlers.append(("getok", [k, 1 + vi]))
        self._B = B
        self._envs = envs
        self._env_code = {env: c for c, env in enumerate(envs)}
        self._U = len(envs)
        self._handlers = handlers

        op_ret_bits = max(V.bit_length(), 2)
        b = LayoutBuilder().array("srv", S, bits_for(V - 1))
        self._client_layout(b)
        b.array("net", self._U, 2)
        self._hist = BoundedHistory(
            b,
            thread_ids=[Id(S + k) for k in range(C)],
            max_ops=self.MAX_OPS,
            op_bits=op_ret_bits,
            ret_bits=op_ret_bits,
            real_time=consistency == "linearizable",
        )
        self._layout = b.finish()
        self._hist.bind(self._layout)
        self.state_words = self._layout.words
        self.max_actions = self._U
        codecs = reg.history_codecs(self.values)
        self._op_code, self._code_op, self._ret_code, self._code_ret = codecs
        self._families = self._group_families(lambda kind, params: params)
        self._device_families: dict = {}
        # The serializer's pattern tables, built once on the host.
        interleaving_tables(C, self.MAX_OPS + 1, self._pattern_limit)

    # --- codec -------------------------------------------------------------

    def pack(self, state) -> np.ndarray:
        fields = dict(srv=[self._val_code(state.actor_states[s]) for s in range(self.S)])
        self._pack_clients(fields, state)
        net = [0] * self._U
        for env, count in state.network.counts.items():
            code = self._env_code.get(env)
            if code is None:
                raise OverflowError32(f"envelope outside universe: {env!r}")
            if count > 3:
                raise OverflowError32(f"envelope count {count} > 3: {env!r}")
            net[code] = count
        fields["net"] = net
        fields.update(self._hist.from_tester(state.history, self._op_code, self._ret_code))
        return self._layout.pack(**fields)

    def unpack(self, words) -> ActorModelState:
        f = self._layout.unpack(words)
        actor_states = [self.values[code] for code in f["srv"]]
        self._unpack_clients(f, actor_states)
        counts = {self._envs[code]: n for code, n in enumerate(f["net"]) if n}
        make_tester = (
            (lambda: LinearizabilityTester(Register(None)))
            if self._consistency == "linearizable"
            else (lambda: SequentialConsistencyTester(Register(None)))
        )
        return ActorModelState(
            actor_states=tuple(actor_states),
            network=UnorderedNonDuplicatingNetwork(counts),
            timers_set=tuple(Timers() for _ in range(self.S + self.C)),
            history=self._hist.to_tester(f, make_tester, self._code_op, self._code_ret),
        )

    # --- batched delivery bodies -------------------------------------------
    # The network holds 2-bit counts: a delivery takes one instance, a send
    # adds one and overflows past 3 (the mixin's bodies read and write it
    # through these two helpers).

    def _net_take(self, words, w, e):
        L = self._layout
        cnt = L.get(words, "net", e)
        L.set_(w, "net", cnt - 1, e)
        return cnt != 0

    def _net_send(self, w, idx, cond=None):
        L = self._layout
        cnt = L.get(w, "net", idx)
        L.set_(w, "net", cnt + 1 if cond is None else torch.where(cond, cnt + 1, cnt), idx)
        return cnt == 3

    def _body_put(self, words, w, e, prm):
        """Put -> server ``prm[0]``: store the value code ``prm[1]``, reply
        PutOk ``prm[2]``."""
        srv, val, putok = prm[..., 0], prm[..., 1], prm[..., 2]
        ok = self._net_take(words, w, e)
        self._layout.set_(w, "srv", val, srv)
        return ok, ok & self._net_send(w, putok)

    def _body_get(self, words, w, e, prm):
        """Get -> server ``prm[0]``: reply GetOk with its current value (the
        GetOk codes of the client start at ``prm[1]``)."""
        srv, getok_base = prm[..., 0], prm[..., 1]
        ok = self._net_take(words, w, e)
        return ok, ok & self._net_send(w, getok_base + self._layout.get(words, "srv", srv))

    def packed_properties(self, words: torch.Tensor) -> torch.Tensor:
        """``[F, 2]``: the consistency property (exact, or the sampled
        one-sided pass of a host-verified property) and "value chosen" (a
        GetOk of a written value in flight)."""
        L = self._layout
        if self._consistency == "linearizable":
            lin = self.device_linearizable_register(words, self._pattern_limit)
        else:
            lin = self.device_sequentially_consistent_register(words, self._pattern_limit)
        chosen = torch.zeros(words.shape[0], dtype=torch.bool, device=words.device)
        for k in range(self.C):
            for vi in range(1, self.V):  # real (written) values only
                chosen = chosen | (L.get(words, "net", k * self._B + 3 + vi) > 0)
        return torch.stack([lin, chosen], 1)


class PackedSingleCopyRegisterOrdered(reg.PackedClientsMixin, PackedModelAdapter):
    """The single-copy register over the **ordered** network on the GPU
    engine: per-directed-pair FIFO channels where only flow heads are
    deliverable (network.rs:57-67, 221-293), packed as
    :class:`~stateright_tpu_torch.packing.FifoLanes`.

    One lane per directed flow: ``k`` = client k -> the server (codes 0 =
    Put, 1 = Get), ``C + k`` = server -> client k (codes 0 = PutOk, 1 + v =
    GetOk(values[v])). An action slot is a lane: delivering pops the head; a
    head whose delivery is a no-op (a reply the client is not awaiting)
    blocks its lane, like the object model's head-of-channel-only rule.
    Stateright has no count oracle for this configuration, so its parity is
    with the object ``OrderedNetwork`` model and the reference package.
    """

    def __init__(self, client_count: int = 2):
        if client_count != 2:
            raise ValueError(
                "the packed model's exact device linearizability covers the "
                "2-client shape; other sizes run on the host engines"
            )
        C, S = client_count, 1
        self.C, self.S = C, S
        self._inner = single_copy_register_model(C, S, Network.new_ordered())
        self._OverflowError32 = OverflowError32
        self.values = self._client_values()
        NV = len(self.values)
        self.max_actions = 2 * C  # one action slot per lane

        b = LayoutBuilder()
        b.array("srv", S, bits_for(NV - 1))
        self._client_layout(b)
        # Depth 2 is headroom: the Put/Get script keeps at most one message
        # in flight per direction (an overflow reports loudly regardless).
        code_bits = bits_for(NV)
        self._lanes = FifoLanes(b, "flows", lanes=2 * C, depth=2, code_bits=code_bits)
        self._hist = BoundedHistory(
            b,
            thread_ids=[Id(S + k) for k in range(C)],
            max_ops=2,
            op_bits=code_bits,
            ret_bits=code_bits,
        )
        self._layout = b.finish()
        self._hist.bind(self._layout)
        self._lanes.bind(self._layout)
        self.state_words = self._layout.words
        codecs = reg.history_codecs(self.values)
        self._op_code, self._code_op, self._ret_code, self._code_ret = codecs
        # Action slot = lane; each family's parameters: the client and the
        # lane its reply (or its next request) goes to.
        self._U = 2 * C
        self._handlers = [("to_server", [k, C + k]) for k in range(C)] + [
            ("to_client", [k, k]) for k in range(C)
        ]
        self._families = self._group_families(lambda kind, params: params)
        self._device_families: dict = {}
        interleaving_tables(C, 3)

    # --- lane codec ---------------------------------------------------------

    def _lane_key(self, lane: int):
        C, S = self.C, self.S
        if lane < C:
            return (Id(S + lane), Id(0))
        return (Id(0), Id(S + (lane - C)))

    def _msg_code(self, lane: int, msg) -> int:
        k = lane if lane < self.C else lane - self.C
        i = self.S + k
        if lane < self.C:  # client -> server
            if isinstance(msg, reg.Put) and msg == reg.Put(i, self.values[1 + k]):
                return 0
            if isinstance(msg, reg.Get) and msg == reg.Get(2 * i):
                return 1
        else:  # server -> client
            if isinstance(msg, reg.PutOk) and msg == reg.PutOk(i):
                return 0
            if isinstance(msg, reg.GetOk) and msg.request_id == 2 * i:
                return 1 + self._val_code(msg.value)
        raise OverflowError32(f"message outside universe on lane {lane}: {msg!r}")

    def _code_msg(self, lane: int, code: int):
        k = lane if lane < self.C else lane - self.C
        i = self.S + k
        if lane < self.C:
            return reg.Put(i, self.values[1 + k]) if code == 0 else reg.Get(2 * i)
        if code == 0:
            return reg.PutOk(i)
        return reg.GetOk(2 * i, self.values[code - 1])

    # --- codec -------------------------------------------------------------

    def pack(self, state) -> np.ndarray:
        C, depth = self.C, self._lanes.depth
        fields: dict = {"srv": [self._val_code(state.actor_states[0])]}
        self._pack_clients(fields, state)
        cells = [0] * (2 * C * depth)
        lens = [0] * (2 * C)
        flows = dict(state.network.flows)
        for lane in range(2 * C):
            msgs = flows.pop(self._lane_key(lane), ())
            lane_cells, n = self._lanes.host_pack_lane([self._msg_code(lane, m) for m in msgs])
            cells[lane * depth:(lane + 1) * depth] = lane_cells
            lens[lane] = n
        if flows:
            raise OverflowError32(f"flows outside universe: {list(flows)!r}")
        fields["flows_cells"] = cells
        fields["flows_lens"] = lens
        fields.update(self._hist.from_tester(state.history, self._op_code, self._ret_code))
        return self._layout.pack(**fields)

    def unpack(self, words) -> ActorModelState:
        f = self._layout.unpack(words)
        C, depth = self.C, self._lanes.depth
        actor_states = [self.values[f["srv"][0]]]
        self._unpack_clients(f, actor_states)
        flows = {}
        for lane in range(2 * C):
            n = f["flows_lens"][lane]
            if n:
                cells = f["flows_cells"][lane * depth:lane * depth + n]
                flows[self._lane_key(lane)] = tuple(self._code_msg(lane, c - 1) for c in cells)
        history = self._hist.to_tester(
            f, lambda: LinearizabilityTester(Register(None)), self._code_op, self._code_ret
        )
        return ActorModelState(
            actor_states=tuple(actor_states),
            network=OrderedNetwork(flows),
            timers_set=tuple(Timers() for _ in range(self.S + C)),
            history=history,
        )

    # --- batched delivery bodies -------------------------------------------

    def _body_to_server(self, words, w, lane, prm):
        """Head of client ``prm[0]``'s lane -> the server: Put stores the
        value and acks, Get replies with the current value, both on lane
        ``prm[1]`` (single-copy-register.rs:18-46). Valid whenever the lane
        is nonempty: the server never no-ops."""
        L = self._layout
        k, reply_lane = prm[..., 0], prm[..., 1]
        code, nonempty = self._lanes.head(words, lane)
        self._lanes.pop(w, lane, enabled=nonempty)
        is_put = code == 0
        srv_val = L.get(words, "srv", 0)
        L.set_(w, "srv", torch.where(is_put & nonempty, k + 1, srv_val), 0)
        ovf = self._lanes.push(w, reply_lane, torch.where(is_put, 0, 1 + srv_val), enabled=nonempty)
        return nonempty, nonempty & ovf

    def _body_to_client(self, words, w, lane, prm):
        """Head of the server's lane to client ``prm[0]``: PutOk advances
        the script (record WriteOk, invoke Read, send Get on lane
        ``prm[1]``); GetOk completes it. A reply the client is not awaiting
        is a no-op and blocks the lane."""
        L, hist = self._layout, self._hist
        k, req_lane = prm[..., 0], prm[..., 1]
        code, nonempty = self._lanes.head(words, lane)
        is_putok = code == 0
        await_k = L.get(words, "cl_await", k)
        eligible = nonempty & torch.where(is_putok, await_k == 1, await_k == 2)
        self._lanes.pop(w, lane, enabled=eligible)
        L.set_(w, "cl_await",
               torch.where(eligible, torch.where(is_putok, 2, 0), await_k), k)
        L.set_(w, "cl_ops",
               torch.where(eligible, torch.where(is_putok, 2, 3), L.get(words, "cl_ops", k)), k)
        o = torch.zeros_like(eligible)
        for t in range(self.C):
            on_p = eligible & is_putok & (k == t)
            o = o | hist.on_return(w, t, 0, enabled=on_p)  # WriteOk
            hist.on_invoke(w, t, 0, enabled=on_p)  # Read
            # GetOk(values[v]) lane code 1 + v is the ReadOk ret code.
            o = o | hist.on_return(w, t, code, enabled=eligible & ~is_putok & (k == t))
        povf = self._lanes.push(w, req_lane, 1, enabled=eligible & is_putok)
        return eligible, eligible & (o | povf)

    def packed_properties(self, words: torch.Tensor) -> torch.Tensor:
        """``[F, 2]``: linearizable, and "value chosen" read from the lane
        heads only: under ordered semantics only heads are deliverable
        (value_chosen_condition over iter_deliverable, network.rs:275-277)."""
        lin = self.device_linearizable_register(words)
        chosen = torch.zeros(words.shape[0], dtype=torch.bool, device=words.device)
        for k in range(self.C):
            code, nonempty = self._lanes.head(words, self.C + k)
            chosen = chosen | (nonempty & (code >= 2))
        return torch.stack([lin, chosen], 1)
