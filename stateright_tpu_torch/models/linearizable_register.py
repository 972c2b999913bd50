"""ABD linearizable register: quorum-replicated shared memory.

Counterpart of ``stateright_tpu/models/linearizable_register.py``
(stateright's ``examples/linearizable-register.rs``): the Attiya, Bar-Noy,
Dolev algorithm ("Sharing Memory Robustly in Message-Passing Systems",
doi:10.1145/200836.200869). Every operation runs two phases:

1. **Query**: poll a quorum for (logical-clock sequencer, value) pairs;
2. **Record**: write back the maximal pair (for a write: the incremented
   sequencer and the new value) and wait for a quorum of acks.

Because both reads and writes perform the write-back phase, the register is
linearizable with any majority quorum.

Exact-count oracle from stateright's own test
(linearizable-register.rs:289,316): 544 unique states at 2 clients /
2 servers on an unordered non-duplicating network, both BFS and DFS.

:class:`PackedAbd` (the unordered non-duplicating network, presence bits
over a closed envelope universe) and :class:`PackedAbdOrdered` (the
ordered network, over :class:`~stateright_tpu_torch.packing.FifoLanes`) are
the GPU forms, at 2 servers with 2 or 3 clients; their delivery bodies run
batched over the frontier and write in place into each action's slice of
one ``[F, A, W]`` grid. ``main`` has ``check``/``check-xla`` (the GPU
engine), ``check-host`` (the host DFS); ``explore`` serves the Explorer
and ``spawn`` starts the UDP runtime.
"""

from __future__ import annotations

from typing import Any, FrozenSet, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..actor import (
    Actor,
    ActorModel,
    Id,
    Network,
    Out,
    StateRef,
    majority,
    model_peers,
)
from ..actor import register as reg
from ..actor.model_state import ActorModelState
from ..actor.network import Envelope, OrderedNetwork, UnorderedNonDuplicatingNetwork
from ..actor.timers import Timers
from ..core import Expectation
from ..ops.words import MASK32
from ..packing import (
    BoundedHistory,
    FifoLanes,
    LayoutBuilder,
    OverflowError32,
    PackedModelAdapter,
    bits_for,
)
from ..semantics import LinearizabilityTester
from ..semantics.device import interleaving_tables
from ..semantics.register import Register
from ..utils.variant import variant

Seq = Tuple[int, Id]  # (logical clock, writer id) — totally ordered

# Internal ABD protocol messages (linearizable-register.rs:28-33).
Query = variant("Query", ["request_id"])
AckQuery = variant("AckQuery", ["request_id", "seq", "value"])
Record = variant("Record", ["request_id", "seq", "value"])
AckRecord = variant("AckRecord", ["request_id"])

# The two client-request phases (linearizable-register.rs:44-57).
# ``responses`` is a map Id -> (Seq, Value) stored as a frozenset of pairs;
# ``acks`` is a frozenset of replica ids.  ``write`` (phase 1) and ``read``
# (phase 2) are ``None`` for the other operation kind and a 1-tuple
# ``(value,)`` otherwise — the tuple keeps a value of ``None`` (a read of
# the unwritten default, or a Put of None) distinct from "not this kind of
# operation" (Rust's Option<Value> makes the same distinction, rs:48,54).
Phase1 = variant("Phase1", ["request_id", "requester_id", "write", "responses"])
Phase2 = variant("Phase2", ["request_id", "requester_id", "read", "acks"])


class AbdState(NamedTuple):
    """Replica state (linearizable-register.rs:37-41)."""

    seq: Seq
    val: Any
    phase: Optional[Any]


def _map_insert(m: FrozenSet, k: Any, v: Any) -> FrozenSet:
    d = dict(m)
    d[k] = v
    return frozenset(d.items())


class AbdActor(Actor):
    """One ABD replica; also coordinates client requests
    (linearizable-register.rs:64-214)."""

    def __init__(self, peers):
        self.peers = list(peers)

    def on_start(self, id: Id, out: Out) -> AbdState:
        return AbdState(seq=(0, id), val=None, phase=None)

    def on_msg(self, id: Id, state: StateRef, src: Id, msg: Any, out: Out) -> None:
        s: AbdState = state.get()

        if isinstance(msg, (reg.Put, reg.Get)) and s.phase is None:
            # Begin phase 1: poll a quorum, seeding with our own pair
            # (linearizable-register.rs:86-111). ``write`` is a 1-tuple so a
            # Put of ``None`` stays distinct from a Get (same trick as
            # ``read`` below).
            write = (msg.value,) if isinstance(msg, reg.Put) else None
            out.broadcast(self.peers, reg.Internal(Query(msg.request_id)))
            state.set(
                s._replace(
                    phase=Phase1(
                        request_id=msg.request_id,
                        requester_id=src,
                        write=write,
                        responses=_map_insert(frozenset(), id, (s.seq, s.val)),
                    )
                )
            )
            return

        if not isinstance(msg, reg.Internal):
            return
        m = msg.msg

        if isinstance(m, Query):
            out.send(src, reg.Internal(AckQuery(m.request_id, s.seq, s.val)))

        elif (
            isinstance(m, AckQuery)
            and isinstance(s.phase, Phase1)
            and s.phase.request_id == m.request_id
        ):
            # Collect quorum responses; on quorum, pick the maximal
            # (seq, value), bump the clock for writes, and move to phase 2
            # with Record/AckRecord self-sends applied inline
            # (linearizable-register.rs:118-176).
            p = s.phase
            responses = _map_insert(p.responses, src, (m.seq, m.value))
            if len(responses) < majority(len(self.peers) + 1):
                state.set(s._replace(phase=p._replace(responses=responses)))
                return
            # Sequencers are distinct ((clock, id) pairs), so max is
            # deterministic (comment at linearizable-register.rs:139-142).
            seq, val = max((v for _k, v in responses), key=lambda sv: sv[0])
            read = None
            if p.write is not None:
                seq = (seq[0] + 1, id)
                val = p.write[0]
            else:
                read = (val,)
            out.broadcast(self.peers, reg.Internal(Record(p.request_id, seq, val)))
            s2 = s
            if seq > s.seq:  # self-send Record
                s2 = s2._replace(seq=seq, val=val)
            state.set(
                s2._replace(
                    phase=Phase2(
                        request_id=p.request_id,
                        requester_id=p.requester_id,
                        read=read,
                        acks=frozenset((id,)),  # self-send AckRecord
                    )
                )
            )

        elif isinstance(m, Record):
            # Adopt newer pairs; always ack (linearizable-register.rs:177-184).
            out.send(src, reg.Internal(AckRecord(m.request_id)))
            if m.seq > s.seq:
                state.set(s._replace(seq=m.seq, val=m.value))

        elif (
            isinstance(m, AckRecord)
            and isinstance(s.phase, Phase2)
            and s.phase.request_id == m.request_id
            and src not in s.phase.acks
        ):
            # On an ack quorum, answer the client and clear the phase
            # (linearizable-register.rs:185-210).
            p = s.phase
            acks = p.acks | {src}
            if len(acks) == majority(len(self.peers) + 1):
                if p.read is not None:
                    out.send(p.requester_id, reg.GetOk(p.request_id, p.read[0]))
                else:
                    out.send(p.requester_id, reg.PutOk(p.request_id))
                state.set(s._replace(phase=None))
            else:
                state.set(s._replace(phase=p._replace(acks=acks)))


def linearizable_register_model(
    client_count: int = 2,
    server_count: int = 2,
    network: Optional[Network] = None,
) -> ActorModel:
    """Build the checkable model (linearizable-register.rs:223-257)."""
    if network is None:
        network = Network.new_unordered_nonduplicating()

    model = ActorModel(cfg=None, init_history=LinearizabilityTester(Register(None)))
    for i in range(server_count):
        model.actor(AbdActor(model_peers(i, server_count)))
    for _ in range(client_count):
        model.actor(reg.RegisterClient(put_count=1, server_count=server_count))
    return (
        model.init_network(network)
        .property(Expectation.ALWAYS, "linearizable", reg.linearizable_condition())
        .property(Expectation.SOMETIMES, "value chosen", reg.value_chosen_condition)
        .record_msg_in(reg.record_returns)
        .record_msg_out(reg.record_invocations)
    )




class PackedAbd(reg.PackedClientsMixin, PackedModelAdapter):
    """The ABD quorum register on the GPU engine (``spawn_xla``): the oracle
    configuration (2 clients / 2 servers, 544 unique states,
    linearizable-register.rs:289,316) and the 3-client / 2-server
    configuration, whose ``linearizable`` property runs exactly on the
    device over the 3-thread interleaving enumeration (1,680 patterns).

    The construction of :class:`~stateright_tpu_torch.models.paxos.PackedPaxos`:
    a closed envelope universe as presence bits (every count stays at 1),
    one batched delivery body per message family over its parameter table,
    and the ``LinearizabilityTester`` history carried as a
    :class:`~stateright_tpu_torch.packing.BoundedHistory`.

    Codec bounds (the reference's, checked by full enumeration of the
    object model): logical clocks are bounded by the Put count, so
    sequencers form the closed set ``(clock 0..C, writer)``; Phase1
    response values and AckQuery/Record payloads pack as
    ``seq_code * NV + val_code``. Two servers keep the quorum arithmetic
    static (majority = 2: the coordinator's own entry plus its one peer);
    wider clusters run on the host engines.

    Requests are keyed ``(coordinator s, local index r)``: server ``s``
    coordinates client k's Put when ``(S+k) % S == s`` and client k's Get
    when ``(S+k+1) % S == s`` (the RegisterClient round-robin,
    register.rs:118-120); ``self._reqs[s]`` lists ``(client, kind)`` with
    kind 0 = Put, 1 = Get.
    """

    def __init__(self, client_count: int = 2, server_count: int = 2):
        if server_count != 2 or client_count not in (2, 3):
            raise ValueError(
                "PackedAbd packs S=2 (single-peer quorum arithmetic) with "
                "2 or 3 clients; other sizes run on the host engines"
            )
        C, S = client_count, server_count
        self._init_core(C, S)
        self._inner = linearizable_register_model(C, S)
        NV, NSQ = self.NV, self.NSQ
        reqs, rix = self._reqs, self._rix
        req_id = self._req_id

        # --- the closed envelope universe -------------------------------
        envs: list = []
        handlers: list = []
        self._code_put: list = []
        self._code_putok: list = []
        self._code_get: list = []
        self._base_getok: list = []
        self._code_query: dict = {}
        self._base_ackquery: dict = {}
        self._base_record: dict = {}
        self._code_ackrecord: dict = {}

        for k in range(C):
            i = S + k
            self._code_put.append(len(envs))
            envs.append(Envelope(Id(i), Id(i % S), reg.Put(i, self.values[1 + k])))
            handlers.append(("begin", rix[(k, 0)]))
        for k in range(C):
            self._code_putok.append(len(envs))
            envs.append(Envelope(Id(k % S), Id(S + k), reg.PutOk(S + k)))
            handlers.append(("putok", (k,)))
        for k in range(C):
            i = S + k
            self._code_get.append(len(envs))
            envs.append(Envelope(Id(i), Id((i + 1) % S), reg.Get(2 * i)))
            handlers.append(("begin", rix[(k, 1)]))
        for k in range(C):
            i = S + k
            self._base_getok.append(len(envs))
            for v in range(NV):
                envs.append(Envelope(Id((i + 1) % S), Id(i), reg.GetOk(2 * i, self.values[v])))
                handlers.append(("getok", (k, v)))
        for c in range(S):  # Query: coordinator c -> its peer
            p = (c + 1) % S
            for r in range(len(reqs[c])):
                self._code_query[(c, r)] = len(envs)
                envs.append(Envelope(Id(c), Id(p), reg.Internal(Query(req_id(c, r)))))
                handlers.append(("query", (p, c, r)))
        for c in range(S):  # AckQuery: peer -> coordinator, contiguous in (seq, val)
            p = (c + 1) % S
            for r in range(len(reqs[c])):
                self._base_ackquery[(c, r)] = len(envs)
                for sq in range(NSQ):
                    for v in range(NV):
                        envs.append(Envelope(Id(p), Id(c), reg.Internal(
                            AckQuery(req_id(c, r), self._seqs[sq], self.values[v]))))
                        handlers.append(("ackquery", (c, r, p, sq * NV + v)))
        for c in range(S):  # Record: coordinator -> peer, contiguous in (seq, val)
            p = (c + 1) % S
            for r in range(len(reqs[c])):
                self._base_record[(c, r)] = len(envs)
                for sq in range(NSQ):
                    for v in range(NV):
                        envs.append(Envelope(Id(c), Id(p), reg.Internal(
                            Record(req_id(c, r), self._seqs[sq], self.values[v]))))
                        handlers.append(("record", (p, c, r, sq * NV + v)))
        for c in range(S):  # AckRecord: peer -> coordinator
            p = (c + 1) % S
            for r in range(len(reqs[c])):
                self._code_ackrecord[(c, r)] = len(envs)
                envs.append(Envelope(Id(p), Id(c), reg.Internal(AckRecord(req_id(c, r)))))
                handlers.append(("ackrecord", (c, r, p)))

        self._envs = envs
        self._handlers = handlers
        self._env_code = {env: code for code, env in enumerate(envs)}
        self._U = len(envs)
        self.max_actions = self._U

        # --- layout ------------------------------------------------------
        b = LayoutBuilder()
        self._server_layout(b)
        self._client_layout(b)
        b.array("net", self._U, 1)
        code_bits = bits_for(NV)
        self._hist = BoundedHistory(
            b, thread_ids=[Id(S + k) for k in range(C)], max_ops=2,
            op_bits=code_bits, ret_bits=code_bits,
        )
        self._layout = b.finish()
        self._hist.bind(self._layout)
        self.state_words = self._layout.words
        codecs = reg.history_codecs(self.values)
        self._op_code, self._code_op, self._ret_code, self._code_ret = codecs
        self._families = self._build_families()
        self._device_families: dict = {}
        # The serializer's pattern tables, built once on the host.
        interleaving_tables(C, self._hist.max_ops + 1)

    # --- code helpers -------------------------------------------------------

    def _seq_code(self, seq) -> int:
        try:
            return self._seqs.index(seq)
        except ValueError:
            raise OverflowError32(f"sequencer outside universe: {seq!r}") from None

    def _sv_code(self, seq, val) -> int:
        return self._seq_code(seq) * self.NV + self._val_code(val)

    def _init_core(self, C: int, S: int) -> None:
        """Protocol structure shared by the unordered and ordered packed
        forms: the value and sequencer universes and the per-server request
        table (class docstring)."""
        self.C, self.S = C, S
        self.majority = S // 2 + 1
        self._OverflowError32 = OverflowError32
        #: values[0] is the unwritten None; client k writes values[1+k].
        self.values = self._client_values()
        self.NV = len(self.values)
        #: seq codes, monotone in the model's (clock, Id) order:
        #: code = clock * S + writer, clock 0..C.
        self._seqs = [(c, Id(w)) for c in range(C + 1) for w in range(S)]
        self.NSQ = len(self._seqs)
        # Per-server request table: Puts first, then Gets.
        reqs = {s: [] for s in range(S)}
        for k in range(C):
            reqs[(S + k) % S].append((k, 0))
        for k in range(C):
            reqs[(S + k + 1) % S].append((k, 1))
        self._reqs = reqs
        self._maxR = max(len(v) for v in reqs.values())

        def req_id(s: int, r: int) -> int:
            k, kind = reqs[s][r]
            return (S + k) if kind == 0 else 2 * (S + k)

        def requester(s: int, r: int) -> int:
            return S + reqs[s][r][0]

        self._req_id, self._requester = req_id, requester
        # (client, kind) -> (coordinator, local request index)
        self._rix = {(k, kind): (s, r) for s in range(S) for r, (k, kind) in enumerate(reqs[s])}

    def _server_layout(self, b) -> None:
        """Per-server replica and phase fields (shared by both network
        packings)."""
        S, NV, NSQ = self.S, self.NV, self.NSQ
        b.array("seq", S, bits_for(NSQ - 1))
        b.array("val", S, bits_for(NV - 1))
        b.array("kind", S, 2)  # 0 = no phase, 1 = Phase1, 2 = Phase2
        # Local request index of the active phase (see self._reqs).
        b.array("p_req", S, max(bits_for(self._maxR - 1), 1))
        # Phase2: 0 = write op, 1+v = read of values[v].
        b.array("read", S, bits_for(NV))
        b.array("rp", S * S, 1)  # Phase1 responses presence, idx s*S + key
        b.array("rv", S * S, bits_for(NSQ * NV - 1))  # Phase1 (seq,val) codes
        b.array("ak", S * S, 1)  # Phase2 acks, idx s*S + voter

    def _phase_req(self, s: int, phase) -> int:
        """The local request index of server ``s``'s active phase: its
        request id and requester must be ones this server coordinates."""
        for r in range(len(self._reqs[s])):
            if phase.request_id == self._req_id(s, r) and int(phase.requester_id) == self._requester(s, r):
                return r
        raise OverflowError32(f"phase request outside universe: {phase!r}")

    def _build_families(self):
        def params_for(kind: str, params) -> list:
            if kind == "begin":
                c, r = params
                return [c, r, self._code_query[(c, r)]]
            if kind == "putok":
                (k,) = params
                return [k, self._code_get[k]]
            if kind == "getok":
                k, v = params
                return [k, 1 + v]  # ReadOk(values[v]) ret code
            if kind == "query":
                p, c, r = params
                return [p, self._base_ackquery[(c, r)]]
            if kind == "ackquery":
                c, r, p, sv = params
                k, req_kind = self._reqs[c][r]
                is_write = 1 if req_kind == 0 else 0
                wval = 1 + k if req_kind == 0 else 0
                return [c, r, p, sv, self._base_record[(c, r)], wval, is_write]
            if kind == "record":
                p, c, r, sv = params
                return [p, sv, self._code_ackrecord[(c, r)]]
            # "ackrecord"
            c, r, p = params
            k, req_kind = self._reqs[c][r]
            putok = self._code_putok[k] if req_kind == 0 else 0
            getok_base = self._base_getok[k] if req_kind == 1 else 0
            return [c, r, p, putok, getok_base, 1 if req_kind == 1 else 0]

        return self._group_families(params_for)

    # --- codec -------------------------------------------------------------

    def _pack_server_fields(self, state) -> dict:
        """Replica, phase and client fields (shared by both network forms)."""
        S = self.S
        fields: dict = {name: [0] * S for name in ("seq", "val", "kind", "p_req", "read")}
        fields.update({name: [0] * (S * S) for name in ("rp", "rv", "ak")})
        for s in range(S):
            a: AbdState = state.actor_states[s]
            fields["seq"][s] = self._seq_code(a.seq)
            fields["val"][s] = self._val_code(a.val)
            if isinstance(a.phase, Phase1):
                r = self._phase_req(s, a.phase)
                k, req_kind = self._reqs[s][r]
                expected_write = (self.values[1 + k],) if req_kind == 0 else None
                if a.phase.write != expected_write:
                    raise OverflowError32(f"phase write outside universe: {a.phase!r}")
                fields["kind"][s] = 1
                fields["p_req"][s] = r
                for key, (sq, v) in a.phase.responses:
                    j = int(key)
                    if not 0 <= j < S:
                        raise OverflowError32(f"response key {key!r}")
                    fields["rp"][s * S + j] = 1
                    fields["rv"][s * S + j] = self._sv_code(sq, v)
            elif isinstance(a.phase, Phase2):
                fields["kind"][s] = 2
                fields["p_req"][s] = self._phase_req(s, a.phase)
                if a.phase.read is not None:
                    fields["read"][s] = 1 + self._val_code(a.phase.read[0])
                for j in a.phase.acks:
                    fields["ak"][s * S + int(j)] = 1
            elif a.phase is not None:  # pragma: no cover
                raise OverflowError32(f"unknown phase {a.phase!r}")
        self._pack_clients(fields, state)
        return fields

    def pack(self, state) -> np.ndarray:
        fields = self._pack_server_fields(state)
        self._pack_presence_net(fields, state)
        fields.update(self._hist.from_tester(state.history, self._op_code, self._ret_code))
        return self._layout.pack(**fields)

    def _unpack_server_states(self, f) -> list:
        """Inverse of :meth:`_pack_server_fields` (servers and clients)."""
        S, NV = self.S, self.NV
        actor_states = []
        for s in range(S):
            kind, r = f["kind"][s], f["p_req"][s]
            phase = None
            if kind == 1:
                k, req_kind = self._reqs[s][r]
                responses = frozenset(
                    (Id(j), (self._seqs[f["rv"][s * S + j] // NV], self.values[f["rv"][s * S + j] % NV]))
                    for j in range(S)
                    if f["rp"][s * S + j]
                )
                phase = Phase1(
                    request_id=self._req_id(s, r),
                    requester_id=Id(self._requester(s, r)),
                    write=(self.values[1 + k],) if req_kind == 0 else None,
                    responses=responses,
                )
            elif kind == 2:
                read = (self.values[f["read"][s] - 1],) if f["read"][s] else None
                phase = Phase2(
                    request_id=self._req_id(s, r),
                    requester_id=Id(self._requester(s, r)),
                    read=read,
                    acks=frozenset(Id(j) for j in range(S) if f["ak"][s * S + j]),
                )
            actor_states.append(AbdState(seq=self._seqs[f["seq"][s]], val=self.values[f["val"][s]],
                                         phase=phase))
        self._unpack_clients(f, actor_states)
        return actor_states

    def unpack(self, words) -> ActorModelState:
        f = self._layout.unpack(words)
        actor_states = self._unpack_server_states(f)
        counts = {self._envs[code]: count for code, count in enumerate(f["net"]) if count}
        history = self._hist.to_tester(
            f, lambda: LinearizabilityTester(Register(None)), self._code_op, self._code_ret)
        return ActorModelState(
            actor_states=tuple(actor_states),
            network=UnorderedNonDuplicatingNetwork(counts),
            timers_set=tuple(Timers() for _ in range(self.S + self.C)),
            history=history,
        )

    # --- batched delivery bodies -------------------------------------------
    # Each takes the pre-state words[F, 1, W], the family's successors
    # w[F, n, W] (updated in place; they start as copies of the pre-state),
    # the envelope codes e[1, n] and the parameter table prm[1, n, cols];
    # returns (valid, overflow), [F, n]. The reference's
    # ``where(quorum, w2, w)`` over a second copy becomes writes gated on
    # ``quorum`` (``_set_if``, ``_net_send(..., cond)``).

    def _net_send(self, w, idx, cond=None):
        """The mixin's send at a code clamped into the universe: a code
        computed from a clock past its bound (reported as overflow) must
        not index past the state's words."""
        if isinstance(idx, torch.Tensor):
            idx = idx.clamp(0, self._U - 1)
        return super()._net_send(w, idx, cond)

    def _own_pair(self, words, s):
        """Server ``s``'s (seq, val) pair code."""
        L = self._layout
        return L.get(words, "seq", s) * self.NV + L.get(words, "val", s)

    def _body_begin(self, words, w, e, prm):
        """Put/Get -> its coordinator: begin phase 1 seeded with the local
        pair, Query the peer (linearizable-register.rs:86-111)."""
        L, S = self._layout, self.S
        c, r, query_code = prm[..., 0], prm[..., 1], prm[..., 2]
        deliv = self._net_take(words, w, e)
        ok = deliv & (L.get(words, "kind", c) == 0)
        L.set_(w, "kind", 1, c)
        L.set_(w, "p_req", r, c)
        L.set_(w, "rp", 1, c * S + c)
        L.set_(w, "rv", self._own_pair(words, c), c * S + c)
        return ok, ok & self._net_send(w, query_code)

    def _body_query(self, words, w, e, prm):
        """Query -> the peer: reply with the local pair, no state change
        (linearizable-register.rs:113-116)."""
        d, ackq_base = prm[..., 0], prm[..., 1]
        deliv = self._net_take(words, w, e)
        return deliv, deliv & self._net_send(w, ackq_base + self._own_pair(words, d))

    def _body_ackquery(self, words, w, e, prm):
        """AckQuery -> the coordinator: collect; on quorum pick the maximal
        pair, bump the clock for writes, Record to the peer, move to phase 2
        (linearizable-register.rs:118-176)."""
        L, S = self._layout, self.S
        c, r, p, sv, record_base, wval, is_write_p = (prm[..., i] for i in range(7))
        deliv = self._net_take(words, w, e)
        ok = deliv & (L.get(words, "kind", c) == 1) & (L.get(words, "p_req", c) == r)
        L.set_(w, "rp", 1, c * S + p)
        L.set_(w, "rv", sv, c * S + p)
        sv2, quorum, o = self._ackquery_core(words, w, c, p, sv, wval, is_write_p)
        o = o | (quorum & self._net_send(w, record_base + sv2, quorum))
        return ok, ok & o

    def _ackquery_core(self, words, w, c, p, sv, wval, is_write_p, gate=None):
        """Quorum check and the Phase1 -> Phase2 transition on coordinator
        ``c`` given peer ``p``'s response ``sv``
        (linearizable-register.rs:118-176); ``c`` and ``p`` are ints or
        tensors, so both network forms share it.

        Reads come from the pre-delivery ``words``; the transition is
        written into ``w`` in place where the quorum holds (and ``gate``,
        if given). Returns ``(sv2, quorum, clock_overflow)``: the caller
        sends Record(sv2) on its network."""
        L, S, NV = self._layout, self.S, self.NV
        count = best = 0
        for j in range(S):
            mine = p == j
            if isinstance(mine, bool) and mine:  # p is an int: its own slot
                count, seen = count + 1, sv
            else:
                pj = L.get(words, "rp", c * S + j)
                vj = L.get(words, "rv", c * S + j)
                if not isinstance(mine, bool):
                    pj, vj = torch.where(mine, 1, pj), torch.where(mine, sv, vj)
                count = count + pj
                seen = torch.where(pj != 0, vj, 0)
            # max by (seq, val) == max by seq: equal sequencers carry equal
            # values (linearizable-register.rs:139-142).
            best = seen if j == 0 else torch.maximum(best, seen)
        quorum = count == self.majority
        best_seq = best // NV
        clock = best_seq // S
        is_write = is_write_p != 0
        o = quorum & is_write & (clock >= self.C)  # the clock would overflow
        seq2 = torch.where(is_write, (clock + 1) * S + c, best_seq)
        val2 = torch.where(is_write, wval, best % NV)
        sv2 = seq2 * NV + val2
        cond = quorum if gate is None else quorum & gate
        for j in range(S):  # responses cleared on the phase switch
            self._set_if(w, cond, "rp", 0, c * S + j)
            self._set_if(w, cond, "rv", 0, c * S + j)
        self._set_if(w, cond, "kind", 2, c)
        self._set_if(w, cond, "read", torch.where(is_write, 0, 1 + val2), c)
        for j in range(S):  # acks := {c}
            self._set_if(w, cond, "ak", 0, c * S + j)
        self._set_if(w, cond, "ak", 1, c * S + c)
        # Self-send Record: adopt if newer (seq codes are order-monotone).
        seq_c, val_c = L.get(words, "seq", c), L.get(words, "val", c)
        newer = seq2 > seq_c
        self._set_if(w, cond, "seq", torch.where(newer, seq2, seq_c), c)
        self._set_if(w, cond, "val", torch.where(newer, val2, val_c), c)
        return sv2, quorum, o

    def _body_record(self, words, w, e, prm):
        """Record -> the peer: adopt newer pairs, always ack
        (linearizable-register.rs:177-184)."""
        L = self._layout
        d, sv, ackrecord_code = prm[..., 0], prm[..., 1], prm[..., 2]
        deliv = self._net_take(words, w, e)
        seq = sv // self.NV
        seq_d = L.get(words, "seq", d)
        newer = seq > seq_d
        L.set_(w, "seq", torch.where(newer, seq, seq_d), d)
        L.set_(w, "val", torch.where(newer, sv % self.NV, L.get(words, "val", d)), d)
        return deliv, deliv & self._net_send(w, ackrecord_code)

    def _body_ackrecord(self, words, w, e, prm):
        """AckRecord -> the coordinator: on an ack quorum answer the client
        and clear the phase (linearizable-register.rs:185-210)."""
        L, S = self._layout, self.S
        c, r, p, putok_code, getok_base, is_read_p = (prm[..., i] for i in range(6))
        deliv = self._net_take(words, w, e)
        ok = (deliv & (L.get(words, "kind", c) == 2) & (L.get(words, "p_req", c) == r)
              & (L.get(words, "ak", c * S + p) == 0))
        L.set_(w, "ak", 1, c * S + p)
        quorum, read = self._ackrecord_core(words, w, c, p)
        is_read = is_read_p != 0
        reply = torch.where(is_read, getok_base + read - 1, putok_code)
        dup = self._net_send(w, reply, quorum)
        # A read phase always recorded a read value (read != 0).
        o = quorum & (dup | (is_read & (read == 0)))
        return ok, ok & o

    def _ackrecord_core(self, words, w, c, p, gate=None):
        """Ack-quorum check and phase clear on coordinator ``c`` given peer
        ``p``'s ack (linearizable-register.rs:185-210): the phase is cleared
        in ``w`` in place where the quorum holds (and ``gate``, if given).
        Returns ``(quorum, read)``; the caller sends the PutOk/GetOk reply
        on its network form."""
        L, S = self._layout, self.S
        count = 0
        for j in range(S):
            mine = p == j
            if isinstance(mine, bool):
                count = count + (1 if mine else L.get(words, "ak", c * S + j))
            else:
                count = count + torch.where(mine, 1, L.get(words, "ak", c * S + j))
        quorum = count == self.majority
        read = L.get(words, "read", c)
        cond = quorum if gate is None else quorum & gate
        for j in range(S):  # clear the phase
            self._set_if(w, cond, "ak", 0, c * S + j)
        self._set_if(w, cond, "kind", 0, c)
        self._set_if(w, cond, "p_req", 0, c)
        self._set_if(w, cond, "read", 0, c)
        return quorum, read

    def packed_properties(self, words: torch.Tensor) -> torch.Tensor:
        """``[F, 2]``: [linearizable, value chosen], the order of
        ``properties()``. The first is the exact on-device linearizability
        check; the second mirrors ``value_chosen_condition``: some
        deliverable GetOk with a real (non-None) value."""
        L = self._layout
        lin = self.device_linearizable_register(words)
        chosen = torch.zeros_like(lin)
        for k in range(self.C):
            for v in range(1, self.NV):  # written values only
                chosen = chosen | (L.get(words, "net", self._base_getok[k] + v) != 0)
        return torch.stack([lin, chosen], 1)


class PackedAbdOrdered(PackedAbd):
    """The ABD quorum register over the **ordered** network on the GPU
    engine: the ``linearizable-register check 2 ordered`` configuration of
    stateright's benchmark harness (``BASELINE.json``), packed with
    :class:`~stateright_tpu_torch.packing.FifoLanes`.

    It shares the protocol structure (request table, sequencer and value
    codes, phase fields, quorum cores) with :class:`PackedAbd`; only the
    network differs: per-directed-pair FIFO channels where only the lane
    heads are deliverable (network.rs:57-67, 221-293). One action slot per
    lane; a head whose delivery is a no-op (an ack the coordinator's phase
    does not match) blocks its lane, like the object model's
    head-of-channel-only rule.

    Lanes: per client k (actor id i = S+k) four depth-1 lanes — Put
    (i -> i%S), Get (i -> (i+1)%S), PutOk (i%S -> i), GetOk ((i+1)%S -> i,
    one code per value) — and one depth-3 server-to-server lane per
    direction carrying the internal traffic, coded
    ``[Query(r) | Record(r, sv) | AckQuery(r', sv) | AckRecord(r')]`` with
    ``r`` indexing the sender's requests and ``r'`` the receiver's.

    Stateright has no count oracle for ordered ABD, so its parity is with
    the object ``OrderedNetwork`` model and the reference package.
    """

    def __init__(self, client_count: int = 2, server_count: int = 2):
        # Does not call PackedAbd.__init__ (the presence-bit envelope
        # universe); shares its protocol helpers.
        if server_count != 2 or client_count not in (2, 3):
            raise ValueError(
                "PackedAbdOrdered packs S=2 (single-peer quorum arithmetic) "
                "with 2 or 3 clients; other sizes run on the host engines"
            )
        C, S = client_count, server_count
        self._init_core(C, S)
        self._inner = linearizable_register_model(C, S, Network.new_ordered())
        NSV = self.NSQ * self.NV
        self._NSV = NSV
        # Server-to-server lane code layout (see class docstring).
        self._R = [len(self._reqs[s]) for s in range(S)]
        self._ss_codes = [self._R[d] * (1 + NSV) + self._R[1 - d] * (NSV + 1) for d in range(S)]
        #: request id -> local request index, per server.
        self._rid2r = [{self._req_id(s, r): r for r in range(self._R[s])} for s in range(S)]
        self.max_actions = 4 * C + S  # one slot per lane

        b = LayoutBuilder()
        self._server_layout(b)
        self._client_layout(b)
        # Client lanes (depth 1): lane k = Put, C+k = Get, 2C+k = PutOk,
        # 3C+k = GetOk(value).
        self._clanes = FifoLanes(b, "cl_flows", lanes=4 * C, depth=1, code_bits=bits_for(self.NV - 1))
        # Server-to-server lanes (depth 3): lane d = server d -> server 1-d.
        self._slanes = FifoLanes(b, "ss_flows", lanes=S, depth=3,
                                 code_bits=bits_for(max(self._ss_codes) - 1))
        code_bits = bits_for(self.NV)
        self._hist = BoundedHistory(
            b, thread_ids=[Id(S + k) for k in range(C)], max_ops=2,
            op_bits=code_bits, ret_bits=code_bits,
        )
        self._layout = b.finish()
        self._hist.bind(self._layout)
        self._clanes.bind(self._layout)
        self._slanes.bind(self._layout)
        self.state_words = self._layout.words
        codecs = reg.history_codecs(self.values)
        self._op_code, self._code_op, self._ret_code, self._code_ret = codecs
        self._device_tables: dict = {}
        interleaving_tables(C, self._hist.max_ops + 1)

    # --- lane codec ---------------------------------------------------------

    def _clane_key(self, lane: int):
        """(src, dst) of client lane ``lane``."""
        C, S = self.C, self.S
        i = S + lane % C
        return [(Id(i), Id(i % S)), (Id(i), Id((i + 1) % S)),
                (Id(i % S), Id(i)), (Id((i + 1) % S), Id(i))][lane // C]

    def _clane_msg_code(self, lane: int, msg) -> int:
        C, S = self.C, self.S
        k = lane % C
        i = S + k
        group = lane // C
        if group == 0 and isinstance(msg, reg.Put) and msg == reg.Put(i, self.values[1 + k]):
            return 0
        if group == 1 and isinstance(msg, reg.Get) and msg == reg.Get(2 * i):
            return 0
        if group == 2 and isinstance(msg, reg.PutOk) and msg == reg.PutOk(i):
            return 0
        if group == 3 and isinstance(msg, reg.GetOk) and msg.request_id == 2 * i:
            return self._val_code(msg.value)
        raise OverflowError32(f"message outside universe on lane {lane}: {msg!r}")

    def _clane_code_msg(self, lane: int, code: int):
        C, S = self.C, self.S
        k = lane % C
        i = S + k
        group = lane // C
        if group == 0:
            return reg.Put(i, self.values[1 + k])
        if group == 1:
            return reg.Get(2 * i)
        if group == 2:
            return reg.PutOk(i)
        return reg.GetOk(2 * i, self.values[code])

    def _ss_msg_code(self, d: int, msg) -> int:
        """Code of an internal message on lane ``d`` (server d -> 1-d)."""
        NSV = self._NSV
        R_s, R_p = self._R[d], self._R[1 - d]
        if not isinstance(msg, reg.Internal):
            raise OverflowError32(f"non-internal on ss lane {d}: {msg!r}")
        m = msg.msg
        if isinstance(m, Query):
            return self._rid2r[d][m.request_id]
        if isinstance(m, Record):
            return R_s + self._rid2r[d][m.request_id] * NSV + self._sv_code(m.seq, m.value)
        if isinstance(m, AckQuery):
            r = self._rid2r[1 - d][m.request_id]
            return R_s + R_s * NSV + r * NSV + self._sv_code(m.seq, m.value)
        if isinstance(m, AckRecord):
            return R_s + R_s * NSV + R_p * NSV + self._rid2r[1 - d][m.request_id]
        raise OverflowError32(f"unknown internal on ss lane {d}: {m!r}")

    def _ss_code_msg(self, d: int, code: int):
        NSV, NV = self._NSV, self.NV
        R_s, R_p = self._R[d], self._R[1 - d]
        if code < R_s:
            return reg.Internal(Query(self._req_id(d, code)))
        code -= R_s
        if code < R_s * NSV:
            r, sv = divmod(code, NSV)
            return reg.Internal(Record(self._req_id(d, r), self._seqs[sv // NV], self.values[sv % NV]))
        code -= R_s * NSV
        if code < R_p * NSV:
            r, sv = divmod(code, NSV)
            return reg.Internal(AckQuery(self._req_id(1 - d, r), self._seqs[sv // NV],
                                         self.values[sv % NV]))
        code -= R_p * NSV
        return reg.Internal(AckRecord(self._req_id(1 - d, code)))

    # --- codec -------------------------------------------------------------

    def pack(self, state) -> np.ndarray:
        C, S = self.C, self.S
        fields = self._pack_server_fields(state)
        flows = dict(state.network.flows)

        def pack_lanes(lanes, n_lanes, key_of, code_of):
            cells = [0] * (n_lanes * lanes.depth)
            lens = [0] * n_lanes
            for lane in range(n_lanes):
                msgs = flows.pop(key_of(lane), ())
                lane_cells, n = lanes.host_pack_lane([code_of(lane, m) for m in msgs])
                cells[lane * lanes.depth:(lane + 1) * lanes.depth] = lane_cells
                lens[lane] = n
            fields[lanes.cells] = cells
            fields[lanes.lens] = lens

        pack_lanes(self._clanes, 4 * C, self._clane_key, self._clane_msg_code)
        pack_lanes(self._slanes, S, lambda d: (Id(d), Id(1 - d)), self._ss_msg_code)
        if flows:
            raise OverflowError32(f"flows outside universe: {list(flows)!r}")
        fields.update(self._hist.from_tester(state.history, self._op_code, self._ret_code))
        return self._layout.pack(**fields)

    def unpack(self, words) -> ActorModelState:
        f = self._layout.unpack(words)
        C, S = self.C, self.S
        actor_states = self._unpack_server_states(f)
        flows = {}
        for lanes, n_lanes, key_of, code_msg in (
            (self._clanes, 4 * C, self._clane_key, self._clane_code_msg),
            (self._slanes, S, lambda d: (Id(d), Id(1 - d)), self._ss_code_msg),
        ):
            for lane in range(n_lanes):
                n = f[lanes.lens][lane]
                if n:
                    cells = f[lanes.cells][lane * lanes.depth:lane * lanes.depth + n]
                    flows[key_of(lane)] = tuple(code_msg(lane, c - 1) for c in cells)
        history = self._hist.to_tester(
            f, lambda: LinearizabilityTester(Register(None)), self._code_op, self._code_ret)
        return ActorModelState(
            actor_states=tuple(actor_states),
            network=OrderedNetwork(flows),
            timers_set=tuple(Timers() for _ in range(S + C)),
            history=history,
        )

    # --- batched delivery bodies -------------------------------------------

    def _request_tables(self, device: torch.device):
        """Per receiving server ``me``, its requests' metadata as int64
        tensors indexed by a local request index held in a tensor: the
        write value code, the is-write flag and the requesting client. Made
        once per device, before any CUDA graph capture reads them."""
        key = str(device)
        if key not in self._device_tables:
            tables = []
            for me in range(self.S):
                reqs = self._reqs[me]
                rows = [(1 + k if kind == 0 else 0, 1 if kind == 0 else 0, k) for k, kind in reqs]
                tables.append(torch.as_tensor(np.asarray(rows, np.int64).T, device=device))
            self._device_tables[key] = tables
        return self._device_tables[key]

    def packed_step(self, words: torch.Tensor):
        """One action slot per lane, in lane order: Put lanes, Get lanes,
        PutOk lanes, GetOk lanes, then the two server-to-server lanes. Each
        lane's body writes in place into its slot of ``next``, which starts
        as a copy of the pre-state."""
        F, W = words.shape
        C = self.C
        nxt = words[:, None, :].expand(F, self.max_actions, W).clone()
        valid = torch.empty((F, self.max_actions), dtype=torch.bool, device=words.device)
        ovf = torch.empty_like(valid)
        bodies = (
            [lambda w, k=k: self._body_lane_request(words, w, k, put=True) for k in range(C)]
            + [lambda w, k=k: self._body_lane_request(words, w, k, put=False) for k in range(C)]
            + [lambda w, k=k: self._body_lane_putok(words, w, k) for k in range(C)]
            + [lambda w, k=k: self._body_lane_getok(words, w, k) for k in range(C)]
            + [lambda w, d=d: self._body_lane_ss(words, w, d) for d in range(self.S)]
        )
        for a, body in enumerate(bodies):
            ok, o = body(nxt[:, a])
            valid[:, a] = ok
            ovf[:, a] = o & ok
        return nxt, valid, ovf

    def _body_lane_request(self, words, w, k, *, put: bool):
        """Head of client k's Put/Get lane -> its coordinator: begin phase 1
        (linearizable-register.rs:86-111) and Query the peer. Blocked while
        the coordinator is mid-phase (the object model's no-op rule)."""
        L, S = self._layout, self.S
        s, r = self._rix[(k, 0 if put else 1)]
        lane = k if put else self.C + k
        _code, nonempty = self._clanes.head(words, lane)
        ok = nonempty & (L.get(words, "kind", s) == 0)
        self._clanes.pop(w, lane, enabled=ok)
        L.set_(w, "kind", 1, s)
        L.set_(w, "p_req", r, s)
        L.set_(w, "rp", 1, s * S + s)
        L.set_(w, "rv", self._own_pair(words, s), s * S + s)
        ovf = self._slanes.push(w, s, r, enabled=ok)  # Query(r)
        return ok, ok & ovf

    def _body_lane_putok(self, words, w, k):
        """Head of the PutOk lane -> client k: record WriteOk, invoke the
        Read, push Get (register.rs:170-185)."""
        L = self._layout
        lane = 2 * self.C + k
        _code, nonempty = self._clanes.head(words, lane)
        ok = nonempty & (L.get(words, "cl_await", k) == 1)
        self._clanes.pop(w, lane, enabled=ok)
        L.set_(w, "cl_await", 2, k)
        L.set_(w, "cl_ops", 2, k)
        o = self._hist.on_return(w, k, 0, enabled=ok)  # WriteOk
        self._hist.on_invoke(w, k, 0, enabled=ok)  # Read
        povf = self._clanes.push(w, self.C + k, 0, enabled=ok)  # Get
        return ok, ok & (o | povf)

    def _body_lane_getok(self, words, w, k):
        """Head of the GetOk lane -> client k: record ReadOk(value); the
        script completes (register.rs:186-187)."""
        L = self._layout
        lane = 3 * self.C + k
        code, nonempty = self._clanes.head(words, lane)
        ok = nonempty & (L.get(words, "cl_await", k) == 2)
        self._clanes.pop(w, lane, enabled=ok)
        L.set_(w, "cl_await", 0, k)
        L.set_(w, "cl_ops", 3, k)
        return ok, ok & self._hist.on_return(w, k, 1 + code, enabled=ok)

    def _body_lane_ss(self, words, w, d):
        """Head of the server-to-server lane d -> me (= 1-d), dispatched on
        the code's range. Query and Record are processed unconditionally
        (linearizable-register.rs:113-116, 177-184); AckQuery and AckRecord
        must match my active phase or the lane blocks. The four branches
        share the slot: each writes only where its own head kind holds."""
        L, S, NV, NSV = self._layout, self.S, self.NV, self._NSV
        me = 1 - d
        R_s, R_p = self._R[d], self._R[me]
        wval_tbl, iw_tbl, kcl_tbl = self._request_tables(words.device)[me]
        code, nonempty = self._slanes.head(words, d)
        is_query = code < R_s
        is_record = ~is_query & (code < R_s + R_s * NSV)
        is_ackq = ~is_query & ~is_record & (code < R_s + R_s * NSV + R_p * NSV)
        is_ackrec = ~is_query & ~is_record & ~is_ackq
        seq_me, val_me = L.get(words, "seq", me), L.get(words, "val", me)

        # --- Query(r): reply AckQuery(r, own pair) on my lane -------------
        on_q = nonempty & is_query
        # On lane `me`, AckQuery codes describe requests of server d.
        ackq_code = (R_p + R_p * NSV + code * NSV + seq_me * NV + val_me) & MASK32
        self._slanes.pop(w, d, enabled=on_q)
        o_q = self._slanes.push(w, me, ackq_code, enabled=on_q)

        # --- Record(r, sv): adopt if newer, AckRecord(r) ------------------
        on_r = nonempty & is_record
        rec = (code - R_s) & MASK32
        rec_r, rec_sv = rec // NSV, rec % NSV
        rec_seq = rec_sv // NV
        newer = rec_seq > seq_me
        self._slanes.pop(w, d, enabled=on_r)
        self._set_if(w, on_r, "seq", torch.where(newer, rec_seq, seq_me), me)
        self._set_if(w, on_r, "val", torch.where(newer, rec_sv % NV, val_me), me)
        ackrec_code = (R_p + R_p * NSV + R_s * NSV + rec_r) & MASK32
        o_r = self._slanes.push(w, me, ackrec_code, enabled=on_r)

        # --- AckQuery(r', sv): my Phase1 completes on quorum --------------
        aq = (code - (R_s + R_s * NSV)) & MASK32
        aq_r, aq_sv = aq // NSV, aq % NSV
        ok_aq = (nonempty & is_ackq & (L.get(words, "kind", me) == 1)
                 & (L.get(words, "p_req", me) == aq_r))
        self._slanes.pop(w, d, enabled=ok_aq)
        self._set_if(w, ok_aq, "rp", 1, me * S + d)
        self._set_if(w, ok_aq, "rv", aq_sv, me * S + d)
        # A code of another kind decodes past the table: clamp the index
        # (the branch is off for that row).
        r_ix = aq_r.clamp(max=R_p - 1)
        sv2, quorum, o_clock = self._ackquery_core(
            words, w, me, d, aq_sv, wval_tbl[r_ix], iw_tbl[r_ix], gate=ok_aq)
        # Record(r', sv2) on my lane (r' indexes my requests there).
        o_push = self._slanes.push(w, me, (R_p + aq_r * NSV + sv2) & MASK32, enabled=ok_aq & quorum)
        o_a = ok_aq & (o_clock | (quorum & o_push))

        # --- AckRecord(r'): my Phase2 completes on ack quorum -------------
        ar_r = (code - (R_s + R_s * NSV + R_p * NSV)) & MASK32
        ok_ar = (nonempty & is_ackrec & (L.get(words, "kind", me) == 2)
                 & (L.get(words, "p_req", me) == ar_r) & (L.get(words, "ak", me * S + d) == 0))
        self._slanes.pop(w, d, enabled=ok_ar)
        self._set_if(w, ok_ar, "ak", 1, me * S + d)
        quorum_r, read = self._ackrecord_core(words, w, me, d, gate=ok_ar)
        ar_ix = ar_r.clamp(max=R_p - 1)
        k_cl = kcl_tbl[ar_ix]
        is_read_req = iw_tbl[ar_ix] == 0
        # Reply lane: PutOk lane 2C+k for writes, GetOk lane 3C+k for
        # reads (code = the read value).
        reply_lane = torch.where(is_read_req, 3 * self.C + k_cl, 2 * self.C + k_cl)
        reply_code = torch.where(is_read_req, (read - 1) & MASK32, 0)
        o_reply = self._clanes.push(w, reply_lane, reply_code, enabled=ok_ar & quorum_r)
        o_c = ok_ar & quorum_r & (o_reply | (is_read_req & (read == 0)))

        ok = nonempty & (is_query | is_record | ok_aq | ok_ar)
        return ok, (on_q & o_q) | (on_r & o_r) | o_a | o_c

    def packed_properties(self, words: torch.Tensor) -> torch.Tensor:
        """``[F, 2]``: [linearizable, value chosen]; "value chosen" reads
        the GetOk lane heads only: under ordered semantics only heads are
        deliverable."""
        lin = self.device_linearizable_register(words)
        chosen = torch.zeros_like(lin)
        for k in range(self.C):
            code, nonempty = self._clanes.head(words, 3 * self.C + k)
            chosen = chosen | (nonempty & (code >= 1))
        return torch.stack([lin, chosen], 1)


def main(argv=None, device=None) -> None:
    """Command line in the manner of linearizable-register.rs:319-430.
    ``check`` runs the GPU engine on the packed model at the test shape (2
    servers) for 2 or 3 clients, on the unordered or the ordered network
    (on the card unless ``device`` names the CPU); other shapes and
    networks fall back to the host DFS at the command line's 3-server
    shape, as the reference does. ``check-host`` runs the host DFS,
    ``spawn`` starts three servers on UDP ports 3000-3002 of localhost, and
    ``explore`` serves the Explorer on the host engine (``serve``)."""
    import sys

    from ..report import WriteReporter

    args = list(sys.argv[1:] if argv is None else argv)
    cmd = args.pop(0) if args else None
    if cmd in ("check", "check-xla"):
        client_count = int(args.pop(0)) if args else 2
        netname = args.pop(0) if args else None
        # "unordered" and "unordered_nonduplicating" both name the packed
        # models' default network and take the same device check.
        if netname == "unordered":
            netname = "unordered_nonduplicating"
        if client_count in (2, 3) and netname in (None, "unordered_nonduplicating", "ordered"):
            cls = PackedAbdOrdered if netname == "ordered" else PackedAbd
            print(
                f"Model checking a linearizable register with {client_count} "
                f"clients and 2 servers on the GPU"
                + (" (ordered network)." if netname == "ordered" else ".")
            )
            cls(client_count, 2).checker().spawn_xla(
                device=device, frontier_capacity=1 << 10, table_capacity=1 << 13
            ).report(WriteReporter())
        else:
            network = Network.from_name(netname) if netname else None
            print(
                f"Model checking a linearizable register with {client_count} "
                "clients (host DFS, the command line's 3-server shape)."
            )
            linearizable_register_model(client_count, 3, network).checker().spawn_dfs().report(
                WriteReporter())
    elif cmd == "check-host":
        client_count = int(args.pop(0)) if args else 2
        network = Network.from_name(args.pop(0)) if args else None
        print(f"Model checking a linearizable register with {client_count} clients.")
        linearizable_register_model(client_count, 3, network).checker().spawn_dfs().report(
            WriteReporter())
    elif cmd == "explore":
        client_count = int(args.pop(0)) if args else 2
        address = args.pop(0) if args else "localhost:3000"
        network = Network.from_name(args.pop(0)) if args else None
        print(
            f"Exploring state space for linearizable register with "
            f"{client_count} clients on {address}."
        )
        linearizable_register_model(client_count, 3, network).checker().serve(address)
    elif cmd == "spawn":
        from ..actor.spawn import json_codec, spawn

        port = 3000
        ids = [Id.from_addr("127.0.0.1", port + i) for i in range(3)]
        serialize, deserialize = json_codec(
            reg.Put, reg.Get, reg.PutOk, reg.GetOk, reg.Internal,
            Query, AckQuery, Record, AckRecord,
        )
        print("  Three servers that implement a linearizable register.")
        print("  You can interact using netcat:")
        print(f"$ nc -u localhost {port}")
        print(serialize(reg.Put(1, "X")).decode())
        print(serialize(reg.Get(2)).decode())
        spawn(serialize, deserialize,
              [(ids[i], AbdActor([x for x in ids if x != ids[i]])) for i in range(3)])
    else:
        print("USAGE:")
        print("  linearizable-register check [CLIENT_COUNT] [NETWORK]  (GPU engine for 2-3 clients")
        print("      at the test shape, 2 servers; other shapes and networks fall back to the")
        print("      host DFS at the command line's 3-server shape)")
        print("  linearizable-register check-host [CLIENT_COUNT] [NETWORK]  (sequential host DFS)")
        print("  linearizable-register check-xla   (alias of check)")
        print("  linearizable-register explore [CLIENT_COUNT] [ADDRESS] [NETWORK]")
        print("  linearizable-register spawn")
        print(
            f"NETWORK: {' | '.join(Network.names())}"
            "  ('unordered' = unordered_nonduplicating, the packed default)"
        )


if __name__ == "__main__":
    main()
