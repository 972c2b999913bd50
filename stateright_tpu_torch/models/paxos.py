"""Single Decree Paxos, model-checked for linearizability.

Counterpart of ``stateright_tpu/models/paxos.py`` (stateright's
``examples/paxos.rs``): a cluster of Paxos servers
(two-phase consensus: Prepare/Prepared leadership handoff, Accept/Accepted
quorum decision, Decided dissemination — paxos.rs:66-248) fronted by the
register protocol (Put/Get), with scripted register clients and a
``LinearizabilityTester`` riding in the model history.

The exact-count oracle is the reference's own test: 16,668 unique states at
2 clients / 3 servers on an unordered non-duplicating network
(paxos.rs:321,345).

A term is coupled to the life of a client request — each Put starts a new
ballot — matching the classic single-decree presentation (paxos.rs:44-47).

:class:`PackedPaxos` is the GPU form; its delivery bodies run batched over
the frontier and over each message family's parameter table. The command
line entry point (``check``/``explore``/``spawn``) waits for a later slice.
"""

from __future__ import annotations

from typing import Any, FrozenSet, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..actor import Actor, ActorModel, Id, Network, majority, model_peers
from ..actor import register as reg
from ..actor.model_state import ActorModelState
from ..actor.network import Envelope, UnorderedNonDuplicatingNetwork
from ..actor.timers import Timers
from ..core import Expectation
from ..ops.words import MASK32
from ..packing import BoundedHistory, LayoutBuilder, OverflowError32, PackedModelAdapter
from ..packing import bits_for as _bits
from ..semantics import LinearizabilityTester
from ..semantics.device import MAX_PATTERNS_EXACT, interleaving_tables, pattern_count
from ..semantics.register import Register
from ..utils.variant import variant

Ballot = Tuple[int, Id]  # (round, leader id), lexicographic order
Proposal = Tuple[int, Id, Any]  # (request_id, requester, value)

# variants, not NamedTuples: Accept(b, p) must not equal Decided(b, p) in
# the modeled network (Rust enum variants never compare equal, paxos.rs:65).
Prepare = variant("Prepare", ["ballot"])
Prepared = variant("Prepared", ["ballot", "last_accepted"])
Accept = variant("Accept", ["ballot", "proposal"])
Accepted = variant("Accepted", ["ballot"])
Decided = variant("Decided", ["ballot", "proposal"])


class PaxosState(NamedTuple):
    """Combined leader/acceptor state (paxos.rs:90-103).

    ``prepares`` is a map ``Id -> Option<(Ballot, Proposal)>`` stored as a
    frozenset of pairs (the Python rendering of ``HashableHashMap``);
    ``accepts`` is a frozenset of acceptor ids."""

    ballot: Ballot
    proposal: Optional[Proposal]
    prepares: FrozenSet[Tuple[Id, Optional[Tuple[Ballot, Proposal]]]]
    accepts: FrozenSet[Id]
    accepted: Optional[Tuple[Ballot, Proposal]]
    is_decided: bool


def _map_insert(m: FrozenSet, k: Any, v: Any) -> FrozenSet:
    d = dict(m)
    d[k] = v
    return frozenset(d.items())


def _accepted_order(v: Optional[Tuple[Ballot, Proposal]]):
    # Option ordering: None < Some, Some compared lexicographically.
    return (0,) if v is None else (1, v)


class PaxosActor(Actor):
    """One Paxos server; plays both leader and acceptor (paxos.rs:110-248)."""

    def __init__(self, peer_ids):
        self.peer_ids = list(peer_ids)

    def on_start(self, id: Id, out) -> PaxosState:
        return PaxosState(
            ballot=(0, Id(0)),
            proposal=None,
            prepares=frozenset(),
            accepts=frozenset(),
            accepted=None,
            is_decided=False,
        )

    def on_msg(self, id: Id, state, src: Id, msg: Any, out) -> None:
        s: PaxosState = state.get()
        if s.is_decided:
            # Once decided, only Gets are serviced; an undecided server does
            # not reply to Get at all, since a decision may exist elsewhere
            # (paxos.rs:139-151).
            if isinstance(msg, reg.Get):
                _ballot, (_req_id, _src, value) = s.accepted
                out.send(src, reg.GetOk(msg.request_id, value))
            return

        if isinstance(msg, reg.Put):
            if s.proposal is not None:
                return  # ignored: a proposal is already in flight
            # Start a new term; simulate Prepare/Prepared self-sends
            # (paxos.rs:154-171).
            ballot = (s.ballot[0] + 1, id)
            state.set(
                s._replace(
                    proposal=(msg.request_id, src, msg.value),
                    prepares=_map_insert(frozenset(), id, s.accepted),
                    accepts=frozenset(),
                    ballot=ballot,
                )
            )
            out.broadcast(self.peer_ids, reg.Internal(Prepare(ballot)))
            return

        if not isinstance(msg, reg.Internal):
            return
        m = msg.msg

        if isinstance(m, Prepare) and s.ballot < m.ballot:
            # Close earlier terms; report previously accepted proposal
            # (paxos.rs:172-181).
            state.set(s._replace(ballot=m.ballot))
            out.send(src, reg.Internal(Prepared(m.ballot, s.accepted)))

        elif isinstance(m, Prepared) and m.ballot == s.ballot:
            # Leadership handoff: once a quorum has closed earlier terms,
            # drive the most recently accepted proposal if any, else the
            # client's (paxos.rs:182-221).
            prepares = _map_insert(s.prepares, src, m.last_accepted)
            s2 = s._replace(prepares=prepares)
            if len(prepares) == majority(len(self.peer_ids) + 1):
                best = max((v for _k, v in prepares), key=_accepted_order)
                if best is not None:
                    proposal = best[1]
                else:
                    assert s2.proposal is not None, "proposal expected"
                    proposal = s2.proposal
                # Simulate Accept/Accepted self-sends.
                s2 = s2._replace(
                    proposal=proposal,
                    accepted=(m.ballot, proposal),
                    accepts=frozenset((id,)),
                )
                out.broadcast(
                    self.peer_ids, reg.Internal(Accept(m.ballot, proposal))
                )
            state.set(s2)

        elif isinstance(m, Accept) and s.ballot <= m.ballot:
            # Acceptor accepts the proposal of the current-or-newer term
            # (paxos.rs:222-227).
            state.set(s._replace(ballot=m.ballot, accepted=(m.ballot, m.proposal)))
            out.send(src, reg.Internal(Accepted(m.ballot)))

        elif isinstance(m, Accepted) and m.ballot == s.ballot:
            # Quorum of accepts = decision (paxos.rs:228-238).
            accepts = s.accepts | {src}
            s2 = s._replace(accepts=accepts)
            if len(accepts) == majority(len(self.peer_ids) + 1):
                s2 = s2._replace(is_decided=True)
                assert s2.proposal is not None, "proposal expected"
                request_id, requester_id, _value = s2.proposal
                out.broadcast(
                    self.peer_ids, reg.Internal(Decided(s.ballot, s2.proposal))
                )
                out.send(requester_id, reg.PutOk(request_id))
            state.set(s2)

        elif isinstance(m, Decided):
            # Learn the decision (paxos.rs:239-244).
            state.set(
                s._replace(
                    ballot=m.ballot,
                    accepted=(m.ballot, m.proposal),
                    is_decided=True,
                )
            )


def paxos_model(
    client_count: int = 2,
    server_count: int = 3,
    network: Optional[Network] = None,
) -> ActorModel:
    """Build the checkable model (paxos.rs:250-292): ``server_count`` Paxos
    servers + ``client_count`` register clients, with an ``always
    linearizable`` property over the history tester and a ``sometimes value
    chosen`` reachability property."""
    if network is None:
        network = Network.new_unordered_nonduplicating()

    model = ActorModel(
        cfg=None, init_history=LinearizabilityTester(Register(None))
    )
    for i in range(server_count):
        model.actor(PaxosActor(model_peers(i, server_count)))
    for _ in range(client_count):
        model.actor(reg.RegisterClient(put_count=1, server_count=server_count))
    return (
        model.init_network(network)
        .property(Expectation.ALWAYS, "linearizable", reg.linearizable_condition())
        .property(Expectation.SOMETIMES, "value chosen", reg.value_chosen_condition)
        .record_msg_in(reg.record_returns)
        .record_msg_out(reg.record_invocations)
    )


class PackedPaxos(reg.PackedClientsMixin, PackedModelAdapter):
    """Single Decree Paxos on the GPU engine (``spawn_xla``): the flagship
    actor example packed into fixed-width state words.

    Everything is declared through :mod:`stateright_tpu_torch.packing`; the hard
    sub-problems SURVEY §7 ranks #2 are solved here generically:

    - the **bounded per-server map** (``prepares``, paxos.rs:97-103) packs
      as per-key (present, accepted-code) scalar fields — keys are server
      ids, a closed set, so every access is statically indexed;
    - the **non-duplicating multiset network** (network.rs:54-55) packs as
      presence bits over a *syntactically closed envelope universe*: every
      send the protocol can ever perform is enumerated at construction
      (ballot rounds are bounded by the Put count, leaders by which servers
      receive Puts), and sub-families whose payload is data-dependent at
      send time (``Prepared`` carries the sender's accepted option, ``Accept``
      / ``Decided`` the driven proposal, ``GetOk`` the read value) are laid
      out contiguously so the device indexes them affinely. A state whose
      network leaves the universe — or holds two copies of one envelope —
      fails loudly (``OverflowError32`` on host, the codec-overflow output
      on device), never silently. Empirically (full 16,668-state
      enumeration) Paxos(2,3) stays within the universe with all envelope
      counts at 1.
    - the **LinearizabilityTester history** rides in the state via
      :class:`~stateright_tpu_torch.packing.BoundedHistory` (max 2 ops/client),
      exactly as the object model carries it (paxos.rs:266-292).

    The ``linearizable`` property is checked EXACTLY on device
    (``device_linearizable_register``, SURVEY §7 M4 variant (b)): the
    bounded history these clients produce admits a static enumeration of
    every interleaving the backtracking serializer
    (linearizability.rs:197-284) would try, fused into the property pass —
    no host re-verification step and no candidate-buffer sizing needed.

    Oracle: 16,668 unique states at 2 clients / 3 servers
    (paxos.rs:321,345), reproduced differentially against the object model.
    """

    def __init__(self, client_count: int = 2, server_count: int = 3):
        if pattern_count(client_count, 2) > MAX_PATTERNS_EXACT:
            raise ValueError(
                f"{client_count} clients exceed the exact device "
                "linearizability budget (semantics.device.MAX_PATTERNS_EXACT); "
                "larger sizes run on the host engines"
            )
        C, S = client_count, server_count
        self.C, self.S = C, S
        self.majority = S // 2 + 1
        self._inner = paxos_model(C, S)
        self._OverflowError32 = OverflowError32

        # Ballot/leader bounds: only servers that receive Puts ever start
        # ballots (client i Puts to server i % S, register.rs:118-120), and
        # each Put delivery raises the round by one, so rounds are bounded
        # by the Put count.
        self.leaders = sorted({(S + k) % S for k in range(C)})
        self.lidx = {l: i for i, l in enumerate(self.leaders)}
        NL = len(self.leaders)
        self.NL = NL
        R = C
        self.R = R
        self.values = [chr(ord("A") + k) for k in range(C)]

        # Ballot codes, monotone in the model's lexicographic (round, Id)
        # order: 0 = the initial (0, Id(0)); 1 + (r-1)*NL + leader_index.
        self._ballots: list = [(0, Id(0))]
        for r in range(1, R + 1):
            for l in self.leaders:
                self._ballots.append((r, Id(l)))
        self.NB = len(self._ballots)

        # Accepted-option codes, monotone in the model's max_by(_accepted_order):
        # 0 = None; 1 + ((r-1)*NL + leader_index)*C + proposal_index.
        self._acc_opts: list = [None]
        for r in range(1, R + 1):
            for l in self.leaders:
                for p in range(C):
                    self._acc_opts.append(((r, Id(l)), self._proposal(p)))
        self.NA = len(self._acc_opts)

        # --- the closed envelope universe -------------------------------
        # Handler metadata rides along: (kind, static params) per code.
        envs: list = []
        handlers: list = []
        self._code_put: list = []
        self._base_putok: dict = {}
        self._code_get: list = []
        self._base_getok: list = []
        self._base_prepare: dict = {}
        self._base_prepared: dict = {}
        self._base_accept: dict = {}
        self._code_accepted_env: dict = {}
        self._base_decided: dict = {}

        for k in range(C):
            i = S + k
            self._code_put.append(len(envs))
            envs.append(Envelope(Id(i), Id(i % S), reg.Put(i, self.values[k])))
            handlers.append(("put", (k, i % S)))
        for l in self.leaders:
            self._base_putok[l] = len(envs)
            for p in range(C):
                envs.append(Envelope(Id(l), Id(S + p), reg.PutOk(S + p)))
                handlers.append(("putok", (p,)))
        for k in range(C):
            i = S + k
            self._code_get.append(len(envs))
            envs.append(Envelope(Id(i), Id((i + 1) % S), reg.Get(2 * i)))
            handlers.append(("get", (k, (i + 1) % S)))
        for k in range(C):
            i = S + k
            self._base_getok.append(len(envs))
            for p in range(C):
                envs.append(
                    Envelope(Id((i + 1) % S), Id(i), reg.GetOk(2 * i, self.values[p]))
                )
                handlers.append(("getok", (k, p)))
        for l in self.leaders:
            for d in range(S):
                if d == l:
                    continue
                self._base_prepare[(l, d)] = len(envs)
                for r in range(1, R + 1):
                    envs.append(
                        Envelope(Id(l), Id(d), reg.Internal(Prepare((r, Id(l)))))
                    )
                    handlers.append(("prepare", (l, r, d)))
        for l in self.leaders:
            for r in range(1, R + 1):
                for s in range(S):
                    if s == l:
                        continue
                    self._base_prepared[(l, r, s)] = len(envs)
                    for la in range(self.NA):
                        envs.append(
                            Envelope(
                                Id(s),
                                Id(l),
                                reg.Internal(Prepared((r, Id(l)), self._acc_opts[la])),
                            )
                        )
                        handlers.append(("prepared", (l, r, s, la)))
        for l in self.leaders:
            for r in range(1, R + 1):
                for d in range(S):
                    if d == l:
                        continue
                    self._base_accept[(l, r, d)] = len(envs)
                    for p in range(C):
                        envs.append(
                            Envelope(
                                Id(l),
                                Id(d),
                                reg.Internal(Accept((r, Id(l)), self._proposal(p))),
                            )
                        )
                        handlers.append(("accept", (l, r, d, p)))
        for l in self.leaders:
            for r in range(1, R + 1):
                for s in range(S):
                    if s == l:
                        continue
                    self._code_accepted_env[(l, r, s)] = len(envs)
                    envs.append(Envelope(Id(s), Id(l), reg.Internal(Accepted((r, Id(l))))))
                    handlers.append(("accepted", (l, r, s)))
        for l in self.leaders:
            for r in range(1, R + 1):
                for d in range(S):
                    if d == l:
                        continue
                    self._base_decided[(l, r, d)] = len(envs)
                    for p in range(C):
                        envs.append(
                            Envelope(
                                Id(l),
                                Id(d),
                                reg.Internal(Decided((r, Id(l)), self._proposal(p))),
                            )
                        )
                        handlers.append(("decided", (l, r, d, p)))

        self._envs = envs
        self._handlers = handlers
        self._env_code = {env: c for c, env in enumerate(envs)}
        self._U = len(envs)
        self.max_actions = self._U

        # --- layout ------------------------------------------------------
        # Server/client state lives in ARRAY fields (uniformly strided) so
        # the vectorized step bodies can address them with traced indices:
        # one traced handler per message family, vmapped over the family's
        # parameter table, instead of one unrolled trace per envelope code
        # (which produced 20k-equation jaxprs and minute-scale XLA compiles).
        b = LayoutBuilder()
        b.array("bal", S, _bits(self.NB - 1))
        b.array("prop", S, _bits(C))
        b.array("acc", S, _bits(self.NA - 1))
        b.array("dec", S, 1)
        b.array("pp", S * S, 1)  # prepares presence, index s*S + key
        b.array("pv", S * S, _bits(self.NA - 1))  # prepares accepted-codes
        b.array("ac", S * S, 1)  # accepts bitset, index s*S + voter
        self._client_layout(b)
        b.array("net", self._U, 1)
        hist_values = [None] + self.values
        code_bits = _bits(len(hist_values))
        self._hist = BoundedHistory(
            b,
            thread_ids=[Id(S + k) for k in range(C)],
            max_ops=2,
            op_bits=code_bits,
            ret_bits=code_bits,
        )
        self._layout = b.finish()
        self._hist.bind(self._layout)
        self.state_words = self._layout.words

        codecs = reg.history_codecs(hist_values)
        self._op_code, self._code_op, self._ret_code, self._code_ret = codecs

        self._families = self._build_families()
        self._device_families: dict = {}
        # The serializer's pattern tables, built once on the host.
        interleaving_tables(C, self._hist.max_ops + 1)

    def _peers(self, x: int):
        return [j for j in range(self.S) if j != x]

    def _build_families(self):
        """Per-family uint32 parameter tables (one column per static
        handler input, send-base columns per peer); see
        PackedClientsMixin._group_families/packed_step."""
        C = self.C

        def acc_base(l: int, r: int) -> int:
            return 1 + ((r - 1) * self.NL + self.lidx[l]) * C

        def params_for(kind: str, params) -> list:
            if kind == "put":
                k, d = params
                return [k, d, self.lidx[d]] + [
                    self._base_prepare[(d, pd)] for pd in self._peers(d)
                ]
            if kind == "putok":
                (p,) = params
                return [p, self._code_get[p]]
            if kind == "get":
                k, d = params
                return [d, self._base_getok[k]]
            if kind == "getok":
                k, p = params
                # ReadOk(values[p]) ret code under [None]+values indexing.
                return [k, 2 + p]
            if kind == "prepare":
                l, r, d = params
                return [
                    self._ballot_code((r, Id(l))),
                    d,
                    self._base_prepared[(l, r, d)],
                ]
            if kind == "prepared":
                l, r, s, la = params
                return [
                    self._ballot_code((r, Id(l))),
                    l,
                    s,
                    la,
                    acc_base(l, r),
                ] + [self._base_accept[(l, r, pd)] for pd in self._peers(l)]
            if kind == "accept":
                l, r, d, p = params
                return [
                    self._ballot_code((r, Id(l))),
                    d,
                    acc_base(l, r) + p,
                    self._code_accepted_env[(l, r, d)],
                ]
            if kind == "accepted":
                l, r, s = params
                return [
                    self._ballot_code((r, Id(l))),
                    l,
                    s,
                    self._base_putok[l],
                ] + [self._base_decided[(l, r, pd)] for pd in self._peers(l)]
            # "decided"
            l, r, d, p = params
            return [self._ballot_code((r, Id(l))), d, acc_base(l, r) + p]

        return self._group_families(params_for)

    def _proposal(self, p: int):
        return (self.S + p, Id(self.S + p), self.values[p])

    def _ballot_code(self, ballot) -> int:
        try:
            return self._ballots.index(ballot)
        except ValueError:
            raise self._OverflowError32(f"ballot outside universe: {ballot!r}")

    def _acc_code(self, opt) -> int:
        try:
            return self._acc_opts.index(opt)
        except ValueError:
            raise self._OverflowError32(f"accepted option outside universe: {opt!r}")

    # --- codec -------------------------------------------------------------

    def pack(self, state) -> np.ndarray:
        S, C = self.S, self.C
        fields: dict = {
            "bal": [0] * S,
            "prop": [0] * S,
            "acc": [0] * S,
            "dec": [0] * S,
            "pp": [0] * (S * S),
            "pv": [0] * (S * S),
            "ac": [0] * (S * S),
        }
        for s in range(S):
            a: PaxosState = state.actor_states[s]
            fields["bal"][s] = self._ballot_code(a.ballot)
            if a.proposal is not None:
                p = int(a.proposal[1]) - S
                if not 0 <= p < C or a.proposal != self._proposal(p):
                    raise self._OverflowError32(
                        f"proposal outside universe: {a.proposal!r}"
                    )
                fields["prop"][s] = 1 + p
            fields["acc"][s] = self._acc_code(a.accepted)
            fields["dec"][s] = 1 if a.is_decided else 0
            for key, val in a.prepares:
                j = int(key)
                if not 0 <= j < S:
                    raise self._OverflowError32(f"prepares key {key!r} not a server")
                fields["pp"][s * S + j] = 1
                fields["pv"][s * S + j] = self._acc_code(val)
            for j in a.accepts:
                fields["ac"][s * S + int(j)] = 1
        self._pack_clients(fields, state)
        self._pack_presence_net(fields, state)
        fields.update(
            self._hist.from_tester(state.history, self._op_code, self._ret_code)
        )
        return self._layout.pack(**fields)

    def unpack(self, words):
        f = self._layout.unpack(words)
        S, C = self.S, self.C
        actor_states = []
        for s in range(S):
            prop_code = f["prop"][s]
            prepares = frozenset(
                (Id(j), self._acc_opts[f["pv"][s * S + j]])
                for j in range(S)
                if f["pp"][s * S + j]
            )
            accepts = frozenset(Id(j) for j in range(S) if f["ac"][s * S + j])
            actor_states.append(
                PaxosState(
                    ballot=self._ballots[f["bal"][s]],
                    proposal=None if prop_code == 0 else self._proposal(prop_code - 1),
                    prepares=prepares,
                    accepts=accepts,
                    accepted=self._acc_opts[f["acc"][s]],
                    is_decided=bool(f["dec"][s]),
                )
            )
        self._unpack_clients(f, actor_states)
        counts = {
            self._envs[code]: count for code, count in enumerate(f["net"]) if count
        }
        history = self._hist.to_tester(
            f,
            lambda: LinearizabilityTester(Register(None)),
            self._code_op,
            self._code_ret,
        )
        return ActorModelState(
            actor_states=tuple(actor_states),
            network=UnorderedNonDuplicatingNetwork(counts),
            timers_set=tuple(Timers() for _ in range(S + C)),
            history=history,
        )


    # --- batched delivery bodies -------------------------------------------
    # Each takes the pre-state words[F, 1, W], the family's successors
    # w[F, n, W] (updated in place; they start as copies of the pre-state),
    # the envelope codes e[1, n] and the parameter table prm[1, n, cols];
    # returns (valid, overflow), [F, n]. Pre-state reads come from
    # ``words``; updates accumulate on ``w``. The reference's
    # ``where(quorum, w2, w)`` over a second copy becomes writes gated on
    # ``quorum`` (``_set_if``, ``_net_send(..., cond)``).

    def _body_put(self, words, w, e, prm):
        L, S = self._layout, self.S
        k, d, lidx_d = prm[..., 0], prm[..., 1], prm[..., 2]
        deliv = self._net_take(words, w, e)
        ok = deliv & (L.get(words, "dec", d) == 0) & (L.get(words, "prop", d) == 0)
        bc = L.get(words, "bal", d)
        r = torch.where(bc == 0, 0, (bc - 1) // self.NL + 1)
        o = r >= self.R  # the next round would leave the universe
        L.set_(w, "bal", 1 + r * self.NL + lidx_d, d)
        L.set_(w, "prop", k + 1, d)
        acc_d = L.get(words, "acc", d)
        for j in range(S):  # prepares := {d: accepted}, accepts := {}
            L.set_(w, "pp", 0, d * S + j)
            L.set_(w, "pv", 0, d * S + j)
            L.set_(w, "ac", 0, d * S + j)
        L.set_(w, "pp", 1, d * S + d)
        L.set_(w, "pv", acc_d, d * S + d)
        for j in range(S - 1):
            # Prepare codes are contiguous in round: base + (new_round-1).
            o = o | self._net_send(w, prm[..., 3 + j] + r)
        return ok, ok & o

    def _body_get(self, words, w, e, prm):
        L = self._layout
        d, getok_base = prm[..., 0], prm[..., 1]
        deliv = self._net_take(words, w, e)
        # Undecided servers ignore Gets (paxos.rs:139-151).
        ok = deliv & (L.get(words, "dec", d) != 0)
        acc_d = L.get(words, "acc", d)
        # The proposal index of the accepted value, in the reference's
        # uint32 arithmetic (acc_d - 1 wraps when acc_d is 0).
        p = ((acc_d - 1) & MASK32) % self.C
        dup = self._net_send(w, getok_base + p)
        # A decided server always has an accepted value (the ref
        # destructures it, paxos.rs:147); acc==0 here is a codec bug.
        return ok, ok & (dup | (acc_d == 0))

    def _body_prepare(self, words, w, e, prm):
        L = self._layout
        bc, d, prepared_base = prm[..., 0], prm[..., 1], prm[..., 2]
        deliv = self._net_take(words, w, e)
        ok = deliv & (L.get(words, "dec", d) == 0) & (L.get(words, "bal", d) < bc)
        L.set_(w, "bal", bc, d)
        # Prepared(b, accepted) back to the leader: codes contiguous in the
        # accepted option.
        dup = self._net_send(w, prepared_base + L.get(words, "acc", d))
        return ok, ok & dup

    def _body_prepared(self, words, w, e, prm):
        L, S = self._layout, self.S
        bc, l, s, la, acc_base = (prm[..., i] for i in range(5))
        deliv = self._net_take(words, w, e)
        ok = deliv & (L.get(words, "dec", l) == 0) & (L.get(words, "bal", l) == bc)
        L.set_(w, "pp", 1, l * S + s)
        L.set_(w, "pv", la, l * S + s)
        count = best = 0
        for j in range(S):
            mine = s == j
            pj = torch.where(mine, 1, L.get(words, "pp", l * S + j))
            vj = torch.where(mine, la, L.get(words, "pv", l * S + j))
            count = count + pj
            seen = torch.where(pj != 0, vj, 0)
            best = seen if j == 0 else torch.maximum(best, seen)
        quorum = count == self.majority
        prop_cur = L.get(words, "prop", l)
        # Drive the best previously-accepted proposal, else our own
        # (paxos.rs:192-204). Accepted codes are monotone in the model's
        # max_by(_accepted_order), so max-of-codes is max-of-options;
        # (code-1) % C recovers the proposal index.
        p_driven = torch.where(best != 0, (best - 1) % self.C, prop_cur - 1)
        o = quorum & (best == 0) & (prop_cur == 0)  # ref asserts (paxos.rs:199)
        self._set_if(w, quorum, "prop", p_driven + 1, l)
        self._set_if(w, quorum, "acc", acc_base + p_driven, l)
        for j in range(S):  # accepts := {l}
            self._set_if(w, quorum, "ac", 0, l * S + j)
        self._set_if(w, quorum, "ac", 1, l * S + l)
        for j in range(S - 1):
            o = o | (quorum & self._net_send(w, prm[..., 5 + j] + p_driven, quorum))
        return ok, ok & o

    def _body_accept(self, words, w, e, prm):
        L = self._layout
        bc, d, acc_code, accepted_code = (prm[..., i] for i in range(4))
        deliv = self._net_take(words, w, e)
        ok = deliv & (L.get(words, "dec", d) == 0) & (L.get(words, "bal", d) <= bc)
        L.set_(w, "bal", bc, d)
        L.set_(w, "acc", acc_code, d)
        dup = self._net_send(w, accepted_code)
        return ok, ok & dup

    def _body_accepted(self, words, w, e, prm):
        L, S = self._layout, self.S
        bc, l, s, putok_base = (prm[..., i] for i in range(4))
        deliv = self._net_take(words, w, e)
        ok = deliv & (L.get(words, "dec", l) == 0) & (L.get(words, "bal", l) == bc)
        L.set_(w, "ac", 1, l * S + s)
        count = 0
        for j in range(S):
            count = count + torch.where(s == j, 1, L.get(words, "ac", l * S + j))
        quorum = count == self.majority
        prop_cur = L.get(words, "prop", l)
        o = quorum & (prop_cur == 0)  # ref asserts (paxos.rs:232)
        p = prop_cur - 1
        self._set_if(w, quorum, "dec", 1, l)
        for j in range(S - 1):
            o = o | (quorum & self._net_send(w, prm[..., 4 + j] + p, quorum))
        # PutOk to the requester of the decided proposal (paxos.rs:236):
        # codes contiguous in proposal for this leader.
        o = o | (quorum & self._net_send(w, putok_base + p, quorum))
        return ok, ok & o

    def _body_decided(self, words, w, e, prm):
        # Learn the decision unconditionally (paxos.rs:239-244).
        L = self._layout
        bc, d, acc_code = prm[..., 0], prm[..., 1], prm[..., 2]
        deliv = self._net_take(words, w, e)
        ok = deliv & (L.get(words, "dec", d) == 0)
        L.set_(w, "bal", bc, d)
        L.set_(w, "acc", acc_code, d)
        L.set_(w, "dec", 1, d)
        return ok, torch.zeros_like(ok)  # never overflows

    def packed_properties(self, words: torch.Tensor) -> torch.Tensor:
        """``[F, 2]`` bool, [linearizable, value chosen] — the order of
        ``properties()``. The first is the exact on-device linearizability
        check (``device_linearizable_register``). The second mirrors
        ``value_chosen_condition``: a deliverable GetOk with a real value —
        Paxos GetOks always carry one."""
        L = self._layout
        lin = self.device_linearizable_register(words)
        chosen = torch.zeros_like(lin)
        for k in range(self.C):
            for p in range(self.C):
                chosen = chosen | (L.get(words, "net", self._base_getok[k] + p) != 0)
        return torch.stack([lin, chosen], 1)
