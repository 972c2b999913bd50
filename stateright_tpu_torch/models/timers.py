"""Timer-semantics demo: pingers driven entirely by model timers.

Counterpart of ``stateright_tpu/models/timers.py`` (stateright's
``examples/timers.rs``): each actor sets three timers
on start (``Even``, ``Odd``, ``NoOp``). In the model a timeout is a
nondeterministic action (the duration range is irrelevant,
actor/model.rs:59-64); firing ``Even``/``Odd`` re-arms the timer and pings
the even/odd peers, while ``NoOp`` only re-arms itself — which the no-op
detection (``is_no_op_with_timer``, actor.rs:254-264) suppresses, so ``NoOp``
timeouts never generate states.

The state space is unbounded (counters grow), so ``check`` bounds the run
with ``target_state_count``. :class:`PackedTimers` is the GPU form.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..actor import (
    Actor,
    ActorModel,
    Id,
    Network,
    Out,
    StateRef,
    model_peers,
    model_timeout,
)
from ..actor.model_state import ActorModelState
from ..actor.network import Envelope, UnorderedNonDuplicatingNetwork
from ..actor.timers import Timers
from ..core import Expectation
from ..packing import LayoutBuilder, OverflowError32, PackedModelAdapter
from ..utils.variant import variant

Ping = variant("Ping", [])
Pong = variant("Pong", [])

Even = variant("Even", [])
Odd = variant("Odd", [])
NoOp = variant("NoOp", [])


class PingerState(NamedTuple):
    sent: int
    received: int


class PingerActor(Actor):
    """timers.rs:32-96."""

    def __init__(self, peer_ids):
        self.peer_ids = list(peer_ids)

    def on_start(self, id: Id, out: Out) -> PingerState:
        out.set_timer(Even(), model_timeout())
        out.set_timer(Odd(), model_timeout())
        out.set_timer(NoOp(), model_timeout())
        return PingerState(sent=0, received=0)

    def on_msg(self, id: Id, state: StateRef, src: Id, msg: Any, out: Out) -> None:
        if isinstance(msg, Ping):
            out.send(src, Pong())
        elif isinstance(msg, Pong):
            s = state.get()
            state.set(s._replace(received=s.received + 1))

    def on_timeout(self, id: Id, state: StateRef, timer: Any, out: Out) -> None:
        if isinstance(timer, NoOp):
            out.set_timer(NoOp(), model_timeout())  # pure re-arm: a no-op
            return
        parity = 0 if isinstance(timer, Even) else 1
        out.set_timer(timer, model_timeout())
        for dst in self.peer_ids:
            if int(dst) % 2 == parity:
                s = state.get()
                state.set(s._replace(sent=s.sent + 1))
                out.send(dst, Ping())


def timers_model(
    server_count: int = 3, network: Optional[Network] = None
) -> ActorModel:
    """Build the checkable model (timers.rs:104-113)."""
    if network is None:
        network = Network.new_unordered_nonduplicating()
    model = ActorModel(cfg=None)
    for i in range(server_count):
        model.actor(PingerActor(model_peers(i, server_count)))
    return model.init_network(network).property(
        Expectation.ALWAYS, "true", lambda _m, _s: True
    )


class PackedTimers(PackedModelAdapter):
    """The Pingers system on the GPU engine (``spawn_xla``).

    Pending timers need no storage: every actor's set is always ``{Even,
    Odd, NoOp}`` (all three are re-armed on every firing and never
    cancelled, timers.rs:50-74). The ``NoOp`` timeout gets no action slot:
    its pure re-arm is a no-op the object model drops
    (``is_no_op_with_timer``, actor.rs:254-264). ``Even``/``Odd`` timeout
    slots are valid whenever the actor has a peer of that parity, and bump
    ``sent`` by the (static) peer count while adding one to each Ping's
    multiset count.

    The space is unbounded (counters grow), so GPU runs take a
    ``target_state_count`` or a ``target_max_depth``, as the object command
    line does; a counter or an envelope count that outgrows its field is
    the loud codec-overflow failure (``OverflowError32``).
    """

    def __init__(self, server_count: int = 3, *, count_bits: int = 8, net_bits: int = 5):
        n = server_count
        self.n = n
        self._inner = timers_model(n)
        # Closed envelope universe: Ping(i->j) then Pong(i->j), i != j.
        pairs = [(i, j) for i in range(n) for j in range(n) if i != j]
        self._pairs = pairs
        U = 2 * len(pairs)
        self._U = U
        self._ping_code = {p: c for c, p in enumerate(pairs)}
        self._pong_code = {p: len(pairs) + c for c, p in enumerate(pairs)}
        self._count_bits, self._net_bits = count_bits, net_bits
        self._layout = (
            LayoutBuilder()
            .array("sent", n, count_bits)
            .array("recv", n, count_bits)
            .array("net", U, net_bits)
            .finish()
        )
        self.state_words = self._layout.words
        # Slots: [Even, Odd] timeouts of each actor, then one delivery per code.
        self.max_actions = 2 * n + U
        self._targets = {
            (i, parity): [j for j in range(n) if j != i and j % 2 == parity]
            for i in range(n)
            for parity in (0, 1)
        }

    # --- codec --------------------------------------------------------------

    def pack(self, state) -> np.ndarray:
        sent = [s.sent for s in state.actor_states]
        recv = [s.received for s in state.actor_states]
        net = [0] * self._U
        for env, count in state.network.counts.items():
            pair = (int(env.src), int(env.dst))
            code = (self._ping_code if isinstance(env.msg, Ping) else self._pong_code).get(pair)
            if code is None:
                raise OverflowError32(f"envelope outside universe: {env!r}")
            net[code] = count
        for v in sent + recv:
            if v >= 1 << self._count_bits:
                raise OverflowError32(f"counter {v} exceeds {self._count_bits} bits")
        for c in net:
            if c >= 1 << self._net_bits:
                raise OverflowError32(f"envelope count {c} exceeds {self._net_bits} bits")
        return self._layout.pack(sent=sent, recv=recv, net=net)

    def unpack(self, words) -> ActorModelState:
        f = self._layout.unpack(words)
        counts = {}
        for (i, j), c in self._ping_code.items():
            if f["net"][c]:
                counts[Envelope(Id(i), Id(j), Ping())] = int(f["net"][c])
        for (i, j), c in self._pong_code.items():
            if f["net"][c]:
                counts[Envelope(Id(i), Id(j), Pong())] = int(f["net"][c])
        timers = Timers(frozenset((Even(), Odd(), NoOp())))
        return ActorModelState(
            actor_states=tuple(PingerState(int(f["sent"][k]), int(f["recv"][k])) for k in range(self.n)),
            network=UnorderedNonDuplicatingNetwork(counts),
            timers_set=tuple(timers for _ in range(self.n)),
            history=(),
        )

    # --- batched transitions ------------------------------------------------

    def packed_step(self, words: torch.Tensor):
        """``words[F, W] -> (next[F, A, W], valid[F, A], ovf[F, A])``: the
        ``Even``/``Odd`` timeouts of each actor, then the delivery of every
        envelope code; each slot written in place from a copy of the
        pre-state. ``ovf`` marks a counter or a count past its field."""
        L = self._layout
        F, W = words.shape
        cmax = (1 << self._count_bits) - 1
        nmax = (1 << self._net_bits) - 1
        nxt = words[:, None, :].expand(F, self.max_actions, W).clone()
        valid = torch.zeros((F, self.max_actions), dtype=torch.bool, device=words.device)
        ovf = torch.zeros_like(valid)
        slot = 0
        for i in range(self.n):
            for parity in (0, 1):
                targets = self._targets[(i, parity)]
                if targets:
                    # No matching peer leaves a pure re-arm: a dropped no-op
                    # whose slot stays invalid.
                    w = nxt[:, slot]
                    sent = L.get(words, "sent", i)
                    L.set_(w, "sent", sent + len(targets), i)
                    o = sent + len(targets) > cmax
                    for j in targets:
                        c = L.get(w, "net", self._ping_code[(i, j)])
                        o = o | (c == nmax)
                        L.set_(w, "net", c + 1, self._ping_code[(i, j)])
                    valid[:, slot] = True
                    ovf[:, slot] = o
                slot += 1
        for (i, j), code in self._ping_code.items():
            # Deliver Ping(i->j): j replies Pong(j->i).
            w = nxt[:, slot]
            c = L.get(words, "net", code)
            pong = self._pong_code[(j, i)]
            cp = L.get(words, "net", pong)
            L.set_(w, "net", c - 1, code)
            L.set_(w, "net", cp + 1, pong)
            valid[:, slot] = c > 0
            ovf[:, slot] = (c > 0) & (cp == nmax)
            slot += 1
        for (i, j), code in self._pong_code.items():
            # Deliver Pong(i->j): j counts a received pong.
            w = nxt[:, slot]
            c = L.get(words, "net", code)
            r = L.get(words, "recv", j)
            L.set_(w, "net", c - 1, code)
            L.set_(w, "recv", r + 1, j)
            valid[:, slot] = c > 0
            ovf[:, slot] = (c > 0) & (r == cmax)
            slot += 1
        return nxt, valid, ovf

    def packed_properties(self, words: torch.Tensor) -> torch.Tensor:
        """``[F, 1]``: the object model's "true"."""
        return torch.ones((words.shape[0], 1), dtype=torch.bool, device=words.device)


def main(argv=None) -> None:
    """Command line in the manner of timers.rs:115-164, each ``check``
    bounded to 100,000 states. ``check`` runs the GPU engine (another
    network falls back to the host DFS: the packed codec models the
    default network), ``check-host`` the host DFS; ``explore`` waits for
    the Explorer (ROADMAP A10)."""
    import sys

    from ..report import WriteReporter

    args = list(sys.argv[1:] if argv is None else argv)
    cmd = args.pop(0) if args else None
    if cmd in ("check", "check-xla") and not args:
        print("Model checking Pingers on the GPU (bounded to 100k states).")
        PackedTimers(3).checker().target_state_count(100_000).spawn_xla(
            frontier_capacity=1 << 15, table_capacity=1 << 18
        ).report(WriteReporter())
    elif cmd in ("check", "check-xla", "check-host"):
        network = Network.from_name(args.pop(0)) if args else None
        print("Model checking Pingers (bounded to 100k states).")
        timers_model(3, network).checker().target_state_count(100_000).spawn_dfs().report(
            WriteReporter())
    elif cmd == "explore":
        raise NotImplementedError("explore waits for the Explorer (ROADMAP A10)")
    else:
        print("USAGE:")
        print("  timers check [NETWORK]       (GPU engine)")
        print("  timers check-host [NETWORK]  (sequential host DFS)")
        print("  timers check-xla             (alias of check)")
        print(f"NETWORK: {' | '.join(Network.names())}")


if __name__ == "__main__":
    main()
