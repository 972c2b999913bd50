"""Canonical actor fixture: ping-pong with history counters and all three
property kinds.

Counterpart of ``stateright_tpu/actor/actor_test_util.py`` (stateright's
``src/actor/actor_test_util.rs``); :mod:`.packed` is its GPU form.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

from ..core import Expectation
from ..utils.variant import variant
from . import Actor, ActorModel, Id, Out, StateRef

# variant, not NamedTuple: Ping(n) must not equal Pong(n) in the modeled
# network (Rust enum variants never compare equal across variants).
Ping = variant("Ping", ["value"])
Pong = variant("Pong", ["value"])


class PingPongActor(Actor):
    """Sends Ping(0) at start (if serving), then counts message exchanges."""

    def __init__(self, serve_to: Optional[Id] = None):
        self.serve_to = serve_to

    def on_start(self, id: Id, out: Out) -> int:
        if self.serve_to is not None:
            out.send(self.serve_to, Ping(0))
        return 0

    def on_msg(self, id: Id, state: StateRef, src: Id, msg, out: Out) -> None:
        count = state.get()
        if isinstance(msg, Pong) and count == msg.value:
            out.send(src, Ping(msg.value + 1))
            state.set(count + 1)
        elif isinstance(msg, Ping) and count == msg.value:
            out.send(src, Pong(msg.value))
            state.set(count + 1)


class PingPongCfg(NamedTuple):
    maintains_history: bool
    max_nat: int


def ping_pong_model(cfg: PingPongCfg) -> ActorModel:
    """The full fixture model (actor_test_util.rs:59-124): history counters
    ``(#in, #out)``, a boundary at ``max_nat``, and properties of every
    expectation kind (one eventually-property falsifiable via the boundary)."""

    def record_in(cfg, history, env):
        if cfg.maintains_history:
            return (history[0] + 1, history[1])
        return None

    def record_out(cfg, history, env):
        if cfg.maintains_history:
            return (history[0], history[1] + 1)
        return None

    return (
        ActorModel(cfg=cfg, init_history=(0, 0))
        .actor(PingPongActor(serve_to=Id(1)))
        .actor(PingPongActor())
        .record_msg_in(record_in)
        .record_msg_out(record_out)
        .within_boundary_fn(
            lambda cfg, state: all(c <= cfg.max_nat for c in state.actor_states)
        )
        .property(
            Expectation.ALWAYS,
            "delta within 1",
            lambda _, state: max(state.actor_states) - min(state.actor_states) <= 1,
        )
        .property(
            Expectation.SOMETIMES,
            "can reach max",
            lambda model, state: any(
                c == model.cfg.max_nat for c in state.actor_states
            ),
        )
        .property(
            Expectation.EVENTUALLY,
            "must reach max",
            lambda model, state: any(
                c == model.cfg.max_nat for c in state.actor_states
            ),
        )
        .property(
            Expectation.EVENTUALLY,
            "must exceed max",
            # Falsifiable due to the boundary.
            lambda model, state: any(
                c == model.cfg.max_nat + 1 for c in state.actor_states
            ),
        )
        .property(
            Expectation.ALWAYS,
            "#in <= #out",
            lambda _, state: state.history[0] <= state.history[1],
        )
        .property(
            Expectation.EVENTUALLY,
            "#out <= #in + 1",
            lambda _, state: state.history[1] <= state.history[0] + 1,
        )
    )
