"""ActorModel: adapts a system of actors to the ``Model`` interface.

The port's own copy of ``stateright_tpu/actor/model.py`` (stateright's
``src/actor/model.rs``), with the Explorer's display hooks ``format_step``
and ``as_svg``, whose strings equal the reference's for the same path. The
model's nondeterminism is exactly stateright's: for every deliverable envelope, a ``Deliver``
action (plus a ``Drop`` when the network is lossy); for every set timer, a
``Timeout``.  History ``H`` is a TLA-style auxiliary variable updated by
``record_msg_in``/``record_msg_out`` — consistency testers ride in it.

Because this sits *below* the ``Model`` contract, every checker engine —
including ``spawn_xla()`` with a packed encoding — explores actor systems
unmodified (the property the reference calls out at model.rs:200).
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

from ..core import Model, Property
from .model_state import ActorModelState
from .network import Envelope, Network
from .timers import Timers


class DeliverAction(NamedTuple):
    """A message can be delivered to an actor."""

    src: "Id"
    dst: "Id"
    msg: Any


class DropAction(NamedTuple):
    """A message can be dropped (lossy networks only)."""

    envelope: Envelope


class TimeoutAction(NamedTuple):
    """An actor can be notified after a timeout."""

    id: "Id"
    timer: Any


ActorModelAction = (DeliverAction, DropAction, TimeoutAction)


class ActorModel(Model):
    """A system of actors communicating over a modeled network
    (model.rs:23-37).  Build fluently::

        ActorModel(cfg=..., init_history=...)
            .actor(Server())
            .actor(Client())
            .init_network(Network.new_ordered())
            .lossy_network(True)
            .property(Expectation.ALWAYS, "safe", lambda model, state: ...)
            .record_msg_in(lambda cfg, history, env: ... or None)
            .checker()
    """

    def __init__(self, cfg: Any = None, init_history: Any = ()):
        self.actors: List[Any] = []
        self.cfg = cfg
        self.init_history = init_history
        self._init_network: Network = Network.new_unordered_duplicating()
        self._lossy: bool = False
        self._properties: List[Property] = []
        self._record_msg_in: Callable = lambda cfg, history, env: None
        self._record_msg_out: Callable = lambda cfg, history, env: None
        self._within_boundary: Callable = lambda cfg, state: True

    # --- builder (model.rs:95-164) ----------------------------------------

    def actor(self, actor) -> "ActorModel":
        self.actors.append(actor)
        return self

    def add_actors(self, actors) -> "ActorModel":
        self.actors.extend(actors)
        return self

    def init_network(self, network: Network) -> "ActorModel":
        self._init_network = network
        return self

    def lossy_network(self, lossy: bool) -> "ActorModel":
        """Whether the network loses messages (model.rs:53-57).  Losing a
        message is indistinguishable from unlimited delay unless invariants
        inspect the network, so ``False`` often checks faster."""
        self._lossy = bool(lossy)
        return self

    def property(self, *args):
        """Arity-dispatched like the reference: ``property(expectation,
        name, condition)`` is the builder (model.rs:121-135);
        ``property(name)`` is the lookup inherited from ``Model``
        (lib.rs:229)."""
        if len(args) == 1:
            return super().property(args[0])
        expectation, name, condition = args
        self._properties.append(Property(expectation, name, condition))
        return self

    def record_msg_in(self, fn: Callable) -> "ActorModel":
        """``fn(cfg, history, envelope) -> new_history | None``."""
        self._record_msg_in = fn
        return self

    def record_msg_out(self, fn: Callable) -> "ActorModel":
        self._record_msg_out = fn
        return self

    def within_boundary_fn(self, fn: Callable) -> "ActorModel":
        self._within_boundary = fn
        return self

    # --- command application (model.rs:166-197) ---------------------------

    def _apply_commands(
        self,
        id,
        out,
        network: Network,
        timers_set: List[Timers],
        history: Any,
    ) -> Tuple[Network, Any]:
        from . import CancelTimer, Send, SetTimer

        index = int(id)
        for c in out.commands:
            if isinstance(c, Send):
                env = Envelope(id, c.dst, c.msg)
                new_history = self._record_msg_out(self.cfg, history, env)
                if new_history is not None:
                    history = new_history
                network = network.send(env)
            elif isinstance(c, SetTimer):
                timers_set[index] = timers_set[index].set(c.timer)
            elif isinstance(c, CancelTimer):
                timers_set[index] = timers_set[index].cancel(c.timer)
            else:  # pragma: no cover
                raise TypeError(f"unknown command {c!r}")
        return network, history

    # --- Model implementation (model.rs:200-343) --------------------------

    def init_states(self) -> List[ActorModelState]:
        from . import Id, Out

        actor_states: List[Any] = []
        network = self._init_network
        timers_set: List[Timers] = [Timers() for _ in self.actors]
        history = self.init_history
        for index, actor in enumerate(self.actors):
            out = Out()
            state = actor.on_start(Id(index), out)
            actor_states.append(state)
            network, history = self._apply_commands(
                Id(index), out, network, timers_set, history
            )
        return [
            ActorModelState(
                actor_states=tuple(actor_states),
                network=network,
                timers_set=tuple(timers_set),
                history=history,
            )
        ]

    def actions(self, state: ActorModelState, actions: List[Any]) -> None:
        # Deliverable envelopes: Drop option first when lossy, then Deliver
        # (model.rs:228-252). Ordered networks only offer flow heads, which
        # iter_deliverable already enforces.
        for env in state.network.iter_deliverable():
            if self._lossy:
                actions.append(DropAction(env))
            if int(env.dst) < len(self.actors):  # ignore if recipient DNE
                actions.append(DeliverAction(env.src, env.dst, env.msg))
        # Timeouts (model.rs:255-259).
        from . import Id

        for index, timers in enumerate(state.timers_set):
            for timer in timers:
                actions.append(TimeoutAction(Id(index), timer))

    def next_state(
        self, last_state: ActorModelState, action: Any
    ) -> Optional[ActorModelState]:
        from . import Out, StateRef, is_no_op, is_no_op_with_timer

        if isinstance(action, DropAction):
            return ActorModelState(
                actor_states=last_state.actor_states,
                network=last_state.network.on_drop(action.envelope),
                timers_set=last_state.timers_set,
                history=last_state.history,
            )

        if isinstance(action, DeliverAction):
            index = int(action.dst)
            if index >= len(last_state.actor_states):
                return None  # not all messages can be delivered
            ref = StateRef(last_state.actor_states[index])
            out = Out()
            self.actors[index].on_msg(action.dst, ref, action.src, action.msg, out)
            if is_no_op(ref, out):
                return None  # ignored action (model.rs:286-289)
            env = Envelope(action.src, action.dst, action.msg)
            new_history = self._record_msg_in(self.cfg, last_state.history, env)
            history = new_history if new_history is not None else last_state.history

            actor_states = list(last_state.actor_states)
            if ref.changed:
                actor_states[index] = ref.get()
            network = last_state.network.on_deliver(env)
            timers_set = list(last_state.timers_set)
            network, history = self._apply_commands(
                action.dst, out, network, timers_set, history
            )
            return ActorModelState(
                tuple(actor_states), network, tuple(timers_set), history
            )

        if isinstance(action, TimeoutAction):
            index = int(action.id)
            ref = StateRef(last_state.actor_states[index])
            out = Out()
            self.actors[index].on_timeout(action.id, ref, action.timer, out)
            if is_no_op_with_timer(ref, out, action.timer):
                return None
            actor_states = list(last_state.actor_states)
            if ref.changed:
                actor_states[index] = ref.get()
            # The fired timer is no longer set (model.rs:332-334).
            timers_set = list(last_state.timers_set)
            timers_set[index] = timers_set[index].cancel(action.timer)
            network, history = self._apply_commands(
                action.id, out, last_state.network, timers_set, last_state.history
            )
            return ActorModelState(
                tuple(actor_states), network, tuple(timers_set), history
            )

        raise TypeError(f"unknown action {action!r}")  # pragma: no cover

    def properties(self) -> List[Property]:
        return list(self._properties)

    def within_boundary(self, state: ActorModelState) -> bool:
        return self._within_boundary(self.cfg, state)

    def format_action(self, action: Any) -> str:
        if isinstance(action, DeliverAction):
            return f"{action.src!r} → {action.msg!r} → {action.dst!r}"
        return repr(action)

    def format_step(self, last_state: ActorModelState, action: Any) -> Optional[str]:
        from . import Out, StateRef

        if isinstance(action, DropAction):
            return f"DROP: {action.envelope!r}"
        if isinstance(action, DeliverAction):
            index = int(action.dst)
            if index >= len(last_state.actor_states):
                return None
            ref = StateRef(last_state.actor_states[index])
            out = Out()
            self.actors[index].on_msg(action.dst, ref, action.src, action.msg, out)
        elif isinstance(action, TimeoutAction):
            index = int(action.id)
            ref = StateRef(last_state.actor_states[index])
            out = Out()
            self.actors[index].on_timeout(action.id, ref, action.timer, out)
        else:
            return None
        last = last_state.actor_states[index]
        lines = [f"OUT: {out!r}", ""]
        if ref.changed:
            lines += [f"NEXT_STATE: {ref.get()!r}", "", f"PREV_STATE: {last!r}"]
        else:
            lines += [f"UNCHANGED: {last!r}"]
        return "\n".join(lines)

    def as_svg(self, path) -> Optional[str]:
        """Sequence-diagram SVG for an actor-system path (model.rs:424-549)."""
        from . import Send, Out, StateRef

        pairs = path.into_vec()
        actor_count = len(path.last_state().actor_states)

        def plot(x, y):
            return x * 100, y * 30

        svg_w, svg_h = plot(actor_count, len(pairs))
        svg_w += 300  # extra width for event labels
        parts = [
            f"<svg version='1.1' baseProfile='full' width='{svg_w}' height='{svg_h}' "
            f"viewbox='-20 -20 {svg_w + 20} {svg_h + 20}' "
            f"xmlns='http://www.w3.org/2000/svg'>",
            "<defs><marker class='svg-event-shape' id='arrow' markerWidth='12' "
            "markerHeight='10' refX='12' refY='5' orient='auto'>"
            "<polygon points='0 0, 12 5, 0 10' /></marker></defs>",
        ]
        for i in range(actor_count):
            (x1, y1), (x2, y2) = plot(i, 0), plot(i, len(pairs))
            parts.append(
                f"<line x1='{x1}' y1='{y1}' x2='{x2}' y2='{y2}' class='svg-actor-timeline' />"
            )
            parts.append(f"<text x='{x1}' y='{y1}' class='svg-actor-label'>{i}</text>")

        send_time = {}
        for time, (state, action) in enumerate(pairs, start=1):
            if isinstance(action, DeliverAction):
                src_time = send_time.get((action.src, action.dst, action.msg), 0)
                x1, y1 = plot(int(action.src), src_time)
                x2, y2 = plot(int(action.dst), time)
                parts.append(
                    f"<line x1='{x1}' x2='{x2}' y1='{y1}' y2='{y2}' "
                    f"marker-end='url(#arrow)' class='svg-event-line' />"
                )
                index = int(action.dst)
                if index < len(state.actor_states):
                    ref = StateRef(state.actor_states[index])
                    out = Out()
                    self.actors[index].on_msg(action.dst, ref, action.src, action.msg, out)
                    for c in out.commands:
                        if isinstance(c, Send):
                            send_time[(action.dst, c.dst, c.msg)] = time
            elif isinstance(action, TimeoutAction):
                x, y = plot(int(action.id), time)
                parts.append(
                    f"<circle cx='{x}' cy='{y}' r='10' class='svg-event-shape' />"
                )
                index = int(action.id)
                if index < len(state.actor_states):
                    ref = StateRef(state.actor_states[index])
                    out = Out()
                    self.actors[index].on_timeout(action.id, ref, action.timer, out)
                    for c in out.commands:
                        if isinstance(c, Send):
                            send_time[(action.id, c.dst, c.msg)] = time

        for time, (_state, action) in enumerate(pairs, start=1):
            if isinstance(action, DeliverAction):
                x, y = plot(int(action.dst), time)
                parts.append(
                    f"<text x='{x}' y='{y}' class='svg-event-label'>{action.msg!r}</text>"
                )
            elif isinstance(action, TimeoutAction):
                x, y = plot(int(action.id), time)
                parts.append(
                    f"<text x='{x}' y='{y}' class='svg-event-label'>"
                    f"Timeout({action.timer!r})</text>"
                )
        parts.append("</svg>")
        return "\n".join(parts)
