"""ActorModel: adapts a system of actors to the ``Model`` interface.

The port's own copy of ``stateright_tpu/actor/model.py`` (stateright's
``src/actor/model.rs``), less the Explorer's display hooks
(``format_step``, ``as_svg``), which wait for the Explorer. The model's
nondeterminism is exactly stateright's: for every deliverable envelope, a ``Deliver``
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
