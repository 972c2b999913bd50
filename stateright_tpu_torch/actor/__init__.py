"""Actor framework: event-driven actors that can be model checked.

The port's own copy of ``stateright_tpu/actor/__init__.py`` (stateright's
``src/actor.rs``), less the UDP runtime (``spawn``, with ``Id``'s socket
addresses) and ``ScriptActor``, which wait for a later slice:

- :class:`Actor` — ``on_start``/``on_msg``/``on_timeout`` handlers emitting
  :class:`Command`\\ s through an :class:`Out` buffer.
- :class:`Id` — actor address; an index for checked models.
- :class:`ActorModel` — adapts a system of actors to the ``Model`` interface
  so every checker engine (including ``spawn_xla``) can explore it.
- :class:`Network` — the in-state message collection (ordered / unordered
  duplicating / unordered non-duplicating).

Design deltas from the reference, intentional and Python-idiomatic:

- Rust's ``Cow``-based no-op detection (actor.rs:247-264) becomes the
  :class:`StateRef` wrapper: handlers call ``ref.set(new_state)`` (or leave
  it untouched); "unchanged and no commands" is a no-op action.
- Rust's ``choice!`` sum types for heterogeneous actor systems are
  unnecessary under duck typing: ``ActorModel.actors`` may simply mix actor
  classes (actor.rs:339-482's machinery has no Python analogue to need).
"""

from __future__ import annotations

from typing import Any, Iterable, List, NamedTuple, Tuple

from .network import Envelope, Network
from .timers import Timers


class Id(int):
    """Uniquely identifies an actor: an index for model-checked actors
    (actor.rs:108-156)."""

    def __repr__(self) -> str:
        return f"Id({int(self)})"


class Send(NamedTuple):
    """Send a message to a destination."""

    dst: Id
    msg: Any


class SetTimer(NamedTuple):
    """Set/reset a timer; duration is a (low, high) seconds range (only the
    runtime uses the range — the model treats firing as nondeterministic)."""

    timer: Any
    duration: Tuple[float, float]


class CancelTimer(NamedTuple):
    """Cancel the timer if one is set."""

    timer: Any


def model_timeout() -> Tuple[float, float]:
    """An arbitrary timeout range for model checking (model.rs:59-64)."""
    return (0.0, 0.0)


def model_peers(self_ix: int, count: int) -> List[Id]:
    """Peer ids for actor ``self_ix`` of ``count`` (model.rs:66-73)."""
    return [Id(j) for j in range(count) if j != self_ix]


def majority(count: int) -> int:
    """Minimum size of a majority quorum (actor.rs:530)."""
    return count // 2 + 1


class Out:
    """Buffer of commands emitted by an actor handler (actor.rs:169-243)."""

    def __init__(self):
        self.commands: List[Any] = []

    def send(self, recipient: Id, msg: Any) -> None:
        self.commands.append(Send(recipient, msg))

    def broadcast(self, recipients: Iterable[Id], msg: Any) -> None:
        for r in recipients:
            self.commands.append(Send(r, msg))

    def set_timer(self, timer: Any, duration: Tuple[float, float]) -> None:
        self.commands.append(SetTimer(timer, duration))

    def cancel_timer(self, timer: Any) -> None:
        self.commands.append(CancelTimer(timer))

    def append(self, other: "Out") -> None:
        self.commands.extend(other.commands)
        other.commands = []

    def __iter__(self):
        return iter(self.commands)

    def __len__(self) -> int:
        return len(self.commands)

    def __repr__(self) -> str:
        return repr(self.commands)


class StateRef:
    """Mutable-reference wrapper handed to ``on_msg``/``on_timeout``.

    The Python rendering of the reference's ``Cow<State>`` (actor.rs:311):
    ``get()`` reads the current state; ``set(new)`` replaces it and marks the
    handler as having written (even if the value is equal — matching
    ``Cow::Owned`` semantics).  Handlers that never ``set`` and emit no
    commands are no-ops, and the corresponding action is ignored by the
    model (model.rs:286-289).
    """

    __slots__ = ("_value", "changed")

    def __init__(self, value: Any):
        self._value = value
        self.changed = False

    def get(self) -> Any:
        return self._value

    def set(self, value: Any) -> None:
        self._value = value
        self.changed = True


def is_no_op(state: StateRef, out: Out) -> bool:
    """True iff the handler neither updated state nor emitted commands
    (actor.rs:247-249)."""
    return not state.changed and not out.commands


def is_no_op_with_timer(state: StateRef, out: Out, timer: Any) -> bool:
    """Like :func:`is_no_op` but tolerates re-setting the same timer
    (actor.rs:254-264)."""
    keep_timer = any(
        isinstance(c, SetTimer) and c.timer == timer for c in out.commands
    )
    return not state.changed and len(out.commands) == 1 and keep_timer


class Actor:
    """An event-driven actor (actor.rs:270-337).

    Subclasses implement ``on_start`` and optionally ``on_msg``/``on_timeout``.
    States should be immutable values (tuples/frozen dataclasses): handlers
    replace them via ``state.set(...)`` rather than mutating in place.
    """

    def on_start(self, id: Id, out: Out) -> Any:
        """Returns the initial state, optionally emitting commands."""
        raise NotImplementedError

    def on_msg(self, id: Id, state: StateRef, src: Id, msg: Any, out: Out) -> None:
        """Handles a received message. Default: no-op."""

    def on_timeout(self, id: Id, state: StateRef, timer: Any, out: Out) -> None:
        """Handles a timer firing. Default: no-op."""

    @property
    def name(self) -> str:
        return type(self).__name__


from .model import (  # noqa: E402  (re-exports, mirroring actor.rs:99-106)
    ActorModel,
    ActorModelAction,
    DeliverAction,
    DropAction,
    TimeoutAction,
)
from .model_state import ActorModelState  # noqa: E402

__all__ = [
    "Actor",
    "ActorModel",
    "ActorModelAction",
    "ActorModelState",
    "CancelTimer",
    "DeliverAction",
    "DropAction",
    "Envelope",
    "Id",
    "Network",
    "Out",
    "Send",
    "SetTimer",
    "StateRef",
    "TimeoutAction",
    "Timers",
    "is_no_op",
    "is_no_op_with_timer",
    "majority",
    "model_peers",
    "model_timeout",
]
