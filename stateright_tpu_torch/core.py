"""Core model abstraction: ``Model``, ``Property``, ``Expectation``.

The port's own copy of ``stateright_tpu/core.py`` (stateright's central
trait, ``src/lib.rs:155-325``).  A ``Model`` describes a nondeterministic
transition system: initial states, the actions enabled in a state, and a
(partial) transition function.  Checkers search the induced state graph for
property violations.

Models checked on the GPU additionally implement the PackedModel protocol
(see ``stateright_tpu_torch/xla.py``), which exposes the same transition
system as batched tensor functions over bit-packed state words.  The
object-level API here is the semantic contract, and witness paths are
re-executed through it.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, List, Optional, Tuple


class Expectation(Enum):
    """Whether a property must hold always, eventually, or sometimes.

    Mirrors lib.rs:318-325.
    """

    ALWAYS = "always"
    EVENTUALLY = "eventually"
    SOMETIMES = "sometimes"


@dataclass(frozen=True)
class Property:
    """A named predicate over (model, state). Mirrors lib.rs:261-305.

    - ``always``: safety; the checker seeks a counterexample.
    - ``sometimes``: reachability; the checker seeks an example.
    - ``eventually``: liveness (terminal-state based; only correct on acyclic
      paths — the checker replicates the reference's documented false-negative
      semantics for cycles/DAG joins, lib.rs:283-287).
    """

    expectation: Expectation
    name: str
    condition: Callable[[Any, Any], bool]

    @staticmethod
    def always(name: str, condition: Callable[[Any, Any], bool]) -> "Property":
        return Property(Expectation.ALWAYS, name, condition)

    @staticmethod
    def eventually(name: str, condition: Callable[[Any, Any], bool]) -> "Property":
        return Property(Expectation.EVENTUALLY, name, condition)

    @staticmethod
    def sometimes(name: str, condition: Callable[[Any, Any], bool]) -> "Property":
        return Property(Expectation.SOMETIMES, name, condition)


class Model:
    """The primary abstraction: a nondeterministic transition system.

    Mirrors the reference's ``Model`` trait (lib.rs:155-254).  Subclasses
    implement ``init_states``, ``actions``, and ``next_state``; everything
    else has default implementations.
    """

    def init_states(self) -> List[Any]:
        """Returns the initial possible states."""
        raise NotImplementedError

    def actions(self, state: Any, actions: List[Any]) -> None:
        """Appends the actions possible from ``state`` to ``actions``."""
        raise NotImplementedError

    def next_state(self, last_state: Any, action: Any) -> Optional[Any]:
        """Applies ``action``; ``None`` indicates the action is a no-op."""
        raise NotImplementedError

    def format_action(self, action: Any) -> str:
        """Intuitive representation of an action (e.g. for the Explorer)."""
        return repr(action)

    def format_step(self, last_state: Any, action: Any) -> Optional[str]:
        """Intuitive representation of a step (e.g. for the Explorer)."""
        next_state = self.next_state(last_state, action)
        return None if next_state is None else repr(next_state)

    def as_svg(self, path: Any) -> Optional[str]:
        """An SVG representation of a path for this model (Explorer pane)."""
        return None

    def next_steps(self, last_state: Any) -> List[Tuple[Any, Any]]:
        """The (action, state) steps that follow ``last_state``.

        Mirrors lib.rs:196-210.
        """
        actions: List[Any] = []
        self.actions(last_state, actions)
        steps = []
        for action in actions:
            state = self.next_state(last_state, action)
            if state is not None:
                steps.append((action, state))
        return steps

    def next_states(self, last_state: Any) -> List[Any]:
        """The states that follow ``last_state``. Mirrors lib.rs:214-221."""
        actions: List[Any] = []
        self.actions(last_state, actions)
        states = []
        for action in actions:
            state = self.next_state(last_state, action)
            if state is not None:
                states.append(state)
        return states

    def properties(self) -> List[Property]:
        """The expected properties for this model."""
        return []

    def property(self, name: str) -> Property:
        """Looks up a property by name; raises if absent (lib.rs:229-239)."""
        for p in self.properties():
            if p.name == name:
                return p
        available = [p.name for p in self.properties()]
        raise KeyError(f"Unknown property. requested={name}, available={available}")

    def within_boundary(self, state: Any) -> bool:
        """Whether ``state`` is inside the checked state space."""
        return True

    def checker(self) -> "CheckerBuilder":
        """Instantiates a CheckerBuilder for this model (lib.rs:247-253)."""
        from .checker.builder import CheckerBuilder

        return CheckerBuilder(self)
