"""System-state snapshot for actor models.

The port's own copy of ``stateright_tpu/actor/model_state.py``
(stateright's ``src/actor/model_state.rs``): per-actor states, the network,
per-actor pending-timer sets, and the auxiliary history. States are
immutable values; the model builds new snapshots rather than mutating.
``representative`` is the canonical member of a state's symmetry class, for
the host engines' ``symmetry()``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

from ..utils.rewrite_plan import RewritePlan, rewrite
from .network import Network
from .timers import Timers


@dataclass(frozen=True)
class ActorModelState:
    actor_states: Tuple[Any, ...]
    network: Network
    timers_set: Tuple[Timers, ...]
    history: Any = ()

    def representative(self) -> "ActorModelState":
        """Canonical member of this state's symmetry equivalence class:
        actors sorted by state, with the network, timers, and history
        rewritten through the same permutation (model_state.rs:113-129)."""
        plan = RewritePlan.from_values_to_sort(self.actor_states)
        return ActorModelState(
            actor_states=tuple(plan.reindex(self.actor_states)),
            network=rewrite(self.network, plan),
            timers_set=tuple(plan.reindex(self.timers_set)),
            history=rewrite(self.history, plan),
        )

    def __repr__(self) -> str:
        return (
            f"ActorModelState(actor_states={self.actor_states!r}, "
            f"network={self.network!r}, timers={self.timers_set!r}, "
            f"history={self.history!r})"
        )
