"""System-state snapshot for actor models.

The port's own copy of ``stateright_tpu/actor/model_state.py``
(stateright's ``src/actor/model_state.rs``): per-actor states, the network,
per-actor pending-timer sets, and the auxiliary history. States are
immutable values; the model builds new snapshots rather than mutating. The
symmetry representative (``representative``) waits for the symmetry slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

from .network import Network
from .timers import Timers


@dataclass(frozen=True)
class ActorModelState:
    actor_states: Tuple[Any, ...]
    network: Network
    timers_set: Tuple[Timers, ...]
    history: Any = ()

    def __repr__(self) -> str:
        return (
            f"ActorModelState(actor_states={self.actor_states!r}, "
            f"network={self.network!r}, timers={self.timers_set!r}, "
            f"history={self.history!r})"
        )
