"""CheckerBuilder: fluent checker configuration.

Counterpart of ``stateright_tpu/checker/builder.py`` (stateright's
``src/checker.rs:52-248``). This slice of the port has one strategy,
``spawn_xla()``, the GPU frontier-expansion engine; the host strategies
(``spawn_bfs``/``spawn_dfs``) come with a later slice.
"""

from __future__ import annotations

from typing import Optional

from ..core import Model
from .base import Checker


class CheckerBuilder:
    """Instantiate via ``model.checker()`` (lib.rs:247)."""

    def __init__(self, model: Model):
        self._model = model
        self._target_state_count: Optional[int] = None
        self._target_max_depth: Optional[int] = None

    def spawn_xla(self, **kwargs) -> Checker:
        """Level-synchronous BFS with the whole frontier expanded per step
        on the device (``stateright_tpu_torch.xla.XlaChecker``). Keyword
        arguments go to it: ``device`` (CUDA unless ``"cpu"``),
        ``frontier_capacity``, ``table_capacity``, ``levels_per_dispatch``
        (32), ``shrink_exit`` ("auto"), ``cand_ladder`` ("auto" = 3 rungs,
        or 1..3), ``host_verified_cap`` (128 candidate rows a level for each
        host-verified property) and ``checkpoint``."""
        from ..xla import XlaChecker

        return XlaChecker(self, **kwargs)

    # --- configuration ----------------------------------------------------

    def target_state_count(self, count: int) -> "CheckerBuilder":
        """The checker may exceed this count but never stops short of it
        while more states exist (checker.rs:215-222)."""
        self._target_state_count = count if count > 0 else None
        return self

    def target_max_depth(self, depth: int) -> "CheckerBuilder":
        self._target_max_depth = depth if depth > 0 else None
        return self
