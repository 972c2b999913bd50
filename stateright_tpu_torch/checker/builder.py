"""CheckerBuilder: fluent checker configuration.

Counterpart of ``stateright_tpu/checker/builder.py`` (stateright's
``src/checker.rs:52-248``). The strategies are the host engines
``spawn_bfs``/``spawn_dfs`` (with ``threads(n)`` their parallel forms) and
``spawn_xla()``, the GPU frontier-expansion engine. The reference's
``spawn_on_demand`` and ``serve`` wait for the port of on-demand checking and
the Explorer (ROADMAP A10).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..core import Model
from .base import Checker
from .visitor import as_visitor


class CheckerBuilder:
    """Instantiate via ``model.checker()`` (lib.rs:247)."""

    def __init__(self, model: Model):
        self._model = model
        self._symmetry: Optional[Callable[[Any], Any]] = None
        self._target_state_count: Optional[int] = None
        self._target_max_depth: Optional[int] = None
        self._thread_count: int = 1
        self._visitor = None

    # --- terminal strategies ---------------------------------------------

    def spawn_bfs(self) -> Checker:
        """Breadth-first search; shortest witness paths (checker.rs:155).

        With ``threads(n)`` for n > 1 (and no visitor), a level-synchronous
        multiprocess engine expands the frontier across n forked workers
        with fingerprint-sharded visited sets
        (``stateright_tpu_torch.checker.parallel_host``) — the host analogue
        of stateright's worker pool (bfs.rs:89-211)."""
        if (self._thread_count or 1) > 1 and self._visitor is None:
            from .parallel_host import ParallelBfsChecker

            return ParallelBfsChecker(self)
        from .search import BfsChecker

        return BfsChecker(self)

    def spawn_dfs(self) -> Checker:
        """Depth-first search; smaller frontier (checker.rs:187). With
        ``threads(n)`` for n > 1 (and no visitor — visitors observe
        per-state paths sequentially, so they fall back to the sequential
        engine exactly as ``spawn_bfs`` does), the job-market parallel
        DFS — stateright's default CLI discipline (dfs.rs:42, 92-215)."""
        if (self._thread_count or 1) > 1 and self._visitor is None:
            from .parallel_dfs import ParallelDfsChecker

            return ParallelDfsChecker(self)
        from .search import DfsChecker

        return DfsChecker(self)

    def spawn_xla(self, **kwargs) -> Checker:
        """Level-synchronous BFS with the whole frontier expanded per step
        on the device (``stateright_tpu_torch.xla.XlaChecker``). Keyword
        arguments go to it: ``device`` (CUDA unless ``"cpu"``),
        ``frontier_capacity``, ``table_capacity``, ``levels_per_dispatch``
        (32; a visitor forces 1), ``shrink_exit`` ("auto"), ``cand_ladder``
        ("auto" = 3 rungs, or 1..3), ``host_verified_cap`` (128 candidate
        rows a level for each host-verified property), ``visit_cap`` (4096
        visited states a level), ``checkpoint`` (resume from a file of
        either package), ``checkpoint_to``/``checkpoint_every``/
        ``checkpoint_keep`` (auto-checkpointing) and ``symmetry`` ("auto",
        the default, honours ``symmetry()``; "on" or "off" force it; the
        ``STPU_SYMMETRY`` environment variable when not given), ``dedup``
        (the visited set: "auto", the default, is "sorted" on every device;
        "hash" is open addressing on the CUDA kernel ``csrc/hashset.cu``,
        with the one-rung block; "delta" is a sorted main tier with a delta
        tier a sixteenth its size, flushed between blocks) and
        ``max_probes`` (32: the hash set's probe budget before a level
        grows the table and runs again). Under symmetry the engine
        canonicalizes through the model's ``symmetry_spec`` or
        ``packed_representative``, and raises ``SymmetryUnsupported`` for
        a model with neither."""
        from ..xla import XlaChecker

        return XlaChecker(self, **kwargs)

    # --- configuration ----------------------------------------------------

    def symmetry(self) -> "CheckerBuilder":
        """Enables symmetry reduction; states must define
        ``representative()`` (checker.rs:198-203)."""
        return self.symmetry_fn(lambda s: s.representative())

    def symmetry_fn(self, representative: Callable[[Any], Any]) -> "CheckerBuilder":
        self._symmetry = representative
        return self

    def target_state_count(self, count: int) -> "CheckerBuilder":
        """The checker may exceed this count but never stops short of it
        while more states exist (checker.rs:215-222)."""
        self._target_state_count = count if count > 0 else None
        return self

    def target_max_depth(self, depth: int) -> "CheckerBuilder":
        self._target_max_depth = depth if depth > 0 else None
        return self

    def threads(self, thread_count: int) -> "CheckerBuilder":
        """Worker count for the host engines (checker.rs:234). With n > 1,
        ``spawn_bfs`` runs the multiprocess level-synchronous engine
        (``parallel_host``) and ``spawn_dfs`` the job-market parallel DFS
        (``parallel_dfs``); with a visitor both fall back to their
        sequential engines. ``spawn_xla`` ignores it: the GPU engine uses
        the whole card."""
        self._thread_count = thread_count
        return self

    def visitor(self, visitor) -> "CheckerBuilder":
        """A function (or CheckerVisitor) applied to every evaluated path
        (checker.rs:242-247)."""
        self._visitor = as_visitor(visitor)
        return self
