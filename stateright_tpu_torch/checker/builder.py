"""CheckerBuilder: fluent checker configuration.

Counterpart of ``stateright_tpu/checker/builder.py`` (stateright's
``src/checker.rs:52-248``). The strategies are the host engines
``spawn_bfs``/``spawn_dfs`` (with ``threads(n)`` their parallel forms) and
``spawn_xla()``, the GPU frontier-expansion engine, with the demand-driven
``spawn_on_demand`` (host or GPU engine) and ``serve``, the Explorer.
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

    def spawn_on_demand(self, engine: str = "host", **spawn_kwargs) -> Checker:
        """Demand-driven search: computes nothing until asked
        (checker.rs:171). ``engine="xla"`` runs it on the GPU engine (packed
        models; ``spawn_kwargs`` go to ``spawn_xla``, ``device`` included):
        a ``check_states`` click runs one superstep over the clicked rows
        and ``run_to_completion()`` hands over to the fused block. The host
        engine takes ``block_size`` (default 1): at stateright's 1500 a
        ``check_fingerprint`` pre-computes up to that many states of the
        clicked subtree (on_demand.rs:209-218)."""
        if engine == "xla":
            from .device_on_demand import DeviceOnDemandChecker

            return DeviceOnDemandChecker(self, **spawn_kwargs)
        if engine != "host":
            raise ValueError(f"engine must be 'host' or 'xla': {engine!r}")
        unknown = set(spawn_kwargs) - {"block_size"}
        if unknown:
            raise TypeError(f"spawn kwargs {sorted(unknown)} only apply to engine=\"xla\"")
        from .on_demand import OnDemandChecker

        return OnDemandChecker(self, **spawn_kwargs)

    def serve(self, addresses, engine: str = "auto", **spawn_kwargs) -> Checker:
        """Starts the Explorer web service and blocks until it is stopped
        (checker.rs:137; ``checker/explorer.py``). A packed model is
        explored on the GPU engine by default (``engine="auto"``; ``device``
        and the other ``spawn_xla`` arguments ride in ``spawn_kwargs``);
        ``engine="host"`` forces the host engine. Returns the checker."""
        from .explorer import serve

        return serve(self, addresses, engine=engine, **spawn_kwargs)

    def spawn_xla(self, *, mesh=None, **kwargs) -> Checker:
        """Level-synchronous BFS with the whole frontier expanded per step
        on the device (``stateright_tpu_torch.xla.XlaChecker``).

        With ``mesh`` (``stateright_tpu_torch.parallel.default_mesh(D)``: D
        shards on one device, or, under ``parallel.distributed.initialize``,
        D shards over the ranks of a process group, each rank's on its own
        device) of more than one shard, the frontier and the visited set
        shard by fingerprint ownership and each level routes every
        candidate to its owner (``parallel.ShardedXlaChecker``). It
        takes ``frontier_capacity``, ``table_capacity`` (over all shards),
        ``route_capacity`` (slots a source and destination shard; by
        default four times a shard's grid over D), ``levels_per_dispatch``,
        ``dedup``, ``max_probes``, ``symmetry``, ``host_verified_cap``,
        ``visit_cap``, the checkpoint and the observability keywords below;
        the single-chip tuning knobs do not apply there. A ``device`` must
        be the mesh's (on a rank mesh, this rank's). A one-shard mesh runs
        the single-chip engine on the mesh's device (``route_capacity``
        ignored).

        Keyword arguments go to ``XlaChecker``: ``device`` (CUDA unless ``"cpu"``),
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
        a model with neither.

        ``compaction`` ("auto" or "pallas", both the CUDA kernel
        ``csrc/compact.cu``, on every device and under every visited set;
        the reference's "gather", "sort" and "bsearch" raise: they are
        functions in ``ops/compact.py``, timed beside the kernel, and not
        engine options, ROADMAP A11) and ``ladder`` ("auto" =
        ``STPU_LADDER`` or "jump", which extrapolates the frontier's growth past bucket rungs; "ramp"
        steps one rung per frontier overflow). Observability, off by
        default and never inside a captured graph (``obs/``): ``trace``
        (a span JSONL path or a ``Tracer``; env ``STPU_TRACE``, and
        ``STPU_TRACE_CHROME`` exports Chrome trace JSON at exit),
        ``heartbeat`` (a JSON file rewritten around every dispatch; env
        ``STPU_HEARTBEAT``), ``metrics_to``/``metrics_every``/
        ``metrics_keep`` (rotating rows of ``metrics()`` at block
        boundaries; env ``STPU_METRICS_TO``/``_EVERY``/``_KEEP``) and
        ``phases`` (env ``STPU_PHASES``; needs a live tracer: each dispatch
        split into ``host_prep``, ``enqueue``, ``device_compute`` and
        ``readback`` sub-spans and a ``checker.phase_log`` row)."""
        from ..xla import XlaChecker

        if mesh is not None:
            import torch

            from ..parallel import ShardedXlaChecker, mesh_device

            dev = mesh_device(mesh)
            want = kwargs.pop("device", None)
            if want is not None and torch.device(want) not in (dev, torch.device(dev.type, 0)):
                raise ValueError(f"device={want!r} is not the mesh's device {dev}")
            if mesh.devices.size > 1 or getattr(mesh, "ranks", None) is not None:
                return ShardedXlaChecker(self, mesh, **kwargs)
            kwargs["device"] = dev
        kwargs.pop("route_capacity", None)  # the sharded engine's knob
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
