"""The fused level loop's device programs: CUDA graphs of the gated level.

Counterpart of the fused-dispatch program cache of
``stateright_tpu/xla.py``: ``_fused_key``/``_fused_for`` (one program per
shape key), the cache on the model instance (``_xla_superstep_cache``),
``_mark_dispatch_shape`` and ``_compiled_run_caps``. The reference compiles
its whole level loop into one ``lax.while_loop`` whose body picks one of up
to three candidate rungs with ``lax.switch``. Here the loop body, one BFS
level gated on the device (``XlaChecker._gated_level``) at one rung, is
captured once per shape key as a CUDA graph, and a block replays one rung's
graph per level (:func:`replay_block`), the host choosing the rung from the
last level's counts, with one host round trip per level already paid for
the gate.

- A :class:`Carry` holds the static device buffers the gated level reads and
  updates in place: the frontier and its eventually-bits per run bucket,
  the visited set's planes (those of its ``dedup`` structure: four for the
  sorted set, three for the hash set, nine for the delta set; its counts
  are block scalars), the discoveries, the host-verified candidates of
  the block, the block scalars (:data:`SLOTS`) and the per-level telemetry.
  Every graph of a model at one table capacity and structure shares one
  carry: the graphs never run at the same time, and a checker loads its
  state into the carry at a block's start and clones what it keeps at the
  block's end.
- A :class:`Program` is one shape key ``(run_cap, rows, cand_cap,
  table_capacity, levels_per_dispatch, hv_cap, dedup, max_probes,
  sym_tag)``: the gated level of bucket ``run_cap`` run on its first
  ``rows`` frontier rows at candidate cap ``cand_cap`` (a rung of the
  candidate ladder; ``rows == run_cap`` is the full rung), inserting into
  the visited-set structure ``dedup`` (probing at most ``max_probes`` slots
  in the hash set) and canonicalizing its dedup keys under the symmetry
  ``sym_tag`` (None: none), as the reference keys its programs on
  ``_dedup``, ``_max_probes`` and ``_sym_tag``. It holds its graph on a
  card, or nothing on the CPU, where the checker runs the same gated level
  eagerly.
- A :class:`ProgramCache` per model and device holds the carries, the
  programs (every rung of each bucket a block ran at), and the graph
  memory pool that all of a model's graphs at one table capacity share
  (their intermediates are dead when a replay ends, and no two replays run
  at once); a table growth frees it and starts another.

Graph replays run no Python, so the kernels' launch counters would stop
counting: each program records how many launches of each kernel its graph
holds, and :meth:`Program.run` adds them per replay.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .ops import deltaset, hashset, sortedset
from .ops.compact import compact
from .ops.merge import merge_insert
from .ops.words import DTYPE

#: Levels in flight on the card during a block: before enqueuing level
#: ``i + LOOKAHEAD`` the host waits for level ``i`` to end and reads its
#: live flag. A deeper queue keeps the card busy across the host's round
#: trip but runs up to ``LOOKAHEAD - 1`` dead levels at the block's end,
#: and a dead level costs a whole superstep: its gate discards the work,
#: it does not skip it. ``chip_smoke.py``'s ``lookahead_sweep`` chose 1
#: (PERF.md). With the candidate ladder, a level's rung is chosen from its
#: predecessor's scalars, which the host has read only when ``LOOKAHEAD`` is
#: 1; past 1, every level queued before its predecessor's scalars are read
#: runs the full rung (:func:`replay_block`).
LOOKAHEAD = 1

#: The block scalars, slots of the carry's int64 vector ``s``: block inputs
#: the host writes (budget, remaining, shrink_below), the level counters,
#: the overflow flags of the last live level (table, frontier, the model's
#: codec, candidate), the visited set's counts (:data:`COUNT_SLOTS`),
#: ``live``, the gate of the next level, ``force_full``, set when a snug
#: rung's candidate buffer overflowed so that the same frontier re-runs at
#: full width, and ``retries``, the block's count of such fall-throughs.
SLOTS = (
    "committed", "f_count", "tot_states", "tot_unique", "prev_gen",
    "prev2_gen", "t_ovf", "f_ovf", "c_ovf", "cc_ovf", "table_n", "delta_n", "live",
    "budget", "remaining", "shrink_below", "force_full", "retries",
)
S = {name: i for i, name in enumerate(SLOTS)}
#: The overflow flags, as a slice of ``s``.
OVF = slice(S["t_ovf"], S["cc_ovf"] + 1)
#: Rows of the per-level telemetry ``lvl``: frontier, generated, unique,
#: and the rung the level ran at (its frontier rows and candidate cap).
LVL_ROWS = 5

#: A capture first empties the allocator's cache when the warm-up left more
#: than this fraction of the card's memory cached and unused.
IDLE_CACHE_DEN = 8

#: The kernel wrappers whose launches a graph can hold.
KERNELS = (compact, merge_insert, hashset.insert_, hashset.undo_)

#: The visited-set structures by ``spawn_xla(dedup=)`` name. Each one's
#: NamedTuple holds ``PLANES`` tensors, then its counts.
STRUCTURES = {"sorted": sortedset, "hash": hashset, "delta": deltaset}
#: The block scalars that hold a structure's counts, in its order: the
#: sorted set's ``n``, the delta set's ``n_main`` and ``n_delta``.
COUNT_SLOTS = ("table_n", "delta_n")


class Carry:
    """The static buffers of the gated level at one table capacity of one
    visited-set structure (``dedup``). The block's host-verified candidates
    of ``n_hv`` properties take ``hv_cap`` rows each: state words,
    fingerprint and the count flagged."""

    def __init__(self, device, words: int, n_props: int, levels: int, table_capacity: int,
                 n_hv: int = 0, hv_cap: int = 0, dedup: str = "sorted"):
        z = dict(dtype=DTYPE, device=device)
        self.words = words
        self.s = torch.zeros(len(SLOTS), **z)
        empty = STRUCTURES[dedup].make(table_capacity, device)
        self.table = list(empty[:empty.PLANES])
        self.disc_found = torch.zeros(n_props, dtype=torch.bool, device=device)
        self.disc_fp = torch.zeros((n_props, 2), **z)
        self.host_found = torch.zeros(n_props, dtype=torch.bool, device=device)
        self.lvl = torch.zeros((LVL_ROWS, levels), **z)
        self.slots = torch.arange(levels, device=device)
        self.hv_w = torch.zeros((n_hv, hv_cap, words), **z)
        self.hv_f = torch.zeros((n_hv, hv_cap, 2), **z)
        self.hv_c = torch.zeros(n_hv, **z)
        self._frontiers: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    def frontier(self, run_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ``[run_cap, W]`` frontier and its ``[run_cap]`` eventually-bits."""
        if run_cap not in self._frontiers:
            dev = self.s.device
            self._frontiers[run_cap] = (
                torch.zeros((run_cap, self.words), dtype=DTYPE, device=dev),
                torch.zeros(run_cap, dtype=DTYPE, device=dev),
            )
        return self._frontiers[run_cap]

    def tensors(self) -> List[torch.Tensor]:
        """Every buffer, in a fixed order (for bitwise comparisons)."""
        out = [self.s, *self.table, self.disc_found, self.disc_fp, self.host_found, self.lvl,
               self.hv_w, self.hv_f, self.hv_c]
        for run_cap in sorted(self._frontiers):
            out.extend(self._frontiers[run_cap])
        return out


class Program:
    """One shape key's level: a captured graph, or None to run eagerly."""

    def __init__(self, carry: Carry, graph=None, launches=()):
        self.carry = carry
        self.graph = graph
        #: ``(wrapper, launches per replay)`` of each kernel in the graph.
        self.launches = tuple(launches)

    def run(self, body: Callable[[], None], eager: bool = False) -> None:
        if eager or self.graph is None:
            body()
            return
        self.graph.replay()
        for fn, n in self.launches:
            fn.launches += n


def capture(body: Callable[[], None], pool, side: torch.cuda.Stream) -> Tuple[object, list]:
    """``body`` (one gated level on a dead carry) run once eagerly on the
    side stream, then captured there into a CUDA graph in ``pool``. Returns
    the graph and the launches of each kernel it holds. Raises if the
    capture fails. (``torch.cuda.graph`` would also run the garbage
    collector and empty the allocator's cache around every capture.)"""
    side.wait_stream(torch.cuda.current_stream())
    before = [fn.captured for fn in KERNELS]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        body()
        # The capture allocates from the graph pool, which cannot reuse the
        # blocks the warm-up left cached in the default pool: where those
        # are a large share of the card (a wide model's level), hand them
        # back first.
        idle = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
        if idle > torch.cuda.get_device_properties(side.device).total_memory // IDLE_CACHE_DEN:
            side.synchronize()
            torch.cuda.empty_cache()
        graph.capture_begin(pool=pool)
        try:
            body()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    return graph, [(fn, fn.captured - b) for fn, b in zip(KERNELS, before)]


class ProgramCache:
    """A model's programs and carries on one device."""

    def __init__(self, device: torch.device):
        self.device = device
        cuda = device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        #: The stream that warm-ups and captures run on.
        self.side = torch.cuda.Stream(device) if cuda else None
        #: ``(table_capacity, levels_per_dispatch, hv_cap, dedup)`` -> Carry.
        self.carries: Dict[Tuple[int, int, int, str], Carry] = {}
        #: ``(run_cap, rows, cand_cap, table_capacity, levels_per_dispatch,
        #: hv_cap, dedup, max_probes, sym_tag)`` -> Program.
        self.programs: Dict[Tuple[int, ...], Program] = {}

    def carry(self, words: int, n_props: int, table_capacity: int, levels: int,
              n_hv: int = 0, hv_cap: int = 0, dedup: str = "sorted") -> Carry:
        key = (table_capacity, levels, hv_cap, dedup)
        if key not in self.carries:
            self.carries[key] = Carry(self.device, words, n_props, levels, table_capacity,
                                      n_hv, hv_cap, dedup)
        return self.carries[key]

    def make(self, key, carry: Carry, body: Callable[[], None], graph: bool) -> Program:
        """The program of ``key``; with ``graph``, ``body`` is captured, after
        the carry's budget is zeroed so that the warm-up level is dead."""
        if graph:
            carry.s[S["budget"]] = 0
            prog = Program(carry, *capture(body, self.pool, self.side))
        else:
            prog = Program(carry)
        self.programs[key] = prog
        return prog

    def drop(self, shape: Tuple[int, int, int, str]) -> None:
        """Forget the carry of ``shape`` = ``(table_capacity,
        levels_per_dispatch, hv_cap, dedup)`` and every program on it, of
        every symmetry tag and probe budget: those of another tag than the
        grown checker's are made anew when a check of that tag needs them.
        On a card, the
        memory of the dropped graphs and carry is handed back before the
        programs at the grown capacity are made (a wide model's largest
        bucket could not hold two levels' worth at once), and later
        captures go to a new pool: a pool whose graphs are all gone is
        freed with them and cannot take another capture."""
        for key in [k for k in self.programs if k[3:7] == shape]:
            del self.programs[key]
        self.carries.pop(shape, None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            self.pool = torch.cuda.graph_pool_handle()


def graph_inputs(model) -> dict:
    """Tensors that the model instance's graphs read outside their carries
    (the symmetry canonicalization's index tables), kept as long as its
    program caches: a graph holds the addresses of what it reads."""
    return model.__dict__.setdefault("_xla_graph_inputs", {})


def cache_for(model, device: torch.device) -> ProgramCache:
    """The model instance's program cache on ``device`` (made on first use)."""
    caches = model.__dict__.setdefault("_xla_programs", {})
    if str(device) not in caches:
        caches[str(device)] = ProgramCache(device)
    return caches[str(device)]


def replay_block(run_level: Callable[[Optional[np.ndarray]], None], s: torch.Tensor,
                 loaded: np.ndarray, budget: int) -> int:
    """Run the gated levels of a block: up to ``budget`` committed levels,
    plus one replay for each candidate-ladder fall-through (a forced
    full-width level either commits or exits, so there are at most
    ``2 * budget`` replays). ``s`` is the carry's block scalars, which each
    level updates; ``loaded`` is the host's copy of them as loaded.
    ``run_level(row)`` enqueues one level given the block scalars its
    predecessor left (``loaded`` for the first), or None when they were not
    read yet. Returns how many dead levels ran: a dead level ran with its
    gate closed and changed nothing.

    On the CPU each level's scalars are read right after it (and, as on a
    card, given to the next level only when ``LOOKAHEAD`` is 1). On a card the
    levels are enqueued ``LOOKAHEAD`` ahead: after each, an async copy of
    ``s`` into pinned memory and an event; before level ``i + LOOKAHEAD``
    the host waits on level ``i``'s event and stops once its ``live`` reads
    false. With ``LOOKAHEAD`` 1 that wait is on the predecessor, so every
    level is given its predecessor's scalars and no synchronisation is
    added for the choice of rung."""
    live = S["live"]
    limit = 2 * budget
    if s.device.type == "cpu":
        row = loaded
        for _ in range(limit):
            run_level(row)
            if not s[live]:
                break
            row = s.numpy().copy() if LOOKAHEAD == 1 else None
        return 0
    rows = torch.empty((limit, len(SLOTS)), dtype=DTYPE, pin_memory=True)
    host = rows.numpy()
    stream = torch.cuda.current_stream()
    events: List[torch.cuda.Event] = []
    for n in range(limit):
        if n >= LOOKAHEAD:
            events[n - LOOKAHEAD].synchronize()
            if not host[n - LOOKAHEAD][live]:
                break
        if n == 0:
            run_level(loaded)
        else:
            run_level(host[n - 1] if LOOKAHEAD == 1 else None)
        rows[n].copy_(s, non_blocking=True)
        events.append(stream.record_event())
    stream.synchronize()
    ran = len(events)
    live_levels = next((i + 1 for i in range(ran) if not host[i][live]), ran)
    return ran - live_levels
