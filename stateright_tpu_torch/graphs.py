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
  programs (every rung of each bucket a block ran at), and the memory pool
  (``torch.cuda.MemPool``) that every live graph of the model instance
  allocates from, of every table capacity and visited-set structure, with
  the warm-up level of each capture: blocks that one capture or warm-up
  freed are reused by the next, so a second graph set of the instance
  (another structure) needs no second copy of the widest level's
  intermediates. A table growth that leaves the cache no graph hands the
  pool's memory back and starts another pool; one that leaves another
  structure's graphs keeps the pool, whose blocks only later captures can
  reuse (the grown carry is allocated outside it). What keeps two graphs
  of the pool apart is order: a graph's intermediates are dead when its
  replay ends, every replay runs on the current stream, a warm-up and
  capture run on the side stream after everything queued there and before
  anything queued after, and one thread at a time drives the card for an
  instance (a capture fails while another thread launches work; the
  Explorer holds a lock around each checker call).

The multiplexed engine (``xla_mux.py``) keeps its own entries in the same
cache: a :class:`MuxCarry` (one carry a lane and the mux's block scalars)
per lane count and shape, and one program per :func:`mux_key`, whose graph
holds every lane's gated level; a table growth drops them with the solo
programs of the old capacity. The sharded engine (``parallel/sharded.py``)
keeps a :class:`ShardCarry` (every shard's buffers, the shard axis first)
per :func:`shard_shape` and one program per :func:`shard_key`, whose graph
holds every shard's level; a growth of its table or frontier drops the
carry of the old shape and every program on it (:meth:`ProgramCache.drop_shard`).
On a rank of a mesh over several processes the carry holds this rank's
shards and the level is three segments with a collective between each two
(the route exchange, then the packed reduction): a :class:`RankProgram`
captures each segment as a graph of its own and runs the collectives
between the replays, since a gloo collective cannot sit inside a graph.

Graph replays run no Python, so the kernels' launch counters would stop
counting: each program records how many launches of each kernel its graph
holds, and :meth:`Program.run` adds them per replay.
"""

from __future__ import annotations

import time
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

#: A capture first empties the allocator's cache when more than this
#: fraction of the card's memory lies cached and unused outside its pool.
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


class MuxCarry:
    """The static buffers of the multiplexed level (``xla_mux.py``) of ``k``
    lanes at one table capacity of one visited-set structure: one
    :class:`Carry` a lane, and the mux's own block scalars ``s`` in the
    :data:`SLOTS` layout, of which it uses ``committed`` (levels any lane
    committed), ``live`` (the gate of the next level), the overflow flags
    (ORed over the lanes a level ran) and ``budget``."""

    def __init__(self, device, words: int, n_props: int, levels: int, table_capacity: int,
                 k: int, dedup: str = "sorted"):
        self.lanes = [Carry(device, words, n_props, levels, table_capacity, dedup=dedup)
                      for _ in range(k)]
        self.s = torch.zeros(len(SLOTS), dtype=DTYPE, device=device)

    def frontier(self, run_cap: int) -> None:
        """Allocate every lane's ``[run_cap, W]`` frontier (before a capture)."""
        for c in self.lanes:
            c.frontier(run_cap)


class ShardCarry:
    """The static buffers of the sharded level (``parallel/sharded.py``) of
    ``shards`` fingerprint-owned shards on one device, the shard axis
    first: each shard's ``[rows, W]`` frontier, its eventually-bits and its
    count; each visited-set plane of the ``dedup`` structure stacked over
    the shards (``table[j][d]`` is shard d's plane j) and their counts
    ``table_n`` ``[shards, 2]`` (:data:`COUNT_SLOTS`' order); the
    discoveries; each shard's block of host-verified candidates
    (``[n_hv, shards, hv_cap, ...]``, the counts ``[n_hv, shards]``); the
    block scalars ``s`` in the :data:`SLOTS` layout, whose ``cc_ovf`` slot
    holds the route overflow (the mesh has no candidate buffer that
    overflows) and whose ``f_count`` is the total over the shards; and
    the per-level telemetry ``lvl`` (total frontier, generated, unique).

    On a rank of a mesh over ``world`` processes, ``shards`` is this rank's
    count, and the carry also holds the route exchange's buffers of each
    route width (:meth:`route`), the level's packed reduction (``red``,
    ``reduce_width`` words, and every rank's, ``red_all``) and the
    host-verified candidates collected by every rank this block
    (``hv_tot`` ``[n_hv]``), which the gate reads."""

    def __init__(self, device, shards: int, rows: int, words: int, n_props: int, levels: int,
                 table_capacity: int, n_hv: int = 0, hv_cap: int = 0, dedup: str = "sorted",
                 world: int = 1, reduce_width: int = 0):
        z = dict(dtype=DTYPE, device=device)
        self.world = world
        self.words = words
        self._routes: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.red = torch.zeros(reduce_width, **z)
        self.red_all = torch.zeros((world, reduce_width), **z)
        self.hv_tot = torch.zeros(n_hv, **z)
        self.s = torch.zeros(len(SLOTS), **z)
        self.counts = torch.zeros(shards, **z)
        self.frontier = torch.zeros((shards, rows, words), **z)
        self.ebits = torch.zeros((shards, rows), **z)
        empty = STRUCTURES[dedup].make(table_capacity, device)
        self.table = [p.expand(shards, *p.shape).clone() for p in empty[:empty.PLANES]]
        self.table_n = torch.zeros((shards, len(COUNT_SLOTS)), **z)
        self.disc_found = torch.zeros(n_props, dtype=torch.bool, device=device)
        self.disc_fp = torch.zeros((n_props, 2), **z)
        self.host_found = torch.zeros(n_props, dtype=torch.bool, device=device)
        self.lvl = torch.zeros((3, levels), **z)
        self.slots = torch.arange(levels, device=device)
        self.hv_w = torch.zeros((n_hv, shards, hv_cap, words), **z)
        self.hv_f = torch.zeros((n_hv, shards, hv_cap, 2), **z)
        self.hv_c = torch.zeros((n_hv, shards), **z)

    def route(self, slots: int, lanes: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """A rank's route buffers ``(send, recv)`` at ``slots`` slots a
        (source, destination) shard pair, each ``[world, shards, shards,
        lanes, slots]``: ``send[q, j, i]`` is local source shard i's batch
        for shard j of rank q, ``recv[p, j, i]`` the batch of rank p's shard
        i for local shard j."""
        if slots not in self._routes:
            shards = self.counts.shape[0]
            shape = (self.world, shards, shards, lanes, slots)
            self._routes[slots] = (torch.zeros(shape, dtype=DTYPE, device=self.s.device),
                                   torch.zeros(shape, dtype=DTYPE, device=self.s.device))
        return self._routes[slots]


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


class RankProgram:
    """A rank's level of a mesh over several processes: ``segments`` run in
    turn, ``collectives[i]`` after segment i (none after the last). Each
    segment takes a dict it shares with the others (what one segment leaves
    for the next). On a card each segment is a graph of its own
    (:meth:`ProgramCache.make_rank`), the collectives running between the
    replays; on the CPU the segments run eagerly."""

    def __init__(self, carry: ShardCarry, segments, collectives):
        self.carry = carry
        self.segments = list(segments)
        self.collectives = list(collectives)
        #: The captured graphs, one a segment, or None.
        self.graph: Optional[Tuple[object, ...]] = None
        self.launches: Tuple[Tuple[Callable, int], ...] = ()
        #: What the captured segments leave for each other: their outputs'
        #: tensors, which the later graphs read, kept alive with them.
        self.state: dict = {}

    def run(self, eager: bool = False) -> None:
        """One level: every segment and the collectives between them."""
        state = {}
        for i, seg in enumerate(self.segments):
            if eager or self.graph is None:
                seg(state)
            else:
                self.graph[i].replay()
            if i < len(self.collectives):
                self.collectives[i]()
        if not eager and self.graph is not None:
            for fn, n in self.launches:
                fn.launches += n

    def capture(self, pool, side: torch.cuda.Stream) -> None:
        """Capture each segment in turn (:func:`capture`), replaying it
        once after its capture so that what it leaves for the next segment
        is defined before that segment's warm-up reads it; the carry's
        budget is zeroed first, so every warm-up and replay is a dead
        level."""
        self.carry.s[S["budget"]] = 0
        self.carry.s[S["live"]] = 0
        graphs, launches = [], {}
        for seg in self.segments:
            graph, held = capture(lambda seg=seg: seg(self.state), pool, side)
            graph.replay()
            graphs.append(graph)
            for fn, n in held:
                launches[fn] = launches.get(fn, 0) + n
        torch.cuda.current_stream().synchronize()
        self.graph = tuple(graphs)
        self.launches = tuple(launches.items())


def capture(body: Callable[[], None], pool, side: torch.cuda.Stream) -> Tuple[object, list]:
    """``body`` (one gated level on a dead carry) run once eagerly on the
    side stream, then captured there into a CUDA graph; both allocate from
    ``pool`` (a ``torch.cuda.MemPool``), so the capture reuses the blocks
    the warm-up freed, and both reuse those that earlier captures of the
    pool freed. Returns the graph and the launches of each kernel it holds.
    Raises if the capture fails. (``torch.cuda.graph`` would also run the
    garbage collector and empty the allocator's cache around every
    capture.)"""
    # Neither the warm-up nor the capture can take blocks cached outside the
    # pool, and an allocation that fails while they run does not hand those
    # back: where they are a large share of the card, hand them back first.
    idle = releasable_idle(side.device, pool)
    if idle > torch.cuda.get_device_properties(side.device).total_memory // IDLE_CACHE_DEN:
        torch.cuda.synchronize(side.device)
        torch.cuda.empty_cache()
    side.wait_stream(torch.cuda.current_stream())
    before = [fn.captured for fn in KERNELS]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        with torch.cuda.use_mem_pool(pool, side.device):
            body()
        graph.capture_begin(pool=pool.id)
        try:
            body()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    return graph, [(fn, fn.captured - b) for fn, b in zip(KERNELS, before)]


def releasable_idle(device: torch.device, pool) -> int:
    """Bytes that the allocator holds cached and unused on ``device``
    outside ``pool``: the default pool's free blocks and those of other
    graph pools, which ``torch.cuda.empty_cache`` hands back once no graph
    holds their pool (a dead model instance's, a pool a growth left).
    ``pool``'s own free blocks are not counted: its live graphs keep it."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    own = tuple(pool.id)
    return sum(seg["total_size"] - seg["allocated_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == index and tuple(seg.get("segment_pool_id", (0, 0))) != own)


def _hold(pool, side: torch.cuda.Stream) -> Tuple[object, torch.Tensor]:
    """A one-operation graph captured into ``pool`` and kept with it, so that
    the pool always holds a graph: PyTorch retires a pool's capture state
    with its last graph, after which a capture into it fails (the mux drops
    an outgrown program outside :meth:`ProgramCache._release`)."""
    flag = torch.zeros(1, dtype=DTYPE, device=side.device)
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin(pool=pool.id)
        try:
            flag.add_(1)
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    return graph, flag


class ProgramCache:
    """A model's programs and carries on one device."""

    def __init__(self, device: torch.device):
        self.device = device
        cuda = device.type == "cuda"
        #: The memory pool of every graph and warm-up (module docstring).
        self.pool = torch.cuda.MemPool() if cuda else None
        #: The stream that warm-ups and captures run on.
        self.side = torch.cuda.Stream(device) if cuda else None
        self._hold = _hold(self.pool, self.side) if cuda else None
        #: ``(table_capacity, levels_per_dispatch, hv_cap, dedup)`` -> Carry.
        self.carries: Dict[Tuple[int, int, int, str], Carry] = {}
        #: ``(run_cap, rows, cand_cap, table_capacity, levels_per_dispatch,
        #: hv_cap, dedup, max_probes, sym_tag)`` -> Program.
        self.programs: Dict[Tuple[int, ...], Program] = {}
        #: The multiplexed engine's (``xla_mux.py``): ``(k, table_capacity,
        #: levels_per_dispatch, dedup)`` -> MuxCarry, and :func:`mux_key` ->
        #: Program.
        self.mux_carries: Dict[Tuple, MuxCarry] = {}
        self.mux_programs: Dict[Tuple, Program] = {}
        #: The sharded engine's (``parallel/sharded.py``): :func:`shard_shape`
        #: -> ShardCarry, and :func:`shard_key` -> Program.
        self.shard_carries: Dict[Tuple, ShardCarry] = {}
        self.shard_programs: Dict[Tuple, Program] = {}

    def carry(self, words: int, n_props: int, table_capacity: int, levels: int,
              n_hv: int = 0, hv_cap: int = 0, dedup: str = "sorted") -> Carry:
        key = (table_capacity, levels, hv_cap, dedup)
        if key not in self.carries:
            self.carries[key] = Carry(self.device, words, n_props, levels, table_capacity,
                                      n_hv, hv_cap, dedup)
        return self.carries[key]

    def mux_carry(self, words: int, n_props: int, table_capacity: int, levels: int, k: int,
                  dedup: str) -> MuxCarry:
        key = (k, table_capacity, levels, dedup)
        if key not in self.mux_carries:
            self.mux_carries[key] = MuxCarry(self.device, words, n_props, levels, table_capacity,
                                             k, dedup)
        return self.mux_carries[key]

    def make_mux(self, key, carry: MuxCarry, body: Callable[[], None], graph: bool) -> Program:
        """The multiplexed program of ``key``; with ``graph``, ``body`` is
        captured after the mux's gate and budget are zeroed, so that the
        warm-up level is dead in every lane."""
        if graph:
            carry.s[S["budget"]] = 0
            carry.s[S["live"]] = 0
            prog = Program(carry, *capture(body, self.pool, self.side))
        else:
            prog = Program(carry)
        self.mux_programs[key] = prog
        return prog

    def shard_carry(self, key: Tuple, words: int, n_props: int, n_hv: int,
                    reduce_width: int = 0) -> ShardCarry:
        """The carry of the sharded program ``key`` (:func:`shard_key`): on
        a rank of ``world`` processes, of its ``shards // world`` shards."""
        shape = shard_shape(key)
        if shape not in self.shard_carries:
            _, shards, rows, table_capacity, levels, hv_cap, dedup, (world, _) = shape
            self.shard_carries[shape] = ShardCarry(
                self.device, shards // world, rows, words, n_props, levels, table_capacity, n_hv,
                hv_cap, dedup, world=world, reduce_width=reduce_width)
        return self.shard_carries[shape]

    def make_shard(self, key, carry: ShardCarry, body: Callable[[], None], graph: bool) -> Program:
        """The sharded program of ``key``; with ``graph``, ``body`` is
        captured after the carry's budget is zeroed, so that the warm-up
        level is dead on every shard."""
        if graph:
            carry.s[S["budget"]] = 0
            prog = Program(carry, *capture(body, self.pool, self.side))
        else:
            prog = Program(carry)
        self.shard_programs[key] = prog
        return prog

    def make_rank(self, key, carry: ShardCarry, segments, collectives,
                  graph: bool) -> RankProgram:
        """The program of a rank's level (:class:`RankProgram`); with
        ``graph``, each segment captured."""
        prog = RankProgram(carry, segments, collectives)
        if graph:
            prog.capture(self.pool, self.side)
        self.shard_programs[key] = prog
        return prog

    def drop_shard(self, shape: Tuple) -> None:
        """Forget the sharded carry of ``shape`` (:func:`shard_shape`) and
        every program on it, of every route width, probe budget and
        symmetry tag, releasing as :meth:`drop` does."""
        for key in [k for k in self.shard_programs if shard_shape(k) == shape]:
            del self.shard_programs[key]
        self.shard_carries.pop(shape, None)
        self._release()

    def holds_graph(self) -> bool:
        """Whether a program of the cache (single-chip, mux or sharded) holds
        a captured graph."""
        return any(prog.graph is not None
                   for progs in (self.programs, self.mux_programs, self.shard_programs)
                   for prog in progs.values())

    def _release(self) -> None:
        """On a card: hand the memory of dropped carries back and, where the
        cache holds no graph any more, the pool's too, sending later
        captures to a new pool (module docstring). Otherwise the dropped
        graphs' blocks stay in the pool, where later captures reuse them."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            if not self.holds_graph():
                self._hold = None
                self.pool = torch.cuda.MemPool()
                self._hold = _hold(self.pool, self.side)
            torch.cuda.empty_cache()

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
        grown checker's are made anew when a check of that tag needs them,
        and the multiplexed programs and carries at that capacity. On a
        card, the memory of the dropped carry and graphs is handed back
        before the programs at the grown capacity are made (a wide model's
        largest bucket could not hold two levels' worth at once), as far as
        :meth:`_release` can."""
        for key in [k for k in self.programs if k[3:7] == shape]:
            del self.programs[key]
        self.carries.pop(shape, None)
        table_capacity, levels, hv_cap, dedup = shape
        if hv_cap == 0:  # no multiplexed lane has host-verified properties
            for key in [k for k in self.mux_programs if mux_shape(k) == shape]:
                del self.mux_programs[key]
            for key in [k for k in self.mux_carries if k[1:] == (table_capacity, levels, dedup)]:
                del self.mux_carries[key]
        self._release()


def mux_key(k: int, run_cap: int, cand_cap: int, levels: int, sym_tag, max_probes: int,
            dedup: str, table_capacity: int) -> Tuple:
    """The key of a multiplexed program: ``k`` lanes' levels at bucket
    ``run_cap`` and candidate cap ``cand_cap`` under the lanes' shape."""
    return ("mux", k, run_cap, cand_cap, levels, sym_tag, max_probes, dedup, table_capacity)


def mux_shape(key: Tuple) -> Tuple[int, int, int, str]:
    """The carry shape ``(table_capacity, levels_per_dispatch, hv_cap,
    dedup)`` of a :func:`mux_key`, as :meth:`ProgramCache.drop` takes it."""
    return (key[8], key[4], 0, key[7])


def shard_key(shards: int, rows: int, table_capacity: int, route: int, levels: int,
              hv_cap: int, dedup: str, max_probes: int, sym_tag, ranks: Tuple[int, int] = (1, 0)
              ) -> Tuple:
    """The key of a sharded program: ``shards`` shards' levels at ``rows``
    frontier rows and ``table_capacity`` table slots a shard, ``route``
    slots a (source, destination) pair, under the checker's structure,
    probe budget and symmetry tag, on ``ranks = (world, first)``: the world
    size and this rank's first shard (``(1, 0)`` in one process), so that
    a one-process program is never replayed for a rank mesh."""
    return ("shard", shards, rows, table_capacity, route, levels, hv_cap, dedup, max_probes,
            sym_tag, tuple(ranks))


def shard_shape(key: Tuple) -> Tuple:
    """The carry shape ``("shard", shards, rows, table_capacity, levels,
    hv_cap, dedup, ranks)`` of a :func:`shard_key`."""
    return key[:4] + key[5:8] + key[10:]


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
                 loaded: np.ndarray, budget: int, drain: Optional[list] = None) -> int:
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
    added for the choice of rung.

    ``drain`` (the dispatch-phase split, when on): a list that gets the
    ``time.monotonic()`` stamps before and after the wait on the last
    level's event, the one wait the block pays anyway; on the CPU, where
    each level ran eagerly, both stamps are taken at the loop's end."""
    live = S["live"]
    limit = 2 * budget
    if s.device.type == "cpu":
        row = loaded
        for _ in range(limit):
            run_level(row)
            if not s[live]:
                break
            row = s.numpy().copy() if LOOKAHEAD == 1 else None
        if drain is not None:
            drain += [time.monotonic()] * 2
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
    if drain is not None:
        drain.append(time.monotonic())
    stream.synchronize()
    if drain is not None:
        drain.append(time.monotonic())
    ran = len(events)
    live_levels = next((i + 1 for i in range(ran) if not host[i][live]), ran)
    return ran - live_levels
