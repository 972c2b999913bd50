"""Fingerprint-sharded frontier expansion: D shards on one device.

Counterpart of ``stateright_tpu/parallel/sharded.py``, whose semantics it
keeps. One BFS level is one superstep over every shard (``_shard_level``):

1. each shard fingerprints its frontier rows (their canonical forms under
   symmetry), checks the properties over them (host-verified ones compact
   up to ``host_verified_cap`` candidate rows a shard) and expands its
   action grid; the terminal pass finds eventually-counterexamples;
2. the discovery election (the reference's ``pick_discovery``): each shard
   takes its first match in frontier order, then the largest ``fp_hi``
   over the shards wins, and the largest ``fp_lo`` among the shards that
   hold it; a property found already keeps its fingerprint;
3. each shard compacts its grid into candidates in state-major order
   (``f*A + a``, ``csrc/compact.cu``), fingerprints them and gives each its
   owner shard (:func:`owner_bits`); one more compaction of every
   candidate under the mask ``owner == d`` for each destination d lays
   them out destination-major, state-major within, and a gather packs the
   route buffer ``[D_src, D_dst, LANES, K]`` (``LANES = W + 5``: the state
   words, the fingerprint, the parent's, the eventually-bits; zeros past a
   destination's count, ``K`` slots a (source, destination) pair);
4. the exchange, the reference's ``all_to_all``, is ``transpose(0, 1)``:
   the owner's batch is source shard 0's K slots, then shard 1's, and so
   on, so its insert (the lowest batch index wins among duplicates) stores
   the lower source shard's parent, as the reference's does;
5. each owner inserts its batch into its own visited set (the sorted, hash
   or delta structure of the single-chip engine, one instance a shard) and
   compacts its new states into its next frontier (``csrc/compact.cu``);
6. the counts and the overflow flags are reduced over the shards: one
   shared ``ok`` over every shard's table, frontier, route and codec
   overflow commits the level on every shard or on none (the hash set's
   in-place inserts are undone on every shard).

The fused block (``levels_per_dispatch`` > 1, default 32) replays one CUDA
graph a level, which holds every shard's superstep, the exchange, and every
shard's commit or undo (``graphs.ShardCarry``, ``graphs.replay_block``), as
the multiplexed engine does; on the CPU the same level runs eagerly. Each
shard launches its own ``compact``, ``merge_insert`` or hash insert and
undo: three compactions and one insert a shard and level. After a block,
the host grows what overflowed (a shard's table, its frontier rows or the
route slots, all shards alike) and runs the level again, with the
reference's load rules and capacity hints (``_xla_sharded_cap_hints[D]``,
one table hint a structure). Checkpoints are layout-agnostic: a file of
the single-chip engine, of another mesh size or of the JAX package loads
here, and one written here loads there.

**The mesh over several processes** (the reference's ``jax.distributed``
path): under a process group (``parallel/distributed.py``),
``default_mesh(n)`` is ``n`` global shards, each rank holding ``n / world``
contiguous ones on its own device, and the level is split at the process
boundary into three segments (:meth:`ShardedXlaChecker._rank_segments`):

(a) each local shard's properties, grid, compactions and route buffer,
    laid out destination-rank-major (``graphs.ShardCarry.route``);
    ``exchange``, the buffer's ``all_to_all_single``: each owner's batch is
    then source shard 0's K slots, then shard 1's, in *global* shard order
    (rank x D_local + i), so its insert stores the parent the one-process
    mesh stores;
(b) each local owner's insert and next-frontier compaction, and one packed
    vector of the local overflow flags, generated, unique and frontier
    counts, host-verified candidate counts and election keys (each a
    ``fold_key`` of the shard's winner, so that one max elects the largest
    ``fp_hi``, then ``fp_lo``); its all-gather;
(c) the commit, or the undo of every hash insert, under the shared ``ok``
    that every rank computes from the same gathered vector.

On a card each segment is a CUDA graph of its own and the collectives run
between the replays (``graphs.RankProgram``). Every rank's host state is
the global one, replicated: the counts per shard, the totals, depth, found
names, ``level_log`` and ``dispatch_log``; every host decision (growths,
the delta set's flush list, the codec overflow, the block's exit) comes
from reduced or gathered values, so all ranks take the same one and call
the same collectives in the same order. Host reads of shards gather every
rank's (``Group.host_read``); ``save_checkpoint`` gathers on every rank and
writes on rank 0 alone, as does the metrics recorder; ``metrics()`` calls
no collective. The result is the one-process mesh's, shard for shard.

Differences from the reference, by design: the counters are int64, so a
block needs no ``kmax`` cut of its level budget; the delta set reports an
overflow and the host flushes each shard's tier between blocks (the
single-chip port's protocol), where the reference's insert flushes inside
the level; ``dedup="auto"`` is the sorted set on every device; a mesh over
several devices in one process is refused (PyTorch's idiom is one rank a
card, and a one-card machine can test only that).
"""

from __future__ import annotations

import functools
import time
import warnings
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import graphs, native, obs
from ..backend import resolve_device, visible_cards
from ..checker.base import Checker
from ..checkpoint import (
    AutoCheckpointer,
    checkpoint_arrays,
    load_checkpoint,
    save_checkpoint,
    validate_model,
    validate_symmetry,
)
from ..core import Expectation, Model
from ..graphs import OVF, S
from ..ops import deltaset, hashset
from ..ops.compact import compact
from ..ops.words import DTYPE, MASK32, fold_key, from_u32
from ..sym import SymmetryUnsupported, resolve_symmetry
from ..xla import ENGINE_COUNTERS, PACKED_ATTRS, XlaChecker
from . import distributed

#: The owner mix's multiplier: decorrelated from the fingerprint lanes and
#: from the hash set's home slot (``ops/hashset.GOLDEN``).
OWNER_MULT = 0x7FEB352D
#: The route buffer's lanes after the W state words.
ROUTE_LANES = ("fp_hi", "fp_lo", "par_hi", "par_lo", "ebits")
#: Where the engine keeps its capacity hints on the model instance, by mesh
#: size (the reference's attribute).
CAP_HINTS = "_xla_sharded_cap_hints"


def owner_bits(fp_hi, fp_lo, n_shards: int):
    """The owner shard of each fingerprint, from 32-bit words held in
    int64 (tensors or numpy arrays): ``((lo ^ (hi * 0x7FEB352D)) >> 5) %
    n_shards``, the product taken mod 2**32 as the reference's uint32
    arithmetic does."""
    return ((fp_lo ^ ((fp_hi * OWNER_MULT) & MASK32)) >> 5) % n_shards


class Mesh:
    """A one-axis mesh (axis ``"shards"``) of ``devices.size`` shards;
    ``devices`` is a 1-D numpy array of ``torch.device``, as the reference's
    ``Mesh.devices`` is an array of JAX devices. On a mesh over several
    processes ``ranks[i]`` is the rank that holds shard i (contiguous
    blocks, in rank order) and ``rank`` the rank of this process; in one
    process ``ranks`` is None."""

    axis_names = ("shards",)

    def __init__(self, devices, ranks=None, rank: int = 0):
        self.devices = np.empty(len(devices), dtype=object)
        for i, dev in enumerate(devices):
            self.devices[i] = torch.device(dev)
        self.ranks = None if ranks is None else np.asarray(ranks, dtype=np.int64)
        self.rank = rank

    @property
    def local(self) -> slice:
        """The global shards this process holds."""
        if self.ranks is None:
            return slice(0, self.devices.size)
        mine = np.flatnonzero(self.ranks == self.rank)
        return slice(int(mine[0]), int(mine[-1]) + 1)

    def __repr__(self) -> str:
        ranks = "" if self.ranks is None else f", ranks={self.ranks.tolist()}"
        return f"Mesh({[str(d) for d in self.devices]}, axis_names={self.axis_names}{ranks})"


def default_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """``n_devices`` shards on one device (``backend.resolve_device``: the
    card unless ``device="cpu"``). ``None`` means the count of devices of
    that kind, as the reference's default mesh is every device: on one
    card, one shard, which ``spawn_xla`` runs on the single-chip engine.

    Under a process group (``distributed.initialize``), ``n_devices``
    global shards (a power of two that the world size divides; ``None`` is
    one shard a rank), each rank holding ``n_devices / world`` contiguous
    ones on its own device; ``device``, if given, must be this rank's."""
    group = distributed.group()
    if group is not None:
        if device is not None and torch.device(device) != group.device:
            raise ValueError(f"device={device!r} is not this rank's device {group.device}")
        n = group.world if n_devices is None else n_devices
        if n < group.world or n % group.world or n & (n - 1):
            raise ValueError(f"a rank mesh needs a power of two of shards that the world size "
                             f"{group.world} divides, got {n}")
        per = n // group.world
        ranks = np.repeat(np.arange(group.world), per)
        return Mesh([group.devices[r] for r in ranks], ranks=ranks, rank=group.rank)
    dev = resolve_device(device)
    if n_devices is None:
        n_devices = max(visible_cards(dev), 1)
    if n_devices < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_devices}")
    return Mesh([dev] * n_devices)


def mesh_device(mesh) -> torch.device:
    """The device of this process's shards of ``mesh``: on a mesh over
    several processes this rank's, in one process the one device every
    shard is on."""
    if getattr(mesh, "ranks", None) is not None:
        group = distributed.group()
        if group is None or group.world != int(mesh.ranks.max()) + 1 or group.rank != mesh.rank:
            raise ValueError("a rank mesh needs the process group it was made under "
                             "(parallel.distributed.initialize, then default_mesh)")
        return group.device
    devs = {str(torch.device(d)) for d in mesh.devices}
    if len(devs) != 1:
        raise NotImplementedError(
            f"a mesh over several devices in one process ({sorted(devs)}) is not supported: "
            "run one rank a card over torch.distributed (parallel.distributed.initialize, "
            "then default_mesh(n)), each rank holding its shards on its own device")
    return resolve_device(mesh.devices[0])


class ShardStep(NamedTuple):
    """A sharded level's superstep before its commit: every shard's next
    frontier, eventually-bits and count, its visited set as the level left
    it and as it was (the carry's views), the hash inserts' undos, the
    discoveries, the level's generated and unique counts over the shards,
    the overflow flags (table, frontier, codec, route: the block scalars'
    ``OVF`` slots, the candidate one holding the route's), the host-verified
    candidates ``(words, fingerprints, counts)`` a shard, the next frontier's
    total over every shard, and, on a rank, the host-verified candidates
    every rank collects this level (``hv_lc``, else None). On a rank the
    counts, flags and discoveries are the reduced ones, the buffers this
    rank's."""

    frontier: torch.Tensor
    ebits: torch.Tensor
    counts: torch.Tensor
    tables: List[Any]
    before: List[Any]
    undos: List[Any]
    disc_found: torch.Tensor
    disc_fp: torch.Tensor
    states: torch.Tensor
    unique: torch.Tensor
    flags: torch.Tensor
    hv: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    f_total: torch.Tensor
    hv_lc: Optional[torch.Tensor]


class RouteStep(NamedTuple):
    """Segment (a) of a level: each property's election over the local
    shards (``(has, fp_hi, fp_lo)``, each ``[P]``), the host-verified
    candidates, the codec and route overflow flags and the local generated
    count. The route buffer went to the caller's ``put``."""

    elect: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    hv: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    codec_ovf: torch.Tensor
    route_ovf: torch.Tensor
    states: torch.Tensor


class OwnerStep(NamedTuple):
    """Segment (b) of a level: each local owner's visited set as the insert
    left it and as it was, the hash inserts' undos, its next frontier, its
    eventually-bits and count, the new keys over the local shards and the
    table overflow."""

    tables: List[Any]
    before: List[Any]
    undos: List[Any]
    fronts: List[torch.Tensor]
    ebits: List[torch.Tensor]
    counts: List[torch.Tensor]
    unique: torch.Tensor
    table_ovf: torch.Tensor


class ShardedXlaChecker(Checker):
    """Level-synchronous BFS over D fingerprint-owned shards on one device,
    or over the ranks of a process group (module docstring). Spawn through
    ``model.checker().spawn_xla(mesh=default_mesh(D))``; a one-shard mesh
    runs the single-chip engine."""

    # Shared with the single-chip engine: the codec and witness paths, the
    # property-gate of a level, the structures' insert, the host-verified
    # compaction, the checkpoint writer and the quiescent-point hooks.
    _fingerprint_planes = XlaChecker._fingerprint_planes
    _fingerprint_rows = XlaChecker._fingerprint_rows
    _row_fps = XlaChecker._row_fps
    _host_fps = XlaChecker._host_fps
    _path_for = XlaChecker._path_for
    _live = XlaChecker._live
    _insert = XlaChecker._insert
    _hv_compact = XlaChecker._hv_compact
    _raise_codec_overflow = XlaChecker._raise_codec_overflow
    _pin_found_names = XlaChecker._pin_found_names
    _maybe_record = XlaChecker._maybe_record
    _settle = XlaChecker._settle
    save_checkpoint = XlaChecker.save_checkpoint
    LOAD = XlaChecker.LOAD

    def __init__(
        self,
        builder,
        mesh,
        *,
        frontier_capacity: Optional[int] = None,
        table_capacity: Optional[int] = None,
        route_capacity: Optional[int] = None,
        max_probes: int = 32,
        visit_cap: int = 4096,
        levels_per_dispatch: int = 32,
        checkpoint: Optional[str] = None,
        checkpoint_to: Optional[str] = None,
        checkpoint_every: Any = None,
        checkpoint_keep: Optional[int] = None,
        dedup: str = "auto",
        symmetry: Any = None,
        host_verified_cap: int = 128,
        trace: Any = None,
        heartbeat: Any = None,
        metrics_to: Any = None,
        metrics_every: Any = None,
        metrics_keep: Optional[int] = None,
    ):
        model = builder._model
        missing = [attr for attr in PACKED_ATTRS if not hasattr(model, attr)]
        if missing:
            raise TypeError(
                f"spawn_xla() requires the PackedModel protocol; "
                f"{type(model).__name__} is missing {missing}"
            )
        self._model = model
        self._mesh = mesh
        self._device = mesh_device(mesh)
        self._backend = self._device.type
        self._D = D = mesh.devices.size
        if D & (D - 1):
            raise ValueError(f"mesh size must be a power of two, got {D}")
        #: The process group of a rank mesh, else None; this rank's shards
        #: are ``local`` (``Dl`` of them from global shard ``r0``).
        self._group = distributed.group() if mesh.ranks is not None else None
        self._local = mesh.local
        self._r0, self._Dl = self._local.start, self._local.stop - self._local.start
        # The canonical form also decides a state's owner, so one class
        # never splits across shards.
        sym = resolve_symmetry(symmetry, builder._symmetry is not None, model, engine="xla-mesh",
                               store=graphs.graph_inputs(model))
        self._sym_tag = sym.tag
        self._sym_canon = sym.device_canon
        self._sym_canon_host = sym.host_canon
        if sym.enabled and getattr(model, "host_verified_properties", ()):
            raise SymmetryUnsupported(
                "xla-mesh",
                f"{type(model).__name__} declares host_verified_properties; "
                f"the host-verified fallback evaluates concrete states and "
                f"cannot honor a symmetry-reduced frontier",
            )
        if dedup == "auto":
            dedup = "sorted"
        if dedup not in graphs.STRUCTURES:
            raise ValueError(f"dedup must be 'auto', 'hash', 'sorted', or 'delta': {dedup!r}")
        self._dedup = dedup
        self._ds = graphs.STRUCTURES[dedup]
        self._max_probes = max_probes
        self._target_state_count = builder._target_state_count
        self._target_max_depth = builder._target_max_depth
        self._visitor = builder._visitor
        self._visit_cap = visit_cap
        self._levels_per_dispatch = 1 if self._visitor is not None else max(1, levels_per_dispatch)
        self._properties = model.properties()
        self._prop_names = [p.name for p in self._properties]
        self._ebit_of_prop: Dict[int, int] = {}
        for i, p in enumerate(self._properties):
            if p.expectation == Expectation.EVENTUALLY:
                self._ebit_of_prop[i] = len(self._ebit_of_prop)
        self._ebits0 = (1 << len(self._ebit_of_prop)) - 1
        self._W = model.state_words
        self._A = model.max_actions
        self._P = len(self._properties)
        hv_names = frozenset(getattr(model, "host_verified_properties", ()))
        unknown = hv_names - set(self._prop_names)
        if unknown:
            raise ValueError(f"host_verified_properties not in properties(): {unknown}")
        self._hv_idx = [i for i, name in enumerate(self._prop_names) if name in hv_names]
        for i in self._hv_idx:
            if self._properties[i].expectation == Expectation.EVENTUALLY:
                raise ValueError("host-verified eventually-properties are not supported")
        self._hv_cap = host_verified_cap if self._hv_idx else 0
        self.hv_stats: Dict[str, float] = {
            "flagged": 0, "host_checked": 0, "cleared": 0, "confirmed": 0, "host_sec": 0.0,
        }

        # Capacities a shard, seeded from what earlier checks of this
        # model on a mesh of this size grew to; an explicit capacity wins.
        hints = self._cap_hints()
        if frontier_capacity is None:
            frontier_capacity = max(1 << 15, hints.get("frontier", 0))
        if table_capacity is None:
            table_capacity = max(1 << 20, hints.get(f"table_{dedup}", 0))
        self._Fl = max(frontier_capacity // D, 16)
        self._Cl = max(table_capacity // D, 64)
        if self._Cl & (self._Cl - 1):
            raise ValueError("table_capacity/D must be a power of two")
        local_cand = self._Fl * self._A
        if route_capacity is not None:
            if route_capacity < 1:
                # K = 0 could never grow out of a route overflow.
                raise ValueError(f"route_capacity must be >= 1, got {route_capacity}")
            self._K = route_capacity
        else:
            self._K = max(min(local_cand, max(64, (local_cand // D) * 4)), hints.get("route", 0))

        self._use_graphs = self._backend == "cuda"
        self._programs = graphs.cache_for(model, self._device)
        self._capture_s = 0.0
        self._found_names: Dict[str, int] = {}
        self._target_reached = False
        self._tracer = obs.resolve_tracer(trace)
        self._heartbeat = obs.resolve_heartbeat(heartbeat)
        # Every rank reaches each quiescent point with the same gauges, so
        # rank 0's rows are the series, as its file is the checkpoint.
        self._recorder = (obs.resolve_recorder(metrics_to, metrics_every, metrics_keep)
                          if self._rank == 0 else None)
        self._counters = obs.Counters(ENGINE_COUNTERS + ("route_grows",))
        #: One ``(D * Fl, committed_levels)`` per dispatch.
        self.dispatch_log: List[Tuple[int, int]] = []
        #: ``{depth, frontier, generated, unique}`` per committed level,
        #: over every shard.
        self.level_log: List[Dict[str, int]] = []
        self._autockpt = AutoCheckpointer.resolve(checkpoint_to, checkpoint_every, checkpoint_keep)
        self._last_checkpoint: Optional[Dict[str, Any]] = None
        self._resumed_from: Optional[str] = checkpoint
        dev = self._device
        self._disc_found = torch.zeros(self._P, dtype=torch.bool, device=dev)
        self._disc_fp = torch.zeros((self._P, 2), dtype=DTYPE, device=dev)

        if checkpoint is not None:
            self._restore(checkpoint)
        else:
            init = np.asarray(model.packed_init(), dtype=np.uint32).reshape(-1, self._W)
            init = init[[model.within_boundary(model.unpack(row)) for row in init]]
            n_init = len(init)
            frontier, fhi, flo, ebits, counts = self._route_frontier_host(
                init, np.full(n_init, self._ebits0, dtype=np.uint32))
            self._store_frontier(frontier, ebits, counts)
            self._tables = [self._ds.make(self._Cl, dev) for _ in range(self._Dl)]
            # Init fingerprints go in with a zero parent, a shard's batch each.
            zeros = np.zeros_like(fhi)
            self._unique_count = self._bulk_insert(fhi, flo, zeros, zeros, counts)
            self._depth = 1
            self._max_depth = 0
            self._state_count = n_init
            self._exhausted = n_init == 0
        for hook in (self._autockpt, self._recorder):
            if hook is not None:
                hook.arm(self._depth)

    # --- the ranks ---------------------------------------------------------------

    @property
    def _rank(self) -> int:
        return 0 if self._group is None else self._group.rank

    def _gather(self, t: torch.Tensor) -> np.ndarray:
        """The global host array of which ``t`` holds this rank's shards
        along the leading axis (in one process, ``t`` itself)."""
        if self._group is None:
            return t.detach().cpu().numpy()
        return self._group.host_read(t)

    def _any(self, flag: bool) -> bool:
        return bool(flag) if self._group is None else self._group.any(flag)

    def _gather_rows(self, lanes: List[np.ndarray]) -> List[np.ndarray]:
        """Equal-length host lanes of this rank's rows, concatenated with
        every rank's in rank order (in one process, the lanes)."""
        if self._group is None:
            return lanes
        both = self._group.gather_ragged(np.stack(lanes, 1).astype(np.int64))
        return [both[:, j].astype(lanes[j].dtype) for j in range(len(lanes))]

    @property
    def _reduce_width(self) -> int:
        """The words of a level's packed reduction on a rank: the four
        overflow flags, the generated, unique and next-frontier counts, the
        host-verified candidates of each such property, and each property's
        election flag and key."""
        return 7 + len(self._hv_idx) + 2 * self._P

    # --- capacities ----------------------------------------------------------

    def _cap_hints(self) -> Dict[str, int]:
        return self._model.__dict__.setdefault(CAP_HINTS, {}).setdefault(self._D, {})

    def _slots_per_shard(self, cl: int) -> int:
        """A shard's table slots at main capacity ``cl`` (the delta tier's
        rows included), the load rule's denominator."""
        return cl + deltaset._delta_cap(cl) if self._dedup == "delta" else cl

    # --- host routing ----------------------------------------------------------

    def _host_pairs(self, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """The ``(hi, lo)`` fingerprint words of the dedup keys of host
        ``[n, W]`` rows, as int64."""
        if not len(rows):
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        fps = np.asarray(self._row_fps(rows), dtype=np.uint64)
        return (fps >> np.uint64(32)).astype(np.int64), (fps & np.uint64(MASK32)).astype(np.int64)

    @staticmethod
    def _shard_positions(owners: np.ndarray, D: int):
        """For each element its place in its shard, in a stable order:
        ``(counts[D], order, pos)``."""
        counts = np.bincount(owners, minlength=D).astype(np.int64)
        order = np.argsort(owners, kind="stable")
        offsets = np.zeros(D, dtype=np.int64)
        np.cumsum(counts[:-1], out=offsets[1:])
        pos = np.arange(len(owners), dtype=np.int64) - np.repeat(offsets, counts)
        return counts, order, pos

    def _route_frontier_host(self, rows: np.ndarray, ebits: np.ndarray):
        """Host rows (init states, a checkpoint's frontier) to their owner
        shards, in their order: ``(frontier [D, Fl, W], fp_hi [D, Fl],
        fp_lo [D, Fl], ebits [D, Fl], counts [D])`` as host arrays, growing
        ``Fl`` (and the route slots with it) to hold the fullest shard."""
        D, W = self._D, self._W
        hi, lo = self._host_pairs(rows)
        owners = owner_bits(hi, lo, D)
        counts, order, pos = self._shard_positions(owners, D)
        if len(rows) and counts.max() > self._Fl:
            while self._Fl < counts.max():
                self._Fl *= 2
            local_cand = self._Fl * self._A
            self._K = min(local_cand, max(self._K, (local_cand // D) * 4))
        Fl = self._Fl
        out = [np.zeros((D, Fl, W), np.uint32)] + [np.zeros((D, Fl), np.uint32) for _ in range(3)]
        shard = owners[order]
        for dst, src in zip(out, (rows, hi, lo, ebits)):
            dst[shard, pos] = np.asarray(src)[order]
        return (*out, counts)

    def _store_frontier(self, frontier, ebits, counts) -> None:
        """Global host ``[D, Fl, ...]`` frontier blocks: this rank's shards
        onto its device, the counts of every shard kept on the host."""
        mine = self._local
        self._frontier = from_u32(frontier[mine], self._device)
        self._frontier_ebits = from_u32(ebits[mine], self._device)
        self._counts = np.asarray(counts, dtype=np.int64)

    def _bulk_insert(self, kh, kl, vh, vl, counts) -> int:
        """Per-shard blocks ``[D, B]`` of (fingerprint, value) words into
        the shards' visited sets (this rank's shards), the first
        ``counts[d]`` of each active; grows (or, for the delta set,
        flushes) and retries on an overflow of any shard. Returns the count
        of new entries over every shard."""
        dev = self._device
        B = kh.shape[1]
        lanes = [from_u32(a[self._local], dev) for a in (kh, kl, vh, vl)]
        while True:
            out, unique, overflow = [], 0, False
            for d, table in enumerate(self._tables):
                active = torch.arange(B, device=dev) < int(counts[self._r0 + d])
                nt, is_new, ovf, _ = self._insert(table, *(x[d] for x in lanes), active)
                out.append(nt)
                unique += int(is_new.sum())
                overflow |= bool(ovf)
            if self._group is not None:
                unique, overflow = self._group.reduce([unique, int(overflow)], "sum")
            if not overflow:
                self._tables = out
                return unique
            self._resolve_table_overflow()

    # --- checkpoint and resume ---------------------------------------------------

    def _restore(self, path: str) -> None:
        """A checkpoint of either package's engine, single-chip or mesh of
        any size: its visited-set rows and frontier rows routed to their
        owner shards (the reference's ``_restore``)."""
        ck = load_checkpoint(path)
        meta = ck["meta"]
        validate_model(meta, self._model, self._prop_names)
        validate_symmetry(meta, self._sym_tag)
        D, dev = self._D, self._device
        rows = [np.asarray(ck[k], dtype=np.uint32) for k in ("key_hi", "key_lo", "val_hi", "val_lo")]
        owners = owner_bits(rows[0].astype(np.int64), rows[1].astype(np.int64), D)
        counts, order, pos = self._shard_positions(owners, D)
        B = max(16, int(counts.max()) if len(owners) else 0)
        while self._Cl < 2 * B:
            self._Cl *= 2
        shard = owners[order]
        blocks = [np.zeros((D, B), np.uint32) for _ in range(4)]
        for block, lane in zip(blocks, rows):
            block[shard, pos] = lane[order]
        if self._dedup == "hash":
            # The reference's padded per-shard batches, so that the slot
            # layout is its own.
            self._tables = [hashset.make(self._Cl, dev) for _ in range(self._Dl)]
            self._bulk_insert(*blocks, counts)
        else:
            self._tables = [self._ds.from_entries(*(b[d, :counts[d]] for b in blocks), self._Cl, dev)
                            for d in range(D)[self._local]]
        frontier, _, _, ebits, fcounts = self._route_frontier_host(
            np.asarray(ck["frontier"], dtype=np.uint32).reshape(-1, self._W),
            np.asarray(ck["frontier_ebits"], dtype=np.uint32))
        self._store_frontier(frontier, ebits, fcounts)
        for key in ("depth", "max_depth", "state_count", "unique_count", "exhausted",
                    "target_reached"):
            setattr(self, f"_{key}", meta[key])
        self._found_names = {k: int(v) for k, v in meta["found_names"].items()}
        for i, name in enumerate(self._prop_names):
            if name in self._found_names:
                fp64 = self._found_names[name]
                self._disc_found[i] = True
                self._disc_fp[i, 0] = fp64 >> 32
                self._disc_fp[i, 1] = fp64 & MASK32

    def _occupied_rows(self) -> List[np.ndarray]:
        """Every shard's occupied ``(key_hi, key_lo, val_hi, val_lo)`` rows
        as host ``uint32`` arrays, in the reference's order of its global
        planes: shard by shard, each in its structure's plane order (and,
        for the delta set, every shard's main tier before the delta tiers);
        on a rank, every rank's shards, gathered."""
        parts = [self._ds.occupied_rows(t) for t in self._tables]
        if self._dedup == "delta":
            mains = [[a[:int(t.n_main)] for a in p] for p, t in zip(parts, self._tables)]
            deltas = [[a[int(t.n_main):] for a in p] for p, t in zip(parts, self._tables)]
            return [np.concatenate(pair) for pair in zip(*(
                self._gather_rows([np.concatenate([p[j] for p in tier]) for j in range(4)])
                for tier in (mains, deltas)))]
        return self._gather_rows([np.concatenate([p[j] for p in parts]) for j in range(4)])

    def _key_planes(self) -> Tuple[np.ndarray, np.ndarray]:
        """Every shard's ``key_hi`` and ``key_lo`` planes as host ``uint32``
        ``[D, slots]`` arrays (the audit's read; gathered on a rank)."""
        return tuple(self._gather(torch.stack([getattr(t, name) for t in self._tables]))
                     .astype(np.uint32) for name in ("key_hi", "key_lo"))

    def _live_frontier(self) -> Tuple[np.ndarray, np.ndarray]:
        """The live frontier rows ``[n, W]`` and eventually-bits ``[n]`` as
        host ``uint32``, shard by shard (the reference's ``_live_frontier``;
        gathered from every rank)."""
        rows = self._gather(self._frontier).astype(np.uint32)
        ebits = self._gather(self._frontier_ebits).astype(np.uint32)
        return (np.concatenate([rows[d, :n] for d, n in enumerate(self._counts)]),
                np.concatenate([ebits[d, :n] for d, n in enumerate(self._counts)]))

    def _write_checkpoint(self, path: str, keep: int) -> None:
        """The global search state's file. On a rank mesh every rank gathers
        the payload (a collective) and rank 0 alone writes it, as the
        reference's process 0 does: its file is the global file. Every rank
        counts the write (``save_checkpoint``), so ``checkpoints_written``
        and ``last_checkpoint_level`` agree on every rank; the path is rank
        0's."""
        if self._rank == 0:
            save_checkpoint(self, path, keep=keep)
        else:
            checkpoint_arrays(self)

    def _maybe_checkpoint(self) -> None:
        """The auto-checkpoint hook (``XlaChecker._maybe_checkpoint``); on a
        rank mesh a write is due when it is due on any rank (a cadence in
        seconds reads each rank's own clock)."""
        if self._autockpt is not None:
            self._autockpt.maybe(self, agree=None if self._group is None else self._group.any)

    # --- the level ---------------------------------------------------------------

    def _carried_table(self, c: graphs.ShardCarry, d: int):
        """Shard ``d``'s visited set in the carry ``c``: views of its planes
        and counts."""
        kind = type(self._tables[0])
        n_counts = len(kind._fields) - kind.PLANES
        return kind(*(p[d] for p in c.table), *(c.table_n[d, j] for j in range(n_counts)))

    @staticmethod
    def _elect(viol, fhi, flo):
        """The discovery election of one property over ``[shards, Fl]``
        matches (the reference's ``pick_discovery``): each shard's first
        match in frontier order, the largest ``fp_hi`` over the shards,
        then the largest ``fp_lo`` among those holding it. Returns
        ``(has, fp_hi, fp_lo)``, the winner zero where nothing matched."""
        has_local = viol.any(1)
        first = torch.argmax(viol.to(torch.uint8), dim=1, keepdim=True)
        cand_hi = torch.where(has_local, fhi.gather(1, first)[:, 0], 0)
        cand_lo = torch.where(has_local, flo.gather(1, first)[:, 0], 0)
        g_hi = cand_hi.max()
        g_lo = torch.where(cand_hi == g_hi, cand_lo, 0).max()
        return has_local.any(), g_hi, g_lo

    @staticmethod
    def _pin_elected(has, fp_hi, fp_lo, disc_found, disc_fp) -> None:
        """The elections' winners ``[P]`` into the discoveries, in place: a
        property found already keeps its fingerprint."""
        take = has & ~disc_found
        disc_fp[:, 0] = torch.where(take, fp_hi, disc_fp[:, 0])
        disc_fp[:, 1] = torch.where(take, fp_lo, disc_fp[:, 1])
        disc_found.copy_(disc_found | has)

    def _shard_step(self, c: graphs.ShardCarry, gate) -> ShardStep:
        """Every shard's superstep from the carry ``c`` (module docstring,
        steps 1-5), gated by ``gate`` (a bool device scalar), with nothing
        committed yet: the hash sets' inserts are in the carry's planes and
        are undone by :meth:`_shard_commit` unless committed. Nothing here
        waits on the host, so the level can be captured into a CUDA graph."""
        D, Fl, W, K = self._D, self._Fl, self._W, self._K
        LANES = W + len(ROUTE_LANES)
        send = torch.empty((D, D, LANES, K), dtype=DTYPE, device=self._device)
        route = self._route_step(c, gate, send.__setitem__)
        recv = send.transpose(0, 1)  # the all_to_all: [D_dst, D_src, LANES, K]
        own = self._owner_step(c, gate, recv.__getitem__)
        disc_found, disc_fp = c.disc_found.clone(), c.disc_fp.clone()
        self._pin_elected(*route.elect, disc_found, disc_fp)
        counts = torch.stack(own.counts)
        flags = torch.stack([own.table_ovf, (counts > Fl).any(), route.codec_ovf,
                             route.route_ovf]).to(DTYPE)
        return ShardStep(torch.stack(own.fronts), torch.stack(own.ebits), counts, own.tables,
                         own.before, own.undos, disc_found, disc_fp, route.states, own.unique,
                         flags, route.hv, counts.sum(), None)

    def _route_step(self, c: graphs.ShardCarry, gate, put) -> RouteStep:
        """Segment (a) of a level over the carry's shards (module docstring,
        steps 1-3): properties, elections, the action grid, the terminal
        pass and each shard's route buffer, ``put(src, [D_dst, LANES, K])``
        for local source shard ``src``."""
        D, Fl, W, A, K = self._D, self._Fl, self._W, self._A, self._K
        Dl = c.counts.shape[0]
        dev = self._device
        model = self._model
        LANES = W + len(ROUTE_LANES)
        zero = torch.zeros((), dtype=DTYPE, device=dev)
        elect = [(torch.zeros((), dtype=torch.bool, device=dev), zero, zero)] * self._P
        rows = c.frontier.view(Dl * Fl, W)
        f_valid = torch.arange(Fl, device=dev)[None, :] < c.counts[:, None]  # [D, Fl]
        fv = f_valid.view(-1)
        fhi, flo = self._fingerprint_rows(rows)
        ebits = c.ebits.view(-1)
        shard_of = lambda t: t.view(Dl, Fl, *t.shape[1:])  # noqa: E731

        # Properties over every shard's frontier.
        props = model.packed_properties(rows)  # [D * Fl, P]
        hv_w, hv_f, hv_n = [], [], []
        for i, p in enumerate(self._properties):
            if p.expectation == Expectation.EVENTUALLY:
                sat = props[:, i] & fv
                ebits = torch.where(sat, ebits & ~(1 << self._ebit_of_prop[i]), ebits)
                continue
            hit = (~props[:, i] if p.expectation == Expectation.ALWAYS else props[:, i]) & fv
            if i in self._hv_idx:
                per = [self._hv_compact(hit[d * Fl:(d + 1) * Fl], c.frontier[d],
                                        fhi[d * Fl:(d + 1) * Fl], flo[d * Fl:(d + 1) * Fl])
                       for d in range(Dl)]
                hv_w.append(torch.stack([w for w, _, _ in per]))
                hv_f.append(torch.stack([f for _, f, _ in per]))
                hv_n.append(torch.stack([n for _, _, n in per]))
                continue
            elect[i] = self._elect(shard_of(hit), shard_of(fhi), shard_of(flo))
        hv = (torch.stack(hv_w), torch.stack(hv_f), torch.stack(hv_n)) if hv_n else None

        # Every shard's action grid, and the terminal pass.
        nxt, valid, *step_ovf = model.packed_step(rows)  # [D*Fl, A, W], [D*Fl, A]
        valid = valid & fv[:, None]
        codec_ovf = (step_ovf[0] & valid).any() if step_ovf else torch.zeros(
            (), dtype=torch.bool, device=dev)
        states = valid.sum()
        if self._ebit_of_prop:
            terminal = fv & ~valid.any(1)
            for i, bit in self._ebit_of_prop.items():
                elect[i] = self._elect(shard_of(terminal & ((ebits >> bit) & 1 == 1)),
                                       shard_of(fhi), shard_of(flo))

        # Candidates, compacted in state-major order, routed to their owners.
        C = Fl * A
        shard_ids = torch.arange(D, device=dev)
        slot = torch.arange(K, device=dev)
        route_ovf = torch.zeros((), dtype=torch.bool, device=dev)
        for src in range(Dl):
            part = slice(src * Fl, (src + 1) * Fl)
            lanes = [nxt[part, :, w] for w in range(W)] + [
                lane[part, None].expand(Fl, A) for lane in (fhi, flo, ebits)]
            grid, n_valid = compact(valid[part], lanes, C)
            cvalid = torch.arange(C, device=dev) < n_valid
            grid = torch.where(cvalid, grid, 0)
            chi, clo = self._fingerprint_planes(grid[:W])
            dest = (owner_bits(chi, clo, D)[None, :] == shard_ids[:, None]) & cvalid[None, :]
            payload = [*grid[:W], chi, clo, *grid[W:]]
            routed, _ = compact(dest, [p[None, :].expand(D, C) for p in payload], C)
            cnt = dest.sum(1)
            route_ovf = route_ovf | (cnt > K).any()
            take = slot[None, :] < cnt[:, None]  # [D_dst, K]
            idx = torch.where(take, (cnt.cumsum(0) - cnt)[:, None] + slot[None, :], 0)
            sel = routed.index_select(1, idx.view(-1)).view(LANES, D, K).transpose(0, 1)
            put(src, torch.where(take[:, None, :], sel, 0))
        if elect:
            has, hi, lo = (torch.stack(x) for x in zip(*elect))
        else:
            has, hi, lo = torch.zeros(0, dtype=torch.bool, device=dev), zero[None][:0], zero[None][:0]
        return RouteStep((has, hi, lo), hv, codec_ovf, route_ovf, states)

    def _owner_step(self, c: graphs.ShardCarry, gate, batch_of) -> OwnerStep:
        """Segment (b) of a level (module docstring, step 5): each local
        owner ``d``'s insert of its batch ``batch_of(d)`` (``[D_src, LANES,
        K]``, source shards in global order) into its own visited set, and
        its next frontier."""
        Fl, W, K = self._Fl, self._W, self._K
        D = self._D
        dev = self._device
        tables, before, undos, fronts, fe, fcount = [], [], [], [], [], []
        unique = torch.zeros((), dtype=DTYPE, device=dev)
        table_ovf = torch.zeros((), dtype=torch.bool, device=dev)
        for d in range(c.counts.shape[0]):
            rl = batch_of(d)  # [D_src, LANES, K]
            hi, lo, par_hi, par_lo = (rl[:, W + j].reshape(-1) for j in range(4))
            active = ((hi != 0) | (lo != 0)) & gate
            table = self._carried_table(c, d)
            nt, is_new, ovf, undo = self._insert(table, hi, lo, par_hi, par_lo, active,
                                                 in_place=True)
            unique = unique + is_new.sum()
            table_ovf = table_ovf | ovf
            out, n_new = compact(is_new.view(D, K), [rl[:, w] for w in range(W)] + [rl[:, W + 4]],
                                 Fl)
            out = torch.where(torch.arange(Fl, device=dev) < n_new, out, 0)
            tables.append(nt)
            before.append(table)
            undos.append(undo)
            fronts.append(out[:W].T)
            fe.append(out[W])
            fcount.append(n_new)
        return OwnerStep(tables, before, undos, fronts, fe, fcount, unique, table_ovf)

    def _rank_segments(self, c: graphs.ShardCarry):
        """A rank's level as ``(segments, collectives)`` for
        ``graphs.RankProgram`` (module docstring, (a)-(c)): the route step
        into the carry's send buffer, the exchange, the owners' step and
        the packed local vector, its all-gather, then the reduction and the
        commit. The segments share a dict; nothing in them waits on the
        host."""
        group = self._group
        D, Dl, Fl, W, K, P = self._D, self._Dl, self._Fl, self._W, self._K, self._P
        n_hv = len(self._hv_idx)
        LANES = W + len(ROUTE_LANES)
        send, recv = c.route(K, LANES)
        sign = fold_key(torch.zeros((), dtype=DTYPE), torch.zeros((), dtype=DTYPE)).item()

        def put(src, v):  # [D_dst, LANES, K] -> send[rank, j, src]
            send[:, :, src].copy_(v.view(group.world, Dl, LANES, K))

        def route(st):
            st["live"] = live = self._live(c.s, c.disc_found, c.host_found, c.hv_tot)
            st["route"] = self._route_step(c, live, put)

        def owners(st):
            st["own"] = own = self._owner_step(
                c, st["live"], lambda d: recv[:, d].reshape(D, LANES, K))
            r = st["route"]
            counts = torch.stack(own.counts)
            flags = torch.stack([own.table_ovf, (counts > Fl).any(), r.codec_ovf, r.route_ovf])
            has, hi, lo = r.elect
            key = torch.where(has, fold_key(hi, lo), sign)
            parts = [flags.to(DTYPE), torch.stack([r.states, own.unique, counts.sum()])]
            if n_hv:
                confirmed = torch.stack([c.host_found[i] for i in self._hv_idx])
                parts.append((r.hv[2] * (~confirmed).to(DTYPE)[:, None]).sum(1))
            c.red.copy_(torch.cat(parts + [has.to(DTYPE), key]))

        def commit(st):
            own, r, every = st["own"], st["route"], c.red_all
            flags = every[:, :4].amax(0)
            states, unique, f_total = every[:, 4:7].sum(0)
            hv_lc = every[:, 7:7 + n_hv].sum(0) if n_hv else None
            has = every[:, 7 + n_hv:7 + n_hv + P].amax(0) > 0
            pair = every[:, 7 + n_hv + P:].amax(0) ^ sign
            disc_found, disc_fp = c.disc_found.clone(), c.disc_fp.clone()
            self._pin_elected(has, (pair >> 32) & MASK32, pair & MASK32, disc_found, disc_fp)
            self._shard_commit(c, st["live"], ShardStep(
                torch.stack(own.fronts), torch.stack(own.ebits), torch.stack(own.counts),
                own.tables, own.before, own.undos, disc_found, disc_fp, states, unique, flags,
                r.hv, f_total, hv_lc))

        def gather():
            c.red_all.copy_(group.all_gather(c.red))

        return (route, owners, commit), (lambda: group.exchange(send, recv), gather)

    def _shard_commit(self, c: graphs.ShardCarry, live, step: ShardStep) -> None:
        """Commit ``step`` into the carry ``c`` on every shard where ``live``
        held and no shard overflowed (one shared ``ok``), else leave every
        buffer bit for bit as it was and undo every hash insert; record the
        level's telemetry and update the block scalars, ending with the
        next level's gate in ``s[live]``."""
        s = c.s
        commit = live & (step.flags.sum() == 0)

        def keep(new, old):
            old.copy_(torch.where(commit, new, old))

        keep(step.frontier, c.frontier)
        keep(step.ebits, c.ebits)
        keep(step.counts, c.counts)
        kind = type(self._tables[0])
        for nt, old, undo in zip(step.tables, step.before, step.undos):
            for new, cur in zip(nt[:kind.PLANES], old[:kind.PLANES]):
                if new is not cur:
                    keep(new, cur)
            if undo is not None:
                undo(commit)
        n_counts = len(kind._fields) - kind.PLANES
        if n_counts:
            new_n = torch.stack([torch.stack(list(nt[kind.PLANES:])) for nt in step.tables])
            keep(new_n, c.table_n[:, :n_counts])
        keep(step.disc_found, c.disc_found)
        keep(step.disc_fp, c.disc_fp)
        hv_total = None
        if self._hv_idx:
            lw, lf, lc = step.hv
            # A property the host confirmed collects nothing; this level's
            # rows go after the block's earlier ones on each shard.
            # (A list index would copy host memory inside a capture.)
            confirmed = torch.stack([c.host_found[i] for i in self._hv_idx])
            lc = lc * (~confirmed).to(DTYPE)[:, None]
            cap = self._hv_cap
            src = torch.arange(cap, device=s.device)[None, None, :] - c.hv_c[:, :, None]
            take = (src >= 0) & (src < lc[:, :, None])
            idx = src.clamp(0, cap - 1)[..., None]
            for acc, new in ((c.hv_w, lw), (c.hv_f, lf)):
                got = torch.take_along_dim(new, idx.expand(-1, -1, -1, new.shape[3]), dim=2)
                acc.copy_(torch.where(commit & take[..., None], got, acc))
            c.hv_c.copy_(torch.where(commit, c.hv_c + lc, c.hv_c))
            hv_total = c.hv_c.sum(1)
            if step.hv_lc is not None:  # every rank's, as the gate reads them
                c.hv_tot.copy_(torch.where(commit, c.hv_tot + step.hv_lc, c.hv_tot))
                hv_total = c.hv_tot
        hit = commit & (c.slots == s[S["committed"]])
        row = torch.stack([s[S["f_count"]], step.states, step.unique])[:, None]
        c.lvl.copy_(torch.where(hit, row, c.lvl))
        cm = commit.to(DTYPE)
        new = s.clone()
        new[S["committed"]] += cm
        new[S["f_count"]] = torch.where(commit, step.f_total, s[S["f_count"]])
        new[S["tot_states"]] += cm * step.states
        new[S["tot_unique"]] += cm * step.unique
        new[OVF] = torch.where(live, step.flags, s[OVF])
        new[S["live"]] = self._live(new, c.disc_found, c.host_found,
                                    c.hv_c.sum(1) if hv_total is None else hv_total)
        s.copy_(new)

    def _shard_level(self, c: graphs.ShardCarry) -> None:
        """One level of a block over every shard, in place: the gate
        (``_live``, the reference loop's ``cond``), the superstep and its
        commit. A level whose gate is closed leaves the carry as it was.
        The level's whole device-side semantics; the graphs replay it."""
        live = self._live(c.s, c.disc_found, c.host_found, c.hv_c.sum(1))
        self._shard_commit(c, live, self._shard_step(c, live))

    # --- programs ---------------------------------------------------------------

    def _key(self) -> Tuple:
        world = 1 if self._group is None else self._group.world
        return graphs.shard_key(self._D, self._Fl, self._Cl, self._K, self._levels_per_dispatch,
                                self._hv_cap, self._dedup, self._max_probes, self._sym_tag,
                                ranks=(world, self._r0))

    def _carry(self) -> graphs.ShardCarry:
        return self._programs.shard_carry(self._key(), self._W, self._P, len(self._hv_idx),
                                          self._reduce_width if self._group is not None else 0)

    def _program(self):
        """The program of the current shapes (a ``graphs.RankProgram`` on a
        rank): captured on first use on a card."""
        key = self._key()
        prog = self._programs.shard_programs.get(key)
        if prog is None or (self._use_graphs and prog.graph is None):
            carry = self._carry()
            t0 = time.perf_counter()
            if self._group is not None:
                prog = self._programs.make_rank(key, carry, *self._rank_segments(carry),
                                                graph=self._use_graphs)
            else:
                prog = self._programs.make_shard(
                    key, carry, functools.partial(self._shard_level, carry), graph=self._use_graphs)
            if self._use_graphs:
                self._counters.inc("graph_captures")
                self._capture_s += time.perf_counter() - t0
        return prog

    def _reshaped(self, old_key: Tuple) -> None:
        """After a growth: the programs of the old shapes are dropped (their
        carry with them when the frontier or table grew), and on the fused
        path the program of the new shapes is made at once, so that a later
        check of the model, which starts at the grown capacities (the
        hints), finds it."""
        had = old_key in self._programs.shard_programs
        if graphs.shard_shape(old_key) != graphs.shard_shape(self._key()):
            self._programs.drop_shard(graphs.shard_shape(old_key))
        else:
            self._programs.shard_programs.pop(old_key, None)
        if had and self._levels_per_dispatch > 1:
            self._program()

    def _load(self, c: graphs.ShardCarry, budget: int, remaining: int) -> np.ndarray:
        """The checker's state and the block's inputs into the carry;
        returns the block scalars the host wrote."""
        c.frontier.copy_(self._frontier)
        c.ebits.copy_(self._frontier_ebits)
        c.counts.copy_(torch.as_tensor(self._counts[self._local]))
        kind = type(self._tables[0])
        for d, t in enumerate(self._tables):
            for dst, src in zip(c.table, t[:kind.PLANES]):
                dst[d].copy_(src)
            for j, n in enumerate(t[kind.PLANES:]):
                c.table_n[d, j] = n
        c.disc_found.copy_(self._disc_found)
        c.disc_fp.copy_(self._disc_fp)
        c.host_found.copy_(torch.tensor([n in self._found_names for n in self._prop_names],
                                        dtype=torch.bool))
        for t in (c.lvl, c.hv_w, c.hv_f, c.hv_c, c.hv_tot):
            t.zero_()
        scalars = dict.fromkeys(graphs.SLOTS, 0)
        scalars.update(f_count=int(self._counts.sum()), budget=budget, remaining=remaining)
        c.s.copy_(torch.tensor([scalars[k] for k in graphs.SLOTS], dtype=DTYPE))
        c.s[S["live"]] = self._live(c.s, c.disc_found, c.host_found, c.hv_c.sum(1))
        return np.array([scalars[k] for k in graphs.SLOTS], dtype=np.int64)

    def _keep(self, c: graphs.ShardCarry, counts: np.ndarray) -> None:
        """The committed state out of the carry, cloned: a later block of
        another checker reuses the carry."""
        self._frontier = c.frontier.clone()
        self._frontier_ebits = c.ebits.clone()
        self._counts = counts
        self._tables = [self._carried_table(c, d) for d in range(self._Dl)]
        self._tables = [type(t)(*(x.clone() for x in t)) for t in self._tables]
        self._disc_found, self._disc_fp = c.disc_found.clone(), c.disc_fp.clone()

    # --- growth ---------------------------------------------------------------

    def _load_doublings(self, unique: int) -> int:
        """Doublings of every shard's table that bring ``unique`` keys within
        the structure's load share of the mesh's slots (hash 1/4, sorted and
        delta 3/4; uniform ownership keeps each shard near the mean)."""
        num, den = self.LOAD[self._dedup]
        doublings = 0
        while unique * den > self._D * self._slots_per_shard(self._Cl << doublings) * num:
            doublings += 1
        return doublings

    def _grow_table(self, doublings: int = 1) -> None:
        """Double every shard's table ``doublings`` times, one
        ``grow_table`` span each: a plane copy of the sorted set, a rehash
        of the hash set in slot order, the delta set rebuilt with its tier
        folded into a main tier of at least twice its rows (the widest
        shard's need sets every shard's capacity)."""
        old_key = self._key()
        dev = self._device
        for _ in range(doublings):
            cap = self._Cl * 2
            with self._tracer.span("grow_table", dedup=self._dedup, shards=self._D,
                                   capacity=self._D * cap):
                if self._dedup == "hash":
                    self._tables = [hashset.grow(t, cap, self._max_probes) for t in self._tables]
                elif self._dedup == "sorted":
                    self._tables = [self._ds.grow(t, cap) for t in self._tables]
                else:
                    rows = [deltaset.occupied_rows(t) for t in self._tables]
                    widest = max(len(r[0]) for r in rows)
                    if self._group is not None:
                        widest = self._group.reduce([widest], "max")[0]
                    while cap < 2 * widest:
                        cap *= 2
                    self._tables = [deltaset.from_entries(*r, cap, dev) for r in rows]
            self._Cl = cap
            self._counters.inc("table_grows")
        self._cap_hints()[f"table_{self._dedup}"] = self._D * self._Cl
        self._reshaped(old_key)

    def _flush(self, shards: List[int], proactive: bool) -> bool:
        """Fold the delta tiers of global ``shards`` into their main tiers
        (``deltaset.maintain``, one ``delta_flush`` span; each rank its own
        shards); False, with every table as it was, when a main tier of any
        shard cannot hold its rows."""
        mine = [d for d in shards if self._local.start <= d < self._local.stop]
        with self._tracer.span("delta_flush", proactive=proactive, shards=len(shards)):
            flushed, failed = [], False
            for d in mine:
                table, overflow = deltaset.maintain(self._tables[d - self._r0])
                if bool(overflow):
                    failed = True
                    break
                flushed.append(table)
            if self._any(failed):
                return False
        for d, table in zip(mine, flushed):
            self._tables[d - self._r0] = table
        self._counters.inc("delta_flushes", len(shards))
        return True

    def _delta_rows(self) -> np.ndarray:
        """Each shard's delta-tier rows, every shard's (gathered on a rank)."""
        return self._gather(torch.tensor([int(t.n_delta) for t in self._tables]))

    def _grow_table_if_loaded(self) -> bool:
        """The load rule after each block (the single-chip engine's), and
        the delta set's flush of every shard whose tier is three quarters
        full. Returns whether a table changed."""
        doublings = self._load_doublings(self._unique_count)
        if doublings:
            self._grow_table(doublings)
        if self._dedup != "delta":
            return doublings > 0
        cap = self._tables[0].delta_capacity
        full = [d for d, n in enumerate(self._delta_rows()) if n * 4 > cap * 3]
        if full and not self._flush(full, proactive=True):
            self._grow_table()
        return doublings > 0 or bool(full)

    def _resolve_table_overflow(self) -> None:
        """A shard's insert overflowed its visited set: under the delta set
        every shard with rows in its tier flushes and the level runs again;
        an overflow with every tier empty, or a flush a main tier cannot
        hold, grows every shard's table."""
        if self._dedup == "delta":
            pending = [d for d, n in enumerate(self._delta_rows()) if n > 0]
            if pending and self._flush(pending, proactive=False):
                return
        self._grow_table()

    def _grow_frontier(self) -> None:
        """Double every shard's frontier rows, and the route slots with them."""
        self._counters.inc("frontier_grows")
        old_key = self._key()
        D, Fl = self._D, self._Fl
        with self._tracer.span("grow_frontier", shards=D, rows=D * Fl * 2):
            self._frontier = torch.cat([self._frontier, torch.zeros_like(self._frontier)], 1)
            self._frontier_ebits = torch.cat(
                [self._frontier_ebits, torch.zeros_like(self._frontier_ebits)], 1)
            self._Fl = Fl * 2
        self._cap_hints()["frontier"] = D * self._Fl
        local_cand = self._Fl * self._A
        self._K = min(local_cand, max(self._K, (local_cand // D) * 4))
        self._reshaped(old_key)

    def _grow_route(self) -> None:
        """Double the route slots a (source, destination) pair."""
        self._counters.inc("route_grows")
        old_key = self._key()
        self._K = min(self._Fl * self._A, self._K * 2)
        self._cap_hints()["route"] = self._K
        self._reshaped(old_key)

    # --- the level loop -----------------------------------------------------------

    def _entry_checks(self) -> bool:
        """Dispatch preamble; False when nothing is left to run."""
        if self._target_reached or self._exhausted:
            return False
        if self._P > 0 and all(n in self._found_names for n in self._prop_names):
            return False
        if self._counts.sum() == 0:
            self._exhausted = True
            return False
        self._max_depth = max(self._max_depth, self._depth)
        if self._target_max_depth is not None and self._depth >= self._target_max_depth:
            # A depth-halted checker reads as frontier-empty everywhere.
            self._counts = np.zeros_like(self._counts)
            self._exhausted = True
            return False
        return True

    def _run_block(self) -> None:
        """One dispatch: a block of up to ``levels_per_dispatch`` levels of
        CUDA-graph replays (on the CPU, the same levels eagerly), or with
        ``levels_per_dispatch=1`` one level run eagerly, after the visitor."""
        if not self._entry_checks():
            return
        if self._levels_per_dispatch == 1:
            if self._visitor is not None:
                self._visit_frontier()
            return self._run_levels("single")
        return self._run_levels("fused")

    def _run_levels(self, flavor: str) -> None:
        """Up to ``levels_per_dispatch`` levels, one host round trip a block
        (the reference's ``_run_block_fused``; ``flavor`` "single" runs the
        level eagerly and makes no program). An overflow commits every
        level before the overflowing one, grows what overflowed, and
        re-enters with the budget left."""
        budget_left = self._levels_per_dispatch
        if self._target_max_depth is not None:
            budget_left = min(budget_left, self._target_max_depth - self._depth)
        graph = flavor == "fused" and self._use_graphs
        retry = False
        while budget_left > 0:
            remaining = 2**62
            if self._target_state_count is not None:
                remaining = max(1, self._target_state_count - self._state_count)
            run_rows = self._D * self._Fl
            fresh = flavor == "fused" and self._key() not in self._programs.shard_programs
            if self._heartbeat is not None:
                self._heartbeat.beat("dispatch", compile=fresh, bucket=run_rows,
                                     depth=self._depth, states=self._state_count)
            with self._tracer.span(
                "dispatch", flavor=flavor, bucket=run_rows, cand=self._D * self._K,
                compile=fresh, retry=retry, dedup=self._dedup, compaction="mesh",
                shards=self._D,
            ) as span:
                if flavor == "fused":
                    prog = self._program()
                    carry = prog.carry
                    if self._group is not None:
                        run = functools.partial(prog.run, eager=not graph)
                    else:
                        run = functools.partial(prog.run, functools.partial(self._shard_level, carry),
                                                not graph)
                else:
                    carry = self._carry()
                    if self._group is not None:
                        run = graphs.RankProgram(carry, *self._rank_segments(carry)).run
                    else:
                        run = functools.partial(self._shard_level, carry)
                loaded = self._load(carry, budget_left, remaining)
                self._counters.inc("dead_replays", graphs.replay_block(
                    lambda _row: run(), carry.s, loaded, budget_left))
                n = len(graphs.SLOTS)
                vals = torch.cat([carry.s, carry.lvl.flatten()]).tolist()
                # The shards' counts and host-verified candidates: every
                # rank's, on a rank.
                per_shard = self._gather(torch.cat([carry.counts[:, None], carry.hv_c.T], 1))
                s = dict(zip(graphs.SLOTS, vals))
                committed = s["committed"]
                span.set(committed=committed)
            counts = per_shard[:, 0].astype(np.int64)
            lvl = np.asarray(vals[n:]).reshape(3, -1)
            hv_counts = per_shard[:, 1:].T
            retry = False
            self.dispatch_log.append((run_rows, committed))
            self._keep(carry, counts)
            self.level_log.extend(
                {"depth": self._depth + i, "frontier": int(lvl[0, i]),
                 "generated": int(lvl[1, i]), "unique": int(lvl[2, i])}
                for i in range(committed))
            self._state_count += s["tot_states"]
            self._unique_count += s["tot_unique"]
            self._depth += committed
            if committed:
                self._max_depth = max(self._max_depth, self._depth - 1)
            if self._heartbeat is not None:
                self._heartbeat.commit(depth=self._depth, states=self._state_count)
            budget_left -= committed
            self._confirm_hv_candidates(carry.hv_w, carry.hv_f, hv_counts)
            del carry, run
            # A table the boundary grew or flushed has room: an overflowing
            # level runs again on it.
            made_room = self._grow_table_if_loaded()
            if self._settle():
                return
            if s["c_ovf"]:
                self._raise_codec_overflow()
            if s["t_ovf"]:
                if not made_room:
                    self._resolve_table_overflow()
                retry = True
                continue
            if s["f_ovf"]:
                self._grow_frontier()
                retry = True
                continue
            if s["cc_ovf"]:
                self._grow_route()
                retry = True
                continue
            if committed == 0 or self._counts.sum() == 0:
                break
            if self._P > 0 and all(n in self._found_names for n in self._prop_names):
                break

    def _confirm_hv_candidates(self, hv_w, hv_f, counts: np.ndarray) -> None:
        """The exact host re-check of the candidates the shards flagged for
        the host-verified properties (the reference's ``_confirm_hv_impl``):
        for each property not found yet, the first candidate in shard-major
        order (shard 0's rows first, each shard's in level and frontier
        order) whose exact condition confirms it; rows with a (0, 0)
        fingerprint are padding. Raises when more rows were flagged than
        were kept and none of the kept ones confirmed."""
        if not self._hv_idx:
            return
        t0 = time.monotonic()
        with self._tracer.span("host_verify"):
            words = fps = None
            for j, i in enumerate(self._hv_idx):
                prop = self._properties[i]
                total = int(counts[j].sum())
                if prop.name in self._found_names or total == 0:
                    continue
                self.hv_stats["flagged"] += total
                if words is None:
                    # [n_hv, D, cap, ...]: every rank's shards, shard-major.
                    words = self._gather(hv_w.transpose(0, 1)).swapaxes(0, 1).astype(np.uint32)
                    words = words.reshape(len(self._hv_idx), -1, self._W)
                    fps = self._gather(hv_f.transpose(0, 1)).swapaxes(0, 1).astype(np.uint32)
                    fps = fps.reshape(len(self._hv_idx), -1, 2)
                confirmed, collected = False, 0
                for r in range(words.shape[1]):
                    fp_hi, fp_lo = int(fps[j, r, 0]), int(fps[j, r, 1])
                    if fp_hi == 0 and fp_lo == 0:
                        continue
                    collected += 1
                    self.hv_stats["host_checked"] += 1
                    holds = bool(prop.condition(self._model, self._model.unpack(words[j, r])))
                    if holds != (prop.expectation == Expectation.ALWAYS):
                        self._found_names[prop.name] = (fp_hi << 32) | fp_lo
                        self.hv_stats["confirmed"] += 1
                        confirmed = True
                        break
                    self.hv_stats["cleared"] += 1
                if not confirmed and total > collected:
                    raise RuntimeError(
                        f"{total} candidate states for host-verified property {prop.name!r} "
                        f"in one super-step, none of the {collected} collected confirmed — "
                        "tighten the conservative device predicate or raise "
                        "spawn_xla(host_verified_cap=...)."
                    )
        self.hv_stats["host_sec"] += time.monotonic() - t0

    def _visit_frontier(self) -> None:
        """The single-chip engine's visitor contract over the shards'
        frontiers, shard by shard: at most ``visit_cap`` states a level,
        with a loud warning past it."""
        total = int(self._counts.sum())
        if total > self._visit_cap:
            warnings.warn(
                f"visitor: frontier has {total} states at depth {self._depth};"
                f" visiting only the first {self._visit_cap} (host-side path "
                "reconstruction per state does not scale — use visitors on "
                "small runs, or raise spawn_xla(visit_cap=...))",
                RuntimeWarning,
                stacklevel=2,
            )
        rows = self._live_frontier()[0][:self._visit_cap]
        parents = self._parent_map()
        for fp in self._row_fps(rows) if len(rows) else ():
            self._visitor.visit(self._model, self._path_for(fp, parents))

    # --- Checker API -------------------------------------------------------------

    def model(self) -> Model:
        return self._model

    def state_count(self) -> int:
        return self._state_count

    def unique_state_count(self) -> int:
        return self._unique_count

    def max_depth(self) -> int:
        return self._max_depth

    def is_done(self) -> bool:
        if self._exhausted or self._target_reached:
            return True
        if self._P > 0 and all(n in self._found_names for n in self._prop_names):
            return True
        return self._counts.sum() == 0 and self._state_count > 0

    def metrics(self) -> Dict[str, Any]:
        """The reference mesh engine's snapshot (every key of its
        ``metrics()``; host reads only) plus the port's ``device``,
        ``graph_capture_s``, ``graph_captures`` and ``dead_replays``."""
        cap = self._D * self._slots_per_shard(self._Cl)
        return {
            "engine": "xla-sharded",
            "backend": self._backend,
            "device": str(self._device),
            "dedup": self._dedup,
            "compaction": "mesh",
            "symmetry": self._sym_tag,
            "ladder": "none",
            "cand_ladder_k": 1,
            "shrink_exit": False,
            "levels_per_dispatch": self._levels_per_dispatch,
            "checkpoint_to": self._autockpt.path if self._autockpt else None,
            "metrics_to": self._recorder.path if self._recorder else None,
            "resumed_from": self._resumed_from,
            "last_checkpoint_level":
                self._last_checkpoint["depth"] if self._last_checkpoint else None,
            "shards": self._D,
            "frontier_rows_per_shard": self._Fl,
            "table_slots_per_shard": self._Cl,
            "route_slots": self._K,
            "state_count": self._state_count,
            "unique_state_count": self._unique_count,
            "depth": self._depth,
            "max_depth": self._max_depth,
            "frontier_count": int(self._counts.sum()),
            "frontier_capacity": self._D * self._Fl,
            "table_capacity": cap,
            "table_occupancy": self._unique_count / max(cap, 1),
            "dispatches": len(self.dispatch_log),
            "levels_committed": sum(c for _, c in self.dispatch_log),
            "cand_retries": 0,
            "hv": dict(self.hv_stats),
            "graph_capture_s": self._capture_s,
            # The rank mesh's collective backend and the host's side of its
            # route exchange (None in one process).
            "mesh_backend": None if self._group is None else self._group.backend,
            "exchange": None if self._group is None else self._group.exchange_totals(),
            **self._counters.snapshot(),
        }

    def _parent_map(self) -> native.AnyParentMap:
        """One ``native.ParentMap`` over every shard's occupied rows
        (``XlaChecker._parent_map``)."""
        return native.ParentMap(*self._occupied_rows())

    def discoveries(self):
        parents = self._parent_map()
        return {name: self._path_for(fp64, parents) for name, fp64 in self._found_names.items()}
