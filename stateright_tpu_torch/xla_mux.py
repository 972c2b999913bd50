"""Multiplexed superstep: K same-model checks through one dispatch sequence.

Counterpart of ``stateright_tpu/xla_mux.py``. Under many small checks of
one model, each check pays a level's fixed costs (the launches, the host's
round trip) alone; :class:`MuxChecker` drives K of them together:

- Each lane is a full :class:`~stateright_tpu_torch.xla.XlaChecker` over
  the SAME model instance (one program cache, shared capacity hints). The
  lanes stay the source of truth for per-lane state, bookkeeping,
  checkpoints and metrics; the mux layer only batches the device work.
- The device program: the reference runs ``jax.vmap`` of the single-level
  superstep inside a ``lax.while_loop``. Here one mux program is one CUDA
  graph a level (:meth:`MuxChecker._mux_level`), replayed in blocks as
  ``graphs.replay_block`` replays the solo engine's. It holds the K lanes'
  supersteps over their own carries (each lane's gate: the mux's and its
  own), ONE reduction of the overflow flags of every lane that ran, and
  the K lanes' commits (or, for the hash set, undos) gated by that shared
  ``ok``. A lane that is done, or has no budget left, rides along with its
  gate closed, so its frontier, table planes and counts stay as they were,
  bit for bit. Each lane still launches its own kernels inside the graph
  (K times the launches; a lane axis in the kernels is ROADMAP D).
- Any running lane's overflow (table, frontier, candidate) leaves that level
  uncommitted for every lane; the host grows every running lane alike
  (keeping the carries rectangular; capacities change cost, never counts)
  and re-enters: the solo engine's retry discipline.

Exactness: counts do not depend on the bucket, a level whose gate is closed
changes nothing, and uncommitted levels rerun deterministically, so every
lane's generated and unique counts, levels and discoveries equal its solo
run's (``tests/test_torch_mux.py``).

Exclusions (typed :class:`MuxError`): host-verified properties (their host
confirmation every level would serialize the lanes), the delta visited set
(its flush is a host-invoked step), and visitors. The mux runs one rung (no
candidate ladder), as the reference's does.

Telemetry: each lane's ``level_log`` rows gain ``lanes``/``lanes_active``,
the mux's ``dispatch_log`` records ``(run_cap, committed, lanes,
lanes_active)`` a block (each lane's own log keeps its ``(run_cap,
committed)`` pairs), dispatch spans have flavor ``mux``, and
:meth:`MuxChecker.metrics` reports ``engine: "xla-mux"``, ``mux_lanes``,
``mux_lanes_active`` and ``mux_dispatches_saved`` (``lanes_active - 1``
summed over the blocks).
"""

from __future__ import annotations

import functools
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from . import graphs
from .graphs import OVF, S
from .ops.words import DTYPE
from .xla import NO_TARGET, RUN_BUCKET_FLOOR, XlaChecker, ladder_buckets


class MuxError(ValueError):
    """A lane set the multiplexed engine cannot batch (typed, so callers can
    fall back to solo checks deliberately)."""


def _check_lanes(lanes: List[XlaChecker]) -> None:
    if not lanes:
        raise MuxError("mux needs at least one lane")
    for ln in lanes:
        if type(ln) is not XlaChecker:
            raise MuxError(f"mux lanes must be XlaChecker instances, got {type(ln).__name__}")
    if len(set(map(id, lanes))) != len(lanes):
        raise MuxError("mux lanes must be distinct checker instances")
    first = lanes[0]
    for ln in lanes[1:]:
        if ln._model is not first._model:
            raise MuxError(
                "mux lanes must share ONE model instance (same shape class "
                "AND shared program caches); resolve the spec once and "
                "build every lane from it"
            )
    if first._hv_idx:
        raise MuxError(
            "host-verified properties cannot be multiplexed (their "
            "per-superstep host confirmation would serialize the lanes)"
        )
    if first._dedup == "delta":
        raise MuxError(
            "the delta dedup structure cannot be multiplexed (its flush "
            "is a host-invoked maintain program)"
        )
    for ln in lanes:
        if ln._visitor is not None:
            raise MuxError("visitors cannot be multiplexed")
    for attr in ("_dedup", "_compaction", "_sym_tag", "_max_probes", "_device",
                 "_levels_per_dispatch"):
        vals = {getattr(ln, attr) for ln in lanes}
        if len(vals) != 1:
            raise MuxError(f"mux lanes disagree on {attr.lstrip('_')}: {sorted(map(str, vals))}")
    caps = {(ln._frontier_capacity, ln._table_cap()) for ln in lanes}
    if len(caps) != 1:
        raise MuxError(
            "mux lanes must start at identical frontier/table capacities "
            f"(got {sorted(caps)}); pass the same spawn capacities to every lane"
        )


class MuxChecker:
    """Drive K lane checkers through one multiplexed level a replay.

    The constructor takes fully spawned lanes (``spawn_xla`` each lane with
    identical capacities over one shared model instance; a lane's
    ``checkpoint_to=``/``metrics_to=`` and resume work unchanged, since the
    lanes hold real state). ``MuxChecker`` then replaces the lanes' own
    dispatch loops: call :meth:`run_to_completion`, or :meth:`_run_block`
    until :meth:`is_done`."""

    PHASE_NAMES = XlaChecker.PHASE_NAMES
    _log_phases = XlaChecker._log_phases

    def __init__(self, lanes: List[XlaChecker]):
        _check_lanes(lanes)
        self.lanes = list(lanes)
        self.k = len(self.lanes)
        lead = self.lanes[0]
        self._model = lead._model
        self._device = lead._device
        self._levels_per_dispatch = lead._levels_per_dispatch
        self._programs = lead._programs
        self._use_graphs = lead._use_graphs
        # One device call serves every lane, so the mux layer owns the
        # dispatch spans, the heartbeat and the phase split (the lead
        # lane's); the lanes keep their checkpoint and metrics hooks.
        self._tracer = lead._tracer
        self._heartbeat = lead._heartbeat
        self._phases = lead._phases
        #: One phase-split dict a block (see ``XlaChecker.phase_log``).
        self.phase_log: List[Dict[str, Any]] = []
        #: One ``(run_cap, committed, lanes, lanes_active)`` a block.
        self.dispatch_log: List[Tuple[int, int, int, int]] = []
        self._dispatches_saved = 0
        self._captures = 0
        self._capture_s = 0.0

    # --- the program ---------------------------------------------------------

    def _key(self, run_cap: int, cand_cap: int, table_cap: int) -> Tuple:
        lead = self.lanes[0]
        return graphs.mux_key(self.k, run_cap, cand_cap, self._levels_per_dispatch,
                              lead._sym_tag, lead._max_probes, lead._dedup, table_cap)

    def _program(self, run_cap: int, cand_cap: int, table_cap: int) -> graphs.Program:
        """The mux program of this bucket and candidate cap at the running
        lanes' table capacity: captured on first use on a card."""
        key = self._key(run_cap, cand_cap, table_cap)
        prog = self._programs.mux_programs.get(key)
        if prog is None or (self._use_graphs and prog.graph is None):
            lead = self.lanes[0]
            carry = self._programs.mux_carry(lead._W, lead._P, table_cap,
                                             self._levels_per_dispatch, self.k, lead._dedup)
            carry.frontier(run_cap)  # allocated before any capture
            body = functools.partial(self._mux_level, carry, run_cap, cand_cap)
            t0 = time.perf_counter()
            prog = self._programs.make_mux(key, carry, body, graph=self._use_graphs)
            if self._use_graphs:
                self._captures += 1
                self._capture_s += time.perf_counter() - t0
        return prog

    def _mux_level(self, mc: graphs.MuxCarry, run_cap: int, cand_cap: int) -> None:
        """One multiplexed level, in place: each lane's superstep under its
        gate (the mux's ``live`` and the lane's own), one reduction of the
        running lanes' overflow flags into the shared ``ok``, each lane's
        commit (or undo) where its gate and ``ok`` hold, and the mux
        scalars: ``committed`` counts a level that ran and committed,
        ``live`` is the next level's gate. Nothing waits on the host."""
        ms = mc.s
        go = ms[S["live"]] > 0
        steps = []
        for ln, c in zip(self.lanes, mc.lanes):
            gate = go & (c.s[S["live"]] > 0)
            steps.append((gate, ln._level_step(c, run_cap, cand_cap, run_cap, gate)))
        ok = ~torch.stack([gate & st.overflow for gate, st in steps]).any()
        flags = torch.stack([torch.where(gate, st.flags, 0) for gate, st in steps]).amax(0)
        for ln, c, (gate, st) in zip(self.lanes, mc.lanes, steps):
            ln._level_commit(c, cand_cap, run_cap, gate, st, gate & ok, slot=ms[S["committed"]])
        new = ms.clone()
        new[S["committed"]] += (go & ok).to(DTYPE)
        new[OVF] = torch.where(go, flags, ms[OVF])
        lanes_live = torch.stack([c.s[S["live"]] > 0 for c in mc.lanes]).any()
        new[S["live"]] = (go & ok & (new[S["committed"]] < ms[S["budget"]]) & lanes_live).to(DTYPE)
        ms.copy_(new)

    # --- the host loop ---------------------------------------------------------

    def _run_cap_for(self, running: List[XlaChecker], table_cap: int) -> int:
        """The snug bucket of the running lanes' ladder for the widest
        running frontier, or a bucket up to ``LADDER_REUSE_BOUND`` times it
        that already has a mux program."""
        lead = running[0]
        want = max(4 * max(max(ln._frontier_count for ln in running), 1), RUN_BUCKET_FLOOR)
        buckets = ladder_buckets(lead._frontier_capacity)
        cap = next((b for b in buckets if b >= want), buckets[-1])
        tail = self._key(0, 0, table_cap)[4:]
        reusable = [k[2] for k in self._programs.mux_programs
                    if k[:2] == ("mux", self.k) and k[4:] == tail
                    and cap <= k[2] <= cap * lead.LADDER_REUSE_BOUND]
        return min(reusable) if reusable else cap

    def _load(self, mc: graphs.MuxCarry, run_cap: int, lane_budget, remaining,
              budget: int) -> None:
        """The running lanes' state into their carries (a lane without a
        budget gets a closed gate and nothing else), and the mux scalars."""
        for ln, c, lb, rem in zip(self.lanes, mc.lanes, lane_budget, remaining):
            if lb > 0:
                ln._load(c, run_cap, int(lb), int(rem), 0)
            else:
                c.s.zero_()
                c.lvl.zero_()
        mc.s.zero_()
        mc.s[S["budget"]] = budget
        mc.s[S["live"]] = torch.stack([c.s[S["live"]] > 0 for c in mc.lanes]).any() & (budget > 0)

    @staticmethod
    def _grow_loaded(running: List[XlaChecker]) -> bool:
        """The solo engine's load rule over the running lanes: all of them
        grow alike, so that their carries stay rectangular, while the
        busiest one is past its structure's load share; a lane that is done
        keeps its planes as they are."""
        doublings = running[0]._load_doublings(max(ln._unique_count for ln in running))
        for ln in running if doublings else ():
            ln._grow_table(doublings, reprogram=False)
        return doublings > 0

    def _lane_budgets(self, host_active: List[bool], budget_left: int):
        """Each lane's level budget (0 for a lane that is done, cut at its
        target depth) and state-count headroom."""
        lane_budget = np.zeros(self.k, dtype=np.int64)
        remaining = np.full(self.k, NO_TARGET, dtype=np.int64)
        for i, ln in enumerate(self.lanes):
            if not host_active[i]:
                continue
            lane_budget[i] = budget_left
            if ln._target_max_depth is not None:
                lane_budget[i] = max(0, min(budget_left, ln._target_max_depth - ln._depth))
            if ln._target_state_count is not None:
                remaining[i] = max(1, ln._target_state_count - ln._state_count)
        return lane_budget, remaining

    def _run_block(self) -> None:
        """Up to ``levels_per_dispatch`` BFS levels for every running lane,
        one multiplexed level a replay (the mux analogue of the solo
        ``_run_block_fused``; each lane ingests, settles and resolves its
        overflows through the solo engine's own steps)."""
        host_active = [ln._entry_checks() for ln in self.lanes]
        if not any(host_active):
            return
        lead = self.lanes[0]
        budget_left = self._levels_per_dispatch
        running = [ln for ln, a in zip(self.lanes, host_active) if a]
        run_cap = self._run_cap_for(running, running[0]._table_cap())
        retry = False
        while budget_left > 0:
            lane_budget, remaining = self._lane_budgets(host_active, budget_left)
            if not lane_budget.any():
                break
            running = [ln for ln, b in zip(self.lanes, lane_budget) if b > 0]
            caps = {ln._table_cap() for ln in running}
            if len(caps) != 1:
                raise RuntimeError(f"mux lanes at different table capacities: {sorted(caps)}")
            (table_cap,) = caps
            cand_cap = running[0]._cand_cap_for(run_cap)
            key = self._key(run_cap, cand_cap, table_cap)
            prog = self._programs.mux_programs.get(key)
            fresh = prog is None or (self._use_graphs and prog.graph is None)
            lanes_entry = len(running)
            if self._heartbeat is not None:
                self._heartbeat.beat("dispatch", compile=fresh, bucket=run_cap, lanes=self.k,
                                     lanes_active=lanes_entry)
            with self._tracer.span(
                "dispatch", flavor="mux", bucket=run_cap, cand=cand_cap, lanes=self.k,
                lanes_active=lanes_entry, compile=fresh, retry=retry, dedup=lead._dedup,
                compaction=lead._compaction,
            ) as span:
                pt0 = time.monotonic() if self._phases else 0.0
                prog = self._program(run_cap, cand_cap, table_cap)
                mc = prog.carry
                self._load(mc, run_cap, lane_budget, remaining, budget_left)
                eager = not self._use_graphs
                body = functools.partial(self._mux_level, mc, run_cap, cand_cap)
                drain = [] if self._phases else None
                pt1 = time.monotonic() if self._phases else 0.0
                graphs.replay_block(lambda _row: prog.run(body, eager), mc.s,
                                    np.zeros(len(graphs.SLOTS), dtype=np.int64), budget_left, drain)
                vals = torch.cat([mc.s, *(c.s for c in mc.lanes),
                                  *(c.lvl.flatten() for c in mc.lanes)]).tolist()
                n = len(graphs.SLOTS)
                ms = dict(zip(graphs.SLOTS, vals[:n]))
                committed = ms["committed"]
                span.set(committed=committed)
                pt4 = time.monotonic() if self._phases else 0.0
            lane_s = [dict(zip(graphs.SLOTS, vals[n * (i + 1):n * (i + 2)])) for i in range(self.k)]
            lvl = np.asarray(vals[n * (self.k + 1):]).reshape(self.k, graphs.LVL_ROWS, -1)
            self.dispatch_log.append((run_cap, committed, self.k, lanes_entry))
            if self._phases:
                self._log_phases(span, flavor="mux", bucket=run_cap, fresh=fresh,
                                 committed=committed, stamps=(pt0, pt1, *drain, pt4))
            self._dispatches_saved += max(0, lanes_entry - 1)
            retry = False
            # A slot's lanes_active: the lanes that committed a level there.
            ran = lvl[:, 3, :committed] > 0
            per_slot = ran.sum(axis=0)

            def extra(slot: int) -> Dict[str, int]:
                return {"lanes": self.k, "lanes_active": int(per_slot[slot])}

            for i, ln in enumerate(self.lanes):
                if lane_budget[i] == 0:
                    continue
                slots = np.flatnonzero(ran[i])
                if len(slots) != lane_s[i]["committed"]:
                    raise RuntimeError(f"mux lane {i}: {lane_s[i]['committed']} levels committed, "
                                       f"{len(slots)} recorded")
                ln._ingest(mc.lanes[i], run_cap, lane_s[i], lvl[i], slots, extra)
            # Nothing of this block's program is used past here: a table
            # growth below drops it with its carry.
            del prog, mc, body
            if self._heartbeat is not None:
                self._heartbeat.commit(depth=max(ln._depth for ln in self.lanes),
                                       states=sum(ln._state_count for ln in self.lanes))
            budget_left -= committed
            for ln in running:
                ln._settle()
            # The lanes that run on: every later load is of these, so they
            # grow together, and a lane that is done keeps its planes.
            host_active = [a and ln._entry_checks() for a, ln in zip(host_active, self.lanes)]
            running = [ln for ln, a in zip(self.lanes, host_active) if a]
            if not running:
                break
            made_room = self._grow_loaded(running)
            # Each running lane resolves the shared overflow as its solo run
            # would (alike, as their tables and capacities are); the level
            # runs again at the widest bucket any lane's ladder chose.
            nxt = [ln._resolve_overflow(ms, run_cap, made_room, reprogram=False)
                   for ln in running]
            if nxt[0] is not None:
                if ms["cc_ovf"]:
                    # The outgrown program is dead weight: this mux looks up
                    # the grown cap from now on.
                    self._programs.mux_programs.pop(key, None)
                run_cap = max(nxt)
                retry = True
                continue
            if committed == 0:
                break

    # --- Checker-like API ------------------------------------------------------

    def is_done(self) -> bool:
        return all(ln.is_done() for ln in self.lanes)

    def run_to_completion(self) -> None:
        while not self.is_done():
            before = [(ln._depth, ln._state_count, ln.is_done()) for ln in self.lanes]
            self._run_block()
            after = [(ln._depth, ln._state_count, ln.is_done()) for ln in self.lanes]
            if before == after:
                raise RuntimeError("mux dispatch made no progress")

    def state_count(self) -> int:
        return sum(ln.state_count() for ln in self.lanes)

    def unique_state_count(self) -> int:
        return sum(ln.unique_state_count() for ln in self.lanes)

    def max_depth(self) -> int:
        return max(ln.max_depth() for ln in self.lanes)

    def metrics(self) -> Dict[str, Any]:
        """The mux layer's own snapshot (each lane's ``metrics()`` keeps the
        engine's schema), with the port's graph counters."""
        return {
            "engine": "xla-mux",
            "backend": self._device.type,
            "device": str(self._device),
            "mux_lanes": self.k,
            "mux_lanes_active": sum(1 for ln in self.lanes if not ln.is_done()),
            "mux_dispatches_saved": self._dispatches_saved,
            "dispatches": len(self.dispatch_log),
            "levels_committed": sum(c for _, c, _, _ in self.dispatch_log),
            "state_count": self.state_count(),
            "unique_state_count": self.unique_state_count(),
            "max_depth": self.max_depth(),
            "graph_captures": self._captures,
            "graph_capture_s": self._capture_s,
        }
