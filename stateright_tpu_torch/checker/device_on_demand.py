"""Demand-driven checking on the GPU engine: the Explorer's backend for
packed models.

Counterpart of ``stateright_tpu/checker/device_on_demand.py``. stateright's
Explorer wraps its real engine (``src/checker/explorer.rs:81-103``); this
checker keeps the interactive contract (compute nothing until asked) while
every expansion, property evaluation, dedup and witness reconstruction runs
through the GPU engine (``xla.XlaChecker``):

- a **targeted expansion** (the user clicked a state) loads exactly the
  clicked packed rows as the frontier and runs one superstep over them
  (``_run_block_single``: ``compact``, then ``merge_insert`` or the hash
  insert, against the whole visited set): children dedup against the
  visited set on the device, properties evaluate there, discoveries pin as
  in batch runs;
- pending (discovered but not expanded) rows live in a host pool keyed by
  their device fingerprint, the on-demand analogue of the frontier;
- ``run_to_completion()`` loads the whole pool as the frontier and hands
  over to the inherited fused block of CUDA-graph replays: from there on
  this is the batch engine (counts stay exact; with a pool of mixed depths
  the per-level depth accounting is approximate, as stateright's
  run-to-completion from a driven state is).

The Explorer passes the clicked object states (it has them in hand) to
``check_states``; host fingerprints never need translating to device ones.
So ``check_fingerprint`` stays the batch checkers' no-op (host fingerprints
cannot address device-keyed pending rows), as in the reference.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..ops.words import DTYPE
from ..xla import XlaChecker


class DeviceOnDemandChecker(XlaChecker):
    """Spawned via ``CheckerBuilder.spawn_on_demand(engine="xla")`` or the
    Explorer's ``serve()`` on a packed model."""

    def __init__(self, builder, **kwargs):
        super().__init__(builder, **kwargs)
        self._waiting = True
        #: device fp64 -> (packed row, eventually-bits, depth) of each
        #: pending entry.
        self._pool: Dict[int, Tuple[np.ndarray, int, int]] = {}
        #: ``(found names, discoveries())`` of the last :meth:`discoveries`.
        self._disc_cache = None
        # self._depth is 1 for a fresh init frontier and the restored depth
        # after a checkpoint resume: the pool inherits it either way.
        self._pool_add(self._frontier_rows_host(), self._frontier_ebits_host(), self._depth)

    def _frontier_ebits_host(self) -> np.ndarray:
        return self._frontier_ebits[: self._frontier_count].cpu().numpy()

    def _pool_add(self, rows: np.ndarray, ebits: np.ndarray, depth: int) -> None:
        """File rows as pending entries, fingerprinted in one batched call."""
        if not len(rows):
            return
        for key, row, eb in zip(self._row_fps(rows), rows, ebits.tolist()):
            self._pool[key] = (row.copy(), eb, depth)

    # --- control flow (the on-demand contract) -----------------------------

    def _stopped(self) -> bool:
        """Whether ``_run_block_single`` would refuse to expand: a target
        was crossed or every property is resolved."""
        return self._target_reached or (
            self._P > 0 and all(n in self._found_names for n in self._prop_names)
        )

    def check_state(self, state: Any) -> None:
        """Evaluate and expand the pending entry of this object state, if
        any (the device form of ``OnDemandChecker.check_fingerprint``;
        unknown or already expanded states are ignored). It takes the state,
        not a fingerprint, because pending rows are keyed by their DEVICE
        fingerprint, which only the packed codec computes."""
        self.check_states([state])

    def check_states(self, states) -> None:
        """Batched :meth:`check_state`: every pending entry among ``states``
        expands in one superstep per depth group (the Explorer expands every
        child of a clicked state)."""
        if not self._waiting or self._stopped():
            return
        states = list(states)
        by_depth: Dict[int, list] = {}
        for key in self._host_fps(states) if states else ():
            entry = self._pool.pop(key, None)
            if entry is not None:
                by_depth.setdefault(entry[2], []).append((key, entry))
        for depth, entries in sorted(by_depth.items()):
            if self._stopped():
                # An earlier group crossed a target or pinned the last
                # property: put the rest back untouched.
                self._pool.update(entries)
                continue
            self._expand_rows(
                np.stack([row for _, (row, _, _) in entries]),
                np.asarray([eb for _, (_, eb, _) in entries], dtype=np.int64),
                depth,
            )

    def run_to_completion(self) -> None:
        """Unblock: the whole pending pool becomes the frontier and the
        inherited fused batch engine takes over (on_demand.rs:193-198)."""
        if not self._waiting:
            return
        self._waiting = False
        if not self._pool:
            self._frontier_count = 0
            self._exhausted = True
            return
        entries = list(self._pool.values())
        self._pool.clear()
        rows = np.stack([row for row, _, _ in entries])
        need = 1 << max(int(len(rows) - 1).bit_length(), 4)
        self._frontier_capacity = max(self._frontier_capacity, need)
        self._load_frontier(rows, [eb for _, eb, _ in entries], min(d for _, _, d in entries))

    # --- engine ------------------------------------------------------------

    def _load_frontier(self, rows: np.ndarray, ebits, depth: int) -> None:
        self._store_frontier_rows(rows)
        self._frontier_ebits = torch.as_tensor(np.asarray(ebits, dtype=np.int64), dtype=DTYPE,
                                               device=self._device)
        self._frontier_count = len(rows)
        self._depth = depth
        self._exhausted = False

    def _expand_rows(self, rows: np.ndarray, ebits: np.ndarray, depth: int) -> None:
        """One superstep over exactly these rows; fresh children join the
        pending pool at ``depth + 1``. Children are new to the visited set,
        so none collides with a pending entry."""
        self._load_frontier(rows, ebits, depth)
        self._run_block_single()
        self._pool_add(self._frontier_rows_host(), self._frontier_ebits_host(), depth + 1)

    def _run_block(self) -> None:
        if self._waiting:
            return  # computes nothing until asked (on_demand.rs:165-203)
        super()._run_block()

    def discoveries(self):
        """The Explorer polls this on every request. Witness paths are
        stable once found (parent chains never change under later
        inserts), so they are cached by the set of discoveries instead of
        reading the visited set back on every poll."""
        key = tuple(sorted(self._found_names.items()))
        if self._disc_cache is None or self._disc_cache[0] != key:
            self._disc_cache = (key, super().discoveries())
        return self._disc_cache[1]

    # --- Checker API adjustments (as checker/on_demand.py) -----------------

    def metrics(self) -> Dict[str, Any]:
        """The engine's snapshot plus the on-demand gauges: the pending
        pool (discovered but not expanded states) and whether the checker
        still waits to be asked."""
        out = super().metrics()
        out["pending_pool"] = len(self._pool)
        out["waiting"] = self._waiting
        return out

    def is_done(self) -> bool:
        if self._waiting:
            return not self._pool or self._stopped()
        return super().is_done()

    def join(self) -> "DeviceOnDemandChecker":
        if self._waiting and not self.is_done():
            raise RuntimeError(
                "join() on an on-demand checker that was never unblocked; "
                "call run_to_completion() first"
            )
        return super().join()
