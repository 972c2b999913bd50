"""Parallel DFS with dynamic work sharing — stateright's default CLI
checker discipline (``src/checker/dfs.rs``).

The port's own copy of ``stateright_tpu/checker/parallel_dfs.py``. Its
structure mirrors stateright's:

- a shared **job market** of pending-stack segments with a low-water mark:
  a worker whose local stack still has work splits it and re-stocks the
  market whenever the market runs below ``n`` jobs (the job market of
  dfs.rs:92-215);
- every worker runs plain LIFO exploration over its local stack
  (dfs.rs:230-407), against one **shared** visited set / parent map — the
  role stateright gives its concurrent DashMap (dfs.rs:29-31);
- discovery races are benign and first-wins (dfs.rs:291-306 lets worker
  threads race on the discovery slot; here the merge is under one lock);
- termination: market empty AND every worker idle, or every property has a
  discovery, or a state/depth target trips.

Concurrency medium: ``threading`` against plain dict/set — under CPython
these are the exact analogue of stateright's shared concurrent map (the
interpreter serializes the primitive operations; the lock guards the
check-then-act sequences). This host is the correctness/semantics engine:
like the multiprocess BFS (``parallel_host.py``), throughput parallelism in
this package is the GPU engine's job (``xla.py``); this engine exists
so every stateright checker discipline has a working counterpart (the
``threads(n)`` + DFS combination).

Semantics notes, shared with stateright's parallel DFS:

- full-coverage ``state_count``/``unique_state_count`` are exact and
  engine-invariant (every unique state expands exactly once, so generated =
  sum of reachable out-degrees + inits);
- visit ORDER is scheduling-dependent, so early-exit timing and
  eventually-property false-negative patterns (ebits travel with the first
  visit) vary run-to-run exactly as stateright's racing threads do;
  full-coverage counts do not.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from ..core import Model
from ..fingerprint import fingerprint
from .base import Checker
from .parallel_host import _eval_properties
from .path import Path


class ParallelDfsChecker(Checker):
    """Job-market parallel DFS behind ``threads(n)`` + ``spawn_dfs()``."""

    #: A worker splits its stack back into the market whenever the market
    #: holds fewer jobs than this multiple of the worker count
    #: (dfs.rs:92-215's low-water mark).
    MARKET_LOW_FACTOR = 1

    def __init__(self, builder):
        if builder._visitor is not None:
            raise ValueError(
                "threads(n)>1 with a visitor is unsupported: visitors observe "
                "per-state paths sequentially. Drop the visitor or threads()."
            )
        self._model: Model = builder._model
        self._n = max(2, builder._thread_count or 0)
        self._symmetry = builder._symmetry
        self._target_state_count = builder._target_state_count
        self._target_max_depth = builder._target_max_depth
        self._properties = self._model.properties()
        self._prop_names = [p.name for p in self._properties]
        self._ebits0 = frozenset(
            i
            for i, p in enumerate(self._properties)
            if p.expectation.name == "EVENTUALLY"
        )

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._market: List[List[tuple]] = []  # jobs: stack segments
        self._idle = 0
        self._stop = False
        self._done_event = threading.Event()
        self._threads: List[threading.Thread] = []
        self._started_threads = False

        self._visited: set = set()  # representative fingerprints
        self._parents: Dict[int, Optional[int]] = {}
        self._discoveries: Dict[int, int] = {}  # prop index -> witness fp
        self._max_depth = 0
        self._target_reached = False
        self._exhausted = False

        init_states = [
            s for s in self._model.init_states() if self._model.within_boundary(s)
        ]
        self._state_count = len(init_states)
        self._unique_count = 0
        seed: List[tuple] = []
        for s in init_states:
            fp = fingerprint(s)
            rfp = self._rep_fp(s, fp)
            if rfp not in self._visited:
                self._visited.add(rfp)
                self._unique_count += 1
            if fp not in self._parents:
                self._parents[fp] = None
            # EVERY init seeds an entry — duplicates included — exactly as
            # the sequential oracle enqueues them (search.py), so
            # full-coverage state_count stays engine-invariant.
            seed.append((s, fp, self._ebits0, 1))
        if seed:
            # One seed job per worker where possible, so exploration fans
            # out immediately.
            k = max(1, len(seed) // self._n)
            self._market = [seed[i : i + k] for i in range(0, len(seed), k)]
        else:
            self._exhausted = True
            self._done_event.set()

    def _rep_fp(self, state, fp: int) -> int:
        if self._symmetry is None:
            return fp
        return fingerprint(self._symmetry(state))

    # --- worker ------------------------------------------------------------

    def _worker(self) -> None:
        model = self._model
        properties = self._properties
        market_low = self.MARKET_LOW_FACTOR * self._n
        try:
            while True:
                with self._cv:
                    while not self._market and not self._stop:
                        self._idle += 1
                        if self._idle == self._n:
                            # Market empty and every peer waiting: the
                            # search is exhausted (dfs.rs's all-idle
                            # termination).
                            self._exhausted = True
                            self._stop = True
                            self._done_event.set()
                            self._cv.notify_all()
                            self._idle -= 1
                            return
                        self._cv.wait()
                        self._idle -= 1
                    if self._stop:
                        return
                    stack = self._market.pop()

                pops = 0
                while stack:
                    if self._stop:
                        return
                    # Re-stock an under-supplied market from the local
                    # stack (share the OLDEST entries — the widest
                    # subtrees — like stateright's bottom-of-stack
                    # splits). Probed every few pops so the hot loop pays
                    # one condition-variable acquire per batch, not per
                    # state.
                    pops += 1
                    # Unlocked fullness pre-check (benign stale read under
                    # CPython): a full market skips the cv
                    # acquire entirely; the locked re-check stays
                    # authoritative.
                    if (
                        len(stack) > 1
                        and pops % 8 == 1
                        and len(self._market) < market_low
                    ):
                        with self._cv:
                            if len(self._market) < market_low:
                                half = stack[: len(stack) // 2]
                                del stack[: len(stack) // 2]
                                self._market.append(half)
                                self._cv.notify()
                    state, fp, ebits, depth = stack.pop()
                    if (
                        self._target_max_depth is not None
                        and depth >= self._target_max_depth
                    ):
                        with self._lock:
                            if depth > self._max_depth:
                                self._max_depth = depth
                        continue
                    local_disc: Dict[int, int] = {}
                    ebits = _eval_properties(
                        model, properties, state, fp, ebits, local_disc
                    )
                    with self._cv:
                        if depth > self._max_depth:
                            self._max_depth = depth
                        for i, wfp in local_disc.items():
                            self._discoveries.setdefault(i, wfp)
                        if len(self._discoveries) == len(properties):
                            # Discoveries exist for every property (trivially
                            # so with zero properties): stop BEFORE expanding,
                            # as the oracle does (search.py, bfs.rs:326-328).
                            self._stop = True
                            self._done_event.set()
                            self._cv.notify_all()
                            return
                    # Expansion (dfs.rs:330-381 analogue) — model callbacks
                    # and fingerprinting run outside any lock.
                    actions: List[Any] = []
                    model.actions(state, actions)
                    succs: List[tuple] = []
                    is_terminal = True
                    for action in actions:
                        nxt = model.next_state(state, action)
                        if nxt is None:
                            continue
                        if not model.within_boundary(nxt):
                            continue
                        is_terminal = False
                        nfp = fingerprint(nxt)
                        succs.append((nxt, nfp, self._rep_fp(nxt, nfp)))
                    term_disc: Dict[int, int] = {}
                    if is_terminal:
                        # Unmet eventually-bits at a terminal state are
                        # counterexamples (dfs.rs:374-381 analogue).
                        for i in ebits:
                            term_disc.setdefault(i, fp)
                    # One consolidated shared-state section per expanded
                    # state: counters, visited-insert, parents, terminal
                    # discoveries, then the stop conditions — in the
                    # oracle's order (target is checked AFTER the full
                    # expansion, with every discovery already flushed).
                    fresh_entries: List[tuple] = []
                    with self._cv:
                        self._state_count += len(succs)
                        for nxt, nfp, rfp in succs:
                            if rfp not in self._visited:
                                self._visited.add(rfp)
                                self._unique_count += 1
                                if nfp not in self._parents:
                                    self._parents[nfp] = fp
                                fresh_entries.append(
                                    (nxt, nfp, ebits, depth + 1)
                                )
                        for i, wfp in term_disc.items():
                            self._discoveries.setdefault(i, wfp)
                        all_found = properties and len(self._discoveries) == len(
                            properties
                        )
                        hit_target = (
                            self._target_state_count is not None
                            and self._state_count >= self._target_state_count
                        )
                        if hit_target:
                            self._target_reached = True
                        if hit_target or all_found:
                            self._stop = True
                            self._done_event.set()
                            self._cv.notify_all()
                            return
                    stack.extend(fresh_entries)
        except Exception:
            # A model-callback failure must not hang join(): surface it.
            import traceback

            with self._cv:
                self._failure = traceback.format_exc()
                self._stop = True
                self._done_event.set()
                self._cv.notify_all()

    _failure: Optional[str] = None

    # --- engine hooks ------------------------------------------------------

    def _start(self) -> None:
        if self._started_threads:
            return
        self._started_threads = True
        for k in range(self._n):
            t = threading.Thread(
                target=self._worker, name=f"dfs-worker-{k}", daemon=True
            )
            t.start()
            self._threads.append(t)

    def _run_block(self, max_count: int = 1500) -> None:
        """Waits for ~max_count new unique states (or completion) so
        ``report()`` gets progress snapshots at the usual granularity."""
        if self.is_done():
            return
        self._start()
        with self._lock:
            baseline = self._unique_count
        while not self._done_event.is_set():
            with self._lock:
                if self._unique_count >= baseline + max_count:
                    return
            self._done_event.wait(0.05)
        if self._failure is not None:
            raise RuntimeError(
                f"parallel DFS worker failed:\n{self._failure}"
            )

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._done_event.set()
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5)

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass

    # --- Checker API -------------------------------------------------------

    def model(self) -> Model:
        return self._model

    def state_count(self) -> int:
        with self._lock:
            return self._state_count

    def unique_state_count(self) -> int:
        with self._lock:
            return self._unique_count

    def max_depth(self) -> int:
        with self._lock:
            return self._max_depth

    def is_done(self) -> bool:
        if not self._started_threads:
            return False
        if self._done_event.is_set():
            if self._failure is not None:
                raise RuntimeError(
                    f"parallel DFS worker failed:\n{self._failure}"
                )
            return True
        return False

    def discoveries(self) -> Dict[str, Path]:
        with self._lock:
            found = dict(self._discoveries)
            parents = dict(self._parents)
        out: Dict[str, Path] = {}
        for i, fp in found.items():
            chain = [fp]
            cur = fp
            while True:
                parent = parents.get(cur)
                if parent is None:
                    break
                chain.append(parent)
                cur = parent
            chain.reverse()
            out[self._properties[i].name] = Path.from_fingerprints(
                self._model, chain
            )
        return out
