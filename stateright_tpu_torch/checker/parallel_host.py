"""Parallel host BFS: ``threads(n)`` with real workers.

The port's own copy of ``stateright_tpu/checker/parallel_host.py``.
stateright runs N OS threads over a shared DashMap visited set with a
job-market work-sharing protocol (``src/checker/bfs.rs:89-211``). Python
threads cannot parallelize model callbacks (the interpreter lock), so this
engine uses N *forked worker processes* — and rather than translating the
job market, it shards the search by fingerprint ownership, as the
reference package's multi-chip engine does, on the host:

- **fingerprint-sharded ownership**: worker ``k`` owns every state whose
  representative fingerprint hashes to ``k``; it keeps that shard of the
  visited set, the parent map (bfs.rs:29-30), and the frontier;
- **level-synchronous supersteps**: each round, every worker expands its
  local frontier (the Python-heavy ``actions``/``next_state``/``fingerprint``
  callbacks — the hot loop of bfs.rs:332-349), buckets candidates by owner,
  and exchanges buckets over per-worker pipes (the host analogue of the
  device engine's ``all_to_all``; a drain thread receives while the worker
  sends, so full pipe buffers cannot deadlock the exchange);
- **deterministic merges**: owners ingest buckets in sender order, so
  counts, witness election, and the documented eventually-false-negatives
  (bfs.rs:343-360) are reproducible run to run — unlike stateright,
  whose discovery races are documented as benign (bfs.rs:291-306).

Forked workers inherit the model by copy-on-write, so models may hold
lambdas (property conditions) that could never cross a pickle boundary;
only candidate states are pickled, for the exchange. The parent may have
``torch`` imported, and a CUDA context on a card; the workers run only the
object model's callbacks and touch no tensor.

The sequential engine (``search.py``) remains the semantics oracle; this
engine matches its full-coverage counts exactly. Early-exit points may
differ by up to one level (any parallel checker stops "soon after" a
discovery; stateright's is nondeterministic too). Visitors force the
sequential engine — they observe per-state paths one at a time.
"""

from __future__ import annotations

import multiprocessing as mp
from typing import Any, Dict, List, Optional

from ..core import Expectation, Model
from ..fingerprint import fingerprint
from .base import Checker
from .path import Path

# Owner mix decorrelated from raw fingerprint bits (fingerprints feed
# Python sets downstream); any fixed odd 64-bit multiplier works.
_OWNER_MULT = 0x9E3779B97F4A7C15
_MASK64 = (1 << 64) - 1


def _owner_of(fp: int, n: int) -> int:
    return (((fp * _OWNER_MULT) & _MASK64) >> 32) % n


def _eval_properties(model, properties, state, fp, ebits, discoveries):
    """Property evaluation at dequeue time (bfs.rs:279-328): returns the
    state's updated eventually-bits, recording ALWAYS/SOMETIMES discoveries
    into ``discoveries`` in place.

    EVENTUALLY conditions must clear ebits even after that property has a
    recorded discovery this level — skipping the clear would hand children
    a stale eventually-bit and invent terminal counterexamples at deeper
    levels.
    """
    for i, prop in enumerate(properties):
        if prop.expectation == Expectation.EVENTUALLY:
            if prop.condition(model, state):
                ebits = ebits - {i}
        elif i in discoveries:
            continue
        elif prop.expectation == Expectation.ALWAYS:
            if not prop.condition(model, state):
                discoveries[i] = fp
        elif prop.condition(model, state):
            discoveries[i] = fp
    return ebits


def _worker_main(rank, n, model, properties, symmetry, target_max_depth,
                 inbox, outboxes, to_main, from_main):
    """Worker loop: owns one shard of visited set / parent map / frontier.

    Protocol (driven by the main process):
      ("seed", bucket)  -> ingest the initial frontier shard; reply count.
      ("expand",)       -> one level: expand, exchange, ingest; reply stats.
      ("parent", fp)    -> reply (present?, parent fp or None).
      ("stop",)         -> exit.
    """
    visited: set = set()
    parents: Dict[int, Optional[int]] = {}
    frontier: List[tuple] = []  # (state, fp, ebits)
    depth = 1

    def rep_fp(state, fp):
        return fp if symmetry is None else fingerprint(symmetry(state))

    def ingest(bucket):
        fresh = 0
        for state, fp, rfp, parent_fp, ebits in bucket:
            if rfp in visited:
                continue
            visited.add(rfp)
            if fp not in parents:
                parents[fp] = parent_fp
            frontier.append((state, fp, ebits))
            fresh += 1
        return fresh

    while True:
        msg = from_main.recv()
        cmd = msg[0]
        if cmd == "stop":
            return
        if cmd == "parent":
            fp = msg[1]
            to_main.send(("parent", fp in parents, parents.get(fp)))
            continue
        if cmd == "seed":
            count = ingest(msg[1])
            to_main.send(("seeded", count))
            continue
        assert cmd == "expand"
        # A model-callback failure must not wedge the level barrier: the
        # failing worker still participates in the exchange (with empty
        # buckets) so its peers' gets complete, and reports the error only
        # after the barrier.
        failure = None
        try:
            generated = 0
            discoveries: Dict[int, int] = {}  # prop index -> witness fp
            buckets: List[List[tuple]] = [[] for _ in range(n)]
            at_depth_target = (
                target_max_depth is not None and depth >= target_max_depth
            )
            for state, fp, ebits in frontier:
                # Depth-target states are counted in max_depth but neither
                # evaluated nor expanded (bfs.rs:267-272 — the early return
                # precedes the property pass).
                if at_depth_target:
                    continue
                ebits = _eval_properties(
                    model, properties, state, fp, ebits, discoveries
                )
                # Expansion (bfs.rs:330-381).
                is_terminal = True
                actions: List[Any] = []
                model.actions(state, actions)
                for action in actions:
                    nxt = model.next_state(state, action)
                    if nxt is None:
                        continue
                    if not model.within_boundary(nxt):
                        continue
                    generated += 1
                    is_terminal = False
                    nfp = fingerprint(nxt)
                    rfp = rep_fp(nxt, nfp)
                    buckets[_owner_of(rfp, n)].append((nxt, nfp, rfp, fp, ebits))
                if is_terminal:
                    # Unmet eventually-bits at a terminal state are
                    # counterexamples (bfs.rs:374-381).
                    for i in ebits:
                        if i not in discoveries:
                            discoveries[i] = fp
        except Exception:
            import traceback

            failure = traceback.format_exc()
            buckets = [[] for _ in range(n)]
        frontier = []
        # ---- exchange. Inboxes are mp.Queues: puts are serialized
        # across producer processes (raw pipe writes from multiple
        # senders could interleave) and buffered by the feeder thread
        # (so N mutually-full pipes cannot deadlock the level). ------
        for k in range(n):
            outboxes[k].put((rank, buckets[k]))
        received = [inbox.get() for _ in range(n)]
        if failure is None:
            try:
                fresh = 0
                for _, bucket in sorted(received):  # deterministic merge
                    fresh += ingest(bucket)
                depth += 1
                to_main.send(
                    ("level", generated, fresh, len(frontier), discoveries)
                )
            except Exception:
                import traceback

                failure = traceback.format_exc()
        if failure is not None:
            to_main.send(("error", failure))
            return


class ParallelBfsChecker(Checker):
    """Level-synchronous multiprocess BFS behind ``threads(n)``."""

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

        self._state_count = 0
        self._unique_count = 0
        self._max_depth = 0
        self._depth = 1
        self._discoveries: Dict[str, int] = {}
        self._paths: Dict[str, Path] = {}
        self._exhausted = False
        self._target_reached = False
        self._pool_started = False
        self._closed = False

    # --- worker pool -------------------------------------------------------

    def _start(self) -> None:
        self._pool_started = True
        ctx = mp.get_context("fork")
        n = self._n
        inboxes = [ctx.Queue() for _ in range(n)]
        to_main_pipes = [ctx.Pipe(duplex=False) for _ in range(n)]
        from_main_pipes = [ctx.Pipe(duplex=False) for _ in range(n)]
        self._to_main = [r for r, _ in to_main_pipes]
        self._from_main = [w for _, w in from_main_pipes]
        self._workers = []
        for k in range(n):
            p = ctx.Process(
                target=_worker_main,
                args=(
                    k,
                    n,
                    self._model,
                    self._properties,
                    self._symmetry,
                    self._target_max_depth,
                    inboxes[k],
                    inboxes,
                    to_main_pipes[k][1],
                    from_main_pipes[k][0],
                ),
                daemon=True,
            )
            p.start()
            self._workers.append(p)

        # Seed the initial frontier shards (bfs.rs:52-78).
        ebits0 = frozenset(
            i
            for i, p in enumerate(self._properties)
            if p.expectation == Expectation.EVENTUALLY
        )
        init_states = [
            s for s in self._model.init_states() if self._model.within_boundary(s)
        ]
        buckets: List[List[tuple]] = [[] for _ in range(n)]
        for s in init_states:
            fp = fingerprint(s)
            rfp = fp if self._symmetry is None else fingerprint(self._symmetry(s))
            buckets[_owner_of(rfp, n)].append((s, fp, rfp, None, ebits0))
        for k in range(n):
            self._from_main[k].send(("seed", buckets[k]))
        seeded = 0
        for k in range(n):
            tag, count = self._to_main[k].recv()
            assert tag == "seeded"
            seeded += count
        self._state_count = len(init_states)
        self._unique_count = seeded
        if seeded == 0:
            self._exhausted = True

    def close(self) -> None:
        """Stops the worker pool (idempotent). Before the pool starts there
        is nothing to stop — and the checker stays usable (a later join()
        starts and finalizes normally)."""
        if not self._pool_started or self._closed:
            return
        self._closed = True
        for pipe in self._from_main:
            try:
                pipe.send(("stop",))
            except (BrokenPipeError, OSError):  # pragma: no cover
                pass
        for p in self._workers:
            p.join(timeout=5)
            if p.is_alive():  # pragma: no cover
                p.terminate()

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass

    # --- engine ------------------------------------------------------------

    def _run_block(self, max_count: int = 1500) -> None:
        """One BFS level across all workers."""
        if not self._pool_started:
            self._start()
        if self.is_done():
            self._finalize()
            return
        self._max_depth = max(self._max_depth, self._depth)
        at_depth_target = (
            self._target_max_depth is not None
            and self._depth >= self._target_max_depth
        )
        for pipe in self._from_main:
            pipe.send(("expand",))
        generated = fresh = frontier_total = 0
        discovery_cands: Dict[int, List[int]] = {}
        failure = None
        for k in range(self._n):
            msg = self._to_main[k].recv()
            if msg[0] == "error":  # pragma: no cover
                failure = (k, msg[1])
                continue
            _, g, f, ftotal, discs = msg
            generated += g
            fresh += f
            frontier_total += ftotal
            for i, fp in discs.items():
                discovery_cands.setdefault(i, []).append(fp)
        if failure is not None:  # pragma: no cover
            self.close()
            raise RuntimeError(f"worker {failure[0]} failed:\n{failure[1]}")
        self._state_count += generated
        self._unique_count += fresh
        self._depth += 1
        for i, fps in sorted(discovery_cands.items()):
            name = self._prop_names[i]
            if name not in self._discoveries:
                # Deterministic witness election (stateright lets worker
                # threads race here, bfs.rs:291-306): lowest fingerprint.
                self._discoveries[name] = min(fps)
        if (
            self._target_state_count is not None
            and self._state_count >= self._target_state_count
        ):
            self._target_reached = True
        if frontier_total == 0 or at_depth_target:
            self._exhausted = True
        if self.is_done():
            self._finalize()

    def _finalize(self) -> None:
        """Resolve witness paths through the sharded parent maps, then shut
        the pool down; paths are cached for discoveries()."""
        if self._closed or not self._pool_started:
            return
        for name, fp in self._discoveries.items():
            if name not in self._paths:
                self._paths[name] = self._reconstruct_path(fp)
        self.close()

    def _parent_of(self, fp: int) -> Optional[int]:
        """The parent map is keyed by *actual* fingerprint but sharded by
        *representative* fingerprint, which the main process cannot derive;
        chains are short and n is small, so query shards starting with the
        no-symmetry owner."""
        if self._closed:
            raise RuntimeError(
                "worker pool already closed: close() preempted finalize, so "
                "this discovery's witness path was never cached and the "
                "parent-map shards that could rebuild it are gone. Let the "
                "check finish (join()) before closing, or re-run it."
            )
        guess = _owner_of(fp, self._n)
        order = [guess] + [j for j in range(self._n) if j != guess]
        for j in order:
            self._from_main[j].send(("parent", fp))
            tag, present, parent = self._to_main[j].recv()
            assert tag == "parent"
            if present:
                return parent
        raise KeyError(f"fingerprint {fp:#x} not in any parent shard")

    def _reconstruct_path(self, fp: int) -> Path:
        """Walk the (sharded) predecessor chain, then re-execute the model
        (bfs.rs:430-459, path.rs:20-97)."""
        fingerprints: List[int] = [fp]
        cur = fp
        while True:
            parent = self._parent_of(cur)
            if parent is None:
                break
            fingerprints.append(parent)
            cur = parent
        fingerprints.reverse()
        return Path.from_fingerprints(self._model, fingerprints)

    # --- Checker API --------------------------------------------------------

    def model(self) -> Model:
        return self._model

    def state_count(self) -> int:
        return self._state_count

    def unique_state_count(self) -> int:
        return self._unique_count

    def max_depth(self) -> int:
        return self._max_depth

    def is_done(self) -> bool:
        if not self._pool_started:
            return False
        return (
            self._exhausted
            or self._target_reached
            or len(self._discoveries) == len(self._properties)
        )

    def discoveries(self) -> Dict[str, Path]:
        out = dict(self._paths)
        for name, fp in self._discoveries.items():
            if name not in out:
                out[name] = self._reconstruct_path(fp)
        return out
