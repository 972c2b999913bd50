"""Host-side BFS/DFS search engines — the CPU correctness oracle.

The port's own copy of ``stateright_tpu/checker/search.py``. These
implement the semantics of stateright's worker loops
(``src/checker/bfs.rs:225-383`` and ``dfs.rs:230-407``):
exact state/unique counts, visit order, eventually-bit propagation with the
documented cycle/DAG-join false negatives, boundary filtering, early exit
once every property has a discovery, and target state/depth bounds.

stateright splits BFS and DFS into two files differing only in frontier
discipline and witness bookkeeping; here one engine is parameterized by both.
Its job-market/work-stealing machinery (bfs.rs:89-211) lives in
``parallel_host.py`` and ``parallel_dfs.py`` (``threads(n)``); this module is
the differential-testing oracle of those and of the GPU frontier expansion
(``stateright_tpu_torch/xla.py``).

Unlike stateright (where only DFS honors symmetry reduction, dfs.rs:357),
both disciplines support it here; BFS keeps witness paths valid by keying
dedup on representative fingerprints while chaining parent pointers through
the pre-canonicalized fingerprints (same trick as dfs.rs:363-366).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..core import Expectation, Model
from ..fingerprint import fingerprint
from .base import Checker
from .path import Path
from .visitor import CheckerVisitor


class SearchChecker(Checker):
    """Sequential explicit-state search over a model's state graph."""

    def __init__(self, builder, *, lifo: bool):
        self._model: Model = builder._model
        self._lifo = lifo
        self._symmetry: Optional[Callable[[Any], Any]] = builder._symmetry
        self._target_state_count: Optional[int] = builder._target_state_count
        self._target_max_depth: Optional[int] = builder._target_max_depth
        self._visitor: Optional[CheckerVisitor] = builder._visitor
        self._properties = self._model.properties()

        init_states = [
            s for s in self._model.init_states() if self._model.within_boundary(s)
        ]
        self._state_count = len(init_states)
        self._max_depth = 0
        # Dedup keys: representative fingerprints when symmetry is enabled
        # (dfs.rs:357-362), plain state fingerprints otherwise.
        self._generated: set = set()
        # BFS-style predecessor map over *actual* fingerprints, for witness
        # reconstruction (bfs.rs:29-30, 430-459). Populated in both
        # disciplines so discoveries() is uniform.
        self._parents: Dict[int, Optional[int]] = {}
        self._ebits0 = frozenset(
            i
            for i, p in enumerate(self._properties)
            if p.expectation == Expectation.EVENTUALLY
        )
        # Pending entries: (state, fingerprint, ebits, depth). Depth counts
        # states on the path, starting at 1 for init states (bfs.rs:79-85).
        self._pending = deque()
        for s in init_states:
            fp = fingerprint(s)
            rep_fp = self._rep_fp(s, fp)
            self._generated.add(rep_fp)
            if fp not in self._parents:
                self._parents[fp] = None
            self._pending.append((s, fp, self._ebits0, 1))
        # Discoveries: property name -> witness fingerprint (path built from
        # the parent chain on demand, as in bfs.rs:407-417).
        self._discoveries: Dict[str, int] = {}
        self._exhausted = False
        self._target_reached = False

    # --- engine ----------------------------------------------------------

    def _rep_fp(self, state: Any, fp: int) -> int:
        if self._symmetry is None:
            return fp
        return fingerprint(self._symmetry(state))

    def _run_block(self, max_count: int = 1500) -> None:
        """Process up to ``max_count`` pending states (bfs.rs:225-383)."""
        while max_count > 0:
            max_count -= 1
            if not self._pending:
                self._exhausted = True
                return
            # Both disciplines pop from the right (bfs.rs:252 pop_back,
            # dfs.rs:254 pop); BFS enqueues children on the left
            # (bfs.rs:367 push_front) and DFS on the right (dfs.rs:391 push),
            # reproducing stateright's exact visit order.
            if not self._evaluate_and_expand(*self._pending.pop()):
                return

    def _evaluate_and_expand(self, state, state_fp, ebits, depth) -> bool:
        """Evaluate properties on one dequeued state and push its successors.

        The body of stateright's hot loop (bfs.rs:252-381), shared by the
        batch engines and the demand-driven checker. Returns False when the
        block should stop (all properties discovered, or target state count
        reached)."""
        model = self._model
        properties = self._properties

        if depth > self._max_depth:
            self._max_depth = depth
        if self._target_max_depth is not None and depth >= self._target_max_depth:
            return True

        if self._visitor is not None:
            self._visitor.visit(model, self._reconstruct_path(state_fp))

        # Property evaluation on the dequeued state (bfs.rs:279-328).
        is_awaiting_discoveries = False
        for i, prop in enumerate(properties):
            if prop.name in self._discoveries:
                continue
            if prop.expectation == Expectation.ALWAYS:
                if not prop.condition(model, state):
                    self._discoveries[prop.name] = state_fp
                else:
                    is_awaiting_discoveries = True
            elif prop.expectation == Expectation.SOMETIMES:
                if prop.condition(model, state):
                    self._discoveries[prop.name] = state_fp
                else:
                    is_awaiting_discoveries = True
            else:
                # Eventually-property discoveries only materialize at
                # terminal states, so this property is still awaiting one
                # regardless of whether it holds here (bfs.rs:309-323).
                is_awaiting_discoveries = True
                if prop.condition(model, state):
                    ebits = ebits - {i}
        if not is_awaiting_discoveries:
            # Discoveries exist for every property. Like stateright
            # (bfs.rs:326-328), this is detected after visiting the
            # dequeued state, so one state is evaluated even when there
            # are zero properties.
            return False

        # Expansion (bfs.rs:330-381).
        is_terminal = True
        actions: List[Any] = []
        model.actions(state, actions)
        for action in actions:
            next_state = model.next_state(state, action)
            if next_state is None:
                continue
            if not model.within_boundary(next_state):
                continue
            self._state_count += 1
            next_fp = fingerprint(next_state)
            rep_fp = self._rep_fp(next_state, next_fp)
            if rep_fp in self._generated:
                # Could be a cycle (terminal for eventually-checking
                # purposes) or a DAG join (not terminal); like the
                # stateright we do not disambiguate, accepting the
                # documented false negative (bfs.rs:353-360).
                is_terminal = False
                continue
            self._generated.add(rep_fp)
            if next_fp not in self._parents:
                self._parents[next_fp] = state_fp
            is_terminal = False
            entry = (next_state, next_fp, ebits, depth + 1)
            if self._lifo:
                self._pending.append(entry)
            else:
                self._pending.appendleft(entry)
        if is_terminal:
            for i in ebits:
                self._discoveries[properties[i].name] = state_fp
        if (
            self._target_state_count is not None
            and self._state_count >= self._target_state_count
        ):
            self._target_reached = True
            return False
        return True

    # --- Checker API ------------------------------------------------------

    def model(self) -> Model:
        return self._model

    def state_count(self) -> int:
        return self._state_count

    def unique_state_count(self) -> int:
        return len(self._generated)

    def max_depth(self) -> int:
        return self._max_depth

    def is_done(self) -> bool:
        return (
            self._exhausted
            or self._target_reached
            or len(self._discoveries) == len(self._properties)
            or not self._pending
        )

    def discoveries(self) -> Dict[str, Path]:
        return {
            name: self._reconstruct_path(fp) for name, fp in self._discoveries.items()
        }

    def _reconstruct_path(self, fp: int) -> Path:
        """Walk the predecessor chain back to an init fingerprint, then
        re-execute the model forward (bfs.rs:430-459, path.rs:20-97)."""
        fingerprints: List[int] = []
        next_fp: Optional[int] = fp
        while next_fp is not None and next_fp in self._parents:
            fingerprints.append(next_fp)
            next_fp = self._parents[next_fp]
        fingerprints.reverse()
        return Path.from_fingerprints(self._model, fingerprints)


class BfsChecker(SearchChecker):
    """Breadth-first search: finds shortest witnesses (checker.rs:146-155)."""

    def __init__(self, builder):
        super().__init__(builder, lifo=False)


class DfsChecker(SearchChecker):
    """Depth-first search: frontier stays small (checker.rs:179-187)."""

    def __init__(self, builder):
        super().__init__(builder, lifo=True)
