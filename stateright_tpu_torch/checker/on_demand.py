"""Demand-driven checker: computes nothing until asked.

Counterpart of ``stateright_tpu/checker/on_demand.py`` (stateright's
``src/checker/on_demand.rs``): a BFS-like engine that starts with only the
initial states pending and **blocks until asked**. ``check_fingerprint(fp)``
(ControlFlow::CheckFingerprint, on_demand.rs:165-203, 460-465) evaluates and
expands exactly the pending frontier entry with that fingerprint;
``run_to_completion()`` (ControlFlow::RunToCompletion) unblocks the engine
fully, after which it behaves like the batch BFS checker. The Explorer is
built on this so the UI only computes the states the user clicks.

stateright fans control messages over a channel to waiting worker threads
and reuses ``check_block``: one click expands up to 1500 states of the
clicked subtree (on_demand.rs:209-218). This engine is in-process;
``block_size`` picks the granularity: at stateright's 1500 a click
pre-computes the clicked subtree block as upstream does, while the Explorer
spawns with ``block_size=1`` (expand exactly the clicked entry, the
demand-driven contract its UI counts rely on). A ``join()`` before
``run_to_completion()`` would deadlock in stateright (workers wait on the
channel forever); here it raises instead of hanging.
"""

from __future__ import annotations

from collections import deque

from .search import SearchChecker


class OnDemandChecker(SearchChecker):
    """Spawned via ``CheckerBuilder.spawn_on_demand()`` (checker.rs:163-171)."""

    def __init__(self, builder, block_size: int = 1):
        super().__init__(builder, lifo=False)
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self._waiting = True
        self._block_size = block_size

    # --- control flow (checker.rs:259-266) --------------------------------

    def check_fingerprint(self, fingerprint: int) -> None:
        """Evaluates and expands the pending frontier entry with this
        fingerprint, if any (on_demand.rs:460-465), then — with
        ``block_size > 1`` — BFS-expands the clicked subtree up to
        ``block_size`` states total, stateright's ``check_block`` reuse
        (on_demand.rs:209-218). Unknown or already processed fingerprints
        are ignored, as in stateright."""
        if not self._waiting:
            return
        for i, entry in enumerate(self._pending):
            if entry[1] == fingerprint:
                del self._pending[i]
                # Entries the expansion prepends (BFS mode appendlefts
                # successors; each is unique — search.py dedups via
                # _generated before enqueueing) are the clicked subtree's
                # next frontier. Pop them straight off the deque into a
                # local BFS queue (reversed: appendleft stores siblings
                # newest-leftmost) and expand within the block budget;
                # a False from _evaluate_and_expand stops the block
                # immediately, like _run_block and stateright's
                # check_block.
                subtree = deque()

                def pull_new(before_len):
                    added = len(self._pending) - before_len
                    subtree.extend(
                        reversed([self._pending.popleft() for _ in range(added)])
                    )

                before = len(self._pending)
                keep_going = self._evaluate_and_expand(*entry)
                pull_new(before)
                expanded = 1
                while subtree and keep_going and expanded < self._block_size:
                    e = subtree.popleft()
                    before = len(self._pending)
                    keep_going = self._evaluate_and_expand(*e)
                    pull_new(before)
                    expanded += 1
                # Unexpanded subtree entries rejoin the frontier in their
                # original newest-leftmost layout.
                self._pending.extendleft(subtree)
                return

    def run_to_completion(self) -> None:
        """Unblocks the engine; subsequent ``join()``/``report()`` drive it
        to completion like a batch BFS (on_demand.rs:193-198)."""
        self._waiting = False

    # --- Checker API adjustments ------------------------------------------

    def _run_block(self, max_count: int = 1500) -> None:
        if self._waiting:
            return  # computes nothing until asked (on_demand.rs:165-203)
        super()._run_block(max_count)

    def is_done(self) -> bool:
        if self._waiting:
            # While demand-driven, the search is done when every property
            # has a discovery, the driven frontier ran dry, or a target was
            # hit — never merely because the un-driven frontier is non-empty.
            return (
                not self._pending
                or self._target_reached
                or (
                    bool(self._properties)
                    and len(self._discoveries) == len(self._properties)
                )
            )
        return super().is_done()

    def join(self) -> "OnDemandChecker":
        if self._waiting and not self.is_done():
            # stateright would block forever here (workers wait on the
            # control channel); fail loudly instead.
            raise RuntimeError(
                "join() on an on-demand checker that was never unblocked; "
                "call run_to_completion() first"
            )
        return super().join()
