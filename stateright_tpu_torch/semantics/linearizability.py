"""Linearizability tester (semantics/linearizability.rs:57-312).

The port's own copy of ``stateright_tpu/semantics/linearizability.py``.

Captures a potentially concurrent operation history and decides whether a
total order exists that (a) is valid for the reference object, (b) respects
per-thread program order, and (c) respects *real-time* order: an operation
invoked after another completed (on any thread) may not be serialized before
it.  Real time is enforced by recording, at invocation, the index of the last
completed operation of every other thread (linearizability.rs:114-126) and
rejecting interleavings that would schedule an op while one of those
prerequisite peer ops is still unscheduled.
"""

from __future__ import annotations

from ._backtracking import BacktrackingTester


class LinearizabilityTester(BacktrackingTester):
    _REAL_TIME = True
