"""Sequential-consistency tester
(semantics/sequential_consistency.rs:55-379): like linearizability but
without the cross-thread real-time constraint — only per-thread program
order and reference-object validity restrict the serialization.

The port's own copy of ``stateright_tpu/semantics/sequential_consistency.py``.
"""

from __future__ import annotations

from ._backtracking import BacktrackingTester


class SequentialConsistencyTester(BacktrackingTester):
    _REAL_TIME = False
