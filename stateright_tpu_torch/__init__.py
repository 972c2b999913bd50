"""stateright_tpu_torch: the PyTorch/CUDA port of ``stateright_tpu``.

A model checker for nondeterministic transition systems (stateright's
``Model``/``Property`` API) whose search engine, ``spawn_xla()``, expands
the whole BFS frontier per step on an NVIDIA GPU: batched packed
transitions, a sorted visited set kept on the device, and two hand-written
CUDA kernels (stream compaction, merge-insert) on its main path.

Counterpart of ``stateright_tpu/__init__.py``; the names are the same, so
user code ports by changing its imports. The engine runs on ``cuda``;
``spawn_xla(device="cpu")`` runs it on the CPU with the kernels' plain
PyTorch versions.
"""

from .checker import Checker, CheckerBuilder, NondeterministicModelError, Path
from .core import Expectation, Model, Property
from .fingerprint import fingerprint
from .report import ReportData, ReportDiscovery, Reporter, WriteReporter
from .semantics import (
    ConsistencyTester,
    HistoryError,
    LinearizabilityTester,
    SequentialConsistencyTester,
    SequentialSpec,
)

__all__ = [
    "Checker",
    "CheckerBuilder",
    "ConsistencyTester",
    "Expectation",
    "HistoryError",
    "LinearizabilityTester",
    "SequentialConsistencyTester",
    "SequentialSpec",
    "Model",
    "NondeterministicModelError",
    "Path",
    "Property",
    "ReportData",
    "ReportDiscovery",
    "Reporter",
    "WriteReporter",
    "fingerprint",
]
