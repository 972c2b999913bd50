"""stateright_tpu_torch: the PyTorch/CUDA port of ``stateright_tpu``.

A model checker for nondeterministic transition systems (stateright's
``Model``/``Property`` API), with host engines (``spawn_bfs``/``spawn_dfs``,
sequential or over ``threads(n)`` workers) and a GPU engine,
``spawn_xla()``, that expands the whole BFS frontier per step on an NVIDIA
GPU: batched packed transitions, a sorted visited set kept on the device,
and two hand-written CUDA kernels (stream compaction, merge-insert) on its
main path. Searches checkpoint to files that the JAX package resumes, and
resume from its files (``checkpoint.py``).

Counterpart of ``stateright_tpu/__init__.py``; the names are the same, so
user code ports by changing its imports. The engine runs on ``cuda``;
``spawn_xla(device="cpu")`` runs it on the CPU with the kernels' plain
PyTorch versions.
"""

from .checker import (
    Checker,
    CheckerBuilder,
    CheckerVisitor,
    NondeterministicModelError,
    Path,
    PathRecorder,
    StateRecorder,
)
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
    "CheckerVisitor",
    "ConsistencyTester",
    "Expectation",
    "HistoryError",
    "LinearizabilityTester",
    "SequentialConsistencyTester",
    "SequentialSpec",
    "Model",
    "NondeterministicModelError",
    "Path",
    "PathRecorder",
    "Property",
    "ReportData",
    "ReportDiscovery",
    "Reporter",
    "StateRecorder",
    "WriteReporter",
    "fingerprint",
]
