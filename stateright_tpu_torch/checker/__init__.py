"""Checkers: the base interface, the host engines' visitors, witness paths
and the builder (counterpart of ``stateright_tpu/checker/__init__.py``)."""

from .base import Checker
from .builder import CheckerBuilder
from .path import NondeterministicModelError, Path
from .visitor import CheckerVisitor, PathRecorder, StateRecorder

__all__ = [
    "Checker",
    "CheckerBuilder",
    "CheckerVisitor",
    "NondeterministicModelError",
    "Path",
    "PathRecorder",
    "StateRecorder",
]
