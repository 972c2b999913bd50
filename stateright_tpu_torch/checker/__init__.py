"""Checkers: the base interface, witness paths and the builder (counterpart
of ``stateright_tpu/checker/__init__.py``)."""

from .base import Checker
from .builder import CheckerBuilder
from .path import NondeterministicModelError, Path

__all__ = ["Checker", "CheckerBuilder", "NondeterministicModelError", "Path"]
