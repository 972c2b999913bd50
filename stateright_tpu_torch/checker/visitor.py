"""Checker visitors: hooks applied to every evaluated state's path.

The port's own copy of ``stateright_tpu/checker/visitor.py`` (stateright's
``src/checker/visitor.rs``).  A visitor may be any callable taking a
:class:`Path`, or one of the recorder classes below.
"""

from __future__ import annotations

from typing import Any, Callable, List, Set

from .path import Path


class CheckerVisitor:
    """Hook applied to every evaluated path (visitor.rs:19-22)."""

    def visit(self, model, path: Path) -> None:
        raise NotImplementedError


class _FnVisitor(CheckerVisitor):
    def __init__(self, fn: Callable[[Path], None]):
        self._fn = fn

    def visit(self, model, path: Path) -> None:
        self._fn(path)


def as_visitor(v) -> CheckerVisitor:
    if isinstance(v, CheckerVisitor):
        return v
    if callable(v):
        return _FnVisitor(v)
    raise TypeError(f"not a visitor: {v!r}")


class PathRecorder(CheckerVisitor):
    """Records the set of paths visited (visitor.rs:47-73).

    Path reconstruction itself validates each path by re-executing the model,
    so recording doubles as a path-validity check (used by stateright's
    symmetry-reduction regression test, dfs.rs:618-622).
    """

    def __init__(self):
        self._paths: Set[Path] = set()

    def visit(self, model, path: Path) -> None:
        self._paths.add(path)

    @staticmethod
    def new_with_accessor():
        recorder = PathRecorder()
        return recorder, lambda: set(recorder._paths)


class StateRecorder(CheckerVisitor):
    """Records states evaluated, in evaluation order (visitor.rs:87-111)."""

    def __init__(self):
        self._states: List[Any] = []

    def visit(self, model, path: Path) -> None:
        self._states.append(path.last_state())

    @staticmethod
    def new_with_accessor():
        recorder = StateRecorder()
        return recorder, lambda: list(recorder._states)
