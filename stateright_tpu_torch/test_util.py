"""Checker-correctness fixture models.

The port's own copy of ``stateright_tpu/test_util.py``, itself a port of
stateright's test fixtures (``src/test_util.rs``): tiny closed-form models
whose exact state counts, visit orders, and discovery paths are oracles for
every engine (host BFS/DFS and the GPU engine alike).
"""

from __future__ import annotations

from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Set

import numpy as np
import torch

from .core import Model, Property


class _NamedEnum(Enum):
    """Enum whose str/repr is the bare variant name, to match the display of
    Rust enum variants in reporter-format parity tests."""

    def __repr__(self) -> str:  # pragma: no cover - trivial
        return str(self.value)

    def __str__(self) -> str:
        return str(self.value)


# --- binary clock (test_util.rs:4-47) ------------------------------------


class BinaryClockAction(_NamedEnum):
    GO_LOW = "GoLow"
    GO_HIGH = "GoHigh"


class BinaryClock(Model):
    """A machine that cycles between two states."""

    def init_states(self) -> List[int]:
        return [0, 1]

    def actions(self, state: int, actions: List[Any]) -> None:
        if state == 0:
            actions.append(BinaryClockAction.GO_HIGH)
        else:
            actions.append(BinaryClockAction.GO_LOW)

    def next_state(self, state: int, action: Any) -> Optional[int]:
        return 1 if action == BinaryClockAction.GO_HIGH else 0

    def properties(self) -> List[Property]:
        return [Property.always("in [0, 1]", lambda _, state: 0 <= state <= 1)]


# --- directed graph (test_util.rs:50-118) ---------------------------------


class DGraph(Model):
    """A directed graph over u8 nodes, specified via paths from inits.

    Used to unit-test checker semantics (notably eventually-properties)
    against explicit edge lists.
    """

    def __init__(
        self,
        inits: Optional[Set[int]] = None,
        edges: Optional[Dict[int, Set[int]]] = None,
        property: Optional[Property] = None,
    ):
        self.inits: Set[int] = set(inits or ())
        self.edges: Dict[int, Set[int]] = {k: set(v) for k, v in (edges or {}).items()}
        self._property = property

    @staticmethod
    def with_property(property: Property) -> "DGraph":
        return DGraph(property=property)

    def with_path(self, path: List[int]) -> "DGraph":
        new = DGraph(self.inits, self.edges, self._property)
        src = path[0]
        new.inits.add(src)
        for dst in path[1:]:
            new.edges.setdefault(src, set()).add(dst)
            src = dst
        return new

    def check(self):
        return self.checker().spawn_bfs().join()

    def init_states(self) -> List[int]:
        return sorted(self.inits)

    def actions(self, state: int, actions: List[Any]) -> None:
        actions.extend(sorted(self.edges.get(state, ())))

    def next_state(self, state: int, action: int) -> Optional[int]:
        return action

    def properties(self) -> List[Property]:
        return [self._property] if self._property is not None else []


class PackedDGraph(DGraph):
    """A :class:`DGraph` that also implements the PackedModel protocol.

    States are node ids in one 32-bit word; the successor grid and property
    predicate values are baked into dense tables at construction, copied to
    a device on first use there (before any CUDA graph capture reads them).
    This is the primary semantics fixture for the GPU engine: every
    checker-semantics test over explicit edge lists runs identically there.
    """

    state_words = 1

    def __init__(self, graph: DGraph):
        super().__init__(graph.inits, graph.edges, graph._property)
        n_nodes = 256
        self.max_actions = max(
            (len(dsts) for dsts in self.edges.values()), default=1
        )
        succ = np.zeros((n_nodes, self.max_actions), dtype=np.int64)
        valid = np.zeros((n_nodes, self.max_actions), dtype=bool)
        for src, dsts in self.edges.items():
            for k, dst in enumerate(sorted(dsts)):
                succ[src, k] = dst
                valid[src, k] = True
        props = self.properties()
        prop_table = np.zeros((n_nodes, len(props)), dtype=bool)
        for node in range(n_nodes):
            for j, p in enumerate(props):
                prop_table[node, j] = bool(p.condition(self, node))
        self._host_tables = (succ, valid, prop_table)
        self._device_tables: Dict[torch.device, tuple] = {}

    def _tables(self, device: torch.device) -> tuple:
        """``(successors [256, A], valid [256, A], properties [256, P])`` on
        ``device``."""
        if device not in self._device_tables:
            self._device_tables[device] = tuple(
                torch.as_tensor(a, device=device) for a in self._host_tables
            )
        return self._device_tables[device]

    def pack(self, state: int):
        return np.array([state], dtype=np.uint32)

    def unpack(self, words) -> int:
        return int(words[0])

    def packed_init(self):
        return np.stack([self.pack(s) for s in self.init_states()])

    def packed_step(self, words):
        succ, valid, _ = self._tables(words.device)
        node = words[:, 0]
        return succ[node][:, :, None], valid[node]

    def packed_properties(self, words):
        return self._tables(words.device)[2][words[:, 0]]


# --- function model (test_util.rs:121-139) --------------------------------


class FnModel(Model):
    """A model defined by one function ``f(prev_or_None, out_actions)``.

    With ``prev=None`` the function emits init states; otherwise it emits the
    successors of ``prev`` (next_state is the identity on actions).
    """

    def __init__(self, fn: Callable[[Optional[Any], List[Any]], None]):
        self._fn = fn

    def init_states(self) -> List[Any]:
        out: List[Any] = []
        self._fn(None, out)
        return out

    def actions(self, state: Any, actions: List[Any]) -> None:
        self._fn(state, actions)

    def next_state(self, state: Any, action: Any) -> Optional[Any]:
        return action


# --- linear equation solver (test_util.rs:142-194) ------------------------


class Guess(_NamedEnum):
    INCREASE_X = "IncreaseX"
    INCREASE_Y = "IncreaseY"


class LinearEquation(Model):
    """Finds u8 ``x``,``y`` with ``a*x + b*y == c`` (wrapping arithmetic).

    State space is exactly 256*256 when fully enumerated.
    """

    def __init__(self, a: int, b: int, c: int):
        self.a, self.b, self.c = a, b, c

    def init_states(self):
        return [(0, 0)]

    def actions(self, state, actions: List[Any]) -> None:
        actions.append(Guess.INCREASE_X)
        actions.append(Guess.INCREASE_Y)

    def next_state(self, state, action):
        x, y = state
        if action == Guess.INCREASE_X:
            return ((x + 1) & 0xFF, y)
        return (x, (y + 1) & 0xFF)

    def properties(self) -> List[Property]:
        def solvable(model, solution) -> bool:
            x, y = solution
            return (model.a * x + model.b * y) & 0xFF == model.c

        return [Property.sometimes("solvable", solvable)]
