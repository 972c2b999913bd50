"""Sliding puzzle: stateright's first-model doc example.

Counterpart of ``stateright_tpu/models/puzzle.py``, with the doc-test model
of stateright's ``src/lib.rs:40-115``: a 3x3 (generally n x n) sliding
puzzle whose single ``sometimes`` property asserts the board configuration
has a solution; ``assert_discovery`` then pins an actual solution path.
:class:`Puzzle` is the object form, :class:`PackedPuzzle` the GPU form.

State: a tuple of ``n*n`` cell values, ``0`` marking the hole. An action
slides the named neighbour *into* the hole (``Slide::Down`` moves the tile
above the hole down, lib.rs:63-69).
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from ..core import Model, Property
from ..packing import LayoutBuilder, bits_for

# Action = which tile slides into the hole: "Down" slides the tile above
# the hole down, etc. (lib.rs:63-69). Deltas/guards depend on the board
# side, so each form derives them where it needs them.
_MOVES = ("Down", "Up", "Right", "Left")


class Puzzle(Model):
    """Object form (lib.rs:46-88). ``board`` is row-major, 0 = hole."""

    def __init__(self, board: Sequence[int], side: int = 3):
        assert len(board) == side * side, (len(board), side)
        self.board = tuple(board)
        self.side = side

    def init_states(self) -> List[Tuple[int, ...]]:
        return [self.board]

    def actions(self, state, actions: List[Any]) -> None:
        actions.extend(_MOVES)

    def _slide_from(self, state, action):
        """Index of the tile that slides into the hole, or None (the
        reference's ``maybe_from``, lib.rs:62-70)."""
        n = self.side
        empty = state.index(0)
        ey, ex = divmod(empty, n)
        if action == "Down" and ey > 0:
            return empty - n
        if action == "Up" and ey < n - 1:
            return empty + n
        if action == "Right" and ex > 0:
            return empty - 1
        if action == "Left" and ex < n - 1:
            return empty + 1
        return None

    def next_state(self, last_state, action):
        frm = self._slide_from(last_state, action)
        if frm is None:
            return None
        s = list(last_state)
        s[last_state.index(0)] = s[frm]
        s[frm] = 0
        return tuple(s)

    def properties(self) -> List[Property]:
        solved = tuple(range(self.side * self.side))
        return [Property.sometimes("solved", lambda _m, s: s == solved)]

    def format_state(self, state) -> str:
        n = self.side
        return "\n".join(
            " ".join(f"{v}" for v in state[r * n : (r + 1) * n]) for r in range(n)
        )


class PackedPuzzle(Puzzle):
    """GPU form: ``n*n`` cells of ``bits_for(n*n-1)`` bits (a 3x3 board
    packs into 2 words), four action slots, the hole found by an
    ``argmin`` over each state's cells."""

    def __init__(self, board: Sequence[int], side: int = 3):
        super().__init__(board, side)
        nn = side * side
        self._layout = LayoutBuilder().array("cell", nn, bits_for(nn - 1)).finish()
        self.state_words = self._layout.words
        self.max_actions = 4

    def pack(self, state) -> np.ndarray:
        return self._layout.pack(cell=list(state))

    def unpack(self, words):
        return tuple(int(x) for x in self._layout.unpack(words)["cell"])

    def packed_init(self) -> np.ndarray:
        return np.stack([self.pack(s) for s in self.init_states()])

    def packed_step(self, words: torch.Tensor):
        """``words[F, W] -> (next[F, 4, W], valid[F, 4])``, slots in
        ``_MOVES`` order; each slot is written in place from a copy of the
        pre-state."""
        L = self._layout
        n = self.side
        F, W = words.shape
        cells = torch.stack([L.get(words, "cell", k) for k in range(n * n)], 1)
        empty = torch.argmin(cells, dim=1)  # the hole holds 0
        ey, ex = empty // n, empty % n
        nxt = words[:, None, :].expand(F, 4, W).clone()
        valid = torch.stack([ey > 0, ey < n - 1, ex > 0, ex < n - 1], 1)
        for a, delta in enumerate((-n, n, -1, 1)):  # Down, Up, Right, Left
            frm = torch.where(valid[:, a], empty + delta, 0)
            w = nxt[:, a]
            L.set_(w, "cell", torch.gather(cells, 1, frm[:, None]).squeeze(1), empty)
            L.set_(w, "cell", 0, frm)
        return nxt, valid

    def packed_properties(self, words: torch.Tensor) -> torch.Tensor:
        """``[F, 1]``: "solved", every cell ``k`` holding ``k``."""
        L = self._layout
        solved = torch.ones(words.shape[0], dtype=torch.bool, device=words.device)
        for k in range(self.side * self.side):
            solved = solved & (L.get(words, "cell", k) == k)
        return solved[:, None]


def main(argv=None) -> None:
    """Command line in the manner of stateright's examples; the doc board
    (lib.rs:93-96) is the default. ``check`` runs the GPU engine,
    ``check-host`` the host BFS; ``explore`` waits for the Explorer
    (ROADMAP A10)."""
    import sys
    from math import isqrt

    from ..report import WriteReporter

    args = list(sys.argv[1:] if argv is None else argv)
    cmd = args.pop(0) if args else None

    def pop_board():
        """``(board, side)``: the doc board unless the next argument parses
        as a square board of comma-separated ints."""
        if args and all(p.strip().isdigit() for p in args[0].split(",")):
            board = [int(x) for x in args.pop(0).split(",")]
            side = isqrt(len(board))
            if side * side != len(board):
                raise SystemExit(f"board has {len(board)} cells; need a square count")
            return board, side
        return [1, 4, 2, 3, 5, 8, 6, 7, 0], 3

    if cmd == "check":
        board, side = pop_board()
        print("Model checking the sliding puzzle on the GPU.")
        PackedPuzzle(board, side).checker().spawn_xla(
            frontier_capacity=1 << 14, table_capacity=1 << 19
        ).report(WriteReporter())
    elif cmd == "check-host":
        board, side = pop_board()
        print("Model checking the sliding puzzle.")
        Puzzle(board, side).checker().spawn_bfs().report(WriteReporter())
    elif cmd == "explore":
        raise NotImplementedError("explore waits for the Explorer (ROADMAP A10)")
    else:
        print("USAGE:")
        print("  puzzle check [BOARD]        (GPU engine)")
        print("  puzzle check-host [BOARD]   (sequential host BFS)")
        print("BOARD is comma-separated, e.g. 1,4,2,3,5,8,6,7,0")


if __name__ == "__main__":
    main()
