"""Path: a state/action trace witnessing a property discovery.

The port's own copy of ``stateright_tpu/checker/path.py`` (stateright's
``src/checker/path.rs``).  Paths are reconstructed from 64-bit fingerprints
by re-executing the model forward (the TLC technique cited at
path.rs:439-442), which keeps the search engine free of state storage: the
device visited set holds only fingerprints.
"""

from __future__ import annotations

from typing import Any, Iterable, List, Optional, Sequence, Tuple

from ..fingerprint import fingerprint


class NondeterministicModelError(RuntimeError):
    """Raised when path reconstruction fails: the model's ``init_states``/
    ``actions``/``next_state`` varied between calls (path.rs:36-55, 68-90)."""


class Path:
    """``state --action--> state ... --action--> state``.

    Stored as a list of ``(state, action_or_None)`` pairs where the final
    pair's action is ``None`` (path.rs:16).
    """

    def __init__(self, pairs: List[Tuple[Any, Optional[Any]]]):
        if not pairs:
            raise ValueError("empty path is invalid")
        self._pairs = pairs

    @staticmethod
    def from_fingerprints(model, fingerprints: Sequence[int]) -> "Path":
        """Reconstructs a path by re-executing ``model`` (path.rs:20-97)."""
        fps = list(fingerprints)
        if not fps:
            raise NondeterministicModelError("empty path is invalid")
        init_print = fps[0]
        last_state = None
        for s in model.init_states():
            if fingerprint(s) == init_print:
                last_state = s
                break
        if last_state is None:
            available = [fingerprint(s) for s in model.init_states()]
            raise NondeterministicModelError(
                "Unable to reconstruct a Path from fingerprints: no init state "
                f"has the expected fingerprint ({init_print}). This usually "
                "happens when Model.init_states varies between calls (e.g. the "
                "model reads untracked external state or iterates an unordered "
                f"container). Available init fingerprints: {available}"
            )
        pairs: List[Tuple[Any, Optional[Any]]] = []
        for next_fp in fps[1:]:
            found = None
            for action, state in model.next_steps(last_state):
                if fingerprint(state) == next_fp:
                    found = (action, state)
                    break
            if found is None:
                available = [fingerprint(s) for s in model.next_states(last_state)]
                raise NondeterministicModelError(
                    f"Unable to reconstruct a Path from fingerprints: {1 + len(pairs)} "
                    "previous state(s) were reconstructed, but no subsequent state "
                    f"has the next fingerprint ({next_fp}). This usually happens "
                    "when Model.actions or Model.next_state vary between calls. "
                    f"Available next fingerprints: {available}"
                )
            pairs.append((last_state, found[0]))
            last_state = found[1]
        pairs.append((last_state, None))
        return Path(pairs)

    @staticmethod
    def from_actions(model, init_state, actions: Iterable[Any]) -> Optional["Path"]:
        """Builds a path from an initial state plus actions (path.rs:101-131).

        Returns ``None`` if the input is unreachable via the model.
        """
        if init_state not in model.init_states():
            return None
        pairs: List[Tuple[Any, Optional[Any]]] = []
        prev_state = init_state
        for action in actions:
            found = None
            for a, s in model.next_steps(prev_state):
                if a == action:
                    found = (a, s)
                    break
            if found is None:
                return None
            pairs.append((prev_state, found[0]))
            prev_state = found[1]
        pairs.append((prev_state, None))
        return Path(pairs)

    @staticmethod
    def final_state(model, fingerprints: Sequence[int]) -> Optional[Any]:
        """The final state of a fingerprint path, or None (path.rs:134-165)."""
        fps = list(fingerprints)
        if not fps:
            return None
        matching = None
        for s in model.init_states():
            if fingerprint(s) == fps[0]:
                matching = s
                break
        if matching is None:
            return None
        for next_fp in fps[1:]:
            found = None
            for s in model.next_states(matching):
                if fingerprint(s) == next_fp:
                    found = s
                    break
            if found is None:
                return None
            matching = found
        return matching

    def last_state(self) -> Any:
        return self._pairs[-1][0]

    def into_states(self) -> List[Any]:
        return [s for s, _a in self._pairs]

    def into_actions(self) -> List[Any]:
        return [a for _s, a in self._pairs if a is not None]

    def into_vec(self) -> List[Tuple[Any, Optional[Any]]]:
        return list(self._pairs)

    def encode(self) -> str:
        """Encodes as ``/``-joined fingerprints for URLs (path.rs:189-198)."""
        return "/".join(str(fingerprint(s)) for s, _a in self._pairs)

    def __len__(self) -> int:
        return len(self._pairs) - 1

    def __eq__(self, other) -> bool:
        return isinstance(other, Path) and self._pairs == other._pairs

    def __hash__(self) -> int:
        # Hash only state fingerprints: consistent with __eq__ (equal pairs
        # imply equal states) and avoids requiring actions to be
        # fingerprintable — the engine never requires that of actions.
        return hash(tuple(fingerprint(s) for s, _a in self._pairs))

    def __repr__(self) -> str:
        return f"Path({self._pairs!r})"

    def __str__(self) -> str:
        # Display format asserted by the reference's reporter tests
        # (checker.rs:684-757): "Path[n]:" then "- {action}" per action.
        lines = [f"Path[{len(self)}]:"]
        for _state, action in self._pairs:
            if action is not None:
                lines.append(f"- {action}")
        return "\n".join(lines) + "\n"
