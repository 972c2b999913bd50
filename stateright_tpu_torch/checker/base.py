"""The ``Checker`` interface: counters, discoveries, assertions, reporting.

The port's own copy of ``stateright_tpu/checker/base.py`` (stateright's
``Checker`` trait, ``src/checker.rs:254-538``).  Checkers run lazily
in-process: ``spawn_*`` builds the checker with initial counters, ``join()``
(or ``report()``) drives it to completion.  The GPU engine runs one BFS
level per ``_run_block`` call.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from ..core import Expectation, Model
from ..report import ReportData, ReportDiscovery, Reporter
from .path import Path


class Checker:
    """Uniform checker API (checker.rs:254-538)."""

    # --- engine hooks -----------------------------------------------------

    def model(self) -> Model:
        raise NotImplementedError

    def state_count(self) -> int:
        """Total states generated including repeats (checker.rs:270)."""
        raise NotImplementedError

    def unique_state_count(self) -> int:
        """Unique states generated (checker.rs:274)."""
        raise NotImplementedError

    def max_depth(self) -> int:
        """Maximum depth explored so far (checker.rs:277)."""
        raise NotImplementedError

    def discoveries(self) -> Dict[str, Path]:
        """Map from property name to discovery path (checker.rs:281)."""
        raise NotImplementedError

    def is_done(self) -> bool:
        """All properties discovered or all reachable states visited."""
        raise NotImplementedError

    def _run_block(self) -> None:
        """Advance the search by a bounded amount of work (engine hook)."""
        raise NotImplementedError

    def metrics(self) -> Dict[str, Any]:
        """A telemetry snapshot: the counters every engine has."""
        return {
            "engine": type(self).__name__,
            "state_count": self.state_count(),
            "unique_state_count": self.unique_state_count(),
            "max_depth": self.max_depth(),
        }

    _started = False

    def _ensure_started(self) -> None:
        """Runs at least one block per checker lifetime, matching the
        reference whose worker threads always enter check_block once even if
        every property already has a discovery (bfs.rs:149-159)."""
        if not self._started:
            self._started = True
            self._run_block()

    def join(self) -> "Checker":
        """Drives checking to completion (checker.rs:287-295)."""
        self._ensure_started()
        while not self.is_done():
            self._run_block()
        return self

    # --- derived API ------------------------------------------------------

    def discovery(self, name: str) -> Optional[Path]:
        return self.discoveries().get(name)

    def discovery_classification(self, name: str) -> str:
        """"example" or "counterexample" (checker.rs:414-424)."""
        prop = self.model().property(name)
        if prop.expectation == Expectation.SOMETIMES:
            return "example"
        return "counterexample"

    def report(self, reporter: Reporter) -> "Checker":
        """Runs to completion, emitting periodic progress (checker.rs:371-412).

        The first progress snapshot is emitted before any work, so output for
        small models is deterministic: ``Checking. states=…`` with initial
        counters, then ``Done. …``, then discoveries sorted by name.
        """
        start = time.monotonic()
        if not self.is_done():
            reporter.report_checking(self._report_data(start, done=False))
        last = time.monotonic()
        self._ensure_started()
        while not self.is_done():
            self._run_block()
            now = time.monotonic()
            if now - last >= reporter.delay() and not self.is_done():
                reporter.report_checking(self._report_data(start, done=False))
                last = now
        reporter.report_checking(self._report_data(start, done=True))
        discoveries = {
            name: ReportDiscovery(path, self.discovery_classification(name))
            for name, path in self.discoveries().items()
        }
        reporter.report_discoveries(discoveries)
        return self

    def _report_data(self, start: float, done: bool) -> ReportData:
        return ReportData(
            total_states=self.state_count(),
            unique_states=self.unique_state_count(),
            max_depth=self.max_depth(),
            duration=time.monotonic() - start,
            done=done,
        )

    # --- assertion helpers (checker.rs:426-537) ---------------------------

    def assert_properties(self) -> None:
        for p in self.model().properties():
            if p.expectation == Expectation.SOMETIMES:
                self.assert_any_discovery(p.name)
            else:
                self.assert_no_discovery(p.name)

    def assert_any_discovery(self, name: str) -> Path:
        found = self.discovery(name)
        if found is not None:
            return found
        if not self.is_done():
            raise AssertionError(
                f'Discovery for "{name}" not found, but model checking is incomplete.'
            )
        raise AssertionError(f'Discovery for "{name}" not found.')

    def assert_no_discovery(self, name: str) -> None:
        found = self.discovery(name)
        if found is not None:
            raise AssertionError(
                f'Unexpected "{name}" {self.discovery_classification(name)} '
                f"{found}Last state: {found.last_state()!r}\n"
            )
        if not self.is_done():
            raise AssertionError(
                f'Discovery for "{name}" not found, but model checking is incomplete.'
            )

    def assert_discovery(self, name: str, actions: List[Any]) -> None:
        """Asserts ``actions`` produce a valid discovery for ``name``
        (checker.rs:481-537)."""
        additional_info: List[str] = []
        found = self.assert_any_discovery(name)
        model = self.model()
        for init_state in model.init_states():
            path = Path.from_actions(model, init_state, actions)
            if path is None:
                continue
            prop = model.property(name)
            if prop.expectation == Expectation.ALWAYS:
                if not prop.condition(model, path.last_state()):
                    return
            elif prop.expectation == Expectation.EVENTUALLY:
                states = path.into_states()
                is_liveness_satisfied = any(prop.condition(model, s) for s in states)
                terminal_actions: List[Any] = []
                model.actions(states[-1], terminal_actions)
                is_path_terminal = not terminal_actions
                if not is_liveness_satisfied and is_path_terminal:
                    return
                if is_liveness_satisfied:
                    additional_info.append(
                        "incorrect counterexample satisfies eventually property"
                    )
                if not is_path_terminal:
                    additional_info.append("incorrect counterexample is nonterminal")
            else:  # SOMETIMES
                if prop.condition(model, path.last_state()):
                    return
        info = f" ({'; '.join(additional_info)})" if additional_info else ""
        raise AssertionError(
            f'Invalid discovery for "{name}"{info}, but a valid one was found. '
            f"found={found.into_actions()!r}"
        )
