"""Progress reporting. Mirrors stateright's ``src/report.rs``.

The port's own copy of ``stateright_tpu/report.py``.

``WriteReporter``'s exact output format is part of the reference's test
contract (checker.rs:684-757): ``Checking. states=…`` progress lines, a
``Done. states=…, sec=…`` summary, then one ``Discovered "name" …`` block per
discovery.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Dict, TextIO


@dataclass
class ReportData:
    """The data sent during a report event (report.rs:9-20)."""

    total_states: int
    unique_states: int
    max_depth: int
    duration: float  # seconds
    done: bool


@dataclass
class ReportDiscovery:
    """A discovery found during checking (report.rs:23-31)."""

    path: "Path"
    classification: str  # "example" | "counterexample"


class Reporter:
    """A reporter for progress during model checking (report.rs:34-47)."""

    def report_checking(self, data: ReportData) -> None:
        raise NotImplementedError

    def report_discoveries(self, discoveries: Dict[str, ReportDiscovery]) -> None:
        raise NotImplementedError

    def delay(self) -> float:
        """Seconds between progress reports."""
        return 1.0


class WriteReporter(Reporter):
    """Writes the reference's exact text format (report.rs:49-96)."""

    def __init__(self, writer: TextIO = None):
        self.writer = writer if writer is not None else sys.stdout

    def report_checking(self, data: ReportData) -> None:
        if data.done:
            self.writer.write(
                f"Done. states={data.total_states}, unique={data.unique_states}, "
                f"depth={data.max_depth}, sec={int(data.duration)}\n"
            )
        else:
            self.writer.write(
                f"Checking. states={data.total_states}, "
                f"unique={data.unique_states}, depth={data.max_depth}\n"
            )

    def report_discoveries(self, discoveries: Dict[str, ReportDiscovery]) -> None:
        # BTreeMap iteration order in the reference == sorted by name.
        for name in sorted(discoveries):
            d = discoveries[name]
            self.writer.write(f'Discovered "{name}" {d.classification} {d.path}')
