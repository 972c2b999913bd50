"""Metrics time-series: ``checker.metrics()`` snapshots over wall-clock.

The port's own copy of ``stateright_tpu/obs/timeseries.py``, with the
same row schema, rotation and environment names.

``checker.metrics()`` (obs/metrics.py + the engines) is a point-in-time
snapshot and the span trace is per-event; neither answers "what did the
run look like *over time*" — frontier growth, gen/s trends, occupancy
creep, queue depth under a service. :class:`MetricsRecorder` is that
layer: an append-only, rotating ``metrics.jsonl`` of snapshot rows,
sampled by the engines at quiescent superstep boundaries (the same points
the auto-checkpointer uses — the device state is a pure function of
host-visible arrays there, so sampling never adds a device sync) on a
cadence of committed levels or wall-clock seconds.

Row schema (one JSON object per line, schema-versioned)::

    {"v": 1,
     "unix_ts": <float, absolute seconds>,
     "t": <float, seconds since the recorder armed>,
     "seq": <int, rows written by this recorder>,
     "kind": "engine" | "pool" | <caller-defined>,
     "metrics": {<the snapshot, verbatim>}}

Rotation mirrors the checkpoint module's pattern (checkpoint.py): when the
live file reaches ``rotate_rows`` rows it shifts to ``<path>.1`` (``.1``
to ``.2``, ... retaining ``keep`` files) via ``os.replace`` — atomic from
any reader's view, bounded on disk at soak scale. :func:`read_series`
reads the rotation chain back oldest-first, skipping torn lines (a
SIGKILL mid-append is this system's designed failure mode).

Off by default, same pin discipline as the tracer: engines hold ``None``
and the hot-path cost is one ``is not None`` check; results are
bit-identical with recording on (pinned in tests/test_obs.py). Knobs::

    spawn_xla(metrics_to=path, metrics_every=N|"Ns", metrics_keep=K)
    STPU_METRICS_TO / STPU_METRICS_EVERY / STPU_METRICS_KEEP

Consumers: ``obs/promexport.py`` (OpenMetrics render of a series tail)
and ``chip_smoke.py``'s ``obs`` phase. The schema is the reference's,
held by tests/test_torch_obs.py.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from ..checkpoint import _parse_every

#: Row schema version — consumers (promexport, the dashboard, roofline)
#: key on this; bump on any breaking row-shape change.
SCHEMA_VERSION = 1


class MetricsRecorder:
    """Append-only rotating JSONL sampler of metrics snapshots.

    The engines call :meth:`maybe` at every quiescent point (next to the
    auto-checkpoint hook); this object decides whether a row is due —
    every ``every`` committed levels, or every that many seconds with an
    ``"Ns"`` spec — and appends the snapshot. :meth:`sample` is the
    direct form (``force=True`` writes unconditionally: final rows,
    pool-side samplers, the Explorer's live ring)."""

    #: Default cadence when ``metrics_to`` is set without an explicit
    #: ``metrics_every``: frequent enough for a live dashboard, cheap
    #: enough for a soak (one small JSON line per write).
    DEFAULT_EVERY = "5s"
    DEFAULT_KEEP = 3
    #: Rows per rotation file. At one row / 5 s a file spans ~5.7 hours;
    #: keep=3 bounds a soak's series to ~17 hours of history on disk.
    DEFAULT_ROTATE_ROWS = 4096

    def __init__(
        self,
        path: str,
        every: Any = None,
        keep: Optional[int] = None,
        rotate_rows: Optional[int] = None,
    ):
        # The cadence grammar is the auto-checkpointer's (_parse_every:
        # int = committed levels, "Ns" = wall-clock seconds) — one
        # spelling for both quiescent-point consumers.

        self.path = path
        self.every_levels, self.every_seconds = _parse_every(
            self.DEFAULT_EVERY if every is None else every
        )
        self.keep = self.DEFAULT_KEEP if keep is None else int(keep)
        if self.keep < 1:
            raise ValueError(f"metrics_keep must be >= 1: {self.keep}")
        self.rotate_rows = (
            self.DEFAULT_ROTATE_ROWS if rotate_rows is None else int(rotate_rows)
        )
        if self.rotate_rows < 1:
            raise ValueError(f"rotate_rows must be >= 1: {self.rotate_rows}")
        self.seq = 0
        self._epoch = time.monotonic()
        self._last_depth: Optional[int] = None
        self._last_time: Optional[float] = None
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        # Append mode: a resumed/requeued worker continues the same
        # series file; count the rows already there so rotation bounds
        # hold across process restarts. A torn tail (SIGKILL mid-append
        # left a partial line with no trailing newline — the designed
        # failure mode) is repaired with a newline FIRST, so the next
        # row never concatenates onto the fragment and gets lost with it.
        self._rows_in_file = 0
        torn_tail = False
        if os.path.exists(path):
            try:
                last = b"\n"
                with open(path, "rb") as fh:
                    for line in fh:
                        self._rows_in_file += 1
                        last = line
                torn_tail = not last.endswith(b"\n")
            except OSError:
                pass
        self._fh = open(path, "a")
        if torn_tail:
            self._fh.write("\n")
            self._fh.flush()

    @classmethod
    def resolve(cls, metrics_to, metrics_every, metrics_keep):
        """The spawn-kwarg/env resolution the engines share (mirrors
        ``AutoCheckpointer.resolve``): ``metrics_to`` / ``STPU_METRICS_TO``
        arms recording; ``metrics_every`` / ``STPU_METRICS_EVERY`` and
        ``metrics_keep`` / ``STPU_METRICS_KEEP`` tune it. Returns None
        when off. The env path arms every checker in the process onto one
        file — rows are self-describing (``kind`` + the snapshot's own
        ``engine``/``job_id``), so a shared file stays parseable, but
        multi-checker processes that want separate series must pass
        ``metrics_to`` explicitly per spawn (the service worker does)."""
        path = metrics_to or os.environ.get("STPU_METRICS_TO") or None
        if path is None:
            return None
        every = (
            metrics_every
            if metrics_every is not None
            else os.environ.get("STPU_METRICS_EVERY") or None
        )
        keep = (
            metrics_keep
            if metrics_keep is not None
            else os.environ.get("STPU_METRICS_KEEP") or None
        )
        return cls(path, every, None if keep is None else int(keep))

    @property
    def closed(self) -> bool:
        return self._fh.closed

    # --- cadence (the AutoCheckpointer contract) --------------------------

    def arm(self, depth: int) -> None:
        """Baseline the cadence at the checker's starting point (fresh
        init or restore) — the first interval is measured from here."""
        self._last_depth = depth
        self._last_time = time.monotonic()

    def due(self, depth: int) -> bool:
        if self._last_depth is None:
            self.arm(depth)
            return False
        if self.every_levels is not None:
            return depth - self._last_depth >= self.every_levels
        return time.monotonic() - self._last_time >= self.every_seconds

    def maybe(self, checker) -> bool:
        """Engine hook at a quiescent superstep boundary: append a row if
        one is due. ``checker.metrics()`` is pure host-side reads, so this
        never adds a device sync. Returns whether it wrote."""
        depth = checker._depth
        if not self.due(depth):
            return False
        self.sample(checker.metrics(), kind="engine")
        self._last_depth = depth
        self._last_time = time.monotonic()
        return True

    # --- writing ----------------------------------------------------------

    def sample(self, metrics: Dict[str, Any], kind: str = "engine") -> None:
        """Append one row unconditionally (cadence-independent callers:
        final rows at completion, pool gauges, live dashboard rings)."""
        if self._fh.closed:  # post-close sample from a lingering checker
            return
        row = {
            "v": SCHEMA_VERSION,
            "unix_ts": time.time(),
            "t": round(time.monotonic() - self._epoch, 6),
            "seq": self.seq,
            "kind": kind,
            "metrics": metrics,
        }
        self._fh.write(json.dumps(row, default=str) + "\n")
        self._fh.flush()
        self.seq += 1
        self._rows_in_file += 1
        if self._rows_in_file >= self.rotate_rows:
            self._rotate()

    def _rotate(self) -> None:
        """Shift the full live file down the rotation chain (checkpoint.py
        pattern: ``.1`` to ``.2``, ..., live to ``.1``, retaining ``keep``
        files total) and start a fresh live file."""
        self._fh.close()
        if self.keep > 1:
            for i in range(self.keep - 1, 1, -1):
                older = f"{self.path}.{i - 1}"
                if os.path.exists(older):
                    os.replace(older, f"{self.path}.{i}")
            os.replace(self.path, f"{self.path}.1")
        else:
            try:
                os.unlink(self.path)
            except OSError:
                pass
        self._fh = open(self.path, "a")
        self._rows_in_file = 0

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()


def series_files(path: str) -> List[str]:
    """Existing rotation files for ``path``, OLDEST first (``.K`` ...
    ``.1``, then the live file) — the read order that reassembles the
    series chronologically."""
    out = []
    i = 1
    while os.path.exists(f"{path}.{i}"):
        out.append(f"{path}.{i}")
        i += 1
    out.reverse()
    if os.path.exists(path):
        out.append(path)
    return out


def read_series(path: str, window: Optional[int] = None) -> List[Dict[str, Any]]:
    """The parsed series across the rotation chain, oldest row first;
    ``window`` keeps only the newest N rows. Lines that do not parse (a
    kill mid-append) or are not v-schema rows are skipped, not fatal."""
    rows: List[Dict[str, Any]] = []
    for f in series_files(path):
        try:
            with open(f) as fh:
                for line in fh:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if isinstance(rec, dict) and "v" in rec and "metrics" in rec:
                        rows.append(rec)
        except OSError:
            continue
    if window is not None and window >= 0:
        rows = rows[-window:] if window else []
    return rows
