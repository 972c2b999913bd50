"""Run-trace observability: spans, counters, heartbeat, time series.

The port's own copy of ``stateright_tpu/obs``, with the same schemas and
environment names. It imports nothing of the JAX package and no torch
outside ``promexport.build_info_sample``.

- :class:`~stateright_tpu_torch.obs.trace.Tracer` — host-side wall-clock
  spans around every host↔device boundary of ``spawn_xla()`` (a block of
  CUDA-graph replays, table growth, delta flush, host-verify round trip,
  checkpoint), appended as JSONL (``STPU_TRACE=path`` /
  ``spawn_xla(trace=...)``) with a Chrome trace-event exporter
  (``export_chrome``); ``STPU_TRACE_CHROME=path`` exports at interpreter
  exit.
- :class:`~stateright_tpu_torch.obs.metrics.Counters` — the counter half of
  ``checker.metrics()``.
- :class:`~stateright_tpu_torch.obs.heartbeat.Heartbeat` — a small JSON
  file rewritten around every dispatch (``STPU_HEARTBEAT=path`` /
  ``spawn_xla(heartbeat=...)``).
- :class:`~stateright_tpu_torch.obs.timeseries.MetricsRecorder` — rotating
  ``metrics.jsonl`` rows of ``checker.metrics()`` at block boundaries
  (``STPU_METRICS_TO/EVERY/KEEP`` / ``spawn_xla(metrics_to=...,
  metrics_every=..., metrics_keep=...)``).
- :mod:`~stateright_tpu_torch.obs.promexport` — OpenMetrics rendering and
  its validating parser.
- :mod:`~stateright_tpu_torch.obs.collect` — the merger of a directory of
  span files into one Chrome trace.

Everything here is OFF by default. With tracing off the engine holds the
shared :data:`NULL_TRACER`, whose ``span()`` returns a no-op context — no
files, no clocks, no allocation — and nothing of it enters a captured
CUDA graph: spans wrap host code only.
"""

from __future__ import annotations

import os
from typing import Optional, Union

from . import collect
from .heartbeat import Heartbeat
from .metrics import Counters
from .timeseries import MetricsRecorder, read_series
from .trace import (
    CTX_ENV,
    NULL_TRACER,
    Span,
    Tracer,
    export_chrome,
    format_ctx,
    new_trace_id,
    parse_ctx,
)

__all__ = [
    "CTX_ENV",
    "Counters",
    "Heartbeat",
    "MetricsRecorder",
    "NULL_TRACER",
    "Span",
    "Tracer",
    "collect",
    "export_chrome",
    "format_ctx",
    "new_trace_id",
    "parse_ctx",
    "read_series",
    "resolve_heartbeat",
    "resolve_recorder",
    "resolve_tracer",
]


#: Process-wide live tracers by absolute path: several checkers in one
#: process (bench primary pass + matrix entries) must SHARE one tracer —
#: one epoch, one ``trace_start`` — or the appended file's timestamps
#: restart at zero mid-run and the Chrome/roofline timeline garbles.
_TRACERS: dict = {}


def resolve_tracer(trace: Union[None, str, Tracer] = None):
    """The tracer a checker should hold: an explicit :class:`Tracer`, a
    path (``spawn_xla(trace="...")``), the ``STPU_TRACE`` env default, or
    — the common case — the shared no-op :data:`NULL_TRACER`. Path
    resolution is cached process-wide (one tracer per file).

    ``STPU_TRACE_CHROME`` (env) or ``Tracer(chrome_path=...)`` additionally
    exports the Chrome trace-event form when the tracer closes."""
    if isinstance(trace, Tracer):
        return trace
    if trace is None:
        trace = os.environ.get("STPU_TRACE") or None
    if trace is None:
        return NULL_TRACER
    path = os.path.abspath(trace)
    tracer = _TRACERS.get(path)
    if tracer is None or tracer.closed:
        tracer = Tracer(
            path, chrome_path=os.environ.get("STPU_TRACE_CHROME") or None
        )
        _TRACERS[path] = tracer
    return tracer


def resolve_heartbeat(heartbeat: Union[None, str, Heartbeat] = None) -> Optional[Heartbeat]:
    """The heartbeat a checker should beat, or None (the default — the
    protocol is for watchdog-supervised runs, not every spawn)."""
    if isinstance(heartbeat, Heartbeat):
        return heartbeat
    if heartbeat is None:
        heartbeat = os.environ.get("STPU_HEARTBEAT") or None
    if heartbeat is None:
        return None
    return Heartbeat(heartbeat)


def resolve_recorder(metrics_to=None, metrics_every=None, metrics_keep=None):
    """The metrics recorder a checker should sample into, or None (the
    default — same off-by-default pin discipline as the tracer). Accepts
    a live :class:`MetricsRecorder` (shared-series embedders), a path, or
    the ``STPU_METRICS_{TO,EVERY,KEEP}`` env knobs."""
    if isinstance(metrics_to, MetricsRecorder):
        return metrics_to
    return MetricsRecorder.resolve(metrics_to, metrics_every, metrics_keep)
