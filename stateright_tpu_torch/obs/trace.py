"""Span tracer: append-only JSONL + Chrome trace-event export.

The port's own copy of ``stateright_tpu/obs/trace.py``: the same record
schema, span ids, ``STPU_TRACE_CTX`` context and Chrome exporter. One JSON
object per line, flushed as written (a process killed mid-run keeps the
spans before it), schema::

    {"ts": <float, seconds since tracer start>,
     "dur": <float, seconds>,
     "name": <str>,
     "span_id": <str, unique within the file>,
     "attrs": {<span attributes>}}

plus — only when the tracer carries a **trace context** — two more keys::

    {"trace_id": <str, the submission's trace id>,
     "parent_id": <str or absent, the parent span's span_id>}

A context is set explicitly (:meth:`Tracer.set_context`) or inherited
from the ``STPU_TRACE_CTX`` environment variable
(``"<trace_id>:<parent_span_id>"``, :func:`format_ctx`/:func:`parse_ctx`),
the propagation seam across process boundaries. Without a context the
extra keys are absent.

The first line of every tracer is a ``trace_start`` span (dur 0) carrying
``pid`` and the absolute ``unix_ts`` of the tracer epoch, so traces from
several processes can be aligned. Span names the port's engine emits
(``stateright_tpu_torch/xla.py``), with the reference's names and attrs:

``dispatch``
    One block: on a card, the host loop of CUDA-graph replays from the
    carry's load to the readback of the block scalars; on the CPU, the
    same levels run eagerly. Attrs: ``flavor`` (``fused``/``single``),
    ``bucket`` (run rows), ``cand`` (candidate cap, or the ladder's rung
    list under fused dispatch), ``committed`` (levels committed — 0 means
    an overflow exit), ``compile`` (this block made a program: on a card,
    captured a graph), ``retry`` (re-run after an overflow recovery),
    ``dedup``, ``compaction``, and — fused path — ``shrink_below``.
``grow_table``
    One doubling of the visited set. Attrs: ``dedup``, ``capacity`` (new).
``delta_flush``
    The delta set's ``maintain`` merge. Attrs: ``proactive`` (the load
    rule at a dispatch boundary, or an overflow's).
``host_verify``
    The host's exact re-check of the device-flagged candidates of the
    host-verified properties. Attrs: ``checked``, ``confirmed``.
``checkpoint``
    One checkpoint write. Attrs: ``path``, ``depth``, ``keep``.
``phase:host_prep`` / ``phase:enqueue`` / ``phase:device_compute`` /
``phase:readback``
    The dispatch-phase split (``spawn_xla(phases=True)`` /
    ``STPU_PHASES=1``, off by default): contiguous sub-intervals of ONE
    parent ``dispatch`` span (``parent_id`` = its ``span_id``). In the
    port: ``host_prep`` is everything before the first replay (programs
    made or captured, the carry loaded); ``enqueue`` is the replay loop,
    which waits on each level's event before it enqueues the next, so it
    holds the device time of every level but the last; ``device_compute``
    is the wait on the last level's event; ``readback`` is the copy of the
    block scalars to the host. Attrs: ``bucket``.

The exporter (:func:`export_chrome`) rewrites a span JSONL as one Chrome
trace-event JSON object (``{"traceEvents": [...]}``, complete events,
microsecond times) — the format Perfetto and ``chrome://tracing`` load
directly; spans carrying ``lanes_active`` additionally render as counter
tracks. The multi-file merger is :mod:`stateright_tpu_torch.obs.collect`.
"""

from __future__ import annotations

import atexit
import json
import os
import time
from typing import Any, Dict, Optional, Tuple


#: The env var carrying a trace context across process boundaries:
#: ``"<trace_id>:<parent_span_id>"`` (parent part may be empty). The
#: service/fleet tiers export it into worker environments; any Tracer
#: constructed in that process inherits it.
CTX_ENV = "STPU_TRACE_CTX"


def new_trace_id() -> str:
    """A fresh submission-scoped trace id (16 hex chars)."""
    return os.urandom(8).hex()


def format_ctx(trace_id: str, parent_id: Optional[str] = None) -> str:
    """The ``STPU_TRACE_CTX`` wire form of a context."""
    return f"{trace_id}:{parent_id or ''}"


def parse_ctx(value: Optional[str]) -> Optional[Tuple[str, Optional[str]]]:
    """``(trace_id, parent_id)`` from the wire form, or None when unset/
    malformed (a bad env var must degrade to context-less tracing, not
    fail the worker)."""
    if not value:
        return None
    trace_id, _, parent = value.partition(":")
    if not trace_id:
        return None
    return trace_id, (parent or None)


class Span:
    """Context manager recording one wall-clock span; attributes may be
    added mid-span with :meth:`set` (e.g. counts only known after the
    host syncs the dispatch results). ``span_id`` is allocated at entry so
    in-flight consumers (the phase profiler) can parent sub-spans to it."""

    __slots__ = ("_tracer", "name", "attrs", "_t0", "span_id")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        self.span_id = self._tracer._new_sid()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        t0 = self._t0
        self._tracer._emit(
            self.name, t0, time.monotonic() - t0, self.attrs,
            span_id=self.span_id,
        )
        return False


class _NullSpan:
    """The do-nothing span: tracing off costs two attribute lookups and a
    shared-singleton return — no clock reads, no allocation, no I/O."""

    __slots__ = ()

    span_id = None

    def set(self, **attrs: Any) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _NullTracer:
    enabled = False
    trace_id = None

    def span(self, name: str, **attrs: Any) -> _NullSpan:
        return _NULL_SPAN

    def emit(self, name: str, **kw: Any) -> Optional[str]:
        return None

    def new_span_id(self) -> Optional[str]:
        return None

    def set_context(self, trace_id: Optional[str],
                    parent_id: Optional[str] = None) -> None:
        pass

    def set_parent(self, parent_id: Optional[str]) -> None:
        pass

    def close(self) -> None:
        pass


#: The shared off-switch: engines hold this when no trace is configured.
NULL_TRACER = _NullTracer()


class Tracer:
    """Append-only JSONL span writer (see module docstring for schema)."""

    enabled = True

    def __init__(self, path: str, chrome_path: Optional[str] = None):
        self.path = path
        self.chrome_path = chrome_path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._fh = open(path, "a")
        self._epoch = time.monotonic()
        # Span ids are unique within the appended file across processes
        # and attempts: pid + a 2-byte salt (pid reuse across a long
        # kill/requeue chain) + a per-tracer sequence.
        self._sid_prefix = f"{os.getpid():x}-{os.urandom(2).hex()}"
        self._sid_seq = 0
        # Distributed-trace context: inherited from STPU_TRACE_CTX (the
        # cross-process seam) unless set_context overrides it.
        ctx = parse_ctx(os.environ.get(CTX_ENV))
        self.trace_id, self._parent_id = ctx if ctx else (None, None)
        self._emit(
            "trace_start", self._epoch, 0.0,
            {"pid": os.getpid(), "unix_ts": time.time()},
        )
        if chrome_path is not None:
            # Best-effort export when the process ends — checkers have no
            # close hook, and an explicit export_chrome() call (bench.py,
            # tests) always works regardless.
            atexit.register(self.close)

    @property
    def closed(self) -> bool:
        return self._fh.closed

    def span(self, name: str, **attrs: Any) -> Span:
        return Span(self, name, attrs)

    def set_context(self, trace_id: Optional[str],
                    parent_id: Optional[str] = None) -> None:
        """Join (or leave, with None) a distributed trace: subsequent
        records carry ``trace_id`` and default their ``parent_id`` to
        ``parent_id`` until narrowed by :meth:`set_parent`."""
        self.trace_id = trace_id
        self._parent_id = parent_id

    def set_parent(self, parent_id: Optional[str]) -> None:
        """Re-root subsequent spans under ``parent_id`` (e.g. a worker's
        enclosing job span, so engine dispatch spans nest under it)."""
        self._parent_id = parent_id

    def emit(self, name: str, *, t0: float, dur: float,
             attrs: Optional[Dict[str, Any]] = None,
             parent_id: Optional[str] = None,
             trace_id: Optional[str] = None,
             span_id: Optional[str] = None) -> Optional[str]:
        """Emit one pre-timed span (``t0`` on the ``time.monotonic`` clock,
        ``dur`` seconds) and return its span_id. The phase profiler and
        the service tiers use this for intervals measured with raw stamps
        rather than a ``with`` block. ``trace_id`` overrides the tracer's
        ambient context per record — a SHARED tracer (one service file,
        many concurrent jobs) must not mutate ambient state per job — and
        ``span_id`` lets a caller pre-allocate the id
        (:meth:`new_span_id`) so children can reference a span emitted
        only after they finish (the supervising attempt span)."""
        sid = span_id if span_id is not None else self._new_sid()
        self._emit(name, t0, dur, dict(attrs or {}), span_id=sid,
                   parent_id=parent_id, trace_id=trace_id)
        return sid

    def new_span_id(self) -> str:
        """Pre-allocate a span id (for :meth:`emit`'s ``span_id=``)."""
        return self._new_sid()

    def _new_sid(self) -> str:
        self._sid_seq += 1
        return f"{self._sid_prefix}.{self._sid_seq}"

    def _emit(self, name: str, t0: float, dur: float, attrs: Dict[str, Any],
              span_id: Optional[str] = None,
              parent_id: Optional[str] = None,
              trace_id: Optional[str] = None) -> None:
        if self._fh.closed:  # post-close span from a lingering checker
            return
        rec = {
            "ts": round(t0 - self._epoch, 6),
            "dur": round(dur, 6),
            "name": name,
            "span_id": span_id if span_id is not None else self._new_sid(),
            "attrs": attrs,
        }
        tid = trace_id if trace_id is not None else self.trace_id
        if tid is not None:
            rec["trace_id"] = tid
            parent = parent_id if parent_id is not None else self._parent_id
            if parent is not None:
                rec["parent_id"] = parent
        elif parent_id is not None:
            rec["parent_id"] = parent_id
        self._fh.write(json.dumps(rec, default=str) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()
        if self.chrome_path is not None:
            try:
                export_chrome(self.path, self.chrome_path)
            except OSError:  # pragma: no cover - exit-path best effort
                pass


def export_chrome(jsonl_path: str, out_path: str) -> int:
    """Rewrites a span JSONL as Chrome trace-event JSON (complete "X"
    events, microsecond clocks) that Perfetto / ``chrome://tracing`` open
    directly. Returns the number of events written. Lines that do not
    parse (a wedge mid-write) are skipped, not fatal.

    Mux-lane telemetry renders as counter tracks: every span whose attrs
    carry ``lanes_active`` (the batched dispatch spans,
    docs/observability.md "Lane telemetry") additionally emits one "C"
    event at its start, so Perfetto charts lane occupancy over the run
    next to the slices."""
    events = []
    pid = os.getpid()
    # An appended file can hold several tracer sessions (bench retries:
    # one per worker process), each with its own zero-based monotonic
    # epoch. Rebase every session onto the first one's wall clock via
    # the unix_ts each trace_start records, so the exported timeline is
    # sequential instead of all sessions overlapping at t=0.
    base_unix = None
    offset = 0.0
    with open(jsonl_path) as fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("name") == "trace_start":
                attrs = rec.get("attrs", {})
                pid = attrs.get("pid", pid)
                u = attrs.get("unix_ts")
                if u is not None:
                    if base_unix is None:
                        base_unix = u
                    offset = u - base_unix
                continue
            events.extend(
                chrome_events(rec, pid=pid, tid=1, offset_s=offset)
            )
    parent = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(parent, exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, fh)
    return len(events)


def chrome_events(rec: Dict[str, Any], *, pid: int, tid: int,
                  offset_s: float = 0.0) -> list:
    """The Chrome trace events for ONE span record: the complete "X"
    slice (context ids ride in ``args``), plus a ``lanes_active`` counter
    sample when the span carries lane telemetry. Shared by the
    single-file exporter above and the run-dir merger (obs/collect.py)
    so both render identically."""
    attrs = rec.get("attrs", {})
    args = dict(attrs)
    for key in ("trace_id", "span_id", "parent_id"):
        if rec.get(key) is not None:
            args[key] = rec[key]
    ts = round((rec["ts"] + offset_s) * 1e6, 3)
    out = [
        {
            "name": rec["name"],
            "cat": "stateright_tpu",
            "ph": "X",
            "ts": ts,
            "dur": round(rec["dur"] * 1e6, 3),
            "pid": pid,
            "tid": tid,
            "args": args,
        }
    ]
    if "lanes_active" in attrs:
        counters = {"lanes_active": attrs["lanes_active"]}
        if "lanes" in attrs:
            counters["lanes_idle"] = (
                attrs["lanes"] - attrs["lanes_active"]
            )
        out.append(
            {
                "name": "mux lanes",
                "cat": "stateright_tpu",
                "ph": "C",
                "ts": ts,
                "pid": pid,
                "args": counters,
            }
        )
    return out
