"""Merged fleet timeline: stitch every span ``trace.jsonl`` under a
service/fleet run dir into ONE Perfetto-loadable Chrome trace.

The port's own copy of ``stateright_tpu/obs/collect.py``: it merges the
run dirs of the port's ``CheckerService`` and ``FleetService``
(``service/core.py``, ``service/fleet.py``), and any other directory of
span files, a set of port checkers' traces included.

A traced run scatters span files across the process tree — the fleet's
router (``<run_dir>/trace.jsonl``), each pool's service
(``device-*/trace.jsonl``), and every worker job/lane
(``.../job-*/trace.jsonl``). Each file is one or more tracer *sessions*
(kill-resume appends a fresh ``trace_start`` per attempt), each with its
own zero-based monotonic epoch. The merger:

- assigns every file a synthetic Chrome ``pid`` with a ``process_name``
  metadata track labelled by its run-dir-relative path, so the timeline
  reads as one row per service/device/job;
- rebases every session onto the EARLIEST ``trace_start`` wall clock in
  the whole run dir (the ``unix_ts`` each session records), so
  cross-process spans line up on one global time axis;
- re-emits mux-lane counter samples (``lanes_active`` attrs) as "C"
  events per process, same rendering as the single-file exporter;
- draws **flow arrows** per distributed ``trace_id`` over the anchor
  spans (``submit`` → ``route`` → ``attempt`` → ``job`` → ``lane`` →
  ``migrate``, in timestamp order), so one submission's path across
  routing, attempts, migration hops, and batched lanes is a single
  connected arc in Perfetto.

Surface: :func:`collect` returns the trace object, :func:`write` dumps
it. Pure host-side file walking — no device.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

from .trace import chrome_events

#: Span names that anchor a distributed trace's flow arc, in causal
#: order of the tiers that emit them (ties broken by timestamp).
ANCHOR_SPANS = ("submit", "route", "attempt", "job", "lane", "migrate")


def trace_files(run_dir: str) -> List[str]:
    """Every span JSONL under ``run_dir`` (files named ``trace.jsonl``),
    sorted by relative path — the fleet/service root file first, then
    device pools, then per-job dirs."""
    found = []
    for root, _dirs, files in os.walk(run_dir):
        for name in files:
            if name == "trace.jsonl":
                found.append(os.path.join(root, name))
    return sorted(found, key=lambda p: os.path.relpath(p, run_dir))


def _read_sessions(path: str) -> List[Dict[str, Any]]:
    """Parse one span JSONL into tracer sessions: ``trace_start`` opens a
    session; records before any (a torn head) get a synthetic one.
    Unparseable lines (a kill mid-write) are skipped, never fatal."""
    sessions: List[Dict[str, Any]] = []
    cur: Optional[Dict[str, Any]] = None
    try:
        fh = open(path)
    except OSError:
        return sessions
    with fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not isinstance(rec, dict) or "name" not in rec:
                continue
            if rec.get("name") == "trace_start":
                attrs = rec.get("attrs", {})
                cur = {
                    "unix_ts": attrs.get("unix_ts"),
                    "pid": attrs.get("pid"),
                    "records": [],
                }
                sessions.append(cur)
                continue
            if cur is None:
                cur = {"unix_ts": None, "pid": None, "records": []}
                sessions.append(cur)
            cur["records"].append(rec)
    return sessions


def collect(run_dir: str) -> Dict[str, Any]:
    """The merged Chrome trace object for ``run_dir`` (see module
    docstring). Always returns a valid (possibly empty) trace."""
    files = trace_files(run_dir)
    per_file: List[Tuple[str, List[Dict[str, Any]]]] = [
        (os.path.relpath(path, run_dir), _read_sessions(path))
        for path in files
    ]
    # Global epoch: earliest session wall clock anywhere in the run dir.
    # Sessions with no unix_ts (torn head) fall back to offset 0 — their
    # spans still render, just unaligned.
    base_unix = None
    for _rel, sessions in per_file:
        for s in sessions:
            u = s["unix_ts"]
            if u is not None and (base_unix is None or u < base_unix):
                base_unix = u

    meta: List[Dict[str, Any]] = []
    events: List[Dict[str, Any]] = []
    # anchors[trace_id] -> list of (abs_ts_us, causal_rank, pid, tid)
    anchors: Dict[str, List[Tuple[float, int, int, int]]] = {}
    for index, (rel, sessions) in enumerate(per_file):
        pid = index + 1
        label = os.path.dirname(rel) or "."
        meta.append({
            "name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": label},
        })
        meta.append({
            "name": "process_sort_index", "ph": "M", "pid": pid,
            "args": {"sort_index": index},
        })
        for s in sessions:
            u = s["unix_ts"]
            offset = (u - base_unix) if (u is not None and
                                         base_unix is not None) else 0.0
            for rec in s["records"]:
                try:
                    evs = chrome_events(rec, pid=pid, tid=1,
                                        offset_s=offset)
                except (KeyError, TypeError):
                    continue  # a malformed record must not kill the merge
                events.extend(evs)
                tid_ = rec.get("trace_id")
                if tid_ and rec.get("name") in ANCHOR_SPANS:
                    anchors.setdefault(tid_, []).append((
                        evs[0]["ts"],
                        ANCHOR_SPANS.index(rec["name"]),
                        pid, 1,
                    ))

    # Flow arrows: one arc per trace_id through its anchors in time
    # order. Chrome binds a flow event to the slice ENCLOSING its ts at
    # that pid/tid — each anchor's own start ts qualifies.
    flows: List[Dict[str, Any]] = []
    for trace_id, marks in anchors.items():
        if len(marks) < 2:
            continue
        marks.sort()
        last = len(marks) - 1
        for i, (ts, _rank, pid, tid) in enumerate(marks):
            ev = {
                "name": "trace", "cat": "flow", "id": trace_id,
                "ts": ts, "pid": pid, "tid": tid,
                "ph": "s" if i == 0 else ("f" if i == last else "t"),
            }
            if i == last:
                ev["bp"] = "e"  # bind the arrowhead to the enclosing slice
            flows.append(ev)

    events.sort(key=lambda e: e["ts"])
    flows.sort(key=lambda e: e["ts"])
    return {
        "traceEvents": meta + events + flows,
        "displayTimeUnit": "ms",
        "otherData": {
            "run_dir": os.path.abspath(run_dir),
            "trace_files": [rel for rel, _ in per_file],
            "traces": sorted(anchors),
        },
    }


def write(run_dir: str, out_path: str) -> int:
    """Dump :func:`collect`'s merge to ``out_path``; returns the event
    count."""
    obj = collect(run_dir)
    parent = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(parent, exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(obj, fh)
    return len(obj["traceEvents"])
