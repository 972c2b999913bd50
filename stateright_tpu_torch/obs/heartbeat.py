"""Heartbeat protocol: in-band liveness for long device runs.

The port's own copy of ``stateright_tpu/obs/heartbeat.py``. A supervisor
that sees a silent process cannot tell a hung card from a long graph
capture or a long block of replays; this file is the in-band answer. The
engine rewrites it (atomically, via ``os.replace``) around every dispatch:

- **before** a block: ``phase="dispatch"`` plus a ``compile`` flag when
  the block makes a program (on a card: captures a CUDA graph), which
  legitimately takes longer;
- **after** the block's readback: ``phase="idle"``, ``seq`` incremented —
  exactly one increment per completed dispatch (the same unit as one
  ``checker.dispatch_log`` entry).

File content (one JSON object)::

    {"ts": <unix seconds>, "seq": <completed dispatches>,
     "phase": "dispatch" | "idle", "compile": <bool>, ...extra gauges}

A watchdog then reads: *mtime fresh* → alive; *stale in phase="idle"* →
host-side work or a dead process; *stale in phase="dispatch",
compile=true* → probably capturing, extend the leash; *stale in
phase="dispatch", compile=false* → the device is stuck.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class Heartbeat:
    """Writer side of the protocol (one per checker; ``seq`` is local to
    the writer — supervisors track deltas, not absolute values)."""

    __slots__ = ("path", "seq")

    def __init__(self, path: str):
        self.path = path
        self.seq = 0
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)

    def beat(self, phase: str, **info: Any) -> None:
        """Rewrite the file (atomic replace: readers never see a torn
        write; mtime always advances)."""
        payload = {"ts": time.time(), "seq": self.seq, "phase": phase}
        payload.update(info)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(payload, fh, default=str)
        os.replace(tmp, self.path)

    def commit(self, **info: Any) -> None:
        """One completed device dispatch: bump ``seq``, mark idle."""
        self.seq += 1
        self.beat("idle", **info)


def read(path: str) -> Optional[Dict[str, Any]]:
    """Reader side: the parsed heartbeat, or None (missing/torn file —
    torn is impossible from this writer, but the reader stays safe against
    foreign writers)."""
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None


def age_s(path: str) -> Optional[float]:
    """Seconds since the last beat (mtime-based), or None if absent."""
    try:
        return max(0.0, time.time() - os.stat(path).st_mtime)
    except OSError:
        return None
