"""Deterministic fault injection: seeded, scriptable faults at the seams.

Counterpart of ``stateright_tpu/chaos.py``, with the same ``STPU_CHAOS``
grammar, injection points and seeded trigger decisions: one spec drives
the same schedule in either package (``tests/test_torch_chaos_supervise.py``
holds the two plans' decisions equal on seeded sequences). Unset, every
hook is a no-op: :func:`fire` returns ``None`` without allocating a plan,
parsing anything or touching a PRNG.

Spec grammar (semicolon-separated clauses)::

    STPU_CHAOS = "seed=7;journal.torn@n=3:at=17;supervise.wedge@n=1"

    clause  := "seed=" INT                      (PRNG seed; default 0)
             | POINT ["@" TRIGGER] [":" PARAMS]
    TRIGGER := "n=" K      fire on the K-th invocation of POINT (1-based,
                           exactly once; counts are per process)
             | "p=" F      fire each invocation with probability F from
                           the seeded PRNG (same seed -> same schedule)
             | (absent)    fire on every invocation
    PARAMS  := key=val ("," key=val)*           (integers where numeric)

Injection points of the port (each is one hook call in the named owner):

- ``supervise.wedge`` -- ``supervise.run_worker``'s poll loop: a simulated
  wedge verdict, classified as ``WorkerResult.wedged``.
- ``checkpoint.torn`` -- ``checkpoint.save_checkpoint``: after the atomic
  replace, truncate the live file at byte ``at`` (default: a seeded
  offset), the torn rotation ``latest_valid_checkpoint`` falls back from.
- ``journal.torn`` -- the service journal's append: write the first ``at``
  bytes of the record, then SIGKILL the process.
- ``journal.die`` -- append the whole record, then SIGKILL the process.
- ``worker.die`` / ``worker.freeze`` -- consumed by
  ``CheckerService.submit``: the N-th submitted job's worker gets
  ``--chaos-die-at-depth`` / ``--chaos-freeze-at-depth`` (params
  ``depth``, ``once``).
- ``lint.timeout`` -- ``CheckerService._admission_verdict``: the admission
  check's subprocess "times out" (the fail-open path, ``lint_errors``).
- ``tenant.storm`` -- consumed by ``tools/service_chaos.py``'s serve loop:
  on the N-th scheduled submission, burst ``rate`` (default 5) extra
  submissions of one tenant (params ``tenant``, default ``storm``;
  ``class``, default ``best_effort``; ``rate``) through the live service,
  under idempotency keys ``storm-<seed>-<i>`` so a restarted incarnation's
  storm dedupes.
- ``device.lost`` / ``device.flaky`` -- consumed by ``FleetService.submit``
  (``service/fleet.py``). ``device.lost`` (params ``device``, default the
  device just routed to, and ``after_s``, default 1) counts successful
  placements and declares a whole device dead after the delay: its pool's
  workers are killed and its jobs migrate to healthy siblings.
  ``device.flaky`` (params ``depth``, ``once``) counts submission attempts
  and gives the routed job a one-shot heartbeat freeze on its device.

``STPU_CHAOS`` rides process boundaries by plain environment inheritance:
the service exports its config's spec into worker environments, so a
``checkpoint.torn`` clause fires inside the worker that writes the
checkpoints. Everything here is stdlib; importing it imports no torch.
"""

from __future__ import annotations

import os
import random
import signal
import threading
from typing import Any, Dict, Optional

__all__ = ["ChaosPlan", "active", "fire", "install", "plan"]


class ChaosPlan:
    """One parsed ``STPU_CHAOS`` spec: per-point rules + the seeded PRNG
    + per-point invocation counters (thread-safe — the service fires
    hooks from scheduler and per-job threads)."""

    def __init__(self, spec: str):
        self.spec = spec
        self.seed = 0
        #: point -> {"n": int|None, "p": float|None, "params": dict}
        self.rules: Dict[str, Dict[str, Any]] = {}
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            if clause.startswith("seed="):
                self.seed = int(clause[len("seed="):])
                continue
            head, _, raw_params = clause.partition(":")
            point, _, raw_trigger = head.partition("@")
            point = point.strip()
            if not point:
                raise ValueError(f"malformed STPU_CHAOS clause {clause!r}")
            rule: Dict[str, Any] = {"n": None, "p": None, "params": {}}
            if raw_trigger:
                key, eq, val = raw_trigger.partition("=")
                if key == "n" and eq:
                    rule["n"] = int(val)
                elif key == "p" and eq:
                    rule["p"] = float(val)
                else:
                    raise ValueError(
                        f"malformed STPU_CHAOS trigger {raw_trigger!r} "
                        "(expected n=K or p=F)"
                    )
            for kv in filter(None, raw_params.split(",")):
                key, eq, val = kv.partition("=")
                if not eq:
                    raise ValueError(
                        f"malformed STPU_CHAOS param {kv!r} in {clause!r}"
                    )
                try:
                    rule["params"][key.strip()] = int(val)
                except ValueError:
                    rule["params"][key.strip()] = val.strip()
            self.rules[point] = rule
        self._rng = random.Random(self.seed)
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def fire(self, point: str, **ctx: Any) -> Optional[Dict[str, Any]]:
        """One invocation of ``point``: the injection params when the
        plan says fire, else None. ``ctx`` supplies defaults the caller
        knows (``size`` -> a seeded random ``at`` offset for torn
        faults)."""
        rule = self.rules.get(point)
        if rule is None:
            return None
        with self._lock:
            n = self._counts.get(point, 0) + 1
            self._counts[point] = n
            if rule["n"] is not None and n != rule["n"]:
                return None
            if rule["p"] is not None and self._rng.random() >= rule["p"]:
                return None
            out = dict(rule["params"])
            size = ctx.get("size")
            if "at" not in out and isinstance(size, int) and size > 1:
                out["at"] = self._rng.randint(1, size - 1)
        return out


#: The process-wide installed plan. None + resolved means "chaos off":
#: the :func:`fire` fast path returns immediately — no parsing, no PRNG,
#: no allocation.
_PLAN: Optional[ChaosPlan] = None
_RESOLVED = False


def plan() -> Optional[ChaosPlan]:
    """The active plan: an installed one, else ``STPU_CHAOS`` parsed
    lazily once per process, else None."""
    global _PLAN, _RESOLVED
    if not _RESOLVED:
        _RESOLVED = True
        spec = os.environ.get("STPU_CHAOS", "").strip()
        if spec:
            _PLAN = ChaosPlan(spec)
    return _PLAN


def install(spec: Optional[str]) -> Optional[ChaosPlan]:
    """Explicitly install (or, with None, clear) the process-wide plan —
    ``ServiceConfig(chaos=...)``'s path, and the tests'. Re-installing
    the SAME spec keeps the live plan (and its fire counters): a pool's
    constructor must not reset a schedule already in flight. Returns the plan."""
    global _PLAN, _RESOLVED
    if spec and _RESOLVED and _PLAN is not None and _PLAN.spec == spec:
        return _PLAN
    _RESOLVED = True
    _PLAN = ChaosPlan(spec) if spec else None
    return _PLAN


def active() -> bool:
    return plan() is not None


def fire(point: str, **ctx: Any) -> Optional[Dict[str, Any]]:
    """The one hook the seams call. With no plan installed/configured
    this is a dict lookup away from a plain ``return None``."""
    p = _PLAN if _RESOLVED else plan()
    if p is None:
        return None
    return p.fire(point, **ctx)


def kill_self() -> None:  # pragma: no cover - the caller dies
    """The crash simulations' exit: SIGKILL this process (no atexit, no
    flushing — exactly what the watchdogs' designed failure mode does)."""
    os.kill(os.getpid(), signal.SIGKILL)


def tear_file(path: str, at: int) -> None:
    """Truncate ``path`` to ``at`` bytes (clamped inside the file) — the
    torn-write shape for checkpoint/journal fault injection."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return
    os.truncate(path, max(1, min(int(at), size - 1)) if size > 1 else 0)
