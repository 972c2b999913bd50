"""CheckerService: fault-isolated multi-tenant checking on one card.

Counterpart of ``stateright_tpu/service/core.py``: the same
``ServiceConfig`` fields and defaults, counters, admission decisions,
scheduler, journal events and run-dir layout, over the port's workers
(``service/worker.py``), which run ``spawn_xla`` and ``MuxChecker`` on the
H100. One pool serves N concurrent checking jobs:

- **Admission control** -- bounded in-flight jobs and a bounded queue;
  beyond either, :meth:`CheckerService.submit` raises the typed
  :class:`AdmissionError` carrying ``retry_after_s`` (from the measured
  drain rate). Per-job budgets: wall-clock (``max_seconds``, soft-checked
  in the worker, hard-backstopped by the supervisor) and state count
  (``max_states``). QoS: priority classes with weighted fair share, aging,
  EDF within a class, overload shedding lowest class first, tenant quotas.
- **Per-job fault isolation** -- every device job runs ``worker.py`` in
  its own process group under ``supervise.run_worker`` with its own
  heartbeat, span trace and checkpoint rotations under the run dir. A
  wedge verdict (a heartbeat stale mid-dispatch) kills exactly that job's
  group, **quarantines** the job for an exponential backoff and requeues it
  from its newest valid rotation; siblings never see it. Each worker holds
  its own CUDA context: a SIGSTOPped one shares the card by time slicing
  until the verdict kills it, and a killed group's device memory returns
  to the card when its processes exit.
- **Graceful degradation** -- ``breaker_k`` consecutive wedge verdicts trip
  a breaker: new and requeued jobs run the host on-demand engine on the CPU
  with ``degraded: true`` (counted in ``degraded_jobs``). A device job
  otherwise runs on the card or fails: there is no quiet CPU fallback. A
  prober (a subprocess that starts the card and launches one tensor op)
  closes the breaker.
- **Status surface** -- :meth:`gauges`/:meth:`metrics`, per-job and merged
  Chrome traces (``obs/collect.py``); the Explorer is one client
  (``register_interactive``/``release_interactive``).
- **Durability** (``service/journal.py``) -- every batch-job transition
  appends a self-verifying record to ``<run_dir>/journal.jsonl``; a service
  constructed over a run dir with a journal replays it: finished jobs
  restore without re-running, in-flight jobs requeue (the wall-clock spent
  is charged, orphaned workers are killed by journaled pid), the breaker
  and quarantines restore, and ``submit(idempotency_key=...)`` dedupes
  resubmissions across the restart.

The service process never touches the card: importing this module imports
torch (the checkpoint reader's word helpers do) but no module that launches
a kernel (``xla``, ``graphs``, ``ops._cuda``), and a pool that ran only
batch jobs leaves ``torch.cuda.is_initialized()`` False. Only workers, the
admission check and the prober (all subprocesses) start a device.

Differences from the reference, each forced by the port: the admission
flight-check runs the port's own stpu-lint (``tools/stpu_lint.py
--admission SPEC --json``: the spec's packed interface and checker, its
kernels' aten graphs and its capture census); CUDA graphs
live in one process, so no program cache crosses processes and
``compile_cache`` keeps its field and environment export with no other
meaning; compile-on-admit (``warm_compiles``) is a background build of the
kernel libraries (``ops/_cuda.py``); the default probe starts the card.
The fleet (``service/fleet.py``) drives ``breaker_mode="halt"``,
``evacuate``, the breaker listener and ``submit(spent_s=, resume_from=)``.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from .. import chaos as chaos_mod
from .. import supervise as sup
from ..checkpoint import latest_valid_checkpoint
from ..obs import (
    NULL_TRACER,
    Counters,
    export_chrome,
    new_trace_id,
    resolve_tracer,
)
from ..tools import stpu_lint as _stpu_lint
from . import registry
from .journal import Journal, read_journal

#: Pre-seeded pool counters (stable ``metrics()`` key set, like the
#: engines' ENGINE_COUNTERS; docs/service.md).
SERVICE_COUNTERS = (
    "submitted",
    "admitted",
    "rejected",
    "jobs_done",
    "jobs_failed",
    "wedge_verdicts",
    "crashes",
    "requeues",
    "breaker_trips",
    "breaker_closes",
    "degraded_jobs",
    "device_probes",
    "lint_checks",
    "lint_rejects",
    "lint_errors",
    "idem_dedups",
    "jobs_recovered",
    "orphans_killed",
    "artifacts_swept",
    "jobs_evacuated",
    "mux_groups",
    "mux_lanes",
    "mux_dispatches_saved",
    "sheds",
    "quota_rejects",
    "aged_picks",
    "warm_compiles",
)

#: Priority classes, highest first (docs/service.md "QoS & overload").
#: ``interactive`` here is a *batch-job* urgency class (latency-sensitive
#: checking requests), distinct from ``Job.kind == "interactive"`` (live
#: Explorer sessions, which bypass the batch queue entirely).
PRIORITY_CLASSES = ("interactive", "batch", "best_effort")

#: Default fair-share weights: an interactive job earns device slots at
#: 4x a best-effort job's rate, batch at 2x. Override per pool with
#: ``ServiceConfig(class_weights=)``.
DEFAULT_CLASS_WEIGHTS = {"interactive": 4.0, "batch": 2.0, "best_effort": 1.0}

#: Default overload-shedding thresholds: the fraction of ``max_queue``
#: occupancy above which a class is shed at admission. Best-effort sheds
#: at half-full, batch at three-quarters, interactive only at the hard
#: queue cap — graceful degradation drops the least-important work first.
DEFAULT_SHED_THRESHOLDS = {
    "interactive": 1.0,
    "batch": 0.75,
    "best_effort": 0.5,
}

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "worker.py")
#: The admission flight-check entry point (the port's stpu-lint wrapper,
#: run with ``--admission SPEC --json``). A subprocess: the spec resolves
#: (and a user family imports) there, never in the service process.
_LINT = _stpu_lint.__file__
#: Compile-on-admit: a user family's first admission builds the kernel
#: libraries (``ops/_cuda.py`` run as a script) in a background
#: subprocess, so the tenant's first real job does not pay the ``nvcc``
#: inside its budget. The port keeps no program cache across processes
#: (CUDA graphs live in one process), so there is nothing else to warm.
_WARM = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "ops",
    "_cuda.py",
)


def _probe_argv(platform: str) -> List[str]:
    """The default device probe: a fresh process that starts the pool's
    device and launches one tensor op on it (the card, or the CPU for a
    ``platform="cpu"`` pool); rc 0 = healthy."""
    device = "cpu" if platform == "cpu" else "cuda"
    return [
        sys.executable, "-c",
        "import torch; t = torch.ones(8, device=%r); t.add_(1); "
        "assert float(t.sum()) == 16.0" % device,
    ]


class AdmissionError(Exception):
    """Typed admission rejection. ``retry_after_s`` is the back-pressure
    hint (an HTTP front end's ``Retry-After``); None when retrying cannot
    help (a budget above the pool cap)."""

    def __init__(self, reason: str, retry_after_s: Optional[float] = None):
        msg = reason
        if retry_after_s is not None:
            msg += f" (retry after ~{retry_after_s:.0f}s)"
        super().__init__(msg)
        self.reason = reason
        self.retry_after_s = retry_after_s


@dataclass
class ServiceConfig:
    """Pool knobs; everything has a production-shaped default and the chaos
    tests shrink the time constants."""

    run_dir: str = os.path.join("runs", "service")
    # -- admission ---------------------------------------------------------
    max_inflight: int = 2  #: concurrently running batch jobs
    max_queue: int = 8  #: queued + quarantined jobs beyond the running set
    max_sessions: int = 4  #: interactive (Explorer) clients
    default_max_seconds: float = 600.0
    max_seconds_cap: float = 3600.0
    max_states_cap: Optional[int] = None
    block_size: int = 1500  #: host-engine block granularity (on_demand.py)
    # -- supervision (supervise.run_worker) --------------------------------
    stall_s: float = 1200.0
    startup_grace_s: float = 900.0
    poll_s: float = 0.5
    requeue_limit: int = 2  #: wedge/crash requeues per job before it fails
    backoff_s: float = 5.0  #: quarantine backoff base (exponential)
    # -- breaker -----------------------------------------------------------
    breaker_k: int = 3  #: consecutive wedge verdicts that trip it
    probe_auto: bool = True  #: background re-probe while open
    probe_interval_s: float = 60.0
    probe_timeout_s: float = 45.0
    #: Device-liveness probe command (rc 0 = device healthy). The default
    #: pays full plugin init in a throwaway subprocess, exactly like
    #: ``backend.ensure_live_backend``'s probe.
    probe_argv: Optional[Sequence[str]] = None
    # -- admission flight-check (tools/stpu_lint.py --admission) ------------
    #: Check a spec before the pool schedules it on the device -- the gate
    #: user-submitted specs (STPU_FAMILIES) pass through: in a fresh
    #: subprocess the spec must resolve to a packed model that
    #: ``spawn_xla`` accepts, whose kernels pass stpu-lint's rules and whose
    #: capture plan fits its budget. A per-service memo makes repeat
    #: submissions of a shipped spec free.
    admission_lint: bool = True
    lint_timeout_s: float = 240.0
    # -- QoS & overload (docs/service.md "QoS & overload") -----------------
    #: Per-class fair-share weights (class -> weight); keys beyond the
    #: defaults are merged over ``DEFAULT_CLASS_WEIGHTS`` at
    #: construction. A class's share of device slots under contention is
    #: weight / sum(weights of backlogged classes).
    class_weights: Optional[Dict[str, float]] = None
    #: The aging time constant: a queued job's effective priority
    #: ``w_class + waited_s / qos_aging_s`` rises monotonically, and the
    #: job jumps the fair-share queue entirely ("aged") once
    #: ``waited_s >= qos_aging_s * (w_max + 1 - w_class)`` — THE
    #: documented starvation bound (defaults: best_effort 2400 s,
    #: batch 1800 s).
    qos_aging_s: float = 600.0
    #: Per-class shed thresholds (fraction of ``max_queue`` occupancy
    #: above which the class is rejected at admission); merged over
    #: ``DEFAULT_SHED_THRESHOLDS``.
    shed_thresholds: Optional[Dict[str, float]] = None
    #: Per-tenant quotas, enforced at admission (queued) and scheduling
    #: (in-flight): defaults for every tenant, overridable per tenant id
    #: via ``tenant_quotas={"t1": {"max_queued": 2, ...}}``. None = no
    #: limit.
    tenant_max_queued: Optional[int] = None
    tenant_max_inflight: Optional[int] = None
    #: Device-seconds budget per tenant: a submission whose requested
    #: ``max_seconds`` would push the tenant's lifetime charged + asked
    #: wall-clock over this rejects typed (``quota_rejects``).
    tenant_budget_s: Optional[float] = None
    tenant_quotas: Optional[Dict[str, Dict[str, Any]]] = None
    #: Completion-rate window for the measured drain rate behind
    #: ``Retry-After`` hints (docs/service.md "QoS & overload").
    drain_window_s: float = 300.0
    #: Compile-on-admit: on a user family's (STPU_FAMILIES) first
    #: admission, build the kernel libraries in a background subprocess
    #: (counter ``warm_compiles``).
    warm_user_families: bool = True
    # -- workers -----------------------------------------------------------
    platform: str = "default"  #: "default" (accelerator) | "cpu" (tests)
    #: The reference's persistent compile cache directory (default:
    #: <cwd>/.jax_cache), exported to workers as STPU_COMPILE_CACHE. The
    #: port's workers read nothing of it: CUDA graphs live in one process.
    compile_cache: Optional[str] = None
    checkpoint_every: Any = 1  #: per-job auto-checkpoint cadence
    checkpoint_keep: int = 3
    # -- durability (service/journal.py; docs/service.md) ------------------
    #: Append every batch-job transition to <run_dir>/journal.jsonl and
    #: REPLAY it when constructed over a run dir that already has one —
    #: the queue, budgets, breaker, and checkpoint pointers survive a
    #: service kill -9. Off = the pre-durability in-memory pool.
    journal: bool = True
    journal_compact_every: int = 256  #: appends between snapshot compactions
    journal_keep: int = 3  #: journal rotations retained by compaction
    #: Seconds a journal-complete job's run-dir artifacts (heartbeat,
    #: trace, checkpoint rotations, worker stdout) are retained before
    #: the sweep deletes its job dir (gauge: ``artifacts_swept``); None
    #: disables sweeping.
    artifact_retention_s: Optional[float] = 7 * 24 * 3600.0
    # -- fault injection (chaos.py) -----------------------------------------
    #: A chaos spec installed process-wide at construction and exported
    #: to worker environments as STPU_CHAOS — the deterministic fault
    #: layer the chaos/restart drills script (None: inherit env, which
    #: is a no-op when STPU_CHAOS is unset).
    chaos: Optional[str] = None
    # -- fleet membership (service/fleet.py; docs/service.md "Fleet") ------
    #: Device label this pool serves ("dev0"...). Rides every job
    #: snapshot (and so /.pool and the dashboard's per-device rows);
    #: None = the single-device pool's legacy surface.
    device: Optional[str] = None
    #: Device ordinal passed to workers as ``--device`` (worker.py runs
    #: on ``cuda:<ordinal>``); None = the default card.
    device_ordinal: Optional[int] = None
    #: Open-breaker policy. "host" (default, the single-pool contract):
    #: jobs route to the host on-demand engine with ``degraded: true``.
    #: "halt" (fleet pools): queued jobs HOLD while the breaker is open —
    #: the FleetService migrates them to a healthy sibling device instead,
    #: and only jobs force-submitted with ``engine="host"`` run (the
    #: fleet's every-device-open last resort).
    breaker_mode: str = "host"
    #: Optional callable(state) notified (from a fresh thread, never under
    #: the pool lock) when the breaker trips ("open") or closes
    #: ("closed") — the fleet's migration trigger.
    breaker_listener: Optional[Any] = None
    #: TTL for Job.snapshot()'s memoized artifact-mtime ages: a 100-job
    #: /.pool render (or a dashboard polling several endpoints in one
    #: tick) does ONE stat per artifact per tick instead of one per
    #: render.
    snapshot_age_ttl_s: float = 1.0
    # -- batched scheduling (xla_mux.py; the JAX package's docs/service.md
    # -- "Batched scheduling") --------------------------------------------
    #: Multiplex up to K queued same-spec batch jobs into ONE
    #: ``worker.py --mux`` invocation (per-lane journal events, budgets,
    #: checkpoints, and metrics preserved; a mux worker fault requeues
    #: its members individually, solo). 1 = off. None = the ``STPU_MUX``
    #: env knob (default 1). Only families in ``registry.MUX_FAMILIES``
    #: group; everything else keeps the solo path.
    mux_k: Optional[int] = None
    # -- distributed tracing (docs/observability.md) -----------------------
    #: Service-side span trace: ``True`` appends the pool's own spans
    #: (``submit``/``attempt``) to ``<run_dir>/trace.jsonl``, a path
    #: appends there; ``None`` defers to the ``STPU_SERVICE_TRACE`` env
    #: knob ("1" = the run-dir default, else a path; unset = off).
    #: Every submission mints (and journals) a ``trace_id`` regardless —
    #: tracing off only skips the span writes, never the propagation.
    trace: Any = None


class Job:
    """One pool entry. Batch jobs own a job dir (checkpoints, heartbeat,
    trace, worker stdout); interactive jobs wrap a live in-process checker.
    All mutation happens under the service lock."""

    def __init__(
        self,
        service: "CheckerService",
        job_id: str,
        spec: str,
        *,
        kind: str = "batch",
        max_seconds: float = 600.0,
        max_states: Optional[int] = None,
        chaos: Optional[Dict[str, Any]] = None,
        idempotency_key: Optional[str] = None,
        tenant: str = "default",
        priority: str = "batch",
        deadline_s: Optional[float] = None,
        symmetry: Optional[str] = None,
    ):
        self._service = service
        self.id = job_id
        self.spec = spec
        self.kind = kind  #: "batch" | "interactive"
        self.idempotency_key = idempotency_key
        #: QoS identity (docs/service.md "QoS & overload"): the
        #: submitting tenant, the priority class (PRIORITY_CLASSES), and
        #: an optional soft deadline — EDF orders same-class picks by
        #: ``created_unix_ts + deadline_s``. All three ride the journal's
        #: ``submitted`` record so a restart replays scheduler state.
        self.tenant = tenant
        self.priority = priority
        self.deadline_s = deadline_s
        #: Per-job symmetry-reduction mode (docs/symmetry.md): None
        #: inherits the pool's environment (STPU_SYMMETRY), "on"/"off"/
        #: "auto" override it for this job's workers. Journaled on
        #: ``submitted`` so replay and migration keep the mode — a
        #: resumed attempt under a different mode would fail the
        #: checkpoint's symmetry-identity check (checkpoint.py).
        self.symmetry = symmetry
        #: queued|running|quarantined|done|failed|migrated — "migrated" is
        #: terminal FOR THIS POOL: the fleet evacuated the job to a
        #: sibling device (service/fleet.py), which owns it from then on.
        self.status = "queued"
        self.engine = "xla"  #: engine of the current/last attempt
        self.engine_force: Optional[str] = None  #: "host" = fleet last resort
        #: A sibling pool's checkpoint rotation to resume from when this
        #: job has no checkpoint of its own yet (migration seed).
        self.seed_checkpoint: Optional[str] = None
        self.degraded = False  #: served by the host fallback
        self.max_seconds = max_seconds
        self.max_states = max_states
        self.chaos = chaos or {}
        self.attempts: List[Dict[str, Any]] = []
        self.wedges = 0
        self.requeues = 0
        self.consumed_s = 0.0
        self.requeue_at = 0.0  #: monotonic; quarantine release time
        self.resumed_from: Optional[str] = None  #: last attempt's resume
        self.lint: Optional[Dict[str, Any]] = None  #: admission flight-check
        self.result: Optional[Dict[str, Any]] = None
        self.error: Optional[str] = None
        self.created_unix_ts = time.time()
        self.completed_unix_ts: Optional[float] = None
        self.recovered = False  #: restored from a journal replay
        #: The submission's distributed-trace id (docs/observability.md
        #: "Distributed tracing") — minted at submit, journaled, carried
        #: across requeues/restarts/migrations so every attempt's spans
        #: stitch into one trace.
        self.trace_id: Optional[str] = None
        #: The root (submit) span's id — the attempt spans' parent.
        #: None on replayed jobs (their attempts re-root at the trace).
        self._root_sid: Optional[str] = None
        self.swept = False  #: run-dir artifacts removed by the retention sweep
        self.checker = None  #: interactive jobs only
        self.dir: Optional[str] = None
        #: Live/last mux-group membership ({"group", "lanes", "lane"}):
        #: rides snapshot() so /.pool and the dashboard attribute a
        #: member's rates to its lane, never to the whole batch.
        self.mux: Optional[Dict[str, Any]] = None
        #: The group heartbeat path while a mux attempt runs — the
        #: snapshot() liveness readout for members (one heartbeat serves
        #: the whole batch; cleared at settlement so a later solo attempt
        #: reads its own hb.json again).
        self._mux_hb: Optional[str] = None
        #: A failed mux attempt pins its unfinished members solo: the
        #: requeued attempt must not regroup into the same faulty batch.
        self._mux_solo = False
        self._proc = None  #: live worker Popen (close-with-kill path)
        self._attempt_t0: Optional[float] = None  #: monotonic; live attempt
        #: path -> (age, read_at_monotonic): the snapshot() mtime memo
        #: (snapshot_age_ttl_s).
        self._age_cache: Dict[str, Any] = {}

    # -- paths -------------------------------------------------------------

    def _path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    @property
    def checkpoint_path(self) -> str:
        return self._path("ck.npz")

    @property
    def trace_path(self) -> str:
        return self._path("trace.jsonl")

    @property
    def metrics_path(self) -> str:
        return self._path("metrics.jsonl")

    # -- surface -----------------------------------------------------------

    @property
    def done(self) -> bool:
        return self.status in ("done", "failed", "migrated")

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Blocks until the job reaches a terminal state; returns whether
        it did within ``timeout``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._service._cond:
            while not self.done:
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return False
                self._service._cond.wait(timeout=remaining)
        return True

    def _cached_age(self, path: str) -> Optional[float]:
        """``_mtime_age`` behind a ``snapshot_age_ttl_s`` memo: a 100-job
        ``/.pool`` render (or several dashboard endpoints polled in one
        tick) stats each artifact once per tick, not once per render."""
        ttl = self._service._cfg.snapshot_age_ttl_s
        now = time.monotonic()
        hit = self._age_cache.get(path)
        if hit is not None and now - hit[1] < ttl:
            age = hit[0]
            # The cached value drifts within the TTL; advance it so a
            # frozen heartbeat still reads as aging between stats.
            return None if age is None else round(age + (now - hit[1]), 3)
        age = _mtime_age(path)
        self._age_cache[path] = (age, now)
        return age

    def snapshot(self) -> Dict[str, Any]:
        """The per-job status record (pool ``metrics()["jobs"]`` entry)."""
        out = {
            "id": self.id,
            "kind": self.kind,
            "spec": self.spec,
            "status": self.status,
            "engine": self.engine,
            "degraded": self.degraded,
            "tenant": self.tenant,
            "priority": self.priority,
            "deadline_s": self.deadline_s,
            "symmetry": self.symmetry,
            # The device this pool serves (fleet pools; None on the
            # single-device pool) — the dashboard's per-device grouping.
            "device": self._service._cfg.device,
            "wedges": self.wedges,
            "requeues": self.requeues,
            "attempts": len(self.attempts),
            "resumed_from": self.resumed_from,
            "lint": self.lint,
            "error": self.error,
            "recovered": self.recovered,
            "trace_id": self.trace_id,
            # Liveness/recovery ages, host-side from file mtimes (the
            # dashboard's per-job staleness + checkpoint-age readouts;
            # docs/observability.md "Dashboard"): None when the artifact
            # does not exist (host-engine jobs, swept dirs, heartbeat off).
            # Memoized per poll tick (snapshot_age_ttl_s).
            # A mux member's liveness is the GROUP heartbeat (one worker
            # beats for the whole batch) while its attempt runs.
            "heartbeat_age_s": (
                self._cached_age(self._mux_hb or self._path("hb.json"))
                if self.dir
                else None
            ),
            "checkpoint_age_s": (
                self._cached_age(self.checkpoint_path) if self.dir else None
            ),
        }
        if self.mux is not None:
            out["mux"] = self.mux
        if self.result is not None:
            out["result"] = {
                k: self.result.get(k)
                for k in ("generated", "unique", "max_depth", "seconds")
            }
        return out

    def persist(self) -> Dict[str, Any]:
        """The journal-snapshot form: everything a restarted service needs
        to re-adopt this job (``service/journal.py``; paths relative to
        the service run dir so a relocated run dir still replays).
        Caller holds the service lock."""
        run_dir = self._service._cfg.run_dir
        return {
            "spec": self.spec,
            "status": self.status,
            "max_seconds": self.max_seconds,
            "max_states": self.max_states,
            "chaos": self.chaos or None,
            "idempotency_key": self.idempotency_key,
            "dir": (
                os.path.relpath(self.dir, run_dir)
                if self.dir is not None
                else None
            ),
            "engine": self.engine,
            "engine_force": self.engine_force,
            "seed_checkpoint": self.seed_checkpoint,
            "degraded": self.degraded,
            "consumed_s": self.consumed_s,
            "requeues": self.requeues,
            "wedges": self.wedges,
            "error": self.error,
            "result": (
                {
                    k: self.result.get(k)
                    for k in (
                        "generated", "unique", "max_depth", "seconds",
                        "degraded",
                    )
                }
                if self.result is not None
                else None
            ),
            "created_unix_ts": self.created_unix_ts,
            "completed_unix_ts": self.completed_unix_ts,
            "trace_id": self.trace_id,
            "tenant": self.tenant,
            "priority": self.priority,
            "deadline_s": self.deadline_s,
            "symmetry": self.symmetry,
        }

    def metrics(self) -> Optional[Dict[str, Any]]:
        """The per-job engine snapshot: a finished batch job's recorded
        ``metrics()``, or a live poll of an interactive checker."""
        if self.checker is not None:
            return self.checker.metrics()
        if self.result is not None:
            return self.result.get("metrics")
        return None


def _mtime_age(path: str) -> Optional[float]:
    """Seconds since ``path`` was last written, or None when absent."""
    try:
        return round(max(0.0, time.time() - os.stat(path).st_mtime), 3)
    except OSError:
        return None


#: Pool-counter increments implied by each replayed journal event —
#: recovery restores counters from the last snapshot verbatim, then
#: re-applies these for the events after it. Best-effort telemetry
#: (rejections and lint checks are not journaled), never an invariant.
_COUNTER_EFFECTS = {
    "submitted": ("submitted", "admitted"),
    "breaker_tripped": ("breaker_trips",),
    "breaker_closed": ("breaker_closes",),
}


def _replay_state(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold a journal's records into the recoverable pool state: the last
    ``snapshot`` (if any) as the base, every later event applied on top.
    Pure — the unit the torn-tail tests pin without a service."""
    state: Dict[str, Any] = {
        "next_id": 0,
        "breaker": "closed",
        "consecutive_wedges": 0,
        "breaker_opened_unix_ts": None,
        "counters": {},
        "idem": {},
        "jobs": {},
        "order": [],
        "last_ts": 0.0,
        # Fair-share scheduler state (docs/service.md "QoS & overload"):
        # per-class served counts — the stride scheduler's pass values
        # derive as served/weight, so a restart resumes the SAME
        # inter-class rotation instead of resetting every class's credit.
        "qos_served": {},
    }

    def counters_inc(name: str, n: int = 1) -> None:
        state["counters"][name] = state["counters"].get(name, 0) + n

    for rec in records:
        state["last_ts"] = max(state["last_ts"], float(rec.get("ts", 0.0)))
        ev = rec["event"]
        for name in _COUNTER_EFFECTS.get(ev, ()):
            counters_inc(name)
        if ev == "snapshot":
            s = rec["state"]
            state["next_id"] = s.get("next_id", state["next_id"])
            state["breaker"] = s.get("breaker", "closed")
            state["consecutive_wedges"] = s.get("consecutive_wedges", 0)
            state["breaker_opened_unix_ts"] = s.get("breaker_opened_unix_ts")
            state["counters"] = dict(s.get("counters", {}))
            state["idem"] = dict(s.get("idem", {}))
            state["jobs"] = {j: dict(v) for j, v in s.get("jobs", {}).items()}
            state["order"] = [
                j for j in s.get("order", list(state["jobs"]))
                if j in state["jobs"]
            ]
            state["qos_served"] = dict(s.get("qos_served", {}))
            continue
        if ev == "recovered":
            continue
        if ev == "breaker_tripped":
            state["breaker"] = "open"
            state["breaker_opened_unix_ts"] = rec["ts"]
            state["consecutive_wedges"] = rec.get(
                "consecutive", state["consecutive_wedges"]
            )
            continue
        if ev == "breaker_closed":
            state["breaker"] = "closed"
            state["breaker_opened_unix_ts"] = None
            state["consecutive_wedges"] = 0
            continue
        jid = rec.get("job")
        if jid is None:
            continue
        if ev == "submitted":
            job = {
                "spec": rec["spec"],
                "status": "queued",
                "max_seconds": rec.get("max_seconds", 600.0),
                "max_states": rec.get("max_states"),
                "chaos": rec.get("chaos"),
                "idempotency_key": rec.get("idempotency_key"),
                "dir": rec.get("dir"),
                "engine": "xla",
                "engine_force": rec.get("engine_force"),
                "seed_checkpoint": rec.get("seed_checkpoint"),
                "degraded": False,
                # A migrated-in job arrives with wall-clock already spent
                # on its previous device (spent_s rides the journal so a
                # restart keeps charging it).
                "consumed_s": float(rec.get("spent_s") or 0.0),
                "requeues": 0,
                "wedges": 0,
                "error": None,
                "result": None,
                "created_unix_ts": rec["ts"],
                "completed_unix_ts": None,
                "trace_id": rec.get("trace_id"),
                # QoS identity; .get defaults keep pre-QoS journals
                # replaying (every old job reads as a default-tenant
                # batch-class submission, exactly its old behavior).
                "tenant": rec.get("tenant", "default"),
                "priority": rec.get("priority", "batch"),
                "deadline_s": rec.get("deadline_s"),
                "symmetry": rec.get("symmetry"),
            }
            state["jobs"][jid] = job
            state["order"].append(jid)
            if job["idempotency_key"]:
                state["idem"][job["idempotency_key"]] = jid
            try:
                state["next_id"] = max(
                    state["next_id"], int(jid.rsplit("-", 1)[-1])
                )
            except ValueError:
                pass
            continue
        job = state["jobs"].get(jid)
        if job is None:  # an event for a job the torn prefix never admitted
            continue
        if ev == "started":
            if job["status"] == "migrated":
                # The spawn/evacuate race can journal `started` after
                # `evacuated` (the worker spawned in the window between
                # the scheduler's pick and the evacuation sweep): the
                # pool-terminal verdict wins — replay must not resurrect
                # the evacuated job here, the sibling's journal owns it.
                continue
            job["status"] = "running"
            job["started_ts"] = rec["ts"]
            job["pid"] = rec.get("pid")
            # Each start is one fair-share pick: re-derive the stride
            # scheduler's per-class served counts from the events after
            # the last snapshot (the snapshot carries the base).
            cls = job.get("priority", "batch")
            state["qos_served"][cls] = state["qos_served"].get(cls, 0) + 1
            job["engine"] = rec.get("engine", job["engine"])
            job["degraded"] = job["degraded"] or job["engine"] == "host"
            # Older journals only carried the trace id on `submitted`;
            # either event restores it (migration resubmits stamp both).
            job["trace_id"] = rec.get("trace_id", job.get("trace_id"))
        elif ev == "budget_charged":
            job["consumed_s"] = rec.get("consumed_s", job["consumed_s"])
            job["pid"] = None  # the attempt was reaped; no orphan to kill
        elif ev == "quarantined":
            job["status"] = "quarantined"
            job["requeues"] = rec.get("requeues", job["requeues"])
            job["wedges"] = rec.get("wedges", job["wedges"])
            job["pid"] = None
            counters_inc("requeues")
            counters_inc(
                "wedge_verdicts" if rec.get("wedged") else "crashes"
            )
        elif ev == "completed":
            job["status"] = rec["status"]
            job["error"] = rec.get("error")
            job["result"] = rec.get("result", job.get("result"))
            job["completed_unix_ts"] = rec["ts"]
            job["pid"] = None
            counters_inc(
                "jobs_done" if rec["status"] == "done" else "jobs_failed"
            )
        elif ev == "evacuated":
            # The fleet moved this job to a sibling device: terminal for
            # THIS pool — a restart must never requeue it here (the
            # sibling's journal carries the live copy). The event carries
            # the killed attempt's charge: a crash between `evacuated`
            # and the fleet's `migrated` must not refund the budget the
            # straggler repair resubmits with.
            job["status"] = "migrated"
            job["consumed_s"] = float(
                rec.get("consumed_s", job["consumed_s"])
            )
            job["error"] = rec.get("reason")
            job["completed_unix_ts"] = rec["ts"]
            job["pid"] = None
            counters_inc("jobs_evacuated")
        elif ev == "checkpointed":
            job["checkpointed"] = True
    return state


class CheckerService:
    """The device's owner: N concurrent checking jobs behind admission
    control, per-job supervision, and a degradation breaker. Construction
    is cheap (no threads, no dirs) — the scheduler thread starts on the
    first :meth:`submit`, the prober when the breaker opens — UNLESS the
    run dir already holds a job journal, in which case construction
    replays it (docs/service.md "Durability & recovery") and restarts
    whatever the replay says is still due: the scheduler for requeued
    jobs, the prober for a restored-open breaker."""

    def __init__(self, config: Optional[ServiceConfig] = None, **overrides):
        if config is not None and overrides:
            raise TypeError(
                "pass either a ServiceConfig or keyword overrides, not both "
                f"(got config and {sorted(overrides)})"
            )
        self._cfg = config or ServiceConfig(**overrides)
        if self._cfg.compile_cache is None:
            self._cfg.compile_cache = os.path.abspath(".jax_cache")
        # QoS knob normalization (docs/service.md "QoS & overload"):
        # partial dicts merge over the defaults so a pool can reweight
        # one class without restating the rest.
        self._class_weights = dict(
            DEFAULT_CLASS_WEIGHTS, **(self._cfg.class_weights or {})
        )
        self._shed_thresholds = dict(
            DEFAULT_SHED_THRESHOLDS, **(self._cfg.shed_thresholds or {})
        )
        self._w_max = max(self._class_weights.values())
        #: Stride fair-share state: per-class picks served (journaled in
        #: the compaction snapshot, re-derived from `started` events on
        #: replay) and a live-only pass floor that forfeits the credit a
        #: class accrued while it had nothing queued (an idle class must
        #: not bank an unbounded burst against its siblings).
        self._qos_served: Dict[str, int] = {}
        self._qos_floor: Dict[str, float] = {}
        #: Completion timeline for the measured drain rate behind
        #: Retry-After: (unix_ts, priority) per settled batch job,
        #: trimmed to drain_window_s; seeded at replay from restored
        #: jobs' completed_unix_ts.
        self._drain: deque = deque()
        #: Compile-on-admit memo (family -> True): one background kernel
        #: build per user family per service lifetime.
        self._warm_started: Dict[str, bool] = {}
        if self._cfg.mux_k is None:
            try:
                self._cfg.mux_k = max(1, int(os.environ.get("STPU_MUX", "1")))
            except ValueError:
                self._cfg.mux_k = 1
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._jobs: Dict[str, Job] = {}
        self._order: List[str] = []
        self._counters = Counters(SERVICE_COUNTERS)
        self._breaker = "closed"  #: "closed" | "open"
        self._consecutive_wedges = 0
        self._breaker_opened_unix_ts: Optional[float] = None
        self._closed = False
        self._next_id = 0
        #: Per-service admission-lint memo (spec -> verdict): a pool
        #: outlives none of the tree edits that would invalidate it, so
        #: one subprocess per distinct SHIPPED spec per service
        #: lifetime. User-family specs (STPU_FAMILIES) are never
        #: memoized — their source lives outside the tree, and a user
        #: who fixes (or breaks) their model mid-pool must get a fresh
        #: verdict, mirroring the linter's own cache bypass.
        self._lint_memo: Dict[str, Dict[str, Any]] = {}
        #: In-flight lint checks (spec -> Event): concurrent submissions
        #: of the same uncached spec wait for one subprocess instead of
        #: each paying a cold check serially.
        self._lint_inflight: Dict[str, threading.Event] = {}
        self._scheduler: Optional[threading.Thread] = None
        self._prober: Optional[threading.Thread] = None
        self._session_dir: Optional[str] = None
        self.log = lambda msg: None  #: swap in print for a chatty service
        #: idempotency key -> job id (``submit(idempotency_key=...)``
        #: dedupe; survives restarts through the journal).
        self._idem: Dict[str, str] = {}
        self._journal: Optional[Journal] = None
        self._recovery: Optional[Dict[str, Any]] = None
        # Distributed tracing (docs/observability.md "Distributed
        # tracing"): the pool's own span file. NULL_TRACER when off —
        # trace ids still mint/journal/propagate either way.
        trace_cfg = self._cfg.trace
        if trace_cfg is None:
            raw = os.environ.get("STPU_SERVICE_TRACE") or None
            trace_cfg = True if raw == "1" else raw
        if trace_cfg is True:
            trace_cfg = os.path.join(self._cfg.run_dir, "trace.jsonl")
        self._tracer = (
            resolve_tracer(trace_cfg) if trace_cfg else NULL_TRACER
        )
        if self._cfg.chaos:
            # The deterministic fault layer: installed process-wide for
            # the service-side seams (journal writer, run_worker polls)
            # and exported to worker envs in _worker_env.
            chaos_mod.install(self._cfg.chaos)
        if self._cfg.journal:
            self._journal = Journal(
                os.path.join(self._cfg.run_dir, "journal.jsonl"),
                keep=self._cfg.journal_keep,
                compact_every=self._cfg.journal_compact_every,
            )
            if os.path.exists(self._journal.path):
                self._recover()

    # -- lifecycle ---------------------------------------------------------

    def __enter__(self) -> "CheckerService":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def close(self, kill: bool = True, timeout: float = 10.0) -> None:
        """Stops scheduling and the prober; with ``kill`` (default), kills
        any in-flight worker process groups (their jobs read as failed).
        Every non-terminal job reaches a terminal state here — a waiter
        blocked in ``Job.wait()``/``wait_all()`` must wake to a verdict,
        never hang on a queue that will no longer be scheduled."""
        with self._cond:
            self._closed = True
            procs = [
                j._proc
                for j in self._jobs.values()
                if j._proc is not None and j._proc.poll() is None
            ]
            for j in self._jobs.values():
                # Running batch jobs are settled by their _run_job thread
                # (it re-checks _closed under the lock); interactive jobs
                # just end with the pool. These close-time settlements
                # are for in-memory WAITERS only and are never journaled
                # as completed: with durability on, unfinished work stays
                # queued/running in the journal, and the next incarnation
                # over this run dir requeues it.
                if j.status in ("queued", "quarantined"):
                    j.status = "failed"
                    j.error = "service closed"
                    self._counters.inc("jobs_failed")
                elif j.kind == "interactive" and j.status == "running":
                    j.status = "done"
                    self._counters.inc("jobs_done")
            self._cond.notify_all()
        if kill:
            for proc in procs:
                sup._kill_group(proc)
        for t in (self._scheduler, self._prober):
            if t is not None:
                t.join(timeout=timeout)
        if self._journal is not None:
            self._journal.close()

    def _ensure_session_dir(self) -> str:
        if self._session_dir is None:
            d = os.path.join(
                self._cfg.run_dir, f"svc-{int(time.time())}-{os.getpid()}"
            )
            os.makedirs(d, exist_ok=True)
            self._session_dir = d
        return self._session_dir

    def _ensure_scheduler(self) -> None:
        if self._scheduler is None or not self._scheduler.is_alive():
            self._scheduler = threading.Thread(
                target=self._scheduler_loop, name="stpu-service-scheduler",
                daemon=True,
            )
            self._scheduler.start()

    def _start_prober(self, immediate: bool = False) -> None:
        """The background breaker prober; with ``immediate`` (a restart
        that recovered an OPEN breaker) the first probe fires now instead
        of after ``probe_interval_s`` — a restarted pool must not send
        its first job at a possibly-wedged device just because the
        incarnation that observed the wedges died."""
        target = self._probe_loop
        if immediate:
            def target() -> None:  # noqa: F811 - deliberate shadowing
                self.probe_device_now()
                self._probe_loop()
        self._prober = threading.Thread(
            target=target, name="stpu-service-prober", daemon=True,
        )
        self._prober.start()

    # -- durability (service/journal.py) -----------------------------------

    def _jlog(self, event: str, **payload: Any) -> None:
        """Append one journal record (caller holds the lock; no-op with
        journaling off). Compaction rides here: past the cadence the log
        is rewritten as one snapshot of the current state."""
        j = self._journal
        if j is None:
            return
        j.append(event, ts=time.time(), **payload)
        if j.compaction_due:
            j.compact(self._snapshot_payload(), ts=time.time())

    def _snapshot_payload(self) -> Dict[str, Any]:
        """The full recoverable pool state (caller holds the lock):
        the journal compaction's snapshot record, and the base a replay
        folds later events onto. Interactive jobs are deliberately
        absent — a live session cannot survive its process."""
        return {
            "next_id": self._next_id,
            "breaker": self._breaker,
            "consecutive_wedges": self._consecutive_wedges,
            "breaker_opened_unix_ts": self._breaker_opened_unix_ts,
            "counters": self._counters.snapshot(),
            "idem": dict(self._idem),
            "qos_served": dict(self._qos_served),
            "order": [
                jid for jid in self._order
                if self._jobs[jid].kind == "batch"
            ],
            "jobs": {
                jid: self._jobs[jid].persist()
                for jid in self._order
                if self._jobs[jid].kind == "batch"
            },
        }

    def _recover(self) -> None:
        """Replay ``<run_dir>/journal.jsonl`` into a live pool: the
        restart-recovery half of the durability contract (docs/service.md
        "Durability & recovery"). A torn tail is recovered-from, not
        fatal: the torn record is dropped, everything before it replays,
        and the recompaction below amputates the torn bytes so appends
        never land after them."""
        replay = read_journal(self._journal.path)
        state = _replay_state(replay.records)
        now = time.time()
        run_dir = self._cfg.run_dir
        readopted = 0
        requeued = 0
        expired: List[Job] = []
        orphans: List[tuple] = []
        with self._cond:
            self._next_id = max(self._next_id, state["next_id"])
            self._breaker = state["breaker"]
            self._consecutive_wedges = state["consecutive_wedges"]
            self._breaker_opened_unix_ts = state["breaker_opened_unix_ts"]
            self._idem.update(state["idem"])
            for cls, served in state["qos_served"].items():
                self._qos_served[cls] = self._qos_served.get(cls, 0) + served
            for name, value in state["counters"].items():
                # jobs_recovered/orphans_killed are per-INCARNATION (they
                # mirror the recovery provenance dict); restoring them
                # from a previous incarnation's snapshot would double-
                # count across a restart loop. Everything else is
                # lifetime-cumulative.
                if value and name not in ("jobs_recovered", "orphans_killed"):
                    self._counters.inc(name, value)
            for jid in state["order"]:
                rec = state["jobs"][jid]
                job = Job(
                    self,
                    jid,
                    rec["spec"],
                    max_seconds=rec["max_seconds"],
                    max_states=rec.get("max_states"),
                    chaos=rec.get("chaos"),
                    idempotency_key=rec.get("idempotency_key"),
                    tenant=rec.get("tenant", "default"),
                    priority=rec.get("priority", "batch"),
                    deadline_s=rec.get("deadline_s"),
                    symmetry=rec.get("symmetry"),
                )
                job.recovered = True
                job.created_unix_ts = rec.get("created_unix_ts", now)
                job.dir = (
                    os.path.join(run_dir, rec["dir"])
                    if rec.get("dir")
                    else None
                )
                job.engine = rec.get("engine", "xla")
                job.engine_force = rec.get("engine_force")
                job.seed_checkpoint = rec.get("seed_checkpoint")
                job.degraded = bool(rec.get("degraded"))
                job.consumed_s = float(rec.get("consumed_s", 0.0))
                job.requeues = int(rec.get("requeues", 0))
                job.wedges = int(rec.get("wedges", 0))
                job.error = rec.get("error")
                # Trace continuity across restarts: the requeued attempt
                # keeps journaling/propagating the submission's trace id
                # (its spans re-root at the trace — the old root span
                # lives in the previous incarnation's file).
                job.trace_id = rec.get("trace_id")
                status = rec["status"]
                if status in ("done", "failed", "migrated"):
                    # Journal-complete: restore the terminal verdict,
                    # never re-run. The full result (discovery paths
                    # included) reloads from the job dir when the sweep
                    # has not reclaimed it; the journaled summary is the
                    # fallback.
                    job.status = status
                    job.completed_unix_ts = rec.get("completed_unix_ts")
                    job.result = rec.get("result")
                    if (
                        status in ("done", "failed")
                        and job.completed_unix_ts is not None
                        and now - job.completed_unix_ts
                        <= self._cfg.drain_window_s
                    ):
                        # Seed the measured drain rate: completions the
                        # dead incarnation settled inside the window
                        # still count toward Retry-After accuracy.
                        self._drain.append(
                            (job.completed_unix_ts, job.priority)
                        )
                    result_path = (
                        os.path.join(job.dir, "result.json")
                        if job.dir is not None
                        else None
                    )
                    if result_path is not None and os.path.exists(result_path):
                        try:
                            with open(result_path) as fh:
                                job.result = json.load(fh)
                        except (OSError, json.JSONDecodeError):
                            pass
                else:
                    # Queued / quarantined / in-flight: requeue. An
                    # in-flight job charges the wall-clock it had already
                    # spent when the pool died (the journal's last
                    # timestamp bounds "the pool was still alive here")
                    # and its worker — orphaned by the pool's death, both
                    # run in their own sessions — is killed by journaled
                    # pid before the scheduler can double-run the job.
                    if status == "running":
                        started = rec.get("started_ts")
                        if started is not None:
                            job.consumed_s += max(
                                0.0, state["last_ts"] - started
                            )
                        if rec.get("pid"):
                            orphans.append((int(rec["pid"]), job))
                    if job.max_seconds - job.consumed_s <= 0:
                        job.status = "failed"
                        job.error = (
                            "wall-clock budget exhausted "
                            "(spent before the restart)"
                        )
                        job.completed_unix_ts = now
                        self._counters.inc("jobs_failed")
                        expired.append(job)
                    else:
                        job.status = "queued"
                        requeued += 1
                        # Existence, not validity: _run_job_inner's
                        # latest_valid_checkpoint does the (decompress +
                        # digest) verification at spawn time; this is
                        # provenance, cheap under the lock.
                        if job.dir is not None and (
                            os.path.exists(job.checkpoint_path)
                            or os.path.exists(job.checkpoint_path + ".1")
                        ):
                            readopted += 1
                self._jobs[jid] = job
                self._order.append(jid)
                self._counters.inc("jobs_recovered")
            # The replay walks submission order; completions may have
            # settled in any order — the drain window trims from the
            # left, so keep it time-sorted.
            self._drain = deque(sorted(self._drain))
        killed = 0
        for pid, job in orphans:
            if self._kill_orphan(pid, job):
                killed += 1
        self._recovery = {
            "records_replayed": len(replay.records),
            "torn": replay.torn,
            "jobs_recovered": len(state["order"]),
            "jobs_requeued": requeued,
            "jobs_readopted": readopted,
            "jobs_expired": len(expired),
            "orphans_killed": killed,
        }
        with self._cond:
            if killed:
                self._counters.inc("orphans_killed", killed)
            # Recompact: the journal becomes [snapshot, recovered, ...] —
            # bounded growth across restart loops, and a torn tail can
            # never be appended after.
            self._journal.seq = (
                replay.records[-1]["seq"] if replay.records else 0
            )
            # The snapshot already carries the expired jobs settled as
            # failed (status, error, completed_unix_ts, counters) —
            # appending separate `completed` events here would replay ON
            # TOP of it at the next restart and double-count
            # jobs_failed.
            self._journal.compact(self._snapshot_payload(), ts=time.time())
            self._jlog("recovered", **self._recovery)
            self._sweep_artifacts(now)
            runnable = any(
                j.kind == "batch" and not j.done
                for j in self._jobs.values()
            )
            self._cond.notify_all()
        if runnable:
            self._ensure_scheduler()
        if self._breaker == "open" and self._cfg.probe_auto:
            self._start_prober(immediate=True)

    def _kill_orphan(self, pid: int, job: Job) -> bool:
        """Best-effort kill of a worker the dead incarnation left running
        (journaled pid; workers lead their own sessions, so the pool's
        death never took them down). Guarded against pid reuse: only a
        process whose command line still looks like our worker body is
        touched."""
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                cmdline = fh.read().replace(b"\0", b" ").decode(
                    errors="replace"
                )
        except OSError:
            return False  # already gone
        if "worker.py" not in cmdline and "service.worker" not in cmdline:
            return False  # pid reused by something that is not ours
        self.log(f"killing orphaned worker pid {pid} ({job.id})")
        # Straight to SIGKILL: the orphan's incarnation is gone, nothing
        # coordinates a graceful stop, and a SIGSTOP-frozen worker would
        # sit on TERM forever (the same reasoning as _kill_group's last
        # resort). run_worker spawns workers as session leaders, so the
        # pid doubles as the pgid; fall back to the single process if
        # the group is already gone.
        try:
            os.killpg(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            return False
        except OSError:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                return False
        return True

    def _sweep_artifacts(self, now: Optional[float] = None) -> None:
        """Reclaim journal-complete jobs' run-dir artifacts (heartbeat,
        trace, checkpoint rotations, worker stdout) past the retention —
        a long-lived service must not grow ``runs/service/`` without
        bound. Caller holds the lock; gauge: ``artifacts_swept``."""
        retention = self._cfg.artifact_retention_s
        if retention is None:
            return
        now = time.time() if now is None else now
        for job in self._jobs.values():
            if (
                job.kind != "batch"
                or not job.done
                or job.swept
                or job.dir is None
                or job.completed_unix_ts is None
                or now - job.completed_unix_ts < retention
            ):
                continue
            if os.path.isdir(job.dir):
                shutil.rmtree(job.dir, ignore_errors=True)
            job.swept = True
            self._counters.inc("artifacts_swept")
            try:
                # A previous incarnation's session dir, once empty, goes
                # too (rmdir refuses non-empty dirs — live siblings keep
                # theirs).
                os.rmdir(os.path.dirname(job.dir))
            except OSError:
                pass

    # -- admission ---------------------------------------------------------

    def _counts(self) -> Dict[str, int]:
        c = {"queued": 0, "running": 0, "quarantined": 0, "interactive": 0,
             "done": 0, "failed": 0, "migrated": 0}
        for j in self._jobs.values():
            if j.kind == "interactive":
                if j.status == "running":
                    c["interactive"] += 1
                continue
            c[j.status] += 1
        return c

    def _record_drain(self, priority: str) -> None:
        """One settled batch job on the completion timeline (caller holds
        the lock) — the measured drain rate behind ``Retry-After``."""
        now = time.time()
        self._drain.append((now, priority))
        cutoff = now - self._cfg.drain_window_s
        while self._drain and self._drain[0][0] < cutoff:
            self._drain.popleft()

    def _drain_rate(self, priority: Optional[str] = None) -> Optional[float]:
        """Measured completions/second over ``drain_window_s`` (caller
        holds the lock), optionally for one class; None below two
        completions — one settlement is an anecdote, not a rate."""
        now = time.time()
        cutoff = now - self._cfg.drain_window_s
        while self._drain and self._drain[0][0] < cutoff:
            self._drain.popleft()
        ts = [
            t for t, cls in self._drain
            if priority is None or cls == priority
        ]
        if len(ts) < 2:
            return None
        span = max(now - ts[0], 1e-3)
        return len(ts) / span

    def _jobs_ahead(self, priority: Optional[str]) -> int:
        """How many batch jobs the scheduler would serve before (or
        alongside) a NEW submission of ``priority`` — same-or-higher
        class weight among the non-terminal set. Caller holds the
        lock."""
        w = (
            self._class_weights.get(priority, 1.0)
            if priority is not None
            else 0.0
        )
        ahead = 0
        for j in self._jobs.values():
            if j.kind != "batch" or j.done:
                continue
            if (
                priority is None
                or self._class_weights.get(j.priority, 1.0) >= w
            ):
                ahead += 1
        return ahead

    def _retry_after(
        self, counts: Dict[str, int], priority: Optional[str] = None
    ) -> float:
        """The back-pressure estimate an HTTP front end would send as
        ``Retry-After``: jobs ahead of (same-or-higher class than) the
        rejected submission over the MEASURED drain rate — the per-class
        completion timeline when that class has recent settlements, the
        pool-wide rate otherwise. Falls back to the static jobs-ahead /
        slots * default-budget guess only when the window holds fewer
        than two completions (a cold pool has no rate to measure). An
        estimate, not a promise — but monotone in pool pressure, which
        is what a client's retry loop needs."""
        ahead = self._jobs_ahead(priority)
        rate = self._drain_rate(priority) or self._drain_rate()
        if rate is not None:
            # +1: the retrier's own job must drain too.
            return min(
                max(5.0, (ahead + 1) / rate), self._cfg.max_seconds_cap
            )
        per_slot = ahead / max(self._cfg.max_inflight, 1)
        return min(
            max(10.0, per_slot * self._cfg.default_max_seconds * 0.5),
            self._cfg.max_seconds_cap,
        )

    def _tenant_quota(self, tenant: str) -> Dict[str, Any]:
        """The effective quota for one tenant: per-tenant overrides
        merged over the pool-wide defaults; None values = unlimited."""
        quota = {
            "max_queued": self._cfg.tenant_max_queued,
            "max_inflight": self._cfg.tenant_max_inflight,
            "budget_s": self._cfg.tenant_budget_s,
        }
        quota.update((self._cfg.tenant_quotas or {}).get(tenant, {}))
        return quota

    def _tenant_usage(self, tenant: str) -> Dict[str, float]:
        """One tenant's live pool usage (caller holds the lock), derived
        by scanning the job table — no separate books to drift or
        replay: restored jobs ARE the quota state."""
        queued = inflight = 0
        spent = 0.0
        for j in self._jobs.values():
            if j.kind != "batch" or j.tenant != tenant:
                continue
            spent += j.consumed_s
            if j.status in ("queued", "quarantined"):
                queued += 1
            elif j.status == "running":
                inflight += 1
        return {"queued": queued, "inflight": inflight, "spent_s": spent}

    def _quota_rejection(
        self, tenant: str, max_seconds: float
    ) -> Optional[str]:
        """The per-tenant admission verdict (caller holds the lock):
        the rejection reason, or None when the tenant is inside its
        quota. In-flight quota is enforced at SCHEDULING time (the
        fair-share pick skips a saturated tenant), not here — a queued
        job costs nothing until a slot serves it."""
        quota = self._tenant_quota(tenant)
        usage = self._tenant_usage(tenant)
        if (
            quota["max_queued"] is not None
            and usage["queued"] >= quota["max_queued"]
        ):
            return (
                f"tenant {tenant!r} queued quota reached "
                f"({quota['max_queued']})"
            )
        if (
            quota["budget_s"] is not None
            and usage["spent_s"] + max_seconds > quota["budget_s"]
        ):
            return (
                f"tenant {tenant!r} device-seconds budget exceeded "
                f"({usage['spent_s']:.0f}s spent + {max_seconds:.0f}s "
                f"asked > {quota['budget_s']:.0f}s)"
            )
        return None

    def _shed_occupancy_limit(self, priority: str) -> int:
        """The queue occupancy at which ``priority`` sheds: its
        threshold fraction of ``max_queue``, floored at one so a
        threshold never rejects an empty pool."""
        frac = self._shed_thresholds.get(priority, 1.0)
        return max(1, int(round(self._cfg.max_queue * frac)))

    def _budget_rejection(
        self, max_seconds: float, max_states: Optional[int]
    ) -> Optional[str]:
        """The ONE budget/caps validator: the rejection reason, or None
        when the budgets are servable. Shared by submit()'s pre-lint
        precheck and its under-lock authoritative rejection so the two
        can never drift (a drifted precheck would admit an unlinted
        job)."""
        if not 0 < max_seconds <= self._cfg.max_seconds_cap:
            return (
                f"max_seconds {max_seconds:.0f} outside the servable "
                f"range (0, {self._cfg.max_seconds_cap:.0f}]"
            )
        if (
            self._cfg.max_states_cap is not None
            and max_states is not None
            and max_states > self._cfg.max_states_cap
        ):
            return (
                f"max_states {max_states} exceeds the pool cap "
                f"{self._cfg.max_states_cap}"
            )
        return None

    def _admission_verdict(self, spec: str) -> Dict[str, Any]:
        """One spec's admission flight-check verdict (memoized per
        service): ``tools/stpu_lint.py --admission`` run in a
        subprocess. The
        verdict dict rides into ``Job.lint`` (and so the job snapshot
        and ``/.pool``). ``ok`` is tri-state: True/False are the
        linter's word; None means the CHECK failed (timeout, crash,
        unparseable output) — the pool fails OPEN on that (the device
        still has per-job fault isolation behind it) but records it as
        ``lint_errors`` so an operator sees a blind gate."""
        family, _ = registry.parse(spec)
        memoizable = family in registry.FAMILIES  # user families: never
        while True:
            with self._lock:
                memo = self._lint_memo.get(spec) if memoizable else None
                if memo is not None:
                    return dict(memo, cached=True)
                waiter = self._lint_inflight.get(spec)
                if waiter is None:
                    self._lint_inflight[spec] = threading.Event()
                    self._counters.inc("lint_checks")
                    break
            # Another thread is checking this spec: wait for its
            # verdict, then loop to read the memo (or run our own check
            # if it wasn't memoizable / errored).
            waiter.wait(timeout=self._cfg.lint_timeout_s + 30.0)
        argv = [sys.executable, _LINT, "--admission", spec, "--json"]
        verdict: Dict[str, Any]
        try:
            try:
                if chaos_mod.fire("lint.timeout") is not None:
                    # Deterministic fault injection: the admission-lint
                    # subprocess "timing out" — the fail-open tooling-
                    # error path, without waiting out a real timeout.
                    raise subprocess.TimeoutExpired(
                        argv, self._cfg.lint_timeout_s,
                        output="chaos: simulated admission-lint timeout",
                    )
                proc = subprocess.run(
                    argv,
                    timeout=self._cfg.lint_timeout_s,
                    capture_output=True,
                    text=True,
                )
                report = json.loads(proc.stdout)
                verdict = {
                    "ok": bool(report["ok"]),
                    "findings": [
                        {k: f[k] for k in ("rule", "surface", "message")}
                        for f in report["findings"]
                    ],
                    "waived": len(report["waived"]),
                    "errors": report["errors"],
                    "cached": False,
                }
            except (
                subprocess.TimeoutExpired,
                OSError,
                json.JSONDecodeError,
                KeyError,
            ) as e:
                verdict = {
                    "ok": None,
                    "findings": [],
                    "waived": 0,
                    "errors": [
                        f"admission lint failed: {type(e).__name__}: {e}"
                    ],
                    "cached": False,
                }
            with self._lock:
                if verdict["ok"] is None:
                    # A TOOLING failure is not a verdict about the spec:
                    # count it, fail open for THIS submission, but do
                    # NOT memoize — the next submission retries the
                    # check, so one transient timeout can't disable the
                    # gate for a spec for the rest of the service's
                    # life.
                    self._counters.inc("lint_errors")
                elif memoizable:
                    self._lint_memo[spec] = verdict
        finally:
            # Always release waiters, even on an unexpected error — a
            # leaked in-flight entry would spin every later submitter of
            # this spec through wait-timeout loops forever.
            with self._lock:
                waiter = self._lint_inflight.pop(spec, None)
            if waiter is not None:
                waiter.set()
        return verdict

    def _spawn_warm(self, family: str, spec: str) -> None:
        """Fire-and-forget compile-on-admit warmer: one background build
        of the kernel libraries (``ops/_cuda.py build``) per user family
        per service lifetime, logged to ``<run_dir>/warm/<family>.log``.
        Best effort by design -- a failed build costs the tenant only the
        build its first job would have paid anyway. A CPU pool has no
        kernel to build and logs so instead."""
        out_dir = os.path.join(self._cfg.run_dir, "warm")
        argv = [sys.executable, _WARM, "build"]
        try:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"{family}.log"), "ab") as fh:
                if self._cfg.platform == "cpu":
                    fh.write(f"{spec}: no kernel to build on the CPU\n".encode())
                    return
                subprocess.Popen(
                    argv,
                    stdout=fh,
                    stderr=subprocess.STDOUT,
                    start_new_session=True,
                )
        except OSError as e:
            self.log(f"compile-on-admit warm failed to spawn: {e}")

    def submit(
        self,
        spec: str,
        *,
        max_seconds: Optional[float] = None,
        max_states: Optional[int] = None,
        chaos: Optional[Dict[str, Any]] = None,
        idempotency_key: Optional[str] = None,
        engine: str = "auto",
        spent_s: float = 0.0,
        resume_from: Optional[str] = None,
        trace_id: Optional[str] = None,
        tenant: str = "default",
        priority: str = "batch",
        deadline_s: Optional[float] = None,
        symmetry: Optional[str] = None,
    ) -> Job:
        """Queues one batch checking job; returns its :class:`Job` handle
        or raises :class:`AdmissionError` (queue full → carries
        ``retry_after_s``; an over-cap budget → no retry hint, shrink the
        request; an unwaived flight-check finding → no retry hint, fix
        the spec). Unknown/malformed specs raise ``ValueError`` before
        any admission accounting.

        ``idempotency_key`` dedupes client resubmissions — across
        restarts too (the key rides the journal): a key the pool already
        knows returns the EXISTING job (terminal or not; a client that
        wants a genuine re-run picks a new key) with no admission
        accounting beyond the ``idem_dedups`` counter. This is what lets
        a supervisor restart loop blindly resubmit its whole schedule
        after a service crash and converge to exactly-once.

        The fleet-migration knobs (service/fleet.py; docs/service.md
        "Fleet"): ``engine="host"`` forces the host on-demand engine for
        this job regardless of breaker state (the every-device-open last
        resort — it is the only work a ``breaker_mode="halt"`` pool runs
        while open); ``spent_s`` seeds the wall-clock already charged on
        a previous device; ``resume_from`` seeds a sibling pool's
        checkpoint rotation, adopted until this job writes rotations of
        its own.

        ``trace_id`` joins an existing distributed trace (the fleet
        passes its minted id; migration passes the victim's) instead of
        minting a fresh one — docs/observability.md "Distributed
        tracing".

        The QoS identity (docs/service.md "QoS & overload"): ``tenant``
        names the submitter (quota accounting), ``priority`` picks the
        class (:data:`PRIORITY_CLASSES` — weighted fair-share slots,
        overload shedding order), ``deadline_s`` is a soft deadline from
        submission that EDF-orders same-class picks. Under overload a
        lower class sheds FIRST (typed, class-naming
        :class:`AdmissionError` whose ``retry_after_s`` comes from the
        measured per-class drain rate); a tenant over its queued/budget
        quota rejects typed (``quota_rejects``)."""
        if engine not in ("auto", "host"):
            raise ValueError(f"engine must be 'auto' or 'host', got {engine!r}")
        if priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"priority must be one of {PRIORITY_CLASSES}, got {priority!r}"
            )
        if not tenant or not isinstance(tenant, str):
            raise ValueError(f"tenant must be a non-empty string, got {tenant!r}")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got {deadline_s!r}")
        if symmetry is not None and symmetry not in ("auto", "on", "off"):
            raise ValueError(
                f"symmetry must be None/'auto'/'on'/'off', got {symmetry!r}"
            )
        family, _ = registry.parse(spec)  # typed spec validation, pre-admission
        _t0 = time.monotonic()
        with self._lock:
            # Pre-flight closed check: a closed pool must reject
            # immediately (the old contract), not after a cold lint
            # subprocess. The post-lint re-check under the lock still
            # guards the race.
            if self._closed:
                raise RuntimeError("service is closed")
            if idempotency_key is not None:
                known = self._jobs.get(self._idem.get(idempotency_key, ""))
                if known is not None:
                    self._counters.inc("idem_dedups")
                    return known
        max_seconds = (
            self._cfg.default_max_seconds if max_seconds is None else max_seconds
        )
        # Budget validation BEFORE the flight-check (ONE definition —
        # the same validator rejects under the lock below): a request
        # the range checks reject anyway must not pay a cold lint
        # subprocess. Same for a full queue: the precheck is racy (the
        # authoritative check below still holds the lock), but a retry
        # loop against a saturated pool must not keep the host
        # pinned on lint subprocesses for doomed submissions.
        budget_reason = self._budget_rejection(max_seconds, max_states)
        queue_full = False
        if budget_reason is None and self._cfg.admission_lint:
            with self._lock:
                counts = self._counts()
                # The class's SHED limit, not the hard cap: a
                # best-effort submission a half-full pool is about to
                # shed must not pay a cold lint subprocess either.
                queue_full = (
                    counts["queued"] + counts["quarantined"]
                    >= self._shed_occupancy_limit(priority)
                    or self._quota_rejection(tenant, max_seconds) is not None
                )
        # The flight-check runs OUTSIDE the lock (a cold check is a
        # subprocess); scheduling state is only touched afterwards.
        lint = (
            self._admission_verdict(spec)
            if self._cfg.admission_lint
            and budget_reason is None
            and not queue_full
            else None
        )
        with self._cond:
            if self._closed:
                raise RuntimeError("service is closed")
            self._counters.inc("submitted")
            if lint is not None and lint["ok"] is False:
                # A typed rejection with NO retry hint: retrying the
                # same spec cannot help — the finding is in the model's
                # kernels (or its compile plan), not in pool pressure.
                self._counters.inc("rejected")
                self._counters.inc("lint_rejects")
                rules = sorted({f["rule"] for f in lint["findings"]})
                first = lint["findings"][0]["message"] if lint["findings"] else (
                    "; ".join(lint["errors"]) or "flight-check failed"
                )
                raise AdmissionError(
                    f"admission flight-check failed for {spec!r} "
                    f"({', '.join(rules) or 'trace error'}): {first}"
                )
            if budget_reason is not None:
                self._counters.inc("rejected")
                raise AdmissionError(budget_reason)
            quota_reason = self._quota_rejection(tenant, max_seconds)
            if quota_reason is not None:
                self._counters.inc("rejected")
                self._counters.inc("quota_rejects")
                raise AdmissionError(
                    quota_reason,
                    # A queued-quota rejection clears as the tenant's
                    # own jobs drain; a budget quota never does.
                    retry_after_s=(
                        self._retry_after(self._counts(), priority)
                        if "quota reached" in quota_reason
                        else None
                    ),
                )
            counts = self._counts()
            occupancy = counts["queued"] + counts["quarantined"]
            shed_limit = self._shed_occupancy_limit(priority)
            if (
                occupancy >= shed_limit
                # The precheck saw a full/shedding/over-quota pool and
                # skipped the lint; if it drained in the (subprocess-
                # free, microsecond) gap, still reject rather than admit
                # an UNLINTED job — the client's retry gets the real
                # verdict.
                or (queue_full and lint is None and self._cfg.admission_lint)
            ):
                self._counters.inc("rejected")
                hint = self._retry_after(counts, priority)
                if shed_limit < self._cfg.max_queue:
                    # Adaptive overload shedding: this class's threshold
                    # tripped BEFORE the hard cap — the pool is
                    # degrading gracefully, lowest class first.
                    self._counters.inc("sheds")
                    raise AdmissionError(
                        f"overloaded: shedding {priority} submissions "
                        f"({occupancy} waiting >= {shed_limit} "
                        f"= {self._shed_thresholds.get(priority, 1.0):.0%}"
                        f" of {self._cfg.max_queue})",
                        retry_after_s=hint,
                    )
                raise AdmissionError(
                    f"queue full ({self._cfg.max_queue} waiting jobs)",
                    retry_after_s=hint,
                )
            if idempotency_key is not None:
                # Re-check under the final lock: a concurrent submit of
                # the same key between the precheck and here must not
                # admit the job twice.
                known = self._jobs.get(self._idem.get(idempotency_key, ""))
                if known is not None:
                    self._counters.inc("idem_dedups")
                    return known
            self._next_id += 1
            job = Job(
                self,
                f"job-{self._next_id:04d}",
                spec,
                max_seconds=max_seconds,
                max_states=max_states,
                chaos=chaos,
                idempotency_key=idempotency_key,
                tenant=tenant,
                priority=priority,
                deadline_s=deadline_s,
                symmetry=symmetry,
            )
            job.lint = lint
            job.engine_force = "host" if engine == "host" else None
            job.consumed_s = max(0.0, float(spent_s))
            job.seed_checkpoint = resume_from
            # Trace ids mint UNCONDITIONALLY (journaled, surfaced in
            # /.pool) — only span WRITES are gated on the tracer.
            job.trace_id = trace_id or new_trace_id()
            job.dir = os.path.join(self._ensure_session_dir(), job.id)
            os.makedirs(job.dir, exist_ok=True)
            if job.chaos.get("marker") is True:
                # The "arm exactly-once" sentinel for caller-supplied
                # chaos dicts (the fleet's device.flaky): resolved to a
                # per-job marker path now that the job dir exists.
                job.chaos["marker"] = os.path.join(job.dir, "chaos.marker")
            # Pool-level chaos plan -> job-level worker sabotage: the
            # N-th submitted job (the plan's @n trigger counts submits)
            # gets the matching worker flag. `once` (default) arms the
            # exactly-once marker so the requeued attempt runs clean.
            for point, key in (
                ("worker.die", "die_at_depth"),
                ("worker.freeze", "freeze_at_depth"),
            ):
                inj = chaos_mod.fire(point)
                if inj is not None:
                    job.chaos.setdefault(key, int(inj.get("depth", 3)))
                    if inj.get("once", 1):
                        job.chaos.setdefault(
                            "marker", os.path.join(job.dir, "chaos.marker")
                        )
            if idempotency_key is not None:
                self._idem[idempotency_key] = job.id
            self._jobs[job.id] = job
            self._order.append(job.id)
            self._counters.inc("admitted")
            self._jlog(
                "submitted",
                job=job.id,
                spec=spec,
                max_seconds=max_seconds,
                max_states=max_states,
                chaos=job.chaos or None,
                idempotency_key=idempotency_key,
                dir=os.path.relpath(job.dir, self._cfg.run_dir),
                engine_force=job.engine_force,
                spent_s=job.consumed_s or None,
                seed_checkpoint=job.seed_checkpoint,
                trace_id=job.trace_id,
                tenant=tenant,
                priority=priority,
                deadline_s=deadline_s,
                symmetry=symmetry,
            )
            self._jlog(
                "admitted",
                job=job.id,
                lint_ok=None if lint is None else lint["ok"],
            )
            # Compile-on-admit: a user family's (STPU_FAMILIES) first
            # admission builds the kernel libraries in a background
            # subprocess -- the new tenant's first real job does not pay
            # the nvcc inside its wall-clock budget.
            warm_family = None
            if (
                self._cfg.warm_user_families
                and family not in registry.FAMILIES
                and not self._warm_started.get(family)
            ):
                self._warm_started[family] = True
                self._counters.inc("warm_compiles")
                warm_family = family
            self._ensure_scheduler()
            self._cond.notify_all()
        if warm_family is not None:
            self._spawn_warm(warm_family, spec)
        if self._tracer.enabled:
            # Root span of the submission's trace — the attempt spans'
            # parent. Emitted outside the lock (one appended JSONL
            # line); the id is what run_worker exports downstream.
            job._root_sid = self._tracer.emit(
                "submit",
                t0=_t0,
                dur=time.monotonic() - _t0,
                attrs={"job": job.id, "spec": spec},
                trace_id=job.trace_id,
            )
        return job

    def check_session_capacity(self) -> None:
        """Raises :class:`AdmissionError` when the interactive-session cap
        is already reached. Callers building EXPENSIVE checkers (the
        Explorer's device backend allocates device-resident buffers) call
        this *before* construction so a rejected tenant never pays — the
        small pre-check-to-register window is benign (register still
        enforces the cap). A rejection here counts as submitted+rejected —
        capacity-rejected sessions must be visible in the pool telemetry,
        and ``submitted == admitted + rejected`` stays reconcilable (a
        passing pre-check counts nothing; registration does)."""
        with self._lock:
            counts = self._counts()
            if counts["interactive"] >= self._cfg.max_sessions:
                self._counters.inc("submitted")
                self._counters.inc("rejected")
                raise AdmissionError(
                    f"interactive sessions full ({self._cfg.max_sessions})",
                    retry_after_s=self._retry_after(counts),
                )

    def register_interactive(self, checker, *, label: Optional[str] = None,
                             degraded: bool = False) -> Job:
        """Admits a live in-process checker (the Explorer's) as a pool job
        of kind ``"interactive"`` — counted, capped (``max_sessions``),
        and visible in the pool gauges like any other tenant."""
        with self._cond:
            if self._closed:
                raise RuntimeError("service is closed")
            self._counters.inc("submitted")
            counts = self._counts()
            if counts["interactive"] >= self._cfg.max_sessions:
                self._counters.inc("rejected")
                raise AdmissionError(
                    f"interactive sessions full ({self._cfg.max_sessions})",
                    retry_after_s=self._retry_after(counts),
                )
            self._next_id += 1
            job = Job(
                self,
                f"job-{self._next_id:04d}",
                label or type(checker.model()).__name__,
                kind="interactive",
            )
            job.status = "running"
            job.engine = "host" if degraded else "xla"
            job.degraded = degraded
            job.checker = checker
            if degraded:
                self._counters.inc("degraded_jobs")
            self._jobs[job.id] = job
            self._order.append(job.id)
            self._counters.inc("admitted")
            self._cond.notify_all()
        checker.attach_job(job.id)
        return job

    def release_interactive(self, job: Job) -> None:
        with self._cond:
            if job.status == "running":
                job.status = "done"
                self._counters.inc("jobs_done")
            self._cond.notify_all()

    # -- scheduling --------------------------------------------------------

    def _scheduler_loop(self) -> None:
        while True:
            to_start: List[Job] = []
            with self._cond:
                if self._closed:
                    return
                now = time.monotonic()
                counts = self._counts()
                slots = self._cfg.max_inflight - counts["running"]
                quarantine_release = None
                # Halt mode (fleet pools): while the breaker is open,
                # queued jobs HOLD for the fleet to migrate them — only
                # forced-host work (the all-devices-open last resort)
                # runs. The breaker close notifies, re-waking this loop.
                halted = (
                    self._cfg.breaker_mode == "halt"
                    and self._breaker == "open"
                )
                if slots > 0:
                    eligible: List[Job] = []
                    for jid in self._order:
                        job = self._jobs[jid]
                        if job.kind != "batch":
                            continue
                        if halted and job.engine_force != "host":
                            continue
                        if job.status == "quarantined" and job.requeue_at > now:
                            quarantine_release = (
                                job.requeue_at
                                if quarantine_release is None
                                else min(quarantine_release, job.requeue_at)
                            )
                            continue
                        if job.status in ("queued", "quarantined"):
                            eligible.append(job)
                    # The QoS pick (docs/service.md "QoS & overload")
                    # replaces the old FIFO scan: weighted fair share
                    # across classes, EDF within a class, aging as the
                    # starvation backstop, tenant in-flight quotas.
                    for job in self._qos_pick(eligible, slots):
                        job.status = "running"
                        to_start.append(job)
                if not to_start:
                    # Event-driven idle: submit/requeue/close all notify.
                    # A timed wait is only needed to release a quarantine
                    # backoff (or re-poll a full pool) — an idle pool
                    # sleeps on the condition instead of polling at 5 Hz
                    # on this one-core box.
                    if quarantine_release is not None:
                        self._cond.wait(
                            timeout=max(quarantine_release - now, 0.05)
                        )
                    else:
                        # Idle or full pool: every relevant transition
                        # (submit, requeue, job settlement, close)
                        # notifies, so an untimed wait suffices.
                        self._cond.wait()
                groups = self._mux_partition(to_start)
            for unit in groups:
                if len(unit) == 1:
                    threading.Thread(
                        target=self._run_job, args=(unit[0],),
                        name=f"stpu-service-{unit[0].id}", daemon=True,
                    ).start()
                else:
                    threading.Thread(
                        target=self._run_mux_group, args=(unit,),
                        name=f"stpu-service-mux-{unit[0].id}", daemon=True,
                    ).start()

    def _edf_deadline(self, job: Job) -> float:
        """EDF sort key: the absolute soft deadline (submission time +
        ``deadline_s``); no deadline sorts last within the class."""
        if job.deadline_s is None:
            return float("inf")
        return job.created_unix_ts + job.deadline_s

    def _aged(self, job: Job, now_unix: float) -> bool:
        """The starvation backstop (docs/service.md "QoS & overload"): a
        queued job's effective priority ``w_class + waited_s /
        qos_aging_s`` rises monotonically; once it clears ``w_max + 1``
        — i.e. ``waited_s >= qos_aging_s * (w_max + 1 - w_class)`` —
        the job jumps the fair-share rotation entirely. That product is
        THE documented worst-case wait before any admitted job is
        scheduled ahead of every un-aged sibling (defaults: best_effort
        2400 s, batch 1800 s, interactive 600 s)."""
        w = self._class_weights.get(job.priority, 1.0)
        bound = self._cfg.qos_aging_s * (self._w_max + 1.0 - w)
        return now_unix - job.created_unix_ts >= bound

    def _qos_pick(self, eligible: List[Job], slots: int) -> List[Job]:
        """The scheduling-round pick (caller holds the lock): up to
        ``slots`` jobs from ``eligible`` (submission-ordered runnable
        batch jobs), chosen by

        1. **tenant in-flight quota** — a tenant at its ``max_inflight``
           is skipped this round (its jobs stay queued, costing nothing);
        2. **aging** — any job past its aged bound (:meth:`_aged`) is
           picked first, oldest first (counter ``aged_picks``): EDF
           churn or a heavier sibling class can never starve an
           admitted job beyond the documented bound;
        3. **weighted fair share** — stride scheduling across classes:
           the class with the lowest pass (``served / weight``) among
           those with runnable jobs wins the slot, so under sustained
           contention class c receives ``w_c / Σ w`` of the slots. A
           class with nothing runnable forfeits the credit it would
           accrue while idle (its pass floor ratchets to the active
           minimum) — returning traffic resumes at fair share instead
           of bursting on banked credit;
        4. **EDF within the class** — earliest absolute deadline first,
           deadline-less jobs last, FIFO as the tiebreak."""
        picks: List[Job] = []
        if not eligible or slots <= 0:
            return picks
        inflight: Dict[str, int] = {}
        for j in self._jobs.values():
            if j.kind == "batch" and j.status == "running":
                inflight[j.tenant] = inflight.get(j.tenant, 0) + 1
        fifo = {id(job): i for i, job in enumerate(eligible)}
        now_unix = time.time()
        remaining = list(eligible)
        while len(picks) < slots and remaining:
            candidates = []
            for job in remaining:
                cap = self._tenant_quota(job.tenant)["max_inflight"]
                if cap is not None and inflight.get(job.tenant, 0) >= cap:
                    continue
                candidates.append(job)
            if not candidates:
                break
            aged = [j for j in candidates if self._aged(j, now_unix)]
            if aged:
                job = min(
                    aged,
                    key=lambda j: (j.created_unix_ts, fifo[id(j)]),
                )
                self._counters.inc("aged_picks")
            else:
                by_class: Dict[str, List[Job]] = {}
                for j in candidates:
                    by_class.setdefault(j.priority, []).append(j)

                def eff_pass(cls: str) -> float:
                    w = self._class_weights.get(cls, 1.0)
                    return max(
                        self._qos_served.get(cls, 0) / w,
                        self._qos_floor.get(cls, 0.0),
                    )

                min_active = min(eff_pass(c) for c in by_class)
                for cls in self._class_weights:
                    if cls not in by_class:
                        self._qos_floor[cls] = max(
                            self._qos_floor.get(cls, 0.0), min_active
                        )
                cls = min(
                    by_class,
                    key=lambda c: (
                        eff_pass(c), -self._class_weights.get(c, 1.0)
                    ),
                )
                job = min(
                    by_class[cls],
                    key=lambda j: (
                        self._edf_deadline(j),
                        j.created_unix_ts,
                        fifo[id(j)],
                    ),
                )
            self._qos_served[job.priority] = (
                self._qos_served.get(job.priority, 0) + 1
            )
            inflight[job.tenant] = inflight.get(job.tenant, 0) + 1
            picks.append(job)
            remaining.remove(job)
        return picks

    def _mux_partition(self, to_start: List[Job]) -> List[List[Job]]:
        """Partition a scheduling round's picks into mux groups (same
        spec, up to ``mux_k`` lanes) and solo singletons. Caller holds
        the lock (the eligibility checks read breaker state).

        Grouping rules (docs/service.md "Batched scheduling"): the
        batching is opt-in (``mux_k > 1``), device-path only (an open
        breaker's host fallback stays solo), spec families must be
        statically mux-eligible (``registry.MUX_FAMILIES`` — shipped
        families only; the worker still verifies at resolve time and
        falls back to sequential drive on a typed ``MuxError``), and a
        member whose previous mux attempt faulted retries solo
        (``_mux_solo``). Migration seeds (``seed_checkpoint``) stay solo
        too: a migrated-in job's adopted rotation can arrive at grown
        capacities the fresh sibling lanes don't share. Groups form
        WITHIN a priority class and symmetry mode ((spec, priority,
        symmetry) key — lanes must agree on the canonicalization tag,
        xla_mux._check_lanes): the group budget
        is the tightest member's, and batching across classes would let
        a best-effort lane ride — and clip — an interactive dispatch's
        budget (docs/service.md "QoS & overload")."""
        if self._cfg.mux_k <= 1 or self._breaker != "closed":
            return [[job] for job in to_start]

        def eligible(job: Job) -> bool:
            if job.engine_force is not None or job.seed_checkpoint:
                return False
            if job._mux_solo:
                return False
            try:
                family = registry.parse(job.spec)[0]
            except ValueError:  # pragma: no cover - admission validated
                return False
            return family in registry.MUX_FAMILIES

        groups: List[List[Job]] = []
        by_spec: Dict[Any, List[Job]] = {}
        for job in to_start:
            if eligible(job):
                by_spec.setdefault(
                    (job.spec, job.priority, job.symmetry), []
                ).append(job)
            else:
                groups.append([job])
        for members in by_spec.values():
            for at in range(0, len(members), self._cfg.mux_k):
                groups.append(members[at:at + self._cfg.mux_k])
        return groups

    def _worker_env(self, job: Job, device: bool) -> Dict[str, str]:
        env = dict(os.environ)
        # Scrub inherited run-trace/recovery env: per-job artifacts must
        # never alias an outer run's files.
        for key in (
            "STPU_TRACE", "STPU_TRACE_CHROME", "STPU_TRACE_CTX",
            "STPU_HEARTBEAT",
            "STPU_CHECKPOINT_TO", "STPU_CHECKPOINT_EVERY",
            "STPU_CHECKPOINT_KEEP", "STPU_METRICS_TO",
            "STPU_METRICS_EVERY", "STPU_METRICS_KEEP",
        ):
            env.pop(key, None)
        if device:
            env["STPU_TRACE"] = job.trace_path
        if job.symmetry is not None:
            # The per-job mode beats the pool's inherited STPU_SYMMETRY
            # (None inherits — symmetry is a plain env knob otherwise).
            env["STPU_SYMMETRY"] = job.symmetry
        env["STPU_COMPILE_CACHE"] = self._cfg.compile_cache
        if self._cfg.chaos:
            # The config's chaos plan rides into every worker (each
            # process replays its own deterministic schedule); a plain
            # env STPU_CHAOS inherits anyway, like any other knob.
            env["STPU_CHAOS"] = self._cfg.chaos
        return env

    def _run_job(self, job: Job) -> None:
        """One supervised attempt of ``job``; classification + requeue
        decisions happen under the lock afterwards. Any unexpected
        exception settles the job as failed — a job stuck in "running"
        with no thread behind it would consume a ``max_inflight`` slot
        forever and hang its waiters."""
        try:
            self._run_job_inner(job)
        except Exception as e:  # noqa: BLE001 - the verdict IS the handling
            with self._cond:
                job._proc = None
                if job.status == "migrated":  # the fleet owns it now
                    self._cond.notify_all()
                    return
                job.status = "failed"
                job.error = f"supervisor error: {type(e).__name__}: {e}"
                job.completed_unix_ts = time.time()
                self._counters.inc("jobs_failed")
                self._record_drain(job.priority)
                self._jlog(
                    "completed", job=job.id, status="failed",
                    error=job.error, result=None,
                )
                self._cond.notify_all()

    def _run_job_inner(self, job: Job) -> None:
        cfg = self._cfg
        with self._cond:
            if job.status == "migrated":
                # Evacuated between the scheduler's pick and this
                # attempt: the sibling pool owns the job now — spawning
                # a worker here would run the condemned device anyway
                # (and settle/charge a job this pool no longer owns).
                self._cond.notify_all()
                return
        attempt = len(job.attempts)
        device = self._breaker == "closed" and job.engine_force != "host"
        if (
            not device
            and job.engine_force != "host"
            and cfg.breaker_mode == "halt"
        ):
            # Halt-mode race guard: the breaker tripped between the
            # scheduler's pick and here. Re-queue for the fleet to
            # migrate instead of silently degrading to the host engine.
            with self._cond:
                if job.status == "running":
                    job.status = "queued"
                self._cond.notify_all()
            return
        engine = "xla" if device else "host"
        remaining = job.max_seconds - job.consumed_s
        if remaining <= 0:
            with self._cond:
                job.status = "failed"
                job.error = "wall-clock budget exhausted"
                job.completed_unix_ts = time.time()
                self._counters.inc("jobs_failed")
                self._record_drain(job.priority)
                self._jlog(
                    "completed", job=job.id, status="failed",
                    error=job.error, result=None,
                )
                self._cond.notify_all()
            return
        resume = (
            latest_valid_checkpoint(job.checkpoint_path) if device else None
        )
        if resume is None and device and job.seed_checkpoint:
            # Migration seed: no rotation of our own yet — adopt (and
            # re-verify) the sibling pool's rotation the fleet handed us.
            resume = latest_valid_checkpoint(job.seed_checkpoint)
        argv = [
            sys.executable, _WORKER,
            "--spec", job.spec,
            "--engine", engine,
            "--platform", cfg.platform if device else "cpu",
            "--out", job._path("result.json"),
            "--block-size", str(cfg.block_size),
            "--max-seconds", str(remaining),
        ]
        if device:
            argv += [
                "--checkpoint", job.checkpoint_path,
                "--every", str(cfg.checkpoint_every),
                "--keep", str(cfg.checkpoint_keep),
                "--metrics", job.metrics_path,
            ]
            if cfg.device_ordinal is not None:
                argv += ["--device", str(cfg.device_ordinal)]
            if resume:
                argv += ["--resume", resume]
        if job.max_states:
            argv += ["--max-states", str(job.max_states)]
        for flag, key in (
            ("--chaos-die-at-depth", "die_at_depth"),
            ("--chaos-freeze-at-depth", "freeze_at_depth"),
            ("--chaos-marker", "marker"),
        ):
            if job.chaos.get(key) is not None:
                argv += [flag, str(job.chaos[key])]

        def on_spawn(proc):
            # close() snapshots live procs under the lock; a worker that
            # spawns in the close race is killed HERE instead of running
            # unsupervised for its whole budget after the pool is gone.
            # The journaled pid is the restart-recovery orphan handle: a
            # pool killed -9 here leaves this worker running (its own
            # session), and the next incarnation kills it by this record
            # before re-scheduling the job.
            with self._cond:
                job._proc = proc
                closed = self._closed
                migrated = job.status == "migrated"
                if not migrated:
                    # An evacuated job must not append `started` after
                    # its `evacuated` record: replay would read the
                    # journal-ordering race as a live attempt.
                    self._jlog(
                        "started", job=job.id, attempt=attempt,
                        engine=engine, resumed_from=resume, pid=proc.pid,
                        trace_id=job.trace_id,
                    )
            if closed or migrated:
                sup._kill_group(proc)

        with self._cond:
            if self._closed:
                job.status = "failed"
                job.error = "service closed"
                self._counters.inc("jobs_failed")
                self._cond.notify_all()
                return
            if job.status == "migrated":
                # Evacuate raced us between the top-of-attempt check and
                # here: the sibling owns the job — don't spawn.
                self._cond.notify_all()
                return
            job.engine = engine
            job.resumed_from = resume
            job._attempt_t0 = time.monotonic()
            if not device:
                job.degraded = True
        self.log(f"{job.id} attempt {attempt} engine={engine} resume={resume}")
        res = sup.run_worker(
            argv,
            heartbeat=job._path("hb.json") if device else None,
            # Verdict ordering contract: the worker's soft budget exit
            # (rc 3) fires first; a wedge that starts ANY time inside the
            # budget draws its heartbeat-staleness verdict (<= stall_s x
            # the 3x compile leash after onset) before the hard timeout,
            # which only backstops a worker that can neither reach a
            # quiescent point nor be diagnosed by heartbeat. Without the
            # stall headroom here, a production-default pool (600s budget,
            # 1200s stall) would misread every wedge as budget exhaustion
            # — no requeue, no breaker evidence.
            timeout_s=remaining * 1.5 + 60.0 + cfg.stall_s * 3.0,
            stall_s=cfg.stall_s,
            startup_grace_s=cfg.startup_grace_s,
            poll_s=cfg.poll_s,
            env=self._worker_env(job, device),
            stdout_path=job._path(f"worker{attempt}.out"),
            log=self.log,
            on_spawn=on_spawn,
            tracer=self._tracer,
            trace_ctx=(job.trace_id, job._root_sid) if job.trace_id else None,
            trace_attrs={"job": job.id, "attempt": attempt, "engine": engine},
        )
        result = None
        if res.ok:
            try:
                with open(job._path("result.json")) as fh:
                    result = json.load(fh)
            except (OSError, json.JSONDecodeError):
                result = None
        with self._cond:
            job._proc = None
            job._attempt_t0 = None
            if job.status == "migrated":
                # The fleet evacuated this job while its worker ran (and
                # killed the worker group): the sibling pool owns it now —
                # no settlement, no budget charge (evacuate() already
                # captured the live attempt's wall-clock), no requeue.
                self._cond.notify_all()
                return
            # Wedge time is the DEVICE's fault, not the tenant's demand:
            # charging it would make the requeued attempt start with a
            # drained budget and fail as "budget exhausted" instead of
            # resuming. Crashes still charge — the compute was real and
            # checkpointed.
            if not res.wedged:
                job.consumed_s += res.seconds
            job.attempts.append(
                {
                    "rc": res.rc,
                    "killed": res.killed,
                    "seconds": res.seconds,
                    "engine": engine,
                    "wedged": res.wedged,
                    "resumed_from": resume,
                }
            )
            self._jlog(
                "budget_charged", job=job.id, seconds=res.seconds,
                consumed_s=job.consumed_s, charged=not res.wedged,
            )
            if self._closed:
                # Settles the in-memory waiters only — deliberately NOT
                # journaled as completed: a durable pool's unfinished
                # work stays queued in the journal for the next
                # incarnation (docs/service.md "Durability & recovery").
                job.status = "failed"
                job.error = "service closed"
                self._counters.inc("jobs_failed")
                self._cond.notify_all()
                return
            if result is not None:
                job.status = "done"
                job.result = result
                job.completed_unix_ts = time.time()
                if result.get("degraded"):
                    job.degraded = True
                    self._counters.inc("degraded_jobs")
                self._counters.inc("jobs_done")
                self._record_drain(job.priority)
                if device:
                    self._consecutive_wedges = 0
                self._jlog(
                    "completed", job=job.id, status="done", error=None,
                    result=job.persist()["result"],
                )
                self._sweep_artifacts()
            elif res.wedged:
                self._counters.inc("wedge_verdicts")
                job.wedges += 1
                self._record_wedge()
                self._requeue_or_fail(
                    job, f"wedge verdict: {res.killed}", wedged=True
                )
            elif res.crashed:
                self._counters.inc("crashes")
                self._requeue_or_fail(
                    job, f"worker died by signal (rc={res.rc})", wedged=False
                )
            elif res.killed is not None or res.rc == 3:
                job.status = "failed"
                job.error = "wall-clock budget exhausted"
                job.completed_unix_ts = time.time()
                self._counters.inc("jobs_failed")
                self._record_drain(job.priority)
                self._jlog(
                    "completed", job=job.id, status="failed",
                    error=job.error, result=None,
                )
            else:
                job.status = "failed"
                job.error = f"worker exited rc={res.rc}"
                job.completed_unix_ts = time.time()
                self._counters.inc("jobs_failed")
                self._record_drain(job.priority)
                self._jlog(
                    "completed", job=job.id, status="failed",
                    error=job.error, result=None,
                )
            self._cond.notify_all()

    def _run_mux_group(self, jobs: List[Job]) -> None:
        """One supervised multiplexed attempt of ``jobs`` (same spec,
        one ``worker.py --mux`` process; docs/service.md "Batched
        scheduling"). Mirrors :meth:`_run_job`'s crash contract: any
        unexpected supervisor exception settles every still-owned member
        as failed rather than leaking ``max_inflight`` slots."""
        try:
            self._run_mux_group_inner(jobs)
        except Exception as e:  # noqa: BLE001 - the verdict IS the handling
            with self._cond:
                for job in jobs:
                    job._proc = None
                    job._mux_hb = None
                    if job.status != "running":
                        continue
                    job.status = "failed"
                    job.error = f"supervisor error: {type(e).__name__}: {e}"
                    job.completed_unix_ts = time.time()
                    self._counters.inc("jobs_failed")
                    self._record_drain(job.priority)
                    self._jlog(
                        "completed", job=job.id, status="failed",
                        error=job.error, result=None,
                    )
                self._cond.notify_all()

    def _run_mux_group_inner(self, jobs: List[Job]) -> None:
        cfg = self._cfg
        lead = jobs[0]
        spec = lead.spec
        attempts = {job.id: len(job.attempts) for job in jobs}
        gid = f"mux-{lead.id}-a{attempts[lead.id]}"

        def requeue_solo(members: List[Job]) -> None:
            # Back to the queue WITHOUT burning a requeue: these members
            # did nothing wrong — the batch (breaker race, a sibling's
            # exhausted budget) did. The journal needs no extra event: a
            # `started` with no terminal already replays as requeue.
            for job in members:
                if job.status == "running":
                    job.status = "queued"
                    job._mux_solo = True

        with self._cond:
            jobs = [j for j in jobs if j.status == "running"]
            if not jobs:
                self._cond.notify_all()
                return
        device = self._breaker == "closed"
        if not device:
            # The breaker tripped between the scheduler's pick and here:
            # batching is a device-path optimization — hand the members
            # back for the solo path's host-fallback/halt semantics.
            with self._cond:
                requeue_solo(jobs)
                self._cond.notify_all()
            return
        live: List[Job] = []
        with self._cond:
            for job in jobs:
                if job.status != "running":
                    continue
                if job.max_seconds - job.consumed_s <= 0:
                    job.status = "failed"
                    job.error = "wall-clock budget exhausted"
                    job.completed_unix_ts = time.time()
                    self._counters.inc("jobs_failed")
                    self._record_drain(job.priority)
                    self._jlog(
                        "completed", job=job.id, status="failed",
                        error=job.error, result=None,
                    )
                    continue
                live.append(job)
            self._cond.notify_all()
        jobs = live
        if not jobs:
            return
        # The group budget is the tightest member's remaining wall-clock:
        # the batch never overruns ANY member. A sibling with budget left
        # when the soft exit fires re-queues uncharged-requeue (below).
        remaining = min(job.max_seconds - job.consumed_s for job in jobs)
        resumes = {
            job.id: latest_valid_checkpoint(job.checkpoint_path)
            for job in jobs
        }
        manifest = {
            "group": gid,
            "spec": spec,
            "lanes": [
                {
                    "job": job.id,
                    "out": job._path("result.json"),
                    "checkpoint": job.checkpoint_path,
                    "metrics": job.metrics_path,
                    "resume": resumes[job.id],
                    "max_states": job.max_states,
                    "trace_id": job.trace_id,
                    "chaos": {
                        key: job.chaos.get(key)
                        for key in ("die_at_depth", "freeze_at_depth", "marker")
                    },
                }
                for job in jobs
            ],
        }
        manifest_path = lead._path(f"mux-manifest-a{attempts[lead.id]}.json")
        tmp = manifest_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(manifest, fh)
        os.replace(tmp, manifest_path)
        hb_path = lead._path("mux-hb.json")
        argv = [
            sys.executable, _WORKER,
            "--mux", manifest_path,
            "--spec", spec,
            "--engine", "xla",
            "--platform", cfg.platform,
            "--out", lead._path("mux-result.json"),
            "--every", str(cfg.checkpoint_every),
            "--keep", str(cfg.checkpoint_keep),
            "--max-seconds", str(remaining),
        ]
        if cfg.device_ordinal is not None:
            argv += ["--device", str(cfg.device_ordinal)]

        def on_spawn(proc):
            # Same close/evacuate race contract as the solo path — every
            # member carries the (shared) proc handle so close() and
            # evacuate() kill the batch through any member, and every
            # member journals its own `started` (the mux provenance keys
            # ride along; replay ignores unknown keys).
            with self._cond:
                closed = self._closed
                migrated = False
                for job in jobs:
                    job._proc = proc
                    if job.status == "migrated":
                        migrated = True
                        continue
                    self._jlog(
                        "started", job=job.id, attempt=attempts[job.id],
                        engine="xla", resumed_from=resumes[job.id],
                        pid=proc.pid, mux_group=gid, mux_lanes=len(jobs),
                        trace_id=job.trace_id,
                    )
            if closed or migrated:
                sup._kill_group(proc)

        with self._cond:
            if self._closed:
                for job in jobs:
                    if job.status != "running":
                        continue
                    job.status = "failed"
                    job.error = "service closed"
                    self._counters.inc("jobs_failed")
                self._cond.notify_all()
                return
            if any(job.status == "migrated" for job in jobs):
                # Evacuate raced the spawn: the whole pool is condemned
                # (evacuate sweeps every non-terminal batch job) — don't
                # start a worker on the dead device.
                self._cond.notify_all()
                return
            self._counters.inc("mux_groups")
            self._counters.inc("mux_lanes", len(jobs))
            now = time.monotonic()
            for i, job in enumerate(jobs):
                job.engine = "xla"
                job.resumed_from = resumes[job.id]
                job._attempt_t0 = now
                job._mux_hb = hb_path
                job.mux = {"group": gid, "lanes": len(jobs), "lane": i}
        self.log(
            f"{gid} lanes={[j.id for j in jobs]} attempt engine=xla"
        )
        res = sup.run_worker(
            argv,
            heartbeat=hb_path,
            # Same verdict-ordering contract as the solo path: soft
            # budget exit first, heartbeat wedge verdict second, hard
            # timeout as the backstop.
            timeout_s=remaining * 1.5 + 60.0 + cfg.stall_s * 3.0,
            stall_s=cfg.stall_s,
            startup_grace_s=cfg.startup_grace_s,
            poll_s=cfg.poll_s,
            env=self._worker_env(lead, True),
            stdout_path=lead._path(f"mux-worker{attempts[lead.id]}.out"),
            log=self.log,
            on_spawn=on_spawn,
            tracer=self._tracer,
            trace_ctx=(
                (lead.trace_id, lead._root_sid) if lead.trace_id else None
            ),
            trace_attrs={
                "job": lead.id, "group": gid,
                "lanes": len(jobs), "engine": "xla",
            },
        )
        summary = None
        try:
            with open(lead._path("mux-result.json")) as fh:
                summary = json.load(fh)
        except (OSError, json.JSONDecodeError):
            summary = None
        results: Dict[str, Any] = {}
        for job in jobs:
            # Per-lane results are written the moment a lane finishes —
            # read them even when the worker died: finished members
            # settle done across a mid-batch crash (a stale file cannot
            # exist: a member with a result would have settled done).
            try:
                with open(job._path("result.json")) as fh:
                    results[job.id] = json.load(fh)
            except (OSError, json.JSONDecodeError):
                pass
        with self._cond:
            for job in jobs:
                job._proc = None
                job._attempt_t0 = None
                job._mux_hb = None
            live = [j for j in jobs if j.status != "migrated"]
            if not live:
                # Evacuated mid-attempt (the fleet killed the worker):
                # the siblings own every member now.
                self._cond.notify_all()
                return
            if summary is not None:
                self._counters.inc(
                    "mux_dispatches_saved",
                    int(summary.get("dispatches_saved") or 0),
                )
            for job in live:
                # Budget: a finished lane's charge is ITS lane wall-clock
                # (the worker stamps per-lane seconds); an unfinished
                # member rode the whole attempt. Wedge time stays
                # uncharged, exactly the solo contract.
                seconds = (
                    results[job.id].get("seconds", res.seconds)
                    if job.id in results
                    else res.seconds
                )
                if not res.wedged:
                    job.consumed_s += float(seconds)
                job.attempts.append(
                    {
                        "rc": res.rc,
                        "killed": res.killed,
                        "seconds": seconds,
                        "engine": "xla",
                        "wedged": res.wedged,
                        "resumed_from": resumes[job.id],
                        "mux_group": gid,
                    }
                )
                self._jlog(
                    "budget_charged", job=job.id, seconds=seconds,
                    consumed_s=job.consumed_s, charged=not res.wedged,
                )
            if self._closed:
                for job in live:
                    job.status = "failed"
                    job.error = "service closed"
                    self._counters.inc("jobs_failed")
                self._cond.notify_all()
                return
            finished = [j for j in live if j.id in results]
            unfinished = [j for j in live if j.id not in results]
            for job in finished:
                job.status = "done"
                job.result = results[job.id]
                job.completed_unix_ts = time.time()
                self._counters.inc("jobs_done")
                self._record_drain(job.priority)
                self._jlog(
                    "completed", job=job.id, status="done", error=None,
                    result=job.persist()["result"],
                )
            if finished:
                self._consecutive_wedges = 0
                self._sweep_artifacts()
            if unfinished:
                for job in unfinished:
                    job._mux_solo = True
                if res.wedged:
                    # ONE device incident (one worker, one wedge) for the
                    # breaker's evidence; each member still records the
                    # wedged attempt it rode.
                    self._counters.inc("wedge_verdicts")
                    self._record_wedge()
                    for job in unfinished:
                        job.wedges += 1
                        self._requeue_or_fail(
                            job, f"mux wedge verdict: {res.killed}",
                            wedged=True,
                        )
                elif res.crashed:
                    self._counters.inc("crashes")
                    for job in unfinished:
                        self._requeue_or_fail(
                            job,
                            f"mux worker died by signal (rc={res.rc})",
                            wedged=False,
                        )
                elif res.killed is not None or res.rc == 3:
                    # The GROUP budget (the tightest member) expired.
                    # Members whose own budget is spent fail; siblings
                    # with wall-clock left retry solo, no requeue burned.
                    for job in unfinished:
                        if job.max_seconds - job.consumed_s <= 0:
                            job.status = "failed"
                            job.error = "wall-clock budget exhausted"
                            job.completed_unix_ts = time.time()
                            self._counters.inc("jobs_failed")
                            self._record_drain(job.priority)
                            self._jlog(
                                "completed", job=job.id, status="failed",
                                error=job.error, result=None,
                            )
                        else:
                            requeue_solo([job])
                else:
                    for job in unfinished:
                        job.status = "failed"
                        job.error = f"mux worker exited rc={res.rc}"
                        job.completed_unix_ts = time.time()
                        self._counters.inc("jobs_failed")
                        self._record_drain(job.priority)
                        self._jlog(
                            "completed", job=job.id, status="failed",
                            error=job.error, result=None,
                        )
            self._cond.notify_all()

    def _requeue_or_fail(
        self, job: Job, reason: str, *, wedged: bool = False
    ) -> None:
        """Quarantine-and-requeue with exponential backoff, up to the
        requeue limit. Caller holds the lock.

        Halt-mode override: a WEDGE at the requeue limit while the
        breaker is open does not fail the job — the device is the
        condemned party, not the tenant, and the fleet is about to
        migrate the pool's jobs to healthy silicon. The job holds
        quarantined (no extra requeue charged) for evacuation; crashes
        and every verdict on a closed breaker keep the single-pool
        contract."""
        hold = (
            wedged
            and self._cfg.breaker_mode == "halt"
            and self._breaker == "open"
            and job.requeues >= self._cfg.requeue_limit
        )
        if job.requeues < self._cfg.requeue_limit or hold:
            if not hold:
                job.requeues += 1
                self._counters.inc("requeues")
            job.status = "quarantined"
            delay = sup.backoff_delay(job.requeues, self._cfg.backoff_s)
            job.requeue_at = time.monotonic() + delay
            if job.dir is not None and (
                os.path.exists(job.checkpoint_path)
                or os.path.exists(job.checkpoint_path + ".1")
            ):
                # The re-adoptable resume pointer (provenance — the next
                # attempt, this incarnation's or a restarted one's,
                # re-resolves latest_valid_checkpoint itself).
                self._jlog(
                    "checkpointed", job=job.id,
                    path=os.path.relpath(
                        job.checkpoint_path, self._cfg.run_dir
                    ),
                )
            self._jlog(
                "quarantined", job=job.id, reason=reason, wedged=wedged,
                requeues=job.requeues, wedges=job.wedges,
                release_in_s=delay,
            )
            self.log(f"{job.id} quarantined ({reason})")
        else:
            job.status = "failed"
            job.error = f"{reason}; requeue limit reached"
            job.completed_unix_ts = time.time()
            self._counters.inc("jobs_failed")
            self._record_drain(job.priority)
            self._jlog(
                "completed", job=job.id, status="failed",
                error=job.error, result=None,
            )

    # -- fleet migration (service/fleet.py) --------------------------------

    def evacuate(self, *, reason: str = "device lost") -> List[Job]:
        """Reclassify every non-terminal batch job as ``migrated`` —
        terminal for THIS pool, journaled as ``evacuated`` so a pool
        restart never requeues it here — and kill any live worker process
        group. Returns the evacuated jobs; each carries everything a
        healthy sibling pool needs to resume it (spec, budgets,
        ``consumed_s`` updated with the live attempt's wall-clock,
        requeue history, and checkpoint rotations still on disk in its
        job dir). The FleetService is the only intended caller: it
        resubmits each to a sibling with ``spent_s=``/``resume_from=``."""
        procs = []
        out: List[Job] = []
        now = time.monotonic()
        with self._cond:
            for jid in self._order:
                job = self._jobs[jid]
                if job.kind != "batch" or job.done:
                    continue
                if job.engine_force == "host":
                    # Forced-host work is device-independent: killing it
                    # would discard progress no checkpoint can restore
                    # (host attempts don't checkpoint) for zero safety
                    # gain — the dead device was never involved.
                    continue
                if job.status == "running" and job._attempt_t0 is not None:
                    # The live attempt's spend: run_worker has not
                    # returned (we are about to kill it), so charge the
                    # elapsed wall-clock here — the sibling must not get
                    # a budget refund out of the migration.
                    job.consumed_s += max(0.0, now - job._attempt_t0)
                    job._attempt_t0 = None
                if job._proc is not None and job._proc.poll() is None:
                    procs.append(job._proc)
                job.status = "migrated"
                job.error = reason
                job.completed_unix_ts = time.time()
                self._counters.inc("jobs_evacuated")
                self._jlog(
                    "evacuated", job=job.id, reason=reason,
                    consumed_s=job.consumed_s,
                )
                out.append(job)
            self._cond.notify_all()
        for proc in procs:
            sup._kill_group(proc)
        return out

    # -- breaker -----------------------------------------------------------

    def _notify_breaker_listener(self, state: str) -> None:
        """Fire the fleet's breaker listener from a fresh thread — the
        trip/close sites hold the pool lock, and the listener (migration
        scheduling) takes fleet locks of its own."""
        listener = self._cfg.breaker_listener
        if listener is not None:
            threading.Thread(
                target=listener, args=(state,),
                name="stpu-breaker-listener", daemon=True,
            ).start()

    def _record_wedge(self) -> None:
        """Caller holds the lock."""
        self._consecutive_wedges += 1
        if (
            self._breaker == "closed"
            and self._consecutive_wedges >= self._cfg.breaker_k
        ):
            self._breaker = "open"
            self._breaker_opened_unix_ts = time.time()
            self._counters.inc("breaker_trips")
            self._jlog(
                "breaker_tripped", consecutive=self._consecutive_wedges
            )
            self.log(
                f"breaker OPEN after {self._consecutive_wedges} consecutive "
                "wedge verdicts; "
                + (
                    "holding queued jobs for fleet migration"
                    if self._cfg.breaker_mode == "halt"
                    else "routing jobs to the host engine"
                )
            )
            self._notify_breaker_listener("open")
            if self._cfg.probe_auto:
                self._start_prober()

    @property
    def degraded(self) -> bool:
        """Whether the breaker is open (new work routes to the host
        engine)."""
        return self._breaker == "open"

    def probe_device_now(self) -> bool:
        """One device-liveness probe (a watchdogged subprocess that starts
        the device and launches one tensor op -- the service process never
        touches the card); on success while the breaker
        is open, closes it. The background prober calls this on
        ``probe_interval_s``; tests and operators call it directly."""
        argv = list(self._cfg.probe_argv or _probe_argv(self._cfg.platform))
        with self._lock:  # Counters.inc is not atomic; every mutation locks
            self._counters.inc("device_probes")
        try:
            rc = subprocess.run(
                argv,
                timeout=self._cfg.probe_timeout_s,
                capture_output=True,
            ).returncode
        except (subprocess.TimeoutExpired, OSError):
            rc = None
        ok = rc == 0
        closed_now = False
        with self._cond:
            if ok and self._breaker == "open":
                self._breaker = "closed"
                self._breaker_opened_unix_ts = None
                self._consecutive_wedges = 0
                self._counters.inc("breaker_closes")
                self._jlog("breaker_closed")
                self.log("breaker CLOSED (device probe healthy)")
                closed_now = True
                self._cond.notify_all()
        if closed_now:
            self._notify_breaker_listener("closed")
        return ok

    def _probe_loop(self) -> None:
        while True:
            deadline = time.monotonic() + self._cfg.probe_interval_s
            with self._cond:
                while not self._closed and time.monotonic() < deadline:
                    if self._breaker == "closed":
                        return
                    self._cond.wait(timeout=min(
                        1.0, deadline - time.monotonic()
                    ))
                if self._closed or self._breaker == "closed":
                    return
            self.probe_device_now()

    # -- status surface ----------------------------------------------------

    def job(self, job_id: str) -> Job:
        return self._jobs[job_id]

    def jobs(self) -> List[Job]:
        with self._lock:
            return [self._jobs[jid] for jid in self._order]

    def wait_all(self, timeout: Optional[float] = None) -> bool:
        """Blocks until every batch job is terminal."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while any(
                not j.done for j in self._jobs.values() if j.kind == "batch"
            ):
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(timeout=remaining)
        return True

    @property
    def run_dir(self) -> str:
        return self._cfg.run_dir

    def merged_trace_chrome(self, out_path: Optional[str] = None) -> Optional[str]:
        """The whole pool's merged distributed-trace timeline
        (``obs.collect`` over the run dir: service + every job/lane span
        file, flow arrows per trace id) as Perfetto-loadable Chrome trace
        JSON; returns the output path, or None when nothing traced.
        Mtime-cached like :meth:`job_trace_chrome` — the Explorer's
        ``GET /.trace.json`` polls this."""
        from ..obs import collect as collect_mod

        files = collect_mod.trace_files(self._cfg.run_dir)
        if not files:
            return None
        dst = out_path or os.path.join(self._cfg.run_dir, "trace.merged.json")
        try:
            dst_m = os.stat(dst).st_mtime
            fresh = all(os.stat(p).st_mtime <= dst_m for p in files)
        except OSError:
            fresh = False
        if not fresh:
            collect_mod.write(self._cfg.run_dir, dst)
        return dst

    def _qos_gauges(self) -> Dict[str, Any]:
        """The per-class / per-tenant QoS breakdown (caller holds the
        lock): ``gauges()``'s ``"qos"`` dict — the dashboard's class
        tiles and the ``/.metrics`` ``class=``/``tenant=`` labeled
        samples render from it (docs/observability.md)."""
        classes: Dict[str, Dict[str, Any]] = {
            cls: {
                "queued": 0, "running": 0, "quarantined": 0,
                "done": 0, "failed": 0, "migrated": 0,
                "weight": self._class_weights.get(cls, 1.0),
                "served": self._qos_served.get(cls, 0),
                "drain_per_s": self._drain_rate(cls),
            }
            for cls in PRIORITY_CLASSES
        }
        tenants: Dict[str, Dict[str, Any]] = {}
        for j in self._jobs.values():
            if j.kind != "batch":
                continue
            row = classes.get(j.priority)
            if row is not None and j.status in row:
                row[j.status] += 1
            t = tenants.setdefault(
                j.tenant,
                {"queued": 0, "running": 0, "done": 0, "failed": 0,
                 "spent_s": 0.0},
            )
            if j.status in ("queued", "quarantined"):
                t["queued"] += 1
            elif j.status in t:
                t[j.status] += 1
            t["spent_s"] = round(t["spent_s"] + j.consumed_s, 3)
        return {
            "classes": classes,
            "tenants": tenants,
            "aging_s": self._cfg.qos_aging_s,
            "drain_per_s": self._drain_rate(),
        }

    def gauges(self) -> Dict[str, Any]:
        """The pool-wide snapshot without per-job payloads — what the
        Explorer embeds under ``/.status``'s ``"pool"`` key."""
        with self._lock:
            counts = self._counts()
            return {
                **counts,
                "qos": self._qos_gauges(),
                "device": self._cfg.device,
                "max_inflight": self._cfg.max_inflight,
                "max_queue": self._cfg.max_queue,
                "max_sessions": self._cfg.max_sessions,
                "breaker": {
                    "state": self._breaker,
                    "consecutive_wedges": self._consecutive_wedges,
                    "k": self._cfg.breaker_k,
                    "opened_unix_ts": self._breaker_opened_unix_ts,
                },
                # Durability provenance (docs/service.md): the journal's
                # position and — after a restart — what the replay
                # restored; surfaces in the Explorer's /.pool unchanged.
                "journal": (
                    None
                    if self._journal is None
                    else {
                        "path": self._journal.path,
                        "records": self._journal.seq,
                        "since_compact": self._journal.since_compact,
                        "recovery": self._recovery,
                    }
                ),
                **self._counters.snapshot(),
            }

    def metrics(self) -> Dict[str, Any]:
        """Pool gauges plus per-job status snapshots (the full service
        status surface; per-job engine metrics via ``Job.metrics()``)."""
        out = self.gauges()
        with self._lock:
            out["jobs"] = {
                jid: self._jobs[jid].snapshot() for jid in self._order
            }
        return out

    def job_metrics_series(
        self, job_id: str, window: Optional[int] = None
    ) -> Optional[List[Dict[str, Any]]]:
        """A batch job's recorded metrics time-series (the per-job
        ``metrics.jsonl`` the worker samples at quiescent superstep
        boundaries; docs/observability.md "Time series"), newest-``window``
        rows, oldest first. None when the job never produced a series
        (host-engine jobs, swept artifacts) or is interactive (live
        checkers are polled, not recorded — the Explorer samples those
        itself). Raises ``KeyError`` on an unknown job id."""
        from ..obs import read_series

        job = self._jobs[job_id]
        if job.dir is None or not os.path.exists(job.metrics_path):
            return None
        return read_series(job.metrics_path, window=window)

    def job_trace_chrome(self, job_id: str,
                         out_path: Optional[str] = None) -> Optional[str]:
        """Exports a job's span trace as Perfetto-loadable Chrome trace
        JSON (``obs.export_chrome``); returns the output path, or None when
        the job never produced a trace (host-engine jobs don't)."""
        job = self._jobs[job_id]
        if job.dir is None or not os.path.exists(job.trace_path):
            return None
        dst = out_path or job._path("trace.chrome.json")
        try:
            fresh = os.stat(dst).st_mtime >= os.stat(job.trace_path).st_mtime
        except OSError:
            fresh = False
        if not fresh:
            # Re-export only when the append-only source advanced — a
            # polled trace endpoint must not re-parse the whole JSONL per
            # request.
            export_chrome(job.trace_path, dst)
        return dst
