"""FleetService: per-device pools with routing, failover and replay.

Counterpart of ``stateright_tpu/service/fleet.py``, with the same
``FleetConfig`` fields and defaults, ``FLEET_COUNTERS``, ``FleetJob``
surface, fleet journal records (``routed``, ``migrated``, ``quiesced``,
``woken``, ``snapshot``, ``recovered``) and run-dir layout
(``<run_dir>/fleet.jsonl``, ``<run_dir>/device-<i>/``): a run dir written
by either package's fleet replays in the other's
(``tests/test_torch_fleet.py``). One :class:`~.core.CheckerService` per
device, fronted by ONE object with the ``submit``/``job``/``wait_all``/
``gauges`` surface a single pool serves:

- **Device-aware routing** -- whole jobs place on the least-loaded
  *healthy* device (breaker closed, not lost, not quiesced). Idempotency
  keys are fleet-scoped: a key the fleet knows returns the existing
  :class:`FleetJob`. Breaker state is per pool: one wedged device
  quarantines only its own jobs.
- **Failover migration** -- when a device's breaker trips (the
  ``breaker_listener`` wakes the fleet monitor) or the device is lost
  (``device.lost`` chaos, or :meth:`FleetService.device_lost`), the pool's
  non-terminal jobs are **evacuated** (``CheckerService.evacuate``: a
  journaled ``migrated`` status, worker groups killed) and resubmitted to a
  healthy sibling with ``spent_s=`` (wall-clock stays charged) and
  ``resume_from=`` (the victim's newest valid checkpoint rotation). Fleet
  pools run ``breaker_mode="halt"``: an open breaker holds queued jobs for
  migration; the host engine is the last resort, taken only when every
  device is open or lost.
- **Durable routing** -- the fleet journals its placements at
  ``<run_dir>/fleet.jsonl`` (``service/journal.py``'s records). A fleet
  constructed over a run dir with journals replays them: each pool restores
  its own jobs, then the fleet journal re-attaches every FleetJob to its
  pool job, adopts idempotency keys a torn fleet tail lost, and re-routes
  orphans from their journaled spec.
- **Fleet-scale chaos** (``chaos.py``) -- ``device.lost`` (``@n`` counts
  successful placements; params ``device``, default the device just routed
  to, and ``after_s``, the delay) kills one device's pool mid-schedule;
  ``device.flaky`` gives the routed job a one-shot heartbeat freeze on its
  device. ``python -m stateright_tpu_torch.tools.service_chaos --fleet N``
  drives seeded schedules through both and checks exactly-once completion.

On the card, ``pin_devices=True`` passes ``--device i`` to pool ``i``'s
workers (``cuda:i``; an ordinal the machine lacks falls back to the default
card and the worker's result records it); the default leaves every pool on
the default card. Like the pools, the fleet's own process never touches
the card: only workers, probers and the admission check start a device.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from .. import chaos as chaos_mod
from ..checkpoint import latest_valid_checkpoint
from ..obs import NULL_TRACER, Counters, new_trace_id, resolve_tracer
from .core import AdmissionError, CheckerService, Job, ServiceConfig
from .journal import Journal, read_journal

#: Fleet-level counters (the pools keep SERVICE_COUNTERS of their own).
FLEET_COUNTERS = (
    "submitted",
    "admitted",
    "rejected",
    "routed",
    "migrations",
    "devices_lost",
    "device_flakes",
    "host_last_resort",
    "idem_dedups",
    "jobs_recovered",
    "pools_quiesced",
    "pools_woken",
)


@dataclass
class FleetConfig:
    """Fleet knobs. Per-pool knobs ride in ``pool`` (a template
    ServiceConfig; its ``run_dir``/``device``/``device_ordinal``/
    ``breaker_mode``/``breaker_listener`` are overwritten per device)."""

    run_dir: str = os.path.join("runs", "fleet")
    devices: int = 2  #: pools to front (one per device ordinal 0..N-1)
    #: Monitor cadence: the sweep that notices open breakers / lost
    #: devices and migrates their jobs (a breaker trip also wakes it
    #: immediately through the listener).
    monitor_interval_s: float = 1.0
    #: Pin worker processes to their pool's device ordinal (worker.py
    #: ``--device``, ``cuda:<i>``). Off by default: every pool's workers
    #: then run on the default card.
    pin_devices: bool = False
    # -- durability (fleet.jsonl; same Journal discipline as the pools) ----
    journal: bool = True
    journal_compact_every: int = 256
    journal_keep: int = 3
    # -- fault injection ---------------------------------------------------
    chaos: Optional[str] = None
    #: Template for the per-device pools (None = ServiceConfig defaults).
    pool: Optional[ServiceConfig] = None
    #: Interactive sessions cap, fleet-wide (None = sum of pool caps).
    max_sessions: Optional[int] = None
    # -- elastic pools -------------------------------------------------------
    #: Idle pools quiesce (drop out of routing; their workers are already
    #: reaped — a pool only quiesces at zero load) and wake under queue
    #: pressure. Quiesce/wake decisions are journaled (``quiesced`` /
    #: ``woken`` fleet events) so a restart resumes the same active set.
    elastic: bool = False
    #: A pool must sit at zero load this long before the monitor
    #: quiesces it.
    idle_quiesce_s: float = 30.0
    #: Never quiesce below this many active (non-lost, non-quiesced)
    #: pools.
    min_active: int = 1
    #: Distributed tracing:
    #: True → fleet route/migrate spans to ``<run_dir>/trace.jsonl`` (and
    #: each pool, unless its template says otherwise, traces to its own
    #: run dir); a path appends there; None → ``STPU_SERVICE_TRACE`` env.
    #: Trace ids mint and journal regardless — only span writes gate.
    trace: Any = None


class FleetJob:
    """One fleet entry: a stable fleet-scoped identity over the (possibly
    migrating) pool job currently serving it. The surface mirrors
    :class:`~.core.Job` where it matters (``status``/``result``/``error``/
    ``wait``/``snapshot``/``metrics``/``done``)."""

    def __init__(self, fleet: "FleetService", fleet_id: str,
                 idempotency_key: Optional[str] = None):
        self._fleet = fleet
        self.id = fleet_id
        self.idempotency_key = idempotency_key
        self.device: Optional[int] = None  #: current device index
        self.pool_job: Optional[Job] = None  #: current pool job
        self.migrations: List[Dict[str, Any]] = []
        self.recovered = False  #: restored by a fleet-journal replay
        #: Set when the reserving submit was rejected fleet-wide: the
        #: handle is terminal-failed (a concurrent same-key submit may
        #: have deduped onto it before the rejection landed).
        self._rejected: Optional[str] = None
        #: Journaled spec kept for the repair pass when a restart cannot
        #: re-attach the routed pool job (torn/lost pool journal, or a
        #: smaller fleet): enough to re-route the work from scratch.
        self._orphan_spec: Optional[str] = None
        #: QoS identity -- journaled on
        #: ``routed`` so migrations and orphan re-routes keep the class.
        self.tenant: str = "default"
        self.priority: str = "batch"
        self.deadline_s: Optional[float] = None
        #: Per-job symmetry mode (``sym/``) — journaled on
        #: ``routed`` so migrations and orphan re-routes keep it.
        self.symmetry: Optional[str] = None
        self.created_unix_ts = time.time()
        #: Fleet-minted distributed-trace id — stable across migrations
        #: (every hop's pool job carries the same one).
        self.trace_id: Optional[str] = None

    # -- delegation --------------------------------------------------------

    def _current(self):
        with self._fleet._lock:
            return self.device, self.pool_job

    @property
    def status(self) -> str:
        if self._rejected is not None:
            return "failed"
        job = self._current()[1]
        if job is None:
            return "queued"
        # "migrated" is a pool-internal verdict: from the fleet's view the
        # job is between devices (the monitor is re-routing it).
        return "migrating" if job.status == "migrated" else job.status

    @property
    def done(self) -> bool:
        if self._rejected is not None:
            return True
        job = self._current()[1]
        return job is not None and job.status in ("done", "failed")

    @property
    def result(self):
        job = self._current()[1]
        return None if job is None else job.result

    @property
    def error(self):
        if self._rejected is not None:
            return self._rejected
        job = self._current()[1]
        return None if job is None else job.error

    @property
    def requeues(self) -> int:
        job = self._current()[1]
        base = sum(m.get("requeues", 0) for m in self.migrations)
        return base + (0 if job is None else job.requeues)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Blocks until the job is terminal FOR THE FLEET (done/failed on
        whatever device it ends up on — migrations are waited through)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._rejected is not None:
                return True
            job = self._current()[1]
            remaining = (
                None if deadline is None else deadline - time.monotonic()
            )
            if remaining is not None and remaining <= 0:
                return self.done
            if job is None:
                # Routed but not attached yet (a recovery edge) — the
                # monitor repairs it; poll.
                time.sleep(min(0.05, remaining or 0.05))
                continue
            job.wait(timeout=min(0.5, remaining) if remaining else 0.5)
            if job.status in ("done", "failed"):
                return True
            if job.status == "migrated":
                # Terminal for the pool but not for the fleet: the
                # monitor is re-routing — don't spin on the pool's
                # already-settled condition.
                time.sleep(0.05)
            # loop re-reads the current pool job.

    def snapshot(self) -> Dict[str, Any]:
        device, job = self._current()
        out = job.snapshot() if job is not None else {"status": "queued"}
        out.update(
            fleet_job=self.id,
            device=(
                self._fleet._device_label(device)
                if device is not None
                else None
            ),
            status=self.status,
            migrations=len(self.migrations),
            recovered=out.get("recovered", False) or self.recovered,
            trace_id=self.trace_id or out.get("trace_id"),
            tenant=self.tenant,
            priority=self.priority,
            deadline_s=self.deadline_s,
        )
        return out

    def metrics(self):
        job = self._current()[1]
        return None if job is None else job.metrics()


def _fleet_replay(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold the fleet journal into recoverable routing state (pure —
    testable without a fleet): last ``snapshot`` as base, later
    ``routed``/``migrated`` events on top. ``routes[fid]`` holds the
    CURRENT placement; ``migrations[fid]`` the count."""
    state: Dict[str, Any] = {
        "next_id": 0,
        "routes": {},
        "order": [],
        "idem": {},
        "counters": {},
        "migrations": {},
        "quiesced": set(),
    }

    def inc(name: str, n: int = 1) -> None:
        state["counters"][name] = state["counters"].get(name, 0) + n

    for rec in records:
        ev = rec["event"]
        if ev == "snapshot":
            s = rec["state"]
            state["next_id"] = s.get("next_id", state["next_id"])
            state["routes"] = {k: dict(v) for k, v in s.get("routes", {}).items()}
            state["order"] = [
                f for f in s.get("order", list(state["routes"]))
                if f in state["routes"]
            ]
            state["idem"] = dict(s.get("idem", {}))
            state["counters"] = dict(s.get("counters", {}))
            state["migrations"] = dict(s.get("migrations", {}))
            state["quiesced"] = set(s.get("quiesced", []))
            continue
        if ev == "recovered":
            continue
        if ev == "quiesced":
            state["quiesced"].add(rec["device"])
            inc("pools_quiesced")
            continue
        if ev == "woken":
            state["quiesced"].discard(rec["device"])
            inc("pools_woken")
            continue
        fid = rec.get("job")
        if fid is None:
            continue
        if ev == "routed":
            state["routes"][fid] = {
                "device": rec["device"],
                "pool_job": rec["pool_job"],
                "spec": rec.get("spec"),
                "idempotency_key": rec.get("idempotency_key"),
                "trace_id": rec.get("trace_id"),
                "tenant": rec.get("tenant", "default"),
                "priority": rec.get("priority", "batch"),
                "deadline_s": rec.get("deadline_s"),
                "symmetry": rec.get("symmetry"),
            }
            if fid not in state["order"]:
                state["order"].append(fid)
            if rec.get("idempotency_key"):
                state["idem"][rec["idempotency_key"]] = fid
            try:
                state["next_id"] = max(
                    state["next_id"], int(fid.rsplit("-", 1)[-1])
                )
            except ValueError:
                pass
            inc("submitted")
            inc("admitted")
            inc("routed")
        elif ev == "migrated":
            route = state["routes"].get(fid)
            if route is None:
                continue
            route["device"] = rec["to_device"]
            route["pool_job"] = rec["pool_job"]
            state["migrations"][fid] = state["migrations"].get(fid, 0) + 1
            inc("migrations")
    return state


class FleetService:
    """N per-device :class:`CheckerService` pools behind one
    ``submit``/``job``/``wait_all``/``gauges`` surface (see the module
    docstring for the routing/migration/durability contract). Also
    implements the session-registration surface the Explorer client uses
    (``check_session_capacity``/``register_interactive``/
    ``release_interactive``), so ``make_app(service=fleet)`` works
    unchanged."""

    def __init__(self, config: Optional[FleetConfig] = None, **overrides):
        if config is not None and overrides:
            raise TypeError(
                "pass either a FleetConfig or keyword overrides, not both "
                f"(got config and {sorted(overrides)})"
            )
        self._cfg = config or FleetConfig(**overrides)
        if self._cfg.devices < 1:
            raise ValueError("a fleet needs at least one device")
        self._lock = threading.Lock()
        #: Serializes session count-check + registration: the fleet-wide
        #: cap must not be exceeded by concurrent registrations racing
        #: the count (the pools' own locks only guard their PER-POOL cap).
        self._session_lock = threading.Lock()
        self._counters = Counters(FLEET_COUNTERS)
        self._jobs: Dict[str, FleetJob] = {}
        self._order: List[str] = []
        self._idem: Dict[str, str] = {}
        self._next_id = 0
        self._lost: set = set()  #: device indices declared dead
        self._quiesced: set = set()  #: elastic pools out of routing
        self._idle_since: Dict[int, float] = {}  #: monotonic idle marks
        self._closed = False
        self._monitor: Optional[threading.Thread] = None
        self._wake = threading.Event()  #: breaker listeners pulse this
        self._timers: List[threading.Timer] = []  #: armed device.lost
        self._journal: Optional[Journal] = None
        self._recovery: Optional[Dict[str, Any]] = None
        self.log = lambda msg: None
        trace_cfg = self._cfg.trace
        if trace_cfg is None:
            raw = os.environ.get("STPU_SERVICE_TRACE") or None
            trace_cfg = True if raw == "1" else raw
        if trace_cfg is True:
            trace_cfg = os.path.join(self._cfg.run_dir, "trace.jsonl")
        self._tracer = (resolve_tracer(trace_cfg) if trace_cfg else NULL_TRACER)
        if self._cfg.chaos:
            chaos_mod.install(self._cfg.chaos)
        # Per-device pools. Constructed AFTER the chaos install so a
        # pool-journal replay sees the plan; each pool replays its own
        # journal if its run dir has one.
        self.pools: List[CheckerService] = []
        for i in range(self._cfg.devices):
            self.pools.append(CheckerService(self._pool_config(i)))
        if self._cfg.journal:
            self._journal = Journal(
                os.path.join(self._cfg.run_dir, "fleet.jsonl"),
                keep=self._cfg.journal_keep,
                compact_every=self._cfg.journal_compact_every,
            )
            if os.path.exists(self._journal.path):
                self._recover()
        # A restart with live (requeued) work needs the monitor running
        # from the start — migrated stragglers and re-tripped breakers
        # are its job to repair.
        if any(not j.done for j in self._jobs.values()):
            self._ensure_monitor()

    def _pool_config(self, i: int) -> ServiceConfig:
        # Everything not overridden below inherits from the caller's pool
        # template — notably mux_k, so a batching fleet multiplexes
        # same-spec jobs WITHIN each device's pool (routing stays
        # whole-job; lanes never span devices).
        base = self._cfg.pool or ServiceConfig()
        return dataclasses.replace(
            base,
            run_dir=os.path.join(self._cfg.run_dir, f"device-{i}"),
            device=self._device_label(i),
            device_ordinal=i if self._cfg.pin_devices else None,
            breaker_mode="halt",
            breaker_listener=self._breaker_listener(i),
            # The fleet's spec rides into every pool so _worker_env
            # exports STPU_CHAOS to worker processes (checkpoint.torn
            # fires THERE); the pools' own installs are no-ops — install
            # is idempotent on a same-spec re-install, so the plan the
            # fleet installed in __init__ keeps its counters.
            chaos=self._cfg.chaos,
            # A tracing fleet traces its pools too (each to its own run
            # dir) unless the template pins an explicit choice.
            trace=(
                base.trace if base.trace is not None
                else (True if self._tracer.enabled else None)
            ),
        )

    def _device_label(self, i: int) -> str:
        return f"device-{i}"

    def _breaker_listener(self, i: int):
        def listener(state: str) -> None:
            self.log(f"device-{i} breaker {state}")
            if state == "open":
                # The monitor idle-exits once every job is terminal; a
                # later trip must bring it back for the evacuation pass.
                self._ensure_monitor()
            self._wake.set()
        return listener

    # -- lifecycle ---------------------------------------------------------

    def __enter__(self) -> "FleetService":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def close(self, kill: bool = True, timeout: float = 10.0) -> None:
        with self._lock:
            self._closed = True
            timers = list(self._timers)
        for timer in timers:
            # An armed chaos loss that hasn't fired dies with the fleet
            # (device_lost would no-op on _closed anyway — but a live
            # non-daemon timer would stall interpreter exit by after_s).
            timer.cancel()
        self._wake.set()
        if self._monitor is not None:
            self._monitor.join(timeout=timeout)
        for pool in self.pools:
            pool.close(kill=kill, timeout=timeout)
        if self._journal is not None:
            self._journal.close()

    def _ensure_monitor(self) -> None:
        # Check-and-start under the lock: two concurrent submits must
        # not both observe "no monitor" and start twin loops (twin
        # repair passes would double-journal migrations).
        with self._lock:
            if self._closed:
                return
            if self._monitor is None or not self._monitor.is_alive():
                self._monitor = threading.Thread(
                    target=self._monitor_loop, name="stpu-fleet-monitor",
                    daemon=True,
                )
                self._monitor.start()

    # -- durability --------------------------------------------------------

    def _jlog(self, event: str, **payload: Any) -> None:
        """Caller holds the fleet lock (mirrors the pools' _jlog)."""
        j = self._journal
        if j is None:
            return
        j.append(event, ts=time.time(), **payload)
        if j.compaction_due:
            j.compact(self._snapshot_payload(), ts=time.time())

    def _snapshot_payload(self) -> Dict[str, Any]:
        return {
            "next_id": self._next_id,
            "idem": dict(self._idem),
            "counters": self._counters.snapshot(),
            "order": list(self._order),
            "migrations": {
                fid: len(j.migrations)
                for fid, j in self._jobs.items()
                if j.migrations
            },
            "quiesced": sorted(self._quiesced),
            "routes": {
                fid: {
                    "device": j.device,
                    "pool_job": j.pool_job.id if j.pool_job else None,
                    # An orphan awaiting repair keeps its journaled spec
                    # through compaction: a crash before the repair pass
                    # runs must not turn it unrecoverable.
                    "spec": (
                        j.pool_job.spec if j.pool_job else j._orphan_spec
                    ),
                    "idempotency_key": j.idempotency_key,
                    "trace_id": j.trace_id,
                    "tenant": j.tenant,
                    "priority": j.priority,
                    "deadline_s": j.deadline_s,
                    # The reference drops the symmetry mode here, so an
                    # orphan re-routed after a compaction lost it.
                    "symmetry": j.symmetry,
                }
                for fid, j in self._jobs.items()
                # A reserved-but-still-routing handle must not be
                # snapshotted: replaying it would resurrect a route that
                # never existed (the `routed` event is the commit point).
                if j.pool_job is not None or j.recovered
            },
        }

    def _recover(self) -> None:
        """Replay ``fleet.jsonl`` routing over the already-replayed pools:
        re-attach each FleetJob to its routed pool job; adopt
        pool-restored idempotency keys a torn fleet tail lost (the pool
        journal is the job's source of truth); leave evacuated-but-never-
        resubmitted stragglers to the monitor's repair pass."""
        replay = read_journal(self._journal.path)
        state = _fleet_replay(replay.records)
        attached = 0
        orphaned = 0
        with self._lock:
            # Seq restores FIRST: the adoption/repair appends below must
            # continue the replayed sequence, not restart it at 1.
            self._journal.seq = (
                replay.records[-1]["seq"] if replay.records else 0
            )
            self._next_id = max(self._next_id, state["next_id"])
            self._idem.update(state["idem"])
            self._quiesced = {
                i for i in state["quiesced"]
                if isinstance(i, int) and 0 <= i < len(self.pools)
            }
            for name, value in state["counters"].items():
                if value and name != "jobs_recovered":
                    self._counters.inc(name, value)
            for fid in state["order"]:
                route = state["routes"][fid]
                fjob = FleetJob(
                    self, fid, idempotency_key=route.get("idempotency_key")
                )
                fjob.recovered = True
                fjob.trace_id = route.get("trace_id")
                fjob.tenant = route.get("tenant", "default")
                fjob.priority = route.get("priority", "batch")
                fjob.deadline_s = route.get("deadline_s")
                fjob.symmetry = route.get("symmetry")
                fjob.migrations = [
                    {"recovered": True}
                ] * state["migrations"].get(fid, 0)
                device = route.get("device")
                pool_job_id = route.get("pool_job")
                if (
                    device is not None
                    and 0 <= device < len(self.pools)
                    and pool_job_id is not None
                ):
                    try:
                        fjob.pool_job = self.pools[device].job(pool_job_id)
                        fjob.device = device
                        attached += 1
                    except KeyError:
                        fjob._orphan_spec = route.get("spec")
                        orphaned += 1
                else:
                    fjob._orphan_spec = route.get("spec")
                    orphaned += 1
                self._jobs[fid] = fjob
                self._order.append(fid)
                self._counters.inc("jobs_recovered")
            # Torn-tail repair: a pool may hold jobs (by idempotency key)
            # the fleet journal never recorded routing for — adopt them
            # rather than double-run on resubmission.
            known_pool_jobs = {
                (j.device, j.pool_job.id)
                for j in self._jobs.values()
                if j.pool_job is not None
            }
            for device, pool in enumerate(self.pools):
                for job in pool.jobs():
                    if job.kind != "batch" or job.idempotency_key is None:
                        continue
                    if (device, job.id) in known_pool_jobs:
                        continue
                    if job.idempotency_key.startswith("fleet-mig:"):
                        # An interrupted migration: the sibling pool
                        # journaled the resubmission but the fleet died
                        # before journaling `migrated`. Complete it —
                        # re-attach to the named fleet job instead of
                        # minting a duplicate (the pool job replays as
                        # live, so without this the straggler repair
                        # would double-run the work).
                        fid = job.idempotency_key.split(":")[1]
                        fjob = self._jobs.get(fid)
                        if fjob is not None and (
                            fjob.pool_job is None
                            or fjob.pool_job.status == "migrated"
                        ):
                            if fjob.trace_id is None:
                                fjob.trace_id = job.trace_id
                            from_device = fjob.device
                            fjob.migrations.append({"recovered": True})
                            fjob.device = device
                            fjob.pool_job = job
                            self._counters.inc("migrations")
                            self._jlog(
                                "migrated", job=fid,
                                from_device=from_device, to_device=device,
                                pool_job=job.id,
                                reason="recovered mid-migration",
                                seed=job.seed_checkpoint,
                            )
                            attached += 1
                        continue
                    if job.idempotency_key in self._idem:
                        continue
                    self._next_id += 1
                    fid = f"fjob-{self._next_id:04d}"
                    fjob = FleetJob(
                        self, fid, idempotency_key=job.idempotency_key
                    )
                    fjob.recovered = True
                    fjob.device = device
                    fjob.pool_job = job
                    fjob.trace_id = job.trace_id
                    fjob.tenant = job.tenant
                    fjob.priority = job.priority
                    fjob.deadline_s = job.deadline_s
                    fjob.symmetry = job.symmetry
                    self._jobs[fid] = fjob
                    self._order.append(fid)
                    self._idem[job.idempotency_key] = fid
                    self._counters.inc("jobs_recovered")
                    self._jlog(
                        "routed", job=fid, spec=job.spec, device=device,
                        pool_job=job.id,
                        idempotency_key=job.idempotency_key,
                        adopted=True,
                        trace_id=job.trace_id,
                        tenant=job.tenant, priority=job.priority,
                        deadline_s=job.deadline_s, symmetry=job.symmetry,
                    )
                    attached += 1
            self._recovery = {
                "records_replayed": len(replay.records),
                "torn": replay.torn,
                "routes_recovered": len(self._order),
                "attached": attached,
                "orphaned": orphaned,
            }
            self._journal.compact(self._snapshot_payload(), ts=time.time())
            self._jlog("recovered", **self._recovery)

    # -- routing -----------------------------------------------------------

    def _pool_load(self, i: int) -> int:
        g = self.pools[i].gauges()
        return g["queued"] + g["quarantined"] + g["running"]

    def _route_load(self, i: int, priority: Optional[str] = None) -> float:
        """Routing cost: total backlog, plus the same-class backlog again
        when the submission carries a priority — two devices equally busy
        overall tie-break toward the one with less SAME-class contention,
        so one tenant's interactive burst spreads instead of piling onto
        a single pool's interactive queue."""
        g = self.pools[i].gauges()
        load = float(g["queued"] + g["quarantined"] + g["running"])
        if priority is not None:
            row = (g.get("qos") or {}).get("classes", {}).get(priority)
            if row:
                load += row.get("queued", 0) + row.get("running", 0)
        return load

    def _healthy_devices(self) -> List[int]:
        return [
            i for i in range(len(self.pools))
            if i not in self._lost and i not in self._quiesced
            and not self.pools[i].degraded
        ]

    def _alive_devices(self) -> List[int]:
        return [i for i in range(len(self.pools)) if i not in self._lost]

    # -- elastic pools -------------------------------------------------------

    def quiesce_pool(self, i: int, reason: str = "idle") -> bool:
        """Take pool ``i`` out of routing (journaled ``quiesced`` event).
        Refused (False) when it would drop the active pool count below
        ``min_active``, or the pool is lost/already quiesced. A quiesce
        with work still on the pool is just a scale-down: the jobs
        evacuate and the monitor migrates them — the same journaled
        path a breaker trip takes."""
        with self._lock:
            if self._closed or i in self._quiesced or i in self._lost or not (
                0 <= i < len(self.pools)
            ):
                return False
            active = [
                d for d in range(len(self.pools))
                if d not in self._lost and d not in self._quiesced
            ]
            if len(active) <= max(1, self._cfg.min_active):
                return False
            self._quiesced.add(i)
            self._idle_since.pop(i, None)
            self._counters.inc("pools_quiesced")
            self._jlog("quiesced", device=i, reason=reason)
        self.log(f"device-{i} quiesced ({reason})")
        if self._pool_load(i):
            self.pools[i].evacuate(reason=f"device-{i} quiesced")
            self._ensure_monitor()
            self._wake.set()
        return True

    def wake_pool(self, i: int, reason: str = "pressure") -> bool:
        """Return a quiesced pool to routing (journaled ``woken``)."""
        with self._lock:
            if self._closed or i not in self._quiesced or i in self._lost:
                return False
            self._quiesced.discard(i)
            self._idle_since.pop(i, None)
            self._counters.inc("pools_woken")
            self._jlog("woken", device=i, reason=reason)
        self.log(f"device-{i} woken ({reason})")
        return True

    def _wake_for_pressure(self) -> Optional[int]:
        """Wake the lowest-numbered quiesced pool; None when there is
        nothing to wake."""
        with self._lock:
            candidates = sorted(self._quiesced - self._lost)
        for i in candidates:
            if self.wake_pool(i, reason="queue pressure"):
                return i
        return None

    def _elastic_sweep(self) -> None:
        """One monitor-cadence elastic pass: wake a pool when every
        active pool is backlogged past its in-flight capacity; quiesce
        pools idle past ``idle_quiesce_s`` (down to ``min_active``)."""
        with self._lock:
            if self._closed:
                return
            active = [
                i for i in range(len(self.pools))
                if i not in self._lost and i not in self._quiesced
            ]
            quiesced = sorted(self._quiesced - self._lost)
        if quiesced and active and all(
            self._pool_load(i) > max(self.pools[i]._cfg.max_inflight, 1)
            for i in active
        ):
            self.wake_pool(quiesced[0], reason="queue pressure")
            return
        now = time.monotonic()
        # Loads read OUTSIDE the fleet lock (gauges take each pool's own
        # lock — same ordering as every other fleet->pool call).
        loads = {i: self._pool_load(i) for i in active}
        idle_for: Dict[int, float] = {}
        with self._lock:
            for i in active:
                if loads[i] == 0:
                    since = self._idle_since.setdefault(i, now)
                    idle_for[i] = now - since
                else:
                    self._idle_since.pop(i, None)
        for i, idled in idle_for.items():
            if idled >= self._cfg.idle_quiesce_s:
                self.quiesce_pool(
                    i, reason=f"idle {self._cfg.idle_quiesce_s:g}s"
                )

    def submit(
        self,
        spec: str,
        *,
        max_seconds: Optional[float] = None,
        max_states: Optional[int] = None,
        chaos: Optional[Dict[str, Any]] = None,
        idempotency_key: Optional[str] = None,
        tenant: str = "default",
        priority: str = "batch",
        deadline_s: Optional[float] = None,
        symmetry: Optional[str] = None,
    ) -> FleetJob:
        """Route one batch job to the least-loaded healthy device —
        class-aware: same-class backlog counts double, so a class's
        burst spreads (host last resort when none is healthy; a fleet
        with quiesced elastic pools wakes one under pressure before
        either degrading or rejecting); returns the :class:`FleetJob`
        or raises :class:`AdmissionError` when every candidate rejects
        (the hint is the minimum Retry-After across devices — the
        soonest any of them expects room). ``tenant``/``priority``/
        ``deadline_s`` ride into the pool submission (per-pool quotas,
        fair-share, shedding) and are journaled on ``routed`` so a
        restart or migration keeps the class."""
        with self._lock:
            if self._closed:
                raise RuntimeError("fleet is closed")
            self._counters.inc("submitted")
            if idempotency_key is not None:
                known = self._jobs.get(self._idem.get(idempotency_key, ""))
                if known is not None:
                    self._counters.inc("idem_dedups")
                    return known
            # Reserve the fleet identity (and the key) BEFORE routing:
            # routing runs outside the lock, and a concurrent same-key
            # submit must dedupe onto THIS handle rather than race the
            # same work onto a second device.
            self._next_id += 1
            fjob = FleetJob(self, f"fjob-{self._next_id:04d}",
                            idempotency_key=idempotency_key)
            # The fleet mints the trace id — the pool job (and every
            # migration hop's resubmission) joins it rather than minting
            # its own, so one submission is ONE trace end to end.
            fjob.trace_id = new_trace_id()
            fjob.tenant = tenant
            fjob.priority = priority
            fjob.deadline_s = deadline_s
            fjob.symmetry = symmetry
            self._jobs[fjob.id] = fjob
            self._order.append(fjob.id)
            if idempotency_key is not None:
                self._idem[idempotency_key] = fjob.id
        # Seeded fleet chaos (deterministic for a deterministic
        # submission schedule): device.flaky fires per submission
        # ATTEMPT — it must inject into the chaos dict the pool submit
        # carries; device.lost fires per successful PLACEMENT (below) so
        # a rejected submission cannot swallow the seeded loss.
        try:
            flaky_inj = chaos_mod.fire("device.flaky")
            if flaky_inj is not None:
                chaos = dict(chaos or {})
                chaos.setdefault(
                    "freeze_at_depth", int(flaky_inj.get("depth", 3))
                )
                if flaky_inj.get("once", 1):
                    chaos.setdefault("marker", True)
            healthy = sorted(
                self._healthy_devices(),
                key=lambda i: self._route_load(i, priority),
            )
            pool_job: Optional[Job] = None
            device: Optional[int] = None
            forced_host = False
            rejections: List[AdmissionError] = []
            for i in healthy:
                try:
                    pool_job = self.pools[i].submit(
                        spec,
                        max_seconds=max_seconds,
                        max_states=max_states,
                        chaos=chaos,
                        idempotency_key=idempotency_key,
                        trace_id=fjob.trace_id,
                        tenant=tenant,
                        priority=priority,
                        deadline_s=deadline_s,
                        symmetry=symmetry,
                    )
                    device = i
                    break
                except AdmissionError as e:
                    rejections.append(e)
                    if e.retry_after_s is None:
                        # Budget/lint rejection: identical on every
                        # device — trying the siblings is pure waste.
                        break
            if pool_job is None and all(
                e.retry_after_s is not None for e in rejections
            ):
                # Elastic wake-on-pressure: a quiesced pool beats both
                # host degradation and a queue-full/shed rejection. (A
                # hint-less rejection — budget, lint — is identical on
                # every pool, so waking one wouldn't help.)
                woken = self._wake_for_pressure()
                if woken is not None:
                    try:
                        pool_job = self.pools[woken].submit(
                            spec,
                            max_seconds=max_seconds,
                            max_states=max_states,
                            chaos=chaos,
                            idempotency_key=idempotency_key,
                            trace_id=fjob.trace_id,
                            tenant=tenant,
                            priority=priority,
                            deadline_s=deadline_s,
                            symmetry=symmetry,
                        )
                        device = woken
                    except AdmissionError as e:
                        rejections.append(e)
            if pool_job is None and not rejections:
                # No healthy device at all: the last resort. Host engine
                # on the least-loaded ALIVE pool — degradation only when
                # EVERY device is open/lost, never as the first response.
                alive = sorted(self._alive_devices(), key=self._pool_load)
                if not alive:
                    raise self._reject(
                        fjob, AdmissionError("no devices left in the fleet")
                    )
                try:
                    pool_job = self.pools[alive[0]].submit(
                        spec,
                        max_seconds=max_seconds,
                        max_states=max_states,
                        chaos=chaos,
                        idempotency_key=idempotency_key,
                        engine="host",
                        trace_id=fjob.trace_id,
                        tenant=tenant,
                        priority=priority,
                        deadline_s=deadline_s,
                        symmetry=symmetry,
                    )
                    device = alive[0]
                    forced_host = True
                except AdmissionError as e:
                    rejections.append(e)
            if pool_job is None:
                hinted = [
                    e for e in rejections if e.retry_after_s is not None
                ]
                if hinted:
                    best = min(hinted, key=lambda e: e.retry_after_s)
                    err: AdmissionError = AdmissionError(
                        f"all devices rejected: {best.reason}",
                        retry_after_s=best.retry_after_s,
                    )
                else:
                    err = rejections[0] if rejections else AdmissionError(
                        "no devices accepted the job"
                    )
                raise self._reject(fjob, err)
        except AdmissionError:
            raise  # already unwound through _reject above
        except BaseException as e:
            # A non-admission failure (malformed-spec ValueError from
            # registry.parse, RuntimeError from a concurrently-closing
            # pool) must not leak the reserved handle as a permanently-
            # queued zombie: unwind it — the key stays retryable, any
            # deduped waiter settles — and re-raise the original.
            self._reject(fjob, AdmissionError(
                f"submit failed: {type(e).__name__}: {e}"
            ))
            raise
        lost_inj = chaos_mod.fire("device.lost")
        with self._lock:
            fjob.device = device
            fjob.pool_job = pool_job
            self._counters.inc("admitted")
            self._counters.inc("routed")
            if forced_host:
                self._counters.inc("host_last_resort")
            if flaky_inj is not None:
                self._counters.inc("device_flakes")
            self._jlog(
                "routed", job=fjob.id, spec=spec, device=device,
                pool_job=pool_job.id, idempotency_key=idempotency_key,
                host=forced_host or None,
                trace_id=fjob.trace_id,
                tenant=tenant, priority=priority, deadline_s=deadline_s,
                symmetry=symmetry,
            )
            landed_lost = device in self._lost
        if self._tracer.enabled:
            self._tracer.emit(
                "route",
                t0=time.monotonic(),
                dur=0.0,
                attrs={
                    "job": fjob.id, "spec": spec,
                    "device": self._device_label(device),
                    "pool_job": pool_job.id,
                    "host": bool(forced_host),
                },
                trace_id=fjob.trace_id,
            )
        if landed_lost and not forced_host:
            # device_lost ran while we were routing (its evacuation
            # sweep predates this placement): evacuate again so the
            # monitor migrates the just-landed job too, instead of
            # leaving it to wedge on the dead device.
            self.pools[device].evacuate(reason=f"device-{device} lost")
            self._wake.set()
        self._ensure_monitor()
        if lost_inj is not None:
            target = int(lost_inj.get("device", device))
            after_s = float(lost_inj.get("after_s", 1))
            self.log(
                f"chaos device.lost armed: device-{target} in {after_s}s"
            )
            timer = threading.Timer(after_s, self.device_lost, args=(target,))
            timer.daemon = True
            with self._lock:
                # Prune fired/cancelled timers so a long chaos soak
                # doesn't accumulate one dead Timer per loss.
                self._timers = [
                    t for t in self._timers if t.is_alive()
                ] + [timer]
            timer.start()
        return fjob

    def _reject(self, fjob: FleetJob, err: AdmissionError) -> AdmissionError:
        """Unwind a reserved-but-unplaced submission: unregister the
        handle (the caller may retry the key) and mark it terminal-failed
        so a concurrent waiter that deduped onto it mid-routing settles
        instead of polling forever. Returns ``err`` for the caller to
        raise."""
        with self._lock:
            self._counters.inc("rejected")
            self._jobs.pop(fjob.id, None)
            try:
                self._order.remove(fjob.id)
            except ValueError:
                pass
            key = fjob.idempotency_key
            if key is not None and self._idem.get(key) == fjob.id:
                del self._idem[key]
            fjob._rejected = getattr(err, "reason", None) or str(err)
        return err

    # -- failover ----------------------------------------------------------

    def device_lost(self, i: int) -> None:
        """Declare device ``i`` dead (the operator's — and the chaos
        layer's — entry point): its pool's workers are killed, its
        non-terminal jobs evacuate, and the monitor migrates them to
        healthy siblings. The pool object stays constructed so its
        terminal jobs remain queryable; routing never picks it again
        this incarnation (a restart re-probes all devices fresh)."""
        with self._lock:
            if self._closed or i in self._lost or not (
                0 <= i < len(self.pools)
            ):
                return
            self._lost.add(i)
            self._counters.inc("devices_lost")
        self.log(f"device-{i} LOST; evacuating its jobs")
        self.pools[i].evacuate(reason=f"device-{i} lost")
        self._ensure_monitor()
        self._wake.set()

    def _migrate_stragglers(self) -> int:
        """The repair pass (monitor loop + restart): every fleet job whose
        current pool job reads ``migrated`` is resubmitted to a healthy
        sibling, seeded with the victim's checkpoint rotation and spent
        wall-clock — and every recovered job a restart could NOT
        re-attach (orphaned: torn/lost pool journal, smaller fleet)
        re-routes from its journaled spec, or fails typed when even that
        is gone, so waiters never poll forever. Returns how many moved."""
        moved = 0
        with self._lock:
            pending = [
                fjob for fjob in self._jobs.values()
                if (
                    fjob.pool_job is not None
                    and fjob.pool_job.status == "migrated"
                )
                or (
                    fjob.pool_job is None
                    and fjob.recovered
                    and fjob._rejected is None
                )
            ]
        for fjob in pending:
            old = fjob.pool_job
            from_device = fjob.device
            if old is not None:
                seed = None
                if old.dir is not None:
                    seed = latest_valid_checkpoint(old.checkpoint_path)
                if seed is None:
                    # migrated twice before running
                    seed = old.seed_checkpoint
                spec = old.spec
                resume_kwargs = dict(
                    max_seconds=old.max_seconds,
                    max_states=old.max_states,
                    chaos=dict(old.chaos) or None,
                    spent_s=old.consumed_s,
                    resume_from=seed,
                    # Migration keeps the victim's trace: the new hop's
                    # spans stitch onto the same timeline.
                    trace_id=fjob.trace_id or old.trace_id,
                    # ... and its QoS identity: the new hop schedules in
                    # the same class under the same tenant's quotas.
                    tenant=old.tenant,
                    priority=old.priority,
                    deadline_s=old.deadline_s,
                    symmetry=old.symmetry,
                )
                reason = old.error
                requeues = old.requeues
            else:
                # Orphaned recovery: the victim pool's copy is gone, so
                # budgets/chaos/checkpoints died with it — re-route the
                # journaled spec from scratch on pool defaults.
                spec = fjob._orphan_spec
                if spec is None:
                    with self._lock:
                        fjob._rejected = (
                            "unrecoverable after fleet restart: the "
                            "routed spec was lost with the pool journal"
                        )
                    continue
                seed = None
                resume_kwargs = dict(
                    tenant=fjob.tenant,
                    priority=fjob.priority,
                    deadline_s=fjob.deadline_s,
                    symmetry=fjob.symmetry,
                )
                if fjob.trace_id:
                    resume_kwargs["trace_id"] = fjob.trace_id
                reason = "orphaned by fleet restart"
                requeues = 0
            healthy = sorted(
                self._healthy_devices(),
                key=lambda d: self._route_load(
                    d, resume_kwargs.get("priority")
                ),
            )
            if not healthy and self._wake_for_pressure() is not None:
                # Migrating onto a woken elastic pool beats forcing the
                # host engine.
                healthy = sorted(
                    self._healthy_devices(),
                    key=lambda d: self._route_load(
                        d, resume_kwargs.get("priority")
                    ),
                )
            candidates = healthy or sorted(
                self._alive_devices(), key=self._pool_load
            )
            if not candidates:
                continue  # nothing to move to; retry next sweep
            target = candidates[0]
            forced_host = not healthy
            try:
                new_job = self.pools[target].submit(
                    spec,
                    engine="host" if forced_host else "auto",
                    # Deterministic per-hop key: a fleet crash between
                    # the sibling's `submitted` append and our
                    # `migrated` append leaves the resubmission findable
                    # — the restart's _recover re-attaches it by this
                    # key instead of double-running (and a same-target
                    # retry in THIS incarnation dedupes at the pool).
                    idempotency_key=(
                        f"fleet-mig:{fjob.id}:{len(fjob.migrations) + 1}"
                    ),
                    **resume_kwargs,
                )
            except AdmissionError as e:
                self.log(f"migration of {fjob.id} to device-{target} "
                         f"rejected ({e.reason}); will retry")
                continue
            except RuntimeError:
                return moved  # target pool closing: the fleet is too
            except Exception as e:  # noqa: BLE001 - the verdict IS the handling
                # Unroutable (e.g. a journaled spec whose user family
                # isn't registered in this incarnation): a retry would
                # throw identically — fail typed so waiters settle
                # instead of the sweep dying and stalling every other
                # pending migration.
                with self._lock:
                    fjob._rejected = (
                        f"migration failed: {type(e).__name__}: {e}"
                    )
                self.log(f"{fjob.id} unroutable: {e!r}")
                continue
            with self._lock:
                fjob.migrations.append(
                    {
                        "from": from_device,
                        "to": target,
                        "reason": reason,
                        "requeues": requeues,
                        "seed": seed,
                        "unix_ts": time.time(),
                    }
                )
                fjob.device = target
                fjob.pool_job = new_job
                self._counters.inc("migrations")
                if forced_host:
                    self._counters.inc("host_last_resort")
                self._jlog(
                    "migrated", job=fjob.id, from_device=from_device,
                    to_device=target, pool_job=new_job.id,
                    reason=reason, seed=seed,
                    trace_id=fjob.trace_id,
                )
                landed_lost = target in self._lost
            if self._tracer.enabled:
                self._tracer.emit(
                    "migrate",
                    t0=time.monotonic(),
                    dur=0.0,
                    attrs={
                        "job": fjob.id,
                        "from_device": self._device_label(from_device)
                        if from_device is not None else None,
                        "device": self._device_label(target),
                        "pool_job": new_job.id,
                        "reason": reason,
                    },
                    trace_id=fjob.trace_id,
                )
            if landed_lost and not forced_host:
                # The target died while we migrated onto it: evacuate
                # again — the next sweep moves the job once more.
                self.pools[target].evacuate(
                    reason=f"device-{target} lost"
                )
                self._wake.set()
            self.log(
                f"{fjob.id} migrated device-{from_device} -> "
                f"device-{target} (seed={seed})"
            )
            moved += 1
        return moved

    def _monitor_loop(self) -> None:
        while True:
            self._wake.wait(timeout=self._cfg.monitor_interval_s)
            self._wake.clear()
            with self._lock:
                if self._closed:
                    return
            # Open breakers on non-lost devices: evacuate so the repair
            # pass can move their held jobs to healthy silicon. Skip when
            # NOTHING is healthy — with every breaker open the held jobs
            # are better off waiting for a probe-close than thrashing
            # into host-forced churn (host last resort applies to NEW
            # work; queued work migrates only when a healthy target
            # exists).
            try:
                healthy = self._healthy_devices()
                if healthy:
                    for i in self._alive_devices():
                        if i in healthy:
                            continue
                        pool = self.pools[i]
                        if pool.degraded and any(
                            j.kind == "batch" and not j.done
                            # Forced-host jobs ride out the outage in
                            # place (evacuate() skips them —
                            # device-independent).
                            and j.engine_force != "host"
                            for j in pool.jobs()
                        ):
                            self.log(
                                f"device-{i} breaker open; "
                                "evacuating its jobs"
                            )
                            pool.evacuate(reason=f"device-{i} breaker open")
                self._migrate_stragglers()
                if self._cfg.elastic:
                    self._elastic_sweep()
            except Exception as e:  # noqa: BLE001 - monitor must survive
                # A dead monitor stalls every pending migration and
                # hangs waiters; log the sweep's failure and keep going.
                self.log(f"fleet monitor sweep failed: {e!r}")
            with self._lock:
                if self._closed:
                    return
                # Idle exit: every fleet job terminal, nothing pending —
                # don't sweep every pool's locks forever on a long-lived
                # Explorer fleet. Clearing _monitor under the lock makes
                # the handoff race-free: submit()/device_lost()/an open-
                # breaker listener re-ensure a fresh monitor, and a job
                # inserted before this check reads as not-done.
                # (Field reads, not FleetJob.done — the property takes
                # this very lock through _current().)
                if (
                    all(
                        j._rejected is not None
                        or (
                            j.pool_job is not None
                            and j.pool_job.status in ("done", "failed")
                        )
                        for j in self._jobs.values()
                    )
                    and not self._wake.is_set()
                    # An elastic fleet keeps sweeping until the idle
                    # pools have quiesced down to min_active — only then
                    # is there nothing left for the monitor to do.
                    and (
                        not self._cfg.elastic
                        or len([
                            i for i in range(len(self.pools))
                            if i not in self._lost
                            and i not in self._quiesced
                        ]) <= max(1, self._cfg.min_active)
                    )
                ):
                    self._monitor = None
                    return

    # -- surface (mirrors CheckerService) ----------------------------------

    def job(self, fleet_id: str) -> FleetJob:
        return self._jobs[fleet_id]

    def jobs(self) -> List[FleetJob]:
        with self._lock:
            return [self._jobs[fid] for fid in self._order]

    def wait_all(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        for fjob in self.jobs():
            remaining = (
                None if deadline is None else deadline - time.monotonic()
            )
            if remaining is not None and remaining <= 0:
                return all(j.done for j in self.jobs())
            if not fjob.wait(timeout=remaining):
                return False
        return True

    @property
    def degraded(self) -> bool:
        """True when NO device is healthy (every breaker open or device
        lost) — the fleet-level analogue of a pool's open breaker."""
        return not self._healthy_devices()

    def gauges(self) -> Dict[str, Any]:
        """Fleet-wide aggregates at the top level (the dashboard header
        and ``/.status``'s ``pool`` read these like a single pool's),
        per-device pool gauges under ``devices``."""
        devices = {
            self._device_label(i): dict(
                pool.gauges(),
                lost=(i in self._lost),
                quiesced=(i in self._quiesced),
            )
            for i, pool in enumerate(self.pools)
        }
        # Fleet-wide per-class/per-tenant rollup: count keys sum across
        # devices; weight is a config constant, taken from any row.
        qos_classes: Dict[str, Dict[str, Any]] = {}
        qos_tenants: Dict[str, Dict[str, Any]] = {}
        for d in devices.values():
            qos = d.get("qos") or {}
            for cls, row in (qos.get("classes") or {}).items():
                agg = qos_classes.setdefault(
                    cls, {"weight": row.get("weight")}
                )
                for k in ("queued", "running", "quarantined", "done",
                          "failed", "migrated", "served"):
                    agg[k] = agg.get(k, 0) + (row.get(k) or 0)
            for tenant, row in (qos.get("tenants") or {}).items():
                agg = qos_tenants.setdefault(tenant, {})
                for k in ("queued", "running", "done", "failed",
                          "spent_s"):
                    agg[k] = agg.get(k, 0) + (row.get(k) or 0)
        agg_keys = (
            "queued", "running", "quarantined", "interactive", "done",
            "failed", "migrated", "jobs_done", "jobs_failed",
            "wedge_verdicts", "crashes", "requeues", "degraded_jobs",
            "jobs_evacuated",
        )
        out: Dict[str, Any] = {
            k: sum(d.get(k, 0) or 0 for d in devices.values())
            for k in agg_keys
        }
        healthy = self._healthy_devices()
        with self._lock:
            out.update(
                fleet=True,
                devices=devices,
                device_count=len(self.pools),
                healthy_devices=len(healthy),
                lost_devices=sorted(self._lost),
                quiesced_devices=sorted(self._quiesced),
                elastic=self._cfg.elastic,
                qos={"classes": qos_classes, "tenants": qos_tenants},
                breaker={
                    # The fleet-level verdict the dashboard badge renders:
                    # open only when NO device can take device work.
                    "state": "closed" if healthy else "open",
                    "open_devices": [
                        self._device_label(i)
                        for i in range(len(self.pools))
                        if i in self._lost or self.pools[i].degraded
                    ],
                    "k": len(self.pools),
                    "consecutive_wedges": max(
                        (
                            d["breaker"]["consecutive_wedges"]
                            for d in devices.values()
                        ),
                        default=0,
                    ),
                    "opened_unix_ts": None,
                },
                journal=(
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
            )
        return out

    def metrics(self) -> Dict[str, Any]:
        out = self.gauges()
        # Collect under the lock, snapshot outside it: FleetJob.snapshot
        # re-reads its placement through the fleet lock (non-reentrant).
        with self._lock:
            ordered = [(fid, self._jobs[fid]) for fid in self._order]
        out["jobs"] = {fid: fjob.snapshot() for fid, fjob in ordered}
        return out

    # -- per-job telemetry (Explorer endpoints) ----------------------------

    def _pool_of(self, fleet_id: str):
        fjob = self._jobs[fleet_id]  # KeyError -> 404, like a pool
        with self._lock:
            if fjob.pool_job is None or fjob.device is None:
                raise KeyError(fleet_id)
            return self.pools[fjob.device], fjob.pool_job

    def job_trace_chrome(self, fleet_id: str,
                         out_path: Optional[str] = None) -> Optional[str]:
        pool, job = self._pool_of(fleet_id)
        return pool.job_trace_chrome(job.id, out_path)

    @property
    def run_dir(self) -> str:
        return self._cfg.run_dir

    def merged_trace_chrome(self, out_path: Optional[str] = None) -> Optional[str]:
        """The fleet-wide merged timeline: ``obs.collect`` over the fleet
        run dir — the router's spans, every device pool's, every
        job/lane's — one Chrome trace with flow arrows across routing,
        attempts, and migration hops. Mtime-cached; the Explorer's
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

    def job_metrics_series(self, fleet_id: str,
                           window: Optional[int] = None):
        pool, job = self._pool_of(fleet_id)
        return pool.job_metrics_series(job.id, window=window)

    # -- interactive sessions (the Explorer client surface) ----------------

    def _session_counts(self) -> int:
        return sum(p.gauges()["interactive"] for p in self.pools)

    def _session_cap(self) -> int:
        if self._cfg.max_sessions is not None:
            return self._cfg.max_sessions
        return sum(p._cfg.max_sessions for p in self.pools)

    def _check_session_capacity_locked(self) -> None:
        """Caller holds ``_session_lock``."""
        if self._session_counts() >= self._session_cap():
            with self._lock:
                self._counters.inc("submitted")
                self._counters.inc("rejected")
            raise AdmissionError(
                f"interactive sessions full ({self._session_cap()})",
                retry_after_s=30.0,
            )
        # The chosen pool's own pre-check still applies at registration.

    def check_session_capacity(self) -> None:
        with self._session_lock:
            self._check_session_capacity_locked()

    def register_interactive(self, checker, *,
                             label: Optional[str] = None,
                             degraded: bool = False) -> Job:
        """Sessions spread to the alive pool with the fewest of them (an
        in-process checker holds no pool's device, but per-device
        accounting keeps ``/.pool`` honest). Cap
        re-check and registration happen under one lock: two concurrent
        registrations must not both pass an N-1 count and land N+1
        sessions."""
        with self._session_lock:
            self._check_session_capacity_locked()
            candidates = self._alive_devices() or [0]
            target = min(
                candidates,
                key=lambda i: self.pools[i].gauges()["interactive"],
            )
            job = self.pools[target].register_interactive(
                checker, label=label, degraded=degraded
            )
            with self._lock:
                # Mirror the cap-rejection path's accounting (which incs
                # submitted+rejected): without these the fleet counters
                # read >100% session rejection rates.
                self._counters.inc("submitted")
                self._counters.inc("admitted")
            return job

    def release_interactive(self, job: Job) -> None:
        job._service.release_interactive(job)
