#!/usr/bin/env python
"""Chaos/load harness for the port's durable CheckerService and FleetService.

Counterpart of the JAX package's ``tools/service_chaos.py``, with the same
schedules, fault plans, scenarios, invariant and SLO line: ``build_schedule``
and ``fault_plan`` are the same pure functions of the seed, so one seed
drives the same submissions and faults through either package
(``tests/test_torch_service_chaos.py``). It drives ONE pool (or, with
``--fleet N``, a fleet of N pools), run in a killable child process,
through a seeded schedule of concurrent submissions, injected faults
(``chaos.py``), service SIGKILLs and restarts over the same run dir, then
checks the invariant that matters:

    every admitted job eventually completes EXACTLY ONCE, with
    generated/unique/discovery counts equal to an undisturbed run of the
    same schedule.

and reports admission latency, Retry-After accuracy and p50/p99 job
turnaround as one JSON line on stdout, also written atomically to
``--out`` (default ``runs/service_chaos_torch.json``).

Scenarios (``--scenario``):

- ``baseline``  -- undisturbed run; its per-spec counts are the ground
  truth the others compare against (it always runs first).
- ``kill``      -- SIGKILL the service's process group at a seeded
  wall-clock point, restart over the same run dir (resubmitting the whole
  schedule under the same idempotency keys), up to ``--max-restarts``.
- ``die``       -- the first incarnation carries ``journal.die@n=K``
  (SIGKILL itself right after the K-th journal record).
- ``torn``      -- like ``die`` but ``journal.torn@n=K``: the crash lands
  mid-append, leaving a torn journal tail the restart recovers from.
- ``device_lost`` (``--fleet N``) -- ``device.lost@n=K`` kills ONE device's
  pool mid-schedule: its jobs migrate and complete exactly once on the
  surviving devices, equal to the baseline.
- ``storm`` (``--tenants N``) -- ``tenant.storm`` bursts one tenant's
  submissions mid-schedule, with a SIGKILL and restart while it runs.
- ``mux`` (``--mux K``) -- K same-spec jobs through a ``mux_k=K`` pool,
  every member armed to SIGKILL the shared group process once; each must
  requeue solo, resume from its own lane checkpoints and complete exactly
  once, equal to a mux-off baseline it runs first.
- ``all``       -- baseline + kill + torn (+ device_lost with ``--fleet``,
  + storm with ``--tenants``, + mux with ``--mux``).

Fleet mode (``--fleet N``): the serve child fronts N per-device pools
through :class:`FleetService` behind the same submit/wait_all surface; the
SLO line gains a ``fleet`` dict (device count, migrations, p50/p99
turnaround per device). ``--sessions N`` adds N concurrent interactive
sessions through ``register_interactive`` polling ``ExplorerApp.status()``.

Devices: ``--platform default`` (the default) runs the pools' workers on
the card, ``--platform cpu`` on the CPU. The parent and the serve child
never touch the card; model work happens in the service's workers.

Reproducibility: the fault schedule (submission order and delays, kill
point, torn/die record index) is a pure function of ``--seed``.
``--check-repro`` runs the schedule twice serially (``max_inflight=1``)
through fresh run dirs and compares the two journals' event sequences
(event names and job ids).

Usage::

    python -m stateright_tpu_torch.tools.service_chaos --platform cpu --seed 42
    python -m stateright_tpu_torch.tools.service_chaos --platform cpu --fleet 2 \
        --scenario device_lost
    python -m stateright_tpu_torch.tools.service_chaos --seed 7 --check-repro
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RUNS = os.path.join(REPO, "runs")
#: The module the serve child re-executes (``python -m``).
MODULE = "stateright_tpu_torch.tools.service_chaos"

#: The schedule's spec pool: tiny shipped models (seconds per worker)
#: with exact full-coverage counts.
SPEC_POOL = ("2pc:3", "increment-lock:3", "abd:2")

RESULT_KEYS = ("generated", "unique", "max_depth", "discoveries")


def log(msg: str) -> None:
    print(f"[service_chaos] {msg}", file=sys.stderr, flush=True)


# --------------------------------------------------------------------------
# Seeded schedule
# --------------------------------------------------------------------------


def build_schedule(
    seed: int, jobs: int, max_seconds: float, tenants: int = 0
) -> Dict[str, Any]:
    """The seeded submission schedule: pure function of
    (seed, jobs, tenants). With ``tenants`` > 0 every entry carries a
    seeded tenant id and priority class (mixed interactive/batch/
    best_effort traffic; interactive entries get deadlines) — the QoS
    tier's load shape."""
    import random

    rng = random.Random(seed)
    entries = []
    for i in range(jobs):
        entry = {
            "idem": f"chaos-{seed}-{i}",
            "spec": rng.choice(SPEC_POOL),
            "delay_s": round(rng.uniform(0.0, 1.5), 3),
            "max_seconds": max_seconds,
        }
        if tenants:
            entry["tenant"] = f"t{rng.randrange(tenants)}"
            draw = rng.random()
            if draw < 0.3:
                entry["priority"] = "interactive"
                entry["deadline_s"] = round(rng.uniform(60.0, 180.0), 3)
            elif draw < 0.7:
                entry["priority"] = "batch"
            else:
                entry["priority"] = "best_effort"
        entries.append(entry)
    return {"seed": seed, "tenants": tenants or None, "jobs": entries}


def fault_plan(seed: int, scenario: str) -> Dict[str, Any]:
    """The seeded fault schedule for one scenario (reported in the SLO
    line so a rerun is auditable). crc32, not hash(): the builtin is
    PYTHONHASHSEED-randomized per process, which would silently break
    the cross-run reproducibility this function promises."""
    import random
    import zlib

    rng = random.Random((seed << 8) ^ zlib.crc32(scenario.encode()))
    if scenario == "kill":
        return {"kill_after_s": round(rng.uniform(2.0, 9.0), 3)}
    if scenario == "die":
        return {"die_at_record": rng.randint(3, 10)}
    if scenario == "torn":
        return {"torn_at_record": rng.randint(3, 10)}
    if scenario == "device_lost":
        # Which routing decision arms the loss, and how long after it
        # the device dies (mid-job for any spec in the pool).
        return {
            "lost_at_route": rng.randint(1, 2),
            "lost_after_s": round(rng.uniform(1.0, 4.0), 3),
        }
    if scenario == "storm":
        # Which scheduled submission triggers the tenant storm, the
        # burst size, and the mid-storm SIGKILL point (kill + restart
        # with the storm in flight).
        return {
            "storm_at_submit": rng.randint(1, 2),
            "storm_rate": rng.randint(4, 8),
            "kill_after_s": round(rng.uniform(2.0, 9.0), 3),
        }
    return {}


# --------------------------------------------------------------------------
# Serve mode: one service incarnation in THIS process (run as a child)
# --------------------------------------------------------------------------


def serve(args: argparse.Namespace) -> int:
    """One service incarnation: recover (if the run dir has a journal),
    resubmit the whole schedule idempotently, wait for every job, write
    driver_results.json. Killable at any instant — that is the point.
    With ``--fleet N`` the incarnation fronts N per-device pools through
    FleetService behind the same surface."""
    from stateright_tpu_torch.service import (
        CheckerService,
        FleetConfig,
        FleetService,
        ServiceConfig,
    )

    with open(args.schedule) as fh:
        schedule = json.load(fh)
    cfg = ServiceConfig(
        run_dir=args.run_dir,
        platform=args.platform,
        # Batched scheduling: the mux scenario's incarnations
        # run the pool with mux_k=K so same-spec members fold into one
        # worker.py --mux group.
        mux_k=args.mux or None,
        max_inflight=args.max_inflight,
        max_queue=max(8, len(schedule["jobs"]) + 2),
        # Every restart recovery compacts once (one rotation per
        # incarnation); the exactly-once audit (check_invariant) reads
        # the FULL event history across rotations, so the keep bound
        # must out-last the restart loop (max_restarts <= 4) or early
        # incarnations' completed events would rotate away and read as
        # false invariant failures.
        journal_keep=12,
        stall_s=8.0,
        startup_grace_s=240.0,
        poll_s=0.2,
        backoff_s=0.1,
        probe_auto=False,
        admission_lint=False,
        chaos=args.chaos or None,
    )
    if args.fleet:
        svc = FleetService(FleetConfig(
            run_dir=args.run_dir,
            devices=args.fleet,
            monitor_interval_s=0.3,
            journal_keep=12,
            chaos=args.chaos or None,
            # The pool template: per-device run dirs/devices/halt mode
            # are overwritten per pool; the chaos plan installs ONCE at
            # the fleet level.
            pool=dataclasses.replace(cfg, chaos=None),
        ))
    else:
        svc = CheckerService(cfg)
    svc.log = log
    sessions = (
        _session_swarm(svc, args.sessions, args.run_dir)
        if args.sessions
        else None
    )
    stats_path = os.path.join(args.run_dir, "admission_stats.jsonl")
    t0 = time.monotonic()
    jobs = []
    with open(stats_path, "a") as stats:
        for entry in schedule["jobs"]:
            delay = entry["delay_s"] - (time.monotonic() - t0)
            if delay > 0:
                time.sleep(delay)
            t = time.monotonic()
            job, retries = _submit_with_retry(svc, entry)
            stats.write(
                json.dumps(
                    {
                        "idem": entry["idem"],
                        "job": job.id,
                        "latency_ms": round(
                            (time.monotonic() - t) * 1e3, 3
                        ),
                        "deduped": job.recovered,
                        "priority": entry.get("priority"),
                        "tenant": entry.get("tenant"),
                        "admission_retries": retries,
                    }
                )
                + "\n"
            )
            stats.flush()
            jobs.append((entry, job))
            # Seeded tenant storm (chaos point tenant.storm):
            # fires per scheduled submission; admitted burst members
            # join the waited set (exactly-once audited), shed members
            # record their typed rejection + hint.
            storm = _chaos_fire("tenant.storm")
            if storm is not None:
                _storm_burst(svc, schedule, storm, stats, jobs)
    retry_stats = (
        _overload_probe(svc, schedule) if args.overload else None
    )
    if not svc.wait_all(timeout=args.wait_s):
        log(f"wait_all timed out after {args.wait_s}s: {svc.gauges()}")
        if sessions is not None:
            # Stop the swarm BEFORE teardown: its threads must not race
            # a closing service, and the aggregate stats row flushes so
            # the timed-out incarnation still reports its sessions SLO.
            sessions.stop()
        svc.close()
        return 4
    session_stats = sessions.stop() if sessions is not None else None
    out = {
        "jobs": {
            entry["idem"]: {
                "id": job.id,
                "spec": entry["spec"],
                "status": job.status,
                "error": job.error,
                "recovered": job.recovered,
                "requeues": job.requeues,
                "result": (
                    {k: job.result.get(k) for k in RESULT_KEYS}
                    if job.result
                    else None
                ),
            }
            for entry, job in jobs
        },
        "gauges": svc.gauges(),
        "retry_after": retry_stats,
        "sessions": session_stats,
    }
    svc.close()
    # The serve process itself never touches the card: only its workers do.
    torch = sys.modules.get("torch")
    out["cuda_initialized"] = bool(torch is not None and torch.cuda.is_initialized())
    tmp = os.path.join(args.run_dir, "driver_results.json.tmp")
    with open(tmp, "w") as fh:
        json.dump(out, fh, indent=1)
    os.replace(tmp, os.path.join(args.run_dir, "driver_results.json"))
    return 0


def _chaos_fire(point: str):
    from stateright_tpu_torch import chaos as chaos_mod

    return chaos_mod.fire(point)


def _submit_with_retry(svc, entry: Dict[str, Any], max_tries: int = 30):
    """Submit one scheduled entry, honoring typed Retry-After rejections
    (shedding under a storm is the QoS tier WORKING — the scheduled set
    still has to land eventually for the exactly-once audit). Returns
    (job, retries). A hint-less rejection (budget/lint) re-raises:
    retrying it would fail identically."""
    from stateright_tpu_torch.service import AdmissionError

    tries = 0
    while True:
        try:
            return svc.submit(
                entry["spec"],
                max_seconds=entry["max_seconds"],
                idempotency_key=entry["idem"],
                # Per-job worker sabotage (the mux scenario arms its
                # members directly; absent everywhere else).
                chaos=entry.get("chaos"),
                tenant=entry.get("tenant", "default"),
                priority=entry.get("priority", "batch"),
                deadline_s=entry.get("deadline_s"),
            ), tries
        except AdmissionError as e:
            tries += 1
            if e.retry_after_s is None or tries >= max_tries:
                raise
            time.sleep(min(e.retry_after_s, 5.0))


def _storm_burst(svc, schedule, storm, stats, jobs) -> None:
    """One fired ``tenant.storm``: burst ``rate`` same-tenant
    submissions in one class through the live service. Deterministic
    idempotency keys make a restarted incarnation's re-fired storm
    dedupe onto the journal-replayed jobs instead of double-submitting."""
    from stateright_tpu_torch.service import AdmissionError

    rate = int(storm.get("rate", 5))
    tenant = str(storm.get("tenant", "storm"))
    priority = str(storm.get("class", "best_effort"))
    first = schedule["jobs"][0]
    seed = schedule.get("seed", 0)
    for s in range(rate):
        idem = f"storm-{seed}-{s}"
        t = time.monotonic()
        row: Dict[str, Any] = {
            "idem": idem, "tenant": tenant, "priority": priority,
            "storm": True,
        }
        try:
            job = svc.submit(
                first["spec"],
                max_seconds=first["max_seconds"],
                idempotency_key=idem,
                tenant=tenant,
                priority=priority,
            )
            row.update(
                job=job.id,
                latency_ms=round((time.monotonic() - t) * 1e3, 3),
                deduped=job.recovered,
            )
            jobs.append(({"idem": idem, "spec": first["spec"]}, job))
        except AdmissionError as e:
            row.update(
                shed=True, reason=e.reason, retry_after_s=e.retry_after_s
            )
        stats.write(json.dumps(row) + "\n")
        stats.flush()


class _SessionChecker:
    """A stand-in for an interactive checker: just enough surface for
    ``register_interactive`` + ``ExplorerApp.status()`` -- the load swarm
    measures the SERVICE's admission/status path, not an engine (the
    serve child must stay off the card and killable in under a second)."""

    class _Model:
        def properties(self):
            return []

    def model(self):
        return self._Model()

    def is_done(self):
        return False

    def state_count(self):
        return 0

    def unique_state_count(self):
        return 0

    def max_depth(self):
        return 0

    def discoveries(self):
        return {}

    def metrics(self):
        return {"engine": "session", "job_id": getattr(self, "job_id", None)}

    def attach_job(self, job_id):
        self.job_id = job_id


class _SessionSwarm:
    """N concurrent interactive sessions (ROADMAP 3(c')): each thread
    registers through the real admission path (``AdmissionError`` past
    the cap counts as a rejection, retried after a backoff) and polls
    the real ``ExplorerApp.status()`` handler until stopped. Stats are
    appended live to ``session_stats.jsonl`` so a SIGKILL loses
    nothing."""

    def __init__(self, svc, n: int, run_dir: str):
        self._svc = svc
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.admitted = 0
        self.rejected = 0
        self.polls = 0
        self.poll_ms: List[float] = []
        self._path = os.path.join(run_dir, "session_stats.jsonl")
        self._threads = [
            threading.Thread(target=self._run, args=(i,), daemon=True)
            for i in range(n)
        ]
        for t in self._threads:
            t.start()

    def _run(self, i: int) -> None:
        from stateright_tpu_torch.checker.explorer import ExplorerApp
        from stateright_tpu_torch.service import AdmissionError

        while not self._stop.is_set():
            checker = _SessionChecker()
            try:
                job = self._svc.register_interactive(
                    checker, label=f"session-{i}"
                )
            except AdmissionError:
                with self._lock:
                    self.rejected += 1
                self._stop.wait(0.5)
                continue
            except RuntimeError:
                return  # service closed
            with self._lock:
                self.admitted += 1
            app = ExplorerApp(checker, service=self._svc, job=job)
            try:
                # Poll /.status (the handler itself, no socket) for a
                # while, then release the slot so capped siblings admit.
                for _ in range(20):
                    if self._stop.is_set():
                        break
                    t = time.monotonic()
                    app.status()
                    with self._lock:
                        self.polls += 1
                        self.poll_ms.append(
                            round((time.monotonic() - t) * 1e3, 3)
                        )
                    self._stop.wait(0.1)
            finally:
                app.close()
                # Live append: each session lifecycle flushes the
                # running aggregate, so a SIGKILLed incarnation's last
                # row still carries (nearly) everything it measured.
                self._append(self._row())

    def _row(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "sessions": len(self._threads),
                "admitted": self.admitted,
                "rejected": self.rejected,
                "status_polls": self.polls,
                "status_poll_ms": _percentiles(list(self.poll_ms)),
            }

    def _append(self, row: Dict[str, Any]) -> None:
        try:
            with open(self._path, "a") as fh:
                fh.write(json.dumps(row) + "\n")
        except OSError:
            pass

    def stop(self) -> Dict[str, Any]:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10.0)
        stats = self._row()
        self._append(stats)
        return stats


def _session_swarm(svc, n: int, run_dir: str) -> _SessionSwarm:
    return _SessionSwarm(svc, n, run_dir)


def _overload_probe(svc, schedule) -> Dict[str, Any]:
    """Retry-After accuracy: push the queue past its cap, record the
    typed hint, retry after (a capped fraction of) it — ``accurate``
    counts hints that were sufficient. Probed per class: the
    ``best_effort`` burst hits the QoS tier's shed threshold first
    so its hint is the measured-drain Retry-After the
    shedding path computes; the ``batch`` burst reproduces the legacy
    queue-pressure path. Legacy top-level keys mirror the batch row."""
    from stateright_tpu_torch.service import AdmissionError

    spec = schedule["jobs"][0]["spec"]
    max_seconds = schedule["jobs"][0]["max_seconds"]
    # Queue capacity: the pool cap, or (fleet) the per-device cap summed
    # — the burst must out-size whatever can absorb it.
    cap = getattr(svc._cfg, "max_queue", None)
    if cap is None:
        cap = sum(p._cfg.max_queue for p in svc.pools)
    out: Dict[str, Any] = {"classes": {}}
    for cls in ("best_effort", "batch"):
        observed = accurate = 0
        hints: List[float] = []
        shed = False
        for i in range(cap + 2):
            try:
                svc.submit(spec, max_seconds=max_seconds, priority=cls)
            except AdmissionError as e:
                if e.retry_after_s is None:
                    continue
                observed += 1
                hints.append(e.retry_after_s)
                shed = "shedding" in (e.reason or "")
                time.sleep(min(e.retry_after_s, 15.0))
                try:
                    svc.submit(
                        spec, max_seconds=max_seconds, priority=cls
                    )
                    accurate += 1
                except AdmissionError:
                    pass
                break
        out["classes"][cls] = {
            "observed": observed, "accurate": accurate,
            "hints_s": hints, "shed": shed,
        }
    out.update(
        observed=out["classes"]["batch"]["observed"],
        accurate=out["classes"]["batch"]["accurate"],
        hints_s=out["classes"]["batch"]["hints_s"],
    )
    return out


# --------------------------------------------------------------------------
# Parent: incarnation driver + invariant checks
# --------------------------------------------------------------------------


def run_incarnation(
    run_dir: str,
    schedule_path: str,
    *,
    kill_after_s: Optional[float] = None,
    chaos: Optional[str] = None,
    max_inflight: int = 2,
    overload: bool = False,
    wait_s: float = 300.0,
    fleet: int = 0,
    sessions: int = 0,
    mux: int = 0,
    platform: str = "default",
) -> int:
    """Spawn one ``--serve`` child (its own process group, this module
    re-executed with ``-m``) and either let it finish or SIGKILL the whole
    group after ``kill_after_s`` — the harness's service-crash primitive.
    Returns the child's rc, or -9."""
    argv = [
        sys.executable, "-m", MODULE, "--serve",
        "--run-dir", run_dir, "--schedule", schedule_path,
        "--max-inflight", str(max_inflight),
        "--wait-s", str(wait_s),
        "--platform", platform,
    ]
    if fleet:
        argv += ["--fleet", str(fleet)]
    if mux:
        argv += ["--mux", str(mux)]
    if sessions:
        argv += ["--sessions", str(sessions)]
    if chaos:
        argv += ["--chaos", chaos]
    if overload:
        argv += ["--overload"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p
    )
    proc = subprocess.Popen(argv, start_new_session=True, env=env)
    if kill_after_s is None:
        try:
            return proc.wait(timeout=wait_s + 60.0)
        except subprocess.TimeoutExpired:
            log(f"incarnation overran {wait_s + 60.0:.0f}s; killing group")
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except OSError:
                proc.kill()
            proc.wait(timeout=10.0)
            return 124
    try:
        rc = proc.wait(timeout=kill_after_s)
        return rc  # finished before the kill point
    except subprocess.TimeoutExpired:
        pass
    log(f"SIGKILL service incarnation (pid {proc.pid})")
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except OSError:
        proc.kill()
    proc.wait(timeout=10.0)
    return -9


def _rotation_chain(base: str) -> List[Dict[str, Any]]:
    from stateright_tpu_torch.service import read_journal

    paths = []
    i = 1
    while os.path.exists(f"{base}.{i}"):
        paths.append(f"{base}.{i}")
        i += 1
    paths.reverse()
    if os.path.exists(base):
        paths.append(base)
    records: List[Dict[str, Any]] = []
    for p in paths:
        records.extend(read_journal(p).records)
    return records


def journal_history(run_dir: str) -> List[Dict[str, Any]]:
    """Every POOL journal record across the compaction rotations, oldest
    first — each event appears exactly once (compaction rewrites the
    live log as a snapshot; rotations keep the raw history). Fleet runs
    concatenate every device's journal, each record tagged ``_device``
    (pool job ids collide across devices — "job-0001" exists on each)."""
    single = _rotation_chain(os.path.join(run_dir, "journal.jsonl"))
    if single:
        return single
    records: List[Dict[str, Any]] = []
    for device in sorted(
        d for d in os.listdir(run_dir) if d.startswith("device-")
    ) if os.path.isdir(run_dir) else []:
        for rec in _rotation_chain(
            os.path.join(run_dir, device, "journal.jsonl")
        ):
            rec = dict(rec, _device=device)
            records.append(rec)
    return records


def fleet_journal(run_dir: str) -> List[Dict[str, Any]]:
    """The fleet's own routing journal (``fleet.jsonl`` rotations),
    oldest first; empty for single-pool runs."""
    return _rotation_chain(os.path.join(run_dir, "fleet.jsonl"))


def _is_fleet(run_dir: str) -> bool:
    return os.path.exists(os.path.join(run_dir, "fleet.jsonl"))


def event_signature(records: List[Dict[str, Any]]) -> List[str]:
    """The reproducibility projection: event names + job ids, with
    timestamps/pids/digests/durations masked."""
    return [
        f"{r['event']}:{r.get('job', '-')}"
        for r in records
        if r["event"] not in ("snapshot", "recovered")
    ]


def check_invariant(
    run_dir: str, schedule: Dict[str, Any], reference: Optional[dict]
) -> Dict[str, Any]:
    """The acceptance invariant: every scheduled job present, done,
    completed exactly once across the whole journal history, counts
    bit-identical to the reference (per spec). Fleet runs key done
    events by (device, pool job) and resolve each fleet job's pool-job
    HISTORY through the routing journal — a migrated job must complete
    exactly once across ALL the devices it touched."""
    with open(os.path.join(run_dir, "driver_results.json")) as fh:
        results = json.load(fh)["jobs"]
    problems: List[str] = []
    history = journal_history(run_dir)
    fleet = _is_fleet(run_dir)
    done_events: Dict[str, int] = {}

    def key_of(rec):
        return (
            f"{rec['_device']}:{rec['job']}" if fleet else rec["job"]
        )

    for r in history:
        if r["event"] == "completed" and r.get("status") == "done":
            done_events[key_of(r)] = done_events.get(key_of(r), 0) + 1
    for jid, n in done_events.items():
        if n > 1:
            problems.append(f"{jid} completed done {n} times")
    # Fleet: fleet job id -> every (device, pool_job) it was ever routed
    # to (exactly one of them must have completed it).
    routes: Dict[str, List[str]] = {}
    if fleet:
        for r in fleet_journal(run_dir):
            if r["event"] == "routed":
                routes.setdefault(r["job"], []).append(
                    f"device-{r['device']}:{r['pool_job']}"
                )
            elif r["event"] == "migrated":
                routes.setdefault(r["job"], []).append(
                    f"device-{r['to_device']}:{r['pool_job']}"
                )
            elif r["event"] == "snapshot":
                for fid, route in r["state"].get("routes", {}).items():
                    routes.setdefault(fid, []).append(
                        f"device-{route['device']}:{route['pool_job']}"
                    )
    for entry in schedule["jobs"]:
        got = results.get(entry["idem"])
        if got is None:
            problems.append(f"{entry['idem']} missing from results")
            continue
        if got["status"] != "done":
            problems.append(
                f"{entry['idem']} status={got['status']} ({got['error']})"
            )
            continue
        if fleet:
            dones = sum(
                done_events.get(k, 0)
                for k in dict.fromkeys(routes.get(got["id"], []))
            )
        else:
            dones = done_events.get(got["id"], 0)
        if dones != 1:
            problems.append(
                f"{entry['idem']} ({got['id']}) has "
                f"{dones} done events in the journal"
            )
        if reference is not None:
            want = reference[entry["spec"]]
            have = got["result"]
            for key in RESULT_KEYS:
                if have.get(key) != want.get(key):
                    problems.append(
                        f"{entry['idem']} {key} {have.get(key)!r} != "
                        f"reference {want.get(key)!r}"
                    )
    return {
        "ok": not problems,
        "problems": problems,
        "journal_records": len(history),
    }


def _percentiles(values: List[float]) -> Optional[Dict[str, float]]:
    if not values:
        return None
    vs = sorted(values)

    def pct(p: float) -> float:
        return vs[min(len(vs) - 1, int(round(p * (len(vs) - 1))))]

    return {
        "p50": round(pct(0.50), 3),
        "p99": round(pct(0.99), 3),
        "max": round(vs[-1], 3),
        "n": len(vs),
    }


def slo_stats(run_dir: str) -> Dict[str, Any]:
    """Admission latency (appended live by every incarnation, so kills
    lose nothing) + per-job turnaround from the journal history. Fleet
    runs additionally report the ``fleet`` dict: device count,
    migrations/losses from the routing journal, per-DEVICE turnaround
    percentiles (ROADMAP 3(c')), and the session-swarm stats."""
    latencies: List[float] = []
    lat_by_class: Dict[str, List[float]] = {}
    sheds = 0
    stats_path = os.path.join(run_dir, "admission_stats.jsonl")
    if os.path.exists(stats_path):
        with open(stats_path) as fh:
            for line in fh:
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if row.get("shed"):
                    sheds += 1
                    continue
                if "latency_ms" not in row:
                    continue
                latencies.append(row["latency_ms"])
                if row.get("priority"):
                    lat_by_class.setdefault(row["priority"], []).append(
                        row["latency_ms"]
                    )
    fleet = _is_fleet(run_dir)
    submitted: Dict[str, float] = {}
    priorities: Dict[str, str] = {}
    completed: Dict[str, float] = {}
    per_device: Dict[str, List[float]] = {}
    recovery = None
    for r in journal_history(run_dir):
        jid = r.get("job")
        key = f"{r['_device']}:{jid}" if fleet else jid
        if r["event"] == "submitted":
            submitted.setdefault(key, r["ts"])
            if "priority" in r:
                priorities[key] = r["priority"] or "batch"
        elif r["event"] == "completed" and r.get("status") == "done":
            completed[key] = r["ts"]
            # Same filter as the aggregate below: a job whose submitted
            # record rotated out of the keep-K chain must be skipped,
            # not counted as a spurious 0.0s turnaround.
            if fleet and key in submitted:
                per_device.setdefault(r["_device"], []).append(
                    r["ts"] - submitted[key]
                )
        elif r["event"] == "recovered":
            recovery = {
                k: r.get(k)
                for k in (
                    "records_replayed", "jobs_recovered", "jobs_requeued",
                    "jobs_readopted", "orphans_killed", "torn",
                )
            }
    turnaround = [
        completed[j] - submitted[j] for j in completed if j in submitted
    ]
    out = {
        "admission_latency_ms": _percentiles(latencies),
        "turnaround_s": _percentiles(turnaround),
        "journal": recovery,
    }
    # Per-class SLO split: present whenever the journal carries
    # priorities (every post-QoS run; pre-QoS journals skip it).
    if priorities:
        by_class: Dict[str, List[float]] = {}
        for j in completed:
            if j in submitted:
                by_class.setdefault(
                    priorities.get(j, "batch"), []
                ).append(completed[j] - submitted[j])
        out["classes"] = {
            cls: {
                "turnaround_s": _percentiles(by_class.get(cls, [])),
                "admission_latency_ms": _percentiles(
                    lat_by_class.get(cls, [])
                ),
            }
            for cls in sorted(set(by_class) | set(lat_by_class))
        }
        out["sheds"] = sheds
    if fleet:
        froutes = fleet_journal(run_dir)
        devices = {
            d for d in os.listdir(run_dir)
            if d.startswith("device-")
            and os.path.isdir(os.path.join(run_dir, d))
        }
        sessions = None
        spath = os.path.join(run_dir, "session_stats.jsonl")
        if os.path.exists(spath):
            with open(spath) as fh:
                rows = [json.loads(l) for l in fh if l.strip()]
            if rows:
                sessions = rows[-1]
        out["fleet"] = {
            "devices": len(devices),
            "migrations": sum(
                1 for r in froutes if r["event"] == "migrated"
            ),
            "routed": sum(1 for r in froutes if r["event"] == "routed"),
            # Per-device p50/p99 turnaround: the ROADMAP 3(c') SLO split.
            "per_device": {
                d: _percentiles(v) for d, v in sorted(per_device.items())
            },
            "sessions": sessions,
        }
    return out


# --------------------------------------------------------------------------
# Scenarios
# --------------------------------------------------------------------------


def run_scenario(
    name: str,
    seed: int,
    schedule: Dict[str, Any],
    base_dir: str,
    *,
    reference: Optional[dict],
    max_inflight: int = 2,
    max_restarts: int = 4,
    overload: bool = False,
    wait_s: float = 300.0,
    fleet: int = 0,
    sessions: int = 0,
    platform: str = "default",
) -> Dict[str, Any]:
    """One scenario end to end; returns its report (and, for baseline,
    the reference counts the others compare against)."""
    run_dir = os.path.join(base_dir, name)
    os.makedirs(run_dir, exist_ok=True)
    schedule_path = os.path.join(run_dir, "schedule.json")
    with open(schedule_path, "w") as fh:
        json.dump(schedule, fh)
    faults = fault_plan(seed, name)
    t0 = time.monotonic()
    restarts = 0
    kw = dict(max_inflight=max_inflight, overload=overload, wait_s=wait_s,
              fleet=fleet, sessions=sessions, platform=platform)
    if name == "baseline":
        rc = run_incarnation(run_dir, schedule_path, **kw)
    elif name == "device_lost":
        if not fleet:
            raise ValueError("device_lost needs --fleet N")
        rc = run_incarnation(
            run_dir, schedule_path,
            chaos=(
                f"seed={seed};device.lost@n={faults['lost_at_route']}"
                f":after_s={faults['lost_after_s']}"
            ),
            **kw,
        )
        while rc != 0 and restarts < max_restarts:
            restarts += 1
            rc = run_incarnation(run_dir, schedule_path, **kw)
    elif name == "kill":
        rc = run_incarnation(
            run_dir, schedule_path,
            kill_after_s=faults["kill_after_s"], **kw,
        )
        while rc != 0 and restarts < max_restarts:
            restarts += 1
            rc = run_incarnation(run_dir, schedule_path, **kw)
    elif name == "storm":
        # Mid-storm SIGKILL + restart: the storm
        # chaos rides EVERY incarnation — per-process fire counters make
        # the restarted storm re-fire at the same submission, and its
        # deterministic idempotency keys dedupe onto the replayed jobs.
        storm_chaos = (
            f"seed={seed};tenant.storm@n={faults['storm_at_submit']}"
            f":rate={faults['storm_rate']},class=best_effort"
        )
        rc = run_incarnation(
            run_dir, schedule_path,
            kill_after_s=faults["kill_after_s"],
            chaos=storm_chaos, **kw,
        )
        while rc != 0 and restarts < max_restarts:
            restarts += 1
            rc = run_incarnation(
                run_dir, schedule_path, chaos=storm_chaos, **kw
            )
    elif name in ("die", "torn"):
        point = "journal.die" if name == "die" else "journal.torn"
        n = faults.get("die_at_record") or faults.get("torn_at_record")
        rc = run_incarnation(
            run_dir, schedule_path,
            chaos=f"seed={seed};{point}@n={n}", **kw,
        )
        while rc != 0 and restarts < max_restarts:
            restarts += 1
            rc = run_incarnation(run_dir, schedule_path, **kw)
    else:
        raise ValueError(f"unknown scenario {name!r}")
    if rc != 0:
        return {
            "scenario": name, "ok": False, "rc": rc, "restarts": restarts,
            "problems": [f"final incarnation rc={rc}"], "faults": faults,
        }
    invariant = check_invariant(
        run_dir, schedule, None if name == "baseline" else reference
    )
    report = {
        "scenario": name,
        "ok": invariant["ok"],
        "problems": invariant["problems"],
        "faults": faults,
        "restarts": restarts,
        "elapsed_s": round(time.monotonic() - t0, 3),
        **slo_stats(run_dir),
    }
    if name == "device_lost":
        # The migration must actually have happened — a device_lost pass
        # that never killed a device proves nothing.
        migrations = (report.get("fleet") or {}).get("migrations", 0)
        if not migrations:
            report["ok"] = False
            report["problems"] = report["problems"] + [
                "device_lost scenario recorded no migrations"
            ]
    if name == "storm":
        # The storm must actually have fired (a pass with no burst
        # proves nothing), and classes must not invert: interactive p99
        # turnaround strictly better than best_effort's once both have
        # enough samples to make the comparison meaningful.
        stormed = sum(
            1 for r in journal_history(run_dir)
            if r["event"] == "submitted" and r.get("tenant") == "storm"
        )
        report["storm_submissions"] = stormed
        if not stormed:
            report["ok"] = False
            report["problems"] = report["problems"] + [
                "storm scenario journaled no storm-tenant submissions"
            ]
        classes = report.get("classes") or {}
        ip99 = ((classes.get("interactive") or {}).get("turnaround_s")
                or {}).get("p99")
        bp99 = ((classes.get("best_effort") or {}).get("turnaround_s")
                or {}).get("p99")
        i_n = ((classes.get("interactive") or {}).get("turnaround_s")
               or {}).get("n", 0)
        b_n = ((classes.get("best_effort") or {}).get("turnaround_s")
               or {}).get("n", 0)
        if ip99 is not None and bp99 is not None:
            report["priority_inversion"] = bool(ip99 >= bp99)
            if ip99 >= bp99 and min(i_n, b_n) >= 5:
                report["ok"] = False
                report["problems"] = report["problems"] + [
                    f"priority inversion: interactive p99 {ip99:.3f}s >= "
                    f"best_effort p99 {bp99:.3f}s"
                ]
    if overload:
        with open(os.path.join(run_dir, "driver_results.json")) as fh:
            report["retry_after"] = json.load(fh).get("retry_after")
    return report


def run_mux_scenario(
    seed: int,
    base_dir: str,
    k: int,
    *,
    max_seconds: float = 240.0,
    wait_s: float = 300.0,
    max_restarts: int = 4,
    platform: str = "default",
) -> Dict[str, Any]:
    """SIGKILL the multiplexed worker mid-batch. K same-spec
    jobs through a ``mux_k=K`` pool; EVERY member carries a per-job
    ``die_at_depth`` (marker-once, so each job sabotages exactly one
    attempt) — whichever members the scheduler batches, the first lane
    to reach the depth kills the SHARED group process. Pool-level
    ``worker.die`` can't guarantee that: the seeded victim may start
    solo before siblings arrive, and the kill then proves nothing about
    the batch path. The service must quarantine every member
    individually, retry them solo (resuming from their own lane
    checkpoint rotations), and converge to exactly-once — counts
    bit-identical to a mux-OFF solo baseline of the same schedule
    (chaos stripped), which this scenario runs first (the batched
    engine proves itself against the solo one)."""
    import random
    import zlib

    rng = random.Random((seed << 8) ^ zlib.crc32(b"mux"))
    faults = {"die_depth": rng.randint(2, 4), "armed": "every member"}

    def make_schedule(with_chaos: bool) -> Dict[str, Any]:
        jobs = []
        for i in range(k):
            job = {
                "idem": f"mux-{seed}-{i}",
                "spec": "2pc:3",
                # Zero stagger: members must be co-queued for the
                # scheduler to batch them at all.
                "delay_s": 0.0,
                "max_seconds": max_seconds,
            }
            if with_chaos:
                job["chaos"] = {
                    "die_at_depth": faults["die_depth"], "marker": True,
                }
            jobs.append(job)
        return {"seed": seed, "jobs": jobs}

    schedule = make_schedule(False)
    t0 = time.monotonic()

    def incarnate(sub: str, sched: Dict[str, Any], **kw) -> tuple:
        run_dir = os.path.join(base_dir, sub)
        os.makedirs(run_dir, exist_ok=True)
        sp = os.path.join(run_dir, "schedule.json")
        with open(sp, "w") as fh:
            json.dump(sched, fh)
        return run_dir, run_incarnation(
            run_dir, sp, wait_s=wait_s, platform=platform, **kw
        )

    base_run, rc = incarnate("mux_baseline", schedule, max_inflight=2)
    if rc != 0:
        return {
            "scenario": "mux", "ok": False, "rc": rc, "k": k,
            "faults": faults, "problems": [f"mux baseline rc={rc}"],
        }
    reference = reference_counts(base_run, schedule)
    restarts = 0
    run_dir, rc = incarnate(
        "mux", make_schedule(True), mux=k, max_inflight=max(2, k),
    )
    while rc != 0 and restarts < max_restarts:
        restarts += 1
        _, rc = incarnate(
            "mux", make_schedule(True), mux=k, max_inflight=max(2, k),
        )
    if rc != 0:
        return {
            "scenario": "mux", "ok": False, "rc": rc, "k": k,
            "restarts": restarts, "faults": faults,
            "problems": [f"final incarnation rc={rc}"],
        }
    invariant = check_invariant(run_dir, schedule, reference)
    history = journal_history(run_dir)
    groups = {
        r["mux_group"]
        for r in history
        if r["event"] == "started" and r.get("mux_group")
    }
    report = {
        "scenario": "mux",
        "ok": invariant["ok"],
        "problems": invariant["problems"],
        "faults": faults,
        "k": k,
        "restarts": restarts,
        "mux_groups_started": len(groups),
        "elapsed_s": round(time.monotonic() - t0, 3),
        **slo_stats(run_dir),
    }
    if not groups:
        # A mux pass that never batched proves nothing — same contract
        # as device_lost's no-migrations guard.
        report["ok"] = False
        report["problems"] = report["problems"] + [
            "mux scenario journaled no mux_group starts"
        ]
    return report


def reference_counts(run_dir: str, schedule: Dict[str, Any]) -> dict:
    """spec -> result counts from the baseline scenario's results."""
    with open(os.path.join(run_dir, "driver_results.json")) as fh:
        results = json.load(fh)["jobs"]
    out: dict = {}
    for entry in schedule["jobs"]:
        got = results[entry["idem"]]
        if got["status"] != "done":
            raise RuntimeError(
                f"baseline job {entry['idem']} did not complete: "
                f"{got['error']}"
            )
        out[entry["spec"]] = got["result"]
    return out


def check_repro(args: argparse.Namespace, base_dir: str) -> Dict[str, Any]:
    """Same seed, twice, fresh dirs, serial pool: the journal event
    sequences (timestamps masked) must be identical."""
    schedule = build_schedule(
        args.seed, args.jobs, args.max_seconds,
        tenants=getattr(args, "tenants", 0),
    )
    sigs = []
    for i in (1, 2):
        run_dir = os.path.join(base_dir, f"repro{i}")
        os.makedirs(run_dir, exist_ok=True)
        sp = os.path.join(run_dir, "schedule.json")
        with open(sp, "w") as fh:
            json.dump(schedule, fh)
        rc = run_incarnation(
            run_dir, sp, max_inflight=1, wait_s=args.wait_s,
            platform=args.platform,
        )
        if rc != 0:
            return {"ok": False, "problems": [f"repro pass {i} rc={rc}"]}
        sigs.append(event_signature(journal_history(run_dir)))
    return {
        "ok": sigs[0] == sigs[1],
        "events": len(sigs[0]),
        "problems": (
            [] if sigs[0] == sigs[1] else [
                f"event sequences diverge: {sigs[0]} != {sigs[1]}"
            ]
        ),
    }


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--jobs", type=int, default=3)
    p.add_argument("--scenario", default="all",
                   choices=("all", "baseline", "kill", "die", "torn",
                            "device_lost", "mux", "storm"))
    p.add_argument("--tenants", type=int, default=0,
                   help="seeded multi-tenant mixed-priority traffic: "
                        "every scheduled job gets one of N tenants and "
                        "a priority class; enables the storm scenario "
                        "and the per-class SLO split")
    p.add_argument("--fleet", type=int, default=0,
                   help="front N per-device pools (FleetService); 0 = "
                        "the single-pool service")
    p.add_argument("--mux", type=int, default=0,
                   help="run the mux scenario at K lanes (batching "
                        "scheduler, ServiceConfig.mux_k); 0 = off "
                        "(--scenario mux alone defaults K to 4)")
    p.add_argument("--sessions", type=int, default=0,
                   help="concurrent interactive Explorer sessions "
                        "polling /.status alongside the batch schedule")
    p.add_argument("--base-dir", default=None,
                   help="scenario run dirs land here "
                        "(default runs/service_chaos/seed<N>)")
    p.add_argument("--max-seconds", type=float, default=240.0)
    p.add_argument("--max-inflight", type=int, default=2)
    p.add_argument("--max-restarts", type=int, default=4)
    p.add_argument("--wait-s", type=float, default=300.0)
    p.add_argument("--overload", action="store_true",
                   help="probe Retry-After accuracy with a queue-full burst")
    p.add_argument("--check-repro", action="store_true")
    p.add_argument("--platform", default="default", choices=("default", "cpu"),
                   help="the pools' device: the card (default) or the CPU")
    p.add_argument("--out", default=os.path.join(RUNS, "service_chaos_torch.json"))
    # serve mode (the killable child; internal)
    p.add_argument("--serve", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--run-dir", default=None, help=argparse.SUPPRESS)
    p.add_argument("--schedule", default=None, help=argparse.SUPPRESS)
    p.add_argument("--chaos", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args.serve:
        return serve(args)

    base_dir = args.base_dir or os.path.join(
        RUNS, "service_chaos", f"seed{args.seed}"
    )
    os.makedirs(base_dir, exist_ok=True)
    if args.scenario == "storm" and not args.tenants:
        args.tenants = 12
    schedule = build_schedule(
        args.seed, args.jobs, args.max_seconds, tenants=args.tenants
    )
    line: Dict[str, Any] = {
        "tool": "service_chaos",
        "platform": args.platform,
        "seed": args.seed,
        "jobs": args.jobs,
        "tenants": args.tenants or None,
        "fleet_devices": args.fleet or None,
        "sessions": args.sessions or None,
        "mux_k": args.mux or None,
        "specs": [j["spec"] for j in schedule["jobs"]],
        "scenarios": {},
        "ok": True,
    }
    if args.check_repro:
        rep = check_repro(args, base_dir)
        line["scenarios"]["repro"] = rep
        line["ok"] = line["ok"] and rep["ok"]
    else:
        if args.scenario == "mux" and not args.mux:
            args.mux = 4
        if args.scenario == "mux":
            names = []  # self-contained: builds its own schedule+baseline
        elif args.scenario == "all":
            names = ["baseline", "kill", "torn"] + (
                ["device_lost"] if args.fleet else []
            ) + (["storm"] if args.tenants else [])
        else:
            names = ["baseline"] + (
                [args.scenario] if args.scenario != "baseline" else []
            )
        reference = None
        kw = dict(
            max_inflight=args.max_inflight,
            max_restarts=args.max_restarts,
            wait_s=args.wait_s,
            fleet=args.fleet,
            sessions=args.sessions,
            platform=args.platform,
        )
        for name in names:
            rep = run_scenario(
                name, args.seed, schedule, base_dir,
                reference=reference,
                overload=args.overload and name == "baseline",
                **kw,
            )
            line["scenarios"][name] = rep
            line["ok"] = line["ok"] and rep["ok"]
            if name == "baseline" and rep["ok"]:
                reference = reference_counts(
                    os.path.join(base_dir, "baseline"), schedule
                )
            elif name == "baseline":
                break  # no ground truth; the comparisons are meaningless
        if args.mux and args.scenario in ("all", "mux"):
            rep = run_mux_scenario(
                args.seed, base_dir, args.mux,
                max_seconds=args.max_seconds,
                wait_s=args.wait_s,
                max_restarts=args.max_restarts,
                platform=args.platform,
            )
            line["scenarios"]["mux"] = rep
            line["ok"] = line["ok"] and rep["ok"]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    tmp = args.out + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(line, fh, indent=1)
    os.replace(tmp, args.out)
    print(json.dumps(line))
    return 0 if line["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
