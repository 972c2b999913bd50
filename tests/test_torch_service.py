"""The port's checker service (``stateright_tpu_torch/service``) on the CPU,
held against the JAX package's.

- Admission, with the scheduler stubbed: the same submission sequences
  into both packages' ``CheckerService`` give the same job ids, the same
  ``AdmissionError`` reasons and ``retry_after_s`` hints (the cold
  estimate and the measured drain rate), the same shed and quota
  decisions, the same fair-share, aging and EDF picks, the same
  ``_mux_partition`` groups, the same interactive-session decisions and
  the same gauges.
- With real workers (``service/worker.py`` subprocesses on
  ``platform="cpu"``): a job SIGKILLed mid-run is requeued once and
  resumed from its rotation; a SIGSTOP-wedged job beside a running sibling
  is quarantined and resumed while the sibling runs once, untouched; two
  jobs wedged side by side open the breaker, the next job runs degraded on
  the host engine, the default probe closes the breaker and the next job
  runs the device engine again; three co-queued jobs run as one ``--mux`` worker; a pool
  killed by ``STPU_CHAOS=journal.die`` right after journaling ``started``
  is restarted over its run dir, kills the orphaned worker and finishes
  the job exactly once; and the Explorer is a client of the pool. Each
  job's counts, depth and discovery actions equal the JAX package's
  in-process ``spawn_xla`` on the CPU for the same spec (run once a spec).
"""

import json
import math
import os
import subprocess
import sys
import time

import pytest
import torch

from stateright_tpu import chaos as ref_chaos
from stateright_tpu.service import AdmissionError as RefAdmissionError
from stateright_tpu.service import CheckerService as RefService
from stateright_tpu.service import ServiceConfig as RefConfig
from stateright_tpu_torch import chaos
from stateright_tpu_torch.service import (
    AdmissionError,
    CheckerService,
    ServiceConfig,
    read_journal,
)

#: Pinned full-coverage (generated, unique) counts.
PINNED = {"2pc:3": (1_146, 288)}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_ambient_chaos(monkeypatch):
    """No chaos plan in either package, and one torch thread in each
    worker subprocess."""
    monkeypatch.delenv("STPU_CHAOS", raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    chaos.install(None)
    ref_chaos.install(None)
    yield
    chaos.install(None)
    ref_chaos.install(None)


def _kw(tmp_path, **kw):
    base = dict(
        run_dir=str(tmp_path / "svc"), platform="cpu", default_max_seconds=420.0,
        stall_s=8.0, startup_grace_s=240.0, poll_s=0.2, backoff_s=0.1,
        probe_auto=False, admission_lint=False,
    )
    base.update(kw)
    return base


# --- admission decisions against the reference --------------------------------


def _submit(log, svc, spec, **kw):
    try:
        job = svc.submit(spec, **kw)
    except (AdmissionError, RefAdmissionError) as e:
        log.append(("reject", e.reason, e.retry_after_s))
        return None
    except ValueError as e:
        log.append(("value_error", str(e)))
        return None
    log.append(("ok", job.id, job.priority, job.tenant, job.status))
    return job


def _caps(svc, log):
    _submit(log, svc, "nosuchmodel:9")
    _submit(log, svc, "2pc:3", max_seconds=10_000_000.0)
    for _ in range(3):
        _submit(log, svc, "2pc:3")


def _shed(svc, log):
    _submit(log, svc, "2pc:3", priority="platinum")
    for _ in range(4):
        _submit(log, svc, "2pc:3", tenant="t-batch")
    _submit(log, svc, "2pc:3", priority="best_effort")
    for _ in range(3):
        _submit(log, svc, "2pc:3")
    _submit(log, svc, "2pc:3", priority="interactive", deadline_s=60)
    _submit(log, svc, "2pc:3", priority="interactive")
    _submit(log, svc, "2pc:3", priority="interactive")
    log.append(("snapshot", svc.job("job-0005").snapshot()["deadline_s"]))


def _quotas(svc, log):
    for tenant in ("t1", "t1", "t1", "t2"):
        _submit(log, svc, "2pc:3", tenant=tenant)
    _submit(log, svc, "2pc:3", tenant="broke", max_seconds=60.0)
    _submit(log, svc, "2pc:3", tenant="broke", max_seconds=40.0)


def _picks(svc, log):
    straggler = _submit(log, svc, "2pc:3", priority="best_effort")
    hi = [_submit(log, svc, "2pc:3", priority="interactive") for _ in range(8)]
    loose = _submit(log, svc, "2pc:4", priority="batch")
    tight = _submit(log, svc, "2pc:4", priority="batch", deadline_s=30.0)
    capped = [_submit(log, svc, "2pc:3", tenant="capped") for _ in range(2)]
    with svc._cond:
        log.append(("pick", [j.id for j in svc._qos_pick([straggler] + hi, 5)]))
        log.append(("pick", [j.id for j in svc._qos_pick([loose, tight], 1)]))
        capped[0].status = "running"
        log.append(("pick", [j.id for j in svc._qos_pick([capped[1], loose], 2)]))
        straggler.created_unix_ts -= svc._cfg.qos_aging_s * svc._w_max + 1.0
        log.append(("pick", [j.id for j in svc._qos_pick([straggler] + hi, 1)]))


def _mux(svc, log):
    jobs = [_submit(log, svc, "2pc:3", priority="interactive") for _ in range(5)]
    jobs += [_submit(log, svc, "2pc:3", priority="best_effort") for _ in range(3)]
    jobs += [_submit(log, svc, "scr:3,1"), _submit(log, svc, "2pc:3", symmetry="on")]
    jobs += [_submit(log, svc, "2pc:4", engine="host")]
    with svc._cond:
        groups = svc._mux_partition(list(jobs))
    log.append(("groups", sorted([j.id for j in g] for g in groups)))


def _drain(svc, log):
    for _ in range(3):
        _submit(log, svc, "2pc:3")
    with svc._cond:
        log.append(("cold", svc._retry_after(svc._counts(), "batch")))
        now = time.time()
        svc._drain.append((now - 8.0, "batch"))
        svc._drain.append((now - 4.0, "batch"))
        log.append(("warm", svc._retry_after(svc._counts(), "batch")))
        log.append(("be", svc._retry_after(svc._counts(), "best_effort")))


def _sessions(svc, log):
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as RefTwoPhase
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    model = TwoPhaseSys if isinstance(svc, CheckerService) else RefTwoPhase
    first = svc.register_interactive(model(2).checker().spawn_on_demand())
    log.append(("session", first.id, first.kind, first.status, first.spec))
    for call in (svc.check_session_capacity,
                 lambda: svc.register_interactive(model(2).checker().spawn_on_demand())):
        try:
            call()
        except (AdmissionError, RefAdmissionError) as e:
            log.append(("reject", e.reason, e.retry_after_s))
    svc.release_interactive(first)
    svc.check_session_capacity()
    second = svc.register_interactive(model(2).checker().spawn_on_demand(), degraded=True)
    log.append(("session", second.id, second.engine, second.degraded,
                second.checker.metrics()["job_id"]))


SCENARIOS = {
    "caps": (_caps, dict(max_inflight=1, max_queue=2)),
    "shed": (_shed, dict(max_inflight=1, max_queue=8)),
    "quotas": (_quotas, dict(max_inflight=0, max_queue=64, tenant_max_queued=2,
                             tenant_quotas={"broke": {"budget_s": 50.0}})),
    "picks": (_picks, dict(max_inflight=0, max_queue=64,
                           shed_thresholds={"best_effort": 1.0, "batch": 1.0},
                           tenant_quotas={"capped": {"max_inflight": 1}})),
    "mux": (_mux, dict(max_inflight=0, max_queue=64, mux_k=4)),
    "drain": (_drain, dict(max_inflight=1, max_queue=64)),
    "sessions": (_sessions, dict(max_sessions=1)),
}


def _same(a, b):
    """Transcripts equal, floats to a relative 1e-3 (the measured drain
    rate reads the clock at each call)."""
    if isinstance(a, float) and isinstance(b, float):
        return math.isclose(a, b, rel_tol=1e-3)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_admission_decisions_equal_the_reference(tmp_path, scenario):
    drive, kw = SCENARIOS[scenario]
    logs, gauges = [], []
    for name, (svc_cls, cfg_cls) in (("port", (CheckerService, ServiceConfig)),
                                     ("ref", (RefService, RefConfig))):
        svc = svc_cls(cfg_cls(**_kw(tmp_path / name, **kw)))
        svc._ensure_scheduler = lambda: None  # admission accounting only
        log = []
        try:
            drive(svc, log)
            g = svc.gauges()
            g["journal"] = {k: v for k, v in g["journal"].items() if k != "path"}
            gauges.append(g)
        finally:
            svc.close()
        logs.append(log)
    assert _same(logs[0], logs[1]), (logs[0], logs[1])
    assert _same(gauges[0], gauges[1]), (gauges[0], gauges[1])
    assert any(entry[0] in ("reject", "pick", "groups", "warm", "session")
               for entry in logs[0])


def test_admission_flight_check(tmp_path, monkeypatch):
    """The port's flight-check subprocess: a shipped spec admits with its
    verdict memoized, a user family that is not packed is rejected typed
    naming the finding (never memoized, so a fixed model admits), a user
    family that cannot load is rejected, and a broken check tool fails
    open with ``ok=None`` and ``lint_errors``."""
    from stateright_tpu_torch.service import core as svc_core

    (tmp_path / "user_fam.py").write_text(
        "from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys as M\n"
        "def fam(args):\n"
        "    return M(args[0] if args else 3), {}\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    monkeypatch.setenv("STPU_FAMILIES", "fam=user_fam:fam,ghost=no_such_module_xyz:f")
    svc = CheckerService(ServiceConfig(**_kw(tmp_path, admission_lint=True)))
    svc._ensure_scheduler = lambda: None
    try:
        with pytest.raises(AdmissionError) as exc:
            svc.submit("fam:3")
        assert "ADM001" in str(exc.value) and "packed interface" in str(exc.value)
        assert exc.value.retry_after_s is None and "flight-check" in exc.value.reason
        (tmp_path / "user_fam.py").write_text(
            "from stateright_tpu_torch.models.two_phase_commit import PackedTwoPhaseSys as M\n"
            "def fam(args):\n"
            "    return M(args[0] if args else 3), {}\n")
        fixed = svc.submit("fam:3")
        assert fixed.lint["ok"] is True and fixed.lint["cached"] is False
        with pytest.raises(AdmissionError, match="flight-check"):
            svc.submit("ghost:1")
        job = svc.submit("2pc:3")
        assert job.lint["ok"] is True and job.snapshot()["lint"]["ok"] is True
        assert svc.submit("2pc:3").lint["cached"] is True
        g = svc.gauges()
        assert (g["lint_checks"], g["lint_rejects"], g["lint_errors"]) == (4, 2, 0)
        assert (g["rejected"], g["admitted"], g["warm_compiles"]) == (2, 3, 1)
        monkeypatch.setattr(svc_core, "_LINT", "/nonexistent/admission.py")
        broken = svc.submit("2pc:4")
        assert broken.lint["ok"] is None and broken.lint["errors"]
        assert svc.gauges()["lint_errors"] == 1
    finally:
        svc.close()


# --- jobs in real workers ------------------------------------------------------

_REF = {}


def _reference(spec):
    """The JAX package's uninterrupted in-process run of ``spec`` on the CPU."""
    if spec not in _REF:
        from stateright_tpu.service.registry import resolve

        model, caps = resolve(spec)
        c = model.checker().spawn_xla(**caps).join()
        _REF[spec] = {
            "generated": c.state_count(),
            "unique": c.unique_state_count(),
            "max_depth": c.max_depth(),
            "discoveries": {name: [repr(a) for a in path.into_actions()]
                            for name, path in sorted(c.discoveries().items())},
        }
    return _REF[spec]


def _assert_exact(result, spec):
    ref = _reference(spec)
    assert (result["generated"], result["unique"]) == PINNED[spec]
    for key in ("generated", "unique", "max_depth", "discoveries"):
        assert result[key] == ref[key], key


def test_kill_resume_smoke(tmp_path):
    svc = CheckerService(ServiceConfig(**_kw(tmp_path)))
    try:
        job = svc.submit("2pc:3", chaos={"die_at_depth": 3, "marker": str(tmp_path / "m1")})
        assert job.wait(timeout=240), job.snapshot()
        assert job.status == "done", job.error
        assert job.attempts[0]["rc"] == -9 and not job.attempts[0]["wedged"]
        assert job.requeues == 1 and job.resumed_from is not None
        assert job.result["resumed_from"] == job.resumed_from and job.result["start_depth"] == 3
        _assert_exact(job.result, "2pc:3")
        assert job.result["metrics"]["checkpoints_written"] >= 1
        assert job.result["platform"] == "cpu" and job.result["degraded"] is False
        with open(svc.job_trace_chrome(job.id)) as fh:
            events = json.load(fh)["traceEvents"]
        assert any(e["name"] == "dispatch" for e in events)
        g = svc.gauges()
        assert (g["jobs_done"], g["crashes"], g["requeues"]) == (1, 1, 1)
        assert g["breaker"]["state"] == "closed"
    finally:
        svc.close()
    assert not torch.cuda.is_initialized()


def test_sigstop_isolation_sibling_exact(tmp_path):
    svc = CheckerService(ServiceConfig(**_kw(tmp_path, max_inflight=2, stall_s=5.0)))
    try:
        victim = svc.submit("2pc:3", chaos={"freeze_at_depth": 4, "marker": str(tmp_path / "m2")})
        sibling = svc.submit("2pc:3")
        assert svc.wait_all(timeout=300), svc.metrics()
        assert sibling.status == "done", sibling.error
        assert (sibling.wedges, sibling.requeues, len(sibling.attempts)) == (0, 0, 1)
        _assert_exact(sibling.result, "2pc:3")
        assert victim.status == "done", victim.error
        assert victim.wedges == 1 and victim.attempts[0]["wedged"]
        assert "stale" in victim.attempts[0]["killed"]
        assert victim.result["start_depth"] >= 4
        _assert_exact(victim.result, "2pc:3")
        g = svc.gauges()
        assert (g["wedge_verdicts"], g["breaker_trips"]) == (1, 0)
        assert g["breaker"]["state"] == "closed"
    finally:
        svc.close()


def test_breaker_trip_host_fallback_and_recovery(tmp_path):
    svc = CheckerService(ServiceConfig(**_kw(tmp_path, stall_s=4.0, requeue_limit=0,
                                             breaker_k=2, max_inflight=2)))
    try:
        # Two jobs frozen side by side: two consecutive wedge verdicts = K,
        # each job failed at its requeue limit of 0.
        wedgers = [svc.submit("2pc:3", chaos={"freeze_at_depth": 2}) for _ in range(2)]
        assert svc.wait_all(timeout=300), svc.metrics()
        for wedger in wedgers:
            assert wedger.status == "failed" and wedger.wedges == 1
            assert "requeue limit" in wedger.error
        g = svc.gauges()
        assert g["breaker"]["state"] == "open" and g["breaker_trips"] == 1 and svc.degraded
        assert g["wedge_verdicts"] == 2
        fallback = svc.submit("2pc:3")
        assert fallback.wait(timeout=300), fallback.snapshot()
        assert fallback.status == "done", fallback.error
        assert fallback.engine == "host" and fallback.degraded
        assert fallback.result["degraded"] is True and fallback.result["engine"] == "host"
        _assert_exact(fallback.result, "2pc:3")
        assert svc.job_trace_chrome(fallback.id) is None
        # The default probe of a CPU pool: a fresh process, one tensor op.
        assert svc.probe_device_now()
        g = svc.gauges()
        assert g["breaker"]["state"] == "closed" and g["breaker_closes"] == 1
        assert (g["degraded_jobs"], g["device_probes"]) == (1, 1)
        again = svc.submit("2pc:3")
        assert again.wait(timeout=300) and again.status == "done", again.error
        assert again.engine == "xla" and not again.degraded
        _assert_exact(again.result, "2pc:3")
    finally:
        svc.close()


def test_mux_group_of_three(tmp_path):
    cfg = ServiceConfig(**_kw(tmp_path, max_inflight=0, mux_k=3))
    svc = CheckerService(cfg)
    try:
        jobs = [svc.submit("2pc:3") for _ in range(3)]
        with svc._cond:
            cfg.max_inflight = 3
            svc._cond.notify_all()
        for job in jobs:
            assert job.wait(timeout=240), job.snapshot()
            assert job.status == "done", job.error
            assert job.result["mux"]["lanes"] == 3 and job.result["metrics"]["mux_lanes"] == 3
            _assert_exact(job.result, "2pc:3")
        assert len({j.result["mux"]["group"] for j in jobs}) == 1
        g = svc.gauges()
        assert (g["mux_groups"], g["mux_lanes"]) == (1, 3) and g["mux_dispatches_saved"] >= 1
        started = [r for r in read_journal(os.path.join(cfg.run_dir, "journal.jsonl")).records
                   if r["event"] == "started"]
        assert len(started) == 3 and all(r["mux_lanes"] == 3 for r in started)
    finally:
        svc.close()


#: One incarnation of a pool over ``argv[1]``: submit one keyed job and
#: wait for it (the chaos plan kills the pool first).
_INCARNATION = """
import sys
from stateright_tpu_torch.service import CheckerService, ServiceConfig
svc = CheckerService(ServiceConfig(run_dir=sys.argv[1], platform="cpu", admission_lint=False,
                                   probe_auto=False, poll_s=0.2, stall_s=8.0,
                                   chaos="seed=1;journal.die@n=3"))
job = svc.submit("2pc:3", idempotency_key="drill-0")
job.wait(timeout=120)
"""


def test_service_restart_finishes_the_job_exactly_once(tmp_path):
    run_dir = str(tmp_path / "svc")
    env = {k: v for k, v in os.environ.items() if k != "STPU_CHAOS"}
    first = subprocess.run([sys.executable, "-c", _INCARNATION, run_dir], cwd=ROOT,
                           env=env, timeout=240)
    assert first.returncode == -9  # the pool's own injected SIGKILL, after `started`
    events = [r["event"] for r in read_journal(os.path.join(run_dir, "journal.jsonl")).records]
    assert events == ["submitted", "admitted", "started"]
    svc = CheckerService(ServiceConfig(**_kw(tmp_path)))
    try:
        rec = svc.gauges()["journal"]["recovery"]
        assert (rec["records_replayed"], rec["jobs_requeued"]) == (3, 1)
        assert rec["orphans_killed"] in (0, 1)
        job = svc.submit("2pc:3", idempotency_key="drill-0")
        assert job.recovered and job.id == "job-0001"
        assert job.wait(timeout=240) and job.status == "done", job.error
        _assert_exact(job.result, "2pc:3")
    finally:
        svc.close()
    records = read_journal(os.path.join(run_dir, "journal.jsonl")).records
    done = [r for r in records if r["event"] == "completed"]
    assert len(done) == 1 and done[0]["status"] == "done" and done[0]["job"] == "job-0001"


def test_explorer_is_a_service_client(tmp_path):
    from stateright_tpu_torch.checker.explorer import make_app
    from stateright_tpu_torch.checker.on_demand import OnDemandChecker
    from stateright_tpu_torch.models.two_phase_commit import PackedTwoPhaseSys

    svc = CheckerService(ServiceConfig(**_kw(tmp_path, max_sessions=1)))
    try:
        app, checker = make_app(PackedTwoPhaseSys(3).checker(), service=svc, device="cpu")
        status = app.status()
        assert status["job"] == "job-0001" and status["degraded"] is False
        assert status["pool"]["interactive"] == 1 and status["metrics"]["job_id"] == "job-0001"
        code, pool = app.pool()
        assert code == 200 and pool["jobs"]["job-0001"]["kind"] == "interactive"
        assert app.job_trace("job-0001")[0] == 404 and app.merged_trace()[0] == 404
        assert 'stpu_pool_interactive 1' in app.metrics_text()
        assert app.job_metrics("job-0001")[1]["rows"][0]["metrics"]["job_id"] == "job-0001"
        with pytest.raises(AdmissionError, match="sessions full"):
            make_app(PackedTwoPhaseSys(3).checker(), service=svc, device="cpu")
        app.run_to_completion()
        while not checker.is_done():
            app.drive()
        assert (checker.state_count(), checker.unique_state_count()) == PINNED["2pc:3"]
        app.close()
        assert svc.gauges()["interactive"] == 0 and svc.job("job-0001").status == "done"
        # While the breaker is open a GPU session is served on the host.
        with svc._cond:
            svc._breaker = "open"
        app2, host = make_app(PackedTwoPhaseSys(3).checker(), service=svc, device="cpu")
        assert isinstance(host, OnDemandChecker)
        assert app2.status()["degraded"] is True and app2.states("/")[0] == 200
        app2.close()
    finally:
        svc.close()
