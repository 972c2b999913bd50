"""The port's chaos harness (``stateright_tpu_torch/tools/service_chaos.py``)
on the CPU, held against the JAX package's (``tools/service_chaos.py``).

- The seeded schedule, every scenario's fault plan and the journal's event
  signature equal the reference's for seeds 0-20; ``check_invariant``,
  ``slo_stats`` and the journal readers give the same verdicts and numbers
  on the same run dirs (one pool and a fleet, exact, double-completed,
  missing, failed and miscounted).
- The harness runs the port (``python -m``, ``--platform cpu``): the seed
  pins, the restart drill (a pool that SIGKILLs itself after ``started``,
  restarted into one completion), and the command line's ``device_lost``
  scenario at ``--fleet 2``. The convergence pins under SIGKILL, torn
  journals and lost devices are ``slow``, as the reference's are.

The port's CPU workers end the schedule's tiny specs about 2.5 s after
submission, where the reference's take tens of seconds, so a seeded device
loss (1-4 s after the first or second placement) lands after every job for
most seeds, seed 42's too. The ``device_lost`` runs here take their fault
plan from seed 4, whose loss lands 1.077 s after the first placement.
"""

import importlib.util
import json
import os
import random
import subprocess
import sys

import pytest

from stateright_tpu import chaos as ref_chaos
from stateright_tpu_torch import chaos
from stateright_tpu_torch.service import Journal
from stateright_tpu_torch.tools import service_chaos as sc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED_2PC3 = (1_146, 288)
SCENARIOS = ("baseline", "kill", "die", "torn", "device_lost", "storm", "mux", "all")
#: A seed whose device loss lands inside the port's CPU jobs (see above).
LOST_SEED = 4


@pytest.fixture(autouse=True)
def _no_ambient_chaos(monkeypatch):
    monkeypatch.delenv("STPU_CHAOS", raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    chaos.install(None)
    ref_chaos.install(None)
    yield
    chaos.install(None)
    ref_chaos.install(None)


_REF_MOD = []


def _ref():
    """The JAX package's harness, imported from its file."""
    if not _REF_MOD:
        path = os.path.join(ROOT, "tools", "service_chaos.py")
        spec = importlib.util.spec_from_file_location("ref_service_chaos", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _REF_MOD.append(mod)
    return _REF_MOD[0]


def _random_records(seed):
    rng = random.Random(seed)
    events = ("submitted", "admitted", "started", "completed", "snapshot", "recovered",
              "quarantined", "routed", "migrated")
    return [{"v": 1, "seq": i + 1, "event": rng.choice(events), "ts": rng.random(),
             **({"job": f"job-{rng.randrange(5):04d}"} if rng.random() < 0.8 else {})}
            for i in range(rng.randrange(1, 30))]


@pytest.mark.parametrize("seed", range(21))
def test_schedule_faults_and_signature_equal_the_reference(seed):
    ref = _ref()
    assert sc.SPEC_POOL == ref.SPEC_POOL and sc.RESULT_KEYS == ref.RESULT_KEYS
    for jobs, tenants in ((3, 0), (5, 12)):
        assert (sc.build_schedule(seed, jobs, 240.0, tenants=tenants)
                == ref.build_schedule(seed, jobs, 240.0, tenants=tenants))
    for scenario in SCENARIOS:
        assert sc.fault_plan(seed, scenario) == ref.fault_plan(seed, scenario)
    records = _random_records(seed)
    assert sc.event_signature(records) == ref.event_signature(records)


def test_harness_schedule_and_faults_are_seed_deterministic():
    """The reference's golden values: the schedule and the fault plan are
    pure functions of the seed, stable across processes."""
    assert sc.build_schedule(7, 3, 240.0) == sc.build_schedule(7, 3, 240.0)
    assert sc.build_schedule(7, 3, 240.0) != sc.build_schedule(8, 3, 240.0)
    for scenario in ("kill", "die", "torn"):
        assert sc.fault_plan(7, scenario) == sc.fault_plan(7, scenario)
    assert sc.fault_plan(42, "kill") == {"kill_after_s": 4.861}
    assert sc.fault_plan(42, "die") == {"die_at_record": 9}
    assert sc.fault_plan(42, "torn") == {"torn_at_record": 6}
    assert sc.fault_plan(LOST_SEED, "device_lost") == {"lost_at_route": 1,
                                                       "lost_after_s": 1.077}


# --- check_invariant and slo_stats on the same run dirs ------------------------

_RESULT = {"generated": 1146, "unique": 288, "max_depth": 11, "discoveries": {}}
_SCHEDULE = {"jobs": [{"idem": f"inv-{i}", "spec": "2pc:3", "delay_s": 0.0,
                       "max_seconds": 240.0} for i in range(2)]}


def _pool_journal(path, jobs, done_twice=()):
    j = Journal(path, compact_every=1000)
    for n, job in enumerate(jobs):
        j.append("submitted", ts=1.0 + n, job=job, spec="2pc:3", priority="batch")
        j.append("started", ts=1.5 + n, job=job, attempt=0)
        for _ in range(2 if job in done_twice else 1):
            j.append("completed", ts=3.0 + n, job=job, status="done", error=None,
                     result=_RESULT)
    j.close()


def _results(run_dir, ids, status="done", result=_RESULT):
    out = {"jobs": {f"inv-{i}": {"id": jid, "spec": "2pc:3", "status": status, "error": None,
                                 "recovered": False, "requeues": 0,
                                 "result": result}
                    for i, jid in enumerate(ids)}}
    with open(os.path.join(run_dir, "driver_results.json"), "w") as fh:
        json.dump(out, fh)


def _case(run_dir, name):
    os.makedirs(run_dir)
    with open(os.path.join(run_dir, "admission_stats.jsonl"), "w") as fh:
        fh.write(json.dumps({"idem": "inv-0", "latency_ms": 1.5, "priority": "batch"}) + "\n")
        fh.write("torn {\n")
    if name.startswith("pool"):
        _pool_journal(os.path.join(run_dir, "journal.jsonl"), ["job-0001", "job-0002"],
                      done_twice=("job-0002",) if name == "pool_twice" else ())
        ids = ["job-0001", "job-0002"] if name != "pool_missing" else ["job-0001"]
        result = dict(_RESULT, unique=287) if name == "pool_miscount" else _RESULT
        _results(run_dir, ids, result=result)
        return
    # A fleet of two: fjob-0001 routed to device 0, evacuated, migrated to
    # device 1 and done there; fjob-0002 done on device 1.
    for d, jobs in ((0, []), (1, ["job-0001", "job-0002"])):
        os.makedirs(os.path.join(run_dir, f"device-{d}"))
        _pool_journal(os.path.join(run_dir, f"device-{d}", "journal.jsonl"), jobs,
                      done_twice=("job-0001",) if name == "fleet_twice" and d == 1 else ())
    fleet = Journal(os.path.join(run_dir, "fleet.jsonl"))
    fleet.append("routed", ts=1.0, job="fjob-0001", device=0, pool_job="job-0001")
    fleet.append("routed", ts=1.1, job="fjob-0002", device=1, pool_job="job-0002")
    fleet.append("migrated", ts=2.0, job="fjob-0001", from_device=0, to_device=1,
                 pool_job="job-0001")
    fleet.close()
    _results(run_dir, ["fjob-0001", "fjob-0002"],
             status="failed" if name == "fleet_failed" else "done")


@pytest.mark.parametrize("name, ok", [
    ("pool", True), ("pool_twice", False), ("pool_missing", False), ("pool_miscount", False),
    ("fleet", True), ("fleet_twice", False), ("fleet_failed", False),
])
def test_invariant_and_slo_equal_the_reference(tmp_path, name, ok):
    ref = _ref()
    run_dir = str(tmp_path / name)
    _case(run_dir, name)
    reference = {"2pc:3": _RESULT}
    got = sc.check_invariant(run_dir, _SCHEDULE, reference)
    assert got == ref.check_invariant(run_dir, _SCHEDULE, reference)
    assert got["ok"] is ok, got["problems"]
    assert sc.journal_history(run_dir) == ref.journal_history(run_dir)
    assert sc.fleet_journal(run_dir) == ref.fleet_journal(run_dir)
    assert sc.slo_stats(run_dir) == ref.slo_stats(run_dir)


# --- the harness on the port ---------------------------------------------------


def _drill_schedule(idem, specs=("2pc:3",)):
    return {"jobs": [{"idem": f"{idem}-{i}", "spec": spec, "delay_s": 0.2 * i,
                      "max_seconds": 240.0} for i, spec in enumerate(specs)]}


def test_smoke_service_restart_resume(tmp_path):
    """The restart drill through the port's harness (``--platform cpu``): the
    service SIGKILLs itself right after journaling ``started``, the restart
    replays the journal, kills the orphaned worker, requeues, and the job
    completes exactly once with the pinned counts."""
    run_dir = str(tmp_path / "drill")
    os.makedirs(run_dir)
    schedule = _drill_schedule("drill")
    sp = os.path.join(run_dir, "schedule.json")
    with open(sp, "w") as fh:
        json.dump(schedule, fh)
    rc = sc.run_incarnation(run_dir, sp, chaos="seed=1;journal.die@n=3", wait_s=120.0,
                            platform="cpu")
    assert rc == -9
    rc = sc.run_incarnation(run_dir, sp, wait_s=120.0, platform="cpu")
    assert rc == 0
    inv = sc.check_invariant(run_dir, schedule, None)
    assert inv["ok"], inv["problems"]
    with open(os.path.join(run_dir, "driver_results.json")) as fh:
        got = json.load(fh)["jobs"]["drill-0"]
    assert got["status"] == "done"
    assert (got["result"]["generated"], got["result"]["unique"]) == PINNED_2PC3
    slo = sc.slo_stats(run_dir)
    assert slo["journal"]["records_replayed"] == 3
    assert slo["journal"]["jobs_requeued"] == 1
    assert slo["journal"]["orphans_killed"] in (0, 1)


def test_command_line_device_lost_at_fleet_2(tmp_path):
    """``python -m stateright_tpu_torch.tools.service_chaos --platform cpu
    --fleet 2 --scenario device_lost``: the baseline, then a lost device
    whose jobs migrate and complete exactly once, equal to the baseline."""
    out = str(tmp_path / "line.json")
    proc = subprocess.run(
        [sys.executable, "-m", "stateright_tpu_torch.tools.service_chaos", "--platform", "cpu",
         "--fleet", "2", "--scenario", "device_lost", "--seed", str(LOST_SEED),
         "--base-dir", str(tmp_path / "runs"), "--out", out],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    with open(out) as fh:
        assert json.load(fh) == line
    assert line["ok"] and line["platform"] == "cpu" and line["fleet_devices"] == 2
    assert list(line["scenarios"]) == ["baseline", "device_lost"]
    lost = line["scenarios"]["device_lost"]
    assert lost["faults"] == sc.fault_plan(LOST_SEED, "device_lost")
    assert lost["fleet"]["migrations"] >= 1 and lost["fleet"]["devices"] == 2
    assert lost["turnaround_s"]["n"] == 3


# --- convergence pins (slow, as the reference's) --------------------------------


@pytest.fixture(scope="module")
def chaos_reference(tmp_path_factory):
    """One undisturbed run of the seeded 3-job schedule on the port."""
    base = str(tmp_path_factory.mktemp("chaos"))
    schedule = sc.build_schedule(42, 3, 240.0)
    rep = sc.run_scenario("baseline", 42, schedule, base, reference=None, platform="cpu")
    assert rep["ok"], rep["problems"]
    ref = sc.reference_counts(os.path.join(base, "baseline"), schedule)
    return base, schedule, ref


@pytest.mark.slow
def test_fleet_sigkill_restart_replay_converges(chaos_reference):
    base, schedule, ref = chaos_reference
    rep = sc.run_scenario("kill", 42, schedule, os.path.join(base, "fleet3"), reference=ref,
                          max_inflight=2, fleet=3, platform="cpu")
    assert rep["ok"], rep["problems"]
    assert rep["restarts"] >= 1 or rep["faults"]["kill_after_s"] > rep["elapsed_s"]
    assert rep["fleet"]["devices"] == 3
    assert rep["turnaround_s"]["n"] == 3


@pytest.mark.slow
def test_fleet_device_lost_mid_schedule_converges(chaos_reference):
    base, schedule, ref = chaos_reference
    rep = sc.run_scenario("device_lost", LOST_SEED, schedule, os.path.join(base, "fleet_lost"),
                          reference=ref, max_inflight=2, fleet=2, platform="cpu")
    assert rep["ok"], rep["problems"]
    assert rep["fleet"]["migrations"] >= 1


@pytest.mark.slow
def test_chaos_pin_service_sigkill_converges(chaos_reference):
    base, schedule, ref = chaos_reference
    rep = sc.run_scenario("kill", 42, schedule, base, reference=ref, max_inflight=2,
                          platform="cpu")
    assert rep["ok"], rep["problems"]
    assert rep["turnaround_s"]["n"] == 3


@pytest.mark.slow
def test_chaos_pin_torn_journal_converges(chaos_reference):
    base, schedule, ref = chaos_reference
    rep = sc.run_scenario("torn", 42, schedule, base, reference=ref, max_inflight=2,
                          platform="cpu")
    assert rep["ok"], rep["problems"]
    assert rep["journal"]["torn"] is not None
