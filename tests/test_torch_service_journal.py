"""The port's service journal (``stateright_tpu_torch/service/journal.py``)
on the CPU, held against the JAX package's.

- Round trip: appends verify, a tampered mid-file record stops replay
  (typed, ``strict`` raises), and the reference's reader reads the port's
  file to the same records and verdict.
- A tail torn at a seeded random byte: the clean prefix replays, the torn
  record is reported, in both readers alike; a writer SIGKILLed mid-append
  by ``STPU_CHAOS=journal.torn`` leaves the same shape.
- Compaction: one snapshot record, keep-K rotations, contiguous ``seq``.
- Across packages: a journal written by each package's service (the same
  submissions, a quarantine, a breaker trip and close, a completion) folds
  to the same ``_replay_state`` under both packages' replay, and a pool of
  the port restarted over a run dir the JAX package's pool wrote restores
  its finished job and its idempotency key without re-running.
"""

import os
import random
import subprocess
import sys

import pytest

from stateright_tpu import chaos as ref_chaos
from stateright_tpu.service import CheckerService as RefService
from stateright_tpu.service import ServiceConfig as RefConfig
from stateright_tpu.service import read_journal as ref_read
from stateright_tpu.service.core import _replay_state as ref_replay_state
from stateright_tpu_torch import chaos
from stateright_tpu_torch.service import (
    CheckerService,
    Journal,
    JournalTorn,
    ServiceConfig,
    read_journal,
)
from stateright_tpu_torch.service.core import _replay_state


@pytest.fixture(autouse=True)
def _no_ambient_chaos(monkeypatch):
    monkeypatch.delenv("STPU_CHAOS", raising=False)
    chaos.install(None)
    ref_chaos.install(None)
    yield
    chaos.install(None)
    ref_chaos.install(None)


def _same_replay(path):
    mine, ref = read_journal(path), ref_read(path)
    assert mine.records == ref.records and mine.torn == ref.torn
    return mine


def test_journal_round_trip_and_digests(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = Journal(path)
    for i in range(4):
        rec = j.append("submitted", ts=100.0 + i, job=f"job-{i:04d}", spec="2pc:3")
        assert rec["seq"] == i + 1 and rec["sha256"]
    j.close()
    replay = _same_replay(path)
    assert replay.torn is None
    assert [r["job"] for r in replay.records] == [f"job-{i:04d}" for i in range(4)]
    lines = open(path).read().splitlines()
    lines[1] = lines[1].replace("2pc:3", "2pc:9")
    (tmp_path / "j.jsonl").write_text("\n".join(lines) + "\n")
    tampered = _same_replay(path)
    assert len(tampered.records) == 1 and "digest mismatch" in tampered.torn
    with pytest.raises(JournalTorn):
        read_journal(path, strict=True)


def test_journal_torn_tail_at_random_byte(tmp_path):
    rng = random.Random(1234)
    for k in range(8):
        path = str(tmp_path / f"j{k}.jsonl")
        j = Journal(path)
        for i in range(5):
            j.append("submitted", ts=float(i), job=f"job-{i:04d}", spec="s")
        j.close()
        data = open(path, "rb").read()
        cut = rng.randint(1, len(data) - 1)
        with open(path, "wb") as fh:
            fh.write(data[:cut])
        replay = _same_replay(path)
        assert len(replay.records) == data[:cut].count(b"\n")
        assert (replay.torn is None) == data[:cut].endswith(b"\n")


def test_journal_torn_by_chaos_in_a_killed_writer(tmp_path):
    path = str(tmp_path / "j.jsonl")
    code = (
        "import sys; from stateright_tpu_torch.service.journal import Journal\n"
        "j = Journal(sys.argv[1])\n"
        "for i in range(5): j.append('submitted', ts=float(i), job='job-%04d' % i, spec='s')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, STPU_CHAOS="seed=1;journal.torn@n=3:at=20")
    proc = subprocess.run([sys.executable, "-c", code, path], cwd=root, env=env, timeout=120)
    assert proc.returncode == -9
    replay = _same_replay(path)
    assert [r["seq"] for r in replay.records] == [1, 2]
    assert "unparseable" in replay.torn
    assert open(path, "rb").read().split(b"\n")[-1].__len__() == 20


def test_journal_compaction_snapshot_and_rotation(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = Journal(path, keep=3, compact_every=3)
    for round_ in range(3):
        for i in range(3):
            j.append("submitted", ts=float(i), job=f"job-{round_}{i}", spec="s")
        assert j.compaction_due
        j.compact({"next_id": 3 * (round_ + 1), "jobs": {}}, ts=3.0)
        assert not j.compaction_due
    j.close()
    live = _same_replay(path)
    assert [r["event"] for r in live.records] == ["snapshot"]
    assert live.records[0]["state"]["next_id"] == 9 and live.records[0]["seq"] == 12
    # keep=3: the two previous logs rotated, each a snapshot then 3 appends.
    assert [r["event"] for r in _same_replay(path + ".1").records] == ["snapshot"] + ["submitted"] * 3
    assert [r["seq"] for r in _same_replay(path + ".2").records] == [4, 5, 6, 7]
    assert not os.path.exists(path + ".3")


def _drive(service_cls, config_cls, run_dir):
    """One pool's journal: three submissions (scheduler stubbed), a crash
    quarantine, two wedges that trip the breaker, a probe that closes it,
    a completion and a failure."""
    svc = service_cls(config_cls(
        run_dir=run_dir, platform="cpu", admission_lint=False, probe_auto=False,
        breaker_k=2, max_inflight=0, probe_argv=[sys.executable, "-c", "pass"]))
    svc._ensure_scheduler = lambda: None
    try:
        jobs = [svc.submit("2pc:3", idempotency_key="k0", tenant="a"),
                svc.submit("2pc:4", priority="interactive", deadline_s=30.0),
                svc.submit("paxos:2,3", max_seconds=120.0, priority="best_effort")]
        with svc._cond:
            for job, wedged in ((jobs[0], False), (jobs[1], True), (jobs[1], True)):
                job.status = "running"
                svc._jlog("started", job=job.id, attempt=len(job.attempts), engine="xla",
                          resumed_from=None, pid=None, trace_id=job.trace_id)
                svc._jlog("budget_charged", job=job.id, seconds=1.5, consumed_s=1.5,
                          charged=not wedged)
                if wedged:
                    job.wedges += 1
                    svc._record_wedge()
                svc._requeue_or_fail(job, "drill", wedged=wedged)
            jobs[0].status = "done"
            svc._jlog("completed", job=jobs[0].id, status="done", error=None,
                      result={"generated": 1146, "unique": 288, "max_depth": 11,
                              "seconds": 1.0, "degraded": False})
            jobs[2].status = "failed"
            svc._jlog("completed", job=jobs[2].id, status="failed", error="drill",
                      result=None)
        assert svc.degraded
        assert svc.probe_device_now() and not svc.degraded
    finally:
        svc.close()
    return os.path.join(run_dir, "journal.jsonl")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_journal_replays_in_the_other_package(tmp_path, writer):
    cls = (CheckerService, ServiceConfig) if writer == "port" else (RefService, RefConfig)
    path = _drive(*cls, str(tmp_path / "svc"))
    replay = _same_replay(path)
    events = [r["event"] for r in replay.records]
    assert events.count("breaker_tripped") == events.count("breaker_closed") == 1
    assert events.count("quarantined") == 3 and events.count("completed") == 2
    state = _replay_state(replay.records)
    assert state == ref_replay_state(replay.records)
    assert state["idem"] == {"k0": "job-0001"} and state["breaker"] == "closed"
    assert [state["jobs"][j]["status"] for j in state["order"]] == ["done", "quarantined", "failed"]
    assert state["counters"]["requeues"] == 3 and state["counters"]["wedge_verdicts"] == 2


def test_port_pool_recovers_a_reference_run_dir(tmp_path):
    run_dir = str(tmp_path / "svc")
    _drive(RefService, RefConfig, run_dir)
    svc = CheckerService(ServiceConfig(run_dir=run_dir, platform="cpu", admission_lint=False,
                                       probe_auto=False, max_inflight=0))
    svc._ensure_scheduler = lambda: None
    try:
        rec = svc.gauges()["journal"]["recovery"]
        assert rec["jobs_recovered"] == 3 and rec["jobs_requeued"] == 1 and rec["torn"] is None
        done = svc.job("job-0001")
        assert done.recovered and done.status == "done"
        assert done.result["generated"] == 1146
        # The idempotency key survived the restart across packages.
        assert svc.submit("2pc:3", idempotency_key="k0") is done
        assert svc.gauges()["idem_dedups"] == 1
        assert svc.job("job-0002").status == "queued"
        assert svc.submit("2pc:3").id == "job-0004"
    finally:
        svc.close()
