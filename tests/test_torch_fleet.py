"""The port's fleet (``stateright_tpu_torch/service/fleet.py``) on the CPU,
held against the JAX package's.

- Case for case, the JAX package's fleet tests run against the port, with
  the reference's expected values: the failover drill (a lost device's job
  migrates once and ends exact, the sibling untouched), the host engine
  only when every device is open, fleet-scoped idempotency and admission,
  concurrent same-key submits, the submit's unwind, the monitor's idle
  exit, elastic quiesce and wake, evacuation skipping forced-host jobs,
  the fleet-wide session cap, the journal's replay and restart routing,
  adoption from a torn tail, orphan re-routing, trace ids across routing,
  restart and migration, the chaos export, and the per-device
  ``/.metrics`` rows.
- Across packages: ``_fleet_replay`` folds the same records to the same
  state, and a run dir written by either package's fleet restarts in the
  other's with the same routes, keys, migrations and quiesced pools.

Pools run ``platform="cpu"``; the workers are ``service/worker.py``
subprocesses, and each finished job's counts, depth and discovery actions
equal the JAX package's in-process ``spawn_xla`` on the CPU.
"""

import os
import threading
import time
import types

import pytest
import torch

from stateright_tpu import chaos as ref_chaos
from stateright_tpu.service import FleetConfig as RefFleetConfig
from stateright_tpu.service import FleetService as RefFleetService
from stateright_tpu.service import ServiceConfig as RefConfig
from stateright_tpu.service import read_journal as ref_read
from stateright_tpu.service.fleet import _fleet_replay as ref_fleet_replay
from stateright_tpu_torch import chaos
from stateright_tpu_torch.checkpoint import latest_valid_checkpoint
from stateright_tpu_torch.service import (
    FLEET_COUNTERS,
    AdmissionError,
    CheckerService,
    FleetConfig,
    FleetJob,
    FleetService,
    ServiceConfig,
    read_journal,
)
from stateright_tpu_torch.service.fleet import _fleet_replay

#: Pinned full-coverage (generated, unique) counts.
PINNED = {"2pc:3": (1_146, 288), "2pc:5": (58_146, 8_832)}


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


def _config(tmp_path, config_cls=ServiceConfig, **kw):
    base = dict(
        run_dir=str(tmp_path / "svc"), platform="cpu", default_max_seconds=420.0,
        stall_s=8.0, startup_grace_s=240.0, poll_s=0.2, backoff_s=0.1,
        probe_auto=False, admission_lint=False,
    )
    base.update(kw)
    return config_cls(**base)


def _fleet(tmp_path, devices=2, pool_kw=None, **kw):
    base = dict(run_dir=str(tmp_path / "fleet"), devices=devices, monitor_interval_s=0.3,
                pool=_config(tmp_path, **(pool_kw or {})))
    base.update(kw)
    return FleetService(FleetConfig(**base))


def _disarmed(tmp_path, devices=3, interval=0.3):
    """A fleet whose pools run no worker (``max_inflight=0``)."""
    return FleetService(FleetConfig(
        run_dir=str(tmp_path / "fleet"), devices=devices, monitor_interval_s=interval,
        pool=_config(tmp_path, max_inflight=0)))


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


def _live_monitors():
    return [t for t in threading.enumerate()
            if t.name == "stpu-fleet-monitor" and t.is_alive()]


def test_public_names_and_defaults_equal_the_reference():
    import stateright_tpu.service as ref_service
    import stateright_tpu_torch.service as service

    assert set(ref_service.__all__) == set(service.__all__)
    assert FLEET_COUNTERS == ref_service.FLEET_COUNTERS
    assert FleetConfig() == FleetConfig(**vars(RefFleetConfig()))
    for name in ("status", "result", "error", "requeues", "wait", "snapshot", "metrics",
                 "done"):
        assert hasattr(FleetJob, name) and hasattr(ref_service.FleetJob, name)


# --- real workers -------------------------------------------------------------


def test_smoke_fleet_failover(tmp_path):
    """A 2-device fleet, ``device.lost@n=1`` kills the first routed job's
    device mid-job: the victim migrates to the surviving device and ends
    exact, the sibling never notices. The port's workers start in about a
    second on the CPU, so the loss lands 0.5 s after the placement (the
    reference waits 2 s), still before the job can end."""
    fleet = _fleet(tmp_path, devices=2, chaos="seed=1;device.lost@n=1:after_s=0.5")
    try:
        victim = fleet.submit("2pc:3")
        sibling = fleet.submit("2pc:3")
        first_device, first = victim.device, victim.pool_job
        assert {victim.device, sibling.device} == {0, 1}  # least-loaded spread
        assert fleet.wait_all(timeout=240), fleet.metrics()

        assert victim.status == "done", (victim.status, victim.error)
        assert len(victim.migrations) == 1
        assert victim.device != first_device
        _assert_exact(victim.result, "2pc:3")

        assert sibling.status == "done", (sibling.status, sibling.error)
        assert sibling.migrations == []
        _assert_exact(sibling.result, "2pc:3")

        g = fleet.gauges()
        assert g["migrations"] == 1
        assert g["devices_lost"] == 1
        assert g["lost_devices"] == [first_device]
        assert g["jobs_evacuated"] == 1
        assert g["devices"][f"device-{first_device}"]["lost"] is True
        snap = fleet.metrics()["jobs"][victim.id]
        assert snap["device"] == f"device-{victim.device}"
        assert snap["migrations"] == 1
        # The lost pool's journal holds the evacuation (the job's status
        # there is `migrated`, terminal for that pool), the fleet journal
        # the route and then the migration.
        lost = read_journal(os.path.join(str(tmp_path / "fleet"), f"device-{first_device}",
                                         "journal.jsonl")).records
        assert [r["job"] for r in lost if r["event"] == "evacuated"] == [first.id]
        assert not [r for r in lost if r["event"] == "completed"]
        assert first.status == "migrated"
        routing = [(r["event"], r["job"]) for r in
                   read_journal(os.path.join(str(tmp_path / "fleet"), "fleet.jsonl")).records
                   if r["event"] in ("routed", "migrated")]
        assert routing == [("routed", victim.id), ("routed", sibling.id), ("migrated", victim.id)]
    finally:
        fleet.close()
    assert not torch.cuda.is_initialized()


def test_failover_resumes_from_the_victims_own_rotation(tmp_path):
    """The port's own drill (the chip phase's on the CPU): the device is
    lost once the victim has committed a checkpoint rotation, so the
    migrated job starts on the sibling from that rotation, past depth 0,
    and still ends exact; the wall-clock already spent stays charged."""
    fleet = _fleet(tmp_path, devices=2, pin_devices=True,
                   pool_kw={"checkpoint_every": 1})
    try:
        # A job with a sabotage flag runs one level a dispatch, so it
        # commits a rotation every level; this one never trips.
        victim = fleet.submit("2pc:5", chaos={"die_at_depth": 10_000})
        deadline = time.monotonic() + 120
        while (latest_valid_checkpoint(victim.pool_job.checkpoint_path) is None
               and not victim.done and time.monotonic() < deadline):
            time.sleep(0.05)
        first_device = victim.device
        first = victim.pool_job
        assert not victim.done
        fleet.device_lost(first_device)
        assert victim.wait(timeout=240)
        assert victim.status == "done", victim.error
        hop = victim.migrations[0]
        assert (hop["from"], hop["to"]) == (first_device, 1 - first_device)
        assert hop["seed"].startswith(first.dir)
        assert victim.result["resumed_from"] == hop["seed"]
        assert victim.result["start_depth"] > 0
        assert victim.pool_job.consumed_s >= first.consumed_s > 0
        assert (victim.result["generated"], victim.result["unique"]) == PINNED["2pc:5"]
        # Pinned pools pass their ordinal; on the CPU the worker records it.
        assert victim.result["device_ordinal"] == 1 - first_device
    finally:
        fleet.close()


def test_fleet_monitor_idle_exits_and_restarts(tmp_path):
    fleet = _fleet(tmp_path, devices=2)
    try:
        fleet.submit("2pc:3")
        assert fleet.wait_all(timeout=240), fleet.metrics()
        deadline = time.monotonic() + 10.0
        while _live_monitors() and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not _live_monitors()  # idle-exited
        again = fleet.submit("2pc:3")
        assert _live_monitors()  # submit brought it back
        assert again.wait(timeout=240)
        assert again.status == "done"
    finally:
        fleet.close()


def test_elastic_quiesce_wake_exact(tmp_path):
    fleet = _fleet(tmp_path, devices=2, elastic=True, idle_quiesce_s=3600.0, min_active=1)
    try:
        assert fleet.quiesce_pool(1, reason="test")
        assert not fleet.quiesce_pool(0, reason="test")  # min_active
        assert not fleet.quiesce_pool(1, reason="test")  # already parked
        job = fleet.submit("2pc:3")
        assert job.device == 0
        assert fleet.wait_all(timeout=240), fleet.metrics()
        assert job.status == "done", (job.status, job.error)
        assert job.migrations == []
        _assert_exact(job.result, "2pc:3")
        g = fleet.gauges()
        assert g["quiesced_devices"] == [1]
        assert g["pools_quiesced"] == 1
        assert g["devices"]["device-1"]["quiesced"] is True
        assert g["devices"]["device-1"]["lost"] is False
        assert fleet.wake_pool(1, reason="test")
        g = fleet.gauges()
        assert g["quiesced_devices"] == []
        assert g["pools_woken"] == 1
    finally:
        fleet.close()


def test_flaky_device_wedge_migrates_not_degrades(tmp_path):
    """``device.flaky@p=1``: the routed job freezes once on its device; the
    wedge opens only that pool's breaker (``breaker_k=1``), the listener
    wakes the monitor, and the held job migrates to the healthy pool and
    runs the device engine there, never the host (the chip phase's
    ``fleet_breaker`` on the CPU)."""
    fleet = _fleet(tmp_path, devices=2, chaos="seed=3;device.flaky@p=1:depth=2",
                   pool_kw={"breaker_k": 1, "stall_s": 4.0})
    try:
        job = fleet.submit("2pc:3")
        first = job.device
        assert job.pool_job.chaos["freeze_at_depth"] == 2
        assert job.wait(timeout=240)
        assert job.status == "done", job.error
        assert job.device == 1 - first and len(job.migrations) == 1
        assert job.pool_job.engine == "xla" and not job.pool_job.degraded
        _assert_exact(job.result, "2pc:3")
        g = fleet.gauges()
        assert g["device_flakes"] == 1 and g["host_last_resort"] == 0
        assert g["devices"][f"device-{first}"]["breaker"]["state"] == "open"
        assert g["devices"][f"device-{1 - first}"]["breaker"]["state"] == "closed"
        assert g["breaker"]["open_devices"] == [f"device-{first}"]
    finally:
        fleet.close()


# --- routing (disarmed pools) -------------------------------------------------


def test_fleet_host_last_resort_only_when_all_open(tmp_path):
    fleet = _fleet(tmp_path, devices=2, pool_kw={"max_inflight": 0})
    try:
        with fleet.pools[0]._cond:
            fleet.pools[0]._breaker = "open"
        job = fleet.submit("2pc:3")
        assert job.device == 1
        assert job.pool_job.engine_force is None
        assert not fleet.degraded
        assert fleet.gauges()["host_last_resort"] == 0

        with fleet.pools[1]._cond:
            fleet.pools[1]._breaker = "open"
        assert fleet.degraded
        last = fleet.submit("2pc:3")
        assert last.pool_job.engine_force == "host"
        assert fleet.gauges()["host_last_resort"] == 1
        assert fleet.gauges()["breaker"]["state"] == "open"

        with fleet.pools[0]._cond:
            fleet.pools[0]._breaker = "closed"
        healthy_again = fleet.submit("2pc:3")
        assert healthy_again.device == 0
        assert healthy_again.pool_job.engine_force is None
    finally:
        fleet.close()


def test_fleet_idempotency_and_admission(tmp_path):
    fleet = _fleet(tmp_path, devices=2, pool_kw={"max_inflight": 0, "max_queue": 1})
    try:
        a = fleet.submit("2pc:3", idempotency_key="k1")
        assert fleet.submit("2pc:3", idempotency_key="k1") is a
        assert fleet.gauges()["idem_dedups"] == 1
        fleet.submit("2pc:3")
        with pytest.raises(AdmissionError) as exc:
            fleet.submit("2pc:3")
        assert exc.value.retry_after_s is not None
        with pytest.raises(AdmissionError) as exc:
            fleet.submit("2pc:3", max_seconds=10_000_000.0)
        assert exc.value.retry_after_s is None
    finally:
        fleet.close()


def test_fleet_concurrent_same_key_submits_dedupe(tmp_path):
    fleet = _fleet(tmp_path, devices=2, pool_kw={"max_inflight": 0})
    try:
        results = []
        threads = [threading.Thread(target=lambda: results.append(
            fleet.submit("2pc:3", idempotency_key="kc"))) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(results) == 4
        assert len({id(r) for r in results}) == 1
        assert sum(1 for j in fleet.jobs() if j.idempotency_key == "kc") == 1
        assert fleet.gauges()["idem_dedups"] == 3
        with pytest.raises(AdmissionError):
            fleet.submit("2pc:3", idempotency_key="kr", max_seconds=10_000_000.0)
        assert all(j.idempotency_key != "kr" for j in fleet.jobs())
        retry = fleet.submit("2pc:3", idempotency_key="kr")
        assert retry.pool_job is not None
        assert len(_live_monitors()) == 1
    finally:
        fleet.close()


def test_fleet_submit_unwinds_on_non_admission_errors(tmp_path):
    fleet = _fleet(tmp_path, devices=2, pool_kw={"max_inflight": 0})
    try:
        with pytest.raises(ValueError):
            fleet.submit("not-a-spec", idempotency_key="kz")
        assert fleet.jobs() == []
        assert fleet.gauges()["rejected"] == 1
        good = fleet.submit("2pc:3", idempotency_key="kz")
        assert good.pool_job is not None
    finally:
        fleet.close()


def test_elastic_wake_on_pressure(tmp_path):
    fleet = _fleet(tmp_path, devices=2, elastic=True,
                   pool_kw={"max_inflight": 0, "max_queue": 1})
    try:
        assert fleet.quiesce_pool(1, reason="test")
        a = fleet.submit("2pc:3")
        assert a.device == 0
        b = fleet.submit("2pc:3")
        assert b.device == 1
        g = fleet.gauges()
        assert g["pools_woken"] == 1
        assert g["quiesced_devices"] == []
        woken_before = fleet.gauges()["pools_woken"]
        with pytest.raises(AdmissionError) as exc:
            fleet.submit("2pc:3", max_seconds=10_000_000.0)
        assert exc.value.retry_after_s is None
        assert fleet.gauges()["pools_woken"] == woken_before
    finally:
        fleet.close()


def test_evacuate_skips_forced_host_jobs(tmp_path):
    svc = CheckerService(_config(tmp_path, max_inflight=0))
    try:
        host_job = svc.submit("2pc:3", engine="host")
        dev_job = svc.submit("2pc:3")
        out = svc.evacuate(reason="device lost")
        assert [j.id for j in out] == [dev_job.id]
        assert dev_job.status == "migrated"
        assert host_job.status == "queued"
    finally:
        svc.close()


def test_fleet_session_cap_holds_under_concurrent_registration(tmp_path):
    fleet = _fleet(tmp_path, devices=2, max_sessions=1,
                   pool_kw={"max_inflight": 0, "max_sessions": 4})
    try:
        admitted, rejected = [], []

        def grab():
            checker = types.SimpleNamespace(model=lambda: object(), attach_job=lambda jid: None)
            try:
                admitted.append(fleet.register_interactive(checker, label="swarm"))
            except AdmissionError as e:
                rejected.append(e)

        threads = [threading.Thread(target=grab) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(admitted) == 1
        assert len(rejected) == 5
        assert all(e.retry_after_s is not None for e in rejected)
        assert fleet.gauges()["interactive"] == 1
        fleet.release_interactive(admitted[0])
        assert fleet.gauges()["interactive"] == 0
    finally:
        fleet.close()


def test_pinned_pools_pass_their_ordinal(tmp_path):
    """``pin_devices=True`` gives pool ``i`` ``device_ordinal=i`` (its
    workers' ``--device i``); the default leaves every pool unpinned."""
    pinned = FleetService(FleetConfig(run_dir=str(tmp_path / "p"), devices=3, pin_devices=True,
                                      pool=_config(tmp_path, max_inflight=0)))
    free = FleetService(FleetConfig(run_dir=str(tmp_path / "f"), devices=2,
                                    pool=_config(tmp_path, max_inflight=0)))
    try:
        assert [p._cfg.device_ordinal for p in pinned.pools] == [0, 1, 2]
        assert [p._cfg.device for p in pinned.pools] == ["device-0", "device-1", "device-2"]
        assert [p._cfg.breaker_mode for p in pinned.pools] == ["halt"] * 3
        assert [p._cfg.device_ordinal for p in free.pools] == [None, None]
    finally:
        pinned.close()
        free.close()


# --- durability ---------------------------------------------------------------


def _records():
    records = []

    def rec(event, **kw):
        records.append({"v": 1, "seq": len(records) + 1, "event": event, **kw})

    rec("routed", ts=1.0, job="fjob-0001", spec="2pc:3", device=0,
        pool_job="job-0001", idempotency_key="k1",
        tenant="t9", priority="interactive", deadline_s=120.0)
    rec("routed", ts=1.5, job="fjob-0002", spec="abd:2", device=1,
        pool_job="job-0001", idempotency_key=None)
    rec("migrated", ts=2.0, job="fjob-0001", from_device=0, to_device=1,
        pool_job="job-0002", reason="device-0 lost")
    rec("quiesced", ts=2.5, device=2, reason="idle")
    rec("quiesced", ts=2.6, device=1, reason="idle")
    rec("woken", ts=3.0, device=1, reason="pressure")
    return records


def test_fleet_replay_folds_routes_and_migrations():
    """The reference's test expects a route dict without ``symmetry``, but
    its ``_fleet_replay`` folds ``symmetry`` into every route (None for a
    record without one); the port pins what the code does."""
    state = _fleet_replay(_records())
    assert state["next_id"] == 2
    assert state["routes"]["fjob-0001"] == {
        "device": 1, "pool_job": "job-0002", "spec": "2pc:3",
        "idempotency_key": "k1", "trace_id": None,
        "tenant": "t9", "priority": "interactive", "deadline_s": 120.0,
        "symmetry": None,
    }
    assert state["routes"]["fjob-0002"]["device"] == 1
    assert state["routes"]["fjob-0002"]["tenant"] == "default"
    assert state["routes"]["fjob-0002"]["priority"] == "batch"
    assert state["idem"] == {"k1": "fjob-0001"}
    assert state["migrations"] == {"fjob-0001": 1}
    assert state["counters"]["routed"] == 2
    assert state["counters"]["migrations"] == 1
    assert state["order"] == ["fjob-0001", "fjob-0002"]
    assert state["quiesced"] == {2}
    assert state["counters"]["pools_quiesced"] == 2
    assert state["counters"]["pools_woken"] == 1


def _snapshot_then(records):
    """A compaction snapshot of the first three records' state, then the
    rest, as ``Journal.compact`` leaves a log."""
    base = _fleet_replay(records[:3])
    snap = {"v": 1, "seq": 3, "event": "snapshot", "ts": 2.1,
            "state": {**base, "quiesced": sorted(base["quiesced"])}}
    return [snap] + records[3:] + [
        {"v": 1, "seq": 7, "event": "recovered", "ts": 3.5},
        {"v": 1, "seq": 8, "event": "routed", "ts": 4.0, "job": "fjob-0007", "spec": "2pc:4",
         "device": 2, "pool_job": "job-0003", "idempotency_key": "k7", "symmetry": "on"},
        {"v": 1, "seq": 9, "event": "migrated", "ts": 4.5, "job": "nope", "to_device": 0,
         "pool_job": "job-0009"},
    ]


@pytest.mark.parametrize("shape", ["events", "snapshot"])
def test_fleet_replay_equals_the_reference(shape):
    records = _records() if shape == "events" else _snapshot_then(_records())
    assert _fleet_replay(records) == ref_fleet_replay(records)


def test_fleet_restart_replays_routing(tmp_path):
    f1 = _disarmed(tmp_path)
    a = f1.submit("2pc:3", idempotency_key="fa")
    f1.submit("2pc:4", idempotency_key="fb")
    f1.submit("abd:2", idempotency_key="fc")
    routes1 = {j.id: (j.device, j.pool_job.id) for j in f1.jobs()}
    assert len({d for d, _ in routes1.values()}) == 3  # spread
    f1.close()

    f2 = _disarmed(tmp_path)
    try:
        routes2 = {j.id: (j.device, j.pool_job.id) for j in f2.jobs()}
        assert routes1 == routes2
        assert all(j.recovered for j in f2.jobs())
        rec = f2.gauges()["journal"]["recovery"]
        assert rec["torn"] is None
        assert rec["routes_recovered"] == 3 and rec["attached"] == 3
        assert all(j.pool_job.status == "queued" for j in f2.jobs())
        again = f2.submit("2pc:3", idempotency_key="fa")
        assert again is f2.job(a.id)
        assert f2.gauges()["idem_dedups"] == 1
    finally:
        f2.close()


def test_fleet_restart_adopts_pool_jobs_lost_from_torn_fleet_tail(tmp_path):
    f1 = _disarmed(tmp_path)
    f1.submit("2pc:3", idempotency_key="ta")
    f1.submit("abd:2", idempotency_key="tb")
    f1.close()
    fpath = os.path.join(str(tmp_path / "fleet"), "fleet.jsonl")
    data = open(fpath, "rb").read()
    cut = data[:-1].rfind(b"\n") + 1
    with open(fpath, "wb") as fh:
        fh.write(data[:cut])

    f2 = _disarmed(tmp_path)
    try:
        assert f2.gauges()["journal"]["recovery"]["routes_recovered"] >= 1
        jobs_before = len(f2.jobs())
        again = f2.submit("abd:2", idempotency_key="tb")
        assert len(f2.jobs()) == jobs_before
        assert again.pool_job.idempotency_key == "tb"
        assert f2.gauges()["idem_dedups"] == 1
    finally:
        f2.close()


def test_fleet_restart_reroutes_orphans_from_journaled_spec(tmp_path):
    f1 = _disarmed(tmp_path, devices=2)
    a = f1.submit("2pc:3", idempotency_key="oa")
    victim = a.device
    f1.close()
    os.remove(os.path.join(str(tmp_path / "fleet"), f"device-{victim}", "journal.jsonl"))

    f2 = _disarmed(tmp_path, devices=2, interval=60.0)
    try:
        assert f2.job(a.id).pool_job is None
        assert f2.gauges()["journal"]["recovery"]["orphaned"] == 1
    finally:
        f2.close()

    f3 = _disarmed(tmp_path, devices=2, interval=60.0)
    try:
        fjob = f3.job(a.id)
        assert fjob.pool_job is None
        assert f3._migrate_stragglers() == 1
        assert fjob.pool_job is not None and fjob.pool_job.spec == "2pc:3"
        assert fjob.device is not None
        assert len(fjob.migrations) >= 1
        assert f3.gauges()["migrations"] >= 1
        fjob._orphan_spec = None
        fjob.pool_job = None
        f3._migrate_stragglers()
        assert fjob.done and "unrecoverable" in fjob.error
        assert fjob.wait(timeout=1.0)
        fjob._rejected = None
        fjob._orphan_spec = "not-a-registered-spec"
        f3._migrate_stragglers()
        assert fjob.done and "migration failed" in fjob.error
    finally:
        f3.close()


def test_fleet_snapshot_keeps_the_symmetry_mode(tmp_path):
    """The port's compaction snapshot keeps each route's symmetry mode (the
    reference's drops it), so an orphan re-routed after a restart runs
    with the mode it was submitted with."""
    f1 = FleetService(FleetConfig(run_dir=str(tmp_path / "fleet"), devices=2,
                                  monitor_interval_s=60.0, journal_compact_every=2,
                                  pool=_config(tmp_path, max_inflight=0)))
    a = f1.submit("2pc:3", idempotency_key="sa", symmetry="on")
    f1.submit("2pc:3", idempotency_key="sb")  # the second append compacts
    f1.close()
    records = read_journal(os.path.join(str(tmp_path / "fleet"), "fleet.jsonl")).records
    assert [r["event"] for r in records] == ["snapshot"]
    assert records[0]["state"]["routes"][a.id]["symmetry"] == "on"
    os.remove(os.path.join(str(tmp_path / "fleet"), f"device-{a.device}", "journal.jsonl"))
    f2 = _disarmed(tmp_path, devices=2, interval=60.0)
    try:
        assert f2.job(a.id).symmetry == "on"
        assert f2._migrate_stragglers() == 1
        assert f2.job(a.id).pool_job.symmetry == "on"
    finally:
        f2.close()


def test_fleet_trace_id_spans_routing_and_restart(tmp_path):
    f1 = _disarmed(tmp_path)
    a = f1.submit("2pc:3", idempotency_key="ft")
    tid = a.trace_id
    assert tid and a.pool_job.trace_id == tid
    assert a.snapshot()["trace_id"] == tid
    f1.close()

    f2 = _disarmed(tmp_path)
    try:
        fjob = f2.job(a.id)
        assert fjob.trace_id == tid
        assert fjob.pool_job.trace_id == tid
    finally:
        f2.close()


def test_fleet_migration_keeps_trace_id(tmp_path):
    f1 = _disarmed(tmp_path, devices=2, interval=60.0)
    a = f1.submit("2pc:3", idempotency_key="mt")
    tid = a.trace_id
    victim = a.device
    f1.close()
    os.remove(os.path.join(str(tmp_path / "fleet"), f"device-{victim}", "journal.jsonl"))

    f2 = _disarmed(tmp_path, devices=2, interval=60.0)
    try:
        fjob = f2.job(a.id)
        assert fjob.trace_id == tid
        assert f2._migrate_stragglers() == 1
        assert fjob.pool_job is not None
        assert fjob.pool_job.trace_id == tid
    finally:
        f2.close()


def test_fleet_pools_export_chaos_to_workers(tmp_path):
    """The reference's test builds its fake job without ``symmetry``, which
    ``_worker_env`` reads; the port's fake job carries ``symmetry=None``."""
    spec = "seed=5;checkpoint.torn@n=1"
    fleet = FleetService(FleetConfig(run_dir=str(tmp_path / "fleet"), devices=2,
                                     pool=_config(tmp_path, max_inflight=0), chaos=spec))
    try:
        live = chaos.plan()
        assert live is not None and live.spec == spec
        assert all(p._cfg.chaos == spec for p in fleet.pools)
        env = fleet.pools[0]._worker_env(
            types.SimpleNamespace(trace_path="unused", symmetry=None), device=False)
        assert env["STPU_CHAOS"] == spec
    finally:
        fleet.close()


# --- across packages ----------------------------------------------------------


def _drive_fleet(fleet_cls, fleet_config_cls, config_cls, run_dir):
    """One fleet's run dir: three keyed submissions (one with a QoS class,
    one under symmetry), a lost device whose job the monitor migrates, and
    a quiesced and woken pool; the pools run no worker."""
    fleet = fleet_cls(fleet_config_cls(
        run_dir=run_dir, devices=3, monitor_interval_s=0.3, elastic=True,
        idle_quiesce_s=3600.0,
        pool=config_cls(platform="cpu", max_inflight=0, probe_auto=False,
                        admission_lint=False)))
    try:
        a = fleet.submit("2pc:3", idempotency_key="x1", tenant="t1",
                         priority="interactive", deadline_s=120.0)
        fleet.submit("2pc:4", idempotency_key="x2")
        fleet.submit("2pc:3", idempotency_key="x3", symmetry="on")
        fleet.device_lost(a.device)
        deadline = time.monotonic() + 30
        while not a.migrations and time.monotonic() < deadline:
            time.sleep(0.05)
        assert len(a.migrations) == 1
        quiet = next(i for i in range(3) if i != a.device and i not in fleet._lost)
        assert fleet.quiesce_pool(quiet, reason="test")
        routes = {j.id: (j.device, j.pool_job.id) for j in fleet.jobs()}
    finally:
        fleet.close()
    return routes, quiet


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_fleet_run_dir_restarts_in_the_other_package(tmp_path, writer):
    run_dir = str(tmp_path / "fleet")
    port = (FleetService, FleetConfig, ServiceConfig)
    ref = (RefFleetService, RefFleetConfig, RefConfig)
    routes, quiet = _drive_fleet(*(port if writer == "port" else ref), run_dir)
    path = os.path.join(run_dir, "fleet.jsonl")
    records = read_journal(path).records
    assert records == ref_read(path).records
    assert _fleet_replay(records) == ref_fleet_replay(records)
    events = [r["event"] for r in records]
    assert events.count("routed") == 3 and events.count("migrated") == 1
    fleet_cls, fleet_config_cls, config_cls = ref if writer == "port" else port
    other = fleet_cls(fleet_config_cls(
        run_dir=run_dir, devices=3, monitor_interval_s=60.0,
        pool=config_cls(platform="cpu", max_inflight=0, probe_auto=False,
                        admission_lint=False)))
    try:
        assert {j.id: (j.device, j.pool_job.id) for j in other.jobs()} == routes
        assert other._idem == {"x1": "fjob-0001", "x2": "fjob-0002", "x3": "fjob-0003"}
        assert [len(j.migrations) for j in other.jobs()] == [1, 0, 0]
        assert other._quiesced == {quiet}
        rec = other.gauges()["journal"]["recovery"]
        assert (rec["routes_recovered"], rec["attached"], rec["orphaned"]) == (3, 3, 0)
        assert other.submit("2pc:4", idempotency_key="x2") is other.job("fjob-0002")
        assert other.job("fjob-0001").tenant == "t1"
    finally:
        other.close()


# --- /.metrics ----------------------------------------------------------------


def test_fleet_metrics_per_device_rows_no_double_count(tmp_path):
    from stateright_tpu_torch.checker.explorer import make_app
    from stateright_tpu_torch.models.two_phase_commit import PackedTwoPhaseSys
    from stateright_tpu_torch.obs import promexport as pe

    fleet = FleetService(FleetConfig(
        run_dir=str(tmp_path / "fleet"), devices=2,
        pool=ServiceConfig(platform="cpu", max_inflight=0, probe_auto=False,
                           admission_lint=False)))
    try:
        fleet.submit("2pc:3", idempotency_key="m1")
        fleet.submit("2pc:3", idempotency_key="m1")  # fleet-level dedup
        app, checker = make_app(PackedTwoPhaseSys(2).checker(), service=fleet, device="cpu",
                                frontier_capacity=1 << 8, table_capacity=1 << 10)
        try:
            parsed = pe.parse_openmetrics(app.metrics_text())
            dev0 = frozenset({("device", "device-0")})
            dev1 = frozenset({("device", "device-1")})
            assert ("stpu_pool_queued", dev0) in parsed
            assert ("stpu_pool_queued", dev1) in parsed
            assert ("stpu_pool_queued", frozenset()) not in parsed
            assert sum(v for (n, labs), v in parsed.items() if n == "stpu_pool_queued") == 1
            assert sum(v for (n, labs), v in parsed.items()
                       if n == "stpu_pool_interactive") == 1
            assert parsed[("stpu_fleet_routed_total", frozenset())] == 1
            assert parsed[("stpu_fleet_idem_dedups_total", frozenset())] == 1
            assert parsed[("stpu_fleet_submitted_total", frozenset())] >= 2
            assert parsed[("stpu_fleet_device_count", frozenset())] == 2
            assert ("stpu_fleet_breaker_open", frozenset()) in parsed
            assert ("stpu_pool_breaker_open", dev0) in parsed
            assert not any(n == "stpu_fleet_queued" for n, _ in parsed)
            status = app.status()
            assert status["pool"]["fleet"] is True and status["job"] == app._job.id
            assert app.pool()[1]["device_count"] == 2
        finally:
            app.close()
        assert fleet.gauges()["interactive"] == 0
    finally:
        fleet.close()


@pytest.mark.parametrize("ordinal, cards, want", [(None, 1, None), (0, 1, "cuda:0"),
                                                  (1, 1, None), (1, 2, "cuda:1")])
def test_worker_device_ordinal_and_its_fallback(monkeypatch, ordinal, cards, want):
    """A pinned pool's worker runs on ``cuda:<i>``; an ordinal the machine
    lacks (pool 1 of a fleet on one card) falls back to the default card,
    with no label, and selects no device by an index-less name."""
    import argparse

    from stateright_tpu_torch import backend
    from stateright_tpu_torch.service import worker

    selected = []
    monkeypatch.setattr(backend, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", selected.append)
    args = argparse.Namespace(engine="xla", platform="default", device=ordinal)
    device, label = worker._resolve_device(args)
    assert label == want
    assert str(device) == (want or "cuda")
    assert selected == ([torch.device(want)] if want else [])
