"""The port's fault layer and supervisor (``stateright_tpu_torch/chaos.py``,
``supervise.py``) on the CPU, held against the JAX package's.

- The chaos plan: on seeded sequences of invocations, the port's
  ``ChaosPlan`` fires exactly where the reference's does, with the same
  parameters (seeded ``at`` offsets included); malformed specs raise the
  same errors; an installed plan reaches ``fire`` and ``None`` clears it.
- ``heartbeat_verdict``: the port's and the reference's verdicts agree on
  the same heartbeat files (no beat within and past the startup grace, a
  previous run's beat, stale idle, fresh and stale dispatch, the
  stretched leash of a ``compile`` beat).
- ``supervise`` over the port's own ``service/worker.py`` (real
  subprocesses on ``--platform cpu``): a SIGKILL at a seeded depth
  resumes from the newest rotation; a SIGSTOP at ``phase="dispatch"`` draws
  the stale-heartbeat verdict, the frozen group is killed and resumed; a
  rotation torn by ``STPU_CHAOS=checkpoint.torn`` in the worker is refused
  by both packages' readers and the resume falls back a rotation. Every
  result's counts, depth and discovery actions equal the JAX package's
  in-process ``spawn_xla`` on the CPU for the same spec (run once, cached).
"""

import json
import os
import random
import sys
import time

import pytest

from stateright_tpu import chaos as ref_chaos
from stateright_tpu import checkpoint as ref_ck
from stateright_tpu import supervise as ref_sup
from stateright_tpu_torch import chaos, checkpoint
from stateright_tpu_torch import supervise as sup
from stateright_tpu_torch.obs.heartbeat import Heartbeat

WORKER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "stateright_tpu_torch", "service", "worker.py")

#: Pinned full-coverage (generated, unique) counts.
PINNED = {"2pc:3": (1_146, 288), "2pc:4": (8_258, 1_568)}


@pytest.fixture(autouse=True)
def _no_ambient_chaos(monkeypatch):
    """No plan installed in either package, none in the environment, and
    one torch thread in each worker subprocess."""
    monkeypatch.delenv("STPU_CHAOS", raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    chaos.install(None)
    ref_chaos.install(None)
    yield
    chaos.install(None)
    ref_chaos.install(None)


# --- the chaos plan ----------------------------------------------------------

SPECS = (
    "seed=7;journal.torn@n=3:at=17;supervise.wedge@n=1",
    "seed=3;checkpoint.torn@p=0.5;worker.die@n=2:depth=4,once=0",
    "seed=11;journal.torn@p=0.3;lint.timeout;worker.freeze@p=0.25:depth=2",
    "journal.torn;journal.die@n=5",
)
POINTS = ("journal.torn", "journal.die", "checkpoint.torn", "supervise.wedge",
          "worker.die", "worker.freeze", "lint.timeout", "tenant.storm")


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_plan_decisions_equal_the_reference(spec):
    mine, ref = chaos.ChaosPlan(spec), ref_chaos.ChaosPlan(spec)
    assert (mine.seed, mine.rules) == (ref.seed, ref.rules)
    rng = random.Random(spec)
    fired = 0
    for _ in range(300):
        point = rng.choice(POINTS)
        ctx = {"size": rng.randint(0, 4096)} if rng.random() < 0.7 else {}
        got = mine.fire(point, **ctx)
        assert got == ref.fire(point, **ctx), point
        fired += got is not None
    assert fired > 0


def test_chaos_parse_errors_install_and_tear(tmp_path):
    for bad in ("@n=1", "journal.torn@q=1", "journal.torn:at", "x@n=z"):
        with pytest.raises(ValueError) as mine:
            chaos.ChaosPlan(bad)
        with pytest.raises(ValueError) as ref:
            ref_chaos.ChaosPlan(bad)
        assert str(mine.value) == str(ref.value)
    assert chaos.fire("journal.torn") is None and not chaos.active()
    plan = chaos.install("seed=2;supervise.wedge@n=2")
    assert chaos.install("seed=2;supervise.wedge@n=2") is plan  # same spec keeps counters
    assert [chaos.fire("supervise.wedge") for _ in range(3)] == [None, {}, None]
    chaos.install(None)
    assert chaos.fire("supervise.wedge") is None
    path = tmp_path / "f"
    path.write_bytes(b"x" * 100)
    chaos.tear_file(str(path), 40)
    assert path.stat().st_size == 40


# --- heartbeat verdicts ------------------------------------------------------


def _beat(path, phase, age, **info):
    hb = Heartbeat(str(path))
    hb.beat(phase, **info)
    t = time.time() - age
    os.utime(path, (t, t))


def test_heartbeat_verdict_equals_the_reference(tmp_path):
    now = time.time()
    kw = dict(stall_s=10.0, startup_grace_s=60.0, compile_leash=3.0)
    cases = []
    missing = tmp_path / "missing.json"
    cases += [(missing, now - 5, 5.0), (missing, now - 90, 90.0)]
    old = tmp_path / "old.json"
    _beat(old, "dispatch", 500.0)  # a previous run's beat
    cases += [(old, now - 30, 30.0), (old, now - 100, 100.0)]
    for name, phase, age, info in (
        ("idle", "idle", 400.0, {}),
        ("fresh", "dispatch", 2.0, {"compile": False}),
        ("stale", "dispatch", 25.0, {"compile": False}),
        ("capture", "dispatch", 25.0, {"compile": True}),
        ("capture_stale", "dispatch", 45.0, {"compile": True, "build": ["compact"]}),
    ):
        path = tmp_path / f"{name}.json"
        _beat(path, phase, age, **info)
        cases.append((path, now - 1000, 1000.0))
    verdicts = []
    for path, started, elapsed in cases:
        mine = sup.heartbeat_verdict(str(path), started_wall=started, elapsed_s=elapsed, **kw)
        ref = ref_sup.heartbeat_verdict(str(path), started_wall=started, elapsed_s=elapsed, **kw)
        assert mine == ref, path.name
        verdicts.append(mine)
    assert [v is None for v in verdicts] == [True, False, True, False, True, True,
                                               False, True, False]
    assert "stale" in verdicts[6] and "compile=True" in verdicts[8]


# --- supervise over the port's worker -----------------------------------------

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


def _supervised(tmp_path, spec, flag, depth, *, stall_s=600.0, env=None, retries=2):
    ck = str(tmp_path / "ck.npz")
    out = str(tmp_path / "result.json")
    marker = str(tmp_path / "chaos.marker")

    def make_argv(attempt, resume):
        argv = [sys.executable, WORKER, "--spec", spec, "--platform", "cpu",
                "--checkpoint", ck, "--out", out, "--every", "1", "--keep", "3",
                "--chaos-marker", marker, flag, str(depth)]
        if resume:
            argv += ["--resume", resume]
        return argv

    res = sup.supervise(
        make_argv, checkpoint=ck, retries=retries, backoff_s=0.1,
        heartbeat=str(tmp_path / "hb.json"), timeout_s=300, stall_s=stall_s,
        startup_grace_s=240, poll_s=0.25, env=env,
        stdout_path=lambda attempt: str(tmp_path / f"worker{attempt}.out"),
    )
    assert res.ok, [(a.rc, a.killed) for a in res.attempts]
    assert os.path.exists(marker), "the chaos flag never tripped"
    with open(out) as fh:
        return res, json.load(fh)


def test_supervise_sigkill_resumes_exact(tmp_path):
    depth = random.Random(14).randint(3, 6)
    res, result = _supervised(tmp_path, "2pc:4", "--chaos-die-at-depth", depth)
    assert res.attempts[0].rc == -9 and res.attempts[0].crashed
    assert len(res.attempts) == 2 and res.resumed_from == [None, str(tmp_path / "ck.npz")]
    assert result["resumed_from"] == res.resumed_from[-1]
    assert result["start_depth"] == depth
    assert result["platform"] == "cpu" and result["metrics"]["device"] == "cpu"
    _assert_exact(result, "2pc:4")


def test_supervise_sigstop_wedge_resumes_exact(tmp_path):
    # The frozen worker's last beat is phase="dispatch", compile=False: past
    # stall_s the verdict kills the (SIGTERM-deaf) stopped group.
    res, result = _supervised(tmp_path, "2pc:3", "--chaos-freeze-at-depth", 4, stall_s=4.0)
    first = res.attempts[0]
    assert first.wedged and "stale" in first.killed and "mid-dispatch" in first.killed
    assert res.resumed_from[-1] is not None and result["start_depth"] == 4
    _assert_exact(result, "2pc:3")
    assert not os.path.exists(tmp_path / "hb.json")  # unlinked on the way out


def test_supervise_falls_back_past_a_torn_rotation(tmp_path):
    # The worker writes a rotation after each level from depth 2 on; the
    # third write (depth 4) is torn in the worker, which then dies there.
    ck = str(tmp_path / "ck.npz")
    env = dict(os.environ, STPU_CHAOS="seed=5;checkpoint.torn@n=3")
    first = sup.run_worker(
        [sys.executable, WORKER, "--spec", "2pc:3", "--platform", "cpu", "--checkpoint", ck,
         "--out", str(tmp_path / "result.json"), "--every", "1", "--keep", "3",
         "--chaos-marker", str(tmp_path / "chaos.marker"), "--chaos-die-at-depth", "4"],
        env=env, timeout_s=300, stdout_path=str(tmp_path / "first.out"),
    )
    assert first.rc == -9 and first.crashed
    # Both packages refuse the torn rotation and fall back to the same one.
    with pytest.raises(checkpoint.CheckpointCorrupt):
        checkpoint.load_checkpoint(ck)
    with pytest.raises(ref_ck.CheckpointCorrupt):
        ref_ck.load_checkpoint(ck)
    assert checkpoint.latest_valid_checkpoint(ck) == ref_ck.latest_valid_checkpoint(ck) == ck + ".1"
    # supervise resolves the resume past it (the marker disarms the kill).
    res, result = _supervised(tmp_path, "2pc:3", "--chaos-die-at-depth", 4, retries=0)
    assert res.resumed_from == [ck + ".1"]
    assert result["start_depth"] == 3
    _assert_exact(result, "2pc:3")
