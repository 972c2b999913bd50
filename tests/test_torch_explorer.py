"""The port's Explorer (``stateright_tpu_torch/checker/explorer.py``) and its
GPU backend (``checker/device_on_demand.py``), on the CPU, held against the
JAX package's Explorer and against each other.

- The cases of ``tests/test_explorer.py`` (views of the init states and of a
  state's children, ignored actions, 404s, status, run-to-completion, the
  recent path) and of ``tests/test_device_explorer.py`` (the backend the
  model picks, clicks through the GPU backend equal to the host one,
  run-to-completion through the fused block, ``join()`` before it, the
  sorted and hash sets).
- The port's app against the JAX app over one click sequence on 2pc rm=3,
  with the host backend and with the GPU backend: every ``/.states`` body
  and ``/.status`` after every click equal by position, action label,
  state rendering and counts. Object fingerprints differ between the
  packages (the port's tag a class's module, ROADMAP C), so each app is
  navigated by its own fingerprints, and the comparison sets them (and the
  encoded discovery paths made of them) aside, with the JAX app's service
  keys (``job``, ``degraded``, ``pool``, ``metrics.job_id``). Within the
  port, the GPU and host backends agree on fingerprints exactly.
- A live socket on ``127.0.0.1:0``: ``/.status``, a click, ``/.metrics``
  parsed back with its counters equal to ``metrics()``, the service-less
  404s, the UI files; a full service refusing the session; and ``explore`` of 2pc's and
  paxos's command lines and ``serve`` of a packed model, each started
  in-process on a free port and asked for ``/.status``.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from typing import Any, List, Optional

import pytest
import torch

from stateright_tpu.checker.explorer import make_app as ref_make_app
from stateright_tpu.models import two_phase_commit as ref_2pc
from stateright_tpu_torch.checker import explorer
from stateright_tpu_torch.checker.device_on_demand import DeviceOnDemandChecker
from stateright_tpu_torch.checker.explorer import make_app
from stateright_tpu_torch.checker.on_demand import OnDemandChecker
from stateright_tpu_torch.core import Model, Property
from stateright_tpu_torch.fingerprint import fingerprint
from stateright_tpu_torch.models import paxos
from stateright_tpu_torch.models import two_phase_commit as port_2pc
from stateright_tpu_torch.models.two_phase_commit import PackedTwoPhaseSys, TwoPhaseSys
from stateright_tpu_torch.obs import promexport
from stateright_tpu_torch.test_util import BinaryClock

KW = dict(device="cpu", frontier_capacity=1 << 10, table_capacity=1 << 12)
REF_KW = dict(frontier_capacity=1 << 10, table_capacity=1 << 12)
#: Child positions of the click sequence (among the views with a state).
CLICKS = (0, 2, 1, 0, 3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _WithIgnoredAction(Model):
    """0 -> 1 via "go"; "stuck" is always proposed but always ignored."""

    def init_states(self) -> List[int]:
        return [0]

    def actions(self, state: int, actions: List[Any]) -> None:
        actions.extend(["go", "stuck"])

    def next_state(self, state: int, action: Any) -> Optional[int]:
        if action == "go" and state == 0:
            return 1
        return None

    def properties(self) -> List[Property]:
        return [Property.sometimes("reaches 1", lambda _m, s: s == 1)]


# --- stateright's handler cases (tests/test_explorer.py) ---------------------


def test_init_states_view():
    app, _checker = make_app(BinaryClock().checker())
    code, body = app.states("/")
    assert code == 200 and len(body) == 2
    for view, state in zip(body, (0, 1)):
        assert view["state"] == repr(state)
        assert view["fingerprint"] == str(fingerprint(state))
        assert "action" not in view
        assert tuple(view["properties"][0][:2]) == ("Always", "in [0, 1]")


def test_next_states_view_and_ignored_actions():
    app, _ = make_app(BinaryClock().checker())
    code, (view,) = app.states(f"/{fingerprint(0)}")
    assert code == 200
    assert view["action"] == "GoHigh" and view["fingerprint"] == str(fingerprint(1))
    assert view["outcome"] is not None
    app, _ = make_app(_WithIgnoredAction().checker())
    code, body = app.states(f"/{fingerprint(0)}")
    assert code == 200
    # "go" produces a state; "stuck" is ignored but still listed
    # (explorer.rs:292-300).
    assert [v["action"] for v in body] == ["'go'", "'stuck'"]
    assert "fingerprint" in body[0] and "fingerprint" not in body[1] and "state" not in body[1]


@pytest.mark.parametrize("packed", [False, True], ids=["host", "gpu"])
@pytest.mark.parametrize("path,words", [("/not-a-number", "Unable to parse"),
                                        ("/123456789", "Unable to find state")])
def test_bad_paths_404(packed, path, words):
    app, _ = (make_app(PackedTwoPhaseSys(3).checker(), **KW) if packed
              else make_app(BinaryClock().checker()))
    code, body = app.states(path)
    assert code == 404 and words in body


def test_status_reflects_demand_driven_progress():
    app, _ = make_app(TwoPhaseSys(2).checker())
    status = app.status()
    assert status["model"] == "TwoPhaseSys" and status["done"] is False
    assert status["state_count"] == 1  # only the init state so far
    assert [p[1] for p in status["properties"]] == [p.name for p in TwoPhaseSys(2).properties()]
    assert not {"job", "degraded", "pool"} & set(status)
    app.states("/")
    assert app.status()["state_count"] >= status["state_count"]


def test_run_to_completion_finishes_via_drive_and_recent_path():
    app, checker = make_app(TwoPhaseSys(2).checker())
    app.run_to_completion()
    app.drive()
    assert app.status()["recent_path"] is not None
    while not checker.is_done():
        app.drive()
    status = app.status()
    bfs = TwoPhaseSys(2).checker().spawn_bfs().join()
    assert status["done"] and status["unique_state_count"] == bfs.unique_state_count()
    # Discovered properties carry an encoded path usable as a /.states URL
    # (explorer.rs:187-205).
    discovered = [p for p in status["properties"] if p[2] is not None]
    assert discovered and app.states("/" + discovered[0][2])[0] == 200


# --- the GPU backend (tests/test_device_explorer.py) ---------------------------


def test_auto_engine_selection_and_service_refused(tmp_path):
    _, dev = make_app(PackedTwoPhaseSys(3).checker(), **KW)
    assert isinstance(dev, DeviceOnDemandChecker)
    _, host = make_app(TwoPhaseSys(3).checker())
    assert isinstance(host, OnDemandChecker)
    _, forced = make_app(PackedTwoPhaseSys(3).checker(), engine="host")
    assert isinstance(forced, OnDemandChecker)
    with pytest.raises(TypeError, match="spawn kwargs"):
        make_app(TwoPhaseSys(3).checker(), **KW)
    # A service with no session slot refuses the session before a checker
    # is built, through make_app and serve alike.
    from stateright_tpu_torch.service import AdmissionError, CheckerService

    svc = CheckerService(run_dir=str(tmp_path / "svc"), platform="cpu", max_sessions=0,
                         journal=False, admission_lint=False, probe_auto=False)
    try:
        for call in (lambda: make_app(TwoPhaseSys(3).checker(), service=svc),
                     lambda: explorer.serve(TwoPhaseSys(3).checker(), "127.0.0.1:0", service=svc)):
            with pytest.raises(AdmissionError, match="interactive sessions full"):
                call()
        assert svc.gauges()["rejected"] == 2
    finally:
        svc.close()


def _walk(apps, clicks=CLICKS):
    """The init states and then a path of ``clicks`` (child positions among
    the views with a state) through each app, each by its own
    fingerprints: ``[[(code, body, status) per app] per request]``."""
    paths = [""] * len(apps)
    out = []
    for pick in (None, *clicks):
        if pick is not None:
            for i, prev in enumerate(out[-1]):
                with_state = [v for v in prev[1] if "fingerprint" in v]
                paths[i] += "/" + with_state[pick % len(with_state)]["fingerprint"]
        out.append([(*app.states(path or "/"), app.status()) for app, path in zip(apps, paths)])
    return out


def _props(props):
    """Property triples with each encoded discovery path cut to its length
    (the paths are fingerprints)."""
    return [(e, n, None if p is None else len(p.split("/"))) for e, n, p in props]


def _agnostic(code, body, status):
    """A request's result with the fingerprints and the service keys set
    aside: ``(code, body, status, metrics)``."""
    if code == 200:
        body = [{**{k: v for k, v in view.items() if k != "fingerprint"},
                 "fingerprint": "fingerprint" in view, "properties": _props(view["properties"])}
                for view in body]
    rest = {k: v for k, v in status.items()
            if k not in ("job", "degraded", "pool", "metrics", "properties")}
    return code, body, {**rest, "properties": _props(status["properties"])}, status["metrics"]


def _held(mine, theirs, metric_keys):
    code, body, status, m = _agnostic(*mine)
    rcode, rbody, rstatus, rm = _agnostic(*theirs)
    assert (code, body) == (rcode, rbody)
    assert status == rstatus
    assert {k: m[k] for k in metric_keys} == {k: rm[k] for k in metric_keys}


def test_click_through_gpu_backend_matches_host_backend():
    """Within the port the two backends agree exactly: bodies (fingerprints
    and encoded discovery paths included) and counts after every click,
    and run to completion."""
    dev_app, dev = make_app(PackedTwoPhaseSys(3).checker(), **KW)
    host_app, host = make_app(TwoPhaseSys(3).checker(), engine="host")
    for (dcode, dbody, dst), (hcode, hbody, hst) in _walk([dev_app, host_app]):
        assert dcode == hcode == 200
        assert dbody == hbody
        for key in ("state_count", "unique_state_count", "max_depth", "done", "properties"):
            assert dst[key] == hst[key], key
    assert dst["metrics"]["waiting"] and dst["metrics"]["pending_pool"] > 0
    for app, c in ((dev_app, dev), (host_app, host)):
        app.run_to_completion()
        while not c.is_done():
            app.drive()
    assert (dev.state_count(), dev.unique_state_count()) == (host.state_count(),
                                                             host.unique_state_count()) == (1146, 288)
    props = {name: enc for _, name, enc in dev_app.status()["properties"]}
    assert props["commit agreement"] and props["abort agreement"]
    # The fused batch engine took over: blocks of more than one level.
    assert any(n > 1 for _, n in dev.dispatch_log) and not dev.metrics()["waiting"]


@pytest.mark.parametrize("packed", [False, True], ids=["host", "gpu"])
def test_click_sequence_matches_jax_explorer(packed, tmp_path):
    """The port's app and the JAX package's over the same clicks on 2pc rm=3,
    then run to completion: equal by position, label, rendering and
    counts; on the GPU backend, a checkpoint saved after it shows in
    ``/.status["last_checkpoint"]`` as the JAX app shows its own."""
    if packed:
        (app, c), (ref_app, ref_c) = (make_app(PackedTwoPhaseSys(3).checker(), **KW),
                                      ref_make_app(ref_2pc.PackedTwoPhaseSys(3).checker(), **REF_KW))
        keys = ("state_count", "unique_state_count", "max_depth", "pending_pool", "waiting")
    else:
        (app, c), (ref_app, ref_c) = (make_app(TwoPhaseSys(3).checker()),
                                      ref_make_app(ref_2pc.TwoPhaseSys(3).checker()))
        keys = ("engine", "state_count", "unique_state_count", "max_depth")
    for mine, theirs in _walk([app, ref_app]):
        _held(mine, theirs, keys)
    for a, checker in ((app, c), (ref_app, ref_c)):
        a.run_to_completion()
        while not checker.is_done():
            a.drive()
    mine, theirs = [(200, [], a.status()) for a in (app, ref_app)]
    _held(mine, theirs, keys)
    assert app.status()["state_count"] == 1146
    if packed:
        for checker, name in ((c, "port"), (ref_c, "ref")):
            checker.save_checkpoint(str(tmp_path / name))
        last = [a.status()["last_checkpoint"] for a in (app, ref_app)]
        assert [l.pop("path") for l in last] == [str(tmp_path / n) + ".npz" for n in ("port", "ref")]
        assert [l.pop("unix_ts") > 0 for l in last] == [True, True]
        assert last[0] == last[1] == {"depth": c._depth, "states": 1146, "unique": 288}
        assert c.metrics()["last_checkpoint_level"] == ref_c.metrics()["last_checkpoint_level"]


def test_join_before_unblock_raises_and_sorted_hash_parity():
    _, checker = make_app(PackedTwoPhaseSys(3).checker(), **KW)
    init = checker.model().init_states()[0]
    # The pending pool is keyed by the device fingerprint of each state.
    assert list(checker._pool) == [checker._host_fps([init])[0]]
    checker.check_state(init)
    assert checker._host_fps([init])[0] not in checker._pool and len(checker._pool) == 7
    with pytest.raises(RuntimeError, match="run_to_completion"):
        checker.join()
    out = {}
    for dedup in ("hash", "sorted"):
        m = PackedTwoPhaseSys(3)
        c = m.checker().spawn_on_demand(engine="xla", dedup=dedup, device="cpu",
                                        frontier_capacity=1 << 8, table_capacity=1 << 10)
        c.check_state(m.init_states()[0])
        lvl1 = sorted(c._pool)  # pending children after one click
        c.run_to_completion()
        c.join()
        out[dedup] = (lvl1, c.state_count(), c.unique_state_count(), c.max_depth())
    assert out["hash"] == out["sorted"] and out["hash"][2] == 288


def test_concurrent_requests_and_drive_keep_the_app_consistent():
    """More threads than cores poll the live series and click while a drive
    thread runs the GPU backend (on the CPU) to completion, with a short
    switch interval: every series row gets its own sequence number, no
    request fails, and the counts end exact."""
    import os
    import sys

    app, checker = make_app(PackedTwoPhaseSys(3).checker(), **KW)
    inits = app.states("/")[1]
    path = "/" + inits[0]["fingerprint"]
    errors, seqs = [], []

    def poll(n):
        try:
            for i in range(n):
                code, body = app.job_metrics("interactive", 1)
                assert code == 200
                seqs.append(body["rows"][-1]["seq"])
                assert app.states(path if i % 2 else "/")[0] == 200
        except Exception as e:  # reported below
            errors.append(e)

    def drive():
        try:
            app.run_to_completion()
            deadline = time.monotonic() + 60
            while not checker.is_done() and time.monotonic() < deadline:
                app.drive()
        except Exception as e:  # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=poll, args=(20,)) for _ in range(2 * (os.cpu_count() or 2))]
        threads.append(threading.Thread(target=drive))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert sorted(seqs) == list(range(len(seqs)))
    assert (checker.state_count(), checker.unique_state_count()) == (1146, 288)


# --- live sockets ---------------------------------------------------------------


def _get(port, path, raw=False):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
        body = resp.read()
        return (body, resp.headers["Content-Type"]) if raw else json.loads(body)


def _code(port, path) -> int:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def test_explorer_live_socket_smoke():
    """One live server on the GPU backend (on the CPU), started as ``serve``
    starts it: status, a click, run-to-completion driven by the drive
    thread, ``/.metrics`` parsed back equal to ``metrics()``, the
    service-less 404s, the live series ring and the UI files; ``stop()``
    ends every thread."""
    app, checker = make_app(PackedTwoPhaseSys(3).checker(), **KW)
    server, stop, threads = explorer.start(app, ("127.0.0.1", 0))
    port = server.server_address[1]
    try:
        status = _get(port, "/.status")
        assert status["model"] == "PackedTwoPhaseSys" and "pool" not in status
        inits = _get(port, "/.states/")
        children = _get(port, "/.states/" + inits[0]["fingerprint"])
        assert sum("state" in v for v in children) == 7
        req = urllib.request.Request(f"http://127.0.0.1:{port}/.runtocompletion", method="POST")
        with urllib.request.urlopen(req, timeout=60):
            pass
        deadline = time.monotonic() + 60
        while not _get(port, "/.status")["done"] and time.monotonic() < deadline:
            time.sleep(0.02)
        assert _get(port, "/.status")["unique_state_count"] == 288
        text, ctype = _get(port, "/.metrics", raw=True)
        assert ctype == promexport.CONTENT_TYPE
        parsed = promexport.parse_openmetrics(text.decode())
        m = checker.metrics()
        for key in ("state_count", "unique_state_count", "dispatches", "table_grows"):
            name = f"stpu_{key}_total" if key in promexport.COUNTER_KEYS else f"stpu_{key}"
            got = [v for (n, labels), v in parsed.items() if n == name and ("job", "interactive") in labels]
            assert got == [m[key]], key
        series = _get(port, "/.jobs/interactive/metrics.json?n=2")
        assert series["job"] == "interactive" and series["rows"][-1]["metrics"]["state_count"] == 1146
        for path in ("/.pool", "/.jobs/other/metrics.json", "/.jobs/x/trace.json", "/.trace.json",
                     "/nothing"):
            assert _code(port, path) == 404, path
        for path in ("/", "/app.js", "/app.css", "/.dash", "/dash.js"):
            assert _code(port, path) == 200, path
    finally:
        stop()
    assert not any(t.is_alive() for t in threads)


class _Recording(ThreadingHTTPServer):
    """The Explorer's server class, recording each instance so that a test
    can find its port and stop it."""

    made: List[ThreadingHTTPServer] = []

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        _Recording.made.append(self)


@pytest.mark.parametrize("start,model", [
    (lambda: port_2pc.main(["explore", "2", "127.0.0.1:0"]), "TwoPhaseSys"),
    (lambda: paxos.main(["explore", "1", "127.0.0.1:0"]), "ActorModel"),
    (lambda: PackedTwoPhaseSys(3).checker().serve("127.0.0.1:0", **KW), "PackedTwoPhaseSys"),
], ids=["2pc-explore", "paxos-explore", "packed-serve"])
def test_serve_in_process(monkeypatch, start, model):
    """``serve`` blocks until its server stops; started in a thread on a free
    port, asked for ``/.status`` and a click, then stopped (its drive and
    re-arm threads stop with it)."""
    monkeypatch.setattr(explorer, "ThreadingHTTPServer", _Recording)
    _Recording.made = []
    result = {}
    t = threading.Thread(target=lambda: result.setdefault("checker", start()), daemon=True)
    t.start()
    deadline = time.monotonic() + 60
    while not _Recording.made and time.monotonic() < deadline:
        time.sleep(0.01)
    (server,) = _Recording.made
    port = server.server_address[1]
    try:
        status = _get(port, "/.status")
        assert status["model"] == model and status["done"] is False
        inits = _get(port, "/.states/")
        assert _get(port, "/.states/" + inits[0]["fingerprint"])
        assert _get(port, "/.status")["state_count"] > status["state_count"]
    finally:
        server.shutdown()
        t.join(timeout=30)
    assert not t.is_alive()
    # ``serve`` returns its checker; a command line's ``main`` returns None.
    assert result["checker"] is None or type(result["checker"].model()).__name__ == model
