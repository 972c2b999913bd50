"""Explorer: an interactive web service for walking the state space.

Counterpart of ``stateright_tpu/checker/explorer.py`` (stateright's
``src/checker/explorer.rs``): ``serve()`` wraps a demand-driven checker
(``spawn_on_demand``) with a small HTTP API —

- ``GET /.status`` → the status view (done, model name, counts, properties
  with encoded discovery paths, recent path snapshot, the checker's
  ``metrics()``) (explorer.rs:156-176);
- ``GET /.states/{fp}/{fp}/…`` → one view per action available in the state
  reached by replaying the fingerprint path, "ignored" actions
  (``next_state`` → None) included, after asking the checker to expand each
  child on demand (explorer.rs:209-312);
- ``POST /.runtocompletion`` → unblocks the checker (explorer.rs:178-187) —

plus the telemetry surface of the JAX package: ``GET /.metrics`` (the
OpenMetrics exposition of this session, ``obs/promexport.py``), ``GET
/.jobs/interactive/metrics.json`` (the session's live metrics ring),
``GET /.dash`` (the dashboard, ``ui/dash.htm``) and the single-page UI of
``ui/`` (the port's own copy of the JAX package's).

The Explorer is one client of the checker service (``service/``), as the
reference's is: ``make_app``/``serve`` with ``service=`` check the
session cap before building the checker, register it as an interactive
pool job (served degraded on the host engine while the service's breaker
is open) and release it at ``close``; ``/.status`` then carries ``job``,
``degraded`` and ``pool``, ``/.pool`` the service's status,
``/.jobs/{id}/trace.json`` and ``/.trace.json`` the job's and the pool's
Chrome traces, ``/.jobs/{id}/metrics.json`` a batch job's series, and
``/.metrics`` the pool gauges and every job's snapshot. A
:class:`~stateright_tpu_torch.service.FleetService` serves wherever a
``CheckerService`` does: the session lands on the alive pool with the
fewest sessions under the fleet-wide cap, and ``/.metrics`` renders each
pool's rows labelled ``device="device-K"`` beside the fleet's own
``stpu_fleet_*`` families. Without a service
(``service=None``, the default: the port creates no pool of its own) the
app is the reference's service-less app: those keys are absent and those
routes answer 404.

The app logic lives in :class:`ExplorerApp`, framework-free and directly
callable: tests drive it without a live server, as stateright's tests call
the actix handlers directly (explorer.rs:314-588). The HTTP layer is a thin
stdlib ``ThreadingHTTPServer`` handler. Every checker call goes through
the app's lock: the engines are single-threaded, and on a card a CUDA graph
capture fails if another thread touches the device meanwhile. Each thread
that takes the lock selects the checker's card first.
"""

from __future__ import annotations

import contextlib
import json
import pprint
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path as FsPath
from typing import Any, Callable, List, Optional, Tuple
from urllib.parse import parse_qs

import torch

from ..backend import card_of, make_current
from ..core import Expectation
from ..core import Model as _BaseModel
from ..fingerprint import fingerprint
from ..obs import heartbeat as hb_mod
from ..obs import promexport
from ..obs.timeseries import SCHEMA_VERSION
from .path import Path

_UI_DIR = FsPath(__file__).resolve().parent.parent / "ui"
_UI_FILES = {
    "/": ("index.htm", "text/html"),
    "/app.css": ("app.css", "text/css"),
    "/app.js": ("app.js", "text/javascript"),
    "/.dash": ("dash.htm", "text/html"),
    "/dash.js": ("dash.js", "text/javascript"),
}

#: Default and largest count of rows a windowed series request returns.
_SERIES_WINDOW = 256
_SERIES_WINDOW_MAX = 4096

#: The job name of this session's own checker in ``/.metrics`` and
#: ``/.jobs/{id}/metrics.json``.
INTERACTIVE = "interactive"
#: The 404 body of the routes that need the checker service.
NO_SERVICE = "no service attached"

#: serde renders Rust unit variants with their name (explorer.rs:13 via
#: lib.rs:317), and the UI switches on these strings (ui/app.js).
_EXPECTATION_NAMES = {
    Expectation.ALWAYS: "Always",
    Expectation.SOMETIMES: "Sometimes",
    Expectation.EVENTUALLY: "Eventually",
}


class Snapshot:
    """Most-recent-path visitor state, re-armed every 4 seconds
    (explorer.rs:63-78, 90-96): between re-arms only the first visited path
    is kept, so the "recent path" display is a cheap sample, not a log."""

    def __init__(self):
        self._lock = threading.Lock()
        self._armed = True
        self.actions: Optional[List[Any]] = None

    def visit(self, path: Path) -> None:
        with self._lock:
            if not self._armed:
                return
            self._armed = False
            self.actions = path.into_actions()

    def rearm(self) -> None:
        with self._lock:
            self._armed = True


class ExplorerApp:
    """The Explorer's request handlers, independent of any HTTP machinery."""

    def __init__(self, checker, snapshot: Optional[Snapshot] = None,
                 service=None, job=None):
        self._checker = checker
        self._snapshot = snapshot or Snapshot()
        self._lock = threading.Lock()
        #: The checker service this session is a client of, and its pool
        #: job (None, None without a service).
        self._service = service
        self._job = job
        device = getattr(checker, "_device", None)
        #: The index of the card the checker runs on, selected by every
        #: thread that takes the lock (None: the host, or the CPU).
        self._card = None if device is None else card_of(device)
        # The live metrics ring of this session: each
        # /.jobs/interactive/metrics.json poll appends one sample, so a
        # polling dashboard builds the series it charts.
        self._series: deque = deque(maxlen=_SERIES_WINDOW_MAX)
        self._series_seq = 0
        self._series_epoch = time.monotonic()

    @contextlib.contextmanager
    def _locked(self):
        """The app's lock, held with the checker's card selected."""
        with self._lock:
            make_current(self._card)
            yield

    # --- handlers ---------------------------------------------------------

    def status(self) -> dict:
        """``GET /.status`` (explorer.rs:156-176)."""
        with self._locked():
            checker = self._checker
            recent = self._snapshot.actions
            out = {
                "done": checker.is_done(),
                "model": type(checker.model()).__name__,
                "state_count": checker.state_count(),
                "unique_state_count": checker.unique_state_count(),
                "max_depth": checker.max_depth(),
                "properties": self._properties(),
                "recent_path": repr(recent) if recent is not None else None,
                # The engine's metrics() snapshot: the full registry on the
                # GPU engine, the base counters on the host engine.
                "metrics": checker.metrics(),
                # The last checkpoint this checker wrote, or None.
                "last_checkpoint": getattr(checker, "_last_checkpoint", None),
                # Seconds since the heartbeat file was rewritten, or None
                # when the heartbeat is off.
                "heartbeat_age_s": self._heartbeat_age(checker),
            }
            # The service client's keys: this session's pool job, whether
            # it is served degraded (the host engine while the breaker is
            # open), and the pool's gauges.
            if self._service is not None:
                out["job"] = self._job.id if self._job is not None else None
                out["degraded"] = self._job.degraded if self._job is not None else False
                out["pool"] = self._service.gauges()
            return out

    def run_to_completion(self) -> None:
        """``POST /.runtocompletion`` (explorer.rs:178-187); the drive
        thread (:func:`serve`) or :meth:`drive` then advances the checker."""
        with self._locked():
            self._checker.run_to_completion()

    def drive(self) -> None:
        """Advance an unblocked checker by one block (the in-process
        equivalent of stateright's background worker threads)."""
        with self._locked():
            if not self._checker.is_done():
                self._checker._run_block()

    def states(self, fingerprints_str: str) -> Tuple[int, Any]:
        """``GET /.states{fingerprints}`` (explorer.rs:209-312). Returns
        ``(http_status, body)``; 404 bodies are error strings."""
        fingerprints_str = fingerprints_str.rstrip("/")
        parts = fingerprints_str.split("/")
        fingerprints: List[int] = []
        for part in parts:
            if not part:
                continue
            try:
                fingerprints.append(int(part))
            except ValueError:
                return 404, f"Unable to parse fingerprints {fingerprints_str}"
        # All but the leading empty segment must have parsed
        # (explorer.rs:233-240).
        if len(fingerprints) + 1 != len(parts):
            return 404, f"Unable to parse fingerprints {fingerprints_str}"

        with self._locked():
            model = self._checker.model()
            results = []
            # The GPU checker keys pending work by DEVICE fingerprint, which
            # only the packed codec computes: it takes the states themselves
            # (one superstep a request); the host checker takes host
            # fingerprints one at a time.
            check_states = getattr(self._checker, "check_states", None)
            if not fingerprints:
                inits = list(model.init_states())
                if check_states is not None:
                    check_states(inits)
                for state in inits:
                    fp = fingerprint(state)
                    if check_states is None:
                        self._checker.check_fingerprint(fp)
                    results.append(self._state_view(model, None, None, state, [fp]))
                return 200, results

            last_state = Path.final_state(model, fingerprints)
            if last_state is None:
                return 404, f"Unable to find state following fingerprints {fingerprints_str}"
            actions: List[Any] = []
            model.actions(last_state, actions)
            # The expansions can add discoveries, so the property triples
            # are evaluated once after all of them and shared by the views
            # (stateright rebuilds them per view, explorer.rs:256-301; once
            # a request is observably the same).
            views = []
            for action in actions:
                outcome = model.format_step(last_state, action)
                state = model.next_state(last_state, action)
                if state is not None:
                    fp = fingerprint(state)
                    if check_states is None:
                        self._checker.check_fingerprint(fp)
                    views.append((action, outcome, state, fp))
                else:
                    # "Action ignored" is still returned, for debugging
                    # (explorer.rs:292-300).
                    views.append((action, None, None, None))
            if check_states is not None:
                check_states([s for _, _, s, _ in views if s is not None])
            properties = self._properties()
            for action, outcome, state, fp in views:
                if state is not None:
                    view = self._state_view(model, model.format_action(action), outcome, state,
                                            fingerprints + [fp], properties=properties)
                else:
                    view = {"action": model.format_action(action), "properties": properties}
                results.append(view)
            return 200, results

    def close(self) -> None:
        """Releases this session's pool slot (the service's
        ``max_sessions``); ``serve`` calls it when the server stops, and an
        embedder of a long-lived service must call it too."""
        if self._service is not None and self._job is not None:
            self._service.release_interactive(self._job)

    def pool(self) -> Tuple[int, Any]:
        """``GET /.pool``: the service's gauges and per-job snapshots; 404
        without a service."""
        if self._service is None:
            return 404, NO_SERVICE
        return 200, self._service.metrics()

    def job_trace(self, job_id: str) -> Tuple[int, Any]:
        """``GET /.jobs/{id}/trace.json``: a service job's span trace as
        Chrome trace JSON (the service's mtime-cached export, served as its
        raw bytes); 404 without a service, for an unknown job or a job
        without a trace."""
        if self._service is None:
            return 404, NO_SERVICE
        try:
            path = self._service.job_trace_chrome(job_id)
        except KeyError:
            return 404, f"unknown job {job_id}"
        if path is None:
            return 404, f"job {job_id} has no span trace"
        with open(path, "rb") as fh:
            return 200, fh.read()

    def merged_trace(self) -> Tuple[int, Any]:
        """``GET /.trace.json``: the pool's merged distributed trace
        (``obs.collect`` over its run dir), as raw Chrome trace bytes; 404
        without a service or without a span file."""
        if self._service is None:
            return 404, NO_SERVICE
        path = self._service.merged_trace_chrome()
        if path is None:
            return 404, "no span traces in the run dir (tracing off?)"
        with open(path, "rb") as fh:
            return 200, fh.read()

    def metrics_text(self) -> str:
        """``GET /.metrics``: the OpenMetrics exposition of this session,
        labeled with its pool job id (``job="interactive"`` without a
        service), plus the pool gauges and every other pool job's snapshot.
        Its counters equal the checkers' ``metrics()``. A fleet's pool
        families render only as rows labelled ``device="device-K"``, its
        own state under ``stpu_fleet_*``."""
        own = self._job.id if self._job is not None else INTERACTIVE
        with self._locked():
            samples = [promexport.build_info_sample()]
            samples += promexport.engine_samples(self._checker.metrics(), {"job": own})
        if self._service is not None:
            gauges = self._service.gauges()
            devices = gauges.get("devices") or {}
            if devices:
                samples += _fleet_samples(gauges, devices)
            else:
                samples += promexport.pool_samples(gauges)
            for job in self._service.jobs():
                if self._job is not None and job.id == self._job.id:
                    continue  # this session's checker is rendered above
                m = job.metrics()
                if m is not None:
                    samples += promexport.engine_samples(m, {"job": job.id})
        return promexport.render_openmetrics(samples)

    def job_metrics(self, job_id: str, window: Optional[int] = None) -> Tuple[int, Any]:
        """``GET /.jobs/{id}/metrics.json``: a series as ``{"job",
        "window", "rows"}``, oldest row first. This session's own job (its
        pool job id, or ``interactive`` without a service) serves a live
        ring that grows one sample a poll; a service's batch job serves its
        recorded ``metrics.jsonl``; anything else answers 404."""
        # Clamped into [1, max]: a zero or negative ?n= takes the default.
        window = max(1, min(window or _SERIES_WINDOW, _SERIES_WINDOW_MAX))
        own = self._job.id if self._job is not None else INTERACTIVE
        if job_id != own:
            if self._service is None:
                return 404, NO_SERVICE
            try:
                rows = self._service.job_metrics_series(job_id, window=window)
            except KeyError:
                return 404, f"unknown job {job_id}"
            if rows is None:
                return 404, f"job {job_id} has no metrics series"
            return 200, {"job": job_id, "window": window, "rows": rows}
        # Sample, append and snapshot under one hold of the lock: the
        # server is threading.
        with self._locked():
            m = self._checker.metrics()
            seq = self._series_seq
            self._series_seq += 1
            self._series.append({
                "v": SCHEMA_VERSION,
                "unix_ts": time.time(),
                "t": round(time.monotonic() - self._series_epoch, 6),
                "seq": seq,
                "kind": "live",
                "metrics": m,
            })
            rows = list(self._series)[-window:]
        return 200, {"job": job_id, "window": window, "rows": rows}

    # --- helpers ----------------------------------------------------------

    def _heartbeat_age(self, checker) -> Optional[float]:
        hb = getattr(checker, "_heartbeat", None)
        if hb is None:
            return None
        age = hb_mod.age_s(hb.path)
        return None if age is None else round(age, 3)

    def _properties(self) -> List[Tuple[str, str, Optional[str]]]:
        """(expectation, name, encoded discovery path) triples
        (explorer.rs:187-205)."""
        checker = self._checker
        discoveries = checker.discoveries()
        return [
            (
                _EXPECTATION_NAMES[p.expectation],
                p.name,
                discoveries[p.name].encode() if p.name in discoveries else None,
            )
            for p in checker.model().properties()
        ]

    def _state_view(self, model, action, outcome, state, fps: List[int], properties=None) -> dict:
        view = {
            "state": _pretty(state),
            "fingerprint": str(fps[-1]),
            "properties": self._properties() if properties is None else properties,
        }
        if action is not None:
            view["action"] = action
        if outcome is not None:
            view["outcome"] = outcome
        # Replaying the whole path (to build the Path that as_svg takes) is
        # only worth it when the model overrides the core no-op as_svg.
        if type(model).as_svg is not _BaseModel.as_svg:
            try:
                svg = model.as_svg(Path.from_fingerprints(model, fps))
            except Exception:
                svg = None
            if svg is not None:
                view["svg"] = svg
        return view


def _fleet_samples(gauges: dict, devices: dict) -> list:
    """A fleet's ``/.metrics`` rows: the pool families only as rows
    labelled ``device`` (an unlabelled aggregate repeating them would
    double a PromQL ``sum``), and fleet-scoped state -- the fleet counters
    (a dedup or rejection happens before any pool sees it), the fleet
    breaker and ``fleet.jsonl`` -- under ``stpu_fleet_*``."""
    from ..service.fleet import FLEET_COUNTERS

    per_device = set().union(*(d.keys() for d in devices.values()))
    own = {k: v for k, v in gauges.items()
           if k not in per_device or k in ("breaker", "journal") or k in FLEET_COUNTERS}
    samples = promexport.pool_samples(own, prefix="stpu_fleet")
    for device, dev_gauges in devices.items():
        samples += promexport.pool_samples(dev_gauges, {"device": device})
    return samples


def _pretty(state: Any) -> str:
    """A multi-line state rendering (the analogue of Rust's ``{:#?}``,
    explorer.rs:49)."""
    try:
        return pprint.pformat(state, width=60)
    except Exception:
        return repr(state)


def serve(builder, addresses, engine: str = "auto", service=None, **spawn_kwargs):
    """Starts the Explorer web service and blocks until the server stops
    (checker.rs:137-144); returns the checker.

    ``addresses`` is a ``"host:port"`` string or ``(host, port)`` tuple
    (port 0: any free port; the printed line names the bound one).
    ``engine`` selects the demand-driven backend: ``"host"`` (the host
    engine), ``"xla"`` (the GPU engine,
    :class:`~stateright_tpu_torch.checker.device_on_demand.DeviceOnDemandChecker`,
    on the card unless ``device="cpu"`` rides in ``spawn_kwargs``) or
    ``"auto"``, the GPU engine whenever the model is packed. Beside the
    server, a drive thread advances an unblocked checker every 50 ms and a
    re-arm thread resets the recent-path snapshot every 4 s; both stop with
    the server (:func:`start` starts all three without blocking).
    ``service`` is the :class:`~stateright_tpu_torch.service.CheckerService`
    to join as a client (see :func:`make_app`); the session's slot is
    released when the server stops."""
    app, checker = make_app(builder, engine=engine, service=service, **spawn_kwargs)
    server, stop, threads = start(app, addresses)
    host = _parse_address(addresses)[0]
    print(f"Exploring. http://{host}:{server.server_address[1]}", flush=True)
    try:
        threads[0].join()  # the server's loop, until ``server.shutdown()``
    except KeyboardInterrupt:
        pass
    finally:
        stop()
        app.close()
    return checker


def start(app: ExplorerApp, addresses) -> Tuple[ThreadingHTTPServer, Callable[[], None],
                                                 List[threading.Thread]]:
    """Binds the Explorer's server for ``app`` and starts :func:`serve`'s
    threads without blocking: the server's loop, the drive thread and the
    re-arm thread, in that order. Returns ``(server, stop, threads)``:
    ``server.server_address`` names the bound port, and ``stop()`` shuts
    the server down, stops and joins every thread and closes the socket
    (the app stays open)."""
    host, port = _parse_address(addresses)

    class Handler(_ExplorerHandler):
        explorer_app = app

    server = ThreadingHTTPServer((host, port), Handler)
    halt = threading.Event()
    threads = [
        threading.Thread(target=server.serve_forever, daemon=True),
        threading.Thread(target=_drive_loop, args=(app, halt), daemon=True),
        threading.Thread(target=_rearm_loop, args=(app, halt), daemon=True),
    ]
    for t in threads:
        t.start()

    def stop() -> None:
        halt.set()
        server.shutdown()
        for t in threads:
            t.join()
        server.server_close()

    return server, stop, threads


def make_app(builder, engine: str = "auto", service=None, **spawn_kwargs):
    """Builds the Explorer app and its demand-driven checker without
    binding a socket (the test entry point, as explorer.rs:314-351). See
    :func:`serve` for ``engine``; ``spawn_kwargs`` reach the GPU checker
    (``device``, capacities, ``dedup``). Returns ``(app, checker)``.

    With ``service`` (a ``CheckerService`` or a ``FleetService``) the
    session is one of the pool's jobs: the session
    cap is checked BEFORE the checker is built (the GPU backend allocates
    on the card, the spend the cap exists to gate; ``AdmissionError`` past
    ``max_sessions``), the checker is registered as an interactive job, and
    while the service's breaker is open a GPU session is served degraded
    on the host engine (the capacities dropped)."""
    from ..xla import is_packed

    if engine not in ("auto", "host", "xla"):
        raise ValueError(f"engine must be 'auto', 'host' or 'xla': {engine!r}")
    if service is not None:
        service.check_session_capacity()
    snapshot = Snapshot()
    wants_device = engine == "xla" or (engine == "auto" and is_packed(builder._model))
    degraded = False
    if wants_device and service is not None and service.degraded:
        wants_device, degraded = False, True
    if wants_device:
        from .device_on_demand import DeviceOnDemandChecker

        # The snapshot visitor would force one level a dispatch in batch
        # mode: the GPU Explorer keeps the fused run-to-completion and
        # leaves the recent-path panel to the host backend.
        checker = DeviceOnDemandChecker(builder, **spawn_kwargs)
    else:
        if spawn_kwargs and not degraded:
            raise TypeError(
                f"spawn kwargs {sorted(spawn_kwargs)} only apply to the GPU "
                "engine; this model resolves to the host backend"
            )
        checker = builder.visitor(snapshot.visit).spawn_on_demand()
    if service is None:
        return ExplorerApp(checker, snapshot), checker
    job = service.register_interactive(checker, degraded=degraded)
    return ExplorerApp(checker, snapshot, service=service, job=job), checker


def _rearm_loop(app: ExplorerApp, stop: threading.Event) -> None:
    while not stop.wait(4):
        app._snapshot.rearm()


def _drive_loop(app: ExplorerApp, stop: threading.Event) -> None:
    """Advances the checker once unblocked; stateright's worker threads do
    this, here a single background thread suffices."""
    while not stop.wait(0.05):
        app.drive()


def _parse_address(addresses) -> Tuple[str, int]:
    if isinstance(addresses, (tuple, list)):
        host, port = addresses
        return str(host), int(port)
    host, _, port = str(addresses).rpartition(":")
    return host or "localhost", int(port)


class _ExplorerHandler(BaseHTTPRequestHandler):
    explorer_app: ExplorerApp = None  # set by serve()

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _send(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, payload: Any) -> None:
        self._send(code, json.dumps(payload).encode(), "application/json")

    def _send_result(self, code: int, body: Any, raw: bool = False) -> None:
        """A handler's ``(code, body)``: JSON (or, with ``raw``, JSON bytes
        already) on 200, the error string as plain text otherwise."""
        if code != 200:
            self._send(code, str(body).encode(), "text/plain")
        elif raw:
            self._send(200, body, "application/json")
        else:
            self._send_json(200, body)

    def do_GET(self):  # noqa: N802 (stdlib API)
        app = self.explorer_app
        path, _, query = self.path.partition("?")
        if path == "/.status":
            self._send_json(200, app.status())
        elif path == "/.metrics":
            self._send(200, app.metrics_text().encode(), promexport.CONTENT_TYPE)
        elif path == "/.pool":
            self._send_result(*app.pool())
        elif path.startswith("/.jobs/") and path.endswith("/metrics.json"):
            job_id = path[len("/.jobs/"):-len("/metrics.json")]
            try:
                window = int(parse_qs(query).get("n", [0])[0]) or None
            except ValueError:
                window = None
            self._send_result(*app.job_metrics(job_id, window))
        elif path.startswith("/.jobs/") and path.endswith("/trace.json"):
            self._send_result(*app.job_trace(path[len("/.jobs/"):-len("/trace.json")]), raw=True)
        elif path == "/.trace.json":
            self._send_result(*app.merged_trace(), raw=True)
        elif path.startswith("/.states"):
            self._send_result(*app.states(path[len("/.states"):]))
        elif path in _UI_FILES:
            name, content_type = _UI_FILES[path]
            f = _UI_DIR / name
            if f.exists():
                self._send(200, f.read_bytes(), content_type)
            else:
                self._send(404, b"missing UI file", "text/plain")
        else:
            self._send(404, b"not found", "text/plain")

    def do_POST(self):  # noqa: N802 (stdlib API)
        path = self.path.split("?", 1)[0]
        if path == "/.runtocompletion":
            self.explorer_app.run_to_completion()
            self._send_json(200, None)
        else:
            self._send(404, b"not found", "text/plain")
