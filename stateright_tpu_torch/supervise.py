"""Crash-recovery supervisor: run wedge-prone device work to completion.

Counterpart of ``stateright_tpu/supervise.py``, with the same verdicts,
retry ladder and worker contract:

- :func:`heartbeat_verdict` -- given the worker's heartbeat file
  (``obs/heartbeat.py``), decide *alive* (None) or a kill reason. Stale in
  ``phase="idle"`` is host work and never a kill; a stale
  ``phase="dispatch"`` beat is a wedge, with the leash stretched
  ``compile_leash`` times when the beat flags ``compile``. In the port
  ``compile`` means a CUDA graph capture (the engine's beats) or a kernel
  build (the service worker beats it around ``ops._cuda.build()``).
- :func:`run_worker` -- ONE supervised attempt: the worker in its own
  process group (``start_new_session``), the heartbeat polled, the whole
  group killed on a wedge verdict or the hard timeout (SIGTERM, then
  SIGKILL, which also takes a SIGSTOP-frozen process). The heartbeat file
  is unlinked on the way out, so a dead worker's last ``dispatch`` beat
  never reads as a wedge to an outer watcher.
- :func:`supervise` -- bounded attempts with exponential backoff, each
  retry resuming from the newest *valid* rotation of the worker's
  checkpoint (``checkpoint.latest_valid_checkpoint``: a torn newest
  rotation falls back to the one before), plus an optional last fallback
  attempt under the hard timeout alone.

The worker contract: it writes checkpoints (``spawn_xla(checkpoint_to=)``),
beats ``STPU_HEARTBEAT`` (exported into its environment here) and takes a
resume path from ``make_argv``. Workers start by ``subprocess`` only, never
by ``fork``: a forked child of a process that touched CUDA cannot use the
card.

Importing this module imports no module that launches kernels (it reads
checkpoints and heartbeats with numpy and the standard library), so a
supervisor process never starts a CUDA context of its own.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Union

from . import chaos
from . import checkpoint as ck_mod
from .obs import heartbeat as hb_mod
from .obs import trace as trace_mod


def heartbeat_verdict(
    path: str,
    *,
    started_wall: float,
    elapsed_s: float,
    stall_s: float,
    startup_grace_s: float,
    compile_leash: float = 3.0,
) -> Optional[str]:
    """The watchdog's per-poll decision: None = leave the worker alone,
    else the kill reason. Implements the heartbeat-protocol table
    (the JAX package's docs/observability.md): beats older than ``started_wall`` are a
    previous run's; a worker that never beat gets ``startup_grace_s``
    (imports + init inserts can wedge before the first dispatch); stale in
    ``phase="idle"`` is host-side work (the hard timeout governs); stale
    mid-``phase="dispatch"`` past the leash (x ``compile_leash`` when the
    beat flags a graph capture or kernel build) is a wedged worker."""
    try:
        mtime = os.stat(path).st_mtime
    except OSError:
        mtime = None
    if mtime is None or mtime < started_wall:
        if elapsed_s > startup_grace_s:
            return f"no heartbeat within {startup_grace_s:.0f}s startup grace"
        return None
    rec = hb_mod.read(path) or {}
    if rec.get("phase") != "dispatch":
        return None
    age = time.time() - mtime
    allow = stall_s * (compile_leash if rec.get("compile") else 1)
    if age > allow:
        return (
            f"heartbeat stale {age:.0f}s > {allow:.0f}s mid-dispatch "
            f"(compile={bool(rec.get('compile'))}, seq={rec.get('seq', '?')})"
            " — wedged worker"
        )
    return None


@dataclass
class WorkerResult:
    """One supervised attempt's outcome."""

    rc: Optional[int]  #: exit code; None when the watchdog killed it
    killed: Optional[str]  #: kill reason, or None for a natural exit
    seconds: float
    stdout_path: Optional[str]

    @property
    def ok(self) -> bool:
        return self.killed is None and self.rc == 0

    @property
    def wedged(self) -> bool:
        """Whether the watchdog killed this attempt on a *liveness* verdict
        (heartbeat stale mid-dispatch, or no beat within the startup
        grace) — the wedged-device signature — as opposed to the hard
        wall-clock timeout (budget exhaustion, not a device fault). The
        classification multi-job supervisors (``service/``)
        key their breaker and requeue policy on."""
        return self.killed is not None and not self.killed.startswith(
            "hard timeout"
        )

    @property
    def crashed(self) -> bool:
        """A natural exit by signal (rc < 0): the worker died mid-run —
        SIGKILL from the OOM killer, a segfault — without any watchdog
        verdict. Like a wedge, the remedy is resume-from-checkpoint; unlike
        a wedge, it is not evidence against the device."""
        return self.killed is None and self.rc is not None and self.rc < 0


def backoff_delay(attempt: int, base_s: float) -> float:
    """The retry ladder every supervisor here shares: exponential from
    ``base_s``, where ``attempt`` counts retries from 1 (attempt 0 is the
    first try and never waits)."""
    if attempt < 1 or base_s <= 0:
        return 0.0
    return base_s * (2 ** (attempt - 1))


def _kill_group(proc: subprocess.Popen, grace_s: float = 2.0) -> None:
    """Kill the worker's whole process group: TERM first (a healthy-but-slow
    tree gets to flush), then KILL — which also takes SIGSTOP-frozen
    processes, where TERM would sit pending forever."""
    for sig in (signal.SIGTERM, signal.SIGKILL):
        try:
            os.killpg(proc.pid, sig)
        except ProcessLookupError:
            break
        except OSError:
            proc.kill()
        try:
            proc.wait(timeout=grace_s)
            break
        except subprocess.TimeoutExpired:
            continue
    try:
        proc.wait(timeout=grace_s)
    except subprocess.TimeoutExpired:  # pragma: no cover - unkillable child
        pass


def run_worker(
    argv: Sequence[str],
    *,
    heartbeat: Optional[str] = None,
    timeout_s: float = float("inf"),
    stall_s: float = 1200.0,
    startup_grace_s: float = 900.0,
    compile_leash: float = 3.0,
    env: Optional[dict] = None,
    cwd: Optional[str] = None,
    stdout_path: Optional[str] = None,
    poll_s: float = 5.0,
    log: Optional[Callable[[str], None]] = None,
    on_spawn: Optional[Callable[[subprocess.Popen], None]] = None,
    tracer=None,
    trace_ctx: Optional[tuple] = None,
    trace_attrs: Optional[dict] = None,
) -> WorkerResult:
    """ONE supervised attempt of ``argv``.

    The worker runs in its own process group; with ``heartbeat`` set the
    path is exported as ``STPU_HEARTBEAT`` (the engines beat it around
    every device dispatch) and polled every ``poll_s`` under
    :func:`heartbeat_verdict`; without it only the hard ``timeout_s``
    supervises (the CPU-fallback mode: no card, no wedge). Worker stdout
    goes to ``stdout_path`` (a file, not a pipe — the parent never reads
    concurrently, so a pipe could deadlock a chatty worker, and a file
    survives for post-mortem salvage no matter how the worker dies).

    Distributed tracing (docs/observability.md): with ``tracer`` (a live
    :class:`stateright_tpu_torch.obs.Tracer`) and ``trace_ctx``
    (``(trace_id, parent_span_id)``), the attempt is recorded as ONE
    ``attempt`` span covering spawn→exit — its span id is pre-allocated
    and exported to the worker as ``STPU_TRACE_CTX``, so every span the
    worker's own tracer writes joins the submission's trace with this
    attempt as its parent. ``trace_attrs`` ride on the span (the service
    adds ``job``/``attempt``)."""
    _log = log or (lambda msg: None)
    env = dict(os.environ if env is None else env)
    if heartbeat is not None:
        heartbeat = os.path.abspath(heartbeat)
        os.makedirs(os.path.dirname(heartbeat) or ".", exist_ok=True)
        env["STPU_HEARTBEAT"] = heartbeat
    trace_id = parent_sid = attempt_sid = None
    if trace_ctx is not None:
        trace_id, parent_sid = trace_ctx
    if tracer is not None and getattr(tracer, "enabled", False) and trace_id:
        attempt_sid = tracer.new_span_id()
        env[trace_mod.CTX_ENV] = trace_mod.format_ctx(trace_id, attempt_sid)
    # heartbeat=None leaves an inherited STPU_HEARTBEAT untouched: a
    # worker whose INNER watchdog is off may still beat an OUTER
    # watcher's stage file. Callers
    # that must silence beats entirely scrub their env themselves — the
    # CPU paths and supervise()'s fallback below.
    out_fh = open(stdout_path, "w") if stdout_path else None
    t0 = time.monotonic()
    wall0 = time.time()
    killed = None
    try:
        proc = subprocess.Popen(
            list(argv),
            stdout=out_fh,
            env=env,
            cwd=cwd,
            start_new_session=True,
        )
        if on_spawn is not None:
            # Hands the live Popen to multi-job supervisors (the service's
            # close-with-kill path) — run_worker itself stays the only
            # place that polls or reaps it.
            on_spawn(proc)
        while True:
            try:
                proc.wait(timeout=poll_s)
                break
            except subprocess.TimeoutExpired:
                pass
            elapsed = time.monotonic() - t0
            if elapsed > timeout_s:
                killed = f"hard timeout {timeout_s:.0f}s"
                break
            if chaos.fire("supervise.wedge") is not None:
                # Deterministic fault injection (chaos.py):
                # a scripted wedge verdict, classified exactly like a
                # stale mid-dispatch heartbeat (WorkerResult.wedged) so
                # quarantine/breaker paths are drivable without a real
                # SIGSTOP. No-op unless an STPU_CHAOS plan names it.
                killed = "chaos: simulated wedge verdict"
                break
            if heartbeat is not None:
                killed = heartbeat_verdict(
                    heartbeat,
                    started_wall=wall0,
                    elapsed_s=elapsed,
                    stall_s=stall_s,
                    startup_grace_s=startup_grace_s,
                    compile_leash=compile_leash,
                )
                if killed is not None:
                    break
        if killed is not None:
            _log(f"killing worker group (pid {proc.pid}): {killed}")
            _kill_group(proc)
    finally:
        if out_fh is not None:
            out_fh.close()
        if heartbeat is not None:
            # Live supervision state, not an artifact: a dead worker's
            # final phase="dispatch" beat must not linger for an outer
            # watcher to read as a wedge.
            try:
                os.unlink(heartbeat)
            except OSError:
                pass
    if attempt_sid is not None:
        attrs = dict(trace_attrs or {})
        attrs.update(
            pid=proc.pid,
            rc=None if killed else proc.returncode,
            killed=killed,
        )
        tracer.emit(
            "attempt", t0=t0, dur=time.monotonic() - t0, attrs=attrs,
            parent_id=parent_sid, trace_id=trace_id, span_id=attempt_sid,
        )
    return WorkerResult(
        rc=None if killed else proc.returncode,
        killed=killed,
        seconds=time.monotonic() - t0,
        stdout_path=stdout_path,
    )


#: ``make_argv(attempt, resume)`` — the worker command line for this
#: attempt. ``resume`` is the checkpoint path to resume from (the latest
#: valid rotation), or None for a cold start.
MakeArgv = Callable[[int, Optional[str]], Sequence[str]]


@dataclass
class SuperviseResult:
    ok: bool
    attempts: List[WorkerResult] = field(default_factory=list)
    #: The resume path each attempt was handed (None = cold start), index-
    #: aligned with ``attempts``; a fallback attempt appends here too.
    resumed_from: List[Optional[str]] = field(default_factory=list)
    used_fallback: bool = False

    @property
    def final(self) -> Optional[WorkerResult]:
        return self.attempts[-1] if self.attempts else None


def supervise(
    make_argv: MakeArgv,
    *,
    checkpoint: Optional[str] = None,
    retries: int = 2,
    backoff_s: float = 5.0,
    success: Optional[Callable[[WorkerResult], bool]] = None,
    fallback_make_argv: Optional[MakeArgv] = None,
    fallback_timeout_s: Optional[float] = None,
    log: Optional[Callable[[str], None]] = None,
    stdout_path: Union[None, str, Callable[[int], str]] = None,
    **worker_kw,
) -> SuperviseResult:
    """Run a worker to success with bounded retries, resuming each retry
    from the latest valid rotation of ``checkpoint``.

    ``1 + retries`` attempts of ``make_argv(attempt, resume)``; before each
    attempt the resume path is re-resolved via
    :func:`checkpoint.latest_valid_checkpoint`, so progress a previous
    attempt checkpointed is never re-explored and a torn newest rotation
    falls back to the one before it automatically. Retries back off
    exponentially from ``backoff_s``. ``success`` (default: exit code 0)
    judges each attempt. If every attempt fails and ``fallback_make_argv``
    is given, ONE final attempt runs it — heartbeat supervision off, hard
    ``fallback_timeout_s`` only (the CPU-fallback mode) — still handed the
    latest resume path. Remaining keyword arguments go to
    :func:`run_worker`."""
    _log = log or (lambda msg: None)
    judge = success or (lambda r: r.ok)
    result = SuperviseResult(ok=False)

    def attempt_once(attempt: int, builder: MakeArgv, **kw) -> bool:
        resume = (
            ck_mod.latest_valid_checkpoint(checkpoint) if checkpoint else None
        )
        sp = stdout_path(attempt) if callable(stdout_path) else stdout_path
        res = run_worker(
            builder(attempt, resume), stdout_path=sp, log=_log, **kw
        )
        result.attempts.append(res)
        result.resumed_from.append(resume)
        if judge(res):
            result.ok = True
            return True
        _log(
            f"attempt {attempt} failed (rc={res.rc}, killed={res.killed}, "
            f"{res.seconds:.0f}s)"
        )
        return False

    for attempt in range(1 + retries):
        if attempt and backoff_s:
            delay = backoff_delay(attempt, backoff_s)
            _log(f"retry {attempt}/{retries} after {delay:.0f}s backoff")
            time.sleep(delay)
        if attempt_once(attempt, make_argv, **worker_kw):
            return result
    if fallback_make_argv is not None:
        _log("retries exhausted; falling back (heartbeat supervision off)")
        kw = dict(worker_kw)
        kw.pop("heartbeat", None)
        kw.pop("stall_s", None)
        kw.pop("startup_grace_s", None)
        kw.pop("compile_leash", None)
        # The fallback worker (typically CPU: no card, no wedge) must
        # not beat an OUTER watcher's stage file either — a long CPU
        # dispatch legitimately outlives any stall leash,
        # so an inherited STPU_HEARTBEAT would get the healthy fallback
        # killed as a "wedge".
        fenv = dict(kw.pop("env", None) or os.environ)
        fenv.pop("STPU_HEARTBEAT", None)
        kw["env"] = fenv
        if fallback_timeout_s is not None:
            kw["timeout_s"] = fallback_timeout_s
        result.used_fallback = True
        attempt_once(len(result.attempts), fallback_make_argv, **kw)
    return result


if __name__ == "__main__":  # pragma: no cover - tiny manual harness
    # python -m stateright_tpu_torch.supervise -- CMD ...   (one watched attempt)
    args = sys.argv[1:]
    if args and args[0] == "--":
        args = args[1:]
    res = run_worker(
        args,
        heartbeat=os.environ.get("STPU_HEARTBEAT"),
        timeout_s=float(os.environ.get("SUPERVISE_TIMEOUT_S", "inf")),
        stall_s=float(os.environ.get("SUPERVISE_STALL_S", "1200")),
        log=lambda m: print(f"[supervise] {m}", file=sys.stderr, flush=True),
    )
    print(f"[supervise] rc={res.rc} killed={res.killed}", file=sys.stderr)
    sys.exit(res.rc if res.rc is not None else 125)
