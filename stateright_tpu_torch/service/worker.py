"""One service job's process body: the unit of fault isolation.

Counterpart of ``stateright_tpu/service/worker.py``, with its flags, chaos
hooks, ``--out`` keys and ``--mux`` manifest. ``CheckerService`` never
touches the card from its own process: every device job runs THIS script
in its own process group under ``supervise.run_worker`` (heartbeat-polled,
killable as a group), so a wedged dispatch or a runaway model takes down
exactly one job and the service requeues it from its auto-checkpoint. The
script is runnable both as ``python -m stateright_tpu_torch.service.worker``
and by file path (the service invokes the latter).

Devices: ``--platform default`` is the card (``backend.resolve_device(None)``,
which raises where there is none); ``--platform cpu`` runs the engine on the
CPU with the kernels' plain versions; ``--device N`` is ``cuda:N`` (an
ordinal the machine does not have falls back to the default card, recorded
in the result, as the reference falls back to its backend's default).

Engines:

- ``--engine xla`` (default): ``spawn_xla`` with per-job auto-checkpointing
  (``--checkpoint``/``--every``/``--keep``), resume (``--resume``) and a
  per-job metrics time series (``--metrics``). On the card the worker
  first builds any missing kernel library (``ops._cuda.build()``) and the
  native host kit that witness paths walk (``native.build()``) under a
  ``phase="dispatch"`` heartbeat that flags ``compile``, so tens of seconds
  of ``nvcc`` get the supervisor's stretched leash instead of reading as a
  wedge; the port keeps no program cache across processes, so every worker
  captures its CUDA graphs cold.
- ``--engine host``: the host on-demand engine, unblocked and driven in
  ``--block-size`` blocks on the CPU: the breaker's degradation target.

Budgets: ``--max-states`` rides ``target_state_count``; ``--max-seconds`` is
a soft check at quiescent points that exits with code 3.

Fault injection: ``--chaos-die-at-depth N`` SIGKILLs the process at the
first quiescent point at or past depth N; ``--chaos-freeze-at-depth N``
rewrites the heartbeat to ``phase="dispatch"`` and SIGSTOPs, the signature
of a wedged dispatch. With ``--chaos-marker`` the sabotage trips exactly
once; without it, every attempt trips.

At completion the counts, discoveries and metrics land in ``--out`` (an
atomic write) under the reference's keys, plus the port's ``launches``
(the kernels' launch counters in this process), ``first_dispatch_s``
(seconds from process start to the first dispatch), ``kernel_build_s``
and ``peak_memory_bytes`` (the card's, else None).

``--mux manifest.json``: ONE worker drives K same-spec jobs through
``xla_mux.MuxChecker``; each lane's result is written the moment the lane
finishes, ``--out`` receives the group summary, and a typed ``MuxError``
falls back to driving the lanes one after another in this process.
"""

from __future__ import annotations

import time

#: Process start, as near as the script can take it: before any import of
#: torch (the ``first_dispatch_s`` the result reports counts from here).
_T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
)


def _resolve_device(args):
    """``(device, label)`` for the flags: the CPU for the host engine and
    ``--platform cpu``, else the card (``--device N`` selecting one)."""
    import torch

    from stateright_tpu_torch.backend import ordinal_device

    if args.engine == "host" or args.platform == "cpu":
        return torch.device("cpu"), None
    if args.platform != "default":
        raise SystemExit(f"--platform must be 'default' or 'cpu', got {args.platform!r}")
    return ordinal_device(args.device)


def _build_kernels(device) -> float:
    """The port's counterpart of the reference's compile-cache step: build
    every missing kernel library and the native host kit before the first
    dispatch, under a ``compile``-flagged dispatch beat (the supervisor's
    stretched leash), so that no job compiles mid-run. Returns the build's
    seconds (0 on the CPU or with every library built)."""
    if device.type != "cuda":
        return 0.0
    from stateright_tpu_torch import native, obs
    from stateright_tpu_torch.ops import _cuda

    hb = obs.resolve_heartbeat(None)
    if hb is not None:
        hb.beat("dispatch", compile=True, build=[*_cuda.SOURCES, "hostkit"])
    seconds = _cuda.build() + native.build()
    if hb is not None:
        hb.commit()
    return seconds


def _launches() -> dict:
    """This process's kernel launch counters (0 on the CPU, where every
    wrapper runs its plain version)."""
    from stateright_tpu_torch.ops import hashset
    from stateright_tpu_torch.ops.compact import compact
    from stateright_tpu_torch.ops.merge import merge_insert

    return {
        "compact": compact.launches,
        "merge_insert": merge_insert.launches,
        "hashset_insert": hashset.insert_.launches,
        "hashset_undo": hashset.undo_.launches,
    }


def _peak_memory(device):
    if device.type != "cuda":
        return None
    import torch

    return int(torch.cuda.max_memory_allocated(device))


def _lane_armed(chaos: dict) -> bool:
    """Whether a lane's sabotage flags are live (marker = exactly-once)."""
    if (
        chaos.get("die_at_depth") is None
        and chaos.get("freeze_at_depth") is None
    ):
        return False
    marker = chaos.get("marker")
    return marker is None or not os.path.exists(marker)


def _lane_trip(chaos: dict) -> None:
    marker = chaos.get("marker")
    if marker is not None:
        with open(marker, "w") as fh:
            fh.write("tripped\n")


def _job_trace():
    """The worker's end of the distributed-trace seam: the tracer named by
    ``STPU_TRACE`` inherits the submission context from ``STPU_TRACE_CTX``
    (both exported by the service), and the whole process body runs under
    ONE pre-allocated ``job`` span that the engine's dispatch spans parent
    to. Returns ``(tracer, job_sid, attempt_sid, t0)``; ``job_sid`` is None
    when tracing or context is off."""
    from stateright_tpu_torch import obs

    tracer = obs.resolve_tracer(None)
    ctx = obs.parse_ctx(os.environ.get(obs.CTX_ENV))
    if not (tracer.enabled and ctx):
        return tracer, None, None, time.monotonic()
    job_sid = tracer.new_span_id()
    tracer.set_parent(job_sid)
    return tracer, job_sid, ctx[1], time.monotonic()


def _end_job_trace(tracer, job_sid, attempt_sid, t0, **attrs) -> None:
    if job_sid is not None:
        tracer.emit(
            "job", t0=t0, dur=time.monotonic() - t0, attrs=attrs,
            parent_id=attempt_sid, span_id=job_sid,
        )


def _write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(obj, fh, default=str)
    os.replace(tmp, path)


def _discoveries(checker) -> dict:
    return {
        name: [repr(a) for a in path.into_actions()]
        for name, path in sorted(checker.discoveries().items())
    }


def _mux_main(args, device, device_label, build_s) -> int:
    """The ``--mux`` body: K lanes of one spec through the multiplexed
    engine (falling back to driving them one after another on
    ``MuxError``)."""
    from stateright_tpu_torch.service.registry import resolve
    from stateright_tpu_torch.xla_mux import MuxChecker, MuxError

    tracer, job_sid, attempt_sid, jt0 = _job_trace()
    with open(args.mux) as fh:
        manifest = json.load(fh)
    lanes_cfg = manifest["lanes"]
    model, caps = resolve(args.spec)
    chaos_armed = [_lane_armed(lane.get("chaos") or {}) for lane in lanes_cfg]
    checkers = []
    for lane in lanes_cfg:
        builder = model.checker()
        if lane.get("max_states"):
            builder = builder.target_state_count(lane["max_states"])
        kw = dict(caps, device=device)
        if any(chaos_armed):
            # One level per dispatch for EVERY lane (the batch shares one
            # dispatch cadence), so sabotage depths and checkpoint cadence
            # line up.
            kw["levels_per_dispatch"] = 1
        if lane.get("checkpoint"):
            kw.update(
                checkpoint_to=lane["checkpoint"],
                checkpoint_every=args.every,
                checkpoint_keep=args.keep,
            )
        if lane.get("metrics"):
            kw["metrics_to"] = lane["metrics"]
        if lane.get("resume"):
            kw["checkpoint"] = lane["resume"]
        checkers.append(builder.spawn_xla(**kw))
    start_depths = [ln._depth for ln in checkers]
    t0 = time.monotonic()
    first_dispatch = []

    def over_budget() -> bool:
        return (
            args.max_seconds is not None
            and time.monotonic() - t0 > args.max_seconds
        )

    try:
        mux = MuxChecker(checkers)
    except MuxError as e:
        # Graceful degradation: same process, same per-lane artifacts,
        # sequential device calls: the batch loses its win, not its jobs.
        print(f"mux ineligible, driving lanes solo: {e}", file=sys.stderr)
        mux = None

    written = [False] * len(checkers)

    def write_lane(i: int) -> None:
        ln = checkers[i]
        lane = lanes_cfg[i]
        metrics = dict(ln.metrics())
        # Lane attribution: the lane's own counts and rates, plus the
        # batch context.
        metrics["mux_lanes"] = len(checkers)
        metrics["mux_dispatches_saved"] = (
            mux._dispatches_saved if mux is not None else 0
        )
        recorder = getattr(ln, "_recorder", None)
        if recorder is not None:
            recorder.sample(metrics, kind="engine")
        result = {
            "spec": args.spec,
            "engine": "xla",
            "platform": device.type,
            "device": device_label,
            "device_ordinal": args.device,
            "degraded": False,
            "generated": ln.state_count(),
            "unique": ln.unique_state_count(),
            "max_depth": ln.max_depth(),
            "discoveries": _discoveries(ln),
            "resumed_from": lane.get("resume"),
            "start_depth": start_depths[i],
            "seconds": time.monotonic() - t0,
            "mux": {
                "group": manifest.get("group"),
                "lanes": len(checkers),
                "lane": i,
            },
            "metrics": metrics,
            "launches": _launches(),
            "first_dispatch_s": first_dispatch[0] if first_dispatch else None,
            "kernel_build_s": build_s,
            "peak_memory_bytes": _peak_memory(device),
        }
        _write_json(lane["out"], result)
        written[i] = True
        if job_sid is not None and lane.get("trace_id"):
            # Per-lane attribution in the member job's OWN trace.
            tracer.emit(
                "lane",
                t0=jt0,
                dur=time.monotonic() - jt0,
                attrs={
                    "lane": i, "group": manifest.get("group"),
                    "job": lane.get("job"), "spec": args.spec,
                },
                parent_id=job_sid,
                trace_id=lane["trace_id"],
            )

    def lane_chaos(i: int) -> None:
        if not chaos_armed[i]:
            return
        ln = checkers[i]
        chaos = lanes_cfg[i].get("chaos") or {}
        die = chaos.get("die_at_depth")
        freeze = chaos.get("freeze_at_depth")
        if die is not None and ln._depth >= die:
            _lane_trip(chaos)
            os.kill(os.getpid(), signal.SIGKILL)
        if freeze is not None and ln._depth >= freeze:
            _lane_trip(chaos)
            hb = mux._heartbeat if mux is not None else ln._heartbeat
            if hb is not None:
                hb.beat("dispatch", compile=False)
            os.kill(os.getpid(), signal.SIGSTOP)

    if mux is not None:
        while not mux.is_done():
            if not first_dispatch:
                first_dispatch.append(time.time() - _T_START)
            mux._run_block()
            # Finished lanes land their results BEFORE any sabotage fires:
            # a chaos kill mid-batch must lose only unfinished lanes.
            for i, ln in enumerate(checkers):
                if not written[i] and ln.is_done():
                    write_lane(i)
            for i in range(len(checkers)):
                lane_chaos(i)
            if over_budget():
                return 3
    else:
        for i, ln in enumerate(checkers):
            while not ln.is_done():
                if not first_dispatch:
                    first_dispatch.append(time.time() - _T_START)
                ln._run_block()
                lane_chaos(i)
                if over_budget():
                    return 3
            write_lane(i)
    for i in range(len(checkers)):
        if not written[i]:
            write_lane(i)
    summary = {
        "group": manifest.get("group"),
        "spec": args.spec,
        "engine": "xla-mux" if mux is not None else "xla",
        "mux": mux is not None,
        "lanes": len(checkers),
        "dispatches": (
            len(mux.dispatch_log)
            if mux is not None
            else sum(len(ln.dispatch_log) for ln in checkers)
        ),
        "dispatches_saved": mux._dispatches_saved if mux is not None else 0,
        "seconds": time.monotonic() - t0,
        "launches": _launches(),
        "first_dispatch_s": first_dispatch[0] if first_dispatch else None,
        "kernel_build_s": build_s,
        "peak_memory_bytes": _peak_memory(device),
    }
    _write_json(args.out, summary)
    _end_job_trace(
        tracer, job_sid, attempt_sid, jt0,
        spec=args.spec, engine=summary["engine"],
        group=manifest.get("group"), lanes=len(checkers),
    )
    return 0


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--spec", required=True)  # service/registry.py grammar
    p.add_argument("--engine", default="xla", choices=("xla", "host"))
    p.add_argument("--platform", default="default")  # "default" | "cpu"
    # Device pinning: run this job's engine on cuda:N. An ordinal the
    # machine does not have falls back to the default card (recorded in
    # the result) rather than failing the job.
    p.add_argument("--device", type=int, default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--checkpoint", default=None)  # auto-checkpoint base
    p.add_argument("--metrics", default=None)  # metrics time-series base
    p.add_argument("--resume", default=None)
    p.add_argument("--every", default="1")
    p.add_argument("--keep", type=int, default=3)
    p.add_argument("--block-size", type=int, default=1500)
    p.add_argument("--max-states", type=int, default=None)
    p.add_argument("--max-seconds", type=float, default=None)
    p.add_argument("--chaos-die-at-depth", type=int, default=None)
    p.add_argument("--chaos-freeze-at-depth", type=int, default=None)
    p.add_argument("--chaos-marker", default=None)
    # Multiplexed mode: a lane manifest path; per-lane out/checkpoint/
    # metrics/resume/chaos ride in the manifest, --out is the group summary.
    p.add_argument("--mux", default=None)
    args = p.parse_args()

    device, device_label = _resolve_device(args)
    build_s = _build_kernels(device) if args.engine == "xla" else 0.0

    if args.mux:
        return _mux_main(args, device, device_label, build_s)

    from stateright_tpu_torch.service.registry import resolve

    tracer, job_sid, attempt_sid, jt0 = _job_trace()
    model, caps = resolve(args.spec)
    builder = model.checker()
    if args.max_states:
        builder = builder.target_state_count(args.max_states)

    t0 = time.monotonic()

    def over_budget() -> bool:
        return (
            args.max_seconds is not None
            and time.monotonic() - t0 > args.max_seconds
        )

    # Chaos arming: a marker file makes sabotage exactly-once (the requeued
    # attempt runs clean); no marker means every attempt trips.
    armed = (args.chaos_die_at_depth is not None
             or args.chaos_freeze_at_depth is not None) and (
        args.chaos_marker is None or not os.path.exists(args.chaos_marker)
    )

    def trip() -> None:
        if args.chaos_marker is not None:
            with open(args.chaos_marker, "w") as fh:
                fh.write("tripped\n")

    chaos_flags = (
        args.chaos_die_at_depth is not None
        or args.chaos_freeze_at_depth is not None
    )
    if args.engine == "xla":
        kw = dict(caps, device=device)
        if chaos_flags:
            # Chaos runs force one level per dispatch, so the sabotage depth
            # and the checkpoint cadence line up deterministically;
            # production jobs keep the fused block of up to 32 levels.
            kw["levels_per_dispatch"] = 1
        if args.checkpoint:
            kw.update(
                checkpoint_to=args.checkpoint,
                checkpoint_every=args.every,
                checkpoint_keep=args.keep,
            )
        if args.metrics:
            kw["metrics_to"] = args.metrics
        if args.resume:
            kw["checkpoint"] = args.resume
        checker = builder.spawn_xla(**kw)
        step = checker._run_block
    else:
        checker = builder.spawn_on_demand(block_size=1)
        checker.run_to_completion()
        step = lambda: checker._run_block(max(args.block_size, 1))  # noqa: E731

    start_depth = checker._depth if args.engine == "xla" else 0
    first_dispatch = None

    while not checker.is_done():
        if first_dispatch is None:
            first_dispatch = time.time() - _T_START
        step()
        if args.engine == "xla":
            depth = checker._depth
            if armed and args.chaos_die_at_depth is not None and (
                depth >= args.chaos_die_at_depth
            ):
                trip()
                os.kill(os.getpid(), signal.SIGKILL)
            if armed and args.chaos_freeze_at_depth is not None and (
                depth >= args.chaos_freeze_at_depth
            ):
                trip()
                # A wedged dispatch's signature: the engine entered a
                # device dispatch and never came back.
                if checker._heartbeat is not None:
                    checker._heartbeat.beat("dispatch", compile=False)
                os.kill(os.getpid(), signal.SIGSTOP)
        if over_budget():
            return 3  # soft budget exit at a quiescent point

    metrics = checker.metrics()
    recorder = getattr(checker, "_recorder", None)
    if recorder is not None:
        # Final forced row: the series ends with the completed run's totals.
        recorder.sample(metrics, kind="engine")
    result = {
        "spec": args.spec,
        "engine": args.engine,
        "platform": device.type,
        "device": device_label,
        "device_ordinal": args.device,
        "degraded": args.engine == "host",
        "generated": checker.state_count(),
        "unique": checker.unique_state_count(),
        "max_depth": checker.max_depth(),
        "discoveries": _discoveries(checker),
        "resumed_from": args.resume,
        "start_depth": start_depth,
        "seconds": time.monotonic() - t0,
        "metrics": metrics,
        "launches": _launches(),
        "first_dispatch_s": first_dispatch,
        "kernel_build_s": build_s,
        "peak_memory_bytes": _peak_memory(device),
    }
    _write_json(args.out, result)
    _end_job_trace(
        tracer, job_sid, attempt_sid, jt0,
        spec=args.spec, engine=args.engine, resumed_from=args.resume,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
