#!/usr/bin/env python3
"""The port's proof of life on an NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py`` on a machine
with one CUDA card and ``nvcc`` (it exits non-zero, printing no result,
where there is no card or no ``stateright_tpu_torch`` beside it). It

1. prints the card's name and power limit and builds every CUDA kernel of
   the port from ``stateright_tpu_torch/csrc`` (one ``nvcc`` per source, all
   started together);
2. checks small 2pc spaces on the card against the pinned counts, and the
   rm=4 search on the card (fused blocks of CUDA graphs) against the same
   search on the CPU (the same gated level, run eagerly): per-level
   counts and witness paths;
3. drives the main path, ``PackedTwoPhaseSys(8).checker().spawn_xla()``
   (fused blocks of up to 32 levels, each level a CUDA graph replay),
   cold and then warm on one model instance, with every launch counter
   set to 0 just before each run and read just after: exact counts
   (18,507,778 generated, 1,745,408 unique), fewer dispatches than levels,
   graphs captured by the cold run and reused by the warm one, both
   kernels launched, and every discovery re-executed to a valid witness
   path; then repeats the warm run three times for the spread and once
   under ``torch.profiler`` for the device time by kernel, the device
   operations per level and the device's idle share; times the gated copy
   of the table planes; splits the host time of a cold and a warm run of a
   fresh model instance by step of the block; sweeps the replay lookahead (``graphs.LOOKAHEAD``)
   over warm runs; runs ``levels_per_dispatch=1`` at rm=8 for the
   comparison; and holds rm=5 through graph replays against the same gated
   level run eagerly on the card: equal level and dispatch logs and
   bitwise equal table planes;
4. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (20 launches each, since a look-back race shows only
   now and then) and on ragged, overflow and adversarial cases for the
   tiles and the look-back, exactly (tolerance 0: integer work); times
   kernel, plain version and, where one PyTorch call computes the same
   function, that call, the frontier compaction on its own too; and counts
   the device operations of one call under ``torch.profiler``;
5. prints the ``{"kernels": [...]}`` line and, last, the device line.

Every line but the nvidia-smi one is a JSON object. Any failed check
raises, so the script exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

from stateright_tpu_torch import graphs
from stateright_tpu_torch.models.two_phase_commit import PackedTwoPhaseSys
from stateright_tpu_torch.ops import _cuda
from stateright_tpu_torch.ops.compact import compact, compact_plain
from stateright_tpu_torch.ops.merge import merge_insert, merge_insert_plain
from stateright_tpu_torch.ops.words import from_u32
from stateright_tpu_torch.xla import XlaChecker

#: H100 SXM device-memory rate, bytes per second (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
EXPECTED_2PC = {
    3: (1_146, 288),
    4: (8_258, 1_568),
    5: (58_146, 8_832),
    6: (402_306, 50_816),
    7: (2_744_706, 296_448),
    8: (18_507_778, 1_745_408),
}
M32 = 0xFFFFFFFF
#: Clock cycles of the sleep kernel that holds the stream while timed calls
#: are enqueued (~25 ms at the H100's clocks).
SLEEP_CYCLES = 50_000_000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def bound_ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def timed_ms(fn, reps: int = 20, queued: bool = False) -> float:
    """Mean time of ``fn()`` over ``reps`` calls, after two warm-up calls,
    by CUDA events around the calls. Back to back (the default), a call
    whose host work outlasts its device work is timed at the host's pace.
    ``queued`` first holds the stream in a sleep kernel while the host
    enqueues every call, so the events time the device work alone; only for
    an ``fn`` that never waits on the device."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_phase() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    emit({
        "phase": "device", "nvidia_smi": smi,
        "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
    })
    emit({"phase": "build", "seconds": _cuda.build(), "sources": list(_cuda.SOURCES)})


LEVEL_KEYS = ("depth", "frontier", "generated", "unique", "bucket", "cand_cap")


def levels(c) -> list:
    return [tuple(r[k] for k in LEVEL_KEYS) for r in c.level_log]


def small_phase() -> None:
    """Counts of the small spaces on the card, and rm=4 on the card equal
    to rm=4 on the CPU level by level, block by block and path by path."""
    for rm in (3, 4, 5, 6, 7):
        c = PackedTwoPhaseSys(rm).checker().spawn_xla().join()
        require((c.state_count(), c.unique_state_count()) == EXPECTED_2PC[rm], f"rm={rm} counts")
    gpu = PackedTwoPhaseSys(4).checker().spawn_xla().join()
    cpu = PackedTwoPhaseSys(4).checker().spawn_xla(device="cpu").join()
    # Buckets and blocks may differ: a card starts the candidate buffers of
    # large buckets at a sixteenth of the grid, the CPU at a quarter.
    require([r[:4] for r in levels(gpu)] == [r[:4] for r in levels(cpu)],
            "rm=4 per-level counts, card vs CPU")
    require(gpu.metrics()["graph_captures"] > 0, "rm=4 on the card ran no graph")
    dg, dc = gpu.discoveries(), cpu.discoveries()
    require(set(dg) == set(dc) and all(
        dg[k].into_actions() == dc[k].into_actions() for k in dc
    ), "rm=4 witness paths, card vs CPU")
    emit({"phase": "small", "rm": [3, 4, 5, 6, 7], "counts_ok": True, "rm4_card_equals_cpu": True,
          "rm4_dispatch_log": {"card": gpu.dispatch_log, "cpu": cpu.dispatch_log}})


def zero_launches() -> None:
    compact.launches = 0
    merge_insert.launches = 0


def drive(model, **kw):
    """One ``spawn_xla().join()`` of ``model`` timed on the host clock,
    launch counters zeroed just before and read just after."""
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    c = model.checker().spawn_xla(**kw).join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return c, wall, {"compact": compact.launches, "merge_insert": merge_insert.launches}


def check_rm8(c, launches: dict, what: str) -> dict:
    """Exact counts, both kernels launched, every witness path re-executed;
    returns the run's line."""
    counts = (c.state_count(), c.unique_state_count())
    require(counts == EXPECTED_2PC[8], f"{what}: rm=8 counts {counts}")
    require(all(n > 0 for n in launches.values()), f"{what}: kernel launches {launches}")
    t1 = time.perf_counter()
    found = c.discoveries()
    c.assert_properties()
    for name, path in found.items():
        c.assert_discovery(name, path.into_actions())
    m = c.metrics()
    return {
        "generated": counts[0], "unique": counts[1], "max_depth": c.max_depth(),
        "levels": len(c.level_log), "dispatches": m["dispatches"],
        "dispatch_log": c.dispatch_log, "launches": launches,
        "graph_captures": m["graph_captures"], "capture_s": m["graph_capture_s"],
        "dead_replays": m["dead_replays"], "shrink_exits": m["shrink_exits"],
        "table_capacity": m["table_capacity"], "frontier_capacity": m["frontier_capacity"],
        "grows": {k: m[k] for k in ("table_grows", "frontier_grows", "cand_grows")},
        "discoveries": {k: len(p) for k, p in found.items()},
        "paths_s": time.perf_counter() - t1,
    }


def main_path_phase():
    """2pc rm=8 through the entry point a user calls, cold and then warm on
    one model instance: the warm run starts from the capacities the cold
    run learned and replays the graphs it captured."""
    model = PackedTwoPhaseSys(8)
    torch.cuda.reset_peak_memory_stats()
    cold, cold_wall, cold_launches = drive(model)
    cold_line = check_rm8(cold, cold_launches, "cold")
    warm, warm_wall, warm_launches = drive(model)
    warm_line = check_rm8(warm, warm_launches, "warm")
    for line in (cold_line, warm_line):
        require(line["dispatches"] < line["levels"], f"fused blocks: {line['dispatch_log']}")
    require(cold_line["graph_captures"] > 0, "the cold run captured no graph")
    require(warm_line["graph_captures"] == 0,
            f"the warm run captured {warm_line['graph_captures']} graphs")
    require([r[:4] for r in levels(warm)] == [r[:4] for r in levels(cold)],
            "warm and cold per-level counts")
    emit({
        "phase": "rm8", "cold_wall_s": cold_wall, "warm_wall_s": warm_wall,
        "states_per_s": EXPECTED_2PC[8][0] / warm_wall,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "cold": cold_line, "warm": warm_line,
    })
    return model, warm, cold_launches


def profiled(fn):
    """``fn()`` under ``torch.profiler``: its wall and the device kernels and
    memory operations by name ``(name, ms, calls)``."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    return out, wall, kernels


def repeat_and_profile_phase(model) -> None:
    """The spread of the warm rm=8 wall over three more warm runs of the
    same model instance, then one under ``torch.profiler``: device time by
    kernel, device operations per level and the device's idle share of
    that (profiled, so slower) run's wall. Then the gated copy of the
    table planes at the run's table capacity, timed alone."""
    walls = []
    for _ in range(3):
        c, wall, _ = drive(model)
        require(c.metrics()["graph_captures"] == 0, "a repeat captured graphs")
        walls.append(wall)
    c, wall, kernels = profiled(lambda: model.checker().spawn_xla().join())
    busy_ms = sum(ms for _, ms, _ in kernels)
    ops = sum(n for _, _, n in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:12]
    cap = c.metrics()["table_capacity"]
    planes = [torch.randint(0, 2**32, (cap,), dtype=torch.int64, device="cuda") for _ in range(8)]
    flag = torch.ones((), dtype=torch.bool, device="cuda")

    def gated_copy():
        for new, old in zip(planes[:4], planes[4:]):
            old.copy_(torch.where(flag, new, old))

    emit({
        "phase": "rm8_repeat_profile", "walls_s": walls, "profiled_wall_s": wall,
        "device_busy_ms": busy_ms if kernels else "not measured",
        "device_idle_share": 1 - busy_ms / (wall * 1e3) if kernels else "not measured",
        "device_launches": ops, "levels": len(c.level_log),
        "device_ops_per_level": ops / len(c.level_log),
        "top_kernels": [{"name": k[:90], "ms": ms, "calls": n} for k, ms, n in top],
        "gated_table_copy": {"C": cap, "ms": timed_ms(gated_copy), "bound_ms": bound_ms(3 * 4 * cap * 8)},
    })


def host_split(fn):
    """``fn()`` with the host seconds spent in each step of the fused block
    summed by name: making programs (captures included), loading the
    carry, replaying levels (which waits for the card), keeping the
    committed state."""
    spent = {}
    steps = [(XlaChecker, "_program"), (XlaChecker, "_load"), (graphs, "replay_block"),
             (XlaChecker, "_keep")]
    originals = [(owner, name, getattr(owner, name)) for owner, name in steps]

    def timed(name, f):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return f(*args, **kwargs)
            finally:
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
        return call

    for owner, name, f in originals:
        setattr(owner, name, timed(name, f))
    try:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        spent["wall"] = time.perf_counter() - t0
    finally:
        for owner, name, f in originals:
            setattr(owner, name, f)
    return spent


def host_split_phase() -> None:
    """Where the host's time goes in a cold and a warm rm=8 run of a fresh
    model instance (not the main-path runs, which run unwrapped)."""
    model = PackedTwoPhaseSys(8)

    def run():
        model.checker().spawn_xla().join()

    emit({"phase": "rm8_host_split", "cold": host_split(run), "warm": host_split(run)})


def lookahead_sweep_phase(model) -> None:
    """Warm rm=8 walls at each replay lookahead, in turns, three runs each."""
    depths = (1, 2, 3, 4)
    chosen = graphs.LOOKAHEAD
    walls = {d: [] for d in depths}
    dead = {d: [] for d in depths}
    try:
        for _ in range(3):
            for d in depths:
                graphs.LOOKAHEAD = d
                c, wall, _ = drive(model)
                walls[d].append(wall)
                dead[d].append(c.metrics()["dead_replays"])
    finally:
        graphs.LOOKAHEAD = chosen
    emit({"phase": "lookahead_sweep", "chosen": chosen, "walls_s": walls, "dead_replays": dead})


def rm8_single_phase() -> None:
    """``levels_per_dispatch=1`` at rm=8, twice, for the comparison."""
    walls = []
    for _ in range(2):
        c, wall, launches = drive(PackedTwoPhaseSys(8), levels_per_dispatch=1)
        line = check_rm8(c, launches, "levels_per_dispatch=1")
        require(line["dispatches"] >= line["levels"], "one level per dispatch")
        walls.append(wall)
    emit({"phase": "rm8_single", "walls_s": walls, "levels": line["levels"],
          "dispatches": line["dispatches"], "launches": launches})


def graph_vs_eager_phase() -> None:
    """rm=5 through graph replays against the same gated level run eagerly
    on the card: equal level and dispatch logs, bitwise equal table."""
    graph = PackedTwoPhaseSys(5).checker().spawn_xla().join()
    eager = PackedTwoPhaseSys(5).checker().spawn_xla()
    eager._use_graphs = False
    eager.join()
    require(graph.metrics()["graph_captures"] > 0, "the graph run captured nothing")
    require(eager.metrics()["graph_captures"] == 0, "the eager run captured graphs")
    require(levels(graph) == levels(eager), "rm=5 level logs, graph vs eager")
    require(graph.dispatch_log == eager.dispatch_log, "rm=5 dispatch logs, graph vs eager")
    tg, te = graph._table, eager._table
    require(all(torch.equal(a, b) for a, b in zip(tg, te)), "rm=5 table planes, graph vs eager")
    require(torch.equal(graph._disc_fp, eager._disc_fp), "rm=5 discoveries, graph vs eager")
    emit({"phase": "graph_vs_eager", "rm": 5, "equal": True, "dispatch_log": graph.dispatch_log,
          "table_rows": int(tg.n), "graph_captures": graph.metrics()["graph_captures"]})


def device_ops(fn, calls: int = 5) -> dict:
    """The device operations (kernels and memsets) of one call of ``fn``, by
    name: how many the call issues and their mean device time, from
    ``torch.profiler`` over ``calls`` calls after a warm-up step (the tracer
    misses the first memset of its window). The tracer now and then loses
    whole calls' device records, so counts are per call of the most
    frequent operation (each wrapper launches its kernel once a call)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=calls, repeat=1)) as prof:
        for _ in range(calls + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    seen = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.count and not e.key.startswith("ProfilerStep")
    ]
    seen_calls = max((e.count for e in seen), default=1)
    return {
        e.key[:90]: {"per_call": e.count / seen_calls, "ms": e.self_device_time_total / e.count / 1e3,
                     "seen": e.count}
        for e in seen
    }


def kernel_timing(kernel, plain, library, n_bytes: int) -> dict:
    """A kernel's wrapper timed with the device work alone (``ms``) and back
    to back (``ms_back_to_back``), its device operations per call under the
    profiler, its plain version, the library call (or None) and the bound
    of ``n_bytes`` over the memory rate."""
    ops = device_ops(kernel)
    return {
        "ms": timed_ms(kernel, queued=True),
        "ms_back_to_back": timed_ms(kernel),
        "device_ms": sum(op["ms"] * op["per_call"] for op in ops.values()),
        "device_launches_per_call": sum(op["per_call"] for op in ops.values()),
        "plain_ms": timed_ms(plain),
        "library_ms": timed_ms(library) if library else None,
        "bound_ms": bound_ms(n_bytes),
        "device_ops": ops,
    }


def _grid_case(rng, f: int, a: int, density: float, cap: int):
    """An rm=8-shaped grid compaction: the planes of an [F, A, 2] grid and
    three per-state lanes broadcast over the A slots (P = 5), as the engine
    hands them over."""
    dev = "cuda"
    grid = from_u32(rng.integers(0, 2**32, (f, a, 2), dtype=np.uint32), dev)
    per_state = from_u32(rng.integers(0, 2**32, (3, f), dtype=np.uint32), dev)
    mask = torch.from_numpy(rng.random((f, a)) < density).to(dev)
    lanes = [grid[:, :, 0], grid[:, :, 1]] + [p[:, None].expand(f, a) for p in per_state]
    return mask, lanes, cap


def _frontier_case(rng, level: dict):
    """An rm=8-shaped frontier compaction at one level of the run: the
    is_new mask over its candidate buffer ([cand_cap], ``unique`` of the
    first ``generated`` slots set) and P = W + 1 = 3 rows of the compacted
    grid's [W + 3, cand_cap] output as lanes, into the level's bucket."""
    dev = "cuda"
    cand_cap = level["cand_cap"]
    rows = from_u32(rng.integers(0, 2**32, (5, cand_cap), dtype=np.uint32), dev)
    flags = np.zeros(cand_cap, bool)
    flags[rng.choice(level["generated"], level["unique"], replace=False)] = True
    return torch.from_numpy(flags).to(dev), [rows[0], rows[1], rows[4]], level["bucket"]


def _flat_case(rng, m: int, density: float, cap: int, offset: int = 0):
    """A 1-D mask of ``m`` flags over three contiguous lanes. A nonzero
    ``offset`` starts the mask that many bytes into its allocation, so it
    is not aligned for 16-byte loads."""
    dev = "cuda"
    base = torch.from_numpy(rng.random(m + offset) < density).to(dev)
    lanes = from_u32(rng.integers(0, 2**32, (3, m), dtype=np.uint32), dev)
    return base[offset:], list(lanes), cap


def compact_bytes(mask, n_lanes: int, n: int, cap: int, read_words: int, per_row_bytes: int) -> int:
    """Bytes a compaction must move: the mask read once, ``read_words``
    words of each kept survivor and ``per_row_bytes`` of per-row lanes read
    once, its ``n_lanes`` words written once (and n_valid)."""
    kept = min(n, cap)
    return mask.numel() + kept * read_words * 8 + per_row_bytes + n_lanes * kept * 8 + 8


def sector_bytes(mask, lanes, cap: int) -> int:
    """Bytes a compaction moves at the grain of the memory system: the mask,
    every 32-byte sector that holds a word of a kept survivor (counted once
    however many lanes share it), the survivors' lanes written once and
    n_valid."""
    kept = mask.reshape(-1).nonzero().squeeze(1)[:cap]
    cols = 1 if mask.dim() == 1 else mask.shape[1]
    row, col = kept // cols, kept % cols
    addrs = [
        lane.data_ptr() + (row * lane.stride(0) + col * (lane.stride(1) if lane.dim() == 2 else 0)) * 8
        for lane in lanes
    ]
    sectors = torch.unique(torch.cat(addrs) // 32).numel()
    return mask.numel() + sectors * 32 + len(lanes) * kept.numel() * 8 + 8


def check_compact(name: str, mask, lanes, cap: int, reps: int = 1) -> dict:
    """``reps`` kernel calls, each equal to the plain version exactly."""
    want, n_plain = compact_plain(mask, lanes, cap)
    k = min(int(n_plain), cap)
    err = 0
    for _ in range(reps):
        got, n = compact(mask, lanes, cap)
        require(int(n) == int(n_plain), f"compact {name}: n_valid")
        if k:
            err = max(err, int((got[:, :k] - want[:, :k]).abs().max()))
        require(err == 0, f"compact {name}: survivors differ")
    return {"M": mask.numel(), "cap": cap, "n_valid": int(n_plain), "reps": reps, "max_abs_err": err}


def time_compact(mask, lanes, cap: int, n: int, read_words: int, per_row_bytes: int) -> dict:
    stacked = torch.stack([lane.reshape(-1) for lane in lanes])
    flat = mask.reshape(-1)
    timing = kernel_timing(
        lambda: compact(mask, lanes, cap), lambda: compact_plain(mask, lanes, cap),
        lambda: stacked[:, flat],
        compact_bytes(mask, len(lanes), n, cap, read_words, per_row_bytes),
    )
    return {**timing, "sector_floor_ms": bound_ms(sector_bytes(mask, lanes, cap))}


def compact_phase(c, rng) -> dict:
    """B1 against its plain version at the main path's two shapes -- its
    largest grid (the widest bucket the rm=8 run dispatched, its candidate
    cap, its densest level) and its largest frontier compaction -- 20 times
    each, then on adversarial cases: a ragged M, a cap overflow, all-true
    and all-false masks, a length that is no multiple of 16 and a mask not
    aligned for 16-byte loads. Times both rm=8 shapes."""
    top = max(c.level_log, key=lambda r: r["bucket"])
    f, a = top["bucket"], c.model().max_actions
    density = max(r["generated"] / (r["bucket"] * a) for r in c.level_log if r["bucket"] == f)
    wide = max(c.level_log, key=lambda r: r["unique"])
    odd = 16 * 4096 * 7 + 9
    cases = {
        "rm8_grid": (_grid_case(rng, f, a, density, top["cand_cap"]), 20),
        "rm8_frontier": (_frontier_case(rng, wide), 20),
        "ragged": (_grid_case(rng, 1001, a, 0.25, 1 << 14), 1),
        "overflow": (_grid_case(rng, 4096, a, 0.5, 1 << 12), 1),
        "all_true": (_flat_case(rng, 1_000_003, 1.0, 1 << 20), 1),
        "all_false": (_flat_case(rng, 1_000_003, 0.0, 1 << 20), 1),
        "length_not_x16": (_flat_case(rng, odd, 0.3, 1 << 20), 1),
        "unaligned": (_flat_case(rng, odd, 0.3, 1 << 20, offset=3), 1),
    }
    out = {name: check_compact(name, *case, reps=reps) for name, (case, reps) in cases.items()}
    mask, lanes, cap = cases["rm8_grid"][0]
    timing = time_compact(mask, lanes, cap, out["rm8_grid"]["n_valid"], 2, 3 * f * 8)
    fmask, flanes, fcap = cases["rm8_frontier"][0]
    frontier = {
        "M": fmask.numel(), "P": len(flanes), "cap": fcap,
        **time_compact(fmask, flanes, fcap, out["rm8_frontier"]["n_valid"], 3, 0),
    }
    emit({"phase": "compact", "cases": out, **timing, "frontier": frontier})
    return {"max_abs_err": max(v["max_abs_err"] for v in out.values()), **timing,
            "frontier": frontier}


def _planes(rng, keys, rows: int):
    """[4, rows] int64 planes on the card: ``keys`` split into (hi, lo)
    words with random values, then all-ones pad rows."""
    out = np.full((4, rows), M32, np.uint32)
    out[0, : len(keys)] = (keys >> np.uint64(32)).astype(np.uint32)
    out[1, : len(keys)] = (keys & np.uint64(M32)).astype(np.uint32)
    out[2:, : len(keys)] = rng.integers(0, 2**32, (2, len(keys)), dtype=np.uint32)
    return from_u32(out, "cuda")


def _merge_case(rng, c: int, n_table: int, m: int, hit: float = 0.4, new: float = 0.4,
                run: int = 0, run_hit: bool = False):
    """A sorted table of ``n_table`` unique keys padded to ``c`` rows, and a
    (key, ticket)-sorted batch of ``m`` rows: a share ``hit`` of hits on
    table keys, ``new`` of fresh keys with in-batch duplicates, a run of
    ``run`` copies of one key (a table key if ``run_hit``, else a fresh
    one), and pads."""
    n_keys = int(n_table * 1.05) if n_table else m
    keys = np.unique(rng.integers(1, 2**62, n_keys, dtype=np.uint64))
    rng.shuffle(keys)
    table_keys = np.sort(keys[:n_table])
    fresh = keys[n_table:]
    n_hit, n_new = int(m * hit), int(m * new)
    parts = [
        rng.choice(table_keys, n_hit) if n_hit else np.zeros(0, np.uint64),
        rng.choice(fresh[: max(1, n_new // 4)], n_new) if n_new else np.zeros(0, np.uint64),
        np.full(run, table_keys[n_table // 2] if run_hit else fresh[-1], np.uint64),
    ]
    batch_keys = np.sort(np.concatenate(parts), kind="stable")
    return _planes(rng, table_keys, c), _planes(rng, batch_keys, m)


def _tie_case(rng, n: int, c: int, m: int):
    """Table keys 0..n and batch keys 1..n: batch key x lands at merged
    position 2x, right after the equal table key, so every tile boundary
    (at a multiple of an even tile) falls between a table row and the equal
    batch row that must die."""
    return (_planes(rng, np.arange(n + 1, dtype=np.uint64), c),
            _planes(rng, np.arange(1, n + 1, dtype=np.uint64), m))


def check_merge(name: str, table, batch, reps: int = 1) -> dict:
    """``reps`` kernel calls, each equal to the plain version exactly."""
    want, keep_plain, n_plain = merge_insert_plain(table, batch)
    rows = min(int(n_plain), table.shape[1])
    err = 0
    for _ in range(reps):
        got, keep, n = merge_insert(table, batch)
        require(int(n) == int(n_plain), f"merge {name}: n_keep")
        require(torch.equal(keep, keep_plain), f"merge {name}: keep flags")
        if rows:
            err = max(err, int((got[:, :rows] - want[:, :rows]).abs().max()))
        require(err == 0, f"merge {name}: merged rows differ")
    return {"C": table.shape[1], "m": batch.shape[1], "n_keep": int(n_plain), "reps": reps,
            "max_abs_err": err}


def merge_phase(rng, c_main: int, m_main: int) -> dict:
    """B2 against its plain version at the rm=8 run's largest shapes (C =
    its table capacity with ~1.3 M real rows, m = its widest candidate
    buffer) 20 times, then at m = 2^20, in an overflow case and on
    adversarial cases for the tiles and the look-back: a 10,000-row run of
    one batch key (fresh, and equal to a table key) across several tiles, a
    batch key equal to the table key just before every tile's diagonal, an
    all-pad batch, an all-pad table and m = 1."""
    cases = {
        "rm8_table": (_merge_case(rng, c_main, 1_300_000, m_main), 20),
        "m_2^20": (_merge_case(rng, c_main, 1_300_000, 1 << 20), 1),
        "overflow": (_merge_case(rng, 1 << 16, 65_000, 1 << 14), 1),
        "run_10k_fresh": (_merge_case(rng, 1 << 20, 600_000, 1 << 16, run=10_000), 1),
        "run_10k_hit": (_merge_case(rng, 1 << 20, 600_000, 1 << 16, run=10_000, run_hit=True), 1),
        "tie_at_diagonals": (_tie_case(rng, 100_000, 1 << 17, 1 << 17), 1),
        "all_pad_batch": (_merge_case(rng, 1 << 16, 60_000, 1 << 14, hit=0, new=0), 1),
        "all_pad_table": (_merge_case(rng, 1 << 16, 0, 1 << 14, hit=0), 1),
        "m_1": (_merge_case(rng, 1 << 16, 60_000, 1, hit=0, new=1.0), 1),
    }
    out = {name: check_merge(name, *case, reps=reps) for name, (case, reps) in cases.items()}
    table, batch = cases["rm8_table"][0]
    n = out["rm8_table"]["n_keep"]
    c, m = table.shape[1], batch.shape[1]
    # Keys of every row read once, values of the kept rows read once,
    # merged rows, keep flags and n_keep written once.
    timing = kernel_timing(
        lambda: merge_insert(table, batch), lambda: merge_insert_plain(table, batch), None,
        (2 * c + 2 * m) * 8 + 6 * min(n, c) * 8 + m + 8,
    )
    emit({"phase": "merge_insert", "cases": out, **timing})
    return {"max_abs_err": max(v["max_abs_err"] for v in out.values()), **timing}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    device_phase()
    small_phase()
    model, checker, launches = main_path_phase()
    repeat_and_profile_phase(model)
    host_split_phase()
    lookahead_sweep_phase(model)
    rm8_single_phase()
    graph_vs_eager_phase()
    rng = np.random.default_rng(2024)
    b1 = compact_phase(checker, rng)
    m_main = max(r["cand_cap"] for r in checker.level_log)
    b2 = merge_phase(rng, checker.metrics()["table_capacity"], m_main)
    kernels = [
        {"name": "compact", "route": "cuda", "source": "stateright_tpu_torch/csrc/compact.cu",
         "replaces": "stateright_tpu/ops/pallas_compact.py:229",
         "launches": launches["compact"], "bound_by": "bytes", **b1},
        {"name": "merge_insert", "route": "cuda", "source": "stateright_tpu_torch/csrc/merge.cu",
         "replaces": "stateright_tpu/ops/pallas_merge.py:347",
         "launches": launches["merge_insert"], "bound_by": "bytes", **b2},
    ]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
