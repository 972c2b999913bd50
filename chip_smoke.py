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
   graphs captured by the cold run and reused by the warm one (and which
   of the cold run's programs no run replayed), both
   kernels launched, and every discovery re-executed to a valid witness
   path; then repeats the warm run three times for the spread and once
   under ``torch.profiler`` for the device time by kernel, the device
   operations per level and the device's idle share; times the gated copy
   of the table planes; splits the host time of a cold and a warm run of a
   fresh model instance by step of the block; sweeps the replay lookahead
   (``graphs.LOOKAHEAD``) over warm runs; runs ``levels_per_dispatch=1``
   at rm=8 for the comparison; and holds rm=5 through graph replays
   against the same gated level run eagerly on the card: equal level and
   dispatch logs and bitwise equal table planes;
4. drives packed Paxos (``PackedPaxos(c, 3).checker().spawn_xla()``):
   2c/3s to full coverage through CUDA-graph blocks (32,971 generated,
   16,668 unique, the 8-action "value chosen" witness re-executed), equal
   level by level to the same search on the CPU; 3c/3s (W = 46 words,
   A = 672 action slots, 1,680 interleavings per on-device
   linearizability check) at its depth-8 pin (3,279 / 1,969), then one
   level per dispatch to ``PAXOS3_DEPTH`` with the peak memory of every
   bucket and the device time of its widest level by stage, then cold and
   warm through the fused path to the same depth
   (equal level by level, the warm run capturing nothing), the depth of
   ROUND3.md's CPU probe, and a warm run under ``torch.profiler``;
5. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (20 launches each, since a look-back race shows only
   now and then) and on ragged, overflow and adversarial cases for the
   tiles and the look-back, then at the Paxos 3c/3s shapes (the grid
   compaction's 49 lanes, the frontier compaction's 47, the merge at the
   Paxos table), exactly (tolerance 0: integer work); times kernel, plain
   version and, where one PyTorch call computes the same function, that
   call, the frontier compaction on its own too; and counts the device
   operations of one call under ``torch.profiler``;
6. compares the candidate ladder (``cand_ladder``, "auto" = 3 rungs, the
   default of every run above) with the one-rung block (``cand_ladder=1``)
   on fresh model instances, in turns: rm=8 cold and warm (exact counts,
   the rung of every level, fall-throughs, captures and capture seconds,
   walls, device busy and idle share under ``torch.profiler``, peak
   memory) and Paxos 3c/3s to ``PAXOS3_DEPTH`` (the same; the ladder's run
   also to depth 16 with its peak memory);
7. drives single-copy-register: 3c/1s (``EXPECTED_MATRIX``'s 6,778 /
   4,243) and the ordered 2c variant, each equal to the CPU level by level;
   then ``PackedSingleCopyRegister(4, 1, device_exact=False)`` to depth 6
   and ``(4, 2, device_exact=False)`` to its linearizability
   counterexample through the host-verified path (the sampled pass on the
   card, the host confirming), equal to the CPU in counts, levels,
   discoveries and ``hv_stats``;
8. holds both kernels against their plain versions at the shapes this
   slice adds, exactly, and times them: the grid and frontier compactions
   of the widest snug rung of rm=8 and of Paxos 3c/3s, a ``merge_insert``
   of a few hundred rows into a 2^22-row table, and the host-verified
   compaction of flagged frontier rows into ``host_verified_cap`` rows at
   each host-verified run's widest rung (with a past-the-cap extra);
9. drives the paths of checkpoints, visitors and increment, each with the
   launch counters set to 0 just before it and read just after:
   ``checkpoint_rm8`` (rm=8 stopped at its widest level on the warm
   main-path instance, saved, resumed in a fresh checker and joined: exact
   counts, valid witnesses, the levels after the save equal to the
   uninterrupted run's; the device-to-host copy, save, load-and-restore and
   resumed-run seconds and the file's bytes), ``autockpt_rm8``
   (``checkpoint_to``/``checkpoint_every=1``/``checkpoint_keep=3`` on the
   warm instance between two warm runs without: a write at every block
   boundary, three rotations, the fallback past a newest rotation torn by
   hand), ``checkpoint_paxos3`` (3c/3s saved at depth 8 and resumed to
   ``PAXOS3_DEPTH``, and a warm run there auto-checkpointing every block
   beside one without), ``cpu_card_checkpoint`` (2pc rm=5 saved at depth 6 on
   the CPU and resumed on the card, and the other way: one payload, exact
   counts and levels), ``visitor`` (a ``PathRecorder`` through
   ``spawn_xla()`` on the card equal to the host ``spawn_bfs()``'s paths)
   and ``increment`` (``PackedIncrementLock(3)`` at (61, 61), then
   ``PackedIncrement(2)``'s ``fin`` witness as long as the host BFS's);
10. drives the ABD linearizable register (``abd``): ``PackedAbd`` and
   ``PackedAbdOrdered`` at 2c/2s (875 / 544 / 25 and 813 / 564 / 25) and
   at 3c/2s (68,115 / 35,009 / 37 and 63,053 / 36,213 / 37; W = 39 and
   31, A = 417 and 14, 1,680 interleavings per linearizability check),
   each 3c/2s run cold and then warm on one model instance (the warm run
   capturing nothing) with every discovery re-executed, each equal to the
   CPU level by level at the CPU tests' depth cut, and the unordered one
   once more one level per dispatch to its widest frontier (peak memory by
   bucket, that level by stage); then ``models``: ping-pong lossy max 5
   (4,094 states, equal to the CPU), the sliding puzzle's doc board (its
   4-slide discovery), timers 3 to depth 5 (equal to the CPU) and a
   ``PackedAbd(2, 2)`` checkpoint written on the CPU and resumed on the
   card, and the other way; then holds both kernels against their plain
   versions at the ABD 3c/2s shapes (``abd3_kernels``, as item 5 at the
   Paxos shapes), exactly, and times them;
11. drives the device symmetry reduction (``symmetry``) through
   ``checker().symmetry().spawn_xla()``: 2pc rm=14, the widest the model
   packs, at the JAX package's pins (227,468 / 12,323 / 44) cold and then
   warm on one model instance (the warm run capturing nothing), both
   discoveries re-executed on the host, a warm run under
   ``torch.profiler``, and one level's device operations and time with and
   without the canonicalization at the widest bucket; rm=8 (15,287 / 1,461
   / 26) equal to the CPU level by level; one rm=5 instance through
   symmetric, plain and symmetric runs, each exact, the third capturing
   nothing; the increment models' pins through the spec and through
   ``packed_representative``; the canonicalization on 2^20 seeded rm=14
   rows bitwise against its host twin and its CPU run; and a symmetric rm=8
   checkpoint saved on the CPU and resumed on the card, and the other way,
   refused without symmetry;
12. prints the ``{"kernels": [...]}`` line (launches summed over every
   main-path run: rm=8, Paxos 3c/3s, single-copy-register, the
   host-verified runs and the paths of items 9 to 11, each also by path)
   and, last, the device line.

Every line but the nvidia-smi one is a JSON object. Any failed check
raises, so the script exits non-zero.
"""

from __future__ import annotations

import gc
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

from stateright_tpu_torch import PathRecorder, graphs
from stateright_tpu_torch.audit import audit_table
from stateright_tpu_torch.checkpoint import (
    PAYLOAD_KEYS,
    checkpoint_arrays,
    latest_valid_checkpoint,
    load_checkpoint,
    rotations,
)
from stateright_tpu_torch.actor.actor_test_util import PingPongCfg
from stateright_tpu_torch.actor.packed import PackedPingPong
from stateright_tpu_torch.models.increment import Increment, PackedIncrement
from stateright_tpu_torch.models.increment_lock import PackedIncrementLock
from stateright_tpu_torch.models.linearizable_register import PackedAbd, PackedAbdOrdered
from stateright_tpu_torch.models.paxos import PackedPaxos
from stateright_tpu_torch.models.puzzle import PackedPuzzle
from stateright_tpu_torch.models.timers import PackedTimers
from stateright_tpu_torch.models.single_copy_register import (
    PackedSingleCopyRegister,
    PackedSingleCopyRegisterOrdered,
)
from stateright_tpu_torch.core import Property
from stateright_tpu_torch.models.two_phase_commit import PackedTwoPhaseSys
from stateright_tpu_torch.ops import _cuda, deltaset, hashset, sortedset
from stateright_tpu_torch.ops.compact import compact, compact_plain
from stateright_tpu_torch.ops.merge import merge_insert, merge_insert_plain
from stateright_tpu_torch.ops.words import DTYPE, from_u32
from stateright_tpu_torch.sym import canonicalize_host, compile_canon
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
#: Packed Paxos, c clients and 3 servers: full coverage at 2c/3s
#: (paxos.rs:321,345) and the reference's bounded pin at 3c/3s, depth 8.
EXPECTED_PAXOS2 = (32_971, 16_668)
PAXOS3_DEPTH8 = (3_279, 1_969)
#: 3c/3s to ``target_max_depth(15)``, as the one-level path counts it.
PAXOS3_DEPTH15 = (405_091, 222_592)
#: ``bench.py`` ``EXPECTED_MATRIX["single-copy-register 3c/1s packed"]``.
EXPECTED_SCR3 = (6_778, 4_243)
#: ``bench.py`` ``EXPECTED_MATRIX["increment_lock 3t packed"]``.
EXPECTED_INCREMENT_LOCK3 = (61, 61)
#: ABD, ``(generated, unique, max_depth)``: 2 clients / 2 servers
#: (``EXPECTED_MATRIX``, linearizable-register.rs:289,316) and 3 clients,
#: on the unordered and the ordered network (``tests/test_packed_abd.py``,
#: ``tests/test_packed_abd_ordered.py``).
EXPECTED_ABD = {
    ("unordered", 2): (875, 544, 25),
    ("ordered", 2): (813, 564, 25),
    ("unordered", 3): (68_115, 35_009, 37),
    ("ordered", 3): (63_053, 36_213, 37),
}
#: The depth cuts of the CPU tests of ABD 3c/2s (``tests/test_torch_abd*.py``).
ABD3_CPU_DEPTH = {"unordered": 14, "ordered": 16}
#: ``PackedPingPong(PingPongCfg(False, 5), lossy=True)``: model.rs:680.
PING_PONG_LOSSY5 = 4_094
#: The deepest ``target_max_depth`` up to 15 whose 3c/3s run fits one H100
#: (its last level runs at the 131,072 bucket: a 32.4 GB action grid).
PAXOS3_DEPTH = 15
#: ROUND3.md's one-level JAX CPU probe "reached depth 15 -- 626,624
#: generated / 339,379 unique": run here as ``target_max_depth(16)``, whose
#: last expanded frontier is at depth 15.
ROUND3_PROBE = (16, 626_624, 339_379)
M32 = 0xFFFFFFFF
#: Clock cycles of the sleep kernel that holds the stream while timed calls
#: are enqueued (~25 ms at the H100's clocks).
SLEEP_CYCLES = 50_000_000
#: The program recorder (:class:`ProgramUse`), installed by ``main``.
PROGRAM_USE = None
#: The kernels' names as the profiler lists them (``csrc/compact.cuh``,
#: ``csrc/merge.cu``).
COMPACT_SYMBOL = "compact_kernel"
MERGE_SYMBOL = "merge_kernel"


#: The script's start on the host clock: each phase line carries its
#: seconds since (``t_s``).
T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
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


def rungs(c) -> list:
    """``(depth, rows, cand_cap, bucket)`` of every level: the rung it ran
    at and the bucket of its block."""
    blocks = [b for b, n in c.dispatch_log for _ in range(n)]
    return [(r["depth"], r["bucket"], r["cand_cap"], b) for r, b in zip(c.level_log, blocks)]


def zero_launches() -> None:
    compact.launches = 0
    merge_insert.launches = 0
    hashset.insert_.launches = 0
    hashset.undo_.launches = 0


#: The kernels of each visited-set structure's path, by the names of the
#: ``kernels`` line.
PATH_KERNELS = {
    "sorted": ("compact", "merge_insert"),
    "delta": ("compact", "merge_insert"),
    "hash": ("compact", "hashset_insert", "hashset_undo"),
}


def launches_now(dedup: str = "sorted") -> dict:
    """The launch counters of the kernels of ``dedup``'s path."""
    counts = {"compact": compact.launches, "merge_insert": merge_insert.launches,
              "hashset_insert": hashset.insert_.launches, "hashset_undo": hashset.undo_.launches}
    return {k: counts[k] for k in PATH_KERNELS[dedup]}


def audited(c, what: str) -> dict:
    """The host audit of ``c``'s visited set (``audit.audit_table``): no key
    twice and one entry per unique state, or the run fails."""
    report = audit_table(c)
    require(report["ok"], f"{what}: visited-set audit {report}")
    return report


def drive(model, depth=None, sym: bool = False, **kw):
    """One ``spawn_xla().join()`` of ``model`` (to ``target_max_depth(depth)``
    if given, through ``symmetry()`` if ``sym``) timed on the host clock,
    launch counters zeroed just before and read just after."""
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    builder = model.checker()
    if depth is not None:
        builder = builder.target_max_depth(depth)
    if sym:
        builder = builder.symmetry()
    c = builder.spawn_xla(**kw).join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return c, wall, launches_now(kw.get("dedup", "sorted"))


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
        "cand_ladder_k": m["cand_ladder_k"], "cand_retries": m["cand_retries"],
        "rungs": rungs(c),
        "table_capacity": m["table_capacity"], "frontier_capacity": m["frontier_capacity"],
        "grows": {k: m[k] for k in ("table_grows", "frontier_grows", "cand_grows")},
        "discoveries": {k: len(p) for k, p in found.items()},
        "paths_s": time.perf_counter() - t1,
        "audit": audited(c, what),
    }


def main_path_phase():
    """2pc rm=8 through the entry point a user calls, cold and then warm on
    one model instance: the warm run starts from the capacities the cold
    run learned and replays the graphs it captured."""
    model = PackedTwoPhaseSys(8)
    torch.cuda.reset_peak_memory_stats()
    PROGRAM_USE.segment = "rm8_cold"
    cold, cold_wall, cold_launches = drive(model)
    PROGRAM_USE.segment = "rm8_warm"
    warm, warm_wall, warm_launches = drive(model)
    PROGRAM_USE.segment = "other"
    cold_line = check_rm8(cold, cold_launches, "cold")
    warm_line = check_rm8(warm, warm_launches, "warm")
    for line in (cold_line, warm_line):
        require(line["dispatches"] < line["levels"], f"fused blocks: {line['dispatch_log']}")
    require(cold_line["graph_captures"] > 0, "the cold run captured no graph")
    require(warm_line["graph_captures"] == 0,
            f"the warm run captured {warm_line['graph_captures']} graphs")
    require([r[:4] for r in levels(warm)] == [r[:4] for r in levels(cold)],
            "warm and cold per-level counts")
    require(cold_line["cand_ladder_k"] == 3, "the main path runs the 3-rung candidate ladder")
    peak = torch.cuda.max_memory_allocated() / 2**30
    emit({
        "phase": "rm8", "cold_wall_s": cold_wall, "warm_wall_s": warm_wall,
        "states_per_s": EXPECTED_2PC[8][0] / warm_wall, "peak_mem_gib": peak,
        "cold": cold_line, "warm": warm_line,
        "program_use": PROGRAM_USE.summary("rm8_cold", ["rm8_warm"]),
    })
    ladder = {"cold_wall_s": cold_wall, "peak_mem_gib": peak, "levels_log": levels(cold),
              **{k: cold_line[k] for k in ("graph_captures", "capture_s", "cand_retries", "rungs")}}
    return model, warm, cold_launches, ladder


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


def paxos_small_phase() -> None:
    """Paxos 2c/3s on the card through CUDA-graph blocks: exact counts,
    every property checked, the 8-action "value chosen" witness
    re-executed, and equal level by level to the same search on the CPU."""
    gpu, wall, launches = drive(PackedPaxos(2, 3))
    cpu = PackedPaxos(2, 3).checker().spawn_xla(device="cpu").join()
    counts = (gpu.state_count(), gpu.unique_state_count())
    require(counts == EXPECTED_PAXOS2, f"paxos 2c/3s counts {counts}")
    require(all(n > 0 for n in launches.values()), f"paxos 2c/3s kernel launches {launches}")
    require(gpu.metrics()["graph_captures"] > 0, "paxos 2c/3s on the card ran no graph")
    gpu.assert_properties()
    witness = gpu.discoveries()["value chosen"].into_actions()
    require(len(witness) == 8, f"value chosen witness of {len(witness)} actions")
    gpu.assert_discovery("value chosen", witness)
    require([r[:4] for r in levels(gpu)] == [r[:4] for r in levels(cpu)],
            "paxos 2c/3s per-level counts, card vs CPU")
    emit({"phase": "paxos_small", "clients": 2, "servers": 3, "generated": counts[0],
          "unique": counts[1], "levels": len(gpu.level_log), "cold_wall_s": wall,
          "audit": audited(gpu, "paxos 2c/3s"),
          "launches": launches, "dispatch_log": gpu.dispatch_log,
          "graph_captures": gpu.metrics()["graph_captures"],
          "capture_s": gpu.metrics()["graph_capture_s"], "witness_actions": len(witness),
          "card_equals_cpu": True})


def per_level_peaks(fn):
    """``fn()`` with the peak device memory of every one-level dispatch,
    as ``(bucket, peak GiB)`` per superstep (overflow retries included)."""
    peaks = []
    original = XlaChecker._superstep

    def superstep(self, frontier, *args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = original(self, frontier, *args, **kwargs)
        torch.cuda.synchronize()
        peaks.append((frontier.shape[0], torch.cuda.max_memory_allocated() / 2**30))
        return out

    XlaChecker._superstep = superstep
    try:
        return fn(), peaks
    finally:
        XlaChecker._superstep = original


class ProgramUse:
    """Every program made while installed (``ProgramCache.make``): its key
    ``(run_cap, rows, cand_cap, table_capacity)``, the host seconds of its
    capture and, by ``segment`` (the run under way), how many times a block
    ran it (``Program.run``: a replay, or an eager level)."""

    def __init__(self):
        self.entries = []
        self.segment = "other"
        make, run = graphs.ProgramCache.make, graphs.Program.run
        use = self

        def tracked_make(cache, key, *args, **kwargs):
            t0 = time.perf_counter()
            prog = make(cache, key, *args, **kwargs)
            prog.use = {"key": tuple(key[:4]), "capture_s": time.perf_counter() - t0,
                        "made_in": use.segment, "runs": {}}
            use.entries.append(prog.use)
            return prog

        def tracked_run(prog, *args, **kwargs):
            if hasattr(prog, "use"):
                prog.use["runs"][use.segment] = prog.use["runs"].get(use.segment, 0) + 1
            return run(prog, *args, **kwargs)

        graphs.ProgramCache.make, graphs.Program.run = tracked_make, tracked_run

    def capture_s(self, segment: str) -> dict:
        """Host seconds of each program made in ``segment`` (a graph capture
        with its warm-up level), by ``(run_cap, rows, cand_cap)``."""
        return {str(e["key"][:3]): e["capture_s"] for e in self.entries if e["made_in"] == segment}

    def summary(self, first: str, later: list) -> dict:
        """The programs made in segment ``first``: how many, how many of
        them at a snug rung, those never run in ``first`` or ``later`` with
        their capture seconds, and the rungs ``(run_cap, rows, cand_cap)``
        that ``later`` ran and ``first`` never did: captured on first use,
        these would be captured by the later runs."""
        made = [e for e in self.entries if e["made_in"] == first]
        idle = [e for e in made if not any(e["runs"].get(g, 0) for g in [first, *later])]
        ran_first = {e["key"][:3] for e in made if e["runs"].get(first)}
        ran_later = {e["key"][:3] for e in made if any(e["runs"].get(g) for g in later)}
        return {
            "captures": len(made), "snug_captures": sum(e["key"][1] < e["key"][0] for e in made),
            "never_run": len(idle), "never_run_snug": sum(e["key"][1] < e["key"][0] for e in idle),
            "never_run_capture_s": sum(e["capture_s"] for e in idle),
            "never_run_keys": sorted(e["key"] for e in idle),
            "run_later_not_first": sorted(ran_later - ran_first),
        }


def level_split(checker) -> dict:
    """Device time (CUDA events, back to back, 3 calls after 2 warm-ups) of
    one eager level at the run's widest bucket from the frontier that
    ``checker`` stopped at (its last level's new states: the depth target
    left them unexpanded), and of the model's two parts of it: the
    transition bodies (``packed_step``) and the properties
    (``packed_properties``, the on-device linearizability check)."""
    model = checker.model()
    f = max(r["bucket"] for r in checker.level_log)
    n = checker.level_log[-1]["unique"]
    frontier, ebits = checker._bucket_inputs(f)
    f_count = torch.full((), n, dtype=DTYPE, device="cuda")
    cand_cap = checker._cand_cap_for(f)
    stages = {
        "packed_step": lambda: model.packed_step(frontier),
        "packed_properties": lambda: model.packed_properties(frontier),
        "superstep": lambda: checker._superstep(
            frontier, ebits, f_count, checker._table, checker._disc_found,
            checker._disc_fp, cand_cap),
    }
    out = {"bucket": f, "frontier": n, "cand_cap": cand_cap}
    out.update({name: timed_ms(fn, reps=3) for name, fn in stages.items()})
    out["rest"] = out["superstep"] - out["packed_step"] - out["packed_properties"]
    return out


def paxos3_phase():
    """Paxos 3c/3s (W = 46, A = 672, 1,680 interleavings per linearizability
    check) at full width: the depth-8 pin; then cold and warm to
    ``PAXOS3_DEPTH`` on one model instance (the warm run captures
    nothing), every property checked and the witness re-executed; one level
    per dispatch to the same depth, equal level by level, with the peak
    memory of every bucket and its widest level split by stage; ROUND3.md's probe depth; one warm run under
    ``torch.profiler``. Returns the cold run's shapes and launches; drops
    every model so that its graphs' memory goes back to the card."""
    gc.collect()
    torch.cuda.empty_cache()
    pin, _, _ = drive(PackedPaxos(3, 3), depth=8)
    require((pin.state_count(), pin.unique_state_count()) == PAXOS3_DEPTH8,
            f"paxos 3c/3s depth-8 pin {(pin.state_count(), pin.unique_state_count())}")
    # One level per dispatch first: its eager levels leave their memory
    # cached in the allocator, handed back before the graphs are made.
    (single, single_wall, _), peaks = per_level_peaks(
        lambda: drive(PackedPaxos(3, 3), depth=PAXOS3_DEPTH, levels_per_dispatch=1))
    split = level_split(single)
    del pin
    gc.collect()
    torch.cuda.empty_cache()
    model = PackedPaxos(3, 3)
    torch.cuda.reset_peak_memory_stats()
    PROGRAM_USE.segment = "paxos3_cold"
    cold, cold_wall, cold_launches = drive(model, depth=PAXOS3_DEPTH)
    captures = PROGRAM_USE.capture_s("paxos3_cold")
    cold_peak = torch.cuda.max_memory_allocated() / 2**30
    reserved = torch.cuda.memory_reserved() / 2**30
    torch.cuda.reset_peak_memory_stats()
    PROGRAM_USE.segment = "paxos3_warm"
    warm, warm_wall, warm_launches = drive(model, depth=PAXOS3_DEPTH)
    PROGRAM_USE.segment = "other"
    warm_peak = torch.cuda.max_memory_allocated() / 2**30
    counts = (cold.state_count(), cold.unique_state_count())
    require(counts == PAXOS3_DEPTH15, f"paxos 3c/3s depth-{PAXOS3_DEPTH} counts {counts}")
    require((warm.state_count(), warm.unique_state_count()) == counts, "paxos 3c/3s warm vs cold counts")
    # Buckets may differ: the warm run starts at the learned capacities.
    require([r[:4] for r in levels(warm)] == [r[:4] for r in levels(cold)],
            "paxos 3c/3s warm vs cold per-level counts")
    require(warm.metrics()["graph_captures"] == 0, "the warm paxos 3c/3s run captured graphs")
    require(all(n > 0 for n in cold_launches.values()), f"paxos 3c/3s kernel launches {cold_launches}")
    t1 = time.perf_counter()
    cold.assert_properties()
    witness = cold.discoveries()["value chosen"].into_actions()
    cold.assert_discovery("value chosen", witness)
    paths_s = time.perf_counter() - t1
    require([r[:4] for r in levels(single)] == [r[:4] for r in levels(cold)],
            "paxos 3c/3s fused vs levels_per_dispatch=1, level by level")
    bucket_peaks = {}
    for bucket, gib in peaks:
        bucket_peaks[bucket] = max(bucket_peaks.get(bucket, 0.0), gib)
    torch.cuda.reset_peak_memory_stats()
    PROGRAM_USE.segment = "paxos3_depth16"
    probe, probe_wall, _ = drive(model, depth=ROUND3_PROBE[0])
    PROGRAM_USE.segment = "other"
    probe_peak = torch.cuda.max_memory_allocated() / 2**30
    probe_reserved = torch.cuda.memory_reserved() / 2**30
    probe_counts = (probe.state_count(), probe.unique_state_count())
    require(probe_counts == ROUND3_PROBE[1:], f"paxos 3c/3s depth-16 counts {probe_counts}")
    prof, prof_wall, kernels = profiled(
        lambda: model.checker().target_max_depth(PAXOS3_DEPTH).spawn_xla().join())
    busy_ms = sum(ms for _, ms, _ in kernels)
    ops = sum(n for _, _, n in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:15]
    deep = probe.level_log[-1]
    growth = deep["unique"] / deep["frontier"]
    need = 1 << max(int(deep["unique"] * growth) - 1, 1).bit_length()
    m = cold.metrics()
    emit({
        "phase": "paxos3", "clients": 3, "servers": 3, "state_words": model.state_words,
        "max_actions": model.max_actions, "target_max_depth": PAXOS3_DEPTH,
        "depth8_pin": list(PAXOS3_DEPTH8), "generated": counts[0], "unique": counts[1],
        "max_depth": cold.max_depth(), "level_log": [list(r[:6]) for r in levels(cold)],
        "rungs": rungs(cold), "cand_retries": m["cand_retries"],
        "cold_wall_s": cold_wall, "warm_wall_s": warm_wall,
        "states_per_s": counts[0] / warm_wall, "cold_states_per_s": counts[0] / cold_wall,
        "dispatch_log": cold.dispatch_log, "graph_captures": m["graph_captures"],
        "capture_s": m["graph_capture_s"], "capture_s_by_shape": captures,
        "program_use": PROGRAM_USE.summary("paxos3_cold", ["paxos3_warm", "paxos3_depth16"]),
        "table_capacity": m["table_capacity"], "table_grows": m["table_grows"],
        "frontier_capacity": m["frontier_capacity"],
        "peak_mem_gib": {"cold": cold_peak, "warm": warm_peak,
                         "reserved_after_cold": reserved},
        "peak_mem_gib_by_bucket": bucket_peaks,
        "launches": {"cold": cold_launches, "warm": warm_launches},
        "audit": {"cold": audited(cold, "paxos 3c/3s cold"), "warm": audited(warm, "paxos 3c/3s warm")},
        "witness_actions": len(witness), "paths_s": paths_s,
        "single": {"wall_s": single_wall, "dispatches": len(single.dispatch_log),
                   "levels_equal_fused": True},
        "level_split_ms": split,
        "round3_probe": {"target_max_depth": ROUND3_PROBE[0], "generated": probe_counts[0],
                         "unique": probe_counts[1], "wall_s": probe_wall,
                         "round3": list(ROUND3_PROBE[1:]),
                         "equal": probe_counts == ROUND3_PROBE[1:], "peak_mem_gib": probe_peak,
                         "reserved_gib": probe_reserved,
                         "rungs": rungs(probe), "cand_retries": probe.cand_retries},
        "deeper": {
            # The probe's last frontier and, at its last level's growth,
            # the bucket one more level would need and its [F, A, W] grid.
            "frontier": deep["unique"], "growth": growth, "bucket": need,
            "grid_gib": need * model.max_actions * model.state_words * 8 / 2**30,
            "bucket_now": deep["bucket"],
        },
        "profile": {
            "wall_s": prof_wall, "device_busy_ms": busy_ms if kernels else "not measured",
            "device_idle_share": 1 - busy_ms / (prof_wall * 1e3) if kernels else "not measured",
            "device_launches": ops, "device_ops_per_level": ops / len(prof.level_log),
            "top_kernels": [{"name": k[:90], "ms": ms, "calls": n} for k, ms, n in top],
        },
    })
    ladder = {"cold_wall_s": cold_wall, "warm_wall_s": warm_wall, "profiled_wall_s": prof_wall,
              "device_busy_ms": busy_ms if kernels else "not measured",
              "graph_captures": m["graph_captures"], "capture_s": m["graph_capture_s"],
              "peak_mem_gib": cold_peak, "reserved_gib": reserved, "cand_retries": m["cand_retries"]}
    shapes = {
        "levels": [dict(r) for r in cold.level_log], "rungs": rungs(cold),
        "table_capacity": m["table_capacity"],
        "generated": counts[0], "unique": counts[1], "A": model.max_actions,
        "W": model.state_words,
    }
    ckpt_launches = checkpoint_paxos3_phase(model, warm)
    del model, cold, warm, single, probe, prof
    gc.collect()
    torch.cuda.empty_cache()
    return shapes, cold_launches, ladder, ckpt_launches


def paxos3_growth_phase(counts) -> None:
    """Paxos 3c/3s to ``PAXOS3_DEPTH`` from a small visited set: its
    growths remake the programs of every bucket at the grown capacity, the
    last with the 131,072 bucket's program in the cache, and the run keeps
    the search and fits the card."""
    torch.cuda.reset_peak_memory_stats()
    PROGRAM_USE.segment = "paxos3_growth"
    c, wall, _ = drive(PackedPaxos(3, 3), depth=PAXOS3_DEPTH, table_capacity=1 << 17)
    PROGRAM_USE.segment = "other"
    captures = PROGRAM_USE.capture_s("paxos3_growth")
    m = c.metrics()
    require((c.state_count(), c.unique_state_count()) == counts, "paxos 3c/3s counts after table growths")
    require(m["table_grows"] >= 2, f"paxos 3c/3s table growths {m['table_grows']}")
    emit({"phase": "paxos3_table_growth", "table_capacity": [1 << 17, m["table_capacity"]],
          "table_grows": m["table_grows"], "graph_captures": m["graph_captures"],
          "capture_s": m["graph_capture_s"], "capture_s_by_shape": captures, "wall_s": wall,
          "dispatch_log": c.dispatch_log, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    del c
    gc.collect()
    torch.cuda.empty_cache()


def device_ops(fn, symbol: str, calls: int = 5, windows: int = 5) -> dict:
    """The device operations (kernels and memsets) of one call of ``fn``, by
    name: how many the call issues and their mean device time, from
    ``torch.profiler`` over ``calls`` calls after a warm-up step (the tracer
    misses the first memset of its window). The tracer now and then loses
    device records, so a window counts only if it holds the kernel
    ``symbol`` (launched once a call) ``calls`` times and every operation a
    whole number of times a call; up to ``windows`` windows are profiled,
    and the result is empty if none counts."""
    for _ in range(windows):
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
        if (sum(e.count for e in seen if symbol in e.key) == calls
                and all(e.count % calls == 0 for e in seen)):
            return {
                e.key[:90]: {"per_call": e.count / calls,
                             "ms": e.self_device_time_total / e.count / 1e3, "seen": e.count}
                for e in seen
            }
    return {}


def ops_split(ops: dict, symbol: str) -> dict:
    """A call's device time from :func:`device_ops`: the kernel ``symbol``'s
    ms, the rest's, and the rest by operation ("not measured" if no
    profiled window counted)."""
    if not ops:
        return {"kernel_ms": "not measured", "rest_ms": "not measured", "rest_ops": {}}
    rest = {k: op["ms"] * op["per_call"] for k, op in ops.items() if symbol not in k}
    return {"kernel_ms": sum(op["ms"] * op["per_call"] for k, op in ops.items() if symbol in k),
            "rest_ms": sum(rest.values()), "rest_ops": rest}


def kernel_timing(kernel, plain, library, n_bytes: int, symbol: str) -> dict:
    """A kernel's wrapper timed with the device work alone (``ms``) and back
    to back (``ms_back_to_back``), its device operations per call under the
    profiler ("not measured" when no profiled window held every call's
    ``symbol`` kernel), its plain version, the library call (or None) and the
    bound of ``n_bytes`` over the memory rate."""
    ops = device_ops(kernel, symbol)
    return {
        "ms": timed_ms(kernel, queued=True),
        "ms_back_to_back": timed_ms(kernel),
        "device_ms": sum(op["ms"] * op["per_call"] for op in ops.values()) if ops else "not measured",
        "device_launches_per_call":
            sum(op["per_call"] for op in ops.values()) if ops else "not measured",
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
        compact_bytes(mask, len(lanes), n, cap, read_words, per_row_bytes), COMPACT_SYMBOL,
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
        (2 * c + 2 * m) * 8 + 6 * min(n, c) * 8 + m + 8, MERGE_SYMBOL,
    )
    emit({"phase": "merge_insert", "cases": out, **timing})
    return {"max_abs_err": max(v["max_abs_err"] for v in out.values()), **timing}


def model_kernel_phase(shapes, rng, tag: str = "paxos3") -> dict:
    """Both kernels against their plain versions, exactly, at the shapes of
    a wide model's run (``shapes``; 20 launches each), and timed there: the
    grid compaction (P = W + 3 lanes: 49 for Paxos 3c/3s, 42 for ABD 3c/2s,
    5 for 2pc rm=14 under symmetry)
    at its widest bucket's densest level, the frontier compaction (P = W +
    1) at the level with the most new states, and ``merge_insert`` at its
    table capacity and widest candidate buffer. The inputs are made on the
    card from a seed. ``tag`` names the phase and its cases."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    A, W, lv = shapes["A"], shapes["W"], shapes["levels"]
    f = max(r["bucket"] for r in lv)
    top = max((r for r in lv if r["bucket"] == f), key=lambda r: r["generated"])
    grid = torch.randint(0, 2**32, (f, A, W), dtype=DTYPE, device="cuda", generator=gen)
    per_state = torch.randint(0, 2**32, (3, f), dtype=DTYPE, device="cuda", generator=gen)
    live = torch.arange(f, device="cuda")[:, None] < top["frontier"]
    density = top["generated"] / (top["frontier"] * A)
    mask = (torch.rand((f, A), device="cuda", generator=gen) < density) & live
    lanes = [grid[:, :, w] for w in range(W)] + [p[:, None].expand(f, A) for p in per_state]
    cap = top["cand_cap"]
    out = {"grid": check_compact(f"{tag}_grid", mask, lanes, cap, reps=20)}
    n = out["grid"]["n_valid"]
    flat = mask.reshape(-1)
    grid_timing = kernel_timing(
        lambda: compact(mask, lanes, cap), lambda: compact_plain(mask, lanes, cap),
        lambda: grid.view(f * A, W)[flat],
        compact_bytes(mask, len(lanes), n, cap, W, 3 * f * 8), COMPACT_SYMBOL,
    )
    grid_timing["library_call"] = "grid.view(F*A, W)[mask]: the W grid words only"
    grid_timing["sector_floor_ms"] = bound_ms(sector_bytes(mask, lanes, cap))
    del grid, per_state, lanes, mask, flat
    wide = max(lv, key=lambda r: r["unique"])
    rows = torch.randint(0, 2**32, (W + 1, wide["cand_cap"]), dtype=DTYPE, device="cuda", generator=gen)
    flags = np.zeros(wide["cand_cap"], bool)
    flags[rng.choice(wide["generated"], wide["unique"], replace=False)] = True
    fmask, flanes = torch.from_numpy(flags).cuda(), list(rows)
    out["frontier"] = check_compact(f"{tag}_frontier", fmask, flanes, wide["bucket"], reps=20)
    frontier_timing = time_compact(fmask, flanes, wide["bucket"], out["frontier"]["n_valid"], W + 1, 0)
    del rows, fmask, flanes
    c_tab, m_cand = shapes["table_capacity"], max(r["cand_cap"] for r in lv)
    table, batch = _merge_case(rng, c_tab, shapes["unique"], m_cand)
    out["merge"] = check_merge(f"{tag}_table", table, batch, reps=20)
    nk = out["merge"]["n_keep"]
    merge_timing = kernel_timing(
        lambda: merge_insert(table, batch), lambda: merge_insert_plain(table, batch), None,
        (2 * c_tab + 2 * m_cand) * 8 + 6 * min(nk, c_tab) * 8 + m_cand + 8, MERGE_SYMBOL,
    )
    del table, batch
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": f"{tag}_kernels", "cases": out,
          "grid": {"F": f, "A": A, "P": W + 3, "cap": cap, **grid_timing},
          "frontier": {"M": wide["cand_cap"], "P": W + 1, "cap": wide["bucket"], **frontier_timing},
          "merge_insert": {"C": c_tab, "m": m_cand, **merge_timing}})
    drop = ("device_ops",)
    return {
        "compact": {
            "max_abs_err": max(out["grid"]["max_abs_err"], out["frontier"]["max_abs_err"]),
            "grid": {"F": f, "P": W + 3, "cap": cap, "n_valid": n,
                     **{k: v for k, v in grid_timing.items() if k not in drop}},
            "frontier": {"M": wide["cand_cap"], "P": W + 1, "cap": wide["bucket"],
                         **{k: v for k, v in frontier_timing.items() if k not in drop}},
        },
        "merge_insert": {"max_abs_err": out["merge"]["max_abs_err"], "C": c_tab, "m": m_cand,
                         **{k: v for k, v in merge_timing.items() if k not in drop}},
    }


def warm_profile(model, depth=None, **kw) -> dict:
    """One warm run of ``model`` under ``torch.profiler``: its wall, the
    device's busy time and its idle share of that (profiled) wall."""
    def run():
        b = model.checker()
        if depth is not None:
            b = b.target_max_depth(depth)
        return b.spawn_xla(**kw).join()

    c, wall, kernels = profiled(run)
    require(c.metrics()["graph_captures"] == 0, "a profiled warm run captured graphs")
    busy = sum(ms for _, ms, _ in kernels)
    return {"profiled_wall_s": wall, "device_busy_ms": busy if kernels else "not measured",
            "device_idle_share": 1 - busy / (wall * 1e3) if kernels else "not measured",
            "device_ops_per_level": sum(n for _, _, n in kernels) / len(c.level_log)}


def rm8_ladder_phase(ladder_model, ladder_line) -> None:
    """The candidate ladder (``ladder_model``, warm from the main path) against
    the one-rung block at rm=8: a fresh instance at ``cand_ladder=1`` cold
    and warm (captures, peak memory), warm runs of both in turns (ladder,
    one rung, one rung, ladder, twice), one profiled warm run each. Every
    run exact, with the same levels."""
    gc.collect()
    torch.cuda.empty_cache()
    one = PackedTwoPhaseSys(8)
    torch.cuda.reset_peak_memory_stats()
    cold, cold_wall, launches = drive(one, cand_ladder=1)
    cold_line = check_rm8(cold, launches, "cand_ladder=1 cold")
    drive(one, cand_ladder=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    require([r[:4] for r in levels(cold)] == [r[:4] for r in ladder_line["levels_log"]],
            "rm=8 per-level counts, cand_ladder=1 vs 3")
    require(all(rows == b for _, rows, _, b in cold_line["rungs"]), "cand_ladder=1 ran a snug rung")
    walls = {3: [], 1: []}
    for k in (3, 1, 1, 3, 3, 1, 1, 3):
        model, kw = (ladder_model, {}) if k == 3 else (one, dict(cand_ladder=1))
        c, wall, _ = drive(model, **kw)
        require((c.state_count(), c.unique_state_count()) == EXPECTED_2PC[8], f"rm=8 cand_ladder={k} counts")
        require(c.metrics()["graph_captures"] == 0, f"a warm cand_ladder={k} run captured graphs")
        walls[k].append(wall)
    emit({
        "phase": "rm8_ladder",
        "ladder": {"cand_ladder": 3, "cold_wall_s": ladder_line["cold_wall_s"],
                   "warm_walls_s": walls[3], "peak_mem_gib": ladder_line["peak_mem_gib"],
                   "graph_captures": ladder_line["graph_captures"], "capture_s": ladder_line["capture_s"],
                   "cand_retries": ladder_line["cand_retries"], "rungs": ladder_line["rungs"],
                   **warm_profile(ladder_model)},
        "one_rung": {"cand_ladder": 1, "cold_wall_s": cold_wall, "warm_walls_s": walls[1],
                     "peak_mem_gib": peak, "graph_captures": cold_line["graph_captures"],
                     "capture_s": cold_line["capture_s"], "dispatch_log": cold_line["dispatch_log"],
                     **warm_profile(one, cand_ladder=1)},
    })
    del one, cold, c
    gc.collect()
    torch.cuda.empty_cache()


def paxos3_one_rung_phase(ladder: dict) -> None:
    """Paxos 3c/3s to ``PAXOS3_DEPTH`` at ``cand_ladder=1`` on a fresh
    instance, cold, warm and profiled warm, beside the ladder's numbers of
    ``paxos3_phase`` (same call, same card)."""
    gc.collect()
    torch.cuda.empty_cache()
    model = PackedPaxos(3, 3)
    torch.cuda.reset_peak_memory_stats()
    cold, cold_wall, _ = drive(model, depth=PAXOS3_DEPTH, cand_ladder=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    reserved = torch.cuda.memory_reserved() / 2**30
    warm, warm_wall, _ = drive(model, depth=PAXOS3_DEPTH, cand_ladder=1)
    for c in (cold, warm):
        require((c.state_count(), c.unique_state_count()) == PAXOS3_DEPTH15,
                "paxos 3c/3s cand_ladder=1 counts")
    require(warm.metrics()["graph_captures"] == 0, "the warm cand_ladder=1 paxos run captured graphs")
    m = cold.metrics()
    emit({"phase": "paxos3_ladder", "ladder": ladder, "one_rung": {
        "cand_ladder": 1, "cold_wall_s": cold_wall, "warm_wall_s": warm_wall,
        "graph_captures": m["graph_captures"], "capture_s": m["graph_capture_s"],
        "peak_mem_gib": peak, "reserved_gib": reserved, "rungs": rungs(cold),
        **warm_profile(model, PAXOS3_DEPTH, cand_ladder=1)}})
    del model, cold, warm
    gc.collect()
    torch.cuda.empty_cache()


def same_search(gpu, cpu, what: str) -> None:
    """Card and CPU runs of one model: equal counts, levels, discoveries
    (re-executed) and host-verified work."""
    require((gpu.state_count(), gpu.unique_state_count(), gpu.max_depth())
            == (cpu.state_count(), cpu.unique_state_count(), cpu.max_depth()), f"{what}: counts")
    require([r[:4] for r in levels(gpu)] == [r[:4] for r in levels(cpu)], f"{what}: per-level counts")
    dg, dc = gpu.discoveries(), cpu.discoveries()
    require(set(dg) == set(dc) and all(dg[k].into_actions() == dc[k].into_actions() for k in dc),
            f"{what}: discoveries")
    for name, path in dg.items():
        gpu.assert_discovery(name, path.into_actions())
    hv = [{k: v for k, v in c.hv_stats.items() if k != "host_sec"} for c in (gpu, cpu)]
    require(hv[0] == hv[1], f"{what}: hv_stats {hv}")


def scr_phase() -> dict:
    """Single-copy-register on the card: 3c/1s (exact) and the ordered 2c
    variant, each equal to the CPU level by level; then the host-verified
    path: ``(4, 1, device_exact=False)`` to depth 6 and ``(4, 2,
    device_exact=False)`` to its linearizability counterexample, equal to
    the CPU in counts, levels, discoveries and ``hv_stats``. Returns the
    launches of each run and the shape of each host-verified run's widest
    hv compaction (``hv_shape``)."""
    cases = (
        ("3c1s", lambda: PackedSingleCopyRegister(3, 1), None),
        ("ordered_2c", lambda: PackedSingleCopyRegisterOrdered(2), None),
        ("4c1s_hv_depth6", lambda: PackedSingleCopyRegister(4, 1, device_exact=False), 6),
        ("4c2s_hv", lambda: PackedSingleCopyRegister(4, 2, device_exact=False), None),
    )
    out, launches, hv_shapes = {}, {}, {}
    for name, build, depth in cases:
        gpu, wall, launches[name] = drive(build(), depth=depth)
        b = build().checker()
        if depth is not None:
            b = b.target_max_depth(depth)
        t0 = time.perf_counter()
        cpu = b.spawn_xla(device="cpu").join()
        cpu_wall = time.perf_counter() - t0
        same_search(gpu, cpu, f"single-copy-register {name}")
        require(all(n > 0 for n in launches[name].values()), f"{name}: kernel launches {launches[name]}")
        m = gpu.metrics()
        out[name] = {
            "generated": gpu.state_count(), "unique": gpu.unique_state_count(),
            "max_depth": gpu.max_depth(), "state_words": gpu.model().state_words,
            "max_actions": gpu.model().max_actions, "cold_wall_s": wall, "cpu_wall_s": cpu_wall,
            "graph_captures": m["graph_captures"], "dispatch_log": gpu.dispatch_log,
            "rungs": rungs(gpu), "hv": m["hv"], "launches": launches[name],
            "discoveries": {k: len(p) for k, p in gpu.discoveries().items()},
            "card_equals_cpu": True,
        }
        if gpu._hv_cap:
            hv_shapes[name] = out[name]["hv_compaction"] = hv_shape(gpu)
    require((out["3c1s"]["generated"], out["3c1s"]["unique"]) == EXPECTED_SCR3, "scr 3c/1s counts")
    require(out["4c2s_hv"]["hv"]["confirmed"] == 1, "4c/2s: the host confirmed no counterexample")
    emit({"phase": "single_copy_register", **out})
    return launches, hv_shapes


def hv_shape(c) -> dict:
    """The widest host-verified compaction a run made: the rows of its
    widest rung (every level compacts its rung's rows, flagged or not), the
    frontier that level held, the words and fingerprints it moves, the
    cap, and the run's flagged total (``hv_stats``; no level flags more)."""
    level = max(c.level_log, key=lambda r: (r["bucket"], r["frontier"]))
    return {"F": level["bucket"], "frontier": level["frontier"], "W": c.model().state_words,
            "cap": c._hv_cap, "flagged": min(int(c.hv_stats["flagged"]), level["frontier"])}


def snug_level(level_log, level_rungs):
    """The widest level that ran at a snug rung: ``(level, block bucket)``."""
    snug = [(r, b) for r, (_, rows, _, b) in zip(level_log, level_rungs) if rows < b]
    require(bool(snug), "no level ran at a snug rung")
    return max(snug, key=lambda t: (t[0]["bucket"], t[0]["generated"]))


def rung_kernel_phase(c, shapes, hv_shapes, rng) -> dict:
    """Both kernels against their plain versions at the shapes the ladder and
    the host-verified path add (20 launches each, exactly), and timed: the
    grid and frontier compactions of the widest snug level of rm=8 and of
    Paxos 3c/3s (the frontier compaction into the block's bucket), a
    ``merge_insert`` of 320 rows into a 2^22-row table, the host-verified
    compaction of flagged frontier rows at each single-copy-register hv
    run's widest rung (``hv_shapes``: its rows, live frontier, flagged
    count and cap), and, as an adversarial extra no run makes, 4,096 rows
    with a quarter flagged, past the cap of 128."""
    comp, merge = {}, {}
    level, bucket = snug_level(c.level_log, rungs(c))
    f, a, cap = level["bucket"], c.model().max_actions, level["cand_cap"]
    mask, lanes, _ = _grid_case(rng, f, a, level["generated"] / (f * a), cap)
    check = check_compact("rm8_rung_grid", mask, lanes, cap, reps=20)
    comp["rm8_rung_grid"] = {"F": f, "A": a, "P": len(lanes), "cap": cap, **check,
                             **time_compact(mask, lanes, cap, check["n_valid"], 2, 3 * f * 8)}
    fmask, flanes, fcap = _frontier_case(rng, {**level, "bucket": bucket})
    check = check_compact("rm8_rung_frontier", fmask, flanes, fcap, reps=20)
    comp["rm8_rung_frontier"] = {"M": fmask.numel(), "P": len(flanes), "cap": fcap, **check,
                                 **time_compact(fmask, flanes, fcap, check["n_valid"], 3, 0)}
    gen = torch.Generator(device="cuda").manual_seed(5)
    A, W = shapes["A"], shapes["W"]
    level, bucket = snug_level(shapes["levels"], shapes["rungs"])
    f, cap = level["bucket"], level["cand_cap"]
    grid = torch.randint(0, 2**32, (f, A, W), dtype=DTYPE, device="cuda", generator=gen)
    per_state = torch.randint(0, 2**32, (3, f), dtype=DTYPE, device="cuda", generator=gen)
    live = torch.arange(f, device="cuda")[:, None] < level["frontier"]
    density = level["generated"] / (level["frontier"] * A)
    mask = (torch.rand((f, A), device="cuda", generator=gen) < density) & live
    lanes = [grid[:, :, w] for w in range(W)] + [p[:, None].expand(f, A) for p in per_state]
    check = check_compact("paxos3_rung_grid", mask, lanes, cap, reps=20)
    comp["paxos3_rung_grid"] = {"F": f, "A": A, "P": len(lanes), "cap": cap, **check,
                                **time_compact(mask, lanes, cap, check["n_valid"], W, 3 * f * 8)}
    del grid, per_state, lanes, mask
    rows = torch.randint(0, 2**32, (W + 1, cap), dtype=DTYPE, device="cuda", generator=gen)
    flags = np.zeros(cap, bool)
    flags[rng.choice(level["generated"], level["unique"], replace=False)] = True
    fmask, flanes = torch.from_numpy(flags).cuda(), list(rows)
    check = check_compact("paxos3_rung_frontier", fmask, flanes, bucket, reps=20)
    comp["paxos3_rung_frontier"] = {"M": cap, "P": W + 1, "cap": bucket, **check,
                                    **time_compact(fmask, flanes, bucket, check["n_valid"], W + 1, 0)}
    del rows, fmask, flanes
    past_cap = {"F": 4096, "frontier": 4096, "W": hv_shapes["4c2s_hv"]["W"], "cap": 128,
                "flagged": 1024}
    for name, shape in [*hv_shapes.items(), ("hv_past_cap", past_cap)]:
        f, hv_w = shape["F"], shape["W"]
        frontier = torch.randint(0, 2**32, (f, hv_w), dtype=DTYPE, device="cuda", generator=gen)
        fps = torch.randint(0, 2**32, (2, f), dtype=DTYPE, device="cuda", generator=gen)
        hv_lanes = [frontier[:, w] for w in range(hv_w)] + list(fps)
        flags = np.zeros(f, bool)
        flags[rng.choice(shape["frontier"], shape["flagged"], replace=False)] = True
        hmask = torch.from_numpy(flags).cuda()
        check = check_compact(name, hmask, hv_lanes, shape["cap"], reps=20)
        comp[name] = {**shape, "P": len(hv_lanes), **check,
                      **time_compact(hmask, hv_lanes, shape["cap"], check["n_valid"], hv_w + 2, 0)}
        del frontier, fps, hv_lanes, hmask
    table, batch = _merge_case(rng, 1 << 22, 1_300_000, 320)
    check = check_merge("m_320", table, batch, reps=20)
    nk = check["n_keep"]
    merge["m_320"] = {**check, **kernel_timing(
        lambda: merge_insert(table, batch), lambda: merge_insert_plain(table, batch), None,
        (2 * (1 << 22) + 2 * 320) * 8 + 6 * nk * 8 + 320 + 8, MERGE_SYMBOL)}
    del table, batch
    gc.collect()
    torch.cuda.empty_cache()
    drop = ("device_ops",)
    comp = {k: {n: v for n, v in d.items() if n not in drop} for k, d in comp.items()}
    merge = {k: {n: v for n, v in d.items() if n not in drop} for k, d in merge.items()}
    emit({"phase": "rung_kernels", "compact": comp, "merge_insert": merge})
    return {"compact": comp, "merge_insert": merge}


# --- checkpoints, the visitor path and increment ----------------------------

#: Where the checkpoint phases write their files (``main`` makes and removes
#: it, in the temporary directory of the process).
CKPT_DIR = None
#: The depth a 2pc rm=5 search is saved at on one device and resumed on the
#: other.
RM5_SAVE_DEPTH = 6
#: The depth a Paxos 3c/3s search is saved at and resumed from.
PAXOS3_SAVE_DEPTH = 8


def run_to_depth(model, depth: int, **kw):
    """A search of ``model`` stopped with the frontier at ``depth`` intact:
    ``target_max_depth`` bounds each block's level budget, and the loop stops
    before the next dispatch's entry check would retire the frontier."""
    c = model.checker().target_max_depth(depth).spawn_xla(**kw)
    while c._depth < depth and not c.is_done():
        c._run_block()
    require(c._depth == depth and c._frontier_count > 0, f"stopped at depth {c._depth}")
    return c


def tail_levels(c, depth: int) -> list:
    """``(depth, frontier, generated, unique)`` of every level from ``depth``
    on."""
    return [r[:4] for r in levels(c) if r[0] >= depth]


def check_paths(c) -> None:
    c.assert_properties()
    for name, path in c.discoveries().items():
        c.assert_discovery(name, path.into_actions())


def checkpoint_resume(model, depth: int, whole, what: str, final_depth=None) -> dict:
    """``model`` searched on the card to ``depth`` and saved; the file
    resumed in a fresh checker on the card and joined (to ``final_depth``
    if given): the resumed run's counts, levels and discoveries equal the
    uninterrupted run ``whole``'s. Times the device-to-host copy of the
    payload, the save, the load-and-restore and the resumed run; launches
    count from the first level to the resumed run's end."""
    path = os.path.join(CKPT_DIR, f"{what}.npz")
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    partial = run_to_depth(model, depth)
    torch.cuda.synchronize()
    partial_wall = time.perf_counter() - t0
    require(tail_levels(whole, 0)[: depth - 1] == [r[:4] for r in levels(partial)],
            f"{what}: levels before the save")
    t0 = time.perf_counter()
    arrays = checkpoint_arrays(partial)
    d2h_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    partial.save_checkpoint(path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    builder = model.checker()
    if final_depth is not None:
        builder = builder.target_max_depth(final_depth)
    resumed = builder.spawn_xla(checkpoint=path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    require((resumed.state_count(), resumed.unique_state_count())
            == (partial.state_count(), partial.unique_state_count()), f"{what}: restored counts")
    t0 = time.perf_counter()
    resumed.join()
    torch.cuda.synchronize()
    resumed_wall = time.perf_counter() - t0
    launches = launches_now()
    require(all(n > 0 for n in launches.values()), f"{what}: kernel launches {launches}")
    counts = (resumed.state_count(), resumed.unique_state_count(), resumed.max_depth())
    require(counts == (whole.state_count(), whole.unique_state_count(), whole.max_depth()),
            f"{what}: resumed counts {counts}")
    require(tail_levels(resumed, depth) == tail_levels(whole, depth), f"{what}: levels after the resume")
    check_paths(resumed)
    return {
        "save_depth": depth, "generated": counts[0], "unique": counts[1], "max_depth": counts[2],
        "saved_rows": len(arrays["key_hi"]), "saved_frontier": len(arrays["frontier"]),
        "payload_bytes": sum(a.nbytes for a in arrays.values()),
        "file_bytes": os.path.getsize(path), "partial_wall_s": partial_wall,
        "d2h_s": d2h_s, "save_s": save_s, "restore_s": restore_s,
        "resumed_wall_s": resumed_wall,
        "table_capacity": {"writer": partial.metrics()["table_capacity"],
                           "resumed": resumed.metrics()["table_capacity"]},
        "resumed_graph_captures": resumed.metrics()["graph_captures"],
        "levels_after_resume_equal": True, "launches": launches,
    }


def checkpoint_rm8_phase(model, whole) -> dict:
    """2pc rm=8 saved at its widest level through the fused CUDA-graph path
    of the warm main-path instance, and resumed on the card."""
    depth = max(whole.level_log, key=lambda r: r["frontier"])["depth"]
    line = checkpoint_resume(model, depth, whole, "checkpoint_rm8")
    require((line["generated"], line["unique"]) == EXPECTED_2PC[8], "checkpoint_rm8 counts")
    emit({"phase": "checkpoint_rm8", **line})
    return line["launches"]


def checkpoint_paxos3_phase(model, whole) -> dict:
    """Paxos 3c/3s saved at depth 8 on the warm instance of ``paxos3_phase``
    and resumed to ``PAXOS3_DEPTH``; then a warm run to that depth
    auto-checkpointing every block beside two without. Returns the
    launches of both paths."""
    line = checkpoint_resume(model, PAXOS3_SAVE_DEPTH, whole, "checkpoint_paxos3",
                             final_depth=PAXOS3_DEPTH)
    require((line["generated"], line["unique"]) == PAXOS3_DEPTH15, "checkpoint_paxos3 counts")
    auto, auto_launches, _, _ = auto_checkpointed(model, "autockpt_paxos3", PAXOS3_DEPTH15,
                                                  depth=PAXOS3_DEPTH)
    emit({"phase": "checkpoint_paxos3", **line, "autockpt": auto})
    return {"checkpoint_paxos3": line["launches"], "autockpt_paxos3": auto_launches}


def auto_checkpointed(model, what: str, expected, depth=None):
    """A warm run of ``model`` with ``checkpoint_to``, ``checkpoint_every=1``
    and ``checkpoint_keep=3``, between two warm runs without: exact counts,
    one write at every block boundary that committed a level, and the
    rotations kept. Returns ``(line, launches, checker, path)``; the line
    has the walls of all three runs."""
    path = os.path.join(CKPT_DIR, f"{what}.npz")
    _, before, _ = drive(model, depth=depth)
    c, wall, launches = drive(model, depth=depth, checkpoint_to=path, checkpoint_every=1,
                              checkpoint_keep=3)
    _, after, _ = drive(model, depth=depth)
    require((c.state_count(), c.unique_state_count()) == expected, f"{what} counts")
    require(all(n > 0 for n in launches.values()), f"{what}: kernel launches {launches}")
    written = c.metrics()["checkpoints_written"]
    blocks = sum(1 for _, committed in c.dispatch_log if committed)
    require(written == blocks, f"{what}: {written} writes for {blocks} blocks")
    rots = rotations(path)
    require(len(rots) == min(written, 3), f"{what} rotations {rots}")
    require(load_checkpoint(path)["meta"]["depth"] == c.metrics()["last_checkpoint_level"],
            f"{what}: the newest rotation is the last write")
    line = {"warm_wall_s": wall, "warm_wall_without_s": [before, after],
            "checkpoints_written": written, "blocks": blocks, "dispatch_log": c.dispatch_log,
            "rotation_bytes": [os.path.getsize(r) for r in rots], "launches": launches}
    return line, launches, c, path


def autockpt_rm8_phase(model) -> dict:
    """Warm rm=8 with ``checkpoint_to``, ``checkpoint_every=1`` and
    ``checkpoint_keep=3``, between two warm runs without
    (:func:`auto_checkpointed`); the whole visited set's copy to the host
    and save timed; and ``latest_valid_checkpoint`` past a newest rotation
    torn by hand, whose fallback restores (timed) and resumes to the exact
    counts."""
    line, launches, c, path = auto_checkpointed(model, "autockpt_rm8", EXPECTED_2PC[8])
    # The whole visited set (1,745,408 rows) copied to the host and saved.
    t0 = time.perf_counter()
    arrays = checkpoint_arrays(c)
    full_d2h = time.perf_counter() - t0
    full = os.path.join(CKPT_DIR, "rm8_full.npz")
    t0 = time.perf_counter()
    c.save_checkpoint(full)
    full_save = time.perf_counter() - t0
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) // 2)
    fallback = latest_valid_checkpoint(path)
    require(fallback == f"{path}.1", f"autockpt_rm8: fallback {fallback}")
    t0 = time.perf_counter()
    back = model.checker().spawn_xla(checkpoint=fallback)
    torch.cuda.synchronize()
    fallback_restore = time.perf_counter() - t0
    back.join()
    require((back.state_count(), back.unique_state_count()) == EXPECTED_2PC[8],
            "autockpt_rm8: the fallback resumes to the exact counts")
    emit({"phase": "autockpt_rm8", **line, "fallback": os.path.basename(fallback),
          "fallback_rows": load_checkpoint(fallback)["key_hi"].size,
          "fallback_restore_s": fallback_restore,
          "full": {"rows": arrays["key_hi"].size,
                   "payload_bytes": sum(a.nbytes for a in arrays.values()),
                   "d2h_s": full_d2h, "save_s": full_save, "file_bytes": os.path.getsize(full)}})
    return launches


def cpu_card_checkpoint_phase() -> dict:
    """2pc rm=5 saved at depth 6 on the CPU and resumed on the card, and
    saved at depth 6 on the card and resumed on the CPU: both files hold the
    same payload, and both resumed runs end at the counts and levels of an
    uninterrupted run on the card."""
    whole = PackedTwoPhaseSys(5).checker().spawn_xla().join()
    on_cpu, on_card = (os.path.join(CKPT_DIR, f"rm5_{d}.npz") for d in ("cpu", "card"))
    run_to_depth(PackedTwoPhaseSys(5), RM5_SAVE_DEPTH, device="cpu").save_checkpoint(on_cpu)
    model = PackedTwoPhaseSys(5)
    torch.cuda.synchronize()
    zero_launches()
    run_to_depth(model, RM5_SAVE_DEPTH).save_checkpoint(on_card)
    to_card = model.checker().spawn_xla(checkpoint=on_cpu).join()
    torch.cuda.synchronize()
    launches = launches_now()
    to_cpu = PackedTwoPhaseSys(5).checker().spawn_xla(device="cpu", checkpoint=on_card).join()
    a, b = load_checkpoint(on_cpu), load_checkpoint(on_card)
    require(all(np.array_equal(a[k], b[k]) for k in PAYLOAD_KEYS)
            and a["meta"]["payload_sha256"] == b["meta"]["payload_sha256"],
            "rm=5: the CPU's and the card's checkpoints differ")
    for c, what in ((to_card, "CPU -> card"), (to_cpu, "card -> CPU")):
        require((c.state_count(), c.unique_state_count()) == EXPECTED_2PC[5], f"rm=5 {what} counts")
        require(tail_levels(c, RM5_SAVE_DEPTH) == tail_levels(whole, RM5_SAVE_DEPTH),
                f"rm=5 {what} levels")
    require(all(n > 0 for n in launches.values()), f"cpu_card_checkpoint: kernel launches {launches}")
    emit({"phase": "cpu_card_checkpoint", "rm": 5, "save_depth": RM5_SAVE_DEPTH,
          "payload_sha256_equal": True, "generated": EXPECTED_2PC[5][0],
          "unique": EXPECTED_2PC[5][1], "launches": launches})
    return launches


def visitor_phase() -> dict:
    """``PackedTwoPhaseSys(4)`` with a ``PathRecorder`` through
    ``spawn_xla()`` on the card (one level per dispatch): the recorded paths
    equal the port's host ``spawn_bfs()`` visitor's, as a set of paths."""
    recorder, recorded = PathRecorder.new_with_accessor()
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    c = PackedTwoPhaseSys(4).checker().visitor(recorder).spawn_xla().join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launches_now()
    host_recorder, host_recorded = PathRecorder.new_with_accessor()
    PackedTwoPhaseSys(4).checker().visitor(host_recorder).spawn_bfs().join()

    def paths(ps):
        return {(tuple(p.into_states()), tuple(p.into_actions())) for p in ps}

    got = paths(recorded())
    require(c.metrics()["levels_per_dispatch"] == 1, "a visitor forces one level per dispatch")
    require(len(got) == EXPECTED_2PC[4][1] and got == paths(host_recorded()),
            "visitor paths, card vs host BFS")
    require(all(n > 0 for n in launches.values()), f"visitor: kernel launches {launches}")
    emit({"phase": "visitor", "rm": 4, "paths": len(got), "equal_host_bfs": True, "wall_s": wall,
          "dispatches": len(c.dispatch_log), "launches": launches})
    return launches


def increment_phase() -> dict:
    """``PackedIncrementLock(3)`` on the card to (61, 61), then
    ``PackedIncrement(2)`` to its ``fin`` counterexample, whose witness is as
    long as the port's host BFS's."""
    lock, lock_wall, lock_launches = drive(PackedIncrementLock(3))
    require((lock.state_count(), lock.unique_state_count()) == EXPECTED_INCREMENT_LOCK3,
            f"increment-lock 3t counts {(lock.state_count(), lock.unique_state_count())}")
    check_paths(lock)
    race, race_wall, race_launches = drive(PackedIncrement(2))
    witness = race.discoveries()["fin"]
    host = Increment(2).checker().spawn_bfs().join().discoveries()["fin"]
    require(len(witness) == len(host), f"fin witness {len(witness)} vs host BFS {len(host)}")
    race.assert_discovery("fin", witness.into_actions())
    for name, launches in (("increment_lock3", lock_launches), ("increment2", race_launches)):
        require(all(n > 0 for n in launches.values()), f"{name}: kernel launches {launches}")
    emit({"phase": "increment", "increment_lock3": {
        "generated": lock.state_count(), "unique": lock.unique_state_count(), "wall_s": lock_wall,
        "state_words": lock.model().state_words, "max_actions": lock.model().max_actions,
        "launches": lock_launches,
    }, "increment2": {"fin_witness": len(witness), "host_bfs_witness": len(host),
                      "generated": race.state_count(), "wall_s": race_wall, "launches": race_launches}})
    return {"increment_lock3": lock_launches, "increment2": race_launches}


# --- ABD and the remaining models ----------------------------------------------

ABD = {"unordered": PackedAbd, "ordered": PackedAbdOrdered}


def abd_phase():
    """The ABD linearizable register through ``spawn_xla()``: 2c/2s on both
    networks and 3c/2s (W = 39 and 31, A = 417 and 14, 1,680 interleavings
    per linearizability check) on both, each 3c/2s run cold and then warm
    on one model instance (the warm run capturing nothing), every count
    exact and every discovery re-executed on the host; each 3c/2s space
    also equal to the CPU's level by level at the CPU tests' depth cut;
    the unordered 3c/2s run once more one level per dispatch to the widest
    frontier (depth 31), with the peak memory of every bucket and that
    level split by stage. Returns the launches of each run and the shapes
    of the unordered 3c/2s run."""
    out, launches = {}, {}
    for net in ("unordered", "ordered"):
        c, wall, launches[f"abd2_{net}"] = drive(ABD[net](2, 2))
        counts = (c.state_count(), c.unique_state_count(), c.max_depth())
        require(counts == EXPECTED_ABD[(net, 2)], f"abd 2c/2s {net} counts {counts}")
        check_paths(c)
        out[f"2c2s_{net}"] = {"generated": counts[0], "unique": counts[1], "max_depth": counts[2],
                              "cold_wall_s": wall, "launches": launches[f"abd2_{net}"],
                              "audit": audited(c, f"abd 2c/2s {net}"),
                              "graph_captures": c.metrics()["graph_captures"]}
    shapes = None
    for net in ("unordered", "ordered"):
        model = ABD[net](3, 2)
        torch.cuda.reset_peak_memory_stats()
        PROGRAM_USE.segment = f"abd3_{net}_cold"
        cold, cold_wall, cold_launches = drive(model)
        cold_peak = torch.cuda.max_memory_allocated() / 2**30
        PROGRAM_USE.segment = f"abd3_{net}_warm"
        warm, warm_wall, warm_launches = drive(model)
        PROGRAM_USE.segment = "other"
        launches[f"abd3_{net}"] = cold_launches
        counts = (cold.state_count(), cold.unique_state_count(), cold.max_depth())
        require(counts == EXPECTED_ABD[(net, 3)], f"abd 3c/2s {net} counts {counts}")
        require((warm.state_count(), warm.unique_state_count(), warm.max_depth()) == counts,
                f"abd 3c/2s {net} warm vs cold counts")
        require([r[:4] for r in levels(warm)] == [r[:4] for r in levels(cold)],
                f"abd 3c/2s {net} warm vs cold per-level counts")
        require(cold.metrics()["graph_captures"] > 0, f"abd 3c/2s {net}: the cold run captured nothing")
        require(warm.metrics()["graph_captures"] == 0, f"abd 3c/2s {net}: the warm run captured graphs")
        require(all(n > 0 for n in cold_launches.values()), f"abd 3c/2s {net} kernel launches {cold_launches}")
        t1 = time.perf_counter()
        check_paths(cold)
        check_paths(warm)
        paths_s = time.perf_counter() - t1
        depth = ABD3_CPU_DEPTH[net]
        card, _, _ = drive(ABD[net](3, 2), depth=depth)
        t0 = time.perf_counter()
        cpu = ABD[net](3, 2).checker().target_max_depth(depth).spawn_xla(device="cpu").join()
        cpu_wall = time.perf_counter() - t0
        same_search(card, cpu, f"abd 3c/2s {net} to depth {depth}")
        m = cold.metrics()
        widest = max(cold.level_log, key=lambda r: r["frontier"])
        line = {
            "state_words": model.state_words, "max_actions": model.max_actions,
            "generated": counts[0], "unique": counts[1], "max_depth": counts[2],
            "cold_wall_s": cold_wall, "warm_wall_s": warm_wall,
            "states_per_s": counts[0] / warm_wall, "cold_states_per_s": counts[0] / cold_wall,
            "level_log": [list(r[:6]) for r in levels(cold)], "rungs": rungs(cold),
            "cand_retries": m["cand_retries"], "dispatch_log": cold.dispatch_log,
            "graph_captures": m["graph_captures"], "capture_s": m["graph_capture_s"],
            "program_use": PROGRAM_USE.summary(f"abd3_{net}_cold", [f"abd3_{net}_warm"]),
            "table_capacity": m["table_capacity"], "frontier_capacity": m["frontier_capacity"],
            "peak_mem_gib": {"cold": cold_peak, "reserved_after_cold": torch.cuda.memory_reserved() / 2**30},
            "widest_level": {k: widest[k] for k in LEVEL_KEYS},
            "launches": {"cold": cold_launches, "warm": warm_launches},
            "audit": {"cold": audited(cold, f"abd 3c/2s {net} cold"),
                      "warm": audited(warm, f"abd 3c/2s {net} warm")},
            "discoveries": {k: len(p) for k, p in cold.discoveries().items()}, "paths_s": paths_s,
            "cpu_depth_cut": {"depth": depth, "card_equals_cpu": True, "cpu_wall_s": cpu_wall,
                              "generated": cpu.state_count(), "unique": cpu.unique_state_count()},
        }
        if net == "unordered":
            # One level per dispatch to the widest frontier: the peak memory
            # of every bucket, and that level (the widest bucket's) by stage.
            split_depth = widest["depth"] + 1
            (single, single_wall, _), peaks = per_level_peaks(
                lambda: drive(ABD[net](3, 2), depth=split_depth, levels_per_dispatch=1))
            require([r[:4] for r in levels(single)] == [r[:4] for r in levels(cold)][:len(single.level_log)],
                    "abd 3c/2s one level per dispatch vs fused, level by level")
            bucket_peaks = {}
            for bucket, gib in peaks:
                bucket_peaks[bucket] = max(bucket_peaks.get(bucket, 0.0), gib)
            line["peak_mem_gib_by_bucket"] = bucket_peaks
            line["level_split_ms"] = level_split(single)
            line["single"] = {"target_max_depth": split_depth, "wall_s": single_wall}
            shapes = {
                "levels": [dict(r) for r in cold.level_log], "rungs": rungs(cold),
                "table_capacity": m["table_capacity"], "generated": counts[0], "unique": counts[1],
                "A": model.max_actions, "W": model.state_words,
            }
            del single
        out[f"3c2s_{net}"] = line
        del model, cold, warm, card, cpu
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "abd", **out})
    return launches, shapes


def models_phase() -> dict:
    """The remaining models on the card: ping-pong lossy max 5 (4,094
    states) and the sliding puzzle's doc board (its 4-slide discovery),
    each re-executed on the host; timers 3 to depth 5 equal to the CPU's
    search; and ``PackedAbd(2, 2)`` saved after 8 levels on the CPU and
    resumed on the card, and the other way, both ending at 875 / 544."""
    launches = {}
    pp, pp_wall, launches["ping_pong"] = drive(PackedPingPong(PingPongCfg(False, 5), lossy=True))
    require(pp.unique_state_count() == PING_PONG_LOSSY5, f"ping-pong unique {pp.unique_state_count()}")
    pz, pz_wall, launches["puzzle"] = drive(PackedPuzzle([1, 4, 2, 3, 5, 8, 6, 7, 0]))
    pz.assert_discovery("solved", ["Down", "Right", "Down", "Right"])
    tm, tm_wall, launches["timers"] = drive(PackedTimers(3), depth=5)
    same_search(tm, PackedTimers(3).checker().target_max_depth(5).spawn_xla(device="cpu").join(),
                "timers 3 to depth 5")
    on_cpu, on_card = (os.path.join(CKPT_DIR, f"abd_{d}.npz") for d in ("cpu", "card"))
    partial = PackedAbd(2, 2).checker().spawn_xla(device="cpu", levels_per_dispatch=1)
    for _ in range(8):
        partial._run_block()
    partial.save_checkpoint(on_cpu)
    torch.cuda.synchronize()
    zero_launches()
    partial = PackedAbd(2, 2).checker().spawn_xla(levels_per_dispatch=1)
    for _ in range(8):
        partial._run_block()
    partial.save_checkpoint(on_card)
    to_card = PackedAbd(2, 2).checker().spawn_xla(checkpoint=on_cpu).join()
    torch.cuda.synchronize()
    launches["abd_checkpoint"] = launches_now()
    to_cpu = PackedAbd(2, 2).checker().spawn_xla(device="cpu", checkpoint=on_card).join()
    a, b = load_checkpoint(on_cpu), load_checkpoint(on_card)
    require(all(np.array_equal(a[k], b[k]) for k in PAYLOAD_KEYS)
            and a["meta"]["payload_sha256"] == b["meta"]["payload_sha256"],
            "abd 2c/2s: the CPU's and the card's checkpoints differ")
    for c, what in ((to_card, "CPU -> card"), (to_cpu, "card -> CPU")):
        counts = (c.state_count(), c.unique_state_count(), c.max_depth())
        require(counts == EXPECTED_ABD[("unordered", 2)], f"abd 2c/2s {what} counts {counts}")
        check_paths(c)
    # Ping-pong's "must exceed max" counterexample ends at the boundary,
    # where the host's terminal test sees the successors the boundary cuts,
    # so its paths are held to the CPU's rather than re-executed.
    pp_cpu = PackedPingPong(PingPongCfg(False, 5), lossy=True).checker().spawn_xla(device="cpu").join()
    require((pp.state_count(), pp.unique_state_count(), pp.max_depth())
            == (pp_cpu.state_count(), pp_cpu.unique_state_count(), pp_cpu.max_depth()),
            "ping-pong counts, card vs CPU")
    require([r[:4] for r in levels(pp)] == [r[:4] for r in levels(pp_cpu)], "ping-pong levels, card vs CPU")
    dg, dc = pp.discoveries(), pp_cpu.discoveries()
    require(set(dg) == set(dc) and all(dg[k].into_actions() == dc[k].into_actions() for k in dc),
            "ping-pong discoveries, card vs CPU")
    check_paths(pz)
    for name, n in launches.items():
        require(all(v > 0 for v in n.values()), f"{name}: kernel launches {n}")
    emit({"phase": "models",
          "ping_pong_lossy5": {"generated": pp.state_count(), "unique": pp.unique_state_count(),
                               "wall_s": pp_wall},
          "puzzle_doc_board": {"generated": pz.state_count(), "unique": pz.unique_state_count(),
                               "solved_witness": len(pz.discoveries()["solved"]), "wall_s": pz_wall},
          "timers3_depth5": {"generated": tm.state_count(), "unique": tm.unique_state_count(),
                             "card_equals_cpu": True, "wall_s": tm_wall},
          "abd_checkpoint": {"save_levels": 8, "payload_sha256_equal": True, "generated": to_card.state_count(),
                             "unique": to_card.unique_state_count()},
          "launches": launches})
    return launches


# --- symmetry ------------------------------------------------------------------

#: ``PackedTwoPhaseSys(rm).checker().symmetry()``: (generated, unique, max
#: depth), as the JAX package's engine counts them.
EXPECTED_2PC_SYM = {5: (2_048, 314, 17), 8: (15_287, 1_461, 26), 14: (227_468, 12_323, 44)}
#: The increment models' unique counts, full space and reduced
#: (``tests/test_symmetry.py``), by (model, threads).
EXPECTED_INCREMENT_SYM = {
    ("increment", 2): (13, 8), ("increment", 3): (84, 22),
    ("increment_lock", 2): (17, 9), ("increment_lock", 3): (61, 13),
}
#: Seeded rm=14 rows the card's canonicalization is held against its host
#: twin and its CPU run on.
CANON_ROWS = 1 << 20
#: The depth a symmetric rm=8 search is saved at on one device and resumed
#: on the other.
SYM_SAVE_DEPTH = 12
#: Calls profiled to count a level's (or the canonicalization's) device
#: operations.
PRICE_CALLS = 20


class _FullSpace:
    """An unreachable ``sometimes`` in place of the always-properties, so that
    the search exhausts the space (``tests/test_symmetry.py``'s variants)."""

    def properties(self):
        return [Property.sometimes("unreachable", lambda _m, _s: False)]

    def packed_properties(self, words):
        return torch.zeros((words.shape[0], 1), dtype=torch.bool, device=words.device)


class _IncrementFull(_FullSpace, PackedIncrement):
    pass


class _IncrementLockFull(_FullSpace, PackedIncrementLock):
    pass


def sym_line(c, what: str, launches: dict, wall: float) -> dict:
    """Checks of a symmetric 2pc run: its pins, both discoveries re-executed
    to valid paths (the host's canonicalization agrees with the card's),
    the spec's tag in ``metrics()`` and every ``level_log`` row; its line."""
    rm = c.model().rm_count
    counts = (c.state_count(), c.unique_state_count(), c.max_depth())
    require(counts == EXPECTED_2PC_SYM[rm], f"{what}: counts {counts}")
    require(all(n > 0 for n in launches.values()), f"{what}: kernel launches {launches}")
    found = c.discoveries()
    require(sorted(found) == ["abort agreement", "commit agreement"], f"{what}: discoveries {sorted(found)}")
    check_paths(c)
    m = c.metrics()
    tag = f"spec:{c.model().symmetry_spec.spec_hash()[:12]}"
    require(m["symmetry"] == tag and all(r["sym"] == tag for r in c.level_log), f"{what}: tag")
    return {
        "generated": counts[0], "unique": counts[1], "max_depth": counts[2], "wall_s": wall,
        "states_per_s": counts[0] / wall, "levels": len(c.level_log), "dispatches": m["dispatches"],
        "dispatch_log": c.dispatch_log, "graph_captures": m["graph_captures"],
        "capture_s": m["graph_capture_s"], "dead_replays": m["dead_replays"],
        "cand_retries": m["cand_retries"], "symmetry": tag, "launches": launches,
        "discoveries": {k: len(p) for k, p in found.items()}, "audit": audited(c, what),
    }


def replay_price(model, warm) -> dict:
    """One level's device operations and device time with and without the
    canonicalization, at the widest bucket of ``warm`` (a symmetric run of
    ``model``): its full-rung program replayed beside the plain program of
    the same shape key, captured on the same model instance (so on the same
    carry, with the gate closed: a dead level runs every operation). Also
    the canonicalization alone on that bucket's frontier and candidate
    buffer."""
    tag = warm.metrics()["symmetry"]
    run_cap = max(b for b, n in warm.dispatch_log if n)
    programs = graphs.cache_for(model, torch.device("cuda")).programs
    key = next(k for k in programs if k[0] == k[1] == run_cap and k[-1] == tag)
    plain = model.checker().spawn_xla(symmetry="off")
    plain._cand_caps[run_cap] = key[2]
    require(plain._tail()[:3] == key[3:6], f"replay_price: plain checker's tail {plain._tail()}")
    plain_prog = plain._program(run_cap, key[1:3])
    sym_prog = programs[key]
    sym_prog.carry.s[graphs.S["budget"]] = 0
    canon = compile_canon(model.symmetry_spec)
    frontier = torch.randint(0, 2**32, (run_cap, 2), dtype=DTYPE, device="cuda")
    cands = torch.randint(0, 2**32, (2, key[2]), dtype=DTYPE, device="cuda")
    calls = {
        "symmetric_level": sym_prog.graph.replay, "plain_level": plain_prog.graph.replay,
        "canon_frontier": lambda: canon(frontier.T), "canon_candidates": lambda: canon(cands),
    }
    line = {"run_cap": run_cap, "cand_cap": key[2]}
    for name, fn in calls.items():
        fn()
        _, _, kernels = profiled(lambda: [fn() for _ in range(PRICE_CALLS)])
        line[name] = {
            "device_ops": sum(n for _, _, n in kernels) / PRICE_CALLS if kernels else "not measured",
            "device_ms": sum(ms for _, ms, _ in kernels) / PRICE_CALLS if kernels else "not measured",
            "ms": timed_ms(fn, queued=True),
        }
    return line


def _host_canon_rows(args):
    """``canonicalize_host`` over a chunk of rows (a pool worker's task)."""
    spec, rows = args
    return np.stack([canonicalize_host(spec, r) for r in rows])


def canon_oracle(rng) -> dict:
    """``compile_canon`` of the rm=14 spec on the card over ``CANON_ROWS``
    seeded rows of random words, bitwise against its host twin (in a pool
    of worker processes) and against the same function on the CPU; timed."""
    spec = PackedTwoPhaseSys(14).symmetry_spec
    rows = rng.integers(0, 2**32, size=(CANON_ROWS, 2), dtype=np.uint64).astype(np.uint32)
    canon = compile_canon(spec)
    planes = from_u32(rows, "cuda").T
    card = canon(planes).T
    torch.cuda.synchronize()
    card = card.cpu().numpy()
    t0 = time.perf_counter()
    cpu = canon(from_u32(rows, "cpu").T).T.numpy()
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(os.cpu_count()) as pool:
        host = np.concatenate(pool.map(
            _host_canon_rows, [(spec, chunk) for chunk in np.array_split(rows, 64)]))
    host_s = time.perf_counter() - t0
    require(np.array_equal(card, cpu), "canon: card vs CPU")
    require(np.array_equal(card.astype(np.uint32), host), "canon: card vs canonicalize_host")
    changed = int((host != rows).any(1).sum())
    return {"rows": CANON_ROWS, "rows_changed": changed, "equal_host_twin": True,
            "equal_cpu": True, "card_ms": timed_ms(lambda: canon(planes), queued=True),
            "cpu_s": cpu_s, "host_twin_s": host_s}


def symmetry_phase(rng) -> dict:
    """Device symmetry reduction through ``Packed<Model>(...).checker()
    .symmetry().spawn_xla()`` on the card: 2pc rm=14 (the widest the model
    packs) cold and then warm on one model instance at the JAX package's
    pins, the warm run capturing nothing, and a warm run under
    ``torch.profiler``; the canonicalization's price per level
    (:func:`replay_price`); rm=8 equal to the CPU level by level; one rm=5
    instance through symmetric, plain and symmetric runs (the program key
    holds the tag: the third run captures nothing); the increment models
    through the spec and through ``packed_representative``; the
    canonicalization against its host twin (:func:`canon_oracle`); and a
    symmetric rm=8 checkpoint crossing CPU and card both ways. Returns the
    launches of each path and the shapes of the warm rm=14 run."""
    launches, out = {}, {}
    model = PackedTwoPhaseSys(14)
    torch.cuda.reset_peak_memory_stats()
    PROGRAM_USE.segment = "sym14_cold"
    cold, cold_wall, launches["sym_rm14"] = drive(model, sym=True)
    PROGRAM_USE.segment = "sym14_warm"
    warm, warm_wall, warm_launches = drive(model, sym=True)
    PROGRAM_USE.segment = "other"
    peak = torch.cuda.max_memory_allocated() / 2**30
    out["rm14_cold"] = sym_line(cold, "sym rm=14 cold", launches["sym_rm14"], cold_wall)
    out["rm14_warm"] = sym_line(warm, "sym rm=14 warm", warm_launches, warm_wall)
    require(out["rm14_cold"]["graph_captures"] > 0, "sym rm=14: the cold run captured no graph")
    require(out["rm14_warm"]["graph_captures"] == 0,
            f"sym rm=14: the warm run captured {out['rm14_warm']['graph_captures']} graphs")
    require([r[:4] for r in levels(warm)] == [r[:4] for r in levels(cold)], "sym rm=14 warm vs cold")
    out["rm14_peak_mem_gib"] = peak
    out["rm14_program_use"] = PROGRAM_USE.summary("sym14_cold", ["sym14_warm"])
    out["rm14_levels"] = [r[:4] for r in levels(warm)]
    c, wall, kernels = profiled(lambda: model.checker().symmetry().spawn_xla().join())
    require(c.metrics()["graph_captures"] == 0, "sym rm=14: the profiled run captured graphs")
    m = c.metrics()
    replays = len(c.level_log) + m["dead_replays"] + m["cand_retries"]
    busy = sum(ms for _, ms, _ in kernels)
    out["rm14_warm_profile"] = {
        "profiled_wall_s": wall, "replays": replays,
        "device_busy_ms": busy if kernels else "not measured",
        "device_idle_share": 1 - busy / (wall * 1e3) if kernels else "not measured",
        "device_ops_per_replay": sum(n for _, _, n in kernels) / replays if kernels else "not measured",
        "top_kernels": [{"name": k[:90], "ms": ms, "calls": n}
                        for k, ms, n in sorted(kernels, key=lambda k: -k[1])[:10]],
    }
    out["rm14_replay_price"] = replay_price(model, warm)
    shapes = {
        "levels": [dict(r) for r in warm.level_log], "table_capacity": warm.metrics()["table_capacity"],
        "generated": warm.state_count(), "unique": warm.unique_state_count(),
        "A": model.max_actions, "W": model.state_words,
    }
    del model, cold, warm, c
    gc.collect()

    gpu, wall, launches["sym_rm8"] = drive(PackedTwoPhaseSys(8), sym=True)
    cpu = PackedTwoPhaseSys(8).checker().symmetry().spawn_xla(device="cpu").join()
    out["rm8"] = sym_line(gpu, "sym rm=8", launches["sym_rm8"], wall)
    same_search(gpu, cpu, "sym rm=8, card vs CPU")
    out["rm8"]["card_equals_cpu"] = True

    model = PackedTwoPhaseSys(5)
    runs = []
    for sym in (True, False, True):
        c, wall, n = drive(model, sym=sym)
        want = EXPECTED_2PC_SYM[5][:2] if sym else EXPECTED_2PC[5]
        require((c.state_count(), c.unique_state_count()) == want, f"rm=5 cache key: sym={sym}")
        runs.append({"symmetry": c.metrics()["symmetry"], "generated": c.state_count(),
                     "unique": c.unique_state_count(), "graph_captures": c.metrics()["graph_captures"],
                     "wall_s": wall})
        launches[f"sym_rm5_{len(runs)}"] = n
    require(runs[2]["graph_captures"] == 0, f"rm=5 cache key: the third run captured {runs[2]}")
    out["rm5_cache_key"] = runs

    inc = {}
    for (name, n), (full, reduced) in EXPECTED_INCREMENT_SYM.items():
        cls = _IncrementFull if name == "increment" else _IncrementLockFull
        off, _, _ = drive(cls(n))
        spec, _, n_spec = drive(cls(n), sym=True)
        bare = cls(n)
        del bare.symmetry_spec
        rep, _, n_rep = drive(bare, sym=True)
        got = (off.unique_state_count(), spec.unique_state_count(), rep.unique_state_count())
        require(got == (full, reduced, reduced), f"{name} {n}: {got}")
        require(spec.metrics()["symmetry"].startswith("spec:")
                and rep.metrics()["symmetry"] == "model:packed_representative", f"{name} {n}: tags")
        launches[f"sym_{name}{n}_spec"], launches[f"sym_{name}{n}_rep"] = n_spec, n_rep
        inc[f"{name}{n}"] = {"full": got[0], "spec": got[1], "packed_representative": got[2],
                             "spec_tag": spec.metrics()["symmetry"]}
    out["increment"] = inc

    out["canon_oracle"] = canon_oracle(rng)

    on_cpu, on_card = (os.path.join(CKPT_DIR, f"sym_rm8_{d}.npz") for d in ("cpu", "card"))
    run_to_depth(PackedTwoPhaseSys(8), SYM_SAVE_DEPTH, device="cpu", symmetry="on").save_checkpoint(on_cpu)
    torch.cuda.synchronize()
    zero_launches()
    run_to_depth(PackedTwoPhaseSys(8), SYM_SAVE_DEPTH, symmetry="on").save_checkpoint(on_card)
    to_card = PackedTwoPhaseSys(8).checker().symmetry().spawn_xla(checkpoint=on_cpu).join()
    torch.cuda.synchronize()
    launches["sym_checkpoint"] = launches_now()
    to_cpu = PackedTwoPhaseSys(8).checker().symmetry().spawn_xla(device="cpu", checkpoint=on_card).join()
    a, b = load_checkpoint(on_cpu), load_checkpoint(on_card)
    require(a["meta"]["symmetry"] == b["meta"]["symmetry"] == "spec:7e95d6c76225",
            f"sym checkpoint tags {a['meta']['symmetry']}, {b['meta']['symmetry']}")
    require(all(np.array_equal(a[k], b[k]) for k in PAYLOAD_KEYS), "sym rm=8: the CPU's and the card's checkpoints differ")
    for c, what in ((to_card, "CPU -> card"), (to_cpu, "card -> CPU")):
        require((c.state_count(), c.unique_state_count(), c.max_depth()) == EXPECTED_2PC_SYM[8],
                f"sym rm=8 {what} counts")
        require(tail_levels(c, SYM_SAVE_DEPTH) == tail_levels(cpu, SYM_SAVE_DEPTH), f"sym rm=8 {what} levels")
        check_paths(c)
    for device in ("cuda", "cpu"):
        try:
            PackedTwoPhaseSys(8).checker().spawn_xla(device=device, checkpoint=on_card)
        except ValueError as e:
            require("symmetry" in str(e), f"sym checkpoint without symmetry: {e}")
        else:
            require(False, f"a symmetric checkpoint resumed without symmetry on {device}")
    out["checkpoint"] = {"save_depth": SYM_SAVE_DEPTH, "symmetry": a["meta"]["symmetry"],
                         "payload_equal": True, "resumed_without_symmetry": "ValueError"}
    for name, n in launches.items():
        require(all(v > 0 for v in n.values()), f"{name}: kernel launches {n}")
    emit({"phase": "symmetry", **out, "launches": launches})
    return launches, shapes


# --- the hash and delta visited sets (spawn_xla(dedup=)) -------------------------

#: The soak configuration: 2pc at one resource manager past the flagship.
#: ``bench.py`` pins no count past rm=8, so the three structures are held
#: against each other.
SOAK_RM = 9
#: The hash kernel's first launch of an insert, as the profiler names it.
HASH_SYMBOL = "claim_kernel"
#: The table the hash kernel is held against its plain version in: 2^26
#: slots, the hash set's capacity at rm=9 (at most a quarter full).
HASH_TABLE = 1 << 26
#: The share of the rm=8 search a checkpoint leaves for the CPU to finish
#: (the port's CPU engine runs some ten thousand states a second).
CPU_TAIL_SHARE = 0.01


def dedup_line(c, wall: float, launches: dict, dedup: str, what: str, audit: bool = True) -> dict:
    """Checks of one run under ``dedup``: the structure in ``metrics()``,
    every kernel of its path launched and (with ``audit``) a clean audit;
    its line."""
    m = c.metrics()
    require(m["dedup"] == dedup, f"{what}: metrics dedup {m['dedup']}")
    require(all(launches[k] > 0 for k in PATH_KERNELS[dedup]), f"{what}: kernel launches {launches}")
    gen = c.state_count()
    return {
        "generated": gen, "unique": c.unique_state_count(), "max_depth": c.max_depth(),
        "wall_s": wall, "states_per_s": gen / wall, "levels": len(c.level_log),
        "dispatches": m["dispatches"], "graph_captures": m["graph_captures"],
        "capture_s": m["graph_capture_s"], "cand_ladder_k": m["cand_ladder_k"],
        "table_capacity": m["table_capacity"], "table_grows": m["table_grows"],
        "delta_flushes": m["delta_flushes"], "launches": launches,
        **({"audit": audited(c, what)} if audit else {}),
    }


def _lanes_of(keys: torch.Tensor, gen, active=None):
    """Batch lanes on the card for int64 ``(hi << 32) | lo`` keys, with
    random values: ``[hi, lo, val_hi, val_lo, active]`` (all active unless
    given)."""
    vals = torch.randint(0, 2**32, (2, keys.shape[0]), dtype=DTYPE, device="cuda", generator=gen)
    if active is None:
        active = torch.ones(keys.shape[0], dtype=torch.bool, device="cuda")
    return [(keys >> 32) & M32, keys & M32, vals[0], vals[1], active]


def _batch_lanes(gen, m: int, n_valid: int, hit: float, table_keys: torch.Tensor):
    """``m`` candidate lanes made on the card, ``n_valid`` of them active, in
    random order: a share ``hit`` of keys drawn from ``table_keys`` (int64
    ``(hi << 32) | lo``), the rest fresh keys with in-batch duplicates (each
    drawn about four times)."""
    n_hit = int(n_valid * hit) if table_keys.numel() else 0
    n_fresh = max(1, (n_valid - n_hit) // 4)
    fresh = torch.randint(1, 2**62, (n_fresh,), dtype=DTYPE, device="cuda", generator=gen)
    pick = lambda pool, n: pool[torch.randint(0, pool.numel(), (n,), device="cuda", generator=gen)]
    keys = torch.cat([pick(table_keys, n_hit) if n_hit else fresh[:0], pick(fresh, n_valid - n_hit),
                      torch.ones(m - n_valid, dtype=DTYPE, device="cuda")])
    order = torch.randperm(m, device="cuda", generator=gen)
    return _lanes_of(keys[order], gen, order < n_valid)


def _table_pairs(hs) -> torch.Tensor:
    """A hash set's ``[2, C]`` (key, value) words sorted by key, on the card:
    equal for two sets that hold the same pairs, wherever they lie."""
    key, order = torch.sort(hs.key)
    return torch.stack([key, hs.val[order]])


def _hash_copy(hs):
    return hashset.HashSet(hs.slots.clone())


def check_hash(name: str, hs, lanes, reps: int = 1, layout: bool = False) -> dict:
    """The kernel (``reps`` calls, each on a fresh copy of ``hs``) against
    the plain version on a copy of its own: ``is_new`` and ``overflow``
    equal bitwise, the stored (key, value) pairs equal as a set (and, with
    ``layout``, the slots bit for bit: the kernel's exact path runs the
    reference's rounds), every ticket back at rest and every pad word 0,
    and the record (``filled``) exactly the slots the batch filled, one a
    new key."""
    want = _hash_copy(hs)
    w_new, w_ovf, _ = hashset.insert_plain(want, *lanes)
    want_pairs = _table_pairs(want)
    was_empty = hs.key == 0
    err, exact = 0, set()
    for _ in range(reps):
        got = _hash_copy(hs)
        g_new, g_ovf, filled = hashset.insert_(got, *lanes)
        torch.cuda.synchronize()
        require(torch.equal(g_new, w_new), f"hash {name}: is_new")
        require(torch.equal(g_ovf, w_ovf), f"hash {name}: overflow")
        require(bool((got.ticket == hashset.NO_TICKET).all()), f"hash {name}: tickets at rest")
        require(bool((got.slots[:, 3] == 0).all()), f"hash {name}: pad words")
        n = int(filled[0])
        rec = torch.sort(filled[2:2 + n].to(DTYPE)).values
        require(n == int(g_new.sum()) and torch.equal(
            rec, (was_empty & (got.key != 0)).nonzero().squeeze(1)), f"hash {name}: the record")
        exact.add(int(filled[1]))
        if not bool(w_ovf.any()):
            err = max(err, int((_table_pairs(got) != want_pairs).sum()))
        if layout:
            require(torch.equal(got.slots, want.slots), f"hash {name}: slots")
        require(err == 0, f"hash {name}: stored pairs differ")
        del got, filled
    require(len(exact) == 1, f"hash {name}: the exact path ran in some calls only")
    return {"C": hs.capacity, "m": lanes[0].shape[0], "active": int(lanes[4].sum()),
            "new": int(w_new.sum()), "overflowed": int(w_ovf.sum()), "reps": reps,
            "layout_equal": layout, "exact_path": bool(exact.pop()), "max_abs_err": err}


def _sectors(lanes, idx) -> int:
    """32-byte sectors that hold a word of ``lanes`` at the indices ``idx``."""
    if not idx.numel():
        return 0
    addrs = [lane.data_ptr() + idx * (lane.stride(0) * 8) for lane in lanes]
    return torch.unique(torch.cat(addrs) // 32).numel()


def hash_bounds(lanes, is_new) -> dict:
    """An insert's least device time. ``bound_ms``, in bytes: ``active`` read
    and ``is_new`` and ``overflow`` written for every lane; an active lane's
    two key words and one 32-byte sector of the table; a new key's two value
    words read and its key and value written. An inactive lane reads
    nothing more, and only a winner reads its value. ``sector_floor_ms``,
    a 32-byte sector for each random access: the sectors of the key lanes
    that hold an active lane's word, a table sector read an active lane,
    the sectors of the value lanes that hold a winner's word, and a new
    key's slot written (key and value in one sector)."""
    m = lanes[0].shape[0]
    active, n_new = lanes[4].nonzero().squeeze(1), int(is_new.sum())
    floor = (m * 3 + 32 * _sectors(lanes[:2], active) + 32 * active.numel()
             + 32 * _sectors(lanes[2:4], is_new.nonzero().squeeze(1)) + 32 * n_new)
    return {"bound_ms": bound_ms(m * 3 + active.numel() * (16 + 32) + n_new * (16 + 16)),
            "sector_floor_ms": bound_ms(floor), "bound_by": "bytes"}


def undo_bounds(n_new: int) -> dict:
    """The undo's least device time: the record's slots read and each
    winner's key and value cleared (``bound_ms``); at the sector's grain,
    the record read and one 32-byte sector written a winner."""
    return {"bound_ms": bound_ms(8 + 4 * n_new + 16 * n_new),
            "sector_floor_ms": bound_ms(8 + 4 * n_new + 32 * n_new), "bound_by": "bytes"}


def hash_timing(t, lanes, max_probes: int = 32, plain: bool = False) -> dict:
    """The insert of ``lanes`` into ``t`` and the undo of such an insert,
    device time alone (every timed insert into a fresh copy of ``t``, every
    timed undo dropping one), with their bounds; each one's device
    operations a call (profiled over insert-and-undo steps that leave the
    copy as it found it) and, with ``plain``, the plain versions' ms.
    ``gather_ms`` times ``t.key[home]`` at every active lane's home slot:
    the random reads alone, one a lane, as the card serves them."""
    copies = iter([_hash_copy(t) for _ in range(7)])
    insert_ms = timed_ms(lambda: hashset.insert_(next(copies), *lanes, max_probes), reps=5, queued=True)
    del copies
    done = iter([(c, *hashset.insert_(c, *lanes, max_probes)) for c in (_hash_copy(t) for _ in range(3))])
    drop = torch.zeros((), dtype=torch.bool, device="cuda")

    def undo_next():
        c, _, _, filled = next(done)
        hashset.undo_(c, filled, drop)

    undo_ms = timed_ms(undo_next, reps=1, queued=True)
    del done
    # The library call: the plain undo's own index_copy_ of the rest slot,
    # the record's count read on the host first.
    c = _hash_copy(t)
    is_new, _, filled = hashset.insert_(c, *lanes, max_probes)
    at = filled[2:2 + int(filled[0])].to(DTYPE)
    rest = torch.tensor(hashset.EMPTY_SLOT, dtype=DTYPE, device="cuda").expand(at.shape[0], 4)
    library_ms = timed_ms(lambda: c.slots.index_copy_(0, at, rest), reps=5, queued=True)
    require(torch.equal(c.slots, t.slots), "hash: index_copy_ of the rest slot is not the undo")
    del at, rest, filled

    def step():
        hashset.undo_(c, hashset.insert_(c, *lanes, max_probes)[2], drop)

    ops = device_ops(step, HASH_SYMBOL)
    require(torch.equal(c.slots, t.slots), "hash: insert and undo left the table other than it was")
    del c
    undo_ops = {k: v for k, v in ops.items() if "undo_kernel" in k}
    insert_ops = {k: v for k, v in ops.items() if k not in undo_ops}
    per_call = lambda o: sum(op["per_call"] for op in o.values()) if o else "not measured"
    n_new = int(is_new.sum())
    # The card's own floor for the claim pass's random reads: the table's
    # key word gathered at every active lane's home slot.
    homes = hashset.home_slot(lanes[0], lanes[1], t.capacity)[lanes[4]]
    gather_ms = timed_ms(lambda: t.key[homes], reps=5, queued=True)
    del homes
    out = {
        "insert": {"ms": insert_ms, **hash_bounds(lanes, is_new), "gather_ms": gather_ms,
                   "gather_reads_per_s": int(lanes[4].sum()) / gather_ms * 1e3,
                   "device_launches_per_call": per_call(insert_ops), "device_ops": insert_ops},
        "undo": {"ms": undo_ms, **undo_bounds(n_new), "dropped": n_new, "library_ms": library_ms,
                 "sector_writes_per_s": n_new / undo_ms * 1e3,
                 "library_call": "index_copy_ of the rest slot at the record's slots",
                 "device_launches_per_call": per_call(undo_ops), "device_ops": undo_ops},
    }
    if plain:
        plain_copies = iter([_hash_copy(t) for _ in range(3)])
        out["insert"]["plain_ms"] = timed_ms(
            lambda: hashset.insert_plain(next(plain_copies), *lanes, max_probes), reps=1)
        del plain_copies
        plain_done = iter([(c, *hashset.insert_(c, *lanes, max_probes))
                           for c in (_hash_copy(t) for _ in range(3))])

        def plain_undo_next():
            c, _, _, filled = next(plain_done)
            hashset.undo_plain(c, filled, drop)

        out["undo"]["plain_ms"] = timed_ms(plain_undo_next, reps=1)
        del plain_done
    gc.collect()
    torch.cuda.empty_cache()
    return out


def hash_kernel_phase(seed: int, m: int, n_valid: int):
    """``csrc/hashset.cu`` against its plain versions on the card: a batch
    of ``m`` lanes (rm=9's widest candidate buffer, ``n_valid`` of them
    active) into a 2^26-slot table an eighth full, 5 calls on fresh copies,
    each undone (``undo_``, a level not committed) back to the table bit for
    bit; then adversarial batches: every row one key; 100 distinct keys on
    one home slot, more than ``max_probes`` (the kernel's exact path, slots
    bit for bit); 4,096 keys on distinct slots that share one claim-buffer
    index (the reference's rounds elect one a round); a batch whose keys are
    all present; one row; no active row. Times the seeded case's insert and
    its undo (:func:`hash_timing`). Returns the lines of both."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    base = hashset.make(HASH_TABLE, "cuda")
    n0 = HASH_TABLE // 8
    base_keys = torch.randint(1, 2**62, (n0,), dtype=DTYPE, device="cuda", generator=gen)
    _, ovf, _ = hashset.insert_(base, *_lanes_of(base_keys, gen))
    require(not bool(ovf.any()), "hash: the base table overflowed")
    lanes = _batch_lanes(gen, m, n_valid, 0.4, base_keys)
    cases = {"rm9_widest": check_hash("rm9_widest", base, lanes, reps=5)}
    small = hashset.make(1 << 12, "cuda")
    k = torch.arange(4096, dtype=DTYPE, device="cuda")
    adversarial = {  # lo = 0: a key's home slot is hi mod C
        "one_key": (base, torch.full((1 << 20,), 0x123456789, dtype=DTYPE, device="cuda"), False),
        "one_home_slot": (small, ((k[:100] << 12) | 5) << 32, True),
        "claim_index": (base, (k * 8192 + 5) << 32, False),
        "all_present": (base, base_keys[: 1 << 20], False),
        "one_row": (base, torch.full((1,), 0x2468ACE, dtype=DTYPE, device="cuda"), False),
    }
    for name, (table, keys, layout) in adversarial.items():
        cases[name] = check_hash(name, table, _lanes_of(keys, gen), layout=layout)
    none = lanes[:4] + [torch.zeros(m, dtype=torch.bool, device="cuda")]
    cases["no_active_row"] = check_hash("no_active_row", base, none)
    require(cases["one_home_slot"]["overflowed"] == 100 - 32, "hash: one home slot past the budget")
    require(cases["claim_index"]["new"] == 4096 and cases["one_key"]["new"] == 1
            and cases["all_present"]["new"] == 0, f"hash: adversarial counts {cases}")
    require(cases["one_home_slot"]["exact_path"]
            and not any(c["exact_path"] for n, c in cases.items() if n != "one_home_slot"),
            f"hash: the exact path ran other than on one home slot {cases}")
    # Each insert undone (a level not committed) leaves the table as the
    # base, as the plain undo does; a kept one is untouched.
    drop = torch.zeros((), dtype=torch.bool, device="cuda")
    undo_err = 0
    for _ in range(2):
        c = _hash_copy(base)
        _, _, filled = hashset.insert_(c, *lanes)
        kept = c.slots.clone()
        hashset.undo_(c, filled, ~drop)
        undo_err += int((c.slots != kept).sum())
        want = _hash_copy(c)
        hashset.undo_plain(want, filled, drop)
        hashset.undo_(c, filled, drop)
        undo_err += int((c.slots != want.slots).sum()) + int((c.slots != base.slots).sum())
        del c, want, kept, filled
    require(undo_err == 0, "hash: an undo left the table other than the base")
    timing = hash_timing(base, lanes, plain=True)
    n_new = cases["rm9_widest"]["new"]
    insert_line = {
        **timing["insert"], "library_ms": None,
        "library_call": "none: no single PyTorch call inserts into a hash table",
        "C": HASH_TABLE, "m": m, "active": n_valid, "new": n_new,
        "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
    }
    undo_line = {**timing["undo"], "C": HASH_TABLE, "m": m, "max_abs_err": undo_err}
    emit({"phase": "hashset_kernel", "cases": cases, **insert_line, "undo": undo_line})
    del base, small, lanes
    gc.collect()
    torch.cuda.empty_cache()
    return insert_line, undo_line


def level_batch(model, dedup: str, c):
    """The visited-set insert of ``c``'s widest level (by generated states)
    as the engine makes it: ``model`` (the instance that ran ``c``, so no
    graph is captured) searched again under ``dedup`` to that level's depth
    and the level run once eagerly, the insert's arguments kept: the table
    before the level and the lanes ``[hi, lo, val_hi, val_lo, active]``,
    as wide as the level's candidate buffer.
    Checks that the batch is that level's (its active lanes and new keys
    are the level's generated and unique counts). Returns the table, the
    lanes, ``is_new`` and the level's ``level_log`` row."""
    widest = max(c.level_log, key=lambda r: r["generated"])
    run = run_to_depth(model, widest["depth"], dedup=dedup)
    # One level more, at the bucket and candidate cap the level ran at.
    run._target_max_depth = None
    run._run_cap_for = lambda n: widest["bucket"]
    run._cand_caps[widest["bucket"]] = widest["cand_cap"]
    kept, insert = [], run._insert

    def spy(table, *lanes, in_place=False):
        out = insert(table, *lanes, in_place=in_place)
        kept[:] = [table, list(lanes), out[1]]
        return out

    run._insert = spy
    run._run_block_single()
    table, lanes, is_new = kept
    require(int(lanes[4].sum()) == widest["generated"] and int(is_new.sum()) == widest["unique"]
            and run.level_log[-1]["depth"] == widest["depth"], f"{dedup}: the widest level's batch")
    return table, lanes, is_new, widest


def batch_mix(lanes, is_new) -> dict:
    """A batch's lanes by kind: active, new keys (one winner each), hits (a
    key already in the table) and in-batch duplicates of a new key."""
    keys = (lanes[0] << 32) | lanes[1]
    active = keys[lanes[4]]
    of_new = int(torch.isin(active, keys[is_new]).sum())
    n_new = int(is_new.sum())
    return {"m": keys.shape[0], "active": active.shape[0], "new": n_new,
            "hits": active.shape[0] - of_new, "duplicates": of_new - n_new}


def table_step_ms(model, dedup: str, c) -> dict:
    """The visited-set step of ``c``'s widest level, device time alone, on
    that level's own batch and table (:func:`level_batch`): the sorted and
    delta sets' insert and the gate's copy of the planes it made anew, the
    hash set's insert in place and its undo. Each call leaves the table as
    it found it (a closed gate). Under hash, also the insert and the undo
    alone with their bounds and device operations a call
    (:func:`hash_timing`), and the kernel against its plain version on that
    batch."""
    t, lanes, is_new, widest = level_batch(model, dedup, c)
    keep = torch.zeros((), dtype=torch.bool, device="cuda")
    extra = {}
    if dedup == "hash":
        def step():
            hashset.undo_(t, hashset.insert_(t, *lanes, c._max_probes)[2], keep)

        # The insert and the undo alone, with their bounds and operations.
        extra = {"kernel": check_hash("widest_level", t, lanes),
                 **hash_timing(t, lanes, c._max_probes)}
    else:
        def step():
            nt, _, _ = c._ds.insert(t, *lanes)
            for new, old in zip(nt, t):
                if new is not old:
                    old.copy_(torch.where(keep, new, old))
    before = [p.clone() for p in t]
    ms = timed_ms(step, reps=10, queued=True)
    require(all(torch.equal(a, b) for a, b in zip(t, before)), f"{dedup}: a closed gate moved the table")
    del before
    rows = getattr(t, "delta_capacity", t.capacity)
    line = {"ms": ms, "depth": widest["depth"], "batch": batch_mix(lanes, is_new),
            "table_rows": rows, "capacity": getattr(t, "main_capacity", t.capacity), **extra}
    del t, lanes, is_new
    gc.collect()
    torch.cuda.empty_cache()
    return line


def soak_phase():
    """2pc rm=9 under the sorted, hash and delta sets, each cold and then
    warm on one model instance (the warm run capturing nothing): the three
    agree in counts, depth and every level, each audit is clean and both
    discoveries are re-executed; peak memory, each structure's table step
    on its widest level's own batch (:func:`table_step_ms`), the flush at
    the delta set's final table with its device time by operation. Returns
    the runs' launches, the delta run's shapes and the widest candidate
    buffer."""
    out, launches, ref = {}, {}, None
    for dedup in ("sorted", "hash", "delta"):
        gc.collect()
        torch.cuda.empty_cache()
        model = PackedTwoPhaseSys(SOAK_RM)
        torch.cuda.reset_peak_memory_stats()
        PROGRAM_USE.segment = f"soak_{dedup}_cold"
        cold, cold_wall, launches[f"dedup_{dedup}_rm9"] = drive(model, dedup=dedup)
        cold_peak = torch.cuda.max_memory_allocated() / 2**30
        PROGRAM_USE.segment = f"soak_{dedup}_warm"
        warm, warm_wall, warm_launches = drive(model, dedup=dedup)
        PROGRAM_USE.segment = "other"
        # The warm run's table is audited; the cold run's must match it
        # level by level.
        line = {"cold": dedup_line(cold, cold_wall, launches[f"dedup_{dedup}_rm9"], dedup,
                                   f"rm=9 {dedup} cold", audit=False),
                "warm": dedup_line(warm, warm_wall, warm_launches, dedup, f"rm=9 {dedup} warm")}
        require(line["warm"]["graph_captures"] == 0, f"rm=9 {dedup}: the warm run captured graphs")
        now = ((cold.state_count(), cold.unique_state_count(), cold.max_depth()),
               [r[:4] for r in levels(cold)])
        require(now[1] == [r[:4] for r in levels(warm)], f"rm=9 {dedup}: warm vs cold levels")
        ref = ref or now
        require(now == ref, f"rm=9 {dedup}: counts or levels differ from the sorted run's")
        check_paths(warm)
        line["peak_mem_gib"] = cold_peak
        line["reserved_gib"] = torch.cuda.memory_reserved() / 2**30
        line["widest_level"] = dict(max(warm.level_log, key=lambda r: r["frontier"]))
        line["table_step"] = table_step_ms(model, dedup, warm)
        if dedup == "delta":
            t = warm._table
            line["flush"] = {"ms": timed_ms(lambda: deltaset.maintain(t), reps=5, queued=True),
                             **ops_split(device_ops(lambda: deltaset.maintain(t), MERGE_SYMBOL),
                                         MERGE_SYMBOL),
                             "main_capacity": t.main_capacity, "delta_capacity": t.delta_capacity,
                             "n_main": int(t.n_main), "n_delta": int(t.n_delta)}
            shapes = {
                "levels": [dict(r) for r in warm.level_log], "A": model.max_actions,
                "W": model.state_words, "table_capacity": t.delta_capacity,
                "unique": 3 * t.delta_capacity // 4, "main_capacity": t.main_capacity,
                "n_main": int(t.n_main) + int(t.n_delta),
            }
        out[dedup] = line
        widest_cands = max(r["cand_cap"] for r in warm.level_log)
        widest_gen = max(r["generated"] for r in warm.level_log)
        actions = model.max_actions
        del model, cold, warm
    out["generated"], out["unique"], out["max_depth"] = ref[0]
    out["level_log"] = ref[1]
    out["rm10_extrapolation"] = rm10_extrapolation(out["sorted"], ref[0][0], actions)
    emit({"phase": "soak_rm9", **out})
    return launches, shapes, widest_cands, widest_gen


def rm10_extrapolation(line: dict, generated: int, actions: int) -> dict:
    """rm=10's widest level from rm=9's sorted run: the widest frontier
    grown by rm=9's own growth over rm=8 (generated states), in the power
    of two of rows the frontier ceiling doubles to, at five more action
    slots; its peak memory the rm=9 peak scaled by rows times actions."""
    growth = generated / EXPECTED_2PC[8][0]
    frontier = line["widest_level"]["frontier"] * growth
    bucket = 1 << max(int(frontier) - 1, 1).bit_length()
    rm9_bucket = line["widest_level"]["bucket"]
    return {"growth": growth, "widest_frontier": frontier, "bucket": bucket,
            "peak_gib": line["peak_mem_gib"] * bucket / rm9_bucket * (actions + 5) / actions}


def flush_merge_phase(rng, shapes) -> dict:
    """``merge_insert`` at the delta set's flush: the rm=9 run's main tier
    (its rows) as the table and a full delta tier of fresh unique keys as
    the batch, against the plain version 5 times, and timed."""
    c, n_main, dc = shapes["main_capacity"], shapes["n_main"], shapes["table_capacity"]
    keys = np.unique(rng.integers(1, 2**62, n_main + dc + dc // 8, dtype=np.uint64))
    rng.shuffle(keys)
    keys = keys[: n_main + dc]
    n_main = min(n_main, c - dc)
    table, batch = _planes(rng, np.sort(keys[:n_main]), c), _planes(rng, np.sort(keys[n_main:]), dc)
    check = check_merge("delta_flush", table, batch, reps=5)
    timing = kernel_timing(
        lambda: merge_insert(table, batch), lambda: merge_insert_plain(table, batch), None,
        (2 * c + 2 * dc) * 8 + 6 * min(check["n_keep"], c) * 8 + dc + 8, MERGE_SYMBOL,
    )
    timing.pop("device_ops")
    del table, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {**check, **timing}


def dedup_phase(main_model, main_warm, rng):
    """The hash and delta visited sets through ``Packed<Model>(...).checker()
    .spawn_xla(dedup=...)`` on the card: rm=8 under each, cold and then warm
    on one model instance (exact, the warm run capturing nothing, equal in
    depth and every level to the sorted main path), each structure's table
    step on its widest level's own batch beside the sorted set's
    (:func:`table_step_ms`), and a profiled warm
    run of each; the soak configuration (:func:`soak_phase`); one rm=5
    instance through sorted, hash, delta and sorted runs (the program key
    holds the structure: the fourth captures nothing); Paxos 2c/3s and ABD
    2c/2s under hash and delta and rm=8 reduced under delta at their pins;
    the hash kernel against its plain version (:func:`hash_kernel_phase`);
    both kernels at the delta set's shapes; rm=8 saved mid-run on the card
    under each of hash and delta and resumed on the CPU under the other.
    Returns the launches of each path, the hash kernel's lines (insert and
    undo) and ``merge_insert``'s at the delta set's shapes."""
    launches, out = {}, {}
    sorted_levels = [r[:4] for r in levels(main_warm)]
    steps = {"sorted": table_step_ms(main_model, "sorted", main_warm)}
    profiles = {}
    for dedup in ("hash", "delta"):
        model = PackedTwoPhaseSys(8)
        torch.cuda.reset_peak_memory_stats()
        PROGRAM_USE.segment = f"{dedup}8_cold"
        cold, cold_wall, launches[f"dedup_{dedup}_rm8"] = drive(model, dedup=dedup)
        PROGRAM_USE.segment = f"{dedup}8_warm"
        warm, warm_wall, warm_launches = drive(model, dedup=dedup)
        PROGRAM_USE.segment = "other"
        peak = torch.cuda.max_memory_allocated() / 2**30
        line = {"cold": {**dedup_line(cold, cold_wall, launches[f"dedup_{dedup}_rm8"], dedup,
                                      f"rm=8 {dedup}", audit=False),
                         **check_rm8(cold, launches[f"dedup_{dedup}_rm8"], f"{dedup} cold")},
                "warm": {**dedup_line(warm, warm_wall, warm_launches, dedup, f"rm=8 {dedup} warm",
                                      audit=False),
                         **check_rm8(warm, warm_launches, f"{dedup} warm")}}
        require(line["warm"]["graph_captures"] == 0, f"rm=8 {dedup}: the warm run captured graphs")
        for c, what in ((cold, "cold"), (warm, "warm")):
            require([r[:4] for r in levels(c)] == sorted_levels and c.max_depth() == main_warm.max_depth(),
                    f"rm=8 {dedup} {what}: levels differ from the sorted run's")
        line["peak_mem_gib"] = peak
        line["program_use"] = PROGRAM_USE.summary(f"{dedup}8_cold", [f"{dedup}8_warm"])
        steps[dedup] = table_step_ms(model, dedup, warm)
        out[f"rm8_{dedup}"] = line
        profiles[dedup] = model
        del cold, warm
    profiles["sorted"] = main_model
    for dedup, model in profiles.items():
        c, wall, kernels = profiled(lambda: model.checker().spawn_xla(dedup=dedup).join())
        require(c.metrics()["graph_captures"] == 0, f"rm=8 {dedup}: the profiled run captured graphs")
        busy = sum(ms for _, ms, _ in kernels)
        table_kernels = {k[:40]: ms for k, ms, _ in kernels
                         if any(s in k for s in (MERGE_SYMBOL, HASH_SYMBOL, "commit_kernel",
                                                 "exact_kernel", "undo_kernel"))}
        out[f"rm8_{dedup}_profile"] = {
            "profiled_wall_s": wall, "levels": len(c.level_log),
            "device_busy_ms": busy if kernels else "not measured",
            "device_ms_per_level": busy / len(c.level_log) if kernels else "not measured",
            "device_idle_share": 1 - busy / (wall * 1e3) if kernels else "not measured",
            "table_kernels_ms": table_kernels,
        }
    out["rm8_table_step"] = steps
    del profiles
    soak_launches, delta_shapes, m_soak, gen_soak = soak_phase()
    launches.update(soak_launches)

    model = PackedTwoPhaseSys(5)
    runs = []
    for dedup in ("sorted", "hash", "delta", "sorted"):
        c, wall, n = drive(model, dedup=dedup)
        require((c.state_count(), c.unique_state_count()) == EXPECTED_2PC[5], f"rm=5 program key: {dedup}")
        runs.append({"dedup": dedup, **dedup_line(c, wall, n, dedup, f"rm=5 {dedup}")})
        launches[f"dedup_rm5_{len(runs)}_{dedup}"] = n
    require(runs[3]["graph_captures"] == 0, f"rm=5 program key: the fourth run captured {runs[3]}")
    out["rm5_program_key"] = runs

    small = {}
    for dedup in ("hash", "delta"):
        for name, build, want in (("paxos2", lambda: PackedPaxos(2, 3), EXPECTED_PAXOS2),
                                  ("abd2", lambda: PackedAbd(2, 2), EXPECTED_ABD[("unordered", 2)][:2])):
            c, wall, n = drive(build(), dedup=dedup)
            require((c.state_count(), c.unique_state_count()) == want, f"{name} {dedup} counts")
            check_paths(c)
            small[f"{name}_{dedup}"] = dedup_line(c, wall, n, dedup, f"{name} {dedup}")
            launches[f"dedup_{name}_{dedup}"] = n
    c, wall, n = drive(PackedTwoPhaseSys(8), sym=True, dedup="delta")
    small["sym_rm8_delta"] = {**dedup_line(c, wall, n, "delta", "sym rm=8 delta", audit=False),
                              **sym_line(c, "sym rm=8 delta", n, wall)}
    launches["dedup_sym_rm8_delta"] = n
    out["models"] = small

    hash_lines = hash_kernel_phase(2026, m_soak, gen_soak)
    merge_lines = {"level": model_kernel_phase(delta_shapes, rng, tag="delta9"),
                   "flush": flush_merge_phase(rng, delta_shapes)}

    # rm=8 saved on the card under one structure, resumed on the CPU under the other.
    left, acc = 0, 0
    for r in main_warm.level_log:
        acc += r["generated"]
        if acc >= (1 - CPU_TAIL_SHARE) * main_warm.state_count():
            left = r["depth"] + 1
            break
    ckpt = {}
    for saver, reader in (("hash", "delta"), ("delta", "hash")):
        path = os.path.join(CKPT_DIR, f"rm8_{saver}.npz")
        torch.cuda.synchronize()
        zero_launches()
        run_to_depth(PackedTwoPhaseSys(8), left, dedup=saver).save_checkpoint(path)
        torch.cuda.synchronize()
        launches[f"dedup_checkpoint_{saver}"] = launches_now(saver)
        t0 = time.perf_counter()
        cpu = PackedTwoPhaseSys(8).checker().spawn_xla(device="cpu", dedup=reader, checkpoint=path).join()
        cpu_s = time.perf_counter() - t0
        require((cpu.state_count(), cpu.unique_state_count(), cpu.max_depth())
                == (*EXPECTED_2PC[8], main_warm.max_depth()), f"rm=8 {saver} card -> {reader} CPU counts")
        require(tail_levels(cpu, left) == tail_levels(main_warm, left), f"rm=8 {saver} -> {reader} levels")
        check_paths(cpu)
        ckpt[f"{saver}_card_to_{reader}_cpu"] = {
            "save_depth": left, "rows": len(load_checkpoint(path)["key_hi"]), "cpu_wall_s": cpu_s,
            "launches": launches[f"dedup_checkpoint_{saver}"], "audit": audited(cpu, f"{reader} CPU"),
        }
    out["checkpoint"] = ckpt
    emit({"phase": "dedup", **out, "launches": launches})
    return launches, hash_lines, merge_lines


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    global PROGRAM_USE, CKPT_DIR
    PROGRAM_USE = ProgramUse()
    CKPT_DIR = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return run_phases()
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)


def run_phases() -> int:
    device_phase()
    small_phase()
    model, checker, launches, ladder = main_path_phase()
    new_paths = {
        "checkpoint_rm8": checkpoint_rm8_phase(model, checker),
        "autockpt_rm8": autockpt_rm8_phase(model),
    }
    repeat_and_profile_phase(model)
    host_split_phase()
    lookahead_sweep_phase(model)
    rm8_ladder_phase(model, ladder)
    rm8_single_phase()
    graph_vs_eager_phase()
    paxos_small_phase()
    shapes, paxos_launches, paxos_ladder, paxos_ckpt = paxos3_phase()
    new_paths.update(paxos_ckpt)
    paxos3_one_rung_phase(paxos_ladder)
    paxos3_growth_phase((shapes["generated"], shapes["unique"]))
    scr_launches, hv_shapes = scr_phase()
    new_paths["cpu_card_checkpoint"] = cpu_card_checkpoint_phase()
    new_paths["visitor"] = visitor_phase()
    new_paths.update(increment_phase())
    abd_launches, abd_shapes = abd_phase()
    new_paths.update(abd_launches)
    new_paths.update(models_phase())
    sym_launches, sym_shapes = symmetry_phase(np.random.default_rng(2024))
    new_paths.update(sym_launches)
    dedup_launches, hk, dk = dedup_phase(model, checker, np.random.default_rng(2025))
    new_paths.update(dedup_launches)
    rng = np.random.default_rng(2024)
    b1 = compact_phase(checker, rng)
    m_main = max(r["cand_cap"] for r in checker.level_log)
    b2 = merge_phase(rng, checker.metrics()["table_capacity"], m_main)
    px = model_kernel_phase(shapes, rng)
    rk = rung_kernel_phase(checker, shapes, hv_shapes, rng)
    ak = model_kernel_phase(abd_shapes, rng, tag="abd3")
    sk = model_kernel_phase(sym_shapes, rng, tag="sym14")
    kernels = []
    for name, source, replaces, main in (
        ("compact", "compact.cu", "stateright_tpu/ops/pallas_compact.py:229", b1),
        ("merge_insert", "merge.cu", "stateright_tpu/ops/pallas_merge.py:347", b2),
    ):
        by_path = {"rm8": launches[name], "paxos3": paxos_launches[name],
                   **{f"scr_{k}": v[name] for k, v in scr_launches.items()},
                   **{k: v[name] for k, v in new_paths.items() if name in v}}
        new_shapes = rk[name]
        delta = {"compact": dk["level"]["compact"], "merge_insert": {
            "level": dk["level"]["merge_insert"], "flush": dk["flush"]}}[name]
        errs = [main, px[name], ak[name], sk[name], *new_shapes.values(), dk["level"][name]]
        if name == "merge_insert":
            errs.append(dk["flush"])
        kernels.append({
            "name": name, "route": "cuda", "source": f"stateright_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": sum(by_path.values()), "launches_by_path": by_path,
            "bound_by": "bytes", **main,
            "max_abs_err": max(e["max_abs_err"] for e in errs),
            "paxos3": px[name], "ladder_and_hv_shapes": new_shapes, "abd3": ak[name],
            "sym14": sk[name], "delta9": delta,
        })
    notes = {
        "hashset_insert": "insert, jitted JAX (a while_loop of scatter-min rounds); no pallas_call",
        "hashset_undo": "none: the reference's insert is functional, its gate selects a copy",
    }
    for name, line in zip(("hashset_insert", "hashset_undo"), hk):
        by_path = {k: v[name] for k, v in new_paths.items() if name in v}
        kernels.append({
            "name": name, "route": "cuda", "source": "stateright_tpu_torch/csrc/hashset.cu",
            "replaces": "stateright_tpu/ops/hashset.py:50", "replaces_note": notes[name],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **{k: v for k, v in line.items() if k != "device_ops"},
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
