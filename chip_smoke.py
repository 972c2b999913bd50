#!/usr/bin/env python3
"""The port's proof of life on an NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py`` on a machine
with one CUDA card and ``nvcc`` (it exits non-zero, printing no result,
where there is no card or no ``stateright_tpu_torch`` beside it). It

1. prints the card's name and power limit and builds every CUDA kernel of
   the port from ``stateright_tpu_torch/csrc`` (one ``nvcc`` per source, all
   started together) and, beside them, the native host kit
   (``stateright_tpu_torch/native/hostkit.cpp``, ``g++``), which must load:
   every parent map an engine builds for a witness path in this process is
   then the library's, or the script fails (:class:`NativeMaps`);
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
   dispatch logs and bitwise equal table planes; and times the warm run's
   witness reconstruction with the native parent map and with its Python
   fallback (:func:`witness_times`: host seconds of the read of the
   occupied rows, of each map's build and of each chain, and of the whole
   ``discoveries()``, every chain equal under both), as ``soak_rm9`` later
   does at rm=9 under each visited set (the ``native`` line);
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
   ROUND3.md's CPU probe, and a warm run under ``torch.profiler``; then,
   on the same model instance, a run to ``PAXOS3_DEPTH`` under the hash
   set (``paxos3_hash``): a second graph set at the widest bucket beside
   the sorted set's, exact, with the card's memory before and after;
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
   then ``PackedSingleCopyRegister(4, 1, device_exact=False)`` to depth 5
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
12. runs every model's ``check`` command line (``cli``) in a fresh
   process each, all four at once, the module's ``__main__`` as
   ``python -m`` runs it, with
   the kernels' launch counters printed at exit: ``two_phase_commit check
   8``, ``paxos check 2``, ``single_copy_register check 3`` and
   ``linearizable_register check 2 ordered``, each exiting 0 with its
   pinned ``Done.`` counts, its wall from process start printed; the
   checker service (``service``, right after ``cli``), whose pools run in
   processes of their own (``SERVICE_BOOT``) and must leave CUDA
   uninitialised there: ``2pc:8`` and ``paxos:2,3`` jobs exact through the
   admission check, a ``2pc:8`` job SIGKILLed at depth 14 and resumed from
   its rotation, a ``2pc:8`` job frozen mid-dispatch beside a running
   sibling (the wedge verdict within the leash, the victim resumed, the
   sibling untouched), four ``2pc:5`` jobs as one ``--mux`` worker, two
   wedges opening the breaker, a ``2pc:4`` job on the host (``degraded``),
   the default probe closing it and the next job on the card, a pool
   SIGKILLed mid-job and restarted over its run dir (the orphaned worker
   killed, the job finished once), and ``make_app(PackedTwoPhaseSys(8)
   .checker(), service=pool)`` in this process; each job's wall from
   submit, its worker's seconds to its first dispatch, captures, peak
   memory and launches printed, every discovery re-executed; the
   checker service's fleet (``fleet``, started once the service's items
   1-3 are done, beside its later items), two pools
   of this card behind one ``FleetService`` with ``pin_devices=True``, its
   processes leaving CUDA uninitialised: two ``2pc:8`` jobs through
   ``device.lost`` (the victim evacuated and resumed on the other pool
   from its own rotation, both exact, the sibling untouched, the lost
   pool's journal holding the evacuation and ``fleet.jsonl`` the route and
   then the migration; pool 1's worker recording the fallback of an
   ordinal the machine lacks), the device lost at the victim's first
   committed rotation; beside it a fleet SIGKILLed
   at a job's first committed rotation and restarted over its run dir
   (orphans killed, routes replayed, one completion a job), the chaos
   harness's ``device_lost`` and ``kill`` scenarios at ``--fleet 2`` (each
   after its baseline, ``ok``), and a ``2pc:4`` job flaky on pool 0 whose
   wedge opens only that pool's breaker and migrates it to pool 1 on the
   card, then the fleet's run dir bundled for a post-mortem
   (``tools/trace_bundle.py`` of the port) and the manifest's counts
   printed; and observability (``obs``): rm=8 cold on a fresh model instance, then warm
   with everything off, on (a span trace, a heartbeat, a metrics series
   every level, the phase split), off and on, each wall printed, the off
   runs holding ``NULL_TRACER`` and giving the on runs' logs; the trace,
   heartbeat and series held against ``dispatch_log``, the Chrome export
   and an OpenMetrics render of the final snapshot parsed back; once more
   under ``dedup="hash"``;
13. drives the Explorer (``explorer``): ``make_app(PackedTwoPhaseSys(8)
   .checker())``, the GPU backend, served on ``127.0.0.1`` over a
   ``ThreadingHTTPServer`` with ``serve``'s threads (``explorer.start``):
   the init states and a 12-click path through ``/.states``, each click's
   views and counts equal to the port's host Explorer on ``TwoPhaseSys(8)``
   (fingerprints too), each click's latency and (traced, under the sorted set) its eager
   levels' phase split; then ``POST /.runtocompletion`` polled to done:
   18,507,778 / 1,745,408, every discovery re-executed, a clean audit,
   ``/.metrics`` parsed back equal to ``metrics()``; under the sorted and
   the hash set; then the kernels against their plain versions at a
   click's shapes (``click_kernels``); and the multiplexed engine
   (``mux``): K = 1, 3 and 8 lanes of 2pc rm=4 under the sorted and the
   hash set, each lane equal to its solo run on the card (K = 8 in at most
   a third of 8 solo runs' dispatches), stragglers, K = 3 lanes of Paxos
   2c/3s and K = 2 lanes of rm=8 (exact, peak memory), and warm walls of a
   K = 8 run against 8 warm solo runs, in turns;
14. drives the sharded engine (``sharded``): ``PackedTwoPhaseSys(8)
   .checker().spawn_xla(mesh=default_mesh(D))``, D shards on this card,
   at D = 2, 4 and 8 under the sorted set, each equal to the single-chip
   engine level by level, every discovery re-executed, a clean audit,
   every key in its owner shard, cold and then warm (capturing nothing)
   on one model instance beside the single-chip engine's cold and warm
   runs there, with walls, captures, growths by kind and peak memory, and
   one more warm D = 8 run under ``torch.profiler`` (device time by kernel,
   idle share); ``default_mesh()``, one shard a card, on the single-chip
   engine; rm=8 at D = 8 under the hash set and at D = 4 under the delta set; rm=5
   at D = 8 equal to its CPU run bit for bit (every shard's planes); Paxos
   2c/3s at D = 4, the host-verified single-copy-register 2c/2s at D = 8
   and symmetric rm=8 at D = 8, each equal to the single-chip engine; an
   rm=8 checkpoint saved at D = 8 and resumed on the single-chip engine
   and at D = 4, and a single-chip file resumed at D = 8; and
   (``shard_kernels``) every kernel call of the widest sharded level held
   against its plain version, the widest shard's timed; then the mesh over
   several processes: two ranks of ``python -m
   stateright_tpu_torch.tools.mesh_worker`` on this card, over gloo since
   they share it (``mesh_ranks_rm8``: rm=8 at 2 ranks x 4 shards cold and
   warm, exact, equal on both ranks and every shard's planes equal to the
   D = 8 run's above, rank 0's mid-run file resumed exactly on the
   single-chip engine, rank 1 writing no file; each rank's walls, launches
   by kernel, peak memory and the exchange's seconds, legs and bytes, at
   the widest level and summed; ``mesh_ranks_rm5``: rm=5 at 2 x 2 shards
   under the hash set and under the delta set with flushes and a growth,
   each equal shard for shard to the one-process D = 4 run);
15. holds the reference's other compaction lowerings, the kernel's
   yardsticks (``compaction_ops``; the engine does not run them):
   ``compact_gather``, ``compact_sort`` and ``compact_bsearch`` against
   the kernel and its plain version, exactly, at the rm=8 grid and
   frontier, the Paxos 3c/3s grid and frontier and the ABD 3c/2s frontier,
   each timed beside the kernel (with the kernel table's bound and each
   call's peak memory);
16. runs the port's static analysis (``lint``): ``python -m
   stateright_tpu_torch.analysis --json --no-cache``, the whole sweep, and
   ``--admission 2pc:8``, the checker service's flight-check of the main
   path's spec, each in a subprocess of its own started right after the
   build and read after the main path (the lint uses the CPU and ``nvcc``,
   never the card); both must be ``ok`` with no ``cuda:`` surface skipped.
   It emits each kernel's registers, shared memory, spill bytes and
   occupancy as ``ptxas`` reported them, the lint's seconds, and the
   census's ``cuda`` plan for 2pc rm=8 at every frontier ceiling the main
   path's cold run passed through held against the graphs that run
   captured, each shape once (a table growth's remakes left out): every
   captured ``(run_cap, rows, cand_cap)`` is the census's, or a rung the
   planner gives once the run's candidate caps grew (a cap each grown
   bucket passed through, ``census.grown_captures``);
17. prints the ``{"kernels": [...]}`` line (launches summed over every
   main-path run: rm=8, Paxos 3c/3s, single-copy-register, the
   host-verified runs and the paths of items 9 to 15, the service's and
   the fleet's from their workers' ``--out`` files, each also by path),
   the count of parent maps the engines built (``native_maps``) and, last,
   the device line.

Every line but the nvidia-smi one is a JSON object. Any failed check
raises, so the script exits non-zero.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import glob
import json
import multiprocessing
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

from stateright_tpu_torch import PathRecorder, graphs, native, obs
from stateright_tpu_torch.analysis.census import captures_of, grown_captures, plan_for
from stateright_tpu_torch.audit import audit_table
from stateright_tpu_torch.checker import explorer
from stateright_tpu_torch.checker.explorer import make_app
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
from stateright_tpu_torch.core import Expectation, Property
from stateright_tpu_torch.models.two_phase_commit import PackedTwoPhaseSys, TwoPhaseSys
from stateright_tpu_torch.obs import heartbeat, promexport
from stateright_tpu_torch.ops import _cuda, deltaset, hashset, sortedset
from stateright_tpu_torch.ops.compact import LOWERINGS, compact, compact_plain
from stateright_tpu_torch.ops.merge import merge_insert, merge_insert_plain
from stateright_tpu_torch.ops.words import DTYPE, PAD_KEY, fold_key, from_u32, to_u32
from stateright_tpu_torch.parallel import default_mesh, owner_bits
from stateright_tpu_torch.parallel import sharded as sharded_mod
from stateright_tpu_torch.sym import canonicalize_host, compile_canon
from stateright_tpu_torch.xla import CAND_HINTS, DEFAULT_FRONTIER_CAPACITY, XlaChecker
from stateright_tpu_torch.xla_mux import MuxChecker
from stateright_tpu_torch.service import CheckerService, ServiceConfig
from stateright_tpu_torch.service.registry import resolve as resolve_spec
from stateright_tpu_torch.tools import mesh_worker, trace_bundle

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
#: The parent-map check (:class:`NativeMaps`), installed by ``main``.
NATIVE_MAPS = None
#: The ``native`` phase's witness timings, by run (:func:`witness_times`).
WITNESS = {}
#: ``nvidia-smi``'s name and power limit of the card (``device_phase``).
SMI = None
#: The kernels' names as the profiler lists them (``csrc/compact.cuh``,
#: ``csrc/merge.cu``).
COMPACT_SYMBOL = "compact_kernel"
MERGE_SYMBOL = "merge_kernel"


#: The script's start on the host clock: each phase line carries its
#: seconds since (``t_s``).
T0 = time.perf_counter()


#: One line at a time on stdout: the fleet phase emits from a thread.
EMIT_LOCK = threading.Lock()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
    with EMIT_LOCK:
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
    global SMI
    SMI = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(SMI, flush=True)
    emit({
        "phase": "device", "nvidia_smi": SMI,
        "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
    })
    # The kernels' nvcc and the host kit's g++, started together.
    with ThreadPoolExecutor(1) as ex:
        host_kit = ex.submit(native.build)
        seconds = _cuda.build()
        native_seconds = host_kit.result()
    require(native.available(), "the native host kit did not load")
    emit({"phase": "build", "seconds": seconds, "sources": list(_cuda.SOURCES),
          "native_seconds": native_seconds, "native_library": str(native.library_path())})


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
    del cold, warm, single, probe, prof
    ckpt_launches["paxos3_hash"] = paxos3_second_set_phase(model, shapes)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return shapes, cold_launches, ladder, ckpt_launches


def paxos3_second_set_phase(model, shapes) -> dict:
    """A second graph set on one model instance at Paxos 3c/3s's widest
    bucket (ROADMAP C2): ``model``, which ran cold, warm, to depth 16,
    profiled and checkpointed under the sorted set, run to ``PAXOS3_DEPTH``
    under ``dedup="hash"``: exact, equal level by level to the sorted runs,
    the witness re-executed; the card's allocated, reserved and peak memory
    before and after. Returns the run's launches."""
    gc.collect()
    torch.cuda.synchronize()
    before = {"allocated_gib": torch.cuda.memory_allocated() / 2**30,
              "reserved_gib": torch.cuda.memory_reserved() / 2**30}
    torch.cuda.reset_peak_memory_stats()
    PROGRAM_USE.segment = "paxos3_hash"
    c, wall, launches = drive(model, depth=PAXOS3_DEPTH, dedup="hash")
    PROGRAM_USE.segment = "other"
    counts = (c.state_count(), c.unique_state_count())
    require(counts == PAXOS3_DEPTH15, f"paxos 3c/3s under hash on the sorted run's instance: {counts}")
    require([list(r[:4]) for r in levels(c)] == [[r[k] for k in LEVEL_KEYS[:4]] for r in shapes["levels"]],
            "paxos 3c/3s under hash: levels differ from the sorted run's")
    require(all(n > 0 for n in launches.values()), f"paxos 3c/3s under hash: launches {launches}")
    check_paths(c)
    m = c.metrics()
    emit({"phase": "paxos3_hash", "generated": counts[0], "unique": counts[1],
          "max_depth": c.max_depth(), "wall_s": wall, "launches": launches,
          "graph_captures": m["graph_captures"], "capture_s": m["graph_capture_s"],
          "table_capacity": m["table_capacity"], "table_grows": m["table_grows"],
          "widest_bucket": max(r["bucket"] for r in c.level_log),
          "memory": {"before": before, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "reserved_after_gib": torch.cuda.memory_reserved() / 2**30},
          "programs": len(graphs.cache_for(model, torch.device("cuda")).programs),
          "audit": audited(c, "paxos 3c/3s hash"), "nvidia_smi": SMI})
    return launches


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
          "dispatch_log": c.dispatch_log, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
          "reserved_gib": torch.cuda.memory_reserved() / 2**30})
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


def merge_bytes(table, batch, n_keep: int) -> int:
    """Bytes a merge-insert must move under its contract (rows of
    ``merged`` from ``n_keep`` on are unspecified): the keys of the table's
    occupied rows and of the batch's valid rows read once, a binary search
    of each to find where its pads start (a 16-byte key a step), the kept
    rows' values read and their four words written once, a keep flag for
    every batch row and n_keep written. Pad rows are not read."""
    c, m = table.shape[1], batch.shape[1]
    n_table, m_valid = (int((fold_key(t[0], t[1]) != PAD_KEY).sum()) for t in (table, batch))
    search = (c.bit_length() + m.bit_length()) * 16
    return (2 * n_table + 2 * m_valid) * 8 + search + 6 * min(n_keep, c) * 8 + m + 8


def merge_timing(table, batch, n_keep: int) -> dict:
    """:func:`kernel_timing` of ``merge_insert`` on ``(table, batch)``,
    bound by :func:`merge_bytes`; beside it ``capacity_bound_ms``, the
    bound over the key of every table and batch row, pads included."""
    c, m = table.shape[1], batch.shape[1]
    timing = kernel_timing(
        lambda: merge_insert(table, batch), lambda: merge_insert_plain(table, batch), None,
        merge_bytes(table, batch, n_keep), MERGE_SYMBOL,
    )
    timing["capacity_bound_ms"] = bound_ms((2 * c + 2 * m) * 8 + 6 * min(n_keep, c) * 8 + m + 8)
    return timing


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
    timing = merge_timing(table, batch, n)
    emit({"phase": "merge_insert", "cases": out, **timing})
    return {"max_abs_err": max(v["max_abs_err"] for v in out.values()), **timing}


def _wide_grid_case(shapes, gen):
    """A wide model's grid compaction at its widest bucket's densest level
    (``shapes`` of its run), made on the card from ``gen``: ``(grid [F,
    A, W], mask, lanes, cap)``, the lanes the grid's W planes (strided
    views) and three per-state lanes broadcast over A, as the engine hands
    them over."""
    A, W, lv = shapes["A"], shapes["W"], shapes["levels"]
    f = max(r["bucket"] for r in lv)
    top = max((r for r in lv if r["bucket"] == f), key=lambda r: r["generated"])
    grid = torch.randint(0, 2**32, (f, A, W), dtype=DTYPE, device="cuda", generator=gen)
    per_state = torch.randint(0, 2**32, (3, f), dtype=DTYPE, device="cuda", generator=gen)
    live = torch.arange(f, device="cuda")[:, None] < top["frontier"]
    density = top["generated"] / (top["frontier"] * A)
    mask = (torch.rand((f, A), device="cuda", generator=gen) < density) & live
    lanes = [grid[:, :, w] for w in range(W)] + [p[:, None].expand(f, A) for p in per_state]
    return grid, mask, lanes, top["cand_cap"]


def _wide_frontier_case(shapes, gen, rng):
    """A wide model's frontier compaction at its level with the most new
    states: ``(is_new mask over the candidate buffer, W + 1 lanes, that
    level)``, into the level's bucket."""
    W = shapes["W"]
    wide = max(shapes["levels"], key=lambda r: r["unique"])
    rows = torch.randint(0, 2**32, (W + 1, wide["cand_cap"]), dtype=DTYPE, device="cuda", generator=gen)
    flags = np.zeros(wide["cand_cap"], bool)
    flags[rng.choice(wide["generated"], wide["unique"], replace=False)] = True
    return torch.from_numpy(flags).cuda(), list(rows), wide


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
    grid, mask, lanes, cap = _wide_grid_case(shapes, gen)
    f = grid.shape[0]
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
    del grid, lanes, mask, flat
    fmask, flanes, wide = _wide_frontier_case(shapes, gen, rng)
    out["frontier"] = check_compact(f"{tag}_frontier", fmask, flanes, wide["bucket"], reps=20)
    frontier_timing = time_compact(fmask, flanes, wide["bucket"], out["frontier"]["n_valid"], W + 1, 0)
    del fmask, flanes
    c_tab, m_cand = shapes["table_capacity"], max(r["cand_cap"] for r in lv)
    table, batch = _merge_case(rng, c_tab, shapes["unique"], m_cand)
    out["merge"] = check_merge(f"{tag}_table", table, batch, reps=20)
    nk = out["merge"]["n_keep"]
    table_merge = merge_timing(table, batch, nk)
    del table, batch
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": f"{tag}_kernels", "cases": out,
          "grid": {"F": f, "A": A, "P": W + 3, "cap": cap, **grid_timing},
          "frontier": {"M": wide["cand_cap"], "P": W + 1, "cap": wide["bucket"], **frontier_timing},
          "merge_insert": {"C": c_tab, "m": m_cand, **table_merge}})
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
                         **{k: v for k, v in table_merge.items() if k not in drop}},
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
    path: ``(4, 1, device_exact=False)`` to depth 5 and ``(4, 2,
    device_exact=False)`` to its linearizability counterexample, equal to
    the CPU in counts, levels, discoveries and ``hv_stats``. Returns the
    launches of each run and the shape of each host-verified run's widest
    hv compaction (``hv_shape``)."""
    cases = (
        ("3c1s", lambda: PackedSingleCopyRegister(3, 1), None),
        ("ordered_2c", lambda: PackedSingleCopyRegisterOrdered(2), None),
        ("4c1s_hv_depth5", lambda: PackedSingleCopyRegister(4, 1, device_exact=False), 5),
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
    merge["m_320"] = {**check, **merge_timing(table, batch, nk)}
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
    """A search of ``model`` (on a mesh too, with ``mesh=``) stopped with the
    frontier at ``depth`` intact: ``target_max_depth`` bounds each block's
    level budget, and the loop stops before the next dispatch's entry check
    would retire the frontier."""
    c = model.checker().target_max_depth(depth).spawn_xla(**kw)
    while c._depth < depth and not c.is_done():
        c._run_block()
    require(c._depth == depth and c.metrics()["frontier_count"] > 0, f"stopped at depth {c._depth}")
    return c


def tail_levels(c, depth: int) -> list:
    """``(depth, frontier, generated, unique)`` of every level from ``depth``
    on."""
    return [r[:4] for r in levels(c) if r[0] >= depth]


def check_paths(c) -> None:
    c.assert_properties()
    for name, path in c.discoveries().items():
        c.assert_discovery(name, path.into_actions())


class NativeMaps:
    """Every parent map that an engine builds for its witness paths (the
    single-chip and the sharded engines' ``_parent_map``) while installed:
    the script fails on a map that the native host kit does not hold,
    unless ``fallback_ok`` (:func:`python_fallback`)."""

    def __init__(self):
        self.native = self.fallback = 0
        self.fallback_ok = False
        for cls in (XlaChecker, sharded_mod.ShardedXlaChecker):
            self._track(cls)

    def _track(self, cls) -> None:
        original = cls._parent_map

        def tracked(checker):
            pm = original(checker)
            if pm.native:
                self.native += 1
            else:
                require(self.fallback_ok, f"{type(checker).__name__}: a parent map fell back to Python")
                self.fallback += 1
            return pm

        cls._parent_map = tracked


@contextlib.contextmanager
def python_fallback():
    """The host kit's Python fallback forced, as the tests force it (its
    loader replaced by one that finds no library)."""
    load = native._load
    native._load = lambda: None
    NATIVE_MAPS.fallback_ok = True
    try:
        yield
    finally:
        native._load = load
        NATIVE_MAPS.fallback_ok = False


def witness_times(c, what: str) -> dict:
    """Witness reconstruction of a single-chip checker ``c``'s discoveries
    with the native map and with the fallback (``native.SortedParentMap``),
    host seconds on the card's machine: the host read of the occupied rows,
    each map's build, ``len`` and ``chain`` of each discovery, and the
    whole ``discoveries()`` under each (the read, the map and the forward
    walk through the object model). Every chain equal under both maps, both
    maps as long as the unique count, the paths equal, every discovery
    re-executed."""
    found = dict(c._found_names)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = c._ds.occupied_rows(c._table)
    out = {"rows": len(rows[0]), "read_s": time.perf_counter() - t0}
    chains = {}
    for kind, build in (("native", native.ParentMap), ("fallback", native.SortedParentMap)):
        t0 = time.perf_counter()
        pm = build(*rows)
        line = {"build_s": time.perf_counter() - t0, "len": len(pm), "chain_s": {}}
        require(kind == "fallback" or pm.native, f"{what}: the engine's map is not native")
        chains[kind] = {}
        for name, fp in found.items():
            t0 = time.perf_counter()
            chains[kind][name] = pm.chain(fp)
            line["chain_s"][name] = time.perf_counter() - t0
        out[kind] = line
        del pm
    require(chains["native"] == chains["fallback"], f"{what}: the chains differ between the maps")
    require(out["native"]["len"] == out["fallback"]["len"] == c.unique_state_count(),
            f"{what}: map lengths {out['native']['len']}, {out['fallback']['len']}")
    t0 = time.perf_counter()
    paths = c.discoveries()
    out["native"]["discoveries_s"] = time.perf_counter() - t0
    with python_fallback():
        t0 = time.perf_counter()
        fallback_paths = c.discoveries()
        out["fallback"]["discoveries_s"] = time.perf_counter() - t0
    actions = {name: p.into_actions() for name, p in paths.items()}
    require(actions == {name: p.into_actions() for name, p in fallback_paths.items()},
            f"{what}: the paths differ between the maps")
    c.assert_properties()
    for name, acts in actions.items():
        c.assert_discovery(name, acts)
    out["chain_len"] = {name: len(ch) for name, ch in chains["native"].items()}
    out["chains_equal"] = True
    return out


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


#: The ``cli`` phase's command lines: the module, its arguments and the
#: ``(generated, unique)`` its ``Done.`` line must print (the last the JAX
#: package's ``PackedAbdOrdered(2, 2)`` counts, ``EXPECTED_ABD``).
CLI_COMMANDS = (
    ("two_phase_commit", ("check", "8"), EXPECTED_2PC[8]),
    ("paxos", ("check", "2"), EXPECTED_PAXOS2),
    ("single_copy_register", ("check", "3"), EXPECTED_SCR3),
    ("linearizable_register", ("check", "2", "ordered"), EXPECTED_ABD[("ordered", 2)][:2]),
)
#: ``python -c CLI_BOOT <module> <args>``: the module's ``__main__`` as
#: ``python -m`` runs it, then the kernels' launch counters as one JSON
#: line on stderr at exit.
CLI_BOOT = """
import atexit, json, runpy, sys
from stateright_tpu_torch.ops import hashset
from stateright_tpu_torch.ops.compact import compact
from stateright_tpu_torch.ops.merge import merge_insert
atexit.register(lambda: print(json.dumps({"launches": {
    "compact": compact.launches, "merge_insert": merge_insert.launches,
    "hashset_insert": hashset.insert_.launches, "hashset_undo": hashset.undo_.launches,
}}), file=sys.stderr, flush=True))
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""
DONE_LINE = r"^Done\. states=(\d+), unique=(\d+), depth=(\d+), sec=(\d+)$"


def cli_phase() -> dict:
    """Each model's ``check`` command line in a fresh process on the card,
    all at once: exit 0, the pinned counts, the kernels of the path
    launched; the wall from process start (torch's import, the card's
    start and a cold check, beside the other three)."""
    import re

    root = os.path.dirname(os.path.abspath(__file__))
    lines, launches = {}, {}

    def run(module, args):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", CLI_BOOT, f"stateright_tpu_torch.models.{module}", *args],
            cwd=root, capture_output=True, text=True, timeout=600,
        )
        return proc, time.perf_counter() - t0

    with ThreadPoolExecutor(len(CLI_COMMANDS)) as ex:
        runs = [ex.submit(run, module, args) for module, args, _ in CLI_COMMANDS]
        done_runs = [r.result() for r in runs]
    for (module, args, pins), (proc, wall) in zip(CLI_COMMANDS, done_runs):
        name = f"{module} {' '.join(args)}"
        out = proc.stdout.splitlines()
        require(proc.returncode == 0,
                f"cli {name}: exit {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        done = [m for m in (re.match(DONE_LINE, line) for line in out) if m]
        require(len(done) == 1, f"cli {name}: Done. lines {out[-5:]}")
        counts = tuple(int(x) for x in done[0].groups())
        require(counts[:2] == pins, f"cli {name}: counts {counts[:2]} != {pins}")
        ran = json.loads(proc.stderr.strip().splitlines()[-1])["launches"]
        require(ran["compact"] > 0 and ran["merge_insert"] > 0, f"cli {name}: launches {ran}")
        launches[f"cli_{module}"] = {k: n for k, n in ran.items() if n}
        lines[name] = {"wall_s": wall, "first_line": out[0], "done": done[0].group(0),
                       "generated": counts[0], "unique": counts[1], "max_depth": counts[2],
                       "launches": ran}
    emit({"phase": "cli", "commands": lines})
    return launches


#: The ``service`` phase's configuration on the card: the specs of its
#: items and their pins, the depths of its faults and the pools' leashes.
SERVICE_CARD = {
    "platform": "default",
    "big": "2pc:8", "big_pins": EXPECTED_2PC[8],
    "paxos": "paxos:2,3", "paxos_pins": EXPECTED_PAXOS2,
    "small": "2pc:5", "small_pins": EXPECTED_2PC[5],
    "tiny": "2pc:4", "tiny_pins": EXPECTED_2PC[4],
    "die_depth": 14, "freeze_depth": 14, "tiny_freeze_depth": 3,
    "stall_s": 15.0, "breaker_stall_s": 6.0, "poll_s": 0.5,
}
#: ``python -c SERVICE_BOOT <mode> <config JSON>``: a checker-service pool
#: in a process of its own, which imports ``stateright_tpu_torch.service``
#: and nothing that launches a kernel. ``batch`` runs the phase's items 1-5
#: (exact jobs, kill and resume, wedge isolation, mux, the breaker),
#: ``restart-a`` starts a job and waits (the phase SIGKILLs it) and
#: ``restart-b`` restarts a pool over the same run dir. One JSON line an
#: item on stdout; any failed check prints ``service_error`` and exits 1.
SERVICE_BOOT = r"""
import json, os, re, sys, time
mode, cfg = sys.argv[1], json.loads(sys.argv[2])
from stateright_tpu_torch.service import CheckerService, ServiceConfig, read_journal

T0 = time.time()
DEVICE = cfg["platform"] != "cpu"


def out(obj):
    print(json.dumps(obj, default=str), flush=True)


def need(ok, what):
    if not ok:
        out({"service_error": what})
        sys.exit(1)


def pool(name, **kw):
    base = dict(run_dir=os.path.join(cfg["run_dir"], name), platform=cfg["platform"],
                stall_s=cfg["stall_s"], startup_grace_s=300.0, poll_s=cfg["poll_s"],
                backoff_s=0.5, probe_auto=False, admission_lint=False,
                default_max_seconds=900.0)
    base.update(kw)
    return CheckerService(ServiceConfig(**base))


def line(job):
    r = job.result or {}
    m = r.get("metrics") or {}
    return {
        "id": job.id, "spec": job.spec, "status": job.status, "error": job.error,
        "engine": job.engine, "degraded": job.degraded,
        "wall_s": (job.completed_unix_ts or time.time()) - job.created_unix_ts,
        "attempts": [{k: a[k] for k in ("rc", "killed", "seconds", "wedged")} for a in job.attempts],
        "requeues": job.requeues, "wedges": job.wedges,
        "platform": r.get("platform"), "device": m.get("device"),
        "generated": r.get("generated"), "unique": r.get("unique"), "max_depth": r.get("max_depth"),
        "discoveries": r.get("discoveries"), "start_depth": r.get("start_depth"),
        "resumed": bool(r.get("resumed_from")), "first_dispatch_s": r.get("first_dispatch_s"),
        "kernel_build_s": r.get("kernel_build_s"), "worker_seconds": r.get("seconds"),
        "captures": m.get("graph_captures"), "capture_s": m.get("graph_capture_s"),
        "peak_memory_bytes": r.get("peak_memory_bytes"), "launches": r.get("launches"),
        "mux": r.get("mux"),
    }


def exact(job, pins, device=DEVICE):
    need(job.status == "done", f"{job.id} {job.spec}: {job.status} {job.error}")
    r = job.result
    need((r["generated"], r["unique"]) == tuple(pins),
         f"{job.id} {job.spec}: counts {(r['generated'], r['unique'])} != {pins}")
    if device:
        need(r["platform"] == "cuda" and str(r["metrics"]["device"]).startswith("cuda"),
             f"{job.id}: ran on {r['platform']} {r['metrics'].get('device')}")
        need(r["launches"]["compact"] > 0 and r["launches"]["merge_insert"] > 0,
             f"{job.id}: launches {r['launches']}")
    return line(job)


def stale_age(job):
    return float(re.search(r"heartbeat stale (\d+)s", job.attempts[0]["killed"]).group(1))


if mode == "batch":
    # 1. Exact jobs, two at a time, through the admission flight-check.
    p1 = pool("jobs", max_inflight=2, admission_lint=True)
    a = p1.submit(cfg["big"])
    b = p1.submit(cfg["paxos"])
    need(p1.wait_all(timeout=900), "jobs: timeout")
    out({"item": "jobs", "jobs": [exact(a, cfg["big_pins"]), exact(b, cfg["paxos_pins"])],
         "lint": [a.lint, b.lint]})
    solo_wall = a.completed_unix_ts - a.created_unix_ts
    # 2. A SIGKILL at a depth: requeued once, resumed from its rotation.
    k = p1.submit(cfg["big"], chaos={"die_at_depth": cfg["die_depth"],
                                     "marker": os.path.join(cfg["run_dir"], "kill.marker")})
    need(k.wait(timeout=900), "kill: timeout")
    kl = exact(k, cfg["big_pins"])
    g = p1.gauges()
    need(k.attempts[0]["rc"] == -9 and not k.attempts[0]["wedged"], f"kill: {k.attempts}")
    need((k.requeues, g["crashes"], g["requeues"]) == (1, 1, 1), f"kill: {g}")
    need(kl["resumed"] and kl["start_depth"] == cfg["die_depth"], f"kill: {kl['start_depth']}")
    out({"item": "kill", "job": kl, "crashes": g["crashes"], "requeues": g["requeues"]})
    # 3. A frozen dispatch beside a running sibling.
    marker = os.path.join(cfg["run_dir"], "freeze.marker")
    v = p1.submit(cfg["big"], chaos={"freeze_at_depth": cfg["freeze_depth"], "marker": marker})
    s = p1.submit(cfg["big"])
    need(p1.wait_all(timeout=900), "wedge: timeout")
    vl, sl = exact(v, cfg["big_pins"]), exact(s, cfg["big_pins"])
    need(v.wedges == 1 and v.attempts[0]["wedged"] and "mid-dispatch" in v.attempts[0]["killed"],
         f"wedge: {v.attempts}")
    need((s.wedges, s.requeues, len(s.attempts)) == (0, 0, 1), f"wedge sibling: {s.attempts}")
    need(vl["resumed"] and vl["start_depth"] >= cfg["freeze_depth"], f"wedge: {vl['start_depth']}")
    age = stale_age(v)
    need(age <= cfg["stall_s"] + 2 * cfg["poll_s"] + 1, f"wedge verdict at {age}s")
    quarantined = [r for r in read_journal(p1._journal.path).records
                   if r["event"] == "quarantined" and r["job"] == v.id][0]
    g = p1.gauges()
    need((g["wedge_verdicts"], g["breaker_trips"]) == (1, 0), f"wedge: {g}")
    out({"item": "wedge", "victim": vl, "sibling": sl, "stale_age_s": age,
         "freeze_to_quarantine_s": quarantined["ts"] - os.stat(marker).st_mtime,
         "sibling_wall_over_solo": sl["wall_s"] / solo_wall, "solo_wall_s": solo_wall})
    p1.close()
    # Items 4 and 5 may overlap the phase's restart drill: say so.
    open(os.path.join(cfg["run_dir"], "items-1-3.done"), "w").close()
    # 4. Four co-queued jobs as one --mux worker.
    p2 = pool("mux", max_inflight=0, mux_k=4)
    jobs = [p2.submit(cfg["small"]) for _ in range(4)]
    with p2._cond:
        p2._cfg.max_inflight = 4
        p2._cond.notify_all()
    need(p2.wait_all(timeout=900), "mux: timeout")
    lines = [exact(j, cfg["small_pins"]) for j in jobs]
    need(all(ln["mux"]["lanes"] == 4 for ln in lines) and len({ln["mux"]["group"] for ln in lines}) == 1,
         f"mux: {[ln['mux'] for ln in lines]}")
    g = p2.gauges()
    need((g["mux_groups"], g["mux_lanes"]) == (1, 4) and g["mux_dispatches_saved"] >= 1, f"mux: {g}")
    with open(jobs[0]._path("mux-result.json")) as fh:
        summary = json.load(fh)
    out({"item": "mux", "jobs": lines, "mux_groups": g["mux_groups"], "mux_lanes": g["mux_lanes"],
         "mux_dispatches_saved": g["mux_dispatches_saved"], "summary": summary})
    p2.close()
    # 5. Two jobs frozen side by side (no marker: every attempt freezes)
    # open the breaker; the host serves; a probe closes it.
    p3 = pool("breaker", stall_s=cfg["breaker_stall_s"], requeue_limit=0, breaker_k=2,
              max_inflight=2)
    ws = [p3.submit(cfg["tiny"], chaos={"freeze_at_depth": cfg["tiny_freeze_depth"]})
          for _ in range(2)]
    need(p3.wait_all(timeout=900), "breaker: timeout")
    need(all(w.status == "failed" and w.wedges == 1 for w in ws) and p3.degraded,
         f"breaker: {[(w.status, w.wedges) for w in ws]}")
    h = p3.submit(cfg["tiny"])
    need(h.wait(timeout=900), "breaker host: timeout")
    hl = exact(h, cfg["tiny_pins"], device=False)
    need(h.engine == "host" and h.result["degraded"] is True and hl["platform"] == "cpu",
         f"breaker host: {h.engine} {hl['platform']}")
    t = time.time()
    probed = p3.probe_device_now()
    probe_s = time.time() - t
    need(probed and not p3.degraded, "breaker: the probe did not close it")
    d = p3.submit(cfg["tiny"])
    need(d.wait(timeout=900), "breaker device: timeout")
    dl = exact(d, cfg["tiny_pins"])
    need(d.engine == "xla" and not d.degraded, f"breaker device: {d.engine}")
    g = p3.gauges()
    out({"item": "breaker", "wedgers": [line(w) for w in ws], "host": hl, "device": dl,
         "probe_s": probe_s,
         **{k: g[k] for k in ("breaker_trips", "breaker_closes", "degraded_jobs", "wedge_verdicts",
                              "device_probes")}})
    p3.close()
    import torch
    mods = sorted(m for m in sys.modules if m.startswith("stateright_tpu_torch")
                  and m.rsplit(".", 1)[-1] in ("xla", "graphs", "_cuda", "xla_mux"))
    out({"item": "pool_process", "cuda_initialized": torch.cuda.is_initialized(),
         "kernel_modules": mods, "wall_s": time.time() - T0})
elif mode == "restart-a":
    p = pool("restart")
    job = p.submit(cfg["big"], idempotency_key="restart-0")
    out({"item": "restart_a", "pid": os.getpid(), "job": job.id})
    job.wait(timeout=900)
    out({"service_error": "restart-a was not killed"})
    sys.exit(1)
elif mode == "restart-b":
    p = pool("restart")
    recovery = p.gauges()["journal"]["recovery"]
    job = p.submit(cfg["big"], idempotency_key="restart-0")
    need(job.recovered and job.id == "job-0001", f"restart: {job.id} {job.recovered}")
    need(job.wait(timeout=900), "restart: timeout")
    jl = exact(job, cfg["big_pins"])
    # A fresh job starts at depth 1: the recovered one resumes from the
    # orphan's rotation.
    need(jl["start_depth"] > 1, f"restart: resumed at depth {jl['start_depth']}")
    p.close()
    done = [r for r in read_journal(p._journal.path).records if r["event"] == "completed"]
    need(len(done) == 1 and done[0]["status"] == "done", f"restart: completions {done}")
    import torch
    out({"item": "restart_b", "recovery": recovery, "job": jl, "completed_records": len(done),
         "cuda_initialized": torch.cuda.is_initialized(), "wall_s": time.time() - T0})
"""


def service_boot(mode: str, config: dict, timeout: float = 900.0) -> list:
    """Runs one ``SERVICE_BOOT`` pool process to its end: its JSON lines."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-c", SERVICE_BOOT, mode, json.dumps(config)],
                          cwd=root, capture_output=True, text=True, timeout=timeout)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    require(proc.returncode == 0 and not any("service_error" in ln for ln in lines),
            f"service {mode}: exit {proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-5000:]}")
    return lines


def kill_service_workers(run_dir: str) -> int:
    """SIGKILLs every worker group still alive that a pool under ``run_dir``
    journaled (a pool killed or failed mid-phase leaves its workers in
    sessions of their own). Returns how many it killed."""
    killed = 0
    for journal in glob.glob(os.path.join(run_dir, "**", "journal.jsonl*"), recursive=True):
        with open(journal) as fh:
            for ln in fh:
                try:
                    pid = json.loads(ln).get("pid")
                    with open(f"/proc/{pid}/cmdline", "rb") as cmd:
                        if b"worker.py" not in cmd.read():
                            continue
                    os.killpg(pid, 9)
                    killed += 1
                except (ValueError, TypeError, OSError):
                    continue
    return killed


def replay_discovery(model, name: str, reprs: list) -> bool:
    """Re-executes a worker's discovery (its actions' ``repr``) from an init
    state on the host model: True when the path is one and the property's
    expectation holds at its end."""
    prop = model.property(name)
    for state in model.init_states():
        states = [state]
        for want in reprs:
            acts = []
            model.actions(states[-1], acts)
            nxt = [a for a in acts if repr(a) == want]
            nxt_state = model.next_state(states[-1], nxt[0]) if nxt else None
            if nxt_state is None:
                break
            states.append(nxt_state)
        else:
            if prop.expectation == Expectation.SOMETIMES:
                ok = prop.condition(model, states[-1])
            elif prop.expectation == Expectation.ALWAYS:
                ok = not prop.condition(model, states[-1])
            else:  # EVENTUALLY: a terminal path on which the condition never held
                terminal = []
                model.actions(states[-1], terminal)
                ok = not terminal and not any(prop.condition(model, st) for st in states)
            if ok:
                return True
    return False


def service_jobs_checked(lines: list, models: dict) -> None:
    """Every discovery of every finished job in ``lines`` re-executed."""
    for ln in lines:
        for job in ln:
            for name, reprs in (job.get("discoveries") or {}).items():
                require(replay_discovery(models[job["spec"]], name, reprs),
                        f"service {job['id']} {job['spec']}: discovery {name!r} does not replay")


def path_launches(jobs: list) -> dict:
    """The sorted set's kernels launched by ``jobs``' finished attempts."""
    return {k: sum((j.get("launches") or {}).get(k, 0) for j in jobs) for k in PATH_KERNELS["sorted"]}


def service_phase(config: dict = SERVICE_CARD, explorer_rm: int = 8) -> dict:
    """The checker service on the card, its pools in processes of their own
    (``SERVICE_BOOT``): exact jobs, a kill and resume, a wedge beside a
    sibling, a mux group, the breaker to the host and back, a pool killed
    mid-job and restarted over its run dir, and (in this process) the
    Explorer as a client. Returns the launches by path. A config with
    ``platform="cpu"`` rehearses the phase on the CPU (no launches)."""
    t0 = time.perf_counter()
    run_dir = os.path.join(CKPT_DIR, "service")
    os.makedirs(run_dir)
    cfg = dict(config, run_dir=run_dir)
    root = os.path.dirname(os.path.abspath(__file__))
    batch_out = os.path.join(run_dir, "batch.out")
    with open(batch_out, "w") as fh:
        batch_proc = subprocess.Popen([sys.executable, "-c", SERVICE_BOOT, "batch", json.dumps(cfg)],
                                      cwd=root, stdout=fh, stderr=subprocess.STDOUT)
    try:
        return service_drills(config, cfg, run_dir, root, batch_proc, batch_out, explorer_rm, t0)
    finally:
        # A failed check must leave no pool and no worker running.
        if batch_proc.poll() is None:
            batch_proc.kill()
            batch_proc.wait(timeout=60)
        kill_service_workers(run_dir)


def service_restart(cfg: dict, run_dir: str, root: str) -> dict:
    """Item 6 of the ``service`` phase: a pool process (``restart-a``)
    SIGKILLed once its job's first block is committed, its worker held
    there, and a new pool (``restart-b``) over the same run dir, which
    kills the orphan and resumes the job from its rotation, exact. Returns
    ``restart-b``'s line with the orphan's state and the beat at the kill."""
    with open(os.path.join(run_dir, "restart-a.out"), "w") as log:
        first = subprocess.Popen([sys.executable, "-c", SERVICE_BOOT, "restart-a", json.dumps(cfg)],
                                 cwd=root, stdout=log, stderr=subprocess.STDOUT)
    journal = os.path.join(run_dir, "restart", "journal.jsonl")
    deadline = time.monotonic() + 600
    beat = worker_pid = None
    while time.monotonic() < deadline and first.poll() is None and worker_pid is None:
        # The job's first committed block: its first valid rotation.
        for ck in glob.glob(os.path.join(run_dir, "restart", "svc-*", "job-0001", "ck.npz")):
            if latest_valid_checkpoint(ck) is not None:
                beat = heartbeat.read(os.path.join(os.path.dirname(ck), "hb.json")) or {}
                started = [json.loads(ln) for ln in open(journal)]
                worker_pid = [r for r in started if r["event"] == "started"][0]["pid"]
        time.sleep(0.2)
    # The orphan is held where its first rotation left it, before the pool
    # is killed: run on, it can finish the job before the restarted pool
    # kills it, and the resumed job then has no level left to launch (a
    # race with the host's speed). The restart must still find it alive,
    # kill it and resume the job from that rotation.
    if worker_pid is not None:
        with contextlib.suppress(ProcessLookupError):
            os.kill(worker_pid, signal.SIGSTOP)
    alive = first.poll() is None
    first.kill()
    first.wait(timeout=60)
    require(alive and worker_pid is not None, f"service restart: no committed block ({beat})")
    orphan_alive = os.path.exists(f"/proc/{worker_pid}")
    second = {ln["item"]: ln for ln in service_boot("restart-b", cfg)}
    restart = second["restart_b"]
    require(restart["cuda_initialized"] is False, "service restart: the pool process touched CUDA")
    require(not os.path.exists(f"/proc/{worker_pid}") or open(f"/proc/{worker_pid}/stat").read().split()[2] == "Z",
            "service restart: the orphaned worker survived the restart")
    return dict(restart, orphan_alive_at_restart=orphan_alive, killed_at_beat_seq=beat.get("seq"))


def service_drills(config, cfg, run_dir, root, batch_proc, batch_out, explorer_rm, t0) -> dict:
    """``service_phase``'s body once the batch pool process runs."""
    on_card = config["platform"] != "cpu"
    # 6. The pool process SIGKILLed mid-job; a new pool finishes the job.
    # It runs beside the batch pool's items 4 and 5 (their walls are not
    # the phase's measurements), after items 1-3 (which are).
    deadline = time.monotonic() + 900
    while (not os.path.exists(os.path.join(run_dir, "items-1-3.done"))
           and batch_proc.poll() is None and time.monotonic() < deadline):
        time.sleep(0.5)
    if batch_proc.poll() is not None and batch_proc.returncode != 0:
        with open(batch_out) as fh:
            require(False, f"service batch: exit {batch_proc.returncode}\n{fh.read()[-6000:]}")
    restart = service_restart(cfg, run_dir, root)
    rc = batch_proc.wait(timeout=900)
    with open(batch_out) as fh:
        text = fh.read()
    lines = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
    require(rc == 0 and not any("service_error" in ln for ln in lines),
            f"service batch: exit {rc}\n{text[-6000:]}")
    batch = {ln["item"]: ln for ln in lines}
    require(batch["pool_process"]["cuda_initialized"] is False
            and not batch["pool_process"]["kernel_modules"],
            f"service: the pool process touched CUDA: {batch['pool_process']}")
    models = {spec: resolve_spec(spec)[0] for spec in
              (config["big"], config["paxos"], config["small"], config["tiny"])}
    service_jobs_checked([batch["jobs"]["jobs"], [batch["kill"]["job"]],
                          [batch["wedge"]["victim"], batch["wedge"]["sibling"]],
                          batch["mux"]["jobs"],
                          [batch["breaker"]["host"], batch["breaker"]["device"]],
                          [restart["job"]]], models)
    # 7. The Explorer as a client of a pool, in this process.
    pool = CheckerService(ServiceConfig(run_dir=os.path.join(run_dir, "explorer"),
                                        admission_lint=False, probe_auto=False))
    zero_launches()
    app, checker = make_app(PackedTwoPhaseSys(explorer_rm).checker(), service=pool,
                            **({} if on_card else {"device": "cpu"}))
    status = app.status()
    require((status["job"], status["degraded"], status["pool"]["interactive"]) == ("job-0001", False, 1),
            f"service explorer: status {({k: status.get(k) for k in ('job', 'degraded')})}")
    code, listing = app.pool()
    require(code == 200 and listing["jobs"]["job-0001"]["kind"] == "interactive"
            and listing["jobs"]["job-0001"]["status"] == "running", "service explorer: /.pool")
    code, inits = app.states("/")
    code2, views = app.states("/" + inits[0]["fingerprint"])
    require(code == code2 == 200 and views, "service explorer: clicks")
    explorer_launches = launches_now()
    clicked = app.status()
    app.close()
    released = pool.metrics()
    require(released["interactive"] == 0 and released["jobs"]["job-0001"]["status"] == "done",
            "service explorer: release")
    pool.close()
    launches = {
        "service_jobs": path_launches(batch["jobs"]["jobs"]),
        "service_kill": path_launches([batch["kill"]["job"]]),
        "service_wedge": path_launches([batch["wedge"]["victim"], batch["wedge"]["sibling"]]),
        "service_mux": {k: batch["mux"]["summary"]["launches"][k] for k in PATH_KERNELS["sorted"]},
        "service_breaker": path_launches([batch["breaker"]["device"]]),
        "service_restart": path_launches([restart["job"]]),
        "service_explorer": explorer_launches,
    }
    for path, counts in launches.items():
        require(all(n > 0 for n in counts.values()) or not on_card,
                f"service: {path} launched {counts}")

    def brief(job):
        return {k: job[k] for k in ("id", "spec", "wall_s", "first_dispatch_s", "kernel_build_s",
                                    "worker_seconds", "captures", "capture_s", "peak_memory_bytes",
                                    "launches", "attempts", "start_depth", "engine", "platform",
                                    "device", "generated", "unique", "max_depth")}

    emit({"phase": "service", "wall_s": time.perf_counter() - t0,
          "jobs": [brief(j) for j in batch["jobs"]["jobs"]], "lint": batch["jobs"]["lint"],
          "kill": {**brief(batch["kill"]["job"]), "crashes": batch["kill"]["crashes"],
                   "requeues": batch["kill"]["requeues"]},
          "wedge": {"victim": brief(batch["wedge"]["victim"]), "sibling": brief(batch["wedge"]["sibling"]),
                    **{k: batch["wedge"][k] for k in ("stale_age_s", "freeze_to_quarantine_s",
                                                      "sibling_wall_over_solo", "solo_wall_s")},
                    "stall_s": config["stall_s"]},
          "mux": {"jobs": [brief(j) for j in batch["mux"]["jobs"]],
                  **{k: batch["mux"][k] for k in ("mux_groups", "mux_lanes", "mux_dispatches_saved")},
                  "summary": batch["mux"]["summary"]},
          "breaker": {"wedgers": [{k: w[k] for k in ("status", "wedges", "attempts", "wall_s")}
                                  for w in batch["breaker"]["wedgers"]],
                      "host": brief(batch["breaker"]["host"]), "device": brief(batch["breaker"]["device"]),
                      **{k: batch["breaker"][k] for k in ("probe_s", "breaker_trips", "breaker_closes",
                                                          "degraded_jobs", "wedge_verdicts",
                                                          "device_probes")}},
          "restart": {"recovery": restart["recovery"], "job": brief(restart["job"]),
                      **{k: restart[k] for k in ("orphan_alive_at_restart", "killed_at_beat_seq")},
                      "completed_records": restart["completed_records"],
                      "pool_wall_s": restart["wall_s"]},
          "explorer": {"status_keys": sorted(k for k in ("job", "degraded", "pool") if k in clicked),
                       "job": status["job"], "pool_interactive": status["pool"]["interactive"],
                       "launches": explorer_launches, "released": released["jobs"]["job-0001"]["status"]},
          "pool_process": batch["pool_process"]})
    return launches


#: The ``fleet`` phase's configuration on the card: the specs of its items
#: and their pins, when the chaos loses a device, the flaky job's freeze
#: depth, the pools' leashes and the harness's seed and scenarios. The
#: failover loses the victim's device at its first committed rotation (an
#: event, not a delay: how soon a worker reaches its first dispatch
#: depends on the host).
FLEET_CARD = {
    "platform": "default",
    "big": "2pc:8", "big_pins": EXPECTED_2PC[8],
    "flaky": "2pc:4", "flaky_pins": EXPECTED_2PC[4], "flaky_depth": 3,
    "stall_s": 15.0, "breaker_stall_s": 6.0, "poll_s": 0.5,
    "chaos_seed": 42, "chaos_jobs": 3, "chaos_scenarios": ["device_lost", "kill"],
}
#: ``python -c FLEET_BOOT <mode> <config JSON>``: a two-pool
#: ``FleetService`` (``pin_devices=True``) in a process of its own, which
#: imports ``stateright_tpu_torch.service`` and nothing that launches a
#: kernel. ``failover`` loses the first job's device (``device_lost``) at
#: that job's first committed rotation,
#: ``flaky`` wedges a job on pool 0. One JSON line an item on stdout; a
#: failed check prints ``fleet_error`` and exits 1.
FLEET_BOOT = r"""
import json, os, sys, time
mode, cfg = sys.argv[1], json.loads(sys.argv[2])
from stateright_tpu_torch.checkpoint import latest_valid_checkpoint
from stateright_tpu_torch.service import FleetConfig, FleetService, ServiceConfig, read_journal

T0 = time.time()
DEVICE = cfg["platform"] != "cpu"
EVENTS = []


def out(obj):
    print(json.dumps(obj, default=str), flush=True)


def need(ok, what):
    if not ok:
        out({"fleet_error": what})
        sys.exit(1)


def fleet(name, chaos, **kw):
    pool = dict(platform=cfg["platform"], stall_s=cfg["stall_s"], startup_grace_s=300.0,
                poll_s=cfg["poll_s"], backoff_s=0.5, probe_auto=False, admission_lint=False,
                default_max_seconds=900.0)
    pool.update(kw)
    f = FleetService(FleetConfig(run_dir=os.path.join(cfg["run_dir"], name), devices=2,
                                 monitor_interval_s=0.5, pin_devices=True, chaos=chaos,
                                 pool=ServiceConfig(**pool)))
    f.log = lambda msg: EVENTS.append((time.time(), msg))
    return f


def worker(job):
    r = job.result or {}
    m = r.get("metrics") or {}
    return {
        "id": job.id, "spec": job.spec,
        "pool": job._service._cfg.device, "pool_job": job.id, "status": job.status,
        "engine": job.engine, "degraded": job.degraded, "platform": r.get("platform"),
        "device_ordinal": r.get("device_ordinal"), "device_label": r.get("device"),
        "torch_device": m.get("device"),
        "generated": r.get("generated"), "unique": r.get("unique"), "max_depth": r.get("max_depth"),
        "discoveries": r.get("discoveries"), "start_depth": r.get("start_depth"),
        "resumed_from": r.get("resumed_from"), "first_dispatch_s": r.get("first_dispatch_s"),
        "worker_seconds": r.get("seconds"), "captures": m.get("graph_captures"),
        "capture_s": m.get("graph_capture_s"), "peak_memory_bytes": r.get("peak_memory_bytes"),
        "launches": r.get("launches"),
        "attempts": [{k: a.get(k) for k in ("rc", "killed", "seconds", "wedged")}
                     for a in job.attempts],
    }


def exact(fjob, pins):
    need(fjob.status == "done", f"{fjob.id}: {fjob.status} {fjob.error}")
    w = worker(fjob.pool_job)
    need((w["generated"], w["unique"]) == tuple(pins), f"{fjob.id}: counts {w['generated']}")
    if DEVICE:
        need(w["platform"] == "cuda" and str(w["torch_device"]).startswith("cuda"),
             f"{fjob.id}: ran on {w['platform']} {w['torch_device']}")
        need(w["launches"]["compact"] > 0 and w["launches"]["merge_insert"] > 0,
             f"{fjob.id}: launches {w['launches']}")
    return dict(w, fleet_job=fjob.id, migrations=len(fjob.migrations),
                wall_s=fjob.pool_job.completed_unix_ts - fjob.created_unix_ts)


def started_ts(pool, job_id):
    rs = [r for r in read_journal(pool._journal.path).records
          if r["event"] == "started" and r["job"] == job_id]
    return rs[-1]["ts"]


def when(word):
    return [t for t, msg in EVENTS if word in msg]


if mode == "failover":
    f = fleet("failover", None)
    victim = f.submit(cfg["big"])
    sibling = f.submit(cfg["big"])
    lost, first = victim.device, victim.pool_job
    need({victim.device, sibling.device} == {0, 1}, f"failover: routes {victim.device} {sibling.device}")
    deadline = time.time() + 600
    while not (first.dir and latest_valid_checkpoint(first.checkpoint_path)):
        need(time.time() < deadline and not victim.done,
             f"failover: the victim ended as {first.status} with no rotation")
        time.sleep(0.1)
    f.device_lost(lost)
    need(f.wait_all(timeout=900), "failover: timeout")
    vl, sl = exact(victim, cfg["big_pins"]), exact(sibling, cfg["big_pins"])
    need(len(victim.migrations) == 1 and sibling.migrations == [],
         f"failover: migrations {victim.migrations} {sibling.migrations}")
    hop = victim.migrations[0]
    need((hop["from"], hop["to"]) == (lost, 1 - lost), f"failover: hop {hop}")
    need(bool(hop["seed"]) and hop["seed"].startswith(first.dir + os.sep),
         f"failover: seed {hop['seed']} is not the victim's rotation")
    need(vl["resumed_from"] == hop["seed"] and vl["start_depth"] > 0,
         f"failover: resumed at {vl['start_depth']} from {vl['resumed_from']}")
    g = f.gauges()
    need((g["migrations"], g["devices_lost"], g["jobs_evacuated"], g["lost_devices"])
         == (1, 1, 1, [lost]), f"failover: gauges {g}")
    evacuated = [r["job"] for r in read_journal(f.pools[lost]._journal.path).records
                 if r["event"] == "evacuated"]
    need(evacuated == [first.id], f"failover: evacuated {evacuated}")
    routing = [(r["event"], r["job"]) for r in
               read_journal(os.path.join(cfg["run_dir"], "failover", "fleet.jsonl")).records
               if r["event"] in ("routed", "migrated")]
    need(routing == [("routed", victim.id), ("routed", sibling.id), ("migrated", victim.id)],
         f"failover: fleet journal {routing}")
    lost_at = when("LOST")[0]
    resumed = started_ts(f.pools[victim.device], victim.pool_job.id)
    out({"item": "failover", "victim": vl, "sibling": sl, "lost_device": lost,
         "victim_first": {"pool": first._service._cfg.device, "pool_job": first.id,
                          "status": first.status, "consumed_s": first.consumed_s},
         "hop": hop,
         "lost_after_submit_s": lost_at - victim.created_unix_ts,
         "loss_to_resumed_dispatch_s": resumed + vl["first_dispatch_s"] - lost_at,
         "loss_to_migrated_s": hop["unix_ts"] - lost_at,
         **{k: g[k] for k in ("migrations", "devices_lost", "jobs_evacuated", "routed",
                              "host_last_resort")}})
    f.close()
elif mode == "flaky":
    f = fleet("breaker", f"seed=3;device.flaky@p=1:depth={cfg['flaky_depth']}",
              stall_s=cfg["breaker_stall_s"], breaker_k=1)
    job = f.submit(cfg["flaky"])
    first = job.pool_job
    need(job.device == 0 and first.chaos.get("freeze_at_depth") == cfg["flaky_depth"],
         f"flaky: routed to {job.device} with {first.chaos}")
    need(job.wait(timeout=900), "flaky: timeout")
    jl = exact(job, cfg["flaky_pins"])
    g = f.gauges()
    need(job.device == 1 and len(job.migrations) == 1, f"flaky: {job.device} {job.migrations}")
    need(job.pool_job.engine == "xla" and not job.pool_job.degraded, "flaky: degraded")
    need(first.wedges == 1 and first.attempts[0]["wedged"], f"flaky: {first.attempts}")
    need((g["devices"]["device-0"]["breaker"]["state"], g["devices"]["device-1"]["breaker"]["state"])
         == ("open", "closed"), "flaky: breakers")
    need((g["host_last_resort"], g["device_flakes"], g["migrations"]) == (0, 1, 1), f"flaky: {g}")
    opened = when("device-0 breaker open")
    out({"item": "flaky", "job": jl, "first_attempt": worker(first), "hop": job.migrations[0],
         "open_devices": g["breaker"]["open_devices"],
         "breaker_open_after_submit_s": opened[0] - job.created_unix_ts if opened else None,
         "open_to_migrated_s": job.migrations[0]["unix_ts"] - opened[0] if opened else None,
         **{k: g[k] for k in ("host_last_resort", "device_flakes", "migrations",
                              "wedge_verdicts", "degraded_jobs")}})
    f.close()
import torch
mods = sorted(m for m in sys.modules if m.startswith("stateright_tpu_torch")
              and m.rsplit(".", 1)[-1] in ("xla", "graphs", "_cuda", "xla_mux"))
out({"item": "fleet_process", "cuda_initialized": torch.cuda.is_initialized(),
     "kernel_modules": mods, "wall_s": time.time() - T0})
"""


def fleet_boot(mode: str, cfg: dict, timeout: float = 900.0) -> dict:
    """Runs one ``FLEET_BOOT`` fleet process to its end: its items by name."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-c", FLEET_BOOT, mode, json.dumps(cfg)],
                          cwd=root, capture_output=True, text=True, timeout=timeout)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    require(proc.returncode == 0 and not any("fleet_error" in ln for ln in lines),
            f"fleet {mode}: exit {proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-5000:]}")
    items = {ln["item"]: ln for ln in lines}
    require(items["fleet_process"]["cuda_initialized"] is False
            and not items["fleet_process"]["kernel_modules"],
            f"fleet {mode}: the fleet process touched CUDA: {items['fleet_process']}")
    return items


def kill_named(path: str) -> int:
    """SIGKILLs every other process whose command line names ``path`` (the
    harness's serve processes and their workers). Returns how many."""
    killed = 0
    for proc in glob.glob("/proc/[0-9]*/cmdline"):
        pid = int(proc.split("/")[2])
        try:
            with open(proc, "rb") as fh:
                named = path.encode() in fh.read()
            if named and pid != os.getpid():
                os.kill(pid, 9)
                killed += 1
        except OSError:
            continue
    return killed


def worker_launches(run_dir: str) -> dict:
    """The sorted set's kernels launched by the finished workers under
    ``run_dir`` (each job's ``result.json``: its final attempt)."""
    total = dict.fromkeys(PATH_KERNELS["sorted"], 0)
    for path in glob.glob(os.path.join(run_dir, "**", "result.json"), recursive=True):
        with open(path) as fh:
            launches = json.load(fh).get("launches") or {}
        for k in total:
            total[k] += launches.get(k, 0)
    return total


def fleet_restart(config: dict, run_dir: str, root: str) -> dict:
    """A two-pool fleet in the harness's serve process, SIGKILLed at the
    first committed block of either ``2pc:8`` job, restarted over its run
    dir with the same idempotency keys: the orphans killed by journaled
    pid, the routes replayed onto the same pools, one ``completed`` record
    a job, exact counts."""
    from stateright_tpu_torch.tools import service_chaos as sc

    rd = os.path.join(run_dir, "restart")
    os.makedirs(rd)
    schedule = {"seed": 0, "jobs": [{"idem": f"fleet-restart-{i}", "spec": config["big"],
                                     "delay_s": 0.0, "max_seconds": 900.0} for i in range(2)]}
    sp = os.path.join(rd, "schedule.json")
    with open(sp, "w") as fh:
        json.dump(schedule, fh)
    argv = [sys.executable, "-m", sc.MODULE, "--serve", "--run-dir", rd, "--schedule", sp,
            "--max-inflight", "2", "--wait-s", "900", "--fleet", "2",
            "--platform", config["platform"]]
    t0 = time.time()
    with open(os.path.join(rd, "first.out"), "w") as log:
        first = subprocess.Popen(argv, cwd=root, stdout=log, stderr=subprocess.STDOUT,
                                 start_new_session=True)
    deadline = time.monotonic() + 600
    beat = None
    while time.monotonic() < deadline and first.poll() is None and beat is None:
        # A job's first committed block: its first valid rotation.
        for ck in glob.glob(os.path.join(rd, "device-*", "svc-*", "job-*", "ck.npz")):
            if latest_valid_checkpoint(ck) is not None:
                b = heartbeat.read(os.path.join(os.path.dirname(ck), "hb.json")) or {}
                beat = dict(b, path=os.path.relpath(ck, rd))
        time.sleep(0.2)
    alive = first.poll() is None
    try:
        os.killpg(first.pid, 9)
    except OSError:
        pass
    first.wait(timeout=60)
    killed_at = time.time() - t0
    require(alive and beat is not None, f"fleet restart: no committed block ({beat})")
    routed = [(r["job"], r["device"], r["pool_job"]) for r in sc.fleet_journal(rd)
              if r["event"] == "routed"]
    pids = [r["pid"] for r in sc.journal_history(rd) if r["event"] == "started" and r.get("pid")]
    t1 = time.time()
    rc = sc.run_incarnation(rd, sp, max_inflight=2, wait_s=900.0, fleet=2,
                            platform=config["platform"])
    require(rc == 0, f"fleet restart: the restarted fleet exited {rc}")
    restart_wall = time.time() - t1
    inv = sc.check_invariant(rd, schedule, None)
    require(inv["ok"], f"fleet restart: {inv['problems']}")
    with open(os.path.join(rd, "driver_results.json")) as fh:
        results = json.load(fh)
    counts = [(j["result"]["generated"], j["result"]["unique"]) for j in results["jobs"].values()]
    require(counts == [tuple(config["big_pins"])] * 2, f"fleet restart: counts {counts}")
    require(results["cuda_initialized"] is False, "fleet restart: the fleet process touched CUDA")
    require(len(routed) == 2 and {d for _, d, _ in routed} == {0, 1}, f"fleet restart: {routed}")
    fleet_events = sc.fleet_journal(rd)
    after = [(r["job"], r["device"], r["pool_job"]) for r in fleet_events if r["event"] == "routed"]
    require(after == routed and not any(r["event"] == "migrated" for r in fleet_events),
            f"fleet restart: routes {routed} -> {after}")
    recovered = [r for r in fleet_events if r["event"] == "recovered"]
    require(recovered and recovered[-1]["attached"] == 2, f"fleet restart: {recovered}")
    pool_recovery = [{k: r.get(k) for k in ("_device", "jobs_requeued", "orphans_killed",
                                            "records_replayed")}
                     for r in sc.journal_history(rd) if r["event"] == "recovered"]
    survivors = [p for p in pids if os.path.exists(f"/proc/{p}")
                 and open(f"/proc/{p}/stat").read().split()[2] != "Z"]
    require(not survivors, f"fleet restart: orphaned workers {survivors} survived")
    start_depths = []
    for path in sorted(glob.glob(os.path.join(rd, "device-*", "svc-*", "job-*", "result.json"))):
        with open(path) as fh:
            start_depths.append(json.load(fh)["start_depth"])
    return {"killed_after_s": killed_at, "killed_at": beat, "routes": routed,
            "start_depths": start_depths,
            "orphan_pids": pids, "pool_recovery": pool_recovery,
            "fleet_recovery": {k: recovered[-1].get(k) for k in
                               ("records_replayed", "routes_recovered", "attached", "orphaned")},
            "restart_wall_s": restart_wall, "completed_done": len(routed),
            "turnaround_s": sc.slo_stats(rd)["turnaround_s"], "launches": worker_launches(rd)}


def fleet_chaos(config: dict, run_dir: str, root: str, scenario: str) -> dict:
    """The chaos harness at ``--fleet 2``, one command line for
    ``scenario`` (the baseline first, as the harness runs it): both
    ``ok``."""
    from stateright_tpu_torch.tools import service_chaos as sc

    base = os.path.join(run_dir, f"chaos-{scenario}")
    line_path = base + ".json"
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", sc.MODULE, "--platform", config["platform"], "--fleet", "2",
         "--seed", str(config["chaos_seed"]), "--jobs", str(config["chaos_jobs"]),
         "--scenario", scenario, "--base-dir", base, "--out", line_path],
        cwd=root, capture_output=True, text=True, timeout=900)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    line = json.loads(lines[-1]) if lines else {}
    require(proc.returncode == 0 and line.get("ok") is True,
            f"fleet chaos {scenario}: exit {proc.returncode} {line.get('scenarios')}\n"
            f"{proc.stderr[-4000:]}")
    reps = line["scenarios"]
    require(list(reps) == ["baseline", scenario], f"fleet chaos: {list(reps)}")
    if scenario == "device_lost":
        require(reps[scenario]["fleet"]["migrations"] >= 1, "fleet chaos: no migration")
    return {
        "wall_s": time.time() - t0, "specs": line["specs"],
        **{name: {k: rep.get(k) for k in ("ok", "problems", "faults", "restarts", "elapsed_s",
                                          "turnaround_s", "admission_latency_ms", "journal")}
                  | {"migrations": rep["fleet"]["migrations"],
                     "per_device": rep["fleet"]["per_device"]}
           for name, rep in reps.items()},
        "launches": worker_launches(base),
    }


def fleet_phase(config: dict = FLEET_CARD) -> dict:
    """The checker service's fleet on the card (``FleetService``, two pools
    of one card, ``pin_devices=True``): a lost device's ``2pc:8`` job
    resumed on the other pool from its own rotation beside an untouched
    sibling; a fleet SIGKILLed and restarted into one completion a job; the
    chaos harness's ``device_lost`` and ``kill`` scenarios; a flaky pool's
    wedge migrated, not degraded. The fleet processes never touch CUDA.
    Returns the launches by path. A config with ``platform="cpu"``
    rehearses the phase on the CPU (no launches)."""
    t0 = time.perf_counter()
    on_card = config["platform"] != "cpu"
    run_dir = os.path.join(CKPT_DIR, "fleet")
    os.makedirs(run_dir)
    cfg = dict(config, run_dir=run_dir)
    root = os.path.dirname(os.path.abspath(__file__))
    def timed_failover():
        items = fleet_boot("failover", cfg)
        return items["failover"], time.perf_counter() - t0

    try:
        # Side by side, each of the harness's scenarios in a command line
        # of its own; the failover's loss waits for its victim's first
        # rotation, however slow the start.
        with ThreadPoolExecutor(3 + len(config["chaos_scenarios"])) as ex:
            failover_f = ex.submit(timed_failover)
            restart_f = ex.submit(fleet_restart, config, run_dir, root)
            flaky_f = ex.submit(fleet_boot, "flaky", cfg)
            chaos_f = {name: ex.submit(fleet_chaos, config, run_dir, root, name)
                       for name in config["chaos_scenarios"]}
            failover, failover_wall = failover_f.result()
            restart, flaky = restart_f.result(), flaky_f.result()["flaky"]
            chaos = {name: f.result() for name, f in chaos_f.items()}
    finally:
        # A failed check must leave no fleet, serve process or worker running.
        kill_service_workers(run_dir)
        kill_named(run_dir)
    models = {spec: resolve_spec(spec)[0] for spec in (config["big"], config["flaky"])}
    service_jobs_checked([[failover["victim"], failover["sibling"]], [flaky["job"]]], models)
    n_cards = torch.cuda.device_count() if on_card else 0
    for w in (failover["victim"], failover["sibling"], flaky["job"]):
        ordinal = int(w["pool"].rsplit("-", 1)[1])
        require(w["device_ordinal"] == ordinal, f"fleet: {w['pool']} ran --device {w['device_ordinal']}")
        if on_card:
            # An ordinal the machine lacks falls back to the default card,
            # with no label (the reference's fallback).
            want = f"cuda:{ordinal}" if ordinal < n_cards else None
            require(w["device_label"] == want, f"fleet: {w['pool']} label {w['device_label']}")
    launches = {
        "fleet_failover": path_launches([failover["victim"], failover["sibling"]]),
        "fleet_restart": restart["launches"],
        "fleet_chaos": {k: sum(s["launches"][k] for s in chaos.values())
                        for k in PATH_KERNELS["sorted"]},
        "fleet_breaker": path_launches([flaky["job"]]),
    }
    for path, counts in launches.items():
        require(all(n > 0 for n in counts.values()) or not on_card, f"fleet: {path} launched {counts}")

    def brief(w):
        return {k: w[k] for k in ("pool", "pool_job", "device_ordinal", "device_label", "torch_device",
                                  "generated", "unique", "max_depth", "start_depth", "first_dispatch_s",
                                  "worker_seconds", "captures", "capture_s", "peak_memory_bytes",
                                  "launches", "attempts", "engine", "platform") if k in w} | (
            {"wall_s": w["wall_s"], "migrations": w["migrations"]} if "wall_s" in w else {})

    manifest = trace_bundle.bundle(run_dir, run_dir + "-bundle", lint_path=None)
    require(bool(manifest["journals"]), f"fleet: the trace bundle holds no journal: {manifest}")
    emit({"phase": "fleet", "wall_s": time.perf_counter() - t0,
          "trace_bundle": trace_bundle.counts(manifest),
          "failover_wall_s": failover_wall, "cards": n_cards,
          "fleet_failover_rm8": {
              "victim": brief(failover["victim"]), "sibling": brief(failover["sibling"]),
              "victim_first": failover["victim_first"],
              "lost_device": failover["lost_device"],
              "hop": {k: failover["hop"][k] for k in ("from", "to", "reason", "requeues", "seed")},
              **{k: failover[k] for k in ("lost_after_submit_s", "loss_to_resumed_dispatch_s",
                                          "loss_to_migrated_s", "migrations", "devices_lost",
                                          "jobs_evacuated", "routed", "host_last_resort")}},
          "fleet_restart_rm8": restart,
          "fleet_chaos": chaos,
          "fleet_breaker": {"job": brief(flaky["job"]), "first_attempt": brief(flaky["first_attempt"]),
                            "hop": {k: flaky["hop"][k] for k in ("from", "to", "reason")},
                            **{k: flaky[k] for k in ("open_devices", "breaker_open_after_submit_s",
                                                     "open_to_migrated_s", "host_last_resort",
                                                     "device_flakes", "migrations", "wedge_verdicts",
                                                     "degraded_jobs")}},
          "launches": launches})
    return launches


def service_and_fleet_phases():
    """``service``, and ``fleet`` beside the service's items 4-6 once its
    items 1-3 (whose walls are the phase's measurements, and whose wedge
    verdict has a one-second margin) are done. Returns both phases'
    launches by path."""
    marker = os.path.join(CKPT_DIR, "service", "items-1-3.done")
    service_over = threading.Event()

    def fleet_after_items_1_3():
        while not (os.path.exists(marker) or service_over.is_set()):
            time.sleep(0.5)
        # A service that failed before its items 1-3 ended starts no fleet.
        return fleet_phase() if os.path.exists(marker) else None

    with ThreadPoolExecutor(1) as ex:
        fleet_f = ex.submit(fleet_after_items_1_3)
        try:
            service_launches = service_phase()
        finally:
            service_over.set()
        return service_launches, fleet_f.result()


def obs_paths(tag: str) -> dict:
    """Files of one observed run under the phase's temporary directory."""
    d = os.path.join(CKPT_DIR, "obs")
    return {k: os.path.join(d, f"{tag}.{k}") for k in ("trace", "hb", "series", "chrome")}


def obs_kwargs(paths: dict) -> dict:
    """Every observability knob of ``spawn_xla`` on, into ``paths``."""
    return dict(trace=paths["trace"], heartbeat=paths["hb"], metrics_to=paths["series"],
                metrics_every=1, phases=True)


def obs_audit(c, paths: dict, what: str) -> dict:
    """An observed run's trace, heartbeat and series against its own logs:
    one ``dispatch`` span a dispatch with its bucket and committed levels,
    four phase spans each, as many ``grow_table`` and ``delta_flush``
    spans as the counters, the heartbeat's ``seq`` the dispatches, the
    series' last row the final counts; the Chrome export, and an
    OpenMetrics render of the final snapshot parsed back. Returns the span
    counts and the widest block's phase split."""
    with open(paths["trace"]) as fh:
        spans = [json.loads(line) for line in fh]
    names = collections.Counter(r["name"] for r in spans)
    disp = [r for r in spans if r["name"] == "dispatch"]
    m = c.metrics()
    require([(r["attrs"]["bucket"], r["attrs"]["committed"]) for r in disp]
            == [tuple(d) for d in c.dispatch_log], f"{what}: dispatch spans against dispatch_log")
    require(len(c.phase_log) == len(disp), f"{what}: phase_log {len(c.phase_log)}")
    require(all(names[f"phase:{p}"] == len(disp) for p in XlaChecker.PHASE_NAMES),
            f"{what}: phase spans {dict(names)}")
    require(names["grow_table"] == m["table_grows"] and names["delta_flush"] == m["delta_flushes"],
            f"{what}: growth and flush spans {dict(names)}")
    beat = heartbeat.read(paths["hb"])
    require(beat["seq"] == len(c.dispatch_log) and beat["phase"] == "idle"
            and beat["states"] == c.state_count(), f"{what}: heartbeat {beat}")
    rows = obs.read_series(paths["series"])
    require(rows and [r["seq"] for r in rows] == list(range(len(rows)))
            and rows[-1]["metrics"]["state_count"] == c.state_count(),
            f"{what}: series of {len(rows)} rows")
    widest = max(range(len(disp)), key=lambda i: (c.phase_log[i]["bucket"],
                                                   c.phase_log[i]["committed"]))
    split = {p: c.phase_log[widest][p] for p in XlaChecker.PHASE_NAMES}
    require(sum(split.values()) <= disp[widest]["dur"] + 1e-5, f"{what}: phases {split}")
    events = obs.export_chrome(paths["trace"], paths["chrome"])
    with open(paths["chrome"]) as fh:
        require(len(json.load(fh)["traceEvents"]) == events == len(spans) - 1,
                f"{what}: Chrome events {events}")
    parsed = promexport.parse_openmetrics(
        promexport.render_openmetrics(promexport.engine_samples(m)))
    labels = frozenset({"engine": "xla", "dedup": m["dedup"]}.items())
    require(parsed[("stpu_state_count_total", labels)] == c.state_count(),
            f"{what}: OpenMetrics state count")
    return {"spans": dict(names), "heartbeat_seq": beat["seq"], "series_rows": len(rows),
            "widest_block": {"bucket": c.phase_log[widest]["bucket"],
                             "committed": c.phase_log[widest]["committed"],
                             "dispatch_s": disp[widest]["dur"], **split},
            "phase_totals_s": {p: sum(r[p] for r in c.phase_log) for p in XlaChecker.PHASE_NAMES},
            "chrome_events": events, "openmetrics_samples": len(parsed)}


def obs_phase() -> dict:
    """rm=8 on a fresh model instance: cold with observability off, then
    warm off, on, off, on (each exact, no warm capture; the off runs hold
    ``NULL_TRACER``, no heartbeat, no recorder and no phase rows, and equal
    the on runs level by level and block by block), each observed run
    audited by :func:`obs_audit`; then one observed run under
    ``dedup="hash"``."""
    model = PackedTwoPhaseSys(8)
    cold, cold_wall, cold_launches = drive(model)
    require((cold.state_count(), cold.unique_state_count()) == EXPECTED_2PC[8], "obs: cold counts")
    walls = {"off": [], "on": []}
    audits, runs = [], []
    launches = {"obs_rm8": dict(cold_launches)}
    os.makedirs(os.path.dirname(obs_paths("")["trace"]), exist_ok=True)
    for i, mode in enumerate(("off", "on", "off", "on")):
        paths = obs_paths(f"rm8_warm{i}")
        files = set(os.listdir(os.path.dirname(paths["trace"])))
        c, wall, ran = drive(model, **(obs_kwargs(paths) if mode == "on" else {}))
        what = f"obs warm {i} ({mode})"
        require((c.state_count(), c.unique_state_count()) == EXPECTED_2PC[8], f"{what}: counts")
        require(c.metrics()["graph_captures"] == 0, f"{what}: captured graphs")
        for k, v in ran.items():
            launches["obs_rm8"][k] += v
        if mode == "off":
            require(c._tracer is obs.NULL_TRACER and c._heartbeat is None and c._recorder is None
                    and not c.phase_log
                    and set(os.listdir(os.path.dirname(paths["trace"]))) == files,
                    f"{what}: observability off")
        else:
            audits.append(obs_audit(c, paths, what))
        walls[mode].append(wall)
        runs.append(c)
    require(all(c.level_log == runs[0].level_log and c.dispatch_log == runs[0].dispatch_log
                for c in runs), "obs: warm runs with and without observability differ")
    audited(runs[-1], "obs")
    paths = obs_paths("rm8_hash")
    h, hash_wall, hash_launches = drive(model, dedup="hash", **obs_kwargs(paths))
    require((h.state_count(), h.unique_state_count()) == EXPECTED_2PC[8], "obs hash: counts")
    hash_line = dedup_line(h, hash_wall, hash_launches, "hash", "obs hash")
    launches["obs_rm8_hash"] = hash_launches
    emit({"phase": "obs", "cold_wall_s": cold_wall, "warm_off_s": walls["off"],
          "warm_on_s": walls["on"], "dispatches": len(runs[0].dispatch_log),
          "levels": len(runs[0].level_log), "audits": audits,
          "hash": {**hash_line, "audit_obs": obs_audit(h, paths, "obs hash")}})
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
        cold_peak_reserved = torch.cuda.max_memory_reserved() / 2**30
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
        WITNESS[f"rm9_{dedup}"] = witness_times(warm, f"rm=9 {dedup}")
        line["peak_mem_gib"] = cold_peak
        line["peak_reserved_gib"] = cold_peak_reserved
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
    timing = merge_timing(table, batch, check["n_keep"])
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


# --- the Explorer and the multiplexed engine ------------------------------------

#: Clicks of the ``explorer`` phase's path below 2pc rm=8's init state.
EXPLORER_CLICKS = 12
#: Seconds a request of the ``explorer`` phase may take (a click, or a poll
#: while the drive thread runs a block that captures graphs).
HTTP_TIMEOUT_S = 300


def http_request(port: int, path: str, method: str = "GET"):
    """``(body bytes, seconds)`` of one request to ``127.0.0.1:port``."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method)
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as resp:
        body = resp.read()
    return body, time.perf_counter() - t0


def http_json(port: int, path: str, method: str = "GET"):
    body, secs = http_request(port, path, method)
    return json.loads(body), secs


def as_json(obj):
    """``obj`` as a JSON round trip gives it back (tuples become lists)."""
    return json.loads(json.dumps(obj))


def click_splits(trace: str, epoch: float, windows) -> list:
    """For each click's request window (monotonic ``(start, end)``), the
    dispatch spans the checker traced inside it (its eager levels,
    overflow retries included): their count, milliseconds and the four
    phases' milliseconds."""
    with open(trace) as fh:
        spans = [json.loads(line) for line in fh]
    phases = collections.defaultdict(dict)
    for sp in spans:
        if sp["name"].startswith("phase:"):
            phases[sp.get("parent_id")][sp["name"][len("phase:"):]] = sp["dur"] * 1e3
    out = []
    for start, end in windows:
        inside = [sp for sp in spans if sp["name"] == "dispatch"
                  and start - epoch <= sp["ts"] and sp["ts"] + sp["dur"] <= end - epoch]
        split = collections.Counter()
        for sp in inside:
            split.update(phases.get(sp["span_id"], {}))
        out.append({"levels": len(inside), "level_ms": sum(sp["dur"] for sp in inside) * 1e3,
                    "phases_ms": dict(split)})
    return out


def explorer_run(dedup: str, trace: str = None) -> dict:
    """2pc rm=8 through a live Explorer on the card (``make_app(
    PackedTwoPhaseSys(8).checker(), dedup=dedup)``, the GPU backend): the
    init states and a path of ``EXPLORER_CLICKS`` clicks through
    ``/.states``, each click's views and the counts equal to the port's host
    Explorer on ``TwoPhaseSys(8)`` (fingerprints and encoded discovery paths
    too); then ``POST /.runtocompletion``, polled to done: the pinned
    counts, every discovery re-executed, a clean audit, ``/.metrics``
    parsed back equal to ``metrics()``. Launch counters set to 0 before the
    app is built, read after the clicks and at the end. With ``trace`` (a
    span file), the checker traces its dispatches with the phase split, and
    each click's levels are read back from it (:func:`click_splits`)."""
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    traced = {"trace": trace, "phases": True} if trace else {}
    app, checker = make_app(PackedTwoPhaseSys(8).checker(), dedup=dedup, **traced)
    host_app, host = make_app(TwoPhaseSys(8).checker())
    build_s = time.perf_counter() - t0
    # Served as ``serve`` serves it (its server loop, drive and re-arm
    # threads). Requests come from this thread, which does no CUDA work
    # while the server runs: every checker call is the app's, under its
    # lock, in the handler and drive threads.
    server, stop, threads = explorer.start(app, ("127.0.0.1", 0))
    port = server.server_address[1]
    clicks, windows = [], []
    try:
        body, init_s = http_json(port, "/.states/")
        require(body == as_json(host_app.states("/")[1]), f"explorer {dedup}: init views")
        path = ""
        for i in range(EXPLORER_CLICKS):
            with_state = [v for v in body if "fingerprint" in v]
            path += "/" + with_state[(3 * i + 1) % len(with_state)]["fingerprint"]
            start = time.monotonic()
            body, secs = http_json(port, "/.states" + path)
            windows.append((start, time.monotonic()))
            code, want = host_app.states(path)
            require(code == 200 and body == as_json(want), f"explorer {dedup}: click {i} views")
            status, _ = http_json(port, "/.status")
            want_status = host_app.status()
            for key in ("state_count", "unique_state_count", "max_depth", "done"):
                require(status[key] == want_status[key], f"explorer {dedup}: click {i} {key}")
            require(as_json(status["properties"]) == as_json(want_status["properties"]),
                    f"explorer {dedup}: click {i} properties")
            clicks.append({"ms": secs * 1e3, "views": len(body), "state_count": status["state_count"],
                           "unique": status["unique_state_count"],
                           "pending_pool": status["metrics"]["pending_pool"]})
        click_launches = launches_now(dedup)
        click_levels = [dict(r) for r in checker.level_log]
        click_table = status["metrics"]["table_capacity"]
        t1 = time.perf_counter()
        http_request(port, "/.runtocompletion", "POST")
        while True:
            status, _ = http_json(port, "/.status")
            if status["done"]:
                break
            require(time.perf_counter() - t1 < HTTP_TIMEOUT_S, f"explorer {dedup}: run to completion")
            require(threads[1].is_alive(), f"explorer {dedup}: the drive thread died")
            time.sleep(0.02)
        rtc_wall = time.perf_counter() - t1
        text, _ = http_request(port, "/.metrics")
    finally:
        stop()
    torch.cuda.synchronize()
    launches = launches_now(dedup)
    counts = (checker.state_count(), checker.unique_state_count())
    require(counts == EXPECTED_2PC[8], f"explorer {dedup}: counts {counts}")
    require((status["state_count"], status["unique_state_count"]) == counts,
            f"explorer {dedup}: /.status counts")
    # A click is one eager level: its hash insert is not gated, so not undone.
    require(all(n > 0 for k, n in click_launches.items() if k != "hashset_undo"),
            f"explorer {dedup}: click launches {click_launches}")
    require(all(n > 0 for n in launches.values()), f"explorer {dedup}: launches {launches}")
    found = checker.discoveries()
    checker.assert_properties()
    for name, p in found.items():
        checker.assert_discovery(name, p.into_actions())
    m = checker.metrics()
    parsed = promexport.parse_openmetrics(text.decode())
    scraped = {}
    for key in ("state_count", "unique_state_count", "dispatches", "table_grows", "graph_captures"):
        name = f"stpu_{key}_total" if key in promexport.COUNTER_KEYS else f"stpu_{key}"
        scraped[key] = [v for (n, labels), v in parsed.items()
                        if n == name and ("job", "interactive") in labels]
        require(scraped[key] == [m[key]], f"explorer {dedup}: /.metrics {key} {scraped[key]}")
    if trace:
        for click, split in zip(clicks, click_splits(trace, checker._tracer._epoch, windows)):
            click.update(split)
    ms = [c["ms"] for c in clicks]
    return {
        "traced": bool(trace),
        "dedup": dedup, "clicks": clicks, "click_ms": {"min": min(ms), "median": float(np.median(ms)),
                                                         "max": max(ms)},
        "init_views_s": init_s, "build_s": build_s, "click_levels": click_levels,
        "click_table_capacity": click_table, "run_to_completion_wall_s": rtc_wall,
        "generated": counts[0], "unique": counts[1], "max_depth": checker.max_depth(),
        "dispatches": m["dispatches"], "graph_captures": m["graph_captures"],
        "capture_s": m["graph_capture_s"], "table_capacity": m["table_capacity"],
        "discoveries": {k: len(p) for k, p in found.items()}, "metrics_scraped": scraped,
        "launches_clicks": click_launches, "launches": launches,
        "audit": audited(checker, f"explorer {dedup}"),
    }


def click_kernel_phase(runs: dict, rng) -> dict:
    """The kernels against their plain versions, exactly, at a click's
    shapes (the click level of the ``explorer`` runs that generated the
    most: its grid compaction at its bucket and candidate cap, its frontier
    compaction, its candidates merged into the click-time table, the hash
    insert of them and its undo) 20 times each, and timed: a click is one
    eager level over a handful of rows against the whole visited set."""
    sorted_run = runs["sorted"]
    top = max(sorted_run["click_levels"], key=lambda r: r["generated"])
    a = PackedTwoPhaseSys(8).max_actions
    f, cap, c_table = top["bucket"], top["cand_cap"], sorted_run["click_table_capacity"]
    n_table = sorted_run["clicks"][-1]["unique"]
    grid = check_compact("click_grid", *_grid_case(rng, f, a, top["generated"] / (f * a), cap),
                         reps=20)
    frontier = check_compact("click_frontier", *_frontier_case(rng, top), reps=20)
    mask, lanes, _ = _grid_case(rng, f, a, top["generated"] / (f * a), cap)
    compact_t = time_compact(mask, lanes, cap, grid["n_valid"], 2, 3 * f * 8)
    # The click's candidate buffer: ``generated`` rows, half hits on table
    # keys and half fresh keys with in-batch duplicates, the rest pads.
    share = top["generated"] / cap / 2
    table, batch = _merge_case(rng, c_table, n_table, cap, hit=share, new=share)
    merge = check_merge("click", table, batch, reps=20)
    merge_t = merge_timing(table, batch, merge["n_keep"])
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(2**31)))
    hs = hashset.make(runs["hash"]["click_table_capacity"], "cuda")
    keys = torch.randint(1, 2**62, (runs["hash"]["clicks"][-1]["unique"],), dtype=DTYPE,
                         device="cuda", generator=gen)
    hashset.insert_(hs, *_lanes_of(keys, gen))
    hlanes = _batch_lanes(gen, cap, top["generated"], 0.4, keys)
    hash_case = check_hash("click", hs, hlanes, reps=20)
    # The undo of such an insert (a gated level not committed), against the
    # plain undo: back to the table as it was.
    undone = _hash_copy(hs)
    _, _, filled = hashset.insert_(undone, *hlanes)
    want = _hash_copy(undone)
    drop = torch.zeros((), dtype=torch.bool, device="cuda")
    hashset.undo_plain(want, filled, drop)
    hashset.undo_(undone, filled, drop)
    undo_err = int((undone.slots != want.slots).sum()) + int((undone.slots != hs.slots).sum())
    require(undo_err == 0, "click: the undo left the table other than it was")
    del undone, want, filled
    hash_t = hash_timing(hs, hlanes, plain=True)
    out = {
        "shape": {"bucket": f, "actions": a, "cand_cap": cap, "generated": top["generated"],
                  "table_capacity": c_table, "table_rows": n_table},
        "compact": {**grid, **{k: v for k, v in compact_t.items() if k != "device_ops"},
                    "frontier": frontier},
        "merge_insert": {**merge, **{k: v for k, v in merge_t.items() if k != "device_ops"}},
        "hashset_insert": {**hash_case, **hash_t["insert"]},
        "hashset_undo": {**hash_t["undo"], "max_abs_err": undo_err},
    }
    emit({"phase": "click_kernels", **out})
    return out


def explorer_phase(rng):
    """The ``explorer`` phase under the sorted and the hash set, then the
    kernels at a click's shapes; returns the launches by path and the
    kernel lines."""
    runs = {}
    for dedup in ("sorted", "hash"):
        # The sorted run traces its clicks' levels (the run to completion
        # pays the tracer's few spans a block too).
        trace = os.path.join(CKPT_DIR, "explorer.trace.jsonl") if dedup == "sorted" else None
        runs[dedup] = explorer_run(dedup, trace)
        emit({"phase": f"explorer_{dedup}", **runs[dedup]})
        gc.collect()
        torch.cuda.empty_cache()
    kernels = click_kernel_phase(runs, rng)
    launches = {"explorer_rm8_clicks": runs["sorted"]["launches_clicks"],
                "explorer_rm8": runs["sorted"]["launches"],
                "explorer_rm8_hash_clicks": runs["hash"]["launches_clicks"],
                "explorer_rm8_hash": runs["hash"]["launches"]}
    # The whole runs include their clicks: by path, the clicks and the rest.
    for tag in ("explorer_rm8", "explorer_rm8_hash"):
        clicks = launches[f"{tag}_clicks"]
        launches[tag] = {k: v - clicks[k] for k, v in launches[tag].items()}
        launches[f"{tag}_run_to_completion"] = launches.pop(tag)
    return launches, kernels


def lane_view(c) -> tuple:
    """Counts, depth, each level's counts and the discoveries' actions."""
    return (c.state_count(), c.unique_state_count(), c.max_depth(),
            [(r["depth"], r["frontier"], r["generated"], r["unique"]) for r in c.level_log],
            {n: p.into_actions() for n, p in c.discoveries().items()})


def same_as_solo(lane, solo, what: str) -> None:
    """A lane equal to its solo run: :func:`lane_view`, and the visited set:
    the sorted set's planes bit for bit, the hash set's (key, parent)
    pairs (the kernel may place contending keys in other slots)."""
    require(lane_view(lane) == lane_view(solo), f"{what}: lane vs solo")
    if lane._dedup == "sorted":
        cap = min(lane._table.capacity, solo._table.capacity)
        require(all(torch.equal(a[:cap], b[:cap]) for a, b in zip(
            lane._table[:lane._table.PLANES], solo._table[:solo._table.PLANES])),
            f"{what}: sorted planes")
    else:
        require(torch.equal(_table_pairs(lane._table), _table_pairs(solo._table)),
                f"{what}: hash pairs")


def mux_drive(lanes):
    """One ``MuxChecker(lanes).run_to_completion()`` timed on the host
    clock, launch counters zeroed just before and read just after."""
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    mux = MuxChecker(lanes)
    mux.run_to_completion()
    torch.cuda.synchronize()
    return mux, time.perf_counter() - t0, launches_now(lanes[0]._dedup)


def mux_line(mux, wall: float, launches: dict, what: str) -> dict:
    m = mux.metrics()
    require(all(n > 0 for n in launches.values()), f"{what}: kernel launches {launches}")
    require(m["mux_lanes_active"] == 0, f"{what}: lanes left running")
    return {"lanes": mux.k, "wall_s": wall, "dispatches": m["dispatches"],
            "dispatch_log": mux.dispatch_log, "levels_committed": m["levels_committed"],
            "dispatches_saved": m["mux_dispatches_saved"], "graph_captures": m["graph_captures"],
            "capture_s": m["graph_capture_s"], "launches": launches,
            "generated": [ln.state_count() for ln in mux.lanes],
            "unique": [ln.unique_state_count() for ln in mux.lanes]}


def mux_phase() -> dict:
    """The multiplexed engine on the card (``xla_mux.MuxChecker``), every
    lane equal to its solo run on the card: K = 1, 3 and 8 lanes of 2pc
    rm=4 under the sorted and the hash set (K = 8 in at most a third of 8
    solo runs' dispatches), stragglers (depth- and state-count-capped lanes
    beside an uncapped one), K = 3 lanes of Paxos 2c/3s and K = 2 lanes of
    2pc rm=8 (each exact, with the peak memory), then warm walls of a K = 8
    run against 8 warm solo runs of rm=4, in turns. Returns the launches by
    path."""
    out, launches = {}, {}
    for dedup in ("sorted", "hash"):
        model = PackedTwoPhaseSys(4)
        solos = [model.checker().spawn_xla(dedup=dedup).join() for _ in range(8)]
        solo = solos[-1]
        require((solo.state_count(), solo.unique_state_count()) == EXPECTED_2PC[4],
                f"mux: rm=4 {dedup} solo counts")
        solo_dispatches = sum(len(c.dispatch_log) for c in solos)
        lines = {}
        for k in (1, 3, 8):
            lanes = [model.checker().spawn_xla(dedup=dedup) for _ in range(k)]
            mux, wall, got = mux_drive(lanes)
            for i, ln in enumerate(lanes):
                same_as_solo(ln, solo, f"mux rm=4 {dedup} K={k} lane {i}")
                audited(ln, f"mux rm=4 {dedup} K={k} lane {i}")
            lines[k] = mux_line(mux, wall, got, f"mux rm=4 {dedup} K={k}")
            launches[f"mux_rm4_k{k}" + ("_hash" if dedup == "hash" else "")] = got
        require(lines[8]["dispatches"] * 3 <= solo_dispatches,
                f"mux {dedup}: K=8 took {lines[8]['dispatches']} dispatches, 8 solos {solo_dispatches}")
        out[f"rm4_{dedup}"] = {"solo_dispatches_8": solo_dispatches,
                               **{f"k{k}": line for k, line in lines.items()}}
        if dedup == "sorted":
            shapers = [lambda b: b.target_max_depth(4), lambda b: b.target_state_count(500),
                       lambda b: b.target_state_count(1), lambda b: b]
            strag_solos = [sh(model.checker()).spawn_xla().join() for sh in shapers]
            lanes = [sh(model.checker()).spawn_xla() for sh in shapers]
            mux, wall, got = mux_drive(lanes)
            for i, (ln, s) in enumerate(zip(lanes, strag_solos)):
                same_as_solo(ln, s, f"mux stragglers lane {i}")
            require(lanes[0].max_depth() < lanes[3].max_depth()
                    and lanes[2].state_count() < 500 <= lanes[1].state_count(),
                    "mux stragglers stopped early")
            out["stragglers"] = {**mux_line(mux, wall, got, "mux stragglers"),
                                 "max_depth": [ln.max_depth() for ln in lanes],
                                 "lanes_active_by_level": [r["lanes_active"]
                                                           for r in lanes[3].level_log]}
            launches["mux_stragglers"] = got
            emit({"phase": "mux_stragglers", **out["stragglers"]})
            # Warm walls, in turns: 8 solo runs, one K = 8 mux run.
            turns = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                warm_solos = [model.checker().spawn_xla().join() for _ in range(8)]
                torch.cuda.synchronize()
                solo_wall = time.perf_counter() - t0
                lanes = [model.checker().spawn_xla() for _ in range(8)]
                mux, wall, _ = mux_drive(lanes)
                require(all(c.metrics()["graph_captures"] == 0 for c in warm_solos)
                        and mux.metrics()["graph_captures"] == 0, "mux: a warm run captured")
                for ln in lanes:
                    same_as_solo(ln, solo, "mux warm K=8")
                turns.append({"solos_8_wall_s": solo_wall, "mux_k8_wall_s": wall,
                              "solo_dispatches": sum(len(c.dispatch_log) for c in warm_solos),
                              "mux_dispatches": len(mux.dispatch_log)})
            out["warm_rm4_k8"] = turns
        emit({"phase": f"mux_rm4_{dedup}", **out[f"rm4_{dedup}"]})
    # Paxos 2c/3s, three lanes.
    model = PackedPaxos(2, 3)
    solo = model.checker().spawn_xla().join()
    lanes = [model.checker().spawn_xla() for _ in range(3)]
    mux, wall, got = mux_drive(lanes)
    for i, ln in enumerate(lanes):
        require((ln.state_count(), ln.unique_state_count()) == EXPECTED_PAXOS2, f"mux paxos lane {i}")
        same_as_solo(ln, solo, f"mux paxos lane {i}")
        ln.assert_discovery("value chosen", ln.discoveries()["value chosen"].into_actions())
    out["paxos2"] = mux_line(mux, wall, got, "mux paxos")
    launches["mux_paxos2_k3"] = got
    emit({"phase": "mux_paxos2", **out["paxos2"]})
    # 2pc rm=8, two lanes, on a fresh model instance.
    del solo, lanes, mux
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lanes = [PackedTwoPhaseSys(8).checker().spawn_xla()]
    lanes.append(lanes[0].model().checker().spawn_xla())
    mux, wall, got = mux_drive(lanes)
    for i, ln in enumerate(lanes):
        require((ln.state_count(), ln.unique_state_count()) == EXPECTED_2PC[8], f"mux rm=8 lane {i}")
        check_paths(ln)
        audited(ln, f"mux rm=8 lane {i}")
    out["rm8_k2"] = {**mux_line(mux, wall, got, "mux rm=8"),
                     "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "table_capacity": lanes[0].metrics()["table_capacity"]}
    launches["mux_rm8_k2"] = got
    emit({"phase": "mux_rm8", **out["rm8_k2"]})
    emit({"phase": "mux_warm_rm4_k8", "turns": out["warm_rm4_k8"]})
    del lanes, mux
    gc.collect()
    torch.cuda.empty_cache()
    return launches


#: The capacities of the rm=5 run held bitwise against its CPU twin
#: (``tests/test_sharded.py``'s rm=5 case): small enough for the CPU.
SHARD_RM5_CAPS = dict(frontier_capacity=1 << 12, table_capacity=1 << 16)


def keys_in_owners(c) -> list:
    """Each shard's occupied keys, every one of which must be owned by its
    shard (``parallel.owner_bits``); returns the keys a shard."""
    out = []
    for d, t in enumerate(c._tables):
        kh, kl = t.key_hi, t.key_lo
        occ = (kh != 0) | (kl != 0)
        require(bool((owner_bits(kh[occ], kl[occ], c._D) == d).all()),
                f"shard {d} holds a key another shard owns")
        out.append(int(occ.sum()))
    return out


def shard_line(c, wall: float, launches: dict, what: str, expected=None,
               properties: bool = True) -> dict:
    """A sharded run's line: the pins (``expected`` generated and unique),
    every discovery re-executed (and, with ``properties``, every property
    as expected), a clean audit, each key in its owner shard and the
    shards' occupancy (max over mean), dispatches, captures, growths by
    kind, the shapes a shard."""
    m = c.metrics()
    if expected is not None:
        require((c.state_count(), c.unique_state_count()) == tuple(expected[:2]),
                f"{what}: counts {(c.state_count(), c.unique_state_count())}")
    require(all(n > 0 for n in launches.values()), f"{what}: kernel launches {launches}")
    if properties:
        c.assert_properties()
    for name, path in c.discoveries().items():
        c.assert_discovery(name, path.into_actions())
    keys = keys_in_owners(c)
    return {
        "shards": c._D, "dedup": m["dedup"], "wall_s": wall, "generated": c.state_count(),
        "unique": c.unique_state_count(), "max_depth": c.max_depth(),
        "dispatches": m["dispatches"], "levels": m["levels_committed"],
        "dispatch_log": c.dispatch_log, "launches": launches,
        "graph_captures": m["graph_captures"], "capture_s": m["graph_capture_s"],
        "grows": {k: m[k] for k in ("table_grows", "frontier_grows", "route_grows")},
        "delta_flushes": m["delta_flushes"],
        "rows_per_shard": m["frontier_rows_per_shard"], "slots_per_shard": m["table_slots_per_shard"],
        "route_slots": m["route_slots"], "keys_per_shard": keys,
        "occupancy_max_over_mean": max(keys) / (sum(keys) / len(keys)),
        "audit": audited(c, what),
    }


def shard_levels(c) -> list:
    return [(r["depth"], r["frontier"], r["generated"], r["unique"]) for r in c.level_log]


def shard_kernel_inputs(model, depth: int, dedup: str):
    """The kernels' inputs of one level of the sharded engine at D = 8: the
    search of ``model`` (which ran it before, so no graph is captured) to
    ``depth``, then that level run once eagerly with the calls recorded:
    every ``compact`` (each shard's grid, route and frontier compaction)
    and every ``merge_insert`` of the sorted set's insert, or under the
    hash set every shard's insert with the table as it was before it."""
    c = run_to_depth(model, depth, mesh=default_mesh(8), dedup=dedup)
    c._target_max_depth = None
    c._levels_per_dispatch = 1
    calls = {"compact": [], "merge_insert": [], "hash": []}
    real_compact, real_merge, real_insert = sharded_mod.compact, sortedset.merge_insert, c._insert

    def spy_compact(mask, lanes, cap):
        out = real_compact(mask, lanes, cap)
        calls["compact"].append((mask, list(lanes), cap, int(out[1])))
        return out

    def spy_merge(table, batch):
        calls["merge_insert"].append((table.clone(), batch.clone()))
        return real_merge(table, batch)

    def spy_insert(table, *lanes, in_place=False):
        if dedup == "hash":
            calls["hash"].append((hashset.HashSet(table.slots.clone()), [x.clone() for x in lanes]))
        return real_insert(table, *lanes, in_place=in_place)

    sharded_mod.compact, sortedset.merge_insert, c._insert = spy_compact, spy_merge, spy_insert
    try:
        c._run_block()
    finally:
        sharded_mod.compact, sortedset.merge_insert = real_compact, real_merge
    require(c._depth == depth + 1 and c.dispatch_log[-1][1] == 1, "shard kernels: the level")
    return c, calls


def without_ops(line: dict) -> dict:
    return {k: v for k, v in line.items() if k != "device_ops"}


def shard_kernel_phase(model, hash_model, depth: int) -> dict:
    """The kernels against their plain versions at the shapes the sharded
    main path gives them (``shard_kernels``): every call of the widest
    level of rm=8 at D = 8 (by its level-log unique count) held exactly
    against the plain version, and the widest shard's call of each kind
    (grid, route and frontier compaction; the sorted set's merge; the hash
    insert and undo) checked 5 more times and timed."""
    c, calls = shard_kernel_inputs(model, depth, "sorted")
    D, Fl, A, W, K = c._D, c._Fl, c._A, c._W, c._K
    lanes_n = W + 5
    kinds = {"grid": (Fl, A), "route": (D, Fl * A), "frontier": (D, K)}
    # Bytes a survivor's words and a level's per-state lanes cost each kind.
    reads = {"grid": (W, 3 * Fl * 8), "route": (lanes_n, 0), "frontier": (W + 1, 0)}
    out = {"compact": {}, "merge_insert": {}}
    for kind, shape in kinds.items():
        mine = [x for x in calls["compact"] if tuple(x[0].shape) == shape]
        require(len(mine) == D, f"shard kernels: {len(mine)} {kind} compactions")
        checks = [check_compact(f"shard_{kind}_{d}", m, l, cap) for d, (m, l, cap, _) in enumerate(mine)]
        mask, lanes, cap, n = max(mine, key=lambda x: x[3])
        check_compact(f"shard_{kind}_widest", mask, lanes, cap, reps=5)
        out["compact"][kind] = {"shape": list(shape), "P": len(lanes), "cap": cap, "n_valid": n,
                                "n_valid_by_shard": [x[3] for x in mine],
                                "max_abs_err": max(x["max_abs_err"] for x in checks),
                                **time_compact(mask, lanes, cap, n, *reads[kind])}
    merges = calls["merge_insert"]
    require(len(merges) == D, f"shard kernels: {len(merges)} merges")
    checks = [check_merge(f"shard_merge_{d}", t, b) for d, (t, b) in enumerate(merges)]
    table, batch = max(merges, key=lambda x: int((fold_key(x[1][0], x[1][1]) != PAD_KEY).sum()))
    n = check_merge("shard_merge_widest", table, batch, reps=5)["n_keep"]
    out["merge_insert"] = {"C": table.shape[1], "m": batch.shape[1], "n_keep": n,
                           "max_abs_err": max(x["max_abs_err"] for x in checks),
                           **merge_timing(table, batch, n)}
    del c, calls, merges, table, batch
    gc.collect()
    torch.cuda.empty_cache()
    h, hcalls = shard_kernel_inputs(hash_model, depth, "hash")
    require(len(hcalls["hash"]) == h._D, "shard kernels: hash inserts")
    checks = [check_hash(f"shard_hash_{d}", t, lanes) for d, (t, lanes) in enumerate(hcalls["hash"])]
    t, lanes = max(hcalls["hash"], key=lambda x: int(x[1][4].sum()))
    timing = hash_timing(t, lanes, h._max_probes, plain=True)
    err = max(x["max_abs_err"] for x in checks)
    out["hashset_insert"] = {**checks[0], "max_abs_err": err, "active_by_shard":
                             [int(x[1][4].sum()) for x in hcalls["hash"]], **timing["insert"]}
    out["hashset_undo"] = {"max_abs_err": err, **timing["undo"]}
    del h, hcalls, t, lanes
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "shard_kernels", "depth": depth, **{
        k: {kind: without_ops(line) for kind, line in v.items()} if k == "compact"
        else without_ops(v) for k, v in out.items()}})
    return out


def sharded_phase(main_levels: list, main_depth: int):
    """The sharded engine (``spawn_xla(mesh=default_mesh(D))``, D shards on
    this card): 2pc rm=8 at D = 2, 4 and 8 under the sorted set, each
    exact at the single-chip engine's levels and depth (``main_levels``,
    ``main_depth``), every discovery re-executed, a clean audit, each key
    in its owner shard, cold and warm on one model instance (the warm run
    capturing nothing) beside the single-chip warm wall on the same
    instance (solo, D = 8 and D = 4 checks and a repeat of each) and one
    more warm D = 8 run profiled; ``default_mesh()``, one shard a card, on
    the single-chip engine; rm=8 at D = 8 under the hash set and at D = 4
    under the delta set (with flushes); rm=5 at D = 8 bitwise equal to its
    CPU twin; Paxos 2c/3s at D = 4 and single-copy-register 2c/2s through
    the host-verified path at D = 8, equal to the single-chip engine; rm=8
    under symmetry at D = 8;
    an rm=8 checkpoint at D = 8 saved mid-run and resumed on the
    single-chip engine and at D = 4, and a single-chip file resumed at
    D = 8; then ``shard_kernels``. Returns the launches by path and the
    kernels' lines."""
    launches, out = {}, {}
    expected = EXPECTED_2PC[8]
    # The default mesh is one shard a card: the single-chip engine.
    require(type(PackedTwoPhaseSys(3).checker().spawn_xla(mesh=default_mesh())) is XlaChecker,
            "default_mesh() on one card")

    def exact(c, what):
        require(shard_levels(c) == main_levels and c.max_depth() == main_depth,
                f"{what}: levels differ from the single-chip engine's")

    # One instance: solo, D = 8, D = 4, then a repeat of each.
    model = PackedTwoPhaseSys(8)
    walls, lines = {}, {}
    for run in ("cold", "warm"):
        for shards in (1, 8, 4):
            kw = {} if shards == 1 else {"mesh": default_mesh(shards)}
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            c, wall, got = drive(model, **kw)
            peak = torch.cuda.max_memory_allocated()
            tag = f"sharded_rm8_{'solo' if shards == 1 else f'd{shards}'}_{run}"
            launches[tag] = got
            walls[tag] = wall
            if shards == 1:
                require((c.state_count(), c.unique_state_count()) == expected, f"{tag}: counts")
                require(run == "cold" or c.metrics()["graph_captures"] == 0, f"{tag}: captured")
                continue
            exact(c, tag)
            if shards == 8:
                # The rank mesh's phases hold every shard against these.
                SHARD_D8[run] = {**mesh_worker.shard_digests(c), "wall_s": wall}
            lines[tag] = {**shard_line(c, wall, got, tag, expected), "peak_mem_gib": peak / 2**30,
                          "peak_above_base_gib": (peak - base) / 2**30}
            if run == "warm":
                require(lines[tag]["graph_captures"] == 0, f"{tag}: the warm run captured")
            emit({"phase": tag, **lines[tag], "solo_warm_wall_s": walls.get("sharded_rm8_solo_warm")})
    # One more warm D = 8 run under the profiler: device time by kernel and
    # the device's idle share.
    c, wall, kernels = profiled(lambda: model.checker().spawn_xla(mesh=default_mesh(8)).join())
    require((c.state_count(), c.unique_state_count()) == expected
            and c.metrics()["graph_captures"] == 0, "profiled D = 8: counts or a capture")
    busy_ms = sum(ms for _, ms, _ in kernels)
    emit({"phase": "sharded_rm8_d8_profile", "wall_s": wall, "busy_ms": busy_ms,
          "idle_share": 1 - busy_ms / 1e3 / wall,
          "device_ops_per_level": sum(n for _, _, n in kernels) / len(c.level_log),
          "top": sorted(kernels, key=lambda k: -k[1])[:12]})
    out["rm8"] = {k: {x: v[x] for x in ("wall_s", "graph_captures", "peak_mem_gib")}
                  for k, v in lines.items()}
    out["rm8"]["solo_walls_s"] = {k: v for k, v in walls.items() if "solo" in k}
    widest = max(range(len(main_levels)), key=lambda i: main_levels[i][3])
    # D = 2 on an instance of its own, cold and warm.
    two = PackedTwoPhaseSys(8)
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        c, wall, got = drive(two, mesh=default_mesh(2))
        tag = f"sharded_rm8_d2_{run}"
        launches[tag] = got
        exact(c, tag)
        line = {**shard_line(c, wall, got, tag, expected),
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        require(run == "cold" or line["graph_captures"] == 0, f"{tag}: the warm run captured")
        out["rm8"][tag] = {x: line[x] for x in ("wall_s", "graph_captures", "peak_mem_gib")}
        emit({"phase": tag, **line})
    del two, c
    gc.collect()
    torch.cuda.empty_cache()
    # The hash set at D = 8 and the delta set at D = 4, each on its own instance.
    hash_model = PackedTwoPhaseSys(8)
    for tag, m, shards, dedup in (("sharded_rm8_d8_hash", hash_model, 8, "hash"),
                                  ("sharded_rm8_d4_delta", PackedTwoPhaseSys(8), 4, "delta")):
        torch.cuda.reset_peak_memory_stats()
        c, wall, got = drive(m, mesh=default_mesh(shards), dedup=dedup)
        launches[tag] = got
        exact(c, tag)
        line = {**shard_line(c, wall, got, tag, expected),
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        require(dedup != "delta" or line["delta_flushes"] > 0, f"{tag}: no flush")
        out[tag] = {x: line[x] for x in ("wall_s", "graph_captures", "peak_mem_gib", "delta_flushes")}
        emit({"phase": tag, **line})
        del c
    gc.collect()
    torch.cuda.empty_cache()
    # rm=5 at D = 8 on the card and on the CPU: bit for bit.
    card, wall, got = drive(PackedTwoPhaseSys(5), mesh=default_mesh(8), **SHARD_RM5_CAPS)
    launches["sharded_rm5_d8"] = got
    t0 = time.perf_counter()
    cpu = PackedTwoPhaseSys(5).checker().spawn_xla(mesh=default_mesh(8, device="cpu"),
                                                   **SHARD_RM5_CAPS).join()
    cpu_wall = time.perf_counter() - t0
    require((card.state_count(), card.unique_state_count(), card.dispatch_log, card._found_names,
             shard_levels(card)) == (cpu.state_count(), cpu.unique_state_count(), cpu.dispatch_log,
                                     cpu._found_names, shard_levels(cpu)), "rm=5 card vs CPU")
    require(all(np.array_equal(to_u32(a[i]), to_u32(b[i])) for a, b in zip(card._tables, cpu._tables)
                for i in range(4)), "rm=5 card vs CPU: shard planes")
    out["rm5_d8"] = {**shard_line(card, wall, got, "sharded rm=5", EXPECTED_2PC[5]),
                     "cpu_wall_s": cpu_wall, "planes_equal": True}
    emit({"phase": "sharded_rm5_d8", **out["rm5_d8"]})
    # Paxos 2c/3s at D = 4; single-copy-register through the host-verified path at D = 8.
    solo = PackedPaxos(2, 3).checker().spawn_xla().join()
    c, wall, got = drive(PackedPaxos(2, 3), mesh=default_mesh(4), frontier_capacity=1 << 12)
    launches["sharded_paxos2_d4"] = got
    require(set(c.discoveries()) == set(solo.discoveries()), "sharded paxos: discoveries")
    out["paxos2_d4"] = shard_line(c, wall, got, "sharded paxos", EXPECTED_PAXOS2)
    emit({"phase": "sharded_paxos2_d4", **out["paxos2_d4"]})
    hv_model = lambda: PackedSingleCopyRegister(2, 2, device_exact=False)  # noqa: E731
    solo = hv_model().checker().spawn_xla().join()
    c, wall, got = drive(hv_model(), mesh=default_mesh(8))
    launches["sharded_hv_scr2_d8"] = got
    require((c.state_count(), c.unique_state_count(), set(c.discoveries())) == (
        solo.state_count(), solo.unique_state_count(), set(solo.discoveries())), "sharded hv")
    require("linearizable" in c.discoveries(), "sharded hv: the counterexample")
    out["hv_scr2_d8"] = {**shard_line(c, wall, got, "sharded hv", properties=False),
                         "hv": c.hv_stats}
    emit({"phase": "sharded_hv_scr2_d8", **out["hv_scr2_d8"]})
    # rm=8 under symmetry at D = 8, equal to the single-chip symmetric run.
    solo = PackedTwoPhaseSys(8).checker().symmetry().spawn_xla().join()
    c, wall, got = drive(PackedTwoPhaseSys(8), sym=True, mesh=default_mesh(8))
    launches["sharded_sym_rm8_d8"] = got
    require((c.state_count(), c.unique_state_count(), c.max_depth()) == EXPECTED_2PC_SYM[8]
            == (solo.state_count(), solo.unique_state_count(), solo.max_depth()), "sharded sym")
    out["sym_rm8_d8"] = shard_line(c, wall, got, "sharded sym rm=8", EXPECTED_2PC_SYM[8])
    emit({"phase": "sharded_sym_rm8_d8", **out["sym_rm8_d8"]})
    del c, solo
    # Checkpoints crossing D = 8, the single-chip engine and D = 4.
    depth = main_levels[widest][0]
    zero_launches()
    ck = {}
    paths = {k: os.path.join(CKPT_DIR, f"shard_{k}.npz") for k in ("d8", "solo")}
    t0 = time.perf_counter()
    run_to_depth(model, depth, mesh=default_mesh(8)).save_checkpoint(paths["d8"])
    run_to_depth(model, depth).save_checkpoint(paths["solo"])
    ck["save_s"] = time.perf_counter() - t0
    for name, path, kw in (("d8_to_solo", paths["d8"], {}),
                           ("d8_to_d4", paths["d8"], {"mesh": default_mesh(4)}),
                           ("solo_to_d8", paths["solo"], {"mesh": default_mesh(8)})):
        t0 = time.perf_counter()
        r = model.checker().spawn_xla(checkpoint=path, **kw).join()
        require((r.state_count(), r.unique_state_count()) == expected, f"checkpoint {name}")
        check_paths(r)
        audited(r, f"checkpoint {name}")
        ck[name] = {"resumed_s": time.perf_counter() - t0, "captures": r.metrics()["graph_captures"]}
    launches["sharded_checkpoint_rm8"] = launches_now()
    ck["file_bytes"] = os.path.getsize(paths["d8"])
    out["checkpoint_rm8"] = ck
    emit({"phase": "sharded_checkpoint_rm8", "depth": depth, **ck})
    kernels = shard_kernel_phase(model, hash_model, depth)
    del model, hash_model
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "sharded", **{k: v for k, v in out.items()
                                  if k not in ("rm5_d8", "paxos2_d4", "hv_scr2_d8", "sym_rm8_d8")}})
    return launches, kernels




#: The one-process D = 8 run's shard digests (``mesh_worker.shard_digests``)
#: and walls, cold and warm, from :func:`sharded_phase`.
SHARD_D8 = {}
#: The ranks of the rank mesh's phases, all on this card (so over gloo).
MESH_RANKS = 2
#: The rank pair's time limit, seconds.
MESH_TIMEOUT_S = 420


def mesh_ranks(configs, out: str, device=None) -> tuple:
    """:data:`MESH_RANKS` processes of ``python -m
    stateright_tpu_torch.tools.mesh_worker``, the ranks of one group, run
    ``configs`` one after another; with no ``device`` each rank takes
    ``cuda:(rank % cards)``, so on one card both share it and the backend
    chosen is gloo. Both must exit 0 with one ``RESULT`` a config, the same
    ``result`` on each. Kills both on any failure. Returns ``({config:
    [each rank's RESULT]}, the pair's wall)``."""
    root = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    extra = [] if device is None else ["--device", device]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "stateright_tpu_torch.tools.mesh_worker", "--rank", str(r),
         "--world", str(MESH_RANKS), "--port", str(port), "--out", out, *extra, *configs],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(MESH_RANKS)]
    outs = [""] * MESH_RANKS
    try:
        with ThreadPoolExecutor(MESH_RANKS) as ex:
            for r, text in enumerate(ex.map(
                    lambda p: p.communicate(timeout=MESH_TIMEOUT_S)[0], procs)):
                outs[r] = text
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    lines = []
    for r, (p, text) in enumerate(zip(procs, outs)):
        require(p.returncode == 0, f"mesh rank {r}: exit {p.returncode}\n{text[-6000:]}")
        lines.append({ln["config"]: ln for ln in (json.loads(x[len("RESULT "):])
                                                  for x in text.splitlines()
                                                  if x.startswith("RESULT "))})
    got = {}
    for name in configs:
        got[name] = [by_rank.get(name) for by_rank in lines]
        require(all(x is not None for x in got[name]), f"mesh {name}: a rank printed no result")
        require(all(x["result"] == got[name][0]["result"] for x in got[name]),
                f"mesh {name}: the ranks' results differ")
        require(all(x["rank"]["backend"] == "gloo" for x in got[name]), f"mesh {name}: backend")
    return got, wall


def rank_launches(lines, dedup: str) -> dict:
    """Launches of ``dedup``'s kernels, summed over every rank and run; each
    kernel must have launched on every rank."""
    total = {}
    for line in lines:
        for run in line["rank"]["runs"]:
            for name in PATH_KERNELS[dedup]:
                require(run["launches"][name] > 0,
                        f"rank {line['rank']['rank']}: {name} never launched")
                total[name] = total.get(name, 0) + run["launches"][name]
    return total


def rank_view(lines) -> dict:
    """Each rank's own figures, by run: wall, launches, peak memory, the
    exchange (seconds and bytes summed, the widest level's), captures and
    growths."""
    return {f"rank{line['rank']['rank']}": {"device": line["rank"]["device"],
                                            "backend": line["rank"]["backend"],
                                            "runs": line["rank"]["runs"]} for line in lines}


def mesh_ranks_phases(model, device=None, rm: int = 8) -> dict:
    """The sharded engine over :data:`MESH_RANKS` processes on this card
    (``mesh_ranks``): ``mesh_ranks_rm8``, 2pc rm=8 at 2 ranks x 4 shards
    under the sorted set, cold (auto-checkpointing on rank 0) and warm on one
    model instance, exact, equal on both ranks and, shard for shard, to the
    one-process D = 8 run (:data:`SHARD_D8`; the cold run starts from
    ``mesh_worker``'s smaller frontier, whose growths end blocks mid-run,
    and which the results do not depend on); rank 0's newest mid-run file
    resumed exactly on ``model`` by the single-chip engine, and rank 1's
    directory empty; then ``mesh_ranks_rm5``: rm=5 at 2 ranks x 2 shards
    under the hash and the delta set (with flushes and a growth), each
    exact and equal to the one-process D = 4 run on this card (every
    shard's sorted rows; under the delta set also its planes: the hash
    kernel may place contending keys in other slots). Returns the launches
    by path."""
    out = tempfile.mkdtemp(prefix="mesh_", dir=CKPT_DIR)
    gc.collect()
    if device is None:
        torch.cuda.empty_cache()
    got, pair_wall = mesh_ranks([f"rm{rm}", "rm5-hash", "rm5-delta"], out, device)
    launches = {}
    rm8 = got[f"rm{rm}"]
    r = rm8[0]["result"]
    require((r["states"], r["unique"]) == EXPECTED_2PC[rm], f"rank mesh rm={rm}: {r}")
    require(r["mesh_backend"] == "gloo", "rank mesh rm=8: the backend")
    for run in ("cold", "warm"):
        require({k: r[k] for k in ("planes", "rows")} == {
            k: SHARD_D8[run][k] for k in ("planes", "rows")},
            f"rank mesh rm=8: the shards differ from the one-process D = 8 {run} run")
    require(all(run["graph_captures"] == 0 for line in rm8 for run in line["rank"]["runs"][1:]),
            "rank mesh rm=8: the warm run captured")
    rank1 = os.path.join(out, "rank1")
    require(rm8[1]["rank"]["files"] == [] and not os.listdir(rank1), "rank 1 wrote a file")
    files = rotations(os.path.join(out, "rank0", f"rm{rm}.npz"))
    mid = next((f for f in files if not load_checkpoint(f)["meta"]["done"]), None)
    require(mid is not None, f"rank mesh rm={rm}: no mid-run checkpoint among {files}")
    meta = load_checkpoint(mid)["meta"]
    t0 = time.perf_counter()
    zero_launches()
    resumed = model.checker().spawn_xla(checkpoint=mid, **({} if device is None else
                                                            {"device": device})).join()
    resume_wall = time.perf_counter() - t0
    launches["mesh_ranks_rm8_resumed"] = launches_now()
    require((resumed.state_count(), resumed.unique_state_count()) == (r["states"], r["unique"]),
            "rank mesh rm=8: the resumed run's counts")
    check_paths(resumed)
    audited(resumed, "rank mesh rm=8 resumed")
    launches["mesh_ranks_rm8"] = rank_launches(rm8, "sorted")
    warm = [line["rank"]["runs"][1] for line in rm8]
    emit({"phase": "mesh_ranks_rm8", "nvidia_smi": SMI, "result": r, "pair_wall_s": pair_wall,
          "cold_wall_s": [line["rank"]["runs"][0]["wall_s"] for line in rm8],
          "warm_wall_s": [run["wall_s"] for run in warm],
          "one_process_d8_wall_s": {k: v["wall_s"] for k, v in SHARD_D8.items()},
          "exchange_warm": [run["exchange"] for run in warm],
          "peak_mem_gib": [[run["peak_mem_gib"] for run in line["rank"]["runs"]] for line in rm8],
          "launches": launches["mesh_ranks_rm8"], "ranks": rank_view(rm8),
          "checkpoint": {"file": os.path.basename(mid), "depth": meta["depth"],
                         "rotations": len(files), "resumed_wall_s": resume_wall,
                         "resumed_captures": resumed.metrics()["graph_captures"]},
          "planes_equal_one_process": True})
    del resumed
    lines = {}
    for name in ("rm5-hash", "rm5-delta"):
        factory, shards, kw, _ = mesh_worker.CONFIGS[name]
        dedup = kw["dedup"]
        one, wall, one_launches = drive(factory(), mesh=default_mesh(shards, device=device), **kw)
        launches[f"mesh_one_process_{name}"] = one_launches
        want = mesh_worker.result_of(one)
        pair = got[name]
        res = pair[0]["result"]
        keys = ("states", "unique", "depth", "paths", "levels", "rows") + (
            ("planes",) if dedup != "hash" else ())
        require(res["unique"] == EXPECTED_2PC[5][1] and res["states"] == EXPECTED_2PC[5][0],
                f"rank mesh {name}: counts")
        require({k: res[k] for k in keys} == {k: want[k] for k in keys},
                f"rank mesh {name}: differs from the one-process D = {shards} run")
        grows = [line["rank"]["runs"][0]["grows"] for line in pair]
        require(dedup != "delta" or all(g["delta_flushes"] > 0 and g["table_grows"] > 0
                                        for g in grows), f"rank mesh {name}: no flush or growth")
        launches[f"mesh_ranks_{name}"] = rank_launches(pair, dedup)
        lines[name] = {"result": res, "one_process_wall_s": wall,
                       "planes_equal": res["planes"] == want["planes"], "grows": grows,
                       "launches": launches[f"mesh_ranks_{name}"], "ranks": rank_view(pair)}
    emit({"phase": "mesh_ranks_rm5", "nvidia_smi": SMI, **lines})
    shutil.rmtree(out, ignore_errors=True)
    return launches


def call_peak_gib(fn) -> float:
    """Device memory one call of ``fn`` takes above what was allocated
    before it (its output included), in GiB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak / 2**30


def lowering_case(name: str, mask, lanes, cap: int, read_words: int, per_row_bytes: int,
                  reps: int) -> dict:
    """Each tensor lowering at one kernel-table shape: equal to
    ``compact_plain`` in every column (zeros past the survivors too) and to
    the kernel in the survivors' columns, exactly; then each timed with
    ``timed_ms`` (the device work alone, ``reps`` calls) beside the kernel
    in the same call, with the table's bound and each call's peak memory."""
    want, n_plain = compact_plain(mask, lanes, cap)
    kernel_out, n_kernel = compact(mask, lanes, cap)
    n = int(n_plain)
    k = min(n, cap)
    require(int(n_kernel) == n, f"{name}: the kernel's n_valid")
    line = {"M": mask.numel(), "P": len(lanes), "cap": cap, "n_valid": n,
            "bound_ms": bound_ms(compact_bytes(mask, len(lanes), n, cap, read_words,
                                               per_row_bytes))}
    for low, fn in LOWERINGS.items():
        got, n_got = fn(mask, lanes, cap)
        require(int(n_got) == n, f"{name} {low}: n_valid {int(n_got)} against {n}")
        err = int((got - want).abs().max()) if cap else 0
        if k:
            err = max(err, int((got[:, :k] - kernel_out[:, :k]).abs().max()))
        require(err == 0, f"{name} {low}: differs from the plain version or the kernel")
        del got
        line[low] = {"max_abs_err": err}
    del want, kernel_out
    for low, fn in {"pallas": compact, **LOWERINGS}.items():
        line.setdefault(low, {}).update({
            "ms": timed_ms(lambda: fn(mask, lanes, cap), reps=reps, queued=True),
            "peak_gib": call_peak_gib(lambda: fn(mask, lanes, cap)),
        })
    gc.collect()
    torch.cuda.empty_cache()
    return line


def compaction_ops_phase(main_checker, shapes, abd_shapes) -> dict:
    """``compaction_ops``: the tensor lowerings against the kernel and its
    plain version at the kernel table's shapes, timed beside the kernel:
    the rm=8 grid (P = 5) and frontier (P = 3), the Paxos 3c/3s grid (P =
    49) and frontier (P = 47), the ABD 3c/2s frontier (P = 40)."""
    rng = np.random.default_rng(2027)
    lv = main_checker.level_log
    top = max(lv, key=lambda r: r["bucket"])
    f, a = top["bucket"], main_checker.model().max_actions
    density = max(r["generated"] / (r["bucket"] * a) for r in lv if r["bucket"] == f)
    cases = {}
    mask, lanes, cap = _grid_case(rng, f, a, density, top["cand_cap"])
    cases["rm8_grid"] = lowering_case("rm8_grid", mask, lanes, cap, 2, 3 * f * 8, reps=20)
    mask, lanes, cap = _frontier_case(rng, max(lv, key=lambda r: r["unique"]))
    cases["rm8_frontier"] = lowering_case("rm8_frontier", mask, lanes, cap, 3, 0, reps=20)
    del mask, lanes
    gen = torch.Generator(device="cuda").manual_seed(5)
    W = shapes["W"]
    grid, mask, lanes, cap = _wide_grid_case(shapes, gen)
    cases["paxos3_grid"] = lowering_case("paxos3_grid", mask, lanes, cap, W,
                                         3 * grid.shape[0] * 8, reps=3)
    del grid, mask, lanes
    mask, lanes, wide = _wide_frontier_case(shapes, gen, rng)
    cases["paxos3_frontier"] = lowering_case("paxos3_frontier", mask, lanes, wide["bucket"],
                                             W + 1, 0, reps=10)
    mask, lanes, wide = _wide_frontier_case(abd_shapes, gen, rng)
    cases["abd3_frontier"] = lowering_case("abd3_frontier", mask, lanes, wide["bucket"],
                                           abd_shapes["W"] + 1, 0, reps=20)
    del mask, lanes
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "compaction_ops", "cases": cases})
    return cases


#: stpu-lint's runs (``python -m stateright_tpu_torch.analysis``): the
#: whole sweep, and the service's flight-check of the main path's spec.
LINT_RUNS = {
    "full": ["--json", "--no-cache", "--census-out", ""],
    "admission_2pc8": ["--admission", "2pc:8", "--json", "--no-cache"],
}
#: Seconds each lint run may take.
LINT_TIMEOUT_S = 600
#: The lint runs under way: name -> (process, stdout file, stderr file).
LINT = {}


def start_lint() -> None:
    """Start every run of :data:`LINT_RUNS` in a subprocess of its own, its
    output to files: the lint uses the CPU and ``nvcc``, never the card, so
    it runs beside the phases that follow (:func:`lint_phase` reads it), on
    one thread and at the lowest CPU priority (``nice -n 19``), so that it
    takes only the cycles those phases leave idle."""
    root = os.path.dirname(os.path.abspath(__file__))
    nice = shutil.which("nice")
    low = [nice, "-n", "19"] if nice else []
    for name, args in LINT_RUNS.items():
        out = open(os.path.join(CKPT_DIR, f"lint_{name}.out"), "w+")
        err = open(os.path.join(CKPT_DIR, f"lint_{name}.err"), "w+")
        LINT[name] = (subprocess.Popen(
            [*low, sys.executable, "-m", "stateright_tpu_torch.analysis", *args], cwd=root,
            stdout=out, stderr=err, env={**os.environ, "OMP_NUM_THREADS": "1"}), out, err)


def stop_lint() -> None:
    """Kill every lint run still going, and close its files."""
    for proc, out, err in LINT.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        out.close()
        err.close()
    LINT.clear()


def census_rm8(model, line: dict) -> dict:
    """The census's ``cuda`` plan of 2pc rm=8 (``analysis/census.py``) at
    every frontier ceiling the main path's cold run ``line`` passed through
    (the engine's default, doubled up to the final one), against the graphs
    that run captured (:class:`ProgramUse`), each ``(run_cap, rows,
    cand_cap)`` once: a table growth remakes every shape at the new
    capacity. A shape outside the census must be a rung that the planner
    gives at the candidate caps the run grew to (the model's
    ``CAND_HINTS``; :func:`grown_captures`): the census is a lower bound,
    and this prices the growth it leaves out."""
    ceilings = [DEFAULT_FRONTIER_CAPACITY]
    while ceilings[-1] < line["frontier_capacity"]:
        ceilings.append(ceilings[-1] * 2)
    plans = [plan_for("2pc:8", "cuda", frontier_capacity=f, _resolved=(model, {}))
             for f in ceilings]
    census = set().union(*(captures_of(p) for p in plans))
    made = [e["key"] for e in PROGRAM_USE.entries if e["made_in"] == "rm8_cold"]
    shapes = {k[:3] for k in made}
    hints = dict(model.__dict__.get(CAND_HINTS, {}))
    allowed = grown_captures("2pc:8", "cuda", ceilings, hints, _resolved=(model, {}))
    outside = sorted(shapes - census)
    require(shapes and shapes <= allowed,
            f"rm=8 captured shapes the planner does not give at the grown candidate caps "
            f"{hints}: {sorted(shapes - allowed)}")
    return {
        "frontier_ceilings": ceilings, "census_captures": len(census),
        "census_captures_by_ceiling": [p["captures"] for p in plans],
        "captures": len(made), "shapes": len(shapes), "remakes": len(made) - len(shapes),
        "census_not_captured": len(census - shapes), "outside_after_cand_growth": outside,
        "grown_census_shapes": len(allowed), "cand_grown_caps": sorted(hints.items()),
        "budget": plans[-1]["budget"],
    }


def lint_phase(model, cold_line: dict) -> None:
    """Read the lint runs :func:`start_lint` began: each exits 0 with an
    ``ok`` report, and the whole sweep compiled every CUDA source (no
    ``cuda:`` surface skipped); emit each kernel's resources as ``ptxas``
    reported them, the lint's seconds and the rm=8 census check."""
    t0 = time.perf_counter()
    reports = {}
    try:
        for name, (proc, out, err) in LINT.items():
            try:
                rc = proc.wait(timeout=LINT_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                rc = None
            out.seek(0)
            err.seek(0)
            text, log = out.read(), err.read()
            require(rc == 0, f"lint {name}: exit {rc}\n{text[-4000:]}\n{log[-4000:]}")
            report = json.loads(text)
            require(report["ok"] and not report["errors"], f"lint {name}: {text[-4000:]}")
            reports[name] = report
    finally:
        stop_lint()
    cuda = {s["name"]: s for s in reports["full"]["surfaces"] if s["name"].startswith("cuda:")}
    require(sorted(cuda) == sorted(f"cuda:{n}" for n in _cuda.SOURCES),
            f"lint: CUDA surfaces {sorted(cuda)}")
    require(not any(s["skipped"] for s in cuda.values()),
            f"lint: a CUDA surface skipped: {[(n, s['skipped']) for n, s in cuda.items()]}")
    kernels = [{"source": f"stateright_tpu_torch/csrc/{n[len('cuda:'):]}.cu", **k}
               for n, s in cuda.items() for k in s["detail"]["kernels"]]
    require(kernels, "lint: ptxas reported no kernel")
    emit({
        "phase": "lint", "nvidia_smi": SMI, "kernels": kernels,
        "lint_s": {name: r["elapsed_s"] for name, r in reports.items()},
        "nvcc_s": {n: s["detail"]["nvcc_s"] for n, s in cuda.items()},
        "surfaces_s": {name: {s["name"]: s["seconds"] for s in r["surfaces"]}
                       for name, r in reports.items()},
        "census_rm8": census_rm8(model, cold_line),
        "wait_s": time.perf_counter() - t0,
    })


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    global PROGRAM_USE, NATIVE_MAPS, CKPT_DIR
    PROGRAM_USE = ProgramUse()
    NATIVE_MAPS = NativeMaps()
    CKPT_DIR = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return run_phases()
    finally:
        stop_lint()
        shutil.rmtree(CKPT_DIR, ignore_errors=True)


def run_phases() -> int:
    device_phase()
    start_lint()
    # The command lines first, while this process holds little of the card.
    cli_launches = cli_phase()
    service_launches, fleet_launches = service_and_fleet_phases()
    small_phase()
    model, checker, launches, ladder = main_path_phase()
    lint_phase(model, checker.metrics())
    WITNESS["rm8"] = witness_times(checker, "rm=8")
    new_paths = {
        "checkpoint_rm8": checkpoint_rm8_phase(model, checker),
        "autockpt_rm8": autockpt_rm8_phase(model),
        **cli_launches,
        **service_launches,
        **fleet_launches,
        **obs_phase(),
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
    emit({"phase": "native", "nvidia_smi": SMI, **WITNESS})
    explorer_launches, ck = explorer_phase(np.random.default_rng(2026))
    new_paths.update(explorer_launches)
    new_paths.update(mux_phase())
    main_levels = [(r["depth"], r["frontier"], r["generated"], r["unique"]) for r in checker.level_log]
    shard_launches, shk = sharded_phase(main_levels, checker.max_depth())
    new_paths.update(shard_launches)
    new_paths.update(mesh_ranks_phases(model))
    rng = np.random.default_rng(2024)
    b1 = compact_phase(checker, rng)
    m_main = max(r["cand_cap"] for r in checker.level_log)
    b2 = merge_phase(rng, checker.metrics()["table_capacity"], m_main)
    px = model_kernel_phase(shapes, rng)
    rk = rung_kernel_phase(checker, shapes, hv_shapes, rng)
    ak = model_kernel_phase(abd_shapes, rng, tag="abd3")
    sk = model_kernel_phase(sym_shapes, rng, tag="sym14")
    lowering_ops = compaction_ops_phase(checker, shapes, abd_shapes)
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
        errs = [main, px[name], ak[name], sk[name], *new_shapes.values(), dk["level"][name],
                ck[name]]
        if name == "compact":
            errs += [ck[name]["frontier"], *shk[name].values()]
        else:
            errs.append(shk[name])
        if name == "merge_insert":
            errs.append(dk["flush"])
        kernels.append({
            "name": name, "route": "cuda", "source": f"stateright_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": sum(by_path.values()), "launches_by_path": by_path,
            "bound_by": "bytes", **main,
            "max_abs_err": max(e["max_abs_err"] for e in errs),
            "paxos3": px[name], "ladder_and_hv_shapes": new_shapes, "abd3": ak[name],
            "sym14": sk[name], "delta9": delta, "click": ck[name],
            **({"lowerings": lowering_ops} if name == "compact" else {}),
            "sharded": without_ops(shk[name]) if name == "merge_insert" else {
                kind: without_ops(line) for kind, line in shk[name].items()},
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
            "click": without_ops(ck[name]), "sharded": without_ops(shk[name]),
            "max_abs_err": max(line["max_abs_err"], ck[name]["max_abs_err"],
                               shk[name]["max_abs_err"]),
        })
    emit({"kernels": kernels})
    emit({"phase": "native_maps", "native": NATIVE_MAPS.native, "fallback": NATIVE_MAPS.fallback})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
