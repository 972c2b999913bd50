#!/usr/bin/env python3
"""The port's proof of life on an NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py`` on a machine
with one CUDA card and ``nvcc`` (it exits non-zero, printing no result,
where there is no card or no ``stateright_tpu_torch`` beside it). It

1. prints the card's name and power limit and builds every CUDA kernel of
   the port from ``stateright_tpu_torch/csrc`` (one ``nvcc`` per source, all
   started together);
2. checks small 2pc spaces on the card against the pinned counts, and the
   rm=4 search on the card against the same search on the CPU;
3. drives the main path, ``PackedTwoPhaseSys(8).checker().spawn_xla()``,
   with every launch counter set to 0 just before it and read just after:
   exact counts (18,507,778 generated, 1,745,408 unique), both kernels
   launched, and every discovery re-executed to a valid witness path; then
   repeats it three times for the spread and once under ``torch.profiler``
   for the device time by kernel and the device's idle share;
4. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (plus ragged and overflow cases), exactly
   (tolerance 0: integer work), and times kernel, plain version and, where
   one PyTorch call computes the same function, that call;
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
from torch.profiler import ProfilerActivity, profile

from stateright_tpu_torch.models.two_phase_commit import PackedTwoPhaseSys
from stateright_tpu_torch.ops import _cuda
from stateright_tpu_torch.ops.compact import compact, compact_plain
from stateright_tpu_torch.ops.merge import merge_insert, merge_insert_plain
from stateright_tpu_torch.ops.words import from_u32

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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def bound_ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def timed_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, after two warm-up
    calls, by CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def small_phase() -> None:
    """Counts of the small spaces on the card, and rm=4 on the card equal
    to rm=4 on the CPU level by level and path by path."""
    for rm in (3, 4, 5, 6, 7):
        c = PackedTwoPhaseSys(rm).checker().spawn_xla().join()
        require((c.state_count(), c.unique_state_count()) == EXPECTED_2PC[rm], f"rm={rm} counts")
    gpu = PackedTwoPhaseSys(4).checker().spawn_xla().join()
    cpu = PackedTwoPhaseSys(4).checker().spawn_xla(device="cpu").join()

    def levels(c):
        return [(r["depth"], r["generated"], r["unique"]) for r in c.level_log]

    require(levels(gpu) == levels(cpu), "rm=4 per-level counts, card vs CPU")
    dg, dc = gpu.discoveries(), cpu.discoveries()
    require(set(dg) == set(dc) and all(
        dg[k].into_actions() == dc[k].into_actions() for k in dc
    ), "rm=4 witness paths, card vs CPU")
    emit({"phase": "small", "rm": [3, 4, 5, 6, 7], "counts_ok": True, "rm4_card_equals_cpu": True})


def main_path_phase():
    """2pc rm=8 through the entry point a user calls, counters zeroed just
    before and read just after."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    compact.launches = 0
    merge_insert.launches = 0
    t0 = time.perf_counter()
    c = PackedTwoPhaseSys(8).checker().spawn_xla().join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"compact": compact.launches, "merge_insert": merge_insert.launches}
    counts = (c.state_count(), c.unique_state_count())
    require(counts == EXPECTED_2PC[8], f"rm=8 counts {counts}")
    require(all(n > 0 for n in launches.values()), f"kernel launches {launches}")
    t1 = time.perf_counter()
    found = c.discoveries()
    c.assert_properties()
    for name, path in found.items():
        c.assert_discovery(name, path.into_actions())
    m = c.metrics()
    emit({
        "phase": "rm8", "generated": counts[0], "unique": counts[1],
        "max_depth": c.max_depth(), "levels": len(c.level_log),
        "dispatches": m["dispatches"], "wall_s": wall,
        "states_per_s": counts[0] / wall, "launches": launches,
        "table_capacity": m["table_capacity"],
        "frontier_capacity": m["frontier_capacity"],
        "grows": {k: m[k] for k in ("table_grows", "frontier_grows", "cand_grows")},
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "discoveries": {k: len(p) for k, p in found.items()},
        "paths_s": time.perf_counter() - t1,
    })
    return c, launches


def repeat_and_profile_phase() -> None:
    """The spread of the rm=8 wall over three more runs, then one run under
    ``torch.profiler``: device time by kernel and the device's idle share
    of that (profiled, so slower) run's wall."""
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        PackedTwoPhaseSys(8).checker().spawn_xla().join()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        PackedTwoPhaseSys(8).checker().spawn_xla().join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy_ms = sum(ms for _, ms, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:12]
    emit({
        "phase": "rm8_repeat_profile", "walls_s": walls, "profiled_wall_s": wall,
        "device_busy_ms": busy_ms if kernels else "not measured",
        "device_idle_share": 1 - busy_ms / (wall * 1e3) if kernels else "not measured",
        "device_launches": sum(n for _, _, n in kernels),
        "top_kernels": [{"name": k[:90], "ms": ms, "calls": n} for k, ms, n in top],
    })


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


def compact_bytes(mask, lanes, n: int, cap: int) -> int:
    """Bytes this compaction must move: the mask, the survivors' grid words
    and the per-state lanes read once, the survivors' P lanes written once
    (and n_valid)."""
    kept = min(n, cap)
    per_state = 3 * mask.shape[0] * 8
    return mask.numel() + kept * 2 * 8 + per_state + len(lanes) * kept * 8 + 8


def compact_phase(c, rng) -> dict:
    """B1 against its plain version at the main path's largest grid (the
    widest bucket the rm=8 run dispatched, its candidate cap, its densest
    level), a ragged M and a cap overflow."""
    top = max(c.level_log, key=lambda r: r["bucket"])
    f, a = top["bucket"], c.model().max_actions
    density = max(r["generated"] / (r["bucket"] * a) for r in c.level_log if r["bucket"] == f)
    cases = {
        "rm8_grid": _grid_case(rng, f, a, density, top["cand_cap"]),
        "ragged": _grid_case(rng, 1001, a, 0.25, 1 << 14),
        "overflow": _grid_case(rng, 4096, a, 0.5, 1 << 12),
    }
    out = {}
    for name, (mask, lanes, cap) in cases.items():
        got, n = compact(mask, lanes, cap)
        want, n_plain = compact_plain(mask, lanes, cap)
        torch.cuda.synchronize()
        k = min(int(n_plain), cap)
        require(int(n) == int(n_plain), f"compact {name}: n_valid")
        err = int((got[:, :k] - want[:, :k]).abs().max()) if k else 0
        require(err == 0, f"compact {name}: survivors differ")
        out[name] = {"M": mask.numel(), "cap": cap, "n_valid": int(n), "max_abs_err": err}
    mask, lanes, cap = cases["rm8_grid"]
    n = out["rm8_grid"]["n_valid"]
    stacked = torch.stack([lane.reshape(-1) for lane in lanes])
    flat = mask.reshape(-1)
    timing = {
        "ms": timed_ms(lambda: compact(mask, lanes, cap)),
        "plain_ms": timed_ms(lambda: compact_plain(mask, lanes, cap)),
        "library_ms": timed_ms(lambda: stacked[:, flat]),
        "bound_ms": bound_ms(compact_bytes(mask, lanes, n, cap)),
    }
    emit({"phase": "compact", "cases": out, **timing})
    return {"max_abs_err": max(v["max_abs_err"] for v in out.values()), **timing}


def _merge_case(rng, c: int, n_table: int, m: int):
    """A sorted table of ``n_table`` unique keys padded to ``c`` rows, and a
    (key, ticket)-sorted batch of ``m`` rows: 40% hits on table keys, 40%
    fresh keys with in-batch duplicates, 20% pads."""
    keys = np.unique(rng.integers(1, 2**62, int(n_table * 1.05), dtype=np.uint64))
    rng.shuffle(keys)
    table_keys = np.sort(keys[:n_table])
    fresh = keys[n_table:]
    n_hit, n_new = int(m * 0.4), int(m * 0.4)
    batch_keys = np.concatenate([
        rng.choice(table_keys, n_hit),
        rng.choice(fresh[: max(1, n_new // 4)], n_new),
        np.full(m - n_hit - n_new, 2**64 - 1, np.uint64),
    ])
    batch_keys = batch_keys[np.argsort(batch_keys, kind="stable")]

    def planes(k, rows):
        out = np.full((4, rows), M32, np.uint32)
        out[0, : len(k)] = (k >> np.uint64(32)).astype(np.uint32)
        out[1, : len(k)] = (k & np.uint64(M32)).astype(np.uint32)
        out[2:, : len(k)] = rng.integers(0, 2**32, (2, len(k)), dtype=np.uint32)
        return from_u32(out, "cuda")

    return planes(table_keys, c), planes(batch_keys, m)


def merge_phase(rng, c_main: int, m_main: int) -> dict:
    """B2 against its plain version at the rm=8 run's largest shapes (C =
    its table capacity with ~1.3 M real rows, m = its widest candidate
    buffer), at m = 2^20, and in an overflow case."""
    cases = {
        "rm8_table": _merge_case(rng, c_main, 1_300_000, m_main),
        "m_2^20": _merge_case(rng, c_main, 1_300_000, 1 << 20),
        "overflow": _merge_case(rng, 1 << 16, 65_000, 1 << 14),
    }
    out = {}
    for name, (table, batch) in cases.items():
        got, keep, n = merge_insert(table, batch)
        want, keep_plain, n_plain = merge_insert_plain(table, batch)
        torch.cuda.synchronize()
        rows = min(int(n_plain), table.shape[1])
        require(int(n) == int(n_plain), f"merge {name}: n_keep")
        require(torch.equal(keep, keep_plain), f"merge {name}: keep flags")
        err = int((got[:, :rows] - want[:, :rows]).abs().max()) if rows else 0
        require(err == 0, f"merge {name}: merged rows differ")
        out[name] = {"C": table.shape[1], "m": batch.shape[1], "n_keep": int(n), "max_abs_err": err}
    table, batch = cases["rm8_table"]
    n = out["rm8_table"]["n_keep"]
    c, m = table.shape[1], batch.shape[1]
    timing = {
        "ms": timed_ms(lambda: merge_insert(table, batch)),
        "plain_ms": timed_ms(lambda: merge_insert_plain(table, batch)),
        "library_ms": None,
        # Keys of every row read once, values of the kept rows read once,
        # merged rows, keep flags and n_keep written once.
        "bound_ms": bound_ms((2 * c + 2 * m) * 8 + 6 * min(n, c) * 8 + m + 8),
    }
    emit({"phase": "merge_insert", "cases": out, **timing})
    return {"max_abs_err": max(v["max_abs_err"] for v in out.values()), **timing}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    device_phase()
    small_phase()
    checker, launches = main_path_phase()
    repeat_and_profile_phase()
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
