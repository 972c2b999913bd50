#!/usr/bin/env python
"""The card's memory through model instances' CUDA graph sets.

Three cases, each on a model instance of its own, through the entry point
a user calls (``spawn_xla().join()``):

- ``rm9``: 2pc rm=9 under the sorted, hash and delta sets, each cold and
  then warm on one instance (the cold run's table growths remake every
  graph at the grown capacity);
- ``paxos3_growth``: Paxos 3c/3s to depth 15 from a 2^17-row table, which
  grows while the widest bucket's programs are in the cache;
- ``paxos3_two_sets``: Paxos 3c/3s to depth 16 under the sorted set, then
  the same instance to depth 15 under the hash set (a second graph set at
  the widest bucket).

One JSON line a run: its counts, wall, growths and captures, the peak
allocated and peak reserved GiB since the run began, and after it the
reserved GiB and the share of it that graph pools hold (all of it and
their free blocks). A run that runs out of device memory prints the error
and the memory at that point, and its case stops there. Run it with
``-m`` on the card (or ``--device cpu`` at small sizes, with no memory
figures)::

    python -m stateright_tpu_torch.tools.graph_memory
    python -m stateright_tpu_torch.tools.graph_memory --cases rm9 --rm 8
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch

from ..models.paxos import PackedPaxos
from ..models.two_phase_commit import PackedTwoPhaseSys

GIB = 2**30
CASES = ("rm9", "paxos3_growth", "paxos3_two_sets")


def pool_bytes(device: torch.device) -> Dict[str, int]:
    """Bytes of the allocator's segments on ``device`` that graph pools hold
    (``segment_pool_id`` other than the default pool's), and of their free
    blocks."""
    held = free = 0
    for seg in torch.cuda.memory_snapshot():
        if seg["device"] == device.index and tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0):
            held += seg["total_size"]
            free += seg["total_size"] - seg["allocated_size"]
    return {"held": held, "free": free}


def memory(device: torch.device) -> Dict[str, Optional[float]]:
    """The memory figures of a line (None on the CPU)."""
    if device.type != "cuda":
        return {k: None for k in ("peak_allocated_gib", "peak_reserved_gib", "reserved_gib",
                                  "graph_pools_gib", "graph_pools_free_gib")}
    torch.cuda.synchronize(device)
    pools = pool_bytes(device)
    return {"peak_allocated_gib": torch.cuda.max_memory_allocated(device) / GIB,
            "peak_reserved_gib": torch.cuda.max_memory_reserved(device) / GIB,
            "reserved_gib": torch.cuda.memory_reserved(device) / GIB,
            "graph_pools_gib": pools["held"] / GIB, "graph_pools_free_gib": pools["free"] / GIB}


def run(name: str, model, device: torch.device, depth: Optional[int] = None, **kw) -> dict:
    """One check of ``model`` on ``device``; its line."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    builder = model.checker()
    if depth is not None:
        builder = builder.target_max_depth(depth)
    try:
        c = builder.spawn_xla(**({"device": "cpu"} if device.type == "cpu" else {}), **kw).join()
    except torch.cuda.OutOfMemoryError as e:
        return {"run": name, "error": str(e)[:400], **memory(device)}
    wall = time.perf_counter() - t0
    m = c.metrics()
    return {"run": name, "generated": c.state_count(), "unique": c.unique_state_count(),
            "max_depth": c.max_depth(), "wall_s": wall, "table_capacity": m["table_capacity"],
            "table_grows": m["table_grows"], "graph_captures": m["graph_captures"],
            **memory(device)}


def cases(names: List[str], device: torch.device, rm: int, paxos_clients: int,
          paxos_depth: int) -> Iterator[dict]:
    """The lines of the cases ``names``, a case's runs on one instance."""
    plans: Dict[str, Callable[[], Iterator[dict]]] = {}

    def rm9():
        for dedup in ("sorted", "hash", "delta"):
            model = PackedTwoPhaseSys(rm)
            for phase in ("cold", "warm"):
                yield run(f"rm{rm}_{dedup}_{phase}", model, device, dedup=dedup)

    def paxos3_growth():
        yield run("paxos3_growth", PackedPaxos(paxos_clients, 3), device, depth=paxos_depth,
                  table_capacity=1 << 17)

    def paxos3_two_sets():
        model = PackedPaxos(paxos_clients, 3)
        yield run("paxos3_sorted", model, device, depth=paxos_depth + 1)
        yield run("paxos3_hash", model, device, depth=paxos_depth, dedup="hash")

    plans.update(rm9=rm9, paxos3_growth=paxos3_growth, paxos3_two_sets=paxos3_two_sets)
    for name in names:
        for line in plans[name]():
            yield dict(line, case=name)
            if "error" in line:
                break
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default=",".join(CASES), help="comma-separated, of " + ", ".join(CASES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rm", type=int, default=9, help="resource managers of the rm9 case")
    ap.add_argument("--paxos-clients", type=int, default=3)
    ap.add_argument("--paxos-depth", type=int, default=15)
    args = ap.parse_args(argv)
    names = [n for n in args.cases.split(",") if n]
    unknown = sorted(set(names) - set(CASES))
    if unknown:
        ap.error(f"unknown cases {unknown}")
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout
        print(json.dumps({"nvidia_smi": smi.strip(), "torch": torch.__version__}), flush=True)
    for line in cases(names, device, args.rm, args.paxos_clients, args.paxos_depth):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
