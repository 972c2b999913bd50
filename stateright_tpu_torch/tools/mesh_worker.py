#!/usr/bin/env python
"""One rank of the sharded engine's mesh over several processes.

Start one process a rank, each with its rank, the world size, the port of
rank 0's store and its device; each joins the group
(``parallel.distributed.initialize`` over ``tcp://127.0.0.1:<port>``),
runs the named configurations one after another on ``default_mesh(n)``
(``n`` global shards, ``n / world`` a rank) and prints one ``RESULT``
line a configuration: ``RESULT`` and a JSON object whose ``result`` (the
counts, the depth, each discovery's path length, a SHA-256 of every
shard's planes and one of every shard's occupied rows, both in global
shard order) is the same on every rank, and whose ``rank`` part holds this
rank's own figures (backend, device, walls, launches by kernel, peak
memory, the exchange's seconds and bytes). Two ranks on the CPU::

    python -m stateright_tpu_torch.tools.mesh_worker --rank 0 --world 2 --port 29511 \\
        --device cpu 2pc hv &
    python -m stateright_tpu_torch.tools.mesh_worker --rank 1 --world 2 --port 29511 \\
        --device cpu 2pc hv

With no ``--device`` a rank runs on ``cuda:(rank % cards)``, and ranks
that share a card talk over gloo. The configurations:

- ``2pc``, ``2pc-sorted``, ``2pc-hash``: 2pc rm=3 at 8 shards under the
  engine's default, the sorted and the hash set; ``2pc-delta`` under the
  delta set from a table small enough to flush and grow;
- ``ev``: the ``DGraph`` cycle with an eventually-property;
- ``hv``: ``PackedSingleCopyRegister(2, 2, device_exact=False)``, its
  linearizability through the host-verified path;
- ``2pc-ckpt``: 2pc rm=3 under the sorted set one level a dispatch, a
  metrics row at every block and a checkpoint at depth ``SAVE_DEPTH``
  (``--out``: each rank writes under ``<out>/rank<r>/``, where only rank
  0 may write), then to the end;
- ``die``: 2pc rm=3 one level a dispatch; rank 1 kills itself at depth
  ``DIE_DEPTH``, and the other rank must fail;
- ``rm8`` (or ``rm<N>`` for 2pc rm=N): 2pc rm=8 at 8 shards, cold and
  then warm on one model instance; the cold run starts from a frontier of
  :func:`cold_frontier` rows, whose growths end blocks mid-run, and
  auto-checkpoints every few levels (``--out``); the warm run starts at
  the capacities the cold one grew to;
- ``rm5-hash``, ``rm5-delta``: 2pc rm=5 at 4 shards under the hash set,
  and under the delta set from a table that flushes and grows.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import sys
import time
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from .. import graphs
from ..audit import audit_table
from ..core import Property
from ..models.single_copy_register import PackedSingleCopyRegister
from ..models.two_phase_commit import PackedTwoPhaseSys
from ..parallel import default_mesh, distributed
from ..test_util import DGraph, PackedDGraph

#: The capacities of the small configurations (``tests/distributed_worker.py``'s).
SMALL = dict(frontier_capacity=1 << 9, table_capacity=1 << 12)
#: The depth at which ``2pc-ckpt`` saves.
SAVE_DEPTH = 5
#: The depth at which rank 1 of ``die`` kills itself.
DIE_DEPTH = 4
#: The levels between the ``rm<N>`` cold run's checkpoints.
RM_CHECKPOINT_EVERY = 4
#: The capacities of ``rm5-delta`` (a table that flushes and grows).
RM5_DELTA = dict(frontier_capacity=1 << 10, table_capacity=1 << 10)
#: The capacities of ``rm5-hash``.
RM5_HASH = dict(frontier_capacity=1 << 10, table_capacity=1 << 12)


def _dgraph():
    graph = (DGraph.with_property(Property.eventually("odd", lambda _, s: s % 2 == 1))
             .with_path([0, 2, 4]).with_path([4, 6]))
    return PackedDGraph(graph)


#: name -> (model factory, global shards, spawn keywords, runs on one instance).
CONFIGS: Dict[str, Tuple[Callable[[], Any], int, Dict[str, Any], int]] = {
    "2pc": (lambda: PackedTwoPhaseSys(3), 8, SMALL, 1),
    "2pc-sorted": (lambda: PackedTwoPhaseSys(3), 8, dict(SMALL, dedup="sorted"), 1),
    "2pc-hash": (lambda: PackedTwoPhaseSys(3), 8, dict(SMALL, dedup="hash"), 1),
    "2pc-delta": (lambda: PackedTwoPhaseSys(3), 8,
                  dict(SMALL, dedup="delta", table_capacity=1 << 9), 1),
    "ev": (_dgraph, 8, SMALL, 1),
    "hv": (lambda: PackedSingleCopyRegister(2, 2, device_exact=False), 8, SMALL, 1),
    "2pc-ckpt": (lambda: PackedTwoPhaseSys(3), 8,
                 dict(SMALL, dedup="sorted", levels_per_dispatch=1), 1),
    "die": (lambda: PackedTwoPhaseSys(3), 8, dict(SMALL, levels_per_dispatch=1), 1),
    "rm5-hash": (lambda: PackedTwoPhaseSys(5), 4, dict(RM5_HASH, dedup="hash"), 1),
    "rm5-delta": (lambda: PackedTwoPhaseSys(5), 4, dict(RM5_DELTA, dedup="delta"), 1),
}


def cold_frontier(rm: int) -> int:
    """The frontier rows, over every shard, that an ``rm<N>`` cold run
    starts from (4,096 at rm=8, 256 at rm=4): small enough that its
    growths end blocks mid-run."""
    return 1 << (rm + 4)


def config(name: str) -> Tuple[Callable[[], Any], int, Dict[str, Any], int]:
    """A configuration by name: one of :data:`CONFIGS`, or ``rm<N>``."""
    if name in CONFIGS:
        return CONFIGS[name]
    if name.startswith("rm") and name[2:].isdigit():
        return (lambda: PackedTwoPhaseSys(int(name[2:]))), 8, {}, 2
    raise argparse.ArgumentTypeError(f"unknown configuration {name!r}: "
                                     f"{', '.join(sorted(CONFIGS))} or rm<N>")


def _config_name(name: str) -> str:
    config(name)
    return name


def shard_digests(checker) -> Dict[str, str]:
    """SHA-256 digests of a sharded checker's visited sets, in global shard
    order, the same in one process and over ranks (a collective on a rank
    mesh): ``planes``, of every plane and count of each shard's structure,
    bit for bit; ``rows``, of each shard's occupied ``(key, value)`` rows
    sorted by key, which is blind to where a hash set placed them."""
    tables = checker._tables
    kind = type(tables[0])
    h = hashlib.sha256()
    for j in range(len(kind._fields)):
        h.update(np.ascontiguousarray(checker._gather(torch.stack(
            [torch.as_tensor(t[j]) for t in tables]))).tobytes())
    per_shard = []
    for t in tables:
        rows = np.stack(checker._ds.occupied_rows(t), 1).astype(np.uint32)
        rows = rows[np.lexsort((rows[:, 1], rows[:, 0]))]
        per_shard.append(np.frombuffer(hashlib.sha256(rows.tobytes()).digest(), np.uint8))
    rows = checker._gather(torch.from_numpy(np.stack(per_shard)))
    return {"planes": h.hexdigest(), "rows": hashlib.sha256(rows.tobytes()).hexdigest()}


def launches() -> Dict[str, int]:
    """The kernel wrappers' launch counters, by the ``kernels`` line's names."""
    names = ("compact", "merge_insert", "hashset_insert", "hashset_undo")
    return {n: fn.launches for n, fn in zip(names, graphs.KERNELS)}


def zero_launches() -> None:
    for fn in graphs.KERNELS:
        fn.launches = 0


def exchange_summary(log, end: float) -> Dict[str, Any]:
    """A run's exchanges (``Group.exchange_log`` rows): their count, seconds
    and bytes summed (with the staged legs: to the host, the collective,
    back), and the widest level's: of the calls that moved the most bytes,
    the one with the longest gap to the next call's start (or to the run's
    ``end``), its seconds, legs, bytes and that gap, the level's wall as
    the host saw it."""
    if not log:
        return {"calls": 0, "seconds": 0.0, "bytes": 0, "widest": None}
    gaps = [nxt[0] - cur[0] for cur, nxt in zip(log, log[1:])] + [end - log[-1][0]]
    most = max(row[2] for row in log)
    i = max((i for i, row in enumerate(log) if row[2] == most), key=lambda i: gaps[i])
    staged = [row[3] for row in log if row[3] is not None]
    return {"calls": len(log), "seconds": sum(row[1] for row in log),
            "bytes": sum(row[2] for row in log),
            "legs_s": [sum(x) for x in zip(*staged)] if staged else None,
            "widest": {"seconds": log[i][1], "legs_s": log[i][3], "bytes": most,
                       "level_wall_s": gaps[i], "share": log[i][1] / gaps[i]}}


def result_of(checker) -> Dict[str, Any]:
    """The global result every rank must agree on (collectives included)."""
    paths = {name: len(path) for name, path in sorted(checker.discoveries().items())}
    report = audit_table(checker)
    if not report["ok"]:
        raise AssertionError(f"audit: {report}")
    return {"states": checker.state_count(), "unique": checker.unique_state_count(),
            "depth": checker.max_depth(), "paths": paths, "levels": len(checker.level_log),
            "dispatches": len(checker.dispatch_log), "hv": checker.hv_stats.get("confirmed", 0),
            **shard_digests(checker)}


def _rank_dir(out: str, rank: int) -> str:
    path = os.path.join(out, f"rank{rank}")
    os.makedirs(path, exist_ok=True)
    return path


def run_config(name: str, args, group) -> Dict[str, Any]:
    """One configuration on this rank; returns its ``RESULT`` object."""
    factory, shards, kw, runs = config(name)
    model = factory()
    mesh = default_mesh(shards)
    out = _rank_dir(args.out, group.rank) if args.out else None
    cuda = group.device.type == "cuda"
    rank_part: Dict[str, Any] = {"rank": group.rank, "world": group.world,
                                 "backend": group.backend, "device": str(group.device),
                                 "runs": []}
    result = None
    for run in range(runs):
        extra: Dict[str, Any] = {}
        if name not in CONFIGS and run == 0:
            extra = dict(frontier_capacity=cold_frontier(int(name[2:])))
            if out:
                extra.update(checkpoint_to=os.path.join(out, f"{name}.npz"),
                             checkpoint_every=RM_CHECKPOINT_EVERY, checkpoint_keep=16)
        if name == "2pc-ckpt" and out:
            extra = dict(metrics_to=os.path.join(out, "metrics.jsonl"), metrics_every=1)
        zero_launches()
        calls0 = len(group.exchange_log)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        checker = model.checker().spawn_xla(mesh=mesh, **kw, **extra)
        if name in ("2pc-ckpt", "die"):
            while not checker.is_done():
                checker._run_block()
                if name == "die" and group.rank == 1 and checker._depth >= DIE_DEPTH:
                    os.kill(os.getpid(), signal.SIGKILL)
                if name == "2pc-ckpt" and out and checker._depth == SAVE_DEPTH:
                    checker.save_checkpoint(os.path.join(out, "mid.npz"))
        else:
            checker.join()
        if cuda:
            torch.cuda.synchronize()
        end = time.perf_counter()
        wall = end - t0
        m = checker.metrics()
        ex = exchange_summary(group.exchange_log[calls0:], end)
        rank_part["runs"].append({
            "wall_s": wall, "launches": launches(), "exchange": ex,
            "graph_captures": m["graph_captures"], "graph_capture_s": m["graph_capture_s"],
            "grows": {k: m[k] for k in ("table_grows", "frontier_grows", "route_grows",
                                        "delta_flushes")},
            "checkpoints": {k: m[k] for k in ("checkpoints_written", "last_checkpoint_level")},
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
            "levels": len(checker.level_log),
        })
        got = result_of(checker)
        got["mesh_backend"] = m["mesh_backend"]
        if result is not None and {k: v for k, v in got.items() if k != "dispatches"} != {
                k: v for k, v in result.items() if k != "dispatches"}:
            raise AssertionError(f"{name}: the warm run differs from the cold: {got} {result}")
        result = got
    if out:
        rank_part["files"] = sorted(os.listdir(out))
    return {"config": name, "result": result, "rank": rank_part}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--device", default=None, help="cpu, cuda or cuda:N (default: the rank's card)")
    p.add_argument("--timeout", type=float, default=distributed.DEFAULT_TIMEOUT_S,
                   help="seconds any collective may wait")
    p.add_argument("--out", default=None, help="a directory for each rank's files")
    p.add_argument("--threads", type=int, default=None, help="torch threads of this process")
    p.add_argument("configs", nargs="+", type=_config_name,
                   help=f"{', '.join(sorted(CONFIGS))} or rm<N>")
    args = p.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    group = distributed.initialize(f"{args.host}:{args.port}", args.world, args.rank,
                                   device=args.device, timeout_s=args.timeout)
    try:
        for name in args.configs:
            print("RESULT " + json.dumps(run_config(name, args, group)), flush=True)
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
