#!/usr/bin/env python3
"""The price of the port's observability on a warm 2pc rm=8 check.

Run from the repository root on a machine with a CUDA card:
``python3 tools/obs_price.py [DIR]``. One model instance runs cold, then
warm with each observability knob of ``spawn_xla`` alone and all of them
together, in turns with everything off, files under ``DIR`` (default: a
temporary directory). Prints one JSON line a configuration (its walls)
and, last, the host functions of one all-on warm run that take the most
time, by ``cProfile``.
"""

from __future__ import annotations

import cProfile
import json
import os
import pstats
import sys
import tempfile
import time

from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from stateright_tpu_torch.models.two_phase_commit import PackedTwoPhaseSys  # noqa: E402

ROUNDS = 3


def knobs(directory: str, tag: str) -> dict:
    path = os.path.join(directory, tag)
    return {
        "off": {},
        "trace": {"trace": f"{path}.trace"},
        "trace+phases": {"trace": f"{path}.trace", "phases": True},
        "heartbeat": {"heartbeat": f"{path}.hb"},
        "series": {"metrics_to": f"{path}.series", "metrics_every": 1},
        "all": {"trace": f"{path}.trace", "phases": True, "heartbeat": f"{path}.hb",
                "metrics_to": f"{path}.series", "metrics_every": 1},
    }


def warm(model, **kw) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c = model.checker().spawn_xla(**kw).join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert (c.state_count(), c.unique_state_count()) == (18_507_778, 1_745_408)
    return wall


def main() -> int:
    directory = sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp(prefix="obs_price_")
    os.makedirs(directory, exist_ok=True)
    print(json.dumps({"directory": directory}), flush=True)
    model = PackedTwoPhaseSys(8)
    model.checker().spawn_xla().join()  # cold: captures every graph
    walls = {name: [] for name in knobs(directory, "x")}
    for r in range(ROUNDS):
        for name, kw in knobs(directory, f"r{r}").items():
            walls[name].append(warm(model, **kw))
            walls["off"].append(warm(model))
    for name, ws in walls.items():
        print(json.dumps({"config": name, "walls_s": ws, "min_s": min(ws)}), flush=True)
    prof = cProfile.Profile()
    kw = knobs(directory, "prof")["all"]
    prof.enable()
    warm(model, **kw)
    prof.disable()
    stats = pstats.Stats(prof)
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:25]
    print(json.dumps({"profile_tottime_s": [
        {"fn": f"{os.path.basename(f)}:{line}:{fn}", "calls": cc, "tottime": tt, "cumtime": ct}
        for (f, line, fn), (cc, _nc, tt, ct, _callers) in rows]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
