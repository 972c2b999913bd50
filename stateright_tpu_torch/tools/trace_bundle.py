#!/usr/bin/env python
"""Post-mortem trace bundle of a service or fleet run dir.

Counterpart of the JAX package's ``tools/trace_bundle.py``, with the same
layout and manifest, over the port's run dirs (``service/core.py``,
``service/fleet.py``). One command snapshots what a post-mortem needs into
one self-contained directory:

- ``trace.merged.json``: the run's merged trace timeline
  (``stateright_tpu_torch.obs.collect``: every ``trace.jsonl`` under the
  run dir on one Chrome/Perfetto time axis, a track a process, flow arrows
  a trace id);
- ``journals/``: every job journal (``journal.jsonl`` and its rotations)
  and the fleet's routing journal (``fleet.jsonl``), at their relative
  paths, so that replay forensics work offline;
- ``heartbeats/``: each worker's last heartbeat file (``hb.json``,
  ``mux-hb.json``, ``heartbeat.json``): what the watchdog saw at its death;
- ``metrics/``: each job's metrics series and its rotations
  (``metrics.jsonl*``);
- ``lint.json``: the flight-check's verdict (``--lint``, default
  ``runs/lint.json``, skipped when absent);
- ``manifest.json``: the inventory: the run dir, the file lists, the merged
  trace ids and the event count.

Host file copies only: no device. Run it with ``-m``::

    python -m stateright_tpu_torch.tools.trace_bundle runs/fleet   # -> runs/fleet-bundle/
    python -m stateright_tpu_torch.tools.trace_bundle runs/svc --out /tmp/b --lint runs/lint.json
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import Optional

from ..obs import collect as collect_mod

#: The journals' base names, and the heartbeat files, that the walk copies.
_JOURNALS = ("journal.jsonl", "fleet.jsonl")
_HEARTBEATS = ("hb.json", "mux-hb.json", "heartbeat.json")


def _is_journal(name: str) -> bool:
    """``journal.jsonl``, ``fleet.jsonl`` and their rotations (``.1``, ...),
    by the reference's test: the name up to its first ``.jsonl`` names one."""
    stem = name.split(".jsonl")[0]
    return stem + ".jsonl" in _JOURNALS and name.startswith(stem)


def _is_metrics(name: str) -> bool:
    return name == "metrics.jsonl" or name.startswith("metrics.jsonl.")


def bundle(run_dir: str, out_dir: str,
           lint_path: Optional[str] = os.path.join("runs", "lint.json")) -> dict:
    """Builds the bundle of ``run_dir`` in ``out_dir``; returns the manifest
    (also written to ``<out_dir>/manifest.json``)."""
    if not os.path.isdir(run_dir):
        raise SystemExit(f"not a run dir: {run_dir}")
    os.makedirs(out_dir, exist_ok=True)

    copied = {"journals": [], "heartbeats": [], "metrics": []}
    out_abs = os.path.abspath(out_dir)
    for root, _dirs, files in os.walk(run_dir):
        # Never walk into a bundle nested in the run dir.
        if os.path.abspath(root).startswith(out_abs):
            continue
        for name in files:
            if _is_journal(name):
                kind = "journals"
            elif name in _HEARTBEATS:
                kind = "heartbeats"
            elif _is_metrics(name):
                kind = "metrics"
            else:
                continue
            src = os.path.join(root, name)
            rel = os.path.relpath(src, run_dir)
            dst = os.path.join(out_dir, kind, rel)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            try:
                shutil.copy2(src, dst)
            except OSError:
                continue  # a file swept mid-walk is not fatal
            copied[kind].append(rel)

    trace_obj = collect_mod.collect(run_dir)
    with open(os.path.join(out_dir, "trace.merged.json"), "w") as fh:
        json.dump(trace_obj, fh)

    lint_copied = False
    if lint_path and os.path.exists(lint_path):
        try:
            shutil.copy2(lint_path, os.path.join(out_dir, "lint.json"))
            lint_copied = True
        except OSError:
            pass

    manifest = {
        "run_dir": os.path.abspath(run_dir),
        "trace_files": trace_obj["otherData"]["trace_files"],
        "trace_ids": trace_obj["otherData"]["traces"],
        "trace_events": len(trace_obj["traceEvents"]),
        "journals": sorted(copied["journals"]),
        "heartbeats": sorted(copied["heartbeats"]),
        "metrics": sorted(copied["metrics"]),
        "lint": lint_copied,
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=2)
    return manifest


def counts(manifest: dict) -> dict:
    """The manifest's counts, as the command line prints them."""
    return {
        "trace_events": manifest["trace_events"],
        "trace_ids": len(manifest["trace_ids"]),
        "journals": len(manifest["journals"]),
        "heartbeats": len(manifest["heartbeats"]),
        "metrics": len(manifest["metrics"]),
        "lint": manifest["lint"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dir", help="service/fleet run dir to snapshot")
    ap.add_argument("--out", default=None, help="bundle dir (default: <run_dir>-bundle)")
    ap.add_argument("--lint", default=os.path.join("runs", "lint.json"),
                    help="lint verdict JSON to include (skipped if absent)")
    args = ap.parse_args(argv)
    out = args.out or (args.run_dir.rstrip("/\\") + "-bundle")
    manifest = bundle(args.run_dir, out, lint_path=args.lint)
    print(json.dumps({"bundle": os.path.abspath(out), **counts(manifest)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
