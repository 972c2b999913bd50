"""The port's post-mortem bundle (``stateright_tpu_torch/tools/trace_bundle.py``)
against the JAX package's ``tools/trace_bundle.py`` (loaded by path) on one
seeded run dir: journals and their rotations, the fleet's journal,
heartbeats, metrics series, two ``trace.jsonl`` files with spans of shared
trace ids, a torn line, files that must be left out and a bundle nested in
the run dir. Both give the same manifest and the same bundle tree; the
command line prints the manifest's counts."""

import importlib.util
import json
import os
import pathlib
import time

import pytest

from stateright_tpu_torch.obs.trace import Tracer
from stateright_tpu_torch.tools import trace_bundle

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref_bundle():
    spec = importlib.util.spec_from_file_location("ref_trace_bundle", ROOT / "tools" / "trace_bundle.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _seeded_run_dir(root: pathlib.Path) -> pathlib.Path:
    run = root / "fleet"
    files = {
        "fleet.jsonl": '{"event": "route", "job": "f-1", "device": 0}\n',
        "fleet.jsonl.1": '{"event": "route", "job": "f-0", "device": 1}\n',
        "device-0/journal.jsonl": '{"event": "submit", "id": "job-0001"}\n{torn\n',
        "device-0/journal.jsonl.1": '{"event": "submit", "id": "job-0000"}\n',
        "device-0/journal.jsonl.2": '{"event": "completed", "id": "job-0000"}\n',
        "device-1/journal.jsonl": '{"event": "submit", "id": "job-0002"}\n',
        "device-0/jobs/job-0001/hb.json": '{"phase": "dispatch", "depth": 7}',
        "device-1/jobs/job-0002/mux-hb.json": '{"phase": "dispatch", "depth": 3}',
        "device-1/heartbeat.json": '{"phase": "idle"}',
        "device-0/jobs/job-0001/metrics.jsonl": '{"depth": 1}\n',
        "device-0/jobs/job-0001/metrics.jsonl.1": '{"depth": 0}\n',
        "device-0/jobs/job-0001/ckpt.npz": "not a bundle file",
        "device-0/jobs/job-0001/journal.json": "not a journal",
        "device-0/notes.jsonl": "{}\n",
        "fleet-bundle/journal.jsonl": '{"stale": true}\n',
    }
    for rel, text in files.items():
        path = run / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    # Two span files of the same traces: the fleet's route and the pool's
    # submit and attempt, as the processes of a run write them.
    fleet = Tracer(str(run / "trace.jsonl"))
    pool = Tracer(str(run / "device-0" / "trace.jsonl"))
    now = time.monotonic()
    for i, trace_id in enumerate(("t-1", "t-2")):
        fleet.emit("route", t0=now + i, dur=0.01, attrs={"device": 0}, trace_id=trace_id)
        pool.emit("submit", t0=now + i + 0.02, dur=0.01, attrs={"spec": "2pc:3"}, trace_id=trace_id)
        pool.emit("attempt", t0=now + i + 0.05, dur=0.5, attrs={"attempt": 1}, trace_id=trace_id)
    fleet._fh.close()
    pool._fh.close()
    with open(run / "device-0" / "trace.jsonl", "a") as fh:
        fh.write('{"name": "attempt", "t0"')  # a kill mid-write
    return run


def _tree(out: pathlib.Path) -> dict:
    return {str(p.relative_to(out)): p.read_bytes() for p in sorted(out.rglob("*"))
            if p.is_file() and p.name not in ("manifest.json", "trace.merged.json")}


def test_bundle_equals_the_references(tmp_path, ref_bundle):
    """Each tool bundles into ``fleet-bundle`` inside the run dir, in turn:
    the same manifest and tree, and neither walks into the bundle (nor the
    stale file already there)."""
    run = _seeded_run_dir(tmp_path)
    lint = tmp_path / "lint.json"
    lint.write_text('{"ok": true}')
    out = run / "fleet-bundle"
    trees, manifests = [], []
    for tool in (ref_bundle, trace_bundle):
        manifests.append(tool.bundle(str(run), str(out), lint_path=str(lint)))
        trees.append((_tree(out), json.loads((out / "trace.merged.json").read_text()),
                      json.loads((out / "manifest.json").read_text())))
    want, got = manifests
    assert got == want and trees[1] == trees[0] and trees[1][2] == got
    assert got["journals"] == sorted([
        "fleet.jsonl", "fleet.jsonl.1", "device-0/journal.jsonl", "device-0/journal.jsonl.1",
        "device-0/journal.jsonl.2", "device-1/journal.jsonl"])
    assert got["heartbeats"] == sorted([
        "device-0/jobs/job-0001/hb.json", "device-1/jobs/job-0002/mux-hb.json",
        "device-1/heartbeat.json"])
    assert got["metrics"] == ["device-0/jobs/job-0001/metrics.jsonl",
                              "device-0/jobs/job-0001/metrics.jsonl.1"]
    assert got["trace_files"] == ["device-0/trace.jsonl", "trace.jsonl"]
    assert got["trace_ids"] == ["t-1", "t-2"] and got["trace_events"] > 6 and got["lint"]


def test_no_lint_and_a_missing_run_dir(tmp_path, ref_bundle):
    run = _seeded_run_dir(tmp_path)
    got = trace_bundle.bundle(str(run), str(tmp_path / "b"), lint_path=None)
    want = ref_bundle.bundle(str(run), str(tmp_path / "r"), lint_path=str(tmp_path / "absent.json"))
    assert got == want and got["lint"] is False
    with pytest.raises(SystemExit, match="not a run dir"):
        trace_bundle.bundle(str(tmp_path / "absent"), str(tmp_path / "c"))


def test_command_line_prints_the_counts(tmp_path, capsys):
    run = _seeded_run_dir(tmp_path)
    assert trace_bundle.main([str(run), "--lint", str(tmp_path / "absent.json")]) == 0
    line = json.loads(capsys.readouterr().out)
    assert line["bundle"] == os.path.abspath(str(run) + "-bundle")
    # Outside the run dir, the bundle holds the stale nested one's journal.
    assert {k: line[k] for k in ("journals", "heartbeats", "metrics", "trace_ids", "lint")} == {
        "journals": 7, "heartbeats": 3, "metrics": 2, "trace_ids": 2, "lint": False}
    assert (tmp_path / "fleet-bundle" / "manifest.json").exists()
