"""The port's observability (``stateright_tpu_torch/obs`` and the engine's
hooks) held against the JAX package's on the CPU.

The reference runs are the expensive part (a CPU compile a program), so
each configuration runs once per module in each package, with everything
on: a span trace, a heartbeat, a metrics series sampled every level and
the dispatch-phase split. The tests read those runs:

- 2pc rm=3 under the sorted set; rm=4 from a 64-row table (forced to grow
  six times) under the "ramp" ladder; rm=4 under the "jump" ladder;
- the span schema and the sequence of span names equal the reference's
  wherever ``dispatch_log`` is equal, which each test asserts first;
- the heartbeat's ``seq``, the recorder's rows, the ladder counters;
- with everything off the engine holds ``NULL_TRACER`` and its results
  are bit-identical to a run with everything on;
- the pure functions give the reference's output on the same input.
"""

import json
import os

import pytest
import torch

from stateright_tpu import obs as ref_obs
from stateright_tpu.models.two_phase_commit import PackedTwoPhaseSys as RefTwoPhase
from stateright_tpu.obs import collect as ref_collect
from stateright_tpu.obs import promexport as ref_prom
from stateright_tpu_torch import obs
from stateright_tpu_torch.models.two_phase_commit import PackedTwoPhaseSys
from stateright_tpu_torch.obs import collect, promexport
from stateright_tpu_torch.obs import heartbeat as hb_mod
from stateright_tpu_torch.obs import trace as trace_mod
from stateright_tpu_torch.xla import UNPORTED_COMPACTIONS

#: ``tests/test_obs.py``'s pinned key set of the reference's ``metrics()``.
METRIC_KEYS = {
    "engine", "backend", "dedup", "compaction", "symmetry", "ladder", "cand_ladder_k",
    "shrink_exit", "levels_per_dispatch", "state_count", "unique_state_count", "depth",
    "max_depth", "frontier_count", "frontier_capacity", "table_capacity",
    "table_occupancy", "dispatches", "levels_committed", "cand_retries", "hv",
    "table_grows", "frontier_grows", "cand_grows", "delta_flushes", "shrink_exits",
    "ladder_jumps", "checkpoint_to", "resumed_from", "last_checkpoint_level",
    "checkpoints_written", "metrics_to",
}
SPAN_KEYS = {"ts", "dur", "name", "span_id", "attrs"}
CTX_SPAN_KEYS = SPAN_KEYS | {"trace_id", "parent_id"}
DISPATCH_ATTRS = {"flavor", "bucket", "cand", "committed", "compile", "retry", "dedup",
                  "compaction"}
RECORDER_ROW_KEYS = {"v", "unix_ts", "t", "seq", "kind", "metrics"}
PHASES = ("phase:host_prep", "phase:enqueue", "phase:device_compute", "phase:readback")

RM3 = dict(dedup="sorted", frontier_capacity=1 << 10, table_capacity=1 << 13)
GROW = dict(dedup="sorted", frontier_capacity=1 << 12, table_capacity=1 << 6, ladder="ramp")
JUMP = dict(dedup="sorted", frontier_capacity=1 << 12, table_capacity=1 << 14, ladder="jump")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spans(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _observed(model, directory, name, **kw):
    """One run with every observability knob on: ``(checker, spans,
    heartbeat, series rows, paths)``."""
    os.makedirs(directory, exist_ok=True)
    paths = {k: os.path.join(directory, f"{name}.{k}") for k in ("trace", "hb", "series")}
    c = model.checker().spawn_xla(
        trace=paths["trace"], heartbeat=paths["hb"], metrics_to=paths["series"],
        metrics_every=1, phases=True, **kw,
    ).join()
    rows = obs.read_series(paths["series"])
    return c, _spans(paths["trace"]), hb_mod.read(paths["hb"]), rows, paths


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each configuration in both packages: ``{case: (port, ref)}``."""
    d = str(tmp_path_factory.mktemp("obs"))
    out = {}
    for case, rm, kw in (("rm3", 3, RM3), ("grow", 4, GROW), ("jump", 4, JUMP)):
        ref = _observed(RefTwoPhase(rm), os.path.join(d, "ref"), case, **kw)
        port = _observed(PackedTwoPhaseSys(rm), os.path.join(d, "port"), case, device="cpu",
                         **kw)
        out[case] = (port, ref)
    return out


def _names(spans):
    return [r["name"] for r in spans]


@pytest.mark.parametrize("case", ["rm3", "grow", "jump"])
def test_span_schema_and_names_equal_the_references(runs, case):
    (pc, pspans, _, _, _), (rc, rspans, _, _, _) = runs[case]
    assert pc.dispatch_log == rc.dispatch_log
    assert (pc.state_count(), pc.unique_state_count()) == (rc.state_count(),
                                                           rc.unique_state_count())
    for rec in pspans:
        # Only the phase spans name a parent (their dispatch span).
        extra = {"parent_id"} if rec["name"].startswith("phase:") else set()
        assert set(rec) == SPAN_KEYS | extra, rec
        assert rec["ts"] >= 0 and rec["dur"] >= 0
    assert len({r["span_id"] for r in pspans}) == len(pspans)
    assert pspans[0]["name"] == "trace_start" and {"pid", "unix_ts"} <= set(pspans[0]["attrs"])
    assert _names(pspans) == _names(rspans)
    pdisp = [r["attrs"] for r in pspans if r["name"] == "dispatch"]
    rdisp = [r["attrs"] for r in rspans if r["name"] == "dispatch"]
    assert len(pdisp) == len(pc.dispatch_log)
    assert sum(a["committed"] for a in pdisp) == len(pc.level_log)
    for p, r in zip(pdisp, rdisp):
        assert DISPATCH_ATTRS <= set(p) and set(p) == set(r)
        # ``compile`` differs by design: the port makes a grown table's
        # programs inside ``grow_table``, the reference at its next dispatch.
        same = ("flavor", "bucket", "cand", "committed", "retry", "dedup", "shrink_below")
        assert {k: p[k] for k in same} == {k: r[k] for k in same}
        assert p["compaction"] == "pallas"
    pgrow = [r["attrs"] for r in pspans if r["name"] == "grow_table"]
    assert pgrow == [r["attrs"] for r in rspans if r["name"] == "grow_table"]
    assert pc.metrics()["table_grows"] == len(pgrow) == rc.metrics()["table_grows"]
    assert any(a["compile"] for a in pdisp)


@pytest.mark.parametrize("case", ["rm3", "grow"])
def test_phase_spans_partition_each_dispatch(runs, case):
    (pc, pspans, _, _, _), _ = runs[case]
    by_id = {r["span_id"]: r for r in pspans}
    disp = [r for r in pspans if r["name"] == "dispatch"]
    assert len(pc.phase_log) == len(disp) == len(pc.dispatch_log)
    for row, (bucket, committed) in zip(pc.phase_log, pc.dispatch_log):
        assert (row["bucket"], row["committed"], row["flavor"]) == (bucket, committed, "fused")
    for span in disp:
        kids = [r for r in pspans if r.get("parent_id") == span["span_id"]]
        assert _names(kids) == list(PHASES)
        assert all(k["attrs"] == {"bucket": span["attrs"]["bucket"]} for k in kids)
        # Contiguous sub-intervals inside the parent span.
        for a, b in zip(kids, kids[1:]):
            assert b["ts"] == pytest.approx(a["ts"] + a["dur"], abs=2e-6)
        assert kids[0]["ts"] >= span["ts"] - 1e-6
        assert kids[-1]["ts"] + kids[-1]["dur"] <= span["ts"] + span["dur"] + 2e-6
        assert all(by_id[k["parent_id"]] is span for k in kids)


@pytest.mark.parametrize("case", ["rm3", "grow", "jump"])
def test_heartbeat_seq_counts_the_committed_dispatches(runs, case):
    (pc, _, phb, _, _), (rc, _, rhb, _, _) = runs[case]
    assert phb["seq"] == len(pc.dispatch_log) == rhb["seq"]
    assert phb["phase"] == "idle" == rhb["phase"]
    assert (phb["depth"], phb["states"]) == (rhb["depth"], rhb["states"])
    assert phb["states"] == pc.state_count()


@pytest.mark.parametrize("case", ["rm3", "grow"])
def test_recorder_rows_equal_the_references(runs, case):
    (pc, _, _, prows, ppaths), (_, _, _, rrows, _) = runs[case]
    assert prows and all(set(r) == RECORDER_ROW_KEYS for r in prows)
    assert [r["seq"] for r in prows] == list(range(len(prows)))
    assert all(r["v"] == 1 and r["kind"] == "engine" for r in prows)
    keys = ("depth", "state_count", "unique_state_count", "table_capacity", "dispatches",
            "table_grows", "frontier_grows", "ladder_jumps")
    assert [[r["metrics"][k] for k in keys] for r in prows] == [
        [r["metrics"][k] for k in keys] for r in rrows]
    assert prows[-1]["metrics"]["metrics_to"] == ppaths["series"]
    assert METRIC_KEYS <= set(prows[-1]["metrics"])


@pytest.mark.parametrize("case, ladder", [("grow", "ramp"), ("jump", "jump")])
def test_ladder_counters_equal_the_references(runs, case, ladder):
    (pc, _, _, _, _), (rc, _, _, _, _) = runs[case]
    pm, rm = pc.metrics(), rc.metrics()
    assert pm["ladder"] == rm["ladder"] == ladder
    assert (pm["frontier_grows"], pm["ladder_jumps"]) == (rm["frontier_grows"],
                                                          rm["ladder_jumps"])
    assert pm["frontier_grows"] > 0
    assert (pm["ladder_jumps"] > 0) == (ladder == "jump")


@pytest.mark.parametrize("dedup", ["sorted", "hash", "delta"])
def test_metrics_hold_the_references_key_set(runs, dedup, tmp_path):
    c = PackedTwoPhaseSys(3).checker().spawn_xla(
        device="cpu", dedup=dedup, metrics_to=str(tmp_path / "m.jsonl"),
        frontier_capacity=1 << 10, table_capacity=1 << 13).join()
    m = c.metrics()
    assert METRIC_KEYS <= set(m)
    _, (rc, _, _, _, _) = runs["rm3"]
    assert set(rc.metrics()) <= set(m)
    assert (m["backend"], m["compaction"], m["ladder"], m["dedup"]) == (
        "cpu", "pallas", "jump", dedup)
    assert m["metrics_to"] == str(tmp_path / "m.jsonl")
    assert {"graph_captures", "dead_replays", "device"} <= set(m)


@pytest.mark.parametrize("compaction", UNPORTED_COMPACTIONS)
def test_an_unported_compaction_raises_naming_the_roadmap(compaction):
    with pytest.raises(ValueError, match="ROADMAP A"):
        PackedTwoPhaseSys(3).checker().spawn_xla(device="cpu", compaction=compaction)


def test_compaction_and_ladder_spellings(monkeypatch):
    model = PackedTwoPhaseSys(3)
    for spelling in ("auto", "pallas"):
        c = model.checker().spawn_xla(device="cpu", compaction=spelling)
        assert c.metrics()["compaction"] == "pallas"
    with pytest.raises(ValueError, match="compaction must be"):
        model.checker().spawn_xla(device="cpu", compaction="scatter")
    with pytest.raises(ValueError, match="ladder"):
        model.checker().spawn_xla(device="cpu", ladder="sideways")
    monkeypatch.setenv("STPU_LADDER", "ramp")
    assert model.checker().spawn_xla(device="cpu").metrics()["ladder"] == "ramp"
    monkeypatch.setenv("STPU_COMPACTION", "sort")
    with pytest.raises(ValueError, match="ROADMAP A"):
        model.checker().spawn_xla(device="cpu")


def test_the_check_command_line_on_the_cpu_equals_the_references_engine(runs, capsys):
    """``two-phase-commit check 3`` on the CPU (``main``'s ``device``
    keyword) against the reference's ``spawn_xla`` on the same model."""
    from stateright_tpu_torch.models import two_phase_commit

    two_phase_commit.main(["check", "3"], device="cpu")
    out = capsys.readouterr().out.splitlines()
    _, (rc, _, _, _, _) = runs["rm3"]
    assert out[0] == "Checking two phase commit with 3 resource managers on the GPU."
    done = [line.split(", sec=")[0] for line in out if line.startswith("Done.")]
    assert done == [f"Done. states={rc.state_count()}, unique={rc.unique_state_count()}, "
                    f"depth={rc.max_depth()}"] == ["Done. states=1146, unique=288, depth=11"]


def test_everything_off_holds_the_null_tracer_and_is_bit_identical(runs, tmp_path):
    (on, _, _, _, _), _ = runs["grow"]
    before = set(os.listdir(tmp_path))
    off = PackedTwoPhaseSys(4).checker().spawn_xla(device="cpu", **GROW).join()
    assert off._tracer is obs.NULL_TRACER
    assert off._heartbeat is None and off._recorder is None
    assert off.phase_log == [] and off._phases is False
    assert set(os.listdir(tmp_path)) == before
    assert (off.state_count(), off.unique_state_count(), off.max_depth()) == (
        on.state_count(), on.unique_state_count(), on.max_depth())
    assert off.level_log == on.level_log
    assert off.dispatch_log == on.dispatch_log
    assert off.metrics()["metrics_to"] is None


def test_environment_knobs_arm_every_piece(tmp_path, monkeypatch):
    paths = {k: str(tmp_path / k) for k in ("trace", "hb", "series")}
    monkeypatch.setenv("STPU_TRACE", paths["trace"])
    monkeypatch.setenv("STPU_HEARTBEAT", paths["hb"])
    monkeypatch.setenv("STPU_METRICS_TO", paths["series"])
    monkeypatch.setenv("STPU_METRICS_EVERY", "1")
    monkeypatch.setenv("STPU_METRICS_KEEP", "2")
    monkeypatch.setenv("STPU_PHASES", "on")
    c = PackedTwoPhaseSys(3).checker().spawn_xla(device="cpu", **RM3).join()
    assert c._tracer.enabled and c._phases and c._recorder.keep == 2
    assert "phase:enqueue" in _names(_spans(paths["trace"]))
    assert hb_mod.read(paths["hb"])["seq"] == len(c.dispatch_log)
    assert obs.read_series(paths["series"])
    monkeypatch.setenv("STPU_PHASES", "maybe")
    with pytest.raises(ValueError, match="phases"):
        PackedTwoPhaseSys(3).checker().spawn_xla(device="cpu")


def test_single_level_dispatch_spans_and_checkpoint_spans(tmp_path):
    trace = str(tmp_path / "t.jsonl")
    c = PackedTwoPhaseSys(3).checker().spawn_xla(
        device="cpu", trace=trace, phases=True, levels_per_dispatch=1,
        checkpoint_to=str(tmp_path / "ck.npz"), checkpoint_every=4, **RM3).join()
    spans = _spans(trace)
    disp = [r for r in spans if r["name"] == "dispatch"]
    assert len(disp) == len(c.dispatch_log) == len(c.phase_log)
    assert all(r["attrs"]["flavor"] == "single" and not r["attrs"]["compile"] for r in disp)
    assert all(isinstance(r["attrs"]["cand"], int) for r in disp)
    ck = [r for r in spans if r["name"] == "checkpoint"]
    assert len(ck) == c.metrics()["checkpoints_written"] > 0
    assert set(ck[0]["attrs"]) == {"path", "depth", "keep"}


def test_host_verify_spans_count_the_rechecks(tmp_path):
    from stateright_tpu_torch.models.single_copy_register import PackedSingleCopyRegister

    trace = str(tmp_path / "t.jsonl")
    c = PackedSingleCopyRegister(2, 2, device_exact=False).checker().spawn_xla(
        device="cpu", host_verified_cap=128, trace=trace).join()
    hv = [r["attrs"] for r in _spans(trace) if r["name"] == "host_verify"]
    assert hv and set(hv[0]) == {"checked", "confirmed"}
    assert sum(a["checked"] for a in hv) == c.hv_stats["host_checked"]
    assert sum(a["confirmed"] for a in hv) == c.hv_stats["confirmed"] == 1


def test_delta_flush_spans_mark_proactive_flushes(tmp_path):
    trace = str(tmp_path / "t.jsonl")
    c = PackedTwoPhaseSys(5).checker().spawn_xla(
        device="cpu", dedup="delta", table_capacity=1 << 12, trace=trace).join()
    flushes = [r["attrs"] for r in _spans(trace) if r["name"] == "delta_flush"]
    assert len(flushes) == c.metrics()["delta_flushes"] > 0
    assert all(set(a) == {"proactive"} for a in flushes)
    assert c.unique_state_count() == 8_832


# --- the pure functions against the reference's ----------------------------


def test_chrome_export_equals_the_references(runs, tmp_path):
    (_, _, _, _, ppaths), _ = runs["grow"]
    mine, theirs = str(tmp_path / "p.json"), str(tmp_path / "r.json")
    n = obs.export_chrome(ppaths["trace"], mine)
    assert n == ref_obs.export_chrome(ppaths["trace"], theirs) > 0
    with open(mine) as a, open(theirs) as b:
        assert json.load(a) == json.load(b)


def test_trace_context_and_emit_equal_the_references(tmp_path, monkeypatch):
    monkeypatch.setenv(trace_mod.CTX_ENV, trace_mod.format_ctx("ab" * 8, "p.9"))
    out = {}
    for name, mod in (("port", trace_mod), ("ref", ref_obs.trace)):
        tracer = mod.Tracer(str(tmp_path / f"{name}.jsonl"))
        with tracer.span("dispatch", bucket=64) as sp:
            sp.set(committed=2)
        sid = tracer.new_span_id()
        tracer.emit("phase:enqueue", t0=tracer._epoch, dur=0.5, attrs={"bucket": 64},
                    parent_id="x", span_id=sid)
        tracer.close()
        out[name] = _spans(str(tmp_path / f"{name}.jsonl"))
    assert trace_mod.parse_ctx("ab:") == ref_obs.parse_ctx("ab:") == ("ab", None)
    assert trace_mod.parse_ctx("") is None
    for a, b in zip(out["port"], out["ref"]):
        assert set(a) == set(b) and SPAN_KEYS <= set(a) <= CTX_SPAN_KEYS
        assert (a["name"], a.get("trace_id"), a.get("parent_id")) == (
            b["name"], b.get("trace_id"), b.get("parent_id"))
        if a["name"] != "trace_start":
            assert a["attrs"] == b["attrs"]
    assert obs.NULL_TRACER.span("x").span_id is None and not obs.NULL_TRACER.enabled


def test_openmetrics_render_and_parse_equal_the_references(runs):
    (pc, _, _, _, _), _ = runs["grow"]
    snap = pc.metrics()
    samples = promexport.engine_samples(snap, {"job": "j1"})
    assert samples == ref_prom.engine_samples(snap, {"job": "j1"})
    text = promexport.render_openmetrics(samples)
    assert text == ref_prom.render_openmetrics(samples)
    parsed = promexport.parse_openmetrics(text)
    assert parsed == ref_prom.parse_openmetrics(text)
    labels = frozenset({"job": "j1", "engine": "xla", "dedup": "sorted"}.items())
    assert parsed[("stpu_state_count_total", labels)] == pc.state_count()
    assert parsed[("stpu_ladder_jumps_total", labels)] == snap["ladder_jumps"]
    for bad in ("stpu_x 1\n", "# TYPE stpu_x gauge\nstpu_x_total 1\n# EOF\n"):
        with pytest.raises(ValueError):
            promexport.parse_openmetrics(bad)
    name, lab, value = promexport.build_info_sample("cuda")
    assert (name, value, lab["platform"]) == ("stpu_build_info", 1.0, "cuda")
    assert {"torch", "tree"} <= set(lab)


def test_pool_samples_equal_the_references():
    gauges = {
        "queued": 3, "running": 1, "submitted": 9, "jobs_done": 5, "waiting": True,
        "breaker": {"state": "open", "consecutive_wedges": 2},
        "journal": {"records": 41},
        "qos": {"aging_s": 2.5, "classes": {"gold": {"queued": 1, "served": 7}},
                "tenants": {"t1": {"running": 1}}},
        "note": "ignored",
    }
    for prefix in ("stpu_pool", "stpu_fleet"):
        got = promexport.pool_samples(gauges, {"device": "device-0"}, prefix=prefix)
        assert got == ref_prom.pool_samples(gauges, {"device": "device-0"}, prefix=prefix)
        text = promexport.render_openmetrics(got)
        assert text == ref_prom.render_openmetrics(got)
        promexport.parse_openmetrics(text)


def test_collect_equals_the_references(runs, tmp_path):
    (_, _, _, _, ppaths), (_, _, _, _, rpaths) = runs["rm3"]
    root = tmp_path / "run"
    for sub, src in (("port", ppaths["trace"]), ("ref/job-1", rpaths["trace"])):
        (root / sub).mkdir(parents=True)
        with open(src) as fh, open(root / sub / "trace.jsonl", "w") as out:
            out.write(fh.read() + "{torn\n")
    assert collect.trace_files(str(root)) == ref_collect.trace_files(str(root))
    assert collect.collect(str(root)) == ref_collect.collect(str(root))
    n = collect.write(str(root), str(tmp_path / "merged.json"))
    assert n == ref_collect.write(str(root), str(tmp_path / "merged_ref.json"))


def test_recorder_rotation_and_torn_tail_equal_the_references(tmp_path):
    series = {}
    for name, mod in (("port", obs.timeseries), ("ref", ref_obs.timeseries)):
        path = str(tmp_path / name / "m.jsonl")
        rec = mod.MetricsRecorder(path, every="2", keep=3, rotate_rows=2)
        for i in range(7):
            rec.sample({"depth": i}, kind="engine")
        rec.close()
        with open(path, "a") as fh:
            fh.write('{"v": 1, "metrics": {"dep')  # a kill mid-append
        again = mod.MetricsRecorder(path, every="2", keep=3, rotate_rows=2)
        again.sample({"depth": 99})
        again.close()
        series[name] = (
            [os.path.basename(f) for f in mod.series_files(path)],
            [r["metrics"]["depth"] for r in mod.read_series(path)],
            [r["metrics"]["depth"] for r in mod.read_series(path, window=2)],
        )
    assert series["port"] == series["ref"]
    assert series["port"][1][-1] == 99
    with pytest.raises(ValueError, match="metrics_keep"):
        obs.MetricsRecorder(str(tmp_path / "x"), keep=0)
    rec = obs.MetricsRecorder(str(tmp_path / "cad"), every=3)
    assert not rec.due(1) and not rec.due(3) and rec.due(4)


def test_heartbeat_reader_and_counters(tmp_path):
    hb = obs.Heartbeat(str(tmp_path / "beats" / "hb.json"))
    hb.beat("dispatch", compile=True)
    assert hb_mod.read(hb.path)["phase"] == "dispatch" and hb_mod.age_s(hb.path) >= 0
    hb.commit(depth=3)
    beat = hb_mod.read(hb.path)
    assert (beat["seq"], beat["phase"], beat["depth"]) == (1, "idle", 3)
    os.unlink(hb.path)
    assert hb_mod.read(hb.path) is None and hb_mod.age_s(hb.path) is None
    counters = obs.Counters(("a", "b"))
    counters.inc("a")
    counters.inc("c", 2)
    assert counters.snapshot() == {"a": 1, "b": 0, "c": 2} and counters["z"] == 0
