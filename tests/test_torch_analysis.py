"""stpu-lint for the port (``stateright_tpu_torch/analysis``), held against
the JAX package's (``stateright_tpu/analysis``) on the CPU.

Case by case it mirrors ``tests/test_analysis.py`` wherever a rule has a
meaning on CUDA: every rule trips on a deliberately bad golden input (a toy
kernel's aten graph for STPU001, canned ``nvcc``/``ptxas`` text and a fake
``nvcc`` for STPU005/006, an over-budget plan for STPU007, golden source
files for STPU101-103, user families for ADM001/ADM002); the shipped tree
sweeps clean, with the CUDA surfaces skipped here (no ``nvcc``); the CLI
keeps the reference's exit codes; the waiver file, the cache and SARIF
behave as the reference's. Against the reference: the same waiver texts
give equal waivers, splits, expiries and errors; the same report gives the
same human lines and SARIF results; the same golden file gives the same
STPU103 findings; every shipped spec's ``cuda`` plan has the reference's
``tpu`` plan's buckets, candidate caps and rungs, counted in captures; and a
CPU run's program keys lie in the census. Caches and reports go under
``tmp_path``, never under ``runs/``.
"""

import contextlib
import io
import json
import os
import textwrap

import numpy as np
import pytest
import torch

from stateright_tpu.analysis import astlint as ref_astlint
from stateright_tpu.analysis import census as ref_census
from stateright_tpu.analysis import cli as ref_cli
from stateright_tpu.analysis import rules as ref_rules
from stateright_tpu_torch.analysis import (
    RULES,
    Finding,
    WaiverError,
    apply_waivers,
    load_waivers,
    run_lint,
)
from stateright_tpu_torch.analysis import cache as cache_mod
from stateright_tpu_torch.analysis import cli, surfaces
from stateright_tpu_torch.analysis import rules as port_rules
from stateright_tpu_torch.analysis.astlint import lint_file
from stateright_tpu_torch.analysis.census import (
    build_census,
    captures_of,
    census_findings,
    grown_captures,
    plan_for,
)
from stateright_tpu_torch.analysis.fx_lint import (
    blocks_per_sm,
    kernel_findings,
    launch_bounds,
    nvcc_findings,
    ptxas_kernels,
    ptxas_report,
    trace,
    write_hazards,
)
from stateright_tpu_torch.ops import _cuda
from stateright_tpu_torch.service.registry import SHIPPED, resolve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "stateright_tpu_torch", "csrc")
THIS = os.path.relpath(os.path.abspath(__file__), ROOT)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(b=64, w=4):
    return torch.zeros((b, w), dtype=torch.int64)


def _has_nvcc() -> bool:
    try:
        _cuda._nvcc()
    except RuntimeError:
        return False
    return True


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    """One whole lint of the shipped tree through the CLI (no cache), its
    exit code, JSON report, SARIF file, banked census and printed lines."""
    out = tmp_path_factory.mktemp("lint")
    paths = {k: str(out / n) for k, n in (
        ("json", "lint.json"), ("sarif", "lint.sarif"), ("census", "plan.json"))}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--no-cache", "--json-out", paths["json"], "--sarif", paths["sarif"],
                       "--census-out", paths["census"]])
    with open(paths["json"]) as fh:
        report = json.load(fh)
    return {"rc": rc, "report": report, "paths": paths, "stdout": buf.getvalue()}


# --- STPU001: a write that can name one position twice ------------------------


def _scatter_two(words):  # a data-dependent [B, 2] index: two positions a row
    out = words.clone()
    out.scatter_(1, words[:, :2] & 3, words[:, 2:4])
    return out


def _index_put(words):  # a row index from the data: two rows may name one row
    out = words.clone()
    out[words[:, 0] & 3, 0] = words[:, 1]
    return out


def _index_put_two(words):  # an arange over the rows, but two positions a row
    out = words.clone()
    out[torch.arange(words.shape[0]).unsqueeze(1), words[:, :2] & 3] = 1
    return out


def _index_copy(words):
    return words.clone().index_copy_(1, words[0, :2] & 3, words[:, 2:4])


def _put(words):
    return words.clone().put_(words[:, 0] & 7, words[:, 1])


@pytest.mark.parametrize("kernel", [_scatter_two, _index_put, _index_put_two, _index_copy, _put],
                         ids=lambda f: f.__name__)
def test_stpu001_flags_data_dependent_repeat_write(kernel):
    hits = kernel_findings(kernel, (_rows(),), "golden:stpu001")
    assert [f.rule for f in hits] == ["STPU001"]
    assert hits[0].file == THIS  # anchored to THIS file, not the lint
    assert hits[0].line > 0
    assert "write one position twice" in hits[0].message


def test_stpu001_static_index_scatter_is_exempt():
    def ok(words):  # a static index: no data decides where it writes
        out = words.clone()
        out.scatter_(1, torch.tensor([[0, 1]]).expand(words.shape[0], 2), words[:, 2:4])
        return out

    assert write_hazards(trace(ok, _rows()), "golden:static") == []


def test_stpu001_index_put_one_position_a_row_is_clean():
    """``out[arange(B), i] = v`` writes one position a row, told apart by
    the row; so does a data-dependent index of one element."""

    def by_row(words):
        out = words.clone()
        out[torch.arange(words.shape[0]), words[:, 0] & 3] = 1
        return out

    def one(words):
        out = words.clone()
        out[words[0, :1] & 3, 0] = 1
        return out

    for fn in (by_row, one):
        gm = trace(fn, _rows())
        assert any("index_put" in str(n.target) for n in gm.graph.nodes)
        assert write_hazards(gm, "golden:index-put-row") == []


def test_stpu001_one_index_per_row_is_clean():
    """The sanctioned write: packing.Layout.set_ at a traced element index
    writes one position a row (an index of size 1 along the written dim)."""
    from stateright_tpu_torch.packing import LayoutBuilder

    lay = LayoutBuilder().array("xs", 6, 4).finish()

    def good(words):
        return lay.set(words, "xs", 3, words[:, 0] & 3)

    gm = trace(good, _rows(w=lay.words))
    assert any("scatter" in str(n.target) for n in gm.graph.nodes)
    assert write_hazards(gm, "golden:layout-set") == []


# --- rules with no meaning on CUDA (STPU002-004, STPU008) ----------------------


@pytest.mark.parametrize("rule", ["STPU002", "STPU003", "STPU004", "STPU008"])
def test_rule_without_cuda_meaning_stays_registered_and_unwaivable(rule):
    assert rule in ref_rules.RULES
    assert RULES[rule].kind == "none" and RULES[rule].history
    text = f'[[waiver]]\nrule = "{rule}"\nreason = "x"\n'
    assert ref_rules._parse_waivers_toml(text, "w.toml")[0].rule == rule
    with pytest.raises(WaiverError, match="no meaning on CUDA"):
        port_rules._parse_waivers_toml(text, "w.toml")


def test_every_reference_rule_is_registered_with_its_cuda_meaning():
    assert set(ref_rules.RULES) <= set(RULES)
    assert set(RULES) - set(ref_rules.RULES) == {"ADM001", "ADM002"}
    assert {r.kind for r in RULES.values()} == {"fx", "cuda", "plan", "ast", "admission", "none"}
    for r in RULES.values():
        assert r.title and r.history


# --- STPU005/006: nvcc and ptxas ---------------------------------------------

#: What ``nvcc -Xptxas -v`` printed for ``csrc/merge.cu`` on the card
#: machine (CUDA 12.9): the kernel in an anonymous namespace, no cmem.
PTXAS_OK = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__51f36385_8_merge_cu_d7a4989712merge_kernelEPKxxS1_xPbPxPyxS3_' for 'sm_90a'
ptxas info    : Function properties for _ZN40_GLOBAL__N__51f36385_8_merge_cu_d7a4989712merge_kernelEPKxxS1_xPbPxPyxS3_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 22608 bytes smem
ptxas info    : Compile time = 94.075 ms
"""

PTXAS_BAD = """\
ptxas info    : Compiling entry function '_ZN4stpu12merge_kernelEPKxxS1_xPbPxPyxS3_' for 'sm_90a'
ptxas info    : Function properties for _ZN4stpu12merge_kernelEPKxxS1_xPbPxPyxS3_
    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 22560 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z9big_tilesPx' for 'sm_90a'
ptxas info    : Function properties for _Z9big_tilesPx
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, 65536 bytes smem, 360 bytes cmem[0]
"""


def test_stpu005_flags_a_compile_error_at_nvccs_line():
    src = os.path.join(CSRC, "merge.cu")
    text = f'{src}(104): error: identifier "kTlie" is undefined\n1 error detected.\n'
    hits = nvcc_findings(text, 1, "golden:nvcc")
    assert [(f.rule, f.file, f.line) for f in hits] == [
        ("STPU005", "stateright_tpu_torch/csrc/merge.cu", 104)]
    assert "kTlie" in hits[0].message


def test_stpu005_failed_compile_without_a_line_is_a_finding():
    hits = nvcc_findings("nvcc fatal   : Unsupported gpu architecture 'compute_90b'\n", 1,
                         "golden:arch")
    assert [(f.rule, f.line) for f in hits] == [("STPU005", 0)]
    assert "Unsupported gpu architecture" in hits[0].excerpt
    resource = nvcc_findings(
        "ptxas error   : Entry function '_Z1kv' uses too much shared data (0x40000 bytes, "
        "0xc000 max)\n", 255, "golden:ptxas")
    assert [f.rule for f in resource] == ["STPU006"]


def test_stpu005_clean_compile_is_clean():
    assert nvcc_findings(PTXAS_OK, 0, "golden:ok") == []


def test_cuda_surfaces_skip_without_nvcc_and_run_with_one(tmp_path, monkeypatch):
    """Here there is no nvcc: each ``cuda:`` surface is skipped with the
    reason, never passed. With one on PATH (a fake that prints canned
    ptxas output) the surface runs the real flags and reports each
    kernel's resources."""
    names = [f"cuda:{n}" for n in _cuda.SOURCES]
    if not _has_nvcc():
        reports = {r.name: r for r in surfaces.run_sweep(only=["cuda:"], use_cache=False)}
        assert list(reports) == names
        assert all("nvcc" in r.skipped and not r.error for r in reports.values())
    fake = tmp_path / "nvcc"
    log = tmp_path / "argv"
    canned = tmp_path / "out.txt"
    canned.write_text(PTXAS_OK)
    fake.write_text(textwrap.dedent(f"""\
        #!/bin/sh
        echo "$@" >> {log}
        while [ "$1" != "-o" ]; do shift; done
        touch "$2"
        cat {canned}
        """))
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    reports = {r.name: r for r in surfaces.run_sweep(only=["cuda:merge"], use_cache=False)}
    rep = reports["cuda:merge"]
    assert rep.error == "" and rep.skipped == "" and rep.findings == []
    (kernel,) = rep.detail["kernels"]
    assert kernel["kernel"] == "(anonymous namespace)::merge_kernel"
    assert (kernel["registers"], kernel["smem_bytes"], kernel["spill_stores"]) == (40, 22608, 0)
    assert (kernel["max_threads"], kernel["min_blocks"], kernel["blocks_per_sm"]) == (256, 6, 6)
    argv = log.read_text().split()
    assert argv[:len(_cuda.NVCC_FLAGS)] == list(_cuda.NVCC_FLAGS)  # one source of the flags
    assert ["-Xptxas", "-v"] == argv[len(_cuda.NVCC_FLAGS):len(_cuda.NVCC_FLAGS) + 2]


def test_stpu006_flags_spills_and_shared_memory_over_the_limit():
    hits, kernels = ptxas_report(PTXAS_BAD, os.path.join(CSRC, "merge.cu"), "golden:stpu006")
    assert [k["kernel"] for k in kernels] == ["big_tiles", "stpu::merge_kernel"]
    messages = {(f.rule, f.file, f.line): f.message for f in hits}
    assert all(rule == "STPU006" for rule, _, _ in messages)
    spill = messages[("STPU006", "stateright_tpu_torch/csrc/merge.cu", 98)]
    assert "spills 8 bytes stored and 8 loaded" in spill
    smem = [f.message for f in hits if "big_tiles" in f.message]
    assert any("65536 bytes of static shared memory" in m for m in smem)


def test_stpu006_launch_bounds_and_occupancy_of_the_shipped_kernels():
    """The shipped sources' ``__launch_bounds__`` parse to the numbers in
    them, and merge_kernel's ask (6 blocks of 256 threads) fits at 40
    registers and its static shared memory, one more register a thread
    does not."""
    merge = launch_bounds(os.path.join(CSRC, "merge.cu"))["merge_kernel"]
    assert (merge["max_threads"], merge["min_blocks"], merge["line"]) == (256, 6, 98)
    compact = launch_bounds(os.path.join(CSRC, "compact.cu"))["compact_kernel"]
    assert (compact["max_threads"], compact["min_blocks"]) == (512, 1)
    assert compact["file"] == "stateright_tpu_torch/csrc/compact.cuh"
    hashset = launch_bounds(os.path.join(CSRC, "hashset.cu"))
    assert hashset["claim_kernel"]["max_threads"] == 256
    assert {"commit_kernel", "exact_kernel", "undo_kernel"} <= set(hashset)
    assert "max_threads" not in hashset["commit_kernel"]
    assert blocks_per_sm(256, 40, 22608) == 6
    assert blocks_per_sm(256, 41, 22608) == 5
    assert ptxas_kernels(PTXAS_OK)["(anonymous namespace)::merge_kernel"]["registers"] == 40


# --- STPU007: the capture census ---------------------------------------------


def test_stpu007_flags_over_budget_plan():
    plan = plan_for("2pc:3", "cuda", frontier_capacity=1 << 30)
    hits = census_findings({"specs": {"2pc:3": {"cuda": plan}}})
    assert [f.rule for f in hits] == ["STPU007"]
    assert f"captures {plan['captures']} CUDA graphs" in hits[0].message
    assert plan["captures"] > plan["budget"]


def test_census_mux_and_symmetry_classes_count_toward_the_budget():
    solo = plan_for("2pc:3", "cuda")
    assert "mux" not in solo and "sym" not in solo
    plan = plan_for("2pc:3", "cuda", mux_k=4, symmetry=True)
    assert [s["bucket"] for s in plan["mux"]["shapes"]] == [s["bucket"] for s in plan["shapes"]]
    assert plan["mux"]["captures"] == len(plan["shapes"])
    model, _ = resolve("2pc:3")
    assert plan["sym"] == {"tag": f"spec:{model.symmetry_spec.spec_hash()[:12]}",
                           "captures": solo["captures"]}
    assert {k: v for k, v in plan.items() if k not in ("mux", "sym")} == solo
    assert "mux" not in plan_for("scr:3,1", "cuda", mux_k=4)
    tight = dict(plan, budget=solo["captures"] * 2)
    assert [f.rule for f in census_findings({"specs": {"2pc:3": {"cuda": tight}}})] == ["STPU007"]
    assert not census_findings({"specs": {"2pc:3": {"cuda": solo}}})


def test_census_matches_shipped_and_the_references_plan():
    """Every shipped spec's ``cuda`` plan has the reference's ``tpu``
    plan's buckets, candidate caps and rungs, and counts captures: every
    rung of a bucket is captured with it."""
    census = build_census()
    assert list(census["specs"]) == list(SHIPPED)
    assert census_findings(census) == []
    for spec in SHIPPED:
        ref = ref_census.plan_for(spec, "tpu")
        port = census["specs"][spec]["cuda"]
        assert port["shapes"] == ref["shapes"], spec
        assert ref["distinct_programs"] == len(ref["shapes"])
        assert port["captures"] == sum(len(s["rungs"]) for s in ref["shapes"])
        cpu = census["specs"][spec]["cpu"]
        assert [s["bucket"] for s in cpu["shapes"]] == [s["bucket"] for s in port["shapes"]]


@pytest.mark.parametrize("spec", SHIPPED)
def test_a_cpu_runs_programs_lie_in_the_census(spec):
    model, caps = resolve(spec)
    c = model.checker().spawn_xla(device="cpu", **caps).join()
    keys = {k[:3] for k in c._programs.programs}
    assert keys and keys <= captures_of(plan_for(spec, "cpu"))


def test_a_run_whose_candidate_caps_grew_lies_in_the_grown_census(monkeypatch):
    """The census is a lower bound: a run that grows its candidate caps
    captures rungs outside it, and every shape it captures is one the
    planner gives at the caps it grew to, under each frontier ceiling it
    passed through. The CPU run takes the card's candidate caps, so that
    it grows as a run on the card does."""
    from stateright_tpu_torch import xla

    card_cap = xla.default_cand_cap
    monkeypatch.setattr(xla, "default_cand_cap", lambda rc, a, backend: card_cap(rc, a, "cuda"))
    model, caps = resolve("2pc:6")
    c = model.checker().spawn_xla(device="cpu", **{**caps, "frontier_capacity": 1 << 10}).join()
    assert c.unique_state_count() == 50_816
    keys = {k[:3] for k in c._programs.programs}
    ceilings = [1 << 10]
    while ceilings[-1] < c.metrics()["frontier_capacity"]:
        ceilings.append(ceilings[-1] * 2)
    plain = set().union(*(captures_of(plan_for("2pc:6", "cuda", frontier_capacity=f))
                          for f in ceilings))
    hints = model.__dict__[xla.CAND_HINTS]
    assert hints and keys - plain
    assert keys <= grown_captures("2pc:6", "cuda", ceilings, hints)
    assert grown_captures("2pc:6", "cuda", ceilings, {}) == plain


# --- the admission surface (ADM001/ADM002) -----------------------------------


def _user_family(tmp_path, monkeypatch, module, body):
    """``fam`` as a user family from a module of its own (a module name is
    imported once a process)."""
    (tmp_path / f"{module}.py").write_text(textwrap.dedent(body))
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("STPU_FAMILIES", f"fam={module}:fam")


def test_adm001_unpacked_model_is_a_finding_not_an_error(tmp_path, monkeypatch):
    _user_family(tmp_path, monkeypatch, "lint_fam_unpacked", """\
        from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
        def fam(args):
            return TwoPhaseSys(3), {}
        """)
    report = run_lint(admission="fam:3")
    assert report["errors"] == [] and report["ok"] is False and report["partial"] is True
    assert [s["name"] for s in report["surfaces"]] == ["admission:fam:3"]
    (f,) = report["findings"]
    assert f["rule"] == "ADM001" and "packed interface" in f["message"]


def test_adm002_refused_model_and_the_cli_exit_code(tmp_path, monkeypatch, capsys):
    _user_family(tmp_path, monkeypatch, "lint_fam_refused", """\
        from stateright_tpu_torch.models.two_phase_commit import PackedTwoPhaseSys
        def fam(args):
            return PackedTwoPhaseSys(3), {"dedup": "bogus"}
        """)
    assert cli.main(["--admission", "fam:3", "--json"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert [f["rule"] for f in report["findings"]] == ["ADM002"]
    assert "spawn_xla refused PackedTwoPhaseSys" in report["findings"][0]["message"]
    assert {s["name"] for s in report["surfaces"]} == {
        "admission:fam:3", "kernel:fam:3:step", "kernel:fam:3:properties",
        "kernel:fam:3:representative", "plan:fam:3"}


# --- AST rules (STPU101-103) ---------------------------------------------------


def _lint_source(tmp_path, rel, text):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(text))
    return lint_file(str(p), rel)


def test_stpu101_flags_scatter_write_in_models(tmp_path):
    hits = _lint_source(tmp_path, "models/bad_model.py", """
        def packed_step(self, words, i):
            return words.scatter_(-1, i, words)
        """)
    assert [f.rule for f in hits] == ["STPU101"]
    assert "scatter_(-1, i, words)" in hits[0].excerpt
    assert _lint_source(tmp_path, "ops/fine.py",
                        "def f(w, i):\n    return w.scatter_(-1, i, w)\n") == []


def test_stpu102_flags_bare_cuda_bringup(tmp_path):
    hits = _lint_source(tmp_path, "cli_helper.py", """
        import torch
        n = torch.cuda.device_count()
        ok = torch.cuda.is_available()
        torch.cuda.set_device(0)
        """)
    assert [f.rule for f in hits] == ["STPU102"] * 3
    assert _lint_source(tmp_path, "backend.py",
                        "import torch\nn = torch.cuda.device_count()\n") == []
    assert _lint_source(tmp_path, "other.py",
                        "import torch\ns = torch.cuda.current_stream()\n") == []


_SLOPPY = """
def beat(heartbeat_path, payload):
    with open(heartbeat_path, "w") as fh:
        fh.write(payload)

def save(ckpt_dir, blob):
    open(ckpt_dir + "/x", "wb").write(blob)
"""


def test_stpu103_flags_raw_heartbeat_write_as_the_reference(tmp_path):
    hits = _lint_source(tmp_path, "service/sloppy.py", _SLOPPY)
    assert [f.rule for f in hits] == ["STPU103", "STPU103"]
    path = str(tmp_path / "service" / "sloppy.py")
    ref = ref_astlint.lint_file(path, "service/sloppy.py")
    assert [f.to_json() for f in hits] == [f.to_json() for f in ref]
    assert _lint_source(tmp_path, "obs/heartbeat2.py", _SLOPPY) == []
    assert _lint_source(
        tmp_path, "service/reader.py",
        'def read(heartbeat_path):\n    with open(heartbeat_path, "r") as fh:\n'
        '        return fh.read()\n') == []


# --- waivers, against the reference --------------------------------------------

WAIVER_TEXTS = {
    "round_trip": (
        "# comment\n[[waiver]]\nrule = \"STPU001\"\nsurface = \"kernel:*:step\"\n"
        "reason = \"by design\"\n\n[[waiver]]\nrule = \"STPU006\"\nreason = \"never matches\"\n"),
    "by_file": "[[waiver]]\nrule = \"STPU102\"\nfile = \"*/worker.py\"\nreason = \"pinning\"\n",
    "expired": ("[[waiver]]\nrule = \"STPU001\"\nsurface = \"kernel:*:step\"\n"
                "reason = \"pending\"\nexpires = \"2026-01-01\"\n"),
    "future": ("[[waiver]]\nrule = \"STPU001\"\nsurface = \"kernel:*:step\"\n"
               "reason = \"pending\"\nexpires = \"2099-01-01\"\n"),
    "unquoted": "[[waiver]]\nrule = STPU001\n",
    "unknown_rule": "[[waiver]]\nrule = \"STPU999\"\nreason = \"x\"\n",
    "no_reason": "[[waiver]]\nrule = \"STPU001\"\n",
    "empty_reason": "[[waiver]]\nrule = \"STPU001\"\nreason = \"  \"\n",
    "bad_date": "[[waiver]]\nrule = \"STPU001\"\nreason = \"x\"\nexpires = \"soonish\"\n",
    "stray_key": "rule = \"STPU001\"\n",
    "empty": "# nothing\n",
}


def _findings(finding_cls):
    return [
        finding_cls(rule="STPU001", surface="kernel:2pc:3:step", file="a.py", line=5,
                    message="m", excerpt="e"),
        finding_cls(rule="STPU001", surface="kernel:2pc:3:properties", file="b.py", line=9,
                    message="m", excerpt="e"),
        finding_cls(rule="STPU102", surface="ast:x", file="pkg/service/worker.py", line=3,
                    message="m", excerpt="e"),
    ]


def _split(mod, text):
    try:
        waivers = mod._parse_waivers_toml(text, "w.toml")
    except mod.WaiverError as e:
        # The list of known rules differs by ADM001/ADM002; the rest is equal.
        return ("error", str(e).split("; known:")[0])
    active, waived, unused = mod.apply_waivers(_findings(mod.Finding), waivers)
    return (
        [(w.rule, w.reason, w.surface, w.file, w.expires, w.expired) for w in waivers],
        [f.to_json() for f in active],
        [f.to_json() for f in waived],
        [(w.rule, w.used) for w in unused],
    )


@pytest.mark.parametrize("case", sorted(WAIVER_TEXTS))
def test_waiver_texts_parse_and_split_as_the_reference(case):
    assert _split(port_rules, WAIVER_TEXTS[case]) == _split(ref_rules, WAIVER_TEXTS[case])


def test_waiver_round_trip(tmp_path):
    wpath = tmp_path / "w.toml"
    wpath.write_text(WAIVER_TEXTS["round_trip"])
    active, waived, unused = apply_waivers(_findings(Finding), load_waivers(str(wpath)))
    assert [f.surface for f in active] == ["kernel:2pc:3:properties", "ast:x"]
    assert [f.surface for f in waived] == ["kernel:2pc:3:step"]
    assert waived[0].waiver_reason == "by design"
    assert [w.rule for w in unused] == ["STPU006"]


def test_waiver_expiry_stops_suppressing(tmp_path):
    wpath = tmp_path / "w.toml"
    wpath.write_text(WAIVER_TEXTS["expired"])
    waivers = load_waivers(str(wpath))
    assert waivers[0].expired
    active, waived, unused = apply_waivers(_findings(Finding)[:1], waivers)
    assert len(active) == 1 and waived == [] and unused == waivers
    wpath.write_text(WAIVER_TEXTS["future"])
    active, waived, unused = apply_waivers(_findings(Finding)[:1], load_waivers(str(wpath)))
    assert active == [] and len(waived) == 1 and unused == []
    wpath.write_text(WAIVER_TEXTS["bad_date"])
    with pytest.raises(WaiverError, match="YYYY-MM-DD"):
        load_waivers(str(wpath))


def test_expired_waiver_reported_in_cli_report(tmp_path):
    wpath = tmp_path / "w.toml"
    wpath.write_text('[[waiver]]\nrule = "STPU006"\nreason = "pending"\n'
                     'expires = "2026-01-01"\n')
    report = run_lint(trace=False, ast_pass=True, waivers_path=str(wpath))
    assert report["partial"] is True
    expired = [w for w in report["unused_waivers"] if w["expired"]]
    assert [w["rule"] for w in expired] == ["STPU006"]
    assert expired[0]["expires"] == "2026-01-01"


def test_waiver_file_is_loud_on_garbage(tmp_path):
    bad = tmp_path / "w.toml"
    for case in ("unquoted", "unknown_rule", "no_reason"):
        bad.write_text(WAIVER_TEXTS[case])
        with pytest.raises(WaiverError):
            load_waivers(str(bad))
    assert load_waivers(str(tmp_path / "missing.toml")) == []


# --- the shipped tree sweeps clean ---------------------------------------------


def test_full_lint_clean_with_cuda_surfaces_skipped(full_run):
    report = full_run["report"]
    assert full_run["rc"] == 0
    assert report["ok"] is True and report["partial"] is False
    assert report["errors"] == [] and report["findings"] == []
    assert report["unused_waivers"] == []
    names = [s["name"] for s in report["surfaces"]]
    for spec in SHIPPED:
        assert {f"admission:{spec}", f"kernel:{spec}:step", f"kernel:{spec}:properties",
                f"plan:{spec}"} <= set(names)
    model_sym = {spec for spec in SHIPPED
                 if getattr(resolve(spec)[0], "symmetry_spec", None) is not None
                 or hasattr(resolve(spec)[0], "packed_representative")}
    assert {n.split(":")[1] + ":" + n.split(":")[2] for n in names
            if n.endswith(":representative")} == model_sym
    cuda = {s["name"]: s for s in report["surfaces"] if s["name"].startswith("cuda:")}
    assert list(cuda) == [f"cuda:{n}" for n in _cuda.SOURCES]
    if not _has_nvcc():
        assert all("nvcc not found" in s["skipped"] for s in cuda.values())
        assert "skipped cuda:merge: nvcc not found" in full_run["stdout"]
    assert full_run["stdout"].rstrip().endswith("-> OK")


def test_ast_pass_shipped_tree_clean():
    report = run_lint(trace=False, ast_pass=True)
    assert report["errors"] == []
    assert report["findings"] == [], report["findings"]


def test_trace_sweep_shipped_subset_clean(tmp_path):
    report = run_lint(trace=True, ast_pass=False, only=["2pc:3"], cache_dir=str(tmp_path))
    assert report["errors"] == [] and report["findings"] == []
    assert {s["name"] for s in report["surfaces"]} == {
        "admission:2pc:3", "kernel:2pc:3:step", "kernel:2pc:3:properties",
        "kernel:2pc:3:representative", "plan:2pc:3"}


# --- CLI exit codes and the partial contract ------------------------------------


def _golden(rule, tmp_path):
    """One golden-bad input of ``rule`` as a sweep surface's findings."""
    if rule == "STPU001":
        return kernel_findings(_scatter_two, (_rows(),), "golden:stpu001")
    if rule == "STPU005":
        return nvcc_findings(f"{CSRC}/merge.cu(1): error: expected a ';'\n", 1, "golden:nvcc")
    if rule == "STPU006":
        return ptxas_report(PTXAS_BAD, os.path.join(CSRC, "merge.cu"), "golden:ptxas")[0]
    if rule == "STPU007":
        plan = plan_for("2pc:3", "cuda", frontier_capacity=1 << 30)
        return census_findings({"specs": {"2pc:3": {"cuda": plan}}})
    rel = {"STPU101": "models/m.py", "STPU102": "helper.py", "STPU103": "service/s.py"}[rule]
    src = {"STPU101": "def f(w, i):\n    return w.index_put_((i,), w)\n",
           "STPU102": "import torch\nok = torch.cuda.is_available()\n",
           "STPU103": _SLOPPY}[rule]
    return _lint_source(tmp_path, rel, src)


@pytest.mark.parametrize("rule", ["STPU001", "STPU005", "STPU006", "STPU007", "STPU101",
                                  "STPU102", "STPU103"])
def test_cli_exit_1_on_each_golden_bad_input(rule, tmp_path, monkeypatch, capsys):
    hits = _golden(rule, tmp_path)
    assert hits and {f.rule for f in hits} == {rule}
    monkeypatch.setattr(surfaces, "build_sweep", lambda full=False: [("golden", lambda: hits)])
    assert cli.main(["--no-ast", "--no-cache", "--json", "--census-out", ""]) == 1
    report = json.loads(capsys.readouterr().out)
    assert {f["rule"] for f in report["findings"]} == {rule}


def test_cli_exit_0_and_list_rules(capsys, tmp_path):
    empty = tmp_path / "w.toml"
    empty.write_text("")
    assert cli.main(["--no-trace", "--waivers", str(empty)]) == 0
    assert capsys.readouterr().out.rstrip().endswith("-> OK")
    assert cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(f"{r} [" in out for r in RULES)
    assert cli.main(["--rules", "STPU999"]) == 2


def test_cli_exit_2_on_malformed_waiver_file(tmp_path, capsys):
    bad = tmp_path / "w.toml"
    bad.write_text(WAIVER_TEXTS["unquoted"])
    assert cli.main(["--no-trace", "--waivers", str(bad)]) == 2
    assert "waiver file error" in capsys.readouterr().err


def test_cli_exit_2_on_surface_trace_failure(monkeypatch, tmp_path):
    def boom():
        raise RuntimeError("golden trace failure")

    monkeypatch.setattr(surfaces, "build_sweep", lambda full=False: [("golden:boom", boom)])
    out = tmp_path / "lint.json"
    assert cli.main(["--no-ast", "--no-cache", "--json-out", str(out)]) == 2
    report = json.loads(out.read_text())
    assert report["ok"] is False
    assert report["errors"] == ["golden:boom: RuntimeError: golden trace failure"]
    assert report["surfaces"][0]["error"].startswith("RuntimeError")


def test_cli_exit_2_on_unknown_admission_spec(capsys):
    assert cli.main(["--admission", "nosuchfamily:3", "--no-cache", "--json"]) == 2
    captured = capsys.readouterr()
    assert "unknown model spec" in captured.err
    report = json.loads(captured.out)
    assert report["ok"] is False and report["errors"]
    assert report["admission"] == "nosuchfamily:3"


def test_partial_contract(tmp_path):
    assert run_lint(trace=False, ast_pass=True)["partial"] is True
    assert run_lint(trace=True, ast_pass=False, only=["plan:2pc:3"],
                    cache_dir=str(tmp_path))["partial"] is True
    assert run_lint(trace=False, ast_pass=True, rules=["STPU101"])["partial"] is True
    # A filter naming only a rule with no meaning runs nothing, and says so.
    nothing = run_lint(rules=["STPU003"])
    assert nothing["surfaces"] == [] and nothing["ok"] is True and nothing["partial"] is True


def test_clean_full_run_banks_the_census(full_run):
    with open(full_run["paths"]["census"]) as fh:
        banked = json.load(fh)
    assert banked["tree"] == cache_mod.tree_hash()[:12]
    assert list(banked["specs"]) == list(SHIPPED)
    assert banked["specs"] == build_census()["specs"]


# --- the content-hash surface cache --------------------------------------------


def test_surface_cache_round_trip(tmp_path):
    cold = surfaces.run_sweep(only=["plan:2pc:3"], cache_dir=str(tmp_path))
    assert [r.cached for r in cold] == [False]
    warm = surfaces.run_sweep(only=["plan:2pc:3"], cache_dir=str(tmp_path))
    assert [r.cached for r in warm] == [True]
    assert [f.to_json() for f in warm[0].findings] == [f.to_json() for f in cold[0].findings]
    fresh = surfaces.run_sweep(only=["plan:2pc:3"], cache_dir=str(tmp_path), use_cache=False)
    assert [r.cached for r in fresh] == [False]


def test_full_census_is_cached_apart_from_the_plain_one(tmp_path, monkeypatch):
    """``--full`` prices the mux and symmetry classes: after a cached plain
    run it computes its own verdict, and neither replays the other's."""
    from stateright_tpu_torch.analysis import census as census_mod

    solo = max(plan_for("2pc:3", p)["captures"] for p in ("cpu", "cuda"))
    monkeypatch.setattr(census_mod, "MAX_CAPTURES", solo)

    def sweep(full):
        reps = surfaces.run_sweep(full=full, only=["plan:2pc:3"], cache_dir=str(tmp_path))
        return [(r.name, r.cached, sorted({f.rule for f in r.findings})) for r in reps]

    assert sweep(False) == [("plan:2pc:3", False, [])]
    assert sweep(True) == [("plan:2pc:3:full", False, ["STPU007"])]
    assert sweep(False) == [("plan:2pc:3", True, [])]
    assert sweep(True) == [("plan:2pc:3:full", True, ["STPU007"])]


def test_errors_skips_and_cuda_surfaces_are_never_cached(tmp_path, monkeypatch):
    from stateright_tpu_torch.analysis.surfaces import SurfaceSkip

    def skip():
        raise SurfaceSkip("no toolkit")

    def boom():
        raise RuntimeError("x")

    monkeypatch.setattr(surfaces, "build_sweep", lambda full=False: [
        ("golden:skip", skip), ("golden:boom", boom), ("cuda:golden", lambda: ([], {"k": 1}))])
    for _ in range(2):
        reps = surfaces.run_sweep(cache_dir=str(tmp_path))
        assert [r.cached for r in reps] == [False, False, False]
    assert reps[2].detail == {"k": 1}


def test_surface_cache_invalidates_on_tree_change(tmp_path, monkeypatch):
    c1 = cache_mod.SurfaceCache(str(tmp_path))
    f = Finding(rule="STPU001", surface="s", file="f.py", line=1, message="m", excerpt="e")
    c1.put("s", [f])
    assert [x.message for x in c1.get("s")] == ["m"]
    monkeypatch.setattr(cache_mod, "_tree_hash_memo", "f" * 64)
    c2 = cache_mod.SurfaceCache(str(tmp_path))
    assert c2.get("s") is None
    c2.put("s", [])
    assert "f" * 12 in os.listdir(tmp_path)
    assert c1.dir.split(os.sep)[-1] in os.listdir(tmp_path)


def test_surface_cache_bounds_tree_dirs(tmp_path, monkeypatch):
    import time as time_mod

    for i in range(6):
        d = tmp_path / f"{i:012d}"
        d.mkdir()
        (d / "x.json").write_text("{}")
        old = time_mod.time() - (10 - i) * 1000
        os.utime(d, (old, old))
    monkeypatch.setattr(cache_mod, "_tree_hash_memo", "a" * 64)
    monkeypatch.setattr(cache_mod, "KEEP_TREES", 3)
    cache = cache_mod.SurfaceCache(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["000000000004", "000000000005"]
    cache.put("s", [])
    assert sorted(os.listdir(tmp_path)) == ["000000000004", "000000000005", "a" * 12]
    monkeypatch.setattr(cache_mod, "KEEP_TREES", 1)
    cache_mod.SurfaceCache(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["a" * 12]


def test_tree_hash_covers_cuda_sources_and_keys_the_build_info(tmp_path):
    from stateright_tpu_torch.obs import promexport

    (tmp_path / "a.py").write_text("x = 1\n")
    (tmp_path / "k.cu").write_text("// v1\n")
    h1 = cache_mod.tree_hash(str(tmp_path))
    (tmp_path / "k.cu").write_text("// v2\n")
    assert cache_mod.tree_hash(str(tmp_path)) != h1
    (tmp_path / "notes.txt").write_text("not a source")
    assert cache_mod.tree_hash(str(tmp_path)) == cache_mod.tree_hash(str(tmp_path))
    _, labels, _ = promexport.build_info_sample("cpu")
    assert labels["tree"] == cache_mod.tree_hash()[:12]
    assert cache_mod.DEFAULT_CACHE_DIR.endswith(os.path.join("runs", "torch_lint_cache"))


# --- human output and SARIF, against the reference ------------------------------

_REPORT = {
    "ok": False, "partial": False, "admission": None, "elapsed_s": 1.5,
    "surfaces": [
        {"name": "kernel:2pc:3:step", "seconds": 0.1, "findings": 1, "error": "",
         "skipped": "", "cached": True},
        {"name": "cuda:merge", "seconds": 0.0, "findings": 0, "error": "",
         "skipped": "nvcc not found", "cached": False},
    ],
    "findings": [
        {"rule": "STPU001", "surface": "kernel:2pc:3:step", "file": "pkg/m.py", "line": 7,
         "message": "write twice", "excerpt": "scatter_", "waived": False,
         "waiver_reason": ""},
        {"rule": "STPU007", "surface": "plan:2pc:3:cuda", "file": "", "line": 0,
         "message": "over budget", "excerpt": "", "waived": False, "waiver_reason": ""},
    ],
    "waived": [
        {"rule": "STPU102", "surface": "ast:w", "file": "pkg/w.py", "line": 0,
         "message": "probe", "excerpt": "x", "waived": True, "waiver_reason": "pinning"},
    ],
    "unused_waivers": [
        {"rule": "STPU006", "surface": "*", "file": "*", "reason": "r", "expires": "",
         "expired": False},
        {"rule": "STPU001", "surface": "k", "file": "*", "reason": "r",
         "expires": "2026-01-01", "expired": True},
    ],
    "errors": ["golden:boom: RuntimeError: x"],
}


def test_human_lines_and_sarif_results_equal_the_references(tmp_path):
    outs = []
    for mod in (cli, ref_cli):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod._print_human(_REPORT)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    results = []
    for mod, name in ((cli, "port.sarif"), (ref_cli, "ref.sarif")):
        mod.write_sarif(_REPORT, str(tmp_path / name))
        results.append(json.loads((tmp_path / name).read_text())["runs"][0]["results"])
    assert results[0] == results[1]


def test_sarif_output(full_run):
    with open(full_run["paths"]["sarif"]) as fh:
        sarif = json.load(fh)
    assert sarif["version"] == "2.1.0"
    run = sarif["runs"][0]
    assert run["tool"]["driver"]["name"] == "stpu-lint"
    rule_ids = {r["id"] for r in run["tool"]["driver"]["rules"]}
    assert rule_ids == set(RULES)
    assert run["results"] == []  # the shipped tree: nothing to annotate


def test_kernel_graphs_are_traced_on_fake_tensors_only():
    """A trace runs nothing: the graph has the kernel's shapes, and no
    cache of the package keeps a fake tensor afterwards (a later real run
    in the same process reads its own)."""
    from stateright_tpu_torch.semantics import device

    model, _ = resolve("abd:2")
    gm = trace(lambda w: model.packed_properties(w), torch.zeros((8, model.state_words),
                                                                 dtype=torch.int64))
    out = [n for n in gm.graph.nodes if n.op == "output"][0]
    assert tuple(out.args[0].meta["val"].shape) == (8, len(model.properties()))
    assert device._step_tables.cache_info().currsize == 0
    words = torch.as_tensor(np.asarray(model.packed_init()), dtype=torch.int64)
    assert model.packed_properties(words).shape == (len(words), len(model.properties()))
