"""The port's engine (stateright_tpu_torch/xla.py) on the CPU against the
reference package's XlaChecker: exact counts, per-level counts, depth and
witness paths. Plus the device rule and the port's import hygiene."""

import ast
import pathlib
import re
from dataclasses import astuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.core import Model as RefModel
from stateright_tpu.core import Property as RefProperty
from stateright_tpu.models import two_phase_commit as ref
from stateright_tpu.ops import sortedset as ref_ss
from stateright_tpu_torch import xla as port_xla
from stateright_tpu_torch.core import Model as PortModel
from stateright_tpu_torch.core import Property as PortProperty
from stateright_tpu_torch.models import two_phase_commit as port

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXPECTED_2PC = {3: (1_146, 288), 4: (8_258, 1_568), 5: (58_146, 8_832)}
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test process: the suite runs several test
    processes on one machine, and torch's default of a thread per core in
    each oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _levels(checker):
    return [(r["depth"], r["generated"], r["unique"]) for r in checker.level_log]


def _assert_same_search(ref_checker, port_checker):
    assert port_checker.state_count() == ref_checker.state_count()
    assert port_checker.unique_state_count() == ref_checker.unique_state_count()
    assert port_checker.max_depth() == ref_checker.max_depth()
    assert _levels(port_checker) == _levels(ref_checker)
    want, got = ref_checker.discoveries(), port_checker.discoveries()
    assert set(got) == set(want) and got
    for name in want:
        # The two packages' state classes differ; compare their fields.
        assert [astuple(s) for s in got[name].into_states()] == [
            astuple(s) for s in want[name].into_states()
        ]
        assert got[name].into_actions() == want[name].into_actions()


@pytest.mark.parametrize("rm", sorted(EXPECTED_2PC))
def test_expected_counts(rm):
    c = port.PackedTwoPhaseSys(rm).checker().spawn_xla(**CPU).join()
    assert (c.state_count(), c.unique_state_count()) == EXPECTED_2PC[rm]
    c.assert_properties()
    assert sum(k for _, k in c.dispatch_log) == len(c.level_log)


@pytest.mark.parametrize("rm", [3, 4])
def test_matches_reference_engine(rm):
    r = ref.PackedTwoPhaseSys(rm).checker().spawn_xla().join()
    c = port.PackedTwoPhaseSys(rm).checker().spawn_xla(**CPU).join()
    _assert_same_search(r, c)
    for name, path in c.discoveries().items():
        c.assert_discovery(name, path.into_actions())


def test_matches_reference_engine_through_both_tpu_kernels(monkeypatch):
    """The reference run with both Pallas kernels in interpret mode."""
    monkeypatch.setenv("STPU_PALLAS_BLOCK", "64")
    monkeypatch.setattr(ref_ss, "INSERT_VIA", "pallas")
    r = ref.PackedTwoPhaseSys(3).checker().spawn_xla(
        dedup="sorted", compaction="pallas", frontier_capacity=1 << 8,
        table_capacity=1 << 10,
    ).join()
    c = port.PackedTwoPhaseSys(3).checker().spawn_xla(**CPU).join()
    _assert_same_search(r, c)


def test_growth_and_retry_paths_keep_the_search(monkeypatch):
    """Tiny table, frontier and candidate buffers: every overflow kind
    fires, is retried, and the committed search is unchanged."""
    monkeypatch.setattr(port_xla, "default_cand_cap", lambda run_cap, a, backend: 64)
    r = ref.PackedTwoPhaseSys(4).checker().spawn_xla().join()
    c = port.PackedTwoPhaseSys(4).checker().spawn_xla(
        frontier_capacity=16, table_capacity=16, **CPU
    ).join()
    m = c.metrics()
    assert m["table_grows"] and m["frontier_grows"] and m["cand_grows"]
    assert m["dispatches"] > m["levels_committed"] == len(c.level_log)
    _assert_same_search(r, c)


@pytest.mark.parametrize("target", [("max_depth", 5), ("state_count", 500)])
def test_targets_match_reference(target):
    kind, value = target

    def run(model, **kw):
        b = model.checker()
        b = b.target_max_depth(value) if kind == "max_depth" else b.target_state_count(value)
        return b.spawn_xla(**kw).join()

    r = run(ref.PackedTwoPhaseSys(4), levels_per_dispatch=1)
    c = run(port.PackedTwoPhaseSys(4), **CPU)
    assert (c.state_count(), c.unique_state_count(), c.max_depth()) == (
        r.state_count(), r.unique_state_count(), r.max_depth()
    )
    assert _levels(c) == _levels(r)


def test_no_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.PackedTwoPhaseSys(3).checker().spawn_xla()
    with pytest.raises(RuntimeError, match="CUDA"):
        port.PackedTwoPhaseSys(3).checker().spawn_xla(device="cuda")


def test_the_backend_makes_every_decision_on_the_cards(monkeypatch):
    """``backend.py`` answers every question that rests on the cards, so
    that no caller branches on a count of them: the CPU has none and
    selects none; on a card, the count, the index and the selection."""
    from stateright_tpu_torch import backend

    cpu = torch.device("cpu")
    selected = []
    monkeypatch.setattr(torch.cuda, "set_device", selected.append)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert (backend.visible_cards(cpu), backend.card_of(cpu)) == (0, None)
    assert backend.platform_label() == "cpu"
    backend.make_current(cpu)
    backend.make_current(None)
    assert selected == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    card = torch.device("cuda")
    assert backend.platform_label() == "cuda"
    assert backend.visible_cards(card) == 2
    assert (backend.card_of(card), backend.card_of(torch.device("cuda", 0))) == (1, 0)
    backend.make_current(1)
    backend.make_current(torch.device("cuda", 0))
    assert selected == [1, torch.device("cuda", 0)]
    assert backend.rank_device(3) == torch.device("cuda", 1)


def test_rejects_models_without_the_packed_protocol():
    with pytest.raises(TypeError, match="PackedModel"):
        port.TwoPhaseSys(3).checker().spawn_xla(**CPU)


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path",
    sorted((ROOT / "stateright_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_port_imports_neither_jax_nor_the_reference_package(path):
    bad = [
        m for m in _imports(path)
        if m.split(".")[0] in ("jax", "jaxlib", "stateright_tpu")
    ]
    assert not bad, f"{path.name} imports {bad}"


#: A string that names a script of the JAX package or of its tools (a path
#: ending in ``.py``, a bare tool name, a ``stateright_tpu.*`` module for
#: ``runpy``/``-m``), or code that imports either. (A bare "stateright_tpu"
#: is the Chrome traces' category, the same in both packages.)
_REFERENCE_RUN = re.compile(
    r"(^|/)stateright_tpu/\S*\.py$|(^|/)tools/\S+\.py$"
    r"|^(stpu_lint|warm_cache|service_chaos)\.py$|^stateright_tpu\.[\w.]+$"
    r"|\b(import|from) (stateright_tpu|jax)\b(?!_)"
)


def _strings(path: pathlib.Path):
    """Every string constant of ``path`` but the docstrings."""
    tree = ast.parse(path.read_text(), str(path))
    docs = set()
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
                and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)):
            docs.add(id(body[0].value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs:
            yield node.value


@pytest.mark.parametrize(
    "path",
    sorted((ROOT / "stateright_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_port_runs_no_script_of_the_reference_package(path):
    """No module of the port, and nothing in ``chip_smoke.py``, names a script
    of the JAX package or its tools to run (the reference's service runs
    ``tools/stpu_lint.py`` and ``tools/warm_cache.py``), nor holds code that
    imports either package."""
    bad = [s for s in _strings(path) if _REFERENCE_RUN.search(s)]
    assert not bad, f"{path.name} names {bad}"


def test_walks_cover_the_fleet_and_the_tools():
    """The two walks above glob the whole package: the fleet, the port's
    tools (the chaos harness, the trace bundle, the graph memory probe) and
    the native host kit, the rank mesh's process group and its worker, and
    the lint package with its wrapper are among the files they check."""
    walked = {str(p.relative_to(ROOT)) for p in (ROOT / "stateright_tpu_torch").rglob("*.py")}
    assert {"stateright_tpu_torch/service/fleet.py",
            "stateright_tpu_torch/tools/__init__.py",
            "stateright_tpu_torch/tools/service_chaos.py",
            "stateright_tpu_torch/tools/trace_bundle.py",
            "stateright_tpu_torch/tools/graph_memory.py",
            "stateright_tpu_torch/native/__init__.py",
            "stateright_tpu_torch/parallel/distributed.py",
            "stateright_tpu_torch/tools/mesh_worker.py",
            "stateright_tpu_torch/_build.py",
            "stateright_tpu_torch/tools/stpu_lint.py",
            *(f"stateright_tpu_torch/analysis/{m}.py" for m in (
                "__init__", "__main__", "astlint", "cache", "census", "cli", "fx_lint",
                "rules", "surfaces"))} <= walked


class _SkipBase:
    """0 -> +1 or +2 (clamped at 4, terminal): "eventually 3" has the
    counterexample 0 -> 2 -> 4, found by the terminal pass."""

    state_words = 1
    max_actions = 2

    def init_states(self):
        return [0]

    def actions(self, state, actions):
        if state < 4:
            actions.extend([1, 2])

    def next_state(self, state, action):
        return min(state + action, 4)

    def pack(self, state):
        return np.array([state], np.uint32)

    def unpack(self, words):
        return int(words[0])

    def packed_init(self):
        return np.array([[0]], np.uint32)


class _RefSkip(_SkipBase, RefModel):
    def properties(self):
        return [RefProperty.eventually("three", lambda _, s: s == 3)]

    def packed_step(self, words):
        x = words[0]
        nxt = jnp.minimum(x + jnp.array([1, 2], jnp.uint32), jnp.uint32(4))[:, None]
        return nxt, jnp.broadcast_to(x < 4, (2,))

    def packed_properties(self, words):
        return jnp.stack([words[0] == 3])


class _PortSkip(_SkipBase, PortModel):
    def properties(self):
        return [PortProperty.eventually("three", lambda _, s: s == 3)]

    def packed_step(self, words):
        x = words[:, 0:1]
        nxt = torch.clamp(x + torch.tensor([1, 2]), max=4)[..., None]
        return nxt, (x < 4).expand(-1, 2)

    def packed_properties(self, words):
        return words[:, 0:1] == 3


def test_eventually_counterexample_from_the_terminal_pass():
    r = _RefSkip().checker().spawn_xla(levels_per_dispatch=1).join()
    c = _PortSkip().checker().spawn_xla(**CPU).join()
    assert (c.state_count(), c.unique_state_count(), c.max_depth()) == (
        r.state_count(), r.unique_state_count(), r.max_depth()
    )
    assert _levels(c) == _levels(r)
    assert c.discoveries()["three"].into_states() == r.discoveries()["three"].into_states()
    assert c.discoveries()["three"].into_actions() == [2, 2]
    c.assert_discovery("three", [2, 2])
