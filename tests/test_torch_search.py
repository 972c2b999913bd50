"""The port's host engines (stateright_tpu_torch/checker/{search,visitor,
parallel_host,parallel_dfs}.py, test_util.py) and the GPU engine's visitor
path, against the reference package's on the CPU:

- ``BfsChecker``/``DfsChecker`` on the ``test_util`` fixtures, case for case
  with the reference's ``tests/test_checker_bfs.py``, ``test_checker_dfs.py``,
  ``test_path.py`` and ``test_report.py``, and their visit orders equal to
  the reference's;
- ``Checker.join_and_report`` gives the reference's report text;
- ``ParallelBfsChecker``/``ParallelDfsChecker`` at ``threads(2)`` give the
  reference's counts and discoveries on 2pc rm=4 and Paxos 2c/3s;
- ``spawn_xla(device="cpu")`` with a visitor records the reference's
  ``spawn_xla`` visitor paths, one level per dispatch, and with
  ``symmetry()`` reduces to the reference's class count.

Everything is exact (integer work)."""

import io
from dataclasses import astuple

import pytest
import torch

import stateright_tpu as ref_api
from stateright_tpu import test_util as ref_util
from stateright_tpu.models import two_phase_commit as ref_2pc
from stateright_tpu_torch import (
    Model,
    NondeterministicModelError,
    Path,
    PathRecorder,
    Property,
    StateRecorder,
    WriteReporter,
    fingerprint,
)
from stateright_tpu_torch.checker.parallel_dfs import ParallelDfsChecker
from stateright_tpu_torch.checker.parallel_host import ParallelBfsChecker, _eval_properties
from stateright_tpu_torch.checker.search import BfsChecker, DfsChecker
from stateright_tpu_torch import test_util as port_util
from stateright_tpu_torch.models import two_phase_commit as port_2pc
from stateright_tpu_torch.models.paxos import PackedPaxos
from stateright_tpu_torch.test_util import DGraph, FnModel, Guess, LinearEquation, PackedDGraph

CPU = dict(device="cpu")
#: The reference's pins for Paxos 2c/3s (paxos.rs:321,345), which its
#: parallel engines reach at threads(2) too.
PAXOS2 = (32_971, 16_668)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test process: the suite runs several test
    processes on one machine, and torch's default of a thread per core in
    each oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _visit_order(package_util, recorder_cls, spawn):
    recorder, accessor = recorder_cls.new_with_accessor()
    builder = package_util.LinearEquation(2, 10, 14).checker().visitor(recorder)
    getattr(builder, spawn)().join()
    return accessor()


# --- tests/test_checker_bfs.py ----------------------------------------------


def test_visits_states_in_bfs_order():
    got = _visit_order(port_util, StateRecorder, "spawn_bfs")
    assert got == [(0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2), (3, 0), (2, 1)]
    assert got == _visit_order(ref_util, ref_api.StateRecorder, "spawn_bfs")


def test_bfs_can_complete_by_enumerating_all_states():
    checker = LinearEquation(2, 4, 7).checker().spawn_bfs().join()
    assert isinstance(checker, BfsChecker) and checker.is_done()
    checker.assert_no_discovery("solvable")
    assert checker.unique_state_count() == 256 * 256


def test_bfs_can_complete_by_eliminating_properties():
    checker = LinearEquation(2, 10, 14).checker().spawn_bfs().join()
    checker.assert_properties()
    assert checker.unique_state_count() == 12
    assert checker.discovery("solvable").into_actions() == [
        Guess.INCREASE_X, Guess.INCREASE_X, Guess.INCREASE_Y,
    ]
    checker.assert_discovery("solvable", [Guess.INCREASE_Y] * 27)


# --- tests/test_checker_dfs.py ----------------------------------------------


def test_visits_states_in_dfs_order():
    got = _visit_order(port_util, StateRecorder, "spawn_dfs")
    assert got == [(0, y) for y in range(28)]
    assert got == _visit_order(ref_util, ref_api.StateRecorder, "spawn_dfs")


def test_dfs_can_complete_by_enumerating_all_states():
    checker = LinearEquation(2, 4, 7).checker().spawn_dfs().join()
    assert isinstance(checker, DfsChecker) and checker.is_done()
    checker.assert_no_discovery("solvable")
    assert checker.unique_state_count() == 256 * 256


def test_dfs_can_complete_by_eliminating_properties():
    checker = LinearEquation(2, 10, 14).checker().spawn_dfs().join()
    checker.assert_properties()
    assert checker.unique_state_count() == 55
    assert checker.discovery("solvable").into_actions() == [Guess.INCREASE_Y] * 27
    checker.assert_discovery("solvable", [Guess.INCREASE_X, Guess.INCREASE_Y, Guess.INCREASE_X])


class _Sys(Model):
    """The symmetry-reduction regression model (dfs.rs:536-623): a buggy
    reduction that enqueues the representative collects invalid paths, and
    PathRecorder's reconstruction raises on them."""

    PAUSED, LOADING, RUNNING = 0, 1, 2

    def init_states(self):
        return [(self.LOADING, self.LOADING)]

    def actions(self, state, actions):
        actions.extend([0, 1])

    def next_state(self, state, action):
        procs = list(state)
        p = procs[action]
        procs[action] = self.RUNNING if p in (self.LOADING, self.PAUSED) else self.PAUSED
        return tuple(procs)

    def properties(self):
        return [
            Property.always("visit all states", lambda _, s: True),
            Property.sometimes(
                "a process pauses", lambda _, s: s[0] == _Sys.PAUSED or s[1] == _Sys.PAUSED),
        ]


@pytest.mark.parametrize("spawn", ["spawn_dfs", "spawn_bfs"])
def test_can_apply_symmetry_reduction(spawn):
    assert getattr(_Sys().checker(), spawn)().join().unique_state_count() == 9
    visitor, accessor = PathRecorder.new_with_accessor()
    builder = _Sys().checker().symmetry_fn(lambda s: tuple(sorted(s))).visitor(visitor)
    checker = getattr(builder, spawn)().join()
    assert checker.unique_state_count() == 6
    assert accessor()


# --- tests/test_path.py -------------------------------------------------------


def test_can_build_path_from_fingerprints():
    model = LinearEquation(2, 10, 14)
    fps = [fingerprint(s) for s in ((0, 0), (0, 1), (1, 1), (2, 1))]
    path = Path.from_fingerprints(model, fps)
    assert path.last_state() == (2, 1) == Path.final_state(model, fps)
    assert fps == [ref_api.fingerprint(s) for s in ((0, 0), (0, 1), (1, 1), (2, 1))]


def test_panics_if_unable_to_reconstruct_init_state():
    def fn(prev, out):
        if prev is None:
            out.append("UNEXPECTED")

    with pytest.raises(NondeterministicModelError):
        Path.from_fingerprints(FnModel(fn), [fingerprint("expected")])


def test_panics_if_unable_to_reconstruct_next_state():
    def fn(prev, out):
        out.append("expected" if prev is None else "UNEXPECTED")

    with pytest.raises(NondeterministicModelError):
        Path.from_fingerprints(FnModel(fn), [fingerprint("expected"), fingerprint("expected")])


def test_encode_and_from_actions():
    model = LinearEquation(2, 10, 14)
    path = Path.from_actions(model, (0, 0), [Guess.INCREASE_X, Guess.INCREASE_Y])
    assert path.into_states() == [(0, 0), (1, 0), (1, 1)]
    assert path.into_actions() == [Guess.INCREASE_X, Guess.INCREASE_Y]
    assert len(path.encode().split("/")) == 3
    assert Path.from_actions(model, (9, 9), [Guess.INCREASE_X]) is None


# --- tests/test_report.py, and join_and_report --------------------------------


def _report(checker, join_and_report=False):
    """The report text of ``checker`` (of either package) split around the
    ``sec=`` field: ``(before, the lines after it)``."""
    out = io.StringIO()
    writer = ref_api.WriteReporter if isinstance(checker, ref_api.Checker) else WriteReporter
    (checker.join_and_report if join_and_report else checker.report)(writer(out))
    head, tail = out.getvalue().split("sec=")
    return head, tail.split("\n", 1)[1]


@pytest.mark.parametrize("spawn, done", [
    ("spawn_bfs", "Done. states=15, unique=12, depth=4, "),
    ("spawn_dfs", "Done. states=55, unique=55, depth=28, "),
])
def test_report_includes_property_names_and_paths(spawn, done):
    head, tail = _report(getattr(LinearEquation(2, 10, 14).checker(), spawn)())
    assert head == "Checking. states=1, unique=1, depth=0\n" + done
    n = 3 if spawn == "spawn_bfs" else 27
    assert tail.startswith(f'Discovered "solvable" example Path[{n}]:\n')
    assert (head, tail) == _report(getattr(ref_util.LinearEquation(2, 10, 14).checker(), spawn)())


@pytest.mark.parametrize("engine", ["spawn_bfs", "spawn_xla"])
def test_join_and_report_equals_the_references(engine):
    """2pc rm=3, up to the ``sec=`` field and from the discoveries on."""
    kw = CPU if engine == "spawn_xla" else {}
    model = port_2pc.PackedTwoPhaseSys(3) if kw else port_2pc.TwoPhaseSys(3)
    ref_model = ref_2pc.PackedTwoPhaseSys(3) if kw else ref_2pc.TwoPhaseSys(3)
    got = _report(getattr(model.checker(), engine)(**kw), join_and_report=True)
    want = _report(getattr(ref_model.checker(), engine)(), join_and_report=True)
    assert got == want
    assert got[0].endswith("Done. states=1146, unique=288, depth=11, ")


# --- threads(n): the parallel host engines ------------------------------------


@pytest.mark.parametrize("spawn, cls", [("spawn_bfs", ParallelBfsChecker),
                                        ("spawn_dfs", ParallelDfsChecker)])
def test_threads_on_2pc_equal_the_references(spawn, cls):
    got = getattr(port_2pc.TwoPhaseSys(4).checker().threads(2), spawn)()
    assert isinstance(got, cls)
    got.join()
    want = getattr(ref_2pc.TwoPhaseSys(4).checker().threads(2), spawn)().join()
    assert (got.state_count(), got.unique_state_count()) == (
        want.state_count(), want.unique_state_count()) == (8_258, 1_568)
    assert set(got.discoveries()) == set(want.discoveries())
    if spawn == "spawn_bfs":
        # Each engine elects the witness of lowest object fingerprint, and
        # an object state's fingerprint is tagged with its class's module,
        # so the two packages may elect different witnesses of one depth.
        assert got.max_depth() == want.max_depth() == 14
        assert {k: len(p) for k, p in got.discoveries().items()} == {
            k: len(p) for k, p in want.discoveries().items()}
    for name, path in got.discoveries().items():
        got.assert_discovery(name, path.into_actions())


@pytest.mark.parametrize("spawn", ["spawn_bfs", "spawn_dfs"])
def test_threads_on_paxos_reach_the_references_counts(spawn):
    c = getattr(PackedPaxos(2, 3).checker().threads(2), spawn)().join()
    assert (c.state_count(), c.unique_state_count()) == PAXOS2
    assert set(c.discoveries()) == {"value chosen"}
    c.assert_properties()
    if spawn == "spawn_bfs":
        assert len(c.discoveries()["value chosen"]) == 8


def test_threads_with_a_visitor_fall_back_to_the_sequential_engines():
    for spawn, cls in (("spawn_bfs", BfsChecker), ("spawn_dfs", DfsChecker)):
        c = getattr(port_2pc.TwoPhaseSys(3).checker().threads(3).visitor(lambda p: None), spawn)()
        assert type(c) is cls
    with pytest.raises(ValueError, match="visitor"):
        ParallelBfsChecker(port_2pc.TwoPhaseSys(3).checker().threads(2).visitor(lambda p: None))


@pytest.mark.parametrize("spawn", ["spawn_bfs", "spawn_dfs"])
def test_host_symmetry_counts_equal_the_references(spawn):
    """The object-level ``representative()`` under the sequential engines:
    2pc rm=3 reduces 288 states to 94 (BFS) or 107 (DFS), as in the
    reference, whose class choice follows the same visit order."""
    got = getattr(port_2pc.TwoPhaseSys(3).checker().symmetry(), spawn)().join()
    want = getattr(ref_2pc.TwoPhaseSys(3).checker().symmetry(), spawn)().join()
    assert (got.state_count(), got.unique_state_count()) == (
        want.state_count(), want.unique_state_count())
    assert got.unique_state_count() == {"spawn_bfs": 94, "spawn_dfs": 107}[spawn]
    for name, path in got.discoveries().items():
        got.assert_discovery(name, path.into_actions())


def test_parallel_eventually_counterexample_and_ebits():
    g = (DGraph.with_property(Property.eventually("odd", lambda _, s: s % 2 == 1))
         .with_path([0, 2, 4]).with_path([0, 1]))
    for spawn in ("spawn_bfs", "spawn_dfs"):
        disc = getattr(g.checker().threads(2), spawn)().join().discoveries()
        assert disc["odd"].last_state() % 2 == 0
    props = [Property.eventually("odd", lambda _, s: s % 2 == 1)]
    discoveries = {0: 0xDEAD}
    assert _eval_properties(None, props, 3, 0xBEEF, frozenset({0}), discoveries) == frozenset()
    assert discoveries == {0: 0xDEAD}


def test_parallel_symmetry_is_deterministic_and_reduces():
    """As in the reference's test: which class member continues the search
    depends on the owner of its representative's fingerprint, so counts
    are compared run to run, and against the sequential engine's
    discoveries."""
    seq = port_2pc.TwoPhaseSys(3).checker().symmetry().spawn_bfs().join()
    a = port_2pc.TwoPhaseSys(3).checker().threads(3).symmetry().spawn_bfs().join()
    b = port_2pc.TwoPhaseSys(3).checker().threads(3).symmetry().spawn_bfs().join()
    assert (a.state_count(), a.unique_state_count()) == (b.state_count(), b.unique_state_count())
    assert a.unique_state_count() < 288
    assert set(a.discoveries()) == set(seq.discoveries())


# --- the GPU engine's visitor path --------------------------------------------


def _paths(recorded):
    return {(tuple(astuple(s) for s in p.into_states()), tuple(p.into_actions())) for p in recorded}


def test_spawn_xla_visitor_records_the_references_paths():
    recorder, accessor = PathRecorder.new_with_accessor()
    c = port_2pc.PackedTwoPhaseSys(3).checker().visitor(recorder).spawn_xla(**CPU).join()
    assert c.metrics()["levels_per_dispatch"] == 1
    assert len(c.dispatch_log) == len(c.level_log) == 11
    ref_rec, ref_acc = ref_api.PathRecorder.new_with_accessor()
    ref_2pc.PackedTwoPhaseSys(3).checker().visitor(ref_rec).spawn_xla().join()
    assert len(accessor()) == 288
    assert _paths(accessor()) == _paths(ref_acc())
    # The same paths as the port's host BFS visitor.
    host_rec, host_acc = PathRecorder.new_with_accessor()
    port_2pc.PackedTwoPhaseSys(3).checker().visitor(host_rec).spawn_bfs().join()
    assert _paths(host_acc()) == _paths(accessor())


def test_spawn_xla_visit_cap_warns_and_cuts():
    recorder, accessor = StateRecorder.new_with_accessor()
    graph = PackedDGraph(DGraph.with_property(Property.always("true", lambda _, s: True))
                         .with_path([0, 1, 3]).with_path([0, 2, 3]))
    with pytest.warns(RuntimeWarning, match="visiting only the first 1"):
        graph.checker().visitor(recorder).spawn_xla(visit_cap=1, **CPU).join()
    assert accessor() == [0, 1, 3]


def test_spawn_xla_symmetry_rm3_equals_the_reference():
    """``symmetry()`` on the builder reaches the GPU engine: rm=3 reduces to
    the reference's 80 classes, level by level."""
    got = port_2pc.PackedTwoPhaseSys(3).checker().symmetry().spawn_xla(**CPU).join()
    want = ref_2pc.PackedTwoPhaseSys(3).checker().symmetry().spawn_xla(dedup="sorted").join()
    assert got.unique_state_count() == want.unique_state_count() == 80
    assert got.state_count() == want.state_count()
    keys = ("depth", "frontier", "generated", "unique", "sym")
    assert [[r[k] for k in keys] for r in got.level_log] == [
        [r[k] for k in keys] for r in want.level_log]


def test_packed_dgraph_on_the_engine_equals_the_host_bfs():
    paths = ([0, 2, 4], [0, 1, 5], [2, 6, 8])
    for prop in (Property.always("small", lambda _, s: s < 100),
                 Property.eventually("odd", lambda _, s: s % 2 == 1)):
        graph = DGraph.with_property(prop)
        for path in paths:
            graph = graph.with_path(path)
        dev = PackedDGraph(graph).checker().spawn_xla(**CPU).join()
        host = graph.checker().spawn_bfs().join()
        if prop.name == "small":  # full coverage: the same counts
            assert (dev.state_count(), dev.unique_state_count()) == (
                host.state_count(), host.unique_state_count()) == (8, 7)
        # The terminal pass finds the host's shortest counterexample.
        assert ({k: p.into_states() for k, p in dev.discoveries().items()}
                == {k: p.into_states() for k, p in host.discoveries().items()})
