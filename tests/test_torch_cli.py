"""The port's command lines (paxos, single-copy-register and
linearizable-register) held against the JAX package's.

- ``check-host``: the first line and the ``Done.`` line (less ``sec=``)
  equal the reference's (linearizable-register's, at the test shape's 2
  servers, in ``test_torch_abd.py``: its command line's 3-server shape
  takes seconds a client);
- ``check`` on the CPU, reached by ``main``'s ``device`` keyword (the
  command line itself has no such flag): its counts equal the reference's
  host BFS on the same packed model. The reference's ``spawn_xla`` of
  these models compiles for 5-21 s on the CPU, past this file's budget;
  its parity with the port's engine is held by
  ``test_torch_single_copy_register.py``, ``test_torch_paxos_engine.py``
  and ``test_torch_abd_ordered.py``, and 2pc's ``check`` is held against
  the reference's ``spawn_xla`` in ``test_torch_obs.py``;
- ``spawn`` builds the reference's cluster and prints its lines, with the
  runtime replaced by a recorder, so no fixed UDP port is bound;
- usage, and ``explore``, which serves the Explorer on the reference's
  model and address (the server recorded, not bound).
"""

import io
import re
from contextlib import redirect_stdout

import pytest
import torch

from stateright_tpu.models import linearizable_register as ref_abd
from stateright_tpu.models import paxos as ref_paxos
from stateright_tpu.models import single_copy_register as ref_scr
from stateright_tpu_torch.models import linearizable_register as abd
from stateright_tpu_torch.models import paxos
from stateright_tpu_torch.models import single_copy_register as scr

MODULES = {"paxos": (paxos, ref_paxos), "single-copy-register": (scr, ref_scr),
           "linearizable-register": (abd, ref_abd)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(main, *args, **kw) -> str:
    out = io.StringIO()
    with redirect_stdout(out):
        main(list(args), **kw)
    return out.getvalue()


def _done(out: str):
    """The report's ``Done.`` lines, less their wall seconds."""
    return [re.sub(r", sec=\S+", "", line) for line in out.splitlines() if line.startswith("Done.")]


def _done_line(checker) -> str:
    return (f"Done. states={checker.state_count()}, unique={checker.unique_state_count()}, "
            f"depth={checker.max_depth()}")


@pytest.mark.parametrize("name, args", [
    ("paxos", ["check-host", "1"]),
    ("single-copy-register", ["check-host", "2"]),
    ("single-copy-register", ["check-host", "2", "ordered"]),
    ("single-copy-register", ["check", "2", "unordered_nonduplicating"]),
])
def test_host_command_lines_equal_the_references(name, args):
    mine, theirs = MODULES[name]
    got, want = _run(mine.main, *args), _run(theirs.main, *args)
    assert len(_done(got)) == 1
    assert _done(got) == _done(want)
    assert got.splitlines()[0] == want.splitlines()[0]


@pytest.mark.parametrize("name, args, ref_model", [
    ("paxos", ["check", "1"], lambda: ref_paxos.PackedPaxos(1, 3)),
    ("single-copy-register", ["check", "2"], lambda: ref_scr.PackedSingleCopyRegister(2, 1)),
    ("linearizable-register", ["check", "2", "ordered"], lambda: ref_abd.PackedAbdOrdered(2, 2)),
    ("single-copy-register", ["check", "2", "ordered"],
     lambda: ref_scr.PackedSingleCopyRegisterOrdered(2)),
])
def test_check_on_the_cpu_equals_the_references_counts(name, args, ref_model):
    got = _run(MODULES[name][0].main, *args, device="cpu")
    assert "on the GPU" in got.splitlines()[0]
    assert _done(got) == [_done_line(ref_model().checker().spawn_bfs().join())]


def test_the_ordered_single_copy_register_check_runs():
    """The reference's ``check 2 ordered`` raises ``TypeError``: it builds
    ``PackedSingleCopyRegisterOrdered(client_count, 1)``, and the
    constructor takes the client count alone (ROADMAP C). The port's runs
    the ordered model."""
    with pytest.raises(TypeError):
        ref_scr.PackedSingleCopyRegisterOrdered(2, 1)
    got = _run(scr.main, "check", "2", "ordered", device="cpu")
    assert _done(got) == ["Done. states=121, unique=93, depth=9"]


def test_check_without_a_device_runs_on_the_card_or_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command line would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        _run(paxos.main, "check", "1")


@pytest.mark.parametrize("name", sorted(MODULES))
def test_spawn_builds_the_references_cluster(name, monkeypatch):
    import sys

    ref_spawn_mod = sys.modules["stateright_tpu.actor.spawn"]
    spawn_mod = sys.modules["stateright_tpu_torch.actor.spawn"]

    calls = {}
    for key, mod in (("port", spawn_mod), ("ref", ref_spawn_mod)):
        def record(serialize, deserialize, actors, key=key, **kw):
            calls[key] = (serialize, actors, kw)
        monkeypatch.setitem(mod.__dict__, "spawn", record)
    mine, theirs = MODULES[name]
    assert _run(mine.main, "spawn") == _run(theirs.main, "spawn")
    (ser, actors, kw), (rser, ractors, rkw) = calls["port"], calls["ref"]
    assert kw == rkw == {}
    assert [int(i) for i, _ in actors] == [int(i) for i, _ in ractors]
    assert [i.to_addr()[1] for i, _ in actors] == list(range(3000, 3000 + len(actors)))
    assert [type(a).__name__ for _, a in actors] == [type(a).__name__ for _, a in ractors]
    assert [sorted(int(p) for p in getattr(a, "peer_ids", getattr(a, "peers", [])))
            for _, a in actors] == [
        sorted(int(p) for p in getattr(a, "peer_ids", getattr(a, "peers", [])))
        for _, a in ractors]


@pytest.mark.parametrize("name", sorted(MODULES))
def test_usage_and_explore(name, monkeypatch):
    """Usage names ``explore``, which serves the Explorer (recorded here,
    not bound) on the model and address the reference's serves, printing
    its line."""
    from stateright_tpu.checker import explorer as ref_explorer
    from stateright_tpu_torch.checker import explorer as port_explorer

    mine, theirs = MODULES[name]
    out = _run(mine.main)
    assert out.startswith("USAGE:") and "check-host" in out and "spawn" in out
    assert " explore [CLIENT_COUNT] [ADDRESS] [NETWORK]" in out
    served = {}
    for mod, tag in ((port_explorer, "port"), (ref_explorer, "ref")):
        monkeypatch.setattr(mod, "serve", lambda b, addr, tag=tag, **kw: served.setdefault(
            tag, ([type(a).__name__ for a in b._model.actors], addr, kw)))
    args = ("explore", "1", "127.0.0.1:3005", "ordered")
    assert _run(mine.main, *args) == _run(theirs.main, *args)
    assert served["port"] == served["ref"] and served["port"][1] == "127.0.0.1:3005"
