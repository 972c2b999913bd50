"""The ABD linearizable register in the port
(stateright_tpu_torch/models/linearizable_register.py) against the
reference package's (stateright_tpu/models/linearizable_register.py) on the
CPU, unordered network (``PackedAbd``):

- the codec round-trips every reachable 2c/2s state, and both packages pack
  the reachable set to the same words;
- ``packed_step`` (valid, overflow and every enabled successor) and
  ``packed_properties`` equal ``jax.vmap`` of the reference's on every
  reachable 2c/2s state, and on a seeded random-walk sample at 3c/2s;
- the engine: 875 generated / 544 unique at 2c/2s
  (linearizable-register.rs:289,316; ``bench.py`` ``EXPECTED_MATRIX``),
  equal to the reference's host BFS, and 3c/2s to ``DEPTH_3C``, equal to
  the reference's ``spawn_xla()`` level by level, with the same
  discoveries;
- a checkpoint written by either package resumes in the other;
- the command line prints the reference's ``Done.`` line.

Everything is exact (integer work, tolerance 0)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu import checkpoint as ref_ck
from stateright_tpu.models import linearizable_register as ref
from stateright_tpu_torch import checkpoint as ck
from stateright_tpu_torch.models import linearizable_register as port
from stateright_tpu_torch.ops.words import from_u32, to_u32

CPU = dict(device="cpu")
#: The 3c/2s depth cut: the levels of the 64- and 256-row buckets, under
#: 40 s with the reference's compiles.
DEPTH_3C = 14
#: ``(generated, unique, max_depth)`` of 2c/2s and of 3c/2s to ``DEPTH_3C``.
FULL_2C = (875, 544, 25)
CUT_3C = (1_457, 821, 14)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test process: the suite runs several test
    processes on one machine, and torch's default of a thread per core in
    each oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref_2c():
    """One reference model instance for the file: the reference engine
    keeps its compiled programs on the instance."""
    return ref.PackedAbd(2, 2)


def reachable(model):
    """Every reachable object state of ``model``, by BFS over
    ``next_steps``, in discovery order."""
    seen = list(model.init_states())
    index = set(seen)
    i = 0
    while i < len(seen):
        for _, nxt in model.next_steps(seen[i]):
            if nxt not in index:
                index.add(nxt)
                seen.append(nxt)
        i += 1
    return seen


def walk_sample(model, n, seed, walk=8000):
    """Up to ``n`` distinct states met on a seeded random walk."""
    rng = random.Random(seed)
    init = model.init_states()[0]
    sample, cur = {init}, init
    for _ in range(walk):
        steps = model.next_steps(cur)
        if not steps:
            cur = init
            continue
        _, cur = rng.choice(steps)
        sample.add(cur)
        if len(sample) >= n:
            break
    return sorted(sample, key=repr)


def assert_codec_equal(m, r, states):
    words = np.stack([m.pack(s) for s in states])
    for s, row in zip(states, words):
        assert m.unpack(row) == s
    assert len({row.tobytes() for row in words}) == len(states)
    ref_words = np.stack([r.pack(r.unpack(row)) for row in words])
    assert np.array_equal(words, ref_words)
    assert (m.state_words, m.max_actions) == (r.state_words, r.max_actions)
    return words


def assert_step_equal(m, r, words):
    """The port's batched step and properties against ``jax.vmap`` of the
    reference's, on every row of ``words``."""
    want_next, want_valid, want_ovf = (
        np.asarray(x) for x in jax.jit(jax.vmap(r.packed_step))(jnp.asarray(words)))
    want_props = np.asarray(jax.jit(jax.vmap(r.packed_properties))(jnp.asarray(words)))
    nxt, valid, ovf = m.packed_step(from_u32(words, "cpu"))
    assert np.array_equal(valid.numpy(), want_valid)
    assert np.array_equal(ovf.numpy(), want_ovf)
    assert not want_ovf.any()
    assert np.array_equal(to_u32(nxt)[want_valid], want_next[want_valid])
    props = m.packed_properties(from_u32(words, "cpu")).numpy()
    assert np.array_equal(props, want_props)
    return props


def _levels(c):
    return [(r["depth"], r["frontier"], r["generated"], r["unique"]) for r in c.level_log]


def test_codec_round_trips_every_reachable_2c_state():
    m, r = port.PackedAbd(2, 2), ref.PackedAbd(2, 2)
    states = reachable(m._inner)
    assert len(states) == 544
    words = assert_codec_equal(m, r, states)
    ref_words = np.stack([r.pack(s) for s in reachable(r._inner)])
    assert sorted(row.tobytes() for row in words) == sorted(row.tobytes() for row in ref_words)
    assert (m.state_words, m.max_actions) == (26, 164)


def test_step_and_properties_equal_the_reference_on_every_reachable_2c_state():
    m, r = port.PackedAbd(2, 2), ref.PackedAbd(2, 2)
    states = reachable(m._inner)
    props = assert_step_equal(m, r, np.stack([m.pack(s) for s in states]))
    # The properties are the exact host conditions on every state.
    for s, row in zip(states, props):
        assert [bool(p.condition(m, s)) for p in m.properties()] == row.tolist()
    # Every enabled slot is the envelope the object model delivers.
    nxt, valid, _ = m.packed_step(from_u32(np.stack([m.pack(s) for s in states]), "cpu"))
    for i, s in enumerate(states):
        want = {m._env_code[port.Envelope(a.src, a.dst, a.msg)]: m.pack(ns)
                for a, ns in m._inner.next_steps(s)}
        assert set(np.flatnonzero(valid[i].numpy())) == set(want)
        for code, ns in want.items():
            assert np.array_equal(to_u32(nxt[i, code]), ns)


def test_3c_codec_and_step_parity_on_a_seeded_sample():
    m, r = port.PackedAbd(3, 2), ref.PackedAbd(3, 2)
    states = walk_sample(m._inner, 200, seed=7)
    words = assert_codec_equal(m, r, states)
    assert (m.state_words, m.max_actions) == (39, 417)
    assert_step_equal(m, r, words)
    nxt, valid, _ = m.packed_step(from_u32(words, "cpu"))
    for i, s in enumerate(states):
        want = {m.pack(ns).tobytes() for _, ns in m._inner.next_steps(s)}
        got = {to_u32(nxt[i, a]).tobytes() for a in np.flatnonzero(valid[i].numpy())}
        assert got == want


def test_2c_full_coverage_equals_the_reference_oracle():
    """Against the reference's host BFS of the object model (the reference
    engine is held level by level at 3c/2s below and in the checkpoint
    test)."""
    c = port.PackedAbd(2, 2).checker().spawn_xla(**CPU).join()
    r = ref.linearizable_register_model(2, 2).checker().spawn_bfs().join()
    assert (c.state_count(), c.unique_state_count(), c.max_depth()) == (
        r.state_count(), r.unique_state_count(), r.max_depth()) == FULL_2C
    c.assert_properties()
    path = c.discoveries()["value chosen"]
    c.assert_discovery("value chosen", path.into_actions())
    assert len(path) == len(r.discoveries()["value chosen"])
    assert any(
        isinstance(env.msg, port.reg.GetOk) and env.msg.value is not None
        for env in path.last_state().network.iter_deliverable()
    )


def test_3c_to_the_depth_cut_equals_the_reference_engine():
    """3c/2s with the exact 3-thread serializer (1,680 patterns a state);
    the full space (68,115 / 35,009 / 37) runs on the card."""
    c = port.PackedAbd(3, 2).checker().target_max_depth(DEPTH_3C).spawn_xla(**CPU).join()
    r = ref.PackedAbd(3, 2).checker().target_max_depth(DEPTH_3C).spawn_xla().join()
    assert (c.state_count(), c.unique_state_count(), c.max_depth()) == (
        r.state_count(), r.unique_state_count(), r.max_depth()) == CUT_3C
    assert _levels(c) == _levels(r)
    got, want = c.discoveries(), r.discoveries()
    assert set(got) == set(want) == {"value chosen"}
    for name in want:
        assert [c.model().pack(s).tolist() for s in got[name].into_states()] == [
            r.model().pack(s).tolist() for s in want[name].into_states()]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_checkpoint_crosses_the_packages(tmp_path, writer, ref_2c):
    """``PackedAbd(2, 2)`` saved after 8 levels by one package resumes in
    the other to the full counts; the model name and digest agree."""
    path = str(tmp_path / "abd.npz")
    if writer == "port":
        partial = port.PackedAbd(2, 2).checker().spawn_xla(levels_per_dispatch=1, **CPU)
    else:
        partial = ref_2c.checker().spawn_xla(levels_per_dispatch=1)
    for _ in range(8):
        partial._run_block()
    partial.save_checkpoint(path)
    meta = ck.load_checkpoint(path)["meta"]
    assert meta["init_digest"] == ck.model_digest(port.PackedAbd(2, 2)) == ref_ck.model_digest(
        ref.PackedAbd(2, 2))
    if writer == "port":
        resumed = ref_2c.checker().spawn_xla(checkpoint=path)
    else:
        resumed = port.PackedAbd(2, 2).checker().spawn_xla(checkpoint=path, **CPU)
    assert (resumed.state_count(), resumed.unique_state_count()) == (
        partial.state_count(), partial.unique_state_count())
    resumed.join()
    assert (resumed.state_count(), resumed.unique_state_count(), resumed.max_depth()) == FULL_2C
    resumed.assert_properties()


def test_the_command_line_prints_the_references_done_line(monkeypatch, capsys):
    """``main(["check-host", "2"])``. The command line's own 3-server shape
    is far past a test's time (over 400,000 unique states), so both
    packages' model builders are held at the test shape's 2 servers; the
    command line's path is the same. The DFS witness may differ: the
    unordered network orders its envelopes by their object fingerprints,
    which carry each package's module names (ROADMAP C)."""
    for mod in (port, ref):
        build = mod.linearizable_register_model
        monkeypatch.setattr(mod, "linearizable_register_model",
                            lambda c, s, n=None, build=build: build(c, 2, n))
    lines = []
    for mod in (port, ref):
        mod.main(["check-host", "2"])
        out = capsys.readouterr().out.splitlines()
        lines.append([l.split(" example ")[0] if l.startswith("Discovered") else l.split(", sec=")[0]
                      for l in out if not l.startswith(("Checking.", "- ", "  "))])
    assert lines[0] == lines[1]
    assert "Done. states=875, unique=544, depth=25" in lines[0]
    dfs = port.linearizable_register_model(2, 2).checker().spawn_dfs().join()
    dfs.assert_discovery("value chosen", dfs.discoveries()["value chosen"].into_actions())
    # ``spawn`` runs the UDP cluster (``tests/test_torch_cli.py``). ``explore``
    # serves the Explorer (recorded here, not bound) on the model and address
    # the reference's serves, printing its line.
    from stateright_tpu.checker import explorer as ref_explorer
    from stateright_tpu_torch.checker import explorer as port_explorer

    served, printed = {}, []
    for mod, tag in ((port_explorer, "port"), (ref_explorer, "ref")):
        monkeypatch.setattr(mod, "serve", lambda b, addr, tag=tag, **kw: served.setdefault(
            tag, ([type(a).__name__ for a in b._model.actors], addr, kw)))
    for mod in (port, ref):
        mod.main(["explore"])
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and "localhost:3000" in printed[0]
    assert served["port"] == served["ref"]


def test_other_sizes_run_on_the_host_engines():
    with pytest.raises(ValueError):
        port.PackedAbd(2, 3)
    with pytest.raises(ValueError):
        port.PackedAbd(4, 2)
    c = port.linearizable_register_model(2, 2).checker().spawn_bfs().join()
    assert c.unique_state_count() == 544
