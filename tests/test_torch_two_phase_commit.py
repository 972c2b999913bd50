"""The port's batched 2pc kernels (stateright_tpu_torch/models/
two_phase_commit.py) against ``jax.vmap`` of the reference package's
per-state ones, on every reachable state at rm=3..5: exact comparison,
tolerance 0. Plus the host codec, the object model and the command line's
host subcommands."""

import re

import jax
import numpy as np
import pytest

from stateright_tpu.models import two_phase_commit as ref
from stateright_tpu_torch.models import two_phase_commit as port
from stateright_tpu_torch.ops.words import from_u32, to_u32


def _reachable(model, step):
    """Every reachable packed state, by BFS over the reference kernel."""
    seen = {tuple(r) for r in model.packed_init().tolist()}
    frontier = np.asarray(model.packed_init(), np.uint32)
    while len(frontier):
        nxt, valid = step(frontier)
        cand = np.asarray(nxt)[np.asarray(valid)]
        fresh = {tuple(r) for r in cand.tolist()} - seen
        seen |= fresh
        frontier = np.array(sorted(fresh), np.uint32).reshape(-1, model.state_words)
    return np.array(sorted(seen), np.uint32)


@pytest.mark.parametrize("rm,unique", [(3, 288), (4, 1568), (5, 8832)])
def test_batched_kernels_match_vmapped_reference(rm, unique):
    rmodel = ref.PackedTwoPhaseSys(rm)
    pmodel = port.PackedTwoPhaseSys(rm)
    step = jax.jit(jax.vmap(rmodel.packed_step))
    states = _reachable(rmodel, step)
    assert len(states) == unique
    want_next, want_valid = step(states)
    want_props = jax.vmap(rmodel.packed_properties)(states)
    got_next, got_valid = pmodel.packed_step(from_u32(states, "cpu"))
    assert got_next.shape == (unique, pmodel.max_actions, 2)
    assert np.array_equal(got_valid.numpy(), np.asarray(want_valid))
    # Disabled slots carry a successor word pattern too; the whole grid is equal.
    assert np.array_equal(to_u32(got_next), np.asarray(want_next))
    assert np.array_equal(
        pmodel.packed_properties(from_u32(states, "cpu")).numpy(), np.asarray(want_props)
    )


def test_codec_and_object_model_match_reference():
    rmodel, pmodel = ref.PackedTwoPhaseSys(4), port.PackedTwoPhaseSys(4)
    assert np.array_equal(pmodel.packed_init(), rmodel.packed_init())
    assert [p.name for p in pmodel.properties()] == [p.name for p in rmodel.properties()]
    state = pmodel.init_states()[0]
    for _ in range(6):
        steps = pmodel.next_steps(state)
        ref_steps = rmodel.next_steps(rmodel.unpack(pmodel.pack(state)))
        assert [a for a, _ in steps] == [a for a, _ in ref_steps]
        assert [pmodel.pack(s).tolist() for _, s in steps] == [
            rmodel.pack(s).tolist() for _, s in ref_steps
        ]
        state = steps[len(steps) // 2][1]
        assert pmodel.unpack(pmodel.pack(state)) == state


def _done_lines(out: str):
    """The report's ``Done.`` lines, less their wall seconds."""
    return [re.sub(r", sec=\S+", "", line) for line in out.splitlines() if line.startswith("Done.")]


@pytest.mark.parametrize("cmd", ["check-sym", "check-host"])
def test_command_line_equals_the_references(cmd, capsys):
    port.main([cmd, "3"])
    got = capsys.readouterr().out
    ref.main([cmd, "3"])
    want = capsys.readouterr().out
    assert len(_done_lines(got)) == 1
    assert _done_lines(got) == _done_lines(want)
    assert got.splitlines()[0] == want.splitlines()[0]


def test_command_line_usage_and_explore():
    import io
    from contextlib import redirect_stdout

    out = io.StringIO()
    with redirect_stdout(out):
        port.main([])
    assert "USAGE:" in out.getvalue() and "check-sym" in out.getvalue()
    with pytest.raises(NotImplementedError, match="A10"):
        port.main(["explore"])
