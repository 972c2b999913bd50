"""The port's host demand-driven checker (``stateright_tpu_torch/checker/
on_demand.py``) held against the JAX package's ``OnDemandChecker``.

The cases of ``tests/test_on_demand.py`` (compute nothing until asked, one
entry a click, unknown fingerprints ignored, run-to-completion as the batch
BFS, ``join()`` before it raising, ``block_size`` and the state-count
target inside a block), each on both packages: after the same click
sequence the counts, the depth and the pending entries (state rendering,
eventually-bits, depth, in deque order) are equal, tolerance 0. Object
fingerprints differ between the packages (the port's tag a class's module,
ROADMAP C), so each checker is clicked by its own fingerprint of the entry
at the same position.
"""

import pytest

from stateright_tpu.fingerprint import fingerprint as ref_fingerprint
from stateright_tpu.models import two_phase_commit as ref_2pc
from stateright_tpu.test_util import BinaryClock as RefBinaryClock
from stateright_tpu_torch.fingerprint import fingerprint
from stateright_tpu_torch.models import two_phase_commit as port_2pc
from stateright_tpu_torch.test_util import BinaryClock

PAIRS = {
    "clock": (BinaryClock, RefBinaryClock),
    "2pc2": (lambda: port_2pc.TwoPhaseSys(2), lambda: ref_2pc.TwoPhaseSys(2)),
    "2pc3": (lambda: port_2pc.TwoPhaseSys(3), lambda: ref_2pc.TwoPhaseSys(3)),
}


def _both(name, shape=lambda b: b, **kw):
    """The port's and the JAX package's on-demand checkers of model ``name``."""
    mine, theirs = PAIRS[name]
    return shape(mine().checker()).spawn_on_demand(**kw), shape(theirs().checker()).spawn_on_demand(**kw)


def _view(c):
    return (c.state_count(), c.unique_state_count(), c.max_depth(), c.is_done(),
            [(repr(s), sorted(eb), d) for s, _fp, eb, d in c._pending])


def _click(pair, pos: int) -> None:
    """Click the pending entry at ``pos`` in both checkers, each by its own
    fingerprint."""
    for c in pair:
        c.check_fingerprint(c._pending[pos][1])


def test_computes_nothing_until_asked():
    pair = _both("clock")
    assert _view(pair[0]) == _view(pair[1])
    assert pair[0].state_count() == pair[0].unique_state_count() == 2
    assert pair[0].max_depth() == 0 and not pair[0].is_done()


def test_check_fingerprint_expands_exactly_one_entry():
    pair = _both("clock")
    for c, fp in zip(pair, (fingerprint, ref_fingerprint)):
        c.check_fingerprint(fp(c.model().init_states()[0]))
    assert _view(pair[0]) == _view(pair[1])
    assert pair[0].unique_state_count() == 2 and pair[0].max_depth() == 1


def test_unknown_fingerprint_is_ignored():
    pair = _both("clock")
    for c in pair:
        c.check_fingerprint(0xDEADBEEF)
    assert _view(pair[0]) == _view(pair[1])
    assert pair[0].state_count() == 2 and pair[0].max_depth() == 0


def test_run_to_completion_matches_bfs():
    pair = _both("2pc3")
    for c in pair:
        c.run_to_completion()
        c.join()
    bfs = port_2pc.TwoPhaseSys(3).checker().spawn_bfs().join()
    assert _view(pair[0]) == _view(pair[1])
    assert pair[0].unique_state_count() == bfs.unique_state_count() == 288
    assert set(pair[0].discoveries()) == set(pair[1].discoveries()) == set(bfs.discoveries())


def test_join_without_run_to_completion_raises():
    for c in _both("clock"):
        with pytest.raises(RuntimeError, match="run_to_completion"):
            c.join()


def test_exhausted_frontier_reports_done_while_waiting():
    pair = _both("clock")
    while pair[0]._pending:
        _click(pair, -1)
        assert _view(pair[0]) == _view(pair[1])
    assert pair[0].is_done() and pair[1].is_done()
    for c in pair:
        c.join()  # must not raise


def test_demand_driven_click_sequence_matches_reference():
    """Click the newest pending entry until done (the reference case), and a
    second sequence alternating oldest and newest: equal after every click."""
    for pick in (lambda i: -1, lambda i: 0 if i % 2 else -1):
        pair = _both("2pc2")
        for i in range(10_000):
            if pair[0].is_done() or not pair[0]._pending:
                break
            _click(pair, pick(i))
            assert _view(pair[0]) == _view(pair[1])
        assert pair[1].is_done()
        full = port_2pc.TwoPhaseSys(2).checker().spawn_bfs().join()
        assert pair[0].unique_state_count() == full.unique_state_count()


@pytest.mark.parametrize("block_size,done", [(1500, True), (10, False), (1, False)])
def test_block_size_expands_clicked_subtree(block_size, done):
    """stateright's granularity: one click pre-computes up to ``block_size``
    states of the clicked subtree (on_demand.rs:209-218); 2pc(3) has 288
    states, so a 1500-state block on the init state computes all of it."""
    pair = _both("2pc3", block_size=block_size)
    _click(pair, 0)
    assert _view(pair[0]) == _view(pair[1])
    assert pair[0].is_done() == done
    if block_size == 1500:
        assert pair[0].unique_state_count() == 288
    elif block_size == 10:
        assert 10 <= pair[0].unique_state_count() < 288
    # A second click on the oldest pending entry keeps them equal.
    if pair[0]._pending:
        _click(pair, 0)
        assert _view(pair[0]) == _view(pair[1])


def test_block_size_must_be_positive():
    for mine, theirs in [PAIRS["clock"]]:
        for model in (mine(), theirs()):
            with pytest.raises(ValueError, match="block_size"):
                model.checker().spawn_on_demand(block_size=0)


def test_block_expansion_respects_target_state_count():
    pair = _both("2pc3", shape=lambda b: b.target_state_count(50), block_size=1500)
    _click(pair, 0)
    assert _view(pair[0]) == _view(pair[1])
    assert pair[0].is_done()
    # One overshooting expansion at most (the signal lands after the
    # expansion that crosses the target).
    assert pair[0].state_count() < 50 + 16
