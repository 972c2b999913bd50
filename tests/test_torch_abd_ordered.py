"""The ABD linearizable register over the ordered network in the port
(``PackedAbdOrdered``, stateright_tpu_torch/models/linearizable_register.py)
against the reference package's on the CPU: stateright's benchmark
configuration "linearizable-register check 2 ordered" (``BASELINE.json``).

- the codec round-trips every reachable 2c/2s state, and both packages pack
  the reachable set to the same words;
- ``packed_step`` and ``packed_properties`` equal ``jax.vmap`` of the
  reference's on every reachable 2c/2s state and on a seeded random-walk
  sample at 3c/2s; every enabled lane slot is the head the object model
  delivers;
- the engine: 813 generated / 564 unique / depth 25 at 2c/2s, equal to
  both packages' host BFS of the object ``OrderedNetwork`` model (the
  reference's own oracle for this configuration); 3c/2s to ``DEPTH_3C``
  equal to the reference's ``spawn_xla()`` level by level.

Everything is exact (integer work, tolerance 0)."""

import numpy as np
import pytest
import torch

from stateright_tpu.actor import Network as RefNetwork
from stateright_tpu.models import linearizable_register as ref
from stateright_tpu_torch.models import linearizable_register as port
from stateright_tpu_torch.ops.words import from_u32, to_u32

from test_torch_abd import _levels, assert_codec_equal, assert_step_equal, reachable, walk_sample

CPU = dict(device="cpu")
#: The 3c/2s depth cut: the levels of the 64- and 256-row buckets.
DEPTH_3C = 16
FULL_2C = (813, 564, 25)
CUT_3C = (1_441, 919, 16)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test process: the suite runs several test
    processes on one machine, and torch's default of a thread per core in
    each oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_lanes_deliver_the_object_steps(m, states, words):
    nxt, valid, _ = m.packed_step(from_u32(words, "cpu"))
    for i, s in enumerate(states):
        want = {m.pack(ns).tobytes() for _, ns in m._inner.next_steps(s)}
        got = {to_u32(nxt[i, a]).tobytes() for a in np.flatnonzero(valid[i].numpy())}
        assert got == want, i


def test_codec_round_trips_every_reachable_2c_state():
    m, r = port.PackedAbdOrdered(2, 2), ref.PackedAbdOrdered(2, 2)
    states = reachable(m._inner)
    assert len(states) == 564
    words = assert_codec_equal(m, r, states)
    ref_words = np.stack([r.pack(s) for s in reachable(r._inner)])
    assert sorted(row.tobytes() for row in words) == sorted(row.tobytes() for row in ref_words)
    assert (m.state_words, m.max_actions) == (25, 10)


def test_step_and_properties_equal_the_reference_on_every_reachable_2c_state():
    m, r = port.PackedAbdOrdered(2, 2), ref.PackedAbdOrdered(2, 2)
    states = reachable(m._inner)
    words = np.stack([m.pack(s) for s in states])
    props = assert_step_equal(m, r, words)
    for s, row in zip(states, props):
        assert [bool(p.condition(m, s)) for p in m.properties()] == row.tolist()
    assert_lanes_deliver_the_object_steps(m, states, words)


def test_3c_codec_and_step_parity_on_a_seeded_sample():
    m, r = port.PackedAbdOrdered(3, 2), ref.PackedAbdOrdered(3, 2)
    states = walk_sample(m._inner, 200, seed=5)
    words = assert_codec_equal(m, r, states)
    assert (m.state_words, m.max_actions) == (31, 14)
    assert_step_equal(m, r, words)
    assert_lanes_deliver_the_object_steps(m, states, words)


def test_2c_full_coverage_equals_the_reference_oracle():
    c = port.PackedAbdOrdered(2, 2).checker().spawn_xla(**CPU).join()
    host = ref.linearizable_register_model(2, 2, RefNetwork.new_ordered()).checker().spawn_bfs().join()
    own = port.linearizable_register_model(2, 2, port.Network.new_ordered()).checker().spawn_bfs().join()
    for other in (host, own):
        assert (c.state_count(), c.unique_state_count(), c.max_depth()) == (
            other.state_count(), other.unique_state_count(), other.max_depth()) == FULL_2C
    c.assert_properties()
    path = c.discoveries()["value chosen"]
    c.assert_discovery("value chosen", path.into_actions())
    assert len(path) == len(host.discoveries()["value chosen"]) == len(own.discoveries()["value chosen"])


def test_3c_to_the_depth_cut_equals_the_reference_engine():
    """3c/2s over ordered channels with the exact 3-thread serializer; the
    full space (63,053 / 36,213) runs on the card."""
    c = port.PackedAbdOrdered(3, 2).checker().target_max_depth(DEPTH_3C).spawn_xla(**CPU).join()
    r = ref.PackedAbdOrdered(3, 2).checker().target_max_depth(DEPTH_3C).spawn_xla().join()
    assert (c.state_count(), c.unique_state_count(), c.max_depth()) == (
        r.state_count(), r.unique_state_count(), r.max_depth()) == CUT_3C
    assert _levels(c) == _levels(r)
    got, want = c.discoveries(), r.discoveries()
    assert set(got) == set(want)
    for name in want:
        assert [c.model().pack(s).tolist() for s in got[name].into_states()] == [
            r.model().pack(s).tolist() for s in want[name].into_states()]


def test_invalid_sizes_raise():
    with pytest.raises(ValueError):
        port.PackedAbdOrdered(2, 3)
    with pytest.raises(ValueError):
        port.PackedAbdOrdered(4, 2)
