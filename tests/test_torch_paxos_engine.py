"""Packed Paxos on the port's engine (stateright_tpu_torch/xla.py) on the
CPU, against the reference's pinned counts:

- full coverage of 2c/3s: 32,971 generated, 16,668 unique, "linearizable"
  everywhere and the 8-action "value chosen" witness (paxos.rs:294-346);
- 3c/3s (W=46, A=672) to depth 8: 3,279 / 1,969, the reference's bounded
  pin (``tests/test_packed_paxos.py``);
- a codec overflow in ``packed_step`` stops the check loudly, on both
  dispatch paths, and is never retried.

The model-level parity with the reference is in ``test_torch_paxos.py``.
Everything is exact (integer work)."""

import numpy as np
import pytest
import torch

from stateright_tpu_torch.actor import register as reg
from stateright_tpu_torch.core import Model, Property
from stateright_tpu_torch.models.paxos import PackedPaxos

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


def test_full_2c_coverage_on_the_cpu():
    c = PackedPaxos(2, 3).checker().spawn_xla(**CPU).join()
    assert (c.state_count(), c.unique_state_count()) == (32_971, 16_668)  # paxos.rs:321,345
    c.assert_properties()
    witness = c.discoveries()["value chosen"]
    actions = witness.into_actions()
    assert len(actions) == 8  # the BFS shortest witness (paxos.rs:311-320)
    assert isinstance(actions[0].msg, reg.Put) and isinstance(actions[-1].msg, reg.Get)
    c.assert_discovery("value chosen", actions)
    assert any(
        isinstance(env.msg, reg.GetOk) and env.msg.value is not None
        for env in witness.last_state().network.iter_deliverable()
    )


def test_3c_depth_8_pin():
    c = PackedPaxos(3, 3).checker().target_max_depth(8).spawn_xla(
        frontier_capacity=1 << 10, table_capacity=1 << 12, **CPU).join()
    assert (c.state_count(), c.unique_state_count()) == (3_279, 1_969)


class _Overflowing(Model):
    """0 -> 1 -> 2 -> ...; the step out of 3 does not fit the codec."""

    state_words = 1
    max_actions = 1

    def init_states(self):
        return [0]

    def actions(self, state, actions):
        actions.append(1)

    def next_state(self, state, action):
        return state + 1

    def properties(self):
        return [Property.sometimes("five", lambda _, s: s == 5)]

    def pack(self, state):
        return np.array([state], np.uint32)

    def unpack(self, words):
        return int(words[0])

    def packed_init(self):
        return np.array([[0]], np.uint32)

    def packed_step(self, words):
        x = words[:, 0:1]
        valid = torch.ones_like(x, dtype=torch.bool)
        return (x + 1)[..., None], valid, valid & (x == 3)

    def packed_properties(self, words):
        return words[:, 0:1] == 5


@pytest.mark.parametrize("levels_per_dispatch", [32, 1])
def test_a_codec_overflow_raises(levels_per_dispatch):
    checker = _Overflowing().checker().spawn_xla(levels_per_dispatch=levels_per_dispatch, **CPU)
    with pytest.raises(RuntimeError, match="packed-codec capacity overflow"):
        checker.join()
    # The overflowing level was not committed: the states before it were.
    assert checker.state_count() == 4 and checker.unique_state_count() == 4
