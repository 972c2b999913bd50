"""The port's symmetry rewrite plans and utility containers
(stateright_tpu_torch/utils/{rewrite_plan,densenatmap,vector_clock}.py,
``ActorModelState.representative``, ``Network.__rewrite__``) against the
reference package's on the CPU.

Mirrors ``tests/test_rewrite_and_codec.py`` (less the UDP wire codec, which
waits for the UDP runtime) and ``tests/test_utils_containers.py`` case for
case, and adds:

- ``ActorModelState.representative`` equal to the reference's on seeded
  reachable single-copy-register 2c/1s and ABD 2c/2s states. The reference's
  ``Timers`` has no ``__rewrite__``, so its ``representative`` raises on
  every actor state; here it is given the port's for the comparison (the
  package's files are not touched). Neither package's
  ``LinearizabilityTester`` has one, so both raise on the histories, which
  the comparison sets aside. Mixed actor states do not compare, so both
  sort them by fingerprint, and the port's fingerprints carry the class's
  module: there the representatives may be other members of one orbit;
- the host ``symmetry().spawn_dfs()`` counts of both packages: 665 on
  ``TwoPhaseSys(5)`` (the reference's partial canon, 2pc.rs:170) and the
  exhaustive single-copy-register 2c/1s actor model without a history.

Everything is exact."""

import dataclasses
import random

import pytest

from stateright_tpu.actor import ActorModel as RefActorModel
from stateright_tpu.actor import Network as RefNetwork
from stateright_tpu.actor import register as ref_reg
from stateright_tpu.actor import timers as ref_timers
from stateright_tpu.core import Expectation as RefExpectation
from stateright_tpu.models import linearizable_register as ref_abd
from stateright_tpu.models import single_copy_register as ref_scr
from stateright_tpu.models import two_phase_commit as ref_2pc
from stateright_tpu.utils import rewrite_plan as ref_rewrite
from stateright_tpu_torch.actor import ActorModel, Id, Network
from stateright_tpu_torch.actor.network import Envelope
from stateright_tpu_torch.actor import register as reg
from stateright_tpu_torch.core import Expectation
from stateright_tpu_torch.fingerprint import fingerprint
from stateright_tpu_torch.models import linearizable_register as abd
from stateright_tpu_torch.models import single_copy_register as scr
from stateright_tpu_torch.models import two_phase_commit as port_2pc
from stateright_tpu_torch.utils import DenseNatMap, RewritePlan, VectorClock, rewrite


@pytest.fixture
def ref_timers_rewrite(monkeypatch):
    """The reference's ``Timers`` given the port's ``__rewrite__`` for one
    test, so that its ``ActorModelState.representative`` runs."""

    def rewrite_timers(self, plan):
        return ref_timers.Timers(frozenset(ref_rewrite.rewrite(t, plan) for t in self._set))

    monkeypatch.setattr(ref_timers.Timers, "__rewrite__", rewrite_timers, raising=False)


# --- rewrite plans (tests/test_rewrite_and_codec.py) ---------------------------------


class TestRewritePlan:
    def test_reindex_rewrites_elements(self):
        # reindex permutes AND rewrites (rewrite_plan.rs:118-123): each actor
        # pointing at its peer still does so in the canonical form.
        plan = RewritePlan([1, 0])
        pointing_at_peer = [Id(1), Id(0)]
        assert plan.reindex(pointing_at_peer) == [Id(1), Id(0)]
        pointing_at_self = [Id(0), Id(1)]
        assert plan.reindex(pointing_at_self) == [Id(0), Id(1)]
        assert plan.reindex(pointing_at_peer) != plan.reindex(pointing_at_self)

    def test_reindex_permutes(self):
        plan = RewritePlan([2, 0, 1])
        assert plan.reindex(["c", "a", "b"]) == ["b", "c", "a"]

    def test_rewrite_nested(self):
        plan = RewritePlan([1, 0])
        value = {("x", Id(0)): [Id(1), frozenset({Id(0)})]}
        assert rewrite(value, plan) == {("x", Id(1)): [Id(0), frozenset({Id(1)})]}

    def test_rewrite_names_the_path_of_what_it_cannot_rewrite(self):
        class Opaque:
            pass

        with pytest.raises(TypeError, match=r"state\.msgs\[1\] \(type .*Opaque\)") as port_err:
            rewrite(_Holder(msgs=[1, Opaque()]), RewritePlan([0]))
        with pytest.raises(TypeError) as ref_err:
            ref_rewrite.rewrite(_RefHolder(msgs=[1, Opaque()]), ref_rewrite.RewritePlan([0]))
        assert str(port_err.value) == str(ref_err.value)


@dataclasses.dataclass(frozen=True)
class _Holder:
    msgs: list


@dataclasses.dataclass(frozen=True)
class _RefHolder:
    msgs: list


# --- VectorClock (vector_clock.rs:109-275) ----------------------------------------------


def test_can_display():
    assert str(VectorClock([1, 2, 3, 4])) == "<1, 2, 3, 4, ...>"
    assert str(VectorClock([])) == "<...>"
    assert str(VectorClock([0])) == "<...>"


def test_can_equate():
    assert VectorClock() == VectorClock()
    assert VectorClock([0]) == VectorClock([])
    assert VectorClock([]) == VectorClock([0])
    assert VectorClock([]) != VectorClock([1])
    assert VectorClock([1]) != VectorClock([])


def test_can_hash():
    assert hash(VectorClock()) == hash(VectorClock())
    assert hash(VectorClock([])) == hash(VectorClock([0, 0]))
    assert hash(VectorClock([1])) == hash(VectorClock([1, 0]))
    assert fingerprint(VectorClock([1])) == fingerprint(VectorClock([1, 0]))
    assert hash(VectorClock([])) != hash(VectorClock([1]))
    assert fingerprint(VectorClock([])) != fingerprint(VectorClock([1]))


def test_can_increment():
    assert VectorClock().incremented(2) == VectorClock([0, 0, 1])
    assert VectorClock().incremented(2).incremented(0).incremented(2) == VectorClock([1, 0, 2])


def test_can_merge():
    assert VectorClock([1, 2, 3, 4]).merge_max(VectorClock([5, 6, 0])) == VectorClock([5, 6, 3, 4])
    assert VectorClock([1, 0, 2]).merge_max(VectorClock([3, 1, 0, 4])) == VectorClock([3, 1, 2, 4])


def test_can_order_partially():
    assert VectorClock([]).partial_cmp(VectorClock([])) == 0
    assert VectorClock([]).partial_cmp(VectorClock([0, 0])) == 0
    assert VectorClock([0, 0]).partial_cmp(VectorClock([])) == 0
    assert VectorClock([1, 2, 0]).partial_cmp(VectorClock([1, 2])) == 0
    assert VectorClock([]).partial_cmp(VectorClock([1])) == -1
    assert VectorClock([1, 2, 3]).partial_cmp(VectorClock([1, 3, 4])) == -1
    assert VectorClock([1, 2, 3]).partial_cmp(VectorClock([1, 3, 3])) == -1
    assert VectorClock([1, 2, 3]).partial_cmp(VectorClock([2, 3, 3])) == -1
    assert VectorClock([1, 2, 3]) < VectorClock([2, 3, 3])
    assert VectorClock([1]).partial_cmp(VectorClock([])) == 1
    assert VectorClock([1, 2, 3]).partial_cmp(VectorClock([1, 1, 2])) == 1
    assert VectorClock([1, 2, 3]).partial_cmp(VectorClock([1, 1, 3])) == 1
    assert VectorClock([1, 2, 4]).partial_cmp(VectorClock([0, 1, 3])) == 1
    assert VectorClock([1, 2, 4]) > VectorClock([0, 1, 3])
    assert VectorClock([1, 2, 3]).partial_cmp(VectorClock([1, 3, 2])) is None
    assert VectorClock([1, 2, 3]).partial_cmp(VectorClock([3, 2, 1])) is None
    assert VectorClock([1, 2, 2]).partial_cmp(VectorClock([2, 1, 2])) is None
    assert not VectorClock([1, 2, 3]) < VectorClock([1, 3, 2])
    assert not VectorClock([1, 2, 3]) > VectorClock([1, 3, 2])


# --- DenseNatMap (densenatmap.rs:98-113, 223-238) ---------------------------------------


def test_dense_insert_and_lookup():
    m = DenseNatMap()
    m.insert(0, "a")
    m.insert(1, "b")
    m[1] = "B"
    assert m[0] == "a" and m[1] == "B"
    assert len(m) == 2
    assert list(m.items()) == [(0, "a"), (1, "B")]
    assert m.get(5) is None


def test_insert_at_gap_raises():
    m = DenseNatMap(["a"])
    with pytest.raises(IndexError):
        m.insert(2, "c")


def test_eq_hash_fingerprint():
    assert DenseNatMap(["x", "y"]) == DenseNatMap(["x", "y"])
    assert DenseNatMap(["x", "y"]) != DenseNatMap(["y", "x"])
    assert hash(DenseNatMap(["x"])) == hash(DenseNatMap(["x"]))
    assert fingerprint(DenseNatMap(["x"])) == fingerprint(DenseNatMap(["x"]))


def test_rewrite_reindexes_by_plan():
    plan = RewritePlan.from_values_to_sort(["c", "a", "b"])
    assert plan.order == [1, 2, 0]
    assert isinstance(plan.new_of_old, DenseNatMap)
    m = DenseNatMap(["c", "a", "b"])
    assert rewrite(m, plan) == DenseNatMap(["a", "b", "c"])


# --- a model-level consumer: vector-clock actors ----------------------------------------


class VectorClockActor:
    """The logical-clock doc actor (actor.rs:11-79) with a VectorClock state."""

    def __init__(self, index, bootstrap_to_id=None):
        self.index = index
        self.bootstrap_to_id = bootstrap_to_id

    def on_start(self, id, out):
        if self.bootstrap_to_id is not None:
            clock = VectorClock().incremented(self.index)
            out.send(self.bootstrap_to_id, clock)
            return clock
        return VectorClock()

    def on_msg(self, id, state, src, msg, out):
        if isinstance(msg, VectorClock) and msg.partial_cmp(state.get()) == 1:
            merged = state.get().merge_max(msg).incremented(self.index)
            state.set(merged)
            out.send(src, merged)

    def on_timeout(self, id, state, timer, out):
        pass


def test_vector_clock_actor_model_counterexample():
    model = (
        ActorModel(cfg=None)
        .actor(VectorClockActor(0))
        .actor(VectorClockActor(1, bootstrap_to_id=Id(0)))
        .init_network(Network.new_unordered_duplicating())
        .property(
            Expectation.ALWAYS,
            "less than max",
            lambda _m, s: all(clock.get(i) < 3 for i, clock in enumerate(s.actor_states)),
        )
    )
    witness = model.checker().spawn_bfs().join().discoveries()["less than max"]
    pairs = witness.into_vec()
    assert len([a for _s, a in pairs if a is not None]) == 4
    assert pairs[-1][0].actor_states == (VectorClock([2, 2]), VectorClock([2, 3]))


# --- ActorModelState.representative against the reference's -----------------------------


def _reachable(model, limit: int):
    """Reachable states of ``model`` by BFS, at most ``limit``."""
    seen = list(model.init_states())
    index = set(seen)
    i = 0
    while i < len(seen) and len(seen) < limit:
        for _, nxt in model.next_steps(seen[i]):
            if nxt not in index:
                index.add(nxt)
                seen.append(nxt)
        i += 1
    return seen


def _orderable(values) -> bool:
    try:
        sorted(values)
        return True
    except TypeError:
        return False


@pytest.mark.parametrize("name", ["single_copy_register_2c1s", "abd_2c2s"])
def test_actor_representative_equals_the_references(name, ref_timers_rewrite):
    port_model, ref_model = {
        "single_copy_register_2c1s": (scr.single_copy_register_model(2, 1),
                                      ref_scr.single_copy_register_model(2, 1)),
        "abd_2c2s": (abd.linearizable_register_model(2, 2),
                     ref_abd.linearizable_register_model(2, 2)),
    }[name]
    ports = {repr(s): s for s in _reachable(port_model, 400)}
    refs = {repr(s): s for s in _reachable(ref_model, 400)}
    common = sorted(set(ports) & set(refs))
    assert len(common) > 50
    for key in random.Random(8).sample(common, 50):
        port, ref = ports[key], refs[key]
        # Both packages' testers lack __rewrite__: the same typed error.
        with pytest.raises(TypeError) as port_err:
            port.representative()
        with pytest.raises(TypeError) as ref_err:
            ref.representative()
        assert str(port_err.value) == str(ref_err.value)
        assert "LinearizabilityTester" in str(port_err.value)
        port, ref = dataclasses.replace(port, history=()), dataclasses.replace(ref, history=())
        got = port.representative()
        plan = RewritePlan.from_values_to_sort(port.actor_states)
        if _orderable(port.actor_states):
            assert repr(got) == repr(ref.representative())
        # Either way it is the reference's rewrite under the port's plan.
        ref_plan = ref_rewrite.RewritePlan(plan.order)
        want = dataclasses.replace(
            ref,
            actor_states=tuple(ref_plan.reindex(ref.actor_states)),
            network=ref_rewrite.rewrite(ref.network, ref_plan),
            timers_set=tuple(ref_plan.reindex(ref.timers_set)),
        )
        assert repr(got) == repr(want)


def test_network_rewrite_remaps_envelope_ids():
    """Each network kind rebuilds itself from rewritten envelopes
    (network.rs:311-324): sources, destinations and Ids in payloads."""
    plan = RewritePlan([1, 0])
    for make in (Network.new_ordered, Network.new_unordered_duplicating,
                 Network.new_unordered_nonduplicating):
        net = make([Envelope(Id(0), Id(1), ("ping", Id(0)))])
        got = rewrite(net, plan)
        assert type(got) is type(net)
        assert list(got.iter_all()) == [Envelope(Id(1), Id(0), ("ping", Id(1)))]


# --- host symmetry() counts in both packages ---------------------------------------------


def test_host_symmetry_dfs_on_2pc_rm5_is_the_references_665():
    got = port_2pc.TwoPhaseSys(5).checker().symmetry().spawn_dfs().join()
    want = ref_2pc.TwoPhaseSys(5).checker().symmetry().spawn_dfs().join()
    assert got.unique_state_count() == want.unique_state_count() == 665
    assert got.state_count() == want.state_count()


def _register_without_history(actor_model, network, reg_module, expectation, make_server):
    """Single-copy-register, 1 server and 2 clients, with no tester in the
    history and a property that never fails, so that the search exhausts
    the space."""
    model = actor_model(cfg=None).actor(make_server())
    for _ in range(2):
        model.actor(reg_module.RegisterClient(put_count=1, server_count=1))
    return model.init_network(network.new_unordered_nonduplicating()).property(
        expectation.ALWAYS, "true", lambda _m, _s: True)


@pytest.mark.parametrize("spawn", ["spawn_dfs", "spawn_bfs"])
def test_host_symmetry_on_an_actor_model_equals_the_references(spawn, ref_timers_rewrite):
    port_model = _register_without_history(ActorModel, Network, reg, Expectation,
                                           scr.SingleCopyActor)
    ref_model = _register_without_history(RefActorModel, RefNetwork, ref_reg, RefExpectation,
                                          ref_scr.SingleCopyActor)
    got = getattr(port_model.checker().symmetry(), spawn)().join()
    want = getattr(ref_model.checker().symmetry(), spawn)().join()
    assert (got.state_count(), got.unique_state_count()) == (
        want.state_count(), want.unique_state_count()) == (79, 49)
