"""The port's remaining models and fixtures against the reference
package's, on the CPU:

- ``packing.SlotMultiset``: insert, delivery and the canonical slot order
  bit for bit on seeded random multisets;
- ``semantics.device.DeviceWORegister``: the batched serializer's verdicts
  on seeded random write-once histories, and its step on every small
  input, including the op codes 0 and 1 where the reference's uint32
  ``o - 2`` wraps;
- the write-once register and vector specs and the testers over them (the
  cases of ``tests/test_semantics.py``), and a write-once register actor
  system with ``WORegisterClient`` on the host engines;
- ``PackedPingPong`` (``actor/packed.py``) at the three configurations of
  ``tests/test_packed_actor.py``, lossy max 5 at 4,094 states;
- ``PackedTimers`` to depth 5, its codec and its overflow path;
- ``PackedPuzzle``: the doc board's discovery and the unsolvable 2x2
  board's 25 / 12;
- the ordered reliable link's three properties
  (``tests/test_ordered_reliable_link.py``).

Everything is exact (integer work, tolerance 0)."""

import random
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stateright_tpu as ref_pkg
import stateright_tpu_torch as port_pkg
from stateright_tpu import packing as ref_packing
from stateright_tpu.actor import actor_test_util as ref_att
from stateright_tpu.actor import packed as ref_packed
from stateright_tpu.actor import write_once_register as ref_woreg
from stateright_tpu.models import puzzle as ref_puzzle
from stateright_tpu.models import timers as ref_timers
from stateright_tpu.semantics import device as ref_dev
from stateright_tpu_torch import Expectation
from stateright_tpu_torch import packing
from stateright_tpu_torch.actor import ActorModel, DeliverAction, Id, Network
from stateright_tpu_torch.actor import ActorModelState
from stateright_tpu_torch.actor import actor_test_util as att
from stateright_tpu_torch.actor import packed
from stateright_tpu_torch.actor import write_once_register as woreg
from stateright_tpu_torch.actor.ordered_reliable_link import ActorWrapper, Deliver
from stateright_tpu_torch.models import puzzle, timers
from stateright_tpu_torch.semantics import device as port_dev
from stateright_tpu_torch.semantics import vec
from stateright_tpu_torch.semantics import write_once_register as wor
from stateright_tpu_torch.ops.words import from_u32, to_u32

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


def _levels(c):
    return [(r["depth"], r["frontier"], r["generated"], r["unique"]) for r in c.level_log]


# --- SlotMultiset -------------------------------------------------------------


@pytest.mark.parametrize("count_bits", [0, 2])
def test_slot_multiset_equals_the_references(count_bits):
    """Random multisets in 6 slots (some full, some with a code at its count
    cap), each sent a random code and, separately, delivered from a random
    slot, with some rows disabled: the words, the overflow flags and the
    decoded slots equal ``jax.vmap`` of the reference's."""
    k, code_bits = 6, 5
    lay = packing.LayoutBuilder().uint("other", 3).words("net", k).finish()
    rlay = ref_packing.LayoutBuilder().uint("other", 3).words("net", k).finish()
    ms = packing.SlotMultiset(lay, "net", code_bits, count_bits)
    rms = ref_packing.SlotMultiset(rlay, "net", code_bits, count_bits)
    rng = np.random.default_rng(17 + count_bits)
    rows = []
    for _ in range(400):
        n = int(rng.integers(0, k + 1))
        codes = rng.choice(12, n, replace=False)
        pairs = [(int(c), int(rng.integers(1, ms.max_count + 1))) for c in codes]
        slots = ms.host_pack(pairs)
        assert slots == rms.host_pack(pairs)
        assert ms.host_unpack(slots) == rms.host_unpack(slots) == sorted(pairs)
        rows.append(lay.pack(other=int(rng.integers(0, 8)), net=slots))
    words = np.stack(rows)
    codes = rng.integers(0, 12, len(words))
    enabled = rng.random(len(words)) < 0.85
    slot_ix = rng.integers(0, k, len(words))

    want_w, want_o = jax.vmap(lambda w, c, e: rms.send(w, c, e))(
        jnp.asarray(words), jnp.asarray(codes, jnp.uint32), jnp.asarray(enabled))
    got = from_u32(words, "cpu")
    got_o = ms.send(got, torch.as_tensor(codes), torch.as_tensor(enabled))
    assert np.array_equal(to_u32(got), np.asarray(want_w))
    assert np.array_equal(got_o.numpy(), np.asarray(want_o))
    assert got_o.any() and (~got_o).any()

    want_r = jax.vmap(lambda w, i, e: rms.remove_slot(w, i, e))(
        jnp.asarray(words), jnp.asarray(slot_ix), jnp.asarray(enabled))
    got = from_u32(words, "cpu")
    ms.remove_slot(got, torch.as_tensor(slot_ix), torch.as_tensor(enabled))
    assert np.array_equal(to_u32(got), np.asarray(want_r))

    # A Python code and slot index (the form a model's static families
    # pass) take the same path as tensors.
    want_w, want_o = jax.vmap(lambda w: rms.send(w, jnp.uint32(7)))(jnp.asarray(words))
    got_s = from_u32(words, "cpu")
    assert np.array_equal(ms.send(got_s, 7).numpy(), np.asarray(want_o))
    assert np.array_equal(to_u32(got_s), np.asarray(want_w))
    want_s = jax.vmap(lambda w: rms.remove_slot(w, k - 1))(jnp.asarray(words))
    got_s = from_u32(words, "cpu")
    ms.remove_slot(got_s, k - 1)
    assert np.array_equal(to_u32(got_s), np.asarray(want_s))

    for mine, theirs in zip(ms.decode(ms.slots(got)),
                            jax.vmap(lambda w: rms.decode(rms.slots(w)))(want_r)):
        assert np.array_equal(to_u32(mine) if mine.dtype != torch.bool else mine.numpy(),
                              np.asarray(theirs))


def test_slot_multiset_overflow_leaves_the_slots_unchanged():
    lay = packing.LayoutBuilder().words("net", 2).finish()
    ms = packing.SlotMultiset(lay, "net", code_bits=8, count_bits=1)
    words = from_u32(lay.pack(net=ms.host_pack([(1, 2), (2, 1)]))[None], "cpu")
    before = words.clone()
    assert bool(ms.send(words, 1))  # count at its cap
    assert torch.equal(words, before)
    assert bool(ms.send(words, 9))  # no free slot
    assert not bool(ms.send(words, 9, enabled=False))
    with pytest.raises(packing.OverflowError32):
        ms.host_pack([(1, 1), (2, 1), (3, 1)])


# --- the write-once register on the device ------------------------------------


def _random_events(rng, T, M, ops_of, rets_of):
    """A random concurrent history: at most M completed ops per thread,
    then possibly one in flight."""
    events, n, fl = [], [0] * T, [None] * T
    for _ in range(4 * T * (M + 1)):
        t = rng.randrange(T)
        if fl[t] is not None and n[t] < M and rng.random() < 0.6:
            events.append(("ret", t, rng.choice(rets_of(fl[t]))))
            n[t] += 1
            fl[t] = None
        elif fl[t] is None and n[t] < M:
            op = rng.choice(ops_of())
            events.append(("inv", t, op))
            fl[t] = op
    return events


def _history(pkg, events, real_time):
    sem = pkg.semantics
    tester = (sem.LinearizabilityTester if real_time else sem.SequentialConsistencyTester)(
        sem.write_once_register.WORegister(None))
    for kind, t, (name, *args) in events:
        x = getattr(sem.write_once_register, name)(*args)
        tester.on_invoke(t, x) if kind == "inv" else tester.on_return(t, x)
    return tester


@pytest.mark.parametrize("T", [2, 3])
@pytest.mark.parametrize("real_time", [True, False], ids=["lin", "seqcst"])
def test_device_wo_register_equals_the_reference(T, real_time):
    M, trials = 2, 200
    rng = random.Random(31_337 + 10 * T + real_time)
    values = [None] + [chr(ord("A") + k) for k in range(T)]
    ops_of = lambda: [("Read",)] + [("Write", v) for v in values[1:]]
    rets_of = lambda op: ([("ReadOk", v) for v in values] if op[0] == "Read"
                          else [("WriteOk",), ("WriteFail",)])
    histories = [_random_events(rng, T, M, ops_of, rets_of) for _ in range(trials)]
    verdicts = []
    for pkg, pk, codecs in ((port_pkg, packing, woreg), (ref_pkg, ref_packing, ref_woreg)):
        b = pk.LayoutBuilder()
        hist = pk.BoundedHistory(b, thread_ids=list(range(T)), max_ops=M, op_bits=3, ret_bits=3)
        hist.bind(b.finish())
        op_code, _, ret_code, _ = codecs.wo_history_codecs(values)
        testers = [_history(pkg, h, real_time) for h in histories]
        words = np.stack([hist.layout.pack(**hist.from_tester(h, op_code, ret_code)) for h in testers])
        if pkg is port_pkg:
            got = port_dev.device_serializable(hist, from_u32(words, "cpu"), port_dev.DeviceWORegister(),
                                               real_time=real_time).numpy()
            host = np.array([h.serialized_history() is not None for h in testers])
        else:
            got = np.asarray(jax.jit(jax.vmap(lambda w: ref_dev.device_serializable(
                hist, w, ref_dev.DeviceWORegister(), real_time=real_time)))(jnp.asarray(words)))
        verdicts.append(got)
    assert np.array_equal(verdicts[0], verdicts[1])
    assert np.array_equal(verdicts[0], host)
    assert host.any() and (~host).any()


def test_device_wo_register_step_equals_the_references_under_the_wrap():
    """The spec's step on every (value, op, ret, completed) up to 3 values:
    op codes 0 (no op) and 1 (Read) give ``o - 2`` < 0 here where the
    reference's uint32 wraps; the verdicts and the next values are equal."""
    v, o, r, comp = np.meshgrid(np.arange(4), np.arange(6), np.arange(8), [False, True], indexing="ij")
    v, o, r, comp = (x.reshape(-1) for x in (v, o, r, comp))
    want_ok, want_v = ref_dev.DeviceWORegister().step(
        jnp, jnp.asarray(v, jnp.uint32), jnp.asarray(o, jnp.uint32), jnp.asarray(r, jnp.uint32),
        jnp.asarray(comp))
    got_ok, got_v = port_dev.DeviceWORegister().step(
        *(torch.as_tensor(x, dtype=port_dev.WORK) for x in (v, o, r)), torch.as_tensor(comp))
    assert np.array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))
    assert (o < 2).sum() > 0


# --- the write-once register and vector specs ---------------------------------


def test_wo_register_spec_semantics():
    r = wor.WORegister(None)
    assert r.invoke(wor.Write("A")) == wor.WriteOk()
    assert r.invoke(wor.Read()) == wor.ReadOk("A")
    assert r.invoke(wor.Write("B")) == wor.WriteFail()
    assert r.invoke(wor.Read()) == wor.ReadOk("A")
    assert wor.WORegister(None).is_valid_history([
        (wor.Read(), wor.ReadOk(None)), (wor.Write("A"), wor.WriteOk()),
        (wor.Read(), wor.ReadOk("A")), (wor.Write("B"), wor.WriteFail()),
        (wor.Read(), wor.ReadOk("A")), (wor.Write("C"), wor.WriteFail()),
        (wor.Read(), wor.ReadOk("A")),
    ])
    assert not wor.WORegister("A").is_valid_history(
        [(wor.Read(), wor.ReadOk("A")), (wor.Write("B"), wor.WriteOk())])
    assert not wor.WORegister(None).is_valid_history(
        [(wor.Read(), wor.ReadOk("A")), (wor.Write("A"), wor.WriteOk())])
    assert not wor.WORegister(None).is_valid_history([
        (wor.Read(), wor.ReadOk(None)), (wor.Write("A"), wor.WriteOk()),
        (wor.Write("B"), wor.WriteOk())])


def test_vec_spec_semantics():
    v = vec.VecSpec(("A",))
    got = [v.invoke(op) for op in (vec.Len(), vec.Push("B"), vec.Len(), vec.Pop(), vec.Len(),
                                   vec.Pop(), vec.Len(), vec.Pop())]
    assert got == [vec.LenOk(1), vec.PushOk(), vec.LenOk(2), vec.PopOk("B"), vec.LenOk(1),
                   vec.PopOk("A"), vec.LenOk(0), vec.PopOk(None)]
    assert vec.VecSpec().is_valid_history([
        (vec.Push(10), vec.PushOk()), (vec.Push(20), vec.PushOk()), (vec.Len(), vec.LenOk(2)),
        (vec.Pop(), vec.PopOk(20)), (vec.Len(), vec.LenOk(1)), (vec.Pop(), vec.PopOk(10)),
        (vec.Len(), vec.LenOk(0)), (vec.Pop(), vec.PopOk(None))])
    assert not vec.VecSpec().is_valid_history(
        [(vec.Push(10), vec.PushOk()), (vec.Push(20), vec.PushOk()), (vec.Len(), vec.LenOk(1))])
    assert not vec.VecSpec().is_valid_history(
        [(vec.Push(10), vec.PushOk()), (vec.Push(20), vec.PushOk()), (vec.Pop(), vec.PopOk(10))])


#: Vector histories of ``tests/test_semantics.py``: (tester, events, whether
#: a serialization exists). An event is ("inv" | "ret" | "invret", thread,
#: op and/or ret as (name, *args)).
VEC_CASES = [
    ("lin", [("inv", 0, ("Push", 10))], True),
    ("lin", [("inv", 0, ("Push", 10)), ("invret", 1, ("Pop",), ("PopOk", None))], True),
    ("lin", [("inv", 0, ("Push", 10)), ("invret", 1, ("Pop",), ("PopOk", 10))], True),
    ("lin", [("invret", 0, ("Push", 10), ("PushOk",)), ("inv", 0, ("Push", 20)),
             ("invret", 1, ("Len",), ("LenOk", 1)), ("invret", 1, ("Pop",), ("PopOk", 20)),
             ("invret", 1, ("Pop",), ("PopOk", 10))], True),
    ("lin", [("invret", 0, ("Push", 10), ("PushOk",)), ("inv", 0, ("Push", 20)),
             ("invret", 1, ("Len",), ("LenOk", 1)), ("invret", 1, ("Pop",), ("PopOk", 10)),
             ("invret", 1, ("Pop",), ("PopOk", 20))], True),
    ("lin", [("invret", 0, ("Push", 10), ("PushOk",)), ("inv", 0, ("Push", 20)),
             ("invret", 1, ("Len",), ("LenOk", 2)), ("invret", 1, ("Pop",), ("PopOk", 20)),
             ("invret", 1, ("Pop",), ("PopOk", 10))], True),
    ("lin", [("invret", 0, ("Push", 10), ("PushOk",)), ("inv", 1, ("Len",)),
             ("inv", 0, ("Push", 20)), ("ret", 1, ("LenOk", 1))], True),
    ("lin", [("invret", 0, ("Push", 10), ("PushOk",)), ("inv", 1, ("Len",)),
             ("inv", 0, ("Push", 20)), ("ret", 1, ("LenOk", 2))], True),
    ("lin", [("invret", 0, ("Push", 10), ("PushOk",)), ("invret", 1, ("Pop",), ("PopOk", None))],
     False),
    ("lin", [("invret", 0, ("Push", 10), ("PushOk",)), ("inv", 1, ("Len",)),
             ("inv", 0, ("Push", 20)), ("ret", 1, ("LenOk", 0))], False),
    ("lin", [("invret", 0, ("Push", 10), ("PushOk",)), ("inv", 0, ("Push", 20)),
             ("invret", 1, ("Len",), ("LenOk", 2)), ("invret", 1, ("Pop",), ("PopOk", 10)),
             ("invret", 1, ("Pop",), ("PopOk", 20))], False),
    ("sc", [("inv", 0, ("Push", 10))], True),
    ("sc", [("inv", 0, ("Push", 10)), ("invret", 1, ("Pop",), ("PopOk", None))], True),
    ("sc", [("invret", 1, ("Pop",), ("PopOk", 10)), ("invret", 0, ("Push", 10), ("PushOk",)),
            ("invret", 0, ("Pop",), ("PopOk", 20)), ("inv", 0, ("Push", 30)),
            ("invret", 1, ("Push", 20), ("PushOk",)), ("invret", 1, ("Pop",), ("PopOk", None))],
     True),
    ("sc", [("invret", 0, ("Push", 10), ("PushOk",)), ("inv", 0, ("Push", 20)),
            ("invret", 1, ("Len",), ("LenOk", 2)), ("invret", 1, ("Pop",), ("PopOk", 10)),
            ("invret", 1, ("Pop",), ("PopOk", 20))], False),
]


def _vec_serialized(pkg, kind, events):
    sem = pkg.semantics
    make = sem.vec.VecSpec
    tester = (sem.LinearizabilityTester if kind == "lin" else sem.SequentialConsistencyTester)(make())
    build = lambda name, *args: getattr(sem.vec, name)(*args)
    for ev in events:
        if ev[0] == "inv":
            tester.on_invoke(ev[1], build(*ev[2]))
        elif ev[0] == "ret":
            tester.on_return(ev[1], build(*ev[2]))
        else:
            tester.on_invret(ev[1], build(*ev[2]), build(*ev[3]))
    found = tester.serialized_history()
    return None if found is None else [(type(op).__name__, tuple(op), type(ret).__name__, tuple(ret))
                                       for op, ret in found]


@pytest.mark.parametrize("case", range(len(VEC_CASES)))
def test_vec_testers_equal_the_references(case):
    kind, events, serializable = VEC_CASES[case]
    got = _vec_serialized(port_pkg, kind, events)
    assert got == _vec_serialized(ref_pkg, kind, events)
    assert (got is not None) == serializable


class SingleWORegisterServer:
    """A write-once server: the first Put wins, a conflicting Put fails."""

    def __init__(self, mod):
        self.mod = mod

    def on_start(self, id, out):
        return None

    def on_msg(self, id, state, src, msg, out):
        if isinstance(msg, self.mod.Put):
            if state.get() is None or state.get() == msg.value:
                state.set(msg.value)
                out.send(src, self.mod.PutOk(msg.request_id))
            else:
                out.send(src, self.mod.PutFail(msg.request_id))
        elif isinstance(msg, self.mod.Get):
            out.send(src, self.mod.GetOk(msg.request_id, state.get()))

    def on_timeout(self, id, state, timer, out):
        pass


def _wo_system(pkg, mod):
    sem = pkg.semantics
    return (
        pkg.actor.ActorModel(cfg=None, init_history=sem.LinearizabilityTester(
            sem.write_once_register.WORegister(None)))
        .actor(SingleWORegisterServer(mod))
        .actor(mod.WORegisterClient(put_count=1, server_count=1))
        .actor(mod.WORegisterClient(put_count=1, server_count=1))
        .init_network(pkg.actor.Network.new_unordered_nonduplicating())
        .record_msg_out(mod.record_invocations)
        .record_msg_in(mod.record_returns)
        .property(pkg.Expectation.ALWAYS, "linearizable",
                  lambda _, s: s.history.serialized_history() is not None)
    )


def test_wo_register_actor_system_equals_the_references():
    got = _wo_system(port_pkg, woreg).checker().spawn_bfs().join()
    want = _wo_system(ref_pkg, ref_woreg).checker().spawn_bfs().join()
    got.assert_no_discovery("linearizable")
    assert (got.state_count(), got.unique_state_count(), got.max_depth()) == (
        want.state_count(), want.unique_state_count(), want.max_depth())
    assert got.unique_state_count() > 0


# --- packed ping-pong ----------------------------------------------------------


@pytest.mark.parametrize("max_nat, history, lossy", [(5, False, True), (3, False, False),
                                                     (3, True, True)])
def test_packed_ping_pong_equals_the_reference(max_nat, history, lossy):
    cfg = att.PingPongCfg(history, max_nat)
    m = packed.PackedPingPong(cfg, lossy=lossy)
    c = m.checker().spawn_xla(**CPU).join()
    ref_model = ref_att.ping_pong_model(ref_att.PingPongCfg(history, max_nat))
    if lossy:
        ref_model = ref_model.lossy_network(True)
    oracle = ref_model.checker().spawn_bfs().join()
    assert (c.state_count(), c.unique_state_count(), c.max_depth()) == (
        oracle.state_count(), oracle.unique_state_count(), oracle.max_depth())
    assert set(c.discoveries()) == set(oracle.discoveries())
    if (max_nat, lossy) == (5, True):
        assert c.unique_state_count() == 4_094  # model.rs:680
    r = ref_packed.PackedPingPong(ref_att.PingPongCfg(history, max_nat), lossy=lossy)
    if (max_nat, lossy) == (3, False):
        # The reference's engine (its sorted visited set, as the port's):
        # the same levels and the same witnesses.
        rc = r.checker().spawn_xla(dedup="sorted").join()
        assert _levels(c) == _levels(rc)
        # The packages' action classes differ; compare their renderings.
        assert {k: repr(p.into_actions()) for k, p in c.discoveries().items()} == {
            k: repr(p.into_actions()) for k, p in rc.discoveries().items()}
    # The step and properties on every reachable state equal the reference's.
    words = np.stack([m.pack(s) for s in _reachable(m)])
    want_next, want_valid = (np.asarray(x) for x in jax.vmap(r.packed_step)(jnp.asarray(words)))
    nxt, valid = m.packed_step(from_u32(words, "cpu"))
    assert np.array_equal(valid.numpy(), want_valid)
    assert np.array_equal(to_u32(nxt)[want_valid], want_next[want_valid])
    want_props = np.asarray(jax.vmap(r.packed_properties)(jnp.asarray(words)))
    assert np.array_equal(m.packed_properties(from_u32(words, "cpu")).numpy(), want_props)


def _reachable(model):
    seen = list(model.init_states())
    index = set(seen)
    i = 0
    while i < len(seen):
        for _, nxt in model.next_steps(seen[i]):
            if nxt not in index and model.within_boundary(nxt):
                index.add(nxt)
                seen.append(nxt)
        i += 1
    return seen


# --- timers --------------------------------------------------------------------


def test_timers_to_depth_5_equal_the_reference():
    c = timers.PackedTimers(3).checker().target_max_depth(5).spawn_xla(**CPU).join()
    r = ref_timers.PackedTimers(3).checker().target_max_depth(5).spawn_xla().join()
    host = ref_timers.timers_model(3).checker().target_max_depth(5).spawn_bfs().join()
    assert (c.state_count(), c.unique_state_count(), c.max_depth()) == (
        r.state_count(), r.unique_state_count(), r.max_depth())
    assert c.unique_state_count() == host.unique_state_count()
    assert c.max_depth() == host.max_depth() == 5
    assert _levels(c) == _levels(r)


def test_timers_codec_and_step_equal_the_reference():
    m, r = timers.PackedTimers(3), ref_timers.PackedTimers(3)
    frontier = list(m._inner.init_states())
    states = list(frontier)
    for _ in range(3):
        frontier = [t for s in frontier for _, t in m._inner.next_steps(s)]
        states += frontier
    states = list(dict.fromkeys(states))
    assert len(states) > 50
    words = np.stack([m.pack(s) for s in states])
    for s, row in zip(states, words):
        assert m.unpack(row) == s
    assert np.array_equal(words, np.stack([r.pack(r.unpack(row)) for row in words]))
    want = [np.asarray(x) for x in jax.vmap(r.packed_step)(jnp.asarray(words))]
    nxt, valid, ovf = m.packed_step(from_u32(words, "cpu"))
    assert np.array_equal(valid.numpy(), want[1]) and np.array_equal(ovf.numpy(), want[2])
    assert np.array_equal(to_u32(nxt)[want[1]], want[0][want[1]])
    # Actor 1's peers are 0 and 2: its Odd timeout is a dropped no-op.
    assert valid[0, :6].tolist() == [True, True, True, False, True, True]


def test_timers_counter_past_its_field_fails_loudly():
    """A counter outgrowing its field: the host codec raises
    ``OverflowError32``; the engine stops with the codec-overflow error,
    the reference's ``RuntimeError``, never a retry or a dropped state."""
    m = timers.PackedTimers(3, count_bits=2)
    state = m._inner.init_states()[0]
    big = state.actor_states[0]._replace(sent=4)
    with pytest.raises(packing.OverflowError32):
        m.pack(ActorModelState(actor_states=(big,) + state.actor_states[1:], network=state.network,
                               timers_set=state.timers_set, history=state.history))
    errors = []
    for build, kw in ((lambda: timers.PackedTimers(3, count_bits=2), CPU),
                      (lambda: ref_timers.PackedTimers(3, count_bits=2), {})):
        with pytest.raises(RuntimeError, match="overflow") as err:
            build().checker().target_max_depth(8).spawn_xla(**kw).join()
        errors.append(type(err.value))
    assert errors[0] is errors[1] is RuntimeError


# --- puzzle --------------------------------------------------------------------

DOC_BOARD = [1, 4, 2, 3, 5, 8, 6, 7, 0]
DOC_SOLUTION = ["Down", "Right", "Down", "Right"]


def test_puzzle_doc_board_discovery():
    c = puzzle.PackedPuzzle(DOC_BOARD).checker().spawn_xla(**CPU).join()
    c.assert_properties()
    c.assert_discovery("solved", DOC_SOLUTION)
    host = puzzle.Puzzle(DOC_BOARD).checker().spawn_bfs().join()
    host.assert_discovery("solved", DOC_SOLUTION)
    r = ref_puzzle.PackedPuzzle(DOC_BOARD).checker().spawn_xla().join()
    assert c.discoveries()["solved"].into_actions() == r.discoveries()["solved"].into_actions()
    assert _levels(c) == _levels(r)


def test_puzzle_unsolvable_2x2_full_coverage():
    bad = [0, 2, 1, 3]  # the other 12-state component
    c = puzzle.PackedPuzzle(bad, side=2).checker().spawn_xla(**CPU).join()
    host = ref_puzzle.Puzzle(bad, side=2).checker().spawn_bfs().join()
    assert (c.state_count(), c.unique_state_count()) == (
        host.state_count(), host.unique_state_count()) == (25, 12)
    assert c.discovery("solved") is None and host.discovery("solved") is None


def test_puzzle_step_equals_the_reference():
    m, r = puzzle.PackedPuzzle(DOC_BOARD), ref_puzzle.PackedPuzzle(DOC_BOARD)
    rng = np.random.default_rng(3)
    boards = [tuple(rng.permutation(9)) for _ in range(64)] + [tuple(range(9))]
    words = np.stack([m.pack(b) for b in boards])
    assert all(m.unpack(w) == b for w, b in zip(words, boards))
    want_next, want_valid = (np.asarray(x) for x in jax.vmap(r.packed_step)(jnp.asarray(words)))
    nxt, valid = m.packed_step(from_u32(words, "cpu"))
    assert np.array_equal(valid.numpy(), want_valid)
    assert np.array_equal(to_u32(nxt)[want_valid], want_next[want_valid])
    want_props = np.asarray(jax.vmap(r.packed_properties)(jnp.asarray(words)))
    assert np.array_equal(m.packed_properties(from_u32(words, "cpu")).numpy(), want_props)


# --- the ordered reliable link --------------------------------------------------


class OrlMsg(NamedTuple):
    value: int


class Sender:
    def __init__(self, receiver_id):
        self.receiver_id = receiver_id

    def on_start(self, id, out):
        out.send(self.receiver_id, OrlMsg(42))
        out.send(self.receiver_id, OrlMsg(43))
        return ()

    def on_msg(self, id, state, src, msg, out):
        pass

    def on_timeout(self, id, state, timer, out):
        pass


class Receiver:
    def on_start(self, id, out):
        return ()

    def on_msg(self, id, state, src, msg, out):
        state.set(state.get() + ((src, msg),))

    def on_timeout(self, id, state, timer, out):
        pass


def _received(state):
    return state.actor_states[1].wrapped_state


def orl_model():
    """ordered_reliable_link.rs:207-316: a lossy duplicating network bounded
    to fewer than 4 messages in flight."""
    return (
        ActorModel(cfg=None, init_history=())
        .actor(ActorWrapper.with_default_timeout(Sender(Id(1))))
        .actor(ActorWrapper.with_default_timeout(Receiver()))
        .init_network(Network.new_unordered_duplicating())
        .lossy_network(True)
        .property(Expectation.ALWAYS, "no redelivery", lambda _, state: (
            sum(1 for _, m in _received(state) if m.value == 42) < 2
            and sum(1 for _, m in _received(state) if m.value == 43) < 2))
        .property(Expectation.ALWAYS, "ordered", lambda _, state: all(
            a.value <= b.value for (_, a), (_, b) in zip(_received(state), _received(state)[1:])))
        .property(Expectation.SOMETIMES, "delivered", lambda _, state:
                  _received(state) == ((Id(0), OrlMsg(42)), (Id(0), OrlMsg(43))))
        .within_boundary_fn(lambda _, state: len(state.network) < 4)
    )


def test_ordered_reliable_link_properties():
    c = orl_model().checker().spawn_bfs().join()
    c.assert_no_discovery("no redelivery")
    c.assert_no_discovery("ordered")
    c.assert_discovery("delivered", [
        DeliverAction(Id(0), Id(1), Deliver(1, OrlMsg(42))),
        DeliverAction(Id(0), Id(1), Deliver(2, OrlMsg(43))),
    ])
