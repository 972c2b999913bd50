"""The port's packing toolkit (stateright_tpu_torch/packing.py) against the
reference's (stateright_tpu/packing.py): host pack/unpack words, batched
``Layout.get``/``set`` with per-row tensor indices against ``jax.vmap`` of
the reference's, ``BoundedHistory``'s device updates and predicate, and
its tester conversions. Everything is exact (integer work)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu import packing as ref
from stateright_tpu.semantics import LinearizabilityTester as RefTester
from stateright_tpu.semantics import register as ref_reg
from stateright_tpu_torch import packing as port
from stateright_tpu_torch.actor import register as port_areg
from stateright_tpu_torch.semantics import LinearizabilityTester as PortTester
from stateright_tpu_torch.semantics import register as port_reg
from stateright_tpu.actor import register as ref_areg
from stateright_tpu_torch.ops.words import from_u32, to_u32

#: (kind, name, count, bits): scalars packed densely, arrays word-aligned.
FIELDS = [
    ("uint", "a", 1, 3), ("flag", "b", 1, 1), ("uint", "c", 1, 30),
    ("array", "bits1", 70, 1), ("array", "bits3", 13, 3), ("array", "bits5", 7, 5),
    ("uint", "d", 1, 7), ("words", "full", 3, 32), ("array", "bits2", 9, 2),
]


def _layouts():
    out = []
    for mod in (ref, port):
        b = mod.LayoutBuilder()
        for kind, name, count, bits in FIELDS:
            if kind == "uint":
                b.uint(name, bits)
            elif kind == "flag":
                b.flag(name)
            elif kind == "array":
                b.array(name, count, bits)
            else:
                b.words(name, count)
        out.append(b.finish())
    return out


def _values(rng):
    vals = {}
    for _, name, count, bits in FIELDS:
        v = rng.integers(0, 1 << bits, count, dtype=np.uint64)
        vals[name] = [int(x) for x in v] if count > 1 or name == "full" else int(v[0])
    return vals


def test_layouts_and_host_codec_match():
    rl, pl = _layouts()
    assert pl.words == rl.words and pl.fields == {k: port.Field(*v) for k, v in rl.fields.items()}
    rng = np.random.default_rng(3)
    for _ in range(20):
        vals = _values(rng)
        words = pl.pack(**vals)
        assert np.array_equal(words, rl.pack(**vals))
        assert pl.unpack(words) == rl.unpack(words) == vals
    with pytest.raises(port.OverflowError32):
        pl.pack(a=8)
    with pytest.raises(port.OverflowError32):
        pl.pack(bits3=[0] * 14)


@pytest.mark.parametrize("name", [f[1] for f in FIELDS])
def test_batched_get_set_match_vmap_of_the_reference(name):
    """Per-row tensor indices and values over a batch of random word
    vectors: ``get`` and ``set`` equal ``jax.vmap`` of the reference's."""
    rl, pl = _layouts()
    f = pl.fields[name]
    rng = np.random.default_rng(len(name) * 7 + f.bits)
    B = 257
    words = rng.integers(0, 2**32, (B, pl.words), dtype=np.uint32)
    idx = rng.integers(0, f.count, B).astype(np.uint32)
    # Values past the field's width: both sides mask them.
    value = rng.integers(0, 2**32, B, dtype=np.uint32)
    want_get = np.asarray(jax.vmap(lambda w, i: rl.get(w, name, i))(jnp.asarray(words), jnp.asarray(idx)))
    want_set = np.asarray(jax.vmap(lambda w, i, v: rl.set(w, name, v, i))(
        jnp.asarray(words), jnp.asarray(idx), jnp.asarray(value)))
    tw, ti, tv = (from_u32(x, "cpu") for x in (words, idx, value))
    assert np.array_equal(to_u32(pl.get(tw, name, ti)), want_get)
    got = pl.set(tw, name, tv, ti)
    assert np.array_equal(to_u32(got), want_set)
    assert np.array_equal(to_u32(tw), words)  # set leaves its input alone
    pl.set_(tw, name, tv, ti)
    assert np.array_equal(to_u32(tw), want_set)
    # Static indices too.
    for i in {0, f.count - 1}:
        want = np.asarray(jax.vmap(lambda w, v: rl.set(w, name, v, i))(jnp.asarray(words), jnp.asarray(value)))
        assert np.array_equal(to_u32(pl.set(from_u32(words, "cpu"), name, tv, i)), want)
        assert np.array_equal(
            to_u32(pl.get(from_u32(words, "cpu"), name, i)),
            np.asarray(jax.vmap(lambda w: rl.get(w, name, i))(jnp.asarray(words))),
        )


def test_get_and_set_broadcast_state_rows_against_an_index_table():
    """The transition bodies' shape: ``words[F, 1, W]`` against a family's
    index table ``[1, n]`` gives ``[F, n]``."""
    rl, pl = _layouts()
    rng = np.random.default_rng(5)
    F, n = 9, 11
    words = rng.integers(0, 2**32, (F, pl.words), dtype=np.uint32)
    idx = rng.integers(0, 70, n).astype(np.uint32)
    tw = from_u32(words, "cpu")[:, None, :]
    ti = from_u32(idx, "cpu")[None, :]
    got_get = to_u32(pl.get(tw, "bits1", ti))
    got_set = to_u32(pl.set(tw, "bits1", 1, ti))
    assert got_get.shape == (F, n) and got_set.shape == (F, n, pl.words)
    for f in range(F):
        for j in range(n):
            assert got_get[f, j] == int(rl.get(jnp.asarray(words[f]), "bits1", jnp.uint32(idx[j])))
            want = np.asarray(rl.set(jnp.asarray(words[f]), "bits1", 1, jnp.uint32(idx[j])))
            assert np.array_equal(got_set[f, j], want)


def _history_layouts(T=3, max_ops=2, bits=2, real_time=True):
    out = []
    for mod in (ref, port):
        b = mod.LayoutBuilder()
        b.uint("pad", 5)
        h = mod.BoundedHistory(b, [10 + t for t in range(T)], max_ops, bits, bits, real_time)
        h.bind(b.finish())
        out.append((h.layout, h))
    return out


@pytest.mark.parametrize("real_time", [True, False])
def test_bounded_history_device_ops_match_the_reference(real_time):
    """Random invoke/return sequences, some misused (a second invoke, a
    return with nothing in flight) and some past ``max_ops``, each row with
    its own enable mask: the words, the overflow flags and the predicate
    equal ``jax.vmap`` of the reference's after every step."""
    (_, rh), (_, ph) = _history_layouts(real_time=real_time)
    L = ph.layout
    rng = np.random.default_rng(17 + real_time)
    B = 64
    start = np.stack([L.pack(h_valid=1)] * B)
    ref_words = jnp.asarray(start)
    port_words = from_u32(start, "cpu")
    # A well-formed order; rows skip steps at random (10%), so some rows
    # misuse the protocol and thread 0's third op overflows max_ops = 2.
    script = [("inv", 0), ("inv", 1), ("ret", 0), ("inv", 2), ("ret", 1), ("inv", 0),
              ("ret", 2), ("ret", 0), ("inv", 1), ("inv", 0), ("ret", 1), ("ret", 0)]
    for step, (kind, t) in enumerate(script):
        code = int(rng.integers(0, 3))
        enabled = rng.random(B) < 0.9
        if kind == "inv":
            ref_words = jax.vmap(lambda w, e: rh.on_invoke(w, t, jnp.uint32(code), e))(
                ref_words, jnp.asarray(enabled))
            ph.on_invoke(port_words, t, code, torch.from_numpy(enabled))
        else:
            ref_words, ref_ovf = jax.vmap(lambda w, e: rh.on_return(w, t, jnp.uint32(code), e))(
                ref_words, jnp.asarray(enabled))
            ovf = ph.on_return(port_words, t, code, torch.from_numpy(enabled))
            assert np.array_equal(ovf.numpy(), np.asarray(ref_ovf)), step
        assert np.array_equal(to_u32(port_words), np.asarray(ref_words)), step
        for m in (0, 1, 2):
            want = np.asarray(jax.vmap(lambda w: rh.valid_with_no_return_geq(w, m))(ref_words))
            assert np.array_equal(ph.valid_with_no_return_geq(port_words, m).numpy(), want)
    final = to_u32(port_words)
    assert len({r.tobytes() for r in final}) > 8  # the rows diverged
    assert 0 < sum(L.unpack(r)["h_valid"] for r in final) < B  # some rows poisoned


def _drive(tester, reg, script):
    for t, kind, v in script:
        try:
            if kind == "inv":
                tester.on_invoke(t, reg.Read() if v is None else reg.Write(v))
            else:
                tester.on_return(t, reg.WriteOk() if v == "ok" else reg.ReadOk(v))
        except Exception:
            pass
    return tester


SCRIPTS = [
    [],
    [(10, "inv", "A"), (11, "inv", None), (10, "ret", "ok"), (11, "ret", "A"),
     (12, "inv", "B"), (10, "inv", None)],
    [(11, "inv", "B"), (11, "ret", "ok"), (11, "inv", None), (11, "ret", None)],
    [(10, "inv", "A"), (10, "inv", "B")],  # misuse poisons the history
    [(12, "ret", "A")],
]


@pytest.mark.parametrize("script", range(len(SCRIPTS)))
def test_bounded_history_tester_conversions_match(script):
    (rl, rh), (pl, ph) = _history_layouts()
    values = [None, "A", "B"]
    rc, pc = ref_areg.history_codecs(values), port_areg.history_codecs(values)
    rt = _drive(RefTester(ref_reg.Register(None)), ref_reg, SCRIPTS[script])
    pt = _drive(PortTester(port_reg.Register(None)), port_reg, SCRIPTS[script])
    fields = ph.from_tester(pt, pc[0], pc[2])
    assert fields == rh.from_tester(rt, rc[0], rc[2])
    words = pl.pack(**fields)
    assert np.array_equal(words, rl.pack(**fields))
    back = ph.to_tester(pl.unpack(words), lambda: PortTester(port_reg.Register(None)), pc[1], pc[3])
    assert back == pt
    assert (back.serialized_history() is None) == (rt.serialized_history() is None)


def _fifo(mod, lanes=3, depth=3, code_bits=3):
    b = mod.LayoutBuilder().uint("pre", 5)
    f = mod.FifoLanes(b, "q", lanes=lanes, depth=depth, code_bits=code_bits)
    b.uint("post", 7)
    return f.bind(b.finish())


def test_fifo_lanes_device_ops_match_the_reference():
    """Random pushes and pops, each row with its own lane (a tensor index)
    and enable flag, some pushes past the depth and some pops of empty
    lanes: the words, heads and overflow flags equal ``jax.vmap`` of the
    reference's after every step."""
    rf, pf = _fifo(ref), _fifo(port)
    assert pf.layout.fields == {k: port.Field(*v) for k, v in rf.layout.fields.items()}
    rng = np.random.default_rng(23)
    B = 128
    start = np.stack([pf.layout.pack(pre=int(rng.integers(32)), post=int(rng.integers(128)))
                      for _ in range(B)])
    ref_words, port_words = jnp.asarray(start), from_u32(start, "cpu")
    for step in range(40):
        lane = rng.integers(0, 3, B)
        enabled = rng.random(B) < 0.8
        lane_t, en_t = torch.from_numpy(lane), torch.from_numpy(enabled)
        if rng.random() < 0.6:
            code = rng.integers(0, 8, B)
            ref_words, ref_ovf = jax.vmap(rf.push)(
                ref_words, jnp.asarray(lane, jnp.uint32), jnp.asarray(code, jnp.uint32),
                jnp.asarray(enabled))
            ovf = pf.push(port_words, lane_t, torch.from_numpy(code), en_t)
            assert np.array_equal(ovf.numpy(), np.asarray(ref_ovf)), step
        else:
            ref_words = jax.vmap(rf.pop)(ref_words, jnp.asarray(lane, jnp.uint32), jnp.asarray(enabled))
            pf.pop(port_words, lane_t, en_t)
        assert np.array_equal(to_u32(port_words), np.asarray(ref_words)), step
        for q in range(3):
            want_code, want_ne = jax.vmap(lambda w: rf.head(w, q))(ref_words)
            code, nonempty = pf.head(port_words, q)
            assert np.array_equal(nonempty.numpy(), np.asarray(want_ne))
            assert np.array_equal(code.numpy(), np.asarray(want_code).astype(np.int64))
            assert np.array_equal(pf.length(port_words, q).numpy(),
                                  np.asarray(jax.vmap(lambda w: rf.length(w, q))(ref_words)))
    lens = np.stack([pf.length(port_words, q).numpy() for q in range(3)])
    assert lens.min() == 0 and lens.max() == 3  # empty and full lanes were reached


def test_fifo_lanes_host_codec_matches_the_reference():
    rf, pf = _fifo(ref), _fifo(port)
    for codes in ([], [0], [7, 1], [3, 3, 3]):
        assert pf.host_pack_lane(codes) == rf.host_pack_lane(codes)
    for bad in ([1, 2, 3, 4], [8]):
        with pytest.raises(port.OverflowError32):
            pf.host_pack_lane(bad)
    with pytest.raises(ValueError, match="sentinel"):
        port.FifoLanes(port.LayoutBuilder(), "q", lanes=1, depth=1, code_bits=32)


def test_ordered_network_matches_the_reference():
    """Sends and deliveries on both packages' ordered networks: the same
    flows, heads in the same order, every message in the same order, the
    same equality; and the command-line names."""
    from stateright_tpu.actor import Id as RefId
    from stateright_tpu.actor.network import Envelope as RefEnvelope
    from stateright_tpu.actor.network import Network as RefNetwork
    from stateright_tpu_torch.actor import Id
    from stateright_tpu_torch.actor.network import Envelope, Network, OrderedNetwork

    rng = np.random.default_rng(4)
    net, rnet = Network.new_ordered(), RefNetwork.new_ordered()
    assert net.is_ordered and not Network.new_unordered_nonduplicating().is_ordered
    for _ in range(200):
        if len(net) and rng.random() < 0.4:
            env = list(net.iter_deliverable())[int(rng.integers(len(list(net.iter_deliverable()))))]
            net = net.on_deliver(env)
            rnet = rnet.on_deliver(RefEnvelope(RefId(env.src), RefId(env.dst), env.msg))
        else:
            src, dst, msg = (int(x) for x in rng.integers(0, 3, 3))
            net = net.send(Envelope(Id(src), Id(dst), msg))
            rnet = rnet.send(RefEnvelope(RefId(src), RefId(dst), msg))
        assert list(net.iter_deliverable()) == list(rnet.iter_deliverable())
        assert list(net.iter_all()) == list(rnet.iter_all()) and len(net) == len(rnet)
        assert net.flows == rnet.flows
    assert net == OrderedNetwork(dict(net.flows)) and hash(net) == hash(OrderedNetwork(net.flows))
    with pytest.raises(KeyError, match="flow not found"):
        Network.new_ordered().on_drop(Envelope(Id(0), Id(1), "x"))
    assert Network.names() == RefNetwork.names()
    for name in Network.names():
        assert type(Network.from_name(name)).__name__ == type(RefNetwork.from_name(name)).__name__
    with pytest.raises(ValueError, match="unable to parse network name"):
        Network.from_name("lossy")
