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
