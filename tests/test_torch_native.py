"""The port's native host kit (``stateright_tpu_torch/native``) against the
JAX package's (``stateright_tpu/native``) on the CPU.

- ``tests/test_native.py``'s six tests, case for case, on the port;
- ``fingerprint_words`` bitwise equal to the reference's library, to both
  packages' ``ops/fphash`` and to the port's Python fallback at w = 1, 2,
  3, 8 and 46, with rows built to hit both reserved keys (their words found
  offline by inverting ``fmix32`` on the first two words of each width);
- the port's ``ParentMap``, native and fallback, equal to the reference's
  (its library and its dict) on the same seeded planes, (0, 0) pads
  included: ``len``, ``get`` and ``chain`` on every key;
- a compile that fails raises with the compiler's output; the library is
  built once into ``build/native/`` and loaded again from there;
- 2pc rm=4's ``discoveries()`` equal to the JAX engine's, path by path,
  under the sorted, hash and delta sets, through the sharded engine at
  D = 4 and through the visitor path; the engines' maps are native.

Everything is exact (tolerance 0: integer work). Each JAX engine run is
made once, in a module-scoped fixture."""

import shutil
from dataclasses import astuple

import numpy as np
import pytest
import torch

from stateright_tpu import native as ref_native
from stateright_tpu.models import two_phase_commit as ref_2pc
from stateright_tpu.ops import fphash as ref_fphash
from stateright_tpu.parallel import default_mesh as ref_mesh
from stateright_tpu_torch import PathRecorder, native
from stateright_tpu_torch.models import two_phase_commit as port_2pc
from stateright_tpu_torch.ops import fphash
from stateright_tpu_torch.ops.words import from_u32, to_u32
from stateright_tpu_torch.parallel import ShardedXlaChecker, default_mesh
from stateright_tpu_torch.xla import XlaChecker

M32 = 0xFFFFFFFF
CPU = dict(device="cpu")
KW = dict(frontier_capacity=1 << 10, table_capacity=1 << 13)
HAS_GXX = shutil.which("g++") is not None
#: The first two words of rows whose fingerprint before the remap is (0, 0)
#: and all-ones, by width; the other words are ``_rest(w)``.
RESERVED_HEADS = {
    2: {"zero": (1209737011, 923188442), "ones": (2668843757, 2749735136)},
    3: {"zero": (1051441843, 322326324), "ones": (2525121162, 1925448374)},
    8: {"zero": (3148201154, 1441274832), "ones": (834384321, 2281326580)},
    46: {"zero": (887004008, 617377103), "ones": (4138483011, 3398521445)},
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lanes(fp64):
    return np.uint32(fp64 >> 32), np.uint32(fp64 & M32)


def _planes(pairs, slots=64):
    """``key_hi/key_lo/val_hi/val_lo`` with ``(key, parent)`` pairs in the
    first slots and (0, 0) pads after."""
    planes = [np.zeros(slots, np.uint32) for _ in range(4)]
    for slot, (key, parent) in enumerate(pairs):
        planes[0][slot], planes[1][slot] = _lanes(key)
        planes[2][slot], planes[3][slot] = _lanes(parent)
    return planes


# --- tests/test_native.py, case for case --------------------------------------


@pytest.mark.skipif(not HAS_GXX, reason="no C++ toolchain")
def test_native_builds_when_toolchain_present():
    assert native.available()
    assert native.library_path().parent == native.BUILD
    assert native.BUILD.parts[-2:] == ("build", "native")


def test_fingerprint_parity_with_python():
    rng = np.random.default_rng(11)
    for w in (1, 2, 3, 8):
        words = rng.integers(0, 2**32, size=(257, w), dtype=np.uint32)
        nh, nl = native.fingerprint_words(words)
        ph, pl = fphash.fingerprint_words(from_u32(words, "cpu"))
        np.testing.assert_array_equal(nh, to_u32(ph))
        np.testing.assert_array_equal(nl, to_u32(pl))


def test_parentmap_lookup_and_chain():
    a, b, c = 0x1111_2222_3333, 0x4444_5555_6666, 0x7777_8888_9999
    pm = native.ParentMap(*_planes([(a, 0), (b, a), (c, b)]))
    assert len(pm) == 3
    assert pm[c] == b and pm[b] == a and pm[a] == 0
    assert pm.chain(c) == [c, b, a]
    assert pm.get(0xDEAD) is None
    with pytest.raises(KeyError):
        pm.chain(0xDEAD)


def test_parentmap_python_fallback_matches(monkeypatch):
    rng = np.random.default_rng(12)
    planes = [rng.integers(lo, 2**32, size=200, dtype=np.uint32) for lo in (1, 1, 0, 0)]
    fast = native.ParentMap(*planes)
    monkeypatch.setattr(native, "_load", lambda: None)
    slow = native.ParentMap(*planes)
    assert isinstance(slow, native.SortedParentMap) and not slow.native
    assert isinstance(fast, native.NativeParentMap) == fast.native == HAS_GXX
    assert len(fast) == len(slow)
    for i in range(0, 200, 17):
        key = (int(planes[0][i]) << 32) | int(planes[1][i])
        assert fast.get(key) == slow.get(key)


def test_planes_of_unequal_lengths_are_refused():
    """The library reads ``n`` rows of each plane: a short plane would be
    read past its end, so the map refuses it before the call."""
    planes = _planes([(5, 0)])
    with pytest.raises(ValueError, match="four"):
        native.ParentMap(*planes[:3], planes[3][:10])
    with pytest.raises(ValueError, match="four"):
        native.ParentMap(*(p.reshape(8, 8) for p in planes))
    with pytest.raises(ValueError, match="four"):
        native.SortedParentMap(*planes[:3], planes[3][:10])


def test_fallback_chain_detects_cycles(monkeypatch):
    a, b = 0x1111_2222_3333, 0x4444_5555_6666
    monkeypatch.setattr(native, "_load", lambda: None)
    pm = native.ParentMap(*_planes([(a, b), (b, a)]))
    with pytest.raises(RuntimeError, match="max_len"):
        pm.chain(a, max_len=100)


def test_xla_discoveries_use_native_parent_map():
    checker = port_2pc.PackedTwoPhaseSys(3).checker().spawn_xla(
        frontier_capacity=1 << 10, table_capacity=1 << 13, **CPU).join()
    checker.assert_properties()
    assert checker.discoveries()
    assert checker._parent_map().native == HAS_GXX


# --- fingerprints ---------------------------------------------------------------


def _rest(w):
    return np.random.default_rng(5000 + w).integers(0, 2**32, w - 2, dtype=np.uint32)


def _rows(w):
    """Seeded rows, all-zero and all-ones rows and, for w >= 2, the rows
    that hit the reserved keys."""
    rng = np.random.default_rng(100 + w)
    rows = [rng.integers(0, 2**32, (253, w), dtype=np.uint32),
            np.zeros((1, w), np.uint32), np.full((1, w), M32, np.uint32)]
    for head in RESERVED_HEADS.get(w, {}).values():
        rows.append(np.concatenate([np.array(head, np.uint32), _rest(w)])[None])
    return np.concatenate(rows)


@pytest.mark.parametrize("w", (1, 2, 3, 8, 46))
def test_fingerprint_words_equal_everywhere(w, monkeypatch):
    """The port's library, the reference's library, both packages'
    ``ops/fphash`` and the port's fallback give the same fingerprints."""
    words = _rows(w)
    got = native.fingerprint_words(words)
    ref = ref_native.fingerprint_words(words)
    ph, pl = fphash.fingerprint_words(from_u32(words, "cpu"))
    want = ref_fphash.fingerprint_words(words, np)
    monkeypatch.setattr(native, "_load", lambda: None)
    fallback = native.fingerprint_words(words)
    for hi, lo in (ref, (to_u32(ph), to_u32(pl)), want, fallback):
        np.testing.assert_array_equal(got[0], hi)
        np.testing.assert_array_equal(got[1], lo)
    assert got[0].dtype == got[1].dtype == np.uint32
    if w in RESERVED_HEADS:
        # The two reserved rows: (0, 0) -> (0, 1), all-ones -> (all-ones, all-ones - 1).
        assert [int(got[0][-2]), int(got[1][-2])] == [0, 1]
        assert [int(got[0][-1]), int(got[1][-1])] == [M32, M32 - 1]


def test_the_reserved_rows_hit_the_reserved_keys_before_the_remap():
    """The rows of ``RESERVED_HEADS`` fold onto the reserved pairs: without
    the remap their fingerprints would be (0, 0) and all-ones."""
    for w, heads in RESERVED_HEADS.items():
        for name, head in heads.items():
            row = np.concatenate([np.array(head, np.uint32), _rest(w)])
            fold_hi = fold_lo = 0
            for i, word in enumerate(row.tolist()):
                m_hi, m_lo = fphash._word_digests(torch.tensor([word]), i)
                fold_hi ^= int(m_hi)
                fold_lo ^= int(m_lo)
            hi = int(fphash._fmix32(torch.tensor([fold_hi ^ fphash._SEED_HI])))
            lo = int(fphash._fmix32(torch.tensor([fold_lo ^ fphash._SEED_LO])))
            assert (hi, lo) == ((0, 0) if name == "zero" else (M32, M32))


# --- the parent map against the reference's -----------------------------------------


def _forest(seed, n=300, slots=512):
    """Seeded planes of ``n`` unique keys in random slots among (0, 0) pads,
    each key's parent an earlier key or 0 (an init state)."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(1, 2**64, 2 * n, dtype=np.uint64))[:n]
    rng.shuffle(keys)
    parents = np.zeros(n, np.uint64)
    for i in range(1, n):
        if rng.random() < 0.9:
            parents[i] = keys[rng.integers(0, i)]
    planes = [np.zeros(slots, np.uint32) for _ in range(4)]
    where = rng.choice(slots, n, replace=False)
    for plane, values, shift in ((0, keys, 32), (1, keys, 0), (2, parents, 32), (3, parents, 0)):
        planes[plane][where] = ((values >> np.uint64(shift)) & np.uint64(M32)).astype(np.uint32)
    return planes, [int(k) for k in keys]


@pytest.mark.parametrize("seed", (1, 2))
def test_parent_map_equals_the_references(seed, monkeypatch):
    planes, keys = _forest(seed)
    maps = [native.ParentMap(*planes), ref_native.ParentMap(*planes),
            native.SortedParentMap(*planes)]
    monkeypatch.setattr(ref_native, "_load", lambda: None)
    maps.append(ref_native.ParentMap(*planes))
    assert maps[1]._handle is not None and maps[3]._dict is not None
    misses = [1, 2**64 - 1, keys[0] ^ 1]
    for pm in maps:
        assert len(pm) == len(keys)
        for fp in keys + misses:
            assert pm.get(fp) == maps[1].get(fp)
            assert (fp in pm) == (fp in maps[1])
        for fp in keys:
            assert pm.chain(fp) == maps[1].chain(fp)
            assert pm[fp] == maps[1][fp]
        with pytest.raises(KeyError):
            pm.chain(misses[0])
    # The native chain grows its buffer past its first 1,024 links.
    long = [(k, p) for k, p in zip(range(5000, 2, -1), range(4999, 1, -1))] + [(2, 0)]
    deep = native.ParentMap(*_planes(long, slots=8192))
    assert deep.chain(5000) == list(range(5000, 1, -1))
    with pytest.raises(RuntimeError, match="max_len"):
        deep.chain(5000, max_len=100)


# --- the build ----------------------------------------------------------------------


@pytest.mark.skipif(not HAS_GXX, reason="no C++ toolchain")
def test_a_compile_failure_raises_with_the_compilers_output(tmp_path):
    src = tmp_path / "hostkit.cpp"
    src.write_text(native.SRC.read_text().replace(
        "int64_t parentmap_count(const ParentMap* pm) { return pm->count; }",
        "int64_t parentmap_count(const ParentMap* pm) { return pm->no_such_member; }"))
    with pytest.raises(RuntimeError, match=r"g\+\+ failed for hostkit.cpp") as err:
        native.build(src, tmp_path / "build")
    assert "no_such_member" in str(err.value)
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.skipif(not HAS_GXX, reason="no C++ toolchain")
def test_the_library_is_built_once_and_loaded_again(monkeypatch):
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD
    mtime = path.stat().st_mtime_ns
    monkeypatch.setattr(native, "_lib", None)
    assert native.build() == 0.0
    assert native.available() and native._lib is not None
    assert path.stat().st_mtime_ns == mtime
    assert native.library_path() == path


@pytest.mark.skipif(not HAS_GXX, reason="no C++ toolchain")
def test_an_edited_source_gets_a_library_of_its_own(tmp_path):
    src = tmp_path / "hostkit.cpp"
    src.write_text(native.SRC.read_text())
    first = native.library_path(src, tmp_path)
    assert native.build(src, tmp_path) > 0.0 and first.exists()
    assert native.build(src, tmp_path) == 0.0
    src.write_text(native.SRC.read_text() + "\n// edited\n")
    assert native.library_path(src, tmp_path) != first


# --- witness paths against the JAX engine -------------------------------------------


def _paths(found):
    return {name: ([astuple(s) for s in p.into_states()], p.into_actions())
            for name, p in found.items()}


@pytest.fixture(scope="module")
def ref_rm4():
    """The JAX engine's rm=4 under each visited set (one CPU compile each)."""
    return {d: _paths(ref_2pc.PackedTwoPhaseSys(4).checker().spawn_xla(dedup=d, **KW)
                      .join().discoveries())
            for d in ("sorted", "hash", "delta")}


@pytest.mark.parametrize("dedup", ("sorted", "hash", "delta"))
def test_discoveries_equal_the_jax_engines(ref_rm4, dedup):
    c = port_2pc.PackedTwoPhaseSys(4).checker().spawn_xla(dedup=dedup, **KW, **CPU).join()
    pm = c._parent_map()
    assert isinstance(c, XlaChecker) and len(pm) == c.unique_state_count() == 1_568
    assert pm.native == HAS_GXX
    assert _paths(c.discoveries()) == ref_rm4[dedup]


def test_sharded_discoveries_equal_the_jax_engines():
    """At D = 4 against the JAX mesh engine at D = 4 (a shard's parents
    arrive in routing order, so the mesh's witnesses are its own)."""
    c = port_2pc.PackedTwoPhaseSys(4).checker().spawn_xla(
        mesh=default_mesh(4, device="cpu"), **KW).join()
    assert isinstance(c, ShardedXlaChecker)
    pm = c._parent_map()
    assert pm.native == HAS_GXX and len(pm) == c.unique_state_count() == 1_568
    ref = ref_2pc.PackedTwoPhaseSys(4).checker().spawn_xla(mesh=ref_mesh(4), **KW).join()
    assert _paths(c.discoveries()) == _paths(ref.discoveries())


def test_visitor_path_discoveries_equal_the_jax_engines(ref_rm4):
    """The visitor path (one level a dispatch, each frontier state's path
    through the parent map): its discoveries are the JAX engine's, and it
    records a path to every state, each discovery's among them."""
    recorder, recorded = PathRecorder.new_with_accessor()
    c = port_2pc.PackedTwoPhaseSys(4).checker().visitor(recorder).spawn_xla(**KW, **CPU).join()
    assert c.metrics()["levels_per_dispatch"] == 1
    found = _paths(c.discoveries())
    assert found == ref_rm4["sorted"]
    paths = {(tuple(astuple(s) for s in p.into_states()), tuple(p.into_actions()))
             for p in recorded()}
    assert len(recorded()) == len(paths) == 1_568
    for states, actions in found.values():
        assert (tuple(states), tuple(actions)) in paths


def test_a_missing_link_raises_the_references_error():
    c = port_2pc.PackedTwoPhaseSys(3).checker().spawn_xla(**KW, **CPU).join()
    fp = next(iter(c._found_names.values()))
    rows = c._ds.occupied_rows(c._table)
    keep = (rows[0] != (fp >> 32)) | (rows[1] != (fp & M32))
    broken = native.ParentMap(*(r[keep] for r in rows))
    with pytest.raises(RuntimeError, match="missing from the visited table during path reconstruction"):
        c._path_for(fp, broken)
