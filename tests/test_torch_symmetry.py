"""Device symmetry reduction in the port (stateright_tpu_torch/sym, the
engine's ``symmetry=``) against the reference package's on the CPU.

Mirrors every case of ``tests/test_symmetry.py`` that needs neither the
mesh, on-demand checking, mux, the service registry nor the hash and delta
sets, with the same pins:

- class counts: 2pc 288 -> 80, 1,568 -> 166, 8,832 -> 314, and the
  increment models' (13 -> 8, 84 -> 22, 17 -> 9, 61 -> 13); the ``fin``
  race survives the reduction; BFS and DFS under the full canon agree;
- the canonicalization: equal to its host twin, idempotent, invariant over
  every block permutation, and equal to ``packed_representative`` where the
  two are promised to agree;
- every typed refusal, spec validation, the env/argument precedence, the
  checkpoint tag and ``level_log``'s ``sym``;

and adds the differentials: the port's ``compile_canon`` against
``jax.vmap`` of the reference's on 4,096 seeded rows (2pc rm=2..14, both
increment models) with the same tags; ``spawn_xla(device="cpu")`` under
symmetry equal to the reference's engine at rm=5 and rm=8 (counts, depth,
``level_log`` level by level, discoveries and their witness paths); the
``packed_representative`` path; checkpoints written under symmetry crossing
both packages; and the program cache keyed on the symmetry tag.

Everything is exact (integer work, tolerance 0)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu import sym as ref_sym
from stateright_tpu.models import increment as ref_inc
from stateright_tpu.models import increment_lock as ref_lock
from stateright_tpu.models import two_phase_commit as ref_2pc
from stateright_tpu_torch import graphs
from stateright_tpu_torch.checkpoint import validate_symmetry
from stateright_tpu_torch.core import Property
from stateright_tpu_torch.models.increment import PackedIncrement
from stateright_tpu_torch.models.increment_lock import PackedIncrementLock
from stateright_tpu_torch.models.linearizable_register import PackedAbd
from stateright_tpu_torch.models.two_phase_commit import PackedTwoPhaseSys, TwoPhaseSys
from stateright_tpu_torch.sym import (
    BlockGroup,
    SymmetrySpec,
    SymmetryUnsupported,
    canonicalize_host,
    compile_canon,
    object_canonicalizer,
)

CAPS = dict(frontier_capacity=1 << 10, table_capacity=1 << 13, device="cpu")
#: The reference engine in the port's dedup structure.
REF = dict(frontier_capacity=1 << 10, table_capacity=1 << 13, dedup="sorted")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test process: the suite runs several test
    processes on one machine, and torch's default of a thread per core in
    each oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reachable_rows(model) -> np.ndarray:
    """Every reachable packed row of the FULL (unreduced) space."""
    seen = set()
    stack = list(model.init_states())
    while stack:
        s = stack.pop()
        if s in seen:
            continue
        seen.add(s)
        stack.extend(model.next_states(s))
    return np.stack([np.asarray(model.pack(s), np.uint32) for s in seen])


def _permute_blocks(spec: SymmetrySpec, row: np.ndarray, perm) -> np.ndarray:
    """A block permutation through the spec's own lane positions: new block
    b takes old block perm[b]'s lane values (shares no code with the
    canonicalization under test)."""
    out = np.array(row, dtype=np.uint32, copy=True)
    for g in spec.groups:
        for lane in g.lanes:
            mask = (1 << lane.bits) - 1
            vals = [(int(row[w]) >> s) & mask for (w, s) in lane.positions]
            for new_b, (w, s) in enumerate(lane.positions):
                out[w] = np.uint32((int(out[w]) & ~(mask << s)) | (vals[perm[new_b]] << s))
    return out


def _canon_rows(spec: SymmetrySpec, rows: np.ndarray) -> np.ndarray:
    """The port's device canonicalization of host uint32 rows, on the CPU."""
    planes = torch.from_numpy(rows.astype(np.int64)).T
    return compile_canon(spec)(planes).T.numpy().astype(np.uint32)


def _levels(c):
    return [(r["depth"], r["frontier"], r["generated"], r["unique"], r["sym"]) for r in c.level_log]


# --- the smoke drill ----------------------------------------------------------


def test_smoke_symmetry():
    """Forced on: 288 -> 80 classes, equal to the host object-state oracle,
    with the reference's spec tag in ``metrics()``; off stays full-space."""
    m = PackedTwoPhaseSys(3)
    dev = m.checker().spawn_xla(symmetry="on", **CAPS).join()
    assert dev.unique_state_count() == 80
    dev.assert_properties()
    tag = dev.metrics()["symmetry"]
    assert tag == f"spec:{m.symmetry_spec.spec_hash()[:12]}"
    assert tag == f"spec:{ref_2pc.PackedTwoPhaseSys(3).symmetry_spec.spec_hash()[:12]}"

    host = TwoPhaseSys(3).checker().symmetry_fn(object_canonicalizer(m)).spawn_bfs().join()
    assert host.unique_state_count() == 80
    host.assert_properties()

    off = m.checker().spawn_xla(**CAPS).join()
    assert off.unique_state_count() == 288
    assert off.metrics()["symmetry"] is None


# --- count pins (class counts do not depend on the traversal) ------------------


def test_device_2pc_rm4_class_count():
    c = PackedTwoPhaseSys(4).checker().symmetry().spawn_xla(
        device="cpu", frontier_capacity=1 << 11, table_capacity=1 << 13).join()
    assert c.unique_state_count() == 166
    c.assert_properties()


class _FullSpace:
    """An unreachable ``sometimes`` in place of the always-properties, so the
    search exhausts the space (``fin``'s race would end it early)."""

    def properties(self):
        return [Property.sometimes("unreachable", lambda _m, _s: False)]

    def packed_properties(self, words):
        return torch.zeros((words.shape[0], 1), dtype=torch.bool, device=words.device)


class _IncrementFull(_FullSpace, PackedIncrement):
    pass


class _IncrementLockFull(_FullSpace, PackedIncrementLock):
    pass


@pytest.mark.parametrize(
    "model_cls,n,full,reduced",
    [
        (_IncrementFull, 2, 13, 8),
        (_IncrementFull, 3, 84, 22),
        (_IncrementLockFull, 2, 17, 9),
        (_IncrementLockFull, 3, 61, 13),
    ],
)
def test_device_increment_class_counts(model_cls, n, full, reduced):
    caps = dict(frontier_capacity=1 << 8, table_capacity=1 << 10, device="cpu")
    off = model_cls(n).checker().spawn_xla(**caps).join()
    assert off.unique_state_count() == full
    on = model_cls(n).checker().symmetry().spawn_xla(**caps).join()
    assert on.unique_state_count() == reduced
    # Without the spec, through packed_representative: the same classes.
    bare = model_cls(n)
    del bare.symmetry_spec
    rep = bare.checker().symmetry().spawn_xla(**caps).join()
    assert rep.metrics()["symmetry"] == "model:packed_representative"
    assert rep.unique_state_count() == reduced


def test_increment_race_survives_reduction():
    """The ``fin`` race (increment.rs:63-71) must still surface from the
    reduced space."""
    caps = dict(frontier_capacity=1 << 8, table_capacity=1 << 10, device="cpu")
    on = PackedIncrement(2).checker().symmetry().spawn_xla(**caps).join()
    assert "fin" in on.discoveries()
    final = on.discoveries()["fin"].last_state()
    assert sum(1 for _t, pc in final.s if pc == 3) != final.i
    on.assert_discovery("fin", on.discoveries()["fin"].into_actions())


def test_host_full_canon_is_traversal_invariant():
    canon = object_canonicalizer(PackedTwoPhaseSys(4))
    bfs = TwoPhaseSys(4).checker().symmetry_fn(canon).spawn_bfs().join()
    dfs = TwoPhaseSys(4).checker().symmetry_fn(canon).spawn_dfs().join()
    assert bfs.unique_state_count() == dfs.unique_state_count() == 166


def test_host_full_canon_rm5_matches_device():
    """The rm=5 host oracle of the device's 314; the reference's partial
    canon (the object ``representative()``) depends on the traversal: its
    DFS lands on 665 (2pc.rs:170), its BFS elsewhere."""
    m = PackedTwoPhaseSys(5)
    full_dfs = TwoPhaseSys(5).checker().symmetry_fn(object_canonicalizer(m)).spawn_dfs().join()
    assert full_dfs.unique_state_count() == 314
    partial_dfs = TwoPhaseSys(5).checker().symmetry().spawn_dfs().join()
    assert partial_dfs.unique_state_count() == 665
    partial_bfs = TwoPhaseSys(5).checker().symmetry().spawn_bfs().join()
    assert partial_bfs.unique_state_count() != 665
    assert partial_bfs.unique_state_count() >= 314


def test_device_matches_host_oracle_discoveries():
    m = PackedTwoPhaseSys(3)
    dev = m.checker().symmetry().spawn_xla(**CAPS).join()
    host = TwoPhaseSys(3).checker().symmetry_fn(object_canonicalizer(m)).spawn_bfs().join()
    assert dev.unique_state_count() == host.unique_state_count() == 80
    assert set(dev.discoveries()) == set(host.discoveries())
    for name, path in dev.discoveries().items():
        dev.assert_discovery(name, path.into_actions())


# --- the canonicalization ------------------------------------------------------


def test_kernel_matches_host_twin_and_is_idempotent():
    m = PackedTwoPhaseSys(3)
    rows = _reachable_rows(m)
    dev = _canon_rows(m.symmetry_spec, rows)
    host = np.stack([canonicalize_host(m.symmetry_spec, r) for r in rows])
    np.testing.assert_array_equal(dev, host)
    host2 = np.stack([canonicalize_host(m.symmetry_spec, r) for r in host])
    np.testing.assert_array_equal(host2, host)
    np.testing.assert_array_equal(_canon_rows(m.symmetry_spec, dev), dev)


@pytest.mark.parametrize(
    "model", [PackedTwoPhaseSys(3), PackedIncrement(3), PackedIncrementLock(3)],
    ids=["2pc3", "increment3", "increment_lock3"],
)
def test_canon_is_class_invariant(model):
    """Every block permutation of every reachable state canonicalizes to the
    same representative, through the host twin and the device form."""
    spec = model.symmetry_spec
    rows = _reachable_rows(model)
    base = np.stack([canonicalize_host(spec, r) for r in rows])
    for perm in itertools.permutations(range(spec.groups[0].count)):
        permuted = np.stack([_permute_blocks(spec, r, perm) for r in rows])
        canon = np.stack([canonicalize_host(spec, r) for r in permuted])
        np.testing.assert_array_equal(canon, base)
        np.testing.assert_array_equal(_canon_rows(spec, permuted), base)


@pytest.mark.parametrize("model", [PackedIncrement(3), PackedIncrementLock(3)],
                         ids=["increment3", "increment_lock3"])
def test_spec_kernel_equals_packed_representative(model):
    rows = _reachable_rows(model)
    hand = model.packed_representative(torch.from_numpy(rows.astype(np.int64)))
    np.testing.assert_array_equal(_canon_rows(model.symmetry_spec, rows),
                                  hand.numpy().astype(np.uint32))


_SPEC_MODELS = [(f"2pc{rm}", ref_2pc.PackedTwoPhaseSys, PackedTwoPhaseSys, rm)
                for rm in range(2, 15)] + [
    ("increment3", ref_inc.PackedIncrement, PackedIncrement, 3),
    ("increment_lock3", ref_lock.PackedIncrementLock, PackedIncrementLock, 3),
]


@pytest.mark.parametrize("ref_cls,port_cls,n", [m[1:] for m in _SPEC_MODELS],
                         ids=[m[0] for m in _SPEC_MODELS])
def test_canon_equals_the_references_on_seeded_rows(ref_cls, port_cls, n):
    """``compile_canon`` on 4,096 seeded rows of random words, bitwise
    against ``jax.vmap`` of the reference's, with the reference's tag."""
    ref_spec, spec = ref_cls(n).symmetry_spec, port_cls(n).symmetry_spec
    assert spec.spec_hash() == ref_spec.spec_hash()
    assert spec.canonical_repr() == ref_spec.canonical_repr()
    rng = np.random.default_rng(1000 + n)
    rows = rng.integers(0, 2**32, size=(4096, port_cls(n).state_words), dtype=np.uint64)
    rows = rows.astype(np.uint32)
    want = np.asarray(jax.vmap(ref_sym.compile_canon(ref_spec))(jnp.asarray(rows)))
    np.testing.assert_array_equal(_canon_rows(spec, rows), want)


def test_packed_representative_equals_the_references():
    """2pc's partial canon (rm_state sort only) on seeded rows, and the
    increment models' on their reachable rows, against ``jax.vmap`` of the
    reference's."""
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 2**32, size=(4096, 2), dtype=np.uint64).astype(np.uint32)
    cases = [(PackedTwoPhaseSys(5), ref_2pc.PackedTwoPhaseSys(5), rows)]
    for port_cls, ref_cls in ((PackedIncrement, ref_inc.PackedIncrement),
                              (PackedIncrementLock, ref_lock.PackedIncrementLock)):
        cases.append((port_cls(3), ref_cls(3), _reachable_rows(port_cls(3))))
    for port, ref, r in cases:
        got = port.packed_representative(torch.from_numpy(r.astype(np.int64)))
        want = np.asarray(jax.vmap(ref.packed_representative)(jnp.asarray(r)))
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_canon_splits_a_group_wider_than_one_key():
    """A group of three 32-bit lanes (96 bits) takes two sort keys, sorted
    least significant first; the result is still the host twin's."""
    lanes = tuple(
        SymmetrySpec.lane(name, 32, positions=[(3 * b + i, 0) for b in range(4)])
        for i, name in enumerate("abc")
    )
    spec = SymmetrySpec([BlockGroup("wide", 4, lanes)])
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 4, size=(512, 12), dtype=np.uint64).astype(np.uint32)
    rows[:, 1::3] = rng.integers(0, 2**32, size=(512, 4), dtype=np.uint64)
    host = np.stack([canonicalize_host(spec, r) for r in rows])
    np.testing.assert_array_equal(_canon_rows(spec, rows), host)


# --- the engine against the reference's ----------------------------------------


@pytest.mark.parametrize("rm,pins", [(5, (2_048, 314, 17)), (8, (15_287, 1_461, 26))])
def test_spawn_xla_equals_the_references(rm, pins):
    port = PackedTwoPhaseSys(rm).checker().symmetry().spawn_xla(device="cpu").join()
    ref = ref_2pc.PackedTwoPhaseSys(rm).checker().symmetry().spawn_xla(dedup="sorted").join()
    assert (port.state_count(), port.unique_state_count(), port.max_depth()) == pins
    assert (ref.state_count(), ref.unique_state_count(), ref.max_depth()) == pins
    assert _levels(port) == _levels(ref)
    assert port.metrics()["symmetry"] == ref.metrics()["symmetry"]
    dp, dr = port.discoveries(), ref.discoveries()
    assert sorted(dp) == sorted(dr) == ["abort agreement", "commit agreement"]
    for name in dr:
        assert dp[name].into_actions() == dr[name].into_actions()
        port.assert_discovery(name, dp[name].into_actions())


def test_packed_representative_path_equals_the_references():
    """With the spec taken away, both engines reduce through 2pc's partial
    canon: the same traversal-dependent count, level by level."""
    port_m, ref_m = PackedTwoPhaseSys(5), ref_2pc.PackedTwoPhaseSys(5)
    del port_m.symmetry_spec, ref_m.symmetry_spec
    port = port_m.checker().symmetry().spawn_xla(**CAPS).join()
    ref = ref_m.checker().symmetry().spawn_xla(**REF).join()
    assert port.metrics()["symmetry"] == ref.metrics()["symmetry"] == "model:packed_representative"
    assert (port.state_count(), port.unique_state_count()) == (
        ref.state_count(), ref.unique_state_count())
    assert _levels(port) == _levels(ref)
    for name, path in port.discoveries().items():
        port.assert_discovery(name, path.into_actions())


def test_one_model_instance_keeps_symmetric_and_plain_programs_apart():
    """Symmetric, plain and symmetric again on one model instance: each
    exact, and the third makes no program (the cache key holds the tag)."""
    m = PackedTwoPhaseSys(5)
    cache = graphs.cache_for(m, torch.device("cpu"))
    first = m.checker().symmetry().spawn_xla(device="cpu").join()
    sym_keys = set(cache.programs)
    plain = m.checker().spawn_xla(device="cpu").join()
    again = m.checker().symmetry().spawn_xla(device="cpu").join()
    for c, want in ((first, (2_048, 314)), (plain, (58_146, 8_832)), (again, (2_048, 314))):
        assert (c.state_count(), c.unique_state_count()) == want
    tag = first.metrics()["symmetry"]
    assert {k[-1] for k in sym_keys} == {tag}
    assert {k[-1] for k in cache.programs} == {tag, None}
    assert {k for k in cache.programs if k[-1] == tag} == sym_keys
    assert _levels(again) == _levels(first)


def test_a_table_growth_drops_every_tags_programs_on_the_old_carry():
    """The old capacity's carry and every program on it go, of either tag
    (their memory is handed back before the grown programs are made);
    programs on another carry stay."""
    cache = graphs.ProgramCache(torch.device("cpu"))
    carry = cache.carry(2, 3, 64, 32)
    other = cache.carry(2, 3, 64, 1)
    for tag in ("spec:a", None):
        cache.make((64, 64, 256, 64, 32, 0, "sorted", 32, tag), carry, lambda: None, graph=False)
    cache.make((64, 64, 256, 64, 1, 0, "sorted", 32, None), other, lambda: None, graph=False)
    cache.drop((64, 32, 0, "sorted"))
    assert list(cache.programs) == [(64, 64, 256, 64, 1, 0, "sorted", 32, None)]
    assert list(cache.carries) == [(64, 1, 0, "sorted")]


def test_a_plain_table_growth_leaves_the_symmetric_check_exact():
    """A plain check that grows the table on a model instance that ran a
    symmetric one: the symmetric programs at the old capacity are dropped,
    and the next symmetric check makes them anew, exact."""
    m = PackedTwoPhaseSys(3)
    kw = dict(device="cpu", table_capacity=1 << 6, frontier_capacity=1 << 6)
    first = m.checker().symmetry().spawn_xla(**kw).join()
    plain = m.checker().spawn_xla(**kw).join()
    again = m.checker().symmetry().spawn_xla(**kw).join()
    assert plain.metrics()["table_grows"] > 0
    assert (plain.state_count(), plain.unique_state_count()) == (1_146, 288)
    for c in (first, again):
        assert (c.state_count(), c.unique_state_count()) == (318, 80)
    assert _levels(again) == _levels(first)


def test_a_table_growth_under_symmetry_stays_exact():
    c = PackedTwoPhaseSys(5).checker().symmetry().spawn_xla(
        device="cpu", table_capacity=1 << 6, frontier_capacity=1 << 6).join()
    assert (c.state_count(), c.unique_state_count()) == (2_048, 314)
    assert c.metrics()["table_grows"] > 0


# --- typed refusals --------------------------------------------------------------


def test_forced_on_without_capability_refuses():
    with pytest.raises(SymmetryUnsupported) as ei:
        PackedAbd(2, 2).checker().spawn_xla(symmetry="on", **CAPS)
    assert ei.value.engine == "xla"
    assert "neither" in ei.value.reason


def test_bad_symmetry_spec_type_refuses():
    class Broken(PackedTwoPhaseSys):
        def __init__(self):
            super().__init__(3)
            self.symmetry_spec = "not-a-spec"

    with pytest.raises(SymmetryUnsupported, match="expected SymmetrySpec"):
        Broken().checker().spawn_xla(symmetry="on", **CAPS)


def test_spec_beyond_state_words_refuses():
    class Widened(PackedTwoPhaseSys):
        def __init__(self):
            super().__init__(3)
            w = self.state_words
            self.symmetry_spec = SymmetrySpec([
                BlockGroup("ghost", 2, (SymmetrySpec.lane("ghost", 2, positions=[(w, 0), (w, 2)]),))
            ])

    with pytest.raises(SymmetryUnsupported, match="state_words"):
        Widened().checker().spawn_xla(symmetry="on", **CAPS)


def test_hv_properties_refuse_symmetry():
    class HvTwoPhase(PackedTwoPhaseSys):
        def __init__(self, rm):
            super().__init__(rm)
            self.host_verified_properties = frozenset({"commit agreement"})

    with pytest.raises(SymmetryUnsupported, match="host-verified"):
        HvTwoPhase(3).checker().symmetry().spawn_xla(**CAPS)


def test_object_canonicalizer_requires_spec():
    with pytest.raises(SymmetryUnsupported):
        object_canonicalizer(PackedAbd(2, 2))


# --- spec validation and identity ------------------------------------------------


def _group(*lanes, count=2, name="g"):
    return SymmetrySpec([BlockGroup(name, count, tuple(lanes))])


def test_spec_validation_errors():
    lane = SymmetrySpec.lane
    with pytest.raises(ValueError, match="overlap"):
        _group(lane("a", 2, positions=[(0, 0), (0, 2)]), lane("b", 2, positions=[(0, 1), (0, 3)]))
    with pytest.raises(ValueError, match="bits"):
        _group(lane("a", 0, positions=[(0, 0), (0, 1)]))
    with pytest.raises(ValueError, match="bits"):
        _group(lane("a", 33, positions=[(0, 0), (1, 0)]))
    with pytest.raises(ValueError, match="positions"):
        _group(lane("a", 1, positions=[(0, 0), (0, 1), (0, 2)]))
    with pytest.raises(ValueError, match="fit"):
        _group(lane("a", 4, positions=[(0, 30), (0, 0)]))
    with pytest.raises(ValueError, match="count"):
        _group(lane("a", 1, positions=[(0, 0)]), count=1)
    with pytest.raises(ValueError, match="no lanes"):
        _group(count=2)
    with pytest.raises(ValueError, match="at least one"):
        SymmetrySpec([])
    with pytest.raises(ValueError, match="positions= or word="):
        lane("a", 1)


def test_spec_hash_is_layout_sensitive():
    lane = SymmetrySpec.lane
    a = _group(lane("t", 2, positions=[(0, 0), (0, 2)]))
    b = _group(lane("t", 2, positions=[(0, 0), (0, 4)]))
    assert a.spec_hash() != b.spec_hash()
    assert a.spec_hash() == _group(lane("t", 2, positions=[(0, 0), (0, 2)])).spec_hash()
    ref_a = ref_sym.SymmetrySpec([ref_sym.BlockGroup(
        "g", 2, (ref_sym.SymmetrySpec.lane("t", 2, positions=[(0, 0), (0, 2)]),))])
    assert a.spec_hash() == ref_a.spec_hash()


# --- mode resolution (spawn argument against STPU_SYMMETRY) ----------------------


def test_env_forces_on(monkeypatch):
    monkeypatch.setenv("STPU_SYMMETRY", "1")
    c = PackedTwoPhaseSys(3).checker().spawn_xla(**CAPS).join()
    assert c.unique_state_count() == 80


def test_env_off_beats_builder(monkeypatch):
    monkeypatch.setenv("STPU_SYMMETRY", "off")
    c = PackedTwoPhaseSys(3).checker().symmetry().spawn_xla(**CAPS).join()
    assert c.unique_state_count() == 288
    assert c.metrics()["symmetry"] is None


def test_arg_beats_env(monkeypatch):
    monkeypatch.setenv("STPU_SYMMETRY", "1")
    c = PackedTwoPhaseSys(3).checker().spawn_xla(symmetry="off", **CAPS).join()
    assert c.unique_state_count() == 288


def test_invalid_mode_raises():
    with pytest.raises(ValueError, match="auto/on/off"):
        PackedTwoPhaseSys(3).checker().spawn_xla(symmetry="sideways", **CAPS)


# --- checkpoint identity ----------------------------------------------------------


def test_checkpoint_symmetry_mismatch_refuses(tmp_path):
    path = str(tmp_path / "ck.npz")
    partial = PackedTwoPhaseSys(3).checker().spawn_xla(symmetry="on", **CAPS)
    partial._run_block()
    partial.save_checkpoint(path)
    with pytest.raises(ValueError, match="symmetry"):
        PackedTwoPhaseSys(3).checker().spawn_xla(checkpoint=path, **CAPS)
    resumed = PackedTwoPhaseSys(3).checker().spawn_xla(symmetry="on", checkpoint=path, **CAPS).join()
    assert resumed.unique_state_count() == 80
    resumed.assert_properties()


def test_old_checkpoints_without_sym_key_still_load():
    validate_symmetry({}, None)
    validate_symmetry({}, "spec:abc")
    validate_symmetry({"symmetry": None}, None)
    with pytest.raises(ValueError):
        validate_symmetry({"symmetry": "spec:a"}, "spec:b")
    with pytest.raises(ValueError):
        validate_symmetry({"symmetry": "spec:a"}, None)


def test_checkpoints_under_symmetry_cross_both_packages(tmp_path):
    """rm=8 saved under symmetry after 9 levels by each package resumes in
    the other to the pins, the file carrying the reference's tag; without
    symmetry neither side resumes it."""
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    ref = ref_2pc.PackedTwoPhaseSys(8).checker().symmetry().spawn_xla(
        levels_per_dispatch=1, **REF)
    port = PackedTwoPhaseSys(8).checker().symmetry().spawn_xla(levels_per_dispatch=1, **CAPS)
    for _ in range(9):
        ref._run_block()
        port._run_block()
    ref.save_checkpoint(ref_path)
    port.save_checkpoint(port_path)
    from stateright_tpu_torch.checkpoint import load_checkpoint

    assert load_checkpoint(port_path)["meta"]["symmetry"] == "spec:7e95d6c76225"
    in_port = PackedTwoPhaseSys(8).checker().symmetry().spawn_xla(checkpoint=ref_path, **CAPS).join()
    in_ref = ref_2pc.PackedTwoPhaseSys(8).checker().symmetry().spawn_xla(
        checkpoint=port_path, **REF).join()
    for c in (in_port, in_ref):
        assert (c.state_count(), c.unique_state_count(), c.max_depth()) == (15_287, 1_461, 26)
    assert _levels(in_port) == _levels(in_ref)
    with pytest.raises(ValueError, match="symmetry"):
        PackedTwoPhaseSys(8).checker().spawn_xla(checkpoint=ref_path, **CAPS)
    with pytest.raises(ValueError, match="symmetry"):
        ref_2pc.PackedTwoPhaseSys(8).checker().spawn_xla(checkpoint=port_path, **REF)


def test_level_log_carries_sym_tag():
    c = PackedTwoPhaseSys(3).checker().symmetry().spawn_xla(**CAPS).join()
    tag = c.metrics()["symmetry"]
    assert tag and tag.startswith("spec:")
    assert c.level_log
    assert all(row["sym"] == tag for row in c.level_log)
    one = PackedTwoPhaseSys(3).checker().symmetry().spawn_xla(levels_per_dispatch=1, **CAPS).join()
    assert all(row["sym"] == tag for row in one.level_log)
    off = PackedTwoPhaseSys(3).checker().spawn_xla(**CAPS).join()
    assert all(row["sym"] is None for row in off.level_log)
