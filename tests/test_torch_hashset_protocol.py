"""The hash set's insert protocol (``stateright_tpu_torch/csrc/hashset.cu``)
on the CPU, where no card runs the kernel:

- a numpy model of the kernel steps each lane's actions on the shared
  slot words (a 16-byte read of key and ticket, the 16-byte
  compare-and-swap, the ticket's ``atomicMin``; then the commit of each
  filled slot and its window check; then the exact path where the flag is
  raised) in seeded random interleavings, on a few hundred lanes and a
  64-slot table. ``is_new`` and ``overflow`` equal :func:`insert_plain`'s
  bit for bit and the stored (key, value) pairs equal it as a set, on the
  adversarial batches ``chip_smoke.py`` holds the kernel to on the card and
  on seeded mixes of hits, duplicates and new keys; where the exact path
  runs, the slots equal it bit for bit; the tickets are back at rest and
  the model's record undoes the insert bit for bit;
- the record's form (``filled``, int32 ``[m + 2]``) from the plain version,
  and the plain ``undo_`` restoring the slots bit for bit;
- 2pc rm=4 under ``dedup="hash"``: the port's ``key_hi``/``key_lo``/
  ``val_hi``/``val_lo`` and a checkpoint's payload equal the JAX
  package's.

Everything is exact (tolerance 0: integer work)."""

import numpy as np
import pytest
import torch

from stateright_tpu.models import two_phase_commit as ref_2pc
from stateright_tpu_torch.checkpoint import PAYLOAD_KEYS, load_checkpoint
from stateright_tpu_torch.models import two_phase_commit as port_2pc
from stateright_tpu_torch.ops import hashset
from stateright_tpu_torch.ops.words import DTYPE

C = 64
MASK = C - 1
REST = hashset.NO_TICKET
GOLDEN = hashset.GOLDEN


def _home(key: int) -> int:
    return ((key >> 32) ^ ((key & 0xFFFFFFFF) * GOLDEN & 0xFFFFFFFF)) & MASK


def _claim_lane(slots, i, key, max_probes, record):
    """One lane of the claim pass, a generator that yields before each
    action on shared memory; returns whether the lane resolved."""
    s = _home(key)
    for _ in range(max_probes):
        yield
        c = (int(slots[s, 0]), int(slots[s, 1]))  # one 16-byte read
        if c[0] == 0:
            yield
            c = (int(slots[s, 0]), int(slots[s, 1]))  # the compare-and-swap
            if c == (0, REST):
                slots[s, 0], slots[s, 1] = key, i
                record.append(s)
                return True
        if c[0] == key:
            if c[1] != REST and c[1] > i:
                yield
                slots[s, 1] = min(int(slots[s, 1]), i)  # atomicMin
            return True
        s = (s + 1) & MASK
    return False


def _commit_entry(slots, s, vals, max_probes, is_new):
    """One filled slot of the commit pass; returns whether its winner's
    window is occupied from end to end."""
    yield
    key, i = int(slots[s, 0]), int(slots[s, 1])
    is_new[i] = True
    slots[s, 2] = vals[i]
    slots[s, 1] = REST
    before = (s - _home(key)) & MASK
    at = (s + 1) & MASK
    for _ in range(before + 1, max_probes):
        yield
        if slots[at, 0] == 0:
            return False
        at = (at + 1) & MASK
    return True


def _interleave(rng, gens) -> list:
    """Runs the generators one action at a time, the next chosen at
    random; returns their results in the generators' order."""
    out = [None] * len(gens)
    live = list(range(len(gens)))
    for g in gens:
        next(g, None)
    while live:
        j = int(rng.integers(len(live)))
        try:
            next(gens[live[j]])
        except StopIteration as stop:
            out[live[j]] = stop.value
            live.pop(j)
    return out


def _model_insert(slots, keys, vals, active, max_probes, rng):
    """The kernel's insert into the ``[C, 4]`` slot words, in place:
    ``(is_new, overflow, record)``."""
    m = len(keys)
    is_new, overflow, record = np.zeros(m, bool), np.zeros(m, bool), []
    lanes = [i for i in range(m) if active[i]]
    done = _interleave(rng, [_claim_lane(slots, i, int(keys[i]), max_probes, record) for i in lanes])
    flag = not all(done)
    full = _interleave(rng, [_commit_entry(slots, s, vals, max_probes, is_new) for s in record])
    if flag or any(full):
        # The exact path: the record's slots cleared, the reference's rounds.
        for s in record:
            slots[s] = hashset.EMPTY_SLOT
        hs = hashset.HashSet(torch.from_numpy(slots))
        t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int64))
        is_new, overflow, filled = hashset.insert_plain(
            hs, t(keys) >> 32, t(keys) & 0xFFFFFFFF, t(vals) >> 32, t(vals) & 0xFFFFFFFF,
            torch.from_numpy(active), max_probes)
        is_new, overflow = is_new.numpy(), overflow.numpy()
        record = filled[2:2 + int(filled[0])].tolist()
    return is_new, overflow, record, flag or any(full)


def _table(seed: int, n_keys: int):
    """A 64-slot hash set holding ``n_keys`` seeded keys, and its keys."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(np.arange(1, 2**40, 2**21 + 7), n_keys, replace=False).astype(np.int64)
    hs = hashset.make(C, "cpu")
    _insert_plain(hs, keys, keys * 3 + 1, np.ones(n_keys, bool), 32)
    return hs, keys


def _insert_plain(hs, keys, vals, active, max_probes):
    t = torch.from_numpy
    keys, vals = np.asarray(keys, np.int64), np.asarray(vals, np.int64)
    return hashset.insert_plain(hs, t(keys >> 32), t(keys & 0xFFFFFFFF), t(vals >> 32),
                                t(vals & 0xFFFFFFFF), t(np.asarray(active, bool)), max_probes)


def _pairs(slots):
    occ = slots[:, 0] != 0
    return sorted(zip(slots[occ, 0].tolist(), slots[occ, 2].tolist()))


def _mix(seed, m, table_keys, hit=0.35):
    """``m`` lanes: a share ``hit`` of table keys, the rest new keys each
    drawn about five times, some lanes inactive."""
    rng = np.random.default_rng(seed)
    fresh = rng.integers(1, 2**62, max(1, m // 8), dtype=np.int64)
    keys = np.where(rng.random(m) < hit, rng.choice(table_keys, m), rng.choice(fresh, m))
    return keys, rng.integers(0, 2**62, m, dtype=np.int64), rng.random(m) < 0.85


def _case(name):
    """The batch of a case: ``(table, keys, values, active, max_probes,
    layout)``; ``layout`` where the slots must equal the plain version's bit
    for bit (the exact path runs)."""
    hs, base = _table(11, 8)
    ones = lambda n: np.ones(n, bool)
    vals = lambda n: np.arange(n, dtype=np.int64) * 7 + 3
    j = np.arange(300, dtype=np.int64)
    if name == "one_key":
        return hs, np.full(300, 0x123456789, np.int64), vals(300), ones(300), 32, False
    if name == "one_home_slot":  # lo = 0: a key's home is hi mod C
        return hashset.make(C, "cpu"), ((j[:100] << 6) | 5) << 32, vals(100), ones(100), 32, True
    if name == "claim_index":  # 4 lanes: a 16-index claim buffer, slots 5, 21, 37, 53
        return hashset.make(C, "cpu"), (j[:4] * 16 + 5) << 32, vals(4), ones(4), 32, False
    if name == "all_present":
        return hs, np.resize(base, 200), vals(200), ones(200), 32, False
    if name == "one_row":
        return hs, np.array([0x2468ACE], np.int64), vals(1), ones(1), 32, False
    if name == "no_active_row":
        return hs, np.resize(base, 50), vals(50), np.zeros(50, bool), 32, False
    if name == "mix":
        return (hs, *_mix(5, 200, base), 32, False)
    if name == "mix_two_probes":  # windows fill: the flag and the exact path
        return (hs, *_mix(6, 200, base), 2, True)
    raise KeyError(name)


CASES = ("one_key", "one_home_slot", "claim_index", "all_present", "one_row", "no_active_row",
         "mix", "mix_two_probes")


@pytest.mark.parametrize("name", CASES)
def test_the_kernels_protocol_equals_the_plain_insert_in_any_interleaving(name):
    table, keys, vals, active, probes, layout = _case(name)
    want = hashset.HashSet(table.slots.clone())
    w_new, w_ovf, _ = _insert_plain(want, keys, vals, active, probes)
    exact_runs = set()
    for seed in range(4):
        slots = table.slots.numpy().copy()
        is_new, overflow, record, exact = _model_insert(
            slots, keys, vals, active, probes, np.random.default_rng(seed))
        exact_runs.add(exact)
        np.testing.assert_array_equal(is_new, w_new.numpy())
        np.testing.assert_array_equal(overflow, w_ovf.numpy())
        if not w_ovf.any():
            assert _pairs(slots) == _pairs(want.slots.numpy())
        if layout:
            np.testing.assert_array_equal(slots, want.slots.numpy())
        assert (slots[:, 1] == REST).all() and (slots[:, 3] == 0).all()
        assert sorted(record) == sorted(set(record)) and len(record) == int(is_new.sum())
        for s in record:
            slots[s] = hashset.EMPTY_SLOT
        np.testing.assert_array_equal(slots, table.slots.numpy())
    # Whether a window fills does not depend on the interleaving: the
    # batch fills the same slots in any order.
    assert len(exact_runs) == 1
    if name in ("one_home_slot", "mix_two_probes"):
        assert exact_runs == {True}
    elif name != "mix":
        assert exact_runs == {False}


def test_the_record_is_int32_and_undo_restores_the_slots_bit_for_bit():
    hs, base = _table(3, 10)
    before = hs.slots.clone()
    keys, vals, active = _mix(4, 120, base)
    is_new, _, filled = _insert_plain(hs, keys, vals, active, 32)
    n = int(is_new.sum())
    assert filled.dtype == torch.int32 and filled.shape == (120 + 2,)
    assert int(filled[0]) == n > 0 and int(filled[1]) == 0
    # The plain version lists the winners' slots in batch order.
    where = {k: s for s, k in enumerate(hs.key.tolist()) if k}
    assert filled[2:2 + n].tolist() == [where[int(keys[i])] for i in np.flatnonzero(is_new.numpy())]
    assert hs.slots.dtype == DTYPE and hs.slots.shape == (C, hashset.WORDS)
    hashset.undo_(hs, filled, torch.tensor(True))
    assert not torch.equal(hs.slots, before)
    hashset.undo_(hs, filled, torch.tensor(False))
    assert torch.equal(hs.slots, before)


def test_2pc_rm4_hash_planes_and_payload_equal_the_reference(tmp_path):
    port = port_2pc.PackedTwoPhaseSys(4).checker().spawn_xla(device="cpu", dedup="hash").join()
    ref = ref_2pc.PackedTwoPhaseSys(4).checker().spawn_xla(dedup="hash").join()
    assert port.unique_state_count() == ref.unique_state_count() == 1_568
    for name in ("key_hi", "key_lo", "val_hi", "val_lo"):
        np.testing.assert_array_equal(np.asarray(getattr(ref._table, name)),
                                      getattr(port._table, name).numpy(), err_msg=name)
    port.save_checkpoint(str(tmp_path / "port.npz"))
    ref.save_checkpoint(str(tmp_path / "ref.npz"))
    a, b = load_checkpoint(str(tmp_path / "ref.npz")), load_checkpoint(str(tmp_path / "port.npz"))
    for key in PAYLOAD_KEYS:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
