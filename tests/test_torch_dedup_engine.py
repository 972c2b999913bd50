"""``spawn_xla(dedup="hash" | "delta")`` of the port against the reference
package's engine under the same structure, on the CPU, and checkpoints
across structures and packages:

- 2pc rm=3 and rm=4, ``PackedIncrement(3)`` under symmetry and a run
  whose 256-row delta tier flushes again and again (the reference's
  ``tests/test_deltaset.py:198-217`` configuration, one candidate rung on
  both sides): counts, depth, ``level_log`` level by level, discovery names
  and path lengths, and ``metrics()["dedup"]``;
- the one difference of the port's overflow protocol, in the flushing run:
  a block that ends on a delta overflow right after its boundary flush
  retries before it grows, where the reference grows at once;
- a file written under each structure resumes under each other (rm=3);
  the reference's hash and delta files resume in the port, and the port's
  in the reference; on the CPU a hash file's payload is the reference's
  byte for byte (the plain insert's slot layout is the reference's).

Everything is exact."""

import numpy as np
import pytest
import torch

from stateright_tpu.models import two_phase_commit as ref_2pc
from stateright_tpu.models.increment import PackedIncrement as RefIncrement
from stateright_tpu import xla as ref_xla
from stateright_tpu.ops import deltaset as ref_ds
from stateright_tpu_torch import xla as port_xla
from stateright_tpu_torch.audit import audit_table
from stateright_tpu_torch.checkpoint import PAYLOAD_KEYS, load_checkpoint
from stateright_tpu_torch.models import two_phase_commit as port_2pc
from stateright_tpu_torch.models.increment import PackedIncrement
from stateright_tpu_torch.ops import deltaset

CPU = dict(device="cpu")
LEVEL_KEYS = ("depth", "frontier", "generated", "unique")
STRUCTURES = ("sorted", "hash", "delta")


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
    return [[r[k] for k in LEVEL_KEYS] for r in c.level_log]


def _same_search(port, ref, dedup):
    assert (port.state_count(), port.unique_state_count(), port.max_depth()) == (
        ref.state_count(), ref.unique_state_count(), ref.max_depth())
    assert _levels(port) == _levels(ref)
    dp, dr = port.discoveries(), ref.discoveries()
    assert sorted(dp) == sorted(dr)
    for name, path in dp.items():
        assert len(path) == len(dr[name]), name
        port.assert_discovery(name, path.into_actions())
    assert port.metrics()["dedup"] == ref.metrics()["dedup"] == dedup
    assert audit_table(port)["ok"]


@pytest.mark.parametrize("rm", [3, 4])
@pytest.mark.parametrize("dedup", ["hash", "delta"])
def test_2pc_equals_the_reference_engine(dedup, rm):
    port = port_2pc.PackedTwoPhaseSys(rm).checker().spawn_xla(dedup=dedup, **CPU).join()
    ref = ref_2pc.PackedTwoPhaseSys(rm).checker().spawn_xla(dedup=dedup).join()
    _same_search(port, ref, dedup)


@pytest.mark.parametrize("dedup", ["hash", "delta"])
def test_increment_under_symmetry_equals_the_reference_engine(dedup):
    port = PackedIncrement(3).checker().symmetry().spawn_xla(dedup=dedup, **CPU).join()
    ref = RefIncrement(3).checker().symmetry().spawn_xla(dedup=dedup).join()
    _same_search(port, ref, dedup)
    assert port.metrics()["symmetry"] == ref.metrics()["symmetry"]


BOUNDARY = ("_grow_table_if_loaded", "_resolve_table_overflow", "_grow_table")


def _logged(fn, log):
    """``fn`` (an engine method), logging each call as ``(name, unique
    count, committed levels, delta rows, delta capacity)`` before it runs."""
    def spy(self, *args, **kwargs):
        t = self._table
        log.append((fn.__name__, self._unique_count, len(self.level_log), int(t.n_delta),
                    t.delta_capacity))
        return fn(self, *args, **kwargs)
    return spy


@pytest.fixture(scope="module")
def forced_flushes():
    """A run whose 256-row delta tier flushes again and again (the
    reference's ``tests/test_deltaset.py:198-217`` configuration, one
    candidate rung on both sides), in each engine, with every boundary
    pass, overflow resolution and growth logged (:func:`_logged`)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    logs = {"port": [], "ref": []}
    with pytest.MonkeyPatch.context() as mp:
        for mod in (ref_ds, deltaset):
            mp.setattr(mod, "DELTA_SHIFT", 6)
            mp.setattr(mod, "MIN_DELTA", 256)
        for name, cls in (("port", port_xla.XlaChecker), ("ref", ref_xla.XlaChecker)):
            for meth in BOUNDARY:
                mp.setattr(cls, meth, _logged(getattr(cls, meth), logs[name]))
        kw = dict(dedup="delta", frontier_capacity=1 << 13, table_capacity=1 << 14, cand_ladder=1)
        port = port_2pc.PackedTwoPhaseSys(5).checker().spawn_xla(**kw, **CPU).join()
        ref = ref_2pc.PackedTwoPhaseSys(5).checker().spawn_xla(**kw).join()
    torch.set_num_threads(threads)
    return port, ref, logs["port"], logs["ref"]


def test_forced_flushes_equal_the_reference_engine(forced_flushes):
    port, ref, _, _ = forced_flushes
    _same_search(port, ref, "delta")
    assert port.metrics()["delta_flushes"] > 0 and ref.metrics()["delta_flushes"] > 0


def test_a_delta_overflow_after_a_boundary_flush_retries_without_growth(forced_flushes):
    """The one place the port's overflow protocol differs from the
    reference's. A block that ends on a delta overflow after the boundary
    pass flushed a tier at least three quarters full: the reference then
    finds the tier empty and doubles the table; the port retries the level
    on the flushed table first. So the port grows once less for each retry
    that commits, and runs one more dispatch for each that overflows again
    (an empty-delta overflow, which grows in both). Flushes are the same."""
    port, ref, plog, rlog = forced_flushes
    name = lambda e: e[0]
    flushing = lambda e: name(e) == BOUNDARY[0] and e[3] * 4 > e[4] * 3
    # The blocks in question, where the reference resolved right after the
    # flushing pass, on the tier it emptied.
    hits = [e for e, f in zip(rlog, rlog[1:])
            if flushing(e) and name(f) == BOUNDARY[1] and f[1:3] == e[1:3] and f[3] == 0]
    assert hits
    # The port, at each of them, retried before any resolution or growth.
    after = {e: f for e, f in zip(plog, plog[1:]) if flushing(e)}
    assert all(name(f) == BOUNDARY[0] for f in after.values())
    assert all(e in after for e in hits)
    saved = [e for e in hits if after[e][2] > e[2]]  # the retry committed
    again = [e for e in hits if after[e][2] == e[2]]  # it overflowed again
    assert saved and again
    mp, mr = port.metrics(), ref.metrics()
    print({k: (mp[k], mr[k]) for k in ("table_grows", "delta_flushes", "table_capacity")})
    assert mr["table_grows"] - mp["table_grows"] == len(saved)
    assert mp["delta_flushes"] == mr["delta_flushes"]
    retries = lambda c: sum(k == 0 for _, k in c.dispatch_log)
    assert retries(port) - retries(ref) == len(again)


# --- checkpoints ----------------------------------------------------------------

RM3 = (1_146, 288, 11)
SAVE = dict(table_capacity=1 << 10, frontier_capacity=1 << 8, levels_per_dispatch=1)


def _save(checker, path, levels=5):
    for _ in range(levels):
        checker._run_block()
    checker.save_checkpoint(path)
    return checker


@pytest.mark.parametrize("reader", STRUCTURES)
@pytest.mark.parametrize("writer", STRUCTURES)
def test_a_file_of_each_structure_resumes_under_each(tmp_path, writer, reader):
    path = str(tmp_path / "ck.npz")
    _save(port_2pc.PackedTwoPhaseSys(3).checker().spawn_xla(dedup=writer, **SAVE, **CPU), path)
    c = port_2pc.PackedTwoPhaseSys(3).checker().spawn_xla(dedup=reader, checkpoint=path, **CPU)
    assert c.unique_state_count() == len(load_checkpoint(path)["key_hi"])
    c.join()
    assert (c.state_count(), c.unique_state_count(), c.max_depth()) == RM3
    assert audit_table(c)["ok"]
    c.assert_properties()


@pytest.mark.parametrize("dedup", ["hash", "delta"])
def test_files_cross_between_the_packages(tmp_path, dedup):
    """The reference's file resumes in the port (under its structure and
    the sorted set), the port's in the reference; the two payloads are
    equal byte for byte."""
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    _save(ref_2pc.PackedTwoPhaseSys(3).checker().spawn_xla(dedup=dedup, **SAVE), ref_path)
    _save(port_2pc.PackedTwoPhaseSys(3).checker().spawn_xla(dedup=dedup, **SAVE, **CPU), port_path)
    a, b = load_checkpoint(ref_path), load_checkpoint(port_path)
    for key in PAYLOAD_KEYS:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for reader in (dedup, "sorted"):
        c = port_2pc.PackedTwoPhaseSys(3).checker().spawn_xla(
            dedup=reader, checkpoint=ref_path, **CPU).join()
        assert (c.state_count(), c.unique_state_count(), c.max_depth()) == RM3
    r = ref_2pc.PackedTwoPhaseSys(3).checker().spawn_xla(dedup=dedup, checkpoint=port_path).join()
    assert (r.state_count(), r.unique_state_count(), r.max_depth()) == RM3
