"""The port's visited-set audit (stateright_tpu_torch/audit.py), as the
reference's ``tests/test_audit.py`` holds its own: clean for every
structure, clean after growth (the window in which a rehash or rebuild
could lose or duplicate entries), and equal to the reference's audit of
the same search. The sharded engine's case waits for the port of
``parallel/``. A table with a key planted twice, or a key dropped, is
reported: the audit catches what it exists for."""

import pytest
import torch

from stateright_tpu.audit import audit_table as ref_audit
from stateright_tpu.models.two_phase_commit import PackedTwoPhaseSys as RefTwoPhaseSys
from stateright_tpu_torch.audit import audit_table
from stateright_tpu_torch.models.paxos import PackedPaxos
from stateright_tpu_torch.models.two_phase_commit import PackedTwoPhaseSys
from stateright_tpu_torch.ops import deltaset

CPU = dict(device="cpu")
STRUCTURES = ("hash", "sorted", "delta")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_clean(checker, expected_unique):
    report = audit_table(checker)
    assert report["ok"], report
    assert report["duplicate_keys"] == 0, report
    assert report["entries"] == expected_unique == report["unique_count"], report


@pytest.mark.parametrize("dedup", STRUCTURES)
def test_audit_clean_all_structures_single_chip(dedup):
    c = PackedTwoPhaseSys(3).checker().spawn_xla(
        frontier_capacity=1 << 8, table_capacity=1 << 10, dedup=dedup, **CPU).join()
    assert c.unique_state_count() == 288
    _assert_clean(c, 288)


@pytest.mark.parametrize("dedup", STRUCTURES)
def test_audit_clean_after_growth(monkeypatch, dedup):
    # A 16-row delta floor, or the default 1,024-row tier holds the space.
    monkeypatch.setattr(deltaset, "MIN_DELTA", 16)
    c = PackedPaxos(2, 2).checker().spawn_xla(
        frontier_capacity=1 << 8, table_capacity=1 << 7, dedup=dedup, **CPU).join()
    assert c.metrics()["table_grows"] > 0
    _assert_clean(c, c.unique_state_count())


def test_audit_equals_the_references_report():
    port = PackedTwoPhaseSys(3).checker().spawn_xla(dedup="hash", **CPU).join()
    ref = RefTwoPhaseSys(3).checker().spawn_xla(dedup="hash").join()
    assert audit_table(port) == ref_audit(ref)


@pytest.mark.parametrize("dedup", STRUCTURES)
def test_a_key_planted_twice_or_dropped_is_reported(dedup):
    """The first occupied key copied over a second occupied slot's key: one
    duplicate and one key lost; a key cleared: an entry short."""
    c = PackedTwoPhaseSys(3).checker().spawn_xla(dedup=dedup, **CPU).join()
    planes = c._table.key if dedup == "hash" else c._table.key_hi
    if dedup == "delta":
        planes = c._table.main_key_hi  # a finished run's rows are in main or delta
        if int(c._table.n_main) < 2:
            planes = c._table.delta_key_hi
    occupied = (planes != 0).nonzero().flatten()
    first, second = int(occupied[0]), int(occupied[1])
    saved = planes[second].clone()
    if dedup == "hash":
        planes[second] = planes[first]
    else:
        lo = c._table.key_lo if dedup == "sorted" else (
            c._table.main_key_lo if planes is c._table.main_key_hi else c._table.delta_key_lo)
        planes[second], lo[second] = planes[first], lo[first]
    report = audit_table(c)
    assert not report["ok"] and report["duplicate_keys"] == 1
    assert report["entries"] == report["unique_count"] == 288
    planes[second] = saved
    planes[first] = 0
    if dedup != "hash":
        lo[first] = 0
    report = audit_table(c)
    assert not report["ok"] and report["duplicate_keys"] == 0
    assert report["entries"] == 287 and report["unique_count"] == 288
