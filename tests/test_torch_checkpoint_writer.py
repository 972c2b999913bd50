"""The port's checkpoint writer (stateright_tpu_torch/checkpoint.py) against
the reference package's (stateright_tpu/checkpoint.py) on the CPU:

- payload parity: the port's save of 2pc rm=4 after k levels holds the
  same ``uint32`` payload arrays, the same ``payload_sha256`` and the same
  meta (apart from ``written_unix_ts``) as the reference's ``dedup="sorted"``
  save after the same levels;
- both resume directions: a port save resumes in the JAX engine and in the
  port to the exact counts of an uninterrupted run (2pc rm=4, and Paxos
  2c/3s at level 10 with its discovery pin carried);
- the reference's own checkpoint tests (``tests/test_checkpoint.py``) that
  need no 8-device mesh, on the port: atomic save, keep-K rotation, a torn
  or tampered file raising the typed ``CheckpointCorrupt``, the fallback of
  ``latest_valid_checkpoint``, level and seconds cadences, the environment
  knobs, a bad cadence rejected, discovery pins preserved; and the
  auto-checkpointer on the fused path, at block boundaries.

Everything is exact (integer work)."""

import json
import os

import numpy as np
import pytest
import torch

from stateright_tpu import checkpoint as ref_ck
from stateright_tpu.models import two_phase_commit as ref
from stateright_tpu.models.paxos import PackedPaxos as RefPaxos
from stateright_tpu_torch import checkpoint as ck
from stateright_tpu_torch.models import two_phase_commit as port
from stateright_tpu_torch.models.paxos import PackedPaxos

CPU = dict(device="cpu")
#: The reference engine at the port's semantics: the sorted visited set.
REF = dict(frontier_capacity=1 << 10, table_capacity=1 << 13, dedup="sorted")
FULL_RM4 = (8_258, 1_568, 14)
FULL_PAXOS2 = (32_971, 16_668)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test process: the suite runs several test
    processes on one machine, and torch's default of a thread per core in
    each oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_partial(levels: int, rm: int = 4, **kw):
    c = port.PackedTwoPhaseSys(rm).checker().spawn_xla(levels_per_dispatch=1, **CPU, **kw)
    for _ in range(levels):
        c._run_block()
    return c


def _final(c):
    return c.state_count(), c.unique_state_count(), c.max_depth()


@pytest.mark.parametrize("levels", [1, 4, 9])
def test_payload_equals_the_references(tmp_path, levels):
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    _port_partial(levels).save_checkpoint(mine)
    r = ref.PackedTwoPhaseSys(4).checker().spawn_xla(levels_per_dispatch=1, **REF)
    for _ in range(levels):
        r._run_block()
    r.save_checkpoint(theirs)
    got, want = ck.load_checkpoint(mine), ref_ck.load_checkpoint(theirs)
    for key in ck.PAYLOAD_KEYS:
        assert got[key].dtype == want[key].dtype == np.uint32, key
        # The frontier rows in the same order, not only the same set.
        assert np.array_equal(got[key], want[key]), key
    gm, wm = dict(got["meta"]), dict(want["meta"])
    assert gm.pop("written_unix_ts") > 0 and wm.pop("written_unix_ts") > 0
    assert gm == wm
    assert gm["payload_sha256"] == ref_ck._payload_digest(want)
    # The visited rows are the sorted occupied prefix: unique, no pad.
    keys = (got["key_hi"].astype(np.uint64) << np.uint64(32)) | got["key_lo"]
    assert np.all(np.diff(keys.astype(np.float64)) > 0) and np.all(keys != 0)


@pytest.mark.parametrize("engine", ["reference", "port"])
def test_a_port_save_resumes_on_both_sides(tmp_path, engine):
    path = str(tmp_path / "ck.npz")
    partial = _port_partial(5)
    partial.save_checkpoint(path)
    if engine == "reference":
        resumed = ref.PackedTwoPhaseSys(4).checker().spawn_xla(checkpoint=path, **REF)
    else:
        resumed = port.PackedTwoPhaseSys(4).checker().spawn_xla(checkpoint=path, **CPU)
    assert (resumed.state_count(), resumed.unique_state_count()) == (
        partial.state_count(), partial.unique_state_count())
    resumed.join()
    assert _final(resumed) == FULL_RM4
    resumed.assert_properties()
    assert resumed.metrics()["resumed_from"] == path


@pytest.mark.parametrize("engine", ["reference", "port"])
def test_paxos_resumes_with_its_discovery_pin(tmp_path, engine):
    """Paxos 2c/3s saved by the port at level 10, where "value chosen" is
    already pinned, resumes to full coverage with the pin carried."""
    path = str(tmp_path / "px.npz")
    partial = PackedPaxos(2, 3).checker().spawn_xla(levels_per_dispatch=1, **CPU)
    for _ in range(10):
        partial._run_block()
    assert "value chosen" in partial._found_names
    partial.save_checkpoint(path)
    if engine == "reference":
        # The reference's CPU default (its hash set): the file is the same
        # logical state whatever the engine's visited structure, and that
        # engine compiles Paxos in seconds where the planes engine takes
        # minutes.
        resumed = RefPaxos(2, 3).checker().spawn_xla(
            checkpoint=path, frontier_capacity=1 << 12, table_capacity=1 << 15)
    else:
        resumed = PackedPaxos(2, 3).checker().spawn_xla(checkpoint=path, **CPU)
    assert resumed._found_names == partial._found_names
    resumed.join()
    assert (resumed.state_count(), resumed.unique_state_count()) == FULL_PAXOS2
    resumed.assert_properties()
    assert len(resumed.discoveries()["value chosen"]) == 8


def test_a_reference_save_resumes_in_the_port_after_a_growth(tmp_path):
    """The port restores into a table whose capacity differs from the
    writer's, and saves again only the occupied prefix."""
    path, again = str(tmp_path / "ck.npz"), str(tmp_path / "again.npz")
    r = ref.PackedTwoPhaseSys(4).checker().spawn_xla(levels_per_dispatch=1, **REF)
    for _ in range(7):
        r._run_block()
    r.save_checkpoint(path)
    c = port.PackedTwoPhaseSys(4).checker().spawn_xla(
        checkpoint=path, table_capacity=16, frontier_capacity=16, levels_per_dispatch=1, **CPU)
    assert c.metrics()["table_capacity"] != r.metrics()["table_capacity"]
    c.save_checkpoint(again)
    a, b = ref_ck.load_checkpoint(path), ref_ck.load_checkpoint(again)
    assert all(np.array_equal(a[k], b[k]) for k in ck.PAYLOAD_KEYS)
    c._run_block()
    c._grow_table(2)  # more pads after the occupied rows
    c.save_checkpoint(again)
    resumed = ref.PackedTwoPhaseSys(4).checker().spawn_xla(checkpoint=again, **REF).join()
    assert _final(resumed) == FULL_RM4


def test_a_torn_reference_checkpoint_raises_the_typed_error(tmp_path):
    path = str(tmp_path / "ck.npz")
    r = ref.PackedTwoPhaseSys(3).checker().spawn_xla(levels_per_dispatch=1, **REF)
    r._run_block()
    r.save_checkpoint(path)
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) // 2)
    with pytest.raises(ck.CheckpointCorrupt):
        port.PackedTwoPhaseSys(3).checker().spawn_xla(checkpoint=path, **CPU)


# --- the reference's tests/test_checkpoint.py, on the port ----------------


def test_single_chip_save_resume_roundtrip(tmp_path):
    path = str(tmp_path / "ck.npz")
    whole = port.PackedTwoPhaseSys(4).checker().spawn_xla(**CPU).join()
    # One fused block of 4 of the 14 levels, then the save.
    partial = port.PackedTwoPhaseSys(4).checker().spawn_xla(levels_per_dispatch=4, **CPU)
    partial._run_block()
    assert partial._depth == 5 and not partial.is_done()
    partial.save_checkpoint(path)
    resumed = port.PackedTwoPhaseSys(4).checker().spawn_xla(checkpoint=path, **CPU).join()
    assert _final(resumed) == _final(whole) == FULL_RM4
    assert set(resumed.discoveries()) == set(whole.discoveries())


def test_resume_with_different_capacities(tmp_path):
    path = str(tmp_path / "ck.npz")
    _port_partial(4).save_checkpoint(path)
    resumed = port.PackedTwoPhaseSys(4).checker().spawn_xla(
        frontier_capacity=1 << 5, table_capacity=1 << 6, checkpoint=path, **CPU).join()
    assert _final(resumed) == FULL_RM4


def test_checkpoint_rejects_wrong_model(tmp_path):
    path = str(tmp_path / "ck.npz")
    port.PackedTwoPhaseSys(4).checker().spawn_xla(**CPU).save_checkpoint(path)
    with pytest.raises(ValueError, match="does not match"):
        port.PackedTwoPhaseSys(5).checker().spawn_xla(checkpoint=path, **CPU)


def test_save_is_atomic_no_temp_left(tmp_path):
    path = str(tmp_path / "ck.npz")
    # A temp orphaned by a writer killed mid-save is swept.
    (tmp_path / "ck.npz.tmp-999999.npz").write_bytes(b"torn")
    _port_partial(4).save_checkpoint(path)
    assert sorted(os.listdir(tmp_path)) == ["ck.npz"]
    ck.load_checkpoint(path)


def test_rotation_keeps_last_k(tmp_path):
    path = str(tmp_path / "ck.npz")
    c = _port_partial(2)
    depths = []
    for _ in range(4):  # 4 saves at keep=3: the oldest falls off
        c.save_checkpoint(path, keep=3)
        depths.append(c._depth)
        c._run_block()
    rots = ck.rotations(path)
    assert rots == [path, f"{path}.1", f"{path}.2"]
    assert [ck.load_checkpoint(p)["meta"]["depth"] for p in rots] == depths[:0:-1]
    with pytest.raises(ValueError, match="keep"):
        c.save_checkpoint(path, keep=0)


def test_truncated_checkpoint_raises_typed(tmp_path):
    path = str(tmp_path / "ck.npz")
    _port_partial(4).save_checkpoint(path)
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) // 3)
    with pytest.raises(ck.CheckpointCorrupt):
        ck.load_checkpoint(path)
    assert ck.latest_valid_checkpoint(path) is None
    with pytest.raises(FileNotFoundError):
        ck.load_checkpoint(str(tmp_path / "missing.npz"))


def test_payload_digest_detects_tampering(tmp_path):
    path = str(tmp_path / "ck.npz")
    _port_partial(4).save_checkpoint(path)
    with np.load(path) as z:
        members = {k: np.asarray(z[k]) for k in z.files}
    members["key_lo"] = members["key_lo"] ^ np.uint32(1)
    np.savez_compressed(path, **members)  # meta (and its digest) unchanged
    with pytest.raises(ck.CheckpointCorrupt, match="digest mismatch"):
        ck.load_checkpoint(path)
    # The reference's reader rejects it the same way.
    with pytest.raises(ref_ck.CheckpointCorrupt, match="digest mismatch"):
        ref_ck.load_checkpoint(path)


def test_latest_valid_falls_back_past_torn_rotation(tmp_path):
    path = str(tmp_path / "ck.npz")
    c = _port_partial(4)
    c.save_checkpoint(path, keep=2)
    c._run_block()
    c.save_checkpoint(path, keep=2)
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) // 2)
    assert ck.latest_valid_checkpoint(path) == f"{path}.1"
    got, meta = ck.latest_valid_checkpoint(path, with_meta=True)
    assert got == f"{path}.1" and meta["depth"] == 5
    resumed = port.PackedTwoPhaseSys(4).checker().spawn_xla(checkpoint=got, **CPU).join()
    assert _final(resumed) == FULL_RM4


def test_autockpt_level_cadence_and_resume(tmp_path):
    path = str(tmp_path / "auto.npz")
    c = port.PackedTwoPhaseSys(4).checker().spawn_xla(
        levels_per_dispatch=1, checkpoint_to=path, checkpoint_every=2, checkpoint_keep=3, **CPU
    ).join()
    m = c.metrics()
    assert m["checkpoint_to"] == path and m["resumed_from"] is None
    # A write every second committed level: levels 2, 4, ..., 14 of 14.
    assert m["checkpoints_written"] == 7
    assert len(ck.rotations(path)) == 3
    latest = ck.latest_valid_checkpoint(path)
    assert ck.load_checkpoint(latest)["meta"]["depth"] == m["last_checkpoint_level"] == 15
    resumed = port.PackedTwoPhaseSys(4).checker().spawn_xla(
        checkpoint=latest, checkpoint_to=path, checkpoint_every=1, **CPU).join()
    assert _final(resumed) == FULL_RM4
    # Armed at the resumed depth: the finished search commits no level, so
    # the file it resumed from is not rewritten.
    assert resumed.metrics()["checkpoints_written"] == 0
    assert resumed.metrics()["resumed_from"] == latest


def test_autockpt_fused_writes_at_block_boundaries(tmp_path):
    """On the fused path the cadence is checked once a block: with
    ``checkpoint_every=1`` every block that committed a level writes, and
    the last write resumes in the reference."""
    path = str(tmp_path / "fused.npz")
    c = port.PackedTwoPhaseSys(4).checker().spawn_xla(
        checkpoint_to=path, checkpoint_every=1, checkpoint_keep=2, **CPU).join()
    blocks = sum(1 for _, committed in c.dispatch_log if committed)
    assert len(c.dispatch_log) > 1
    assert c.metrics()["checkpoints_written"] == blocks
    assert len(ck.rotations(path)) == min(blocks, 2)
    resumed = ref.PackedTwoPhaseSys(4).checker().spawn_xla(checkpoint=path, **REF).join()
    assert _final(resumed) == _final(c) == FULL_RM4


def test_autockpt_seconds_cadence(tmp_path):
    path = str(tmp_path / "auto_s.npz")
    c = port.PackedTwoPhaseSys(4).checker().spawn_xla(
        levels_per_dispatch=1, checkpoint_to=path, checkpoint_every="0.001s", **CPU).join()
    assert c.metrics()["checkpoints_written"] >= 3


def test_autockpt_env_knobs(tmp_path, monkeypatch):
    path = str(tmp_path / "env.npz")
    monkeypatch.setenv("STPU_CHECKPOINT_TO", path)
    monkeypatch.setenv("STPU_CHECKPOINT_EVERY", "1")
    monkeypatch.setenv("STPU_CHECKPOINT_KEEP", "2")
    c = port.PackedTwoPhaseSys(4).checker().spawn_xla(levels_per_dispatch=1, **CPU).join()
    assert c.metrics()["checkpoints_written"] == 14
    assert len(ck.rotations(path)) == 2
    ck.load_checkpoint(path)


@pytest.mark.parametrize("every", ["soon", 0, "-1s", True])
def test_autockpt_bad_cadence_rejected(tmp_path, every):
    with pytest.raises(ValueError, match="checkpoint_every"):
        port.PackedTwoPhaseSys(4).checker().spawn_xla(
            checkpoint_to=str(tmp_path / "x.npz"), checkpoint_every=every, **CPU)


def test_checkpoint_preserves_discovery_pins(tmp_path):
    path = str(tmp_path / "ck.npz")
    done = port.PackedTwoPhaseSys(3).checker().spawn_xla(**CPU).join()
    done.save_checkpoint(path)
    assert json.loads(bytes(np.load(path)["meta"]).decode())["done"] is True
    resumed = port.PackedTwoPhaseSys(3).checker().spawn_xla(checkpoint=path, **CPU)
    assert resumed._found_names == done._found_names
    a = {n: p.into_actions() for n, p in done.discoveries().items()}
    b = {n: p.into_actions() for n, p in resumed.discoveries().items()}
    assert a == b


def test_metrics_recovery_gauges_have_the_references_types(tmp_path):
    path = str(tmp_path / "ck.npz")
    keys = ("checkpoint_to", "resumed_from", "last_checkpoint_level", "checkpoints_written")
    fresh = port.PackedTwoPhaseSys(3).checker().spawn_xla(**CPU).metrics()
    want = ref.PackedTwoPhaseSys(3).checker().spawn_xla(**REF).metrics()
    assert {k: fresh[k] for k in keys} == {k: want[k] for k in keys} == dict(
        checkpoint_to=None, resumed_from=None, last_checkpoint_level=None, checkpoints_written=0)
    c = _port_partial(3, rm=3)
    c.save_checkpoint(path)
    m = c.metrics()
    assert (m["last_checkpoint_level"], m["checkpoints_written"]) == (4, 1)
