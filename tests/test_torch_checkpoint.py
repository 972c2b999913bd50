"""A search stopped and saved by the reference package's XlaChecker resumes
in the port (stateright_tpu_torch/checkpoint.py, carry.py) to the exact
counts of an uninterrupted run."""

import json

import numpy as np
import pytest

from stateright_tpu.models import two_phase_commit as ref
from stateright_tpu_torch.models import two_phase_commit as port


def _save_reference(path, rm: int, levels: int):
    partial = ref.PackedTwoPhaseSys(rm).checker().spawn_xla(
        frontier_capacity=1 << 10, table_capacity=1 << 13, levels_per_dispatch=1
    )
    for _ in range(levels):
        partial._run_block()
    partial.save_checkpoint(path)
    return partial


@pytest.mark.parametrize("levels", [1, 4, 9])
def test_reference_checkpoint_resumes_in_the_port(tmp_path, levels):
    path = str(tmp_path / "ck.npz")
    partial = _save_reference(path, 4, levels)
    resumed = port.PackedTwoPhaseSys(4).checker().spawn_xla(checkpoint=path, device="cpu")
    assert resumed.state_count() == partial.state_count()
    assert resumed.unique_state_count() == partial.unique_state_count()
    resumed.join()
    assert (resumed.state_count(), resumed.unique_state_count()) == (8_258, 1_568)
    assert resumed.max_depth() == 14
    resumed.assert_properties()


def test_resume_with_small_capacities_grows(tmp_path):
    path = str(tmp_path / "ck.npz")
    _save_reference(path, 4, 6)
    resumed = port.PackedTwoPhaseSys(4).checker().spawn_xla(
        checkpoint=path, device="cpu", frontier_capacity=32, table_capacity=64
    ).join()
    assert (resumed.state_count(), resumed.unique_state_count()) == (8_258, 1_568)


def test_rejects_another_model_and_a_tampered_payload(tmp_path):
    path = str(tmp_path / "ck.npz")
    _save_reference(path, 4, 3)
    with pytest.raises(ValueError, match="does not match"):
        port.PackedTwoPhaseSys(3).checker().spawn_xla(checkpoint=path, device="cpu")
    with np.load(path) as z:
        arrays = {k: np.asarray(z[k]) for k in z.files}
    arrays["frontier_ebits"] = arrays["frontier_ebits"] + 1
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **arrays)
    with pytest.raises(ValueError, match="digest"):
        port.PackedTwoPhaseSys(4).checker().spawn_xla(checkpoint=bad, device="cpu")
    meta = json.loads(bytes(arrays["meta"]).decode())
    assert meta["format_version"] == 3
