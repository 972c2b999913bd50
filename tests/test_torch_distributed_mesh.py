"""The port's sharded engine across a real process boundary, on the CPU.

Two OS processes (``python -m stateright_tpu_torch.tools.mesh_worker``),
ranks of one ``torch.distributed`` group over gloo, run one mesh of 8
global shards (4 a rank; ``rm5-*``: 2 a rank) SPMD-style, every
configuration in one pair of processes. What the process boundary changes
is held here, exactly (tolerance 0: counts, depths, path lengths and
SHA-256 digests of every shard's planes):

- the five counterparts of ``tests/test_distributed_mesh.py`` (2pc rm=3
  against the host BFS under the default, sorted and delta sets, the
  ``DGraph`` eventually-counterexample against the JAX single-chip engine,
  the host-verified counterexample against the JAX 8-device mesh);
- both ranks' results equal, and every shard's planes equal, bit for bit,
  to the port's one-process ``default_mesh(n, device="cpu")`` run, which
  ``tests/test_torch_sharded.py`` holds against the JAX mesh engine;
- rank 0 alone writes the checkpoint and the metrics rows; its file equals
  the JAX 8-device mesh's written at the same level, and resumes in the
  JAX single-chip engine to the pins;
- a rank killed mid-run makes the other exit non-zero within the group's
  timeout;
- the backend chosen from the device layout.

The JAX and one-process runs are made while the ranks run.
"""

import json
import os
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from stateright_tpu.checkpoint import load_checkpoint as ref_load
from stateright_tpu.core import Property as RefProperty
from stateright_tpu.models.single_copy_register import PackedSingleCopyRegister as RefScr
from stateright_tpu.models.two_phase_commit import PackedTwoPhaseSys as RefSys
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as RefHostSys
from stateright_tpu.parallel import default_mesh as ref_mesh
from stateright_tpu.test_util import DGraph as RefDGraph
from stateright_tpu.test_util import PackedDGraph as RefPackedDGraph
from stateright_tpu_torch.checkpoint import PAYLOAD_KEYS, load_checkpoint
from stateright_tpu_torch.parallel import Mesh, default_mesh, distributed, mesh_device
from stateright_tpu_torch.tools import mesh_worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Every configuration the pair runs, in order; ``die`` last, since rank 1
#: kills itself there.
CONFIGS = ("2pc", "2pc-sorted", "2pc-hash", "2pc-delta", "ev", "hv", "2pc-ckpt", "rm5-delta")
#: The group's collective timeout, seconds.
GROUP_TIMEOUT_S = 30
#: What the pair may take in all before it is killed, seconds.
PAIR_TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Pair:
    """Two ranks of ``mesh_worker`` running :data:`CONFIGS` and ``die``."""

    def __init__(self, out: str):
        self.out = out
        port = _free_port()
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "stateright_tpu_torch.tools.mesh_worker", "--rank", str(r),
             "--world", "2", "--port", str(port), "--device", "cpu", "--threads", "1",
             "--timeout", str(GROUP_TIMEOUT_S), "--out", out, *CONFIGS, "die"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO, env=env)
            for r in (0, 1)]
        self._done = None

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def wait(self):
        """Each rank's ``(returncode, exit time, output)``: both ranks'
        ``communicate(timeout=...)`` side by side, the exit time when each
        returned; both are killed on a timeout or any other failure."""
        if self._done is None:
            def one(p):
                out = p.communicate(timeout=PAIR_TIMEOUT_S)[0]
                return p.returncode, time.monotonic(), out
            try:
                with ThreadPoolExecutor(2) as ex:
                    self._done = list(ex.map(one, self.procs))
            finally:
                self.kill()
        return self._done

    def results(self):
        """``{config: (rank 0's RESULT, rank 1's)}``."""
        by_rank = []
        for rc, _, out in self.wait():
            lines = [json.loads(line[len("RESULT "):]) for line in out.splitlines()
                     if line.startswith("RESULT ")]
            by_rank.append({line["config"]: line for line in lines})
        missing = [c for c in CONFIGS if c not in by_rank[0] or c not in by_rank[1]]
        assert not missing, f"no RESULT for {missing}:\n" + self.wait()[0][2][-3000:]
        return {c: (by_rank[0][c], by_rank[1][c]) for c in CONFIGS}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    p = Pair(str(tmp_path_factory.mktemp("ranks")))
    yield p
    p.kill()


def _paths(c) -> dict:
    return {name: len(path) for name, path in sorted(c.discoveries().items())}


def _profile(c) -> dict:
    return {"states": c.state_count(), "unique": c.unique_state_count(), "depth": c.max_depth(),
            "paths": _paths(c)}


@pytest.fixture(scope="module")
def refs(pair, tmp_path_factory):
    """The runs the ranks are held against, made while they run: the JAX
    package's (the host BFS of 2pc rm=3, the ``DGraph`` on its single-chip
    engine, the host-verified register on its 8-device mesh, the mesh's
    checkpoint at the worker's save depth) and the port's one-process
    mesh of each configuration."""
    out = {"oracle": _profile(RefHostSys(3).checker().spawn_bfs().join())}
    graph = (RefDGraph.with_property(RefProperty.eventually("odd", lambda _, s: s % 2 == 1))
             .with_path([0, 2, 4]).with_path([4, 6]))
    out["ev"] = _profile(RefPackedDGraph(graph).checker().spawn_xla(**mesh_worker.SMALL).join())
    out["hv"] = _profile(RefScr(2, 2, device_exact=False).checker().spawn_xla(
        mesh=ref_mesh(8), **mesh_worker.SMALL).join())
    ref = RefSys(3).checker().spawn_xla(mesh=ref_mesh(8), dedup="sorted", levels_per_dispatch=1,
                                        **mesh_worker.SMALL)
    while ref._depth < mesh_worker.SAVE_DEPTH:
        ref._run_block()
    out["ckpt"] = str(tmp_path_factory.mktemp("ref") / "mid.npz")
    ref.save_checkpoint(out["ckpt"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name in CONFIGS:
            factory, shards, kw, _ = mesh_worker.CONFIGS[name]
            c = factory().checker().spawn_xla(mesh=default_mesh(shards, device="cpu"), **kw).join()
            out[("one", name)] = mesh_worker.result_of(c)
            out[("grows", name)] = {k: c.metrics()[k] for k in ("table_grows", "delta_flushes")}
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.fixture(scope="module")
def results(pair, refs):
    return pair.results()


def _same_on_both(results, name) -> dict:
    a, b = results[name]
    assert a["result"] == b["result"], name
    assert (a["rank"]["rank"], b["rank"]["rank"]) == (0, 1)
    return {k: a["result"][k] for k in ("states", "unique", "depth", "paths")}


# --- the reference's five two-process tests ---------------------------------------


def test_two_process_mesh_exact_parity(results, refs):
    assert _same_on_both(results, "2pc") == refs["oracle"]
    assert refs["oracle"]["unique"] == 288 and refs["oracle"]["states"] == 1_146


@pytest.mark.parametrize("dedup", ["sorted", "hash"])
def test_two_process_mesh_sorted_structure(results, refs, dedup):
    assert _same_on_both(results, f"2pc-{dedup}") == refs["oracle"]


def test_two_process_mesh_delta_structure_with_flushes(results, refs):
    assert _same_on_both(results, "2pc-delta") == refs["oracle"]
    # rm=5 at 2 x 2 shards from a small table: flushes and a growth of
    # every shard's table, across the process boundary.
    assert _same_on_both(results, "rm5-delta")["unique"] == 8_832
    for line in results["rm5-delta"]:
        run = line["rank"]["runs"][0]
        assert run["grows"]["delta_flushes"] > 0 and run["grows"]["table_grows"] > 0, run
    assert refs[("grows", "rm5-delta")] == {
        k: results["rm5-delta"][0]["rank"]["runs"][0]["grows"][k]
        for k in ("table_grows", "delta_flushes")}


def test_two_process_mesh_eventually_counterexample(results, refs):
    assert "odd" in refs["ev"]["paths"]
    assert _same_on_both(results, "ev") == refs["ev"]


def test_two_process_mesh_host_verified_counterexample(results, refs):
    assert "linearizable" in refs["hv"]["paths"]
    assert _same_on_both(results, "hv") == refs["hv"]
    assert results["hv"][0]["result"]["hv"] == 1


# --- the one-process mesh, shard for shard -----------------------------------------


@pytest.mark.parametrize("name", CONFIGS)
def test_every_shard_equals_the_one_process_mesh(results, refs, name):
    """Both ranks' results, and every shard's planes (and sorted rows), equal
    the port's one-process mesh of the same shards, bit for bit."""
    a, b = results[name]
    assert a["result"] == b["result"]
    got = {k: v for k, v in a["result"].items() if k != "mesh_backend"}
    assert got == refs[("one", name)]


# --- rank 0's files -----------------------------------------------------------------


def test_rank_zero_alone_writes_the_checkpoint_and_the_metrics(results, refs, pair):
    """Rank 0's mid-run file is the JAX 8-device mesh's payload written at
    the same level, meta included (but its time and digest), and resumes in
    the JAX single-chip engine to the pins; rank 1 wrote nothing, yet
    counts the write in its gauges as rank 0 does; rank 0's metrics rows
    end at the search's counts."""
    a, b = results["2pc-ckpt"]
    assert a["rank"]["files"] == ["metrics.jsonl", "mid.npz"] and b["rank"]["files"] == []
    assert a["rank"]["runs"][0]["checkpoints"] == b["rank"]["runs"][0]["checkpoints"] == {
        "checkpoints_written": 1, "last_checkpoint_level": mesh_worker.SAVE_DEPTH}
    assert not os.listdir(os.path.join(pair.out, "rank1"))
    path = os.path.join(pair.out, "rank0", "mid.npz")
    got, want = load_checkpoint(path), ref_load(refs["ckpt"])
    assert got["meta"]["depth"] == mesh_worker.SAVE_DEPTH
    for key in PAYLOAD_KEYS:
        assert got[key].dtype == want[key].dtype == np.uint32
        assert np.array_equal(got[key], want[key]), key
    skip = {"payload_sha256", "written_unix_ts"}
    assert {k: v for k, v in got["meta"].items() if k not in skip} == {
        k: v for k, v in want["meta"].items() if k not in skip}
    r = RefSys(3).checker().spawn_xla(checkpoint=path, **mesh_worker.SMALL).join()
    assert (r.state_count(), r.unique_state_count()) == (1_146, 288)
    with open(os.path.join(pair.out, "rank0", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    last = rows[-1]["metrics"]
    assert last["state_count"] == 1_146 and last["mesh_backend"] == "gloo"


# --- a rank's death -------------------------------------------------------------------


def test_a_killed_rank_fails_its_peer_within_the_timeout(results, pair):
    """Rank 1 kills itself mid-run (``die``, after every other config); rank
    0, inside a collective, exits non-zero within the group's timeout."""
    (rc0, end0, out0), (rc1, end1, _) = pair.wait()
    assert rc1 == -9, rc1
    assert rc0 not in (0, None), out0[-2000:]
    assert end0 - end1 < GROUP_TIMEOUT_S, (end0 - end1)
    assert '"config": "die"' not in out0


# --- the backend ------------------------------------------------------------------------


@pytest.mark.parametrize("layout,want", [
    (("cpu", 2, 0), "gloo"),
    (("cuda", 2, 1), "gloo"),
    (("cuda", 2, 2), "nccl"),
    (("cuda", 4, 8), "nccl"),
    (("cuda", 8, 4), "gloo"),
], ids=str)
def test_the_backend_follows_the_device_layout(layout, want):
    """gloo on the CPU and for ranks that share a card, NCCL when every rank
    of the machine has a card of its own; a pure function, no card needed."""
    assert distributed.choose_backend(*layout) == want


def test_the_ranks_report_their_backend(results):
    for a, b in results.values():
        assert a["rank"]["backend"] == b["rank"]["backend"] == "gloo"
        assert a["result"]["mesh_backend"] == "gloo"
        assert a["rank"]["device"] == b["rank"]["device"] == "cpu"


def test_a_rank_asking_for_a_card_has_one_or_fails():
    """A rank's device is ``cuda:(rank % cards)`` unless it names the CPU;
    with no card, asking for one raises and nothing falls back to the CPU."""
    assert distributed.rank_device(3, "cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        for device in (None, "cuda"):
            with pytest.raises(RuntimeError, match="no.*CUDA|none is available"):
                distributed.rank_device(1, device)
    with pytest.raises(ValueError, match="cuda' or 'cpu"):
        distributed.choose_backend("meta", 2, 0)


def test_a_rank_mesh_needs_its_group():
    """Outside a group ``default_mesh`` is the one-process mesh, and a mesh
    made with ranks refuses to run without the group it names."""
    assert distributed.group() is None and distributed.process_count() == 1
    assert default_mesh(4, device="cpu").ranks is None
    with pytest.raises(ValueError, match="process group"):
        mesh_device(Mesh(["cpu"] * 4, ranks=[0, 0, 1, 1], rank=0))
