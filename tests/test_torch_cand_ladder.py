"""The port's candidate ladder (``spawn_xla(cand_ladder=)``, "auto" = 3
rungs) against the reference's (``stateright_tpu/xla.py`` ``cand_rungs``,
``_build_fused``) on the CPU:

- the rung plan equals the reference's over a grid of buckets, caps and
  rung counts, and stays monotone after a candidate-cap growth at a small
  bucket; the keyword is validated as the reference validates it;
- the reference's growth-spike model: a snug rung's candidate overflow
  falls through to the full rung inside the block, with exact counts, the
  same fall-throughs, levels and dispatches as the reference;
- candidate caps are per checker; a second check of a model, after a table
  growth remade its programs, makes no program; a second check runs a snug
  rung the first never ran (so rungs are not made on first use);
- the gated level reads nothing on the host at every rung (meta device),
  and levels queued ahead of the host's read (``graphs.LOOKAHEAD`` > 1) run
  the full rung with the same search.

2pc at rm=3..5 at ``cand_ladder`` 3 and 1 against the reference (counts,
discoveries, per-level rungs, dispatch log, fall-throughs) is
``test_torch_fused.py::test_fused_matches_reference``. Everything is
exact."""

import numpy as np
import pytest
import torch

from stateright_tpu import xla as ref_xla
from stateright_tpu.models import two_phase_commit as ref
from stateright_tpu_torch import graphs
from stateright_tpu_torch import xla as port_xla
from stateright_tpu_torch.core import Model
from stateright_tpu_torch.graphs import S
from stateright_tpu_torch.models import two_phase_commit as port
from stateright_tpu_torch.models.single_copy_register import PackedSingleCopyRegister
from stateright_tpu_torch.ops import sortedset as port_ss
from stateright_tpu_torch.ops.words import DTYPE

CPU = dict(device="cpu")
KW = dict(frontier_capacity=1 << 12, table_capacity=1 << 13)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test process: the suite runs several test
    processes on one machine, and torch's default of a thread per core in
    each oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_rung_plan_equals_the_reference(backend):
    grown = {256: 1 << 15, 1024: 1 << 16, 4096: 1 << 12}
    cap_fns = [
        lambda f: port_xla.default_cand_cap(f, 42, backend),
        lambda f: port_xla.default_cand_cap(f, 672, backend),
        # Caps grown at small buckets, past their parents': the clamp.
        lambda f: grown.get(f, port_xla.default_cand_cap(f, 16, backend)),
    ]
    for cap_of in cap_fns:
        for f_cap in [64, 256, 1000, 1024, 2048, 4096, 32768, 131072, 262144, 1 << 20]:
            for k in (1, 2, 3):
                got = port_xla.cand_rungs(f_cap, cap_of, k)
                assert got == ref_xla.cand_rungs(f_cap, cap_of, k), (f_cap, k)
                caps = [c for _, c in got]
                assert caps == sorted(caps) and got[-1] == (f_cap, cap_of(f_cap))
    assert port_xla.CAND_RUNG_FLOOR == ref_xla.CAND_RUNG_FLOOR
    assert port_xla.CAND_LADDER_AUTO_K == ref_xla.CAND_LADDER_AUTO_K
    assert port_xla.XlaChecker.CAND_EST_MARGIN == ref_xla.XlaChecker.CAND_EST_MARGIN


def test_rung_caps_stay_monotone_after_subbucket_growth():
    model = port.PackedTwoPhaseSys(3)
    c = model.checker().spawn_xla(**KW, **CPU)
    # A card's starting caps (a sixteenth of the grid) leave room to grow.
    c._backend = "cuda"
    assert c._cand_ladder_k == 3 and c.metrics()["cand_ladder_k"] == 3
    assert c._cand_rungs(64) == [(64, c._cand_cap_for(64))]
    assert [f for f, _ in c._cand_rungs(1024)] == [256, 1024]
    assert [f for f, _ in c._cand_rungs(1 << 14)] == [1 << 10, 1 << 12, 1 << 14]
    while c._cand_cap_for(1024) < port_xla._next_pow2(1024 * c._A):
        c._grow_cand_cap(1024)
    assert c._cand_cap_for(1024) > c._cand_cap_for(4096)  # the hazard
    caps = [cap for _, cap in c._cand_rungs(4096)]
    assert caps == sorted(caps) and caps[-1] == c._cand_cap_for(4096)
    assert c._cand_rungs(4096) == ref_xla.cand_rungs(4096, c._cand_cap_for, 3)


def test_cand_ladder_validation():
    for bad in ("sideways", None, 1.5j):
        with pytest.raises(ValueError, match="cand_ladder"):
            port.PackedTwoPhaseSys(3).checker().spawn_xla(cand_ladder=bad, **CPU)
    for bad in (0, 4, "5"):
        with pytest.raises(ValueError, match="cand_ladder must be in 1..3"):
            port.PackedTwoPhaseSys(3).checker().spawn_xla(cand_ladder=bad, **CPU)
    for k in (1, 2, 3, "2"):
        c = port.PackedTwoPhaseSys(3).checker().spawn_xla(cand_ladder=k, **CPU)
        assert len(c._cand_rungs(1 << 14)) == int(k)


class ChainSpike(Model):
    """The reference's growth-spike model (``tests/test_cand_ladder.py``),
    batched: 600 parallel chains make 600 states a level for two levels,
    then every chain state fans out 16 wide at once, 9,600 candidates
    against the snug rung's 4,096-row buffer, so the only overflow of the
    run is the snug rung's fall-through. The spike's successors collide
    down to 800 uniques."""

    M = 100_000  # wave stride in the packed word
    state_words = 1
    max_actions = 16

    def init_states(self):
        return list(range(600))

    def actions(self, state, actions):
        wave = state // self.M
        if wave < 2:
            actions.append(0)
        elif wave == 2:
            actions.extend(range(16))

    def next_state(self, state, action):
        wave, i = divmod(state, self.M)
        if wave < 2:
            return state + self.M
        return 3 * self.M + action * 50 + i % 50

    def properties(self):
        return []

    def pack(self, state):
        return np.asarray([state], np.uint32)

    def unpack(self, words):
        return int(words[0])

    def packed_init(self):
        return np.arange(600, dtype=np.uint32)[:, None]

    def packed_step(self, words):
        x = words[:, 0]
        wave, i = x // self.M, x % self.M
        a = torch.arange(16, device=words.device)
        leaves = 3 * self.M + a * 50 + (i % 50)[:, None]
        nxt = torch.where((wave < 2)[:, None], (x + self.M)[:, None], leaves)[..., None]
        valid = torch.where((wave < 2)[:, None], a == 0, (wave == 2)[:, None])
        return nxt, valid

    def packed_properties(self, words):
        return torch.zeros((words.shape[0], 0), dtype=torch.bool, device=words.device)


#: The reference's pins: 600 init + (600 + 600 + 9,600) generated; uniques
#: 600 * 3 waves + 800 colliding leaves; the leaves at depth 4.
SPIKE_PINNED = (11_400, 2_600, 4)
SPIKE_KW = dict(frontier_capacity=1 << 13, table_capacity=1 << 13)


def _rows(c):
    return [(r["depth"], r["frontier"], r["generated"], r["unique"], r["bucket"], r["cand_cap"])
            for r in c.level_log]


@pytest.fixture(scope="module")
def ref_spike():
    from test_cand_ladder import _ChainSpike

    return {
        k: _ChainSpike().checker().spawn_xla(
            dedup="sorted", cand_ladder=k, shrink_exit="on", **SPIKE_KW).join()
        for k in (1, 3)
    }


@pytest.mark.parametrize("cand_ladder", [3, 1])
def test_growth_spike_falls_through_to_the_full_rung(ref_spike, cand_ladder):
    r = ref_spike[cand_ladder]
    c = ChainSpike().checker().spawn_xla(cand_ladder=cand_ladder, **SPIKE_KW, **CPU).join()
    assert (c.state_count(), c.unique_state_count(), c.max_depth()) == SPIKE_PINNED
    assert _rows(c) == _rows(r)
    assert c.dispatch_log == r.dispatch_log == [(4096, 4)]
    assert c.cand_retries == r.cand_retries == (1 if cand_ladder == 3 else 0)
    assert c.metrics()["cand_retries"] == c.cand_retries
    # The spike level committed at the full rung; no candidate buffer grew.
    spike = next(row for row in c.level_log if row["generated"] == 9_600)
    assert (spike["bucket"], spike["cand_cap"]) == (4096, c._cand_cap_for(4096))
    assert c.metrics()["cand_grows"] == 0


def test_two_checkers_do_not_share_cand_caps():
    model = port.PackedTwoPhaseSys(3)
    c1 = model.checker().spawn_xla(**KW, **CPU)
    c2 = model.checker().spawn_xla(**KW, **CPU)
    base = c2._cand_cap_for(1024)
    assert c1._cand_cap_for(1024) == base
    rungs = c2._cand_rungs(4096)
    c1._grow_cand_cap(1024)
    assert c1._cand_cap_for(1024) == base * 4
    assert c2._cand_cap_for(1024) == base and c2._cand_rungs(4096) == rungs
    # A fresh checker starts from the model's hint.
    assert model.checker().spawn_xla(**KW, **CPU)._cand_cap_for(1024) == base * 4


def test_a_second_check_makes_no_program(monkeypatch):
    """A first check from a small table grows it and remakes the programs
    of every rung it ran at the grown capacity; a second check of the same
    model instance (at the hinted capacity) finds every program it runs."""
    monkeypatch.setattr(port_xla, "DEFAULT_TABLE_CAPACITY", 1 << 10)
    model = port.PackedTwoPhaseSys(5)
    first = model.checker().spawn_xla(**CPU).join()
    assert first.metrics()["table_grows"] > 0
    cache = graphs.cache_for(model, torch.device("cpu"))
    keys = set(cache.programs)
    cap = first.metrics()["table_capacity"]
    assert all(k[3] == cap for k in keys)
    # Sub-rung programs were made (and remade after the growth).
    assert any(k[1] < k[0] for k in keys)
    made = []
    original = cache.make
    monkeypatch.setattr(cache, "make", lambda key, *a, **kw: made.append(key) or original(key, *a, **kw))
    second = model.checker().spawn_xla(**CPU).join()
    assert made == [] and set(cache.programs) == keys
    assert second.level_log == first.level_log
    assert second.metrics()["table_grows"] == 0 and all(n for _, n in second.dispatch_log)


def test_a_second_check_runs_a_rung_the_first_never_ran(monkeypatch):
    """Why every rung of a bucket is made with the bucket and not on its
    first use: a second check reuses a bucket that has a program for an
    earlier, smaller frontier than the first check ran there (the
    reference's bucket reuse, ``LADDER_REUSE_BOUND``), and there runs a
    snug rung the first check never ran. Made on first use, that rung
    would be captured by the second check."""
    model = port.PackedTwoPhaseSys(7)
    ran = []
    original = graphs.Program.run
    monkeypatch.setattr(graphs.Program, "run",
                        lambda prog, *a, **kw: ran.append(prog) or original(prog, *a, **kw))
    first = model.checker().spawn_xla(**CPU).join()
    cache = graphs.cache_for(model, torch.device("cpu"))
    key_of = {id(p): k[:3] for k, p in cache.programs.items()}
    keys = set(cache.programs)
    ran_first = {key_of[id(p)] for p in ran}
    ran.clear()
    second = model.checker().spawn_xla(**CPU).join()
    assert set(cache.programs) == keys
    ran_second = {key_of[id(p)] for p in ran}
    assert (second.state_count(), second.unique_state_count()) == (2_744_706, 296_448)
    assert second.dispatch_log != first.dispatch_log
    new = ran_second - ran_first
    assert new and all(rows < run_cap for run_cap, rows, _ in new)


def test_queued_levels_run_the_full_rung(monkeypatch):
    """With ``LOOKAHEAD`` 2 a level's predecessor has not been read when
    it is enqueued, so every level but a block's first runs the full rung:
    the same search, wider rungs."""
    snug = port.PackedTwoPhaseSys(5).checker().spawn_xla(**CPU).join()
    monkeypatch.setattr(graphs, "LOOKAHEAD", 2)
    queued = port.PackedTwoPhaseSys(5).checker().spawn_xla(**CPU).join()
    keys = ("depth", "frontier", "generated", "unique")
    assert [[r[k] for k in keys] for r in queued.level_log] == [
        [r[k] for k in keys] for r in snug.level_log]
    assert queued.dispatch_log == snug.dispatch_log
    blocks = [(bucket, i == 0) for bucket, n in queued.dispatch_log for i in range(n)]
    for r, s, (bucket, first) in zip(queued.level_log, snug.level_log, blocks):
        assert r["bucket"] == (s["bucket"] if first else bucket)
    assert any(r["bucket"] > s["bucket"] for r, s in zip(queued.level_log, snug.level_log))


def test_the_gated_level_reads_nothing_on_the_host_at_each_rung(monkeypatch):
    """Each rung of a 4,096 bucket (1,024 rows at its cap up to the whole
    bucket) on the meta device, where every host read raises; with a
    host-verified property, whose candidates the level accumulates."""

    def fake_compact(mask, lanes, cap):
        return (torch.empty((len(lanes), cap), dtype=DTYPE, device=mask.device),
                torch.empty((), dtype=DTYPE, device=mask.device))

    def fake_merge(table, batch):
        return (torch.empty_like(table),
                torch.empty(batch.shape[1], dtype=torch.bool, device=table.device),
                torch.empty((), dtype=DTYPE, device=table.device))

    checkers = [
        port.PackedTwoPhaseSys(3).checker().spawn_xla(**CPU),
        PackedSingleCopyRegister(3, 1, device_exact=False, pattern_limit=64).checker().spawn_xla(
            host_verified_cap=16, **CPU),
    ]
    monkeypatch.setattr(port_xla, "compact", fake_compact)
    monkeypatch.setattr(port_ss, "merge_insert", fake_merge)
    meta = torch.device("meta")
    for c in checkers:
        monkeypatch.setattr(c, "_device", meta)
        rungs = c._cand_rungs(4096)
        assert len(rungs) == 3
        for rows, cand_cap in rungs:
            carry = graphs.Carry(meta, c._W, c._P, 32, 1024, len(c._hv_idx), c._hv_cap)
            c._gated_level(carry, 4096, cand_cap, rows)
            with pytest.raises(RuntimeError, match="meta"):
                bool(carry.s[S["live"]])


def test_lane_words_drop_at_narrow_levels():
    """``tests/test_cand_ladder.py::test_lane_words_drop_at_narrow_levels``
    on the port: with the ladder on, the median level of 2pc rm=4 carries
    at least 2x fewer sorted lane words than the one-rung block's (the
    merge kernel's batch-scale words, ``level_log``'s ``lane_words``), at
    identical counts, discoveries and dispatch count; no level runs wider
    than the one-rung block's widest candidate cap."""

    def summary(c):
        return (c.state_count(), c.unique_state_count(), c.max_depth(),
                {n: p.into_actions() for n, p in c.discoveries().items()})

    model = port.PackedTwoPhaseSys(4)
    off = model.checker().spawn_xla(dedup="sorted", cand_ladder=1, **KW, **CPU).join()
    on = model.checker().spawn_xla(dedup="sorted", cand_ladder=3, **KW, **CPU).join()
    assert summary(on) == summary(off)
    assert len(on.dispatch_log) == len(off.dispatch_log)
    lw_off = sorted(r["lane_words"] for r in off.level_log)
    lw_on = sorted(r["lane_words"] for r in on.level_log)
    med = len(lw_off) // 2
    assert lw_on[med] * 2 <= lw_off[med], (lw_on, lw_off)
    peak_cand = max(r["cand_cap"] for r in off.level_log)
    for r in on.level_log:
        assert r["cand_cap"] <= peak_cand
