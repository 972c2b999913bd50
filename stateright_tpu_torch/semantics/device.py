"""Exact consistency checking on the device, batched over the frontier.

Counterpart of ``stateright_tpu/semantics/device.py``. The host testers
(``linearizability.py`` / ``sequential_consistency.py``) run a backtracking
search per history (``semantics/linearizability.rs:197-284``). For the
statically bounded histories packed models carry
(:class:`~stateright_tpu_torch.packing.BoundedHistory`: T threads, at most M
completed ops plus one in-flight op each) the whole search space is a
static enumeration: every admissible serialization is a merge of the
per-thread sequences, an arrangement of the multiset ``{0^(M+1), ...,
(T-1)^(M+1)}``. :func:`device_serializable` evaluates all of them for
every state of a batch at once, as ``[F, P]`` tensors over F states and P
patterns.

Semantics replicated (tested against the reference function and the host
serializer):

- per-thread program order holds by construction (a thread's slots appear
  in sequence order in every pattern);
- **linearizability** also checks the recorded real-time prerequisites:
  an op invoked after a peer's op completed is serialized after it
  (linearizability.rs:221-233);
- **sequential consistency** is the same enumeration without the
  real-time constraint;
- in-flight ops need never return: an excluded in-flight op is subsumed by
  a pattern that schedules it after every constrained op, because the
  specs here are total and a trailing op constrains nothing;
- a poisoned history (``h_valid`` cleared) is never serializable.

Sizing: P = (T·(M+1))! / ((M+1)!)^T — 20 at 2×2, 1,680 at 3×2, 369,600 at
4×2. Past ``MAX_PATTERNS_EXACT`` a model declares the property in
``host_verified_properties`` and passes ``pattern_limit``: the pass then
evaluates a deterministic sample of that many patterns, and its answer is
one-sided (True proves serializability, False means unknown), which is the
conservative predicate the engine's host-verified path confirms on the
host. The pattern tables (the thread, the thread's slot, and each thread's count
before every step) depend on the pattern alone, so they are built once on
the host (:func:`interleaving_tables`) and copied to each device once; the
state-dependent part gathers from them. The reference carries running
counts instead to keep its compiled constants small, and chunks the
pattern axis under ``lax.scan`` past ``PATTERN_CHUNK``; here the frontier
axis is chunked so that no ``[rows, P]`` intermediate exceeds
``SERIAL_LANES`` elements.
"""

from __future__ import annotations

import itertools
import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

#: Exact-enumeration ceiling (the reference's ``MAX_PATTERNS_EXACT``): a
#: model whose interleaving count exceeds it runs on the host engines.
MAX_PATTERNS_EXACT = 2_000_000
#: Elements of one ``[rows, P]`` intermediate of the batched serializer;
#: the frontier is split into row chunks of at most this many lanes.
SERIAL_LANES = 1 << 24
#: The serializer's working type: codes, counts and prereqs are all small.
WORK = torch.int16


@lru_cache(maxsize=None)
def interleaving_tids(T: int, slots: int, limit: Optional[int] = None) -> np.ndarray:
    """The ``tid[P, L]`` thread-schedule table for merges of T sequences of
    ``slots`` slots (L = T*slots): the thread scheduled at each step, every
    arrangement once, in the reference's order. With ``limit`` below the
    full count, ``limit`` rows drawn as the reference draws them: each an
    independent uniform shuffle of the multiset ``{t^slots}`` from one fixed
    seed, so both packages evaluate the same sample, row for row."""
    L = T * slots
    if limit is not None and limit < pattern_count(T, slots - 1):
        rng = np.random.default_rng(0xC0FFEE)
        base = np.repeat(np.arange(T, dtype=np.int32), slots)
        tid = np.asarray(rng.permuted(np.tile(base, (limit, 1)), axis=1))
        return np.ascontiguousarray(tid.astype(np.int8))
    pats: list = []

    def rec(remaining: tuple, t: int, cur: list) -> None:
        if t == T - 1:
            pat = list(cur)
            for pos in remaining:
                pat[pos] = t
            pats.append(pat)
            return
        for comb in itertools.combinations(remaining, slots):
            taken = set(comb)
            nxt = list(cur)
            for pos in comb:
                nxt[pos] = t
            rec(tuple(p for p in remaining if p not in taken), t + 1, nxt)

    rec(tuple(range(L)), 0, [0] * L)
    return np.ascontiguousarray(np.asarray(pats, dtype=np.int8))


@lru_cache(maxsize=None)
def interleaving_tables(
    T: int, slots: int, limit: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(tid[P, L], slot[P, L], cnt_before[P, L, T])``: the thread of each
    step, that thread's slot index at the step, and every thread's count of
    scheduled slots before it (of the ``limit``-row sample, if given)."""
    tid = interleaving_tids(T, slots, limit).astype(np.int32)
    P, L = tid.shape
    slot = np.zeros((P, L), dtype=np.int32)
    cnt_before = np.zeros((P, L, T), dtype=np.int32)
    running = np.zeros((P, T), dtype=np.int32)
    rows = np.arange(P)
    for l in range(L):
        cnt_before[:, l, :] = running
        slot[:, l] = running[rows, tid[:, l]]
        running[rows, tid[:, l]] += 1
    return tid, slot, cnt_before


def pattern_count(T: int, max_ops: int) -> int:
    """P without building the tables: (T*(M+1))! / ((M+1)!)^T."""
    slots = max_ops + 1
    return math.factorial(T * slots) // math.factorial(slots) ** T


@lru_cache(maxsize=None)
def _step_tables(T: int, slots: int, limit: Optional[int], device: str):
    """Per step l, as ``[L, P]`` tensors on ``device``: the thread ``tl``,
    its slot ``sl``, its completed-op column ``tl * slots + sl`` and, as
    ``[L, T, P]``, each peer's prereq columns and count before the step.
    Made once per device, before any CUDA graph capture reads them."""
    tid, slot, before = interleaving_tables(T, slots, limit)
    flat = tid * slots + slot  # [P, L]
    q = np.arange(T)
    pre = flat[:, :, None] * T + q  # [P, L, T]
    flpre = tid[:, :, None] * T + q

    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)

    return (
        t(tid.T), t(slot.T, WORK), t(flat.T),
        t(pre.transpose(1, 2, 0)), t(flpre.transpose(1, 2, 0)),
        t(before.transpose(1, 2, 0), WORK),
    )


class DeviceRegister:
    """Device form of :class:`~stateright_tpu_torch.semantics.register.Register`
    under the ``history_codecs`` convention: stored op codes — ``Read = 1``,
    ``Write(values[i]) = 2 + i``; stored ret codes — ``WriteOk = 1``,
    ``ReadOk(values[i]) = 2 + i``; the running value is the ``values``
    index (0 = unwritten None)."""

    def step(self, v, o, r, is_comp):
        is_read = o == 1
        is_write = o >= 2
        sem_ok = ~is_comp | torch.where(is_read, r == v + 2, r == 1)
        v = torch.where(is_write, o - 2, v)
        return sem_ok, v


class DeviceWORegister:
    """Device form of
    :class:`~stateright_tpu_torch.semantics.write_once_register.WORegister`
    (write_once_register.rs:9-58: the first write wins, a rewrite of the
    same value succeeds, a write of another value fails) under
    ``wo_history_codecs``: stored op codes — ``Read = 1``,
    ``Write(values[i]) = 2 + i``; stored ret codes — ``WriteOk = 1``,
    ``WriteFail = 2``, ``ReadOk(values[i]) = 3 + i``.

    ``o - 2`` is negative for ``o`` in {0, 1} where the reference's uint32
    wraps; neither value equals a running value, and the write's value is
    used only where ``o >= 2``, so the verdicts are the same."""

    def step(self, v, o, r, is_comp):
        is_read = o == 1
        is_write = o >= 2
        w_val = o - 2
        accepts = (v == 0) | (v == w_val)  # unwritten, or the same value
        write_ok = torch.where(accepts, r == 1, r == 2)
        sem_ok = ~is_comp | torch.where(is_read, r == v + 3, write_ok)
        v = torch.where(is_write & accepts, w_val, v)
        return sem_ok, v


def device_serializable(hist, words: torch.Tensor, spec, *, real_time: bool,
                        pattern_limit: Optional[int] = None) -> torch.Tensor:
    """``bool[F]``: whether the packed history in each row of
    ``words[F, W]`` admits a legal serialization of ``spec`` — the batched,
    exact device form of ``BacktrackingTester.serialized_history() is not
    None`` (real_time=True: linearizability; False: sequential
    consistency). ``hist`` is the model's bound :class:`BoundedHistory`;
    ``spec`` is :class:`DeviceRegister` or :class:`DeviceWORegister`.

    ``pattern_limit`` evaluates only a sample of that many patterns
    (:func:`interleaving_tids`): True still proves serializability, False
    means unknown — the conservative predicate of a host-verified property.

    No host read and no data-dependent shape, so the property pass that
    calls it can be captured into a CUDA graph."""
    T = len(hist.thread_ids)
    M = hist.max_ops
    slots = M + 1
    full = pattern_count(T, M)
    limit = None if pattern_limit is None or pattern_limit >= full else pattern_limit
    if (full if limit is None else limit) > MAX_PATTERNS_EXACT:
        raise NotImplementedError(
            f"{full if limit is None else limit} interleavings ({T} threads x {M}+1 ops"
            f"{'' if limit is None else f', pattern_limit={limit}'}) exceeds "
            f"MAX_PATTERNS_EXACT={MAX_PATTERNS_EXACT}; declare the property in "
            "host_verified_properties instead (conservative device predicate — "
            f"this function with a pattern_limit <= {MAX_PATTERNS_EXACT} — plus "
            "exact host confirmation)."
        )
    L_ = hist.layout
    tl_, sl_, flat_, pre_, flpre_, before_ = _step_tables(T, slots, limit, str(words.device))
    P = tl_.shape[1]
    F = words.shape[0]

    def cols(names):
        return torch.stack([L_.get(words, *n) for n in names], 1).to(WORK)

    N = cols([(f"h{t}_n",) for t in range(T)])  # [F, T]
    FL = cols([(f"h{t}_fl",) for t in range(T)])  # [F, T]
    zero = torch.zeros((F, 1), dtype=WORK, device=words.device)
    # Completed ops padded to `slots` per thread: column t * slots + j.
    OP = torch.cat([
        torch.cat([cols([(f"h{t}_op", j) for j in range(M)]), zero], 1) for t in range(T)
    ], 1)
    RET = torch.cat([
        torch.cat([cols([(f"h{t}_ret", j) for j in range(M)]), zero], 1) for t in range(T)
    ], 1)
    # Prereqs on absolute thread columns (self and pad columns 0 = no
    # entry): PRE column (t * slots + j) * T + q, FLPRE column t * T + q.
    npeer = max(T - 1, 1)
    pre_cols, flpre_cols = [], []
    for t in range(T):
        peer = {q: pi for pi, q in enumerate(hist.peers[t])}
        for j in range(slots):
            for q in range(T):
                pre_cols.append(
                    L_.get(words, f"h{t}_pre", j * npeer + peer[q]).to(WORK)
                    if j < M and q in peer else zero[:, 0]
                )
        for q in range(T):
            flpre_cols.append(
                L_.get(words, f"h{t}_flpre", peer[q]).to(WORK) if q in peer else zero[:, 0]
            )
    PRE = torch.stack(pre_cols, 1)
    FLPRE = torch.stack(flpre_cols, 1)

    def block(r0: int, r1: int) -> torch.Tensor:
        n, fl, op, ret, pre, flpre = (x[r0:r1] for x in (N, FL, OP, RET, PRE, FLPRE))
        v = torch.zeros((r1 - r0, P), dtype=WORK, device=words.device)
        ok = torch.ones((r1 - r0, P), dtype=torch.bool, device=words.device)
        for l in range(T * slots):
            tl, sl, flat = tl_[l], sl_[l], flat_[l]
            n_t = n.index_select(1, tl)
            fl_t = fl.index_select(1, tl)
            is_comp = sl < n_t
            is_fl = (sl == n_t) & (fl_t != 0)
            active = is_comp | is_fl
            o = torch.where(is_comp, op.index_select(1, flat), torch.where(is_fl, fl_t, 0))
            r = torch.where(is_comp, ret.index_select(1, flat), 0)
            good, nv = spec.step(v, o, r, is_comp)
            if real_time:
                for q in range(T):
                    b = torch.where(is_comp, pre.index_select(1, pre_[l, q]),
                                    torch.where(is_fl, flpre.index_select(1, flpre_[l, q]), 0))
                    # Peer q's completed ops scheduled so far; b stores the
                    # prereq index + 2, 0 = no entry.
                    sched = torch.minimum(before_[l, q], n[:, q:q + 1])
                    good = good & ((b == 0) | (b - 2 < sched))
            # Inactive (padding) steps constrain nothing and change nothing.
            ok = ok & (~active | good)
            v = torch.where(active, nv, v)
        return ok.any(1)

    rows = max(1, SERIAL_LANES // P)
    any_ok = torch.cat([block(r0, min(r0 + rows, F)) for r0 in range(0, F, rows)]) if F else (
        torch.zeros(0, dtype=torch.bool, device=words.device))
    return (L_.get(words, "h_valid") != 0) & any_ok
