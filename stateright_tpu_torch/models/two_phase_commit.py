"""Two-phase commit (Gray & Lamport, "Consensus on Transaction Commit").

Counterpart of ``stateright_tpu/models/two_phase_commit.py``, with the same
transition system as stateright's ``examples/2pc.rs``: a transaction manager
and ``rm_count`` resource managers exchange messages through a shared
message set. Known state-space sizes: 288 unique at rm=3, 1,568 at rm=4,
8,832 at rm=5, 1,745,408 at rm=8. Under the device symmetry (the RM blocks'
full canonicalization) they reduce to 80, 166, 314 and 1,461 classes, and
rm=14 to 12,323.

Two implementations of the one system:

- :class:`TwoPhaseSys` — the object-level ``Model``; witness paths are
  re-executed through it.
- :class:`PackedTwoPhaseSys` — the GPU form: states bit-packed into two
  32-bit words, the action fan-out evaluated as a fixed ``2 + 5N`` slot
  grid batched over the whole frontier, properties as packed predicates,
  and the RM blocks declared as a ``symmetry_spec``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..core import Model, Property
from ..ops.words import MASK32
from ..sym import BlockGroup, SymmetrySpec

# RmState encoding; order matches the reference's derive(Ord) declaration
# order (2pc.rs:33-39).
WORKING, PREPARED, COMMITTED, ABORTED = 0, 1, 2, 3
# TmState encoding (2pc.rs:41-46).
TM_INIT, TM_COMMITTED, TM_ABORTED = 0, 1, 2


@dataclass(frozen=True)
class TwoPhaseState:
    """rm_state per RM, tm_state, tm_prepared per RM, and the message set.

    Messages are encoded in a frozenset as ``("Prepared", rm)``, ``"Commit"``,
    ``"Abort"`` (the closed message universe of 2pc.rs:26-31).
    """

    rm_state: Tuple[int, ...]
    tm_state: int
    tm_prepared: Tuple[bool, ...]
    msgs: frozenset

    def representative(self) -> "TwoPhaseState":
        """Canonical member of this state's symmetry class, for the host
        engines' ``symmetry()``: RMs sorted by rm_state (stable),
        tm_prepared permuted along, message RM ids rewritten
        (2pc.rs:205-225)."""
        order = sorted(range(len(self.rm_state)), key=lambda i: self.rm_state[i])
        inverse = {old: new for new, old in enumerate(order)}
        msgs = frozenset(
            ("Prepared", inverse[m[1]]) if isinstance(m, tuple) else m
            for m in self.msgs
        )
        return TwoPhaseState(
            rm_state=tuple(self.rm_state[i] for i in order),
            tm_state=self.tm_state,
            tm_prepared=tuple(self.tm_prepared[i] for i in order),
            msgs=msgs,
        )


class TwoPhaseSys(Model):
    """Object-level two-phase commit model (2pc.rs:59-149)."""

    def __init__(self, rm_count: int):
        self.rm_count = rm_count

    def init_states(self) -> List[TwoPhaseState]:
        n = self.rm_count
        return [
            TwoPhaseState(
                rm_state=(WORKING,) * n,
                tm_state=TM_INIT,
                tm_prepared=(False,) * n,
                msgs=frozenset(),
            )
        ]

    def actions(self, state: TwoPhaseState, actions: List[Any]) -> None:
        # Mirrors the enablement conditions of 2pc.rs:72-98 (same order).
        if state.tm_state == TM_INIT and all(state.tm_prepared):
            actions.append(("TmCommit",))
        if state.tm_state == TM_INIT:
            actions.append(("TmAbort",))
        for rm in range(self.rm_count):
            if state.tm_state == TM_INIT and ("Prepared", rm) in state.msgs:
                actions.append(("TmRcvPrepared", rm))
            if state.rm_state[rm] == WORKING:
                actions.append(("RmPrepare", rm))
            if state.rm_state[rm] == WORKING:
                actions.append(("RmChooseToAbort", rm))
            if "Commit" in state.msgs:
                actions.append(("RmRcvCommitMsg", rm))
            if "Abort" in state.msgs:
                actions.append(("RmRcvAbortMsg", rm))

    def next_state(
        self, state: TwoPhaseState, action: Tuple
    ) -> Optional[TwoPhaseState]:
        kind = action[0]
        rm_state = list(state.rm_state)
        tm_prepared = list(state.tm_prepared)
        tm_state = state.tm_state
        msgs = set(state.msgs)
        if kind == "TmRcvPrepared":
            tm_prepared[action[1]] = True
        elif kind == "TmCommit":
            tm_state = TM_COMMITTED
            msgs.add("Commit")
        elif kind == "TmAbort":
            tm_state = TM_ABORTED
            msgs.add("Abort")
        elif kind == "RmPrepare":
            rm_state[action[1]] = PREPARED
            msgs.add(("Prepared", action[1]))
        elif kind == "RmChooseToAbort":
            rm_state[action[1]] = ABORTED
        elif kind == "RmRcvCommitMsg":
            rm_state[action[1]] = COMMITTED
        elif kind == "RmRcvAbortMsg":
            rm_state[action[1]] = ABORTED
        else:  # pragma: no cover
            raise ValueError(f"unknown action {action!r}")
        return TwoPhaseState(tuple(rm_state), tm_state, tuple(tm_prepared), frozenset(msgs))

    def properties(self) -> List[Property]:
        return [
            Property.sometimes(
                "abort agreement",
                lambda _, s: all(r == ABORTED for r in s.rm_state),
            ),
            Property.sometimes(
                "commit agreement",
                lambda _, s: all(r == COMMITTED for r in s.rm_state),
            ),
            Property.always(
                "consistent",
                lambda _, s: not (
                    any(r == ABORTED for r in s.rm_state)
                    and any(r == COMMITTED for r in s.rm_state)
                ),
            ),
        ]

    def format_action(self, action: Tuple) -> str:
        return action[0] if len(action) == 1 else f"{action[0]}({action[1]})"


class PackedTwoPhaseSys(TwoPhaseSys):
    """Packed two-phase commit: implements the PackedModel protocol.

    Bit layout over two 32-bit words (supports rm_count <= 14):

    - word0: ``rm_state[i]`` in bits ``[2i, 2i+2)``
    - word1: ``tm_state`` in bits ``[0, 2)``; ``tm_prepared[i]`` at bit
      ``2 + i``; ``Prepared{i}`` message bit at ``16 + i``; ``Commit`` at
      ``30``; ``Abort`` at ``31``.

    The action grid is ``2 + 5*rm_count`` static slots: [TmCommit, TmAbort]
    then per-RM [TmRcvPrepared, RmPrepare, RmChooseToAbort, RmRcvCommitMsg,
    RmRcvAbortMsg], mirroring the enablement conditions of 2pc.rs:72-98.
    """

    state_words = 2

    def __init__(self, rm_count: int):
        if rm_count > 14:
            raise ValueError("PackedTwoPhaseSys supports rm_count <= 14")
        super().__init__(rm_count)
        self.max_actions = 2 + 5 * rm_count
        if rm_count >= 2:
            # The device symmetry (``sym/``): RM block i is its rm_state
            # dibit, its tm_prepared bit and its Prepared{i} message bit.
            # All three lanes key the sort, so the spec's canonicalization
            # is FULL (class-invariant), unlike the partial rm_state sort of
            # :meth:`packed_representative`: rm=5 reduces to 314 classes on
            # any traversal.
            self.symmetry_spec = SymmetrySpec(
                [
                    BlockGroup(
                        "rm",
                        rm_count,
                        (
                            SymmetrySpec.lane("rm_state", 2, word=0, count=rm_count),
                            SymmetrySpec.lane(
                                "tm_prepared", 1, word=1, shift0=2, stride=1, count=rm_count
                            ),
                            SymmetrySpec.lane(
                                "prepared_msg", 1, word=1, shift0=16, stride=1, count=rm_count
                            ),
                        ),
                    )
                ],
                name="2pc-rm",
            )

    # --- host-side codec --------------------------------------------------

    def pack(self, state: TwoPhaseState) -> np.ndarray:
        w0 = 0
        for i, r in enumerate(state.rm_state):
            w0 |= r << (2 * i)
        w1 = state.tm_state
        for i, p in enumerate(state.tm_prepared):
            w1 |= int(p) << (2 + i)
        for m in state.msgs:
            if isinstance(m, tuple):
                w1 |= 1 << (16 + m[1])
            elif m == "Commit":
                w1 |= 1 << 30
            else:
                w1 |= 1 << 31
        return np.array([w0, w1], dtype=np.uint32)

    def unpack(self, words) -> TwoPhaseState:
        w0, w1 = int(words[0]), int(words[1])
        n = self.rm_count
        msgs = set()
        for i in range(n):
            if (w1 >> (16 + i)) & 1:
                msgs.add(("Prepared", i))
        if (w1 >> 30) & 1:
            msgs.add("Commit")
        if (w1 >> 31) & 1:
            msgs.add("Abort")
        return TwoPhaseState(
            rm_state=tuple((w0 >> (2 * i)) & 3 for i in range(n)),
            tm_state=w1 & 3,
            tm_prepared=tuple(bool((w1 >> (2 + i)) & 1) for i in range(n)),
            msgs=frozenset(msgs),
        )

    def packed_init(self) -> np.ndarray:
        return np.stack([self.pack(s) for s in self.init_states()])

    # --- batched device form ----------------------------------------------

    def packed_step(self, words: torch.Tensor):
        """Every state's full action fan-out: ``[F, 2] int64 -> ([F, A, 2]
        int64, [F, A] bool)``, slot order as in the class docstring."""
        n = self.rm_count
        dev = words.device
        w0, w1 = words[:, 0:1], words[:, 1:2]  # [F, 1]
        rm_ids = torch.arange(n, device=dev)
        shift = 2 * rm_ids
        rm_state = (w0 >> shift) & 3  # [F, n]
        all_prepared = (1 << n) - 1
        tm_init = (w1 & 3) == TM_INIT  # [F, 1]
        tm_prepared_all = ((w1 >> 2) & all_prepared) == all_prepared
        msg_prepared = ((w1 >> (16 + rm_ids)) & 1) == 1  # [F, n]
        msg_commit = ((w1 >> 30) & 1) == 1
        msg_abort = ((w1 >> 31) & 1) == 1

        def set_rm(value: int) -> torch.Tensor:
            return (w0 & (MASK32 ^ (3 << shift))) | (value << shift)  # [F, n]

        # TmCommit / TmAbort (scalar slots).
        tmc_w1 = (w1 & (MASK32 ^ 3)) | TM_COMMITTED | (1 << 30)
        tma_w1 = (w1 & (MASK32 ^ 3)) | TM_ABORTED | (1 << 31)
        scalar_states = torch.stack(
            [torch.cat([w0, tmc_w1], 1), torch.cat([w0, tma_w1], 1)], 1
        )  # [F, 2, 2]
        scalar_valid = torch.cat([tm_init & tm_prepared_all, tm_init], 1)  # [F, 2]

        # Per-RM families, each [F, n] per word.
        w0b = w0.expand(-1, n)
        w1b = w1.expand(-1, n)
        rm_working = rm_state == WORKING
        families = [
            # TmRcvPrepared(rm): set the tm_prepared bit.
            (w0b, w1b | (1 << (2 + rm_ids)), tm_init & msg_prepared),
            # RmPrepare(rm): rm -> Prepared, add the Prepared{rm} message.
            (set_rm(PREPARED), w1b | (1 << (16 + rm_ids)), rm_working),
            # RmChooseToAbort(rm): rm -> Aborted.
            (set_rm(ABORTED), w1b, rm_working),
            # RmRcvCommitMsg(rm): rm -> Committed.
            (set_rm(COMMITTED), w1b, msg_commit.expand(-1, n)),
            # RmRcvAbortMsg(rm): rm -> Aborted.
            (set_rm(ABORTED), w1b, msg_abort.expand(-1, n)),
        ]
        per_rm_states = torch.stack(
            [torch.stack([a, b], -1) for a, b, _ in families], 2
        )  # [F, n, 5, 2]
        per_rm_valid = torch.stack([v for _, _, v in families], 2)  # [F, n, 5]
        f = words.shape[0]
        next_states = torch.cat([scalar_states, per_rm_states.reshape(f, 5 * n, 2)], 1)
        valid = torch.cat([scalar_valid, per_rm_valid.reshape(f, 5 * n)], 1)
        return next_states, valid

    def packed_properties(self, words: torch.Tensor) -> torch.Tensor:
        """Property predicates: ``[F, 2] -> [F, 3] bool``, ordered as
        :meth:`properties`."""
        n = self.rm_count
        rm_ids = torch.arange(n, device=words.device)
        rm_state = (words[:, 0:1] >> (2 * rm_ids)) & 3  # [F, n]
        all_aborted = (rm_state == ABORTED).all(1)
        all_committed = (rm_state == COMMITTED).all(1)
        consistent = ~((rm_state == ABORTED).any(1) & (rm_state == COMMITTED).any(1))
        return torch.stack([all_aborted, all_committed, consistent], 1)

    def packed_representative(self, words: torch.Tensor) -> torch.Tensor:
        """Canonical symmetry-class member of each packed state: ``[F, 2]
        -> [F, 2]``. Sorts the RM slots by rm_state (stable), carrying the
        tm_prepared and Prepared-message bits through the same permutation,
        the packed form of :meth:`TwoPhaseState.representative`. A partial
        canonicalization: the engine uses the full ``symmetry_spec`` when
        the model has one."""
        n = self.rm_count
        w0, w1 = words[:, 0:1], words[:, 1:2]
        rm_ids = torch.arange(n, device=words.device)
        rm_state = (w0 >> (2 * rm_ids)) & 3  # [F, n]
        order = torch.argsort(rm_state, dim=1, stable=True)
        sorted_rm = rm_state.gather(1, order)
        prepared_bits = (w1 >> (2 + order)) & 1
        msg_bits = (w1 >> (16 + order)) & 1
        new_w0 = (sorted_rm << (2 * rm_ids)).sum(1)
        new_w1 = (
            (w1[:, 0] & (0b11 | (1 << 30) | (1 << 31)))
            | (prepared_bits << (2 + rm_ids)).sum(1)
            | (msg_bits << (16 + rm_ids)).sum(1)
        )
        return torch.stack([new_w0, new_w1], 1)


def main(argv=None) -> None:
    """Command line in the manner of 2pc.rs:174-255. ``check`` runs the GPU
    engine (``spawn_xla``, on the card); ``check-host`` runs the host DFS and
    ``check-sym`` the host DFS with symmetry reduction (the object
    ``representative()``). ``explore`` waits for the Explorer (ROADMAP
    A10)."""
    import sys

    from ..report import WriteReporter

    args = list(sys.argv[1:] if argv is None else argv)
    cmd = args.pop(0) if args else None
    rm_count = int(args.pop(0)) if cmd and args else 2
    if cmd in ("check", "check-xla"):
        print(f"Checking two phase commit with {rm_count} resource managers on the GPU.")
        PackedTwoPhaseSys(rm_count).checker().spawn_xla().report(WriteReporter())
    elif cmd == "check-host":
        print(f"Checking two phase commit with {rm_count} resource managers.")
        TwoPhaseSys(rm_count).checker().spawn_dfs().report(WriteReporter())
    elif cmd == "check-sym":
        print(
            f"Checking two phase commit with {rm_count} resource managers "
            f"using symmetry reduction."
        )
        TwoPhaseSys(rm_count).checker().symmetry().spawn_dfs().report(WriteReporter())
    elif cmd == "explore":
        raise NotImplementedError("explore waits for the Explorer (ROADMAP A10)")
    else:
        print("USAGE:")
        print("  two-phase-commit check [RM_COUNT]        (GPU engine)")
        print("  two-phase-commit check-host [RM_COUNT]   (sequential host DFS)")
        print("  two-phase-commit check-sym [RM_COUNT]")
        print("  two-phase-commit check-xla [RM_COUNT]    (alias of check)")


if __name__ == "__main__":
    main()
