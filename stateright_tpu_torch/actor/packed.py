"""Packed actor models: the actor framework on the GPU engine.

Counterpart of ``stateright_tpu/actor/packed.py``. An ``ActorModel`` runs
on the host engines because it implements ``Model`` (model.rs:200); on the
GPU engine it must also implement the packed protocol of
:class:`~stateright_tpu_torch.xla.XlaChecker`: a fixed-width bit-packed
transition function. The network packs either as one presence bit per
envelope of a closed universe (the natural codec of the unordered
duplicating network) or as a
:class:`~stateright_tpu_torch.packing.SlotMultiset` (the non-duplicating
multiset).

:class:`PackedPingPong` is the canonical fixture (actor_test_util.rs:4-126)
in packed form, held against the object ``ActorModel`` (4,094 states on
the lossy max=5 configuration, model.rs:680). The wrapper delegates the
object-level ``Model`` API to the ``ActorModel``, so paths and property
conditions see ordinary actor states; only the ``packed_*`` functions are
layout-declared.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from ..core import Model
from ..packing import LayoutBuilder
from . import Id
from .actor_test_util import Ping, PingPongCfg, Pong, ping_pong_model
from .model_state import ActorModelState
from .network import Envelope, UnorderedDuplicatingNetwork
from .timers import Timers


class PackedPingPong(Model):
    """The ping-pong ``ActorModel`` with a packed codec.

    The unordered duplicating network (the ``ActorModel`` default), lossy
    or lossless, with or without history. The envelope universe is closed
    — Ping(v)/Pong(v) for v in 0..max_nat (the boundary caps the actors'
    counts, so no larger value is sent) — so the network packs as one
    presence bit per envelope: under duplicating semantics a set of
    envelopes is a bitset (network.rs:51-52).
    """

    def __init__(self, cfg: PingPongCfg, lossy: bool = False):
        self.cfg = cfg
        self.lossy = lossy
        inner = ping_pong_model(cfg)
        if lossy:
            inner = inner.lossy_network(True)
        self._inner = inner
        self._V = cfg.max_nat + 1
        # Envelope codes: Ping(v) = 2v (actor 0 -> actor 1), Pong(v) = 2v+1
        # (actor 1 -> actor 0).
        count_bits = max(cfg.max_nat.bit_length() + 1, 1)
        self._layout = (
            LayoutBuilder()
            .uint("c0", count_bits)
            .uint("c1", count_bits)
            .uint("hin", 2 * count_bits)
            .uint("hout", 2 * count_bits)
            .array("net", 2 * self._V, 1)
            .finish()
        )
        self.state_words = self._layout.words
        # Action slots: deliver each envelope (and drop it, if lossy).
        self.max_actions = (2 if lossy else 1) * 2 * self._V

    # --- object-level Model API: the ActorModel's ---------------------------

    def init_states(self) -> List[ActorModelState]:
        return self._inner.init_states()

    def actions(self, state, actions: List[Any]) -> None:
        self._inner.actions(state, actions)

    def next_state(self, state, action):
        return self._inner.next_state(state, action)

    def properties(self):
        return self._inner.properties()

    def within_boundary(self, state) -> bool:
        return self._inner.within_boundary(state)

    def format_action(self, action) -> str:
        return self._inner.format_action(action)

    # --- codec -------------------------------------------------------------

    def _env_code(self, env: Envelope) -> int:
        if isinstance(env.msg, Ping):
            return 2 * env.msg.value
        return 2 * env.msg.value + 1

    def _code_env(self, code: int) -> Envelope:
        v, is_pong = divmod(code, 2)
        if is_pong:
            return Envelope(Id(1), Id(0), Pong(v))
        return Envelope(Id(0), Id(1), Ping(v))

    def pack(self, state: ActorModelState) -> np.ndarray:
        c0, c1 = state.actor_states
        hist_in, hist_out = state.history if state.history else (0, 0)
        net = [0] * (2 * self._V)
        for env in state.network.envelopes:
            net[self._env_code(env)] = 1
        return self._layout.pack(c0=c0, c1=c1, hin=hist_in, hout=hist_out, net=net)

    def unpack(self, words) -> ActorModelState:
        f = self._layout.unpack(words)
        envs = [self._code_env(c) for c, bit in enumerate(f["net"]) if bit]
        return ActorModelState(
            actor_states=(f["c0"], f["c1"]),
            network=UnorderedDuplicatingNetwork(frozenset(envs)),
            timers_set=(Timers(), Timers()),
            history=(f["hin"], f["hout"]) if self.cfg.maintains_history else (0, 0),
        )

    # --- batched transitions ------------------------------------------------

    def packed_init(self) -> np.ndarray:
        return np.stack([self.pack(s) for s in self._inner.init_states()])

    def packed_step(self, words: torch.Tensor):
        """Every state's action fan-out, ``words[F, W] -> (next[F, A, W],
        valid[F, A])``: deliver every envelope (a no-op delivery or a
        boundary violation is invalid: the packed form of model.rs:286-289
        and ``within_boundary``), and drop every envelope when lossy. Each
        slot is written in place, starting from a copy of the pre-state."""
        L = self._layout
        F, W = words.shape
        c0 = L.get(words, "c0")
        c1 = L.get(words, "c1")
        max_nat = self.cfg.max_nat
        nxt = words[:, None, :].expand(F, self.max_actions, W).clone()
        valid = torch.empty((F, self.max_actions), dtype=torch.bool, device=words.device)

        def bump_history(w):
            if self.cfg.maintains_history:
                L.set_(w, "hin", L.get(w, "hin") + 1)
                L.set_(w, "hout", L.get(w, "hout") + 1)

        for v in range(self._V):
            # Deliver Ping(v) to actor 1 (actor_test_util.rs on_msg): count
            # it and reply Pong(v). Duplicating network: the Ping stays.
            w = nxt[:, 2 * v]
            valid[:, 2 * v] = (L.get(words, "net", 2 * v) != 0) & (c1 == v) & (c1 + 1 <= max_nat)
            L.set_(w, "c1", c1 + 1)
            bump_history(w)
            L.set_(w, "net", 1, 2 * v + 1)  # send Pong(v)
            # Deliver Pong(v) to actor 0: count it and send Ping(v+1).
            w = nxt[:, 2 * v + 1]
            valid[:, 2 * v + 1] = (L.get(words, "net", 2 * v + 1) != 0) & (c0 == v) & (c0 + 1 <= max_nat)
            L.set_(w, "c0", c0 + 1)
            bump_history(w)
            if v + 1 < self._V:
                L.set_(w, "net", 1, 2 * (v + 1))  # send Ping(v+1)
        if self.lossy:
            for code in range(2 * self._V):
                slot = 2 * self._V + code
                valid[:, slot] = L.get(words, "net", code) != 0
                L.set_(nxt[:, slot], "net", 0, code)
        return nxt, valid

    def packed_properties(self, words: torch.Tensor) -> torch.Tensor:
        """``[F, 6]``: the fixture's six properties
        (actor_test_util.rs:68-124), in ``properties()`` order."""
        L = self._layout
        c0 = L.get(words, "c0")
        c1 = L.get(words, "c1")
        hist_in = L.get(words, "hin")
        hist_out = L.get(words, "hout")
        max_nat = self.cfg.max_nat
        at_max = (c0 == max_nat) | (c1 == max_nat)
        return torch.stack(
            [
                (c0 - c1).abs() <= 1,  # always "delta within 1"
                at_max,  # sometimes "can reach max"
                at_max,  # eventually "must reach max"
                (c0 == max_nat + 1) | (c1 == max_nat + 1),  # eventually "must exceed max"
                hist_in <= hist_out,  # always "#in <= #out"
                hist_out <= hist_in + 1,  # eventually "#out <= #in + 1"
            ],
            1,
        )

    def __getattr__(self, name):
        # Property conditions receive this wrapper as ``model``; expose the
        # ActorModel's attributes. Private names never delegate (that would
        # recurse while ``__dict__`` is empty, as during unpickling).
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._inner, name)
