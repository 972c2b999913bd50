"""Spec-compiled canonicalization on tensors, and its bit-exact host twin.

Counterpart of ``stateright_tpu/sym/kernel.py``. :func:`compile_canon`
turns a :class:`~stateright_tpu_torch.sym.spec.SymmetrySpec` into a
function ``canon(planes[W, N]) -> planes[W, N]`` over int64 tensors of
32-bit words (``ops/words.py``). It works plane-major, as the engine's
candidates are, so neither the candidate planes nor the frontier
(``frontier.T``) need a row gather. The engine applies it to the dedup key
only, right before fingerprinting; on a card it is captured inside the
level's CUDA graph. It is plain tensor code, not a kernel written by hand:
the reference's is jitted JAX code, not a Pallas kernel.

The reference sorts each group's blocks with a stable odd-even
transposition network that swaps on strict lexicographic greater-than over
the lanes, in declaration order. Here each block's lanes are packed into
one sort key, earlier lanes in the higher bits (a group wider than 63 bits
takes several keys, sorted least significant first with stable sorts), and
the blocks of every row sort by it in one call. The result is the
network's, bit for bit: the keys hold every bit of their block, so blocks
with equal keys are equal, and the order among equal blocks, the one thing
stability decides, cannot show in the output. A call is a few tensor
operations per lane and per key, not the network's ``count*(count-1)/2``
comparators. :func:`canonicalize_host` is the oracle.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ..ops.words import MASK32
from .spec import BlockGroup, Lane, SymmetrySpec, SymmetryUnsupported

#: The widest sort key: int64 tensors compare signed, so 63 bits.
KEY_BITS = 63


def _sort_keys(group: BlockGroup) -> List[List[Lane]]:
    """The group's lanes in declaration order, cut into runs of at most
    ``KEY_BITS`` bits: the sort keys, most significant first."""
    keys: List[List[Lane]] = [[]]
    bits = 0
    for lane in group.lanes:
        if bits + lane.bits > KEY_BITS:
            keys.append([])
            bits = 0
        keys[-1].append(lane)
        bits += lane.bits
    return keys


def _tables(spec: SymmetrySpec, store: dict, digest: str, device: torch.device, width: int) -> list:
    """Per group: the mask that keeps every bit outside the group's lanes,
    one ``[W, 1]`` entry per word, and per sort key its lanes as ``(lane,
    words [count], shifts [count, 1])``; made once into ``store``, keyed by
    the spec's hash ``digest``, the device and the width."""
    at = ("canon", digest, str(device), width)
    if at not in store:
        out = []
        for g in spec.groups:
            keep = [MASK32] * width
            keys = []
            for lanes in _sort_keys(g):
                entries = []
                for lane in lanes:
                    mask = (1 << lane.bits) - 1
                    for w, s in lane.positions:
                        keep[w] &= ~(mask << s) & MASK32
                    words = torch.tensor([w for w, _ in lane.positions], dtype=torch.long)
                    shifts = torch.tensor([[s] for _, s in lane.positions], dtype=torch.long)
                    entries.append((lane, words.to(device), shifts.to(device)))
                keys.append(entries)
            out.append((torch.tensor(keep, dtype=torch.long).to(device)[:, None], keys))
        store[at] = out
    return store[at]


def compile_canon(
    spec: SymmetrySpec, store: Optional[dict] = None
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The device canonicalization: ``canon(planes[W, N]) -> planes[W, N]``,
    a new tensor; ``planes`` may be a strided view (``rows.T``). Nothing in
    it waits on the host, so a CUDA graph can hold it, once a first call on
    the device has built its index tables. A graph holds the addresses of
    the tables it read, so they are kept in ``store``, which must outlive
    every graph that captures the call: the engine passes
    ``graphs.graph_inputs(model)``. By default they are the function's own."""
    digest = spec.spec_hash()
    store = {} if store is None else store

    def canon(planes: torch.Tensor) -> torch.Tensor:
        out = planes
        for keep, keys in _tables(spec, store, digest, planes.device, planes.shape[0]):
            # Extract: one [count, N] key per run of lanes.
            packed = []
            for entries in keys:
                key = None
                for lane, words, shifts in entries:
                    v = (out.index_select(0, words) >> shifts) & ((1 << lane.bits) - 1)
                    key = v if key is None else (key << lane.bits) | v
                packed.append(key)
            # Sort the blocks of every row, least significant key first,
            # carrying one permutation. The sorts after the first must be
            # stable; the first need not be, since blocks with equal keys
            # are equal (on the card, the unstable sort of a short row is a
            # bitonic one, the stable one a radix sort).
            perm = None
            for key in reversed(packed):
                k = key if perm is None else key.gather(0, perm)
                idx = torch.sort(k, dim=0, stable=perm is not None).indices
                perm = idx if perm is None else perm.gather(0, idx)
            # Reassemble: the group's bits cleared, the sorted lane values
            # added back (the lanes' bits are disjoint, so adding is OR).
            out = out & keep
            for key, entries in zip(packed, keys):
                key = key.gather(0, perm)
                for lane, words, shifts in reversed(entries):
                    v = key & ((1 << lane.bits) - 1)
                    key = key >> lane.bits
                    out.index_add_(0, words, v << shifts)
        return out

    return canon


def canonicalize_host(spec: SymmetrySpec, row: np.ndarray) -> np.ndarray:
    """Bit-exact numpy twin of :func:`compile_canon` for one packed row —
    the engine's host-side fingerprint path and the differential tests'
    oracle. A stable sort by the full block key tuple equals the strict
    greater-than adjacent-transposition network exactly."""
    out = np.array(row, dtype=np.uint32, copy=True)
    for g in spec.groups:
        n = g.count
        blocks = []
        for b in range(n):
            key = tuple(
                (int(out[w]) >> s) & ((1 << lane.bits) - 1)
                for lane in g.lanes
                for w, s in [lane.positions[b]]
            )
            blocks.append(key)
        order = sorted(range(n), key=lambda b: blocks[b])
        for li, lane in enumerate(g.lanes):
            lane_mask = (1 << lane.bits) - 1
            vals = [blocks[b][li] for b in range(n)]
            for new_b, old_b in enumerate(order):
                w, s = lane.positions[new_b]
                out[w] = np.uint32(
                    (int(out[w]) & ~(lane_mask << s)) | (vals[old_b] << s)
                )
    return out


def host_canonicalizer(spec: SymmetrySpec) -> Callable[[np.ndarray], np.ndarray]:
    """Partial application of :func:`canonicalize_host` (the form the
    engine stores next to the device canonicalization)."""

    def canon(row: np.ndarray) -> np.ndarray:
        return canonicalize_host(spec, row)

    return canon


def object_canonicalizer(model) -> Callable[[Any], Any]:
    """An OBJECT-state canonicalizer for the host search engines, derived
    from the model's spec through its own pack/unpack codec — the host
    symmetry oracle the device engine is differentially tested against:

        host = Model(...).checker().symmetry_fn(object_canonicalizer(m))

    explores exactly the classes ``spawn_xla`` + spec symmetry visits
    (class-invariant canon => traversal-order-independent counts)."""
    spec = getattr(model, "symmetry_spec", None)
    if spec is None:
        raise SymmetryUnsupported(
            "object_canonicalizer",
            f"{type(model).__name__} ships no symmetry_spec",
        )

    def canon(state):
        row = np.asarray(model.pack(state), dtype=np.uint32)
        return model.unpack(canonicalize_host(spec, row))

    return canon
