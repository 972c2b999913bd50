"""64-bit fingerprints of packed states, as two 32-bit lanes, on tensors.

Counterpart of ``stateright_tpu/ops/fphash.py`` and bit-equal to it: each
word is mixed with a position key through murmur3's ``fmix32``, the
per-word digests are XOR-folded across the width, and one final ``fmix32``
avalanches the fold. The pairs (0, 0) (the visited set's empty rows) and
all-ones (the sorted set's pad key) are reserved and remapped by
:func:`_finalize`.

Words and lanes follow ``ops/words.py``: int64 tensors holding 32-bit
values, masked after every multiply and add.
"""

from __future__ import annotations

import torch

from .words import MASK32

# fmix32 constants (murmur3 finalizer, public domain).
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
# Per-lane seeds and word multipliers (the reference package's constants).
_SEED_HI = 0x9E3779B9
_SEED_LO = 0x517CC1B7
_WORD_MIX_HI = 0x2545F491
_WORD_MIX_LO = 0x85157AF5
_POS_HI = 0x9E3779B9
_POS_LO = 0x61C88647


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = (h * _C1) & MASK32
    h = h ^ (h >> 13)
    h = (h * _C2) & MASK32
    return h ^ (h >> 16)


def _finalize(fold_hi: torch.Tensor, fold_lo: torch.Tensor):
    """Seeded avalanche over the per-word fold, then the reserved-pair
    remap: (0, 0) -> (0, 1) and (all-ones, all-ones) -> (all-ones,
    0xFFFFFFFE)."""
    hi = _fmix32(fold_hi ^ _SEED_HI)
    lo = _fmix32(fold_lo ^ _SEED_LO)
    lo = torch.where((hi == 0) & (lo == 0), 1, lo)
    lo = torch.where((hi == MASK32) & (lo == MASK32), MASK32 - 1, lo)
    return hi, lo


def _word_digests(word: torch.Tensor, i: int):
    """The position-keyed digests of word ``i`` (0-based) of every state."""
    pos_hi = (_POS_HI * (i + 1)) & MASK32
    pos_lo = (_POS_LO * (i + 1)) & MASK32
    m_hi = _fmix32((((word * _WORD_MIX_HI) & MASK32) + pos_hi) & MASK32)
    m_lo = _fmix32((((word * _WORD_MIX_LO) & MASK32) + pos_lo) & MASK32)
    return m_hi, m_lo


def fingerprint_planes(planes):
    """Fingerprint plane-major states: ``planes`` is a ``[W, ...]`` tensor
    (or a W-sequence of same-shape tensors), one plane per packed word.
    Returns the ``(hi, lo)`` lanes."""
    fold_hi = fold_lo = None
    for i in range(len(planes)):
        m_hi, m_lo = _word_digests(planes[i], i)
        fold_hi = m_hi if fold_hi is None else fold_hi ^ m_hi
        fold_lo = m_lo if fold_lo is None else fold_lo ^ m_lo
    return _finalize(fold_hi, fold_lo)


def fingerprint_words(words: torch.Tensor):
    """Fingerprint row-major states: ``[..., W] -> ([...], [...])``."""
    return fingerprint_planes(words.movedim(-1, 0))
