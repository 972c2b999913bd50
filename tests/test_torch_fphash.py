"""The port's fingerprints (stateright_tpu_torch/ops/fphash.py) are bit-equal
to the reference package's (stateright_tpu/ops/fphash.py, run under numpy):
exact comparison, tolerance 0 (integer work)."""

import numpy as np
import pytest
import torch

from stateright_tpu.ops import fphash as ref
from stateright_tpu_torch.ops import fphash
from stateright_tpu_torch.ops.words import from_u32, to_u32

M32 = 0xFFFFFFFF


def _states(w: int, n: int = 512) -> np.ndarray:
    rng = np.random.default_rng(1000 + w)
    words = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    words[:8] = 0  # all-zero states
    words[8:16] = M32  # all-ones states
    return words


@pytest.mark.parametrize("w", range(1, 26))
def test_fingerprint_words_and_planes_match_reference(w):
    words = _states(w)
    want_hi, want_lo = ref.fingerprint_words(words, np)
    hi, lo = fphash.fingerprint_words(from_u32(words, "cpu"))
    assert np.array_equal(to_u32(hi), want_hi) and np.array_equal(to_u32(lo), want_lo)
    phi, plo = fphash.fingerprint_planes(from_u32(words.T.copy(), "cpu"))
    assert np.array_equal(to_u32(phi), want_hi) and np.array_equal(to_u32(plo), want_lo)


def _unxorshift(h: int, s: int) -> int:
    x = h
    for _ in range(32 // s + 1):
        x = h ^ (x >> s)
    return x & M32


def _fmix32_inv(h: int) -> int:
    """The input ``x`` with ``fmix32(x) == h`` (fmix32 is a bijection)."""
    h = _unxorshift(h, 16)
    h = (h * pow(ref._C2, -1, 2**32)) & M32
    h = _unxorshift(h, 13)
    h = (h * pow(ref._C1, -1, 2**32)) & M32
    return _unxorshift(h, 16)


def test_fmix32_inverse_helper_is_exact():
    rng = np.random.default_rng(7)
    xs = rng.integers(0, 2**32, 64, dtype=np.uint32)
    with np.errstate(over="ignore"):
        ys = ref._fmix32(xs, np)
    for x, y in zip(xs.tolist(), ys.tolist()):
        assert _fmix32_inv(y) == x


@pytest.mark.parametrize(
    "target",
    [(0, 0), (M32, M32), (0, 1), (M32, M32 - 1), (0, M32), (M32, 0), (12345, 678)],
)
def test_finalize_reserved_pair_remaps(target):
    """Folds built to land exactly on the reserved pairs (and beside them)
    are remapped identically: (0,0) -> (0,1), all-ones -> (.., 0xFFFFFFFE)."""
    fold_hi = _fmix32_inv(target[0]) ^ ref._SEED_HI
    fold_lo = _fmix32_inv(target[1]) ^ ref._SEED_LO
    want = ref._finalize(np.array([fold_hi], np.uint32), np.array([fold_lo], np.uint32), np)
    got = fphash._finalize(torch.tensor([fold_hi]), torch.tensor([fold_lo]))
    assert [int(g) for g in got] == [int(x[0]) for x in want]
    if target == (0, 0):
        assert [int(g) for g in got] == [0, 1]
    if target == (M32, M32):
        assert [int(g) for g in got] == [M32, M32 - 1]
