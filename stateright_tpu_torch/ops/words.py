"""How the port carries 32-bit words: the one place that choice is made.

Counterpart of the ``uint32`` lanes of ``stateright_tpu`` (``ops/fphash.py``,
``ops/sortedset.py``, the packed models). ``torch.uint32`` has no ``>>``,
``+``, ``<``, ``searchsorted`` or ``max`` in the torch builds this port runs
on, so every packed state word, fingerprint half and parent half is a
``torch.int64`` holding a value in ``[0, 2**32)``:

- mask with :data:`MASK32` after every multiply, add and left shift (a
  wrapped int64 product keeps its low 32 bits, which is all ``fmix32``
  needs); right shifts of a non-negative value are logical already;
- order a ``(hi, lo)`` pair through :func:`fold_key`, which XORs the
  64-bit pair with ``1 << 63`` so that signed int64 order equals unsigned
  pair order, and the all-ones pad key folds to the int64 maximum and
  sorts last;
- the CUDA kernels take these lanes as ``const int64_t*`` and compare pairs
  as ``uint64_t``.
"""

from __future__ import annotations

import numpy as np
import torch

DTYPE = torch.int64
MASK32 = 0xFFFFFFFF
#: The reserved all-ones word: the sorted set's pad key half.
FULL = 0xFFFFFFFF
#: ``1 << 63`` as an int64: XOR with it maps unsigned order onto signed.
_SIGN = torch.iinfo(torch.int64).min
#: :func:`fold_key` of the all-ones pad pair.
PAD_KEY = torch.iinfo(torch.int64).max


def from_u32(a, device) -> torch.Tensor:
    """numpy (or anything array-like) of 32-bit words -> int64 tensor."""
    return torch.as_tensor(np.asarray(a, dtype=np.uint32).astype(np.int64), device=device)


def to_u32(t: torch.Tensor) -> np.ndarray:
    """int64 word tensor -> host ``uint32`` numpy array."""
    return t.detach().cpu().numpy().astype(np.uint32)


def fold_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The ``(hi, lo)`` pair as one int64 whose signed order is the pair's
    unsigned order."""
    return ((hi << 32) | lo) ^ _SIGN
