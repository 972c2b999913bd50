"""Stable 64-bit fingerprinting of model states.

The port's own copy of ``stateright_tpu/fingerprint.py``.

stateright derives a ``NonZeroU64`` fingerprint from every state with a
*fixed-key* hasher so that hashes are stable across builds and runs
(``src/lib.rs:327-336, 356-369``); container types hash order-insensitively
by sorting per-element digests (``src/util.rs:134-156``).  Stability matters
because paths are reconstructed from fingerprints after the fact, and tests
assert exact counts.

This module provides the same guarantees for Python values with a splitmix64-
style mixer (public-domain finalizer constants).  Packed states use the
32-bit-lane construction of ``stateright_tpu_torch/ops/fphash.py`` instead.
"""

from __future__ import annotations

import dataclasses
import struct
from enum import Enum
from typing import Any

MASK64 = (1 << 64) - 1

# splitmix64 finalizer constants (public domain, Sebastiano Vigna).
_SM1 = 0xBF58476D1CE4E5B9
_SM2 = 0x94D049BB133111EB
# Fixed keys playing the role of the reference's fixed ahash keys
# (lib.rs:359-360): any constants work; stability is what matters.
_SEED = 0x517CC1B727220A95

# Type tags so that values of different types never collide structurally.
_T_NONE = 0x01
_T_BOOL = 0x02
_T_INT = 0x03
_T_FLOAT = 0x04
_T_STR = 0x05
_T_BYTES = 0x06
_T_TUPLE = 0x07
_T_LIST = 0x08
_T_SET = 0x09
_T_DICT = 0x0A
_T_DATACLASS = 0x0B
_T_ENUM = 0x0C
_T_CUSTOM = 0x0D


def _type_tag(t: type) -> str:
    """Module-qualified class tag: two same-named classes in different
    modules (e.g. the two adapter ``ClientState``s) must not collide."""
    return f"{t.__module__}.{t.__qualname__}"


def _mix(h: int) -> int:
    """splitmix64 finalizer: bijective 64-bit mixer."""
    h &= MASK64
    h ^= h >> 30
    h = (h * _SM1) & MASK64
    h ^= h >> 27
    h = (h * _SM2) & MASK64
    h ^= h >> 31
    return h


def _fold(acc: int, word: int) -> int:
    return _mix((acc ^ (word & MASK64)) * 0x9E3779B97F4A7C15)


def _hash_bytes(acc: int, data: bytes) -> int:
    for i in range(0, len(data), 8):
        chunk = data[i : i + 8]
        acc = _fold(acc, int.from_bytes(chunk, "little"))
    return _fold(acc, len(data))


def _digest(value: Any, acc: int) -> int:
    """Fold ``value`` into accumulator ``acc`` deterministically."""
    if value is None:
        return _fold(acc, _T_NONE)
    if value is True or value is False:
        return _fold(_fold(acc, _T_BOOL), int(value))
    t = type(value)
    if t is int:
        acc = _fold(acc, _T_INT)
        if -0x8000_0000_0000_0000 <= value < 0x8000_0000_0000_0000:
            # Two's-complement fold: injective over the 64-bit range.
            return _fold(acc, value & MASK64)
        # Arbitrary-precision ints: fold the full signed magnitude so values
        # that agree mod 2^64 don't collide.
        data = value.to_bytes((value.bit_length() + 8) // 8, "little", signed=True)
        return _hash_bytes(acc, data)
    if t is float:
        return _fold(_fold(acc, _T_FLOAT), int.from_bytes(struct.pack("<d", value), "little"))
    if t is str:
        return _hash_bytes(_fold(acc, _T_STR), value.encode("utf-8"))
    if t is bytes:
        return _hash_bytes(_fold(acc, _T_BYTES), value)
    if isinstance(value, tuple) and not hasattr(value, "__fingerprint_key__"):
        # Tuple subclasses (NamedTuples) are tagged with the class name so
        # e.g. Ping(0) and Pong(0) fingerprint differently, like Rust enum
        # variants hashing their discriminant. A __fingerprint_key__ hook
        # takes precedence (handled below).
        acc = _fold(acc, _T_TUPLE)
        if t is not tuple:
            acc = _hash_bytes(acc, _type_tag(t).encode("utf-8"))
        for item in value:
            acc = _digest(item, acc)
        return _fold(acc, len(value))
    if t is list:
        acc = _fold(acc, _T_LIST)
        for item in value:
            acc = _digest(item, acc)
        return _fold(acc, len(value))
    if t in (set, frozenset):
        # Order-insensitive: sort element digests, like the reference's
        # HashableHashSet (util.rs:134-156).
        acc = _fold(acc, _T_SET)
        for d in sorted(_digest(item, _SEED) for item in value):
            acc = _fold(acc, d)
        return _fold(acc, len(value))
    if t is dict:
        acc = _fold(acc, _T_DICT)
        for d in sorted(_digest((k, v), _SEED) for k, v in value.items()):
            acc = _fold(acc, d)
        return _fold(acc, len(value))
    if isinstance(value, Enum):
        acc = _fold(acc, _T_ENUM)
        acc = _hash_bytes(acc, _type_tag(t).encode("utf-8"))
        return _digest(value.value, acc)
    custom = getattr(value, "__fingerprint_key__", None)
    if custom is not None:
        acc = _fold(acc, _T_CUSTOM)
        acc = _hash_bytes(acc, _type_tag(type(value)).encode("utf-8"))
        return _digest(custom(), acc)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        acc = _fold(acc, _T_DATACLASS)
        acc = _hash_bytes(acc, _type_tag(type(value)).encode("utf-8"))
        for f in dataclasses.fields(value):
            acc = _digest(getattr(value, f.name), acc)
        return acc
    if isinstance(value, int):  # bare int subclasses (exact ints returned above)
        return _fold(_fold(acc, _T_INT), int(value))
    raise TypeError(
        f"Cannot fingerprint value of type {t.__qualname__}: define a "
        f"__fingerprint_key__() method returning a canonical hashable value."
    )


def fingerprint(value: Any) -> int:
    """Convert a state to a nonzero 64-bit fingerprint.

    Mirrors ``fingerprint()`` in the reference (lib.rs:332): fixed-seed,
    stable across runs.  A zero digest is mapped to a fixed nonzero value
    (the reference panics instead; zero here is a 2^-64 event).
    """
    digest = _digest(value, _SEED)
    return digest if digest != 0 else 0x1D1AD

stable_mix = _mix
stable_fold = _fold
