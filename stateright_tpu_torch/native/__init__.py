"""The port's native host kit: batch fingerprints and the parent map.

Counterpart of ``stateright_tpu/native/__init__.py``, with its surface:

- :func:`available`: whether the library is loaded;
- :func:`fingerprint_words`: the two-lane fingerprints of numpy ``[n, w]``
  uint32 rows, bit-equal to ``ops/fphash.py``;
- :func:`ParentMap`: fp64 -> parent fp64 over the visited set's occupied
  rows, with the whole parent chain of a discovery walked in one call
  (:class:`NativeParentMap`). The engines' ``_parent_map`` returns one
  (``xla.py``, ``parallel/sharded.py``).

The library is the port's own ``hostkit.cpp`` (the reference's C ABI),
built by ``g++ -O3 -shared -fPIC -std=c++17`` at first use into
``build/native/libhostkit-<digest>.so`` at the repository root and bound
with ``ctypes``; the checker service's workers build it before their first
dispatch (``service/worker.py``). It differs from the reference's module in
three ways:

- the library's name carries a digest of the source (``_build.py``, shared
  with the CUDA kernels), where the reference compares modification times;
- a compile that fails raises with the compiler's output, where the
  reference falls back quietly. Only a machine with no ``g++`` falls back to
  Python: :class:`SortedParentMap` (the rows sorted by key, one
  ``searchsorted`` a link) and ``ops/fphash.fingerprint_words`` on CPU
  tensors;
- an allocation that fails in the library raises ``MemoryError``, where the
  reference falls back to a dict.

Tests force the fallback as the reference's do, by replacing ``_load``.
"""

from __future__ import annotations

import ctypes
import shutil
import threading
import time
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

from .._build import BUILD_ROOT, compile_all, digest

SRC = Path(__file__).resolve().parent / "hostkit.cpp"
BUILD = BUILD_ROOT / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_U32P = ctypes.POINTER(ctypes.c_uint32)
_U64P = ctypes.POINTER(ctypes.c_uint64)
#: (argtypes, restype) of each exported C function.
_SIGNATURES = {
    "fingerprint_words": ([_U32P, ctypes.c_int64, ctypes.c_int64, _U32P, _U32P], None),
    "parentmap_build": ([_U32P] * 4 + [ctypes.c_int64], ctypes.c_void_p),
    "parentmap_free": ([ctypes.c_void_p], None),
    "parentmap_count": ([ctypes.c_void_p], ctypes.c_int64),
    "parentmap_get": ([ctypes.c_void_p, ctypes.c_uint64, _U64P], ctypes.c_int),
    "parentmap_chain": ([ctypes.c_void_p, ctypes.c_uint64, _U64P, ctypes.c_int64],
                        ctypes.c_int64),
}


def library_path(src: Path = SRC, build_dir: Path = BUILD) -> Path:
    """Where the library of ``src`` is built, keyed by a digest of it."""
    return build_dir / f"libhostkit-{digest([src])}.so"


def build(src: Path = SRC, build_dir: Path = BUILD) -> float:
    """Compile the library of ``src`` unless it is built, or there is no
    ``g++`` (then the package falls back to Python). Returns the seconds it
    took; raises with the compiler's output if the compile fails."""
    out = library_path(src, build_dir)
    gxx = shutil.which("g++")
    if out.exists() or gxx is None:
        return 0.0
    t0 = time.monotonic()
    compile_all([(src.name, out, lambda tmp: [gxx, *CXX_FLAGS, "-o", str(tmp), str(src)])], "g++")
    return time.monotonic() - t0


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None on a machine with no
    ``g++`` and no library built."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            path = library_path()
            if not path.exists():
                return None
            lib = ctypes.CDLL(str(path))
            for fn, (argtypes, restype) in _SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _u32ptr(a: np.ndarray):
    return a.ctypes.data_as(_U32P)


def fingerprint_words(words: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The fingerprints ``(hi, lo)`` (uint32 ``[n]`` each) of ``[n, w]``
    uint32 rows, as ``ops/fphash.fingerprint_words`` computes them."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    if words.ndim != 2:
        raise ValueError(f"expected [n, w] words, got shape {words.shape}")
    lib = _load()
    if lib is None:
        from ..ops import fphash
        from ..ops.words import from_u32

        hi, lo = fphash.fingerprint_words(from_u32(words, "cpu"))
        return hi.numpy().astype(np.uint32), lo.numpy().astype(np.uint32)
    n, w = words.shape
    out_hi = np.empty(n, dtype=np.uint32)
    out_lo = np.empty(n, dtype=np.uint32)
    lib.fingerprint_words(_u32ptr(words), n, w, _u32ptr(out_hi), _u32ptr(out_lo))
    return out_hi, out_lo


def _missing(fp64: int) -> KeyError:
    return KeyError(f"fingerprint {fp64:#x} missing from the visited table")


class _Lookup:
    """``in`` and ``[]`` over a map's ``get``."""

    def get(self, fp64: int) -> Optional[int]:
        raise NotImplementedError

    def __contains__(self, fp64: int) -> bool:
        return self.get(fp64) is not None

    def __getitem__(self, fp64: int) -> int:
        value = self.get(fp64)
        if value is None:
            raise KeyError(fp64)
        return value


def _planes(key_hi, key_lo, val_hi, val_lo) -> List[np.ndarray]:
    """The four row planes as contiguous uint32 ``[n]`` arrays."""
    planes = [np.ascontiguousarray(a, dtype=np.uint32) for a in (key_hi, key_lo, val_hi, val_lo)]
    if any(a.shape != (len(planes[0]),) for a in planes):
        raise ValueError(f"expected four [n] planes, got {[a.shape for a in planes]}")
    return planes


class SortedParentMap(_Lookup):
    """The fallback: the occupied rows as 64-bit keys sorted ascending with
    their parents, one ``searchsorted`` a lookup. Rows that come sorted (the
    sorted set's) are not sorted again. As the native map, ``len`` counts
    the occupied rows and a key given twice maps to its last row's parent."""

    #: Whether the library's index holds the rows.
    native = False

    def __init__(self, key_hi, key_lo, val_hi, val_lo):
        kh, kl, vh, vl = (a.astype(np.uint64) for a in _planes(key_hi, key_lo, val_hi, val_lo))
        keys = (kh << np.uint64(32)) | kl
        vals = (vh << np.uint64(32)) | vl
        occ = keys != 0
        keys, vals = keys[occ], vals[occ]
        if not bool(np.all(keys[1:] > keys[:-1])):
            order = np.argsort(keys, kind="stable")
            keys, vals = keys[order], vals[order]
        self._keys, self._vals = keys, vals

    def __len__(self) -> int:
        return len(self._keys)

    def get(self, fp64: int) -> Optional[int]:
        i = int(np.searchsorted(self._keys, np.uint64(fp64), side="right")) - 1
        if i >= 0 and int(self._keys[i]) == fp64:
            return int(self._vals[i])
        return None

    def chain(self, fp64: int, max_len: int = 1 << 24) -> List[int]:
        chain = []
        cur = fp64
        while cur != 0:
            if len(chain) >= max_len:
                raise RuntimeError("parent chain exceeds max_len")
            parent = self.get(cur)
            if parent is None:
                raise _missing(cur)
            chain.append(cur)
            cur = parent
        return chain


class NativeParentMap(_Lookup):
    """The library's open-addressing index of the rows."""

    native = True

    def __init__(self, lib: ctypes.CDLL, key_hi, key_lo, val_hi, val_lo):
        planes = _planes(key_hi, key_lo, val_hi, val_lo)
        self._lib = lib
        self._handle = lib.parentmap_build(*(_u32ptr(a) for a in planes), len(planes[0]))
        if not self._handle:
            raise MemoryError(f"the native parent map of {len(planes[0])} rows")

    def __len__(self) -> int:
        return int(self._lib.parentmap_count(self._handle))

    def get(self, fp64: int) -> Optional[int]:
        out = ctypes.c_uint64()
        hit = self._lib.parentmap_get(self._handle, ctypes.c_uint64(fp64), ctypes.byref(out))
        return int(out.value) if hit else None

    def chain(self, fp64: int, max_len: int = 1 << 24) -> List[int]:
        """The parent chain ``[fp64, ..., init fp]``. Raises ``KeyError`` if
        a link is missing (the host and device codecs disagree) and
        ``RuntimeError`` if the chain is longer than ``max_len`` (a
        cycle)."""
        # A buffer grown 8x at a time: chains are as long as the search is
        # deep, so the first nearly always holds them.
        size = min(1024, max_len)
        while True:
            out = np.empty(size, dtype=np.uint64)
            n = self._lib.parentmap_chain(self._handle, ctypes.c_uint64(fp64),
                                          out.ctypes.data_as(_U64P), size)
            if n == -1:
                raise _missing(self._missing_link(fp64))
            if n == -2:
                if size >= max_len:
                    raise RuntimeError("parent chain exceeds max_len")
                size = min(size * 8, max_len)
                continue
            return out[:n].tolist()

    def _missing_link(self, fp64: int) -> int:
        """The first fingerprint of ``fp64``'s chain that the map lacks."""
        cur = fp64
        while True:
            parent = self.get(cur)
            if parent is None:
                return cur
            cur = parent

    def __del__(self):  # pragma: no cover - interpreter teardown
        if getattr(self, "_handle", None):
            try:
                self._lib.parentmap_free(self._handle)
            except Exception:
                pass


#: Either parent map; ``.native`` says which.
AnyParentMap = Union[NativeParentMap, SortedParentMap]


def ParentMap(key_hi, key_lo, val_hi, val_lo) -> AnyParentMap:
    """fp64 -> parent fp64 over visited-set rows: the library's index
    (:class:`NativeParentMap`), or :class:`SortedParentMap` on a machine with
    no ``g++``. The rows are ``key_hi/key_lo/val_hi/val_lo`` uint32 arrays;
    rows whose key is (0, 0) are empty and skipped."""
    lib = _load()
    if lib is None:
        return SortedParentMap(key_hi, key_lo, val_hi, val_lo)
    return NativeParentMap(lib, key_hi, key_lo, val_hi, val_lo)
