"""Build and bind the port's CUDA kernels.

The JAX package has no counterpart: its Pallas kernels were compiled by XLA
inside ``pallas_call``. Here each source ``csrc/<name>.cu`` is compiled by
``nvcc`` into ``build/kernels/lib<name>-<digest>.so`` at the repository
root, at first use, and bound with ``ctypes`` through a plain C interface.
The digest covers the sources, so an edited kernel is rebuilt and a stale
library is never loaded (``_build.py``, shared with the native host kit).

Nothing here touches CUDA when the module is imported: the CPU tests import
every module of the package on a machine with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import sys
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

if __name__ == "__main__":  # run as a script: the package is beside it
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from stateright_tpu_torch._build import BUILD_ROOT, compile_all, digest  # noqa: E402

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = BUILD_ROOT / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
#: Every kernel source of the package, by stem.
SOURCES = ("compact", "merge", "hashset")

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
#: (argtypes, restype) of each exported C function, by library.
_SIGNATURES = {
    "compact": {
        "stpu_compact": (
            [_P, _I64, _I64, ctypes.POINTER(ctypes.c_int64), _INT, _P, _I64, _P, _P, _P],
            _INT,
        ),
        "stpu_compact_status_words": ([_I64], _I64),
    },
    "merge": {
        "stpu_merge_insert": ([_P, _I64, _P, _I64] + [_P] * 5, _INT),
        "stpu_merge_status_words": ([_I64, _I64], _I64),
    },
    "hashset": {
        "stpu_hashset_insert": (
            [_P, _I64] + [_P] * 5 + [_I64, _INT] + [_P] * 7 + [_I64, _P],
            _INT,
        ),
        "stpu_hashset_undo": ([_P] * 3 + [_I64, _P], _INT),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built, keyed by a digest of
    that source and every header beside it."""
    return BUILD / f"lib{name}-{digest([CSRC / f'{name}.cu', *sorted(CSRC.glob('*.cuh'))])}.so"


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every library of ``names`` that is missing, one ``nvcc`` per
    source, all started together. Returns the seconds it took; raises with
    the compiler's output if any build fails."""
    t0 = time.monotonic()
    todo = [(n, library_path(n)) for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    compile_all([(f"{name}.cu", out, lambda tmp, name=name: [
        nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]) for name, out in todo], "nvcc")
    return time.monotonic() - t0


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        path = library_path(name)
        if not path.exists():
            build([name])
        so = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(so, fn).argtypes = argtypes
            getattr(so, fn).restype = restype
        so.stpu_error_string.argtypes = [_INT]
        so.stpu_error_string.restype = ctypes.c_char_p
        _loaded[name] = so
    return _loaded[name]


def check(so: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = so.stpu_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def count_launch(wrapper) -> None:
    """One launch by ``wrapper``: ``wrapper.launches`` counts launches that
    run now, ``wrapper.captured`` those recorded into a CUDA graph under
    capture, which run only when the graph is replayed (``graphs.py`` adds
    them to ``launches`` per replay)."""
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1


if __name__ == "__main__":
    # ``python stateright_tpu_torch/ops/_cuda.py build``: build every
    # missing library, the kernels' and the native host kit's (the checker
    # service's compile-on-admit step).
    if sys.argv[1:] != ["build"]:
        sys.exit("usage: _cuda.py build")
    from stateright_tpu_torch import native

    print(f"built in {build() + native.build():.1f}s", flush=True)
