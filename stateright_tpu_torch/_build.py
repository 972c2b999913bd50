"""Shared libraries built at first use, keyed by a digest of their sources.

The port has two build paths, each loaded through ``ctypes``: the CUDA
kernels (``ops/_cuda.py``, ``nvcc``, into ``build/kernels/``) and the
native host kit (``native/``, ``g++``, into ``build/native/``). Both name a
library by a digest of every source it is built from, so an edited source
is rebuilt and a stale library is never loaded, and both build through
:func:`compile_all`. The JAX package has no counterpart of this module: its
host kit compares modification times, and its kernels were compiled by XLA.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import Callable, Iterable, List, Sequence, Tuple

#: The repository root's ``build/`` directory (in ``.gitignore``).
BUILD_ROOT = Path(__file__).resolve().parents[1] / "build"


def digest(sources: Iterable[Path]) -> str:
    """The first 12 hex digits of a SHA-256 over each source's name and
    bytes, in the order given."""
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:12]


def compile_all(jobs: Sequence[Tuple[str, Path, Callable[[Path], List[str]]]], tool: str) -> None:
    """Run one compiler command for each ``(name, out, command)`` of
    ``jobs``, all started together. ``command(tmp)`` is the command line that
    writes the library to ``tmp``, a name of this process beside ``out``;
    each finished library is moved onto ``out`` with ``os.replace``, which is
    atomic, so processes racing on one library each leave a whole file and
    no reader ever loads a partial one. Raises ``RuntimeError`` with each
    failed command's output."""
    procs = []
    for name, out, command in jobs:
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        procs.append((name, out, tmp, subprocess.Popen(
            command(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failures = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name} (rc={proc.returncode}):\n{log}")
    if failures:
        raise RuntimeError(f"{tool} failed for " + "\n".join(failures))
