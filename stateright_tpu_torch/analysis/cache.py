"""Content-hash-keyed per-surface result cache for the lint sweep.

Counterpart of ``stateright_tpu/analysis/cache.py``. The sweep's cost is
tracing, a pure function of the package source and of the installed torch.
One :func:`tree_hash` over every ``.py``, ``.cu`` and ``.cuh`` file of
``stateright_tpu_torch/`` plus ``torch.__version__`` keys the whole cache:
any source edit invalidates everything, and repeat runs on an unchanged tree
(the service's admission checks, say) replay findings from disk. The same
hash is the ``tree`` label of the ``stpu_build_info`` gauge
(``obs/promexport.py``), so a scrape and a lint verdict name one tree. The
waiver file is not in the hash: waivers apply after the sweep, to raw
findings.

Entries live under ``runs/torch_lint_cache/<tree12>/<slug>.json``
(``runs/`` is gitignored), beside and apart from the JAX package's
``runs/lint_cache/``, so neither package's pruning evicts the other's
entries. Growth is bounded to the newest ``KEEP_TREES`` tree dirs (by
mtime), pruned at start-up and on write. Surfaces that errored or skipped are never cached (an environment
verdict is not a tree verdict), and neither are the CUDA surfaces: their
verdict is the compiler's, which the tree hash does not cover
(``surfaces.py``).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import List, Optional

from .rules import Finding

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
DEFAULT_CACHE_DIR = os.path.join(_REPO, "runs", "torch_lint_cache")

#: Newest tree dirs retained.
KEEP_TREES = 4

#: The package's source files, by suffix.
SOURCE_SUFFIXES = (".py", ".cu", ".cuh")

_tree_hash_memo: Optional[str] = None


def tree_hash(root: str = _PKG) -> str:
    """sha256 over ``torch.__version__`` and every package source file
    (path and content), memoized per process: the key under which cached
    surface results are valid."""
    global _tree_hash_memo
    if _tree_hash_memo is not None and root == _PKG:
        return _tree_hash_memo
    import torch

    h = hashlib.sha256()
    # A traced graph is a function of the installed torch too: an upgrade
    # must invalidate cached verdicts.
    h.update(torch.__version__.encode())
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if not fn.endswith(SOURCE_SUFFIXES):
                continue
            p = os.path.join(dirpath, fn)
            h.update(os.path.relpath(p, root).encode())
            with open(p, "rb") as fh:
                h.update(fh.read())
    digest = h.hexdigest()
    if root == _PKG:
        _tree_hash_memo = digest
    return digest


def _slug(surface: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]+", "_", surface)


class SurfaceCache:
    """get/put of raw (pre-waiver) surface findings under one tree hash,
    bounded to the newest :data:`KEEP_TREES` tree dirs."""

    def __init__(self, cache_dir: Optional[str] = None):
        self.root = cache_dir or DEFAULT_CACHE_DIR
        self.tree = tree_hash()[:12]
        self.dir = os.path.join(self.root, self.tree)
        # Prune at start-up too, not just on write: a lint run on an
        # unchanged tree (all hits, no puts) must still bound the cache.
        self._prune()

    def _prune(self) -> None:
        """Delete all but the newest :data:`KEEP_TREES` tree dirs (by mtime;
        the current tree always counts as newest: a warm hit must never
        prune the entries it is about to read)."""
        try:
            others = sorted(
                (
                    d for d in os.listdir(self.root)
                    if d != self.tree and os.path.isdir(os.path.join(self.root, d))
                ),
                key=lambda d: os.path.getmtime(os.path.join(self.root, d)),
                reverse=True,
            )
        except OSError:  # no cache dir yet
            return
        for d in others[KEEP_TREES - 1:]:
            shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)

    def get(self, surface: str) -> Optional[List[Finding]]:
        path = os.path.join(self.dir, _slug(surface) + ".json")
        try:
            with open(path) as fh:
                rows = json.load(fh)["findings"]
        except (OSError, json.JSONDecodeError, KeyError):
            return None
        try:
            return [
                Finding(**{k: r[k] for k in (
                    "rule", "surface", "file", "line", "message", "excerpt"
                )})
                for r in rows
            ]
        except (KeyError, TypeError):
            return None

    def put(self, surface: str, findings: List[Finding]) -> None:
        try:
            os.makedirs(self.dir, exist_ok=True)
        except OSError:  # the cache is best-effort
            return
        payload = {
            "findings": [
                {k: v for k, v in f.to_json().items()
                 if k not in ("waived", "waiver_reason")}
                for f in findings
            ]
        }
        tmp = os.path.join(self.dir, _slug(surface) + f".json.tmp{os.getpid()}")
        try:
            with open(tmp, "w") as fh:
                json.dump(payload, fh)
            os.replace(tmp, os.path.join(self.dir, _slug(surface) + ".json"))
        except OSError:  # the cache is best-effort
            pass
