"""Reader of the reference package's checkpoint files.

Counterpart of ``stateright_tpu/checkpoint.py`` in the one direction this
slice needs: a search stopped and saved by the JAX engine resumes in the
port (``spawn_xla(checkpoint=path)``). The file is the JAX package's
format 3 ``.npz``: a ``meta`` JSON document and six payload arrays
(``key_hi/key_lo/val_hi/val_lo`` of the visited set, ``frontier`` rows and
``frontier_ebits``) with a SHA-256 over them in the meta. The reader
checks the format, the digest, and that the file was written for this
model: class, configuration digest, ``state_words``, ``max_actions``,
property names, and no symmetry reduction (not ported yet).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Tuple

import numpy as np

FORMAT_VERSION = 3
#: Payload members, in digest order (the order is part of the format).
PAYLOAD_KEYS = ("key_hi", "key_lo", "val_hi", "val_lo", "frontier", "frontier_ebits")


def model_digest(model) -> str:
    """Digest of the model's configuration: its packed initial states."""
    rows = np.ascontiguousarray(np.asarray(model.packed_init(), dtype=np.uint32))
    h = hashlib.sha256()
    h.update(repr((rows.shape, model.state_words, model.max_actions)).encode())
    h.update(rows.tobytes())
    return h.hexdigest()[:16]


def payload_digest(arrays: Dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for key in PAYLOAD_KEYS:
        a = np.ascontiguousarray(arrays[key])
        h.update(key.encode())
        h.update(repr((a.shape, str(a.dtype))).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def load_reference_checkpoint(path: str, model) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """``(arrays, meta)`` of a checkpoint written for ``model``; raises
    ``ValueError`` on any mismatch."""
    if not path.endswith(".npz") and not os.path.isfile(path):
        path += ".npz"
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        arrays = {k: np.asarray(z[k]) for k in PAYLOAD_KEYS if k in z}
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint format {meta.get('format_version')}")
    if len(arrays) != len(PAYLOAD_KEYS) or meta.get("payload_sha256") != payload_digest(arrays):
        raise ValueError(f"{path}: payload missing or digest mismatch (torn or tampered)")
    want = {
        "model": type(model).__name__,
        "init_digest": model_digest(model),
        "state_words": model.state_words,
        "max_actions": model.max_actions,
        "property_names": [p.name for p in model.properties()],
        "symmetry": None,
    }
    problems = [f"{k} {meta.get(k)!r} != {v!r}" for k, v in want.items() if meta.get(k) != v]
    if problems:
        raise ValueError("checkpoint does not match this model: " + "; ".join(problems))
    return arrays, meta
