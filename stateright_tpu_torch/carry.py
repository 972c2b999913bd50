"""Carry a checkpoint's logical search state into the port's engine.

The part of ``stateright_tpu/xla.py`` ``_restore`` that builds engine state
from the arrays a checkpoint holds (``checkpoint.load_checkpoint``), written
by either package's engine. The logical state — the visited set as
compacted ``(fingerprint, parent)`` 32-bit lanes, the frontier rows with
their eventually-bits, and the counters of the meta — becomes the port's
visited set of the chosen structure (a file written under any structure
restores into any), frontier tensors and counters.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .ops import deltaset, hashset, sortedset
from .ops.words import from_u32


def state_from_checkpoint(
    arrays: Dict[str, np.ndarray], meta: Dict[str, Any], device, table_capacity: int,
    dedup: str = "sorted", max_probes: int = 32,
) -> Dict[str, Any]:
    """The port's search state from a checkpoint's ``arrays`` and ``meta``
    (``checkpoint.load_checkpoint``), its visited set in the structure
    ``dedup``. The set gets the smallest power-of-two capacity from
    ``table_capacity`` up with room for twice its rows, as the reference
    engine sizes a restored table: the sorted and delta sets are built
    sorted (``from_entries``), the hash set by inserting the rows in the
    file's order, doubled until none overflows."""
    n = len(arrays["key_hi"])
    cap = table_capacity
    while cap < 2 * n:
        cap *= 2
    rows = [arrays[k] for k in ("key_hi", "key_lo", "val_hi", "val_lo")]
    if dedup == "hash":
        table = hashset.from_entries(*rows, cap, device, max_probes)
    else:
        table = {"sorted": sortedset, "delta": deltaset}[dedup].from_entries(*rows, cap, device)
    rows = np.asarray(arrays["frontier"], dtype=np.uint32)
    return {
        "table": table,
        "frontier": from_u32(rows, device).reshape(rows.shape),
        "frontier_ebits": from_u32(arrays["frontier_ebits"], device),
        "depth": meta["depth"],
        "max_depth": meta["max_depth"],
        "state_count": meta["state_count"],
        "unique_count": meta["unique_count"],
        "found_names": {k: int(v) for k, v in meta["found_names"].items()},
        "exhausted": meta["exhausted"],
        "target_reached": meta["target_reached"],
    }
