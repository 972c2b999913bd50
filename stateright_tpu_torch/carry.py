"""Carry the reference package's logical search state into the port.

No module of ``stateright_tpu`` has this job: its engines restore their own
checkpoints (``stateright_tpu/xla.py`` ``_restore``, from the arrays that
``stateright_tpu/checkpoint.py`` writes). Here the same logical state — the
visited set as compacted ``(fingerprint, parent)`` 32-bit lanes, the
frontier rows with their eventually-bits, and the counters of the meta —
becomes the port's ``SortedSet``, frontier tensors and counters.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .ops import sortedset
from .ops.words import from_u32


def state_from_reference(
    arrays: Dict[str, np.ndarray], meta: Dict[str, Any], device, table_capacity: int
) -> Dict[str, Any]:
    """The port's search state from a checkpoint's ``arrays`` and ``meta``
    (``checkpoint.load_reference_checkpoint``). The visited set gets the
    smallest power-of-two capacity from ``table_capacity`` up with room for
    twice its rows, as the reference engine sizes a restored table."""
    n = len(arrays["key_hi"])
    cap = table_capacity
    while cap < 2 * n:
        cap *= 2
    table = sortedset.from_entries(
        arrays["key_hi"], arrays["key_lo"], arrays["val_hi"], arrays["val_lo"], cap, device
    )
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
