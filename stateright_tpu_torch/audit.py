"""Host-side integrity audit of the GPU engine's visited set.

Counterpart of ``stateright_tpu/audit.py``. Exact state counts are this
checker's correctness contract, so a count that drifts on one device must
be attributable. The audit answers the sharpest question: **does the
visited set hold the same fingerprint twice?** A duplicate entry means the
device insert admitted a key that was already present (each admission adds
to ``unique_count`` and expands the state again): the signature of a
faulty insert, such as a hash insert on atomics that lets two threads
claim one key, rather than of a nondeterministic model.

The audit runs on the HOST in numpy over a copy of the table's key planes:
an audit computed by the suspect device program would prove nothing.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .ops.words import to_u32


def audit_table(checker) -> Dict[str, Any]:
    """Pulls the checker's visited-set key planes (``key_hi``/``key_lo``,
    which every structure exposes: the sorted set's planes, the hash set's
    slots, the delta set's concatenated tiers) and cross-checks them
    against the committed ``unique_state_count()``. Returns::

        {
          "entries":        occupied slots across all planes,
          "distinct_keys":  distinct 64-bit fingerprints among them,
          "duplicate_keys": entries - distinct_keys  (MUST be 0),
          "unique_count":   the checker's committed unique_state_count(),
          "ok":             duplicate_keys == 0 and entries == unique_count,
        }

    ``entries != unique_count`` with no duplicates would instead show lost
    entries (a growth or rehash dropping keys) or a counter fault: another
    failure, also caught here."""
    table = checker._table
    keys = (to_u32(table.key_hi).astype(np.uint64) << np.uint64(32)) | to_u32(table.key_lo)
    live = keys[keys != 0]  # EMPTY is (0, 0); fphash never emits it
    entries = int(live.size)
    distinct = int(np.unique(live).size)
    unique = int(checker.unique_state_count())
    return {
        "entries": entries,
        "distinct_keys": distinct,
        "duplicate_keys": entries - distinct,
        "unique_count": unique,
        "ok": entries == distinct == unique,
    }
