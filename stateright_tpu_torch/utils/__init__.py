"""Utility containers (counterpart of ``stateright_tpu/utils``): rewrite
plans for symmetry reduction, dense maps, vector clocks and
:func:`variant` (stateright's ``src/util.rs``).

The reference's ``HashableHashSet``/``HashableHashMap`` (order-insensitive
stable hashing, util.rs:73-366) have no separate classes here: plain
``frozenset``/``dict`` values already fingerprint order-insensitively via
``stateright_tpu_torch.fingerprint``.
"""

from .densenatmap import DenseNatMap
from .rewrite_plan import RewritePlan, rewrite
from .variant import variant
from .vector_clock import VectorClock

__all__ = ["DenseNatMap", "RewritePlan", "VectorClock", "rewrite", "variant"]
