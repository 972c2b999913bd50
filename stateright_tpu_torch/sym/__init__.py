"""Device symmetry reduction.

Counterpart of ``stateright_tpu/sym`` (the JAX package's
``docs/symmetry.md``). The host engines reduce symmetric state spaces
through object-level ``representative()`` methods (``checker/builder.py``
``symmetry()``, ``utils/rewrite_plan.py`` — stateright's
``representative.rs``/``rewrite_plan.rs``). This package is the packed
analogue: a declarative per-model :class:`SymmetrySpec` names the
role-symmetric process blocks in the packed word layout, and
:func:`compile_canon` compiles it into the canonicalization the engine
(``xla.py``) applies to the dedup key of every frontier row and every
candidate right before fingerprinting, inside the level's CUDA graph on a
card. Every lane of a block is in its sort key, so the canonical form is
class-invariant: reduced counts do not depend on the traversal order, and
equal the JAX package's.

Surface: ``spawn_xla(symmetry=)`` / ``STPU_SYMMETRY`` (see
:func:`resolve_symmetry`); paths that cannot honor an enabled symmetry
raise :class:`SymmetryUnsupported` instead of silently exploring the
full space.
"""

from .spec import BlockGroup, Lane, SymmetrySpec, SymmetryUnsupported
from .kernel import canonicalize_host, compile_canon, object_canonicalizer
from .resolve import resolve_symmetry

__all__ = [
    "BlockGroup",
    "Lane",
    "SymmetrySpec",
    "SymmetryUnsupported",
    "canonicalize_host",
    "compile_canon",
    "object_canonicalizer",
    "resolve_symmetry",
]
