"""Enum-variant tuples: namedtuples whose Eq/Hash include the type.

The port's own copy of ``stateright_tpu/utils/variant.py``.

A Rust enum derives ``Hash``/``PartialEq`` over its *discriminant plus*
payload, so two variants with identical payloads are never equal (e.g. the
``PaxosMsg`` variants in the reference's ``examples/paxos.rs:65-88``).
Python ``NamedTuple`` compares as a bare tuple, so ``Accept(b, p) ==
Decided(b, p)`` would be ``True`` — silently merging distinct messages in
any set or map keyed by them.  The modeled ``Network`` is exactly such a
map, so this corrupts state-space exploration.

:func:`variant` returns a ``collections.namedtuple`` subclass whose
``__eq__``/``__hash__`` are tagged by the defining module and class name,
restoring Rust enum-variant semantics while keeping all namedtuple
conveniences (``_replace``, field access, unpacking, ordering).
"""

from __future__ import annotations

import sys
from collections import namedtuple


def variant(typename: str, field_names, *, module: str = None) -> type:
    """Create a namedtuple class with type-tagged equality and hashing.

    Cross-class structural comparison (``<``, ``>``) still behaves like
    plain tuples; only ``==``/``!=``/``hash`` are tagged.
    """
    if module is None:
        try:
            module = sys._getframe(1).f_globals.get("__name__", "__main__")
        except (AttributeError, ValueError):  # pragma: no cover
            module = "__main__"
    base = namedtuple(typename, field_names)
    tag = f"{module}.{typename}"

    def __eq__(self, other):
        if type(other) is type(self):
            return tuple.__eq__(self, other)
        if isinstance(other, tuple):
            return False  # block the structural tuple fallback
        return NotImplemented  # delegate to e.g. mock.ANY's __eq__

    def __ne__(self, other):
        eq = __eq__(self, other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self):
        return hash((tag, tuple.__hash__(self)))

    cls = type(
        typename,
        (base,),
        {
            "__slots__": (),
            "__eq__": __eq__,
            "__ne__": __ne__,
            "__hash__": __hash__,
            "_variant_tag": tag,
        },
    )
    cls.__module__ = module
    cls.__qualname__ = typename
    return cls
