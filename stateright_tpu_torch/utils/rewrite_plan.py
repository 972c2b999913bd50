"""Symmetry-reduction rewrite plans.

The port's own copy of ``stateright_tpu/utils/rewrite_plan.py``
(stateright's ``src/checker/rewrite_plan.rs`` and ``rewrite.rs``): a
:class:`RewritePlan` is a permutation derived by (stably) sorting values;
``reindex`` permutes index-keyed collections and :func:`rewrite` recursively
remaps :class:`~stateright_tpu_torch.actor.Id` values inside arbitrary
structures.

The reference implements ``Rewrite`` as a trait with blanket impls
(rewrite.rs:24-163); here one generic function dispatches structurally, and
classes may define ``__rewrite__(plan)`` for custom behavior.

Values with no total order sort by their stable fingerprint. The port's
object fingerprints carry the class's module (``fingerprint.py``), so on
such values the port may pick another orbit member than the JAX package.
"""

from __future__ import annotations

from typing import Any, List, Sequence

from ..fingerprint import fingerprint
from .densenatmap import DenseNatMap


class RewritePlan:
    """A permutation plan: ``order[new_index] = old_index``.

    The inverse mapping lives in a :class:`DenseNatMap` keyed by old index —
    the same dense-natural-key container the reference's ``RewritePlan``
    is built on (rewrite_plan.rs:19, densenatmap.rs:75)."""

    def __init__(self, order: Sequence[int]):
        self.order = list(order)
        # Inverse: new index of each old index.
        inverse = [0] * len(self.order)
        for new, old in enumerate(self.order):
            inverse[old] = new
        self.new_of_old = DenseNatMap(inverse)

    @staticmethod
    def from_values_to_sort(values: Sequence[Any]) -> "RewritePlan":
        """Plan that would stably sort ``values`` ascending
        (rewrite_plan.rs:81-106).  Values without a total order fall back to
        sorting by stable fingerprint (deterministic across runs)."""
        idx = range(len(values))
        try:
            order = sorted(idx, key=lambda i: values[i])
        except TypeError:
            order = sorted(idx, key=lambda i: fingerprint(values[i]))
        return RewritePlan(order)

    def rewrite_id(self, id_value: int):
        """The new index of old index ``id_value`` (rewrite_plan.rs:110)."""
        from ..actor import Id

        return Id(self.new_of_old[int(id_value)])

    def reindex(self, collection: Sequence[Any]) -> List[Any]:
        """Permutes an index-keyed collection AND rewrites each element
        (rewrite_plan.rs:118-123 rewrites every element as it permutes —
        element values may themselves embed Ids that must be remapped)."""
        return [rewrite(collection[old], self) for old in self.order]


def rewrite(value: Any, plan: RewritePlan) -> Any:
    """Recursively remaps :class:`Id` values inside ``value``
    (the generic analogue of rewrite.rs's blanket impls: no-op for scalars,
    structural recursion for containers, ``__rewrite__`` for custom types).
    Unknown structured types raise rather than silently passing through —
    a missed Id remap would make symmetry reduction unsound — and the
    error NAMES THE PATH to the offending value (``state.msgs[2].src``),
    not just its type, so a model author can find the field to fix."""
    return _rewrite(value, plan, "state")


def _rewrite(value: Any, plan: RewritePlan, path: str) -> Any:
    import dataclasses
    from enum import Enum

    from ..actor import Id
    from ..actor.network import Envelope

    if isinstance(value, Id):
        return plan.rewrite_id(value)
    custom = getattr(value, "__rewrite__", None)
    if custom is not None:
        return custom(plan)
    if isinstance(value, Envelope):
        return Envelope(
            _rewrite(value.src, plan, f"{path}.src"),
            _rewrite(value.dst, plan, f"{path}.dst"),
            _rewrite(value.msg, plan, f"{path}.msg"),
        )
    t = type(value)
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return t(*(
            _rewrite(v, plan, f"{path}.{name}")
            for name, v in zip(value._fields, value)
        ))
    if t is tuple:
        return tuple(
            _rewrite(v, plan, f"{path}[{i}]") for i, v in enumerate(value)
        )
    if t is list:
        return [_rewrite(v, plan, f"{path}[{i}]") for i, v in enumerate(value)]
    if t in (set, frozenset):
        return t(_rewrite(v, plan, f"{path}{{…}}") for v in value)
    if isinstance(value, DenseNatMap):
        # Index-keyed by construction (actor/process ids): the plan
        # permutes the ENTRIES too, not just embedded Ids — the
        # reference's Rewrite impl reindexes (rewrite.rs:137-147).
        return DenseNatMap(
            [
                _rewrite(value[old], plan, f"{path}[{old}]")
                for old in plan.order
            ]
        )
    if isinstance(value, dict):
        out = {
            _rewrite(k, plan, f"{path}[key {k!r}]"):
                _rewrite(v, plan, f"{path}[{k!r}]")
            for k, v in value.items()
        }
        # dict subclasses (OrderedDict, defaultdict, Counter) rebuild as
        # their own type when the one-arg constructor accepts a mapping;
        # defaultdict's factory is restored explicitly.
        if t is dict:
            return out
        if hasattr(value, "default_factory"):
            fresh = t(value.default_factory)
            fresh.update(out)
            return fresh
        return t(out)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return type(value)(
            **{
                f.name: _rewrite(getattr(value, f.name), plan, f"{path}.{f.name}")
                for f in dataclasses.fields(value)
            }
        )
    if value is None or isinstance(
        value, (bool, int, float, complex, str, bytes, bytearray, range, Enum)
    ):
        return value
    raise TypeError(
        f"cannot rewrite {path} (type {t.__qualname__}) for symmetry "
        f"reduction: define a __rewrite__(plan) method on it."
    )
