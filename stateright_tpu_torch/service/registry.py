"""Model registry: the specs a :class:`CheckerService` job can name.

Counterpart of ``stateright_tpu/service/registry.py``: the same families,
spec grammar, default arguments, shipped list and capacities, resolved to
the port's packed models. Service jobs run in supervised subprocesses, so
a job's model must be constructible from a plain string the worker
re-resolves on its side of the boundary. Spec grammar::

    <family>[:<arg>[,<arg>...]]

e.g. ``2pc:4``, ``paxos:2,3``, ``abd-ordered:2``, ``scr:3,1``. Omitted
args take the family default. :func:`resolve` returns the packed model
plus the engine capacities the reference tunes the shipped configurations
at; the engine grows past them as the search needs.

User families ride ``STPU_FAMILIES="name=module:attr,..."``: :func:`parse`
validates a spec's name against that mapping without importing anything,
so the service process never executes user code (nor imports an engine);
only the subprocesses that resolve the spec (the admission check and the
job workers) import it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple


def _two_phase(args: List[int]):
    from ..models.two_phase_commit import PackedTwoPhaseSys

    rm = args[0] if args else 3
    return PackedTwoPhaseSys(rm), dict(
        frontier_capacity=1 << 10, table_capacity=1 << 13
    )


def _paxos(args: List[int]):
    from ..models.paxos import PackedPaxos

    c = args[0] if len(args) > 0 else 2
    s = args[1] if len(args) > 1 else 3
    return PackedPaxos(c, s), dict(
        frontier_capacity=1 << 12, table_capacity=1 << 16
    )


def _abd(args: List[int]):
    from ..models.linearizable_register import PackedAbd

    c = args[0] if args else 2
    return PackedAbd(c, 2), dict(
        frontier_capacity=1 << 10, table_capacity=1 << 13
    )


def _abd_ordered(args: List[int]):
    from ..models.linearizable_register import PackedAbdOrdered

    c = args[0] if args else 2
    return PackedAbdOrdered(c, 2), dict(
        frontier_capacity=1 << 10, table_capacity=1 << 13
    )


def _scr(args: List[int]):
    from ..models.single_copy_register import PackedSingleCopyRegister

    c = args[0] if len(args) > 0 else 3
    s = args[1] if len(args) > 1 else 1
    return PackedSingleCopyRegister(c, s), dict(
        frontier_capacity=1 << 11, table_capacity=1 << 14
    )


def _increment(args: List[int]):
    from ..models.increment import PackedIncrement

    t = args[0] if args else 3
    return PackedIncrement(t), dict(
        frontier_capacity=1 << 10, table_capacity=1 << 13
    )


def _increment_lock(args: List[int]):
    from ..models.increment_lock import PackedIncrementLock

    t = args[0] if args else 3
    return PackedIncrementLock(t), dict(
        frontier_capacity=1 << 10, table_capacity=1 << 13
    )


#: family name -> model factory taking the parsed integer args.
FAMILIES: Dict[str, Callable[[List[int]], Tuple[Any, Dict[str, int]]]] = {
    "2pc": _two_phase,
    "paxos": _paxos,
    "abd": _abd,
    "abd-ordered": _abd_ordered,
    "scr": _scr,
    "increment": _increment,
    "increment-lock": _increment_lock,
}


#: Families whose jobs the batching scheduler may multiplex into one
#: ``worker.py --mux`` invocation.
#: ``MuxChecker`` requires lanes with no host-verified properties — every
#: shipped family resolves hv-free at its shipped configurations EXCEPT
#: ``scr``, whose model conditionally promotes properties to host
#: verification by pattern census, so the scheduler excludes it statically
#: rather than paying a resolve-and-fall-back in the worker. User families
#: (STPU_FAMILIES) are never multiplexed: the service cannot see their
#: model structure without importing user code.
MUX_FAMILIES = frozenset(FAMILIES) - {"scr"}


#: Families whose packed models ship a declarative ``symmetry_spec``
#: (``sym/``), known statically like MUX_FAMILIES: the service process
#: imports no model.
SYM_FAMILIES = frozenset({"2pc", "increment", "increment-lock"})


def _extra_family_targets() -> Dict[str, Tuple[str, str]]:
    """The ``STPU_FAMILIES="name=module:attr,..."`` mapping, parsed but
    NOT imported — :func:`parse` validates spec names against this
    without executing any user code, so the service process can
    admission-validate a user spec while the import itself happens only
    in the subprocesses that resolve it (the admission check, the job
    workers). A malformed entry raises
    ``ValueError`` — a caller bug, same contract as an unknown spec."""
    import os

    raw = os.environ.get("STPU_FAMILIES", "").strip()
    if not raw:
        return {}
    out: Dict[str, Tuple[str, str]] = {}
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, eq, target = entry.partition("=")
        mod_name, colon, attr = target.partition(":")
        if not (eq and colon and name.strip() and mod_name and attr):
            raise ValueError(
                f"malformed STPU_FAMILIES entry {entry!r} "
                '(expected "name=module:attr")'
            )
        out[name.strip()] = (mod_name, attr)
    return out


def _load_extra_family(name: str) -> Callable[[List[int]], Tuple[Any, Dict[str, int]]]:
    """Import ONE user family's factory (same ``(args) -> (model,
    capacities)`` contract as the shipped ones). Only the requested
    entry is imported — one broken STPU_FAMILIES entry must not take
    down the healthy ones — and only :func:`resolve` reaches this:
    importing a user module executes its top-level code, which must
    never happen in the service pool process (it may start the card;
    see service/core.py). Kept OUT of
    :data:`FAMILIES` on purpose: shipped families are the tree's
    (their admission verdicts memoizable); user families are the
    caller's, re-resolved lazily on every call so the env var works
    across the process boundaries the service creates."""
    import importlib

    mod_name, attr = _extra_family_targets()[name]
    try:
        mod = importlib.import_module(mod_name)
        return getattr(mod, attr)
    except (ImportError, AttributeError) as e:
        raise ValueError(
            f"STPU_FAMILIES entry {name}={mod_name}:{attr} "
            f"failed to load: {e}"
        ) from e

#: The seven shipped packed-model configurations: the specs whose admission
#: verdicts a service memoizes.
SHIPPED = (
    "2pc:3",
    "2pc:4",
    "abd:2",
    "abd-ordered:2",
    "paxos:2,3",
    "scr:3,1",
    "increment-lock:3",
)


def parse(spec: str) -> Tuple[str, List[int]]:
    """``"paxos:2,3"`` -> ``("paxos", [2, 3])``; raises ``ValueError`` on
    an unknown family or malformed args (typed: admission control converts
    nothing — a bad spec is a caller bug, not a capacity problem)."""
    name, _, rest = spec.strip().partition(":")
    if name not in FAMILIES and name not in _extra_family_targets():
        raise ValueError(
            f"unknown model spec {spec!r}; families: {sorted(FAMILIES)}"
        )
    try:
        args = [int(a) for a in rest.split(",") if a.strip()] if rest else []
    except ValueError:
        raise ValueError(f"malformed spec args in {spec!r}") from None
    return name, args


def resolve(spec: str) -> Tuple[Any, Dict[str, int]]:
    """Spec string -> ``(packed model, default spawn capacities)``."""
    name, args = parse(spec)
    factory = FAMILIES.get(name) or _load_extra_family(name)
    return factory(args)
