"""In-state message collections with three delivery semantics.

The port's own copy of ``stateright_tpu/actor/network.py`` (stateright's
``src/actor/network.rs``).  The network is a *data structure inside each
model state*, not a transport: enumerating deliverable envelopes (plus
drops for lossy networks) is what generates the nondeterministic
interleavings the checker explores.

Unlike the reference's mutate-in-place methods, operations here return new
network values — the functional style matches how the engines clone states,
and keeps networks safely shareable between states.

Determinism note: the reference gets stable iteration order from its
fixed-key hasher; Python set/dict order depends on ``PYTHONHASHSEED``, so
deliverable iteration here sorts by stable fingerprint instead.  (Witness
*validity* never depends on this; reproducibility across runs does.)
"""

from __future__ import annotations

from typing import Any, Dict, FrozenSet, Iterator, List, NamedTuple, Tuple

from ..fingerprint import fingerprint


class Envelope(NamedTuple):
    """Source, destination, and message (network.rs:23-29)."""

    src: "Id"
    dst: "Id"
    msg: Any


class Network:
    """Base of the three delivery-semantics variants (network.rs:45-68).

    Construct via :meth:`new_ordered`, :meth:`new_unordered_duplicating`,
    or :meth:`new_unordered_nonduplicating`.
    """

    # --- constructors (network.rs:84-117) ---------------------------------

    @staticmethod
    def new_ordered(envelopes: List[Envelope] = ()) -> "OrderedNetwork":
        net = OrderedNetwork({})
        for env in envelopes:
            net = net.send(env)
        return net

    @staticmethod
    def new_unordered_duplicating(
        envelopes: List[Envelope] = (),
    ) -> "UnorderedDuplicatingNetwork":
        net = UnorderedDuplicatingNetwork(frozenset())
        for env in envelopes:
            net = net.send(env)
        return net

    @staticmethod
    def new_unordered_nonduplicating(
        envelopes: List[Envelope] = (),
    ) -> "UnorderedNonDuplicatingNetwork":
        net = UnorderedNonDuplicatingNetwork({})
        for env in envelopes:
            net = net.send(env)
        return net

    # --- command-line names (network.rs:119-146, 296-309) ----------------

    @staticmethod
    def names() -> List[str]:
        return ["ordered", "unordered_duplicating", "unordered_nonduplicating"]

    @staticmethod
    def from_name(name: str) -> "Network":
        try:
            return {
                "ordered": Network.new_ordered,
                "unordered_duplicating": Network.new_unordered_duplicating,
                "unordered_nonduplicating": Network.new_unordered_nonduplicating,
            }[name]()
        except KeyError:
            raise ValueError(f"unable to parse network name: {name}") from None

    # --- protocol ---------------------------------------------------------

    is_ordered = False
    is_duplicating = False

    def send(self, envelope: Envelope) -> "Network":
        raise NotImplementedError

    def on_deliver(self, envelope: Envelope) -> "Network":
        raise NotImplementedError

    def on_drop(self, envelope: Envelope) -> "Network":
        raise NotImplementedError

    def iter_deliverable(self) -> Iterator[Envelope]:
        """Distinct deliverable envelopes (heads only for ordered flows)."""
        raise NotImplementedError

    def iter_all(self) -> Iterator[Envelope]:
        """Every message incl. multiplicity (network.rs:148-157)."""
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def __rewrite__(self, plan):
        """Remaps actor ids through a symmetry permutation by rebuilding the
        network from rewritten envelopes (network.rs:311-324)."""
        from ..utils.rewrite_plan import rewrite

        ctor = {
            OrderedNetwork: Network.new_ordered,
            UnorderedDuplicatingNetwork: Network.new_unordered_duplicating,
            UnorderedNonDuplicatingNetwork: Network.new_unordered_nonduplicating,
        }[type(self)]
        return ctor([rewrite(env, plan) for env in self.iter_all()])


def _stable_sorted(envs) -> List[Envelope]:
    return sorted(envs, key=fingerprint)


class _SortCache:
    """Networks are immutable and shared across many states, so the
    fingerprint-sorted envelope order is computed once per instance."""

    __slots__ = ("_sorted",)

    def _sorted_envs(self, envs) -> List[Envelope]:
        try:
            return self._sorted
        except AttributeError:
            self._sorted = _stable_sorted(envs)
            return self._sorted


class UnorderedDuplicatingNetwork(_SortCache, Network):
    """No ordering; delivery is a no-op so messages can be redelivered
    (network.rs:51-52, 204-205).  Drop removes the envelope entirely."""

    is_duplicating = True
    __slots__ = ("envelopes",)

    def __init__(self, envelopes: FrozenSet[Envelope]):
        self.envelopes = frozenset(envelopes)

    def send(self, envelope: Envelope) -> "UnorderedDuplicatingNetwork":
        return UnorderedDuplicatingNetwork(self.envelopes | {envelope})

    def on_deliver(self, envelope: Envelope) -> "UnorderedDuplicatingNetwork":
        return self  # redeliverable

    def on_drop(self, envelope: Envelope) -> "UnorderedDuplicatingNetwork":
        return UnorderedDuplicatingNetwork(self.envelopes - {envelope})

    def iter_deliverable(self) -> Iterator[Envelope]:
        return iter(self._sorted_envs(self.envelopes))

    def iter_all(self) -> Iterator[Envelope]:
        return iter(self._sorted_envs(self.envelopes))

    def __len__(self) -> int:
        return len(self.envelopes)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, UnorderedDuplicatingNetwork)
            and self.envelopes == other.envelopes
        )

    def __hash__(self) -> int:
        return hash(("dup", self.envelopes))

    def __fingerprint_key__(self):
        return ("dup", self.envelopes)

    def __repr__(self) -> str:
        return f"UnorderedDuplicating({sorted(map(repr, self.envelopes))})"


class UnorderedNonDuplicatingNetwork(_SortCache, Network):
    """No ordering; a *multiset* with counts so duplicate sends stay
    distinguishable (network.rs:54-55 and the regression test at
    model.rs:861-964). Delivery and drop both consume one instance."""

    __slots__ = ("counts",)

    def __init__(self, counts: Dict[Envelope, int]):
        self.counts = dict(counts)

    def send(self, envelope: Envelope) -> "UnorderedNonDuplicatingNetwork":
        counts = dict(self.counts)
        counts[envelope] = counts.get(envelope, 0) + 1
        return UnorderedNonDuplicatingNetwork(counts)

    def _remove_one(self, envelope: Envelope) -> "UnorderedNonDuplicatingNetwork":
        if envelope not in self.counts:
            raise KeyError(f"envelope not found: {envelope!r}")
        counts = dict(self.counts)
        if counts[envelope] == 1:
            del counts[envelope]
        else:
            counts[envelope] -= 1
        return UnorderedNonDuplicatingNetwork(counts)

    on_deliver = _remove_one
    on_drop = _remove_one

    def iter_deliverable(self) -> Iterator[Envelope]:
        return iter(self._sorted_envs(self.counts.keys()))

    def iter_all(self) -> Iterator[Envelope]:
        for env in self._sorted_envs(self.counts.keys()):
            for _ in range(self.counts[env]):
                yield env

    def __len__(self) -> int:
        return sum(self.counts.values())

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, UnorderedNonDuplicatingNetwork)
            and self.counts == other.counts
        )

    def __hash__(self) -> int:
        return hash(("nondup", frozenset(self.counts.items())))

    def __fingerprint_key__(self):
        return ("nondup", self.counts)

    def __repr__(self) -> str:
        return f"UnorderedNonDuplicating({sorted(map(repr, self.counts.items()))})"


class OrderedNetwork(Network):
    """Per-directed-pair FIFO flows; only flow heads are deliverable, and
    empty flows are canonicalized away (network.rs:57-67, 221-293)."""

    is_ordered = True
    __slots__ = ("flows",)

    def __init__(self, flows: Dict[Tuple[Any, Any], Tuple[Any, ...]]):
        self.flows = {k: tuple(v) for k, v in flows.items() if v}

    def send(self, envelope: Envelope) -> "OrderedNetwork":
        flows = dict(self.flows)
        key = (envelope.src, envelope.dst)
        flows[key] = flows.get(key, ()) + (envelope.msg,)
        return OrderedNetwork(flows)

    def _remove_first(self, envelope: Envelope) -> "OrderedNetwork":
        key = (envelope.src, envelope.dst)
        if key not in self.flows:
            raise KeyError(f"flow not found. src={envelope.src!r}, dst={envelope.dst!r}")
        flow = self.flows[key]
        try:
            i = flow.index(envelope.msg)
        except ValueError:
            raise KeyError(f"message not found: {envelope.msg!r}") from None
        flows = dict(self.flows)
        remaining = flow[:i] + flow[i + 1:]
        if remaining:
            flows[key] = remaining
        else:
            del flows[key]
        return OrderedNetwork(flows)

    on_deliver = _remove_first
    on_drop = _remove_first

    def iter_deliverable(self) -> Iterator[Envelope]:
        for src, dst in sorted(self.flows.keys()):
            yield Envelope(src, dst, self.flows[(src, dst)][0])

    def iter_all(self) -> Iterator[Envelope]:
        for src, dst in sorted(self.flows.keys()):
            for msg in self.flows[(src, dst)]:
                yield Envelope(src, dst, msg)

    def __len__(self) -> int:
        return sum(len(f) for f in self.flows.values())

    def __eq__(self, other) -> bool:
        return isinstance(other, OrderedNetwork) and self.flows == other.flows

    def __hash__(self) -> int:
        return hash(("ordered", frozenset(self.flows.items())))

    def __fingerprint_key__(self):
        return ("ordered", self.flows)

    def __repr__(self) -> str:
        return f"Ordered({sorted(map(repr, self.flows.items()))})"
