"""Declarative symmetry specs over packed word layouts.

The port's own copy of ``stateright_tpu/sym/spec.py``; a spec's
:meth:`SymmetrySpec.spec_hash` is the same string in both packages, so a
checkpoint's symmetry tag crosses between them.

A :class:`SymmetrySpec` names the role-symmetric process blocks of a
packed model — which bitfields make up one block, how many
interchangeable blocks there are, and where each block's copy of each
field lives in the word vector — in the same declarative style
``packing.py`` uses for fields. ``sym/kernel.py`` compiles a spec into
the device canonicalization and its bit-exact host twin.

Soundness contract (the JAX package's ``docs/symmetry.md``): the named
blocks must be FULLY interchangeable — permuting the blocks of a state
(and nothing else) always yields a behaviorally equivalent state — and
every bit of per-block data must be covered by some lane, because every
lane participates in the sort key. That makes the canonical form
class-invariant (a "perfect" canonicalizer): two states in the same
orbit map to the same representative, so reduced counts are
traversal-order-independent. Blocks whose fields embed *references* to
other blocks (actor ids in message payloads, per-thread prerequisite
indices in history fields) are NOT expressible as a plain block
permutation — such models must not ship a spec; enabling symmetry on
them raises :class:`SymmetryUnsupported` instead.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple, Optional, Sequence, Tuple


class SymmetryUnsupported(TypeError):
    """An engine or path cannot honor the requested symmetry reduction.

    Raised instead of silently exploring the full state space (or,
    worse, silently producing an unsound reduction). ``engine`` names
    the refusing engine/path; ``reason`` says what is missing.
    """

    def __init__(self, engine: str, reason: str):
        self.engine = engine
        self.reason = reason
        super().__init__(f"symmetry reduction under {engine}: {reason}")


class Lane(NamedTuple):
    """One per-block bitfield: ``positions[b]`` is the static
    ``(word, shift)`` of block ``b``'s copy; all copies are ``bits``
    wide. Every lane participates in the block sort key, in declaration
    order (earlier lanes are more significant)."""

    name: str
    bits: int
    positions: Tuple[Tuple[int, int], ...]


class BlockGroup(NamedTuple):
    """``count`` interchangeable blocks, each made of ``lanes``."""

    name: str
    count: int
    lanes: Tuple[Lane, ...]


class SymmetrySpec:
    """The symmetry declaration a packed model ships as its
    ``symmetry_spec`` attribute."""

    def __init__(self, groups: Sequence[BlockGroup], *, name: str = "sym"):
        self.name = name
        self.groups: Tuple[BlockGroup, ...] = tuple(groups)
        self._validate()

    # --- construction helpers --------------------------------------------

    @staticmethod
    def lane(
        name: str,
        bits: int,
        *,
        word: Optional[int] = None,
        shift0: int = 0,
        stride: Optional[int] = None,
        count: Optional[int] = None,
        positions: Optional[Sequence[Tuple[int, int]]] = None,
    ) -> Lane:
        """A lane either from explicit ``positions`` or from a strided
        run inside one word: block ``b`` at ``(word, shift0 + b*stride)``
        (``stride`` defaults to ``bits``)."""
        if positions is None:
            if word is None or count is None:
                raise ValueError(
                    f"lane {name!r}: give positions= or word=/count="
                )
            step = bits if stride is None else stride
            positions = [(word, shift0 + b * step) for b in range(count)]
        return Lane(name, bits, tuple((int(w), int(s)) for w, s in positions))

    @classmethod
    def from_layout(
        cls,
        layout,
        fields: Sequence[str],
        *,
        count: Optional[int] = None,
        group: str = "procs",
        name: str = "sym",
    ) -> "SymmetrySpec":
        """Spec over a :class:`packing.Layout`: each named ARRAY field
        becomes one lane, block ``b`` = element ``b`` of every field.
        This is the declaration path for models built on
        ``LayoutBuilder`` (increment, increment_lock); hand-rolled
        layouts use :meth:`lane` with explicit positions."""
        lanes = []
        n = count
        for fname in fields:
            f = layout.fields[fname]
            if not f.is_array:
                raise ValueError(
                    f"symmetry lane {fname!r} must be an array field "
                    f"(one element per block)"
                )
            if n is None:
                n = f.count
            if f.count < n:
                raise ValueError(
                    f"symmetry lane {fname!r} has {f.count} elements, "
                    f"need {n} (one per block)"
                )
            positions = [
                (f.word + b // f.epw, (b % f.epw) * f.bits) for b in range(n)
            ]
            lanes.append(Lane(fname, f.bits, tuple(positions)))
        return cls([BlockGroup(group, n or 0, tuple(lanes))], name=name)

    # --- validation --------------------------------------------------------

    def _validate(self) -> None:
        if not self.groups:
            raise ValueError("SymmetrySpec needs at least one block group")
        covered = {}
        for g in self.groups:
            if g.count < 2:
                raise ValueError(
                    f"group {g.name!r}: count must be >= 2, got {g.count}"
                )
            if not g.lanes:
                raise ValueError(f"group {g.name!r} has no lanes")
            for lane in g.lanes:
                if not 1 <= lane.bits <= 32:
                    raise ValueError(
                        f"lane {g.name}.{lane.name}: bits must be 1..32"
                    )
                if len(lane.positions) != g.count:
                    raise ValueError(
                        f"lane {g.name}.{lane.name}: {len(lane.positions)} "
                        f"positions for {g.count} blocks"
                    )
                for b, (w, s) in enumerate(lane.positions):
                    if w < 0 or s < 0 or s + lane.bits > 32:
                        raise ValueError(
                            f"lane {g.name}.{lane.name} block {b}: "
                            f"(word={w}, shift={s}, bits={lane.bits}) "
                            f"does not fit a uint32 word"
                        )
                    for bit in range(s, s + lane.bits):
                        key = (w, bit)
                        if key in covered:
                            raise ValueError(
                                f"lane {g.name}.{lane.name} block {b} "
                                f"overlaps {covered[key]} at word {w} "
                                f"bit {bit}"
                            )
                        covered[key] = f"{g.name}.{lane.name}[{b}]"

    # --- identity ----------------------------------------------------------

    @property
    def max_word(self) -> int:
        """Highest word index any lane touches (engine W bound check)."""
        return max(
            w for g in self.groups for ln in g.lanes for w, _ in ln.positions
        )

    def canonical_repr(self) -> str:
        return repr(
            [
                (g.name, g.count, [(ln.name, ln.bits, ln.positions) for ln in g.lanes])
                for g in self.groups
            ]
        )

    def spec_hash(self) -> str:
        """Stable content hash — the checkpoint/cache identity of this
        spec (a resumed run with a DIFFERENT spec would dedup against a
        differently-canonicalized table, silently corrupting counts, so
        checkpoints record this and mismatches fail typed)."""
        return hashlib.sha256(self.canonical_repr().encode()).hexdigest()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"SymmetrySpec({self.canonical_repr()}, name={self.name!r})"
