"""Counters registry: the event half of ``checker.metrics()``.

The port's own copy of ``stateright_tpu/obs/metrics.py``.

A plain dict of named monotonic counters, pre-seeded so the snapshot's key
set is stable across engines, dedup structures, and runs that never hit a
growth path (consumers diff snapshots; a key that appears only after the
first table growth would read as schema drift). Gauges — occupancy,
capacities, live counts — are NOT registered here: the engines compute
them from live state at ``metrics()`` time, so the registry itself never
touches the hot path (increments happen only at rare host-side events:
growths, flushes, shrink-exits).
"""

from __future__ import annotations

from typing import Dict, Iterable


class Counters:
    """Named monotonic event counters with a stable key set."""

    __slots__ = ("_c",)

    def __init__(self, seed: Iterable[str] = ()):
        self._c: Dict[str, int] = {name: 0 for name in seed}

    def inc(self, name: str, n: int = 1) -> None:
        self._c[name] = self._c.get(name, 0) + n

    def __getitem__(self, name: str) -> int:
        return self._c.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        return dict(self._c)
