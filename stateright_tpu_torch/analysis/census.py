"""STPU007: the census of CUDA-graph captures a run plan commits to.

Counterpart of ``stateright_tpu/analysis/census.py``. The reference counts
the XLA programs a plan compiles, one per (bucket, rung schedule). The port
captures one CUDA graph per (bucket, candidate rung), keyed
``(run_cap, rows, cand_cap) + XlaChecker._tail()``, and every rung of a
bucket is captured with the bucket (a logged difference), so its count is
captures: the sum of each bucket's rungs. The engine's own planner decides
those shapes (``xla.ladder_buckets``, ``default_cand_cap``, ``cand_rungs``,
``CAND_LADDER_AUTO_K``), so the census enumerates them with no tracing and
no device:

- :func:`plan_for`: one spec's plan on one platform at the registry's
  capacities, with the multiplexed (``mux_k``) and symmetry shape classes
  when asked; :func:`captures_of` lists its ``(bucket, rows, cand_cap)``
  shapes;
- :func:`build_census`: every shipped spec's plan on both platforms; the CLI
  writes it to ``runs/torch_compile_plan.json`` on a clean full run;
- :func:`census_findings`: STPU007 proper, a plan over its budget
  (``rules.MAX_CAPTURES``; an exception is a waiver in ``waivers.toml``);
- :func:`grown_captures`: the shapes a run may add once its candidate caps
  grew, for a check of a run's captures against the plan.

The census is a LOWER bound on what a run captures. It prices the declared
plan and none of a run's growths: a table growth captures every shape again
at the new capacity, a frontier growth adds the buckets of the doubled
ceiling, and a candidate-cap growth adds the bucket's rungs at the grown
cap. On an NVIDIA H100, 2pc rm=8's plan is 22 captures (13 to 16 a
ceiling) while its cold run captured 46 graphs of 18 shapes (PERF.md).

The platforms are ``("cpu", "cuda")``. The port's CPU policy is not the
reference's (a logged difference, ROADMAP.md): ``dedup="auto"`` is the
sorted set on every device, so the CPU plan has the candidate ladder too,
and the engine compacts with its kernel everywhere; only the candidate caps
differ (a quarter of the action grid on the CPU, a sixteenth on a card).
The reference's ``warm_specs`` has no counterpart: no program cache crosses
processes in the port (a logged difference too), so there is no warm set to
derive.

The census is hermetic: it reads no environment knob.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from ..xla import (
    CAND_LADDER_AUTO_K,
    DEFAULT_FRONTIER_CAPACITY,
    DEFAULT_TABLE_CAPACITY,
    cand_rungs,
    default_cand_cap,
    ladder_buckets,
)
from .rules import MAX_CAPTURES, Finding

#: The platforms a shipped plan is enumerated for.
PLATFORMS = ("cpu", "cuda")


def plan_for(
    spec: str,
    platform: str,
    *,
    frontier_capacity: Optional[int] = None,
    table_capacity: Optional[int] = None,
    mux_k: Optional[int] = None,
    symmetry: bool = False,
    cand_caps: Optional[Dict[int, int]] = None,
    _resolved=None,
) -> Dict[str, Any]:
    """The captures one spec commits to on one platform, at the registry's
    capacities (the engine's defaults where the registry names none, as for
    a user family; override for what-if probes and the tests). Growth
    events are excluded: the census prices the declared plan. A run that
    doubles its frontier ceiling runs the plan of each ceiling it passes.
    ``_resolved`` lets :func:`build_census` resolve each spec's model once.

    ``mux_k`` adds the multiplexed engine's shape classes (``xla_mux.py``:
    one program per bucket at its full rung, keyed by the lane count K), for
    mux-eligible plans only (family in ``registry.MUX_FAMILIES``; the delta
    set, which the mux refuses, is never the plan's). ``symmetry`` adds the
    symmetry-variant classes for a model with a ``symmetry_spec`` or a
    ``packed_representative``: the symmetry tag is in every program's key
    (``XlaChecker._tail``), so a symmetry-on service captures the plan
    again. Both count toward the same budget. ``cand_caps`` overrides the
    planner's candidate cap of some buckets (caps a run grew to; see
    :func:`grown_captures`)."""
    if _resolved is None:
        from ..service.registry import resolve

        _resolved = resolve(spec)
    model, caps = _resolved
    W, A = model.state_words, model.max_actions
    f_cap = frontier_capacity or caps.get("frontier_capacity", DEFAULT_FRONTIER_CAPACITY)
    t_cap = table_capacity or caps.get("table_capacity", DEFAULT_TABLE_CAPACITY)

    def cap_of(rc: int) -> int:
        return (cand_caps or {}).get(rc) or default_cand_cap(rc, A, platform)

    shapes: List[Dict[str, Any]] = []
    for bucket in ladder_buckets(f_cap):
        shapes.append({
            "bucket": bucket,
            "cand_cap": cap_of(bucket),
            "rungs": [list(r) for r in cand_rungs(bucket, cap_of, CAND_LADDER_AUTO_K)],
        })
    plan: Dict[str, Any] = {
        "spec": spec,
        "platform": platform,
        "state_words": W,
        "max_actions": A,
        "dedup": "sorted",
        "compaction": "pallas",
        "frontier_capacity": f_cap,
        "table_capacity": t_cap,
        "shapes": shapes,
        "captures": sum(len(s["rungs"]) for s in shapes),
        "budget": MAX_CAPTURES,
    }
    if symmetry:
        spec_obj = getattr(model, "symmetry_spec", None)
        tag = (
            f"spec:{spec_obj.spec_hash()[:12]}" if spec_obj is not None
            else "model:packed_representative" if hasattr(model, "packed_representative")
            else None
        )
        if tag is not None:
            plan["sym"] = {"tag": tag, "captures": plan["captures"]}
    if mux_k is not None and mux_k > 1:
        from ..service.registry import MUX_FAMILIES, parse

        if parse(spec)[0] in MUX_FAMILIES:
            mux_shapes = [{"bucket": s["bucket"], "cand_cap": s["cand_cap"]} for s in shapes]
            plan["mux"] = {"k": mux_k, "shapes": mux_shapes, "captures": len(mux_shapes)}
    return plan


def captures_of(plan: Dict[str, Any]) -> Set[Tuple[int, int, int]]:
    """The ``(run_cap, rows, cand_cap)`` shapes of a plan's solo captures:
    the head of the engine's program key."""
    return {(s["bucket"], rows, cap) for s in plan["shapes"] for rows, cap in s["rungs"]}


def grown_captures(
    spec: str,
    platform: str,
    frontier_ceilings: Iterable[int],
    grown: Dict[int, int],
    _resolved=None,
) -> Set[Tuple[int, int, int]]:
    """Every ``(run_cap, rows, cand_cap)`` shape a run of ``spec`` may
    capture under each of ``frontier_ceilings`` once the candidate caps of
    some buckets grew, up to ``grown`` (bucket -> largest cap; the model's
    ``xla.CAND_HINTS`` after the run). The engine grows a bucket's cap four
    times over, up to the bucket's whole action grid, and a bucket's rungs
    take their caps from the buckets below them as they stand when it is
    captured, so every grown bucket is taken at each cap it passed through,
    in every combination. The plan's own shapes are among them."""
    if _resolved is None:
        from ..service.registry import resolve

        _resolved = resolve(spec)
    A = _resolved[0].max_actions
    passed: Dict[int, List[int]] = {}
    for rc, top in grown.items():
        grid = 1 << max(rc * A - 1, 1).bit_length()
        caps = [default_cand_cap(rc, A, platform)]
        while caps[-1] < min(top, grid):
            caps.append(min(caps[-1] * 4, grid))
        passed[rc] = caps
    out: Set[Tuple[int, int, int]] = set()
    for combo in itertools.product(*passed.values()):
        caps = dict(zip(passed, combo))
        for f in frontier_ceilings:
            out |= captures_of(plan_for(spec, platform, frontier_capacity=f,
                                        cand_caps=caps, _resolved=_resolved))
    return out


def build_census(
    specs: Optional[List[str]] = None,
    mux_k: Optional[int] = None,
    symmetry: bool = False,
) -> Dict[str, Any]:
    """The full census: every shipped spec's plan on both platforms."""
    from ..service.registry import SHIPPED, resolve

    out: Dict[str, Any] = {"specs": {}}
    for spec in specs if specs is not None else list(SHIPPED):
        resolved = resolve(spec)
        out["specs"][spec] = {
            p: plan_for(spec, p, mux_k=mux_k, symmetry=symmetry, _resolved=resolved)
            for p in PLATFORMS
        }
    return out


def plan_total(plan: Dict[str, Any]) -> int:
    """Every capture a plan commits to: the solo plan, plus the mux and
    symmetry classes where the census priced them."""
    return (plan["captures"] + plan.get("mux", {}).get("captures", 0)
            + plan.get("sym", {}).get("captures", 0))


def census_findings(census: Dict[str, Any]) -> List[Finding]:
    """STPU007 over a built census: one finding per (spec, platform) plan
    whose captures exceed its declared budget."""
    findings: List[Finding] = []
    for spec, plans in census["specs"].items():
        for platform, plan in plans.items():
            n = plan_total(plan)
            budget = plan["budget"]
            if n <= budget:
                continue
            buckets = [s["bucket"] for s in plan["shapes"]]
            findings.append(
                Finding(
                    rule="STPU007",
                    surface=f"plan:{spec}:{platform}",
                    file="",
                    line=0,
                    message=(
                        f"run plan captures {n} CUDA graphs (budget {budget}): "
                        f"buckets {buckets}, every rung of a bucket captured with it; "
                        "each capture costs a warm-up level and the capture on the "
                        "cold wall. Lower the frontier ceiling, or waive the finding "
                        "in analysis/waivers.toml with the reason"
                    ),
                    excerpt=f"buckets={buckets}",
                )
            )
    return findings
