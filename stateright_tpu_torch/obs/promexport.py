"""OpenMetrics rendering of metrics snapshots.

The port's own copy of ``stateright_tpu/obs/promexport.py``, whole:
:func:`pool_samples` renders the ``gauges()`` of a ``CheckerService`` or
a ``FleetService`` (``service/``), and the Explorer's ``GET /.metrics``
renders its checker's snapshot, and its pool's when it serves one. Turns any
``checker.metrics()`` snapshot, pool snapshot,
or :mod:`~stateright_tpu_torch.obs.timeseries` row into the OpenMetrics
text format Prometheus-shaped scrapers consume. The one difference:
:func:`build_info_sample` labels the build with torch's version, not
jax's.

Naming is mechanical — snapshot key ``foo`` becomes ``stpu_foo`` (engine
snapshots), ``stpu_pool_foo`` (pool snapshots), or ``stpu_hv_foo`` (the
flattened host-verify stats dict). Monotonic keys (the obs Counters plus
the cumulative search totals) render as OpenMetrics *counters* with the
mandatory ``_total`` suffix; everything else numeric is a *gauge*;
booleans render 0/1; strings and None are skipped (they ride as labels or
not at all). Labels carried per sample: ``job`` (the pool job id),
``engine``, ``dedup`` — the identity triple of a snapshot — with absent
values omitted, never empty-stringed. QoS rollups (``gauges()["qos"]``)
additionally ride ``class=`` / ``tenant=`` labels on the
``stpu_pool_qos_*`` families (docs/service.md "QoS & overload").

The module also ships :func:`parse_openmetrics` — a strict-enough parser
(TYPE tracking, label unescaping, the ``# EOF`` terminator) used by the
tests and the smoke stage to validate the endpoint's output and
cross-check every counter against ``checker.metrics()`` exactly. Both
directions are held against the reference by tests/test_torch_obs.py.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

#: Snapshot keys rendered as OpenMetrics counters (monotonic; the
#: ``_total`` suffix is mandatory in the exposition format). Everything
#: numeric outside this set is a gauge.
COUNTER_KEYS = frozenset(
    {
        # cumulative search totals
        "state_count",
        "unique_state_count",
        "dispatches",
        "levels_committed",
        "cand_retries",
        # the obs.Counters event registry (ENGINE_COUNTERS + mesh extras)
        "table_grows",
        "frontier_grows",
        "cand_grows",
        "delta_flushes",
        "shrink_exits",
        "ladder_jumps",
        "checkpoints_written",
        "route_grows",
        # pool counters (SERVICE_COUNTERS)
        "submitted",
        "admitted",
        "rejected",
        "jobs_done",
        "jobs_failed",
        "wedge_verdicts",
        "crashes",
        "requeues",
        "breaker_trips",
        "breaker_closes",
        "degraded_jobs",
        "device_probes",
        "lint_checks",
        "lint_rejects",
        "lint_errors",
        "idem_dedups",
        "jobs_recovered",
        "orphans_killed",
        "artifacts_swept",
        "jobs_evacuated",
        # QoS tier (docs/service.md "QoS & overload"): shed admissions,
        # tenant-quota rejections, aging-term scheduler picks, and
        # compile-on-admit warm-cache spawns.
        "sheds",
        "quota_rejects",
        "aged_picks",
        "warm_compiles",
        # batched scheduling (xla_mux.py; docs/service.md "Batched
        # scheduling") — mux_groups/mux_lanes count groups/members the
        # pool launched, mux_dispatches_saved the device calls the
        # batching avoided (both the pool's fold of worker summaries and
        # the per-lane engine snapshots carry the latter). mux_lanes and
        # mux_lanes_active on a LIVE MuxChecker snapshot are gauges (the
        # batch's current width), so only the monotonic keys ride here.
        "mux_groups",
        "mux_dispatches_saved",
        # fleet counters (FLEET_COUNTERS; service/fleet.py)
        "routed",
        "migrations",
        "devices_lost",
        "device_flakes",
        "host_last_resort",
        "pools_quiesced",
        "pools_woken",
    }
)

#: The label set every sample may carry: absent values are
#: omitted from the sample, never rendered as empty strings.
LABEL_KEYS = ("job", "engine", "dedup")

#: One exposition sample: ``(metric_name, labels, value)``.
Sample = Tuple[str, Dict[str, str], float]


def _numeric(value: Any) -> Optional[float]:
    """The sample value for a snapshot entry, or None to skip it. bools
    are 0/1 (``waiting``, breaker flags); ints/floats pass through;
    strings/None/containers are identity or structure, not samples."""
    if isinstance(value, bool):
        return float(value)
    if isinstance(value, (int, float)):
        return float(value)
    return None


def _labels_of(snapshot: Dict[str, Any], extra: Optional[Dict[str, Any]] = None) -> Dict[str, str]:
    """The identity labels a snapshot carries: ``job`` from the service
    job id, ``engine``/``dedup`` from the snapshot's own config gauges;
    ``extra`` (caller-known identity, e.g. the pool job id for a finished
    job's recorded snapshot) wins over the snapshot."""
    merged = {"job": snapshot.get("job_id"), "engine": snapshot.get("engine"),
              "dedup": snapshot.get("dedup")}
    if extra:
        merged.update({k: v for k, v in extra.items() if k in LABEL_KEYS})
    return {k: str(v) for k, v in merged.items() if v is not None}


def engine_samples(
    snapshot: Dict[str, Any], labels: Optional[Dict[str, Any]] = None
) -> List[Sample]:
    """Flatten one engine snapshot into ``stpu_*`` samples (the ``hv``
    stats dict flattens to ``stpu_hv_*`` gauges)."""
    lab = _labels_of(snapshot, labels)
    out: List[Sample] = []
    for key, value in snapshot.items():
        if key == "hv" and isinstance(value, dict):
            for hk, hv in value.items():
                v = _numeric(hv)
                if v is not None:
                    out.append((f"stpu_hv_{hk}", lab, v))
            continue
        v = _numeric(value)
        if v is None:
            continue
        name = f"stpu_{key}_total" if key in COUNTER_KEYS else f"stpu_{key}"
        out.append((name, lab, v))
    return out


def pool_samples(
    gauges: Dict[str, Any],
    labels: Optional[Dict[str, Any]] = None,
    prefix: str = "stpu_pool",
) -> List[Sample]:
    """Flatten a ``service.gauges()`` snapshot into ``{prefix}_*``
    samples: occupancy counts, caps, the SERVICE_COUNTERS, breaker state
    (``{prefix}_breaker_open`` 0/1 + consecutive-wedge gauge), and the
    journal position. ``labels`` ride every sample — the Explorer labels
    a fleet's per-device pool rows ``device="device-K"`` — and fleet-
    scoped rows render under ``prefix="stpu_fleet"`` so they never share
    a family with (and double-count against) the per-device pool rows."""
    out: List[Sample] = []
    lab: Dict[str, str] = {
        str(k): str(v) for k, v in (labels or {}).items() if v is not None
    }
    for key, value in gauges.items():
        if key == "breaker" and isinstance(value, dict):
            out.append(
                (f"{prefix}_breaker_open", lab, float(value.get("state") == "open"))
            )
            v = _numeric(value.get("consecutive_wedges"))
            if v is not None:
                out.append((f"{prefix}_breaker_consecutive_wedges", lab, v))
            continue
        if key == "journal" and isinstance(value, dict):
            v = _numeric(value.get("records"))
            if v is not None:
                out.append((f"{prefix}_journal_records_total", lab, v))
            continue
        if key == "qos" and isinstance(value, dict):
            out.extend(_qos_samples(value, lab, prefix))
            continue
        v = _numeric(value)
        if v is None:
            continue
        name = (
            f"{prefix}_{key}_total" if key in COUNTER_KEYS else f"{prefix}_{key}"
        )
        out.append((name, lab, v))
    return out


def _qos_samples(
    qos: Dict[str, Any], lab: Dict[str, str], prefix: str
) -> List[Sample]:
    """Flatten a ``gauges()["qos"]`` dict (docs/service.md "QoS &
    overload"): per-class rows render under ``{prefix}_qos_class_*`` with
    a ``class`` label, per-tenant rows under ``{prefix}_qos_tenant_*``
    with a ``tenant`` label, scalar fields (``aging_s``,
    ``drain_per_s``) as plain gauges. ``served`` is the journaled
    monotonic stride counter, so it renders as an OpenMetrics counter."""
    out: List[Sample] = []
    for key, value in qos.items():
        if key in ("classes", "tenants") and isinstance(value, dict):
            label_key = "class" if key == "classes" else "tenant"
            suffix = "class" if key == "classes" else "tenant"
            for ident, row in value.items():
                if not isinstance(row, dict):
                    continue
                row_lab = dict(lab)
                row_lab[label_key] = str(ident)
                for f, fv in row.items():
                    v = _numeric(fv)
                    if v is None:
                        continue
                    name = (
                        f"{prefix}_qos_{suffix}_{f}_total"
                        if f == "served"
                        else f"{prefix}_qos_{suffix}_{f}"
                    )
                    out.append((name, row_lab, v))
            continue
        v = _numeric(value)
        if v is not None:
            out.append((f"{prefix}_qos_{key}", lab, v))
    return out


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace("\"", "\\\"").replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    # Integral values render without a trailing .0 — exact-count
    # cross-checks (and humans) compare them against ints.
    return str(int(v)) if float(v).is_integer() else repr(float(v))


#: Memoized build-info labels: the package tree hash reads every source
#: file — compute once per process, not once per scrape.
_BUILD_INFO_LABELS: Optional[Dict[str, str]] = None


def build_info_sample(platform: Optional[str] = None) -> Sample:
    """The ``stpu_build_info`` identity gauge (value always 1; the
    standard Prometheus *info*-metric idiom): ``platform`` (``cuda`` when
    a card is present unless the caller knows better), ``torch``
    (version), and ``tree`` — the package-tree content hash the stpu-lint
    cache keys by (``analysis/cache.tree_hash``), so a scrape and a lint
    verdict name the exact source that ran."""
    global _BUILD_INFO_LABELS
    import torch

    if _BUILD_INFO_LABELS is None:
        try:
            from ..analysis.cache import tree_hash

            tree = tree_hash()[:12]
        except OSError:  # identity is best-effort
            tree = "unknown"
        _BUILD_INFO_LABELS = {
            "torch": getattr(torch, "__version__", "unknown"),
            "tree": tree,
        }
    if platform is None:
        from ..backend import platform_label

        platform = platform_label()
    return (
        "stpu_build_info",
        {"platform": str(platform), **_BUILD_INFO_LABELS},
        1.0,
    )


def render_openmetrics(samples: List[Sample]) -> str:
    """One OpenMetrics exposition of ``samples``: a ``# TYPE`` line per
    family (counter families carry the ``_total``-stripped family name,
    per the spec), samples grouped under it, ``# EOF`` terminated."""
    by_family: Dict[str, List[Sample]] = {}
    order: List[str] = []
    for name, labels, value in samples:
        family = name[: -len("_total")] if name.endswith("_total") else name
        if family not in by_family:
            by_family[family] = []
            order.append(family)
        by_family[family].append((name, labels, value))
    lines: List[str] = []
    for family in order:
        rows = by_family[family]
        kind = "counter" if rows[0][0].endswith("_total") else "gauge"
        lines.append(f"# TYPE {family} {kind}")
        for name, labels, value in rows:
            if labels:
                inner = ",".join(
                    f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())
                )
                lines.append(f"{name}{{{inner}}} {_fmt_value(value)}")
            else:
                lines.append(f"{name} {_fmt_value(value)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def parse_openmetrics(text: str) -> Dict[Tuple[str, frozenset], float]:
    """The validating parser the tests and the smoke stage drive against
    ``GET /.metrics``: returns ``{(name, frozenset(labels.items())):
    value}``. Raises ``ValueError`` on a malformed exposition — missing
    ``# EOF``, a sample line that does not parse, a ``_total`` sample
    under a non-counter family, or a counter family whose samples lack
    the suffix."""
    lines = text.splitlines()
    if not lines or lines[-1] != "# EOF":
        raise ValueError("exposition not terminated by # EOF")
    out: Dict[Tuple[str, frozenset], float] = {}
    types: Dict[str, str] = {}
    for line in lines[:-1]:
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
                continue
            raise ValueError(f"unexpected comment line: {line!r}")
        name, labels, value = _parse_sample(line)
        family = name[: -len("_total")] if name.endswith("_total") else name
        kind = types.get(family)
        if kind is None:
            raise ValueError(f"sample before its # TYPE line: {line!r}")
        if kind == "counter" and not name.endswith("_total"):
            raise ValueError(f"counter sample without _total: {line!r}")
        if kind != "counter" and name.endswith("_total"):
            raise ValueError(f"_total sample under gauge family: {line!r}")
        key = (name, frozenset(labels.items()))
        if key in out:
            raise ValueError(f"duplicate sample: {line!r}")
        out[key] = value
    return out


def _parse_sample(line: str) -> Tuple[str, Dict[str, str], float]:
    rest = line
    labels: Dict[str, str] = {}
    brace = rest.find("{")
    if brace != -1:
        name = rest[:brace]
        end = rest.rfind("}")
        if end == -1:
            raise ValueError(f"unterminated label set: {line!r}")
        labels = _parse_labels(rest[brace + 1 : end])
        rest = rest[end + 1 :]
    else:
        name, _, rest = rest.partition(" ")
        rest = " " + rest
    if not name or not name.replace("_", "").replace(":", "").isalnum():
        raise ValueError(f"bad metric name in: {line!r}")
    try:
        value = float(rest.strip().split()[0])
    except (ValueError, IndexError):
        raise ValueError(f"bad sample value in: {line!r}") from None
    return name, labels, value


def _parse_labels(body: str) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    i = 0
    while i < len(body):
        eq = body.find("=", i)
        if eq == -1 or body[eq + 1] != '"':
            raise ValueError(f"bad label pair in: {body!r}")
        key = body[i:eq]
        j = eq + 2
        value = []
        while j < len(body):
            c = body[j]
            if c == "\\":
                nxt = body[j + 1] if j + 1 < len(body) else ""
                value.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
                j += 2
                continue
            if c == '"':
                break
            value.append(c)
            j += 1
        else:
            raise ValueError(f"unterminated label value in: {body!r}")
        labels[key] = "".join(value)
        i = j + 1
        if i < len(body) and body[i] == ",":
            i += 1
    return labels


#: The Content-Type the endpoint serves (the OpenMetrics registration).
CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"
