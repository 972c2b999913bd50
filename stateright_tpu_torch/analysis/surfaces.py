"""The registered surfaces stpu-lint sweeps.

Counterpart of ``stateright_tpu/analysis/surfaces.py``. A *surface* is one
checkable artifact the port ships, with the rules that apply to it:

- ``kernel:<spec>:step``, ``:properties`` and ``:representative`` (the
  symmetry canonicalization the engine runs, where the model has one): the
  model's batched kernels, traced to aten graphs on fake CPU tensors at
  :data:`KERNEL_BATCH` rows and scanned for STPU001, for every spec of
  ``service/registry.SHIPPED``;
- ``cuda:<name>``: each kernel source of ``ops/_cuda.SOURCES``, compiled
  with ``ops/_cuda.NVCC_FLAGS`` and ``-Xptxas -v`` for STPU005/006 (skipped,
  with the reason, where there is no ``nvcc``; never cached, since the
  verdict is the compiler's and the tree hash does not cover it);
- ``plan:<spec>``: the census of the spec's graph captures (STPU007);
  ``plan:<spec>:full`` under ``--full``, which also prices the mux and
  symmetry classes (a verdict of its own, cached apart);
- ``admission:<spec>``: ``ADM001``/``ADM002``, the checks the service's
  flight-check ran before this package: a model without the packed
  interface has no kernel to trace, which is a finding, not an error.

The reference's engine, fused, ops, sharded and mux superstep surfaces
carried only STPU003, STPU004 and STPU008, which mean nothing here
(``rules.py``), and its Pallas surfaces are the ``cuda:`` ones; none is
ported. Nothing here touches a card: every trace runs on fake tensors of
the CPU device (:func:`pin_cpu`), the admission check builds its checker on
the CPU, and ``nvcc`` compiles without one.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .fx_lint import kernel_findings, nvcc_findings, ptxas_report
from .rules import Finding

#: The rows the kernel surfaces trace at. The graph does not depend on the
#: batch, but tracing at the engine's scale keeps the shapes honest.
KERNEL_BATCH = 4096

#: The lane count ``--full`` prices the multiplexed engine's captures at
#: (the widest mux ``chip_smoke.py`` runs).
FULL_MUX_K = 8

#: Seconds one ``nvcc`` of a kernel source may take.
NVCC_TIMEOUT_S = 600

Runner = Callable[[], Any]


class SurfaceSkip(Exception):
    """A surface that cannot run in THIS environment (a CUDA surface
    without ``nvcc``): reported with its reason, not an error; the
    environment, not the tree, is the cause."""


@dataclass
class SurfaceReport:
    name: str
    findings: List[Finding] = field(default_factory=list)
    seconds: float = 0.0
    #: Non-empty when the surface failed to trace or compile for a reason
    #: that is not a finding (the CLI exits 2 on these: a surface that
    #: cannot be checked is not a pass).
    error: str = ""
    #: Non-empty when the surface skipped itself (an environment limit, not
    #: a failure; the reason is the probe's verdict).
    skipped: str = ""
    #: Whether the findings came from the content-hash result cache
    #: (analysis/cache.py) instead of a fresh check.
    cached: bool = False
    #: What the surface measured beside its findings: a CUDA surface's
    #: kernels (registers, shared memory, spills, occupancy) and compile
    #: seconds.
    detail: Dict[str, Any] = field(default_factory=dict)


def pin_cpu():
    """The device every surface works on: the CPU. The kernel traces run on
    fake tensors of it and the admission check builds its checker there, so
    the lint never initialises CUDA, on a machine with a card too."""
    import torch

    return torch.device("cpu")


# --- surface builders -------------------------------------------------------


def _kernel_surfaces(spec: str, model) -> List[Tuple[str, Runner]]:
    import torch

    W = model.state_words
    out: List[Tuple[str, Runner]] = []

    def scan(name: str, fn, shape: Tuple[int, int]) -> Tuple[str, Runner]:
        def run():
            return kernel_findings(fn, (torch.zeros(shape, dtype=torch.int64, device=pin_cpu()),),
                                   name)

        return name, run

    rows = (KERNEL_BATCH, W)
    out.append(scan(f"kernel:{spec}:step", model.packed_step, rows))
    out.append(scan(f"kernel:{spec}:properties", model.packed_properties, rows))
    spec_obj = getattr(model, "symmetry_spec", None)
    if spec_obj is not None:
        # The spec-compiled canonicalization the engine captures into each
        # symmetric level, over plane-major [W, N] words.
        from ..sym import compile_canon

        out.append(scan(f"kernel:{spec}:representative", compile_canon(spec_obj),
                        (W, KERNEL_BATCH)))
    elif hasattr(model, "packed_representative"):
        out.append(scan(f"kernel:{spec}:representative", model.packed_representative, rows))
    return out


def _cuda_surface(name: str) -> Tuple[str, Runner]:
    """STPU005/006 for ``csrc/<name>.cu``: one ``nvcc`` with the build's
    own flags plus ``-Xptxas -v``, into a scratch directory."""
    surface = f"cuda:{name}"

    def run():
        from ..ops import _cuda

        try:
            nvcc = _cuda._nvcc()
        except RuntimeError as e:
            raise SurfaceSkip(f"{e} (STPU005/006 need the CUDA toolkit)") from None
        source = str(_cuda.CSRC / f"{name}.cu")
        t0 = time.monotonic()
        with tempfile.TemporaryDirectory(prefix="stpu_lint_") as tmp:
            proc = subprocess.run(
                [nvcc, *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                 os.path.join(tmp, f"lib{name}.so"), source],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                timeout=NVCC_TIMEOUT_S)
        findings = nvcc_findings(proc.stdout, proc.returncode, surface)
        kernels: List[Dict[str, Any]] = []
        if proc.returncode == 0:
            more, kernels = ptxas_report(proc.stdout, source, surface)
            findings += more
        return findings, {"kernels": kernels, "nvcc_s": round(time.monotonic() - t0, 3)}

    return surface, run


def _census_surface(spec: str, full: bool = False) -> Tuple[str, Runner]:
    """STPU007: the spec's capture census on both platforms (pure planner
    arithmetic, no tracing); ``full`` adds the mux and symmetry classes,
    under a name of its own so that the cache keeps the two verdicts apart."""
    name = f"plan:{spec}:full" if full else f"plan:{spec}"

    def run():
        from .census import build_census, census_findings

        census = (build_census([spec], mux_k=FULL_MUX_K, symmetry=True) if full
                  else build_census([spec]))
        return census_findings(census)

    return name, run


def _admission_surface(spec: str) -> Tuple[str, Runner]:
    """ADM001/ADM002: the spec's model has the packed interface, and
    ``spawn_xla`` builds its checker on the CPU at the spec's capacities.
    The model is resolved afresh, apart from the instances the kernel
    traces saw."""
    name = f"admission:{spec}"

    def run():
        from ..service.registry import resolve
        from ..xla import PACKED_ATTRS, is_packed

        model, caps = resolve(spec)
        if not is_packed(model):
            missing = [a for a in PACKED_ATTRS if not hasattr(model, a)]
            return [Finding(
                rule="ADM001", surface=name, file="", line=0,
                message=f"{type(model).__name__} lacks the packed interface: {', '.join(missing)}",
                excerpt="")]
        try:
            model.checker().spawn_xla(device=pin_cpu(), **caps)
        except Exception as e:  # noqa: BLE001 - the refusal IS the finding
            return [Finding(
                rule="ADM002", surface=name, file="", line=0,
                message=(f"spawn_xla refused {type(model).__name__}: "
                         f"{type(e).__name__}: {e}"),
                excerpt="")]
        return []

    return name, run


def _spec_surfaces(spec: str, full: bool = False) -> List[Tuple[str, Runner]]:
    """One spec's surfaces: its admission check and, for a packed model, its
    kernels and its census."""
    from ..service.registry import resolve
    from ..xla import is_packed

    model, _ = resolve(spec)
    out = [_admission_surface(spec)]
    if is_packed(model):
        out += _kernel_surfaces(spec, model)
        out.append(_census_surface(spec, full))
    return out


# --- the sweep --------------------------------------------------------------


def build_sweep(full: bool = False) -> List[Tuple[str, Runner]]:
    """Every (name, runner) of the sweep: each shipped spec's surfaces and
    each kernel source's. Runners trace lazily, so an ``--only``-filtered
    run costs only the surfaces it touches. ``full`` also prices the mux and
    symmetry capture classes of every plan."""
    from ..ops._cuda import SOURCES
    from ..service.registry import SHIPPED

    out: List[Tuple[str, Runner]] = []
    for spec in SHIPPED:
        out.extend(_spec_surfaces(spec, full))
    out.extend(_cuda_surface(name) for name in SOURCES)
    return out


def build_admission_sweep(spec: str) -> List[Tuple[str, Runner]]:
    """The admission-time flight-check for ONE spec: its admission check,
    kernel surfaces (STPU001) and capture census (STPU007), the subset a
    submitted model must pass before the pool schedules it. The CUDA
    surfaces are spec-independent and stay the full sweep's business.
    Raises ``ValueError`` for a spec that does not resolve."""
    return _spec_surfaces(spec)


def run_sweep(
    full: bool = False,
    only: Optional[List[str]] = None,
    *,
    admission_spec: Optional[str] = None,
    use_cache: bool = True,
    cache_dir: Optional[str] = None,
) -> List[SurfaceReport]:
    """Check every surface. ``only`` filters surface names by substring;
    ``admission_spec`` swaps the sweep for :func:`build_admission_sweep`
    over that one spec.

    The sweep is HERMETIC: every ``STPU_*`` environment knob is scrubbed for
    its duration (and restored after), so the verdict is a function of the
    tree, not of the caller's shell. The one exemption is ``STPU_FAMILIES``
    (service/registry.py's user-family hook): it selects which models
    exist, and scrubbing it would hide the very spec an admission check was
    asked to verify.

    ``use_cache`` replays raw findings from the content-hash cache
    (analysis/cache.py) for surfaces of an unchanged tree; errors, skips,
    the CUDA surfaces and a user family's surfaces (its source lies outside
    the tree the cache hashes) are never cached."""
    cache = None
    if use_cache and admission_spec is not None:
        from ..service.registry import FAMILIES, parse

        use_cache = parse(admission_spec)[0] in FAMILIES
    if use_cache:
        from .cache import SurfaceCache

        cache = SurfaceCache(cache_dir)

    reports: List[SurfaceReport] = []
    scrubbed = {
        k: os.environ.pop(k)
        for k in list(os.environ)
        if k.startswith("STPU_") and k != "STPU_FAMILIES"
    }
    try:
        sweep = (
            build_admission_sweep(admission_spec)
            if admission_spec is not None
            else build_sweep(full=full)
        )
        for name, runner in sweep:
            if only and not any(s in name for s in only):
                continue
            t0 = time.monotonic()
            rep = SurfaceReport(name=name)
            cacheable = cache is not None and not name.startswith("cuda:")
            hit = cache.get(name) if cacheable else None
            if hit is not None:
                rep.findings = hit
                rep.cached = True
            else:
                try:
                    result = runner()
                    rep.findings, rep.detail = result if isinstance(result, tuple) else (
                        result, {})
                    if cacheable:
                        cache.put(name, rep.findings)
                except SurfaceSkip as e:
                    rep.skipped = str(e)
                except Exception as e:  # noqa: BLE001 - not checked is not a pass
                    rep.error = f"{type(e).__name__}: {e}"
            rep.seconds = round(time.monotonic() - t0, 3)
            reports.append(rep)
    finally:
        os.environ.update(scrubbed)
    return reports
