"""Resolution of the ``spawn_xla(symmetry=)`` / ``STPU_SYMMETRY`` surface.

Counterpart of ``stateright_tpu/sym/resolve.py``, with the same modes, tags
and error messages.

Modes (arg wins over env; env default ``"auto"``):

- ``"auto"`` — honor the builder: symmetry is on iff the checker was
  built with ``.symmetry()`` / ``.symmetry_fn()``. A model that ships a
  ``symmetry_spec`` then canonicalizes through the spec-compiled kernel
  automatically (no hand-written per-model device code).
- ``"on"`` / ``1`` / ``True`` — force symmetry on, builder or not (the
  env form makes any model CLI's ``check`` symmetry-reduced:
  ``STPU_SYMMETRY=1 python -m stateright_tpu_torch.models.two_phase_commit
  check 5``). Requires the model to ship a spec or a
  ``packed_representative``; otherwise :class:`SymmetryUnsupported`.
- ``"off"`` / ``0`` / ``False`` — force symmetry off (the A/B knob; an
  explicit user choice, so a ``.symmetry()`` builder runs full-space).

When enabled, the kernel is chosen by capability:

1. ``model.symmetry_spec`` (a :class:`SymmetrySpec`) — the compiled
   class-invariant canonicalization; tag ``spec:<hash12>``.
2. ``model.packed_representative`` — the model's hand-written batched
   form (``[N, W] -> [N, W]`` rows; it may be a partial canonicalization,
   whose counts then depend on the traversal order); tag
   ``model:packed_representative``.
3. neither — :class:`SymmetryUnsupported` naming the engine.

The device canonicalization takes and returns plane-major ``[W, N]``
tensors on either path.
"""

from __future__ import annotations

import os
from typing import Any, Callable, NamedTuple, Optional

from .kernel import compile_canon, host_canonicalizer
from .spec import SymmetrySpec, SymmetryUnsupported


class ResolvedSymmetry(NamedTuple):
    """What the engine stores: ``enabled``; ``tag`` (the program-cache and
    checkpoint identity: None when off, ``spec:<hash12>`` or
    ``model:packed_representative`` when on); the device canonicalization
    over ``[W, N]`` planes; and the host-row canonicalizer (None on the
    packed_representative path, which round-trips through the object
    ``representative()``)."""

    enabled: bool
    tag: Optional[str]
    device_canon: Optional[Callable[[Any], Any]]
    host_canon: Optional[Callable[[Any], Any]]


OFF = ResolvedSymmetry(False, None, None, None)

_ON = ("on", "1", "true", "yes")
_OFF = ("off", "0", "false", "no")


def _mode(symmetry) -> str:
    if symmetry is None:
        symmetry = os.environ.get("STPU_SYMMETRY", "auto")
    if symmetry is True:
        return "on"
    if symmetry is False:
        return "off"
    s = str(symmetry).strip().lower()
    if s in _ON:
        return "on"
    if s in _OFF:
        return "off"
    if s in ("auto", ""):
        return "auto"
    raise ValueError(
        f"symmetry must be auto/on/off (STPU_SYMMETRY), got {symmetry!r}"
    )


def resolve_symmetry(
    symmetry, builder_requested: bool, model, engine: str, store: Optional[dict] = None
) -> ResolvedSymmetry:
    """Resolve the knob for one engine instance (see module docstring).
    ``builder_requested`` is whether the CheckerBuilder carries a
    ``.symmetry()`` / ``.symmetry_fn()`` request; ``engine`` names the
    caller for the typed refusal; ``store`` keeps the device
    canonicalization's index tables (:func:`compile_canon`)."""
    mode = _mode(symmetry)
    enabled = builder_requested if mode == "auto" else (mode == "on")
    if not enabled:
        return OFF
    spec = getattr(model, "symmetry_spec", None)
    if spec is not None:
        if not isinstance(spec, SymmetrySpec):
            raise SymmetryUnsupported(
                engine,
                f"{type(model).__name__}.symmetry_spec is "
                f"{type(spec).__name__}, expected SymmetrySpec",
            )
        if spec.max_word >= model.state_words:
            raise SymmetryUnsupported(
                engine,
                f"{type(model).__name__}.symmetry_spec touches word "
                f"{spec.max_word} but state_words={model.state_words}",
            )
        return ResolvedSymmetry(
            True,
            f"spec:{spec.spec_hash()[:12]}",
            compile_canon(spec, store),
            host_canonicalizer(spec),
        )
    if hasattr(model, "packed_representative"):

        def device_canon(planes):
            return model.packed_representative(planes.T).T

        return ResolvedSymmetry(True, "model:packed_representative", device_canon, None)
    raise SymmetryUnsupported(
        engine,
        f"{type(model).__name__} ships neither a symmetry_spec nor "
        f"packed_representative (actor-framework and register models "
        f"embed block references in message/history fields, which a "
        f"block permutation alone cannot rewrite)",
    )
