"""Utilities (counterpart of ``stateright_tpu/utils``): for now only
:func:`variant`. The symmetry rewrite plans wait for the symmetry slice."""

from .variant import variant

__all__ = ["variant"]
