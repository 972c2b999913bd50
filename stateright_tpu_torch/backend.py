"""Device resolution for the port's engine.

Counterpart of ``stateright_tpu/backend.py``, which probes a JAX backend
that may hang and falls back to the CPU. The port's rule is stricter and
needs no probe: the engine runs on ``cuda`` unless the caller asks for the
CPU by name, and never falls back to the CPU quietly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the first CUDA card, and raises when there is none;
    ``"cpu"`` runs every kernel's plain PyTorch version instead."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "spawn_xla() runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
