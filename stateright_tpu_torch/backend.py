"""Device resolution for the port's engine.

Counterpart of ``stateright_tpu/backend.py``, which probes a JAX backend
that may hang and falls back to the CPU. The port's rule is stricter and
needs no probe: the engine runs on ``cuda`` unless the caller asks for the
CPU by name, and never falls back to the CPU quietly. Every decision that
rests on the cards this process sees is made here, so that no caller
branches on a count of them; stpu-lint's STPU102 holds the package to it.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

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


def rank_device(process_id: int, device: Union[None, str, torch.device] = None) -> torch.device:
    """Rank ``process_id``'s device: ``cuda:(process_id % device_count)``
    unless ``device`` names one (an index of its own, or the CPU). Raises
    when a card is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if not cards:
            raise RuntimeError("a rank asked for a CUDA device and none is available; "
                               "pass device='cpu' to run the rank on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", process_id % cards)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def ordinal_device(ordinal: Optional[int]) -> Tuple[torch.device, Optional[str]]:
    """A service worker's card for its ``--device N``: ``cuda:N``, made
    current and labelled, when this machine has card N; otherwise the
    default card with no label (the reference's rule for an ordinal the
    machine lacks: another card, never the CPU). Raises where there is no
    card at all."""
    device = resolve_device(None)
    if ordinal is None or not 0 <= ordinal < torch.cuda.device_count():
        return device, None
    device = torch.device("cuda", ordinal)
    torch.cuda.set_device(device)
    return device, str(device)


def visible_cards(device: torch.device) -> int:
    """The cards a process on ``device`` sees: every CUDA card for a card
    (at least one, since ``device`` was resolved), none for the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 0


def card_of(device: torch.device) -> Optional[int]:
    """The index of the card ``device`` names (the current card for a bare
    ``cuda``); None for the CPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.current_device() if device.index is None else device.index


def make_current(device: Union[None, int, torch.device]) -> None:
    """Make ``device``'s card this thread's current one (an int is a card's
    index); nothing for the CPU or None."""
    if isinstance(device, int) or (device is not None and device.type == "cuda"):
        torch.cuda.set_device(device)


def platform_label() -> str:
    """The platform a default device of this process is on, as the
    ``stpu_build_info`` gauge labels it: ``cuda`` where a card is, else
    ``cpu``. A label only: the engine's default device still raises where
    there is no card (:func:`resolve_device`)."""
    return "cuda" if torch.cuda.is_available() else "cpu"
