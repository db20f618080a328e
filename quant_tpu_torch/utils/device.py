"""Device selection for the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU by
name. A machine without a GPU raises instead of falling back to the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "check_on"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises when a CUDA device is asked for and
    this machine has none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


def check_on(t: torch.Tensor, dev: torch.device, what: str) -> None:
    """Raise unless ``t`` lies on ``dev`` (never moves it silently)."""
    if t.device.type != dev.type or (
            dev.index is not None and t.device.index != dev.index):
        raise ValueError(f"{what} is on {t.device}, expected {dev}")
