"""Device resolution shared by every entry point of the port.

The port runs on a CUDA card.  ``None`` means the card; only an explicit
``"cpu"`` puts the work on the host (the tests do so), so a host without a
card never quietly runs the model on its CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if the resolved device is CUDA and no card
    is visible.  Any other explicit device is taken as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the host explicitly")
    return dev


def generator(seed: int, device: DeviceLike = None) -> torch.Generator:
    """An explicit ``torch.Generator`` on ``device``, seeded with ``seed``."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def maybe_synchronize(device: Optional[torch.device]) -> None:
    """Wait for the card, so that a host clock around the work measures it."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
