"""Device resolution for the port's entry points."""

from __future__ import annotations

import typing as tp

import torch


def resolve_device(device: tp.Union[None, str, torch.device]) -> torch.device:
    """The device an entry point runs on. ``None`` means the card: the
    port's entry points run on CUDA unless the caller asks for the CPU,
    and raise rather than fall back when there is no card."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device
