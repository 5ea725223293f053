"""Device resolution for the port's entry points."""

from __future__ import annotations

import os
import typing as tp

import torch


def local_rank() -> tp.Optional[int]:
    """``torch.distributed.run``'s ``LOCAL_RANK`` (this process's place
    among the ranks of its host), or None outside a launch."""
    value = os.environ.get("LOCAL_RANK")
    return None if value is None else int(value)


def resolve_device(device: tp.Union[None, str, torch.device],
                   local_rank: tp.Optional[int] = None) -> torch.device:
    """The device an entry point runs on. ``None`` means the card: the
    port's entry points run on CUDA unless the caller asks for the CPU,
    and raise rather than fall back when there is no card. With a
    ``local_rank``, a CUDA device without an index is that rank's card,
    ``cuda:<local_rank>``."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if device.type == "cuda" and device.index is None and local_rank is not None:
        device = torch.device("cuda", local_rank)
    return device


def device_scalar(x: tp.Union[int, torch.Tensor],
                  device: torch.device) -> torch.Tensor:
    """``x`` as an int32 ``[1]`` tensor on ``device``: a tensor is
    reshaped (its dtype kept if int32), an int filled in on the device
    (no host tensor, no copy)."""
    if isinstance(x, torch.Tensor):
        return x.reshape(1).to(torch.int32)
    return torch.full((1,), int(x), dtype=torch.int32, device=device)
