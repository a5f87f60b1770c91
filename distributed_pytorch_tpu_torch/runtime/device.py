"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with
no explicit device and no CUDA device they raise instead of falling
back silently."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    device and raises when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' explicitly "
            "to run the port on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def default_generator(device: torch.device, seed: int) -> torch.Generator:
    """A fresh ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))
