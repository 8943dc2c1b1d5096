"""The device of the port's entry points: the card unless the caller asks
for the CPU, and never the CPU in place of a missing card."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: torch.device | str) -> torch.device:
    """torch.device(device), raising when it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev
