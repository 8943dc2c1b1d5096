"""The device of the port's entry points: the card unless the caller asks
for the CPU, and never the CPU in place of a missing card."""

from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def full_f32_matmul():
    """Products in full f32 inside the block (TF32 off for matmuls and
    cuDNN), as JAX's precision=HIGHEST; the previous settings after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
