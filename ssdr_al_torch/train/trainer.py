"""Inference half of the trainer (counterpart of ssdr_al_tpu/train/trainer.py):
the eval step, fresh weights and torch checkpoints.

A model state is a `state_dict` (parameters and BatchNorm statistics) on
the device; the eval step runs the module functionally on it
(torch.func.functional_call), as flax's `model.apply(variables, ...)` does.
The train step, Adam and the device pool come with the training slice.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.func import functional_call

from ssdr_al_torch.config import Config
from ssdr_al_torch.models.randlanet import (
    RandLANet,
    SortedPyramid,
    build_pyramid,
    init_params,
)

__all__ = ["init_params", "make_eval_step", "save_checkpoint",
           "restore_checkpoint"]


def make_eval_step(model: RandLANet, cfg: Config, knn_engine: str = "window",
                   sorted_outputs: bool = True, *,
                   device: torch.device | str = "cpu"):
    """Return eval_step(state, batch) → (probs, penult[, order]).

    batch: {"xyz": [B, N, 3], "features": [B, N, 6]} numpy or tensors;
    state: a state_dict of `model` on `device`. probs are the softmax of
    the logits, penult the 32-d penultimate features.

    sorted_outputs=True adds `order` [B, N] int32 and, on a sorted pyramid,
    leaves probs and penult in morton-sorted row order (row r is input row
    order[r]); callers permute their host index maps instead of the device
    rows. On an exact pyramid (engine "xla") order is the identity."""
    device = torch.device(device)

    def eval_step(state, batch):
        xyz = torch.as_tensor(np.asarray(batch["xyz"]), dtype=torch.float32,
                              device=device)
        feats = torch.as_tensor(np.asarray(batch["features"]),
                                dtype=torch.float32, device=device)
        with torch.inference_mode():
            pyramid = build_pyramid(xyz, cfg, engine=knn_engine)
            sorted_mode = sorted_outputs and isinstance(pyramid, SortedPyramid)
            logits, penult = functional_call(
                model, state, (feats, pyramid), {"unsort": not sorted_mode})
            probs = torch.softmax(logits, dim=-1)
            if not sorted_outputs:
                return probs, penult
            if sorted_mode:
                order = pyramid.order
            else:
                b, n = xyz.shape[:2]
                order = torch.arange(n, dtype=torch.int32,
                                     device=device).expand(b, n)
            return probs, penult, order

    return eval_step


def save_checkpoint(path: str, state: dict):
    """Save a state_dict (tensors moved to the CPU)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state.items()}, path)


def restore_checkpoint(path: str, device: torch.device | str) -> dict:
    """Load a state_dict saved by save_checkpoint onto `device`."""
    return torch.load(path, map_location=device, weights_only=True)
