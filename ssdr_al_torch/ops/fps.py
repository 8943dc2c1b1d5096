"""Farthest-feature sampling (counterpart of ssdr_al_tpu/ops/fps.py).

The greedy loop runs on the features' device with no host sync per step:
each step is one distance row, a running minimum and an argmax.
"""

from __future__ import annotations

import torch

_BIG = 1e10  # the reference's initial distance (fps_gcn_cpu.py:135)


def farthest_feature_sample(features: torch.Tensor, start_idx: int,
                            sample_number: int,
                            valid_mask: torch.Tensor | None = None):
    """Greedy FPS in feature space with squared L2 distance.

    features [N, D]; start_idx: first pick; valid_mask [N] bool, invalid
    rows are never picked. Returns [sample_number] int64. Ties go to the
    lowest index (torch.argmax returns the first maximum, as jnp.argmax)."""
    n = features.shape[0]
    features = features.float()
    dev = features.device
    if valid_mask is None:
        valid_mask = torch.ones(n, dtype=torch.bool, device=dev)
    sel = torch.empty(sample_number, dtype=torch.long, device=dev)
    sel[0] = int(start_idx)
    distance = torch.full((n,), _BIG, dtype=torch.float32, device=dev)
    neg = torch.tensor(-1.0, device=dev)
    for i in range(sample_number - 1):
        cur = features.index_select(0, sel[i:i + 1])               # [1, D]
        d = ((features - cur) ** 2).sum(-1)
        distance = torch.minimum(distance, d)
        sel[i + 1] = torch.argmax(torch.where(valid_mask, distance, neg))
    return sel
