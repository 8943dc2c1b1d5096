"""k-Center-Greedy core-set selection on the device (counterpart of
ssdr_al_tpu/ops/kcenter.py; reference kcenterGreedy.py:84-128).

A chunked minimum distance from every point to the labeled set, then the
greedy loop: each step picks the point farthest from everything selected
and updates the running minimum with one distance row, with no host sync.
Distances are Euclidean through the expanded form |a|² + |b|² − 2a·b with
its products in full f32 (JAX's Precision.HIGHEST).
"""

from __future__ import annotations

import torch

from ssdr_al_torch.device import full_f32_matmul


def kcenter_greedy(features: torch.Tensor, already_selected: torch.Tensor,
                   batch_size: int, chunk: int = 1024) -> torch.Tensor:
    """features [N, D]; already_selected [N] bool (the labeled set), on the
    features' device. Returns [batch_size] int64 indices of the new picks.
    Labeled points are never picked; a pick's own distance falls to ~0, so
    it is not picked again (kcenterGreedy.py:118). With no labeled point
    every distance starts at inf and the first pick is index 0, as
    jnp.argmax over equal values."""
    feats = features.float()
    n = feats.shape[0]
    dev = feats.device
    mask = already_selected.to(device=dev, dtype=torch.bool)
    with full_f32_matmul():
        sq = (feats * feats).sum(-1)
        min_d = torch.full((n,), float("inf"), device=dev)
        lab = torch.nonzero(mask)[:, 0]
        for c0 in range(0, lab.numel(), chunk):
            centers = feats.index_select(0, lab[c0:c0 + chunk])
            d2 = sq[:, None] + sq.index_select(0, lab[c0:c0 + chunk])[None] \
                - 2.0 * (feats @ centers.T)
            min_d = torch.minimum(
                min_d, torch.sqrt(torch.clamp(d2, min=0.0)).amin(1))
        min_d = torch.where(mask, 0.0, min_d)
        sel = torch.empty(batch_size, dtype=torch.long, device=dev)
        neg = torch.tensor(-1.0, device=dev)
        for t in range(batch_size):
            pick = torch.argmax(torch.where(mask, neg, min_d))
            sel[t] = pick
            row = feats.index_select(0, pick.view(1))[0]
            d2 = sq + sq.index_select(0, pick.view(1)) - 2.0 * (feats @ row)
            min_d = torch.minimum(min_d, torch.sqrt(torch.clamp(d2, min=0.0)))
    return sel
