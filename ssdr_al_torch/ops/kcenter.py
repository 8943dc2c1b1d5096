"""k-Center-Greedy core-set selection on the device (counterpart of
ssdr_al_tpu/ops/kcenter.py; reference kcenterGreedy.py:84-128).

A chunked minimum distance from every point to the labeled set, one
eager pass as JAX's lax.scan, then the greedy loop, JAX's lax.fori_loop:
each step picks the point farthest from everything selected, writes it
at a device-side step counter and updates the running minimum in place
with one distance row, with no host sync. The steps run through
train/graphs.py::run_steps (on the card GRAPH_WARMUP eager steps, then
replays of one captured step; on the CPU a Python loop of the step).
Distances are Euclidean through the expanded form |a|² + |b|² − 2a·b with
its products in full f32 (JAX's Precision.HIGHEST): TF32 is off around
the eager steps and the capture alike, so the captured GEMV is the eager
one.
"""

from __future__ import annotations

import torch

from ssdr_al_torch.device import full_f32_matmul
from ssdr_al_torch.ops import fps
from ssdr_al_torch.train.graphs import run_steps


def kcenter_steps(features: torch.Tensor, already_selected: torch.Tensor,
                  batch_size: int, chunk: int = 1024):
    """(step, sel): the chunked init run now, then each step() writes the
    next of batch_size picks into sel [batch_size] int64. Call the steps
    inside full_f32_matmul()."""
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
    t = torch.zeros(1, dtype=torch.long, device=dev)     # the next pick's

    def step():
        pick = torch.argmax(torch.where(mask, neg, min_d)).view(1)
        sel.index_copy_(0, t, pick)
        t.add_(1)
        row = feats.index_select(0, pick)[0]
        d2 = sq + sq.index_select(0, pick) - 2.0 * (feats @ row)
        torch.minimum(min_d, torch.sqrt(torch.clamp(d2, min=0.0)),
                      out=min_d)

    return step, sel


def kcenter_greedy(features: torch.Tensor, already_selected: torch.Tensor,
                   batch_size: int, chunk: int = 1024, *,
                   eager: bool = False) -> torch.Tensor:
    """features [N, D]; already_selected [N] bool (the labeled set), on the
    features' device. Returns [batch_size] int64 indices of the new picks.
    Labeled points are never picked; a pick's own distance falls to ~0, so
    it is not picked again (kcenterGreedy.py:118). With no labeled point
    every distance starts at inf and the first pick is index 0, as
    jnp.argmax over equal values. eager=True: the steps eagerly on the
    card too."""
    step, sel = kcenter_steps(features, already_selected, batch_size, chunk)
    with full_f32_matmul():
        run_steps(step, batch_size, features.device, eager=eager,
                  min_replays=fps.MIN_REPLAYS, name="kcenter_greedy")
    return sel
