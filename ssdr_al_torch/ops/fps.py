"""Farthest-feature and farthest-superpoint sampling (counterpart of
ssdr_al_tpu/ops/fps.py).

Each greedy loop is JAX's lax.fori_loop: a static step (one distance row,
a running minimum updated in place, an argmax) that reads the last pick
at a device-side step counter, writes the next pick after it and
advances the counter, so no step syncs with the host. The steps run
through train/graphs.py::run_steps: on the card GRAPH_WARMUP eager steps,
then one captured step replayed for the rest, bitwise the eager steps'
arithmetic; on the CPU a Python loop of the same step.
"""

from __future__ import annotations

import torch

from ssdr_al_torch.train.graphs import run_steps

_BIG = 1e10  # the reference's initial distance (fps_gcn_cpu.py:135)
# a greedy loop on the card runs eagerly unless it replays at least this
# many steps after its GRAPH_WARMUP eager ones: below it the capture
# costs more than the launches it saves (train/step_times.py
# --greedy-loops on an H100, PERF.md §6)
MIN_REPLAYS = 64


def farthest_feature_steps(features: torch.Tensor, start_idx: int,
                           sample_number: int,
                           valid_mask: torch.Tensor | None = None):
    """(step, sel): sel [sample_number] int64 holds start_idx first; each
    step() writes the next pick of the greedy FPS over `features` (squared
    L2) after the last one, sample_number − 1 steps in all. Ties go to the
    lowest index (torch.argmax returns the first maximum, as jnp.argmax);
    rows where valid_mask is False are never picked."""
    n = features.shape[0]
    features = features.float()
    dev = features.device
    if valid_mask is None:
        valid_mask = torch.ones(n, dtype=torch.bool, device=dev)
    sel = torch.empty(sample_number, dtype=torch.long, device=dev)
    sel[0] = int(start_idx)
    distance = torch.full((n,), _BIG, dtype=torch.float32, device=dev)
    neg = torch.tensor(-1.0, device=dev)
    i = torch.zeros(1, dtype=torch.long, device=dev)     # the last pick's

    def step():
        cur = features.index_select(0, sel.index_select(0, i))     # [1, D]
        d = ((features - cur) ** 2).sum(-1)
        torch.minimum(distance, d, out=distance)
        nxt = torch.argmax(torch.where(valid_mask, distance, neg))
        i.add_(1)
        sel.index_copy_(0, i, nxt.view(1))

    return step, sel


def farthest_feature_sample(features: torch.Tensor, start_idx: int,
                            sample_number: int,
                            valid_mask: torch.Tensor | None = None, *,
                            eager: bool = False) -> torch.Tensor:
    """Greedy FPS in feature space with squared L2 distance.

    features [N, D]; start_idx: first pick; valid_mask [N] bool, invalid
    rows are never picked. Returns [sample_number] int64. The steps of
    farthest_feature_steps through run_steps (eager=True: eagerly on the
    card too)."""
    step, sel = farthest_feature_steps(features, start_idx, sample_number,
                                       valid_mask)
    run_steps(step, sample_number - 1, features.device, eager=eager,
              min_replays=MIN_REPLAYS, name="farthest_feature_sample")
    return sel


def farthest_superpoint_steps(centroids_xyz: torch.Tensor,
                              extra_dist: torch.Tensor, trigger_idx: int,
                              sample_number: int):
    """(step, sel) of the FPS over superpoints (sampler2.py:49-80, the
    edcd branch): the step distance is the squared Euclidean distance of
    the bbox centres plus the precomputed row extra_dist[cur] (the
    pairwise chamfer). sel [sample_number] int64 holds trigger_idx first;
    each step() writes the next pick; ties go to the lowest index."""
    c = centroids_xyz.float()
    s = c.shape[0]
    dev = c.device
    sel = torch.empty(sample_number, dtype=torch.long, device=dev)
    sel[0] = int(trigger_idx)
    distance = torch.full((s,), _BIG, dtype=torch.float32, device=dev)
    i = torch.zeros(1, dtype=torch.long, device=dev)

    def step():
        cur = sel.index_select(0, i)
        diff = c - c.index_select(0, cur)                          # [S, 3]
        ed = (diff * diff).sum(-1)
        d = ed + extra_dist.index_select(0, cur)[0]
        torch.minimum(distance, d, out=distance)
        i.add_(1)
        sel.index_copy_(0, i, torch.argmax(distance).view(1))

    return step, sel


def farthest_superpoint_sample(centroids_xyz: torch.Tensor,
                               extra_dist: torch.Tensor, trigger_idx: int,
                               sample_number: int, *,
                               eager: bool = False) -> torch.Tensor:
    """FPS over superpoints: centroids_xyz [S, 3]; extra_dist [S, S] on
    the same device; trigger_idx: the first pick. Returns [sample_number]
    int64: the steps of farthest_superpoint_steps through run_steps
    (eager=True: eagerly on the card too)."""
    step, sel = farthest_superpoint_steps(centroids_xyz, extra_dist,
                                          trigger_idx, sample_number)
    run_steps(step, sample_number - 1, centroids_xyz.device, eager=eager,
              min_replays=MIN_REPLAYS, name="farthest_superpoint_sample")
    return sel
