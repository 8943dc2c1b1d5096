"""Device-resident possibility-scheduled training pool: the Semantic3D
training path (counterpart of ssdr_al_tpu/train/possibility_pool.py).

The Semantic3D trainer feeds possibility-scheduled, augmented blocks
(data/dataset.py::PossibilityTrainingPipeline, the reference's train2
generator, semantic3d_dataset_train.py:135-210): each block centres on the
least-visited point of the least-visited cloud, and its points' visit
count ("possibility") grows by (1 − d²/d²max)² · class_frequency. Block
b + 1's centre depends on block b's update, so the B blocks of a step are
a sequential chain. The pool runs that chain on the card inside the
train step, with the field threaded through the steps as state; the host
sends nothing per step.

Semantics of the host pipeline, not its random stream: N(0, noise_init/10)
pick jitter, the num_points nearest points by f32 d² (block_d2, stable
(d², index) order; the train step shuffles each block, as the host
pipeline does, device_pool.shuffle_blocks), xyz recentred in x and y
only (z stays absolute,
semantic3d_dataset_train.py:182), the update over the block's true points,
and the feature copy of xyz augmented (rotation about z, scale
U[0.8, 1.2]³, an x-flip, σ = 0.001 noise; tf_augment_input,
semantic3d_dataset_train.py:237-276). Jitter, duplicates and augmentation
come from the pool's torch.Generator, so the distribution is the JAX
pool's and the bits are not.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ssdr_al_torch.data.cloud import Cloud
from ssdr_al_torch.device import DEFAULT_DEVICE
from ssdr_al_torch.train.device_pool import (
    DeviceTrainPool,
    _block_payload,
    block_d2,
)

# the field [T] f32, its static buffer [T] f32 and each row's cloud id
# [T] int64
FIELD_BYTES_PER_POINT = 16


class PossibilityDevicePool(DeviceTrainPool):
    """DeviceTrainPool plus a possibility field on the card and the class
    frequencies of the training labels. The field is the trainer's state:
    `init_possibility` starts a round, `poss_state` holds it between
    epochs (the trainer stores a copy there). `field` is the static buffer
    that the trainer's steps update in place (a captured step reads and
    writes the same tensor at every replay): the trainer fills it from
    poss_state, or init_possibility, at a round's start."""

    def __init__(self, clouds: List[Cloud], cfg, *,
                 pseudo_gt: Optional[Dict[str, np.ndarray]] = None,
                 seed: int = 0, device: torch.device | str = DEFAULT_DEVICE,
                 augment: bool = True):
        super().__init__(clouds, cfg, pseudo_gt=pseudo_gt, seed=seed,
                         device=device)
        self.augment = augment
        if not self.available:
            return
        # class frequencies over all training clouds
        # (semantic3d_dataset_train.py:52-56)
        counts = np.bincount(np.hstack([c.labels for c in clouds]),
                             minlength=cfg.num_classes).astype(np.float64)
        self.class_weight = torch.from_numpy(
            (counts / counts.sum()).astype(np.float32)).to(self.device)
        self.cloud_of_row = torch.repeat_interleave(
            torch.arange(len(clouds), device=self.device), self.n)
        self.reset_possibility(seed)
        self.field = torch.empty_like(self.init_possibility)

    def footprint(self, total_points: int) -> int:
        return super().footprint(total_points) + \
            FIELD_BYTES_PER_POINT * total_points

    def device_args(self):
        return super().device_args() + (self.cloud_of_row,)

    def reset_possibility(self, seed: int):
        """A fresh U[0, 1e-3) field from RandomState(seed), cloud by cloud
        as the JAX pool draws it (the host pipeline draws a new field per
        AL round)."""
        rng = np.random.RandomState(seed)
        poss = np.concatenate([rng.rand(c.num_points) * 1e-3
                               for c in self.clouds]).astype(np.float32)
        self.init_possibility = torch.from_numpy(poss).to(self.device)
        self.poss_state = None


def possibility_extract(xyz, planes, offsets, n, cloud_of_row, class_weight,
                        poss, generator: torch.Generator, batch_size: int,
                        num_points: int, noise_sigma: float, window: int,
                        augment: bool = True):
    """A batch of possibility-scheduled blocks and the updated field.

    The pool's tensors (DeviceTrainPool.extract_blocks' xyz, planes,
    offsets, n, and cloud_of_row [T]); class_weight [num_classes] f32;
    poss [T] f32, the field; generator draws the jitter, the duplicates
    and the augmentation. Each of the B blocks in turn: the cloud with the
    least minimum, its least-visited point plus N(0, noise_sigma) jitter,
    the num_points nearest points (random duplicates past a small cloud's
    size), then the field over the block's true points += (1 −
    d²/d²max)² · class_weight[label]. Returns (new poss, xyz [B, K, 3]
    recentred in x and y, features [B, K, 6] = [xyz or its augmented copy,
    rgb], labels, activation, pseudo)."""
    dev = xyz.device
    c = n.shape[0]
    last_row = xyz.shape[0] - 1
    iota = torch.arange(window, device=dev)
    pos = torch.arange(num_points, device=dev)
    # each cloud's least value, kept up to date below (the per-step
    # segment min of the JAX scan, without a pass over the whole field);
    # every row's cloud id is in range, so no mask (a masked select would
    # sync with the host)
    cloud_min = torch.full((c,), torch.inf, device=dev).scatter_reduce_(
        0, cloud_of_row, poss, "amin")
    poss = poss.clone()
    jitter = torch.randn((batch_size, 3), generator=generator,
                         device=dev) * noise_sigma
    dup_u = torch.rand((batch_size, num_points), generator=generator,
                       device=dev)
    firsts, idxs, picks = [], [], []
    for b in range(batch_size):
        # [1]-shaped device indices throughout: no host synchronisation
        ci = torch.argmin(cloud_min).reshape(1)
        first, nc = offsets[ci], n[ci]
        rows = torch.clamp(first + iota, max=last_row)             # [P]
        inside = iota < nc
        pi = torch.argmin(torch.where(inside, poss[rows], torch.inf))
        xyz_c = xyz[rows]                                          # [P, 3]
        pick = xyz_c[pi.reshape(1)] + jitter[b]                    # [1, 3]
        d2 = torch.where(inside, block_d2(xyz_c, pick), torch.inf)
        order = torch.sort(d2, stable=True).indices
        dup = torch.minimum((dup_u[b] * nc).long(), nc - 1)
        idx = torch.where(pos < nc, order[:num_points], order[dup])
        # the update over the true block points (duplicates add nothing:
        # the host pipeline indexes each point once)
        in_block = pos < torch.clamp(nc, max=num_points)
        d2_blk = torch.where(in_block, d2[idx], 0.0)
        dmax = torch.clamp(d2_blk.max(), min=1e-12)
        lab = planes[first + idx, 3].long()
        delta = torch.where(in_block, torch.square(1.0 - d2_blk / dmax)
                            * class_weight[lab], 0.0)
        poss.index_add_(0, first + idx, delta)
        cloud_min.index_put_(
            (ci,), torch.where(inside, poss[rows], torch.inf).min()
            .reshape(1))
        firsts.append(first)
        idxs.append(idx)
        picks.append(pick)
    first = torch.cat(firsts)
    picks = torch.cat(picks)                                       # [B, 3]
    # recentre x and y only; z stays absolute
    centre = torch.cat([picks[:, :2], torch.zeros_like(picks[:, 2:])], 1)
    bxyz, feats, labels, act, pseudo = _block_payload(
        xyz, planes, first[:, None] + torch.stack(idxs), centre)
    if augment:
        feats = torch.cat([augment_xyz(bxyz, generator), feats[..., 3:]], -1)
    return poss, bxyz, feats, labels, act, pseudo


def augment_xyz(xyz: torch.Tensor, generator: torch.Generator):
    """tf_augment_input's distribution on xyz [B, K, 3]: a rotation about
    z by U[0, 2π), scale U[0.8, 1.2] per axis, x negated with probability
    1/2, then N(0, 0.001²) noise; one draw per block."""
    b = xyz.shape[0]
    dev = xyz.device
    theta = torch.rand(b, generator=generator, device=dev) * (2 * np.pi)
    cth, sth = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(cth), torch.ones_like(cth)
    rot = torch.stack([torch.stack([cth, -sth, zero], -1),
                       torch.stack([sth, cth, zero], -1),
                       torch.stack([zero, zero, one], -1)], 1)    # [B, 3, 3]
    out = torch.einsum("bkj,bji->bki", xyz, rot)
    scale = 0.8 + 0.4 * torch.rand((b, 1, 3), generator=generator,
                                   device=dev)
    flip = torch.where(torch.rand((b, 1, 1), generator=generator,
                                  device=dev) < 0.5, -1.0, 1.0)
    sym = torch.cat([flip, torch.ones((b, 1, 2), device=dev)], -1)
    out = out * scale * sym
    return out + 0.001 * torch.randn(out.shape, generator=generator,
                                     device=dev)
