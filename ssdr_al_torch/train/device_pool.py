"""Device-resident training pool: every training cloud stays on the card,
and each train step extracts its blocks there (counterpart of
ssdr_al_tpu/train/device_pool.py).

Training clouds do not change during an AL run; only the activation and
pseudo-label planes change between rounds. So the pool uploads every
cloud once, and per step the card receives only the [B] cloud ids and
the [B, 3] jittered picks that `sample_indices` draws on the host.

Block semantics are the host pipeline's (data/cloud.py::sample_block,
reference s3dis_dataset.py:115-154): a uniform random centre point plus
N(0, noise_init/10) jitter, the num_points points nearest the pick,
recentred on it, features [xyz, rgb]. `extract_blocks` returns them in
stable (d², index) order, as the JAX pool does, and clouds smaller than a
block are filled with random duplicates of their own points. The train
steps then shuffle each block (`shuffle_blocks`), as the host pipeline
does: the pyramid's subsample is the prefix of a block's rows
(RandLA-Net's random downsampling), and the prefix of a block in
distance order is its nearest points, a disk around the pick. The JAX
pooled step feeds the sorted order to its pyramid (ROADMAP.md §3); a
pool whose `blocks` is "sorted" feeds that order too, a control that
only scripts/flagship.py sets.

Layout: the clouds' rows concatenated, f32 xyz [T, 3] and f32 planes
[T, 6] = [rgb, label, activation, pseudo label], with per-cloud row
offsets. The JAX package's u16/u8 ragged arena and its 450 MB / 400 MB
single-buffer gates exist for the TPU's host link and its worker's 500 MB
buffer limit and are not ported; the pool is gated on the card's free
memory instead (`POOL_MEMORY_SHARE`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ssdr_al_torch.data.cloud import Cloud
from ssdr_al_torch.device import DEFAULT_DEVICE, resolve_device

# the row order a pooled step feeds its pyramid: "shuffled" (the default,
# the host pipeline's) or "sorted" (extract_blocks' distance order, the
# JAX pooled step's)
BLOCK_ORDERS = ("shuffled", "sorted")
# the share of the card's free memory (torch.cuda.mem_get_info, read when
# the pool is built) that the resident clouds and one step's extraction
# temporaries may take; the rest is the model's
POOL_MEMORY_SHARE = 0.5
RESIDENT_BYTES_PER_POINT = 36     # xyz 12 + planes 24
# per (block, cloud row) of one extraction: row ids 8, xyz 12, the f32 and
# f64 differences 36, d² and its f64 partial sums 20, sort keys and
# indices 12, masks, with headroom
EXTRACT_BYTES_PER_ROW = 96


def block_d2(xyz: torch.Tensor, pick: torch.Tensor) -> torch.Tensor:
    """f32 squared distance Σ (xyz − pick)² over the last axis, rounded as
    XLA's fused multiply-adds round it (the JAX package's extraction on
    the CPU): d = xyz − pick in f32, s = d₀², then s = fma(d₁, d₁, s) and
    s = fma(d₂, d₂, s), each a single rounding to f32 (the f64 product of
    two f32 values is exact). The same d² on every device."""
    d = (xyz - pick).double()
    s = (d[..., 0] * d[..., 0]).float()
    s = (d[..., 1] * d[..., 1] + s).float()
    return (d[..., 2] * d[..., 2] + s).float()


def _rows(group, x):
    """x, or this rank's rows of the global [B, ...] x."""
    return x if group is None else group.shard_rows(x)


def extract_blocks(xyz, planes, offsets, n, cloud_ids, picks,
                   num_points: int, window: int, generator: torch.Generator,
                   group=None):
    """Blocks of B clouds on the pool's device.

    xyz [T, 3] f32 and planes [T, 6] f32 (the pool's rows); offsets [C]
    and n [C] int64, each cloud's first row and size; cloud_ids [B] int64;
    picks [B, 3] f32; window ≥ the size of every cloud in cloud_ids and
    ≥ num_points, the rows read per block; generator draws the duplicates
    that fill a cloud smaller than a block.

    A block is the cloud's num_points points nearest the pick by
    block_d2, in stable (d², index) order; its positions past the cloud's
    size take random duplicates of its points. Returns (xyz [B, K, 3]
    recentred on the pick, features [B, K, 6] = [xyz, rgb], labels
    [B, K] int64, activation [B, K] f32, pseudo [B, K] int64).

    With a data-parallel group, cloud_ids and picks are the global batch's
    and the blocks this rank's rows of it; the duplicates' draw is made
    for the global batch and cut to the rows, so every rank advances the
    generator alike and the rows equal the single-device blocks."""
    b = cloud_ids.shape[0]
    cloud_ids, picks = _rows(group, cloud_ids), _rows(group, picks)
    dev = xyz.device
    iota = torch.arange(window, device=dev)
    first = offsets[cloud_ids]
    valid = n[cloud_ids]                                       # [B]
    rows = torch.clamp(first[:, None] + iota, max=xyz.shape[0] - 1)
    d2 = block_d2(xyz[rows], picks[:, None, :])
    d2 = torch.where(iota < valid[:, None], d2, torch.inf)
    order = torch.sort(d2, dim=1, stable=True).indices         # [B, P]
    idx = order[:, :num_points]
    dup = (_rows(group, torch.rand((b, num_points), generator=generator,
                                   device=dev)) * valid[:, None]).long()
    dup = torch.minimum(dup, valid[:, None] - 1)
    pos = torch.arange(num_points, device=dev)
    idx = torch.where(pos < valid[:, None], idx, torch.gather(order, 1, dup))
    return _block_payload(xyz, planes, first[:, None] + idx, picks)


def shuffle_blocks(blocks, generator: torch.Generator, group=None):
    """The [B, K, ...] tensors of a batch of blocks with each block's rows
    in one random order (a permutation a block, from `generator`), so the
    prefix the pyramid keeps is a random subsample of the block. With a
    data-parallel group the blocks are this rank's rows and their
    permutations its rows of the global batch's draw."""
    b, k = blocks[0].shape[:2]
    m = 1 if group is None else group.size
    perm = torch.argsort(_rows(group, torch.rand(
        (b * m, k), generator=generator, device=blocks[0].device)), dim=1)
    return tuple(torch.gather(t, 1, perm.reshape(
        (b, k) + (1,) * (t.dim() - 2)).expand_as(t)) for t in blocks)


def _block_payload(xyz, planes, rows, centre):
    """(xyz − centre, [xyz − centre, rgb], labels, activation, pseudo) of
    the pool rows [B, K]; centre [B, 3]."""
    bxyz = xyz[rows] - centre[:, None, :]
    pl = planes[rows]
    return (bxyz, torch.cat([bxyz, pl[..., :3]], -1), pl[..., 3].long(),
            pl[..., 4], pl[..., 5].long())


def device_budget(device: torch.device) -> Optional[int]:
    """Bytes the pool may take on `device`: POOL_MEMORY_SHARE of the
    card's free memory, or None (no gate) on the CPU."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[0] * POOL_MEMORY_SHARE)


class DeviceTrainPool:
    """Every training cloud resident on `device`; step indices drawn on
    the host.

    The cloud cycle, centre and jitter draws are TrainingPipeline's and
    the JAX pool's, draw for draw: a reshuffled cloud cycle, a uniform
    centre point, N(0, noise_init/10) pick jitter, all from one
    RandomState(seed). `available` is False when the resident clouds and
    one step's extraction would take more than device_budget(device);
    callers then keep the host pipeline. `blocks` (BLOCK_ORDERS) is the
    row order the pooled steps made after it is set feed their pyramid."""

    blocks = "shuffled"

    def __init__(self, clouds: List[Cloud], cfg, *,
                 pseudo_gt: Optional[Dict[str, np.ndarray]] = None,
                 seed: int = 0, device: torch.device | str = DEFAULT_DEVICE):
        self.cfg = cfg
        self.clouds = clouds
        self.device = resolve_device(device)
        self.rng = np.random.RandomState(seed)
        self._order = np.arange(len(clouds))
        self._pos = len(clouds)  # reshuffle on first use
        ns = self.sizes = np.asarray([c.num_points for c in clouds],
                                     np.int64)
        # the most rows a block reads: every cloud fits, and
        # order[:, :num_points] is a full slice even when every cloud is
        # smaller than a block
        self.window = max(int(ns.max()), cfg.num_points)
        budget = device_budget(self.device)
        self.available = budget is None or \
            self.footprint(int(ns.sum())) <= budget
        if not self.available:
            return
        offs = np.zeros(len(clouds), np.int64)
        offs[1:] = np.cumsum(ns[:-1])
        planes = np.zeros((int(ns.sum()), 6), np.float32)
        planes[:, :3] = np.concatenate([c.colors for c in clouds])
        planes[:, 3] = np.concatenate([c.labels for c in clouds])
        dev = self.device
        self.xyz = torch.from_numpy(np.concatenate(
            [np.asarray(c.xyz, np.float32) for c in clouds])).to(dev)
        self.planes = torch.from_numpy(planes).to(dev)
        self.offsets = torch.from_numpy(offs).to(dev)
        self.n = torch.from_numpy(ns).to(dev)
        self.generator = torch.Generator(dev).manual_seed(seed)
        self.update_pseudo_gt(pseudo_gt)

    def footprint(self, total_points: int) -> int:
        """Bytes of the resident clouds and of one step's extraction."""
        return (RESIDENT_BYTES_PER_POINT * total_points
                + EXTRACT_BYTES_PER_ROW * self.cfg.batch_size * self.window)

    # --------------------------------------------------------- per round ---
    def update_pseudo_gt(self, pseudo_gt: Optional[Dict[str, np.ndarray]]):
        """Upload the round's activation and pseudo-label planes (the
        other planes stay). pseudo_gt=None means fully supervised:
        activation 1, pseudo labels = labels."""
        if pseudo_gt is None:
            dyn = np.stack([np.ones(len(self.planes), np.float32),
                            np.concatenate([c.labels for c in self.clouds])],
                           1)
        else:
            dyn = np.concatenate([np.stack(pseudo_gt[c.name][:2], 1)
                                  for c in self.clouds])
        self.planes[:, 4:6] = torch.from_numpy(
            dyn.astype(np.float32)).to(self.device)

    def reseed(self, seed: int):
        """Reset the host sampling stream and the duplicate generator (one
        fresh TrainingPipeline per AL round, as the host path has)."""
        self.rng = np.random.RandomState(seed)
        self._order = np.arange(len(self.clouds))
        self._pos = len(self.clouds)
        self.generator.manual_seed(seed)

    # ------------------------------------------------------------- steps ---
    def _next_cloud_idx(self) -> int:
        if self._pos >= len(self._order):
            self.rng.shuffle(self._order)
            self._pos = 0
        i = int(self._order[self._pos])
        self._pos += 1
        return i

    def sample_indices(self, batch_size: int):
        """Host-side per-step draw: (cloud_ids [B] int32, picks [B, 3] f32)."""
        ids = np.empty(batch_size, np.int32)
        picks = np.empty((batch_size, 3), np.float32)
        sigma = self.cfg.noise_init / 10
        for b in range(batch_size):
            ci = self._next_cloud_idx()
            ids[b] = ci
            cl = self.clouds[ci]
            center = cl.xyz[self.rng.randint(0, cl.num_points)]
            picks[b] = center + self.rng.normal(scale=sigma, size=3)
        return ids, picks

    def device_args(self):
        return self.xyz, self.planes, self.offsets, self.n

    def extract(self, cloud_ids, picks, group=None, window=None):
        """extract_blocks of ids [B] and picks [B, 3]: host arrays,
        uploaded here (the only upload of a pooled step), or tensors on
        the pool's device. window: the rows a block reads; None reads as
        many as the batch's largest cloud has (host ids). The trainer's
        captured step (trainer.make_static_step) passes its static device
        ids and picks and `self.window`, the pool's largest cloud, for
        every batch, as JAX's jitted step does: the same blocks, since rows
        past a cloud's size sort last (d² inf) and the duplicates index
        below its size. With a data-parallel group, this rank's rows of
        the global batch's blocks."""
        if window is None:
            window = max(int(self.sizes[np.asarray(cloud_ids)].max()),
                         self.cfg.num_points)
        ids = torch.as_tensor(cloud_ids, dtype=torch.long,
                              device=self.device)
        picks = torch.as_tensor(picks, dtype=torch.float32,
                                device=self.device)
        return extract_blocks(*self.device_args(), ids, picks,
                              self.cfg.num_points, window, self.generator,
                              group)

    # ------------------------------------------------------------ oracle ---
    def extract_host(self, cloud_ids, picks):
        """Numpy oracle of extract_blocks without the small-cloud
        duplicates: per sample, the stable argsort of block_d2 on the
        cloud's f32 coordinates, cut to num_points."""
        out = []
        for ci, pick in zip(cloud_ids, picks):
            cl = self.clouds[int(ci)]
            d2 = block_d2(torch.from_numpy(np.asarray(cl.xyz, np.float32)),
                          torch.from_numpy(np.asarray(pick, np.float32)))
            out.append(np.argsort(d2.numpy(), kind="stable")[
                : self.cfg.num_points])
        return out
