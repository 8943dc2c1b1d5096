"""Per-cloud region graphs for diversity reasoning (counterpart of
ssdr_al_tpu/active/region_graph.py).

The reference's global adjacency exp(−(ED+CD)) is block-diagonal by cloud,
so each cloud is one block: ED is the Euclidean distance of bbox centres
(host numpy) and CD the pairwise chamfer (ops/chamfer.chamfer_pairwise_blocks,
kernel K3 on the device), padded into [C, S, S].

The TPU's shape ladders (_S_LADDER, _P_LADDER, _G_CHUNK) only bounded its
compiled-shape set; the port pads S to the round's largest cloud and P to
the slab width, and sends every cloud in one dispatch.

SuperpointBlockCache's `mxu` (--chamfer_mxu) is accepted as JAX's is, and
every setting runs the exact f32 K3: on the TPU it picks the bf16x3 chamfer kernel
(region_graph.py:43-62), which the port does not have.

Under data parallelism (a DataGroup, JAX's `mesh=`) the block axis C is
split over the ranks: the slab is on every rank, each rank runs K3 on its
contiguous share of blocks and the [C, S, S] result is gathered
(chamfer_pairwise_blocks_dp). JAX's gate `_G_CHUNK % mesh size` served its
shape ladder and has no counterpart: any C splits.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ssdr_al_torch.device import DEFAULT_DEVICE, resolve_device
from ssdr_al_torch.ops.chamfer import (
    chamfer_pairwise_blocks,
    chamfer_pairwise_blocks_dp,
)


@dataclasses.dataclass
class RegionRef:
    cloud_name: str
    sp_idx: int
    is_labeled: bool
    dominant_point_ids: np.ndarray


@dataclasses.dataclass
class RegionTable:
    """Flat region bookkeeping: row r is superpoint sp_idx[r] of cloud
    cloud_names[cloud_ids[r]]; its dominant point ids are
    arena[offsets[r]:offsets[r+1]] (a view)."""

    cloud_names: list
    cloud_ids: np.ndarray      # [R] int32
    sp_idx: np.ndarray         # [R] int64
    is_labeled: np.ndarray     # [R] bool
    arena: np.ndarray          # [M] int64
    offsets: np.ndarray        # [R+1] int64

    def __len__(self) -> int:
        return len(self.sp_idx)

    def dom_ids(self, r: int) -> np.ndarray:
        return self.arena[self.offsets[r]: self.offsets[r + 1]]

    def cloud_name(self, r: int) -> str:
        return self.cloud_names[self.cloud_ids[r]]

    @staticmethod
    def empty() -> "RegionTable":
        return RegionTable([], np.zeros(0, np.int32), np.zeros(0, np.int64),
                           np.zeros(0, bool), np.zeros(0, np.int64),
                           np.zeros(1, np.int64))


@dataclasses.dataclass
class RegionGraph:
    """Padded per-cloud blocks + flat bookkeeping. block_of/slot_of map a
    flat region index to (cloud block, in-block slot). timings: wall-clock
    seconds of build_region_graph's phases."""

    refs: List[RegionRef]
    cloud_names: List[str]
    block_of: np.ndarray        # [N] int32
    slot_of: np.ndarray         # [N] int32
    ed_cd: np.ndarray           # [C, S, S] float32: ED + CD per block
    mask: np.ndarray            # [C, S] bool
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def num_regions(self) -> int:
        return len(self.refs)


def bbox_center(points: np.ndarray) -> np.ndarray:
    """(min+max)/2 per axis (sampler2.py:570-573)."""
    return (points.min(axis=0) + points.max(axis=0)) / 2.0


def pad_regions_vectorized(
    xyz: np.ndarray,
    ids_list: List[np.ndarray],
    max_points: Optional[int],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(centroids [S,3], pts [S,P,3] centred, mask [S,P]) of the regions'
    points, P = largest region capped at max_points. Regions above the cap
    take np.linspace(0, L−1, P) points, endpoint pinned (pad_superpoints)."""
    s = len(ids_list)
    sizes = np.fromiter((len(i) for i in ids_list), np.int64, count=s)
    allids = np.concatenate(ids_list) if s else np.zeros(0, np.int64)
    offsets = np.zeros(s, np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    pts_all = xyz[allids].astype(np.float32, copy=False)
    mins = np.minimum.reduceat(pts_all, offsets, axis=0)
    maxs = np.maximum.reduceat(pts_all, offsets, axis=0)
    centroids = (mins + maxs) / 2.0

    p = int(sizes.max()) if s else 1
    if max_points is not None and p > max_points:
        p = max_points
    j = np.arange(p, dtype=np.int64)
    step = (sizes - 1) / max(p - 1, 1)
    pos = (j[None, :] * step[:, None]).astype(np.int64)
    pos[:, -1] = sizes - 1
    small = sizes <= p
    pos[small] = np.minimum(j[None, :], (sizes[small] - 1)[:, None])
    msk = j[None, :] < np.minimum(sizes, p)[:, None]
    idx = allids[offsets[:, None] + pos]
    pts = xyz[idx].astype(np.float32) - centroids[:, None, :]
    pts[~msk] = 0.0
    return centroids, pts, msk


class SuperpointBlockCache:
    """Every superpoint of every staged cloud, padded once and kept on the
    device as ONE slab: points [R+1, P, 3] f32 and mask [R+1, P] bool, the
    last row all-False (it fills padding slots). P is the widest padded
    superpoint over the staged clouds (at most max_points_per_sp); a
    narrower cloud's extra columns are masked, which leaves every chamfer
    value unchanged. Superpoint point sets are fixed for a run, so a round
    only uploads slab row indices."""

    def __init__(self, max_points_per_sp: Optional[int] = 512, *,
                 device: torch.device | str = DEFAULT_DEVICE,
                 mxu: Optional[bool] = None, group=None):
        self.cap = max_points_per_sp
        self.mxu = mxu        # every setting runs K3 (module docstring)
        self.device = resolve_device(device)
        self.group = group    # split the chamfer's blocks over its ranks
        self._host: List[tuple] = []            # (pts, msk) per staged cloud
        self._info: Dict[str, tuple] = {}       # name -> (base row, S)
        self._centroids: Dict[str, np.ndarray] = {}
        self._rows = 0
        self._slab = None                       # (pts, msk) on the device
        self._dirty = False

    def ensure(self, name: str, xyz: np.ndarray, components: List[np.ndarray]):
        """Stage a cloud's full superpoint set (no-op if already staged).
        An empty superpoint becomes an all-False row: chamfer puts 1e15
        against it, an isolated graph node."""
        if name in self._info:
            return
        empty = np.fromiter((len(c) == 0 for c in components), bool,
                            count=len(components))
        comps = [c if len(c) else np.zeros(1, np.int64) for c in components]
        centroids, pts, msk = pad_regions_vectorized(xyz, comps, self.cap)
        centroids[empty] = 0.0
        pts[empty] = 0.0
        msk[empty] = False
        self._host.append((pts, msk))
        self._info[name] = (self._rows, pts.shape[0])
        self._centroids[name] = centroids
        self._rows += pts.shape[0]
        self._dirty = True

    def finalize(self):
        """Upload the slab (again, from host copies, if clouds were staged
        since the last upload)."""
        if not self._dirty:
            return
        p = max(pts.shape[1] for pts, _ in self._host)
        pts_all = np.zeros((self._rows + 1, p, 3), np.float32)
        msk_all = np.zeros((self._rows + 1, p), bool)
        r = 0
        for pts, msk in self._host:
            pts_all[r:r + len(pts), :pts.shape[1]] = pts
            msk_all[r:r + len(msk), :msk.shape[1]] = msk
            r += len(pts)
        self._slab = (torch.from_numpy(pts_all).to(self.device),
                      torch.from_numpy(msk_all).to(self.device))
        self._dirty = False

    def centroids(self, name: str) -> np.ndarray:
        return self._centroids[name]

    def rows(self, name: str, sp_ids: np.ndarray) -> np.ndarray:
        """Slab row of each superpoint id of `name`."""
        base, s = self._info[name]
        sp_ids = np.asarray(sp_ids, np.int64)
        if sp_ids.size and (sp_ids.min() < 0 or sp_ids.max() >= s):
            raise IndexError(f"superpoint id out of range for {name}")
        return base + sp_ids

    @property
    def trash_row(self) -> int:
        return self._rows

    def chamfer(self, idx: np.ndarray) -> torch.Tensor:
        """Chamfer blocks of slab rows idx [C, S] → [C, S, S] on the device;
        with a group, each rank gathers and runs its share of the blocks."""
        if self._slab is None or self._dirty:
            raise RuntimeError("SuperpointBlockCache.finalize() not called")
        pts, msk = self._slab
        idx = np.asarray(idx, np.int64)
        if self.group is not None:
            part = self.group.share(len(idx))
            i = torch.from_numpy(idx[part]).to(self.device)
            return chamfer_pairwise_blocks_dp(pts[i], msk[i], self.group,
                                              len(idx))
        i = torch.from_numpy(idx).to(self.device)
        return chamfer_pairwise_blocks(pts[i], msk[i])


def build_region_graph(
    regions_by_cloud: Dict[str, List[Tuple[int, bool, np.ndarray]]],
    cloud_xyz: Optional[Dict[str, np.ndarray]] = None,
    components: Optional[Dict[str, List[np.ndarray]]] = None,
    *,
    max_points_per_sp: Optional[int] = 512,
    cache: Optional[SuperpointBlockCache] = None,
    device: torch.device | str = DEFAULT_DEVICE,
    group=None,
) -> RegionGraph:
    """regions_by_cloud: {cloud: [(sp_idx, is_labeled, dominant_point_ids)]}.

    ED = bbox-centre Euclidean distance (not squared, fps_gcn_cpu.py:96-98)
    + CD = pairwise chamfer of the superpoints' points, capped at
    max_points_per_sp by linspace subsampling. With a cache, points come
    from its device slab (and the cache's group splits the blocks);
    without one, the regions are padded here from cloud_xyz and
    components and uploaded to `device`, and a data-parallel group splits
    the blocks over its ranks."""
    device = cache.device if cache is not None else resolve_device(device)
    timings: Dict[str, float] = {}
    t0 = time.perf_counter()
    cloud_names = sorted(regions_by_cloud)
    c = len(cloud_names)
    s_max = max(len(v) for v in regions_by_cloud.values())
    centroids = []
    if cache is not None:
        idx = np.full((c, s_max), cache.trash_row, np.int64)
        for ci, name in enumerate(cloud_names):
            sp_ids = np.fromiter((sp for sp, _, _ in regions_by_cloud[name]),
                                 np.int64)
            idx[ci, :len(sp_ids)] = cache.rows(name, sp_ids)
            centroids.append(cache.centroids(name)[sp_ids])
        timings["pad_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cd_dev = cache.chamfer(idx)
    else:
        padded = []
        for name in cloud_names:
            comps = components[name]
            cen, pts, msk = pad_regions_vectorized(
                cloud_xyz[name], [comps[sp] for sp, _, _ in
                                  regions_by_cloud[name]], max_points_per_sp)
            centroids.append(cen)
            padded.append((pts, msk))
        p = max(pts.shape[1] for pts, _ in padded)
        pts_g = np.zeros((c, s_max, p, 3), np.float32)
        msk_g = np.zeros((c, s_max, p), bool)
        for ci, (pts, msk) in enumerate(padded):
            pts_g[ci, :pts.shape[0], :pts.shape[1]] = pts
            msk_g[ci, :msk.shape[0], :msk.shape[1]] = msk
        timings["pad_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if group is None:
            cd_dev = chamfer_pairwise_blocks(
                torch.from_numpy(pts_g).to(device),
                torch.from_numpy(msk_g).to(device))
        else:
            part = group.share(c)
            cd_dev = chamfer_pairwise_blocks_dp(
                torch.from_numpy(pts_g[part]).to(device),
                torch.from_numpy(msk_g[part]).to(device), group, c)
    cd = cd_dev.cpu().numpy()
    timings["chamfer_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    ed_cd = np.zeros((c, s_max, s_max), np.float32)
    mask = np.zeros((c, s_max), bool)
    refs: List[RegionRef] = []
    block_of, slot_of = [], []
    for ci, name in enumerate(cloud_names):
        regs = regions_by_cloud[name]
        cen = centroids[ci]
        diff = cen[:, None, :] - cen[None, :, :]
        ed = np.sqrt(np.maximum((diff * diff).sum(-1), 0.0))
        s = len(regs)
        ed_cd[ci, :s, :s] = ed + cd[ci, :s, :s]
        mask[ci, :s] = True
        for slot, (sp_idx, is_labeled, dom_ids) in enumerate(regs):
            refs.append(RegionRef(name, int(sp_idx), bool(is_labeled), dom_ids))
            block_of.append(ci)
            slot_of.append(slot)
    timings["assemble_s"] = time.perf_counter() - t0
    return RegionGraph(
        refs=refs, cloud_names=cloud_names,
        block_of=np.asarray(block_of, np.int32),
        slot_of=np.asarray(slot_of, np.int32),
        ed_cd=ed_cd, mask=mask, timings=timings,
    )


def flat_to_blocks(graph: RegionGraph, flat: np.ndarray, fill=0.0) -> np.ndarray:
    """Scatter flat per-region rows [N, D] into padded blocks [C, S, D]."""
    c, s = graph.mask.shape
    out = np.full((c, s, flat.shape[1]), fill, flat.dtype)
    out[graph.block_of, graph.slot_of] = flat
    return out


def blocks_to_flat(graph: RegionGraph, blocks: np.ndarray) -> np.ndarray:
    """Gather padded blocks [C, S, D] back to flat [N, D]."""
    return np.asarray(blocks)[graph.block_of, graph.slot_of]
