"""In-memory clouds and spatial block queries (a copy of
ssdr_al_tpu/data/cloud.py): flat arrays per cloud, an O(N) argpartition
for the num_points nearest to a block centre, and the fixed-size blocks the
training and evaluation pipelines stack into batches."""

from __future__ import annotations

import dataclasses
import glob
import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from ssdr_al_torch.data.ply import read_ply


@dataclasses.dataclass
class Cloud:
    """One subsampled cloud: [N, 3] f32 xyz, [N, 3] f32 colours in 0..1,
    [N] int32 labels. proj_idx / full_labels carry the full-resolution
    reprojection (`<name>_proj.pkl`): proj_idx[i] is the sub point nearest
    to full-resolution point i, full_labels[i] its true label."""

    name: str
    xyz: np.ndarray
    colors: np.ndarray
    labels: np.ndarray
    proj_idx: Optional[np.ndarray] = None
    full_labels: Optional[np.ndarray] = None

    @property
    def num_points(self) -> int:
        return len(self.xyz)


def load_cloud(ply_path: str) -> Cloud:
    data = read_ply(ply_path)
    xyz = np.vstack((data["x"], data["y"], data["z"])).T.astype(np.float32)
    colors = np.vstack((data["red"], data["green"], data["blue"])).T.astype(
        np.float32)
    labels = np.asarray(data["class"]).astype(np.int32)
    name = os.path.basename(ply_path)[:-4]
    proj_idx = full_labels = None
    proj_path = ply_path[:-4] + "_proj.pkl"
    if os.path.exists(proj_path):
        with open(proj_path, "rb") as f:
            proj_idx, full_labels = pickle.load(f)
        proj_idx = np.asarray(proj_idx).astype(np.int64)
        full_labels = np.asarray(full_labels).astype(np.int32)
    return Cloud(name=name, xyz=np.ascontiguousarray(xyz),
                 colors=np.ascontiguousarray(colors), labels=labels,
                 proj_idx=proj_idx, full_labels=full_labels)


def load_clouds(input_dir: str, *, include=None, exclude=None) -> List[Cloud]:
    """Every cloud of an input_<grid>/ directory, sorted by file name;
    include / exclude filter on a substring of the cloud name."""
    out = []
    for path in sorted(glob.glob(os.path.join(input_dir, "*.ply"))):
        name = os.path.basename(path)[:-4]
        if include is not None and include not in name:
            continue
        if exclude is not None and exclude in name:
            continue
        out.append(load_cloud(path))
    return out


def knn_block_query(xyz: np.ndarray, center: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k nearest points to `center` (unordered), O(N)."""
    d2 = np.sum((xyz - center[None, :]) ** 2, axis=1)
    if k >= len(xyz):
        return np.arange(len(xyz))
    return np.argpartition(d2, k)[:k]


@dataclasses.dataclass
class Block:
    """One fixed-size network input block."""

    xyz: np.ndarray          # [N, 3] centred on the pick point
    features: np.ndarray     # [N, 6] = [xyz, rgb]
    labels: np.ndarray       # [N] int32
    activation: np.ndarray   # [N] float32
    pseudo: np.ndarray       # [N] int32
    point_idx: np.ndarray    # [N] int32 indices into the source cloud
    cloud_idx: int


def sample_block(
    cloud: Cloud,
    num_points: int,
    rng: np.random.RandomState,
    *,
    activation: Optional[np.ndarray] = None,
    pseudo: Optional[np.ndarray] = None,
    center_idx: Optional[int] = None,
    noise_sigma: float = 0.35,
    whole_cloud: bool = False,
) -> Block:
    """Spatially regular block: a random centre point (or `center_idx`)
    jittered by N(0, σ), its num_points nearest (or the whole cloud),
    shuffled and centred on the pick; clouds smaller than num_points are
    upsampled with replacement."""
    pts = cloud.xyz
    if center_idx is None:
        center_idx = rng.randint(0, len(pts))
    center = pts[center_idx]
    pick = center + rng.normal(scale=noise_sigma, size=3).astype(np.float32)

    if whole_cloud or len(pts) < num_points:
        idx = np.arange(len(pts))
    else:
        idx = knn_block_query(pts, pick, num_points)

    rng.shuffle(idx)
    if activation is None:
        activation = np.ones(len(pts), np.float32)
    if pseudo is None:
        pseudo = cloud.labels.astype(np.float32)

    target = len(idx) if whole_cloud else num_points
    if len(idx) < target:
        dup = rng.choice(len(idx), target - len(idx))
        idx = np.concatenate([idx, idx[dup]])

    xyz = pts[idx] - pick[None, :]
    feats = np.concatenate([xyz, cloud.colors[idx]], axis=1).astype(np.float32)
    return Block(
        xyz=xyz.astype(np.float32),
        features=feats,
        labels=cloud.labels[idx].astype(np.int32),
        activation=np.asarray(activation)[idx].astype(np.float32),
        pseudo=np.asarray(pseudo)[idx].astype(np.int32),
        point_idx=idx.astype(np.int32),
        cloud_idx=-1,
    )


def stack_blocks(blocks: List[Block]) -> Dict[str, np.ndarray]:
    """Collate blocks into one batch dict of [B, N, ...] arrays."""
    return {
        "xyz": np.stack([b.xyz for b in blocks]),
        "features": np.stack([b.features for b in blocks]),
        "labels": np.stack([b.labels for b in blocks]),
        "activation": np.stack([b.activation for b in blocks]),
        "pseudo": np.stack([b.pseudo for b in blocks]),
        "point_idx": np.stack([b.point_idx for b in blocks]),
        "cloud_idx": np.asarray([b.cloud_idx for b in blocks], np.int32),
    }
