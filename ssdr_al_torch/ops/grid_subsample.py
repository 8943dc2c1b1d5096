"""Voxel-grid subsampling: barycenter of points and features, majority
label (the counterpart of ssdr_al_tpu/ops/grid_subsample.py).

  - voxel index = floor((p − origin)/dl) with origin = floor(min/dl)·dl
  - output point   = mean of the points in the voxel (barycenter)
  - output feature = mean of the features in the voxel
  - output label   = majority vote in the voxel (ties → smallest label id)
  - voxels in ascending flat key (iz, iy, ix) order

`grid_subsample_np` is the offline preprocessing path (numpy, a copy of
JAX's); `grid_subsample_torch` is the padded variant of
`grid_subsample_jax` on the caller's device. The C++ path of native/ is
partition/cp.py::grid_subsample_native.
"""

from __future__ import annotations

import numpy as np
import torch


def _voxel_keys(points: np.ndarray, grid_size: float):
    min_corner = points.min(axis=0)
    origin = np.floor(min_corner / grid_size) * grid_size
    ij = np.floor((points - origin) / grid_size).astype(np.int64)
    max_corner = points.max(axis=0)
    nx = int(np.floor((max_corner[0] - origin[0]) / grid_size)) + 1
    ny = int(np.floor((max_corner[1] - origin[1]) / grid_size)) + 1
    return ij[:, 0] + nx * ij[:, 1] + nx * ny * ij[:, 2]


def grid_subsample_np(points, features=None, labels=None, grid_size=0.1):
    """points [N,3] float32; features [N,F] optional; labels [N] int
    optional. Returns points / (points, features) / (points, labels) /
    (points, features, labels), as the reference wrapper
    (helper_tool.py:227-235)."""
    points = np.asarray(points, np.float32)
    keys = _voxel_keys(points, float(grid_size))
    uniq, inv, counts = np.unique(keys, return_inverse=True,
                                  return_counts=True)
    s = len(uniq)

    sub_points = np.zeros((s, 3), np.float64)
    np.add.at(sub_points, inv, points.astype(np.float64))
    sub_points = (sub_points / counts[:, None]).astype(np.float32)

    out = [sub_points]
    if features is not None:
        features = np.asarray(features)
        sub_feat = np.zeros((s, features.shape[1]), np.float64)
        np.add.at(sub_feat, inv, features.astype(np.float64))
        out.append((sub_feat / counts[:, None]).astype(np.float32))
    if labels is not None:
        labels = np.asarray(labels).astype(np.int64).ravel()
        num_classes = int(labels.max()) + 1
        hist = np.zeros((s, num_classes), np.int64)
        np.add.at(hist, (inv, labels), 1)
        out.append(hist.argmax(axis=1).astype(np.int32))
    return out[0] if len(out) == 1 else tuple(out)


def grid_subsample_torch(points: torch.Tensor, grid_size: float,
                         max_voxels: int, features=None, labels=None,
                         num_classes=None):
    """The padded variant on points' device: (sub_points [V, 3], sub_feat
    [V, F] or None, sub_labels [V] int32 or None, valid [V] bool) with
    V = max_voxels, voxels in ascending flat key, rows past the voxel
    count zero (labels 0); voxels past max_voxels are dropped, as JAX's
    segment sums drop them. Voxel sums are index_add_ of f32 rows."""
    points = points.float()
    dev = points.device
    origin = torch.floor(points.amin(0) / grid_size) * grid_size
    ij = torch.floor((points - origin) / grid_size).long()
    span = torch.floor((points.amax(0) - origin) / grid_size).long() + 1
    keys = ij[:, 0] + span[0] * ij[:, 1] + span[0] * span[1] * ij[:, 2]
    uniq, seg = torch.unique(keys, sorted=True, return_inverse=True)
    valid = torch.arange(max_voxels, device=dev) < len(uniq)
    keep = seg < max_voxels
    seg = seg[keep]
    ones = torch.ones(len(seg), dtype=torch.float32, device=dev)
    cnt = torch.zeros(max_voxels, dtype=torch.float32, device=dev)
    cnt.index_add_(0, seg, ones)
    cnt_safe = torch.clamp(cnt, min=1.0)[:, None]

    def mean_of(x):
        acc = torch.zeros((max_voxels, x.shape[1]), dtype=torch.float32,
                          device=dev)
        return acc.index_add_(0, seg, x[keep].float()) / cnt_safe

    sub_points = mean_of(points)
    sub_feat = None if features is None else mean_of(features)
    sub_labels = None
    if labels is not None:
        hist = torch.zeros((max_voxels, num_classes), dtype=torch.int32,
                           device=dev)
        hist.index_put_((seg, labels[keep].long()), ones.int(),
                        accumulate=True)
        sub_labels = torch.argmax(hist, dim=1).to(torch.int32)
    return sub_points, sub_feat, sub_labels, valid
