"""Full SPG partition pipeline: prune → geof → cut-pursuit → superpoint graph
(the counterpart of ssdr_al_tpu/partition/spg.py).

Parity with the inherited superpoint-graph tooling
(partition/partition.py:126-190 in the reference): for a raw cloud, prune it
on a voxel grid (with label histograms), compute geometric features, solve the
L0 minimal partition, and build the superpoint graph with superedge features —
the artifact consumed by SPG-style downstream models.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ssdr_al_torch.device import DEFAULT_DEVICE
from ssdr_al_torch.ops.grid_subsample import grid_subsample_np
from ssdr_al_torch.partition.sp_graph import compute_sp_graph
from ssdr_al_torch.partition.superpoint import partition_cloud


def spg_pipeline(
    xyz: np.ndarray,
    rgb: np.ndarray,
    labels: Optional[np.ndarray],
    *,
    prune_size: float = 0.0,
    reg_strength: float = 0.03,
    k_adj: int = 10,
    k_geof: int = 45,
    lambda_edge_weight: float = 1.0,
    d_max: float = 5.0,
    n_labels: Optional[int] = None,
    knn_backend: str = "auto",
    device=DEFAULT_DEVICE,
):
    """Returns dict(xyz, rgb, labels, components, in_component, sp_graph).

    prune_size > 0 runs the voxel prune first (partition.py:126-151 —
    `libply_c.prune` semantics via grid subsampling with majority labels).
    The partition's KNN search and geof run on `device`."""
    xyz = np.asarray(xyz, np.float32)
    rgb = np.asarray(rgb, np.float32)
    if prune_size > 0:
        if labels is not None:
            xyz, rgb, labels = grid_subsample_np(
                xyz, features=rgb, labels=labels, grid_size=prune_size
            )
        else:
            xyz, rgb = grid_subsample_np(xyz, features=rgb, grid_size=prune_size)

    components, in_component = partition_cloud(
        xyz, rgb, reg_strength,
        k_adj=k_adj, k_geof=min(k_geof, len(xyz) - 1),
        lambda_edge_weight=lambda_edge_weight, knn_backend=knn_backend,
        device=device,
    )
    if labels is not None and n_labels is None:
        n_labels = int(np.max(labels)) + 1
    graph = compute_sp_graph(
        xyz, d_max, in_component, components,
        labels if labels is not None else np.zeros(1),
        n_labels or 1,
    )
    return {
        "xyz": xyz,
        "rgb": rgb,
        "labels": labels,
        "components": components,
        "in_component": in_component,
        "sp_graph": graph,
    }
