"""Superpoint-graph construction with superedge features (the counterpart
of ssdr_al_tpu/partition/sp_graph.py, numpy and scipy on the host).

Same output contract as the reference's `compute_sp_graph`
(partition/graphs.py:72-207): Delaunay interface edges between different
components, grouped into superedges with geometric descriptors
(sp_centroids / length / surface / volume / point_count, se_delta_* and
ratio features). The reference loops superedges in Python; here every
per-superpoint and per-superedge statistic is a vectorized segment reduction.
"""

from __future__ import annotations

import numpy as np


def _sp_shape_features(xyz, components):
    """Per-superpoint centroid + eigen shape features (graphs.py:146-178)."""
    n_com = len(components)
    centroids = np.zeros((n_com, 3), np.float32)
    length = np.zeros((n_com, 1), np.float32)
    surface = np.zeros((n_com, 1), np.float32)
    volume = np.zeros((n_com, 1), np.float32)
    count = np.zeros((n_com, 1), np.uint64)
    for i, comp in enumerate(components):
        pts = np.unique(xyz[comp], axis=0)
        count[i] = len(comp)
        centroids[i] = pts.mean(0)
        if len(pts) == 2:
            length[i] = np.sqrt(np.sum(np.var(pts, axis=0)))
        elif len(pts) > 2:
            ev = np.linalg.eigvalsh(np.cov(pts.T))[::-1]  # descending
            ev = np.maximum(ev, 0)
            length[i] = ev[0]
            surface[i] = np.sqrt(ev[0] * ev[1] + 1e-10)
            volume[i] = np.sqrt(ev[0] * ev[1] * ev[2] + 1e-10)
    return centroids, length, surface, volume, count


def compute_sp_graph(xyz, d_max, in_component, components, labels, n_labels):
    """Build the superpoint graph (reference graphs.py:72-207 contract)."""
    from scipy.spatial import Delaunay

    xyz = np.asarray(xyz, np.float32)
    in_component = np.asarray(in_component)
    n_com = int(in_component.max()) + 1
    has_labels = np.size(labels) > 1
    labels = np.asarray(labels) if has_labels else None

    # --- Delaunay interface edges (both directions) ---
    tri = Delaunay(xyz)
    simplex = tri.simplices
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    edges = []
    for a, b in pairs:
        va, vb = simplex[:, a], simplex[:, b]
        interface = in_component[va] != in_component[vb]
        edges.append(np.stack([va[interface], vb[interface]]))
        edges.append(np.stack([vb[interface], va[interface]]))
    edges = np.unique(np.hstack(edges), axis=1)
    if d_max > 0:
        dist = np.sqrt(((xyz[edges[0]] - xyz[edges[1]]) ** 2).sum(1))
        edges = edges[:, dist < d_max]

    # --- group edges into superedges by (source comp, target comp) ---
    edge_comp = in_component[edges]
    key = edge_comp[0].astype(np.int64) * n_com + edge_comp[1]
    order = np.argsort(key)
    edges = edges[:, order]
    edge_comp = edge_comp[:, order]
    key = key[order]
    uniq_key, sedg_of_edge, se_count = np.unique(
        key, return_inverse=True, return_counts=True
    )
    n_sedg = len(uniq_key)

    centroids, length, surface, volume, count = _sp_shape_features(xyz, components)

    graph = {"is_nn": False}
    graph["sp_centroids"] = centroids
    graph["sp_length"] = length
    graph["sp_surface"] = surface
    graph["sp_volume"] = volume
    graph["sp_point_count"] = count
    if has_labels:
        hist = np.zeros((n_com, n_labels + 1), np.uint32)
        if labels.ndim > 1 and labels.shape[1] > 1:
            for i, comp in enumerate(components):
                hist[i] = labels[comp].sum(0)
        else:
            for i, comp in enumerate(components):
                hist[i] = np.bincount(
                    labels[comp].astype(np.int64), minlength=n_labels + 1
                )[: n_labels + 1]
        graph["sp_labels"] = hist
    else:
        graph["sp_labels"] = []

    src_com = (uniq_key // n_com).astype(np.uint32)
    tgt_com = (uniq_key % n_com).astype(np.uint32)
    graph["source"] = src_com[:, None]
    graph["target"] = tgt_com[:, None]

    # --- vectorized superedge offsets ---
    delta = xyz[edges[0]] - xyz[edges[1]]                  # [E, 3]
    cnt = se_count.astype(np.float64)[:, None]
    sums = np.zeros((n_sedg, 3))
    np.add.at(sums, sedg_of_edge, delta)
    mean = sums / cnt
    sq = np.zeros((n_sedg, 3))
    np.add.at(sq, sedg_of_edge, delta.astype(np.float64) ** 2)
    var = np.maximum(sq / cnt - mean**2, 0.0)
    norms = np.zeros(n_sedg)
    np.add.at(norms, sedg_of_edge, np.sqrt((delta**2).sum(1)))

    graph["se_delta_mean"] = mean.astype(np.float32)
    graph["se_delta_std"] = np.sqrt(var).astype(np.float32)
    graph["se_delta_norm"] = (norms / cnt[:, 0])[:, None].astype(np.float32)
    graph["se_delta_centroid"] = (
        centroids[src_com] - centroids[tgt_com]
    ).astype(np.float32)
    graph["se_length_ratio"] = length[src_com] / (length[tgt_com] + 1e-6)
    graph["se_surface_ratio"] = surface[src_com] / (surface[tgt_com] + 1e-6)
    graph["se_volume_ratio"] = volume[src_com] / (volume[tgt_com] + 1e-6)
    graph["se_point_count_ratio"] = (
        count[src_com].astype(np.float32) / (count[tgt_com].astype(np.float32) + 1e-6)
    )
    return graph
