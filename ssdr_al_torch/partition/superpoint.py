"""Superpoint partition: KNN graphs → geof → cut-pursuit → registry (the
counterpart of ssdr_al_tpu/partition/superpoint.py).

Per cloud, with the semantics of partition/compute_superpoint.py:20-89:
  1. the 10-NN adjacency graph and the 45-NN geometric-feature
     neighbourhoods in one search of k_geof + 1 = 46 neighbours, self
     included (compute_graph_nn_2, partition/graphs.py:23-70): on the card
     kernel K6 (ops/knn.py::knn_tiled, its K = 64 instantiation), on the
     host scipy's cKDTree;
  2. linearity, planarity, scattering, verticality (ops/geof.py, on the
     entry point's device, on the same neighbourhoods);
  3. partition features [geof, rgb] with verticality ×2
     (compute_superpoint.py:54-55);
  4. edge weights 1/(λ_edge + d/mean d) (compute_superpoint.py:57-59);
  5. L0 cut-pursuit (native C++, partition/cp.py), on the host: features,
     edges and weights come to the host once;
  6. <cloud>.superpoint, a zeroed <cloud>.gt and the total.pkl registry.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ssdr_al_torch.active.state import ALState
from ssdr_al_torch.data.cloud import Cloud
from ssdr_al_torch.device import DEFAULT_DEVICE, resolve_device
from ssdr_al_torch.ops.geof import geometric_features
from ssdr_al_torch.ops.knn import knn_tiled
from ssdr_al_torch.partition.cp import cutpursuit

KNN_BACKENDS = ("auto", "device", "host")


def resolve_backend(backend: str, device: torch.device) -> str:
    """"auto" is "device" (K6) when the entry point's device is the card,
    else "host" (cKDTree), as JAX's "auto" is "device" on the TPU."""
    if backend not in KNN_BACKENDS:
        raise ValueError(f"knn backend {backend!r} not in {KNN_BACKENDS}")
    if backend == "auto":
        return "device" if device.type == "cuda" else "host"
    return backend


class _Timer:
    """Stage times of one cloud: CUDA events on the card (read after the
    host copy that ends the cloud's device work), the host clock on the
    CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = {}

    def mark(self, name: str):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks[name] = ev
        else:
            self.marks[name] = time.perf_counter()

    def ms(self, a: str, b: str) -> float:
        if self.cuda:
            return self.marks[a].elapsed_time(self.marks[b])
        return 1e3 * (self.marks[b] - self.marks[a])


def _neighbours(xyz_t: torch.Tensor, xyz: np.ndarray, k: int, k_adj: int,
                backend: str, timer: Optional[_Timer] = None):
    """(neighbours [N, k - 1] int32 without column 0 (self) on xyz_t's
    device, distances [N, k_adj] f32 numpy to columns 1..k_adj); `timer`
    marks "knn" right after the search."""
    if backend == "device":
        idx = knn_tiled(xyz_t[None], xyz_t[None], k)[0]
        if timer is not None:
            timer.mark("knn")
        # the distances as JAX's device path computes them: f32 numpy
        # sqrt(sum of squares), in the same order of operations
        nb = xyz_t[idx[:, 1:k_adj + 1].long()]
        dx, dy, dz = (xyz_t[:, None, a] - nb[..., a] for a in range(3))
        d = torch.sqrt((dx * dx + dy * dy) + dz * dz).cpu().numpy()
        return idx[:, 1:], d
    from scipy.spatial import cKDTree

    d, idx = cKDTree(xyz).query(xyz, k=k)
    if timer is not None:
        timer.mark("knn")
    return (torch.from_numpy(idx[:, 1:].astype(np.int32)).to(xyz_t.device),
            d[:, 1:k_adj + 1].astype(np.float32))


def _graph(n, neighbours, distances, k_adj, k_geof):
    adj = neighbours[:, :k_adj].cpu().numpy()
    source = np.repeat(np.arange(n, dtype=np.uint32), adj.shape[1])
    target = adj.astype(np.uint32).ravel()
    return source, target, distances.astype(np.float32).ravel(), \
        neighbours[:, :k_geof]


def knn_graph(xyz: np.ndarray, k_adj: int, k_geof: int,
              backend: str = "auto", device=DEFAULT_DEVICE):
    """The k_adj-NN graph with its distances and the k_geof-NN targets,
    self excluded (compute_graph_nn_2, graphs.py:23-70), from one search of
    min(k_geof + 1, N) neighbours whose column 0 is taken as self.

    Returns (source [N·k_adj] u32, target [N·k_adj] u32, distances
    [N·k_adj] f32, target_geof [N, k_geof] int32) as numpy arrays. The
    "device" backend runs K6 on `device` (exact; JAX's TPU path is
    approx_min_k), "host" scipy's cKDTree, "auto" the device on a card."""
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    xyz = np.asarray(xyz, np.float32)
    k = min(k_geof + 1, len(xyz))
    nb, d = _neighbours(torch.from_numpy(xyz).to(dev), xyz, k, k_adj,
                        backend)
    source, target, distances, target_geof = _graph(len(xyz), nb, d, k_adj,
                                                    k_geof)
    return source, target, distances, \
        target_geof.cpu().numpy().astype(np.int32)


def partition_cloud(xyz: np.ndarray, rgb: np.ndarray, reg_strength: float,
                    *, k_adj: int = 10, k_geof: int = 45,
                    lambda_edge_weight: float = 1.0,
                    knn_backend: str = "auto", device=DEFAULT_DEVICE,
                    times: Optional[dict] = None):
    """One cloud → (components, in_component), as compute_superpoint.py:
    46-64. The KNN search and geof run on `device`; `times`, when given,
    gains the cloud's knn_ms, geof_ms and cutpursuit_s."""
    dev = resolve_device(device)
    backend = resolve_backend(knn_backend, dev)
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    timer = _Timer(dev)
    xyz_t = torch.from_numpy(xyz).to(dev)
    timer.mark("start")
    nb, distances = _neighbours(xyz_t, xyz, min(k_geof + 1, n), k_adj,
                                backend, timer)
    source, target, distances, target_geof = _graph(n, nb, distances,
                                                    k_adj, k_geof)
    timer.mark("geof_start")
    geof = geometric_features(xyz_t, target_geof)
    timer.mark("geof")
    geof = geof.cpu().numpy()
    features = np.hstack([geof, np.asarray(rgb, np.float32)]).astype(
        np.float32)
    features[:, 3] *= 2.0  # verticality boost (compute_superpoint.py:55)
    edge_weight = (1.0 / (lambda_edge_weight + distances / distances.mean())
                   ).astype(np.float32)
    t0 = time.perf_counter()
    out = cutpursuit(features, source, target, edge_weight, reg_strength)
    if times is not None:
        times.update(knn_backend=backend, knn_ms=timer.ms("start", "knn"),
                     geof_ms=timer.ms("geof_start", "geof"),
                     cutpursuit_s=time.perf_counter() - t0)
    return out


def compute_superpoints(clouds: List[Cloud], state: ALState,
                        reg_strength: float, *, k_adj: int = 10,
                        k_geof: int = 45, lambda_edge_weight: float = 1.0,
                        knn_backend: str = "auto", device=DEFAULT_DEVICE,
                        log=print, times: Optional[list] = None) -> dict:
    """All training clouds → superpoint files and the total.pkl registry
    (compute_superpoint.py:20-89). `times`, when given, gains one dict a
    cloud: its name, points, superpoints and partition_cloud's stage
    times."""
    device = resolve_device(device)   # no card: raise before any work
    total_obj = {"unlabeled": {}}
    sp_num = file_num = point_num = 0
    for cloud in clouds:
        t = {}
        components, in_component = partition_cloud(
            cloud.xyz, cloud.colors, reg_strength, k_adj=k_adj,
            k_geof=k_geof, lambda_edge_weight=lambda_edge_weight,
            knn_backend=knn_backend, device=device, times=t)
        state.write_superpoints(cloud.name, components, in_component,
                                cloud.num_points)
        total_obj["unlabeled"][cloud.name] = np.arange(len(components))
        sp_num += len(components)
        file_num += 1
        point_num += cloud.num_points
        log(f"partition {cloud.name}: {cloud.num_points} pts → "
            f"{len(components)} superpoints ({t['knn_backend']} knn "
            f"{t['knn_ms']:.3f} ms, geof {t['geof_ms']:.3f} ms, "
            f"cut-pursuit {t['cutpursuit_s']:.3f} s)")
        if times is not None:
            times.append(dict(t, name=cloud.name, points=cloud.num_points,
                              superpoints=len(components)))
    total_obj["file_num"] = file_num
    total_obj["sp_num"] = sp_num
    total_obj["point_num"] = point_num
    state.write_registry(total_obj)
    log(f"total: file_num={file_num} sp_num={sp_num} point_num={point_num}")
    return total_obj


def superpoint_size_distribution(state: ALState, cloud_names: List[str]):
    """Histogram of superpoint sizes (test_superpoint_distribution,
    compute_superpoint.py:92-116)."""
    sp_count = point_count = 0
    hist = {}
    for name in cloud_names:
        sp = state.load_superpoints(name)
        sp_count += sp.num_superpoints
        for c in sp.components:
            point_count += len(c)
            bucket = len(c) // 10
            hist[bucket] = hist.get(bucket, 0) + 1
    return {
        "sp_count": sp_count,
        "point_count": point_count,
        "mean_size": point_count / max(sp_count, 1),
        "hist": dict(sorted(hist.items())),
    }
