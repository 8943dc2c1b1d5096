"""The launch counts of the port's kernels: each wrapper adds one to its
count where it launches its kernel (CUDA tensors only), so a run can show
that its path went through the kernels."""

from __future__ import annotations

from typing import Dict


def counters() -> dict:
    """{kernel: (wrapper, attribute holding its launch count)}."""
    from ssdr_al_torch.ops.chamfer import chamfer_sums
    from ssdr_al_torch.ops.gather import gather_window, scatter_window
    from ssdr_al_torch.ops.knn import knn_tiled, window_topk

    return {"window_topk": (window_topk, "launches"),
            "gather_window": (gather_window, "launches"),
            "chamfer_sums": (chamfer_sums, "launches"),
            "scatter_window": (scatter_window, "launches"),
            "window_topk_mxu": (window_topk, "launches_mxu"),
            "knn_tiled": (knn_tiled, "launches"),
            "gather_window_bf16": (gather_window, "launches_bf16"),
            "scatter_window_bf16": (scatter_window, "launches_bf16"),
            "knn_tiled_k64": (knn_tiled, "launches_k64")}


def reset():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read() -> Dict[str, int]:
    return {name: getattr(fn, attr)
            for name, (fn, attr) in counters().items()}
