"""The launch counts of the port's kernels: each wrapper adds one to its
count where it launches its kernel (CUDA tensors only), so a run can show
that its path went through the kernels. A CUDA graph's capture calls the
wrappers but launches nothing; train/graphs.py takes those counts back
after the capture and adds them again at every replay (`since`, `add`),
so that the counts stay the kernels' real launches."""

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


def since(before: Dict[str, int]) -> Dict[str, int]:
    """The launches counted since `before` (a read())."""
    now = read()
    return {name: now[name] - before.get(name, 0) for name in now}


def add(launches: Dict[str, int], times: int = 1):
    """Add `times` × launches to the counts (negative: take them back)."""
    for name, (fn, attr) in counters().items():
        if launches.get(name):
            setattr(fn, attr, getattr(fn, attr) + times * launches[name])
