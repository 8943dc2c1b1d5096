"""Windowed neighbour gather, forward only: kernel K2.

Counterpart of ssdr_al_tpu/ops/gather.py. On the sorted fast path every
neighbour index of a query tile lies inside that tile's search window
[starts[t], starts[t] + window). The TPU turned that into a one-hot MXU
matmul (bf16 output); the port gathers rows directly in the hand-written
CUDA kernel K2 (csrc/gather_window.cu), which keeps the input dtype and is
exact. Training's scatter-add backward (TPU kernel `_scatter_kernel`) comes
with the training slice.

The TPU's crossover gate KERNEL_MAX_WC is not ported: every gather that
the JAX sorted path can send to its kernel goes through K2 here.
"""

from __future__ import annotations

import ctypes

import torch

from ssdr_al_torch.kernels import build as _kb


def _gather_window_plain(values, idx, starts, window, tq):
    """Plain PyTorch version of K2: same rows, zeros outside the window."""
    b, n, c = values.shape
    nq, k = idx.shape[1], idx.shape[2]
    lo = torch.clamp(starts.long(), 0, n - window)
    lo = torch.repeat_interleave(lo, tq, dim=1)[..., None]         # [B, nq, 1]
    i = idx.long()
    inside = (i >= lo) & (i < lo + window)
    flat = torch.where(inside, i, torch.zeros_like(i)).reshape(b, nq * k)
    out = torch.gather(values, 1, flat[..., None].expand(b, nq * k, c))
    out = out.reshape(b, nq, k, c)
    return torch.where(inside[..., None], out, torch.zeros_like(out))


def gather_window(values: torch.Tensor, idx: torch.Tensor,
                  starts: torch.Tensor, window: int,
                  tq: int = 128) -> torch.Tensor:
    """values [B, N, C]; idx [B, Nq, k] int32 with idx[b, t·tq:(t+1)·tq] in
    [starts[b, t], starts[b, t] + window); starts [B, Nq/tq] int32.
    Returns [B, Nq, k, C] in the values' dtype (exact). An index outside
    its window reads as a zero row, as on the TPU.
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes float32 values (the slice's dtype)."""
    b, n, c = values.shape
    nq, k = idx.shape[1], idx.shape[2]
    if idx.shape[0] != b or nq % tq or starts.shape != (b, nq // tq):
        raise ValueError(f"gather_window: bad shapes {values.shape} "
                         f"{idx.shape} {starts.shape} tq={tq}")
    if not 1 <= window <= n:
        raise ValueError(f"gather_window: window {window} vs n {n}")
    if values.device.type == "cpu":
        return _gather_window_plain(values, idx, starts, window, tq)
    if values.dtype != torch.float32 or idx.dtype != torch.int32 \
            or starts.dtype != torch.int32:
        raise TypeError("gather_window: float32 values, int32 idx and starts")
    _kb.require_cuda("gather_window", values, idx, starts)
    out = torch.empty((b, nq, k, c), dtype=values.dtype, device=values.device)
    err = _kb.library().gather_window_launch(
        values.data_ptr(), idx.data_ptr(), starts.data_ptr(), out.data_ptr(),
        b, n, nq, k, c, window, tq,
        ctypes.c_void_p(_kb.stream_ptr(values.device)))
    _kb.check(err, "gather_window")
    gather_window.launches += 1
    return out


gather_window.launches = 0


def tile_min_starts(idx: torch.Tensor, n: int, window: int,
                    tq: int) -> torch.Tensor:
    """Per-tile 128-aligned starts from the indices' own minimum.
    idx [B, Nq, k] → [B, Nq/tq] int32 in [0, n − window]."""
    b, nq, k = idx.shape
    mn = idx.reshape(b, nq // tq, tq * k).amin(-1).to(torch.int32)
    return torch.clamp((mn // 128) * 128, 0, max(n - window, 0))


def gather_window_auto(values: torch.Tensor, idx: torch.Tensor, window: int,
                       tq: int = 128) -> torch.Tensor:
    """gather_window for windowed index sets whose starts are not carried
    (the pool gathers of the sorted path): each tile's start comes from its
    minimum index, and indices are clamped into [start, start + window).
    A clamp fires only when a tile's index spread exceeds the window
    (`window_violations` counts them; tests assert zero at their shapes)."""
    n = values.shape[1]
    window = min(window, n)
    if window % 8:
        raise ValueError(f"gather_window_auto: window {window} % 8")
    starts = tile_min_starts(idx, n, window, tq)
    lo = torch.repeat_interleave(starts, tq, dim=1)[..., None]
    idx_c = torch.minimum(torch.maximum(idx, lo), lo + (window - 1))
    return gather_window(values, idx_c.contiguous(), starts, window, tq)


def window_violations(idx: torch.Tensor, window: int,
                      tq: int = 128) -> int:
    """Count of tiles whose indices gather_window_auto would clamp."""
    b, nq, k = idx.shape
    r = idx.reshape(b, nq // tq, tq * k)
    spread = r.amax(-1) - r.amin(-1)
    # the start is 128-aligned down, so the span budget shrinks by ≤ 127
    return int((torch.clamp(spread - (window - 128), min=0) > 0).sum())
