"""Windowed neighbour gather and its gradient: kernels K2 and K4.

Counterpart of ssdr_al_tpu/ops/gather.py. On the sorted fast path every
neighbour index of a query tile lies inside that tile's search window
[starts[t], starts[t] + window). The TPU turned the gather into a one-hot
MXU matmul (bf16 output) and its VJP into the transposed one-hot product
(`_scatter_kernel`); the port gathers rows directly in the hand-written
CUDA kernel K2 (csrc/gather_window.cu), which keeps the input dtype and is
exact, and scatter-adds the cotangent back with f32 atomics in K4
(csrc/scatter_window.cu). `gather_window` is a torch.autograd.Function
with K2 forward and K4 backward; no gradient flows to idx or starts.

The TPU's crossover gate KERNEL_MAX_WC and its VMEM gates
(`_scatter_fits_vmem`, `_scatter_parts`) are not ported: every gather that
the JAX sorted path can send to its kernels goes through K2 and K4 here.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ssdr_al_torch.kernels import build as _kb


def _check_window_args(name, b, n, idx, starts, window, tq):
    nq = idx.shape[1]
    if idx.shape[0] != b or nq % tq or starts.shape != (b, nq // tq):
        raise ValueError(f"{name}: bad shapes idx {tuple(idx.shape)} "
                         f"starts {tuple(starts.shape)} tq={tq}")
    if not 1 <= window <= n:
        raise ValueError(f"{name}: window {window} vs n {n}")


def _window_mask(idx, starts, n, window, tq):
    """(idx as int64, inside [B, nq, k]): which indices lie in their tile's
    window; starts are clamped to [0, n − window] as the kernels do."""
    lo = torch.clamp(starts.long(), 0, n - window)
    lo = torch.repeat_interleave(lo, tq, dim=1)[..., None]         # [B, nq, 1]
    i = idx.long()
    return i, (i >= lo) & (i < lo + window)


def _gather_window_plain(values, idx, starts, window, tq):
    """Plain PyTorch version of K2: same rows, zeros outside the window."""
    b, n, c = values.shape
    nq, k = idx.shape[1], idx.shape[2]
    i, inside = _window_mask(idx, starts, n, window, tq)
    flat = torch.where(inside, i, torch.zeros_like(i)).reshape(b, nq * k)
    out = torch.gather(values, 1, flat[..., None].expand(b, nq * k, c))
    out = out.reshape(b, nq, k, c)
    return torch.where(inside[..., None], out, torch.zeros_like(out))


# K2's launch plan (csrc/gather_window.cu): a CTA copies its tile's window
# into shared memory when the slab is at most SLAB_MAX_BYTES and the tiles
# alone fill two waves of the card's SMs; otherwise CTAs of GATHER_THREADS
# read through L1/L2 and each writes at most GATHER_SPAN floats of one
# tile. On the H100 the slab wins at L0's 64 KB window of 8 channels and
# loses at its 88 KB window of 11 (PERF.md).
SLAB_MAX_BYTES = 64 * 1024
SLAB_THREADS = 1024
GATHER_THREADS = 256
GATHER_SPAN = 32768


def gather_plan(b: int, nq: int, k: int, c: int, window: int, tq: int,
                slab: Optional[bool] = None):
    """(slab, rows per CTA, threads per CTA) of K2 for these shapes; `slab`
    forces the source (chip_smoke.py checks both). A CTA's rows divide the
    tile's tq·k rows and rows·c is a multiple of 4, so every CTA writes
    whole float4s; that needs tq % 4 == 0."""
    if tq % 4:
        raise ValueError(f"gather_window: the kernel takes tq % 4 == 0, "
                         f"not {tq}")
    rows = tq * k
    if slab is None:
        slab = (window * c * 4 <= SLAB_MAX_BYTES
                and b * (nq // tq) >= 2 * _kb.SMS)
    if slab:
        return True, rows, SLAB_THREADS
    while rows * c > GATHER_SPAN and rows % 8 == 0:
        rows //= 2
    return False, rows, GATHER_THREADS


def _gather_window_launch(values, idx, starts, window, tq, plan):
    """Launch K2 with a given plan (gather_plan's, or another for a check
    of both sources) and count the launch."""
    b, n, c = values.shape
    nq, k = idx.shape[1], idx.shape[2]
    slab, rows, threads = plan
    out = torch.empty((b, nq, k, c), dtype=values.dtype, device=values.device)
    err = _kb.library().gather_window_launch(
        values.data_ptr(), idx.data_ptr(), starts.data_ptr(), out.data_ptr(),
        b, n, nq, k, c, window, tq, int(slab), rows, threads,
        ctypes.c_void_p(_kb.stream_ptr(values.device)))
    _kb.check(err, "gather_window")
    gather_window.launches += 1
    return out


def _gather_window_fwd(values, idx, starts, window, tq):
    """K2 on CUDA tensors, its plain version on CPU tensors."""
    b, n, c = values.shape
    nq, k = idx.shape[1], idx.shape[2]
    _check_window_args("gather_window", b, n, idx, starts, window, tq)
    if values.device.type == "cpu":
        return _gather_window_plain(values, idx, starts, window, tq)
    if values.dtype != torch.float32 or idx.dtype != torch.int32 \
            or starts.dtype != torch.int32:
        raise TypeError("gather_window: float32 values, int32 idx and starts")
    _kb.require_cuda("gather_window", values, idx, starts)
    return _gather_window_launch(values, idx, starts, window, tq,
                                 gather_plan(b, nq, k, c, window, tq))


def _scatter_window_plain(g, idx, starts, n, window, tq):
    """Plain PyTorch version of K4: out-of-window contributions masked to
    zero, then one index_add_ over the flattened [B·N, C] rows
    (deterministic on the CPU)."""
    b, nq, k, c = g.shape
    i, inside = _window_mask(idx, starts, n, window, tq)
    rows = i + (torch.arange(b, device=g.device) * n)[:, None, None]
    rows = torch.where(inside, rows, torch.zeros_like(rows)).reshape(-1)
    gm = torch.where(inside[..., None], g, torch.zeros_like(g))
    dv = torch.zeros((b * n, c), dtype=g.dtype, device=g.device)
    dv.index_add_(0, rows, gm.reshape(-1, c))
    return dv.reshape(b, n, c)


def scatter_window(g: torch.Tensor, idx: torch.Tensor, starts: torch.Tensor,
                   n: int, window: int, tq: int = 128) -> torch.Tensor:
    """The transpose of gather_window: dv [B, n, C] with
    dv[b, r] = Σ g[b, q, j] over the (q, j) whose idx[b, q, j] == r lies in
    query tile q // tq's window; an index outside its window contributes
    nothing. g [B, Nq, k, C]; idx [B, Nq, k] int32; starts [B, Nq/tq] int32.
    CPU tensors take the plain version; CUDA tensors launch K4, which takes
    float32 g and sums with atomics in no fixed order."""
    b, nq, k, c = g.shape
    if idx.shape != (b, nq, k):
        raise ValueError(f"scatter_window: g {tuple(g.shape)} vs idx "
                         f"{tuple(idx.shape)}")
    _check_window_args("scatter_window", b, n, idx, starts, window, tq)
    if g.device.type == "cpu":
        return _scatter_window_plain(g, idx, starts, n, window, tq)
    if g.dtype != torch.float32 or idx.dtype != torch.int32 \
            or starts.dtype != torch.int32:
        raise TypeError("scatter_window: float32 g, int32 idx and starts")
    _kb.require_cuda("scatter_window", g, idx, starts)
    dv = torch.empty((b, n, c), dtype=g.dtype, device=g.device)
    err = _kb.library().scatter_window_launch(
        g.data_ptr(), idx.data_ptr(), starts.data_ptr(), dv.data_ptr(),
        b, n, nq, k, c, window, tq,
        ctypes.c_void_p(_kb.stream_ptr(g.device)))
    _kb.check(err, "scatter_window")
    scatter_window.launches += 1
    return dv


scatter_window.launches = 0


class _GatherWindow(torch.autograd.Function):
    """K2 forward, K4 backward (ssdr_al_tpu/ops/gather.py:269-330)."""

    @staticmethod
    def forward(ctx, values, idx, starts, window, tq):
        ctx.save_for_backward(idx, starts)
        ctx.window, ctx.tq, ctx.n = window, tq, values.shape[1]
        return _gather_window_fwd(values, idx, starts, window, tq)

    @staticmethod
    def backward(ctx, g):
        idx, starts = ctx.saved_tensors
        dv = scatter_window(g.contiguous(), idx, starts, ctx.n, ctx.window,
                            ctx.tq)
        return dv, None, None, None, None


def gather_window(values: torch.Tensor, idx: torch.Tensor,
                  starts: torch.Tensor, window: int,
                  tq: int = 128) -> torch.Tensor:
    """values [B, N, C]; idx [B, Nq, k] int32 with idx[b, t·tq:(t+1)·tq] in
    [starts[b, t], starts[b, t] + window); starts [B, Nq/tq] int32.
    Returns [B, Nq, k, C] in the values' dtype (exact). An index outside
    its window reads as a zero row, as on the TPU. Differentiable in
    `values` (backward: scatter_window).
    CPU tensors take the plain versions; CUDA tensors launch the kernels,
    which take float32 values (the slice's dtype)."""
    return _GatherWindow.apply(values, idx, starts, window, tq)


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
    (`window_violations` counts them; tests assert zero at their shapes).
    The backward scatters through the same clamped indices."""
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
