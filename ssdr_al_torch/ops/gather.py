"""Windowed neighbour gather and its gradient: kernels K2 and K4.

Counterpart of ssdr_al_tpu/ops/gather.py. On the sorted fast path every
neighbour index of a query tile lies inside that tile's search window
[starts[t], starts[t] + window). The TPU turned the gather into a one-hot
MXU matmul (bf16 output) and its VJP into the transposed one-hot product
(`_scatter_kernel`); the port gathers rows directly in the hand-written
CUDA kernel K2 (csrc/gather_window.cu), and sums the cotangent back in K4
(csrc/scatter_window.cu), which bins the entries by their dv row and adds
each row in (q, j) order: deterministic, and bitwise equal to its plain
version's index_add_ on the CPU. Each kernel has two instantiations: the
float32 model's (f32 values gathered exactly; f32 cotangent) and the
bfloat16 model's, as on the TPU (f32 values, each gathered value rounded
to bf16 and stored bf16; the bf16 cotangent widened to f32 and summed
into f32 dv).
`gather_window` is a torch.autograd.Function
with K2 forward and K4 backward; no gradient flows to idx or starts.

The TPU's crossover gate KERNEL_MAX_WC and its VMEM gates
(`_scatter_fits_vmem`, `_scatter_parts`) are not ported: every gather that
the JAX sorted path can send to its kernels goes through K2 and K4 here.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from ssdr_al_torch.kernels import build as _kb

# SSDR_DEBUG_WINDOW_GUARD=1 makes gather_window_auto report the indices it
# clamps (ssdr_al_tpu/ops/gather.py:51-55): the count reads back from the
# card at each call, so it is off unless asked for, and a too-narrow window
# otherwise gives wrong neighbours silently.
DEBUG_WINDOW_GUARD = os.environ.get("SSDR_DEBUG_WINDOW_GUARD", "") == "1"


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


def _gather_window_plain(values, idx, starts, window, tq, out_dtype=None):
    """Plain PyTorch version of K2: same rows, zeros outside the window,
    then cast to out_dtype (bf16: rounded to nearest even)."""
    b, n, c = values.shape
    nq, k = idx.shape[1], idx.shape[2]
    i, inside = _window_mask(idx, starts, n, window, tq)
    flat = torch.where(inside, i, torch.zeros_like(i)).reshape(b, nq * k)
    out = torch.gather(values, 1, flat[..., None].expand(b, nq * k, c))
    out = out.reshape(b, nq, k, c)
    out = torch.where(inside[..., None], out, torch.zeros_like(out))
    return out if out_dtype is None else out.to(out_dtype)


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
                slab: Optional[bool] = None,
                out_dtype: torch.dtype = torch.float32):
    """(slab, rows per CTA, threads per CTA, unit) of K2 for these shapes
    and output dtype; `slab` forces the source (chip_smoke.py checks
    both). A CTA's rows divide the tile's tq·k rows and rows·c is a
    multiple of the unit, the values a thread stores at once: 4 f32 (a
    float4), or 8 bf16 (16 bytes) where rows·c % 8 == 0, else 4 bf16 (8
    bytes). That needs tq % 4 == 0."""
    if tq % 4:
        raise ValueError(f"gather_window: the kernel takes tq % 4 == 0, "
                         f"not {tq}")
    rows = tq * k
    if slab is None:
        slab = (window * c * 4 <= SLAB_MAX_BYTES
                and b * (nq // tq) >= 2 * _kb.SMS)
    threads = SLAB_THREADS
    if not slab:
        threads = GATHER_THREADS
        while rows * c > GATHER_SPAN and rows % 8 == 0:
            rows //= 2
    unit = 8 if _out_bf16(out_dtype) and rows * c % 8 == 0 else 4
    return slab, rows, threads, unit


def _out_bf16(out_dtype) -> bool:
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gather_window: output dtype {out_dtype}; K2 "
                        "stores float32 or bfloat16")
    return out_dtype == torch.bfloat16


def _gather_window_launch(values, idx, starts, window, tq, plan,
                          out_dtype=torch.float32):
    """Launch K2 with a given plan (gather_plan's, or another for a check
    of both sources) and count the launch: `gather_window.launches` (f32
    output) or `gather_window.launches_bf16`."""
    b, n, c = values.shape
    nq, k = idx.shape[1], idx.shape[2]
    slab, rows, threads, unit = plan
    out = torch.empty((b, nq, k, c), dtype=out_dtype, device=values.device)
    err = _kb.library().gather_window_launch(
        values.data_ptr(), idx.data_ptr(), starts.data_ptr(), out.data_ptr(),
        b, n, nq, k, c, window, tq, int(slab), rows, threads,
        int(_out_bf16(out_dtype)), unit,
        ctypes.c_void_p(_kb.stream_ptr(values.device)))
    _kb.check(err, "gather_window")
    if out_dtype == torch.bfloat16:
        gather_window.launches_bf16 += 1
    else:
        gather_window.launches += 1
    return out


def _gather_window_fwd(values, idx, starts, window, tq, out_dtype):
    """K2 on CUDA tensors, its plain version on CPU tensors."""
    b, n, c = values.shape
    nq, k = idx.shape[1], idx.shape[2]
    _check_window_args("gather_window", b, n, idx, starts, window, tq)
    if values.device.type == "cpu":
        return _gather_window_plain(values, idx, starts, window, tq,
                                    out_dtype)
    if values.dtype != torch.float32 or idx.dtype != torch.int32 \
            or starts.dtype != torch.int32:
        raise TypeError("gather_window: float32 values, int32 idx and starts")
    _kb.require_cuda("gather_window", values, idx, starts)
    return _gather_window_launch(
        values, idx, starts, window, tq,
        gather_plan(b, nq, k, c, window, tq, out_dtype=out_dtype), out_dtype)


def _scatter_window_plain(g, idx, starts, n, window, tq):
    """Plain PyTorch version of K4: out-of-window contributions masked to
    zero, then one index_add_ over the flattened [B·N, C] rows
    (deterministic on the CPU), in f32: a bf16 g is widened first."""
    g = g.float()
    b, nq, k, c = g.shape
    i, inside = _window_mask(idx, starts, n, window, tq)
    rows = i + (torch.arange(b, device=g.device) * n)[:, None, None]
    rows = torch.where(inside, rows, torch.zeros_like(rows)).reshape(-1)
    gm = torch.where(inside[..., None], g, torch.zeros_like(g))
    dv = torch.zeros((b * n, c), dtype=g.dtype, device=g.device)
    dv.index_add_(0, rows, gm.reshape(-1, c))
    return dv.reshape(b, n, c)


# K4's launch plan (csrc/scatter_window.cu): a group of G lanes sums each
# dv row, lane l the units l, l + G, ... of it: vector units of a row
# (f32: float4s where c % 4 == 0; bf16: 16-byte units of 8 where
# c % 8 == 0, else 8-byte units of 4 where c % 4 == 0), G the power of 2
# from 2 to 32 that covers them; else single values, 4 lanes up to 16
# channels and 32 above (measured on the H100 in f32, PERF.md). A tile is
# sorted by row in shared memory when its window has at most
# SCATTER_HIST_MAX rows and it has at most SCATTER_FILL_ENTRIES entries,
# else each entry claims its slot with a global atomic. Each row bins up
# to SCATTER_BIN entry ids (the kernel's LIST_CAP), the rest in an
# overflow list.
SCATTER_HIST_MAX = 12288
SCATTER_FILL_ENTRIES = 8192
SCATTER_BIN = 48


def scatter_plan(b: int, n: int, nq: int, k: int, c: int, window: int,
                 tq: int, g_dtype: torch.dtype = torch.float32):
    """(group, hist) of K4 for these shapes and cotangent dtype: lanes per
    dv row, and whether each tile is sorted in shared memory."""
    if not (1 <= b <= 65535 and n >= 1 and k >= 1 and c >= 1 and tq >= 1
            and nq >= 0 and nq % tq == 0 and 1 <= window <= n
            and nq * k < 2 ** 31):
        raise ValueError(f"scatter_plan: bad shapes b={b} n={n} nq={nq} "
                         f"k={k} c={c} window={window} tq={tq}")
    if g_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"scatter_plan: cotangent dtype {g_dtype}")
    per = (8 if c % 8 == 0 else 4) if g_dtype == torch.bfloat16 else 4
    if c % 4 == 0:
        group = 2
        while group < min(c // per, 32):
            group *= 2
    else:
        group = 4 if c <= 16 else 32
    return group, (window <= SCATTER_HIST_MAX
                   and tq * k <= SCATTER_FILL_ENTRIES)


def scatter_window(g: torch.Tensor, idx: torch.Tensor, starts: torch.Tensor,
                   n: int, window: int, tq: int = 128) -> torch.Tensor:
    """The transpose of gather_window: dv [B, n, C] with
    dv[b, r] = Σ g[b, q, j] over the (q, j) whose idx[b, q, j] == r lies in
    query tile q // tq's window; an index outside its window contributes
    nothing. g [B, Nq, k, C]; idx [B, Nq, k] int32; starts [B, Nq/tq] int32.
    CPU tensors take the plain version; CUDA tensors launch K4, which takes
    float32 or bfloat16 g and adds in (q, j) order in f32, as the plain
    version does. dv is float32. A launch counts in
    `scatter_window.launches` (f32 g) or `scatter_window.launches_bf16`."""
    b, nq, k, c = g.shape
    if idx.shape != (b, nq, k):
        raise ValueError(f"scatter_window: g {tuple(g.shape)} vs idx "
                         f"{tuple(idx.shape)}")
    _check_window_args("scatter_window", b, n, idx, starts, window, tq)
    if g.device.type == "cpu":
        return _scatter_window_plain(g, idx, starts, n, window, tq)
    if g.dtype not in (torch.float32, torch.bfloat16) \
            or idx.dtype != torch.int32 or starts.dtype != torch.int32:
        raise TypeError("scatter_window: float32 or bfloat16 g, int32 idx "
                        "and starts")
    _kb.require_cuda("scatter_window", g, idx, starts)
    group, hist = scatter_plan(b, n, nq, k, c, window, tq, g.dtype)
    dev = g.device
    dv = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    # scratch: ids per row and per overflow list, each row's bin of ids,
    # and the (row, id) pairs past a full bin
    counts = torch.empty(b * n + b, dtype=torch.int32, device=dev)
    bins = torch.empty((b, n, SCATTER_BIN), dtype=torch.int32, device=dev)
    ovf = torch.empty((b, nq * k, 2), dtype=torch.int32, device=dev)
    err = _kb.library().scatter_window_launch(
        g.data_ptr(), idx.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        bins.data_ptr(), ovf.data_ptr(), dv.data_ptr(), b, n, nq, k, c,
        window, tq, group, int(hist), int(g.dtype == torch.bfloat16),
        ctypes.c_void_p(_kb.stream_ptr(dev)))
    _kb.check(err, "scatter_window")
    if g.dtype == torch.bfloat16:
        scatter_window.launches_bf16 += 1
    else:
        scatter_window.launches += 1
    return dv


scatter_window.launches = 0
scatter_window.launches_bf16 = 0


class _GatherWindow(torch.autograd.Function):
    """K2 forward, K4 backward (ssdr_al_tpu/ops/gather.py:269-330): dv in
    f32, cast to the values' dtype (:327)."""

    @staticmethod
    def forward(ctx, values, idx, starts, window, tq, out_dtype):
        ctx.save_for_backward(idx, starts)
        ctx.window, ctx.tq, ctx.n = window, tq, values.shape[1]
        ctx.dtype = values.dtype
        return _gather_window_fwd(values, idx, starts, window, tq, out_dtype)

    @staticmethod
    def backward(ctx, g):
        idx, starts = ctx.saved_tensors
        dv = scatter_window(g.contiguous(), idx, starts, ctx.n, ctx.window,
                            ctx.tq)
        return dv.to(ctx.dtype), None, None, None, None, None


def gather_window(values: torch.Tensor, idx: torch.Tensor,
                  starts: torch.Tensor, window: int, tq: int = 128,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """values [B, N, C]; idx [B, Nq, k] int32 with idx[b, t·tq:(t+1)·tq] in
    [starts[b, t], starts[b, t] + window); starts [B, Nq/tq] int32.
    Returns [B, Nq, k, C] in out_dtype (default the values' dtype: an
    exact copy; bfloat16 rounds each value to nearest even, as the TPU
    kernel stores it). An index outside its window reads as a zero row, as
    on the TPU. Differentiable in `values` (backward: scatter_window, in
    f32). CPU tensors take the plain versions; CUDA tensors launch the
    kernels, which take float32 values and store float32 or bfloat16."""
    return _GatherWindow.apply(values, idx, starts, window, tq,
                               out_dtype or values.dtype)


gather_window.launches = 0
gather_window.launches_bf16 = 0


def scatter_rows(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """The transpose of a row gather, summed in a fixed order: dv [B, n, C]
    with dv[b, r] = Σ g[b, m] over the m with idx[b, m] == r, added in
    ascending m. A stable sort of the flat targets b·n + idx, then one
    segment sum over the sorted rows, each segment added in order: no
    float atomics, the same bits on every run and, in f32, the bits of the
    CPU's index_add_ (the order of torch.gather's CPU backward). g
    [B, M, C]; idx [B, M] integer. A bf16 g is summed in f32; dv is
    float32."""
    b, m, c = g.shape
    flat = (idx.long() + (torch.arange(b, device=g.device) * n)[:, None]
            ).reshape(-1)
    flat, order = torch.sort(flat, stable=True)
    offsets = torch.searchsorted(
        flat, torch.arange(b * n + 1, device=g.device))
    rows = g.reshape(b * m, c).float()[order]
    dv = torch.segment_reduce(rows, "sum", offsets=offsets, axis=0,
                              unsafe=True)
    return dv.reshape(b, n, c)


class _GatherRows(torch.autograd.Function):
    """torch.gather of rows forward; scatter_rows backward."""

    @staticmethod
    def forward(ctx, values, idx):
        ctx.save_for_backward(idx)
        ctx.n, ctx.dtype = values.shape[1], values.dtype
        return torch.gather(values, 1, idx.long()[..., None].expand(
            -1, -1, values.shape[-1]))

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return scatter_rows(g, idx, ctx.n).to(ctx.dtype), None


def gather_rows_fixed(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values [B, N, C] rows at idx [B, M] → [B, M, C], whose backward sums
    in a fixed order on the card (scatter_rows), where torch.gather's
    backward adds with float atomics in an order that changes from run to
    run. On the CPU: torch.gather, whose backward is the plain version
    (index_add_ order)."""
    if values.device.type == "cpu":
        return torch.gather(values, 1, idx.long()[..., None].expand(
            -1, -1, values.shape[-1]))
    return _GatherRows.apply(values, idx)


def tile_min_starts(idx: torch.Tensor, n: int, window: int,
                    tq: int) -> torch.Tensor:
    """Per-tile 128-aligned starts from the indices' own minimum.
    idx [B, Nq, k] → [B, Nq/tq] int32 in [0, n − window]."""
    b, nq, k = idx.shape
    mn = idx.reshape(b, nq // tq, tq * k).amin(-1).to(torch.int32)
    return torch.clamp((mn // 128) * 128, 0, max(n - window, 0))


def gather_window_auto(values: torch.Tensor, idx: torch.Tensor, window: int,
                       tq: int = 128,
                       out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """gather_window for windowed index sets whose starts are not carried
    (the pool gathers of the sorted path): each tile's start comes from its
    minimum index, and indices are clamped into [start, start + window).
    A clamp fires only when a tile's index spread exceeds the window
    (`window_violations` counts them; tests assert zero at their shapes);
    with DEBUG_WINDOW_GUARD each call that clamps prints how many indices
    it clamped, as JAX's guard does. The backward scatters through the
    same clamped indices. out_dtype as in gather_window."""
    n = values.shape[1]
    window = min(window, n)
    if window % 8:
        raise ValueError(f"gather_window_auto: window {window} % 8")
    starts = tile_min_starts(idx, n, window, tq)
    lo = torch.repeat_interleave(starts, tq, dim=1)[..., None]
    idx_c = torch.minimum(torch.maximum(idx, lo), lo + (window - 1))
    if DEBUG_WINDOW_GUARD:
        bad = int((idx_c != idx).sum())
        if bad > 0:
            print(f"gather_window_auto: {bad} indices clamped (window="
                  f"{window} too narrow for this tile spread — results use "
                  "wrong neighbors)")
    return gather_window(values, idx_c.contiguous(), starts, window, tq,
                         out_dtype)


def window_violations(idx: torch.Tensor, window: int,
                      tq: int = 128) -> int:
    """Count of tiles whose indices gather_window_auto would clamp."""
    b, nq, k = idx.shape
    r = idx.reshape(b, nq // tq, tq * k)
    spread = r.amax(-1) - r.amin(-1)
    # the start is 128-aligned down, so the span budget shrinks by ≤ 127
    return int((torch.clamp(spread - (window - 128), min=0) > 0).sum())
