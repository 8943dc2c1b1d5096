"""Windowed neighbour gather and its gradient: kernels K2 and K4.

Counterpart of ssdr_al_tpu/ops/gather.py. On the sorted fast path every
neighbour index of a query tile lies inside that tile's search window
[starts[t], starts[t] + window). The TPU turned the gather into a one-hot
MXU matmul (bf16 output) and its VJP into the transposed one-hot product
(`_scatter_kernel`); the port gathers rows directly in the hand-written
CUDA kernel K2 (csrc/gather_window.cu), and sums the cotangent back in K4
(csrc/scatter_window.cu), which transposes the index set (each dv row's
entry ids, ascending; `WindowTranspose`, shared by the scatters of one
index set) and adds each row in (q, j) order: deterministic, and bitwise
equal to its plain version's index_add_ on the CPU. Each kernel has two
instantiations: the float32 model's (f32 values gathered exactly; f32
cotangent) and the bfloat16 model's, as on the TPU (f32 values, each
gathered value rounded to bf16 and stored bf16; the bf16 cotangent widened
to f32 and summed into f32 dv).
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


# K4 (csrc/scatter_window.cu) runs in two passes. The transpose of an
# index set (each dv row's in-window entry ids, ascending) is built by one
# kernel, a few CTAs a batch element, where a batch element's ids fit in
# its shared memory, else by three kernels over plan tiles: a query tile,
# cut into `parts` runs of at most TRANSPOSE_PART entries and its window
# into `pieces` runs of at most TRANSPOSE_PIECE rows where it has more, a
# CTA that holds its entries (transpose_plan); a layer's two LFA gathers
# share one (WindowTranspose). The sum pass gives each dv row a group of G
# lanes, lane l the units l, l + G, ... of it, in one of SCATTER_UNITS
# (scatter_plan): f32 float4s where c % 4 == 0, else single
# floats (4 lanes up to 16 channels, 32 above, measured on the H100,
# PERF.md); bf16 16-byte units of 8 where c % 8 == 0, 8-byte units of 4
# where c % 4 == 0, else spans of 8 channels read from aligned 8-byte
# words; G the power of 2 that covers a row's units, at most 32 (spans:
# at most SPAN_LANES).
SPAN_LANES = 4
SCATTER_UNITS = ("f32x1", "f32x4", "bf16x8", "bf16x4", "bf16span8")
TRANSPOSE_PART = 8192            # the kernels' PART_MAX
TRANSPOSE_PIECE = 12288          # the kernels' PIECE_MAX
TRANSPOSE_SCAN_ROWS = 4096       # the kernels' SCAN_ROWS
TRANSPOSE_HELD = 8               # the kernels' EPT
TRANSPOSE_WHOLE_SMEM = 200 * 1024    # the kernels' WHOLE_SMEM
TRANSPOSE_WHOLE_PIECES = 16
TRANSPOSE_SMALL_TILE = 1024


def _check_k4_shapes(name, b, n, nq, k, window, tq):
    if not (1 <= b <= 65535 and n >= 1 and k >= 1 and tq >= 1
            and nq >= 0 and nq % tq == 0 and 1 <= window <= n
            and b * nq * k < 2 ** 31):
        raise ValueError(f"{name}: bad shapes b={b} n={n} nq={nq} k={k} "
                         f"window={window} tq={tq}")


def transpose_plan(b: int, n: int, nq: int, k: int, window: int,
                   tq: int) -> tuple:
    """(parts, pieces, threads, whole) of the transpose kernels. whole:
    where a batch element's nq·k ids fit in u16 and in
    TRANSPOSE_WHOLE_SMEM with its rows' offsets (the 1-NN upsamples, the
    L2 LFA set and smaller ones: faster so on the H100 at every main-path
    set, PERF.md), its rows are cut into `pieces` runs, a CTA each that
    reads all its entries and places those of its rows:
    TRANSPOSE_WHOLE_PIECES runs (fewer for fewer rows; 16 measured
    fastest of 1-16 for the 1-NN upsamples on the H100, PERF.md). Otherwise
    plan tiles: each query tile's tq·k entries cut into `parts` runs of at
    most TRANSPOSE_PART and its window into `pieces` runs of at most
    TRANSPOSE_PIECE rows (1 and 1 at every main-path call), a tile's CTA
    the power of 2 from 128 to 1024 threads that holds its entries,
    TRANSPOSE_HELD a thread."""
    _check_k4_shapes("transpose_plan", b, n, nq, k, window, tq)
    parts = -(-tq * k // TRANSPOSE_PART)
    threads = 128
    while threads * TRANSPOSE_HELD < -(-tq * k // parts):
        threads *= 2
    if nq * k <= 65535:
        pieces = min(TRANSPOSE_WHOLE_PIECES, n)
        if (2 * -(-n // pieces) + 1) * 4 + 2 * nq * k <= TRANSPOSE_WHOLE_SMEM:
            return parts, pieces, threads, True
    return parts, -(-window // TRANSPOSE_PIECE), threads, False


def scatter_plan(b: int, n: int, nq: int, k: int, c: int, window: int,
                 tq: int, g_dtype: torch.dtype = torch.float32):
    """(group, unit) of K4's sum pass for these shapes and cotangent
    dtype: lanes per dv row and the unit a lane loads (SCATTER_UNITS)."""
    if not (1 <= b <= 65535 and n >= 1 and k >= 1 and c >= 1 and tq >= 1
            and nq >= 0 and nq % tq == 0 and 1 <= window <= n
            and nq * k < 2 ** 31):
        raise ValueError(f"scatter_plan: bad shapes b={b} n={n} nq={nq} "
                         f"k={k} c={c} window={window} tq={tq}")
    if g_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"scatter_plan: cotangent dtype {g_dtype}")
    if g_dtype == torch.float32:
        if c % 4:
            return (4 if c <= 16 else 32), "f32x1"
        unit, units = "f32x4", c // 4
    elif c % 8 == 0:
        unit, units = "bf16x8", c // 8
    elif c % 4 == 0:
        unit, units = "bf16x4", c // 4
    else:
        # spans: a lane takes two or three of a row's units at 35 and 67
        # channels, faster than a lane each (measured on the H100, PERF.md)
        unit, units = "bf16span8", min(-(-c // 8), SPAN_LANES)
    group = 1
    while group < min(units, 32):
        group *= 2
    return group, unit


# K4's single-use path (csrc/scatter_fused.cu), for a scatter whose index
# set no other scatter shares and whose tiles hold at least
# TRANSPOSE_SMALL_TILE entries (the pool gathers' backward): a fill kernel
# bins each tile's entries by row in one pass (sorted in shared memory when
# its window has at most FUSED_HIST_MAX rows and it has at most
# FUSED_FILL_ENTRIES entries, else a global atomic a claim), FUSED_BIN ids
# a row and an overflow list past them, and a sum kernel sorts each row's
# ids and adds them: one call, no transpose kept. Its group of G lanes a
# row covers a row's vector units (f32 float4s, bf16 16-byte units of 8 or
# 8-byte units of 4), from 2 to 32; else single values, 4 lanes up to 16
# channels and 32 above.
FUSED_HIST_MAX = 12288
FUSED_FILL_ENTRIES = 8192
FUSED_BIN = 48


def fused_plan(b: int, n: int, nq: int, k: int, c: int, window: int,
               tq: int, g_dtype: torch.dtype = torch.float32):
    """(group, hist) of K4's single-use path for these shapes and cotangent
    dtype: lanes per dv row, and whether each tile is sorted in shared
    memory."""
    scatter_plan(b, n, nq, k, c, window, tq, g_dtype)    # the same checks
    per = (8 if c % 8 == 0 else 4) if g_dtype == torch.bfloat16 else 4
    if c % 4 == 0:
        group = 2
        while group < min(c // per, 32):
            group *= 2
    else:
        group = 4 if c <= 16 else 32
    return group, (window <= FUSED_HIST_MAX
                   and tq * k <= FUSED_FILL_ENTRIES)


def _scatter_fused(g, idx, starts, n, window, tq):
    """K4's single-use path on CUDA tensors: dv [B, n, C] f32."""
    b, nq, k, c = g.shape
    group, hist = fused_plan(b, n, nq, k, c, window, tq, g.dtype)
    dev = g.device
    dv = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    # scratch: ids per row and per overflow list, each row's bin of ids,
    # and the (row, id) pairs past a full bin
    counts = torch.empty(b * n + b, dtype=torch.int32, device=dev)
    bins = torch.empty((b, n, FUSED_BIN), dtype=torch.int32, device=dev)
    ovf = torch.empty((b, nq * k, 2), dtype=torch.int32, device=dev)
    err = _kb.library().scatter_fused_launch(
        g.data_ptr(), idx.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        bins.data_ptr(), ovf.data_ptr(), dv.data_ptr(), b, n, nq, k, c,
        window, tq, group, int(hist), int(g.dtype == torch.bfloat16),
        ctypes.c_void_p(_kb.stream_ptr(dev)))
    _kb.check(err, f"scatter_window {tuple(g.shape)} {g.dtype} n={n}")
    return dv


def _window_transpose_plain(idx, starts, n, window, tq):
    """Plain PyTorch version of the transpose kernels: (rowptr [B, n + 1],
    ids [B, Nq·k]) int32 flattened, each batch element's in-window entries'
    ids q·k + j in ascending order of (row, id) by a stable sort of their
    rows, rowptr[b] their offsets in batch element b's run of ids; the
    out-of-window entries' ids follow rowptr[b, n]."""
    b, nq, k = idx.shape
    i, inside = _window_mask(idx, starts, n, window, tq)
    key = torch.where(inside, i, torch.full_like(i, n)).reshape(b, nq * k)
    ids = torch.sort(key, dim=1, stable=True).indices.int()
    rowptr = torch.zeros((b, n + 1), dtype=torch.int64, device=idx.device)
    rowptr[:, 1:] = torch.cumsum(torch.stack([torch.bincount(
        key[j], minlength=n + 1)[:n] for j in range(b)]), 1)
    return rowptr.int().reshape(-1), ids.reshape(-1)


def window_transpose(idx: torch.Tensor, starts: torch.Tensor, n: int,
                     window: int, tq: int = 128) -> tuple:
    """The transpose of a windowed index set: (rowptr [B, n + 1], ids
    [B, Nq·k]) int32 flattened, dv row (b, r)'s in-window entry ids q·k + j
    (in batch element b) ascending at ids[b·Nq·k + rowptr[b, r]:
    b·Nq·k + rowptr[b, r + 1]]; a batch element's ids past rowptr[b, n]
    are not part of it. CPU tensors take the plain version; CUDA tensors
    launch K4's transpose kernels (no host sync; every buffer from
    PyTorch's allocator), counted in `window_transpose.launches`."""
    b, nq, k = idx.shape
    _check_window_args("window_transpose", b, n, idx, starts, window, tq)
    if idx.device.type == "cpu":
        return _window_transpose_plain(idx, starts, n, window, tq)
    if idx.dtype != torch.int32 or starts.dtype != torch.int32:
        raise TypeError("window_transpose: int32 idx and starts")
    _kb.require_cuda("window_transpose", idx, starts)
    parts, pieces, threads, whole = transpose_plan(b, n, nq, k, window, tq)
    tiles = 0 if whole else nq // tq * parts * pieces
    wp = 0 if whole else -(-window // pieces)
    blocks = 0 if whole else b * -(-n // TRANSPOSE_SCAN_ROWS)
    # one buffer: the tile kernels' scratch (each plan tile's span of rows,
    # int2 first so that it is 8-byte aligned), rowptr, ids, then more
    # scratch (the rows plan tiles reach, counts a row and a block of rows,
    # each plan tile's u16 counts a row)
    sizes = [2 * b * tiles, b * (n + 1), b * nq * k, b * tiles,
             0 if whole else b * n, blocks, -(-b * tiles * wp // 2)]
    buf = torch.empty(sum(sizes), dtype=torch.int32, device=idx.device)
    span, rowptr, ids, reach, cnt, tot, hist = torch.split(buf, sizes)
    err = _kb.library().scatter_transpose_launch(
        idx.data_ptr(), starts.data_ptr(), hist.data_ptr(), span.data_ptr(),
        reach.data_ptr(), cnt.data_ptr(), tot.data_ptr(), rowptr.data_ptr(),
        ids.data_ptr(), b, n, nq, k, window, tq, parts, pieces, threads,
        int(whole), ctypes.c_void_p(_kb.stream_ptr(idx.device)))
    _kb.check(err, f"window_transpose {tuple(idx.shape)} n={n} "
                   f"window={window} tq={tq}")
    window_transpose.launches += 1
    return rowptr, ids


window_transpose.launches = 0


class WindowTranspose:
    """One windowed index set (idx, starts, n, window, tq) and its
    transpose, built at the first `csr()` (window_transpose) and kept:
    several scatters of that set share it. A layer's two LFA gathers
    (models/randlanet.py::BuildingBlock) hand one to both gather_window
    calls, so their backward builds it once, inside a captured train step
    when the step is captured; a forward that runs no backward builds
    none."""

    def __init__(self, idx: torch.Tensor, starts: torch.Tensor, n: int,
                 window: int, tq: int = 128):
        _check_window_args("WindowTranspose", idx.shape[0], n, idx, starts,
                           window, tq)
        self.idx, self.starts = idx, starts
        self.n, self.window, self.tq = n, window, tq
        self._csr = None

    def matches(self, idx, starts, n, window, tq) -> bool:
        """Whether (idx, starts, n, window, tq) is this index set: the same
        tensors' storage and shapes, and the same sizes."""
        return ((n, window, tq) == (self.n, self.window, self.tq)
                and all(a.device == c.device and a.shape == c.shape
                        and a.data_ptr() == c.data_ptr()
                        for a, c in ((idx, self.idx),
                                     (starts, self.starts))))

    @property
    def built(self) -> bool:
        return self._csr is not None

    def csr(self) -> tuple:
        """(rowptr, ids), built on the first call."""
        if self._csr is None:
            self._csr = window_transpose(self.idx, self.starts, self.n,
                                         self.window, self.tq)
        return self._csr


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


def _scatter_csr(g, idx, starts, n, window, tq, transpose):
    """K4's sum pass on CUDA tensors through `transpose` (or one built for
    this call): dv [B, n, C] f32."""
    b, nq, k, c = g.shape
    group, unit = scatter_plan(b, n, nq, k, c, window, tq, g.dtype)
    rowptr, ids = (transpose or WindowTranspose(idx, starts, n, window,
                                                tq)).csr()
    dv = torch.empty((b, n, c), dtype=torch.float32, device=g.device)
    err = _kb.library().scatter_sum_launch(
        g.data_ptr(), rowptr.data_ptr(), ids.data_ptr(), dv.data_ptr(), b, n,
        nq, k, c, group, SCATTER_UNITS.index(unit),
        ctypes.c_void_p(_kb.stream_ptr(g.device)))
    _kb.check(err, f"scatter_window {tuple(g.shape)} {g.dtype} n={n}")
    return dv


def scatter_window(g: torch.Tensor, idx: torch.Tensor, starts: torch.Tensor,
                   n: int, window: int, tq: int = 128,
                   transpose: Optional[WindowTranspose] = None
                   ) -> torch.Tensor:
    """The transpose of gather_window: dv [B, n, C] with
    dv[b, r] = Σ g[b, q, j] over the (q, j) whose idx[b, q, j] == r lies in
    query tile q // tq's window; an index outside its window contributes
    nothing. g [B, Nq, k, C]; idx [B, Nq, k] int32; starts [B, Nq/tq] int32.
    `transpose`, a WindowTranspose of the same index set, is shared with
    other scatters of it (its transpose built once, then a sum pass each);
    without one, a call whose tiles hold at least TRANSPOSE_SMALL_TILE
    entries takes K4's single-use path (fill and sum, `fused_plan`), a
    call with smaller tiles builds its own transpose. CPU tensors take the
    plain version; CUDA tensors launch K4, which takes float32 or bfloat16
    g and adds in (q, j) order in f32, as the plain version does. dv is
    float32. A call counts in `scatter_window.launches` (f32 g) or
    `scatter_window.launches_bf16`."""
    b, nq, k, c = g.shape
    if idx.shape != (b, nq, k):
        raise ValueError(f"scatter_window: g {tuple(g.shape)} vs idx "
                         f"{tuple(idx.shape)}")
    _check_window_args("scatter_window", b, n, idx, starts, window, tq)
    if transpose is not None and not transpose.matches(idx, starts, n,
                                                       window, tq):
        raise ValueError("scatter_window: the transpose is of another "
                         "index set")
    if g.device.type == "cpu":
        return _scatter_window_plain(g, idx, starts, n, window, tq)
    if g.dtype not in (torch.float32, torch.bfloat16) \
            or idx.dtype != torch.int32 or starts.dtype != torch.int32:
        raise TypeError("scatter_window: float32 or bfloat16 g, int32 idx "
                        "and starts")
    _kb.require_cuda("scatter_window", g, idx, starts)
    if g.data_ptr() % 16:
        g = g.clone()            # both paths load 16-byte aligned units
    if transpose is None and tq * k >= TRANSPOSE_SMALL_TILE:
        dv = _scatter_fused(g, idx, starts, n, window, tq)
    else:
        dv = _scatter_csr(g, idx, starts, n, window, tq, transpose)
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
    def forward(ctx, values, idx, starts, window, tq, out_dtype, transpose):
        ctx.save_for_backward(idx, starts)
        ctx.window, ctx.tq, ctx.n = window, tq, values.shape[1]
        ctx.dtype, ctx.transpose = values.dtype, transpose
        return _gather_window_fwd(values, idx, starts, window, tq, out_dtype)

    @staticmethod
    def backward(ctx, g):
        idx, starts = ctx.saved_tensors
        dv = scatter_window(g.contiguous(), idx, starts, ctx.n, ctx.window,
                            ctx.tq, transpose=ctx.transpose)
        # the transpose and its ids go with the last backward that holds
        # them, not with the graph
        ctx.transpose = None
        return dv.to(ctx.dtype), None, None, None, None, None, None


def gather_window(values: torch.Tensor, idx: torch.Tensor,
                  starts: torch.Tensor, window: int, tq: int = 128,
                  out_dtype: Optional[torch.dtype] = None,
                  transpose: Optional[WindowTranspose] = None
                  ) -> torch.Tensor:
    """values [B, N, C]; idx [B, Nq, k] int32 with idx[b, t·tq:(t+1)·tq] in
    [starts[b, t], starts[b, t] + window); starts [B, Nq/tq] int32.
    Returns [B, Nq, k, C] in out_dtype (default the values' dtype: an
    exact copy; bfloat16 rounds each value to nearest even, as the TPU
    kernel stores it). An index outside its window reads as a zero row, as
    on the TPU. Differentiable in `values` (backward: scatter_window, in
    f32, through `transpose` where given: a WindowTranspose of this index
    set that other gathers of it share). CPU tensors take the plain
    versions; CUDA tensors launch the kernels, which take float32 values
    and store float32 or bfloat16."""
    return _GatherWindow.apply(values, idx, starts, window, tq,
                               out_dtype or values.dtype, transpose)


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
