"""Pairwise chamfer distance between padded superpoints: kernel K3.

Counterpart of ssdr_al_tpu/ops/chamfer.py. For superpoints i, j (each
centred on its bbox centre by the caller)
    cd[i, j] = mean_{p∈i} min_{q∈j} ||p−q|| + mean_{q∈j} min_{p∈i} ||p−q||
with cd[i, i] = 0. `chamfer_pairwise_blocks` gives the values of the JAX
exact form (chamfer.py:52-169, 257-271) in one implementation: the
directional sums in the hand-written CUDA kernel K3 (csrc/chamfer_sums.cu)
on CUDA tensors, or `_chamfer_sums_plain` on CPU tensors, followed by the
combine epilogue of chamfer.py:447-456 in PyTorch.

The TPU's live-buffer cap and sub-chunk wrappers (_CSP_CAP, _subchunk,
*_chunked) guarded a TPU worker crash and are not ported. K3 numbers its
pair tasks in 32-bit ints, so `chamfer_sums` refuses a call whose task
count (C · S(S−1)/2 and the counter's overshoot) would not fit in one
(K3_MAX_TASKS), before it launches anything.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ssdr_al_torch.kernels import build as _kb

# K3 (csrc/chamfer_sums.cu) numbers its pair tasks in int: it forms S(S−1)
# before halving it, counts C · S(S−1)/2 tasks, and its task counter runs
# past the last by one a warp (3 CTAs of 8 warps an SM); 2**16 leaves room
# for that overshoot.
K3_MAX_TASKS = 2 ** 31 - 1 - 2 ** 16
PLAIN_ELEMS = 2 ** 27     # the plain version's [rc, P, S·P] intermediates


def _chamfer_sums_plain(points, mask, row_chunk=None):
    """Plain PyTorch version of K3: o[c, a, b] = Σ over b's valid points of
    the min distance to a's valid points (0 when a is empty). Rows of
    superpoints go `row_chunk` at a time (default: at most 8, and few
    enough that one [rc, P, S·P] intermediate holds PLAIN_ELEMS values);
    each row's sums do not depend on it."""
    c, s, p, _ = points.shape
    if row_chunk is None:
        row_chunk = max(1, min(8, PLAIN_ELEMS // max(1, s * p * p)))
    o = torch.empty((c, s, s), dtype=torch.float32, device=points.device)
    for ci in range(c):
        flat = points[ci].reshape(s * p, 3)
        for a0 in range(0, s, row_chunk):
            a = points[ci, a0:a0 + row_chunk]                      # [rc, P, 3]
            a_msk = mask[ci, a0:a0 + row_chunk]
            rc = a.shape[0]
            dx = a[:, :, None, 0] - flat[None, None, :, 0]
            dy = a[:, :, None, 1] - flat[None, None, :, 1]
            dz = a[:, :, None, 2] - flat[None, None, :, 2]
            d2 = dx * dx + dy * dy + dz * dz                       # [rc, P, S·P]
            d2 = torch.where(a_msk[:, :, None], d2, float("inf"))
            dmin = torch.sqrt(d2.amin(1)).reshape(rc, s, p)        # [rc, S, P]
            dmin = torch.where(mask[ci][None] & a_msk.any(-1)[:, None, None],
                               dmin, 0.0)
            o[ci, a0:a0 + rc] = dmin.sum(-1)
    return o


def chamfer_sums(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """K3: directional chamfer sums. points [C, S, P, 3] f32, mask
    [C, S, P] bool → o [C, S, S] f32, o[c, a, b] = Σ_{q∈b} min_{p∈a} ||p−q||
    (0 when a or b is empty). CPU tensors take the plain version; CUDA
    tensors launch the kernel, which computes each unordered pair's
    distances once for both directions. A call of more than K3_MAX_TASKS
    pair tasks raises ValueError on either device."""
    c, s, p, three = points.shape
    if three != 3 or mask.shape != (c, s, p):
        raise ValueError(f"chamfer_sums: bad shapes {points.shape} {mask.shape}")
    if s * (s - 1) > K3_MAX_TASKS or c * (s * (s - 1) // 2) > K3_MAX_TASKS:
        raise ValueError(
            f"chamfer_sums: {c} blocks of {s} superpoints make "
            f"{c * (s * (s - 1) // 2)} pair tasks (S(S-1) = {s * (s - 1)}); "
            f"K3 numbers them in int and takes at most {K3_MAX_TASKS}: "
            "split the blocks over calls")
    if points.device.type == "cpu":
        return _chamfer_sums_plain(points.float(), mask)
    if points.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError("chamfer_sums: float32 points and bool mask")
    _kb.require_cuda("chamfer_sums", points, mask)
    dev = points.device
    out = torch.empty((c, s, s), dtype=torch.float32, device=dev)
    # scratch: each superpoint's valid points packed as float4s, their
    # counts and the pair kernel's task counter
    packed = torch.empty((c, s, p, 4), dtype=torch.float32, device=dev)
    counts = torch.empty(c * s + 1, dtype=torch.int32, device=dev)
    err = _kb.library().chamfer_sums_launch(
        points.data_ptr(), mask.data_ptr(), packed.data_ptr(),
        counts.data_ptr(), out.data_ptr(), c, s, p,
        ctypes.c_void_p(_kb.stream_ptr(dev)))
    _kb.check(err, "chamfer_sums")
    chamfer_sums.launches += 1
    return out


chamfer_sums.launches = 0


def chamfer_pairwise_blocks(points: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """Pairwise chamfer per block: K3 sums + the combine epilogue of
    chamfer.py:447-456. [C, S, P, 3], [C, S, P] → [C, S, S] with zero
    diagonal and 1e15 wherever either superpoint is empty."""
    o = chamfer_sums(points.contiguous(), mask.contiguous())
    cnt = mask.sum(-1).float()                                    # [C, S]
    safe = cnt.clamp(min=1.0)
    cd = o.transpose(1, 2) / safe[:, :, None] + o / safe[:, None, :]
    empty = cnt == 0
    cd = torch.where(empty[:, :, None] | empty[:, None, :], 1e15, cd)
    eye = torch.eye(cd.shape[-1], dtype=cd.dtype, device=cd.device)
    return cd * (1.0 - eye)[None]


def chamfer_pairwise_blocks_dp(points: torch.Tensor, mask: torch.Tensor,
                               group, c: int) -> torch.Tensor:
    """chamfer_pairwise_blocks with the block axis split over a data-
    parallel group (chamfer.py:238-254's chamfer_pairwise_blocks_gathered_dp):
    points [C_r, S, P, 3] and mask [C_r, S, P] are this rank's share
    group.share(c) of c blocks; returns the whole [c, S, S] on every rank.
    A rank whose share is empty launches nothing."""
    s = points.shape[1]
    if points.shape[0]:
        part = chamfer_pairwise_blocks(points, mask)
    else:
        part = torch.zeros((0, s, s), dtype=torch.float32,
                           device=points.device)
    return group.gather_share(part, c)


def chamfer_pairwise(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Pairwise chamfer of one cloud's superpoints (chamfer.py:53, the exact
    form the edcd branch calls): chamfer_pairwise_blocks on a block axis of
    1, so CUDA tensors run K3. points [S, P, 3] centred; mask [S, P] →
    [S, S] with zero diagonal.

    Every superpoint must hold a valid point: for a pair of empty ones
    JAX's exact form gives 0 where K3's epilogue gives 1e15. The edcd
    candidates are never empty (each has its dominant points)."""
    if not bool(mask.any(-1).all()):
        raise ValueError("chamfer_pairwise: an empty superpoint")
    return chamfer_pairwise_blocks(points[None], mask[None])[0]


def pad_superpoints(sp_points_list, max_points=None):
    """Host helper: ragged [Pi, 3] arrays → ([S, P, 3] centred, [S, P] mask).
    Clouds are centred on their bbox centre; clouds above max_points are
    subsampled with np.linspace (chamfer.py:540-566)."""
    s = len(sp_points_list)
    p = max(len(x) for x in sp_points_list)
    if max_points is not None and p > max_points:
        p = max_points
    pts = np.zeros((s, p, 3), np.float32)
    msk = np.zeros((s, p), bool)
    for i, x in enumerate(sp_points_list):
        x = np.asarray(x, np.float32)
        x = x - (x.min(axis=0) + x.max(axis=0)) / 2.0
        if len(x) > p:
            x = x[np.linspace(0, len(x) - 1, p).astype(np.int64)]
        pts[i, : len(x)] = x
        msk[i, : len(x)] = True
    return pts, msk
