"""K-nearest-neighbour search: morton sort, exact KNN and the window kernel K1.

Counterpart of ssdr_al_tpu/ops/knn.py, slice part: the morton codes and the
stable payload sort that put a cloud in z-order, the exact search `knn_xla`
(used for the small pyramid layers and for the "xla" engine), and the
window search `knn_window_sorted_raw`, whose per-tile top-k runs in the
hand-written CUDA kernel K1 (csrc/window_topk.cu) on CUDA tensors and in
`_window_topk_plain` on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ssdr_al_torch.kernels import build as _kb

QUERY_TILE = 256   # queries per K1 tile (the TPU kernel's query_chunk)
KERNEL_K = (1, 16)  # the widths K1 is built for: the 1-NN upsample and k_n


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits of x over 30 bits (every 3rd position)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton_codes(xyz: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 shift: int = 0) -> torch.Tensor:
    """30-bit z-order codes over the [lo, hi] box. xyz [..., 3] f32 → int32."""
    span = torch.clamp(hi - lo, min=1e-9)
    q = torch.clamp(((xyz - lo) / span * 1023.0).to(torch.int32), 0, 1023)
    if shift:
        q = (q + shift) % 1024
    return (_part1by2(q[..., 0]) | (_part1by2(q[..., 1]) << 1)
            | (_part1by2(q[..., 2]) << 2))


def sort_by_codes(codes: torch.Tensor, xyz: torch.Tensor):
    """Stable sort along the last point axis → (codes_sorted, order,
    xyz_sorted). codes [..., N]; xyz [..., N, 3]. Ties keep input order,
    as jax.lax.sort(is_stable=True) does."""
    codes_s, order = torch.sort(codes, dim=-1, stable=True)
    xyz_s = torch.gather(xyz, -2, order.unsqueeze(-1).expand_as(xyz))
    return codes_s, order.to(torch.int32), xyz_s


def invert_permutation(order: torch.Tensor) -> torch.Tensor:
    """Inverse of a permutation along the last axis (int32)."""
    order = order.long()
    inv = torch.empty_like(order)
    ar = torch.arange(order.shape[-1], device=order.device).expand_as(order)
    inv.scatter_(-1, order, ar)
    return inv.to(torch.int32)


# ---------------------------------------------------------------- exact ---


def knn_xla(support: torch.Tensor, query: torch.Tensor, k: int, *,
            query_chunk: int = 1024) -> torch.Tensor:
    """Exact KNN, ascending by distance, ties to the lower support index.

    support [B, Ns, 3], query [B, Nq, 3] → int32 [B, Nq, k]. The distance
    is the matmul form of the JAX engine, 2 q·s − |q|² − |s|², in full f32
    (TF32 off: torch's default, pinned in models/randlanet.py). With fewer
    than k support points the missing slots hold index 0, as in the JAX
    engine (a tiny top layer of a small block)."""
    support = support.float()
    query = query.float()
    sq_s = (support * support).sum(-1)                            # [B, Ns]
    kk = min(k, support.shape[1])
    outs = []
    for q0 in range(0, query.shape[1], query_chunk):
        q = query[:, q0:q0 + query_chunk]
        sq_q = (q * q).sum(-1, keepdim=True)
        neg = 2.0 * torch.bmm(q, support.transpose(1, 2)) - sq_q - sq_s[:, None]
        vals, idx = torch.topk(neg, kk, dim=-1, sorted=True)
        # deterministic tie order inside the k: by value, then lower index
        idx, perm = torch.sort(idx, dim=-1)
        vals = torch.gather(vals, -1, perm)
        _, perm = torch.sort(-vals, dim=-1, stable=True)
        outs.append(torch.gather(idx, -1, perm))
    out = torch.cat(outs, dim=1).to(torch.int32)
    if kk < k:
        out = torch.nn.functional.pad(out, (0, k - kk))
    return out


# --------------------------------------------------------- window search ---


def _window_topk_plain(support, queries, starts, k, window, tq):
    """Plain PyTorch version of K1: same distances, same order."""
    b, ns, _ = support.shape
    nq = queries.shape[1]
    tiles = nq // tq
    st = torch.clamp(starts.long(), 0, ns - window)                # [B, T]
    ar = torch.arange(window, device=support.device)
    out = torch.empty((b, nq, k), dtype=torch.int32, device=support.device)
    for bi in range(b):
        win = support[bi][st[bi][:, None] + ar[None, :]]           # [T, W, 3]
        qs = queries[bi].reshape(tiles, tq, 3)
        dx = qs[:, :, None, 0] - win[:, None, :, 0]
        dy = qs[:, :, None, 1] - win[:, None, :, 1]
        dz = qs[:, :, None, 2] - win[:, None, :, 2]
        d2 = dx * dx + dy * dy + dz * dz                           # [T, tq, W]
        _, idx = torch.sort(d2, dim=-1, stable=True)
        out[bi] = idx[..., :k].reshape(nq, k).to(torch.int32)
    return out


def window_topk(support: torch.Tensor, queries: torch.Tensor,
                starts: torch.Tensor, k: int, window: int,
                tq: int = QUERY_TILE) -> torch.Tensor:
    """K1: per query tile t, the k nearest of support[b, s:s+window] with
    s = starts[b, t], as window-relative ranks.

    support [B, Ns, 3] f32, queries [B, Nq, 3] f32, starts [B, Nq/tq] i32
    → [B, Nq, k] i32, ascending by squared distance, ties to the lower rank.
    CPU tensors take the plain version; CUDA tensors launch the kernel, for
    k in KERNEL_K."""
    b, ns, _ = support.shape
    nq = queries.shape[1]
    if queries.shape[0] != b or starts.shape != (b, nq // tq) or nq % tq:
        raise ValueError(f"window_topk: bad shapes {support.shape} "
                         f"{queries.shape} {starts.shape} tq={tq}")
    if not 1 <= k <= 16 or not k <= window <= ns:
        raise ValueError(f"window_topk: k={k} window={window} ns={ns}")
    if support.device.type == "cpu":
        return _window_topk_plain(support, queries, starts, k, window, tq)
    if support.dtype != torch.float32 or queries.dtype != torch.float32 \
            or starts.dtype != torch.int32:
        raise TypeError("window_topk: float32 points and int32 starts")
    _kb.require_cuda("window_topk", support, queries, starts)
    if k not in KERNEL_K:
        raise ValueError(f"window_topk: the kernel is built for k in "
                         f"{KERNEL_K}, not {k}")
    out = torch.empty((b, nq, k), dtype=torch.int32, device=support.device)
    lib = _kb.library()
    err = lib.window_topk_launch(
        support.data_ptr(), queries.data_ptr(), starts.data_ptr(),
        out.data_ptr(), b, ns, nq, window, k, tq,
        ctypes.c_void_p(_kb.stream_ptr(support.device)))
    _kb.check(err, "window_topk")
    window_topk.launches += 1
    return out


window_topk.launches = 0


def self_query_starts(n_pad: int, ns_pad: int, window: int,
                      tq: int = QUERY_TILE, device=None) -> torch.Tensor:
    """Per-tile window starts of a self-search: each sorted query's rank is
    its own position, so tile t centres on t·tq + tq/2 (128-aligned)."""
    centers = torch.arange(n_pad // tq, dtype=torch.int32,
                           device=device) * tq + tq // 2
    starts = torch.clamp(centers - window // 2, 0, ns_pad - window)
    return (starts // 128) * 128


def knn_window_sorted_raw(xyz_sorted: torch.Tensor, n: int, k: int, *,
                          window: int = 2048,
                          query_chunk: int = QUERY_TILE):
    """Self-query window KNN on morton-sorted clouds, staying in sorted space.

    xyz_sorted [B, N_pad, 3] (rows past n are sentinels at 3e18). Returns
    (idx [B, n, k] into the sorted rows, starts [B, n_pad/tq]) with
    idx[tile t] ∈ [starts[t], starts[t] + window): the invariant
    ops.gather.gather_window relies on. Only self-query starts are ported;
    they are what the sorted pyramid uses (models/randlanet.py)."""
    b, ns_pad, _ = xyz_sorted.shape
    nq_pad = _round_up(n, query_chunk)
    q = xyz_sorted[:, :n]
    if nq_pad > n:
        q = torch.cat([q, q[:, n - 1:n].expand(b, nq_pad - n, 3)], dim=1)
    starts = self_query_starts(nq_pad, ns_pad, window, query_chunk,
                               xyz_sorted.device).expand(b, -1).contiguous()
    rel = window_topk(xyz_sorted.contiguous(), q.contiguous(), starts, k,
                      window, query_chunk)
    out = torch.repeat_interleave(starts, query_chunk, dim=1)[..., None] + rel
    # sentinel picks (only when the last window overhangs the pad rows)
    # clamp to the last real row, which stays inside that window
    out = torch.clamp(out, max=n - 1)
    return out[:, :n], starts
