"""K-nearest-neighbour search (counterpart of ssdr_al_tpu/ops/knn.py).

Each search returns int32 indices [B, Nq, k], ascending by squared
distance:

  knn_window_sorted(_raw) — space-filling-curve window search between
               clouds sorted along the morton (or Hilbert) curve by
               `sort_cloud`: each 256-query tile searches one window of the
               sorted support through the window kernel (K1, or K5 with the
               centred-product distance).
  knn_window — the same window search on clouds in their own order
               (approximate): sort both along the curve, search with K1
               (impl "pallas", the default) or an exact top-k over unaligned
               windows (impl "xla"), map back; probes=2 merges a second
               search on a shifted grid by exact distance.
  knn_tiled  — exact, the counterpart of knn_pallas: kernel K6 sorts both
               clouds along the morton curve and walks blocks of the
               sorted support, skipping every block whose bounding box
               lies beyond the k-th best of each of a warp's queries.
  knn_xla    — exact, in the matmul form of the JAX engine (dense products
               and torch.topk), for the small pyramid layers.
  knn_approx — the TPU's approx_min_k path; served by the exact K6 here.

The exact searches take support [B, Ns, 3] and query [B, Nq, 3] f32.
The sorted-space helpers let the model pyramid search, pool and upsample
on one sort per layer. Kernels run on CUDA tensors (csrc/window_topk.cu,
csrc/knn_tiled.cu); CPU tensors take each kernel's plain PyTorch version,
which computes the same distances in the same order.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from ssdr_al_torch.kernels import build as _kb

QUERY_TILE = 256   # queries per K1 tile (the TPU kernel's query_chunk)
KERNEL_K = (1, 16)  # the widths K1 and K5 are built for: the 1-NN
                    # upsample and k_n
SENTINEL = 3e18    # coordinate of the pad rows of a sorted cloud
# K5 (centred-product distance) in place of K1 for window searches that do
# not choose; off, as ssdr_al_tpu/ops/knn.py::_MXU_DISTANCE_DEFAULT
MXU_DISTANCE_DEFAULT = False


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# --------------------------------------------------- space-filling curves ---


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


def _hilbert_transpose(q: torch.Tensor, bits: int):
    """Skilling's AxestoTranspose for 3 axes, vectorised over points:
    q [..., 3] int32 in [0, 2**bits) → the 3 transposed-index planes."""
    x = [q[..., 0], q[..., 1], q[..., 2]]
    big = 1 << (bits - 1)
    b = big
    while b > 1:
        p = b - 1
        x[0] = torch.where((x[0] & b) != 0, x[0] ^ p, x[0])
        for i in (1, 2):
            cond = (x[i] & b) != 0
            t = (x[0] ^ x[i]) & p
            x0, xi = x[0], x[i]
            x[0] = torch.where(cond, x0 ^ p, x0 ^ t)
            x[i] = torch.where(cond, xi, xi ^ t)
        b >>= 1
    x[1] = x[1] ^ x[0]
    x[2] = x[2] ^ x[1]
    t = torch.zeros_like(x[0])
    b = big
    while b > 1:
        t = torch.where((x[2] & b) != 0, t ^ (b - 1), t)
        b >>= 1
    return [v ^ t for v in x]


def hilbert_codes(xyz: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                  shift: int = 0, bits: int = 10) -> torch.Tensor:
    """30-bit Hilbert-curve codes over the [lo, hi] box, bit for bit those
    of ssdr_al_tpu's hilbert_codes (an alternative to morton_codes for the
    window engines, Config.curve="hilbert"); shift moves the grid as
    morton_codes' does (knn_window's second probe)."""
    span = torch.clamp(hi - lo, min=1e-9)
    top = (1 << bits) - 1
    q = torch.clamp(((xyz - lo) / span * top).to(torch.int32), 0, top)
    if shift:
        q = (q + shift) % (top + 1)
    x0, x1, x2 = _hilbert_transpose(q, bits)
    return (_part1by2(x0) << 2) | (_part1by2(x1) << 1) | _part1by2(x2)


# the sort curves of the window engines, chosen by Config.curve
CURVES = {"morton": morton_codes, "hilbert": hilbert_codes}


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


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...] rows at idx [B, M] → [B, M, ...]."""
    shape = idx.shape + x.shape[2:]
    flat = idx.long().reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, flat.expand(shape))


# ---------------------------------------------------------------- exact ---


def knn_xla(support: torch.Tensor, query: torch.Tensor, k: int, *,
            query_chunk: int = 1024, support_chunk: int = 4096
            ) -> torch.Tensor:
    """Exact KNN, ascending by distance, ties to the lower support index.

    support [B, Ns, 3], query [B, Nq, 3] → int32 [B, Nq, k]. The distance
    is the matmul form of the JAX engine, 2 q·s − |q|² − |s|², in full f32
    (TF32 off: torch's default, pinned in models/randlanet.py). With fewer
    than k support points the missing slots hold index 0, as in the JAX
    engine (a tiny top layer of a small block). support_chunk, JAX's tile
    of the support, is accepted and ignored: each chunk of queries takes
    the whole support in one product."""
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


def knn_approx(support: torch.Tensor, query: torch.Tensor, k: int, *,
               query_chunk: int = 1024,
               recall_target: float = 0.99) -> torch.Tensor:
    """The "approx" engine name. JAX serves it with the TPU's approx_min_k
    (≥ 0.99 recall); there is no such hardware path here, so the port
    answers it exactly with knn_tiled (K6 on CUDA tensors, its plain
    version on CPU tensors): "approx" and "pallas" are one search.
    JAX's query_chunk and recall_target are accepted and ignored (the
    answer is exact)."""
    return knn_tiled(support, query, k)


def _sq_dist(qx, qy, qz, sx, sy, sz):
    """(dx·dx + dy·dy) + dz·dz, each operation rounded on its own (no FMA),
    as the kernels compute it."""
    dx, dy, dz = qx - sx, qy - sy, qz - sz
    return (dx * dx + dy * dy) + dz * dz


def _knn_tiled_plain(support, query, k, query_chunk=1024):
    """Plain PyTorch version of K6: per chunk of queries the distances to
    the whole support, then a stable sort."""
    b, ns, _ = support.shape
    nq = query.shape[1]
    kk = min(k, ns)
    out = torch.zeros((b, nq, k), dtype=torch.int32, device=support.device)
    for bi in range(b):
        s = support[bi]
        for q0 in range(0, nq, query_chunk):
            q = query[bi, q0:q0 + query_chunk]
            d2 = _sq_dist(q[:, None, 0], q[:, None, 1], q[:, None, 2],
                          s[None, :, 0], s[None, :, 1], s[None, :, 2])
            idx = torch.sort(d2, dim=-1, stable=True).indices[:, :kk]
            out[bi, q0:q0 + query_chunk, :kk] = idx.to(torch.int32)
    return out


# K6's walk (csrc/knn_tiled.cu): blocks of KNN_BLOCK sorted support
# points, super-blocks of KNN_SUPER blocks, each with a 32-byte box;
# KNN_THREADS threads a CTA. K6 is instantiated for the widths KNN_K (the
# 1-NN upsample, k_n, and the partition's k_geof + 1 = 46 neighbours); a
# call with k runs the least width at or above k and keeps the first k
# columns. K = 1 and 16 (knn_walk_kernel): a warp per 32 sorted queries,
# each warp staging a kept block in KNN_STAGE floats and each thread
# buffering KNN_BUF candidate keys of 8 bytes (k > 1); the kernel's
# registers allow KNN_CTAS[K] CTAs an SM, and the box tables take shared
# memory only where as many still fit beside the stages and buffers.
# K = 64 (knn_walk64_kernel): a warp per sorted query, KNN_WALK64_QUERIES
# queries a CTA of KNN_WALK64_THREADS threads, the list of 64 keys spread
# over the warp's lanes (csrc/warp_topk.cuh), at most 64 registers a
# thread (nine CTAs an SM), no dynamic shared memory (the boxes read
# through L1).
KNN_BLOCK, KNN_SUPER, KNN_THREADS, KNN_STAGE, KNN_BUF = 32, 32, 256, 128, 24
KNN_K = (1, 16, 64)
KNN_CTAS = {1: 3, 16: 3}
KNN_WALK64_THREADS = 128
KNN_WALK64_QUERIES = KNN_WALK64_THREADS // 32
# K6's route by the support's size (knn_tiled_route): a thread per query
# over every support point at most KNN_BRUTE_MAX[K] points, the walk over
# the clouds in their own order at most KNN_SORT_MIN[K], the walk over the
# curve-sorted clouds beyond. Set from kernels/measure.py --k6-only, which
# times every route at every call of the three exact pyramids (H100): for
# k=1 the brute force is fastest up to 4096 points (0.135 against the
# sorted walk's 0.194 ms) and the sorted walk from 10240 (0.497 against
# 1.490); for k=16 the walk in the clouds' own order up to 704 points
# (0.093 against 0.107), the sorted walk from 1024 (0.115 against 0.116).
# K = 64 (measure.py --k6-only, k = 46 over random subsets of a prepared
# room, which keep its grid order): the walk in the room's own order up to
# 6000 points (46: 0.0069 ms against the sorted walk's 0.0256 and the
# brute force's 0.0452; 700: 0.0204 / 0.0488; 3000: 0.0402 / 0.0616;
# 6000: 0.0662 / 0.0922), the sorted walk from 10 000 (0.1063 against
# 0.1095; 20 000: 0.1420 against 0.1992); the brute force is never fastest
KNN_BRUTE_MAX = {1: 4096, 16: 0, 64: 0}
KNN_SORT_MIN = {1: 896, 16: 896, 64: 8192}
KNN_ROUTES = ("brute", "walk", "sorted")
SMEM_DEFAULT = 48 * 1024   # dynamic shared memory a launch has without
                           # the opt-in attribute
SMEM_LIMIT = 227 * 1024    # the most one CTA can opt in to on an H100
SMEM_SM = 228 * 1024       # an SM's shared memory, 1 KiB of it reserved
                           # for each resident CTA


def knn_kernel_k(k: int) -> int:
    """The width of K6 that serves a call with k: the least of KNN_K at or
    above k. Raises for k outside [1, KNN_K[-1]], on every device, so that
    a call that the card refuses is refused on the CPU too."""
    for width in KNN_K:
        if 1 <= k <= width:
            return width
    raise ValueError(f"knn_tiled: k={k}, but K6 is built for 1 <= k <= "
                     f"{KNN_K[-1]} (widths {KNN_K})")


def knn_tiled_plan(ns: int, k: int):
    """(nblk, nsup, boxes_in_smem, smem bytes) of K6's walk over ns support
    points. K = 1 and 16: both box tables go to shared memory where
    KNN_CTAS[K] CTAs an SM still fit with them, else only the
    super-blocks' do and the walk reads the block boxes through L1; a
    launch above SMEM_DEFAULT sets the opt-in attribute (the kernel has no
    static shared memory). K = 64: no dynamic shared memory at any size
    (its list slots are 2 KiB of static shared memory, its boxes read
    through L1), so no opt-in ever."""
    nblk = -(-ns // KNN_BLOCK)
    nsup = -(-nblk // KNN_SUPER)
    if knn_kernel_k(k) == 64:
        return nblk, nsup, False, 0
    fixed = KNN_THREADS // 32 * KNN_STAGE * 4 \
        + (KNN_THREADS * KNN_BUF * 8 if k > 1 else 0)
    both = fixed + (nsup + nblk) * 32
    in_smem = both <= SMEM_SM // KNN_CTAS[knn_kernel_k(k)] - 1024
    return nblk, nsup, in_smem, both if in_smem else fixed + nsup * 32


def knn_tiled_route(ns: int, k: int) -> str:
    """K6's route at ns support points: "brute" (csrc/knn_tiled.cu::
    knn_brute_kernel, a thread per query over every support point, where
    a warp's walk costs more than it prunes), "walk" (the walk over the
    clouds in their own order, where the codes and sorts cost more than
    the boxes save) or "sorted" (the walk over the curve-sorted clouds)."""
    if ns <= KNN_BRUTE_MAX[knn_kernel_k(k)]:
        return "brute"
    return "walk" if ns <= KNN_SORT_MIN[knn_kernel_k(k)] else "sorted"


def knn_sorted_inputs(support: torch.Tensor, query: torch.Tensor,
                      self_search: bool = False, sort: bool = True):
    """The plain version of K6's preparation (csrc/knn_tiled.cu's codes and
    layout kernels and the stable sort between them): both clouds of a
    batch row sorted along the morton curve over one box that holds them
    both.

    Returns groups [B, nblk·8, 3, 4] (the sorted support by groups of four
    points, x[4] y[4] z[4], NaN pads up to nblk·KNN_BLOCK rows), order [B,
    nblk·KNN_BLOCK] int32 (the original index of each sorted support row,
    0 on pads), the sorted queries [B, nq, 3], qorder [B, nq] int32 (the
    original row of each sorted query) and qpos [B, nq] int32 (each sorted
    query's rank in the sorted support: its own on a self-search, else its
    searchsorted position). The rows keep their values: every d² is the
    plain version's. sort=False keeps both clouds in their own order (the
    kernel's path for at most KNN_SORT_MIN[K] support points): identity
    orders, qpos its own rank on a self-search, else 0."""
    b, ns, _ = support.shape
    if not sort:
        nq, dev = query.shape[1], support.device
        ar = torch.arange(max(ns, nq), dtype=torch.int32, device=dev)
        s_order, q_order = ar[:ns].expand(b, ns), ar[:nq].expand(b, nq)
        q_pos = q_order if self_search else torch.zeros_like(q_order)
        return _knn_layout(support, s_order) + (
            query.contiguous(), q_order.contiguous(), q_pos.contiguous())
    lo, hi = support.amin(1, keepdim=True), support.amax(1, keepdim=True)
    if not self_search:
        lo = torch.minimum(lo, query.amin(1, keepdim=True))
        hi = torch.maximum(hi, query.amax(1, keepdim=True))
    s_codes, s_order, s_xyz = sort_by_codes(morton_codes(support, lo, hi),
                                            support)
    groups, order = _knn_layout(support, s_order)
    if self_search:
        q_xyz, q_order = s_xyz, s_order
        q_pos = torch.arange(ns, dtype=torch.int32,
                             device=support.device).expand(b, ns)
    else:
        q_codes, q_order, q_xyz = sort_by_codes(
            morton_codes(query, lo, hi), query)
        q_pos = torch.searchsorted(s_codes.contiguous(),
                                   q_codes.contiguous()).to(torch.int32)
    return (groups, order, q_xyz.contiguous(), q_order.contiguous(),
            q_pos.contiguous())


def _knn_layout(support, s_order):
    """(groups [B, nblk·8, 3, 4], order [B, nblk·KNN_BLOCK] int32): the
    support rows in the order s_order [B, Ns] by groups of four points,
    NaN pads, and their original indices (0 on pads)."""
    b, ns, _ = support.shape
    nblk = -(-ns // KNN_BLOCK)
    pad = nblk * KNN_BLOCK - ns
    groups = torch.nn.functional.pad(gather_rows(support, s_order),
                                     (0, 0, 0, pad), value=float("nan"))
    groups = groups.reshape(b, nblk * 8, 4, 3).transpose(2, 3).contiguous()
    return groups, torch.nn.functional.pad(s_order, (0, pad)).contiguous()


def knn_tiled(support: torch.Tensor, query: torch.Tensor, k: int, *,
              tile_q: int = 256, tile_s: int = 512) -> torch.Tensor:
    """K6: exact KNN, the counterpart of ssdr_al_tpu's knn_pallas.

    support [B, Ns, 3] f32, query [B, Nq, 3] f32 → int32 [B, Nq, k],
    ascending by (d², support index) with d² = (dx·dx + dy·dy) + dz·dz in
    f32 without FMA (the broadcast-subtraction form of the TPU kernel).
    Ties go to the lower support index; with Ns < k the slots past Ns hold
    index 0. CPU tensors take the plain version; CUDA tensors launch the
    kernel (csrc/knn_tiled.cu) on the curve-sorted clouds (as
    knn_sorted_inputs sorts them), on small clouds in their own order or a
    thread per query over every support point (knn_tiled_route). Any
    1 <= k <= 64 runs on both (the width knn_kernel_k(k) of the kernel,
    its first k columns); a larger k raises on both. A launch counts in
    knn_tiled.launches (widths 1 and 16) or knn_tiled.launches_k64.
    tile_q and tile_s, the TPU kernel's tiles (JAX's knn_pallas), are
    accepted and ignored: K6 takes its own (knn_tiled_plan)."""
    return _knn_tiled(support, query, k)[0]


def knn_tiled_stats(support: torch.Tensor, query: torch.Tensor, k: int,
                    route: str | None = None):
    """knn_tiled on CUDA tensors, on its own route (knn_tiled_route) or
    the one given, and what it did: {"pairs" (query, support) evaluated
    (of Nq·Ns a batch row; all of them on the brute-force route), and on
    a walk KNN_WALK_STATS[K]: for K = 1 and 16 "blocks_kept" and
    "block_tests" by the warps, "keys_buffered" by the lanes,
    "insert_rounds" of the warps; for K = 64 "blocks_kept", "box_tests"
    (super-blocks' and blocks'), "keys_merged" and "merges" (blocks with an
    entrant) summed over the queries}."""
    return _knn_tiled(support, query, k, with_stats=True, route=route)


def _knn_tiled(support, query, k, with_stats=False, route=None):
    if support.dim() != 3 or query.dim() != 3 or support.shape[-1] != 3 \
            or query.shape[-1] != 3 or support.shape[0] != query.shape[0]:
        raise ValueError(f"knn_tiled: bad shapes {tuple(support.shape)} "
                         f"{tuple(query.shape)}")
    knn_kernel_k(k)
    if support.device.type == "cpu" and not with_stats:
        return _knn_tiled_plain(support.float(), query.float(), k), None
    if support.dtype != torch.float32 or query.dtype != torch.float32:
        raise TypeError("knn_tiled: float32 points")
    self_search = support.data_ptr() == query.data_ptr() and \
        support.shape == query.shape and support.stride() == query.stride()
    support = support.contiguous()
    query = support if self_search else query.contiguous()
    _kb.require_cuda("knn_tiled", support, query)
    b, ns, _ = support.shape
    nq = query.shape[1]
    dev = support.device
    if nq == 0 or ns == 0:
        return torch.zeros((b, nq, k), dtype=torch.int32, device=dev), None
    stream = ctypes.c_void_p(_kb.stream_ptr(dev))
    route = route or knn_tiled_route(ns, k)
    if route not in KNN_ROUTES:
        raise ValueError(f"knn_tiled: no route {route!r}")
    if route == "brute":
        out = torch.empty((b, nq, k), dtype=torch.int32, device=dev)
        _kb.check(_kb.library().knn_brute_launch(
            support.data_ptr(), query.data_ptr(), out.data_ptr(), b, ns, nq,
            k, stream), "knn_tiled brute")
        _count_launch(k)
        return out, dict(pairs=b * ns * nq) if with_stats else None
    # the sort orders and sorted codes; none where the walk takes the
    # clouds in their own order
    sorts = [None] * 4
    if route == "sorted":
        # the curve codes (csrc/knn_tiled.cu::knn_codes_kernel: morton_codes
        # over one box holding both clouds), then their stable sort
        s_codes, q_codes = _knn_codes(support, query, self_search, stream)
        s_codes, s_order = torch.sort(s_codes, dim=-1, stable=True)
        q_codes, q_order = (s_codes, s_order) if self_search else \
            torch.sort(q_codes, dim=-1, stable=True)
        sorts = [t.data_ptr() for t in (s_order, q_order, s_codes, q_codes)]
    nblk, nsup, in_smem, smem = knn_tiled_plan(ns, k)
    groups = torch.empty((b, nblk * 8, 3, 4), dtype=torch.float32,
                         device=dev)
    order = torch.empty((b, nblk * KNN_BLOCK), dtype=torch.int32, device=dev)
    boxes = torch.empty((b, nsup + nblk, 8), dtype=torch.float32, device=dev)
    out = torch.empty((b, nq, k), dtype=torch.int32, device=dev)
    stats = torch.zeros(5, dtype=torch.int64, device=dev) \
        if with_stats else None
    err = _kb.library().knn_tiled_launch(
        support.data_ptr(), query.data_ptr(), *sorts,
        groups.data_ptr(), order.data_ptr(), boxes.data_ptr(),
        out.data_ptr(), None if stats is None else stats.data_ptr(), b, ns,
        nq, k, KNN_WALK64_THREADS if knn_kernel_k(k) == 64 else KNN_THREADS,
        int(in_smem), int(self_search), smem, stream)
    _kb.check(err, "knn_tiled")
    _count_launch(k)
    if stats is None:
        return out, None
    return out, dict(zip(("pairs",) + KNN_WALK_STATS[knn_kernel_k(k)],
                         stats.tolist()))


# the walk's counters after "pairs" (knn_tiled_stats), by width
KNN_WALK_STATS = {
    1: ("blocks_kept", "block_tests", "keys_buffered", "insert_rounds"),
    16: ("blocks_kept", "block_tests", "keys_buffered", "insert_rounds"),
    64: ("blocks_kept", "box_tests", "keys_merged", "merges")}


def _knn_codes(support, query, self_search, stream=None):
    """(support codes [B, Ns], query codes [B, Nq] or None on a
    self-search) int32 on the card: morton_codes of both clouds over one
    box per batch row that holds them both (knn_sorted_inputs computes
    the same on any device)."""
    b, ns, _ = support.shape
    nq = query.shape[1]
    dev = support.device
    if stream is None:
        stream = ctypes.c_void_p(_kb.stream_ptr(dev))
    lohi = torch.empty((b, 6), dtype=torch.float32, device=dev)
    s_codes = torch.empty((b, ns), dtype=torch.int32, device=dev)
    q_codes = None if self_search else \
        torch.empty((b, nq), dtype=torch.int32, device=dev)
    err = _kb.library().knn_codes_launch(
        support.data_ptr(), query.data_ptr(), lohi.data_ptr(),
        s_codes.data_ptr(), None if q_codes is None else q_codes.data_ptr(),
        b, ns, nq, int(self_search), stream)
    _kb.check(err, "knn_tiled codes")
    return s_codes, q_codes


def knn_tiled_counter(k: int) -> str:
    """The attribute of knn_tiled that counts launches of the width that
    serves k: "launches_k64" for K = 64, else "launches"."""
    return "launches_k64" if knn_kernel_k(k) == 64 else "launches"


def _count_launch(k: int):
    attr = knn_tiled_counter(k)
    setattr(knn_tiled, attr, getattr(knn_tiled, attr) + 1)


knn_tiled.launches = 0
knn_tiled.launches_k64 = 0


# --------------------------------------------------------- window search ---


def _window_topk_plain(support, queries, starts, k, window, tq, mxu=False):
    """Plain PyTorch version of K1 (mxu=False) and K5 (mxu=True): same
    distances, same order. K5's d² is max(−2·q'·s' + (|s'|² + |q'|²), 0)
    with q' = q − c, s' = s − c and c the window's first support point."""
    b, ns, _ = support.shape
    nq = queries.shape[1]
    tiles = nq // tq
    st = torch.clamp(starts.long(), 0, ns - window)                # [B, T]
    ar = torch.arange(window, device=support.device)
    out = torch.empty((b, nq, k), dtype=torch.int32, device=support.device)
    for bi in range(b):
        win = support[bi][st[bi][:, None] + ar[None, :]]           # [T, W, 3]
        qs = queries[bi].reshape(tiles, tq, 3)
        if mxu:
            c = win[:, :1, :]
            sc, qc = win - c, qs - c
            s2 = (sc[..., 0] * sc[..., 0] + sc[..., 1] * sc[..., 1]) \
                + sc[..., 2] * sc[..., 2]                          # [T, W]
            q2 = (qc[..., 0] * qc[..., 0] + qc[..., 1] * qc[..., 1]) \
                + qc[..., 2] * qc[..., 2]                          # [T, tq]
            m = qc * -2.0
            cross = (m[:, :, None, 0] * sc[:, None, :, 0]
                     + m[:, :, None, 1] * sc[:, None, :, 1]) \
                + m[:, :, None, 2] * sc[:, None, :, 2]             # [T, tq, W]
            d2 = torch.clamp(cross + (s2[:, None, :] + q2[:, :, None]),
                             min=0.0)
        else:
            d2 = _sq_dist(qs[:, :, None, 0], qs[:, :, None, 1],
                          qs[:, :, None, 2], win[:, None, :, 0],
                          win[:, None, :, 1], win[:, None, :, 2])
        out[bi] = _first_k(d2, k).reshape(nq, k).to(torch.int32)
    return out


def _first_k(d2, k):
    """The first k indices of d2 [..., W] (non-negative) in ascending
    (d², index) order, as a stable sort gives them: a top-k of int64 keys
    that are unique, the bits of the f32 d² (monotone in its value; +0.0
    for -0.0) above the index."""
    w = d2.shape[-1]
    if w > 1 << 16:
        return torch.sort(d2, dim=-1, stable=True)[1][..., :k]
    bits = (d2.float() + 0.0).view(torch.int32).long()
    key = (bits << 16) | torch.arange(w, device=d2.device)
    return torch.topk(key, k, dim=-1, largest=False).values & 0xFFFF


# K1/K5's launch plan (csrc/window_topk.cu): `split` threads share a query
# (each walks 1/split of the window) until TOPK_MIN_WARPS warps are in
# flight, while each still walks TOPK_MIN_WALK candidates or more; then
# CTAs shrink from TOPK_THREADS to 64 threads until the grid has
# TOPK_MIN_CTAS of them, which spreads a small grid evenly over the SMs.
TOPK_THREADS = 256
TOPK_MIN_WARPS = 16 * _kb.SMS
TOPK_MIN_CTAS = 4 * _kb.SMS
TOPK_MIN_WALK = 256


def window_topk_plan(b: int, nq: int, window: int, tq: int):
    """(split, queries per CTA, threads per CTA) of K1/K5 for these shapes:
    the CTAs of a tile each take qpc of its queries, with `split` threads
    per query, rounded up to whole warps."""
    split = 1
    while split < 8 and window >= 2 * split * TOPK_MIN_WALK and \
            b * nq * split < 32 * TOPK_MIN_WARPS:
        split *= 2
    tiles, threads = b * (nq // tq), TOPK_THREADS
    while threads > 64 and \
            tiles * -(-tq * split // threads) < TOPK_MIN_CTAS:
        threads //= 2
    parts = -(-tq * split // threads)
    qpc = -(-tq // parts)
    return split, qpc, _round_up(qpc * split, 32)


TOPK_BUF = 24     # K1/K5's buffered candidate keys a thread (k > 1)


def window_topk_smem(window: int, k: int, split: int, threads: int,
                     mxu: bool) -> int:
    """Dynamic shared memory of a K1/K5 launch, in bytes: the window padded
    to groups of 4·split candidates, 3 floats each (K5: 4, with |s'|²), the
    32-byte box of each block of 8 such groups (two sub-boxes a block at
    split 8, reduced over a warp each), and for k > 1 TOPK_BUF keys of 8
    bytes a thread. Above SMEM_DEFAULT the launch sets the opt-in
    attribute (the kernel has no static shared memory)."""
    wpad = _round_up(window, 4 * split)
    nblk = -(-(wpad // (4 * split)) // 8)
    boxes = nblk * (2 if split == 8 else 1)
    return wpad * (4 if mxu else 3) * 4 + boxes * 32 \
        + (threads * TOPK_BUF * 8 if k > 1 else 0)


def window_topk(support: torch.Tensor, queries: torch.Tensor,
                starts: torch.Tensor, k: int, window: int,
                tq: int = QUERY_TILE, mxu: Optional[bool] = None
                ) -> torch.Tensor:
    """K1 / K5: per query tile t, the k nearest of support[b, s:s+window]
    with s = starts[b, t], as window-relative ranks.

    support [B, Ns, 3] f32, queries [B, Nq, 3] f32, starts [B, Nq/tq] i32
    → [B, Nq, k] i32, ascending by squared distance, ties to the lower rank.
    mxu=True takes K5's centred-product distance, False K1's difference
    form, None MXU_DISTANCE_DEFAULT. CPU tensors take the plain version;
    CUDA tensors launch the kernel, for k in KERNEL_K, and count it in
    `window_topk.launches` (K1) or `window_topk.launches_mxu` (K5)."""
    b, ns, _ = support.shape
    nq = queries.shape[1]
    if mxu is None:
        mxu = MXU_DISTANCE_DEFAULT
    if queries.shape[0] != b or starts.shape != (b, nq // tq) or nq % tq:
        raise ValueError(f"window_topk: bad shapes {support.shape} "
                         f"{queries.shape} {starts.shape} tq={tq}")
    if not 1 <= k <= 16 or not k <= window <= ns:
        raise ValueError(f"window_topk: k={k} window={window} ns={ns}")
    if support.device.type == "cpu":
        return _window_topk_plain(support, queries, starts, k, window, tq,
                                  mxu)
    if support.dtype != torch.float32 or queries.dtype != torch.float32 \
            or starts.dtype != torch.int32:
        raise TypeError("window_topk: float32 points and int32 starts")
    _kb.require_cuda("window_topk", support, queries, starts)
    if k not in KERNEL_K:
        raise ValueError(f"window_topk: the kernel is built for k in "
                         f"{KERNEL_K}, not {k}")
    split, qpc, threads = window_topk_plan(b, nq, window, tq)
    out = torch.empty((b, nq, k), dtype=torch.int32, device=support.device)
    err = _kb.library().window_topk_launch(
        support.data_ptr(), queries.data_ptr(), starts.data_ptr(),
        out.data_ptr(), b, ns, nq, window, k, tq, int(mxu), split, qpc,
        threads, int(support.data_ptr() == queries.data_ptr() and ns == nq),
        window_topk_smem(window, k, split, threads, mxu),
        ctypes.c_void_p(_kb.stream_ptr(support.device)))
    _kb.check(err, "window_topk")
    if mxu:
        window_topk.launches_mxu += 1
    else:
        window_topk.launches += 1
    return out


window_topk.launches = 0
window_topk.launches_mxu = 0

# the counters of K1's counter build (window_topk_stats), in its order
K1_STATS = ("box_tests", "blocks_visited", "warp_groups",
            "warp_groups_passed", "keys_buffered", "keys_kept", "flushes",
            "insert_rounds", "warps")


def window_topk_stats(support: torch.Tensor, queries: torch.Tensor,
                      starts: torch.Tensor, k: int, window: int,
                      tq: int = QUERY_TILE, cut: int = 0,
                      read: bool = True):
    """K1's counter build on CUDA tensors, for measurement only (the main
    path never launches it, and it counts in no launch count): window_topk's
    result and {K1_STATS counter: its sum over the warps}, the box tests,
    blocks visited and groups a warp visits or passes (in some lane), the
    keys a lane buffers and keeps, a warp's flushes and insertion rounds
    (kernels/k1_twin.py counts the same). cut 1 ends every CTA after the
    staging of its window, 2 after the fill of its lists: their times
    are the walk's share; nothing is written to `out` then. read=False
    returns the counters as a tensor on the card, unread (a timed launch
    must not wait for the host)."""
    b, ns, _ = support.shape
    nq = queries.shape[1]
    if k not in KERNEL_K or queries.shape[0] != b or nq % tq or \
            starts.shape != (b, nq // tq) or cut not in (0, 1, 2):
        raise ValueError("window_topk_stats: bad arguments")
    _kb.require_cuda("window_topk_stats", support, queries, starts)
    split, qpc, threads = window_topk_plan(b, nq, window, tq)
    out = torch.empty((b, nq, k), dtype=torch.int32, device=support.device)
    stats = torch.zeros(len(K1_STATS), dtype=torch.int64,
                        device=support.device)
    err = _kb.library().window_topk_stats_launch(
        support.data_ptr(), queries.data_ptr(), starts.data_ptr(),
        out.data_ptr(), b, ns, nq, window, k, tq, split, qpc, threads,
        int(support.data_ptr() == queries.data_ptr() and ns == nq),
        window_topk_smem(window, k, split, threads, False), stats.data_ptr(),
        cut, ctypes.c_void_p(_kb.stream_ptr(support.device)))
    _kb.check(err, "window_topk_stats")
    return out, dict(zip(K1_STATS, stats.tolist())) if read else stats


@dataclasses.dataclass
class SortedCloud:
    """Clouds sorted along a space-filling curve, reusable across several
    window searches (a pyramid layer is self-support, self-query and
    up-query at once).

    xyz_sorted [B, N_pad, 3] (rows past n_real are SENTINEL pad rows);
    order [B, n_real] int32, the original index of each sorted row (None
    where no caller maps back); codes_sorted [B, n_real] (None for a
    self-query-only cloud, whose window starts need no codes)."""

    xyz_sorted: torch.Tensor
    order: Optional[torch.Tensor]
    codes_sorted: Optional[torch.Tensor]
    n_real: int


def pad_rows(xyz: torch.Tensor, n_pad: int) -> torch.Tensor:
    """xyz [B, N, 3] with SENTINEL rows appended up to n_pad."""
    b, n, _ = xyz.shape
    if n_pad == n:
        return xyz
    pad = torch.full((b, n_pad - n, 3), SENTINEL, dtype=xyz.dtype,
                     device=xyz.device)
    return torch.cat([xyz, pad], dim=1)


def sort_cloud(xyz: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
               pad_to: int = 128, curve: str = "morton",
               shift: int = 0) -> SortedCloud:
    """Sort xyz [B, N, 3] along the curve (a key of CURVES, its grid
    shifted by `shift`) over the [lo, hi] box ([B, 1, 3]) and pad to a
    multiple of pad_to rows."""
    codes = CURVES[curve](xyz, lo, hi, shift)
    codes_s, order, xyz_s = sort_by_codes(codes, xyz)
    n = xyz.shape[1]
    return SortedCloud(pad_rows(xyz_s, _round_up(n, pad_to)).contiguous(),
                       order, codes_s, n)


def self_query_starts(n_pad: int, ns_pad: int, window: int,
                      tq: int = QUERY_TILE, device=None) -> torch.Tensor:
    """Per-tile window starts of a self-search: each sorted query's rank is
    its own position, so tile t centres on t·tq + tq/2 (128-aligned)."""
    centers = torch.arange(n_pad // tq, dtype=torch.int32,
                           device=device) * tq + tq // 2
    starts = torch.clamp(centers - window // 2, 0, ns_pad - window)
    return (starts // 128) * 128


def median_floor(x: torch.Tensor) -> torch.Tensor:
    """jnp.median(x, axis=-1).astype(int32) for non-negative ints: the mean
    of the two middle values of an even-length row, truncated (torch.median
    would return the lower middle value)."""
    s = torch.sort(x, dim=-1).values
    m = s.shape[-1]
    return (s[..., (m - 1) // 2] + s[..., m // 2]) // 2


def _pad_last(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    """x [B, N, ...] padded to n_pad rows by repeating row N − 1."""
    n = x.shape[1]
    if n_pad == n:
        return x
    tail = x[:, n - 1:n].expand((x.shape[0], n_pad - n) + x.shape[2:])
    return torch.cat([x, tail], dim=1)


def tile_starts(sup: SortedCloud, q_codes: torch.Tensor, tq: int,
                window: int, limit: int, align: int) -> torch.Tensor:
    """Window starts [B, T] of query tiles of tq sorted queries (q_codes
    [B, T·tq], padded): each query's rank is its searchsorted position in
    the support's codes, a tile centres on the median of its ranks
    (jnp.median's: the truncated mean of the two middle values), and
    starts there − window/2, clipped to [0, limit] and aligned down to
    `align`."""
    pos = torch.searchsorted(sup.codes_sorted.contiguous(),
                             q_codes.contiguous())
    med = median_floor(pos.reshape(pos.shape[0], -1, tq))
    starts = torch.clamp(med - window // 2, 0, limit)
    return (starts // align) * align


def knn_window_sorted_raw(sup: SortedCloud, qry: SortedCloud, k: int, *,
                          query_chunk: int = QUERY_TILE, window: int = 2048,
                          self_query: bool = False,
                          mxu: Optional[bool] = None):
    """Window KNN between sorted clouds, staying in sorted space.

    Returns (idx [B, nq, k] into the support's sorted rows, rows in the
    query's sorted order; starts [B, nq_pad / query_chunk]) with
    idx[tile t] ∈ [starts[t], starts[t] + window): the invariant
    ops.gather.gather_window relies on. A self-search (support IS the
    query cloud) centres tile t on its own ranks; otherwise a tile centres
    on the median of its queries' ranks in the support (tile_starts).
    Starts are clipped to [0, ns_pad − window] and aligned down to 128."""
    b, ns_pad, _ = sup.xyz_sorted.shape
    ns, nq = sup.n_real, qry.n_real
    nq_pad = _round_up(nq, query_chunk)
    q = _pad_last(qry.xyz_sorted[:, :nq], nq_pad).contiguous()
    dev = sup.xyz_sorted.device
    if self_query:
        starts = self_query_starts(nq_pad, ns_pad, window, query_chunk, dev)
        starts = starts.expand(b, -1).contiguous()
    else:
        starts = tile_starts(sup, _pad_last(qry.codes_sorted, nq_pad),
                             query_chunk, window, ns_pad - window, 128)
        starts = starts.to(torch.int32).contiguous()
    rel = window_topk(sup.xyz_sorted.contiguous(), q, starts, k, window,
                      query_chunk, mxu)
    out = torch.repeat_interleave(starts, query_chunk, dim=1)[..., None] + rel
    # sentinel picks (only when the last window overhangs the pad rows)
    # clamp to the last real row, which stays inside that window
    out = torch.clamp(out, max=ns - 1)
    return out[:, :nq], starts


def knn_window_sorted(sup: SortedCloud, qry: SortedCloud, k: int, *,
                      query_chunk: int = QUERY_TILE, window: int = 2048,
                      self_query: bool = False) -> torch.Tensor:
    """Window KNN between sorted clouds; indices in the ORIGINAL support
    order, rows in the ORIGINAL query order."""
    out_sorted, _ = knn_window_sorted_raw(
        sup, qry, k, query_chunk=query_chunk, window=window,
        self_query=self_query)
    return _to_original(sup, qry, out_sorted)


def _to_original(sup: SortedCloud, qry: SortedCloud,
                 out_sorted: torch.Tensor) -> torch.Tensor:
    """Indices [B, nq, k] into the support's sorted rows, rows in the
    query's sorted order → support indices, rows in the query's order."""
    b, nq, k = out_sorted.shape
    out = torch.gather(sup.order.long(), 1,
                       out_sorted.reshape(b, -1).long()).reshape(b, nq, k)
    return gather_rows(out, invert_permutation(qry.order)).to(torch.int32)


# --------------------------------------- window search in original order ---

# knn_window's widths: K1 is built for KERNEL_K, so 1 < k < 16 runs the
# width 16 and keeps its first k columns; JAX's Pallas impl takes k ≤
# WINDOW_MAX_K and window ≤ WINDOW_MAX (ssdr_al_tpu/ops/knn.py:619-620)
WINDOW_MAX_K, WINDOW_MAX = 16, 4096
PROBE_SHIFT = 512          # the second probe's grid shift (half the range)
XLA_TILE_ELEMS = 1 << 22   # d² elements of one pass of the XLA form


def _window_k1(sup: SortedCloud, qry: SortedCloud, k, tq, window):
    """_knn_window_single_pallas (ssdr_al_tpu/ops/knn.py:426-462):
    knn_window_sorted_raw without the self-query shortcut (each tile's
    window from the median of its searchsorted ranks, as JAX's), at K1's
    width for k, its first k columns."""
    width = KERNEL_K[0] if k == 1 else KERNEL_K[1]
    out, _ = knn_window_sorted_raw(sup, qry, width, query_chunk=tq,
                                   window=window)
    return out[..., :k]


def _window_xla(sup: SortedCloud, qry: SortedCloud, k, tq, window):
    """_knn_window_single (ssdr_al_tpu/ops/knn.py:210-264), JAX's XLA form,
    in plain torch ops on any device: window = min(window, ns); each tile's
    window starts at the median of its ranks − window/2, clipped to
    [0, ns − window] and not aligned; an exact top-k over the window in
    ascending (d², rank) order, XLA_TILE_ELEMS d² at a time. Indices into
    the support's sorted rows, rows in the query's sorted order."""
    b, ns, nq = sup.xyz_sorted.shape[0], sup.n_real, qry.n_real
    window = min(window, ns)
    nq_pad = _round_up(nq, tq)
    q_pad = _pad_last(qry.xyz_sorted[:, :nq], nq_pad)
    starts = tile_starts(sup, _pad_last(qry.codes_sorted, nq_pad), tq,
                         window, ns - window, 1)                  # [B, T]
    ar = torch.arange(window, device=q_pad.device)
    tiles = nq_pad // tq
    step = max(1, XLA_TILE_ELEMS // (tq * window))
    out = torch.empty((b, nq_pad, k), dtype=torch.int64, device=q_pad.device)
    for bi in range(b):
        for t0 in range(0, tiles, step):
            st = starts[bi, t0:t0 + step]
            win = sup.xyz_sorted[bi][st[:, None] + ar]            # [T, W, 3]
            rows = slice(t0 * tq, (t0 + len(st)) * tq)
            qs = q_pad[bi, rows].reshape(-1, tq, 3)
            d2 = _sq_dist(qs[:, :, None, 0], qs[:, :, None, 1],
                          qs[:, :, None, 2], win[:, None, :, 0],
                          win[:, None, :, 1], win[:, None, :, 2])
            out[bi, rows] = (st[:, None, None] + _first_k(d2, k)).reshape(
                -1, k)
    return out[:, :nq]


def merge_probes(support, query, idx1, idx2, k):
    """_merge_probes (ssdr_al_tpu/ops/knn.py:579-596): the 2k candidates
    of two searches [B, nq, k] sorted by id, duplicates set to +inf, the k
    nearest by exact d² (ties to the lower position, as lax.top_k)."""
    both = torch.cat([idx1, idx2], dim=-1).long()                 # [B, nq, 2k]
    b, nq, kk = both.shape
    cand = gather_rows(support, both.reshape(b, -1)).reshape(b, nq, kk, 3)
    q = query[:, :, None, :]
    d2 = _sq_dist(q[..., 0], q[..., 1], q[..., 2],
                  cand[..., 0], cand[..., 1], cand[..., 2])
    ids, ordr = torch.sort(both, dim=-1, stable=True)
    d2s = torch.gather(d2, -1, ordr)
    dup = torch.cat([torch.zeros_like(ids[..., :1], dtype=torch.bool),
                     ids[..., 1:] == ids[..., :-1]], dim=-1)
    d2s = torch.where(dup, torch.inf, d2s)
    sel = torch.sort(d2s, dim=-1, stable=True).indices[..., :k]
    return torch.gather(ids, -1, sel).to(torch.int32)


def knn_window(support: torch.Tensor, query: torch.Tensor, k: int, *,
               query_chunk: int = QUERY_TILE, window: int = 2048,
               impl: str = "auto", probes: int = 1,
               curve: Optional[str] = None) -> torch.Tensor:
    """Space-filling-curve window KNN on clouds in their own order, the
    counterpart of ssdr_al_tpu's knn_window (approximate).

    support [B, Ns, 3], query [B, Nq, 3] f32 → int32 [B, Nq, k], support
    indices ascending by d², rows in the query's order. A cloud of at most
    `window` points or fewer than 2k is answered exactly by knn_approx
    (K6). impl "pallas" searches each tile's window with K1 (K5 where
    MXU_DISTANCE_DEFAULT is set, as JAX's; k ≤ 16, window ≤ 4096, else
    ValueError); "xla" is JAX's XLA form
    (_window_xla: tiles of at least 512 queries, unaligned windows, any
    k); "auto" is "pallas" on every device (JAX's auto takes "xla" off
    the TPU). CPU tensors take K1's and K6's plain versions, CUDA tensors
    launch the kernels. probes other than 1 (JAX's test is probes == 1)
    add a search on the grid shifted by PROBE_SHIFT and merge both by
    exact d² (merge_probes: no id twice in a row). curve: a key of CURVES,
    default "morton"."""
    b, ns, _ = support.shape
    nq = query.shape[1]
    if query.shape[0] != b or support.shape[-1] != 3 or query.shape[-1] != 3:
        raise ValueError(f"knn_window: bad shapes {tuple(support.shape)} "
                         f"{tuple(query.shape)}")
    if ns <= window or ns < 2 * k:
        return knn_approx(support, query, k)
    if impl == "auto":
        impl = "pallas"
    qc = min(query_chunk, _round_up(nq, 128))
    if impl == "pallas":
        if k > WINDOW_MAX_K or window > WINDOW_MAX:
            raise ValueError(f"knn_window: the K1 form takes k ≤ "
                             f"{WINDOW_MAX_K} and window ≤ {WINDOW_MAX}, "
                             f"not k={k} window={window}")
        single = _window_k1
    elif impl == "xla":
        single, qc = _window_xla, max(qc, 512)
    else:
        raise ValueError(f"knn_window: unknown impl {impl!r}")
    support, query = support.float(), query.float()
    lo = torch.minimum(support.amin(1, keepdim=True),
                       query.amin(1, keepdim=True))
    hi = torch.maximum(support.amax(1, keepdim=True),
                       query.amax(1, keepdim=True))
    outs = []
    for shift in (0,) if probes == 1 else (0, PROBE_SHIFT):
        sup = sort_cloud(support, lo, hi, curve=curve or "morton",
                         shift=shift)
        qry = sort_cloud(query, lo, hi, pad_to=1, curve=curve or "morton",
                         shift=shift)
        outs.append(_to_original(sup, qry, single(sup, qry, k, qc, window)))
    return outs[0] if probes == 1 else merge_probes(support, query, *outs, k)


def knn(support: torch.Tensor, query: torch.Tensor, k: int, *,
        engine: str = "xla", **kw) -> torch.Tensor:
    """KNN by engine name, each engine's keywords passed through as JAX's
    knn passes them: "xla" (exact, matmul form), "approx" (served exact by
    K6), "pallas" (exact, K6) or "window" (knn_window, approximate). The
    model pyramid builds its window engines on sorted clouds
    (models/randlanet.py::build_pyramid)."""
    if engine == "xla":
        return knn_xla(support, query, k, **kw)
    if engine == "approx":
        return knn_approx(support, query, k, **kw)
    if engine == "window":
        return knn_window(support, query, k, **kw)
    if engine == "pallas":
        return knn_tiled(support, query, k, **kw)
    raise ValueError(f"unknown knn engine {engine!r}")
