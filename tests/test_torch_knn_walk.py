"""What the redesigned K6 and K5 kernels rely on, checked on the CPU.

- K6 (csrc/knn_tiled.cu) walks the curve-sorted support by blocks of 32
  points with two levels of bounding boxes, skipping a (super-)block when
  the least d² to its box is strictly above the k-th best key's d², and
  keys candidates by (d², original index). Numpy twins of its two walks
  (K = 1 and 16: a lane per query; K = 64: a warp per query, pruned at
  the kout-th key), on the inputs the wrapper builds
  (ops/knn.py::knn_sorted_inputs) and with their rows written back by
  original query index, equal the plain version index for index on
  random, duplicated, coarse-grid and Ns < k clouds.
- K5 (csrc/window_topk.cu) skips a block of its window when the real least
  d² to the block's box in centred coordinates, rounded down, less the
  rounding error of the expanded d², is above every lane's k-th best: a
  numpy twin of that bound never exceeds the computed d² of a candidate
  in the block, far from the origin included.
- The shared-memory arithmetic of both launches (knn_tiled_plan,
  window_topk_smem), which the launchers recompute and refuse on mismatch.
- K1 (csrc/window_topk.cu): a numpy twin of its walk (kernels/k1_twin.py,
  the redesign's and the parent's, and the candidates its counters
  turned down) equals the plain version index for index on random and
  tie-heavy clouds at the main path's windows, and the redesign's
  bounded flushes run fewer insertion rounds than the parent's.
"""

import numpy as np
import pytest
import torch

from ssdr_al_torch.kernels import k1_twin
from ssdr_al_torch.ops import knn as tk

torch.set_num_threads(1)

F32 = np.float32
EMPTY = np.uint64(0x7F800000) << np.uint64(32)


def _keys(d2, ids):
    return ((d2.view(np.uint32) & np.uint32(0x7FFFFFFF)).astype(np.uint64)
            << np.uint64(32)) | ids.astype(np.uint64)


def _d2(q, s):
    """[nq, ns] (dx·dx + dy·dy) + dz·dz in float32, one rounding each."""
    d = q[:, None, :] - s[None, :, :]
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]


def _box_lb(lo, hi, q):
    """[nq, nbox] key_topk.cuh::box_lb in float32: the least d² to each box,
    rounded to nearest at every step."""
    e = np.maximum(np.maximum(lo[None] - q[:, None], q[:, None] - hi[None]),
                   F32(0.0))
    return (e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]) \
        + e[..., 2] * e[..., 2]


def walk_twin(groups, order, q_xyz, q_order, q_pos, ns, k, strict=True):
    """K6's lane-per-query walk (knn_walk_kernel, K = 1 and 16; at k > 16
    the K = 64 walk it ran before knn_walk64_kernel, kept as the yardstick
    of the new one's pairs) for one batch row, in numpy, at the width
    K = knn_kernel_k(k): a warp per 32 sorted queries starting at the
    block of its middle query's rank, the first min(K, 32) candidates of
    that block taken at once, then the spiral over
    super-blocks and, in each kept one, over its blocks from the one
    nearest the start; a (super-)block is kept while its box_lb is <=
    some lane's K-th best (strict=False keeps it only while below, the
    skip that loses ties). Each lane's list is updated as soon as a block
    is evaluated, the tightest threshold the kernel's buffered one can
    reach. Returns (out [nq, k] by original query row: the first k of each
    list of K, pairs evaluated)."""
    k_out, k = k, tk.knn_kernel_k(k)
    fill = min(k, tk.KNN_BLOCK)
    pts = groups.transpose(0, 2, 1).reshape(-1, 3)
    nblk = pts.shape[0] // tk.KNN_BLOCK
    nsup = -(-nblk // tk.KNN_SUPER)
    blocks = pts.reshape(nblk, tk.KNN_BLOCK, 3)
    with np.errstate(invalid="ignore"):
        blo, bhi = np.nanmin(blocks, 1), np.nanmax(blocks, 1)
    slo = np.stack([blo[i * tk.KNN_SUPER:(i + 1) * tk.KNN_SUPER].min(0)
                    for i in range(nsup)])
    shi = np.stack([bhi[i * tk.KNN_SUPER:(i + 1) * tk.KNN_SUPER].max(0)
                    for i in range(nsup)])
    nq = q_xyz.shape[0]
    out = np.zeros((nq, k_out), np.int64)
    pairs = 0

    def keep(lo, hi, qs, best):
        thr = (best[:, -1] >> np.uint64(32)).astype(np.uint32).view(F32)
        lb = _box_lb(lo[None], hi[None], qs)[:, 0]
        return bool((lb <= thr).any() if strict else (lb < thr).any())

    for r0 in range(0, nq, 32):
        live = min(32, nq - r0)
        qs = q_xyz[np.minimum(np.arange(r0, r0 + 32), nq - 1)]
        blk0 = min(max(int(q_pos[min(r0 + 16, nq - 1)]), 0) // 32, nblk - 1)
        sb0 = blk0 // tk.KNN_SUPER
        best = np.full((32, k), EMPTY, np.uint64)
        first = 0

        def evaluate(blk, c0, best):
            ranks = np.arange(blk * 32 + c0, min(blk * 32 + 32, ns))
            keys = _keys(_d2(qs, pts[ranks]),
                         np.broadcast_to(order[ranks], (32, len(ranks))))
            return np.sort(np.concatenate([best, keys], 1), 1)[:, :k], \
                len(ranks)

        if k % 8 == 0 and blk0 * 32 + fill <= ns:
            ranks = np.arange(blk0 * 32, blk0 * 32 + fill)
            best[:, :fill] = np.sort(_keys(_d2(qs, pts[ranks]),
                                           np.broadcast_to(order[ranks],
                                                           (32, fill))), 1)
            first, seen = fill, fill
        else:
            seen = 0
        for i in range(2 * nsup):
            d = (i + 1) >> 1
            sb = sb0 + d if i & 1 else sb0 - d
            if not 0 <= sb < nsup or not keep(slo[sb], shi[sb], qs, best):
                continue
            lo_b = sb * tk.KNN_SUPER
            hi_b = min(lo_b + tk.KNN_SUPER, nblk)
            piv = min(max(blk0, lo_b), hi_b - 1)
            for j in range(2 * tk.KNN_SUPER):
                d = (j + 1) >> 1
                blk = piv + d if j & 1 else piv - d
                if not lo_b <= blk < hi_b or \
                        not keep(blo[blk], bhi[blk], qs, best):
                    continue
                best, n = evaluate(blk, first if blk == blk0 else 0, best)
                seen += n
        pairs += seen * live
        out[q_order[r0:r0 + live]] = (best[:live, :k_out]
                                      & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return out, pairs


def _spiral(t, c0, n):
    """knn_tiled.cu::spiral_at: the t-th of [0, n) in spiral order from c0
    (c0, c0 + 1, c0 - 1, ..., then the longer side on its own)."""
    below, above = c0, n - 1 - c0
    m = np.minimum(below, above)
    near = np.where(t & 1, c0 + ((t + 1) >> 1), c0 - (t >> 1))
    far = np.where(above > below, c0 + (t - m), c0 - (t - m))
    return np.where(t <= 2 * m, near, far)


NEVER = np.uint64(0xFFFFFFFFFFFFFFFF)   # a pad of a walked block: no entry
DONE = np.int64(1) << np.int64(32)      # a box visited, or no box


def walk64_twin(groups, order, q_xyz, q_order, q_pos, ns, k, strict=True):
    """K6's K = 64 walk (knn_walk64_kernel, 16 < k <= 64) for one batch
    row, in numpy, every query at once: a warp a query; the fill of the
    query's block and its neighbour on the side of its rank (64
    candidates, the empty key for each missing one); then the super-blocks
    in chunks of 32 in spiral order from the query's, each chunk nearest
    box first, and in a kept super-block its blocks but the fill's, nearest
    box first (ties to the lower lane); a level ends at the first box whose
    box_lb is above the list's kout-th d² (strict=False: at or above it,
    the skip that loses ties). A block's candidates below the kout-th key
    enter together. Returns (out [nq, k] by original query row, pairs
    evaluated)."""
    kout = k
    pts = groups.transpose(0, 2, 1).reshape(-1, 3)
    nblk = pts.shape[0] // tk.KNN_BLOCK
    nsup = -(-nblk // tk.KNN_SUPER)
    blocks = pts.reshape(nblk, tk.KNN_BLOCK, 3)
    with np.errstate(invalid="ignore"):
        blo, bhi = np.nanmin(blocks, 1), np.nanmax(blocks, 1)
    slo = np.stack([blo[i * tk.KNN_SUPER:(i + 1) * tk.KNN_SUPER].min(0)
                    for i in range(nsup)])
    shi = np.stack([bhi[i * tk.KNN_SUPER:(i + 1) * tk.KNN_SUPER].max(0)
                    for i in range(nsup)])
    nq = q_xyz.shape[0]
    lanes = np.arange(32)
    p0 = q_pos.astype(np.int64)
    blk0 = np.minimum(p0 // 32, nblk - 1)
    back = (((p0 & 31) < 16) & (blk0 > 0)) | (blk0 + 1 >= nblk)
    fa, fb = np.where(back, blk0 - 1, blk0), np.where(back, blk0, blk0 + 1)

    def block_keys(blk, qs, pad):
        """[n, 32] keys of each query's block blk (pad past Ns or for
        blk < 0) and the real candidates of each."""
        ranks = blk[:, None] * 32 + lanes
        real = (blk[:, None] >= 0) & (ranks < ns)
        r = np.clip(ranks, 0, pts.shape[0] - 1)
        with np.errstate(invalid="ignore"):
            d = qs[:, None, :] - pts[r]
            d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
                + d[..., 2] * d[..., 2]
        return np.where(real, _keys(d2, order[r]), pad), real.sum(1)

    c0, n0 = block_keys(fa, q_xyz, EMPTY)
    c1, n1 = block_keys(fb, q_xyz, EMPTY)
    best = np.sort(np.concatenate([c0, c1], 1), 1)
    pairs = int(n0.sum() + n1.sum())

    def thr_d(rows):
        return (best[rows, kout - 1] >> np.uint64(32)).astype(
            np.uint32).view(F32)

    def keep(lb, rows):
        """Whether each box of bits lb (DONE: none) is visited against the
        threshold of rows as it stands."""
        lv = lb.astype(np.uint32).view(F32)
        with np.errstate(invalid="ignore"):
            near = (lv <= thr_d(rows)) if strict else (lv < thr_d(rows))
        return (lb != DONE) & near

    def bits(lb):
        return lb.view(np.uint32).astype(np.int64)

    sb0 = blk0 // tk.KNN_SUPER
    every = np.arange(nq)
    for t0 in range(0, nsup, 32):
        t = t0 + lanes
        sb = _spiral(np.minimum(t, nsup - 1)[None], sb0[:, None], nsup)
        lbs = np.where(t[None] < nsup,
                       bits(_box_lb_rows(slo[sb], shi[sb], q_xyz)), DONE)
        for js in np.argsort(lbs, 1, kind="stable").T:
            go = keep(lbs[every, js], every)
            if not go.any():
                break
            rows = every[go]
            blk = sb[rows, js[go]][:, None] * tk.KNN_SUPER + lanes
            open_ = (blk < nblk) & (blk != fa[rows, None]) \
                & (blk != fb[rows, None])
            bc = np.minimum(blk, nblk - 1)
            lbb = np.where(open_, bits(_box_lb_rows(blo[bc], bhi[bc],
                                                    q_xyz[rows])), DONE)
            for jb in np.argsort(lbb, 1, kind="stable").T:
                on = keep(lbb[np.arange(len(rows)), jb], rows)
                if not on.any():
                    break
                sub = rows[on]
                vb = blk[np.arange(len(rows))[on], jb[on]]
                keys, n = block_keys(vb, q_xyz[sub], NEVER)
                keys = np.where(keys < best[sub, kout - 1, None], keys,
                                NEVER)
                best[sub] = np.sort(np.concatenate([best[sub], keys], 1),
                                    1)[:, :64]
                pairs += int(n.sum())
    out = np.zeros((nq, kout), np.int64)
    out[q_order] = (best[:, :kout] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return out, pairs


def _box_lb_rows(lo, hi, q):
    """[n, m] key_topk.cuh::box_lb of query row i to its boxes lo / hi
    [n, m, 3], in float32."""
    e = np.maximum(np.maximum(lo - q[:, None], q[:, None] - hi), F32(0.0))
    return (e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]) \
        + e[..., 2] * e[..., 2]


def _cloud(kind, n, rng):
    if kind == "random":
        return (rng.rand(n, 3) * 6).astype(F32)
    if kind == "duplicates":
        return np.repeat((rng.rand(-(-n // 4), 3) * 2).astype(F32), 4,
                         axis=0)[rng.permutation(n)]
    if kind == "grid":
        return (rng.randint(0, 6, (n, 3)) * 0.25).astype(F32)
    raise ValueError(kind)


def _twin_knn(s, q, k, self_search, strict=True, sort=True, lane=False):
    """The wrapper's inputs for [B, Ns, 3] / [B, Nq, 3] tensors (sorted, or
    in their own order as for at most KNN_SORT_MIN[K] support points), each
    batch row through the twin of the kernel's walk at k (walk64_twin for
    16 < k, walk_twin below; lane=True: walk_twin at any k): [B, Nq, k]
    and the pairs evaluated."""
    groups, order, qx, qo, qp = tk.knn_sorted_inputs(s, q, self_search,
                                                     sort)
    twin = walk64_twin if k > 16 and not lane else walk_twin
    outs, pairs = [], 0
    for bi in range(s.shape[0]):
        o, p = twin(groups[bi].numpy(), order[bi].numpy(),
                    qx[bi].numpy(), qo[bi].numpy(), qp[bi].numpy(),
                    s.shape[1], k, strict)
        outs.append(o)
        pairs += p
    return np.stack(outs), pairs


@pytest.mark.parametrize("kind", ["random", "duplicates", "grid"])
@pytest.mark.parametrize("k", [16, 1, 46])
@pytest.mark.parametrize("ns,nq,self_search,sort", [
    (1500, 1500, True, True),    # a pyramid self-search, nq % 32 != 0
    (700, 2500, False, True),    # an upsample: queries against a subset
    (2600, 333, False, True),    # more support than queries
    (700, 2500, False, False),   # the walk in the clouds' own order
    (900, 900, True, False),
])
def test_k6_walk_twin_equals_plain(kind, k, ns, nq, self_search, sort):
    """The walk over the sorted clouds (or the clouds in their own order),
    keyed on the original index and written back by the original query
    row, equals _knn_tiled_plain index for index, ties included, at the
    widths K = 1, 16 (the lane-per-query walk) and, for k = 46, the
    partition's, 64 (the warp-per-query walk); on random sorted clouds it
    evaluates a fraction of the pairs for k <= 16 (at k = 46 a query's
    neighbourhood is a large part of these small clouds)."""
    rng = np.random.RandomState(ns + nq + k)
    b = 2
    s = torch.from_numpy(np.stack([_cloud(kind, ns, rng) for _ in range(b)]))
    q = s if self_search else torch.from_numpy(
        np.stack([_cloud(kind, nq, rng) for _ in range(b)]))
    want = tk._knn_tiled_plain(s, q, k).numpy()
    got, pairs = _twin_knn(s, q, k, self_search, sort=sort)
    np.testing.assert_array_equal(got, want)
    share = pairs / (b * ns * nq)
    assert 0 < share <= 1
    if kind == "random" and sort and k <= 16:
        assert share < 0.7, share


def test_k6_walk_twin_prunes_more_on_larger_clouds():
    """The share of pairs evaluated falls as the cloud grows (a warp's
    neighbourhood is a smaller part of it): at 4096 points under 0.6 of
    the share at 1024."""
    rng = np.random.RandomState(11)
    share = []
    for n in (1024, 4096):
        s = torch.from_numpy((rng.rand(1, n, 3) * 6).astype(F32))
        got, pairs = _twin_knn(s, s, 16, True)
        np.testing.assert_array_equal(got,
                                      tk._knn_tiled_plain(s, s, 16).numpy())
        share.append(pairs / n ** 2)
    assert share[1] < 0.6 * share[0], share


def test_k6_walk_twin_strict_skip_keeps_ties():
    """On a coarse grid the least d² to a box often equals a lane's k-th
    best exactly while the box holds a candidate at that d² with a lower
    index: the strict skip keeps that block and equals the plain version,
    a skip on equality loses the candidate."""
    rng = np.random.RandomState(3)
    s = torch.from_numpy(np.stack([_cloud("grid", 1500, rng)]))
    want = tk._knn_tiled_plain(s, s, 16).numpy()
    got, _ = _twin_knn(s, s, 16, True)
    np.testing.assert_array_equal(got, want)
    loose, _ = _twin_knn(s, s, 16, True, strict=False)
    assert (loose != want).any()


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("ns,nq", [(5, 40), (12, 70), (16, 33)])
def test_k6_walk_twin_fewer_support_than_k(ns, nq, sort):
    """Ns <= k: no fill from a partial block, every real candidate keyed,
    the slots past Ns left empty, which reads as index 0."""
    rng = np.random.RandomState(ns)
    s = torch.from_numpy(rng.randn(2, ns, 3).astype(F32))
    q = torch.from_numpy(rng.randn(2, nq, 3).astype(F32))
    want = tk._knn_tiled_plain(s, q, 16).numpy()
    got, pairs = _twin_knn(s, q, 16, False, sort=sort)
    np.testing.assert_array_equal(got, want)
    assert (got[..., ns:] == 0).all() and pairs == 2 * ns * nq


@pytest.mark.parametrize("k", [17, 46, 64])
@pytest.mark.parametrize("ns", [33, 63, 64, 65, 96])
def test_k6_walk64_twin_around_the_fill(ns, k):
    """The K = 64 walk where its two-block fill holds every support point
    (Ns <= 64: Ns < k among them, the slots past Ns index 0) or all but a
    few (65, 96: the walk visits what the fill left), a self-search and
    an upsample-shaped search on each route's inputs, equal to the plain
    version."""
    rng = np.random.RandomState(ns + k)
    s = torch.from_numpy(rng.randn(2, ns, 3).astype(F32))
    q = torch.from_numpy(rng.randn(2, 70, 3).astype(F32))
    for sup, qry, self_search in ((s, s, True), (s, q, False)):
        want = tk._knn_tiled_plain(sup, qry, k).numpy()
        for sort in (False, True):
            got, pairs = _twin_knn(sup, qry, k, self_search, sort=sort)
            np.testing.assert_array_equal(got, want)
            assert pairs <= 2 * ns * qry.shape[1]
        if ns < k:
            assert (got[..., ns:] == 0).all()


def test_k6_walk64_twin_strict_skip_keeps_ties():
    """At k = 46 on a coarse grid the least d² to a box often equals the
    list's kout-th d² while the box holds a candidate at that d² with a
    lower index: the warp walk's strict skip keeps the box and equals the
    plain version, a skip on equality loses the candidate."""
    rng = np.random.RandomState(3)
    s = torch.from_numpy(np.stack([_cloud("grid", 1500, rng)]))
    want = tk._knn_tiled_plain(s, s, 46).numpy()
    got, _ = _twin_knn(s, s, 46, True)
    np.testing.assert_array_equal(got, want)
    loose, _ = _twin_knn(s, s, 46, True, strict=False)
    assert (loose != want).any()


def test_k6_walk64_twin_evaluates_fewer_pairs():
    """On a random 4096-point cloud at k = 46 the warp-per-query walk
    (pruned at the 46th key, each query's own boxes, a 64-candidate fill)
    evaluates fewer pairs than the lane-per-query walk at K = 64 it
    replaced (pruned at the 64th key, boxes kept for any of 32 queries),
    both equal to the plain version."""
    rng = np.random.RandomState(12)
    s = torch.from_numpy((rng.rand(1, 4096, 3) * 6).astype(F32))
    want = tk._knn_tiled_plain(s, s, 46).numpy()
    new, new_pairs = _twin_knn(s, s, 46, True)
    old, old_pairs = _twin_knn(s, s, 46, True, lane=True)
    np.testing.assert_array_equal(new, want)
    np.testing.assert_array_equal(old, want)
    assert new_pairs < 0.6 * old_pairs, (new_pairs, old_pairs)


def test_k6_sorted_inputs_keep_rows():
    """knn_sorted_inputs only reorders rows: the groups hold support[order]
    (NaN pads past Ns), the sorted queries are query[qorder], both orders
    are permutations, the support's morton codes ascend and qpos is each
    query's searchsorted rank (its own rank on a self-search)."""
    rng = np.random.RandomState(1)
    s = torch.from_numpy((rng.rand(2, 1000, 3) * 6).astype(F32))
    q = torch.from_numpy((rng.rand(2, 300, 3) * 7).astype(F32))
    for sup, qry, self_search in ((s, q, False), (s, s, True)):
        groups, order, qx, qo, qp = tk.knn_sorted_inputs(sup, qry,
                                                         self_search)
        nblk = -(-sup.shape[1] // tk.KNN_BLOCK)
        assert groups.shape == (2, nblk * 8, 3, 4)
        rows = groups.transpose(2, 3).reshape(2, -1, 3)
        n = sup.shape[1]
        for bi in range(2):
            o = order[bi, :n].long()
            assert torch.equal(torch.sort(o).values, torch.arange(n))
            assert torch.equal(rows[bi, :n], sup[bi, o])
            assert torch.isnan(rows[bi, n:]).all()
            assert torch.equal(qx[bi], qry[bi, qo[bi].long()])
            assert torch.equal(torch.sort(qo[bi].long()).values,
                               torch.arange(qry.shape[1]))
        if self_search:
            assert torch.equal(qp, torch.arange(n, dtype=torch.int32)
                               .expand(2, n))
        else:
            lo = torch.minimum(sup.amin(1, keepdim=True),
                               qry.amin(1, keepdim=True))
            hi = torch.maximum(sup.amax(1, keepdim=True),
                               qry.amax(1, keepdim=True))
            sc = torch.sort(tk.morton_codes(sup, lo, hi), -1).values
            qc = torch.sort(tk.morton_codes(qry, lo, hi), -1).values
            assert torch.equal(qp, torch.searchsorted(sc, qc).int())


# ------------------------------------------------------------- K5 bound ---


def _round_down(v):
    """float64 → the float32 at or below it."""
    f = v.astype(F32)
    return np.where(f.astype(np.float64) > v,
                    np.nextafter(f, F32(-np.inf)), f)


def _round_up(v):
    f = v.astype(F32)
    return np.where(f.astype(np.float64) < v,
                    np.nextafter(f, F32(np.inf)), f)


def k5_box_lb(lo, hi, w2max, q, q2):
    """[nq, nbox] window_topk.cu::k5_box_lb: the real least d² from each
    centred query to each box with every step rounded down (float32
    operands, exact in float64, then rounded toward −inf), times
    (1 − 2^-23), less 2^-20·(q2 + w2max) + 2^-126 rounded up."""
    f64 = np.float64
    gap = np.maximum(np.maximum(
        _round_down(lo[None].astype(f64) - q[:, None]),
        _round_down(q[:, None].astype(f64) - hi[None])), F32(0.0))
    sq = [_round_down(gap[..., a].astype(f64) ** 2) for a in range(3)]
    ell = _round_down(_round_down(sq[0].astype(f64) + sq[1]).astype(f64)
                      + sq[2])
    s = _round_up(q2[:, None].astype(f64) + w2max[None])
    err = _round_up(s.astype(f64) * 2.0 ** -20 + 2.0 ** -126)
    scaled = _round_down(ell.astype(f64) * (1.0 - 2.0 ** -23))
    return _round_down(scaled.astype(f64) - err)


def _k5_d2(q, s):
    """K5's computed d² between centred float32 points, in the kernel's
    order: max(((m_x s_x + m_y s_y) + m_z s_z) + (|s|² + |q|²), 0) with
    m = −2q and each norm ((x·x + y·y) + z·z)."""
    w2 = (s[:, 0] * s[:, 0] + s[:, 1] * s[:, 1]) + s[:, 2] * s[:, 2]
    q2 = (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]) + q[:, 2] * q[:, 2]
    m = q * F32(-2.0)
    cross = (m[:, None, 0] * s[None, :, 0] + m[:, None, 1] * s[None, :, 1]) \
        + m[:, None, 2] * s[None, :, 2]
    return np.maximum(cross + (w2[None, :] + q2[:, None]), F32(0.0)), w2, q2


def _k5_fma(q, s, w2, q2):
    """K5's filter form fma(m_x, s_x, fma(m_y, s_y, fma(m_z, s_z, w2 + q2)))
    in float32, each fma through float64 (the product exact there)."""
    m = (q * F32(-2.0)).astype(np.float64)
    t = (w2[None, :] + q2[:, None]).astype(np.float64)
    a = (m[:, None, 2] * s[None, :, 2] + t).astype(F32).astype(np.float64)
    b = (m[:, None, 1] * s[None, :, 1] + a).astype(F32).astype(np.float64)
    return (m[:, None, 0] * s[None, :, 0] + b).astype(F32)


@pytest.mark.parametrize("kind,offset,centre", [
    ("random", 0.0, True), ("duplicates", 0.0, True), ("grid", 0.0, True),
    ("random", 100.0, True), ("random", 1000.0, True),
    ("grid", 1000.0, True),
    # uncentred far clouds: |q'|² ~ 1e6, where the expanded form cancels
    ("random", 100.0, False), ("random", 1000.0, False),
    ("near", 1000.0, False),
])
def test_k5_block_bound_never_exceeds_a_candidate(kind, offset, centre):
    """The bound of every (query, block of 32 window points) pair is at
    most the computed d² of each candidate in the block, and the group
    filter's FMA form of each candidate at most its filter bound; where the
    cloud is centred the block bound still prunes most blocks."""
    rng = np.random.RandomState(int(offset) + len(kind))
    n = 1024
    if kind == "near":
        # queries within 1e-4 of support points: d² is all rounding error
        base = (rng.rand(n, 3) * 6).astype(F32)
        s = base + F32(offset)
        q = (base[rng.randint(0, n, 512)]
             + rng.randn(512, 3).astype(F32) * F32(1e-4)) + F32(offset)
    else:
        s = _cloud(kind, n, rng) + F32(offset)
        q = _cloud(kind, 512, rng) + F32(offset)
    x = torch.from_numpy(s[None])
    lo, hi = x.amin(1, keepdim=True), x.amax(1, keepdim=True)
    s = tk.sort_by_codes(tk.morton_codes(x, lo, hi), x)[2][0].numpy()
    c = s[0] if centre else np.zeros(3, F32)
    sc, qc = s - c, q - c                        # float32, as the kernel
    d2, w2, q2 = _k5_d2(qc, sc)
    blocks = sc.reshape(-1, 32, 3)
    blo, bhi = blocks.min(1), blocks.max(1)
    wmax = w2.reshape(-1, 32).max(1)
    lb = k5_box_lb(blo, bhi, wmax, qc, q2)       # [nq, nblk]
    least = d2.reshape(len(q), -1, 32).min(-1)
    assert (lb <= least).all(), float((lb - least).max())
    # the group filter: the FMA form never exceeds the bound of the exact
    # d² that the block's k5_filter_err gives
    f = _k5_fma(qc, sc, w2, q2)
    err = _round_up(_round_up(q2[:, None].astype(np.float64) + wmax[None])
                    .astype(np.float64) * 2.0 ** -19 + 2.0 ** -126)
    tf = _round_up(d2.reshape(len(q), -1, 32).astype(np.float64)
                   * (1.0 + 2.0 ** -22) + err[..., None])
    assert (f.reshape(tf.shape) <= tf).all()
    if centre and kind != "near":
        thr = np.sort(d2, 1)[:, 15]
        assert (lb > thr[:, None]).mean() > 0.5   # the bound does prune


@pytest.mark.parametrize("ns,k,route", [
    (80, 1, "brute"), (640, 1, "brute"), (2560, 1, "brute"),
    (4096, 1, "brute"), (10240, 1, "sorted"), (65536, 1, "sorted"),
    (160, 16, "walk"), (704, 16, "walk"), (1024, 16, "sorted"),
    (2560, 16, "sorted"), (40960, 16, "sorted")])
def test_k6_route_by_support_size(ns, k, route):
    """K6's route at the support sizes of the three exact pyramids' calls:
    the thread-per-query loop for the 1-NN upsamples up to 4096 points,
    the walk in the clouds' own order for k=16 up to 704, the walk over
    the sorted clouds beyond (the fastest route at each call on the H100,
    kernels/measure.py --k6-only)."""
    assert tk.knn_tiled_route(ns, k) == route


# ----------------------------------------------------- shared memory ---


@pytest.mark.parametrize("ns,k,in_smem,opt_in", [
    (40960, 16, False, True), (65536, 16, False, True),
    (45056, 16, False, True), (10240, 16, True, True),
    (160, 16, True, True), (40960, 1, True, False), (10240, 1, True, False),
    (65536, 1, True, True)])
def test_k6_shared_memory_plan(ns, k, in_smem, opt_in):
    """K6's dynamic shared memory: eight warps' 512-byte stages, for k=16
    256 threads' 24 keys of 8 bytes, and the box tables (32 bytes a block
    and a super-block) where three CTAs still fit on an SM (228 KiB, 1 KiB
    reserved a CTA), else the super-blocks' alone: in shared memory at
    40960 and 65536 points for k=1 and below ~20 000 for k=16. Above 48
    KiB the launch needs the opt-in, at S3DIS's and Semantic3D's L0 among
    others."""
    nblk, nsup, got_in, smem = tk.knn_tiled_plan(ns, k)
    assert nblk == -(-ns // 32) and nsup == -(-nblk // 32)
    assert got_in == in_smem
    fixed = 8 * 512 + (256 * 24 * 8 if k > 1 else 0)
    assert smem == (nblk + nsup if in_smem else nsup) * 32 + fixed
    assert (smem > tk.SMEM_DEFAULT) == opt_in
    assert 3 * (smem + 1024) <= 228 * 1024
    if not in_smem:
        assert 3 * (smem + nblk * 32 + 1024) > 228 * 1024
    if ns == 40960 and k == 16:
        assert smem == 54528
    if ns == 65536 and k == 1:
        assert smem == 71680


def test_k6_shared_memory_plan_far_past_the_tables():
    """At 400 000 points the super-blocks' table alone stays in shared
    memory, still within one CTA's limit."""
    nblk, nsup, in_smem, smem = tk.knn_tiled_plan(400_000, 16)
    assert not in_smem
    assert smem == nsup * 32 + 8 * 512 + 256 * 24 * 8 <= tk.SMEM_LIMIT


@pytest.mark.parametrize("window,split,threads,mxu,want", [
    (1792, 1, 256, False, 1792 * 12 + 56 * 32 + 256 * 24 * 8),
    (1792, 1, 256, True, 1792 * 16 + 56 * 32 + 256 * 24 * 8),
    (2560, 4, 128, True, 2560 * 16 + 20 * 32 + 128 * 24 * 8),
    (2560, 8, 64, False, 2560 * 12 + 10 * 2 * 32 + 64 * 24 * 8),
    (4096, 1, 256, True, 4096 * 16 + 128 * 32 + 256 * 24 * 8),
    (100, 2, 64, False, 104 * 12 + 2 * 32 + 64 * 24 * 8),
])
def test_window_topk_shared_memory(window, split, threads, mxu, want):
    """K1/K5's dynamic shared memory: the window padded to groups of
    4·split, 12 bytes a candidate (K5: 16, with |s'|²), a 32-byte box per
    block of 8 groups of split (K5's holds its largest |s'|² too; two
    sub-boxes a block at split 8, each reduced over a warp), 24 keys of 8
    bytes a thread; all within one CTA's limit."""
    got = tk.window_topk_smem(window, 16, split, threads, mxu)
    assert got == want and got <= tk.SMEM_LIMIT
    assert tk.window_topk_smem(window, 1, split, threads, mxu) == \
        want - threads * 24 * 8


# ------------------------------------------------------------ K1's walk ---

def _sorted_tie_cloud(kind, b, n, rng):
    """[b, n, 3] curve-sorted clouds: random, every point four times, or
    points on a coarse grid."""
    x = np.stack([_cloud(kind, n, rng) for _ in range(b)])
    xt = torch.from_numpy(x)
    lo, hi = xt.amin(1, keepdim=True), xt.amax(1, keepdim=True)
    return tk.sort_by_codes(tk.morton_codes(xt, lo, hi), xt)[2].contiguous()


K1_WALKS = [
    (4096, 1792, 16, 1),     # L0's window
    (2048, 768, 16, 2),      # L1's
    (2560, 2560, 16, 8),     # L2's (the whole layer), as at b = 2
    (2048, 2048, 16, 4),
    (4096, 1024, 16, 1),     # the upsamples' window, k = 16 too
]


@pytest.mark.parametrize("kind", ["random", "duplicates", "grid"])
@pytest.mark.parametrize("policy", ["new", "parent"])
@pytest.mark.parametrize("n,window,k,split", K1_WALKS)
def test_k1_walk_twin_equals_plain(kind, policy, n, window, k, split):
    """The twin of K1's walk (kernels/k1_twin.py), the redesign's and the
    parent's, equals _window_topk_plain index for index on random and
    tie-heavy sorted self-searches at the main path's windows, with the
    starts clamped past the cloud's end; split lanes share their k-th
    best."""
    _k1_walk_case(kind, policy, n, window, k, split)


@pytest.mark.parametrize("kind", ["random", "grid"])
@pytest.mark.parametrize("policy", ["every_block", "supers",
                                    "nearest_box", "own_fill"])
@pytest.mark.parametrize("n,window,k,split", [K1_WALKS[0], K1_WALKS[2]])
def test_k1_turned_down_walks_are_safe(kind, policy, n, window, k, split):
    """The candidates the counters turned down keep the plain version's
    indices too: their skip rules (a super-block's box past every lane's
    k-th best; the least d² from the warp's query box, in sorted order,
    past every lane's k-th best, which ends the chunk; each lane's own
    fill, skipped later by that lane only) never drop a candidate of the
    top-k nor take one twice, ties included."""
    _k1_walk_case(kind, policy, n, window, k, split)


def _k1_walk_case(kind, policy, n, window, k, split):
    rng = np.random.RandomState(n + window + split)
    xs = _sorted_tie_cloud(kind, 2, n, rng)
    st = tk.self_query_starts(n, n, window).expand(2, -1).contiguous()
    st[:, -1] = n                       # clamped to n - window
    want = tk._window_topk_plain(xs, xs, st, k, window, tk.QUERY_TILE)
    plan = (split, tk.QUERY_TILE // split, tk.QUERY_TILE)
    x = xs.numpy()
    got, c = k1_twin.walk(x, x, st.numpy().astype(np.int64), k, window,
                          tk.QUERY_TILE, plan, True, policy)
    np.testing.assert_array_equal(got, want.numpy())
    assert c["queries"] == 2 * n and c["keys_kept"] <= c["keys_buffered"]
    assert c["blocks_visited"] <= c["box_tests"] or policy == "nearest_box"


@pytest.mark.parametrize("kind", ["random", "grid"])
@pytest.mark.parametrize("policy", ["new", "parent"])
def test_k1_walk_twin_upsample_equals_plain(kind, policy):
    """The 1-NN upsample (k = 1, W = 1024, starts from the kept ranks as
    models/randlanet.py computes them; the walk starts at the nearest of
    32 samples of the window): the twin equals the plain version."""
    rng = np.random.RandomState(5)
    n = 4096
    xs = _sorted_tie_cloud(kind, 2, n, rng)
    kept = torch.from_numpy(np.stack([rng.permutation(n) < n // 4
                                      for _ in range(2)]))
    sub = torch.stack([xs[i][kept[i]] for i in range(2)]).contiguous()
    ranks = torch.cumsum(kept.int(), 1) - 1
    centers = torch.arange(n // 256) * 256 + 128
    st = torch.clamp(ranks[:, centers] - 512, 0, n // 4 - 1024)
    st = ((st // 128) * 128).int().contiguous()
    want = tk._window_topk_plain(sub, xs, st, 1, 1024, tk.QUERY_TILE)
    got, c = k1_twin.walk(sub.numpy(), xs.numpy(),
                          st.numpy().astype(np.int64), 1, 1024,
                          tk.QUERY_TILE, (2, 128, 256), False, policy)
    np.testing.assert_array_equal(got, want.numpy())
    assert c["flushes"] == 0 and c["keys_kept"] == c["keys_buffered"]


@pytest.mark.parametrize("call", [0, 2, 4])
def test_k1_twin_counts_at_the_main_path(call):
    """At the L0, L1 and L2 self-searches of the flagship's [2 × 40960]
    forward (sampled tiles) the redesign's walk, whose flushes run at
    most 8 rounds of the lanes' newest keys, runs fewer insertion rounds
    than the parent's, which inserted every lane's whole buffer, for the
    same lists; and a lone query needs fewer blocks than a warp visits
    (the union of its 32 queries)."""
    name, s, q, st, k, w, self_ = k1_twin.pyramid_calls(2)[call]
    assert "self" in name and k == 16
    plan = tk.window_topk_plan(2, q.shape[1], w, tk.QUERY_TILE)
    nt = q.shape[1] // tk.QUERY_TILE
    tiles = [(0, 0), (0, nt // 2), (1, nt - 1)]
    out, new = k1_twin.walk(s, q, st, k, w, tk.QUERY_TILE, plan, self_,
                            "new", tiles)
    ref, old = k1_twin.walk(s, q, st, k, w, tk.QUERY_TILE, plan, self_,
                            "parent", tiles)
    np.testing.assert_array_equal(out, ref)
    assert new["insert_rounds"] < old["insert_rounds"]
    assert new["lone_blocks"] / new["queries"] < \
        new["blocks_visited"] / new["warps"]
