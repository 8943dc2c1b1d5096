"""What the redesigned K1 and K2 kernels rely on, checked on the CPU.

- K1 (csrc/window_topk.cu) walks a window in any order and keeps the k
  least keys (d², window rank): that equals the plain version's stable sort
  only if the plain order is lexicographic in (d², rank), ties included.
- K1 skips a block of candidates when the least d² to its bounding box,
  rounded as d² is, exceeds a lane's k-th best, and filters groups on d² in
  FMA form against `filter_bound`: both must stay on the safe side of the
  exact d² (numpy float32 twins of the kernel's arithmetic).
- The launch plans the wrappers compute in Python (`window_topk_plan`,
  `gather_plan`) are pure functions of the shapes.
- K2 (csrc/gather_window.cu) writes each CTA's rows as float4s, finding a
  float4's row by a multiply-high with ceil(2^32 / c) and stepping the
  channel: a numpy twin of that arithmetic equals the plain gather.
- K6 (csrc/knn_tiled.cu) runs the width K = knn_kernel_k(k) of 1, 16 and
  64 for a call with k; the K = 64 walk (the partition's k = 46) runs one
  CTA an SM, and its shared-memory plan and route follow from that.
"""

import numpy as np
import pytest
import torch

from ssdr_al_torch.ops import gather as tg
from ssdr_al_torch.ops import knn as tk

torch.set_num_threads(1)

F32 = np.float32

# the main path's calls at B=8 (models/randlanet.py): (nq, window, tq)
K1_MAIN = [(40960, 1792), (10240, 768), (2560, 2560), (40960, 1024),
           (10240, 1024)]
# (nq, k, c, window, tq) of every K2 call of one forward
K2_MAIN = [(40960, 16, 11, 2048, 512), (40960, 16, 8, 2048, 512),
           (10240, 16, 35, 1024, 512), (10240, 16, 32, 1024, 512),
           (2560, 16, 67, 2560, 512), (2560, 16, 64, 2560, 512),
           (10240, 16, 32, 4096, 128), (2560, 16, 128, 3072, 128),
           (640, 16, 256, 2560, 128)]


def _tie_cloud(kind, n, seed=0):
    """Sorted clouds full of exact ties: every point four times, or points
    on a coarse grid."""
    rng = np.random.RandomState(seed)
    if kind == "duplicates":
        xyz = np.repeat(rng.rand(1, n // 4, 3).astype(F32) * 2, 4, axis=1)
    else:
        xyz = (rng.randint(0, 6, (1, n, 3)) * 0.25).astype(F32)
    x = torch.from_numpy(xyz)
    lo, hi = x.amin(1, keepdim=True), x.amax(1, keepdim=True)
    return tk.sort_by_codes(tk.morton_codes(x, lo, hi), x)[2].contiguous()


def _d2_numpy(q, s, mxu):
    """The kernels' d² in numpy float32, one rounding per operation:
    K1 (dx·dx + dy·dy) + dz·dz, K5 max(m + (|s'|² + |q'|²), 0)."""
    if not mxu:
        d = q[:, None, :] - s[None, :, :]
        return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
            + d[..., 2] * d[..., 2]
    c = s[:1]
    sc, qc = s - c, q - c
    s2 = (sc[:, 0] * sc[:, 0] + sc[:, 1] * sc[:, 1]) + sc[:, 2] * sc[:, 2]
    q2 = (qc[:, 0] * qc[:, 0] + qc[:, 1] * qc[:, 1]) + qc[:, 2] * qc[:, 2]
    m = qc * F32(-2.0)
    cross = (m[:, None, 0] * sc[None, :, 0] + m[:, None, 1] * sc[None, :, 1]) \
        + m[:, None, 2] * sc[None, :, 2]
    return np.maximum(cross + (s2[None, :] + q2[:, None]), F32(0.0))


@pytest.mark.parametrize("kind", ["duplicates", "grid"])
@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("k", [16, 1])
def test_window_topk_plain_is_lexicographic_on_ties(kind, mxu, k):
    """The plain K1/K5 order is the (d², window rank) order, and the k least
    keys taken in a shuffled order (as the kernel's walk takes them) are the
    same: exact ties go to the lower rank whatever the arrival order."""
    n, w, tq = 1024, 512, 256
    xs = _tie_cloud(kind, n)
    st = tk.self_query_starts(n, n, w)[None]
    got = tk._window_topk_plain(xs, xs, st, k, w, tq, mxu)[0].numpy()
    x = xs[0].numpy()
    rng = np.random.RandomState(1)
    ties = 0
    for t, s0 in enumerate(st[0].tolist()):
        s0 = min(max(s0, 0), n - w)
        q = x[t * tq:(t + 1) * tq]
        d2 = _d2_numpy(q, x[s0:s0 + w], mxu)
        ranks = np.broadcast_to(np.arange(w), d2.shape)
        want = np.lexsort((ranks, d2), axis=-1)[:, :k]
        np.testing.assert_array_equal(got[t * tq:(t + 1) * tq], want)
        keys = ((d2.view(np.uint32) & 0x7FFFFFFF).astype(np.uint64)
                << np.uint64(32)) \
            | ranks.astype(np.uint64)
        perm = rng.permutation(w)
        walked = np.sort(keys[:, perm], axis=-1)[:, :k]
        np.testing.assert_array_equal(
            (walked & np.uint64(0xFFFFFFFF)).astype(np.int64), want)
        ties += int((np.diff(np.sort(d2, -1)[:, :k + 1], axis=-1) == 0).sum())
    assert ties > 100                        # the inputs really tie


def _fma(a, b, c):
    """float32 fma through float64: a·b is exact there, one more rounding
    of the sum can only move the result by an ulp, far inside the bound."""
    return (a.astype(np.float64) * b + c).astype(F32)


def test_k1_filter_and_box_bounds_are_safe():
    """The group filter: d² in FMA form never exceeds filter_bound of the
    exact d², subnormal and huge coordinates included. The block skip: the
    least d² to a block's box, rounded as d² is, never exceeds the d² of a
    point in the box."""
    rng = np.random.RandomState(2)
    scale = np.exp(rng.uniform(-60, 40, (4096, 1))).astype(F32)
    q = (rng.randn(4096, 3) * scale).astype(F32)
    s = (q + rng.randn(4096, 3).astype(F32) * scale
         * F32(10.0) ** rng.uniform(-7, 0, (4096, 1)).astype(F32))
    d = q - s
    exact = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    fma = _fma(d[:, 0], d[:, 0], _fma(d[:, 1], d[:, 1], d[:, 2] * d[:, 2]))
    bound = _fma(exact, np.full_like(exact, 1 + 2.0 ** -20),
                 np.full_like(exact, 2.0 ** -126))
    ok = np.isfinite(exact)
    assert ok.mean() > 0.9
    assert (fma[ok] <= bound[ok]).all()

    pts = rng.randn(64, 32, 3).astype(F32) * F32(3.0)
    lo, hi = pts.min(1), pts.max(1)                  # [64 blocks, 3]
    qs = (rng.randn(200, 3) * 5).astype(F32)
    e = np.maximum(np.maximum(lo[None] - qs[:, None], qs[:, None] - hi[None]),
                   F32(0.0))                         # [200, 64, 3]
    lb = (e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]) \
        + e[..., 2] * e[..., 2]
    dq = qs[:, None, None, :] - pts[None]            # [200, 64, 32, 3]
    d2 = (dq[..., 0] * dq[..., 0] + dq[..., 1] * dq[..., 1]) \
        + dq[..., 2] * dq[..., 2]
    assert (lb[..., None] <= d2).all()
    assert (lb > 0).mean() > 0.5                     # the bound does prune


@pytest.mark.parametrize("b", [2, 4, 6, 8])
@pytest.mark.parametrize("nq,window", K1_MAIN)
def test_window_topk_plan_at_main_path_shapes(nq, window, b):
    """split threads per query, qpc queries per CTA, whole warps of at most
    TOPK_THREADS; the main path's grids get TOPK_MIN_WARPS warps and
    TOPK_MIN_CTAS CTAs, or as close as the limits allow, at the eval
    step's batch, the train steps' and the flagship's; the shared memory
    of K1 and K5 at both widths within one CTA's 227 KB."""
    tq = tk.QUERY_TILE
    split, qpc, threads = tk.window_topk_plan(b, nq, window, tq)
    for k in tk.KERNEL_K:
        for mxu in (False, True):
            assert 0 < tk.window_topk_smem(window, k, split, threads,
                                           mxu) <= tk.SMEM_LIMIT
    assert split in (1, 2, 4, 8) and 1 <= qpc <= tq
    assert threads % 32 == 0 and qpc * split <= threads <= tk.TOPK_THREADS
    parts = -(-tq // qpc)
    assert parts * qpc >= tq and (parts - 1) * qpc < tq
    if split > 1:
        assert window // split >= tk.TOPK_MIN_WALK
    assert b * nq * split >= 32 * tk.TOPK_MIN_WARPS or split == 8 \
        or window < 2 * split * tk.TOPK_MIN_WALK
    ctas = b * (nq // tq) * parts
    assert ctas >= tk.TOPK_MIN_CTAS or threads == 64
    assert tk.window_topk_plan(b, nq, window, tq) == (split, qpc, threads)


def test_window_topk_plan_values():
    """The plans of the main path, as measured in PERF.md: L0 one thread a
    query in 256-thread CTAs, L1 in 128-thread CTAs, L2 four threads a
    query."""
    plan = tk.window_topk_plan
    assert plan(8, 40960, 1792, 256) == (1, 256, 256)
    assert plan(8, 10240, 768, 256) == (1, 128, 128)
    assert plan(8, 2560, 2560, 256) == (4, 32, 128)
    assert plan(8, 40960, 1024, 256) == (1, 256, 256)
    assert plan(8, 10240, 1024, 256) == (1, 128, 128)
    assert plan(1, 100, 50, 100) == (1, 50, 64)      # a ragged tiny tile


@pytest.mark.parametrize("nq,k,c,window,tq", K2_MAIN)
def test_gather_plan_at_main_path_shapes(nq, k, c, window, tq):
    """Whole float4s per CTA, rows dividing the tile, the multiply-high
    row lookup in range; the slab only where it is small and the tiles
    fill the card."""
    b = 8
    slab, rows, threads, unit = tg.gather_plan(b, nq, k, c, window, tq)
    assert unit == 4
    assert (tq * k) % rows == 0 and (rows * c) % 4 == 0
    assert rows * c < 1 << 24 and threads % 32 == 0 and threads <= 1024
    if slab:
        assert window * c * 4 <= tg.SLAB_MAX_BYTES and rows == tq * k
        assert b * (nq // tq) >= 2 * tg._kb.SMS
    else:
        assert rows * c <= tg.GATHER_SPAN or rows % 8
    forced = tg.gather_plan(b, nq, k, c, window, tq, slab=not slab)
    assert forced[0] == (not slab)


def test_gather_plan_values_and_refusal():
    """The slab serves the L0 LFA gather of 8 channels only; tq must be a
    multiple of 4 for whole float4s."""
    plan = tg.gather_plan
    assert plan(8, 40960, 16, 8, 2048, 512) == (True, 8192, 1024, 4)
    assert plan(8, 40960, 16, 11, 2048, 512) == (False, 2048, 256, 4)
    assert plan(8, 10240, 16, 35, 1024, 512) == (False, 512, 256, 4)
    assert plan(8, 640, 16, 256, 2560, 128) == (False, 128, 256, 4)
    assert plan(2, 8192, 16, 8, 2048, 512)[0] is False    # too few tiles
    with pytest.raises(ValueError, match="tq % 4"):
        plan(1, 6, 2, 3, 4, 6)


def _k2_twin(values, idx, starts, window, tq, plan):
    """numpy twin of K2's index arithmetic: CTA (b, tile, part) writes rows
    [part·rows, (part+1)·rows) of its tile as float4s; a float4 at float
    p of the span starts in row umulhi(p, ceil(2^32 / c)) and steps the
    channel, moving to the next row when it reaches c."""
    _, rows, _, _ = plan
    b, n, c = values.shape
    nq, k = idx.shape[1:]
    magic = np.uint64(0xFFFFFFFF // c + 1)
    out = np.full(b * nq * k * c, np.nan, F32)
    flat_idx = idx.reshape(-1)
    for bb in range(b):
        for t in range(nq // tq):
            lo = min(max(int(starts[bb, t]), 0), n - window)
            win = values[bb, lo:lo + window].reshape(-1)
            for part in range(tq * k // rows):
                row0 = (bb * nq + t * tq) * k + part * rows
                p = np.arange(0, rows * c, 4, dtype=np.uint64)
                r = ((p * magic) >> np.uint64(32)).astype(np.int64) \
                    if c > 1 else p.astype(np.int64)
                ch = p.astype(np.int64) - r * c
                for j in range(4):
                    rr = r + (ch + j >= c)             # c >= 4: one step
                    cc = (ch + j) % c
                    i = flat_idx[row0 + rr] - lo
                    inside = (i >= 0) & (i < window)
                    v = np.where(inside, win[np.clip(i, 0, window - 1) * c
                                             + cc], F32(0.0))
                    out[row0 * c + p.astype(np.int64) + j] = v
    return out.reshape(b, nq, k, c)


@pytest.mark.parametrize("c", [8, 11, 35, 67])
def test_k2_span_arithmetic_equals_plain(c):
    """Both plans' spans (one CTA a tile, or a tile split in parts) cover
    the output exactly and read the plain gather's values, zero rows
    outside the window and clamped starts included."""
    rng = np.random.RandomState(c)
    b, n, k, tq, window = 2, 1024, 4, 128, 256
    vals = rng.randn(b, n, c).astype(F32)
    starts = rng.randint(-64, n, (b, n // tq)).astype(np.int32)
    lo = np.clip(starts, 0, n - window)
    idx = (np.repeat(lo, tq, 1)[..., None]
           + rng.randint(-8, window + 8, (b, n, k))).astype(np.int32)
    idx = np.clip(idx, 0, n - 1)
    want = tg._gather_window_plain(torch.from_numpy(vals),
                                   torch.from_numpy(idx),
                                   torch.from_numpy(starts), window,
                                   tq).numpy()
    for slab in (True, False):
        plan = tg.gather_plan(b, n, k, c, window, tq, slab=slab)
        np.testing.assert_array_equal(
            _k2_twin(vals, idx, starts, window, tq, plan), want)
    small = (False, 4, 256, 4)               # many parts per tile
    np.testing.assert_array_equal(
        _k2_twin(vals, idx, starts, window, tq, small), want)


# ---------------------------------------------------------- K6 widths ---


def test_k6_width_of_every_k():
    """k = 1 runs K = 1, 2..16 run K = 16, 17..64 run K = 64 (the
    partition's k_geof + 1 = 46 among them); 0 and 65 raise on any
    device."""
    assert [tk.knn_kernel_k(k) for k in (1, 2, 15, 16, 17, 46, 63, 64)] == \
        [1, 16, 16, 16, 64, 64, 64, 64]
    for k in (0, 65, 100):
        with pytest.raises(ValueError, match="built for"):
            tk.knn_kernel_k(k)
    assert tk.knn_tiled_counter(46) == "launches_k64"
    assert tk.knn_tiled_counter(16) == tk.knn_tiled_counter(1) == "launches"


@pytest.mark.parametrize("ns", [
    60000,     # a prepared S3DIS room (0.04 grid, ~6 x 6 x 3 m)
    96728,     # the smoke's prepared partition room
    139686,    # a flagship room (scripts/flagship.py)
    150000,    # a room at its raw 150 000 points
    200000,    # past the rooms: no size needs the opt-in
    700, 46])
def test_k6_k64_plan(ns):
    """The K = 64 walk (k = 46): a warp a query, KNN_WALK64_QUERIES = 4
    queries a CTA of KNN_WALK64_THREADS = 128 threads, at every support
    size no
    dynamic shared memory (the boxes are read through L1, the list slots
    are static) and so never the opt-in, where K = 16 keeps its box
    tables in shared memory below ~20 000 points; every width above 16
    has the same plan."""
    nblk, nsup, in_smem, smem = tk.knn_tiled_plan(ns, 46)
    assert nblk == -(-ns // 32) and nsup == -(-nblk // 32)
    assert tk.KNN_WALK64_QUERIES == tk.KNN_WALK64_THREADS // 32 == 4
    assert 64 not in tk.KNN_CTAS and tk.KNN_CTAS[16] == 3
    assert not in_smem and smem == 0 <= tk.SMEM_DEFAULT
    for k in (17, 33, 64):
        assert tk.knn_tiled_plan(ns, k) == (nblk, nsup, False, 0)
    if ns <= 700:
        assert tk.knn_tiled_plan(ns, 16)[2]


def test_k6_k64_walk_counters():
    """knn_tiled_stats names the K = 64 walk's counters (summed over its
    queries) apart from the lane-per-query walk's (summed over warps and
    lanes)."""
    assert tk.KNN_WALK_STATS[64] == ("blocks_kept", "box_tests",
                                     "keys_merged", "merges")
    assert tk.KNN_WALK_STATS[1] == tk.KNN_WALK_STATS[16] == (
        "blocks_kept", "block_tests", "keys_buffered", "insert_rounds")


@pytest.mark.parametrize("ns,route", [
    (46, "walk"), (700, "walk"), (3000, "walk"), (6000, "walk"),
    (8192, "walk"), (8193, "sorted"), (10000, "sorted"), (20000, "sorted"),
    (96728, "sorted"), (139686, "sorted")])
def test_k6_k64_route(ns, route):
    """K = 64 has routes of its own (kernels/measure.py --k6-only at the
    partition's call over subsets of a prepared room, H100): never the
    thread-per-query loop (0.045 ms at 46 points against the walk's
    0.007), the walk in the cloud's own order up to KNN_SORT_MIN[64] =
    8192 points (faster up to 6000), the sorted walk beyond (faster from
    10 000); K = 1 and 16 keep theirs."""
    assert tk.knn_tiled_route(ns, 46) == route
    assert tk.knn_tiled_route(ns, 64) == route
    assert tk.KNN_SORT_MIN[1] == tk.KNN_SORT_MIN[16] == 896
