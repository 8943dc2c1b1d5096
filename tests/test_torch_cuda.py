"""Each CUDA kernel of ssdr_al_torch against its plain PyTorch version.

Needs an NVIDIA card with nvcc: marked `cuda`, skipped without one. This
file imports no jax, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from ssdr_al_torch.ops import chamfer as ch
from ssdr_al_torch.ops import gather as ga
from ssdr_al_torch.ops import knn as kn

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _sorted_cloud(rng, b, n):
    xyz = torch.from_numpy((rng.rand(b, n, 3) * 6).astype(np.float32))
    lo, hi = xyz.amin(1, keepdim=True), xyz.amax(1, keepdim=True)
    _, _, xs = kn.sort_by_codes(kn.morton_codes(xyz, lo, hi), xyz)
    return xs.contiguous()


@pytest.mark.parametrize("n,window,k", [(40960, 1792, 16), (10240, 768, 16),
                                        (2560, 2560, 16), (10240, 1024, 1)])
def test_window_topk_matches_plain(dev, n, window, k):
    """K1 equals its plain version index for index (same d2, same ties)."""
    xs = _sorted_cloud(np.random.RandomState(0), 2, n)
    starts = kn.self_query_starts(n, n, window).expand(2, -1).contiguous()
    want = kn.window_topk(xs, xs, starts, k, window)
    before = kn.window_topk.launches
    got = kn.window_topk(xs.to(dev), xs.to(dev), starts.to(dev), k, window)
    torch.cuda.synchronize()
    assert kn.window_topk.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("n", [40960, 10240])
def test_window_topk_upsample_matches_plain(dev, n):
    """K1 k=1 at the 1-NN upsample of the sorted pyramid: n queries against
    their kept quarter, W=1024, starts from the kept ranks as
    models/randlanet.py computes them."""
    xs = _sorted_cloud(np.random.RandomState(6), 2, n)
    rng = np.random.RandomState(7)
    kept = torch.from_numpy(np.stack([rng.permutation(n) < n // 4
                                      for _ in range(2)]))
    ranks = torch.cumsum(kept.int(), 1) - 1
    sub = torch.stack([xs[i][kept[i]] for i in range(2)]).contiguous()
    tq, w = kn.QUERY_TILE, 1024
    centers = torch.arange(n // tq) * tq + tq // 2
    st = torch.clamp(ranks[:, centers] - w // 2, 0, n // 4 - w)
    st = ((st // 128) * 128).int().contiguous()
    want = kn.window_topk(sub, xs, st, 1, w)
    got = kn.window_topk(sub.to(dev), xs.to(dev), st.to(dev), 1, w)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def test_window_topk_ties_match_plain(dev):
    """K1 (k=16 and 1) and K5 on clouds full of exact ties (every point four
    times, a coarse grid, SENTINEL pad rows) with starts clamped at the
    cloud's end, K2 on the same starts with both sources, and K6's
    self-search and 1-NN upsample on the same clouds on each of its routes:
    equal to their plain versions (kernels/measure.py::check_ties raises if
    not)."""
    from ssdr_al_torch.kernels import measure

    done = measure.check_ties(dev)
    assert len(done) == 18


def test_window_topk_refuses_unbuilt_k(dev):
    """K1 is built for k in (1, 16); another k raises instead of falling
    back to the plain version."""
    xs = _sorted_cloud(np.random.RandomState(0), 1, 1024).to(dev)
    starts = kn.self_query_starts(1024, 1024, 512, device=dev)[None]
    with pytest.raises(ValueError, match="built for k"):
        kn.window_topk(xs, xs, starts.contiguous(), 4, 512)


@pytest.mark.parametrize("n,window,k", [(40960, 1792, 16), (10240, 4096, 16),
                                        (10240, 1024, 1)])
def test_window_topk_mxu_matches_plain(dev, n, window, k):
    """K5 (centred-product distance) equals its plain version index for
    index, counted apart from K1."""
    xs = _sorted_cloud(np.random.RandomState(4), 2, n)
    starts = kn.self_query_starts(n, n, window).expand(2, -1).contiguous()
    want = kn.window_topk(xs, xs, starts, k, window, mxu=True)
    before = (kn.window_topk.launches, kn.window_topk.launches_mxu)
    got = kn.window_topk(xs.to(dev), xs.to(dev), starts.to(dev), k, window,
                         mxu=True)
    torch.cuda.synchronize()
    assert (kn.window_topk.launches, kn.window_topk.launches_mxu) == \
        (before[0], before[1] + 1)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("b,ns,nq,k", [(2, 40960, 40960, 16),
                                       (2, 10240, 40960, 1),
                                       (1, 300, 130, 16), (1, 5, 40, 16)])
def test_knn_tiled_matches_plain(dev, b, ns, nq, k):
    """K6 equals its plain version index for index (the plain version runs
    on the card too at these sizes), ragged tiles and Ns < k included."""
    rng = np.random.RandomState(5)
    s = torch.from_numpy((rng.rand(b, ns, 3) * 6).astype(np.float32)).to(dev)
    q = torch.from_numpy((rng.rand(b, nq, 3) * 6).astype(np.float32)).to(dev)
    want = kn._knn_tiled_plain(s, q, k)
    before = kn.knn_tiled.launches
    got = kn.knn_tiled(s, q, k)
    torch.cuda.synchronize()
    assert kn.knn_tiled.launches == before + 1
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="built for k"):
        kn.knn_tiled(s, q, 4)


def _far_sorted_cloud(rng, b, n, offset):
    """A sorted cloud 6 m wide whose coordinates sit `offset` m from the
    origin, where K5's expanded d² rounds most."""
    xyz = torch.from_numpy((rng.rand(b, n, 3) * 6 + offset).astype(
        np.float32))
    lo, hi = xyz.amin(1, keepdim=True), xyz.amax(1, keepdim=True)
    return kn.sort_by_codes(kn.morton_codes(xyz, lo, hi), xyz)[2] \
        .contiguous()


@pytest.mark.parametrize("offset", [100.0, 1000.0])
@pytest.mark.parametrize("n,window,k,up", [
    (40960, 1792, 16, False),     # the L0 self-search
    (40960, 1024, 1, True),       # the L0 and L1 1-NN upsamples
    (10240, 1024, 1, True)])
def test_window_topk_mxu_far_from_centre(dev, offset, n, window, k, up):
    """K5 with its block skip on clouds 1e2-1e3 m from the origin, at the
    self-search and both upsample shapes: equal to its plain version index
    for index (the skip's bound subtracts the expanded form's rounding
    error), counted apart from K1."""
    rng = np.random.RandomState(int(offset) + n)
    xs = _far_sorted_cloud(rng, 2, n, offset)
    tq = kn.QUERY_TILE
    if up:
        sub = xs[:, ::4].contiguous()
        st = torch.clamp(torch.arange(n // tq) * (tq // 4) + tq // 8
                         - window // 2, 0, n // 4 - window)
        st = ((st // 128) * 128).int().expand(2, -1).contiguous()
    else:
        sub = xs
        st = kn.self_query_starts(n, n, window).expand(2, -1).contiguous()
    want = kn.window_topk(sub, xs, st, k, window, mxu=True)
    before = (kn.window_topk.launches, kn.window_topk.launches_mxu)
    got = kn.window_topk(sub.to(dev), xs.to(dev), st.to(dev), k, window,
                         mxu=True)
    torch.cuda.synchronize()
    assert (kn.window_topk.launches, kn.window_topk.launches_mxu) == \
        (before[0], before[1] + 1)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("up", [False, True])
@pytest.mark.parametrize("n", [40960, 10240, 2560, 640, 160])
def test_knn_tiled_exact_pyramid_calls(dev, n, up):
    """K6 at each call of an exact pyramid [2 x 40960] (models/randlanet.py::
    _pyramid_exact): the k=16 self-search of each layer, and the 1-NN
    upsample of the layer's points against its prefix quarter (a strided
    view, as the pyramid passes it); equal to the plain version on the
    card index for index, one launch each."""
    rng = np.random.RandomState(n)
    cur = torch.from_numpy((rng.rand(2, n, 3) * 6).astype(np.float32)).to(dev)
    sup, k = (cur[:, :n // 4], 1) if up else (cur, 16)
    want = kn._knn_tiled_plain(sup, cur, k)
    before = kn.knn_tiled.launches
    got = kn.knn_tiled(sup, cur, k)
    torch.cuda.synchronize()
    assert kn.knn_tiled.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("route", ["brute", "walk", "sorted"])
@pytest.mark.parametrize("ns,nq,k", [(2560, 10240, 1), (640, 640, 16),
                                     (4096, 4096, 16), (300, 130, 16),
                                     (5, 40, 16), (80, 160, 1)])
def test_knn_tiled_every_route_matches_plain(dev, route, ns, nq, k):
    """Each of K6's routes (the thread-per-query loop, the walk over the
    clouds in their own order, the walk over the sorted clouds) equals the
    plain version index for index at sizes around the route plan's
    thresholds, ragged tiles and Ns < k included, one launch each; the
    brute-force route evaluates every pair."""
    rng = np.random.RandomState(ns + nq)
    s = torch.from_numpy((rng.rand(2, ns, 3) * 6).astype(np.float32)).to(dev)
    q = s if ns == nq else torch.from_numpy(
        (rng.rand(2, nq, 3) * 6).astype(np.float32)).to(dev)
    want = kn._knn_tiled_plain(s, q, k)
    before = kn.knn_tiled.launches
    got, stats = kn.knn_tiled_stats(s, q, k, route=route)
    torch.cuda.synchronize()
    assert kn.knn_tiled.launches == before + 1
    assert torch.equal(got, want)
    assert 0 < stats["pairs"] <= 2 * ns * nq
    if route == "brute":
        assert stats["pairs"] == 2 * ns * nq


@pytest.mark.parametrize("self_search", [True, False])
def test_knn_tiled_codes_are_morton_codes(dev, self_search):
    """K6's codes kernel gives ops/knn.py::morton_codes bit for bit over
    the box that knn_sorted_inputs takes (both clouds' on an upsample)."""
    rng = np.random.RandomState(2)
    s = torch.from_numpy((rng.rand(3, 5000, 3) * 6 - 2).astype(np.float32))
    q = s if self_search else torch.from_numpy(
        (rng.rand(3, 1700, 3) * 7).astype(np.float32))
    lo, hi = s.amin(1, keepdim=True), s.amax(1, keepdim=True)
    if not self_search:
        lo = torch.minimum(lo, q.amin(1, keepdim=True))
        hi = torch.maximum(hi, q.amax(1, keepdim=True))
    sd = s.to(dev)
    got_s, got_q = kn._knn_codes(sd, sd if self_search else q.to(dev),
                                 self_search)
    torch.cuda.synchronize()
    assert torch.equal(got_s.cpu(), kn.morton_codes(s, lo, hi))
    if self_search:
        assert got_q is None
    else:
        assert torch.equal(got_q.cpu(), kn.morton_codes(q, lo, hi))


def test_knn_tiled_pairs_pruned(dev):
    """The walk's pair count: a small share of Nq·Ns on a random cloud at
    S3DIS's L0 width, and every pair on a cloud of one repeated point
    (no box excludes anything), with the same indices either way."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy((rng.rand(1, 40960, 3) * 6).astype(np.float32)
                         ).to(dev)
    got, stats = kn.knn_tiled_stats(x, x, 16)
    assert torch.equal(got, kn._knn_tiled_plain(x, x, 16))
    assert 0 < stats["pairs"] < 0.1 * 40960 ** 2
    same = torch.ones((1, 3000, 3), device=dev)
    got, stats = kn.knn_tiled_stats(same, same, 16)
    assert torch.equal(got, kn._knn_tiled_plain(same, same, 16))
    assert stats["pairs"] == 3000 ** 2


_FIRST_K6 = """
import numpy as np, torch
from ssdr_al_torch.ops import knn as kn
rng = np.random.RandomState(0)
for n, k in ((65536, 1), (40960, 16)):
    assert kn.knn_tiled_plan(n, k)[3] > kn.SMEM_DEFAULT
    x = torch.from_numpy((rng.rand(1, n, 3) * 6).astype(np.float32)).cuda()
    assert torch.equal(kn.knn_tiled(x, x, k), kn._knn_tiled_plain(x, x, k))
print("ok")
"""


def test_knn_tiled_first_launch_above_48_kib(dev):
    """K6's first launch in a fresh process (the opt-in attribute persists
    once set) with box tables above 48 KiB of shared memory: the k=1 walk
    at 65536 points (tables of 67 584 bytes, 71 680 in all), then the k=16
    walk at 40960 (its block boxes read through L1, 54 528 bytes); each
    equals the plain version."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _FIRST_K6], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("c,window,tq", [(11, 2048, 512), (32, 4096, 128),
                                         (64, 2560, 512)])
def test_gather_window_matches_plain(dev, c, window, tq):
    """K2 is bitwise equal to its plain version, out-of-window rows included."""
    rng = np.random.RandomState(1)
    b, n, k = 2, 8192, 16
    vals = torch.from_numpy(rng.randn(b, n, c).astype(np.float32))
    tiles = n // tq
    starts = torch.from_numpy(
        (rng.randint(0, (n - window) // 128 + 1, (b, tiles)) * 128)
        .astype(np.int32))
    lo = torch.repeat_interleave(starts, tq, 1)[..., None]
    idx = (lo + torch.from_numpy(rng.randint(0, window, (b, n, k)))).int()
    idx[0, 0, 0] = -5                       # outside: reads as a zero row
    want = ga.gather_window(vals, idx, starts, window, tq)
    got = ga.gather_window(vals.to(dev), idx.to(dev), starts.to(dev),
                           window, tq)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert float(want[0, 0, 0].abs().sum()) == 0.0


@pytest.mark.parametrize("tq", [512, 128])
@pytest.mark.parametrize("c", [8, 11, 32, 35, 64, 67, 128, 256])
def test_gather_window_every_channel_count(dev, c, tq):
    """K2 at every channel count the model gathers and both tile sizes
    (GATHER_TQ for the LFA gathers, 128 for gather_window_auto), with the
    wrapper's plan and with each source forced (the shared-memory slab
    where it fits in an SM): bitwise equal to the plain version."""
    rng = np.random.RandomState(c + tq)
    b, n, k, window = 2, 4096, 16, 1024
    vals = torch.from_numpy(rng.randn(b, n, c).astype(np.float32))
    starts = torch.from_numpy(
        (rng.randint(0, (n - window) // 128 + 2, (b, n // tq)) * 128)
        .astype(np.int32))
    lo = torch.repeat_interleave(torch.clamp(starts, 0, n - window), tq,
                                 1)[..., None]
    idx = (lo + torch.from_numpy(rng.randint(-9, window + 9, (b, n, k))))
    idx = torch.clamp(idx, 0, n - 1).int()
    want = ga.gather_window(vals, idx, starts, window, tq)
    v, i, st = vals.to(dev), idx.to(dev), starts.to(dev)
    got = [ga.gather_window(v, i, st, window, tq)]
    for slab in (True, False):
        if slab and window * c * 4 > 227 * 1024:
            continue
        plan = ga.gather_plan(b, n, k, c, window, tq, slab=slab)
        got.append(ga._gather_window_launch(v, i, st, window, tq, plan))
    torch.cuda.synchronize()
    for g in got:
        assert torch.equal(g.cpu(), want)


def test_chamfer_sums_matches_plain(dev):
    """K3 agrees with its plain version within 1e-5 relative, and two
    launches agree bit for bit."""
    rng = np.random.RandomState(2)
    c, s, p = 3, 32, 512
    pts = torch.from_numpy(rng.randn(c, s, p, 3).astype(np.float32))
    msk = torch.from_numpy(rng.rand(c, s, p) < 0.7)
    msk[0, 3] = False                       # one empty superpoint
    want = ch.chamfer_sums(pts, msk)
    got = ch.chamfer_sums(pts.to(dev), msk.to(dev))
    again = ch.chamfer_sums(pts.to(dev), msk.to(dev))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, again)
    cd = ch.chamfer_pairwise_blocks(pts.to(dev), msk.to(dev)).cpu()
    assert (cd[0, 3, torch.arange(s) != 3] >= 1e12).all()


@pytest.mark.parametrize("s,p,valid", [
    (1, 64, 1.0),          # one superpoint: only the diagonal
    (7, 100, 1.0),         # odd S, all valid, P not a multiple of 32
    (16, 75, 0.6),         # P not a multiple of the register block
    (9, 512, 0.12),        # the selection call's sparse slab rows
    (4, 700, 1.0),         # both sides over 512 points: each direction
    (5, 600, 0.45),        # one side over 512 points
])
def test_chamfer_sums_shapes(dev, s, p, valid):
    """K3 against its plain version within 1e-5 relative at several
    (S, P, validity), with one superpoint at 0 % valid and one with a
    single point; bit for bit the same on a second launch."""
    rng = np.random.RandomState(s * 1000 + p)
    c = 2
    pts = torch.from_numpy((rng.randn(c, s, p, 3) * 0.4).astype(np.float32))
    msk = torch.from_numpy(rng.rand(c, s, p) < valid)
    if s > 2:
        msk[0, 1] = False
        msk[1, 2] = False
        msk[1, 2, p // 2] = True
    want = ch.chamfer_sums(pts, msk)
    got = ch.chamfer_sums(pts.to(dev), msk.to(dev))
    again = ch.chamfer_sums(pts.to(dev), msk.to(dev))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, again)


def _scatter_inputs(rng, b, n, nq, k, c, window, tq):
    """Window starts spread over the cloud, the first past its start and
    the last past its end (clamped to [0, n - window]), and indices
    around each window, some outside it."""
    starts = torch.from_numpy(
        (rng.randint(-2, (n - window) // 128 + 3, (b, nq // tq)) * 128)
        .astype(np.int32))
    starts[:, 0], starts[:, -1] = -300, n + 5
    lo = torch.repeat_interleave(torch.clamp(starts, 0, n - window), tq,
                                 1)[..., None]
    idx = lo + torch.from_numpy(rng.randint(-9, window + 9, (b, nq, k)))
    idx = torch.clamp(idx, 0, n - 1).int()
    g = torch.from_numpy(rng.randn(b, nq, k, c).astype(np.float32))
    return g, idx, starts


@pytest.mark.parametrize("b,n,nq,c,window,tq", [
    (2, 40960, 40960, 11, 2048, 512),    # L0 LFA gather's backward
    (2, 2560, 640, 256, 2560, 128),      # L2 pool gather's, 256 channels
    (2, 2048, 8192, 8, 2048, 128),       # all 64 tiles' windows on a row
])
def test_scatter_window_matches_plain(dev, b, n, nq, c, window, tq):
    """K4 adds each dv value in (q, j) order, as the plain version's
    index_add_ does on the CPU: bitwise equal to it, and to itself on a
    second launch. Out-of-window indices contribute nothing. The backward
    of gather_window on the card launches K4 and gives the same
    gradient."""
    rng = np.random.RandomState(3)
    k = 16
    starts = torch.from_numpy(
        (rng.randint(0, (n - window) // 128 + 1, (b, nq // tq)) * 128)
        .astype(np.int32))
    lo = torch.repeat_interleave(starts, tq, 1)[..., None]
    idx = (lo + torch.from_numpy(rng.randint(0, window, (b, nq, k)))).int()
    idx[0, 0, 0] = -5                       # outside: contributes nothing
    idx[-1, -1, -1] = n + 3
    g = torch.from_numpy(rng.randn(b, nq, k, c).astype(np.float32))
    want = ga.scatter_window(g, idx, starts, n, window, tq)
    before = ga.scatter_window.launches
    args = (idx.to(dev), starts.to(dev), n, window, tq)
    got = ga.scatter_window(g.to(dev), *args)
    again = ga.scatter_window(g.to(dev), *args)
    torch.cuda.synchronize()
    assert ga.scatter_window.launches == before + 2
    assert torch.equal(got.cpu(), want) and torch.equal(got, again)

    vals = torch.from_numpy(rng.randn(b, n, c).astype(np.float32))
    v_dev = vals.to(dev).requires_grad_(True)
    ga.gather_window(v_dev, idx.to(dev), starts.to(dev), window,
                     tq).backward(g.to(dev))
    assert ga.scatter_window.launches == before + 3
    assert torch.equal(v_dev.grad.cpu(), want)


_FIRST_K4 = """
import numpy as np, torch
from ssdr_al_torch.ops import gather as ga
rng = np.random.RandomState(0)
b, n, nq, k, c, window, tq = 1, 4096, 1024, 16, 256, 4096, 128
idx = torch.from_numpy(rng.randint(0, n, (b, nq, k)).astype(np.int32))
starts = torch.zeros((b, nq // tq), dtype=torch.int32)
g = torch.from_numpy(rng.randn(b, nq, k, c).astype(np.float32))
got = ga.scatter_window(g.cuda(), idx.cuda(), starts.cuda(), n, window, tq)
assert torch.equal(got.cpu(), ga.scatter_window(g, idx, starts, n, window,
                                                tq))
print("ok")
"""


def test_scatter_window_first_launch_at_48_kib(dev):
    """Semantic3D's first K4 call of a backward, [1, 1024, 16, 256] into
    4096 rows with a 4096-row window (tq=128), asks the fill kernel for
    exactly 48 KiB of dynamic shared memory, which with its static scan
    buffer needs the opt-in attribute. As the first K4 launch of a fresh
    process (the attribute persists once set) it launches and equals the
    plain version."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _FIRST_K4], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("tq", [512, 128])
@pytest.mark.parametrize("c", [8, 11, 32, 35, 64, 67, 128, 256])
def test_scatter_window_every_channel_count(dev, c, tq):
    """K4 at every channel count the model scatters and both tile sizes
    (the LFA gathers' and gather_window_auto's), starts past both ends
    and indices outside their windows: bitwise equal to the CPU plain
    version and to a second launch."""
    rng = np.random.RandomState(c + tq)
    b, n, k, window = 2, 4096, 16, 1024
    g, idx, starts = _scatter_inputs(rng, b, n, n, k, c, window, tq)
    want = ga.scatter_window(g, idx, starts, n, window, tq)
    args = (g.to(dev), idx.to(dev), starts.to(dev), n, window, tq)
    got, again = ga.scatter_window(*args), ga.scatter_window(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want) and torch.equal(got, again)


def test_scatter_window_auto_gradient(dev):
    """The pool gathers' path: gather_window_auto's clamped indices (index
    spread wider than the window) scatter back through K4, bitwise equal
    to the CPU's gradient."""
    rng = np.random.RandomState(9)
    b, n, nq, k, c, window = 2, 10240, 2560, 16, 128, 3072
    centre = np.repeat(np.linspace(0, n - 1, nq // 128), 128)[None, :, None]
    idx = torch.from_numpy(np.clip(
        centre + rng.randint(-2500, 2500, (b, nq, k)), 0, n - 1
    ).astype(np.int32))
    vals = torch.from_numpy(rng.randn(b, n, c).astype(np.float32))
    g = torch.from_numpy(rng.randn(b, nq, k, c).astype(np.float32))
    grads = []
    for d in ("cpu", dev):
        v = vals.to(d, copy=True).requires_grad_(True)
        ga.gather_window_auto(v, idx.to(d), window).backward(g.to(d))
        grads.append(v.grad.cpu())
    torch.cuda.synchronize()
    assert ga.window_violations(idx, window) > 0
    assert torch.equal(grads[0], grads[1])


# ---------------------------------------------------- bfloat16 (K2, K4) ---

@pytest.mark.parametrize("tq", [512, 128])
@pytest.mark.parametrize("c", [8, 11, 32, 35, 64, 67, 128, 256])
def test_gather_window_bf16_every_channel_count(dev, c, tq):
    """K2 with bf16 output at every channel count the model gathers, both
    tile sizes, the wrapper's plan and each source forced: bitwise equal
    to the plain version, the f32 gather rounded to bf16."""
    rng = np.random.RandomState(c + tq + 1)
    b, n, k, window = 2, 4096, 16, 1024
    vals = torch.from_numpy(rng.randn(b, n, c).astype(np.float32))
    starts = torch.from_numpy(
        (rng.randint(0, (n - window) // 128 + 2, (b, n // tq)) * 128)
        .astype(np.int32))
    lo = torch.repeat_interleave(torch.clamp(starts, 0, n - window), tq,
                                 1)[..., None]
    idx = (lo + torch.from_numpy(rng.randint(-9, window + 9, (b, n, k))))
    idx = torch.clamp(idx, 0, n - 1).int()
    want = ga.gather_window(vals, idx, starts, window, tq, torch.bfloat16)
    assert want.dtype == torch.bfloat16
    assert torch.equal(want, ga._gather_window_plain(
        vals, idx, starts, window, tq).to(torch.bfloat16))
    v, i, st = vals.to(dev), idx.to(dev), starts.to(dev)
    got = [ga.gather_window(v, i, st, window, tq, torch.bfloat16)]
    for slab in (True, False):
        if slab and window * c * 4 > 227 * 1024:
            continue
        plan = ga.gather_plan(b, n, k, c, window, tq, slab=slab,
                              out_dtype=torch.bfloat16)
        got.append(ga._gather_window_launch(v, i, st, window, tq, plan,
                                            torch.bfloat16))
    torch.cuda.synchronize()
    for g in got:
        assert g.dtype == torch.bfloat16
        assert torch.equal(g.cpu().view(torch.int16),
                           want.view(torch.int16))


@pytest.mark.parametrize("rows_c", ["8-byte units", "16-byte units"])
def test_gather_window_bf16_units_and_ties(dev, rows_c):
    """K2-bf16 where rows·c is not a multiple of 8 (tq = 4, k = 1, c odd:
    8-byte stores) and where it is, on values at the rounding ties of
    bf16 (halfway between two bf16 values, both parities, signed zeros,
    the largest finite floats): bitwise equal to the plain version."""
    b, n, window = 1, 256, 128
    tq, k, c = (4, 1, 5) if rows_c == "8-byte units" else (128, 16, 11)
    plan = ga.gather_plan(b, n, k, c, window, tq, slab=False,
                          out_dtype=torch.bfloat16)
    assert plan[3] == (4 if rows_c == "8-byte units" else 8)
    base = (torch.arange(b * n * c, dtype=torch.int32) + 0x3F00) << 16
    ties = base | 0x8000                       # exactly halfway
    ties[::7] = 0x7F7FFFFF                     # rounds to inf
    ties[1::7] = -0x80000000                   # -0.0
    ties[2::7] = base[2::7] | 0x7FFF           # just below halfway
    vals = ties.view(torch.float32).reshape(b, n, c)
    rng = np.random.RandomState(3)
    starts = torch.zeros((b, n // tq), dtype=torch.int32)
    starts[:, n // tq // 2:] = n - window
    lo = torch.repeat_interleave(starts, tq, 1)[..., None]
    idx = (lo + torch.from_numpy(rng.randint(0, window, (b, n, k)))).int()
    want = ga._gather_window_plain(vals, idx, starts, window,
                                   tq).to(torch.bfloat16)
    for slab in (True, False):
        p = ga.gather_plan(b, n, k, c, window, tq, slab=slab,
                           out_dtype=torch.bfloat16)
        got = ga._gather_window_launch(vals.to(dev), idx.to(dev),
                                       starts.to(dev), window, tq, p,
                                       torch.bfloat16)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu().view(torch.int16),
                           want.view(torch.int16)), p


@pytest.mark.parametrize("tq", [512, 128])
@pytest.mark.parametrize("c", [8, 11, 32, 35, 64, 67, 128, 256])
def test_scatter_window_bf16_every_channel_count(dev, c, tq):
    """K4 with a bf16 cotangent at every channel count the model scatters:
    bitwise equal to index_add_ of g.float() on the CPU (the plain
    version) and to a second launch; f32 dv."""
    rng = np.random.RandomState(c + tq + 2)
    b, n, k, window = 2, 4096, 16, 1024
    g, idx, starts = _scatter_inputs(rng, b, n, n, k, c, window, tq)
    g = g.to(torch.bfloat16)
    want = ga.scatter_window(g, idx, starts, n, window, tq)
    assert want.dtype == torch.float32
    assert torch.equal(want, ga.scatter_window(g.float(), idx, starts, n,
                                               window, tq))
    args = (g.to(dev), idx.to(dev), starts.to(dev), n, window, tq)
    got, again = ga.scatter_window(*args), ga.scatter_window(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert torch.equal(got.cpu(), want) and torch.equal(got, again)


_FIRST_K4_BF16 = _FIRST_K4.replace(
    "g = torch.from_numpy(rng.randn(b, nq, k, c).astype(np.float32))",
    "g = torch.from_numpy(rng.randn(b, nq, k, c).astype(np.float32))"
    ".to(torch.bfloat16)")


def test_scatter_window_bf16_first_launch_at_48_kib(dev):
    """test_scatter_window_first_launch_at_48_kib with a bf16 cotangent:
    the fill kernel's 48 KiB opt-in as the first K4 launch of a fresh
    process, and the bf16 sum kernel after it."""
    import os
    import subprocess
    import sys

    assert "bfloat16" in _FIRST_K4_BF16
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _FIRST_K4_BF16], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_gather_window_bf16_backward(dev):
    """gather_window with bf16 output on the card: the forward launches K2
    (bf16), the backward K4 (bf16 cotangent), the gradient f32 and bitwise
    equal to the CPU's."""
    rng = np.random.RandomState(11)
    b, n, k, c, window, tq = 2, 8192, 16, 11, 2048, 512
    g, idx, starts = _scatter_inputs(rng, b, n, n, k, c, window, tq)
    vals = torch.from_numpy(rng.randn(b, n, c).astype(np.float32))
    cot = g.to(torch.bfloat16)
    grads = []
    counts = (ga.gather_window.launches_bf16, ga.scatter_window.launches_bf16,
              ga.gather_window.launches, ga.scatter_window.launches)
    for d in ("cpu", dev):
        v = vals.to(d, copy=True).requires_grad_(True)
        out = ga.gather_window(v, idx.to(d), starts.to(d), window, tq,
                               torch.bfloat16)
        assert out.dtype == torch.bfloat16
        out.backward(cot.to(d))
        grads.append(v.grad.cpu())
    torch.cuda.synchronize()
    assert (ga.gather_window.launches_bf16, ga.scatter_window.launches_bf16,
            ga.gather_window.launches, ga.scatter_window.launches) == (
        counts[0] + 1, counts[1] + 1, counts[2], counts[3])
    assert grads[1].dtype == torch.float32
    assert torch.equal(grads[0], grads[1])


# --------------------------------------- the comparison branches' loops ---

def test_kcenter_greedy_on_card_equals_cpu(dev):
    """k-center greedy on the card (full-f32 products) picks what it picks
    on the CPU, labeled points never among them."""
    from ssdr_al_torch.ops.kcenter import kcenter_greedy

    rng = np.random.RandomState(4)
    feats = torch.from_numpy(rng.randn(3000, 129).astype(np.float32))
    labeled = torch.from_numpy(rng.rand(3000) < 0.3)
    want = kcenter_greedy(feats, labeled, 200, chunk=512)
    got = kcenter_greedy(feats.to(dev), labeled.to(dev), 200, chunk=512)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert not labeled[want].any()


def test_farthest_superpoint_sample_on_card_equals_cpu(dev):
    """Farthest-superpoint sampling over ED² + a chamfer matrix from K3 on
    the card against the same loop on the CPU on the plain version's
    matrix: the same picks."""
    from ssdr_al_torch.ops.fps import farthest_superpoint_sample

    rng = np.random.RandomState(5)
    s, p = 300, 128
    pts = torch.from_numpy((rng.randn(s, p, 3) * 0.3).astype(np.float32))
    msk = torch.from_numpy(rng.rand(s, p) < 0.7)
    msk[:, 0] = True
    cents = torch.from_numpy((rng.rand(s, 3) * 5).astype(np.float32))
    before = ch.chamfer_sums.launches
    cd_dev = ch.chamfer_pairwise(pts.to(dev), msk.to(dev))
    assert ch.chamfer_sums.launches == before + 1
    want = farthest_superpoint_sample(cents, ch.chamfer_pairwise(pts, msk),
                                      3, 60)
    got = farthest_superpoint_sample(cents.to(dev), cd_dev, 3, 60)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
