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


@pytest.fixture(scope="module")
def flagship_k1_calls(dev):
    """The 5 K1 calls of one [2 × 40960] forward (the flagship's batch),
    built as models/randlanet.py builds them (kernels/k1_twin.py)."""
    from ssdr_al_torch.kernels import k1_twin

    out = []
    for name, s, q, st, k, w, self_ in k1_twin.pyramid_calls(2):
        x = torch.from_numpy(s).to(dev)
        out.append((name, x, x if self_ else torch.from_numpy(q).to(dev),
                    torch.from_numpy(st).int().to(dev), k, w))
    return out


@pytest.mark.parametrize("i", range(5))
@pytest.mark.parametrize("mxu", [False, True])
def test_window_topk_flagship_calls_match_plain(dev, flagship_k1_calls, i,
                                                mxu):
    """K1 (and K5) at each of the 5 calls of a [2 × 40960] forward: equal
    to the plain version index for index, one launch counted."""
    name, s, q, st, k, w = flagship_k1_calls[i]
    want = kn._window_topk_plain(s, q, st, k, w, kn.QUERY_TILE, mxu)
    attr = "launches_mxu" if mxu else "launches"
    before = getattr(kn.window_topk, attr)
    got = kn.window_topk(s, q, st, k, w, mxu=mxu)
    torch.cuda.synchronize()
    assert getattr(kn.window_topk, attr) == before + 1, name
    assert torch.equal(got, want), name


def test_window_topk_counter_build_equals_twin(dev, flagship_k1_calls):
    """K1's counter build at the [2 × 2560] L2 self-search (20 tiles, the
    twin walks them all) and the L1 upsample: its result equals the plain
    version, no launch is counted, and at L2 its counters equal the numpy
    twin's (kernels/k1_twin.py, "new") exactly; cut 1 and 2 run."""
    from ssdr_al_torch.kernels import k1_twin

    for name, s, q, st, k, w in (flagship_k1_calls[4],
                                 flagship_k1_calls[3]):
        before = kn.window_topk.launches
        got, chip = kn.window_topk_stats(s, q, st, k, w)
        assert kn.window_topk.launches == before
        assert torch.equal(got, kn._window_topk_plain(s, q, st, k, w,
                                                      kn.QUERY_TILE)), name
        for cut in (1, 2):
            kn.window_topk_stats(s, q, st, k, w, cut=cut)
        torch.cuda.synchronize()
        if q.shape[1] == 2560:
            plan = kn.window_topk_plan(2, 2560, w, kn.QUERY_TILE)
            _, twin = k1_twin.walk(s.cpu().numpy(), q.cpu().numpy(),
                                   st.cpu().numpy().astype(np.int64), k, w,
                                   kn.QUERY_TILE, plan, True, "new")
            assert {n: twin[n] for n in kn.K1_STATS} == chip


_FIRST_K1 = """
import numpy as np, torch
from ssdr_al_torch.ops import knn as kn
rng = np.random.RandomState(0)
for b, n, w in ((2, 40960, 4096), (1, 4096, 4096)):
    xyz = torch.from_numpy((rng.rand(b, n, 3) * 6).astype(np.float32))
    lo, hi = xyz.amin(1, keepdim=True), xyz.amax(1, keepdim=True)
    x = kn.sort_by_codes(kn.morton_codes(xyz, lo, hi), xyz)[2].cuda()
    x = x.contiguous()
    st = kn.self_query_starts(n, n, w, device=x.device).expand(b, -1)
    st = st.contiguous()
    split, qpc, threads = kn.window_topk_plan(b, n, w, kn.QUERY_TILE)
    assert (split, threads) == ((1, 128) if b == 2 else (8, 64))
    for mxu in (False, True):
        smem = kn.window_topk_smem(w, 16, split, threads, mxu)
        assert smem > kn.SMEM_DEFAULT or b == 1
        got = kn.window_topk(x, x, st, 16, w, mxu=mxu)
        want = kn._window_topk_plain(x, x, st, 16, w, kn.QUERY_TILE, mxu)
        assert torch.equal(got, want), (b, n, w, mxu)
print("ok")
"""


def test_window_topk_first_launch_at_its_largest(dev):
    """K1's and K5's first launches in a fresh process (the opt-in
    attribute persists once set) at the largest shared memory the main
    paths plan, the `window_og` L0 self-search at W = 4096 at the
    flagship's batch [2 × 40960] (77 824 bytes for K1, 94 208 for K5),
    then at split 8 (a block's box united from two warps' sub-boxes)
    [1 × 4096]: each equals its plain version."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _FIRST_K1], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and out.stdout.strip() == "ok", \
        out.stderr[-2000:]


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
    with pytest.raises(ValueError, match="built for"):
        kn.knn_tiled(s, q, 65)


def _cloud_of(kind, rng, n):
    """[1, n, 3] f32: random in a 6 m cube, or with every point four times
    (exact d² ties between distinct indices, self not always first)."""
    if kind == "duplicates":
        x = np.repeat((rng.rand(-(-n // 4), 3) * 6).astype(np.float32), 4,
                      axis=0)[rng.permutation(n)]
    else:
        x = (rng.rand(n, 3) * 6).astype(np.float32)
    return torch.from_numpy(x[None])


@pytest.mark.parametrize("k", [17, 46, 64])
@pytest.mark.parametrize("kind,n", [
    ("random", 40000),      # the sorted walk at a prepared room's order
    ("duplicates", 40000),
    ("duplicates", 3000),
    ("random", 700),        # the walk in the cloud's own order
    ("random", 40),         # fewer points than k (k = 46, 64)
    ("duplicates", 12)])
def test_knn_tiled_any_k_matches_plain(dev, k, kind, n):
    """K6 at k above 16 (the K = 64 instantiation: 46 is the partition's
    k_geof + 1): a self-search equal to its plain version index for
    index on random clouds, on clouds of duplicated points and on clouds
    of fewer than k points (slots past them index 0), one launch each,
    counted in knn_tiled.launches_k64."""
    x = _cloud_of(kind, np.random.RandomState(n + k), n).to(dev)
    want = kn._knn_tiled_plain(x, x, k)
    before = (kn.knn_tiled.launches, kn.knn_tiled.launches_k64)
    got = kn.knn_tiled(x, x, k)
    torch.cuda.synchronize()
    assert (kn.knn_tiled.launches, kn.knn_tiled.launches_k64) == \
        (before[0], before[1] + 1)
    assert got.shape == (1, n, k)
    assert torch.equal(got, want)
    if n < k:
        assert (got[..., n:] == 0).all()


@pytest.mark.parametrize("route", ["brute", "walk", "sorted"])
@pytest.mark.parametrize("k", [2, 5, 17, 46, 64])
def test_knn_tiled_every_route_any_k(dev, route, k):
    """Every route of K6 at widths between and above the model's: an
    upsample-shaped search (queries apart from the support) with
    duplicated support points equals the plain version."""
    rng = np.random.RandomState(k)
    s = _cloud_of("duplicates", rng, 2000).to(dev)
    q = _cloud_of("random", rng, 1500).to(dev)
    want = kn._knn_tiled_plain(s, q, k)
    got, stats = kn.knn_tiled_stats(s, q, k, route=route)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert 0 < stats["pairs"] <= 2000 * 1500


K64 = [17, 33, 46, 64]      # widths served by K6's K = 64 walk


def _k64_case(s, q, k, routes=("walk", "sorted")):
    """K6 at 16 < k <= 64 on each given route equal to the plain version
    index for index, each launch counted once in launches_k64; returns
    the last route's result and pair count."""
    want = kn._knn_tiled_plain(s, q, k)
    for route in routes:
        before = (kn.knn_tiled.launches, kn.knn_tiled.launches_k64)
        got, stats = kn.knn_tiled_stats(s, q, k, route=route)
        torch.cuda.synchronize()
        assert (kn.knn_tiled.launches, kn.knn_tiled.launches_k64) == \
            (before[0], before[1] + 1)
        assert got.shape == want.shape
        assert torch.equal(got, want), (route, (got != want).sum().item())
    return got, stats


@pytest.mark.parametrize("k", K64)
@pytest.mark.parametrize("ns", [33, 63, 64, 65, 96])
def test_knn_tiled_k64_around_the_fill(dev, k, ns):
    """The K = 64 walk where its fill of two blocks holds every support
    point (Ns <= 64; Ns < k among them, the slots past Ns index 0) or all
    but a few (65, 96), on both walk routes: a self-search over two batch
    rows and 70 queries apart from the support."""
    rng = np.random.RandomState(ns * 100 + k)
    s = torch.from_numpy(rng.randn(2, ns, 3).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.randn(2, 70, 3).astype(np.float32)).to(dev)
    got, _ = _k64_case(s, s, k)
    if ns < k:
        assert (got[..., ns:] == 0).all()
    _k64_case(s, q, k)


@pytest.mark.parametrize("k", K64)
@pytest.mark.parametrize("shape", ["ragged", "batch", "one point", "plane"])
def test_knn_tiled_k64_shapes(dev, k, shape):
    """The K = 64 walk on shapes its plan meets: 3001 queries (not a
    multiple of the KNN_WALK64_QUERIES a CTA takes) against 5000 support
    points; B = 2 self-searches; a cloud of one repeated point (every d²
    ties, so the order is by index, and no box excludes anything: every
    pair is evaluated); a planar cloud (z constant: every box flat)."""
    rng = np.random.RandomState(k)
    assert 3001 % kn.KNN_WALK64_QUERIES
    if shape == "ragged":
        s = _cloud_of("duplicates", rng, 5000).to(dev)
        _k64_case(s, _cloud_of("random", rng, 3001).to(dev), k)
        return
    if shape == "batch":
        s = torch.cat([_cloud_of("random", rng, 6000) for _ in range(2)]
                      ).to(dev)
    elif shape == "one point":
        s = torch.full((1, 3000, 3), 1.5, device=dev)
    else:
        xy = (rng.rand(1, 8000, 2) * 6).astype(np.float32)
        s = torch.from_numpy(np.concatenate(
            [xy, np.full((1, 8000, 1), 0.8, np.float32)], -1)).to(dev)
    got, stats = _k64_case(s, s, k)
    if shape == "one point":
        assert torch.equal(got[0], torch.arange(k, dtype=torch.int32,
                                                device=dev).expand(3000, k))
        assert stats["pairs"] == 3000 ** 2


_FIRST_K64 = """
import numpy as np, torch
from ssdr_al_torch.ops import knn as kn
n = 200_000
assert kn.knn_tiled_plan(n, 46) == (6250, 196, False, 0)
x = (np.random.RandomState(0).rand(1, n, 3) * [12, 12, 3]).astype(np.float32)
x = torch.from_numpy(x).cuda()
assert torch.equal(kn.knn_tiled(x, x, 46), kn._knn_tiled_plain(x, x, 46))
assert kn.knn_tiled.launches_k64 == 1
print("ok")
"""


def test_knn_tiled_k64_first_launch_at_its_largest(dev):
    """The K = 64 walk's first launch in a fresh process at 200 000
    points, past the flagship's rooms: its plan takes no dynamic shared
    memory at any size (2 KiB of static list slots), so no opt-in is
    needed; equal to the plain version, one launch counted."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _FIRST_K64], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and out.stdout.strip() == "ok", \
        out.stderr[-2000:]


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
b, n, nq, k, c, window, tq = {shape}
idx = torch.from_numpy(rng.randint(0, window, (b, nq, k)).astype(np.int32))
starts = torch.zeros((b, nq // tq), dtype=torch.int32)
g = torch.from_numpy(rng.randn(b, nq, k, c).astype(np.float32)){cast}
i_d, s_d = idx.cuda(), starts.cuda()
tr = ga.WindowTranspose(i_d, s_d, n, window, tq) if {shared} else None
got = ga.scatter_window(g.cuda(), i_d, s_d, n, window, tq, transpose=tr)
assert ga.window_transpose.launches == {transposes}
if {transposes}:
    assert ga.transpose_plan(b, n, nq, k, window, tq)[3] == {whole}
assert torch.equal(got.cpu(), ga.scatter_window(g, idx, starts, n, window,
                                                tq))
print("ok")
"""


def _first_k4(shape, bf16=False, shared=False, transposes=0, whole=False):
    """Runs one K4 call as the first K4 launch of a fresh process (a
    kernel's shared-memory opt-in persists once set): at `shape` (b, n,
    nq, k, c, window, tq), through a WindowTranspose where `shared`, with
    `transposes` transpose launches on the `whole` (batch) or tile plan;
    it must equal the plain version."""
    import os
    import subprocess
    import sys

    script = _FIRST_K4.format(
        shape=", ".join(map(str, shape)), shared=shared,
        cast=".to(torch.bfloat16)" if bf16 else "", transposes=transposes,
        whole=whole)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", script], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# Semantic3D's first K4 call of a backward, a pool gather's
S3D_POOL = (1, 4096, 1024, 16, 256, 4096, 128)


def test_scatter_window_first_launch_at_48_kib(dev):
    """Semantic3D's first K4 call of a backward, [1, 1024, 16, 256] into
    4096 rows with a 4096-row window (tq=128), takes the single-use path
    (no shared transpose, tiles of 2048 entries): it asks the fill kernel
    for exactly 48 KiB of dynamic shared memory, which with its static
    part needs the opt-in attribute. As the first K4 launch of a fresh
    process it launches and equals the plain version."""
    _first_k4(S3D_POOL)


def test_scatter_window_first_launch_under_48_kib(dev):
    """The bf16 step's L2 pool index set, [6, 640, 16, 256] into 2560 rows,
    through a WindowTranspose: its 10 240 ids take the batch transpose
    kernel (scatter_batch_transpose_kernel), which asks for ~21 KiB of
    dynamic shared memory, under the 48 KiB default. As the first K4
    launch of a fresh process it launches and equals the plain version."""
    _first_k4((6, 2560, 640, 16, 256, 2560, 128), shared=True,
              transposes=1, whole=True)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("plan,shape,shared", [
    # 65 536 ids in tiles of 8 192: the tile kernels, the place kernel
    # asking ~90 KiB (a window of 2048 rows, 1024 threads)
    ("tile", (1, 4096, 4096, 16, 8, 2048, 512), True),
    # the L0 1-NN upsample's 40 960 ids in tiles of 128, no shared
    # transpose: the batch kernel asking ~85 KiB
    ("batch", (1, 10240, 40960, 1, 32, 1152, 128), False)])
def test_scatter_window_first_transpose_past_48_kib(dev, plan, shape,
                                                    shared, bf16):
    """A transpose as the first K4 launch of a fresh process, on the tile
    plan (scatter_hist_kernel, scatter_scan_kernel,
    scatter_place_transpose_kernel) and on the batch plan
    (scatter_batch_transpose_kernel), each asking for more than 48 KiB of
    dynamic shared memory: the kernels opt in at first use, launch, and
    the sum after them equals the plain version."""
    _first_k4(shape, bf16=bf16, shared=shared, transposes=1,
              whole=plan == "batch")


@pytest.mark.parametrize("tq", [512, 128])
@pytest.mark.parametrize("c", [8, 11, 32, 35, 64, 67, 128, 256])
def test_scatter_window_every_channel_count(dev, c, tq):
    """K4 at every channel count the model scatters and both tile sizes
    (the LFA gathers' and gather_window_auto's), starts past both ends
    and indices outside their windows, on both paths (the single-use
    path, and a shared transpose's sum): bitwise equal to the CPU plain
    version and to a second launch."""
    rng = np.random.RandomState(c + tq)
    b, n, k, window = 2, 4096, 16, 1024
    g, idx, starts = _scatter_inputs(rng, b, n, n, k, c, window, tq)
    want = ga.scatter_window(g, idx, starts, n, window, tq)
    args = (g.to(dev), idx.to(dev), starts.to(dev), n, window, tq)
    tr = ga.WindowTranspose(*args[1:])
    got, again = ga.scatter_window(*args), ga.scatter_window(*args)
    shared = [ga.scatter_window(*args, transpose=tr) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want) and torch.equal(got, again)
    assert all(torch.equal(x, got) for x in shared)


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
    """K4 with a bf16 cotangent at every channel count the model scatters,
    on both paths: bitwise equal to index_add_ of g.float() on the CPU
    (the plain version) and to a second launch; f32 dv."""
    rng = np.random.RandomState(c + tq + 2)
    b, n, k, window = 2, 4096, 16, 1024
    g, idx, starts = _scatter_inputs(rng, b, n, n, k, c, window, tq)
    g = g.to(torch.bfloat16)
    want = ga.scatter_window(g, idx, starts, n, window, tq)
    assert want.dtype == torch.float32
    assert torch.equal(want, ga.scatter_window(g.float(), idx, starts, n,
                                               window, tq))
    args = (g.to(dev), idx.to(dev), starts.to(dev), n, window, tq)
    tr = ga.WindowTranspose(*args[1:])
    got, again = ga.scatter_window(*args), ga.scatter_window(*args)
    shared = [ga.scatter_window(*args, transpose=tr) for _ in range(2)]
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert torch.equal(got.cpu(), want) and torch.equal(got, again)
    assert all(torch.equal(x, got) for x in shared)


def test_scatter_window_bf16_first_launch_at_48_kib(dev):
    """test_scatter_window_first_launch_at_48_kib with a bf16 cotangent:
    the single-use path's fill kernel's opt-in as the first K4 launch of a
    fresh process, and its bf16 sum kernel after it."""
    _first_k4(S3D_POOL, bf16=True)


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


@pytest.mark.parametrize("c8", [8, 11])
def test_scatter_window_shared_transpose_matches_none(dev, c8):
    """Two K4 calls of one index set at the L0 LFA shape through one
    WindowTranspose (a bf16 cotangent of 11 and one of c8 channels, as a
    layer's two LFA gathers): one transpose built (two kernels, one count),
    each sum bitwise equal to the call without a shared transpose and to
    the CPU plain version; the transpose equal to its plain version."""
    rng = np.random.RandomState(20 + c8)
    b, n, k, window, tq = 2, 40960, 16, 2048, 512
    g, idx, starts = _scatter_inputs(rng, b, n, n, k, 11, window, tq)
    g2 = torch.from_numpy(rng.randn(b, n, k, c8).astype(np.float32))
    cots = [x.to(torch.bfloat16) for x in (g, g2)]
    i, st = idx.to(dev), starts.to(dev)
    tr = ga.WindowTranspose(i, st, n, window, tq)
    before = (ga.window_transpose.launches, ga.scatter_window.launches_bf16)
    shared = [ga.scatter_window(x.to(dev), i, st, n, window, tq,
                                transpose=tr) for x in cots]
    assert (ga.window_transpose.launches,
            ga.scatter_window.launches_bf16) == (before[0] + 1,
                                                 before[1] + 2)
    own = [ga.scatter_window(x.to(dev), i, st, n, window, tq) for x in cots]
    torch.cuda.synchronize()
    for x, a, o in zip(cots, shared, own):
        assert torch.equal(a, o)
        assert torch.equal(a.cpu(), ga.scatter_window(x, idx, starts, n,
                                                      window, tq))
    rp, ids = tr.csr()
    rp0, ids0 = ga._window_transpose_plain(idx, starts, n, window, tq)
    assert torch.equal(rp.cpu(), rp0)
    for j, m in enumerate(rp0.reshape(b, n + 1)[:, n].tolist()):
        assert torch.equal(ids[j * n * k:j * n * k + m].cpu(),
                           ids0[j * n * k:j * n * k + m])


@pytest.mark.parametrize("n,tq,window", [(8192, 512, 2048),
                                         (32768, 1024, 16384)])
def test_scatter_window_long_rows(dev, n, tq, window):
    """Rows with thousands of ids (piles of 3000 and 1500 entries on two
    rows, four tiles' entries on 64 rows of one window) and, at tq = 1024
    and a 16 384-row window, tiles cut into runs of entries and of window
    rows (transpose_plan's parts and pieces 2 and 2): bitwise equal to
    the plain version on both paths, f32 and bf16, run to run."""
    rng = np.random.RandomState(21)
    b, k, c = 2, 16, 32
    g, idx, starts = _scatter_inputs(rng, b, n, n, k, c, window, tq)
    lo = int(torch.clamp(starts[0, 3], 0, n - window))
    starts[0, 3:7] = lo
    e0, ne = 3 * tq * k, tq * k
    flat = idx[0].reshape(-1)
    flat[e0:e0 + 4 * ne] = torch.from_numpy(
        rng.randint(lo, lo + 64, 4 * ne).astype(np.int32))
    flat[e0:e0 + 3000] = lo + 5
    flat[e0 + 3000:e0 + 4500] = lo + 900
    i, inside = ga._window_mask(idx, starts, n, window, tq)
    assert torch.bincount(i[0][inside[0]], minlength=n).max() > 3000
    assert ga.transpose_plan(b, n, n, k, window, tq)[:2] == \
        ((1, 1) if tq == 512 else (2, 2))
    for cot in (g, g.to(torch.bfloat16)):
        want = ga.scatter_window(cot, idx, starts, n, window, tq)
        args = (cot.to(dev), idx.to(dev), starts.to(dev), n, window, tq)
        tr = ga.WindowTranspose(*args[1:])
        got, again = ga.scatter_window(*args), ga.scatter_window(*args)
        shared = ga.scatter_window(*args, transpose=tr)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want) and torch.equal(got, again)
        assert torch.equal(shared, got)


@pytest.mark.parametrize("n,n_sub,c", [(40960, 10240, 32),
                                       (10240, 2560, 128)])
def test_scatter_window_k1_bf16_against_scatter_rows(dev, n, n_sub, c):
    """K4 at k = 1 with a bf16 cotangent at the upsample windows (the
    sorted pyramid's, through gather_window_auto's starts) and
    scatter_rows, the bf16 model's upsample backward, on the same rows:
    both bitwise equal to index_add_ of g.float() on the CPU."""
    feat, idx = _upsample_case(np.random.RandomState(22), 2, n, n_sub, c)
    w = 1024 + 128
    starts = ga.tile_min_starts(idx, n_sub, w, 128)
    g = torch.randn(2, n, 1, c, generator=torch.Generator().manual_seed(3)
                    ).to(torch.bfloat16)
    want = ga.scatter_window(g, idx, starts, n_sub, w, 128)
    got = ga.scatter_window(g.to(dev), idx.to(dev), starts.to(dev), n_sub, w,
                            128)
    rows = ga.scatter_rows(g.to(dev)[:, :, 0], idx.to(dev)[..., 0], n_sub)
    torch.cuda.synchronize()
    assert ga.window_violations(idx, w) == 0
    assert torch.equal(got.cpu(), want) and torch.equal(rows.cpu(), want)


def test_scatter_window_capture_matches_eager(dev):
    """A layer's two LFA gathers sharing one WindowTranspose, forward and
    backward captured in a CUDA graph (the transpose built inside the
    capture, from the graph's pool) and replayed on new values and
    cotangents: the gradient bitwise equal to the eager step's, replay
    after replay."""
    rng = np.random.RandomState(23)
    b, n, k, window, tq = 2, 8192, 16, 2048, 512
    _, idx, starts = _scatter_inputs(rng, b, n, n, k, 11, window, tq)
    i, st = idx.to(dev), starts.to(dev)
    v = torch.zeros(b, n, 11, device=dev, requires_grad=True)
    g1 = torch.zeros(b, n, k, 11, device=dev, dtype=torch.bfloat16)
    g2 = torch.zeros(b, n, k, 8, device=dev, dtype=torch.bfloat16)

    def step():
        v.grad = None
        tr = ga.WindowTranspose(i, st, n, window, tq)
        a = ga.gather_window(v, i, st, window, tq, torch.bfloat16,
                             transpose=tr)
        w = ga.gather_window(v[..., :8].contiguous(), i, st, window, tq,
                             torch.bfloat16, transpose=tr)
        torch.autograd.backward([a, w], [g1, g2])
        return v.grad

    def fill(seed):
        r = np.random.RandomState(seed)
        with torch.no_grad():
            v.copy_(torch.from_numpy(r.randn(b, n, 11).astype(np.float32)))
            g1.copy_(torch.from_numpy(r.randn(*g1.shape).astype(np.float32)))
            g2.copy_(torch.from_numpy(r.randn(*g2.shape).astype(np.float32)))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fill(0)
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    fill(0)
    with torch.cuda.graph(graph):
        out = step()
    for seed in (1, 2):
        fill(seed)
        graph.replay()
        got = out.clone()
        fill(seed)
        want = step().clone()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


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


def _dp_step_case():
    """A window-engine train step at 8192 points (K1, K2 and K4 on the
    card): config, seeded O(1) weights, batch and weights."""
    import dataclasses

    from ssdr_al_torch.config import ConfigS3DIS
    from ssdr_al_torch.models.randlanet import init_params
    from ssdr_al_torch.train.grad_check import spread_weights

    cfg = dataclasses.replace(ConfigS3DIS, num_points=8192, batch_size=4)
    rng = np.random.RandomState(0)
    b, n = 4, cfg.num_points
    xyz = (rng.rand(b, n, 3) * 6).astype(np.float32)
    batch = {"xyz": xyz,
             "features": np.concatenate(
                 [xyz, rng.rand(b, n, 3).astype(np.float32)], -1),
             "labels": rng.randint(0, cfg.num_classes, (b, n)).astype(
                 np.int32),
             "pseudo": rng.randint(0, cfg.num_classes, (b, n)).astype(
                 np.int32),
             "activation": (rng.rand(b, n) < 0.6).astype(np.float32)}
    state = spread_weights(init_params(cfg, torch.Generator().manual_seed(0)),
                           5)
    return dict(cfg=cfg, state=state, batch=batch,
                weights=np.ones(cfg.num_classes, np.float32))


@pytest.mark.parametrize("ranks,backend", [(2, "gloo"), (1, "nccl")])
def test_data_parallel_step_on_one_card(dev, tmp_path, ranks, backend):
    """Two gloo ranks sharing the card, and a one-rank NCCL group: the
    step's loss equals the plain step's on the card to rtol 1e-5; the dp
    step's summed gradient and the plain step's are each held to a
    float64 CPU step, every f32 run replaying the f64 run's leaky-ReLU
    slopes and max-pool picks, within GRAD_ERR_MULTIPLE times the CPU f32
    step's own error plus GRAD_ERR_FLOOR (grad_check.reference_step, the
    smoke's data_parallel_path check); every rank launched K1, K2 and
    K4."""
    from ssdr_al_torch.parallel import backend_for, dryrun, launch
    from ssdr_al_torch.train.grad_check import gradient_rel, reference_step

    assert backend_for([dev] * ranks) == backend
    case = _dp_step_case()
    ref = reference_step(case["cfg"], case["state"], case["batch"],
                         case["weights"], dev)
    pins = str(tmp_path / "pins.pt")
    torch.save({"slopes": ref["slopes"], "pools": ref["pools"]}, pins)
    want = dryrun.train_step_result(None, device=dev, pins=ref, **case)
    assert gradient_rel(want["grad"], ref["grad"]) <= ref["limit"]
    out = launch(dryrun.run_calls, ranks, [dev] * ranks, str(tmp_path),
                 [(dryrun.train_step_result, dict(case, pins=pins))])
    for (res, counts), in out:
        np.testing.assert_allclose(res["loss"], want["loss"], rtol=1e-5)
        assert gradient_rel(res["grad"], ref["grad"]) <= ref["limit"]
        for name in ("window_topk", "gather_window", "scatter_window"):
            assert counts[name] > 0, (name, counts)


def _upsample_case(rng, b, n, n_sub, c, up_w=1024):
    """interp_idx [b, n, 1] as the sorted pyramid's windowed 1-NN upsample
    gives them (every 256-query tile inside [start, start + up_w) of the
    kept rows, starts 128-aligned) and a coarse feature [b, n_sub, c]."""
    tiles = n // kn.QUERY_TILE
    centre = (np.arange(tiles) * kn.QUERY_TILE + kn.QUERY_TILE // 2) \
        * n_sub // n
    starts = np.clip(centre - up_w // 2, 0, n_sub - up_w) // 128 * 128
    rel = rng.randint(0, up_w, (b, n))
    idx = np.repeat(starts, kn.QUERY_TILE)[None] + rel
    feat = rng.randn(b, n_sub, c).astype(np.float32)
    return (torch.from_numpy(feat),
            torch.from_numpy(idx[..., None].astype(np.int32)))


@pytest.mark.parametrize("n,n_sub,c", [(40960, 10240, 32),
                                       (10240, 2560, 128)])
def test_scatter_window_k1_upsample_matches_plain(dev, n, n_sub, c):
    """K4 at k = 1, the decoder's upsample backward (the sorted pyramid's
    two windowed upsamples at S3DIS width), through gather_window_auto:
    bitwise equal to its plain version (index_add_ on the CPU), run to
    run, and no index clamped (window_violations 0)."""
    from ssdr_al_torch.models.randlanet import nearest_interpolation

    feat, idx = _upsample_case(np.random.RandomState(8), 2, n, n_sub, c)
    assert ga.window_violations(idx, 1024 + 128) == 0
    g = torch.randn(2, n, c, generator=torch.Generator().manual_seed(9))

    def grad(d):
        f = feat.detach().to(d).requires_grad_()
        out = nearest_interpolation(f, idx.to(d), 1024 + 128)
        out.backward(g.to(d))
        return out.detach().cpu(), f.grad.cpu()

    want = grad("cpu")
    before = (ga.gather_window.launches, ga.scatter_window.launches)
    got = grad(dev)
    torch.cuda.synchronize()
    assert (ga.gather_window.launches, ga.scatter_window.launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(grad(dev)[1], got[1])


@pytest.mark.parametrize("b,n,m,c", [(6, 160, 2560, 512), (2, 640, 160, 7),
                                     (4, 4096, 65536, 32)])
def test_scatter_rows_fixed_order_on_the_card(dev, b, n, m, c):
    """The row gather's fixed-order backward (scatter_rows: a stable sort
    of the targets, then a segment sum) on the card equals the CPU's
    index_add_ bit for bit, run to run, where torch.gather's CUDA backward
    adds with float atomics; rows no index reaches are zero."""
    rng = np.random.RandomState(10)
    g = torch.from_numpy(rng.randn(b, m, c).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, n - 3, (b, m)).astype(np.int32))
    flat = (idx.long() + torch.arange(b)[:, None] * n).reshape(-1)
    want = torch.zeros(b * n, c).index_add_(0, flat, g.reshape(-1, c))
    got = ga.scatter_rows(g.to(dev), idx.to(dev), n)
    assert torch.equal(got.cpu(), want.reshape(b, n, c))
    assert torch.equal(ga.scatter_rows(g.to(dev), idx.to(dev), n), got)
    v = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(dev)
    v.requires_grad_()
    ga.gather_rows_fixed(v, idx.to(dev)).backward(g.to(dev))
    assert torch.equal(v.grad.cpu(), want.reshape(b, n, c))


def test_train_steps_repeat_bitwise(dev, tmp_path):
    """Two identical train steps from one state and one batch on the host
    pipeline, the device pool and the possibility pool, at 16384 points
    (five layers, both windowed upsamples): loss, every gradient, the
    BatchNorm statistics and the updated parameters bitwise equal
    (train/repeat_check.py)."""
    import dataclasses

    from ssdr_al_torch.config import ConfigS3DIS, ConfigSemantic3D
    from ssdr_al_torch.data.synthetic import make_dataset
    from ssdr_al_torch.train.repeat_check import repeat_paths

    rooms = make_dataset(num_train=2, num_val=0, num_points=30000, seed=0,
                         hard=True)[0]
    s3dis = dataclasses.replace(ConfigS3DIS, num_points=16384, batch_size=2)
    s3d = dataclasses.replace(ConfigSemantic3D, num_points=16384,
                              batch_size=2)
    res = repeat_paths(dev, s3dis=(s3dis, rooms), semantic3d=(s3d, rooms),
                       work=str(tmp_path))
    assert set(res) == {"host", "pool", "possibility"}
    for name, r in res.items():
        assert r["equal"], (name, r)


@pytest.mark.parametrize("probes", [1, 2])
@pytest.mark.parametrize("k", [1, 8, 16])
def test_knn_window_matches_plain(dev, k, probes):
    """knn_window on the card (K1, widths 1 and 16) index for index equal
    to the same call on CPU copies (K1's plain version): the curve codes,
    sorts, starts and the probe merge are the same torch ops on both."""
    rng = np.random.RandomState(11)
    sup = torch.from_numpy((rng.rand(2, 20000, 3) * 6).astype(np.float32))
    qry = sup if k > 1 else sup[:, ::4].contiguous()
    window = 2048 if k > 1 else 1024
    want = kn.knn_window(sup, qry, k, window=window, probes=probes)
    before = kn.window_topk.launches
    got = kn.knn_window(sup.to(dev), qry.to(dev), k, window=window,
                        probes=probes)
    torch.cuda.synchronize()
    assert kn.window_topk.launches == before + probes
    assert torch.equal(got.cpu(), want)


def test_approx_pyramid_is_the_pallas_pyramid(dev):
    """The "approx" engine searches with K6: its pyramid equals the
    "pallas" one bit for bit, and each layer launches K6 twice."""
    from ssdr_al_torch.config import ConfigS3DIS
    from ssdr_al_torch.models.randlanet import build_pyramid

    rng = np.random.RandomState(12)
    xyz = torch.from_numpy((rng.rand(2, ConfigS3DIS.num_points, 3) * 6)
                           .astype(np.float32)).to(dev)
    before = kn.knn_tiled.launches
    got = build_pyramid(xyz, ConfigS3DIS, engine="approx")
    torch.cuda.synchronize()
    assert kn.knn_tiled.launches == before + 2 * ConfigS3DIS.num_layers
    want = build_pyramid(xyz, ConfigS3DIS, engine="pallas")
    for f in ("neigh_idx", "sub_idx", "interp_idx"):
        for a, b in zip(getattr(got, f), getattr(want, f)):
            assert torch.equal(a, b)


def _gcn_problem(dev, blocks=3, slots=300, nfeat=16, seed=0):
    from ssdr_al_torch.train.step_times import gcn_fit_inputs

    return gcn_fit_inputs(dev, blocks, slots, nfeat, seed)


def test_gcn_fit_graphs_match_eager_steps(dev):
    """The fit as a CUDA graph (3 warm-up steps, 197 replays of one
    captured step) against the same capturable-AdamW steps run eagerly,
    200 steps with dropout from the same generator seed: losses and
    parameters bitwise equal (the same kernels on the same inputs, the
    same Philox offsets for every mask)."""
    from ssdr_al_torch.active import gcn
    from ssdr_al_torch.train import graphs

    params, adj, vhat, mask, labeled = _gcn_problem(dev)
    ref = {k: v.detach().clone().requires_grad_(True)
           for k, v in params.items()}
    with graphs.record_runs() as runs:
        losses = gcn.fit_gcn(params, adj, vhat, mask, labeled,
                             num_steps=200,
                             dropout_gen=torch.Generator(dev).manual_seed(3))
    assert [r["replays"] for r in runs] == [200 - graphs.GRAPH_WARMUP]
    valid = mask.float()
    n_lbl = torch.clamp((labeled * valid).sum(), min=1.0)
    n_unl = torch.clamp(((1 - labeled) * valid).sum(), min=1.0)
    opt = torch.optim.AdamW([ref[k] for k in gcn.PARAMS], lr=1e-3,
                            weight_decay=5e-4, capturable=True)
    drop = torch.Generator(dev).manual_seed(3)
    want = []
    for _ in range(200):
        opt.zero_grad(set_to_none=False)
        scores, _ = gcn._gcn_forward(ref, adj, vhat, mask, drop)
        loss = gcn.bce_adjacency_loss(scores, labeled, valid, n_lbl, n_unl)
        loss.backward()
        opt.step()
        want.append(loss.detach())
    torch.cuda.synchronize()
    assert torch.equal(losses, torch.stack(want))
    for k in gcn.PARAMS:
        assert torch.equal(params[k], ref[k]), k


# the card's fit against the CPU fit: f32 on both sides, other summation
# orders in the block products. The CPU fit is held to optax.adamw over
# JAX's loss with this tolerance (tests/test_torch_diversity.py::FIT_TOL,
# test_gcn_adamw_steps_match_optax), which cannot run here: the card's
# machine has no jax. Each step moves a parameter by at most lr
GCN_CARD_TOL = dict(rtol=1e-5, atol=1e-6)


def test_gcn_card_fit_matches_cpu_fit(dev):
    """24 steps of the fit (dropout off) from the same weights, at the
    size of test_gcn_adamw_steps_match_optax (3 blocks of 20 regions, 32
    features): the card's (3 eager steps, 21 replays of the captured
    step, capturable AdamW) against the CPU loop; losses and the weights
    that the loss reaches within GCN_CARD_TOL."""
    from ssdr_al_torch.active import gcn
    from ssdr_al_torch.train import graphs

    cpu = _gcn_problem("cpu", blocks=3, slots=20, nfeat=32, seed=5)
    card = [{k: v.detach().to(dev).requires_grad_(True)
             for k, v in cpu[0].items()}] + [x.to(dev) for x in cpu[1:]]
    want = gcn.fit_gcn(*cpu, num_steps=24)
    with graphs.record_runs() as runs:
        got = gcn.fit_gcn(*card, num_steps=24)
    assert [r["replays"] for r in runs] == [24 - graphs.GRAPH_WARMUP]
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               **GCN_CARD_TOL)
    for k in ("gc1_w", "gc1_b", "gc3_w", "gc3_b"):
        np.testing.assert_allclose(card[0][k].detach().cpu().numpy(),
                                   cpu[0][k].detach().numpy(),
                                   **GCN_CARD_TOL, err_msg=k)


_CAPTURE_FAILS = """
import sys
import torch
from ssdr_al_torch.active import gcn
sys.path.insert(0, "tests")
import test_torch_cuda as tc

def syncing_loss(*args, **kw):
    loss = bce(*args, **kw)
    loss.item()     # a host sync, which a stream capture refuses
    return loss

bce, gcn.bce_adjacency_loss = gcn.bce_adjacency_loss, syncing_loss
dev = torch.device("cuda", 0)
params, adj, vhat, mask, labeled = tc._gcn_problem(dev)
gcn.fit_gcn(params, adj, vhat, mask, labeled, num_steps=50)
print("RAN")
"""


def test_gcn_fit_capture_failure_raises(dev):
    """A step that a capture cannot record (a host sync) makes the fit
    raise; nothing runs the steps eagerly instead. In a child process: a
    failed capture may leave the process's CUDA context unusable."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _CAPTURE_FAILS], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "RAN" not in r.stdout, r.stdout
    assert "capture" in r.stderr.lower(), r.stderr[-2000:]
