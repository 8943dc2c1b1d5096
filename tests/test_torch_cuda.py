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
    cloud's end, and K2 on the same starts with both sources: equal to
    their plain versions (kernels/measure.py::check_ties raises if not)."""
    from ssdr_al_torch.kernels import measure

    done = measure.check_ties(dev)
    assert len(done) == 12


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
