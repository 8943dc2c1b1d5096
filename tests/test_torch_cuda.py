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


def test_window_topk_refuses_unbuilt_k(dev):
    """K1 is built for k in (1, 16); another k raises instead of falling
    back to the plain version."""
    xs = _sorted_cloud(np.random.RandomState(0), 1, 1024).to(dev)
    starts = kn.self_query_starts(1024, 1024, 512, device=dev)[None]
    with pytest.raises(ValueError, match="built for k"):
        kn.window_topk(xs, xs, starts.contiguous(), 4, 512)


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


def test_chamfer_sums_matches_plain(dev):
    """K3 agrees with its plain version within 1e-5 relative."""
    rng = np.random.RandomState(2)
    c, s, p = 3, 32, 512
    pts = torch.from_numpy(rng.randn(c, s, p, 3).astype(np.float32))
    msk = torch.from_numpy(rng.rand(c, s, p) < 0.7)
    msk[0, 3] = False                       # one empty superpoint
    want = ch.chamfer_sums(pts, msk)
    got = ch.chamfer_sums(pts.to(dev), msk.to(dev))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    cd = ch.chamfer_pairwise_blocks(pts.to(dev), msk.to(dev)).cpu()
    assert (cd[0, 3, torch.arange(s) != 3] >= 1e12).all()


@pytest.mark.parametrize("b,n,nq,c,window,tq", [
    (2, 40960, 40960, 11, 2048, 512),    # L0 LFA gather's backward
    (2, 2560, 640, 256, 2560, 128),      # L2 pool gather's, 256 channels
])
def test_scatter_window_matches_plain(dev, b, n, nq, c, window, tq):
    """K4 against its plain version (index_add_ on the CPU): f32 atomics sum
    in no fixed order, and two orders of an f32 sum of m values differ by
    at most 2·m·ε·Σ|g| (ε = 2⁻²³); so each element within 1e-5 relative
    plus that bound, with m and Σ|g| from the plain version (a near-
    cancelling sum has a large relative error: measured 2.2e-3 relative,
    2.2e-6 absolute at the L0 shape). Out-of-window indices contribute
    nothing. The backward of gather_window on the card launches K4 and
    gives the same gradient."""
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
    m = ga.scatter_window(torch.ones_like(g), idx, starts, n, window, tq)
    tol = 1e-5 * want.abs() + 2 * m * 2.0 ** -23 * ga.scatter_window(
        g.abs(), idx, starts, n, window, tq)
    before = ga.scatter_window.launches
    got = ga.scatter_window(g.to(dev), idx.to(dev), starts.to(dev), n,
                            window, tq)
    torch.cuda.synchronize()
    assert ga.scatter_window.launches == before + 1
    assert bool(((got.cpu() - want).abs() <= tol).all())

    vals = torch.from_numpy(rng.randn(b, n, c).astype(np.float32))
    v_dev = vals.to(dev).requires_grad_(True)
    ga.gather_window(v_dev, idx.to(dev), starts.to(dev), window,
                     tq).backward(g.to(dev))
    assert ga.scatter_window.launches == before + 2
    assert bool(((v_dev.grad.cpu() - want).abs() <= tol).all())
