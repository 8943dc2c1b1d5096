"""ssdr_al_torch.ops.knn against ssdr_al_tpu.ops.knn on the CPU: morton
codes, stable sorts, exact KNN and the window top-k K1 (its plain version
against the TPU kernel function in interpret mode)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdr_al_torch.ops import knn as tk
from torch_parity import assert_near_ties, interpret, t

# ssdr_al_tpu.ops re-exports a function named knn over the module name
jk = importlib.import_module("ssdr_al_tpu.ops.knn")

torch.set_num_threads(1)


def _cloud(seed, n, b=1, scale=6.0):
    return (np.random.RandomState(seed).rand(b, n, 3) * scale).astype(
        np.float32)


@pytest.mark.parametrize("shift", [0, 512])
def test_morton_codes_equal(shift):
    xyz = _cloud(0, 4096)[0]
    lo, hi = xyz.min(0), xyz.max(0)
    want = np.asarray(jk.morton_codes(jnp.asarray(xyz), jnp.asarray(lo),
                                      jnp.asarray(hi), shift))
    got = tk.morton_codes(t(xyz), t(lo), t(hi), shift).numpy()
    np.testing.assert_array_equal(got, want)


def test_sort_by_codes_stable_on_ties():
    """Coordinates on a coarse grid give many equal codes: the order of
    tied rows must match jax.lax.sort(is_stable=True) exactly."""
    rng = np.random.RandomState(1)
    xyz = (rng.randint(0, 6, (2000, 3)) * 0.5).astype(np.float32)
    lo, hi = xyz.min(0), xyz.max(0)
    codes = np.asarray(jk.morton_codes(jnp.asarray(xyz), jnp.asarray(lo),
                                       jnp.asarray(hi)))
    assert len(np.unique(codes)) < len(codes) // 4     # many ties
    jc, jo, jx = jk.sort_by_codes(jnp.asarray(codes), jnp.asarray(xyz))
    tc, to, tx = tk.sort_by_codes(t(codes), t(xyz))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(
        tk.invert_permutation(to).numpy(),
        np.asarray(jk.invert_permutation(jo)))


@pytest.mark.parametrize("ns,nq,k", [(700, 300, 16), (160, 160, 16),
                                     (640, 2560, 1), (8, 5, 16)])
def test_knn_xla_matches_jax(ns, nq, k):
    """Exact KNN equals JAX knn_xla except where distances tie; with fewer
    support points than k the missing slots are index 0 on both sides."""
    rng = np.random.RandomState(2)
    s = rng.randn(2, ns, 3).astype(np.float32)
    q = rng.randn(2, nq, 3).astype(np.float32)
    want = np.asarray(jk.knn_xla(s, q, k))
    got = tk.knn_xla(t(s), t(q), k).numpy()
    for b in range(2):
        assert_near_ties(q[b], s[b], got[b], want[b], rel=1e-6, max_frac=1e-3)


@pytest.mark.parametrize("k", [16, 1])
def test_window_topk_plain_matches_tpu_kernel(k):
    """K1's plain version against _run_window_pallas (interpret mode) at
    n=2048, W=1024: equal indices up to the packed-distance near-tie rule."""
    n, w = 2048, 1024
    xyz = _cloud(3, n)[0]
    lo, hi = xyz.min(0), xyz.max(0)
    codes = jk.morton_codes(jnp.asarray(xyz), jnp.asarray(lo), jnp.asarray(hi))
    _, _, xs = jk.sort_by_codes(codes, jnp.asarray(xyz))
    xs = np.asarray(xs)
    starts = tk.self_query_starts(n, n, w)
    with interpret():
        want = np.asarray(jk._run_window_pallas(
            jnp.asarray(xs), jnp.asarray(xs), jnp.asarray(starts.numpy()),
            k, 256, w))
    got = tk.window_topk(t(xs)[None], t(xs)[None], starts[None], k, w)[0]
    base = np.repeat(starts.numpy(), 256)[:, None]
    frac = assert_near_ties(xs, xs, got.numpy() + base, want + base)
    assert frac < 0.01


def test_knn_window_sorted_raw_matches_jax():
    """Sorted-space window search incl. starts and the sentinel clamp, on a
    cloud whose size is not a tile multiple (pad rows at 3e18)."""
    n, w = 1900, 1024
    xyz = _cloud(4, n)[0]
    lo, hi = xyz.min(0), xyz.max(0)
    with interpret():
        sc = jk.sort_cloud(jnp.asarray(xyz), jnp.asarray(lo), jnp.asarray(hi))
        want, want_st = jk.knn_window_sorted_raw(sc, sc, 16, window=w,
                                                 self_query=True)
    sc_t = tk.sort_cloud(t(xyz)[None], t(lo)[None, None], t(hi)[None, None])
    assert sc_t.xyz_sorted.shape == (1, 1920, 3)
    assert (sc_t.xyz_sorted[0, n:] == 3e18).all()
    xs = sc_t.xyz_sorted[0, :n]
    got, got_st = tk.knn_window_sorted_raw(sc_t, sc_t, 16, window=w,
                                           self_query=True)
    np.testing.assert_array_equal(got_st[0].numpy(), np.asarray(want_st))
    xs_np = xs.numpy()
    assert_near_ties(xs_np, xs_np, got[0].numpy(), np.asarray(want))


def test_window_topk_refuses_non_cpu_tensors():
    """A tensor that is not on the CPU never takes the plain version."""
    x = torch.zeros(1, 256, 3, device="meta")
    st = torch.zeros(1, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tk.window_topk(x, x, st, 4, 128)
