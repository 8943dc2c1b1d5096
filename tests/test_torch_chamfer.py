"""ssdr_al_torch.ops.chamfer against ssdr_al_tpu.ops.chamfer on the CPU:
the pairwise chamfer (K3's plain version + epilogue) against both the
exact JAX path and the TPU kernel in interpret mode."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdr_al_torch.ops import chamfer as tc
from torch_parity import t

jc = importlib.import_module("ssdr_al_tpu.ops.chamfer")
torch.set_num_threads(1)


def _blocks(seed, c, s, p, empty=(0, 3)):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(c, s, p, 3) * 0.5).astype(np.float32)
    msk = rng.rand(c, s, p) < 0.7
    msk[..., 0] = True
    msk[empty] = False                      # one empty superpoint
    pts[~msk] = 7.0                         # junk in masked slots
    return pts, msk


@pytest.mark.parametrize("s,p", [(12, 40), (24, 96)])
def test_kernel_path_matches_jax_exact(s, p):
    """K3 sums + epilogue vs chamfer_pairwise_blocks(mxu=False):
    rtol 1e-5, atol 1e-6; 1e15 rows at the empty superpoint, zero diagonal."""
    pts, msk = _blocks(1, 2, s, p)
    want = np.asarray(jc.chamfer_pairwise_blocks(jnp.asarray(pts),
                                                 jnp.asarray(msk)))
    got = tc.chamfer_pairwise_blocks(t(pts), t(msk)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    others = np.arange(s) != 3
    assert (got[0, 3, others] >= 1e12).all() and (got[0, others, 3] >= 1e12).all()
    assert (np.diagonal(got, axis1=1, axis2=2) == 0).all()


def test_kernel_path_matches_tpu_kernel_interpret():
    """Against the TPU kernel (bf16x3 d², interpret mode): within 5e-4
    relative, the bar tests/test_ops.py already holds that kernel to."""
    pts, msk = _blocks(2, 2, 16, 128)
    want = np.asarray(jc.chamfer_pairwise_blocks_pallas(
        jnp.asarray(pts), jnp.asarray(msk), True))
    got = tc.chamfer_pairwise_blocks(t(pts), t(msk)).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-5)


def test_pad_superpoints_matches_jax():
    rng = np.random.RandomState(3)
    sps = [rng.randn(n, 3).astype(np.float32) for n in (5, 40, 700, 1)]
    for cap in (None, 512):
        want = jc.pad_superpoints(sps, cap)
        got = tc.pad_superpoints(sps, cap)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_chamfer_sums_refuses_non_cpu_tensors():
    p = torch.zeros(1, 2, 8, 3, device="meta")
    m = torch.zeros(1, 2, 8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tc.chamfer_sums(p, m)
