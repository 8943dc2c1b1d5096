"""The gradient of ssdr_al_torch.ops.gather.gather_window: kernel K4's
plain version (`_scatter_window_plain`, what CPU tensors take) against the
VJP of the JAX package's gather_window on the CPU, against the TPU scatter
kernel in interpret mode, and by finite differences."""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ssdr_al_torch.ops import gather as tg
from torch_parity import interpret, t, windowed

jg = importlib.import_module("ssdr_al_tpu.ops.gather")
torch.set_num_threads(1)

# same bf16-representable cotangent on both sides, f32 sums: only the
# summation order may differ
VJP_RTOL, VJP_ATOL = 1e-6, 1e-6
BF16_REL = 2.0 ** -8     # the TPU scatter kernel rounds g to bf16


def _port_grad(vals, idx, starts, window, tq, cot):
    v = t(vals).requires_grad_(True)
    out = tg.gather_window(v, t(idx), t(starts), window, tq)
    out.backward(t(cot))
    return v.grad.numpy()


@pytest.mark.parametrize("c,window,tq", [(11, 1024, 512), (32, 2048, 128)])
def test_backward_matches_jax_vjp(c, window, tq):
    """JAX: forward through the TPU gather kernel (interpret mode, channels
    padded as pad_channels pads them), backward through its CPU branch,
    the XLA scatter-add (ssdr_al_tpu/ops/gather.py:320-326). The gather
    outputs bf16, so its cotangent is bf16: both sides get the same
    bf16-representable cotangent."""
    b, n, k = 2, 2048, 16
    vals, idx, starts = windowed(4, b, n, c, k, window, tq)
    cot = np.random.RandomState(5).randn(b, n, k, c).astype(
        ml_dtypes.bfloat16)
    with interpret():
        def f(v):
            v_pad, c0 = jg.pad_channels(v, k=k)
            return jg.gather_window(v_pad, jnp.asarray(idx),
                                    jnp.asarray(starts), window, tq)[..., :c0]

        _, vjp = jax.vjp(f, jnp.asarray(vals))
        (want,) = vjp(jnp.asarray(cot))
    got = _port_grad(vals, idx, starts, window, tq, cot.astype(np.float32))
    assert np.asarray(want).dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=VJP_RTOL,
                               atol=VJP_ATOL)


def test_plain_scatter_within_bf16_of_tpu_scatter_kernel():
    """_scatter_window_impl, the TPU kernel run in interpret mode, rounds
    every cotangent value to bf16 before its f32 one-hot sums, so each row
    may differ by up to 2⁻⁸ · Σ|g| over the values it collects."""
    b, n, k, c, window, tq = 1, 1024, 16, 16, 512, 128
    _, idx, starts = windowed(6, b, n, c, k, window, tq)
    g = np.random.RandomState(7).randn(b, n, k, c).astype(np.float32)
    with interpret():
        want = np.asarray(jg._scatter_window_impl(
            jnp.asarray(g), jnp.asarray(idx), jnp.asarray(starts), n, window,
            tq, 8))
    got = tg.scatter_window(t(g), t(idx), t(starts), n, window, tq).numpy()
    bound = BF16_REL * tg.scatter_window(t(np.abs(g)), t(idx), t(starts), n,
                                         window, tq).numpy()
    assert np.all(np.abs(got - want) <= bound + 1e-6)
    assert np.abs(got - want).max() > 0     # the rounding is really there


def test_gradcheck_float64():
    """Finite differences in float64, through gather_window and through
    gather_window_auto (whose backward scatters through its clamped
    indices)."""
    b, n, c, k, window, tq = 1, 256, 3, 4, 128, 128
    vals, idx, starts = windowed(8, b, n, c, k, window, tq)
    v = t(vals).double().requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x: tg.gather_window(x, t(idx), t(starts), window, tq), (v,))
    assert torch.autograd.gradcheck(
        lambda x: tg.gather_window_auto(x, t(idx), window, tq), (v,))


def test_out_of_window_index_gets_no_gradient():
    vals, idx, starts = windowed(9, 1, 1024, 8, 4, 512, 128)
    row = int(starts[0, 0]) + 512                # one past tile 0's window
    idx[0, 5, 2] = row
    cot = np.zeros((1, 1024, 4, 8), np.float32)
    cot[0, 5, 2] = 1.0                           # only the outside entry
    got = _port_grad(vals, idx, starts, 512, 128, cot)
    assert np.abs(got).sum() == 0.0
    assert tg.scatter_window.launches == 0       # CPU: the plain version


def test_scatter_refuses_non_cpu_tensors():
    g = torch.zeros(1, 256, 2, 4, device="meta")
    i = torch.zeros(1, 256, 2, dtype=torch.int32, device="meta")
    s = torch.zeros(1, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tg.scatter_window(g, i, s, 256, 128, 128)
