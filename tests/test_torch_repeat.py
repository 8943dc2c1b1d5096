"""The train step's row gathers sum their gradients in a fixed order, and
SSDR_DEBUG_WINDOW_GUARD reports clamped indices, on the CPU against
ssdr_al_tpu: the 1-NN upsample (K2/K4 at k = 1 on the sorted pyramid's
windowed upsamples, the fixed-order row gather elsewhere) and
gather_neighbour equal JAX's take_along_axis and its VJP, and the CPU
autograd gradient (index_add_) bit for bit; two CPU train steps from one
state are bitwise equal on every training path."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdr_al_tpu.models import randlanet as jr
from ssdr_al_torch.config import ConfigS3DIS, ConfigSemantic3D
from ssdr_al_torch.models import randlanet as tr
from ssdr_al_torch.ops import gather as tg
from torch_parity import interpret, t

jg = importlib.import_module("ssdr_al_tpu.ops.gather")
torch.set_num_threads(1)


def _upsample(seed, b, n, n_sub, c, up_w=1024, tile=256):
    """A coarse feature [b, n_sub, c] and interp_idx [b, n, 1] as the
    sorted pyramid's windowed upsample gives them: every 256-query tile's
    indices inside [start, start + up_w) of the coarse rows, starts
    128-aligned."""
    rng = np.random.RandomState(seed)
    centre = (np.arange(n // tile) * tile + tile // 2) * n_sub // n
    starts = np.clip(centre - up_w // 2, 0, n_sub - up_w) // 128 * 128
    idx = np.repeat(starts, tile)[None] + rng.randint(0, up_w, (b, n))
    return (rng.randn(b, n_sub, c).astype(np.float32),
            idx[..., None].astype(np.int32),
            rng.randn(b, n, c).astype(np.float32))


def _small(cfg, **over):
    """A narrow 3-layer RandLA-Net of the port's config."""
    return dataclasses.replace(cfg, **dict(dict(
        num_layers=3, d_out=(8, 16, 32), sub_sampling_ratio=(4, 4, 2)),
        **over))


def _jax_vjp(fn, x, *args):
    out, vjp = jax.vjp(lambda v: fn(v, *args), jnp.asarray(x))
    return out, vjp


@pytest.mark.parametrize("window", [1024 + 128, 0])
def test_upsample_backward_equals_autograd_and_jax(window):
    """nearest_interpolation through K2/K4's plain versions (window > 0)
    and through the row gather (window 0): the forward equals JAX's
    take_along_axis bit for bit, the gradient equals the CPU autograd
    gradient of torch.gather (index_add_ order) bit for bit and JAX's VJP
    within f32 summation order (rtol 1e-6)."""
    feat, idx, g = _upsample(0, 2, 8192, 2048, 11)
    assert tg.window_violations(t(idx), 1024 + 128) == 0
    x = t(feat).requires_grad_()
    out = tr.nearest_interpolation(x, t(idx), window)
    out.backward(t(g))
    ref = t(feat).requires_grad_()
    torch.gather(ref, 1, t(idx).long().expand(-1, -1, 11)).backward(t(g))
    assert torch.equal(x.grad, ref.grad)
    want, vjp = _jax_vjp(jr.nearest_interpolation, feat, jnp.asarray(idx))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(x.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-6, atol=1e-6)


def test_gather_neighbour_backward_equals_autograd_and_jax():
    """gather_neighbour's fixed-order backward (the card's; here its
    autograd Function run on the CPU) equals the CPU autograd gradient bit
    for bit and JAX's VJP within f32 summation order; scatter_rows sums
    a bf16 cotangent in f32 and leaves unreached rows zero."""
    rng = np.random.RandomState(1)
    b, n, m, k, c = 2, 300, 200, 16, 9
    pc = rng.randn(b, n, c).astype(np.float32)
    idx = rng.randint(0, n - 20, (b, m, k)).astype(np.int32)
    g = rng.randn(b, m, k, c).astype(np.float32)
    x = t(pc).requires_grad_()
    out = tg._GatherRows.apply(x, t(idx).reshape(b, m * k))
    out.backward(t(g).reshape(b, m * k, c))
    ref = t(pc).requires_grad_()
    tr.gather_neighbour(ref, t(idx)).backward(t(g))
    assert torch.equal(x.grad, ref.grad)
    assert float(x.grad[:, n - 20:].abs().sum()) == 0.0
    want, vjp = _jax_vjp(jr.gather_neighbour, pc, jnp.asarray(idx))
    np.testing.assert_array_equal(
        out.detach().reshape(b, m, k, c).numpy(), np.asarray(want))
    np.testing.assert_allclose(x.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-6, atol=1e-6)
    gb = t(g).reshape(b, m * k, c).bfloat16()
    flat = (t(idx).long().reshape(b, -1) + torch.arange(b)[:, None] * n)
    want16 = torch.zeros(b * n, c).index_add_(0, flat.reshape(-1),
                                              gb.float().reshape(-1, c))
    assert torch.equal(tg.scatter_rows(gb, t(idx).reshape(b, -1), n),
                       want16.reshape(b, n, c))


def test_sorted_pyramid_upsample_windows():
    """The sorted pyramid marks the upsamples that came from the windowed
    search (up_windows: 1024 rows and 128 of slack for the 128-aligned
    gather tiles) and no other; no index of those would be clamped."""
    cfg = _small(ConfigS3DIS, num_points=8192, sub_sampling_ratio=(2, 4, 2))
    xyz = torch.from_numpy(np.random.RandomState(2).rand(1, 8192, 3)
                           .astype(np.float32) * 6)
    pyr = tr.build_pyramid(xyz, cfg)
    assert pyr.up_windows == (1024 + 128, 0, 0)
    assert tg.window_violations(pyr.interp_idx[0], pyr.up_windows[0]) == 0


def test_two_cpu_train_steps_are_bitwise_equal(tmp_path):
    """train/repeat_check.py on the CPU: the host step, the device-pool
    step and the possibility-pool step each run twice from one state and
    one batch give the same loss, gradients, BatchNorm statistics and
    updated parameters, bit for bit."""
    from ssdr_al_torch.data.synthetic import make_dataset
    from ssdr_al_torch.train.repeat_check import repeat_paths

    rooms = make_dataset(num_train=2, num_val=0, num_points=3000, seed=0,
                         hard=True)[0]
    cfg = _small(ConfigS3DIS, num_points=2048, batch_size=2)
    cfg3 = _small(ConfigSemantic3D, num_points=2048, batch_size=2)
    res = repeat_paths(torch.device("cpu"), s3dis=(cfg, rooms),
                       semantic3d=(cfg3, rooms), work=str(tmp_path),
                       log=lambda *_: None)
    assert set(res) == {"host", "pool", "possibility"}
    for name, r in res.items():
        assert r["equal"] and r["tensors"] > 50, (name, r)


def _too_narrow(seed=3):
    """Indices whose tiles spread over more than a 512-row window."""
    rng = np.random.RandomState(seed)
    vals = rng.randn(1, 2048, 32).astype(np.float32)
    idx = rng.randint(0, 2048, (1, 256, 4)).astype(np.int32)
    return vals, idx, 512


def test_window_guard_reports_the_count_jax_prints(capsys, monkeypatch):
    """SSDR_DEBUG_WINDOW_GUARD: with a window too narrow for the tiles'
    spread, gather_window_auto prints JAX's message with JAX's count of
    clamped indices."""
    vals, idx, w = _too_narrow()
    monkeypatch.setattr(jg, "DEBUG_WINDOW_GUARD", True)
    with interpret():
        jg.gather_window_auto(jnp.asarray(vals), jnp.asarray(idx), w)
        jax.effects_barrier()
    want = capsys.readouterr().out.strip()
    monkeypatch.setattr(tg, "DEBUG_WINDOW_GUARD", True)
    tg.gather_window_auto(t(vals), t(idx), w)
    got = capsys.readouterr().out.strip()
    assert want.startswith("gather_window_auto: ") and "clamped" in want
    assert got == want
    assert int(got.split()[1]) > 0


def test_window_guard_unset_prints_nothing(capsys, monkeypatch):
    vals, idx, w = _too_narrow()
    monkeypatch.setattr(tg, "DEBUG_WINDOW_GUARD", False)
    tg.gather_window_auto(t(vals), t(idx), w)
    assert capsys.readouterr().out == ""
