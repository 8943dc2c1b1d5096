"""ssdr_al_torch.ops.gather (K2's plain version) against ssdr_al_tpu on the
CPU: bitwise against the exact XLA row gather, within bf16 rounding against
the TPU kernel functions in interpret mode."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdr_al_tpu.models.randlanet import gather_neighbour
from ssdr_al_torch.ops import gather as tg
from torch_parity import interpret, t

jg = importlib.import_module("ssdr_al_tpu.ops.gather")
torch.set_num_threads(1)

BF16_REL = 2.0 ** -8     # the TPU gather rounds every value to bf16


def _windowed(seed, b, n, c, k, window, tq):
    """values [B,N,C], window starts per tile, indices inside the windows."""
    rng = np.random.RandomState(seed)
    vals = rng.randn(b, n, c).astype(np.float32)
    starts = (rng.randint(0, (n - window) // 128 + 1, (b, n // tq)) * 128
              ).astype(np.int32)
    lo = np.repeat(starts, tq, axis=1)[..., None]
    idx = (lo + rng.randint(0, window, (b, n, k))).astype(np.int32)
    return vals, idx, starts


@pytest.mark.parametrize("c", [11, 64])
def test_plain_gather_bitwise_equals_xla_gather(c):
    vals, idx, starts = _windowed(0, 2, 2048, c, 16, 1024, 512)
    want = np.asarray(gather_neighbour(jnp.asarray(vals), jnp.asarray(idx)))
    got = tg.gather_window(t(vals), t(idx), t(starts), 1024, 512).numpy()
    np.testing.assert_array_equal(got, want)


def test_plain_gather_within_bf16_of_tpu_kernel():
    vals, idx, starts = _windowed(1, 2, 2048, 16, 16, 1024, 128)
    with interpret():
        want = np.asarray(jg.gather_window(
            jnp.asarray(vals), jnp.asarray(idx), jnp.asarray(starts), 1024,
            128)).astype(np.float32)
    got = tg.gather_window(t(vals), t(idx), t(starts), 1024, 128).numpy()
    np.testing.assert_allclose(got, want, rtol=BF16_REL, atol=0)


def test_gather_window_auto_matches_tpu_and_never_clamps():
    """Pool-style gather: indices are neighbour rows of the kept subset of
    a sorted cloud, the start comes from each tile's own minimum."""
    rng = np.random.RandomState(2)
    n, n_sub, k, c, w = 2048, 512, 16, 16, 1024
    vals = rng.randn(1, n, c).astype(np.float32)
    kept = np.sort(rng.choice(n, n_sub, replace=False))
    idx = np.clip(kept[None, :, None] + rng.randint(-150, 150, (1, n_sub, k)),
                  0, n - 1).astype(np.int32)
    assert tg.window_violations(t(idx), w) == 0
    assert int(jg.window_violations(jnp.asarray(idx), w)) == 0
    np.testing.assert_array_equal(
        tg.tile_min_starts(t(idx), n, w, 128).numpy(),
        np.asarray(jg.tile_min_starts(jnp.asarray(idx), n, w, 128)))
    with interpret():
        want = np.asarray(jg.gather_window_auto(
            jnp.asarray(vals), jnp.asarray(idx), w)).astype(np.float32)
    got = tg.gather_window_auto(t(vals), t(idx), w).numpy()
    np.testing.assert_allclose(got, want, rtol=BF16_REL, atol=0)
    exact = np.asarray(gather_neighbour(jnp.asarray(vals), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, exact)


def test_out_of_window_index_reads_zero():
    vals, idx, starts = _windowed(3, 1, 1024, 8, 4, 512, 128)
    idx[0, 5, 2] = starts[0, 0] + 512          # one past the window
    got = tg.gather_window(t(vals), t(idx), t(starts), 512, 128)
    assert float(got[0, 5, 2].abs().sum()) == 0.0


def test_gather_refuses_non_cpu_tensors():
    v = torch.zeros(1, 256, 4, device="meta")
    i = torch.zeros(1, 256, 2, dtype=torch.int32, device="meta")
    s = torch.zeros(1, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tg.gather_window(v, i, s, 128, 128)
