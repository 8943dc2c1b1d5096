"""Shared helpers of the tests that hold ssdr_al_torch against ssdr_al_tpu.

Inputs are made with numpy from a seed and handed to both sides; JAX runs
on the CPU, and where it reaches a Pallas TPU kernel it runs it in
interpret mode (`interpret()`)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from ssdr_al_tpu.config import ConfigS3DIS

# the K1 tie rule: the TPU kernel packs the window index into the low 12
# mantissa bits of d2, so two candidates within 2^-11 relative may swap
NEAR_TIE_REL = 2.0 ** -11


def interpret():
    """Context in which JAX's TPU Pallas kernels run in interpret mode."""
    return pltpu.force_tpu_interpret_mode()


def t(x, dtype=None):
    """numpy / jax array → CPU torch tensor."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def small_cfg(**over):
    """Narrow RandLA-Net: 3 layers, d_out (8, 16, 32)."""
    base = dict(num_layers=3, d_out=(8, 16, 32), sub_sampling_ratio=(4, 4, 2))
    base.update(over)
    return dataclasses.replace(ConfigS3DIS, **base)


def sorted_d2(xyz_q, xyz_s, idx):
    """Squared distance of query row r to support rows idx[r] (f64)."""
    q = np.asarray(xyz_q, np.float64)
    s = np.asarray(xyz_s, np.float64)
    return ((q[:, None, :] - s[np.asarray(idx)]) ** 2).sum(-1)


def assert_near_ties(xyz_q, xyz_s, idx_a, idx_b, rel=NEAR_TIE_REL,
                     max_frac=0.01):
    """idx_a and idx_b [nq, k] agree except where two candidates' squared
    distances agree to within `rel`; returns the mismatch fraction."""
    idx_a, idx_b = np.asarray(idx_a), np.asarray(idx_b)
    diff = idx_a != idx_b
    if diff.any():
        da = sorted_d2(xyz_q, xyz_s, idx_a)
        db = sorted_d2(xyz_q, xyz_s, idx_b)
        scale = np.maximum(np.maximum(da, db), 1e-30)
        bad = diff & (np.abs(da - db) > rel * scale + 1e-12)
        assert not bad.any(), (
            f"{int(bad.sum())} index mismatches are not near-ties")
    frac = float(diff.mean())
    assert frac <= max_frac, f"mismatch fraction {frac}"
    return frac


def random_flax_variables(variables, seed=0):
    """Flax RandLANet variables with every leaf redrawn at O(1) scale
    (kernels ~ N(0, 2/fan_in), biases and BN terms spread around their
    identity values), so the outputs are far from the near-constant logits
    of a fresh σ=1e-3 init and a class comparison means something."""
    rng = np.random.RandomState(seed)

    def draw(path, x):
        x = np.asarray(x)
        name = path[-1]
        if name == "kernel":
            return (rng.randn(*x.shape) * np.sqrt(2.0 / x.shape[0])).astype(
                np.float32)
        if name in ("bias", "mean"):
            return (rng.randn(*x.shape) * 0.1).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        raise KeyError(name)

    def walk(d, path=()):
        return {k: walk(v, path + (k,)) if isinstance(v, dict)
                else draw(path + (k,), v) for k, v in d.items()}

    return walk(_plain_dict(variables))


def _plain_dict(d):
    return {k: _plain_dict(v) if hasattr(v, "items") else v
            for k, v in d.items()}
