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
from ssdr_al_tpu.models import randlanet as jr
from ssdr_al_torch.models import randlanet as tr

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


def windowed(seed, b, n, c, k, window, tq):
    """values [B, N, C] f32, 128-aligned window starts per query tile
    [B, N/tq] and neighbour indices [B, N, k] inside each tile's window."""
    rng = np.random.RandomState(seed)
    vals = rng.randn(b, n, c).astype(np.float32)
    starts = (rng.randint(0, (n - window) // 128 + 1, (b, n // tq)) * 128
              ).astype(np.int32)
    lo = np.repeat(starts, tq, axis=1)[..., None]
    idx = (lo + rng.randint(0, window, (b, n, k))).astype(np.int32)
    return vals, idx, starts


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


def flax_param_dict(params, batch_stats):
    """Flax variables → {state_dict key: numpy array} of the port's model."""
    return {k: v.numpy() for k, v in tr.params_from_flax(
        _plain_dict(jax_to_numpy(params)),
        _plain_dict(jax_to_numpy(batch_stats))).items()}


def flax_from_params(state_dict) -> dict:
    """The port's RandLANet state_dict → flax variables {"params",
    "batch_stats"} of ssdr_al_tpu's RandLANet (numpy leaves): the inverse
    of params_from_flax. Linear weights [out, in] become Dense kernels
    [in, out]."""
    sd = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                        else v, np.float32) for k, v in state_dict.items()}

    def dense(prefix, bias=True):
        d = {"kernel": sd[prefix + "weight"].T.copy()}
        if bias:
            d["bias"] = sd[prefix + "bias"]
        return d

    def bn(prefix):
        return ({"scale": sd[prefix + "weight"], "bias": sd[prefix + "bias"]},
                {"mean": sd[prefix + "running_mean"],
                 "var": sd[prefix + "running_var"]})

    def shared(prefix):
        p, bs = {"Dense_0": dense(prefix + "dense.")}, {}
        if prefix + "bn.weight" in sd:
            p["BatchNorm_0"], bs["BatchNorm_0"] = bn(prefix + "bn.")
        return p, bs

    def att(prefix):
        mp, mbs = shared(prefix + "mlp.")
        return ({"Dense_0": dense(prefix + "dense.", bias=False), "mlp": mp},
                {"mlp": mbs})

    params, stats = {"fc0": dense("fc0.")}, {}
    params["fc0_bn"], stats["fc0_bn"] = bn("fc0_bn.")
    i = 0
    while f"encoder.{i}.mlp1.dense.weight" in sd:
        pre, p, bs = f"encoder.{i}.", {"lfa": {}}, {"lfa": {}}
        for name in ("mlp1", "mlp2", "shortcut"):
            p[name], bs[name] = shared(pre + name + ".")
        for name in ("mlp1", "mlp2"):
            p["lfa"][name], bs["lfa"][name] = shared(pre + f"lfa.{name}.")
        for name in ("att_pooling_1", "att_pooling_2"):
            p["lfa"][name], bs["lfa"][name] = att(pre + f"lfa.{name}.")
        params[f"encoder_{i}"], stats[f"encoder_{i}"] = p, bs
        i += 1
    j = 0
    while f"decoder.{j}.dense.weight" in sd:
        params[f"decoder_{j}"], stats[f"decoder_{j}"] = shared(
            f"decoder.{j}.")
        j += 1
    for name in ("fc1", "fc2"):
        params[name], stats[name] = shared(name + ".")
    params["fc"] = dense("fc.")
    return {"params": params, "batch_stats": stats}


def jax_to_numpy(tree):
    return {k: jax_to_numpy(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


class _IdentityDropout(torch.nn.Module):
    def forward(self, x, generator=None):
        return x


def identity_dropout():
    """A stand-in for the port model's dropout (`model.dp1`): there is no
    RNG shared between the frameworks, so parity tests switch dropout off
    on both sides."""
    return _IdentityDropout()


def to_torch_pyramid(p):
    """A JAX Pyramid / SortedPyramid as the port's, on the CPU."""
    if isinstance(p, jr.SortedPyramid):
        conv = [None if s is None else t(s, torch.int32) for s in p.starts]
        return tr.SortedPyramid(
            [t(x) for x in p.xyz], [t(x, torch.int32) for x in p.neigh_idx],
            conv, [t(x, torch.int32) for x in p.sub_idx],
            [t(x, torch.int32) for x in p.interp_idx],
            t(p.order, torch.int32), t(p.inv, torch.int32),
            windows=tuple(p.windows))
    return tr.Pyramid([t(x) for x in p.xyz],
                      [t(x, torch.int32) for x in p.neigh_idx],
                      [t(x, torch.int32) for x in p.sub_idx],
                      [t(x, torch.int32) for x in p.interp_idx])
