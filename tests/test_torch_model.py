"""ssdr_al_torch.models.randlanet against ssdr_al_tpu.models.randlanet on the
CPU: parameter conversion, the exact and the sorted pyramid, and the
forward given the same pyramid arrays (the sorted one built by the TPU
kernels in interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdr_al_tpu.models import randlanet as jr
from ssdr_al_torch.models import randlanet as tr
from ssdr_al_torch.ops.gather import window_violations
from ssdr_al_torch.train import trainer as tt
from torch_parity import (
    assert_near_ties,
    interpret,
    random_flax_variables,
    small_cfg,
    t,
    to_torch_pyramid,
)

torch.set_num_threads(1)

# exact pyramid, same arrays on both sides: f32 everywhere, only the
# summation order of the matmuls differs
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-5
# sorted pyramid: JAX's TPU gathers round every gathered value to bf16
# (2^-8 relative), the port's are exact f32
CLASS_AGREEMENT = 0.99
PENULT_REL_ERR = 1e-2      # ||Δ penult|| / ||penult||; measured 2.0e-3


def _inputs(seed, b, n):
    rng = np.random.RandomState(seed)
    xyz = (rng.rand(b, n, 3) * 4).astype(np.float32)
    feats = np.concatenate([xyz, rng.rand(b, n, 3).astype(np.float32)], -1)
    return xyz, feats


@pytest.fixture(scope="module")
def flax_init():
    """(cfg, flax model, variables from model.init): parameter shapes do
    not depend on the point count, so one init serves every test here."""
    cfg = small_cfg(num_points=1024)
    xyz, feats = _inputs(0, 1, 512)
    model = jr.RandLANet(cfg)

    @jax.jit
    def init(key, x, f):
        return model.init({"params": key}, f,
                          jr.build_pyramid(x, cfg, engine="xla"), False)

    v = init(jax.random.PRNGKey(0), jnp.asarray(xyz), jnp.asarray(feats))
    return cfg, model, jax.tree_util.tree_map(np.asarray, v)


def _torch_model(cfg, variables):
    model = tr.RandLANet(cfg)
    model.load_state_dict(tr.params_from_flax(variables["params"],
                                              variables["batch_stats"]))
    return model.eval()


def test_params_from_flax_loads_strict(flax_init):
    cfg, _, v = flax_init
    sd = tr.params_from_flax(v["params"], v["batch_stats"])
    model = tr.RandLANet(cfg)
    model.load_state_dict(sd, strict=True)
    np.testing.assert_array_equal(
        model.fc0.weight.detach().numpy(),
        np.asarray(v["params"]["fc0"]["kernel"]).T)


def test_init_params_follows_flax_initializers(flax_init):
    """Same keys and shapes as a converted flax init; 1×1 convs truncated
    at ±2σ (σ=1e-3), dense layers inside the glorot bound, BN identity."""
    cfg, _, v = flax_init
    ref = tr.params_from_flax(v["params"], v["batch_stats"])
    sd = tt.init_params(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(x.shape) for k, x in sd.items()} == \
        {k: tuple(x.shape) for k, x in ref.items()}
    w = sd["encoder.0.mlp1.dense.weight"]
    assert w.abs().max() <= 2e-3 and 5e-4 < w.std() < 1.5e-3
    g = sd["encoder.1.lfa.att_pooling_1.dense.weight"]
    assert g.abs().max() <= (6.0 / (g.shape[0] + g.shape[1])) ** 0.5
    assert (sd["fc0_bn.running_var"] == 1).all()
    again = tt.init_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_exact_pyramid_matches_jax():
    cfg = small_cfg(num_points=1024)
    xyz, _ = _inputs(1, 2, 1024)
    want = jr.build_pyramid(jnp.asarray(xyz), cfg, engine="xla")
    got = tr.build_pyramid(t(xyz), cfg, engine="xla")
    for i in range(cfg.num_layers):
        np.testing.assert_array_equal(got.xyz[i].numpy(),
                                      np.asarray(want.xyz[i]))
        for b in range(2):
            x = np.asarray(want.xyz[i][b])
            assert_near_ties(x, x, got.neigh_idx[i][b].numpy(),
                             np.asarray(want.neigh_idx[i][b]), rel=1e-6)
            sub = x[: got.sub_idx[i].shape[1]]
            assert_near_ties(sub, x, got.sub_idx[i][b].numpy(),
                             np.asarray(want.sub_idx[i][b]), rel=1e-6)
            assert_near_ties(x, sub, got.interp_idx[i][b].numpy(),
                             np.asarray(want.interp_idx[i][b]), rel=1e-6)


def test_forward_on_exact_pyramid_matches_jax(flax_init):
    """Same pyramid arrays, same converted weights: logits and penult
    within rtol 1e-4 / atol 1e-5."""
    cfg, model, v = flax_init
    xyz, feats = _inputs(2, 2, 1024)
    v = random_flax_variables(v, seed=1)
    pyr = jr.build_pyramid(jnp.asarray(xyz), cfg, engine="xla")
    logits, penult = jax.jit(model.apply)(v, jnp.asarray(feats), pyr)
    tm = _torch_model(cfg, v)
    with torch.inference_mode():
        got_l, got_p = tm(t(feats), to_torch_pyramid(pyr))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(logits),
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(penult),
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


# ------------------------------------------------------------- sorted ---

SORTED_N = 8192


@pytest.fixture(scope="module")
def sorted_case(flax_init):
    """One cloud of 8192 points through the JAX sorted pyramid and the JAX
    sorted forward, both with the TPU kernels in interpret mode."""
    _, _, v = flax_init
    cfg = small_cfg(num_points=SORTED_N)
    model = jr.RandLANet(cfg)
    xyz, feats = _inputs(3, 1, SORTED_N)
    v = random_flax_variables(v, seed=2)
    with interpret():
        pyr = jax.jit(jax.vmap(
            lambda x: jr._pyramid_window_sorted_single(x, cfg)))(
                jnp.asarray(xyz))
        logits, penult = jax.jit(model.apply)(v, jnp.asarray(feats), pyr)
    return cfg, xyz, feats, v, pyr, np.asarray(logits), np.asarray(penult)


def test_sorted_pyramid_matches_jax(sorted_case):
    """order, inv, starts, windows and the layer rows are equal; neigh_idx,
    sub_idx and interp_idx agree up to the K1 near-tie rule."""
    cfg, xyz, _, _, want, _, _ = sorted_case
    got = tr.build_pyramid(t(xyz), cfg, engine="window")
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    np.testing.assert_array_equal(got.inv.numpy(), np.asarray(want.inv))
    assert got.windows == tuple(want.windows)
    assert got.windows == (1024, 2048, 0)
    # the pool gathers (gather_window_auto) never clamp at these shapes
    for i, w in enumerate(got.windows[:2]):
        n = got.xyz[i].shape[1]
        assert window_violations(got.sub_idx[i], min(w + 2048, n)) == 0
    # layer i's sorted rows are the sorted rows whose original index is
    # below the layer size (each layer keeps a prefix of the input order)
    order0 = np.asarray(want.order[0])

    def layer_rows(n):
        return xyz[0][order0[order0 < n]]

    n = cfg.num_points
    for i in range(cfg.num_layers):
        np.testing.assert_array_equal(got.xyz[i].numpy(),
                                      np.asarray(want.xyz[i]))
        if want.starts[i] is None:
            assert got.starts[i] is None
        else:
            np.testing.assert_array_equal(got.starts[i].numpy(),
                                          np.asarray(want.starts[i]))
        x = layer_rows(n)
        n = n // cfg.sub_sampling_ratio[i]
        nxt = layer_rows(n)
        np.testing.assert_array_equal(x, np.asarray(want.xyz[i][0]))
        assert_near_ties(x, x, got.neigh_idx[i][0].numpy(),
                         np.asarray(want.neigh_idx[i][0]))
        assert_near_ties(nxt, x, got.sub_idx[i][0].numpy(),
                         np.asarray(want.sub_idx[i][0]))
        assert_near_ties(x, nxt, got.interp_idx[i][0].numpy(),
                         np.asarray(want.interp_idx[i][0]))


def test_forward_on_sorted_pyramid_close_to_jax(sorted_case):
    """The JAX SortedPyramid into both models: f32 gathers here against
    the TPU kernel's bf16 gathers there."""
    cfg, _, feats, v, pyr, logits, penult = sorted_case
    tm = _torch_model(cfg, v)
    with torch.inference_mode():
        got_l, got_p = tm(t(feats), to_torch_pyramid(pyr))
    agree = float((got_l.numpy().argmax(-1) == logits.argmax(-1)).mean())
    rel = float(np.linalg.norm(got_p.numpy() - penult)
                / np.linalg.norm(penult))
    print(f"sorted forward: class agreement {agree:.4f}, penult rel err "
          f"{rel:.2e}")
    assert agree >= CLASS_AGREEMENT
    assert rel <= PENULT_REL_ERR


def test_batched_sorted_builder_equals_per_cloud():
    cfg = small_cfg(num_points=SORTED_N)
    xyz, _ = _inputs(4, 2, SORTED_N)
    both = tr.build_pyramid(t(xyz), cfg, engine="window")
    for b in range(2):
        one = tr.build_pyramid(t(xyz[b:b + 1]), cfg, engine="window")
        for f in ("xyz", "neigh_idx", "sub_idx", "interp_idx"):
            for i in range(cfg.num_layers):
                assert torch.equal(getattr(both, f)[i][b],
                                   getattr(one, f)[i][0]), (f, i)
        assert torch.equal(both.order[b], one.order[0])


def test_eval_step_sorted_outputs_follow_order():
    """Sorted outputs: row r belongs to input row order[r]."""
    cfg = small_cfg(num_points=SORTED_N)
    xyz, feats = _inputs(5, 1, SORTED_N)
    model = tr.RandLANet(cfg)
    state = tt.init_params(cfg, torch.Generator().manual_seed(1))
    batch = {"xyz": xyz, "features": feats}
    p_s, f_s, order = tt.make_eval_step(model, cfg, "window", True,
                                        device="cpu")(state, batch)
    p_o, f_o = tt.make_eval_step(model, cfg, "window", False,
                                 device="cpu")(state, batch)
    o = order[0].long()
    assert torch.equal(p_s[0], p_o[0][o]) and torch.equal(f_s[0], f_o[0][o])
    _, _, ident = tt.make_eval_step(model, cfg, "xla", True,
                                    device="cpu")(state, batch)
    assert torch.equal(ident[0], torch.arange(SORTED_N, dtype=torch.int32))
