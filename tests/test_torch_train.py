"""The train-mode pieces of ssdr_al_torch against the JAX package on the CPU:
BatchNorm in flax's arithmetic, dropout, the masked weighted CE, Adam
under the per-epoch schedule, and one train step on the exact pyramid."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from ssdr_al_tpu.config import ConfigS3DIS as JConfigS3DIS
from ssdr_al_tpu.models import randlanet as jr
from ssdr_al_tpu.train import trainer as jt
from ssdr_al_torch.models import randlanet as tr
from ssdr_al_torch.train import trainer as tt
from torch_parity import (
    flax_param_dict,
    identity_dropout,
    random_flax_variables,
    small_cfg,
    t,
)

torch.set_num_threads(1)

# same f32 arithmetic on both sides, only the reduction order differs
BN_RTOL, BN_ATOL = 1e-5, 1e-6
CE_RTOL, CE_ATOL = 1e-5, 1e-7
# Adam on identical gradients: torch folds the bias corrections into the
# step size, optax into the moments; after 5 steps of ~lr = 1e-2 the
# round-off reaches ~2e-7 (measured 1.7e-7)
ADAM_RTOL, ADAM_ATOL = 1e-6, 1e-6
# one train step on the exact pyramid, same weights and batch: loss and
# BatchNorm statistics; each parameter's gradient within 1e-4 of its
# tensor's largest (measured 2.1e-5), and the updated parameters within
# what that allows through Adam's first step
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
GRAD_TOL = 1e-4


@pytest.mark.parametrize("shape", [(512, 8), (2, 64, 16, 8)])
def test_batchnorm_train_mode_matches_flax(shape):
    """Output and updated running statistics; the 4-D case reduces over the
    k axis of an edge tensor as well."""
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    c = shape[-1]
    scale, bias = rng.rand(c).astype(np.float32) + 0.5, rng.randn(c).astype(
        np.float32)
    mean0, var0 = rng.randn(c).astype(np.float32), rng.rand(c).astype(
        np.float32) + 0.5
    bn = fnn.BatchNorm(momentum=0.99, epsilon=1e-6)
    y, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                       "batch_stats": {"mean": mean0, "var": var0}},
                      jnp.asarray(x), use_running_average=False,
                      mutable=["batch_stats"])
    m = tr.BatchNorm(c).train()
    m.load_state_dict({"weight": t(scale), "bias": t(bias),
                       "running_mean": t(mean0), "running_var": t(var0)})
    got = m(t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               rtol=BN_RTOL, atol=BN_ATOL)
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(
            getattr(m, ours).numpy(), np.asarray(upd["batch_stats"][theirs]),
            rtol=BN_RTOL, atol=BN_ATOL)
    m.eval()
    np.testing.assert_allclose(
        m(t(x)).detach().numpy(),
        np.asarray(bn.apply({"params": {"scale": scale, "bias": bias},
                             "batch_stats": upd["batch_stats"]},
                            jnp.asarray(x), use_running_average=True)),
        rtol=BN_RTOL, atol=BN_ATOL)


def test_dropout_rate_scale_and_mask():
    """Rate 0.5, kept values scaled by 2, the same mask from the same
    generator seed, the identity in eval mode."""
    d = tr.Dropout(tr.DROPOUT_RATE).train()
    x = torch.rand(64, 32) + 0.5
    a = d(x, torch.Generator().manual_seed(3))
    b = d(x, torch.Generator().manual_seed(3))
    c = d(x, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert torch.equal(a[kept], 2 * x[kept])
    assert 0.4 < kept.float().mean() < 0.6
    with pytest.raises(ValueError, match="Generator"):
        d(x, None)
    assert torch.equal(d.eval()(x, None), x)


@pytest.mark.parametrize("ignored", [(), (0,)])
def test_masked_weighted_ce_matches_jax(ignored):
    """Loss, accuracy and the logits' gradient, with and without ignored
    labels and their reduce table."""
    rng = np.random.RandomState(1)
    b, n, c = 2, 300, 6
    n_raw = c + len(ignored)
    logits = rng.randn(b, n, c).astype(np.float32)
    labels = rng.randint(0, n_raw, (b, n)).astype(np.int32)
    pseudo = rng.randint(len(ignored), n_raw, (b, n)).astype(np.int32)
    act = (rng.rand(b, n) < 0.6).astype(np.float32)
    weights = (rng.rand(c) + 0.5).astype(np.float32)
    table = jr.label_reduce_table(c, ignored) if ignored else None
    assert np.array_equal(tr.label_reduce_table(c, ignored),
                          jr.label_reduce_table(c, ignored))

    def jloss(lg):
        return jr.masked_weighted_ce(lg, jnp.asarray(pseudo),
                                     jnp.asarray(act), jnp.asarray(labels),
                                     weights, ignored, table)

    (jl, ja), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits))
    lg = t(logits).requires_grad_(True)
    tl, ta = tr.masked_weighted_ce(lg, t(pseudo), t(act), t(labels),
                                   weights, ignored, table)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=CE_RTOL)
    assert abs(float(ta) - float(ja)) < 1e-6
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(jg),
                               rtol=CE_RTOL, atol=CE_ATOL)


def test_adam_under_schedule_matches_optax():
    """Five steps on the same gradients, two steps per epoch, so the
    learning rate decays twice (steps 2 and 4)."""
    rng = np.random.RandomState(2)
    p0 = rng.randn(50).astype(np.float32)
    grads = [rng.randn(50).astype(np.float32) * 10 ** rng.uniform(-3, 1)
             for _ in range(5)]
    cfg = dataclasses.replace(JConfigS3DIS, lr_decay=0.5)
    sched = jt.make_lr_schedule(cfg, 2)
    tx = optax.adam(sched)
    opt_state = tx.init(jnp.asarray(p0))
    jp = jnp.asarray(p0)

    holder = nn.Module()
    holder.w = nn.Parameter(t(p0))
    state = tt.create_train_state(holder, cfg, 2)
    assert [state.schedule(s) for s in range(5)] == \
        [float(sched(s)) for s in range(5)]
    for g in grads:
        upd, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        holder.w.grad = t(g)
        tt.apply_gradients(state)
        np.testing.assert_allclose(holder.w.detach().numpy(), np.asarray(jp),
                                   rtol=ADAM_RTOL, atol=ADAM_ATOL)
    assert state.step == 5


def _batch(seed, b, n, num_classes):
    rng = np.random.RandomState(seed)
    xyz = (rng.rand(b, n, 3) * 4).astype(np.float32)
    return {
        "xyz": xyz,
        "features": np.concatenate(
            [xyz + rng.randn(b, n, 3).astype(np.float32) * 0.01,
             rng.rand(b, n, 3).astype(np.float32)], -1),
        "labels": rng.randint(0, num_classes, (b, n)).astype(np.int32),
        "pseudo": rng.randint(0, num_classes, (b, n)).astype(np.int32),
        "activation": (rng.rand(b, n) < 0.5).astype(np.float32),
    }


def bn_cancelled(key: str) -> bool:
    """A Dense bias that feeds a train-mode BatchNorm: the batch mean takes
    it out again, so its gradient is 0 up to round-off. Adam's first step
    is lr · g / (|g| + eps), so that round-off moves it by anything up to
    lr in either framework, and only that bound can be compared."""
    return key == "fc0.bias" or key.endswith("dense.bias")


def test_train_step_exact_pyramid_matches_jax(monkeypatch):
    """One step of make_train_step on both sides from the same converted
    weights and batch (engine "xla", dropout the identity on both): the
    loss, the gradients, the updated parameters and the BatchNorm
    statistics."""
    cfg = small_cfg(num_points=1024)
    weights = (np.random.RandomState(3).rand(cfg.num_classes) + 0.5).astype(
        np.float32)
    batch = _batch(4, 2, cfg.num_points, cfg.num_classes)
    model = jr.RandLANet(cfg)
    v = jax.jit(lambda x, f: model.init(
        {"params": jax.random.PRNGKey(0)}, f,
        jr.build_pyramid(x, cfg, engine="xla"), False))(
            jnp.asarray(batch["xyz"]), jnp.asarray(batch["features"]))
    v = random_flax_variables(v, seed=5)
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    state = jt.TrainState.create(apply_fn=model.apply, params=v["params"],
                                 batch_stats=v["batch_stats"],
                                 tx=optax.adam(jt.make_lr_schedule(cfg, 10)))
    step = jt.make_train_step(model, cfg, weights, knn_engine="xla")
    new, metrics = step(state, {k: jnp.asarray(x) for k, x in batch.items()},
                        jax.random.PRNGKey(1))
    want = flax_param_dict(new.params, new.batch_stats)

    tm = tr.RandLANet(cfg)
    tm.load_state_dict(tr.params_from_flax(v["params"], v["batch_stats"]))
    tm.dp1 = identity_dropout()
    ts = tt.create_train_state(tm, cfg, 10)
    ts, tmet = tt.make_train_step(tm, cfg, weights, "xla", device="cpu")(
        ts, batch, None)
    np.testing.assert_allclose(float(tmet["loss"]), float(metrics["loss"]),
                               rtol=STEP_RTOL)
    assert abs(float(tmet["accuracy"]) - float(metrics["accuracy"])) < 1e-6
    pyr = jr.build_pyramid(jnp.asarray(batch["xyz"]), cfg, engine="xla")

    def loss_fn(params):
        (logits, _), _ = model.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(batch["features"]), pyr, True,
            mutable=["batch_stats"])
        return jr.masked_weighted_ce(
            logits, jnp.asarray(batch["pseudo"]),
            jnp.asarray(batch["activation"]), jnp.asarray(batch["labels"]),
            weights)[0]

    jgrad = flax_param_dict(jax.jit(jax.grad(loss_fn))(v["params"]),
                            v["batch_stats"])
    before = flax_param_dict(v["params"], v["batch_stats"])
    got = tm.state_dict()
    lr = tt.make_lr_schedule(cfg, 10)(0)
    g_all = max(np.abs(jgrad[k]).max() for k, _ in tm.named_parameters())
    for k, p in tm.named_parameters():
        g, w = p.grad.numpy(), jgrad[k]
        if bn_cancelled(k):
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-6 * g_all, k
            for side in (got[k].numpy(), want[k]):
                assert np.abs(side - before[k]).max() <= lr * (1 + 1e-5), k
            continue
        dg = GRAD_TOL * np.abs(w).max()
        assert np.abs(g - w).max() <= dg, k
        # what dg allows through Adam's first step lr · g / (|g| + eps)
        step_bound = lr * np.minimum(
            2.0, dg / (np.maximum(np.abs(w) - dg, 0) + tt.ADAM_EPS))
        assert np.all(np.abs(got[k].numpy() - want[k])
                      <= step_bound + 1e-6 * np.abs(want[k])), k
    for k in ("running_mean", "running_var"):
        for name in [n for n in want if n.endswith(k)]:
            np.testing.assert_allclose(got[name].numpy(), want[name],
                                       rtol=STEP_RTOL, atol=STEP_ATOL,
                                       err_msg=name)
