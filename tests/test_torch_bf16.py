"""--compute_dtype bfloat16 in ssdr_al_torch against ssdr_al_tpu on the CPU:
K2's bf16 output and K4's bf16 cotangent (their plain versions) bit for
bit against JAX's gather_window and its VJP with the TPU kernel in
interpret mode; the bf16 RandLA-Net forward and one train-mode gradient
against JAX's bf16 model on the same sorted pyramid and weights, held
within JAX's own bf16-vs-f32 gap; the launch plans and a numpy twin of
K2's bf16 store units; the flag through cli.common."""

import dataclasses
import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ssdr_al_tpu.models import randlanet as jr
from ssdr_al_torch.cli import common as t_common
from ssdr_al_torch.models import randlanet as tr
from ssdr_al_torch.ops import gather as tg
from torch_parity import (
    flax_param_dict,
    identity_dropout,
    interpret,
    random_flax_variables,
    small_cfg,
    t,
    to_torch_pyramid,
    windowed,
)

jg = importlib.import_module("ssdr_al_tpu.ops.gather")
torch.set_num_threads(1)
BF16 = torch.bfloat16
N = 8192                     # the smallest block that takes the sorted path


def _bits(x):
    """bf16 values as their 16-bit patterns (numpy uint16)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


# ------------------------------------------------------------ K2 / K4 ---

@pytest.mark.parametrize("c,window,tq", [(11, 1024, 128), (16, 1024, 512),
                                         (35, 2048, 128)])
def test_k2_bf16_plain_bitwise_equals_tpu_kernel(c, window, tq):
    """The TPU gather rounds each value to bf16 and stores bf16 (channels
    padded as the JAX model pads them); the port's K2-bf16 plain version
    gives the same bits, zero rows outside the window included."""
    b, n, k = 2, 4096, 16
    vals, idx, starts = windowed(c, b, n, c, k, window, tq)
    idx[0, 3, 1] = starts[0, 0] + window + 5     # outside: a zero row
    with interpret():
        v_pad, c0 = jg.pad_channels(jnp.asarray(vals), k=k)
        want = jg.gather_window(v_pad, jnp.asarray(idx), jnp.asarray(starts),
                                window, tq)[..., :c0]
    assert want.dtype == jnp.bfloat16
    got = tg.gather_window(t(vals), t(idx), t(starts), window, tq, BF16)
    assert got.dtype == BF16
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not got[0, 3, 1].any()


@pytest.mark.parametrize("c,window,tq", [(11, 1024, 512), (32, 2048, 128)])
def test_k4_bf16_plain_bitwise_equals_jax_vjp(c, window, tq):
    """The VJP of JAX's gather_window (TPU kernel forward in interpret
    mode, its CPU backward: the bf16 cotangent cast to f32 and
    scatter-added) against the port's backward through K4-bf16's plain
    version (index_add_ of g.float()): the same f32 dv, bit for bit."""
    b, n, k = 2, 2048, 16
    vals, idx, starts = windowed(c + 1, b, n, c, k, window, tq)
    cot = np.random.RandomState(c).randn(b, n, k, c).astype(
        ml_dtypes.bfloat16)
    with interpret():
        def f(v):
            v_pad, c0 = jg.pad_channels(v, k=k)
            return jg.gather_window(v_pad, jnp.asarray(idx),
                                    jnp.asarray(starts), window, tq)[..., :c0]

        _, vjp = jax.vjp(f, jnp.asarray(vals))
        (want,) = vjp(jnp.asarray(cot))
    v = t(vals).requires_grad_(True)
    out = tg.gather_window(v, t(idx), t(starts), window, tq, BF16)
    g = torch.from_numpy(cot.view(np.int16)).view(BF16)
    out.backward(g)
    assert v.grad.dtype == torch.float32
    np.testing.assert_array_equal(v.grad.numpy(), np.asarray(want))
    plain = tg.scatter_window(g, t(idx), t(starts), n, window, tq)
    assert torch.equal(plain, v.grad)


def test_bf16_plans():
    """K2-bf16 stores 16-byte units of 8 where rows·c % 8 == 0, else 8-byte
    units of 4; f32 keeps float4s. K4's group covers a bf16 row's 16-byte
    units (c/8), or its 8-byte units (c/4) where c % 8 != 0, or its spans
    of 8 channels where c % 4 != 0 (one lane a row at 8 channels, at most
    4 lanes a row); f32
    rows keep float4s, or single floats at 4 or 32 lanes."""
    plan = tg.gather_plan
    assert plan(8, 40960, 16, 11, 2048, 512, out_dtype=BF16) == \
        (False, 2048, 256, 8)
    assert plan(8, 40960, 16, 8, 2048, 512, out_dtype=BF16) == \
        (True, 8192, 1024, 8)
    assert plan(1, 8, 1, 5, 8, 4, slab=False, out_dtype=BF16)[3] == 4
    assert plan(1, 8, 1, 5, 8, 4, slab=False)[3] == 4
    with pytest.raises(TypeError, match="dtype"):
        plan(1, 8, 1, 5, 8, 4, out_dtype=torch.float16)
    sp = tg.scatter_plan
    for c, f32, bf16 in ((8, 2, 1), (11, 4, 2), (32, 8, 4), (35, 32, 4),
                         (64, 16, 8), (128, 32, 16), (256, 32, 32),
                         (12, 4, 4), (20, 8, 8), (67, 32, 4)):
        assert sp(6, 4096, 4096, 16, c, 1024, 512)[0] == f32, c
        assert sp(6, 4096, 4096, 16, c, 1024, 512, BF16)[0] == bf16, c


def _k2_unit_twin(values, idx, starts, window, tq, rows, unit):
    """numpy twin of K2's index arithmetic with U-value store units: CTA
    (b, tile, part) writes rows [part·rows, (part+1)·rows) of its tile; a
    unit at value p of the span starts in row umulhi(p, ceil(2^32 / c)) and
    steps the channel, moving to the next row each time it reaches c."""
    b, n, c = values.shape
    nq, k = idx.shape[1:]
    magic = np.uint64(0xFFFFFFFF // c + 1)
    out = np.full(b * nq * k * c, np.nan, np.float32)
    flat_idx = idx.reshape(-1)
    for bb in range(b):
        for tt in range(nq // tq):
            lo = min(max(int(starts[bb, tt]), 0), n - window)
            win = values[bb, lo:lo + window].reshape(-1)
            for part in range(tq * k // rows):
                row0 = (bb * nq + tt * tq) * k + part * rows
                p = np.arange(0, rows * c, unit, dtype=np.uint64)
                r = ((p * magic) >> np.uint64(32)).astype(np.int64) \
                    if c > 1 else p.astype(np.int64)
                ch = p.astype(np.int64) - r * c
                for j in range(unit):
                    cc = ch + j
                    rr = r + cc // c                # c < unit: several rows
                    cc = cc % c
                    i = flat_idx[row0 + rr] - lo
                    inside = (i >= 0) & (i < window)
                    v = np.where(inside, win[np.clip(i, 0, window - 1) * c
                                             + cc], np.float32(0.0))
                    out[row0 * c + p.astype(np.int64) + j] = v
    return out.reshape(b, nq, k, c)


@pytest.mark.parametrize("c", [1, 3, 8, 11, 35])
def test_k2_bf16_unit_arithmetic_equals_plain(c):
    """Both bf16 units (8 values where rows·c % 8 == 0, else 4) cover the
    output exactly and read the plain gather's values, with c below the
    unit (a unit spanning several rows) and clamped starts."""
    rng = np.random.RandomState(c)
    b, n, k, tq, window = 2, 512, 2, 4, 128
    vals = rng.randn(b, n, c).astype(np.float32)
    starts = rng.randint(-64, n, (b, n // tq)).astype(np.int32)
    lo = np.clip(starts, 0, n - window)
    idx = (np.repeat(lo, tq, 1)[..., None]
           + rng.randint(-8, window + 8, (b, n, k))).astype(np.int32)
    idx = np.clip(idx, 0, n - 1)
    want = tg._gather_window_plain(t(vals), t(idx), t(starts), window,
                                   tq).numpy()
    for rows in (tq * k, 4):
        unit = 8 if rows * c % 8 == 0 else 4
        if rows * c % unit:
            continue
        np.testing.assert_array_equal(
            _k2_unit_twin(vals, idx, starts, window, tq, rows, unit), want)


# ------------------------------------------------------------- model ---

@pytest.fixture(scope="module")
def jax_bf16():
    """One cloud of 8192 points: JAX's sorted pyramid (TPU kernels in
    interpret mode) and, on it, the f32 and bf16 forwards and train-mode
    gradients of the same weights (dropout off)."""
    cfg = small_cfg(num_points=N)
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    rng = np.random.RandomState(3)
    xyz = (rng.rand(1, N, 3) * 4).astype(np.float32)
    feats = np.concatenate([xyz, rng.rand(1, N, 3).astype(np.float32)], -1)
    labels = rng.randint(0, cfg.num_classes, (1, N)).astype(np.int32)
    act = (rng.rand(1, N) < 0.5).astype(np.float32)
    weights = (rng.rand(cfg.num_classes) + 0.5).astype(np.float32)
    m32, m16 = jr.RandLANet(cfg), jr.RandLANet(cfg16)
    v = jax.jit(lambda x, f: m32.init(
        {"params": jax.random.PRNGKey(0)}, f,
        jr.build_pyramid(x, cfg, engine="xla"), False))(
            jnp.asarray(xyz[:, :1024]), jnp.asarray(feats[:, :1024]))
    v = random_flax_variables(v, seed=2)
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        with interpret():
            pyr = jax.jit(jax.vmap(
                lambda one: jr._pyramid_window_sorted_single(one, cfg)))(
                    jnp.asarray(xyz))
            order = pyr.order
            take = lambda a: jnp.take_along_axis(  # noqa: E731
                jnp.asarray(a), order, axis=1)
            for name, m in (("f32", m32), ("bf16", m16)):
                logits, _ = jax.jit(m.apply)(v, jnp.asarray(feats), pyr)

                def loss_fn(params, m=m):
                    (lg, _), _ = m.apply(
                        {"params": params, "batch_stats": v["batch_stats"]},
                        jnp.asarray(feats), pyr, True, unsort=False,
                        mutable=["batch_stats"])
                    return jr.masked_weighted_ce(
                        lg, take(labels), take(act), take(labels),
                        weights)[0]

                loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
                    v["params"])
                out[name] = dict(logits=np.asarray(logits), loss=float(loss),
                                 grads=flax_param_dict(grads,
                                                       v["batch_stats"]))
    finally:
        mp.undo()
    return dict(cfg16=cfg16, v=v, pyr=pyr, feats=feats, labels=labels,
                act=act, weights=weights, **out)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _port_model(js):
    tm = tr.RandLANet(js["cfg16"])
    tm.load_state_dict(tr.params_from_flax(js["v"]["params"],
                                           js["v"]["batch_stats"]))
    return tm


def test_bf16_forward_within_jax_bf16_gap(jax_bf16):
    """The port's bf16 forward on JAX's pyramid is no further from JAX's
    bf16 forward than that is from JAX's f32 forward: relative L2 of the
    logits and class disagreement (measured on this block: port 0.78 %
    and 0.71 %, JAX's own gap 1.34 % and 1.51 %)."""
    js = jax_bf16
    tm = _port_model(js).eval()
    with torch.inference_mode():
        logits, penult = tm(t(js["feats"]), to_torch_pyramid(js["pyr"]))
    assert logits.dtype == penult.dtype == torch.float32
    got, l16, l32 = logits.numpy(), js["bf16"]["logits"], js["f32"]["logits"]
    gap_rel, rel = _rel(l16, l32), _rel(got, l16)
    gap_cls = float((l16.argmax(-1) != l32.argmax(-1)).mean())
    cls = float((got.argmax(-1) != l16.argmax(-1)).mean())
    print(f"bf16 forward: port vs JAX bf16 rel {rel:.4f}, class "
          f"disagreement {cls:.4f}; JAX bf16 vs f32 rel {gap_rel:.4f}, "
          f"{gap_cls:.4f}")
    assert 0 < gap_rel and rel <= gap_rel
    assert cls <= gap_cls


def test_bf16_train_gradient_within_jax_bf16_gap(jax_bf16):
    """One train step of the port's bf16 model (make_train_step on JAX's
    pyramid, dropout off): its loss and its gradient, all parameters as one
    vector, no further from JAX's bf16 step than JAX's bf16 step is from
    its f32 step (measured: loss 9.1e-5 against 2.9e-4 apart, gradient
    5.4 % against 7.2 %). The parameters and Adam's moments stay f32."""
    from ssdr_al_torch.train import trainer as tt

    js = jax_bf16
    tm = _port_model(js)
    tm.dp1 = identity_dropout()
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tt, "build_pyramid",
                   lambda x, c, engine: to_torch_pyramid(js["pyr"]))
        ts = tt.create_train_state(tm, js["cfg16"], 10)
        batch = {"xyz": js["feats"][..., :3], "features": js["feats"],
                 "labels": js["labels"], "pseudo": js["labels"],
                 "activation": js["act"]}
        _, met = tt.make_train_step(tm, js["cfg16"], js["weights"], "window",
                                    device="cpu")(ts, batch, None)
    finally:
        mp.undo()
    keys = [k for k, _ in tm.named_parameters()]
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(s["exp_avg"].dtype == torch.float32
               for s in ts.optimizer.state.values())
    g16, g32 = js["bf16"]["grads"], js["f32"]["grads"]
    got = np.concatenate([p.grad.numpy().ravel()
                          for _, p in tm.named_parameters()])
    want = np.concatenate([g16[k].ravel() for k in keys])
    ref = np.concatenate([g32[k].ravel() for k in keys])
    loss = float(met["loss"])
    l16, l32 = js["bf16"]["loss"], js["f32"]["loss"]
    print(f"bf16 step: loss {loss:.6f} vs JAX bf16 {l16:.6f} (f32 "
          f"{l32:.6f}); gradient rel L2 vs JAX bf16 {_rel(got, want):.4f}, "
          f"JAX bf16 vs f32 {_rel(want, ref):.4f}")
    assert abs(loss - l16) <= abs(l16 - l32)
    assert _rel(got, want) <= _rel(want, ref)


def test_compute_dtype_flag_sets_the_model(tmp_path):
    """--compute_dtype bfloat16 reaches Config.compute_dtype and the model
    runs its layers in bf16 with f32 parameters; '' keeps float32."""
    from test_torch_cli import make_args

    for flag, want in (("bfloat16", "bfloat16"), ("", "float32")):
        exp = t_common.setup_experiment(make_args(tmp_path,
                                                  compute_dtype=flag))
        assert exp.cfg.compute_dtype == want
        model = tr.RandLANet(exp.cfg)
        assert model.dtype == tr.COMPUTE_DTYPES[want]
        assert model.fc1.dtype == model.dtype
        assert all(p.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(ValueError, match="compute_dtype"):
        tr.RandLANet(dataclasses.replace(exp.cfg, compute_dtype="float16"))
