"""The KNN engines of ssdr_al_torch against ssdr_al_tpu on the CPU: Hilbert
codes, sorted clouds and the hilbert-sorted pyramids, the exact tiled
search (K6's plain version against knn_pallas), the centred-product window
search (K5's plain version against _knn_window_kernel_mxu), non-self-query
window starts (the jnp.median trap), the "window_og", "pallas" and
"approx" (K6) pyramids and one eval step on the "pallas" engine. JAX runs its
Pallas kernels in interpret mode."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdr_al_tpu.models import randlanet as jr
from ssdr_al_tpu.train import trainer as jt
from ssdr_al_torch.models import randlanet as tr
from ssdr_al_torch.ops import knn as tk
from ssdr_al_torch.train import trainer as tt
from torch_parity import (
    NEAR_TIE_REL,
    assert_near_ties,
    interpret,
    random_flax_variables,
    small_cfg,
    t,
)

jk = importlib.import_module("ssdr_al_tpu.ops.knn")

torch.set_num_threads(1)

# exact engines on both sides: the pyramids' matmul-form distances
# (knn_xla) round differently from the difference form by ~ε·|x|², so a
# swap is accepted only between candidates within this relative d²
EXACT_TIE_REL = 1e-3
# eval step on identical pyramids (test_torch_model.py's tolerance): f32
# everywhere, only the matmuls' summation order differs
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-5


def _cloud(seed, n, b=1, scale=6.0):
    return (np.random.RandomState(seed).rand(b, n, 3) * scale).astype(
        np.float32)


def _box(*clouds):
    lo = np.minimum.reduce([c.min(0) for c in clouds])
    hi = np.maximum.reduce([c.max(0) for c in clouds])
    return lo, hi


# ------------------------------------------------------------- curves ---


@pytest.mark.parametrize("seed", [0, 1])
def test_hilbert_codes_equal(seed):
    xyz = _cloud(seed, 4096, scale=1.0 + 5.0 * seed)[0]
    lo, hi = _box(xyz)
    want = np.asarray(jk.hilbert_codes(jnp.asarray(xyz), jnp.asarray(lo),
                                       jnp.asarray(hi)))
    got = tk.hilbert_codes(t(xyz), t(lo), t(hi)).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(tk.CURVES) == set(jk.CURVES)


@pytest.mark.parametrize("curve", ["morton", "hilbert"])
def test_sort_cloud_matches_jax(curve):
    """sort_cloud along either curve: codes, order and rows equal to JAX's,
    padded to a multiple of 128 rows with the sentinel."""
    xyz = _cloud(5, 1000)[0]
    lo, hi = _box(xyz)
    want = jk.sort_cloud(jnp.asarray(xyz), jnp.asarray(lo), jnp.asarray(hi),
                         curve=curve)
    got = tk.sort_cloud(t(xyz)[None], t(lo)[None, None], t(hi)[None, None],
                        curve=curve)
    np.testing.assert_array_equal(got.codes_sorted[0].numpy(),
                                  np.asarray(want.codes_sorted))
    np.testing.assert_array_equal(got.order[0].numpy(), np.asarray(want.order))
    np.testing.assert_array_equal(got.xyz_sorted[0].numpy(),
                                  np.asarray(want.xyz_sorted))
    assert got.xyz_sorted.shape[1] == 1024 and got.n_real == 1000
    assert (got.xyz_sorted[0, 1000:] == tk.SENTINEL).all()


def test_hilbert_sorted_pyramid_matches_jax():
    """Config.curve="hilbert": JAX's _pyramid_window_sorted_single sorts
    along the Hilbert curve, and so does the port's sorted pyramid (order
    and inv equal; the neighbourhoods up to the K1 near-tie rule)."""
    n = 8192
    cfg = small_cfg(num_points=n, curve="hilbert")
    xyz = _cloud(6, n, scale=4.0)
    with interpret():
        want = jax.jit(jax.vmap(
            lambda x: jr._pyramid_window_sorted_single(x, cfg)))(
                jnp.asarray(xyz))
    got = tr.build_pyramid(t(xyz), cfg, engine="window")
    morton = tr.build_pyramid(t(xyz), small_cfg(num_points=n),
                              engine="window")
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    np.testing.assert_array_equal(got.inv.numpy(), np.asarray(want.inv))
    assert not torch.equal(got.order, morton.order)
    assert got.windows == tuple(want.windows)
    for i in range(cfg.num_layers):
        x = np.asarray(want.xyz[i][0])
        np.testing.assert_array_equal(got.xyz[i][0].numpy(), x)
        if want.starts[i] is not None:
            np.testing.assert_array_equal(got.starts[i].numpy(),
                                          np.asarray(want.starts[i]))
        assert_near_ties(x, x, got.neigh_idx[i][0].numpy(),
                         np.asarray(want.neigh_idx[i][0]))
        if i + 1 < cfg.num_layers:
            nxt = np.asarray(want.xyz[i + 1][0])
            assert_near_ties(x, nxt, got.interp_idx[i][0].numpy(),
                             np.asarray(want.interp_idx[i][0]))


# -------------------------------------------------------- exact (K6) ---


@pytest.mark.parametrize("ns,nq,k,tile_q,tile_s", [
    (512, 256, 16, 128, 256), (512, 256, 16, 256, 512),
    (300, 130, 8, 256, 512)])
def test_knn_tiled_plain_matches_knn_pallas(ns, nq, k, tile_q, tile_s):
    """K6's plain version equals knn_pallas index for index, padded tiles
    included, and both equal a (d², index) lexsort."""
    rng = np.random.RandomState(7)
    s = rng.randn(2, ns, 3).astype(np.float32)
    q = rng.randn(2, nq, 3).astype(np.float32)
    with interpret():
        want = np.asarray(jk.knn_pallas(s, q, k, tile_q=tile_q,
                                        tile_s=tile_s))
    got = tk.knn_tiled(t(s), t(q), k).numpy()
    np.testing.assert_array_equal(got, want)
    d2 = ((q[0][:, None, :] - s[0][None]) ** 2).sum(-1)
    lex = np.lexsort((np.broadcast_to(np.arange(ns), d2.shape), d2))
    assert (lex[:, :k] == got[0]).mean() > 0.999


def test_knn_tiled_fewer_support_than_k():
    """Ns < k: the first Ns slots are the whole support by distance, the
    rest index 0, as in the TPU kernel."""
    rng = np.random.RandomState(8)
    s = rng.randn(2, 5, 3).astype(np.float32)
    q = rng.randn(2, 40, 3).astype(np.float32)
    with interpret():
        want = np.asarray(jk.knn_pallas(s, q, 16))
    got = tk.knn_tiled(t(s), t(q), 16).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[..., 5:] == 0).all()
    assert (np.sort(got[..., :5], -1) == np.arange(5)).all()


def test_knn_tiled_ties_to_lower_index():
    """Duplicated support points tie exactly: the lower index comes first,
    on both sides."""
    rng = np.random.RandomState(9)
    base = rng.randn(1, 100, 3).astype(np.float32)
    s = np.concatenate([base, base, base[:, :28]], axis=1)     # [1, 228, 3]
    q = np.concatenate([base[:, :64], rng.randn(1, 64, 3).astype(
        np.float32)], axis=1)
    with interpret():
        want = np.asarray(jk.knn_pallas(s, q, 16))
    got = tk.knn_tiled(t(s), t(q), 16).numpy()
    np.testing.assert_array_equal(got, want)
    # query r < 64 is support row r: itself first, then its copy r + 100
    np.testing.assert_array_equal(got[0, :28, 0], np.arange(28))
    np.testing.assert_array_equal(got[0, :28, 1], np.arange(28) + 100)
    np.testing.assert_array_equal(got[0, :28, 2], np.arange(28) + 200)


def test_knn_tiled_refuses_non_cpu_tensors():
    """A tensor that is not on the CPU never takes the plain version."""
    x = torch.zeros(1, 256, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tk.knn_tiled(x, x, 16)


# ----------------------------------------------- window search (K5) ---


@pytest.mark.parametrize("k", [16, 1])
def test_window_topk_mxu_plain_matches_tpu_kernel(k):
    """K5's plain version against _run_window_pallas(mxu=True) at n=2048,
    W=1024: the same indices except where the two candidates' d² agree to
    within 2⁻¹¹ relative (the TPU kernel packs the index into d²'s low 12
    mantissa bits), on at most 1 % of entries."""
    n, w = 2048, 1024
    xyz = _cloud(3, n)[0]
    lo, hi = _box(xyz)
    codes = jk.morton_codes(jnp.asarray(xyz), jnp.asarray(lo), jnp.asarray(hi))
    _, _, xs = jk.sort_by_codes(codes, jnp.asarray(xyz))
    xs = np.asarray(xs)
    starts = tk.self_query_starts(n, n, w)
    with interpret():
        want = np.asarray(jk._run_window_pallas(
            jnp.asarray(xs), jnp.asarray(xs), jnp.asarray(starts.numpy()),
            k, 256, w, mxu=True))
    got = tk.window_topk(t(xs)[None], t(xs)[None], starts[None], k, w,
                         mxu=True)[0].numpy()
    base = np.repeat(starts.numpy(), 256)[:, None]
    assert_near_ties(xs, xs, got + base, want + base)
    # the module default is K1, as JAX's _MXU_DISTANCE_DEFAULT
    assert tk.MXU_DISTANCE_DEFAULT is jk._MXU_DISTANCE_DEFAULT is False
    k1 = tk.window_topk(t(xs)[None], t(xs)[None], starts[None], k, w)[0]
    assert_near_ties(xs, xs, got + base, k1.numpy() + base)


# ------------------------------------------------ non-self-query starts ---


def test_median_floor_is_jnp_median():
    """Even-length rows: the truncated mean of the two middle values, not
    torch.median's lower middle value."""
    rng = np.random.RandomState(10)
    x = rng.randint(0, 5000, (50, 256)).astype(np.int32)
    want = np.asarray(jnp.median(jnp.asarray(x), axis=1).astype(jnp.int32))
    got = tk.median_floor(t(x).long()).numpy()
    np.testing.assert_array_equal(got, want)
    assert (torch.median(t(x), dim=1).values.numpy() != want).any()
    np.testing.assert_array_equal(tk.median_floor(t(x[:, :255])).numpy(),
                                  np.median(x[:, :255], axis=1))


@pytest.mark.parametrize("clustered", [False, True])
def test_knn_window_sorted_non_self_query_matches_jax(clustered):
    """Upsample-style search (queries ≠ support): the searchsorted ranks,
    the per-tile median and the starts are equal; the neighbours, in sorted
    and in original order, equal up to the K1 near-tie rule. clustered: one tile of queries in two far clusters,
    so its two middle ranks differ by ~the whole support and torch.median's
    lower middle value would give another start."""
    rng = np.random.RandomState(11)
    sup = (rng.rand(3000, 3) * 6).astype(np.float32)
    if clustered:
        qry = np.concatenate([rng.rand(128, 3) * 0.5,
                              5.5 + rng.rand(128, 3) * 0.5]).astype(
                                  np.float32)
    else:
        qry = (rng.rand(2600, 3) * 6).astype(np.float32)
    lo, hi = _box(sup, qry)
    with interpret():
        ss = jk.sort_cloud(jnp.asarray(sup), jnp.asarray(lo), jnp.asarray(hi))
        qs = jk.sort_cloud(jnp.asarray(qry), jnp.asarray(lo), jnp.asarray(hi))
        want_raw, want_st = jk.knn_window_sorted_raw(ss, qs, 1, window=1024)
        want = jk.knn_window_sorted(ss, qs, 1, window=1024)
    lo_t, hi_t = t(lo)[None, None], t(hi)[None, None]
    s_c = tk.sort_cloud(t(sup)[None], lo_t, hi_t)
    q_c = tk.sort_cloud(t(qry)[None], lo_t, hi_t)
    got_raw, got_st = tk.knn_window_sorted_raw(s_c, q_c, 1, window=1024)
    np.testing.assert_array_equal(got_st[0].numpy(), np.asarray(want_st))
    assert_near_ties(q_c.xyz_sorted[0].numpy(),
                     s_c.xyz_sorted[0, :len(sup)].numpy(),
                     got_raw[0].numpy(), np.asarray(want_raw))
    got = tk.knn_window_sorted(s_c, q_c, 1, window=1024)
    assert_near_ties(qry, sup, got[0].numpy(), np.asarray(want))
    if clustered:
        pos = torch.searchsorted(s_c.codes_sorted, q_c.codes_sorted)
        lower = torch.median(pos.reshape(1, -1, 256), dim=-1).values
        lower = (torch.clamp(lower - 512, 0, s_c.xyz_sorted.shape[1] - 1024)
                 // 128) * 128
        assert (lower != got_st).all()


def test_knn_dispatcher():
    """"approx" is K6's search (equal to "pallas"), which equals the
    matmul-form "xla" up to its ties; "window" is knn_window
    (tests/test_torch_knn_window.py); "kd" is no engine."""
    s, q = t(_cloud(13, 700, b=2)), t(_cloud(14, 300, b=2))
    exact = tk.knn(s, q, 16)
    pallas = tk.knn(s, q, 16, engine="pallas")
    assert torch.equal(tk.knn(s, q, 16, engine="approx"), pallas)
    for b in range(2):
        assert_near_ties(q[b].numpy(), s[b].numpy(), pallas[b].numpy(),
                         exact[b].numpy(), rel=EXACT_TIE_REL, max_frac=1e-3)
    assert torch.equal(tk.knn(s, q, 16, engine="window", window=512),
                       tk.knn_window(s, q, 16, window=512))
    with pytest.raises(ValueError, match="unknown knn engine"):
        tk.knn(s, q, 16, engine="kd")


@pytest.mark.parametrize("engine,kw", [
    ("xla", dict(query_chunk=128, support_chunk=256)),
    ("approx", dict(query_chunk=128, recall_target=0.9)),
    ("pallas", dict(tile_q=128, tile_s=256))])
def test_knn_engine_takes_jax_keywords(engine, kw):
    """Each engine takes the keywords JAX's takes (its TPU tiles and
    recall target, which the port ignores): the answer equals the call
    without them, and JAX's knn with the same keywords up to ties."""
    s, q = _cloud(16, 700), _cloud(17, 300)
    got = tk.knn(t(s), t(q), 16, engine=engine, **kw)
    assert torch.equal(got, tk.knn(t(s), t(q), 16, engine=engine))
    with interpret():
        want = np.asarray(jk.knn(jnp.asarray(s), jnp.asarray(q), 16,
                                 engine=engine, **kw))
    assert_near_ties(q[0], s[0], got[0].numpy(), want[0],
                     rel=EXACT_TIE_REL, max_frac=1e-3)


# ----------------------------------------------------------- pyramids ---


def _assert_pyramids_close(got, want, cfg, rel):
    for i in range(cfg.num_layers):
        np.testing.assert_array_equal(got.xyz[i].numpy(),
                                      np.asarray(want.xyz[i]))
        for b in range(got.xyz[i].shape[0]):
            x = np.asarray(want.xyz[i][b])
            sub = x[: got.sub_idx[i].shape[1]]
            for f, qx, sx in (("neigh_idx", x, x), ("sub_idx", sub, x),
                              ("interp_idx", x, sub)):
                assert_near_ties(qx, sx, getattr(got, f)[i][b].numpy(),
                                 np.asarray(getattr(want, f)[i][b]), rel=rel)


def test_window_og_pyramid_matches_jax():
    """engine "window_og" against JAX's _pyramid_window_single (vmapped):
    at N=8192 with ratios (2, 4, 2) layer 0 takes the window self-search
    (W=2048) and the non-self-query window upsample (W=1024), layers 1-2
    knn_xla; every index up to the K1 near-tie rule."""
    cfg = small_cfg(num_points=8192, sub_sampling_ratio=(2, 4, 2))
    xyz = _cloud(15, 8192, b=2, scale=4.0)
    with interpret():
        want = jax.jit(jax.vmap(lambda x: jr._pyramid_window_single(x, cfg)))(
            jnp.asarray(xyz))
    got = tr.build_pyramid(t(xyz), cfg, engine="window_og")
    assert isinstance(got, tr.Pyramid)
    _assert_pyramids_close(got, want, cfg, NEAR_TIE_REL)


def test_window_og_pyramid_follows_curve(monkeypatch):
    """Config.curve="hilbert" sorts the window_og layers along the Hilbert
    curve. JAX's window_og reads only its module default, which stands in
    here for the curve setting; every index up to the K1 near-tie rule."""
    cfg = small_cfg(num_points=8192, sub_sampling_ratio=(2, 4, 2),
                    curve="hilbert")
    xyz = _cloud(18, 8192, scale=4.0)
    monkeypatch.setattr(jk, "DEFAULT_CURVE", "hilbert")
    with interpret():
        want = jax.jit(jax.vmap(lambda x: jr._pyramid_window_single(x, cfg)))(
            jnp.asarray(xyz))
    got = tr.build_pyramid(t(xyz), cfg, engine="window_og")
    _assert_pyramids_close(got, want, cfg, NEAR_TIE_REL)
    # the window search is approximate, so another curve finds other
    # neighbours somewhere
    morton = tr.build_pyramid(t(xyz), dataclasses.replace(cfg, curve="morton"),
                              engine="window_og")
    assert not torch.equal(got.neigh_idx[0], morton.neigh_idx[0])


@pytest.mark.parametrize("engine", ["pallas", "approx"])
def test_exact_engine_pyramids_match_jax(engine):
    """The generic pyramid: "pallas" (knn_pallas in interpret mode against
    K6's plain version, equal) and "approx" (JAX's approx_min_k, exact on
    the CPU, against the port's K6, whose plain version runs here)."""
    cfg = small_cfg(num_points=1024)
    xyz = _cloud(16, 1024, b=2, scale=4.0)
    with interpret():
        want = jr.build_pyramid(jnp.asarray(xyz), cfg, engine=engine)
    got = tr.build_pyramid(t(xyz), cfg, engine=engine)
    if engine == "pallas":
        for f in ("neigh_idx", "sub_idx", "interp_idx"):
            for i in range(cfg.num_layers):
                np.testing.assert_array_equal(getattr(got, f)[i].numpy(),
                                              np.asarray(getattr(want, f)[i]))
    else:
        _assert_pyramids_close(got, want, cfg, EXACT_TIE_REL)


def test_eval_step_pallas_engine_matches_jax():
    """One eval step with engine "pallas" on each side, same converted
    weights: probs and penult within test_torch_model.py's tolerance."""
    cfg = small_cfg(num_points=1024)
    rng = np.random.RandomState(17)
    xyz = (rng.rand(2, 1024, 3) * 4).astype(np.float32)
    batch = {"xyz": xyz, "features": np.concatenate(
        [xyz, rng.rand(2, 1024, 3).astype(np.float32)], -1)}
    model = jr.RandLANet(cfg)
    state = jt.create_train_state(model, cfg, jax.random.PRNGKey(0),
                                  batch, 500)
    v = random_flax_variables({"params": state.params,
                               "batch_stats": state.batch_stats}, seed=4)
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"])
    with interpret():
        probs, penult = jt.make_eval_step(model, cfg, "pallas")(state, batch)
    sd = tr.params_from_flax(v["params"], v["batch_stats"])
    got_p, got_f = tt.make_eval_step(tr.RandLANet(cfg), cfg, "pallas", False,
                                     device="cpu")(sd, batch)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(probs),
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    # penult sums terms up to max|penult| in another order: the absolute
    # error scales with that magnitude (measured 2.8e-5 at max|penult| = 16.8)
    penult = np.asarray(penult)
    np.testing.assert_allclose(got_f.numpy(), penult, rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL * np.abs(penult).max())
