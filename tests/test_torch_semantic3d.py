"""The port's Semantic3D and SemanticKITTI paths against the JAX package on
the CPU: the configs and class weights, the ignored label, the segment
reductions, the possibility-scheduled host pipeline, the possibility
pool's schedule, a 4-layer SemanticKITTI-shaped forward, and the AL loop
with --dataset semantic3d on the possibility pool."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdr_al_tpu import config as j_config
from ssdr_al_tpu.data import dataset as j_dataset
from ssdr_al_tpu.data.synthetic import make_dataset
from ssdr_al_tpu.models import randlanet as jr
from ssdr_al_tpu.ops import segment as j_segment
from ssdr_al_tpu.train import possibility_pool as jpp
from ssdr_al_torch import config as t_config
from ssdr_al_torch.cli import al_loop, seed
from ssdr_al_torch.cli.common import setup_experiment, write_grid_superpoints
from ssdr_al_torch.data import dataset as t_dataset
from ssdr_al_torch.data.cloud import Cloud
from ssdr_al_torch.models import randlanet as tr
from ssdr_al_torch.ops import segment as t_segment
from ssdr_al_torch.train import trainer as tt
from ssdr_al_torch.train.possibility_pool import (
    PossibilityDevicePool,
    possibility_extract,
)
from test_torch_cli import make_args
from test_torch_device_pool import both, exact_clouds
from torch_parity import (
    assert_near_ties,
    interpret,
    random_flax_variables,
    sorted_d2,
    t,
    to_torch_pyramid,
)

torch.set_num_threads(1)

# the possibility field against JAX's (tests/test_possibility_pool.py's
# tolerance against its numpy oracle): the same f32 arithmetic, picks
# that differ only by the two frameworks' N(0, 1e-7) jitter draws
FIELD_RTOL, FIELD_ATOL = 1e-3, 1e-5
# 4-layer forward, same pyramid arrays and weights (tests/
# test_torch_model.py's bounds): exact engine, then the sorted engine
# against the TPU kernels' bf16 gathers
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-5
# the exact engine's dense-product d² = |q|² + |s|² − 2 q·s carries an
# absolute f32 error of a few ulps of |q|² + |s|² (≤ 96 in a 4 m cube):
# neighbour indices may differ only between candidates this close
D2_ATOL = 8 * 2.0 ** -24 * 96
CLASS_AGREEMENT, PENULT_REL_ERR = 0.99, 1e-2

J_TINY = dataclasses.replace(
    j_config.ConfigSemantic3D, num_points=512, d_out=(4, 8, 8, 8, 8),
    num_classes=3, ignored_label_inds=(), batch_size=2, noise_init=1e-6)
TINY = dataclasses.replace(
    t_config.ConfigSemantic3D, num_points=512, d_out=(4, 8, 8, 8, 8),
    num_classes=3, ignored_label_inds=(), batch_size=2, noise_init=1e-6)


@pytest.mark.parametrize("name", ["Semantic3D", "SemanticKITTI"])
def test_config_and_class_weights_match_jax(name):
    got, want = t_config.get_config(name), j_config.get_config(name)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert t_config.CLASS_COUNTS[name] == tuple(j_config.CLASS_COUNTS[name])
    np.testing.assert_array_equal(t_config.class_weights(name),
                                  j_config.class_weights(name))
    if name == "Semantic3D":
        assert t_config.get_config("semantic3d") is got


def test_label_reduce_table_with_ignored_zero_matches_jax():
    for num_classes in (8, 19):
        np.testing.assert_array_equal(
            tr.label_reduce_table(num_classes, (0,)),
            jr.label_reduce_table(num_classes, (0,)))


@pytest.mark.parametrize("op", ["segment_mean", "segment_max",
                                "segment_min"])
def test_segment_reductions_match_jax(op):
    """[N, 2] values over 7 segments, one of them empty and one id out of
    range (dropped); float32 and, for max / min, int32."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 7, 500).astype(np.int32)
    ids[ids == 4] = 5
    ids[:3] = 9
    dtypes = (np.float32,) if op == "segment_mean" else (np.float32,
                                                          np.int32)
    for dt in dtypes:
        vals = (rng.randn(500, 2) * 100).astype(dt)
        want = np.asarray(getattr(j_segment, op)(jnp.asarray(vals),
                                                 jnp.asarray(ids), 7))
        got = getattr(t_segment, op)(t(vals), t(ids), 7).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_possibility_training_pipeline_matches_jax():
    """Same clouds, seed and pseudo-GT, augmentation on: three batches
    bitwise equal to JAX's, and the field and class frequencies after
    them."""
    train, _ = make_dataset(num_train=2, num_points=3000)
    cfg_t = dataclasses.replace(t_config.ConfigSemantic3D, num_points=512,
                                num_classes=8)
    cfg_j = dataclasses.replace(j_config.ConfigSemantic3D, num_points=512,
                                num_classes=8)
    rng = np.random.RandomState(1)
    pseudo = {c.name: np.stack([(rng.rand(c.num_points) > 0.5).astype(
        np.float32), rng.randint(0, 8, c.num_points).astype(np.float32)])
        for c in train}
    tc = [Cloud(name=c.name, xyz=c.xyz, colors=c.colors, labels=c.labels)
          for c in train]
    got = t_dataset.PossibilityTrainingPipeline(tc, cfg_t, pseudo_gt=pseudo,
                                                seed=7)
    want = j_dataset.PossibilityTrainingPipeline(train, cfg_j,
                                                 pseudo_gt=pseudo, seed=7)
    for bs in (2, 3, 2):
        g, w = got.sample_batch(bs), want.sample_batch(bs)
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    for a, b in zip(got.possibility, want.possibility):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.class_weight, want.class_weight)
    assert list(t_dataset.PossibilityTrainingPipeline(
        tc, cfg_t, seed=7).batches(2, 2))[1]["xyz"].shape == (2, 512, 3)


def _pools(sizes, seed=0):
    arrays, _ = exact_clouds(seed, sizes)
    tc, jc = both(arrays)
    got = PossibilityDevicePool(tc, TINY, seed=0, device="cpu", augment=False)
    want = jpp.PossibilityDevicePool(jc, J_TINY, seed=0, augment=False)
    return got, want


def _finite(x):
    x = np.asarray(x)
    return x[np.isfinite(x)]


def _argmins(field, sizes):
    """(cloud, point) the schedule picks from a compact field."""
    segs = np.split(field, np.cumsum(sizes)[:-1])
    ci = int(np.argmin([s.min() for s in segs]))
    return ci, int(np.argmin(segs[ci]))


def _t_extract(pool, poss, batch_size, gen, augment=False):
    return possibility_extract(
        *pool.device_args(), pool.class_weight, poss, gen, batch_size,
        pool.cfg.num_points, pool.cfg.noise_init / 10, pool.window, augment)


def _j_extract(pool, poss, batch_size, key):
    return jpp.possibility_extract(
        *pool.device_args(), pool.class_weight, poss, key, batch_size,
        pool.cfg.num_points, pool.cfg.noise_init / 10, pool.window, False)


@pytest.mark.parametrize("sizes", [(300, 340), (700, 900, 650)])
def test_possibility_extract_matches_jax(sizes):
    """JAX's TINY config, noise_init 1e-6, no augmentation, on
    quantization-exact clouds smaller and larger than a block: the
    initial field equal; four single-block steps pick the same cloud and
    point on both sides, and the field after each stays within
    FIELD_RTOL / FIELD_ATOL of JAX's; so does a two-block step's."""
    got, want = _pools(sizes)
    np.testing.assert_array_equal(got.init_possibility.numpy(),
                                  _finite(want.init_possibility))
    np.testing.assert_array_equal(got.class_weight.numpy(),
                                  np.asarray(want.class_weight))
    gen = torch.Generator().manual_seed(0)
    tp, jpv = got.init_possibility, want.init_possibility
    for s in range(4):
        ci, _ = _argmins(tp.numpy(), sizes)
        assert _argmins(tp.numpy(), sizes) == _argmins(_finite(jpv), sizes)
        tp, *tb = _t_extract(got, tp, 1, gen)
        jpv, *jb = _j_extract(want, jpv, 1, jax.random.PRNGKey(s))
        np.testing.assert_allclose(tp.numpy(), _finite(jpv),
                                   rtol=FIELD_RTOL, atol=FIELD_ATOL)
        # the same true block points (the duplicates past a small cloud's
        # size are random on both sides): labels, and xyz recentred in x
        # and y on picks 1e-7 apart
        m = min(sizes[ci], TINY.num_points)
        np.testing.assert_array_equal(tb[2].numpy()[:, :m],
                                      np.asarray(jb[2])[:, :m])
        np.testing.assert_allclose(tb[0].numpy()[:, :m],
                                   np.asarray(jb[0])[:, :m], atol=1e-5)
    tp2, *_ = _t_extract(got, got.init_possibility, 2, gen)
    jp2, *_ = _j_extract(want, want.init_possibility, 2,
                         jax.random.PRNGKey(9))
    np.testing.assert_allclose(tp2.numpy(), _finite(jp2), rtol=FIELD_RTOL,
                               atol=FIELD_ATOL)


def test_possibility_field_is_monotone_and_blocks_consistent():
    """Two steps only raise the field; z stays absolute; the augmented
    feature copy differs from xyz while the colours stay."""
    got, _ = _pools((700, 900))
    gen = torch.Generator().manual_seed(1)
    a = got.init_possibility
    b, xyz, feats, *_ = _t_extract(got, a, 2, gen)
    c, *_ = _t_extract(got, b, 2, gen)
    assert (b >= a).all() and (c >= b).all() and (c > a).any()
    z = xyz[..., 2].numpy()
    assert z.min() >= 0 and z.max() <= 65535 * 2.0 ** -13
    np.testing.assert_array_equal(feats[..., :3].numpy(), xyz.numpy())
    _, xyz2, aug, *_ = _t_extract(got, a, 2, torch.Generator().manual_seed(1),
                                  augment=True)
    assert torch.equal(xyz2, xyz)
    assert not torch.allclose(aug[..., :3], xyz, atol=1e-4)
    assert torch.equal(aug[..., 3:], feats[..., 3:])
    # a rotation about z, a scale in [0.8, 1.2] and a flip keep |z| within
    # 1.2 |z| plus the noise
    assert (aug[..., 2].abs() <= 1.2 * xyz[..., 2].abs() + 0.01).all()


def test_possibility_pooled_step_learns_color_rule():
    """tests/test_possibility_pool.py's toy task through the port's
    possibility-pooled step: labels follow colour channel 0."""
    rng = np.random.RandomState(0)
    clouds = []
    for i in range(2):
        n = 700
        labels = rng.randint(0, 3, n).astype(np.int32)
        colors = np.zeros((n, 3), np.float32)
        colors[:, 0] = labels / 2.0
        clouds.append(Cloud(name=f"c{i}", xyz=(rng.rand(n, 3) * 4).astype(
            np.float32), colors=colors, labels=labels))
    pool = PossibilityDevicePool(clouds, TINY, seed=0, device="cpu",
                                 augment=False)
    model = tr.RandLANet(TINY)
    model.load_state_dict(tt.init_params(TINY, torch.Generator().manual_seed(
        0)))
    state = tt.create_train_state(model, TINY, 100)
    step = tt.make_possibility_pooled_train_step(
        model, TINY, np.ones(3, np.float32), "xla", device="cpu")
    gen = torch.Generator().manual_seed(0)
    poss, losses = pool.init_possibility, []
    for _ in range(12):
        state, poss, m = step(state, pool, poss, gen)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses
    assert float(m["accuracy"]) > 0.5


def _kitti_cfg(num_points, cfg=j_config.ConfigSemanticKITTI):
    return dataclasses.replace(cfg, num_points=num_points,
                               d_out=(8, 16, 16, 16), num_classes=5)


@pytest.fixture(scope="module")
def kitti_variables():
    cfg = _kitti_cfg(2816)
    rng = np.random.RandomState(0)
    xyz = (rng.rand(1, 2816, 3) * 4).astype(np.float32)
    feats = np.concatenate([xyz, rng.rand(1, 2816, 3).astype(np.float32)],
                           -1)
    model = jr.RandLANet(cfg)
    v = jax.jit(lambda x, f: model.init(
        {"params": jax.random.PRNGKey(0)}, f,
        jr.build_pyramid(x, cfg, engine="xla"), False))(
            jnp.asarray(xyz), jnp.asarray(feats))
    return random_flax_variables(v, seed=3)


def _torch_kitti(cfg_points, v):
    model = tr.RandLANet(_kitti_cfg(cfg_points, t_config.ConfigSemanticKITTI))
    model.load_state_dict(tr.params_from_flax(v["params"],
                                              v["batch_stats"]))
    return model.eval()


def test_semantickitti_forward_on_exact_pyramid_matches_jax(kitti_variables):
    """4 layers, 2816 → 704 → 176 → 44 points (no layer a multiple of
    256): the port's exact pyramid equals JAX's up to distance ties, and
    the forward on JAX's pyramid gives its logits and penult."""
    cfg = _kitti_cfg(2816)
    rng = np.random.RandomState(1)
    xyz = (rng.rand(2, 2816, 3) * 4).astype(np.float32)
    feats = np.concatenate([xyz, rng.rand(2, 2816, 3).astype(np.float32)],
                           -1)
    pyr = jr.build_pyramid(jnp.asarray(xyz), cfg, engine="xla")
    mine = tr.build_pyramid(t(xyz), _kitti_cfg(
        2816, t_config.ConfigSemanticKITTI), engine="xla")
    assert [x.shape[1] for x in mine.xyz] == [2816, 704, 176, 44]
    for i in range(4):
        for b in range(2):
            x = np.asarray(pyr.xyz[i][b])
            a = mine.neigh_idx[i][b].numpy()
            w = np.asarray(pyr.neigh_idx[i][b])
            gap = np.abs(sorted_d2(x, x, a) - sorted_d2(x, x, w))
            assert not ((a != w) & (gap > D2_ATOL)).any(), i
    logits, penult = jax.jit(jr.RandLANet(cfg).apply)(
        kitti_variables, jnp.asarray(feats), pyr)
    with torch.inference_mode():
        got_l, got_p = _torch_kitti(2816, kitti_variables)(
            t(feats), to_torch_pyramid(pyr))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(logits),
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(penult),
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def test_semantickitti_sorted_pyramid_close_to_jax(kitti_variables):
    """11264 → 2816 → 704 → 176 points on the window engine (the
    SemanticKITTI pyramid from its L1 down): the sorted pyramid of the
    port equals JAX's (TPU kernels in interpret mode) up to the K1
    near-tie rule, L0 takes the half window and a windowed upsample, and
    the forward on JAX's pyramid agrees with JAX's to the sorted-engine
    bounds of tests/test_torch_model.py."""
    n = 11264
    cfg = _kitti_cfg(n)
    rng = np.random.RandomState(2)
    xyz = (rng.rand(1, n, 3) * 4).astype(np.float32)
    feats = np.concatenate([xyz, rng.rand(1, n, 3).astype(np.float32)], -1)
    with interpret():
        pyr = jax.jit(jax.vmap(
            lambda x: jr._pyramid_window_sorted_single(x, cfg)))(
                jnp.asarray(xyz))
        logits, penult = jax.jit(jr.RandLANet(cfg).apply)(
            kitti_variables, jnp.asarray(feats), pyr)
    got = tr.build_pyramid(t(xyz), _kitti_cfg(
        n, t_config.ConfigSemanticKITTI), engine="window")
    assert got.windows == tuple(pyr.windows) and got.windows[0] > 0
    assert got.windows[1:] == (0, 0, 0)
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(pyr.order))
    np.testing.assert_array_equal(got.starts[0].numpy(),
                                  np.asarray(pyr.starts[0]))
    for i in range(4):
        x = np.asarray(pyr.xyz[i][0])
        np.testing.assert_array_equal(got.xyz[i][0].numpy(), x)
        assert_near_ties(x, x, got.neigh_idx[i][0].numpy(),
                         np.asarray(pyr.neigh_idx[i][0]))
    with torch.inference_mode():
        got_l, got_p = _torch_kitti(n, kitti_variables)(
            t(feats), to_torch_pyramid(pyr))
    logits, penult = np.asarray(logits), np.asarray(penult)
    agree = float((got_l.numpy().argmax(-1) == logits.argmax(-1)).mean())
    rel = float(np.linalg.norm(got_p.numpy() - penult)
                / np.linalg.norm(penult))
    assert agree >= CLASS_AGREEMENT
    assert rel <= PENULT_REL_ERR


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)        # record_round/ is written to the cwd
    return tmp_path


def test_al_loop_semantic3d_trains_on_the_possibility_pool(workdir,
                                                           monkeypatch):
    """--dataset semantic3d on synthetic rooms: the seed round trains on
    the host PossibilityTrainingPipeline, the AL round on the possibility
    pool (train_steps × max_epoch scheduled batches), and snap-2 is
    finite."""
    args = make_args(workdir, dataset="semantic3d", pool=1)
    exp = setup_experiment(args)
    assert exp.cfg.ignored_label_inds == (0,)
    write_grid_superpoints(exp.make_state([]), exp.train_clouds, 24)
    seed.run_seed(args)
    calls = []
    extract = tt.possibility_extract
    monkeypatch.setattr(tt, "possibility_extract",
                        lambda *a: calls.append(1) or extract(*a))
    ((miou, oa),) = al_loop.run_al_loop(args)
    assert 0 <= miou <= 1 and 0 <= oa <= 1
    assert len(calls) == exp.cfg.max_epoch * exp.cfg.train_steps
    snap = workdir / "data" / "semantic3d" / "0.05" / "saver" / \
        "t0-sb-clsbal-gcn_fps-WetSU-NAIL-0.9-1-1-0" / "snapshots" / "snap-2"
    state = torch.load(snap, map_location="cpu", weights_only=True)
    assert all(torch.isfinite(v).all() for v in state.values()
               if v.is_floating_point())
