"""The port's device training pool (--pool 1) against the JAX package's on
the CPU: the host draws, the extracted blocks, the small-cloud fill, the
per-round planes, the memory gate, one pooled train step, and the AL loop
on the pool.

Quantization-exact clouds make the JAX pool's u16/u8 arena lossless:
every xyz channel holds integers 0..65535 times 2⁻¹³ (min and max
present) and every colour channel integers 0..255 times 2⁻⁸, so the JAX
pool's dequantized coordinates equal the port's f32 ones and the blocks
compare exactly: index sets, their order and every payload plane."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssdr_al_tpu.config import ConfigS3DIS as JConfigS3DIS
from ssdr_al_tpu.data.cloud import Cloud as JCloud
from ssdr_al_tpu.models import randlanet as jr
from ssdr_al_tpu.train import device_pool as jp
from ssdr_al_tpu.train import trainer as jt
from ssdr_al_torch.cli import al_loop, seed
from ssdr_al_torch.cli.common import setup_experiment, write_grid_superpoints
from ssdr_al_torch.config import ConfigS3DIS
from ssdr_al_torch.data.cloud import Cloud
from ssdr_al_torch.models import randlanet as tr
from ssdr_al_torch.train import trainer as tt
from ssdr_al_torch.train import device_pool as dp
from ssdr_al_torch.train.device_pool import DeviceTrainPool
from test_torch_cli import make_args
from test_torch_train import (
    GRAD_TOL,
    STEP_ATOL,
    STEP_RTOL,
    bn_cancelled,
)
from torch_parity import (
    flax_param_dict,
    identity_dropout,
    random_flax_variables,
    small_cfg,
)

torch.set_num_threads(1)

TINY = dataclasses.replace(ConfigS3DIS, num_points=512,
                           d_out=(4, 8, 8, 8, 8), num_classes=3)
J_TINY = dataclasses.replace(JConfigS3DIS, num_points=512,
                             d_out=(4, 8, 8, 8, 8), num_classes=3)


def exact_clouds(seed, sizes, num_classes=3):
    """Quantization-exact clouds (module docstring), with labels and one
    round's pseudo-GT: [(name, xyz, colors, labels)], {name: [2, n]}."""
    rng = np.random.RandomState(seed)
    out, pseudo = [], {}
    for i, n in enumerate(sizes):
        q = rng.randint(0, 65536, (n, 3))
        q[0], q[1] = 0, 65535
        c = rng.randint(0, 256, (n, 3))
        c[0], c[1] = 0, 255
        name = f"c{i}"
        out.append((name, (q * 2.0 ** -13).astype(np.float32),
                    (c * 2.0 ** -8).astype(np.float32),
                    rng.randint(0, num_classes, n).astype(np.int32)))
        pseudo[name] = np.stack([(rng.rand(n) > 0.5).astype(np.float32),
                                 rng.randint(0, num_classes, n).astype(
                                     np.float32)])
    return out, pseudo


def both(arrays):
    """The same clouds as the port's and as the JAX package's Cloud."""
    return ([Cloud(name=a, xyz=x, colors=c, labels=y) for a, x, c, y in arrays],
            [JCloud(name=a, xyz=x, colors=c, labels=y)
             for a, x, c, y in arrays])


def jax_extract(pool, ids, picks):
    return [np.asarray(x) for x in jp.extract_blocks(
        *pool.device_args(), jnp.asarray(ids), jnp.asarray(picks),
        jax.random.PRNGKey(0), pool.cfg.num_points, pool.window)]


def test_sample_indices_match_jax_draw_for_draw():
    """Three steps of B = 6 draws, then a reseed and three more: cloud ids
    and picks equal to the JAX pool's."""
    arrays, _ = exact_clouds(0, [700, 600, 900, 650])
    tc, jc = both(arrays)
    got = DeviceTrainPool(tc, TINY, seed=3, device="cpu")
    want = jp.DeviceTrainPool(jc, J_TINY, seed=3)
    for r in range(6):
        if r == 3:
            got.reseed(11)
            want.reseed(11)
        gi, gp = got.sample_indices(6)
        wi, wp = want.sample_indices(6)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gp, wp)
        assert gi.dtype == wi.dtype and gp.dtype == wp.dtype


def test_extract_blocks_match_jax_on_exact_clouds():
    """Clouds larger than a block (no duplicates): every plane of every
    block equal to the JAX pool's, rows in the same (d², index) order."""
    arrays, pseudo = exact_clouds(1, [900, 1300, 700])
    tc, jc = both(arrays)
    got_pool = DeviceTrainPool(tc, TINY, pseudo_gt=pseudo, seed=0,
                               device="cpu")
    want_pool = jp.DeviceTrainPool(jc, J_TINY, pseudo_gt=pseudo, seed=0)
    for _ in range(2):
        ids, picks = want_pool.sample_indices(6)
        want = jax_extract(want_pool, ids, picks)
        got = [x.numpy() for x in got_pool.extract(ids, picks)]
        for name, g, w in zip(("xyz", "features", "labels", "activation",
                               "pseudo"), got, want):
            assert g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_blocks_are_numpy_nearest_k_on_random_clouds():
    """Random f32 clouds: each block is its cloud's num_points nearest
    rows in extract_host's (numpy stable argsort) order, recentred."""
    rng = np.random.RandomState(2)
    clouds = [Cloud(name=f"r{i}", xyz=(rng.rand(n, 3) * 8).astype(np.float32),
                    colors=rng.rand(n, 3).astype(np.float32),
                    labels=rng.randint(0, 3, n).astype(np.int32))
              for i, n in enumerate((800, 1500, 613))]
    pool = DeviceTrainPool(clouds, TINY, seed=4, device="cpu")
    ids, picks = pool.sample_indices(5)
    xyz, feats, labels, act, pseudo = pool.extract(ids, picks)
    for b, rows in enumerate(pool.extract_host(ids, picks)):
        cl = clouds[int(ids[b])]
        np.testing.assert_array_equal(xyz[b].numpy(),
                                      cl.xyz[rows] - picks[b][None])
        np.testing.assert_array_equal(feats[b, :, 3:].numpy(),
                                      cl.colors[rows])
        np.testing.assert_array_equal(labels[b].numpy(), cl.labels[rows])
        # no pseudo-GT: fully supervised
        np.testing.assert_array_equal(pseudo[b].numpy(), cl.labels[rows])
        assert (act[b] == 1).all()
    np.testing.assert_array_equal(feats[..., :3].numpy(), xyz.numpy())


def test_small_cloud_filled_with_valid_duplicates():
    """A cloud of 100 points and a block of 512: the first 100 rows are
    the whole cloud in (d², index) order, every later row a copy of one of
    them (same xyz, colour and label)."""
    rng = np.random.RandomState(3)
    n = 100
    cl = Cloud(name="s", xyz=(rng.rand(n, 3) * 8).astype(np.float32),
               colors=rng.rand(n, 3).astype(np.float32),
               labels=rng.randint(0, 3, n).astype(np.int32))
    big = Cloud(name="b", xyz=(rng.rand(900, 3) * 8).astype(np.float32),
                colors=rng.rand(900, 3).astype(np.float32),
                labels=rng.randint(0, 3, 900).astype(np.int32))
    pool = DeviceTrainPool([cl, big], TINY, seed=0, device="cpu")
    ids = np.array([0, 1, 0], np.int32)
    picks = np.stack([cl.xyz[5], big.xyz[7], cl.xyz[50]]).astype(np.float32)
    xyz, feats, labels, _, _ = pool.extract(ids, picks)
    for b in (0, 2):
        rows = pool.extract_host(ids[b:b + 1], picks[b:b + 1])[0]
        assert len(rows) == n
        local = cl.xyz - picks[b][None]
        np.testing.assert_array_equal(xyz[b, :n].numpy(), local[rows])
        # each duplicate is a real row: its xyz, colour and label match
        src = np.abs(xyz[b].numpy()[:, None, :] - local[None]).sum(
            -1).argmin(1)
        np.testing.assert_array_equal(xyz[b].numpy(), local[src])
        np.testing.assert_array_equal(feats[b, :, 3:].numpy(),
                                      cl.colors[src])
        np.testing.assert_array_equal(labels[b].numpy(), cl.labels[src])
    # the large cloud's block has no duplicate
    assert len(np.unique(xyz[1].numpy(), axis=0)) == TINY.num_points


def test_extract_reads_the_batch_largest_cloud(monkeypatch):
    """A batch without the pool's largest cloud reads only as many rows a
    block as its own largest cloud has (at least a block), and its blocks,
    duplicates of a small cloud included, equal those read at the pool's
    window from the same generator state."""
    rng = np.random.RandomState(9)
    clouds = [Cloud(name=f"c{i}", xyz=(rng.rand(n, 3) * 8).astype(np.float32),
                    colors=rng.rand(n, 3).astype(np.float32),
                    labels=rng.randint(0, 3, n).astype(np.int32))
              for i, n in enumerate((100, 700, 3000))]
    pool = DeviceTrainPool(clouds, TINY, seed=2, device="cpu")
    windows = []
    extract = dp.extract_blocks

    def recording(*args):
        windows.append(args[7])
        return extract(*args)

    monkeypatch.setattr(dp, "extract_blocks", recording)
    ids = np.array([0, 1, 0, 1], np.int32)
    picks = np.stack([clouds[int(i)].xyz[j] for i, j in zip(ids, (3, 9, 50,
                                                                  600))])
    state = pool.generator.get_state()
    got = pool.extract(ids, picks)
    pool.generator.set_state(state)
    want = extract(*pool.device_args(), torch.from_numpy(ids).long(),
                   torch.from_numpy(picks), TINY.num_points, pool.window,
                   pool.generator)
    assert windows == [700] and pool.window == 3000
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    pool.extract(np.array([0, 0], np.int32), picks[[0, 2]])
    assert windows[-1] == TINY.num_points


def test_update_pseudo_gt_changes_only_those_planes():
    arrays, pg1 = exact_clouds(4, [700, 800])
    _, pg2 = exact_clouds(5, [700, 800])
    tc, _ = both(arrays)
    pool = DeviceTrainPool(tc, TINY, pseudo_gt=pg1, seed=0, device="cpu")
    xyz0, planes0 = pool.xyz.clone(), pool.planes.clone()
    ids, picks = pool.sample_indices(4)
    before = pool.extract(ids, picks)
    pool.update_pseudo_gt(pg2)
    assert torch.equal(pool.xyz, xyz0)
    assert torch.equal(pool.planes[:, :4], planes0[:, :4])
    after = pool.extract(ids, picks)
    for i in range(3):                       # xyz, features, labels
        assert torch.equal(before[i], after[i])
    for b, rows in enumerate(pool.extract_host(ids, picks)):
        gt = pg2[tc[int(ids[b])].name]
        np.testing.assert_array_equal(after[3][b].numpy(), gt[0][rows])
        np.testing.assert_array_equal(after[4][b].numpy(), gt[1][rows])
    assert not torch.equal(before[4], after[4])


def test_memory_gate(monkeypatch):
    """Past the budget (half the card's free memory on a card, no gate
    on the CPU) the pool is unavailable and uploads nothing."""
    arrays, _ = exact_clouds(6, [700, 800])
    tc, _ = both(arrays)
    monkeypatch.setattr(dp, "device_budget", lambda device: 1000)
    small = DeviceTrainPool(tc, TINY, device="cpu")
    assert not small.available and not hasattr(small, "xyz")
    monkeypatch.undo()
    assert dp.device_budget(torch.device("cpu")) is None
    pool = DeviceTrainPool(tc, TINY, device="cpu")
    assert pool.available and pool.window == 800
    assert pool.footprint(1500) == 36 * 1500 + 96 * TINY.batch_size * 800


def test_shuffled_blocks_subsample_the_whole_block():
    """shuffle_blocks permutes each block's rows, every plane alike, so
    the pyramid's prefix subsample spans the block; in the extracted
    (d², index) order the first quarter is a disk around the pick."""
    rng = np.random.RandomState(8)
    clouds = [Cloud(name=f"r{i}", xyz=(rng.rand(n, 3) * 8).astype(np.float32),
                    colors=rng.rand(n, 3).astype(np.float32),
                    labels=rng.randint(0, 3, n).astype(np.int32))
              for i, n in enumerate((3000, 2500))]
    cfg = dataclasses.replace(TINY, num_points=2048)
    pool = DeviceTrainPool(clouds, cfg, seed=1, device="cpu")
    blocks = pool.extract(*pool.sample_indices(4))
    shuffled = dp.shuffle_blocks(blocks, torch.Generator().manual_seed(0))
    key = lambda x, f: torch.cat([x, f], -1).numpy().tolist()  # noqa: E731
    for b in range(4):
        assert sorted(key(shuffled[0][b], shuffled[1][b])) == \
            sorted(key(blocks[0][b], blocks[1][b]))
        rows = {tuple(r[:3]): r[3:] for r in key(blocks[0][b], blocks[1][b])}
        for r, lab in zip(key(shuffled[0][b], shuffled[1][b]),
                          shuffled[2][b].tolist()):
            assert rows[tuple(r[:3])] == r[3:]
        assert lab in (0, 1, 2)
    r_sorted = blocks[0].norm(dim=-1)
    r_shuf = shuffled[0].norm(dim=-1)
    quarter = cfg.num_points // 4
    assert (r_sorted[:, :quarter].amax(1) < 0.8 * r_sorted.amax(1)).all()
    assert (r_shuf[:, :quarter].amax(1) > 0.9 * r_shuf.amax(1)).all()


def test_sorted_control_feeds_the_jax_pooled_steps_blocks(monkeypatch):
    """A pool whose `blocks` is "sorted" (scripts/flagship.py's control)
    feeds its step body the JAX pooled step's blocks: every plane equal
    to jp.extract_blocks' (d², index) order on exact clouds. The default
    pool feeds each block shuffled (a permutation of the same rows);
    an unknown order is refused."""
    arrays, pseudo = exact_clouds(12, [900, 1300, 700])
    tc, jc = both(arrays)
    want_pool = jp.DeviceTrainPool(jc, J_TINY, pseudo_gt=pseudo, seed=0)
    fed = []

    def body_maker(*args, **kwargs):
        return lambda state, *blocks: fed.append(blocks)

    monkeypatch.setattr(tt, "_make_step_body", body_maker)
    for order in ("sorted", "shuffled"):
        pool = DeviceTrainPool(tc, TINY, pseudo_gt=pseudo, seed=0,
                               device="cpu")
        if order == "sorted":
            pool.blocks = "sorted"
        inputs, step = tt.make_static_step(None, TINY, None, path="pool",
                                           pool=pool, device="cpu")
        ids, picks = want_pool.sample_indices(4)
        inputs.stage({"cloud_ids": ids, "picks": picks})
        step(None, None)
        want = jax_extract(want_pool, ids, picks)
        got = [x.numpy() for x in fed[-1][:5]]
        if order == "sorted":
            for name, g, w in zip(("xyz", "features", "labels",
                                   "activation", "pseudo"), got, want):
                assert g.shape == w.shape, name
                np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        assert not np.array_equal(got[0], want[0])
        key = np.concatenate([got[1], got[2][..., None], got[3][..., None],
                              got[4][..., None]], -1)
        wkey = np.concatenate([want[1], want[2][..., None],
                               want[3][..., None], want[4][..., None]], -1)
        for b in range(4):
            np.testing.assert_array_equal(
                np.unique(key[b], axis=0), np.unique(wkey[b], axis=0))
    pool.blocks = "unsorted"
    with pytest.raises(ValueError):
        tt.make_static_step(None, TINY, None, path="pool", pool=pool,
                            device="cpu")


def test_pooled_train_step_matches_jax(monkeypatch):
    """One pooled step from converted weights, dropout off, on the exact
    pyramid. The port's step trains on the pool's blocks (JAX's blocks:
    test_extract_blocks_match_jax_on_exact_clouds) shuffled per block,
    where JAX's pooled step feeds the distance order to its pyramid, whose
    subsample is the prefix (ROADMAP.md §3); so it is held to JAX's train
    step on the same shuffled blocks: the loss, each parameter against
    what its gradient allows through Adam's first step, and the BatchNorm
    statistics, to the tolerances of
    test_torch_train.py::test_train_step_exact_pyramid_matches_jax (on
    random f32 clouds as there: lattice clouds tie distances, which the
    two exact engines may break apart)."""
    cfg = small_cfg(num_points=1024)
    rng = np.random.RandomState(7)
    clouds = [Cloud(name=f"r{i}", xyz=(rng.rand(n, 3) * 4).astype(np.float32),
                    colors=rng.rand(n, 3).astype(np.float32),
                    labels=rng.randint(0, cfg.num_classes, n).astype(np.int32))
              for i, n in enumerate((1500, 1800))]
    pseudo = {c.name: np.stack([(rng.rand(c.num_points) > 0.5).astype(
        np.float32), rng.randint(0, cfg.num_classes, c.num_points).astype(
            np.float32)]) for c in clouds}
    weights = (np.random.RandomState(3).rand(cfg.num_classes) + 0.5).astype(
        np.float32)
    pool = DeviceTrainPool(clouds, cfg, pseudo_gt=pseudo, seed=2,
                           device="cpu")
    ids, picks = pool.sample_indices(2)
    # the blocks the port's step trains on: extracted and shuffled by the
    # pool's generator, from the state the step starts at
    gen_state = pool.generator.get_state()
    blocks = pool.extract(ids, picks)
    shuffled = dp.shuffle_blocks(blocks, pool.generator)
    pool.generator.set_state(gen_state)
    xyz, feats, labels, act, pse = [x.numpy() for x in shuffled]
    assert not np.array_equal(xyz, blocks[0].numpy())
    model = jr.RandLANet(cfg)
    v = jax.jit(lambda x, f: model.init(
        {"params": jax.random.PRNGKey(0)}, f,
        jr.build_pyramid(x, cfg, engine="xla"), False))(
            jnp.asarray(xyz), jnp.asarray(feats))
    v = random_flax_variables(v, seed=5)
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    state = jt.TrainState.create(apply_fn=model.apply, params=v["params"],
                                 batch_stats=v["batch_stats"],
                                 tx=optax.adam(jt.make_lr_schedule(cfg, 10)))
    step = jt.make_train_step(model, cfg, weights, knn_engine="xla")
    new, metrics = step(state, {"xyz": xyz, "features": feats,
                                "labels": labels, "activation": act,
                                "pseudo": pse}, jax.random.PRNGKey(1))
    want = flax_param_dict(new.params, new.batch_stats)

    tm = tr.RandLANet(cfg)
    tm.load_state_dict(tr.params_from_flax(v["params"], v["batch_stats"]))
    tm.dp1 = identity_dropout()
    ts = tt.create_train_state(tm, cfg, 10)
    ts, tmet = tt.make_pooled_train_step(tm, cfg, weights, "xla",
                                         device="cpu")(ts, pool, ids, picks,
                                                       None)
    np.testing.assert_allclose(float(tmet["loss"]), float(metrics["loss"]),
                               rtol=STEP_RTOL)
    assert abs(float(tmet["accuracy"]) - float(metrics["accuracy"])) < 1e-6
    assert float(tmet["activation_sum"]) == float(metrics["activation_sum"])

    pyr = jr.build_pyramid(jnp.asarray(xyz), cfg, engine="xla")

    def loss_fn(params):
        (logits, _), _ = model.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(feats), pyr, True, mutable=["batch_stats"])
        return jr.masked_weighted_ce(logits, jnp.asarray(pse),
                                     jnp.asarray(act), jnp.asarray(labels),
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
        step_bound = lr * np.minimum(
            2.0, dg / (np.maximum(np.abs(w) - dg, 0) + tt.ADAM_EPS))
        assert np.all(np.abs(got[k].numpy() - want[k])
                      <= step_bound + 1e-6 * np.abs(want[k])), k
    for k in ("running_mean", "running_var"):
        for name in [n for n in want if n.endswith(k)]:
            np.testing.assert_allclose(got[name].numpy(), want[name],
                                       rtol=STEP_RTOL, atol=STEP_ATOL,
                                       err_msg=name)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)        # record_round/ is written to the cwd
    return tmp_path


def test_al_loop_trains_on_the_device_pool(workdir, monkeypatch):
    """The twin of tests/test_torch_cli.py::test_full_al_loop with the
    al_loop default --pool 1: round 2 trains on blocks extracted from the
    pool (train_steps × max_epoch pooled extractions, no host batch) and
    writes a finite snap-2."""
    args = make_args(workdir, pool=1)
    exp = setup_experiment(args)
    write_grid_superpoints(exp.make_state([]), exp.train_clouds, 24)
    seed.run_seed(args)
    calls = []
    extract = DeviceTrainPool.extract
    monkeypatch.setattr(DeviceTrainPool, "extract",
                        lambda *a: calls.append(1) or extract(*a))
    ((miou, oa),) = al_loop.run_al_loop(args)
    assert 0 <= miou <= 1 and 0 <= oa <= 1
    assert len(calls) == exp.cfg.max_epoch * exp.cfg.train_steps
    snap = workdir / "data" / "S3DIS" / "0.05" / "saver" / \
        "t0-sb-clsbal-gcn_fps-WetSU-NAIL-0.9-1-1-0" / "snapshots" / "snap-2"
    state = torch.load(snap, map_location="cpu", weights_only=True)
    assert all(torch.isfinite(v).all() for v in state.values()
               if v.is_floating_point())


def test_al_loop_pool_is_the_default(monkeypatch):
    """Without --pool, al_loop's parser picks the device pool."""
    seen = {}
    monkeypatch.setattr(al_loop, "run_al_loop", lambda a: seen.update(vars(a)))
    al_loop.main(["--synthetic", "--device", "cpu"])
    assert seen["pool"] == 1
