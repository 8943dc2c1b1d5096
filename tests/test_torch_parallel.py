"""Data parallelism of ssdr_al_torch on the CPU: gloo ranks spawned from
the package (ssdr_al_torch.parallel), a FileStore under tmp_path, one torch
thread a rank. Every dp path is held to the single-device run of the same
function on the same inputs, on 2 and 4 ranks: the train step in f32 and
bf16 with ignored labels whose count differs between the shards, a
4-step train_round, the pooled step, the selection forward with its
uncertainty and region means, the chamfer blocks, a selection round of
each diversity branch and the evaluator; the 4-rank step is also held to
JAX's step over its 8-device CPU mesh (tests/test_sharding.py's TINY)."""

import dataclasses
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssdr_al_tpu.config import ConfigS3DIS as JConfigS3DIS
from ssdr_al_tpu.models import randlanet as jr
from ssdr_al_tpu.parallel import make_mesh, replicated_sharding, shard_batch
from ssdr_al_tpu.train import trainer as jt
from ssdr_al_torch.active.samplers import SeedSampler
from ssdr_al_torch.active.state import ALState, RoundStats
from ssdr_al_torch.config import ConfigS3DIS
from ssdr_al_torch.data.synthetic import NUM_SYNTH_CLASSES, grid_superpoints
from ssdr_al_torch.data.synthetic import make_dataset
from ssdr_al_torch.models.randlanet import init_params, params_from_flax
from ssdr_al_torch.parallel import backend_for, data_devices, dryrun, launch
from ssdr_al_torch.parallel.mesh import DataGroup
from ssdr_al_torch.train.grad_check import spread_weights
from ssdr_al_torch.train.trainer import ADAM_EPS
from torch_parity import flax_param_dict, random_flax_variables

torch.set_num_threads(1)

# the same arithmetic summed in another order (each rank's rows, then over
# the ranks): the loss and the BatchNorm statistics to 1e-5, the summed
# gradient to 1e-5 relative L2 before Adam
STEP_RTOL, GRAD_REL = 1e-5, 1e-5
# the bf16 model rounds every activation to 8 bits, so an f32 sum taken in
# another order flips the rounding of values on a bf16 boundary by one bf16
# ulp: its loss, accuracy and BatchNorm statistics are held to 2^-8
# relative (the statistics to 2^-8 of their tensor's largest entry). Its
# gradient meets those flips in cancellations (measured: one device moves
# its own bf16 gradient by 13 % relative L2 when the batch rows are merely
# reversed; 2 and 4 ranks move it by 10.7 % and 11.3 %), so it is held to
# twice what reversing the rows does on one device.
BF16_RTOL, BF16_GRAD_VS_REVERSED = 2.0 ** -8, 2.0
# after 4 Adam steps: Adam's step is ~lr whatever the gradient's size, so
# where a gradient is mostly round-off its parameter's path follows the
# rounding. The Dense biases that feed a train-mode BatchNorm have a
# gradient of round-off alone and are left out (tests/test_torch_train.py::
# bn_cancelled). The round runs on blocks of 2048 points: at 512 the
# deepest layer holds 32 points, its gradients are round-off enough to
# part one device and two ranks by more than ROUND_REL after 4 steps;
# at 2048 they part by 5.8e-5.
ROUND_REL, ROUND_POINTS = 1e-3, 2048
# the pooled step's second loss follows one Adam step taken on gradients
# that agree to GRAD_REL, Adam turning round-off into ~lr steps
# (measured 3.1e-5)
POOLED_SECOND_RTOL = 1e-4
# test_torch_train.py's tolerances of one port step against one JAX step:
# loss and BatchNorm statistics; each parameter's gradient within
# JAX_GRAD_TOL of its tensor's largest, the updated parameters within what
# that allows through Adam's first step
JAX_STEP_RTOL, JAX_STEP_ATOL, JAX_GRAD_TOL = 1e-4, 1e-5, 1e-4
SSDR_ARGS = ["t0", "sb", "clsbal", "gcn_fps", "WetSU", "NAIL", "0.9", "1",
             "1", "0"]
# the selection round's diversity branches; the coreGCN fit is cut to 200
# steps (20 000 in the branch; the full fit runs in chip_smoke.py)
DIVERSITY = {"selection": "gcn_fps", "selection_gcn": "gcn",
             "selection_edcd": "edcd"}
GCN_STEPS = 200


def ssdr_args(diversity):
    return SSDR_ARGS[:3] + [diversity] + SSDR_ARGS[4:]

CFG = dataclasses.replace(
    ConfigS3DIS, num_layers=3, d_out=(8, 16, 32), sub_sampling_ratio=(4, 4, 2),
    num_points=512, batch_size=4, val_batch_size=4, val_steps=2,
    train_steps=4, max_epoch=1, num_classes=NUM_SYNTH_CLASSES)
# the step's batch carries label 0 as ignored: 6 training classes of 7 raw
CFG_IGN = dataclasses.replace(CFG, num_classes=6, ignored_label_inds=(0,))


def bn_cancelled(key: str) -> bool:
    return key == "fc0.bias" or key.endswith("dense.bias")


def rel(a, b):
    """Relative L2 distance of a from b (arrays, or dicts of arrays)."""
    if isinstance(b, dict):
        a, b = (np.concatenate([d[k].ravel() for k in sorted(b)])
                for d in (a, b))
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def ignored_batch(seed, cfg):
    """[4, N] batch whose rows hold 50 %, 10 %, 0 % and 0 % ignored labels,
    so the shards' valid counts differ."""
    rng = np.random.RandomState(seed)
    b, n = cfg.batch_size, cfg.num_points
    xyz = (rng.rand(b, n, 3) * 4).astype(np.float32)
    labels = rng.randint(1, cfg.num_classes + 1, (b, n)).astype(np.int32)
    for row, share in ((0, 0.5), (1, 0.1)):
        labels[row, rng.rand(n) < share] = 0
    return {"xyz": xyz,
            "features": np.concatenate(
                [xyz, rng.rand(b, n, 3).astype(np.float32)], -1),
            "labels": labels,
            "pseudo": rng.randint(1, cfg.num_classes + 1,
                                  (b, n)).astype(np.int32),
            "activation": (rng.rand(b, n) < 0.6).astype(np.float32)}


def selection_workload(work):
    """tests/test_torch_selection.py's workload: 2 rooms, grid
    superpoints, the registry and a seed round."""
    train, _ = make_dataset(num_train=2, num_val=0, num_points=3000, seed=0)
    state = ALState(work, SSDR_ARGS)
    total = {"unlabeled": {}, "file_num": len(train), "sp_num": 0,
             "point_num": sum(c.num_points for c in train)}
    for c in train:
        comps, in_comp = grid_superpoints(c.xyz, 64)
        state.write_superpoints(c.name, comps, in_comp, c.num_points)
        total["unlabeled"][c.name] = np.arange(len(comps))
        total["sp_num"] += len(comps)
    state.write_registry(total)
    SeedSampler(ALState(work, ["seed"]), train, total["sp_num"]).sampling(
        total["sp_num"] // 8, 0, RoundStats())
    return train, total["sp_num"]


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The inputs of every call, made once: the train-step batches and
    states, rooms with their superpoints and regions, and the selection
    workload for the single-device run ("one") and the ranks ("dp")."""
    base = tmp_path_factory.mktemp("dp")
    rooms, val = make_dataset(num_train=2, num_val=1, num_points=3000,
                              seed=0)
    state = spread_weights(init_params(CFG, torch.Generator().manual_seed(0)),
                           1)
    cfg_round = dataclasses.replace(CFG, num_points=ROUND_POINTS)
    state_ign = spread_weights(
        init_params(CFG_IGN, torch.Generator().manual_seed(0)), 1)
    comps = {c.name: grid_superpoints(c.xyz, 16)[0] for c in rooms}
    regions = {c.name: [(s, s % 3 == 0, comps[c.name][s][:5])
                        for s in range(len(comps[c.name]))] for c in rooms}
    rng = np.random.RandomState(5)
    slots = {c.name: rng.randint(-1, 40, c.num_points) for c in rooms}
    train, sp_num = selection_workload(str(base / "one"))
    shutil.copytree(base / "one", base / "dp")
    weights = (np.random.RandomState(3).rand(6) + 0.5).astype(np.float32)
    w8 = np.ones(CFG.num_classes, np.float32)
    calls = {
        "step": (dryrun.train_step_result, dict(
            cfg=CFG_IGN, state=state_ign, batch=ignored_batch(4, CFG_IGN),
            weights=weights)),
        "step_bf16": (dryrun.train_step_result, dict(
            cfg=dataclasses.replace(CFG_IGN, compute_dtype="bfloat16"),
            state=state_ign, batch=ignored_batch(4, CFG_IGN),
            weights=weights)),
        "round": (dryrun.train_round_result, dict(
            cfg=cfg_round, state=state, clouds=rooms, pseudo=None,
            weights=w8)),
        "pooled": (dryrun.pooled_step_result, dict(
            cfg=CFG, state=state, clouds=rooms, weights=w8, steps=2)),
        "inference": (dryrun.inference_result, dict(
            cfg=CFG, clouds=rooms, state=state, slot_maps=slots,
            num_slots=40)),
        "chamfer": (dryrun.chamfer_result, dict(
            clouds=rooms, components=comps, regions_by_cloud=regions)),
        **{name: (dryrun.selection_round_result, dict(
            cfg=CFG, clouds=train, state=state,
            sampler_args=ssdr_args(div), diversity=div, gcn_steps=GCN_STEPS,
            total_num=sp_num, budget=sp_num // 10))
           for name, div in DIVERSITY.items()},
        "evaluate": (dryrun.evaluate_result, dict(
            cfg=CFG, clouds=val, state=state)),
    }
    return base, calls


def _one(calls, name, base, **over):
    fn, kw = calls[name]
    kw = dict(kw, **over)
    if name == "round":
        kw["save_dir"] = str(base / "snap_one")
    if name.startswith("selection"):
        kw["work"] = str(base / "one")
    return fn(None, device="cpu", **kw)


@pytest.fixture(scope="module")
def single(work):
    """Every call on one device, and the bf16 step on the batch with its
    rows reversed (one device's own spread under another order)."""
    base, calls = work
    out = {name: _one(calls, name, base) for name in calls}
    batch = calls["step_bf16"][1]["batch"]
    out["step_bf16_reversed"] = _one(calls, "step_bf16", base, batch={
        k: v[::-1].copy() for k, v in batch.items()})
    return out


@pytest.fixture(scope="module", autouse=True)
def launches(work):
    """The module's three launches, started before its first test and run
    while this process computes the single-device and JAX references:
    every call on 2 ranks (the evaluator with val_batch_size 3, which the
    ranks round up to 4), the f32, bf16 and JAX TINY steps on 4 ranks,
    and dryrun_multichip(2)."""
    base, calls = work
    todo = []
    for name, (fn, kw) in calls.items():
        kw = dict(kw)
        if name == "round":
            kw["save_dir"] = str(base / "snap_dp")
        if name.startswith("selection"):
            kw["work"] = str(base / "dp")
        if name == "evaluate":
            kw["cfg"] = dataclasses.replace(CFG, val_batch_size=3)
        todo.append((fn, kw))
    tiny = jax_tiny()
    todo4 = [calls["step"], calls["step_bf16"],
             (dryrun.train_step_result, dict(
                 cfg=tiny["cfg"], state=tiny["state"], batch=tiny["batch"],
                 weights=np.ones(5, np.float32), knn_engine="xla"))]
    store = str(base / "store")
    with ThreadPoolExecutor(3) as pool:
        yield dict(
            tiny=tiny,
            dp2=pool.submit(launch, dryrun.run_calls, 2, ["cpu"] * 2, store,
                            todo),
            dp4=pool.submit(launch, dryrun.run_calls, 4, ["cpu"] * 4, store,
                            todo4),
            dry=pool.submit(dryrun.dryrun_multichip, 2, ["cpu"] * 2, store))


@pytest.fixture(scope="module")
def dp2(work, launches):
    """[rank][name] → result of every call on 2 ranks."""
    _, calls = work
    return [{name: res for name, (res, _) in zip(calls, r)}
            for r in launches["dp2"].result()]


@pytest.fixture(scope="module")
def dp4(launches):
    return [{name: res for name, (res, _) in
             zip(("step", "step_bf16", "jax_tiny"), r)}
            for r in launches["dp4"].result()], launches["tiny"]


def jax_tiny():
    """test_sharding.py's TINY config and batch, random O(1) flax weights
    and the port's copy of them."""
    jcfg = dataclasses.replace(JConfigS3DIS, num_points=512,
                               d_out=(4, 8, 8, 8, 8), batch_size=8,
                               num_classes=5)
    cfg = dataclasses.replace(ConfigS3DIS, num_points=512,
                              d_out=(4, 8, 8, 8, 8), batch_size=8,
                              num_classes=5)
    rng = np.random.RandomState(0)
    b, n = 8, 512
    batch = {
        "xyz": (rng.rand(b, n, 3) * 10).astype(np.float32),
        "features": rng.rand(b, n, 6).astype(np.float32),
        "labels": rng.randint(0, 5, (b, n)).astype(np.int32),
        "activation": np.ones((b, n), np.float32),
        "pseudo": rng.randint(0, 5, (b, n)).astype(np.int32),
    }
    model = jr.RandLANet(jcfg)
    v = jax.jit(lambda x, f: model.init(
        {"params": jax.random.PRNGKey(0)}, f,
        jr.build_pyramid(x, jcfg, engine="xla"), False))(
            jnp.asarray(batch["xyz"]), jnp.asarray(batch["features"]))
    v = random_flax_variables(v, seed=5)
    state = params_from_flax(v["params"], v["batch_stats"])
    return dict(jcfg=jcfg, cfg=cfg, batch=batch, variables=v, state=state,
                model=model)


def test_data_devices_and_backend(monkeypatch):
    """CPU ranks share the CPU and take gloo; cuda ranks take a card each
    (NCCL), two ranks on one card take gloo, and more ranks than cards
    raise."""
    cpu = data_devices("cpu", 3)
    assert cpu == [torch.device("cpu")] * 3 and backend_for(cpu) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    two = data_devices("cuda", 2)
    assert two == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert backend_for(two) == "nccl"
    assert backend_for([torch.device("cuda", 0)] * 2) == "gloo"
    with pytest.raises(ValueError, match="asks for 3 cards.*has 2"):
        data_devices("cuda", 3)


def test_shares_cover_the_batch_and_the_blocks():
    for m in (1, 2, 3, 4):
        groups = [DataGroup(r, m, torch.device("cpu")) for r in range(m)]
        for n in (0, 1, 5, 8):
            got = np.concatenate([np.arange(n)[g.share(n)] for g in groups])
            assert np.array_equal(got, np.arange(n))
        x = np.arange(8 * m).reshape(4 * m, 2)
        assert np.array_equal(np.concatenate(
            [g.shard_rows(x) for g in groups]), x)
    with pytest.raises(ValueError, match="does not split"):
        DataGroup(0, 4, torch.device("cpu")).shard_rows(np.zeros((6, 2)))


@pytest.mark.parametrize("name", ["step", "step_bf16"])
@pytest.mark.parametrize("ranks", [2, 4])
def test_train_step_equals_one_device(single, dp2, dp4, name, ranks):
    """Loss, accuracy, the summed gradient and the BatchNorm running
    statistics of one step, with ignored labels in two of the four rows;
    every rank ends with the same state. bf16 within its rounding
    (BF16_RTOL, BF16_GRAD_VS_REVERSED)."""
    runs = dp2 if ranks == 2 else dp4[0]
    want = single[name]
    rtol, grad_tol = STEP_RTOL, GRAD_REL
    if name == "step_bf16":
        rtol = BF16_RTOL
        grad_tol = BF16_GRAD_VS_REVERSED * rel(
            single["step_bf16_reversed"]["grad"], want["grad"])
    for r in runs:
        got = r[name]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=rtol)
        assert abs(got["accuracy"] - want["accuracy"]) <= max(rtol, 1e-6)
        assert rel(got["grad"], want["grad"]) <= grad_tol
        for k in want["state"]:
            if "running" in k:
                # bf16: one ulp of the tensor's largest entry
                atol = (1e-7 if name == "step" else
                        BF16_RTOL * np.abs(want["state"][k]).max())
                np.testing.assert_allclose(got["state"][k], want["state"][k],
                                           rtol=rtol, atol=atol, err_msg=k)
        for k, v in runs[0][name]["state"].items():
            assert np.array_equal(got["state"][k], v), k


def test_train_round_equals_one_device(single, dp2):
    """Four steps of Trainer.train_round on the host pipeline, dropout
    off: the snapshot every rank ends with, within ROUND_REL."""
    want = single["round"]
    keys = [k for k in want if not bn_cancelled(k)]
    for r in dp2:
        got = r["round"]
        assert rel(np.concatenate([got[k].ravel() for k in keys]),
                   np.concatenate([want[k].ravel() for k in keys])) \
            <= ROUND_REL
        for k in want:
            assert np.array_equal(got[k], dp2[0]["round"][k]), k


def test_pooled_step_equals_one_device(single, dp2):
    """Two pooled steps: every rank holds a pool with the same seed, takes
    its rows of the global draws (blocks, duplicates and shuffles), and
    the first step's loss and gradient and the second step's loss equal
    the single-device run's (blocks drawn otherwise would move the loss
    by O(1))."""
    want = single["pooled"]
    for r in dp2:
        got = r["pooled"]
        np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                                   rtol=STEP_RTOL)
        assert rel(got["grad"], want["grad"]) <= GRAD_REL
        np.testing.assert_allclose(got["losses"][1], want["losses"][1],
                                   rtol=POOLED_SECOND_RTOL)


def test_inference_and_region_means_equal_one_device(single, dp2):
    """InferenceRunner on 2 ranks: every rank holds the whole prediction
    (classes, uncertainties, penult), equal to one device's, and the
    region means of the ranks' retained rows within 1e-6."""
    want = single["inference"]
    for r in dp2:
        got = r["inference"]
        for name, (cls, unc, pen) in want["clouds"].items():
            g_cls, g_unc, g_pen = got["clouds"][name]
            assert np.array_equal(g_cls, cls)
            np.testing.assert_allclose(g_unc, unc, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(g_pen.astype(np.float32),
                                       pen.astype(np.float32), rtol=1e-3,
                                       atol=1e-3)
        np.testing.assert_allclose(got["means"], want["means"], rtol=1e-6,
                                   atol=1e-6)


def test_chamfer_blocks_equal_one_device(single, dp2):
    """The region graph's chamfer with its blocks split over 2 ranks, from
    padded regions and from the block cache: equal."""
    for r in dp2:
        for form in ("padded", "cached"):
            assert np.array_equal(r["chamfer"][form],
                                  single["chamfer"][form]), form


@pytest.mark.parametrize("branch", list(DIVERSITY))
def test_selection_round_picks_equal_one_device(work, single, dp2, branch):
    """One selection round on 2 ranks with each diversity branch (full
    SSDR's gcn_fps, coreGCN, edcd): every rank's state holds the picks of
    the single-device round; rank 0 wrote the files, which equal the
    single-device round's byte for byte."""
    base, _ = work
    want = single[branch]
    for r in dp2:
        got = r[branch]
        assert got["registry"]["unlabeled"].keys() == \
            want["registry"]["unlabeled"].keys()
        for name, unl in want["registry"]["unlabeled"].items():
            assert sorted(got["registry"]["unlabeled"][name]) == sorted(unl)
        for name, gt in want["pseudo"].items():
            assert np.array_equal(got["pseudo"][name], gt)
        assert got["stats"] == want["stats"]
    rd = os.path.join("sampling", "-".join(ssdr_args(DIVERSITY[branch])),
                      "round_2")
    names = sorted(os.listdir(base / "one" / rd))
    assert names == sorted(os.listdir(base / "dp" / rd))
    for f in names:
        with open(base / "one" / rd / f, "rb") as a, \
                open(base / "dp" / rd / f, "rb") as b:
            assert a.read() == b.read(), f


def test_evaluator_equals_one_device(single, dp2):
    """The dp Evaluator, its val_batch_size of 3 rounded up to 4 on 2
    ranks, returns on every rank the (mIoU, OA) of one device evaluating
    batches of 4."""
    for r in dp2:
        np.testing.assert_allclose(r["evaluate"], single["evaluate"],
                                   atol=1e-4)


def test_four_rank_step_matches_jax_mesh(dp4, monkeypatch):
    """The port's step on 4 ranks against JAX's step over its 8-device CPU
    mesh (test_sharding.py), same weights and batch, dropout off on both:
    the loss, the accuracy, the summed gradient against JAX's gradient on
    the mesh, the updated parameters and the BatchNorm running
    statistics (test_torch_train.py's bounds; a Dense bias that feeds a
    train-mode BatchNorm has a gradient of round-off alone and moves by at
    most lr)."""
    runs, tiny = dp4
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    cfg, v, batch = tiny["jcfg"], tiny["variables"], tiny["batch"]
    state = jt.TrainState.create(
        apply_fn=tiny["model"].apply, params=v["params"],
        batch_stats=v["batch_stats"],
        tx=optax.adam(jt.make_lr_schedule(cfg, cfg.train_steps)))
    mesh = make_mesh()
    assert mesh.devices.size == 8
    step = jt.make_train_step(tiny["model"], cfg, np.ones(5, np.float32),
                              knn_engine="xla")
    sharded = shard_batch(batch, mesh)
    new, metrics = step(jax.device_put(state, replicated_sharding(mesh)),
                        sharded, jax.random.PRNGKey(1))
    want = flax_param_dict(new.params, new.batch_stats)

    def loss_fn(params, b):
        (logits, _), _ = tiny["model"].apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            b["features"], jr.build_pyramid(b["xyz"], cfg, engine="xla"),
            True, mutable=["batch_stats"])
        return jr.masked_weighted_ce(logits, b["pseudo"], b["activation"],
                                     b["labels"], np.ones(5, np.float32))[0]

    jgrad = flax_param_dict(jax.jit(jax.grad(loss_fn))(v["params"], sharded),
                            v["batch_stats"])
    before = flax_param_dict(v["params"], v["batch_stats"])
    lr = jt.make_lr_schedule(cfg, cfg.train_steps)(0)
    g_all = max(np.abs(jgrad[k]).max() for k in runs[0]["jax_tiny"]["grad"])
    for r in runs:
        got = r["jax_tiny"]
        np.testing.assert_allclose(got["loss"], float(metrics["loss"]),
                                   rtol=JAX_STEP_RTOL)
        assert abs(got["accuracy"] - float(metrics["accuracy"])) < 1e-6
        for k, g in got["grad"].items():
            w, p = jgrad[k], got["state"][k]
            if bn_cancelled(k):
                assert max(np.abs(g).max(), np.abs(w).max()) <= \
                    1e-6 * g_all, k
                for side in (p, want[k]):
                    assert np.abs(side - before[k]).max() <= \
                        lr * (1 + 1e-5), k
                continue
            dg = JAX_GRAD_TOL * np.abs(w).max()
            assert np.abs(g - w).max() <= dg, k
            step_bound = lr * np.minimum(
                2.0, dg / (np.maximum(np.abs(w) - dg, 0) + ADAM_EPS))
            assert np.all(np.abs(p - want[k])
                          <= step_bound + 1e-6 * np.abs(want[k])), k
        for k in want:
            if "running" in k:
                np.testing.assert_allclose(got["state"][k], want[k],
                                           rtol=JAX_STEP_RTOL,
                                           atol=JAX_STEP_ATOL, err_msg=k)


def test_dryrun_multichip_two_cpu_ranks(launches):
    """The twin of __graft_entry__.dryrun_multichip(2) on two CPU ranks:
    a finite loss, updated parameters equal on both ranks, finite
    selection, chamfer, region-mean and pooled-step results."""
    out = launches["dry"].result()
    assert len(out) == 2
    for r in out:
        assert np.isfinite(r["loss"]) and np.isfinite(r["dp_pooled_loss"])
        assert r["dp_region_means"] == (8, 32)


def test_failed_rank_fails_the_launch(tmp_path):
    """A rank that raises fails the launch with its traceback; the other
    ranks are stopped."""
    with pytest.raises(RuntimeError, match=r"rank \d of 2 failed"):
        launch(dryrun.run_calls, 2, ["cpu"] * 2, str(tmp_path),
               [(dryrun.train_step_result, dict(
                   cfg=CFG, state={}, batch={}, weights=None))])
