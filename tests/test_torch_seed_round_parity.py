"""The seed round's training on ssdr_al_torch and on ssdr_al_tpu, each
through its own cli.seed, on the CPU, from one initial state: JAX's
initializers at key d (`init_variables`), carried into the port with
params_from_flax. Each side's Trainer.init_state is wrapped to load that
state after the side's own init; nothing in either package changes. Both
sides seed their TrainingPipeline with 0, so they train on one stream of
host batches; dropout is the identity on both sides or each side's own
stream.

Small (tier-1): a 2-room hard synthetic partition of ROOM_POINTS points a
room (the port's cli.superpoint, copied to each side), the narrow model
SMALL_MODEL through both CLIs' get_config, f32, the exact pyramid, dropout
the identity and `--max_epoch 2`, so that the best-of-epochs evaluation
and the per-epoch decay both run. Held: the seed files equal, the
record's mIoU and OA within test_torch_train_round.py's MIOU_ATOL and
the parameter updates within its UPDATE_RTOL.

Flagship scale (a `slow` case, or `__main__`): the flagship's partition
and its s = 0 seed set, carried from the twin's card run
(scripts/flagship.py's work directory: data/S3DIS/0.03/{superpoint,
sampling/seed}), the rooms made anew by the CLI's seeded generator, the
full-width model in f32 and engine `window` on both sides (off the TPU
JAX's is its XLA window search in original order, another pyramid than
the port's, which is JAX's TPU one). (a) One step from draw 0, dropout
the identity, on the first batch of the seed round's pipeline: the loss,
each parameter's gradient and update and the BatchNorm statistics
against test_torch_train.py's STEP_RTOL / STEP_ATOL and GRAD_TOL rule,
with each side's f32 gradient against the port's float64 gradient on
its own pyramid and the port's f32 gradient on JAX's pyramid. (b) Draws
d of the whole seed round (`--epochs` epochs of `--steps` steps, dropout
on, each side's own stream), then each side's evaluator on both sides'
snap-1:

    PYTHONPATH=. JAX_PLATFORMS=cpu python \\
        tests/test_torch_seed_round_parity.py --work DIR \\
        [--draws 0,1,2] [--steps N] [--epochs E] [--val_steps V] \\
        [--jobs 3] [--shared_pyramid | --control_engine window_og] \\
        [--write]

--jobs runs the draws in processes of their own; --shared_pyramid has
JAX train and evaluate on the port's pyramids (port_pyramid);
--control_engine runs the port alone on another engine; --write puts the
result into results/record_round_flagship_torch/SUMMARY.md."""

import argparse
import dataclasses
import json
import os
import shutil
import statistics
import time

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssdr_al_tpu.active import state as j_state
from ssdr_al_tpu.cli import common as j_common
from ssdr_al_tpu.cli import seed as j_seed
from ssdr_al_tpu.models import randlanet as jr
from ssdr_al_tpu.train import trainer as jt
from ssdr_al_torch.active import state as t_state
from ssdr_al_torch.cli import common as t_common
from ssdr_al_torch.cli import seed as t_seed
from ssdr_al_torch.cli import superpoint
from ssdr_al_torch.config import ConfigS3DIS
from ssdr_al_torch.models import randlanet as tr
from ssdr_al_torch.scripts.flagship import (
    file_digests,
    read_record,
    working_directory,
)
from ssdr_al_torch.train import trainer as tt
from ssdr_al_torch.train.grad_check import GRAD_ERR_FLOOR, GRAD_ERR_MULTIPLE

from test_torch_flagship_parity import FlaxState, jax_config
from test_torch_train import GRAD_TOL, STEP_ATOL, STEP_RTOL, bn_cancelled
from test_torch_train_round import MIOU_ATOL, UPDATE_RTOL
from torch_parity import (
    flax_from_params,
    flax_param_dict,
    identity_dropout,
    to_torch_pyramid,
)

torch.set_num_threads(1)

REG = "0.03"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED_FILES = os.path.join("sampling", "seed")
# the small workload: 2 hard rooms, the narrow model on 1024-point
# blocks, 5 % of the superpoints seeded, 2 epochs of 2 steps, 2 val steps
ROOM_POINTS = 3000
SMALL_MODEL = dict(num_layers=3, d_out=(8, 16, 32),
                   sub_sampling_ratio=(4, 4, 2))
SMALL_FLAGS = ["--synthetic_rooms", "2", "--synthetic_points",
               str(ROOM_POINTS), "--num_points", "1024", "--train_steps", "2",
               "--max_epoch", "2", "--val_steps", "2", "--seed_percent",
               "0.05", "--knn_engine", "xla"]
# the flagship's seed round: 6 rooms of 150 000 points, 40 960-point
# blocks, 1 % seeded, 40 val steps
FLAG_FLAGS = ["--synthetic_rooms", "6", "--synthetic_points", "150000",
              "--num_points", "40960", "--seed_percent", "0.01",
              "--knn_engine", "window"]
SUMMARY = os.path.join(REPO, "results", "record_round_flagship_torch",
                       "SUMMARY.md")
SECTION = "## The seed round's training in both packages"


def seed_argv(root, flags, steps=None, val_steps=None, epochs=1) -> list:
    """cli.seed's flags (both packages) for the hard synthetic rooms of
    root/data in f32."""
    argv = ["--dataset", "S3DIS", "--data_root", os.path.join(root, "data"),
            "--synthetic", "--reg_strength", REG, "--compute_dtype",
            "float32"] + flags
    if steps is not None:
        argv += ["--train_steps", str(steps), "--max_epoch", str(epochs)]
    if val_steps is not None:
        argv += ["--val_steps", str(val_steps)]
    return argv


def init_variables(cfg, key: int) -> dict:
    """JAX's RandLANet initializers at PRNGKey(key): the flax variables of
    `cfg` (JAX's Config), drawn on a small cloud (the parameters' shapes
    do not depend on the points)."""
    n = int(np.prod(cfg.sub_sampling_ratio)) * cfg.k_n
    xyz = np.random.RandomState(key).rand(1, n, 3).astype(np.float32)
    model = jr.RandLANet(cfg)
    return jax.jit(lambda x, f: model.init(
        {"params": jax.random.PRNGKey(key)}, f,
        jr.build_pyramid(x, cfg, engine="xla"), False))(
            jnp.asarray(xyz), jnp.asarray(np.concatenate([xyz, xyz], -1)))


def _identity(self, x, *args, **kwargs):
    return x


def original_order(pyr, sizes) -> tuple:
    """A port SortedPyramid as numpy arrays of an original-order Pyramid
    (neigh_idx, sub_idx, interp_idx by layer; `sizes`: the layers' point
    counts): layer i holds the block's first sizes[i] points, and its
    sorted row r is original point perm_i[r], perm_i the sorted order
    restricted to them."""
    order = pyr.order.numpy()
    b_n = order.shape[0]
    out = {"neigh": [], "sub": [], "interp": []}
    for i in range(len(sizes)):
        n, m = sizes[i], sizes[i + 1] if i + 1 < len(sizes) else None
        neigh = np.empty(pyr.neigh_idx[i].shape, np.int32)
        sub = np.empty(pyr.sub_idx[i].shape, np.int32)
        interp = np.empty(pyr.interp_idx[i].shape, np.int32)
        for b in range(b_n):
            p = order[b][order[b] < n]
            q = order[b][order[b] < (m or pyr.sub_idx[i].shape[1])]
            neigh[b][p] = p[pyr.neigh_idx[i][b].numpy()]
            sub[b][q] = p[pyr.sub_idx[i][b].numpy()]
            interp[b][p] = q[pyr.interp_idx[i][b].numpy()]
        out["neigh"].append(neigh)
        out["sub"].append(sub)
        out["interp"].append(interp)
    return out["neigh"], out["sub"], out["interp"]


def port_pyramid(xyz, cfg, engine="window"):
    """JAX's build_pyramid in place: the port's `window` pyramid of xyz
    (a jax array [B, N, 3]; JAX's Config `cfg`), built on the host through
    jax.pure_callback and put in original order (original_order), as a
    JAX Pyramid; `engine` is not read."""
    b, n, _ = xyz.shape
    sizes = [n]
    for r in cfg.sub_sampling_ratio:
        sizes.append(sizes[-1] // r)
    tcfg = dataclasses.replace(ConfigS3DIS, **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    k = cfg.k_n
    shapes = (
        [jax.ShapeDtypeStruct((b, sizes[i], k), jnp.int32)
         for i in range(cfg.num_layers)],
        [jax.ShapeDtypeStruct((b, sizes[i + 1], k), jnp.int32)
         for i in range(cfg.num_layers)],
        [jax.ShapeDtypeStruct((b, sizes[i], 1), jnp.int32)
         for i in range(cfg.num_layers)])

    def host(x):
        with torch.no_grad():
            pyr = tr.build_pyramid(torch.as_tensor(np.array(x)), tcfg,
                                   engine="window")
        return original_order(pyr, sizes[:cfg.num_layers])

    neigh, sub, interp = jax.pure_callback(host, shapes, xyz)
    return jr.Pyramid([xyz[:, :sizes[i]] for i in range(cfg.num_layers)],
                      list(neigh), list(sub), list(interp))


def run_seed(pkg, root, partition, argv, key, dropout, mp, small=False,
             shared_pyramid=False):
    """`pkg`'s ("jax" or "torch") cli.seed with the flags `argv` (whose
    data root is root/data) in `root`, on a copy of the partition
    directory `partition` (data/S3DIS/0.03/superpoint), its Trainer's
    initial state JAX's at `key`; with dropout False the identity; with
    shared_pyramid JAX's trainer builds every pyramid as port_pyramid.
    Returns {miou, oa (the record's), trainer, exp (its Experiment), init
    (the flax variables), final and snap ({name: array} of the parameters
    and statistics at the round's end and of its best-mIoU snap-1),
    seed_files (digests), seconds}."""
    shutil.rmtree(root, ignore_errors=True)
    data_path = os.path.join(root, "data", "S3DIS", REG)
    shutil.copytree(partition, os.path.join(data_path, "superpoint"))
    got = {}
    mp.setattr(fnn.Dropout, "__call__",
               fnn.Dropout.__call__ if dropout else _identity)
    if pkg == "jax":
        cli, trainer_cls = j_common, jt.Trainer
    else:
        cli, trainer_cls = t_common, tt.Trainer
    init = trainer_cls.init_state

    def wrapped(self, *args, **kwargs):
        init(self, *args, **kwargs)
        v = init_variables(jax_config(self.cfg), key)
        got.update(trainer=self, init=v)
        if pkg == "jax":
            self.state = self.state.replace(params=v["params"],
                                            batch_stats=v["batch_stats"])
            return self.state
        self.model.load_state_dict(tr.params_from_flax(v["params"],
                                                       v["batch_stats"]))
        if not dropout:
            self.model.dp1 = identity_dropout()
        return self.state

    mp.setattr(trainer_cls, "init_state", wrapped)
    if shared_pyramid and pkg == "jax":
        mp.setattr(jt, "build_pyramid", port_pyramid)
    if small:
        base = cli.get_config
        mp.setattr(cli, "get_config", lambda name: dataclasses.replace(
            base(name), **SMALL_MODEL))
    t0 = time.perf_counter()
    with working_directory(root):
        if pkg == "jax":
            p = argparse.ArgumentParser()
            j_common.add_common_args(p)
            p.add_argument("--seed_percent", type=float, default=0.01)
            j_seed.run_seed(p.parse_args(argv))
            got["exp"] = j_common.setup_experiment(p.parse_args(argv))
        else:
            args = t_seed.parser().parse_args(argv + ["--device", "cpu"])
            t_seed.run_seed(args)
            got["exp"] = t_common.setup_experiment(args)
    seconds = time.perf_counter() - t0
    rec = read_record(os.path.join(root, "record_round"))[1]
    trainer = got["trainer"]
    if pkg == "jax":
        final = flax_param_dict(trainer.state.params,
                                trainer.state.batch_stats)
    else:
        final = {k: v.detach().numpy().copy()
                 for k, v in trainer.model.state_dict().items()}
    snap = {k: v.numpy() for k, v in tt.restore_checkpoint(
        trainer.snapshot_path(1), "cpu").items()}
    return dict(got, miou=rec["best_miou"], oa=rec["best_OA"], final=final,
                snap=snap,
                seed_files=file_digests(os.path.join(data_path, SEED_FILES)),
                seconds=seconds)


def updates_apart(side, ref, before, lr_steps) -> tuple:
    """(relative L2 of the two sides' parameter updates as one vector,
    worst single tensor's); the Dense biases that feed a BatchNorm, whose
    gradients are 0 up to round-off, are held to Adam's bound instead
    (lr_steps: the sum of the learning rates over the steps)."""
    du_all, dw_all, worst = [], [], 0.0
    for k in before:
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        if bn_cancelled(k):
            for s in (side[k], ref[k]):
                assert np.abs(s - before[k]).max() <= lr_steps * 1.00001, k
            continue
        du, dw = side[k] - before[k], ref[k] - before[k]
        worst = max(worst, float(np.linalg.norm(du - dw) /
                                 max(np.linalg.norm(dw), 1e-30)))
        du_all.append(du.ravel())
        dw_all.append(dw.ravel())
    du, dw = np.concatenate(du_all), np.concatenate(dw_all)
    return float(np.linalg.norm(du - dw) / np.linalg.norm(dw)), worst


# ------------------------------------------------------- the small case ---


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """(jax run, torch run) of the small seed round from one state."""
    root = str(tmp_path_factory.mktemp("seed_round_parity"))
    mp = pytest.MonkeyPatch()
    try:
        base = t_common.get_config
        mp.setattr(t_common, "get_config", lambda name: dataclasses.replace(
            base(name), **SMALL_MODEL))
        args = superpoint.parser().parse_args(
            seed_argv(root, SMALL_FLAGS[:4]) + ["--device", "cpu"])
        superpoint.run_superpoint(args)
        mp.undo()
        partition = os.path.join(root, "data", "S3DIS", REG, "superpoint")
        runs = {pkg: run_seed(pkg, os.path.join(root, pkg), partition,
                              seed_argv(os.path.join(root, pkg),
                                        SMALL_FLAGS), 0, False, mp,
                              small=True) for pkg in ("jax", "torch")}
    finally:
        mp.undo()
    return runs


def test_both_seed_rounds_label_the_same_seed_set(small):
    assert small["jax"]["seed_files"] == small["torch"]["seed_files"]
    assert small["jax"]["seed_files"]


def test_both_seed_rounds_score_alike(small):
    """The record's best mIoU and OA of the two epochs' evaluations, and
    four steps (2 epochs of 2) on both sides."""
    j, t = small["jax"], small["torch"]
    print("jax", j["miou"], j["oa"], "torch", t["miou"], t["oa"])
    assert abs(t["miou"] - j["miou"]) <= MIOU_ATOL
    assert abs(t["oa"] - j["oa"]) <= MIOU_ATOL
    assert 0.0 < t["miou"] <= 1.0
    assert t["trainer"].train_state.step == int(j["trainer"].state.step) == 4


def test_both_seed_rounds_update_alike(small):
    """The parameter updates of the whole round (4 steps, the learning
    rate decayed once) within UPDATE_RTOL, as one vector."""
    j, t = small["jax"], small["torch"]
    before = flax_param_dict(j["init"]["params"], j["init"]["batch_stats"])
    cfg = j["trainer"].cfg
    lr_steps = 2 * cfg.learning_rate * (1 + cfg.lr_decay)
    rel, worst = updates_apart(t["final"], j["final"], before, lr_steps)
    print(f"update relative L2 error {rel:.3e}, worst tensor {worst:.3e}")
    assert rel <= UPDATE_RTOL


def test_port_pyramid_gives_jax_the_port_neighbourhoods():
    """JAX's forward on port_pyramid (the port's `window` pyramid put in
    original order) gives the port's logits on its own sorted pyramid, at
    the narrow model on 2 x 8192 points."""
    cfg = dataclasses.replace(jax_config(ConfigS3DIS), num_points=8192,
                              **SMALL_MODEL)
    rng = np.random.RandomState(0)
    xyz = (rng.rand(2, 8192, 3) * 4).astype(np.float32)
    feats = np.concatenate([xyz, rng.rand(2, 8192, 3).astype(np.float32)],
                           -1)
    v = init_variables(cfg, 3)
    pyr = jax.jit(lambda x: port_pyramid(x, cfg))(jnp.asarray(xyz))
    want, _ = jax.jit(jr.RandLANet(cfg).apply)(v, jnp.asarray(feats), pyr)
    tcfg = dataclasses.replace(ConfigS3DIS, num_points=8192, **SMALL_MODEL)
    tm = tr.RandLANet(tcfg)
    tm.load_state_dict(tr.params_from_flax(v["params"], v["batch_stats"]))
    tm.eval()
    with torch.no_grad():
        got, _ = tm(torch.as_tensor(feats), tr.build_pyramid(
            torch.as_tensor(xyz), tcfg, engine="window"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=STEP_RTOL, atol=STEP_ATOL)


# ------------------------------------------------- the flagship's size ---


def first_batch(exp, pkg, seed=0):
    """The first training batch of `pkg`'s seed-round pipeline (after the
    sample batch cli.seed hands to init_state)."""
    cli, state_mod = ((j_common, j_state) if pkg == "jax"
                      else (t_common, t_state))
    state = state_mod.ALState(exp.data_path, ["seed"])
    pipe = cli.make_training_pipeline(exp, pseudo_gt=cli.pseudo_gt_for_round(
        state, state.round_dir(1), exp.train_clouds), seed=seed)
    pipe.sample_batch(exp.cfg.batch_size)
    return next(iter(pipe.batches(1, exp.cfg.batch_size)))


def port_gradient(cfg, v, batch, weights, pyr, dtype=torch.float64) -> dict:
    """{parameter: gradient} of the port's model in `dtype` from the flax
    variables `v` on a port pyramid `pyr` (Pyramid, or SortedPyramid,
    whose forward sorts the features itself and leaves the logits in its
    order, the labels then taken in that order), dropout off, with the
    trainer's loss."""
    order = getattr(pyr, "order", None)

    def rows(key, dtype):
        x = torch.as_tensor(np.asarray(batch[key]), dtype=dtype)
        return x if order is None or x.dim() != 2 else torch.gather(
            x, 1, order.long())

    model = tr.RandLANet(cfg).to(dtype)
    model.load_state_dict(tr.params_from_flax(v["params"], v["batch_stats"]))
    model.train()
    model.dp1 = identity_dropout()
    p = dataclasses.replace(pyr, xyz=[x.to(dtype) for x in pyr.xyz])
    logits, _ = model(rows("features", dtype), p,
                      **({} if order is None else {"unsort": False}))
    table = (tr.label_reduce_table(cfg.num_classes, cfg.ignored_label_inds)
             if cfg.ignored_label_inds else None)
    loss, _ = tr.masked_weighted_ce(
        logits, rows("pseudo", torch.int64), rows("activation",
                                                  torch.float32),
        rows("labels", torch.int64), weights, cfg.ignored_label_inds, table)
    loss.backward()
    return {k: q.grad.numpy() for k, q in model.named_parameters()}


def gradient_gaps(got: dict, want: dict) -> dict:
    """{rel_l2 (all parameters as one vector), worst (the largest of each
    tensor's max |got - want| over its max |want|), worst_at}."""
    keys = [k for k in want if k in got and not bn_cancelled(k)
            and not k.endswith(("running_mean", "running_var"))]
    per = {k: float(np.abs(got[k] - want[k]).max() /
                    max(np.abs(want[k]).max(), 1e-30)) for k in keys}
    a = np.concatenate([np.asarray(got[k], np.float64).ravel() for k in keys])
    b = np.concatenate([np.asarray(want[k], np.float64).ravel()
                        for k in keys])
    worst = max(per, key=per.get)
    return dict(rel_l2=float(np.linalg.norm(a - b) / np.linalg.norm(b)),
                worst=per[worst], worst_at=worst)


def one_step(exp_t, exp_j, engine, log=print) -> dict:
    """(a): one step of each side from draw 0's state, dropout the
    identity, on the seed round's first batch (both pipelines' batches
    equal). Returns the errors: loss, the worst gradient error over its
    tensor's largest, the update errors past what that allows through
    Adam's first step, the BatchNorm statistics'."""
    batch = first_batch(exp_t, "torch")
    jbatch = first_batch(exp_j, "jax")
    for k in batch:
        np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)
    cfg = exp_t.cfg
    jcfg = jax_config(cfg)
    weights = t_common.experiment_class_weights(exp_t)
    np.testing.assert_array_equal(weights,
                                  j_common.experiment_class_weights(exp_j))
    v = init_variables(jcfg, 0)
    model = jr.RandLANet(jcfg)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", _identity)
        state = jt.TrainState.create(
            apply_fn=model.apply, params=v["params"],
            batch_stats=v["batch_stats"],
            tx=optax.adam(jt.make_lr_schedule(jcfg, cfg.train_steps)))
        step = jt.make_train_step(model, jcfg, weights, knn_engine=engine)
        jb = {k: jnp.asarray(x) for k, x in batch.items()}
        t0 = time.perf_counter()
        new, metrics = step(state, jb, jax.random.PRNGKey(1))
        jax.block_until_ready(new.params)
        out["jax_step_s"] = time.perf_counter() - t0
        want = flax_param_dict(new.params, new.batch_stats)
        pyr = jr.build_pyramid(jb["xyz"], jcfg, engine=engine)

        def loss_fn(params):
            (logits, _), _ = model.apply(
                {"params": params, "batch_stats": v["batch_stats"]},
                jb["features"], pyr, True, mutable=["batch_stats"])
            return jr.masked_weighted_ce(
                logits, jb["pseudo"].astype(jnp.int32),
                jb["activation"].astype(jnp.float32),
                jb["labels"].astype(jnp.int32), weights,
                jcfg.ignored_label_inds,
                jr.label_reduce_table(jcfg.num_classes,
                                      jcfg.ignored_label_inds)
                if jcfg.ignored_label_inds else None)[0]

        jgrad = flax_param_dict(jax.jit(jax.grad(loss_fn))(v["params"]),
                                v["batch_stats"])
    tm = tr.RandLANet(cfg)
    tm.load_state_dict(tr.params_from_flax(v["params"], v["batch_stats"]))
    tm.dp1 = identity_dropout()
    ts = tt.create_train_state(tm, cfg, cfg.train_steps)
    t0 = time.perf_counter()
    ts, tmet = tt.make_train_step(tm, cfg, weights, engine, device="cpu")(
        ts, batch, None)
    out["torch_step_s"] = time.perf_counter() - t0
    before = flax_param_dict(v["params"], v["batch_stats"])
    got = tm.state_dict()
    lr = cfg.learning_rate
    out.update(loss_jax=float(metrics["loss"]), loss_torch=float(
        tmet["loss"]))
    out["loss_rel"] = abs(out["loss_torch"] - out["loss_jax"]) / abs(
        out["loss_jax"])
    g_all = max(np.abs(jgrad[k]).max() for k, _ in tm.named_parameters())
    grad_rel, update_excess, cancelled = {}, {}, {}
    for k, p in tm.named_parameters():
        g, w = p.grad.numpy(), jgrad[k]
        if bn_cancelled(k):
            cancelled[k] = max(
                float(max(np.abs(g).max(), np.abs(w).max()) / g_all),
                *(float(np.abs(s - before[k]).max() / lr)
                  for s in (got[k].numpy(), want[k])))
            continue
        dg = GRAD_TOL * np.abs(w).max()
        grad_rel[k] = float(np.abs(g - w).max() / np.abs(w).max())
        step_bound = lr * np.minimum(
            2.0, dg / (np.maximum(np.abs(w) - dg, 0) + tt.ADAM_EPS))
        update_excess[k] = float(np.max(
            np.abs(got[k].numpy() - want[k])
            - step_bound - 1e-6 * np.abs(want[k])))
    bn = {}
    for name in [n for n in want if n.endswith(("running_mean",
                                                "running_var"))]:
        err = np.abs(got[name].numpy() - want[name])
        bn[name] = float(np.max(err - STEP_RTOL * np.abs(want[name])))
    # each side's f32 gradient against the port's float64 gradient on
    # that side's own pyramid (a fault of the port's arithmetic would put
    # JAX's f32 gradient far from it while the port's stays near its own);
    # the port's f32 gradient on JAX's pyramid against JAX's (the
    # arithmetic alone); the float64 gradients on the two pyramids (the
    # pyramids alone)
    tgrad = {k: q.grad.numpy() for k, q in tm.named_parameters()}
    with torch.no_grad():
        tpyr = tr.build_pyramid(torch.as_tensor(batch["xyz"]), cfg,
                                engine=engine)
    jpyr = to_torch_pyramid(jax.tree_util.tree_map(np.asarray, pyr))
    g64 = {name: port_gradient(cfg, v, batch, weights, p)
           for name, p in (("torch", tpyr), ("jax", jpyr))}
    out["torch_f32_to_f64"] = gradient_gaps(tgrad, g64["torch"])
    out["jax_f32_to_f64"] = gradient_gaps(jgrad, g64["jax"])
    out["torch_to_jax"] = gradient_gaps(tgrad, jgrad)
    out["torch_to_jax_on_jax_pyramid"] = gradient_gaps(port_gradient(
        cfg, v, batch, weights, jpyr, torch.float32), jgrad)
    out["pyramids_f64"] = gradient_gaps(g64["torch"], g64["jax"])
    out.update(
        grad_rel_max=max(grad_rel.values()),
        grad_rel_worst=max(grad_rel, key=grad_rel.get),
        update_excess_max=max(update_excess.values()),
        bn_excess_max=max(bn.values()),
        cancelled_max=max(cancelled.values(), default=0.0),
        within=bool(out["loss_rel"] <= STEP_RTOL
                    and max(grad_rel.values()) <= GRAD_TOL
                    and max(update_excess.values()) <= 0
                    and max(bn.values()) <= STEP_ATOL))
    log(json.dumps({"one_step": engine, **out}))
    return out


def evaluate(pkg, run, final) -> tuple:
    """`pkg`'s evaluator (a fresh one, as cli.seed makes) on the
    parameters `final` ({port name: array}) with its trainer's eval step:
    (mIoU, OA)."""
    exp, trainer = run["exp"], run["trainer"]
    if pkg == "jax":
        v = flax_from_params({k: torch.from_numpy(x) for k, x in
                              final.items()})
        state = FlaxState(params=jax.tree_util.tree_map(jnp.asarray,
                                                        v["params"]),
                          batch_stats=jax.tree_util.tree_map(
                              jnp.asarray, v["batch_stats"]))
        return j_common.make_evaluator(exp)(trainer.eval_step, state)
    sd = {k: torch.from_numpy(x) for k, x in final.items()}
    return t_common.make_evaluator(exp)(trainer.eval_step, sd)


def flagship_scale(work, scratch, draws=(0, 1, 2), steps=500, val_steps=40,
                   epochs=1, log=print, shared_pyramid=False) -> dict:
    """(b) at the flagship's partition and s = 0 seed set from `work`
    (data/S3DIS/0.03/{superpoint, sampling/seed}), `epochs` epochs of
    `steps` steps a draw, and (a) with draw 0; with shared_pyramid, JAX
    trains and evaluates on the port's pyramids (port_pyramid) and (a) is
    not run. Returns {one_step: (a)'s
    errors (with draw 0), draws: [{d, jax: {miou, oa, seconds}, torch:
    {...}, cross: {"<evaluator> on <model>": (miou, oa)}}] (each side's
    evaluator on each side's snap-1), steps, epochs, val_steps}."""
    carried = os.path.join(work, "data", "S3DIS", REG)
    partition = os.path.join(carried, "superpoint")
    want_seed = file_digests(os.path.join(carried, SEED_FILES))
    out = dict(steps=steps, epochs=epochs, val_steps=val_steps, draws=[],
               shared_pyramid=shared_pyramid)
    for d in draws:
        runs = {}
        for pkg in ("torch", "jax"):
            root = os.path.join(scratch, f"{pkg}{'-shared' * shared_pyramid}"
                                f"-d{d}")
            with pytest.MonkeyPatch.context() as mp:
                runs[pkg] = run_seed(pkg, root, partition, seed_argv(
                    root, FLAG_FLAGS, steps, val_steps, epochs), d, True,
                    mp, shared_pyramid=shared_pyramid)
            if runs[pkg]["seed_files"] != want_seed:
                raise ValueError(f"{pkg}'s seed set is not the carried s = 0 "
                                 "set")
            log(json.dumps({"draw": d, "pkg": pkg, "miou": runs[pkg]["miou"],
                            "oa": runs[pkg]["oa"],
                            "seconds": runs[pkg]["seconds"]}))
        if d == 0 and not shared_pyramid:
            out["one_step"] = one_step(runs["torch"]["exp"],
                                       runs["jax"]["exp"], "window", log)
        cross = {}
        for ev in ("torch", "jax"):
            for model in ("torch", "jax"):
                with pytest.MonkeyPatch.context() as mp:
                    if shared_pyramid:
                        mp.setattr(jt, "build_pyramid", port_pyramid)
                    cross[f"{ev} on {model}"] = evaluate(
                        ev, runs[ev], runs[model]["snap"])
                log(json.dumps({"draw": d, "evaluator": ev, "model": model,
                                "miou_oa": cross[f"{ev} on {model}"]}))
        out["draws"].append(dict(d=d, cross=cross, **{
            pkg: {k: runs[pkg][k] for k in ("miou", "oa", "seconds")}
            for pkg in runs}))
    return out


def pyramid_check(work, scratch, log=print) -> dict:
    """The pyramids of the seed round's first batch [2 × 40960] at the
    flagship's partition: the port's `window` pyramid against JAX's TPU
    one (`_pyramid_window_sorted_single`, its Pallas kernels in interpret
    mode) and the port's `window_og` against JAX's `window` off the TPU
    (its XLA window search): per layer and batch row, the share of
    neigh_idx, sub_idx and interp_idx entries that differ, and of those
    the share that are not near-ties (torch_parity.NEAR_TIE_REL); with
    each build's seconds."""
    from torch_parity import NEAR_TIE_REL, interpret, sorted_d2

    root = os.path.join(scratch, "pyramids")
    shutil.rmtree(root, ignore_errors=True)
    for sub in ("superpoint", SEED_FILES):
        shutil.copytree(os.path.join(work, "data", "S3DIS", REG, sub),
                        os.path.join(root, "data", "S3DIS", REG, sub))
    exp = t_common.setup_experiment(t_seed.parser().parse_args(
        seed_argv(root, FLAG_FLAGS) + ["--device", "cpu"]))
    xyz = first_batch(exp, "torch")["xyz"]
    cfg, jcfg = exp.cfg, jax_config(exp.cfg)
    sizes = [cfg.num_points]
    for r in cfg.sub_sampling_ratio:
        sizes.append(sizes[-1] // r)
    seconds, built = {}, {}
    for name, build in (
            ("port window", lambda: tr.build_pyramid(
                torch.as_tensor(xyz), cfg, engine="window")),
            ("port window_og", lambda: tr.build_pyramid(
                torch.as_tensor(xyz), cfg, engine="window_og")),
            ("JAX TPU window", lambda: to_torch_pyramid(jax.jit(jax.vmap(
                lambda x: jr._pyramid_window_sorted_single(x, jcfg)))(
                    jnp.asarray(xyz)))),
            ("JAX CPU window", lambda: to_torch_pyramid(jax.jit(
                lambda x: jr.build_pyramid(x, jcfg, engine="window"))(
                    jnp.asarray(xyz))))):
        t0 = time.perf_counter()
        with interpret():
            built[name] = build()
        seconds[name] = time.perf_counter() - t0

    def rows(p, b, i):
        """Layer i's points in p's row order, and its next layer's."""
        x = xyz[b]
        if isinstance(p, tr.SortedPyramid):
            order = p.order[b].numpy()
            return (x[order[order < sizes[i]]],
                    x[order[order < sizes[i + 1]]])
        return x[:sizes[i]], x[:sizes[i + 1]]

    out = dict(seconds=seconds)
    for got, want in (("port window", "JAX TPU window"),
                      ("port window_og", "JAX CPU window")):
        gaps = []
        for b in range(xyz.shape[0]):
            for i in range(cfg.num_layers):
                x, nxt = rows(built[got], b, i)
                for f, q, sup in (("neigh_idx", x, x), ("sub_idx", nxt, x),
                                  ("interp_idx", x, nxt)):
                    a = getattr(built[got], f)[i][b].numpy()
                    w = getattr(built[want], f)[i][b].numpy()
                    diff = a != w
                    da, dw = sorted_d2(q, sup, a), sorted_d2(q, sup, w)
                    far = diff & (np.abs(da - dw) > NEAR_TIE_REL * np.maximum(
                        np.maximum(da, dw), 1e-30) + 1e-12)
                    gaps.append(dict(b=b, layer=i, field=f,
                                     differ=float(diff.mean()),
                                     not_near_ties=float(far.mean())))
        out[f"{got} against {want}"] = gaps
    log(json.dumps({"pyramids": out}))
    return out


def port_control(work, scratch, draws, steps, val_steps, epochs, engine,
                 log=print) -> list:
    """The port's seed round alone on the `engine` pyramid (window_og:
    the original-order window search that JAX's `window` takes off the
    TPU) at flagship_scale's draws: [{d, miou, oa, seconds}]."""
    partition = os.path.join(work, "data", "S3DIS", REG, "superpoint")
    flags = FLAG_FLAGS[:-1] + [engine]
    out = []
    for d in draws:
        root = os.path.join(scratch, f"torch-{engine}-d{d}")
        with pytest.MonkeyPatch.context() as mp:
            run = run_seed("torch", root, partition, seed_argv(
                root, flags, steps, val_steps, epochs), d, True, mp)
        out.append(dict(d=d, miou=run["miou"], oa=run["oa"],
                        seconds=run["seconds"]))
        log(json.dumps({"control": engine, **out[-1]}))
    return out


def verdict(result) -> dict:
    """(3)'s figures: (a) within tolerance, each side's seed mIoU over the
    draws, and whether JAX's median lies within the port's [min, max]."""
    j = [r["jax"]["miou"] for r in result["draws"]]
    t = [r["torch"]["miou"] for r in result["draws"]]
    return dict(one_step_within=result.get("one_step", {}).get("within"),
                jax=j, torch=t,
                jax_median=statistics.median(j),
                median_inside=min(t) <= statistics.median(j) <= max(t))


def one_step_text(a) -> str:
    """(a)'s paragraph of section()."""
    if a is None:
        return "(a) not run (it runs with draw 0)."
    gaps = "; ".join(
        f"{name} relative L2 {a[k]['rel_l2']:.2e}, worst tensor "
        f"{a[k]['worst']:.2e} ({a[k]['worst_at']})" for name, k in (
            ("port f32 to port f64 on the port's pyramid",
             "torch_f32_to_f64"),
            ("JAX f32 to port f64 on JAX's pyramid", "jax_f32_to_f64"),
            ("port f32 to JAX f32 on JAX's pyramid",
             "torch_to_jax_on_jax_pyramid"),
            ("port f64 on the two pyramids", "pyramids_f64")))
    return (f"(a) One step from draw 0, dropout the identity: loss JAX "
            f"{a['loss_jax']:.7f}, port {a['loss_torch']:.7f} (relative "
            f"{a['loss_rel']:.2e}, tolerance {STEP_RTOL:g}); worst "
            f"gradient error {a['grad_rel_max']:.2e} of its tensor's "
            f"largest ({a['grad_rel_worst']}, tolerance {GRAD_TOL:g}); "
            f"update error past Adam's allowance "
            f"{a['update_excess_max']:.2e}; BatchNorm statistics past "
            f"{STEP_RTOL:g} relative {a['bn_excess_max']:.2e} (tolerance "
            f"{STEP_ATOL:g}): {'within' if a['within'] else 'outside'} "
            f"tolerance. Gradients (parameters as one vector, and the worst "
            f"tensor's max error over its max): {gaps}.")


def section(result, command, control=None, title=SECTION) -> str:
    """The markdown of flagship_scale's result for SUMMARY.md, with the
    port's rows of port_control (`control`: {engine: rows}) if given."""
    a, v = result.get("one_step"), verdict(result)
    pyramids = ("JAX training and evaluating on the port's `window` "
                "pyramids (port_pyramid)" if result.get("shared_pyramid")
                else "engine `window` on both sides")
    lines = [title, "",
             "Both packages' cli.seed at this run's partition and its s = 0 "
             f"seed set (carried from the card), f32, {pyramids}, on the "
             "CPU; draw d starts both from JAX's "
             f"initializers at key d; {result['epochs']} epoch(s) of "
             f"{result['steps']} steps and {result['val_steps']} val steps a "
             "draw "
             "(tests/test_torch_seed_round_parity.py).", "",
             f"Command: `{command}`.", "",
             one_step_text(a), "",
             "(b) Each draw's seed round (dropout on, each side's own "
             "stream), then each side's evaluator on both sides' snap-1:",
             "", "| draw | JAX mIoU / OA | port mIoU / OA | JAX evaluator on "
             "JAX model | JAX evaluator on port model | port evaluator on "
             "JAX model | port evaluator on port model | JAX s / port s |",
             "| --- | --- | --- | --- | --- | --- | --- | --- |"]
    for r in result["draws"]:
        c = r["cross"]
        lines.append(
            f"| {r['d']} | {r['jax']['miou']:.4f} / {r['jax']['oa']:.4f} | "
            f"{r['torch']['miou']:.4f} / {r['torch']['oa']:.4f} | " +
            " | ".join(f"{c[k][0]:.4f} / {c[k][1]:.4f}" for k in (
                "jax on jax", "jax on torch", "torch on jax",
                "torch on torch")) +
            f" | {r['jax']['seconds']:.0f} / {r['torch']['seconds']:.0f} |")
    lines += ["", f"JAX's seed mIoU median {v['jax_median']:.4f} "
              f"{'inside' if v['median_inside'] else 'outside'} the port's "
              f"[{min(v['torch']):.4f}, {max(v['torch']):.4f}]."]
    for engine, rows in (control or {}).items():
        lines += ["", f"The port's seed round alone on engine `{engine}` "
                  "(port_control), the same draws: " + ", ".join(
                      f"d = {r['d']} {r['miou']:.4f} / {r['oa']:.4f}"
                      for r in rows) + " (mIoU / OA)."]
    return "\n".join(lines) + "\n"


def write_section(path, text):
    """Put `text` at the end of `path`, in place of an earlier copy."""
    with open(path) as f:
        old = f.read()
    keep = old.split(SECTION)[0].rstrip("\n")
    with open(path, "w") as f:
        f.write(keep + "\n\n" + text)


def arithmetic_holds(result) -> dict:
    """What separates a fault of the port from the two packages' window
    pyramids: (a)'s loss within STEP_RTOL; on JAX's pyramid, the port's
    f32 gradient as near JAX's as GRAD_ERR_MULTIPLE times the larger of
    the two sides' own f32 errors to the float64 gradient (plus
    GRAD_ERR_FLOOR, train/grad_check.py's rule); each side's evaluator
    on each draw's models within MIOU_ATOL of the other's."""
    a = result["one_step"]
    own = max(a["torch_f32_to_f64"]["rel_l2"], a["jax_f32_to_f64"]["rel_l2"])
    evals = max(abs(r["cross"][f"torch on {m}"][i] - r["cross"][
        f"jax on {m}"][i]) for r in result["draws"] for m in ("torch", "jax")
        for i in (0, 1))
    return dict(loss=a["loss_rel"] <= STEP_RTOL,
                gradient=a["torch_to_jax_on_jax_pyramid"]["rel_l2"]
                <= GRAD_ERR_MULTIPLE * own + GRAD_ERR_FLOOR,
                evaluators=evals <= MIOU_ATOL, evaluator_gap=evals)


@pytest.mark.slow
def test_flagship_seed_round_arithmetic_matches_jax(tmp_path):
    """flagship_scale from the work directory in SSDR_FLAGSHIP_WORK, at
    8 steps x 4 epochs and 8 val steps a draw: arithmetic_holds. The
    decision figures ((a) within the step tolerances, JAX's seed mIoU
    median within the port's range) are printed, not held: the two
    `window` engines build other pyramids off the TPU."""
    work = os.environ.get("SSDR_FLAGSHIP_WORK")
    if not work:
        pytest.skip("SSDR_FLAGSHIP_WORK names no work directory")
    result = flagship_scale(work, str(tmp_path), steps=8, val_steps=8,
                            epochs=4)
    print(json.dumps(verdict(result)))
    held = arithmetic_holds(result)
    assert held["loss"] and held["gradient"] and held["evaluators"], held


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", required=True,
                    help="directory holding the twin's data/S3DIS/0.03/"
                         "{superpoint, sampling/seed}")
    ap.add_argument("--draws", default="0,1,2")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--val_steps", type=int, default=40)
    ap.add_argument("--scratch", default=os.path.join(REPO, "build",
                                                      "seed_round_parity"))
    ap.add_argument("--threads", type=int, default=4,
                    help="torch's threads (in each process)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="run the draws in this many processes at once")
    ap.add_argument("--json", default="",
                    help="also write the result as JSON to this path")
    ap.add_argument("--shared_pyramid", action="store_true",
                    help="JAX trains and evaluates on the port's window "
                         "pyramids (port_pyramid); (a) is not run")
    ap.add_argument("--pyramids", action="store_true",
                    help="only compare the first batch's pyramids "
                         "(pyramid_check)")
    ap.add_argument("--control_engine", default="",
                    help="run only the port's seed rounds, on this engine "
                         "(window_og: the pyramid JAX's window takes off "
                         "the TPU), and print their figures")
    ap.add_argument("--write", action="store_true",
                    help="put the result into " + SUMMARY)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    draws = [int(d) for d in args.draws.split(",")]
    if args.pyramids:
        pyramid_check(args.work, args.scratch)
        return
    if args.control_engine:
        rows = port_control(args.work, args.scratch, draws, args.steps,
                            args.val_steps, args.epochs, args.control_engine)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(rows, f)
        return
    if args.jobs > 1 and len(draws) > 1:
        result = in_processes(args, draws)
    else:
        result = flagship_scale(args.work, args.scratch, draws, args.steps,
                                args.val_steps, args.epochs,
                                shared_pyramid=args.shared_pyramid)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f)
    text = section(result, "PYTHONPATH=. JAX_PLATFORMS=cpu python "
                   "tests/test_torch_seed_round_parity.py --work <the twin's "
                   f"work directory> --draws {args.draws} --steps "
                   f"{args.steps} --epochs {args.epochs} --val_steps "
                   f"{args.val_steps} --jobs {args.jobs}"
                   + " --shared_pyramid" * args.shared_pyramid + " --write")
    print(text)
    print(json.dumps({"result": result, "verdict": verdict(result), **(
        {"arithmetic": arithmetic_holds(result)} if "one_step" in result
        else {})}))
    if args.write:
        write_section(SUMMARY, text)


def in_processes(args, draws) -> dict:
    """flagship_scale's result over `draws`, each draw in a process of its
    own (args.jobs at a time), merged in the order of `draws`."""
    import subprocess
    import sys

    os.makedirs(args.scratch, exist_ok=True)
    paths = {d: os.path.join(args.scratch, f"draw{d}"
                             f"{'-shared' * args.shared_pyramid}.json")
             for d in draws}
    pending, running = list(draws), []
    while pending or running:
        while pending and len(running) < args.jobs:
            d = pending.pop(0)
            running.append((d, subprocess.Popen([
                sys.executable, os.path.abspath(__file__), "--work",
                args.work, "--draws", str(d), "--steps", str(args.steps),
                "--epochs", str(args.epochs), "--val_steps",
                str(args.val_steps), "--scratch", args.scratch, "--threads",
                str(args.threads), "--json", paths[d]]
                + ["--shared_pyramid"] * args.shared_pyramid)))
        d, proc = running.pop(0)
        if proc.wait():
            raise RuntimeError(f"draw {d} failed ({proc.returncode})")
    parts = []
    for d in draws:
        with open(paths[d]) as f:
            parts.append(json.load(f))
    out = dict(parts[0], draws=[r for p in parts for r in p["draws"]])
    one = [p["one_step"] for p in parts if "one_step" in p]
    if one:
        out["one_step"] = one[0]
    return out


if __name__ == "__main__":
    main()
