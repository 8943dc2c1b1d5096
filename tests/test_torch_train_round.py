"""Trainer.train_round of ssdr_al_torch against the JAX package's: same
weights, the same TrainingPipeline seed and pseudo-GT, dropout the identity
on both sides, 2 epochs of 2 steps with evaluation from the first epoch on,
exact pyramid ("xla")."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdr_al_tpu.data import dataset as j_dataset
from ssdr_al_tpu.data import synthetic as j_syn
from ssdr_al_tpu.models import randlanet as jr
from ssdr_al_tpu.train import evaluator as j_eval
from ssdr_al_tpu.train import trainer as jt
from ssdr_al_torch.data import dataset as t_dataset
from ssdr_al_torch.models import randlanet as tr
from ssdr_al_torch.train import evaluator as t_eval
from ssdr_al_torch.train import trainer as tt
from torch_parity import (
    flax_param_dict,
    identity_dropout,
    random_flax_variables,
    small_cfg,
)

torch.set_num_threads(1)

# Adam's first steps move each parameter by ~lr · sign(g), so an entry
# whose gradient is near 0 may step either way, and the two runs' updates
# drift apart over four steps. Compared: the updates (final − initial) of
# all parameters as one vector, relative L2 (measured 4.5e-2),
# and of the worst single tensor, a BatchNorm bias (measured 0.446). The
# Dense biases that feed a BatchNorm have a zero gradient up to round-off,
# so only Adam's bound (lr per step) holds for them. The mIoU and OA of
# the evaluations agree: the best of the round equal, the first epoch's
# OA 1e-3 apart (measured).
UPDATE_RTOL, TENSOR_UPDATE_RTOL = 0.2, 0.6
MIOU_ATOL = 5e-3


def _bn_cancelled(key):
    return key == "fc0.bias" or key.endswith("dense.bias")


@pytest.fixture(scope="module")
def setup():
    train, val = j_syn.make_dataset(num_train=2, num_val=1, num_points=3000,
                                    seed=0, hard=True)
    cfg = small_cfg(num_points=512, batch_size=2, val_batch_size=2,
                    train_steps=2, val_steps=2, max_epoch=2)
    rng = np.random.RandomState(1)
    pseudo = {c.name: np.stack([
        (rng.rand(c.num_points) < 0.4).astype(np.float32),
        c.labels.astype(np.float32)]) for c in train}
    model = jr.RandLANet(cfg)
    x0 = rng.rand(1, 512, 3).astype(np.float32)
    v = jax.jit(lambda x, f: model.init(
        {"params": jax.random.PRNGKey(0)}, f,
        jr.build_pyramid(x, cfg, engine="xla"), False))(
            jnp.asarray(x0), jnp.asarray(np.concatenate([x0, x0], -1)))
    return train, val, cfg, pseudo, random_flax_variables(v, seed=3)


def test_train_round_matches_jax(setup, tmp_path, monkeypatch):
    train, val, cfg, pseudo, v = setup
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    jlog, tlog = [], []

    jtr = jt.Trainer(cfg, "S3DIS", save_dir=str(tmp_path / "jax"),
                     knn_engine="xla", log_fn=jlog.append)
    jpipe = j_dataset.TrainingPipeline(train, cfg, pseudo_gt=pseudo, seed=5)
    jtr.init_state(jpipe.sample_batch(cfg.batch_size))
    jtr.state = jtr.state.replace(params=v["params"],
                                  batch_stats=v["batch_stats"])
    jres = jtr.train_round(
        1, lambda e: jpipe.batches(cfg.train_steps, cfg.batch_size),
        j_eval.Evaluator(cfg, val, max_epochs=2))

    ttr = tt.Trainer(cfg, "S3DIS", save_dir=str(tmp_path / "torch"),
                     knn_engine="xla", log_fn=tlog.append, device="cpu")
    tpipe = t_dataset.TrainingPipeline(train, cfg, pseudo_gt=pseudo, seed=5)
    ttr.init_state(tpipe.sample_batch(cfg.batch_size))
    ttr.model.load_state_dict(tr.params_from_flax(v["params"],
                                                  v["batch_stats"]))
    ttr.model.dp1 = identity_dropout()
    tres = ttr.train_round(
        1, lambda e: tpipe.batches(cfg.train_steps, cfg.batch_size),
        t_eval.Evaluator(cfg, val, max_epochs=2))

    print("jax", jres, "torch", tres)
    assert abs(tres[0] - jres[0]) <= MIOU_ATOL
    assert abs(tres[1] - jres[1]) <= MIOU_ATOL
    assert 0.0 < tres[0] <= 1.0
    assert ttr.train_state.step == jtr.state.step == 4
    # one train line and one evaluation line per epoch on both sides
    assert [line.split(" | ")[1][:4] for line in tlog] == \
        [line.split(" | ")[1][:4] for line in jlog] == ["epoc", "Best"] * 2

    want = flax_param_dict(jtr.state.params, jtr.state.batch_stats)
    before = flax_param_dict(v["params"], v["batch_stats"])
    got = ttr.model.state_dict()
    lr = cfg.learning_rate
    worst, du_all, dw_all = 0.0, [], []
    for k, _ in ttr.model.named_parameters():
        if _bn_cancelled(k):
            for side in (got[k].numpy(), want[k]):
                assert np.abs(side - before[k]).max() <= 4 * lr * 1.00001, k
            continue
        du, dw = got[k].numpy() - before[k], want[k] - before[k]
        worst = max(worst, float(np.linalg.norm(du - dw)
                                 / np.linalg.norm(dw)))
        du_all.append(du.ravel())
        dw_all.append(dw.ravel())
    du, dw = np.concatenate(du_all), np.concatenate(dw_all)
    rel = float(np.linalg.norm(du - dw) / np.linalg.norm(dw))
    print(f"update relative L2 error {rel:.3e}, worst tensor {worst:.3e}")
    assert rel <= UPDATE_RTOL and worst <= TENSOR_UPDATE_RTOL
    # the best-mIoU snapshot, as the port's torch checkpoint
    snap = tt.restore_checkpoint(ttr.snapshot_path(1), "cpu")
    assert snap.keys() == got.keys()
