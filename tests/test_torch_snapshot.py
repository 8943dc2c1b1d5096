"""JAX snapshots read by the port without flax (ssdr_al_torch/train/
flax_snapshot.py): the file ssdr_al_tpu's save_checkpoint writes after a
JAX train step loads through restore_checkpoint, Trainer.restore_model
and cli.evaluate --snapshot, and the port's eval forward from it equals
JAX's; the decoder agrees with msgpack and refuses a truncated file."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch

from ssdr_al_tpu.config import ConfigS3DIS as JConfigS3DIS
from ssdr_al_tpu.models import randlanet as jr
from ssdr_al_tpu.train import trainer as jt
from ssdr_al_torch.cli import evaluate
from ssdr_al_torch.cli.common import setup_experiment
from ssdr_al_torch.models import randlanet as tr
from ssdr_al_torch.train import flax_snapshot
from ssdr_al_torch.train import trainer as tt
from torch_parity import random_flax_variables, small_cfg, t, to_torch_pyramid

torch.set_num_threads(1)

# test_torch_model.py's tolerance of the forward on the same exact pyramid
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-5


def _batch(seed, b, n, num_classes):
    rng = np.random.RandomState(seed)
    xyz = (rng.rand(b, n, 3) * 4).astype(np.float32)
    return {"xyz": xyz,
            "features": np.concatenate(
                [xyz, rng.rand(b, n, 3).astype(np.float32)], -1),
            "labels": rng.randint(0, num_classes, (b, n)).astype(np.int32),
            "pseudo": rng.randint(0, num_classes, (b, n)).astype(np.int32),
            "activation": (rng.rand(b, n) < 0.5).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_snapshot(tmp_path_factory):
    """A JAX state after one train step, saved by JAX's save_checkpoint
    (flax.serialization.to_bytes of params and batch_stats) as snap-1."""
    cfg = small_cfg(num_points=1024)
    batch = _batch(0, 2, cfg.num_points, cfg.num_classes)
    model = jr.RandLANet(cfg)
    state = jt.create_train_state(model, cfg, jax.random.PRNGKey(0), batch,
                                  steps_per_epoch=10)
    v = random_flax_variables({"params": state.params,
                               "batch_stats": state.batch_stats}, seed=3)
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"])
    step = jt.make_train_step(model, cfg, np.ones(cfg.num_classes,
                                                  np.float32), "xla")
    state, _ = step(state, {k: jnp.asarray(x) for k, x in batch.items()},
                    jax.random.PRNGKey(1))
    save_dir = tmp_path_factory.mktemp("snapshots")
    jt.save_checkpoint(str(save_dir / "snap-1"), state)
    return cfg, model, state, save_dir


def test_decoder_agrees_with_msgpack():
    """Every msgpack form the decoder takes, packed by msgpack itself."""
    obj = {"ints": [0, 1, 127, 128, 255, 256, 65536, 2 ** 32, 2 ** 40, -1,
                    -32, -33, -129, -40000, -2 ** 40],
           "floats": [1.5, -2.25e300], "none": None, "bools": [True, False],
           "str": ["", "s" * 31, "s" * 32, "u" * 300, "w" * 70000],
           "bin": [b"", b"b" * 300, b"c" * 70000],
           "map": {str(i): i for i in range(20)},
           "array": list(range(20))}
    assert flax_snapshot.unpackb(msgpack.packb(obj, use_bin_type=True)) \
        == obj


def test_restore_checkpoint_reads_the_jax_snapshot(jax_snapshot):
    """Every parameter and statistic equals JAX's after its train step."""
    _, _, state, save_dir = jax_snapshot
    got = tt.restore_checkpoint(str(save_dir / "snap-1"), "cpu")
    want = tr.params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                      state.params),
                               jax.tree_util.tree_map(np.asarray,
                                                      state.batch_stats))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_eval_forward_from_jax_snapshot_matches_jax(jax_snapshot):
    """Trainer.restore_model(1) of the JAX snap-1, then the port's eval
    forward against JAX's on the same exact pyramid."""
    cfg, model, state, save_dir = jax_snapshot
    trainer = tt.Trainer(cfg, "S3DIS", save_dir=str(save_dir), device="cpu",
                         log_fn=lambda msg: None)
    trainer.restore_model(1)
    xyz = _batch(2, 2, cfg.num_points, cfg.num_classes)
    pyr = jr.build_pyramid(jnp.asarray(xyz["xyz"]), cfg, engine="xla")
    logits, penult = jax.jit(model.apply)(
        {"params": state.params, "batch_stats": state.batch_stats},
        jnp.asarray(xyz["features"]), pyr)
    trainer.model.eval()
    with torch.inference_mode():
        got_l, got_p = trainer.model(t(xyz["features"]),
                                     to_torch_pyramid(pyr))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(logits),
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(penult),
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def test_truncated_snapshot_raises(jax_snapshot, tmp_path):
    _, _, _, save_dir = jax_snapshot
    data = (save_dir / "snap-1").read_bytes()
    for cut in (1, len(data) // 2, len(data) - 1):
        (tmp_path / "snap").write_bytes(data[:cut])
        with pytest.raises(ValueError, match="truncated"):
            tt.restore_checkpoint(str(tmp_path / "snap"), "cpu")
    (tmp_path / "snap").write_bytes(data + b"\x00")
    with pytest.raises(ValueError, match="trailing"):
        tt.restore_checkpoint(str(tmp_path / "snap"), "cpu")


def test_cli_evaluate_reads_a_jax_snapshot(tmp_path):
    """cli.evaluate --snapshot on a JAX snap-<n> of the synthetic config's
    RandLA-Net returns what the same weights give from a port snapshot."""
    def args(kind):
        return evaluate.parser().parse_args([
            "--device", "cpu", "--synthetic", "--synthetic_rooms", "1",
            "--synthetic_points", "3000", "--num_points", "512",
            "--reg_strength", "0.05", "--knn_engine", "xla",
            "--data_root", str(tmp_path / "data"),
            "--snapshot", str(tmp_path / kind / "snap-1"),
            "--out", str(tmp_path / f"pred_{kind}")])

    cfg = setup_experiment(args("jax")).cfg
    jcfg = dataclasses.replace(JConfigS3DIS, **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(JConfigS3DIS)
        if hasattr(cfg, f.name)})
    batch = _batch(1, 1, cfg.num_points, cfg.num_classes)
    model = jr.RandLANet(jcfg)
    v = jax.jit(lambda x, f: model.init(
        {"params": jax.random.PRNGKey(0)}, f,
        jr.build_pyramid(x, jcfg, engine="xla"), False))(
            jnp.asarray(batch["xyz"]), jnp.asarray(batch["features"]))
    v = random_flax_variables(v, seed=4)
    jstate = jt.TrainState.create(apply_fn=model.apply, params=v["params"],
                                  batch_stats=v["batch_stats"],
                                  tx=optax.adam(1e-3))
    jt.save_checkpoint(str(tmp_path / "jax" / "snap-1"), jstate)
    tt.save_checkpoint(str(tmp_path / "port" / "snap-1"),
                       tr.params_from_flax(v["params"], v["batch_stats"]))
    res = {kind: evaluate.run_evaluate(args(kind)) for kind in ("jax", "port")}
    assert os.listdir(tmp_path / "pred_jax")
    assert res["jax"]["oa"] == res["port"]["oa"]
    assert res["jax"]["miou"] == res["port"]["miou"]
