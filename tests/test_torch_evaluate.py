"""The standalone evaluation of ssdr_al_torch against ssdr_al_tpu's on the
CPU: the prediction-PLY writer, the .labels exporter and the PLY scorer
against the JAX copies, cli.evaluate against JAX's run_evaluate on the same
weights with --knn_engine pallas (reprojection to full resolution
included), and the AL loop with --knn_engine pallas followed by an
evaluation of its snapshot."""

import argparse
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from ssdr_al_tpu.cli import evaluate as j_evaluate
from ssdr_al_tpu.cli.common import setup_experiment as j_setup_experiment
from ssdr_al_tpu.models.randlanet import RandLANet as JRandLANet
from ssdr_al_tpu.train import cross_val as j_cross_val
from ssdr_al_tpu.train import trainer as j_trainer
from ssdr_al_tpu.utils import visualize as j_visualize
from ssdr_al_torch.cli import al_loop, evaluate, seed
from ssdr_al_torch.cli.common import setup_experiment, write_grid_superpoints
from ssdr_al_torch.data.ply import read_ply, write_ply
from ssdr_al_torch.models.randlanet import params_from_flax
from ssdr_al_torch.train import cross_val
from ssdr_al_torch.train.trainer import save_checkpoint
from ssdr_al_torch.utils import visualize
from torch_parity import interpret, random_flax_variables

torch.set_num_threads(1)

SSDR = "t0-sb-clsbal-gcn_fps-WetSU-NAIL-0.9-1-1-0"


def make_args(tmp_path, **over):
    base = dict(
        device="cpu",
        dataset="S3DIS", data_root=os.path.join(str(tmp_path), "data"),
        test_area=5, reg_strength=0.05, synthetic=True, synthetic_rooms=2,
        synthetic_points=3000, num_points=512, max_epoch=2, train_steps=3,
        knn_engine="pallas", seed_percent=0.1, num_devices=1,
        sampler="T", round=2, rounds=2, classbal=2, edcd=0, gcn=0, gcn_fps=1,
        gcn_number=1, gcn_top=0, uncertainty_mode="WetSU",
        point_uncertainty_mode="sb", oracle_mode="NAIL", threshold=0.9,
        min_size=1, t=0, sp_batch_size=10, pool=0, export_labels=True,
        out=os.path.join(str(tmp_path), "preds"), snapshot="")
    base.update(over)
    return argparse.Namespace(**base)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)        # record_round/ is written to the cwd
    return tmp_path


def test_exporters_and_scorer_match_jax(tmp_path):
    """Same arrays through both packages' write_prediction_ply (byte-equal
    files), export_semantic3d_labels (equal files) and
    score_prediction_plys (equal OA, mIoU and IoU)."""
    rng = np.random.RandomState(0)
    t_dir, j_dir = tmp_path / "t", tmp_path / "j"
    t_dir.mkdir()
    j_dir.mkdir()
    for room in range(3):
        n = 500 + 100 * room
        xyz = rng.rand(n, 3).astype(np.float32)
        gt = rng.randint(0, 13, n)
        pred = np.where(rng.rand(n) < 0.7, gt, rng.randint(0, 13, n))
        visualize.write_prediction_ply(str(t_dir / f"r{room}.ply"), xyz,
                                       pred, gt)
        j_visualize.write_prediction_ply(str(j_dir / f"r{room}.ply"), xyz,
                                         pred, gt)
        assert (t_dir / f"r{room}.ply").read_bytes() == \
            (j_dir / f"r{room}.ply").read_bytes()
    assert cross_val.score_prediction_plys(str(t_dir), 13) == \
        j_cross_val.score_prediction_plys(str(j_dir), 13)
    probs = rng.rand(200, 8).astype(np.float32)
    proj = rng.randint(0, 200, 700)
    got = visualize.export_semantic3d_labels(
        str(t_dir / "a.labels"), probs, proj, np.arange(1, 9))
    want = j_visualize.export_semantic3d_labels(
        str(j_dir / "a.labels"), probs, proj, np.arange(1, 9))
    np.testing.assert_array_equal(got, want)
    assert (t_dir / "a.labels").read_text() == \
        (j_dir / "a.labels").read_text()
    with pytest.raises(FileNotFoundError):
        cross_val.score_prediction_plys(str(tmp_path / "none"))


def _add_full_resolution(exp, cloud, rng):
    """A _proj.pkl and an original_ply/ file for one cloud: 1.5× its points
    at full resolution, each mapped to a sub point."""
    full = int(cloud.num_points * 1.5)
    proj = rng.randint(0, cloud.num_points, full)
    xyz = cloud.xyz[proj] + rng.randn(full, 3).astype(np.float32) * 1e-3
    base = os.path.join(exp.input_path, cloud.name)
    with open(base + "_proj.pkl", "wb") as f:
        pickle.dump((proj, cloud.labels[proj]), f)
    orig = os.path.join(os.path.dirname(exp.input_path), "original_ply")
    os.makedirs(orig, exist_ok=True)
    write_ply(os.path.join(orig, cloud.name + ".ply"),
              [xyz, cloud.labels[proj].astype(np.int32)],
              ["x", "y", "z", "class"])
    return full


def test_evaluate_matches_jax(workdir, capsys):
    """One snapshot (random O(1) flax weights) saved in each package's
    format, both evaluations with --knn_engine pallas on the same val
    cloud, reprojected to full resolution through _proj.pkl and
    original_ply/: the same predictions in the PLYs, the same .labels, the
    same OA / mIoU / IoU, and the same printed line."""
    args = make_args(workdir)
    exp = setup_experiment(args)
    full = _add_full_resolution(exp, exp.val_clouds[0],
                                np.random.RandomState(1))
    cfg = j_setup_experiment(args).cfg

    model = JRandLANet(cfg)
    rng = np.random.RandomState(0)
    sample = {"xyz": (rng.rand(1, cfg.num_points, 3) * 6).astype(np.float32),
              "features": rng.rand(1, cfg.num_points, 6).astype(np.float32)}
    state = j_trainer.create_train_state(model, cfg, jax.random.PRNGKey(0),
                                         sample, 500)
    v = random_flax_variables({"params": state.params,
                               "batch_stats": state.batch_stats}, seed=3)
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"])
    j_snap, t_snap = str(workdir / "j_snap"), str(workdir / "t_snap")
    j_trainer.save_checkpoint(j_snap, state)
    save_checkpoint(t_snap, params_from_flax(v["params"], v["batch_stats"]))

    t_out, j_out = str(workdir / "t_preds"), str(workdir / "j_preds")
    with interpret():
        want = j_evaluate.run_evaluate(make_args(workdir, snapshot=j_snap,
                                                 out=j_out))
    j_line = capsys.readouterr().out.strip().splitlines()[-1]
    got = evaluate.run_evaluate(make_args(workdir, snapshot=t_snap,
                                          out=t_out))
    t_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert t_line == j_line and t_line.startswith("OA=")
    assert got == want
    name = exp.val_clouds[0].name
    t_ply = read_ply(os.path.join(t_out, name + ".ply"))
    j_ply = read_ply(os.path.join(j_out, name + ".ply"))
    assert len(t_ply) == full
    for field in ("x", "y", "z", "pred", "class"):
        np.testing.assert_array_equal(t_ply[field], j_ply[field])
    assert len(np.unique(t_ply["pred"])) > 1
    with open(os.path.join(t_out, name + ".labels")) as a, \
            open(os.path.join(j_out, name + ".labels")) as b:
        assert a.read() == b.read()


def test_al_round_and_evaluate_on_pallas_engine(workdir, capsys):
    """The CPU twin of one al_loop round with --knn_engine pallas (every
    pyramid through knn_tiled), then cli.evaluate on its snapshot."""
    args = make_args(workdir)
    exp = setup_experiment(args)
    write_grid_superpoints(exp.make_state([]), exp.train_clouds, 24)
    seed.run_seed(args)
    ((miou, oa),) = al_loop.run_al_loop(args)
    assert 0 <= miou <= 1 and 0 <= oa <= 1
    snap2 = os.path.join(exp.data_path, "saver", SSDR, "snapshots", "snap-2")
    capsys.readouterr()
    evaluate.main(["--device", "cpu", "--synthetic", "--data_root",
                   args.data_root, "--reg_strength", "0.05",
                   "--num_points", "512", "--knn_engine", "pallas",
                   "--snapshot", snap2, "--out", args.out])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("OA=") and "mIoU=" in line
    result = cross_val.score_prediction_plys(args.out, exp.cfg.num_classes)
    assert 0 <= result["oa"] <= 1 and len(result["iou"]) == \
        exp.cfg.num_classes
    assert sorted(os.listdir(args.out)) == [exp.val_clouds[0].name + ".ply"]
