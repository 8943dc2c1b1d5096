"""The port's AL loop end to end on the CPU: a twin of
tests/test_e2e.py::test_full_al_loop through ssdr_al_torch.cli (seed round,
then one full-SSDR AL round with retraining), at that test's sizes. The
superpoint partition is not ported, so the registry comes from
grid_superpoints (cli/common.write_grid_superpoints). Also: the flags
whose path is not ported raise, and so does the default device without a
card."""

import argparse
import os
import pickle

import numpy as np
import pytest
import torch

from ssdr_al_torch.cli import al_loop, seed
from ssdr_al_torch.cli.common import setup_experiment, write_grid_superpoints

torch.set_num_threads(1)

SSDR = "t0-sb-clsbal-gcn_fps-WetSU-NAIL-0.9-1-1-0"


def make_args(tmp_path, **over):
    base = dict(
        device="cpu",
        dataset="S3DIS", data_root=os.path.join(str(tmp_path), "data"),
        test_area=5, reg_strength=0.05, synthetic=True, synthetic_rooms=2,
        synthetic_points=3000, num_points=512, max_epoch=2, train_steps=3,
        knn_engine="xla", seed_percent=0.1, num_devices=1,
        sampler="T", round=2, rounds=2, classbal=2, edcd=0, gcn=0, gcn_fps=1,
        gcn_number=1, gcn_top=0, uncertainty_mode="WetSU",
        point_uncertainty_mode="sb", oracle_mode="NAIL", threshold=0.9,
        min_size=1, t=0, sp_batch_size=10, pool=0,
    )
    base.update(over)
    return argparse.Namespace(**base)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)        # record_round/ is written to the cwd
    return tmp_path


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_full_al_loop(workdir):
    args = make_args(workdir)
    exp = setup_experiment(args)
    total = write_grid_superpoints(exp.make_state([]), exp.train_clouds, 24)
    assert total["sp_num"] > 10

    miou, oa = seed.run_seed(args)
    assert 0 <= miou <= 1 and 0 <= oa <= 1
    assert os.path.exists(os.path.join(exp.data_path, "saver", "seed",
                                       "snapshots", "snap-1"))

    ((miou2, oa2),) = al_loop.run_al_loop(args)
    assert 0 <= miou2 <= 1 and 0 <= oa2 <= 1
    round2 = os.path.join(exp.data_path, "sampling", SSDR, "round_2")
    t0 = _load(os.path.join(exp.data_path, "superpoint", "total.pkl"))
    t2 = _load(os.path.join(round2, "total.pkl"))
    assert sum(len(v) for v in t2["unlabeled"].values()) < \
        sum(len(v) for v in t0["unlabeled"].values())
    seed_round = os.path.join(exp.data_path, "sampling", "seed", "round_1")
    for cloud in exp.train_clouds:
        g1 = np.asarray(_load(os.path.join(seed_round, cloud.name + ".gt")))
        g2 = np.asarray(_load(os.path.join(round2, cloud.name + ".gt")))
        assert (g2[0] >= g1[0]).all(), "activation must be monotone"
    snap2 = os.path.join(exp.data_path, "saver", SSDR, "snapshots", "snap-2")
    assert os.path.exists(snap2)
    state = torch.load(snap2, map_location="cpu", weights_only=True)
    assert all(torch.isfinite(v).all() for v in state.values()
               if v.is_floating_point())


@pytest.mark.parametrize("flag,value", [
    ("pool", 1), ("knn_engine", "pallas"), ("knn_engine", "approx"),
    ("knn_engine", "window_og"), ("num_devices", 2),
    ("compute_dtype", "bfloat16"), ("dataset", "semantic3d"),
    ("sampler", "random"),
])
def test_unported_flags_raise(workdir, flag, value):
    args = make_args(workdir, **{flag: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        al_loop.run_al_loop(args)


def _entry_points(tmp_path):
    """Each port entry point called with its default device."""
    from ssdr_al_torch.active import fps_gcn, region_graph, samplers, state
    from ssdr_al_torch.config import ConfigS3DIS as cfg
    from ssdr_al_torch.models.randlanet import RandLANet
    from ssdr_al_torch.train import trainer

    return {
        "cli.seed": lambda: seed.main(
            ["--synthetic", "--data_root", str(tmp_path / "data")]),
        "cli.al_loop": lambda: al_loop.main(
            ["--synthetic", "--data_root", str(tmp_path / "data")]),
        "make_eval_step": lambda: trainer.make_eval_step(RandLANet(cfg), cfg),
        "make_train_step": lambda: trainer.make_train_step(
            RandLANet(cfg), cfg, np.ones(cfg.num_classes, np.float32)),
        "Trainer": lambda: trainer.Trainer(cfg, "S3DIS",
                                           save_dir=str(tmp_path)),
        "InferenceRunner": lambda: samplers.InferenceRunner(
            cfg, [], None, None, "sb"),
        "TSampler": lambda: samplers.TSampler(
            state.ALState(str(tmp_path)), [], cfg, samplers.TSamplerArgs(),
            0),
        "SuperpointBlockCache": lambda: region_graph.SuperpointBlockCache(),
        "build_region_graph": lambda: region_graph.build_region_graph({}),
        "gcn_fps_sampling": lambda: fps_gcn.gcn_fps_sampling(
            None, np.zeros((0, 4), np.float32), np.zeros(0, bool), 1),
    }


@pytest.mark.parametrize("entry", [
    "cli.seed", "cli.al_loop", "make_eval_step", "make_train_step",
    "Trainer", "InferenceRunner", "TSampler", "SuperpointBlockCache",
    "build_region_graph", "gcn_fps_sampling"])
def test_entry_points_default_to_the_card(workdir, entry):
    """Without device="cpu" every entry point asks for the card, and on a
    machine without one it raises before doing any work."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points(workdir)[entry]()
    assert not (workdir / "data").exists()
