"""The port's AL loop end to end on the CPU: a twin of
tests/test_e2e.py::test_full_al_loop through ssdr_al_torch.cli (seed round,
then one full-SSDR AL round with retraining), at that test's sizes. The
superpoint partition is not ported, so the registry comes from
grid_superpoints (cli/common.write_grid_superpoints). Also: one al_loop
round with each comparison branch and --compute_dtype bfloat16; the
--sampler random round and the labels of cli.baseline and
cli.max_dominant equal to the JAX samplers' on the same state; the flags
whose path is not ported raise, and so does the default device without a
card."""

import argparse
import functools
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from ssdr_al_tpu.active import samplers as j_samplers
from ssdr_al_tpu.active import state as j_state
from ssdr_al_torch.active import gcn as t_gcn
from ssdr_al_torch.active import samplers as t_samplers
from ssdr_al_torch.cli import al_loop, baseline, evaluate, max_dominant, seed
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


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """A data root with the registry (grid superpoints) and the seed round
    run by cli.seed, made once; tests copy it."""
    base = tmp_path_factory.mktemp("seeded")
    cwd = os.getcwd()
    os.chdir(base)
    try:
        args = make_args(base)
        exp = setup_experiment(args)
        write_grid_superpoints(exp.make_state([]), exp.train_clouds, 24)
        seed.run_seed(args)
    finally:
        os.chdir(cwd)
    return base / "data"


def _same_files(a_dir, b_dir):
    names = sorted(os.listdir(a_dir))
    assert names == sorted(os.listdir(b_dir)) and names
    for fname in names:
        with open(os.path.join(a_dir, fname), "rb") as a, \
                open(os.path.join(b_dir, fname), "rb") as b:
            assert a.read() == b.read(), fname


@pytest.mark.parametrize("over", [
    dict(compute_dtype="bfloat16"), dict(sampler="random",
                                         oracle_mode="dominant"),
    dict(edcd=1, gcn_fps=0), dict(gcn=1, gcn_fps=0), dict(chamfer_mxu=1)],
    ids=["bfloat16", "random", "edcd", "gcn", "chamfer_mxu"])
def test_al_loop_branches_run(workdir, seeded, monkeypatch, over):
    """One al_loop round from the seed round with each comparison branch
    and with bf16 activations: the round labels superpoints and trains to
    a finite snap-2. The coreGCN fit is cut to 200 steps here (20 000 in
    the branch; the full fit runs in chip_smoke.py)."""
    shutil.copytree(seeded, workdir / "data")
    monkeypatch.setattr(t_samplers, "gcn_sampling",
                        functools.partial(t_gcn.gcn_sampling, num_steps=200))
    args = make_args(workdir, **over)
    ((miou, oa),) = al_loop.run_al_loop(args)
    assert 0 <= miou <= 1 and 0 <= oa <= 1
    exp = setup_experiment(args)
    sargs = "-".join(al_loop.build_sampler_args(args))
    t0 = _load(os.path.join(exp.data_path, "superpoint", "total.pkl"))
    t2 = _load(os.path.join(exp.data_path, "sampling", sargs, "round_2",
                            "total.pkl"))
    assert sum(len(v) for v in t2["unlabeled"].values()) < \
        sum(len(v) for v in t0["unlabeled"].values())
    state = torch.load(os.path.join(exp.data_path, "saver", sargs,
                                    "snapshots", "snap-2"),
                       map_location="cpu", weights_only=True)
    assert all(torch.isfinite(v).all() for v in state.values()
               if v.is_floating_point())


def test_al_loop_random_round_matches_jax(workdir, seeded):
    """--sampler random: the round's files equal those of JAX's
    RandomSampler (seed --t, the same budget) on the same seed round."""
    shutil.copytree(seeded, workdir / "data")
    shutil.copytree(seeded, workdir / "jax")
    args = make_args(workdir, sampler="random", oracle_mode="dominant")
    al_loop.run_al_loop(args)
    exp = setup_experiment(args)
    sargs = al_loop.build_sampler_args(args)
    j_path = os.path.join(workdir, "jax", os.path.relpath(
        exp.data_path, workdir / "data"))
    j_state_ = j_state.ALState(j_path, sargs)
    j_samplers.RandomSampler(
        j_state_, exp.train_clouds, j_state_.load_registry()["sp_num"],
        args.min_size, oracle_mode=args.oracle_mode, seed=args.t).sampling(
            args.sp_batch_size, 1, j_state.RoundStats(),
            threshold=args.threshold)
    rd = os.path.join("sampling", "-".join(sargs), "round_2")
    _same_files(os.path.join(exp.data_path, rd), os.path.join(j_path, rd))


@pytest.mark.parametrize("driver", ["baseline", "max_dominant"])
def test_driver_labels_match_jax(workdir, driver):
    """cli.baseline (every superpoint precisely labelled) and
    cli.max_dominant (every superpoint with its dominant label) each train
    one round to a finite snapshot; the pseudo-GT files and the registry
    they wrote before training equal those of the JAX sampler behind the
    JAX driver, run on a copy of the same registry."""
    args = make_args(workdir)
    exp = setup_experiment(args)
    total = write_grid_superpoints(exp.make_state([]), exp.train_clouds, 24)
    j_path = str(workdir / "jax")
    shutil.copytree(os.path.join(exp.data_path, "superpoint"),
                    os.path.join(j_path, "superpoint"))
    run, rnd = ((baseline.run_baseline, 1) if driver == "baseline"
                else (max_dominant.run_max_dominant, 2))
    miou, oa = run(args)
    assert 0 <= miou <= 1 and 0 <= oa <= 1
    st = j_state.ALState(j_path, [driver])
    if driver == "baseline":
        j_samplers.SeedSampler(st, exp.train_clouds, total["sp_num"]
                               ).sampling(total["sp_num"], 0,
                                          j_state.RoundStats())
    else:
        j_samplers.AllSampler(st, exp.train_clouds, total["sp_num"],
                              oracle_mode="dominant").sampling(
            total["sp_num"], 1, j_state.RoundStats())
    rd = os.path.join("sampling", driver, f"round_{rnd}")
    _same_files(os.path.join(exp.data_path, rd), os.path.join(j_path, rd))
    assert not _load(os.path.join(exp.data_path, rd, "total.pkl"))[
        "unlabeled"]
    snap = os.path.join(exp.data_path, "saver", driver, "snapshots",
                        f"snap-{rnd}")
    state = torch.load(snap, map_location="cpu", weights_only=True)
    assert all(torch.isfinite(v).all() for v in state.values()
               if v.is_floating_point())


@pytest.mark.parametrize("flag,value", [("num_devices", 2)])
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
        "cli.baseline": lambda: baseline.main(
            ["--synthetic", "--data_root", str(tmp_path / "data")]),
        "cli.max_dominant": lambda: max_dominant.main(
            ["--synthetic", "--data_root", str(tmp_path / "data")]),
        "cli.evaluate": lambda: evaluate.main(
            ["--synthetic", "--data_root", str(tmp_path / "data"),
             "--snapshot", str(tmp_path / "snap-1")]),
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
        "gcn_sampling": lambda: t_gcn.gcn_sampling(
            None, np.zeros((0, 4), np.float32), np.zeros(0, bool), 1),
    }


@pytest.mark.parametrize("entry", [
    "cli.seed", "cli.al_loop", "cli.baseline", "cli.max_dominant",
    "cli.evaluate", "make_eval_step", "make_train_step", "Trainer",
    "InferenceRunner", "TSampler", "SuperpointBlockCache",
    "build_region_graph", "gcn_fps_sampling", "gcn_sampling"])
def test_entry_points_default_to_the_card(workdir, entry):
    """Without device="cpu" every entry point asks for the card, and on a
    machine without one it raises before doing any work."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points(workdir)[entry]()
    assert not (workdir / "data").exists()
