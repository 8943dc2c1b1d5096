"""Shared CLI plumbing (counterpart of ssdr_al_tpu/cli/common.py): the same
flags and the same on-disk layout, keyed by the sampler-args string under
data/<ds>/<reg_strength>/, plus `--device`, the port's counterpart of
JAX_PLATFORMS (default: the card).

--num_devices N > 1 runs the entry point data-parallel (run_ranks): N
ranks, rank r on cuda:r (ValueError when the machine has fewer cards;
JAX's make_mesh silently takes fewer devices), or N CPU ranks with
--device cpu. Every rank runs the same round; rank 0 alone writes the
AL state, the snapshots and the record_round/ log.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List

import numpy as np

from ssdr_al_torch.active.state import ALState, sampler_args_str
from ssdr_al_torch.config import Config, class_weights, get_config
from ssdr_al_torch.data.cloud import Cloud, load_clouds
from ssdr_al_torch.data.dataset import (
    PossibilityTrainingPipeline,
    TrainingPipeline,
)
from ssdr_al_torch.data.ply import write_ply
from ssdr_al_torch.data.synthetic import (
    NUM_SYNTH_CLASSES,
    NUM_SYNTH_CLASSES_HARD,
    grid_superpoints,
    make_dataset,
)
from ssdr_al_torch.device import DEFAULT_DEVICE, resolve_device
from ssdr_al_torch.models.randlanet import KNN_ENGINES
from ssdr_al_torch.parallel.mesh import data_devices, launch
from ssdr_al_torch.train.evaluator import Evaluator
from ssdr_al_torch.train.trainer import Trainer


def log_out(msg: str, f=None):
    """Append, flush and print (RandLANet.py:13-16)."""
    if f is not None:
        f.write(msg + "\n")
        f.flush()
    print(msg)


def rank_log(record, group):
    """log(msg): log_out to `record` on rank 0 (or without a group); a
    no-op on the other ranks."""
    if group is not None and not group.lead:
        return lambda msg: None
    return lambda msg: log_out(msg, record)


def add_common_args(p: argparse.ArgumentParser):
    p.add_argument("--device", type=str, default=DEFAULT_DEVICE,
                   help="torch device of the run: 'cuda' (default; raises "
                        "without a card) or 'cpu'")
    p.add_argument("--dataset", type=str, default="S3DIS",
                   choices=["S3DIS", "semantic3d", "SemanticKITTI"])
    p.add_argument("--data_root", type=str, default="./data")
    p.add_argument("--test_area", type=int, default=5)
    p.add_argument("--reg_strength", type=float, default=0.008)
    p.add_argument("--synthetic", action="store_true",
                   help="use generated scenes instead of a real dataset")
    p.add_argument("--synthetic_rooms", type=int, default=4)
    p.add_argument("--synthetic_points", type=int, default=20000)
    p.add_argument("--synthetic_easy", action="store_true",
                   help="easy scenes (5 well-separated classes); default "
                        "is the hard generator (8 confusable classes)")
    p.add_argument("--num_points", type=int, default=0,
                   help="override cfg.num_points (0 = dataset default)")
    p.add_argument("--max_epoch", type=int, default=0,
                   help="override cfg.max_epoch (0 = dataset default)")
    p.add_argument("--train_steps", type=int, default=0,
                   help="override cfg.train_steps (0 = dataset default)")
    p.add_argument("--val_steps", type=int, default=0,
                   help="override cfg.val_steps (0 = dataset default; the "
                        "synthetic default is 8)")
    p.add_argument("--batch_size", type=int, default=0,
                   help="override cfg.batch_size (0 = dataset default)")
    p.add_argument("--knn_engine", type=str, default="window",
                   choices=list(KNN_ENGINES))
    p.add_argument("--compute_dtype", type=str, default="",
                   choices=["", "float32", "bfloat16"],
                   help="activation dtype ('' = config default float32; "
                        "bfloat16 runs every layer's activations in bf16 "
                        "with f32 parameters, as JAX's flag does)")
    p.add_argument("--search_window", type=int, default=0,
                   help="morton search window for big pyramid layers "
                        "(0 = config default 2048; multiple of 512 in "
                        "[1024, 4096])")
    p.add_argument("--num_devices", type=int, default=1,
                   help="data-parallel ranks, one device each: cuda:0 … "
                        "cuda:N-1 (at most the machine's cards), or N CPU "
                        "ranks with --device cpu")


def run_ranks(fn, args):
    """fn(group, args) on every rank of --num_devices and rank 0's result;
    with one device fn(None, args) in this process. The data is set up
    once here before the ranks start (they read it), and the batch is
    checked to split over the ranks, as JAX's make_trainer does."""
    n = getattr(args, "num_devices", 1)
    if n == 1:
        return fn(None, args)
    resolve_device(args.device)
    devices = data_devices(args.device, n)
    check_batch_split(setup_experiment(args).cfg, n)
    return launch(fn, n, devices, os.path.join(args.data_root, "dp_runs"),
                  args)[0]


def check_batch_split(cfg: Config, n: int):
    """JAX's make_trainer check: the batch splits over the ranks."""
    if cfg.batch_size % n:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by "
                         f"{n} devices")


def rank_device(args, group):
    """The device of this rank: the group's, else --device."""
    return args.device if group is None else group.device


@dataclasses.dataclass
class Experiment:
    cfg: Config
    dataset_name: str
    data_path: str          # data/<ds>/<reg_strength>
    input_path: str         # data/<ds>/input_<grid>
    train_clouds: List[Cloud]
    val_clouds: List[Cloud]
    class_weight_name: str  # key for config.class_weights, or "" for flat

    def make_state(self, sampler_args, group=None) -> ALState:
        """The AL state; ranks other than 0 hold their writes."""
        return ALState(self.data_path, sampler_args,
                       write_files=group is None or group.lead)

    def save_dir(self, sampler_args) -> str:
        return os.path.join(self.data_path, "saver",
                            sampler_args_str(sampler_args), "snapshots")


def setup_experiment(args) -> Experiment:
    resolve_device(getattr(args, "device", DEFAULT_DEVICE))
    cfg = get_config(args.dataset)
    overrides = {}
    synth_hard = args.synthetic and not getattr(args, "synthetic_easy", False)
    if args.synthetic:
        overrides.update(
            num_classes=(NUM_SYNTH_CLASSES_HARD if synth_hard
                         else NUM_SYNTH_CLASSES),
            num_points=args.num_points or 4096,
            batch_size=2,
            val_batch_size=2,
            train_steps=args.train_steps or 8,
            val_steps=8,
            max_epoch=args.max_epoch or 4,
            sub_grid_size=0.0,
        )
    else:
        if args.num_points:
            overrides["num_points"] = args.num_points
        if args.max_epoch:
            overrides["max_epoch"] = args.max_epoch
        if args.train_steps:
            overrides["train_steps"] = args.train_steps
    # --val_steps / --batch_size apply to real and synthetic configs alike
    if getattr(args, "val_steps", 0):
        overrides["val_steps"] = args.val_steps
    if getattr(args, "batch_size", 0):
        overrides["batch_size"] = args.batch_size
    if getattr(args, "compute_dtype", ""):
        overrides["compute_dtype"] = args.compute_dtype
    if getattr(args, "search_window", 0):
        sw = args.search_window
        if sw % 512 or not (1024 <= sw <= 4096):
            raise ValueError(f"--search_window {sw} invalid: must be a "
                             "multiple of 512 in [1024, 4096]")
        overrides["search_window"] = sw
    cfg = dataclasses.replace(cfg, **overrides)

    ds_dir = os.path.join(args.data_root, args.dataset)
    data_path = os.path.join(ds_dir, str(args.reg_strength))
    os.makedirs(data_path, exist_ok=True)

    if args.synthetic:
        input_path = os.path.join(
            ds_dir, "input_synth_hard" if synth_hard else "input_synth")
        if not os.path.isdir(input_path) or not os.listdir(input_path):
            os.makedirs(input_path, exist_ok=True)
            train, val = make_dataset(
                num_train=args.synthetic_rooms, num_val=1,
                num_points=args.synthetic_points, hard=synth_hard)
            for c in train + val:
                write_ply(os.path.join(input_path, c.name + ".ply"),
                          [c.xyz, c.colors, c.labels.astype(np.int32)],
                          ["x", "y", "z", "red", "green", "blue", "class"])
        train_clouds = load_clouds(input_path, include="train")
        val_clouds = load_clouds(input_path, include="val")
        cw_name = ""
    else:
        input_path = os.path.join(ds_dir,
                                  "input_{:.3f}".format(cfg.sub_grid_size))
        val_split = f"Area_{args.test_area}"
        train_clouds = load_clouds(input_path, exclude=val_split)
        val_clouds = load_clouds(input_path, include=val_split)
        cw_name = args.dataset if args.dataset != "semantic3d" \
            else "Semantic3D"

    return Experiment(cfg=cfg, dataset_name=args.dataset,
                      data_path=data_path, input_path=input_path,
                      train_clouds=train_clouds, val_clouds=val_clouds,
                      class_weight_name=cw_name)


def experiment_class_weights(exp: Experiment) -> np.ndarray:
    if exp.class_weight_name:
        return class_weights(exp.class_weight_name)
    return np.ones(exp.cfg.num_classes, np.float32)


def make_trainer(exp: Experiment, sampler_args, knn_engine="window", *,
                 device=DEFAULT_DEVICE, group=None) -> Trainer:
    """Trainer wired to this experiment's snapshot dir and class weights;
    data-parallel over `group`."""
    return Trainer(exp.cfg, exp.dataset_name,
                   save_dir=exp.save_dir(sampler_args),
                   seed_save_dir=exp.save_dir(["seed"]),
                   knn_engine=knn_engine,
                   weights=experiment_class_weights(exp), device=device,
                   group=group)


def make_evaluator(exp: Experiment, group=None) -> Evaluator:
    """Evaluator over the validation clouds; full-resolution reprojection
    is picked up when every val cloud carries its `_proj.pkl`; `group`
    splits each batch over the data-parallel ranks."""
    return Evaluator(exp.cfg, exp.val_clouds, group=group)


def record_name(args, sampler_args, suffix="") -> str:
    """The file name of the run's record_round/ log."""
    return (f"{args.dataset}_{args.test_area}_"
            f"{sampler_args_str(sampler_args)}_{args.reg_strength}"
            f"{suffix}.txt")


def make_record_file(args, sampler_args, suffix="", group=None):
    """The record_round/ log of the run, appended to; None on the ranks
    other than 0."""
    if group is not None and not group.lead:
        return None
    os.makedirs("record_round", exist_ok=True)
    return open(os.path.join("record_round", record_name(
        args, sampler_args, suffix)), "a")


def write_grid_superpoints(state: ALState, clouds, target_sp: int) -> dict:
    """Partition every cloud with grid_superpoints (~target_sp voxels each)
    and write the superpoint files and the registry total.pkl: a quick
    registry for tests and the smoke's synthetic loops. Users partition
    with cut-pursuit (cli/superpoint.py, partition/superpoint.py)."""
    total = {"unlabeled": {}, "file_num": len(clouds), "sp_num": 0,
             "point_num": sum(c.num_points for c in clouds)}
    for c in clouds:
        comps, in_comp = grid_superpoints(c.xyz, target_sp)
        state.write_superpoints(c.name, comps, in_comp, c.num_points)
        total["unlabeled"][c.name] = np.arange(len(comps))
        total["sp_num"] += len(comps)
    state.write_registry(total)
    return total


def pseudo_gt_for_round(state: ALState, round_dir: str, clouds) -> dict:
    return {c.name: state.load_pseudo_gt(round_dir, c.name) for c in clouds}


def make_training_pipeline(exp: Experiment, pseudo_gt=None, seed=0):
    """The dataset's host training pipeline: Semantic3D's possibility-
    scheduled, augmented blocks (the train2 path, SSRD_AL_semantic3d/
    RandLANet.py:260-331); for S3DIS and SemanticKITTI random spatially
    regular blocks."""
    if exp.dataset_name == "semantic3d":
        return PossibilityTrainingPipeline(exp.train_clouds, exp.cfg,
                                           pseudo_gt=pseudo_gt, seed=seed)
    return TrainingPipeline(exp.train_clouds, exp.cfg, pseudo_gt=pseudo_gt,
                            seed=seed)
