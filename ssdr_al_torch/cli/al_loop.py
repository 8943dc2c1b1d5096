"""The closed AL loop, per round: restore snap-(r−1) → select → label →
retrain → evaluate → snap-r (counterpart of ssdr_al_tpu/cli/al_loop.py;
flags of ssdr_main_S3DIS2.py:10-157). The full SSDR method is

  python -m ssdr_al_torch.cli.al_loop --sampler T \\
      --point_uncertainty_mode sb --classbal 2 --uncertainty_mode WetSU \\
      --oracle_mode NAIL --gcn_fps 1 [--device cpu]

The comparison samplers of the paper run with the same driver:
--sampler random (RandomSampler), --edcd 1 (farthest-superpoint sampling
over ED² + chamfer), --gcn 1 (coreGCN + k-center); --chamfer_mxu is
accepted and every setting runs the exact chamfer kernel K3.

Every round trains on the device-resident pool by default (--pool 1, as
in JAX): DeviceTrainPool for S3DIS and SemanticKITTI, the possibility-
scheduled PossibilityDevicePool for semantic3d; past the pool's memory
gate, and with --pool 0, on the host pipeline. --num_devices N runs the
rounds data-parallel (cli/common.py::run_ranks): the train steps, the
evaluation, the selection forward and the diversity chamfer split over
the ranks; the possibility pool is single-device, so semantic3d trains
on the host pipeline under dp, as in JAX.
"""

from __future__ import annotations

import argparse
import functools
import time

from ssdr_al_torch.active.samplers import (
    RandomSampler,
    TSampler,
    TSamplerArgs,
)
from ssdr_al_torch.active.state import RoundStats
from ssdr_al_torch.cli.common import (
    add_common_args,
    make_evaluator,
    make_record_file,
    make_trainer,
    make_training_pipeline,
    pseudo_gt_for_round,
    rank_device,
    rank_log,
    run_ranks,
    setup_experiment,
)
from ssdr_al_torch.train.device_pool import DeviceTrainPool
from ssdr_al_torch.train.possibility_pool import PossibilityDevicePool


def build_sampler_args(args) -> list:
    """The experiment-ID list (ssdr_main_S3DIS2.py:91-127)."""
    t = f"t{args.t}"
    if args.sampler == "random":
        return [t, "random", args.oracle_mode, str(args.threshold),
                str(args.min_size), str(args.gcn_number), str(args.gcn_top)]
    sa = [t, args.point_uncertainty_mode]
    if args.classbal == 1:
        sa.append("classbal")
    elif args.classbal == 2:
        sa.append("clsbal")
    if args.edcd:
        sa.append("edcd")
    if args.gcn:
        sa.append("gcn")
    if args.gcn_fps:
        sa.append("gcn_fps")
    sa += [args.uncertainty_mode, args.oracle_mode, str(args.threshold),
           str(args.min_size), str(args.gcn_number), str(args.gcn_top)]
    return sa


def run_al_loop(args, observe=None):
    """Rounds args.round..last of the loop; returns [(miou, oa)] a round.
    observe(event, info), for measurement (scripts/flagship.py), is
    called with ("setup", {trainer, sampler, pool}) before the first
    round (pool: the device training pool, or None) and with ("round",
    {round, stats, select_s, train_s, miou, oa}) after each round's
    training."""
    return run_ranks(functools.partial(_run_al_loop, observe=observe), args)


def _run_al_loop(group, args, observe=None):
    exp = setup_experiment(args)
    sampler_args = build_sampler_args(args)
    state = exp.make_state(sampler_args, group)
    trainer = make_trainer(exp, sampler_args, args.knn_engine,
                           device=rank_device(args, group), group=group)
    record = make_record_file(args, sampler_args, group=group)
    log = rank_log(record, group)

    total_obj = state.load_registry()
    total_sp_num = total_obj["sp_num"]
    log(f"total_sp_num {total_sp_num}")

    diversity = ""
    if args.edcd:
        diversity = "edcd"
    elif args.gcn:
        diversity = "gcn"
    elif args.gcn_fps:
        diversity = "gcn_fps"
    if args.sampler == "random":
        sampler = RandomSampler(state, exp.train_clouds, total_sp_num,
                                args.min_size, oracle_mode=args.oracle_mode,
                                seed=args.t)
    else:
        sampler = TSampler(
            state, exp.train_clouds, exp.cfg,
            TSamplerArgs(
                point_uncertainty_mode=args.point_uncertainty_mode,
                uncertainty_mode=args.uncertainty_mode,
                oracle_mode=args.oracle_mode,
                class_balance={0: "", 1: "classbal",
                               2: "clsbal"}[args.classbal],
                diversity=diversity,
                threshold=args.threshold,
                min_size=args.min_size,
                gcn_number=args.gcn_number,
                gcn_top=args.gcn_top,
                chamfer_cap=getattr(args, "chamfer_cap", 512),
                chamfer_mxu={-1: None, 0: False, 1: True}[
                    getattr(args, "chamfer_mxu", -1)],
            ),
            total_sp_num, seed=args.t, device=trainer.device, group=group)
    pipe0 = make_training_pipeline(exp)
    trainer.init_state(pipe0.sample_batch(exp.cfg.batch_size))
    pool = make_pool(args, exp, trainer, log)
    evaluate = make_evaluator(exp, group)

    sp_batch_size = args.sp_batch_size or exp.cfg.sp_batch_size
    last = args.rounds if args.rounds else exp.cfg.al_rounds[1]

    if observe is not None:
        observe("setup", dict(trainer=trainer, sampler=sampler, pool=pool))
    results = []
    for r in range(args.round, last + 1):
        trainer.restore_model(r - 1)
        t0 = time.time()
        stats = RoundStats()
        if args.sampler == "random":
            sampler.sampling(sp_batch_size, r - 1, stats,
                             threshold=args.threshold)
        else:
            sampler.sampling(trainer.eval_step, trainer.state, sp_batch_size,
                             r - 1, stats)
        select_s = time.time() - t0
        regions = max(stats.sp_num + stats.split_sp_num, 1)
        points = stats.p_num + stats.sub_p_num
        log(f"round= {r} | labeling mean point={points / regions:.1f}, "
            f"{stats}, costTime={select_s:.1f}")

        t0 = time.time()
        round_dir = state.round_dir(r)
        pseudo = pseudo_gt_for_round(state, round_dir, exp.train_clouds)
        if pool is not None:
            pool.update_pseudo_gt(pseudo)
            pool.reseed(r)
            if isinstance(pool, PossibilityDevicePool):
                pool.reset_possibility(r)
            batch_iter_fn = None
        else:
            pipe = make_training_pipeline(exp, pseudo_gt=pseudo, seed=r)

            def batch_iter_fn(epoch, pipe=pipe):
                return pipe.batches(exp.cfg.train_steps, exp.cfg.batch_size)
        miou, oa = trainer.train_round(r, batch_iter_fn, evaluate,
                                       device_pool=pool)
        train_s = time.time() - t0
        log(f"round= {r} | best_miou= {miou:.4f}, best_OA= {oa:.4f}, "
            f"costTime={train_s:.1f}")
        results.append((miou, oa))
        if observe is not None:
            observe("round", dict(round=r, stats=stats, select_s=select_s,
                                  train_s=train_s, miou=miou, oa=oa))
    if record is not None:
        record.close()
    return results


def make_pool(args, exp, trainer, log):
    """The run's device training pool on the trainer's device (--pool 1):
    the possibility-scheduled pool for semantic3d, DeviceTrainPool
    otherwise; None with --pool 0, past the pool's memory gate, and for
    semantic3d under data parallelism (the host pipeline then trains, as
    it does in JAX). Under data parallelism every rank holds a pool with
    the same seed."""
    if not args.pool:
        return None
    if exp.dataset_name == "semantic3d" and trainer.group is not None:
        log("possibility pool is single-device only; host pipeline "
            "under dp")
        return None
    cls = (PossibilityDevicePool if exp.dataset_name == "semantic3d"
           else DeviceTrainPool)
    pool = cls(exp.train_clouds, exp.cfg, seed=args.t, device=trainer.device)
    if not pool.available:
        log("device pool over budget; host pipeline")
        return None
    if args.round > 2:
        # the pool's block stream differs from the host pipeline's, so a
        # run resumed here switches streams mid-curve
        log(f"resuming at round {args.round} with the device pool: "
            "block-sampling RNG differs from the host pipeline (pass "
            "--pool 0 to keep the original stream)")
    return pool


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="active-learning loop")
    add_common_args(p)
    p.add_argument("--sampler", type=str, default="T", choices=["random", "T"])
    p.add_argument("--round", type=int, default=2)
    p.add_argument("--rounds", type=int, default=0,
                   help="last round (0 = dataset default 33)")
    p.add_argument("--classbal", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--edcd", type=int, default=0, choices=[0, 1])
    p.add_argument("--gcn", type=int, default=0, choices=[0, 1])
    p.add_argument("--gcn_fps", type=int, default=0, choices=[0, 1])
    p.add_argument("--gcn_number", type=int, default=1)
    p.add_argument("--gcn_top", type=int, default=0)
    p.add_argument("--uncertainty_mode", type=str, default="mean",
                   choices=["mean", "sum_weight", "WetSU"])
    p.add_argument("--point_uncertainty_mode", type=str, default="entropy",
                   choices=["lc", "sb", "entropy"])
    p.add_argument("--oracle_mode", type=str, default="dominant",
                   choices=["dominant", "NAIL"])
    p.add_argument("--threshold", type=float, default=0.9)
    p.add_argument("--chamfer_cap", type=int, default=512,
                   help="padded superpoint size cap for pairwise chamfer "
                        "(0 = exact, unbounded)")
    p.add_argument("--chamfer_mxu", type=int, default=-1, choices=[-1, 0, 1],
                   help="JAX's bf16x3 chamfer switch; every value runs the "
                        "exact f32 chamfer kernel K3 here")
    p.add_argument("--min_size", type=int, default=1)
    p.add_argument("--pool", type=int, default=1, choices=[0, 1],
                   help="1: device-resident training pool (semantic3d: the "
                        "possibility-scheduled one), falling back to the "
                        "host pipeline past its memory gate; 0: host "
                        "pipeline")
    p.add_argument("--t", type=int, default=0)
    p.add_argument("--sp_batch_size", type=int, default=0,
                   help="clicks per round (0 = dataset default)")
    return p


def main(argv=None):
    run_al_loop(parser().parse_args(argv))


if __name__ == "__main__":
    main()
