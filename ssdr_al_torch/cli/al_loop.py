"""The closed AL loop, per round: restore snap-(r−1) → select → label →
retrain → evaluate → snap-r (counterpart of ssdr_al_tpu/cli/al_loop.py;
flags of ssdr_main_S3DIS2.py:10-157). The full SSDR method is

  python -m ssdr_al_torch.cli.al_loop --sampler T \\
      --point_uncertainty_mode sb --classbal 2 --uncertainty_mode WetSU \\
      --oracle_mode NAIL --gcn_fps 1 [--device cpu]

Training uses the host TrainingPipeline (--pool 0). Not ported yet
(ROADMAP.md), and refused with NotImplementedError: --pool 1 (the device
training pool), --sampler random, --edcd 1, --gcn 1, --chamfer_mxu 1 and
the flags common.check_ported lists.
"""

from __future__ import annotations

import argparse
import time

from ssdr_al_torch.active.samplers import TSampler, TSamplerArgs
from ssdr_al_torch.active.state import RoundStats
from ssdr_al_torch.cli.common import (
    NOT_PORTED,
    add_common_args,
    log_out,
    make_evaluator,
    make_record_file,
    make_trainer,
    make_training_pipeline,
    pseudo_gt_for_round,
    setup_experiment,
)


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


def _check_loop_ported(args):
    for flag, value, ported in (
            ("--pool", getattr(args, "pool", 0), (0,)),
            ("--sampler", args.sampler, ("T",)),
            ("--edcd", args.edcd, (0,)),
            ("--gcn", args.gcn, (0,)),
            ("--chamfer_mxu", getattr(args, "chamfer_mxu", -1), (-1, 0))):
        if value not in ported:
            raise NotImplementedError(f"{flag} {value} {NOT_PORTED}")


def run_al_loop(args):
    _check_loop_ported(args)
    exp = setup_experiment(args)
    sampler_args = build_sampler_args(args)
    state = exp.make_state(sampler_args)
    trainer = make_trainer(exp, sampler_args, args.knn_engine,
                           device=args.device)
    record = make_record_file(args, sampler_args)

    total_obj = state.load_registry()
    total_sp_num = total_obj["sp_num"]
    log_out(f"total_sp_num {total_sp_num}", record)

    sampler = TSampler(
        state, exp.train_clouds, exp.cfg,
        TSamplerArgs(
            point_uncertainty_mode=args.point_uncertainty_mode,
            uncertainty_mode=args.uncertainty_mode,
            oracle_mode=args.oracle_mode,
            class_balance={0: "", 1: "classbal", 2: "clsbal"}[args.classbal],
            diversity="gcn_fps" if args.gcn_fps else "",
            threshold=args.threshold,
            min_size=args.min_size,
            gcn_number=args.gcn_number,
            gcn_top=args.gcn_top,
            chamfer_cap=getattr(args, "chamfer_cap", 512),
        ),
        total_sp_num, seed=args.t, device=trainer.device)
    pipe0 = make_training_pipeline(exp)
    trainer.init_state(pipe0.sample_batch(exp.cfg.batch_size))
    evaluate = make_evaluator(exp)

    sp_batch_size = args.sp_batch_size or exp.cfg.sp_batch_size
    last = args.rounds if args.rounds else exp.cfg.al_rounds[1]

    results = []
    for r in range(args.round, last + 1):
        trainer.restore_model(r - 1)
        t0 = time.time()
        stats = RoundStats()
        sampler.sampling(trainer.eval_step, trainer.state, sp_batch_size,
                         r - 1, stats)
        regions = max(stats.sp_num + stats.split_sp_num, 1)
        points = stats.p_num + stats.sub_p_num
        log_out(f"round= {r} | labeling mean point={points / regions:.1f}, "
                f"{stats}, costTime={time.time() - t0:.1f}", record)

        t0 = time.time()
        round_dir = state.round_dir(r)
        pseudo = pseudo_gt_for_round(state, round_dir, exp.train_clouds)
        pipe = make_training_pipeline(exp, pseudo_gt=pseudo, seed=r)
        miou, oa = trainer.train_round(
            r, lambda epoch: pipe.batches(exp.cfg.train_steps,
                                          exp.cfg.batch_size),
            evaluate)
        log_out(f"round= {r} | best_miou= {miou:.4f}, best_OA= {oa:.4f}, "
                f"costTime={time.time() - t0:.1f}", record)
        results.append((miou, oa))
    record.close()
    return results


def main(argv=None):
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
                   help="-1 / 0: exact f32 chamfer (kernel K3); 1 is not "
                        "ported yet")
    p.add_argument("--min_size", type=int, default=1)
    p.add_argument("--pool", type=int, default=0, choices=[0, 1],
                   help="0: host training pipeline; 1 (the device-resident "
                        "training pool) is not ported yet")
    p.add_argument("--t", type=int, default=0)
    p.add_argument("--sp_batch_size", type=int, default=0,
                   help="clicks per round (0 = dataset default)")
    run_al_loop(p.parse_args(argv))


if __name__ == "__main__":
    main()
