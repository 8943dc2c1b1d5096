"""Seed round: random precise labelling, then round-1 training with
evaluation and the best-mIoU snap-1 (counterpart of
ssdr_al_tpu/cli/seed.py; reference ssdr_create_seed.py:6-59):

  python -m ssdr_al_torch.cli.seed --dataset S3DIS --seed_percent 0.01 \\
      --reg_strength 0.012 [--device cpu]

The superpoint registry (data/<ds>/<reg>/superpoint/total.pkl) must exist.
"""

from __future__ import annotations

import argparse

from ssdr_al_torch.active.samplers import SeedSampler
from ssdr_al_torch.active.state import RoundStats
from ssdr_al_torch.cli.common import (
    add_common_args,
    log_out,
    make_evaluator,
    make_record_file,
    make_trainer,
    make_training_pipeline,
    pseudo_gt_for_round,
    setup_experiment,
)


def run_seed(args):
    exp = setup_experiment(args)
    sampler_args = ["seed"]
    state = exp.make_state(sampler_args)
    trainer = make_trainer(exp, sampler_args, args.knn_engine,
                           device=args.device)
    record = make_record_file(args, sampler_args)

    total_obj = state.load_registry()
    total_sp_num = total_obj["sp_num"]
    sp_batch = max(1, int(total_sp_num * args.seed_percent))
    log_out(f"total_sp_num {total_sp_num}, seeding {sp_batch}", record)

    sampler = SeedSampler(state, exp.train_clouds, total_sp_num)
    stats = RoundStats()
    sampler.sampling(sp_batch, last_round=0, stats=stats)
    n_regions = max(stats.sp_num + stats.sub_num, 1)
    n_points = stats.p_num + stats.sub_p_num
    log_out(
        f"round= 1 | labeling_region_num={n_regions}, "
        f"labeling_point_num={n_points}, "
        f"mean_points={n_points / n_regions:.1f}", record)

    round_dir = state.round_dir(1)
    pipe = make_training_pipeline(
        exp, pseudo_gt=pseudo_gt_for_round(state, round_dir,
                                           exp.train_clouds))
    trainer.init_state(pipe.sample_batch(exp.cfg.batch_size))
    evaluate = make_evaluator(exp)
    miou, oa = trainer.train_round(
        1, lambda epoch: pipe.batches(exp.cfg.train_steps,
                                      exp.cfg.batch_size),
        evaluate)
    log_out(f"round= 1 | best_miou= {miou:.4f}, best_OA= {oa:.4f}", record)
    record.close()
    return miou, oa


def main(argv=None):
    p = argparse.ArgumentParser(description="seed round")
    add_common_args(p)
    p.add_argument("--seed_percent", type=float, default=0.01)
    run_seed(p.parse_args(argv))


if __name__ == "__main__":
    main()
