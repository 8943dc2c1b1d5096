"""Fully-supervised baseline: label every superpoint precisely, train one
round (counterpart of ssdr_al_tpu/cli/baseline.py; reference
ssdr_create_baseline.py: the seed path with the whole budget):

  python -m ssdr_al_torch.cli.baseline --dataset S3DIS [--device cpu]

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


def run_baseline(args):
    exp = setup_experiment(args)
    sampler_args = ["baseline"]
    state = exp.make_state(sampler_args)
    record = make_record_file(args, sampler_args)

    total_sp_num = state.load_registry()["sp_num"]
    stats = RoundStats()
    SeedSampler(state, exp.train_clouds, total_sp_num).sampling(
        total_sp_num, last_round=0, stats=stats)
    log_out(f"baseline: labeled {stats.sp_num} superpoints "
            f"({stats.p_num} points)", record)

    trainer = make_trainer(exp, sampler_args, args.knn_engine,
                           device=args.device)
    pipe = make_training_pipeline(exp, pseudo_gt=pseudo_gt_for_round(
        state, state.round_dir(1), exp.train_clouds))
    trainer.init_state(pipe.sample_batch(exp.cfg.batch_size))
    miou, oa = trainer.train_round(
        1, lambda epoch: pipe.batches(exp.cfg.train_steps,
                                      exp.cfg.batch_size),
        make_evaluator(exp))
    log_out(f"baseline | best_miou= {miou:.4f}, best_OA= {oa:.4f}", record)
    record.close()
    return miou, oa


def main(argv=None):
    p = argparse.ArgumentParser(description="fully-supervised baseline")
    add_common_args(p)
    run_baseline(p.parse_args(argv))


if __name__ == "__main__":
    main()
