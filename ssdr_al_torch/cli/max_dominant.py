"""Dominant-label upper bound: label every superpoint with its dominant
ground-truth label, train one round (counterpart of
ssdr_al_tpu/cli/max_dominant.py; reference ssdr_max_dominant.py: the
AllSampler with an unlimited budget):

  python -m ssdr_al_torch.cli.max_dominant --dataset S3DIS [--device cpu]

The superpoint registry (data/<ds>/<reg>/superpoint/total.pkl) must exist.
"""

from __future__ import annotations

import argparse

from ssdr_al_torch.active.samplers import AllSampler
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


def run_max_dominant(args):
    exp = setup_experiment(args)
    sampler_args = ["max_dominant"]
    state = exp.make_state(sampler_args)
    record = make_record_file(args, sampler_args)

    total_sp_num = state.load_registry()["sp_num"]
    stats = RoundStats()
    AllSampler(state, exp.train_clouds, total_sp_num,
               oracle_mode="dominant").sampling(total_sp_num, last_round=1,
                                                stats=stats)
    log_out(f"max_dominant: labeled {stats.sp_num} superpoints "
            f"({stats.p_num} points)", record)

    trainer = make_trainer(exp, sampler_args, args.knn_engine,
                           device=args.device)
    pipe = make_training_pipeline(exp, pseudo_gt=pseudo_gt_for_round(
        state, state.round_dir(2), exp.train_clouds))
    trainer.init_state(pipe.sample_batch(exp.cfg.batch_size))
    miou, oa = trainer.train_round(
        2, lambda epoch: pipe.batches(exp.cfg.train_steps,
                                      exp.cfg.batch_size),
        make_evaluator(exp))
    log_out(f"max_dominant | best_miou= {miou:.4f}, best_OA= {oa:.4f}",
            record)
    record.close()
    return miou, oa


def main(argv=None):
    p = argparse.ArgumentParser(description="dominant-label upper bound")
    add_common_args(p)
    run_max_dominant(p.parse_args(argv))


if __name__ == "__main__":
    main()
