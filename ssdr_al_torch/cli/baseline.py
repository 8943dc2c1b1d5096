"""Fully-supervised baseline: label every superpoint precisely, train one
round (counterpart of ssdr_al_tpu/cli/baseline.py; reference
ssdr_create_baseline.py: the seed path with the whole budget):

  python -m ssdr_al_torch.cli.baseline --dataset S3DIS [--device cpu]

The superpoint registry (data/<ds>/<reg>/superpoint/total.pkl) must exist.
--num_devices N trains data-parallel (cli/common.py::run_ranks).
"""

from __future__ import annotations

import argparse

from ssdr_al_torch.active.samplers import SeedSampler
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


def run_baseline(args):
    return run_ranks(_run_baseline, args)


def _run_baseline(group, args):
    exp = setup_experiment(args)
    sampler_args = ["baseline"]
    state = exp.make_state(sampler_args, group)
    record = make_record_file(args, sampler_args, group=group)
    log = rank_log(record, group)

    total_sp_num = state.load_registry()["sp_num"]
    stats = RoundStats()
    SeedSampler(state, exp.train_clouds, total_sp_num).sampling(
        total_sp_num, last_round=0, stats=stats)
    log(f"baseline: labeled {stats.sp_num} superpoints "
        f"({stats.p_num} points)")

    trainer = make_trainer(exp, sampler_args, args.knn_engine,
                           device=rank_device(args, group), group=group)
    pipe = make_training_pipeline(exp, pseudo_gt=pseudo_gt_for_round(
        state, state.round_dir(1), exp.train_clouds))
    trainer.init_state(pipe.sample_batch(exp.cfg.batch_size))
    miou, oa = trainer.train_round(
        1, lambda epoch: pipe.batches(exp.cfg.train_steps,
                                      exp.cfg.batch_size),
        make_evaluator(exp, group))
    log(f"baseline | best_miou= {miou:.4f}, best_OA= {oa:.4f}")
    if record is not None:
        record.close()
    return miou, oa


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="fully-supervised baseline")
    add_common_args(p)
    return p


def main(argv=None):
    run_baseline(parser().parse_args(argv))


if __name__ == "__main__":
    main()
