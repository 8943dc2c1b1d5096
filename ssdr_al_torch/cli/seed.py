"""Seed round: random precise labelling, then round-1 training with
evaluation and the best-mIoU snap-1 (counterpart of
ssdr_al_tpu/cli/seed.py; reference ssdr_create_seed.py:6-59):

  python -m ssdr_al_torch.cli.seed --dataset S3DIS --seed_percent 0.01 \\
      --reg_strength 0.012 [--device cpu]

The superpoint registry (data/<ds>/<reg>/superpoint/total.pkl) must exist.
--num_devices N trains data-parallel (cli/common.py::run_ranks).
"""

from __future__ import annotations

import argparse
import functools
import time

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


def run_seed(args, observe=None):
    """The seed round; returns its (miou, oa). observe(event, info), for
    measurement (scripts/flagship.py), is called with ("setup",
    {trainer, sampler}) before the labelling (the seed trials reseed the
    sampler's `rng`, the trainer's `init_seed`, which also seeds the
    round's training pipeline, and its `dropout_gen` there) and with
    ("round", {round: 1, stats, select_s, train_s, miou, oa}) after the
    training."""
    return run_ranks(functools.partial(_run_seed, observe=observe), args)


def _run_seed(group, args, observe=None):
    exp = setup_experiment(args)
    sampler_args = ["seed"]
    state = exp.make_state(sampler_args, group)
    trainer = make_trainer(exp, sampler_args, args.knn_engine,
                           device=rank_device(args, group), group=group)
    record = make_record_file(args, sampler_args, group=group)
    log = rank_log(record, group)

    total_obj = state.load_registry()
    total_sp_num = total_obj["sp_num"]
    sp_batch = max(1, int(total_sp_num * args.seed_percent))
    log(f"total_sp_num {total_sp_num}, seeding {sp_batch}")

    sampler = SeedSampler(state, exp.train_clouds, total_sp_num)
    if observe is not None:
        observe("setup", dict(trainer=trainer, sampler=sampler))
    t0 = time.time()
    stats = RoundStats()
    sampler.sampling(sp_batch, last_round=0, stats=stats)
    select_s = time.time() - t0
    n_regions = max(stats.sp_num + stats.sub_num, 1)
    n_points = stats.p_num + stats.sub_p_num
    log(f"round= 1 | labeling_region_num={n_regions}, "
        f"labeling_point_num={n_points}, "
        f"mean_points={n_points / n_regions:.1f}")

    t0 = time.time()
    round_dir = state.round_dir(1)
    pipe = make_training_pipeline(
        exp, pseudo_gt=pseudo_gt_for_round(state, round_dir,
                                           exp.train_clouds),
        seed=trainer.init_seed)
    trainer.init_state(pipe.sample_batch(exp.cfg.batch_size))
    evaluate = make_evaluator(exp, group)
    miou, oa = trainer.train_round(
        1, lambda epoch: pipe.batches(exp.cfg.train_steps,
                                      exp.cfg.batch_size),
        evaluate)
    log(f"round= 1 | best_miou= {miou:.4f}, best_OA= {oa:.4f}")
    if observe is not None:
        observe("round", dict(round=1, stats=stats, select_s=select_s,
                              train_s=time.time() - t0, miou=miou, oa=oa))
    if record is not None:
        record.close()
    return miou, oa


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="seed round")
    add_common_args(p)
    p.add_argument("--seed_percent", type=float, default=0.01)
    return p


def main(argv=None):
    run_seed(parser().parse_args(argv))


if __name__ == "__main__":
    main()
