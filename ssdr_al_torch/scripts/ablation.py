"""Sampler ablation: does SSDR selection beat random selection at the same
click budget? The twin of scripts/ablation.py, on the port.

    python -m ssdr_al_torch.scripts.ablation --rooms 3 --points 12000 \
        --seed_percent 0.02 --clicks 40 --rounds 10 \
        --configs random,sb_mean,ssdr_full,ssdr_dom --t 0 [--device cpu]

The same flags, configs, seeds and records as scripts/ablation.py, plus
`--device` (default: the card). Hard synthetic rooms (8 classes,
data/synthetic.py::make_room_hard) are partitioned (compute_superpoints,
knn_backend auto: K6's K = 64 instantiation on the card, cKDTree on the
CPU); a seed round labels `seed_percent` of the superpoints (SeedSampler,
seed 0) and trains snap-1; then each config runs rounds 2..rounds: restore
the last snapshot, select `clicks` clicks (RandomSampler with the dominant
oracle, seed t, or TSampler with the config's arguments, seed t), and
train a round on a TrainingPipeline seeded 1000·t + 100 + round (or, with
`--pool`, on a DeviceTrainPool reseeded so), each round evaluated on the
validation room (Evaluator, 6 epochs). Unit class weights, 4096-point
blocks, batch 4.

Writes one JSON line per record to stdout, with the keys of the JAX
script's: {"event": "setup", "total_sp", "clicks_per_round", "rounds"},
{"sampler": "seed", "round": 1, "miou", "oa"}, one {"sampler", "round",
"miou", "oa", "labeled_sp", "labeled_pts", "pseudo_acc", "coverage",
"sel_s", "train_s"} per (config, round), and {"event": "done",
"final_miou", ...}; so scripts/ablation_summary.py merges trials of
either. The port adds {"event": "device", "kind", "card"} first and, on
the card, {"event": "launches", "phase", "counts"} after the partition,
the seed round and each config: each kernel's launches in that phase.
A markdown summary goes to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np


def sampler_configs():
    """[(tag, "random" or TSamplerArgs)]: the six configs of
    scripts/ablation.py, in its order."""
    from ssdr_al_torch.active.samplers import TSamplerArgs

    def ssdr(diversity, oracle="NAIL"):
        return TSamplerArgs(point_uncertainty_mode="sb",
                            uncertainty_mode="WetSU", oracle_mode=oracle,
                            class_balance="clsbal", diversity=diversity)

    return [
        ("random", "random"),
        ("sb_mean", TSamplerArgs(
            point_uncertainty_mode="sb", uncertainty_mode="mean",
            oracle_mode="dominant", class_balance="", diversity="")),
        ("ssdr_full", ssdr("gcn_fps")),
        # the diversity stack with the dominant oracle: isolates NAIL's
        # split-budget cost
        ("ssdr_dom", ssdr("gcn_fps", "dominant")),
        # the trainable-coreGCN branch: the 20 000-step fit + k-center
        ("ssdr_gcn", ssdr("gcn")),
        # superpoint FPS over centroid ED + chamfer CD on the candidates
        ("ssdr_edcd", ssdr("edcd")),
    ]


def _launches(dev, log, phase):
    """Log the kernels' launch counts since the last call and reset them
    (the card only: CPU tensors launch nothing)."""
    if dev.type != "cuda":
        return
    from ssdr_al_torch.kernels import counts

    log({"event": "launches", "phase": phase,
         "counts": {k: v for k, v in counts.read().items() if v}})
    counts.reset()


def run_config(tag, sampler_kind, workdir, train, val, cfg, total_sp,
               seed_percent, rounds, clicks, log, t=0, start_round=2,
               use_pool=False, device="cuda"):
    """The seed round (once per workdir) and rounds start_round..rounds of
    one config; returns its round records."""
    import torch

    from ssdr_al_torch.active.samplers import (
        RandomSampler,
        SeedSampler,
        TSampler,
    )
    from ssdr_al_torch.active.state import ALState, RoundStats
    from ssdr_al_torch.data.dataset import TrainingPipeline
    from ssdr_al_torch.train.evaluator import Evaluator
    from ssdr_al_torch.train.trainer import Trainer

    dev = torch.device(device)
    state = ALState(workdir, [tag, f"t{t}"])
    seed_state = ALState(workdir, ["seed"])
    weights = np.ones(cfg.num_classes, np.float32)

    pool = None
    if use_pool:
        from ssdr_al_torch.train.device_pool import DeviceTrainPool

        pool = DeviceTrainPool(train, cfg, seed=1, device=dev)
        if not pool.available:
            pool = None

    def trainer_for(save):
        return Trainer(cfg, "S3DIS", save_dir=os.path.join(
            workdir, "saver", save, "snapshots"),
            seed_save_dir=os.path.join(workdir, "saver", "seed",
                                       "snapshots"),
            log_fn=lambda *_: None, weights=weights, device=dev)

    trainer = trainer_for(f"{tag}_t{t}")
    evaluate = Evaluator(cfg, val, max_epochs=6)

    # the seed round: its selection is the same for every config
    # (SeedSampler seed 0); trained once per workdir
    if not os.path.exists(os.path.join(workdir, "saver", "seed",
                                       "snapshots", "snap-1")):
        seeder = SeedSampler(seed_state, train, total_sp, seed=0)
        seeder.sampling(max(1, int(total_sp * seed_percent)), 0, RoundStats())
        round_dir = seed_state.round_dir(1)
        pseudo = {c.name: seed_state.load_pseudo_gt(round_dir, c.name)
                  for c in train}
        pipe = TrainingPipeline(train, cfg, pseudo_gt=pseudo, seed=1)
        seed_trainer = trainer_for("seed")
        seed_trainer.init_state(pipe.sample_batch(cfg.batch_size))
        if pool is not None:
            pool.update_pseudo_gt(pseudo)
            pool.reseed(1)
        miou, oa = seed_trainer.train_round(
            1, lambda e: pipe.batches(cfg.train_steps, cfg.batch_size),
            evaluate, device_pool=pool)
        log({"sampler": "seed", "round": 1, "miou": round(miou, 4),
             "oa": round(oa, 4)})
        _launches(dev, log, "seed")

    if sampler_kind == "random":
        sampler = RandomSampler(state, train, total_sp, min_size=1,
                                oracle_mode="dominant", seed=t)
    else:
        sampler = TSampler(state, train, cfg, sampler_kind, total_sp, seed=t,
                           device=dev)
    trainer.init_state(
        TrainingPipeline(train, cfg, seed=2).sample_batch(cfg.batch_size))

    curve = []
    for r in range(start_round, rounds + 1):
        trainer.restore_model(r - 1)
        stats = RoundStats()
        t0 = time.time()
        if sampler_kind == "random":
            sampler.sampling(clicks, r - 1, stats)
        else:
            sampler.sampling(trainer.eval_step, trainer.state, clicks,
                             r - 1, stats)
        sel_t = time.time() - t0

        round_dir = state.round_dir(r)
        pseudo = {c.name: state.load_pseudo_gt(round_dir, c.name)
                  for c in train}
        pipe = TrainingPipeline(train, cfg, pseudo_gt=pseudo,
                                seed=1000 * t + 100 + r)
        t0 = time.time()
        if pool is not None:
            pool.update_pseudo_gt(pseudo)
            pool.reseed(1000 * t + 100 + r)
        miou, oa = trainer.train_round(
            r, lambda e: pipe.batches(cfg.train_steps, cfg.batch_size),
            evaluate, device_pool=pool)
        # pseudo-label quality: the activated pseudo labels' accuracy
        # against the true labels, and the labelled share of the points
        pg_hit = pg_n = tot_n = 0
        for c in train:
            pg = pseudo[c.name]
            act = pg[0] > 0
            pg_hit += int((pg[1][act].astype(np.int64)
                           == c.labels[act]).sum())
            pg_n += int(act.sum())
            tot_n += c.num_points
        rec = {"sampler": tag, "round": r, "miou": round(miou, 4),
               "oa": round(oa, 4), "labeled_sp": stats.sp_num,
               "labeled_pts": stats.p_num + stats.sub_p_num,
               "pseudo_acc": round(pg_hit / max(pg_n, 1), 4),
               "coverage": round(pg_n / max(tot_n, 1), 4),
               "sel_s": round(sel_t, 1),
               "train_s": round(time.time() - t0, 1)}
        log(rec)
        curve.append(rec)
    _launches(dev, log, tag)
    return curve


def ablation_config(max_epoch: int, train_steps: int):
    """The ablation's model configuration (scripts/ablation.py): S3DIS
    RandLA-Net on 4096-point blocks of the 8 hard synthetic classes."""
    import dataclasses

    from ssdr_al_torch.config import ConfigS3DIS
    from ssdr_al_torch.data.synthetic import NUM_SYNTH_CLASSES_HARD

    return dataclasses.replace(
        ConfigS3DIS, num_points=4096, num_classes=NUM_SYNTH_CLASSES_HARD,
        batch_size=4, val_batch_size=4, train_steps=train_steps,
        val_steps=10, max_epoch=max_epoch, eval_start_frac=0.5)


def parser():
    from ssdr_al_torch.device import DEFAULT_DEVICE

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--clicks", type=int, default=40)
    p.add_argument("--rooms", type=int, default=4)
    p.add_argument("--points", type=int, default=20000)
    p.add_argument("--seed_percent", type=float, default=0.01)
    p.add_argument("--reg_strength", type=float, default=0.03)
    p.add_argument("--out", default=os.path.join("build", "ablation.md"),
                   help="the markdown summary")
    p.add_argument("--workdir", default="")
    p.add_argument("--t", type=int, default=0,
                   help="trial seed: varies sampler + training-pipeline RNG")
    p.add_argument("--configs", default="random,sb_mean,ssdr_full",
                   help="comma-separated subset of: random, sb_mean, "
                        "ssdr_full, ssdr_dom, ssdr_gcn, ssdr_edcd "
                        "('' = all)")
    p.add_argument("--train_steps", type=int, default=30,
                   help="steps per epoch (reference: 500, helper_tool.py:52)")
    p.add_argument("--max_epoch", type=int, default=3,
                   help="epochs per AL round (reference: 30)")
    p.add_argument("--start_round", type=int, default=2,
                   help="resume: the first AL round to run (needs --workdir "
                        "with the earlier rounds on disk)")
    p.add_argument("--pool", action="store_true",
                   help="train on the DeviceTrainPool (blocks extracted on "
                        "the device) in place of the host pipeline")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="cuda (default) or cpu")
    return p


def main(argv=None, log=None) -> dict:
    """Run the ablation; returns {tag: round records}. `log` takes each
    record (default: one JSON line on stdout)."""
    from ssdr_al_torch.active.state import ALState
    from ssdr_al_torch.data.synthetic import (
        NUM_SYNTH_CLASSES_HARD,
        make_dataset,
    )
    from ssdr_al_torch.device import resolve_device
    from ssdr_al_torch.partition.superpoint import compute_superpoints

    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    if log is None:
        def log(rec):
            print(json.dumps(rec), flush=True)

    cfg = ablation_config(args.max_epoch, args.train_steps)
    work = args.workdir or tempfile.mkdtemp(prefix="ablation_")
    os.makedirs(work, exist_ok=True)
    curves = {}
    try:
        if dev.type == "cuda":
            import torch

            from ssdr_al_torch.kernels import counts

            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip()
            log({"event": "device", "kind": torch.cuda.get_device_name(dev),
                 "card": card})
            counts.reset()
        else:
            log({"event": "device", "kind": "cpu", "card": None})
        train, val = make_dataset(num_train=args.rooms, num_val=1,
                                  num_points=args.points, hard=True)
        state = ALState(work, ["partition"])
        if os.path.exists(os.path.join(state.superpoint_dir, "total.pkl")):
            # a --workdir shared across trials: the partition and the seed
            # round do not depend on the trial
            total = state.load_registry()
        else:
            total = compute_superpoints(train, state, args.reg_strength,
                                        device=dev, log=lambda *a: None)
            _launches(dev, log, "partition")
        total_sp = total["sp_num"]
        log({"event": "setup", "total_sp": total_sp,
             "clicks_per_round": args.clicks, "rounds": args.rounds})

        all_configs = sampler_configs()
        wanted = [c for c in args.configs.split(",") if c]
        unknown = set(wanted) - {name for name, _ in all_configs}
        if unknown:
            raise SystemExit(
                f"unknown --configs {sorted(unknown)}; "
                f"choose from {[name for name, _ in all_configs]}")
        configs = [c for c in all_configs if not wanted or c[0] in wanted]
        for tag, kind in configs:
            curves[tag] = run_config(
                tag, kind, work, train, val, cfg, total_sp,
                args.seed_percent, args.rounds, args.clicks, log, t=args.t,
                start_round=args.start_round, use_pool=args.pool,
                device=dev)

        final = {t: curves[t][-1]["miou"] for t, _ in configs}
        if args.start_round > 2:
            # a resumed run's curves are partial: summarise the JSONL
            log({"event": "done", "final_miou": final, "resumed": True})
            return curves
        lines = [
            "# Sampler ablation (hard synthetic scenes)", "",
            f"{args.rooms} rooms x {args.points} pts, "
            f"{NUM_SYNTH_CLASSES_HARD} classes, {total_sp} superpoints, "
            f"seed {args.seed_percent:.0%}, {args.clicks} clicks/round.", "",
            "| round | " + " | ".join(t for t, _ in configs) + " |",
            "|---| " + " | ".join("---" for _ in configs) + " |",
        ]
        for i in range(args.rounds - 1):
            row = [str(curves[configs[0][0]][i]["round"])]
            row += [f"{curves[t][i]['miou']:.4f}" for t, _ in configs]
            lines.append("| " + " | ".join(row) + " |")
        lines += ["", f"Final-round mIoU: {json.dumps(final)}", ""]
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines))
        log({"event": "done", "final_miou": final, "out": args.out})
    finally:
        if not args.workdir:
            shutil.rmtree(work, ignore_errors=True)
    return curves


if __name__ == "__main__":
    main()
