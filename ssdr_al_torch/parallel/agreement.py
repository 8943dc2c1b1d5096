"""How far a data-parallel train step on the card lies from a float64
step, beside the one-rank step, each with the float64 run's leaky-ReLU
slopes and max-pool picks replayed.

    python -m ssdr_al_torch.parallel.agreement [--points 2048 8192 40960]
        [--ranks 2] [--out FILE] [--device cpu]

For each block size and each of two weight sets (the model's init, and
spread_weights' O(1) weights), one window-engine step at S3DIS width on a
[4 × points] batch, dropout off. train/grad_check.py::reference_step runs
it in float64 on the CPU (on the card's pyramid), recording every leaky
ReLU's slopes and max-pool's picks, and in float32 on the CPU with them
replayed; the f32 run's relative L2 error to the f64 gradient sets the
limit, GRAD_ERR_MULTIPLE times it plus GRAD_ERR_FLOOR. The one-rank step
on the card and the dp step (gloo ranks sharing the card), each with the
pins replayed, are held to the f64 gradient under that limit: the check
of chip_smoke.py's data_parallel_path. Reported per case: the three
errors to f64, the limit, whether both card steps hold it, and the dp
step's loss and gradient distance from the one-rank step. One JSON line
a case on stdout (and in FILE).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ssdr_al_torch.config import ConfigS3DIS, class_weights
from ssdr_al_torch.device import DEFAULT_DEVICE, resolve_device
from ssdr_al_torch.models.randlanet import init_params
from ssdr_al_torch.parallel import dryrun, launch
from ssdr_al_torch.train.grad_check import (
    gradient_rel,
    reference_step,
    spread_weights,
)

ROWS = 4


def case(points: int, weights: str) -> dict:
    """train_step_result's arguments: a seeded [ROWS × points] batch and
    the init ("init") or O(1) ("spread") weights."""
    cfg = dataclasses.replace(ConfigS3DIS, num_points=points,
                              batch_size=ROWS)
    rng = np.random.RandomState(0)
    xyz = (rng.rand(ROWS, points, 3) * 6).astype(np.float32)
    batch = {"xyz": xyz,
             "features": np.concatenate(
                 [xyz, rng.rand(ROWS, points, 3).astype(np.float32)], -1),
             "labels": rng.randint(0, cfg.num_classes,
                                   (ROWS, points)).astype(np.int32),
             "pseudo": rng.randint(0, cfg.num_classes,
                                   (ROWS, points)).astype(np.int32),
             "activation": (rng.rand(ROWS, points) < 0.6).astype(
                 np.float32)}
    state = init_params(cfg, torch.Generator().manual_seed(0))
    if weights == "spread":
        state = spread_weights(state, 5)
    return dict(cfg=cfg, state=state, batch=batch,
                weights=class_weights("S3DIS"))


def measure(points, ranks: int, store_dir: str,
            device=DEFAULT_DEVICE) -> list:
    """One row a (points, weights) case; the ranks share `device`."""
    dev = resolve_device(device)
    cases = [(p, w, case(p, w)) for p in points for w in ("init", "spread")]
    os.makedirs(store_dir, exist_ok=True)
    refs, ones, calls = [], [], []
    for i, (_, _, c) in enumerate(cases):
        ref = reference_step(c["cfg"], c["state"], c["batch"], c["weights"],
                             dev)
        path = os.path.join(store_dir, f"agreement_pins_{i}.pt")
        torch.save({"slopes": ref["slopes"], "pools": ref["pools"]}, path)
        ones.append(dryrun.train_step_result(None, device=dev, pins=ref, **c))
        calls.append((dryrun.train_step_result, dict(c, pins=path)))
        refs.append({k: ref[k] for k in ("grad", "cpu_f32", "limit")})
    try:
        out = launch(dryrun.run_calls, ranks, [dev] * ranks, store_dir,
                     calls)
    finally:
        for _, kw in calls:
            os.remove(kw["pins"])
    rows = []
    for i, (p, w, _) in enumerate(cases):
        one, ref = ones[i], refs[i]
        dp = [r[i][0] for r in out]
        dp_f64 = max(gradient_rel(d["grad"], ref["grad"]) for d in dp)
        one_f64 = gradient_rel(one["grad"], ref["grad"])
        rows.append({
            "points": p, "weights": w, "ranks": ranks,
            "cpu_f32_f64_rel": ref["cpu_f32"], "limit": ref["limit"],
            "one_f64_rel": one_f64, "dp_f64_rel": dp_f64,
            "held": max(one_f64, dp_f64) <= ref["limit"],
            "dp_loss_rel": max(abs(d["loss"] - one["loss"]) / abs(one["loss"])
                               for d in dp),
            "dp_grad_rel": max(gradient_rel(d["grad"], one["grad"])
                               for d in dp)})
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--points", type=int, nargs="+",
                   default=[2048, 8192, 40960])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=DEFAULT_DEVICE)
    a = p.parse_args(argv)
    t0 = time.perf_counter()
    rows = measure(a.points, a.ranks, dryrun.RUN_DIR, a.device)
    lines = [json.dumps(r) for r in rows]
    print("\n".join(lines))
    print(f"agreement: {len(rows)} cases in "
          f"{time.perf_counter() - t0:.1f} s on {a.device}")
    if a.out:
        with open(a.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
