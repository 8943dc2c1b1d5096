"""How far a data-parallel train step on the card lies from the one-rank
step, beside how far the one-rank step moves when only the order of its
batch rows changes (the same step in exact arithmetic).

    python -m ssdr_al_torch.parallel.agreement [--points 2048 8192 40960]
        [--ranks 2] [--out FILE] [--device cpu]

For each block size and each of two weight sets (the model's init, and
spread_weights' O(1) weights), one window-engine step at S3DIS width on a
[4 × points] batch, dropout off: the loss's relative error and the summed
gradient's relative L2 distance of the dp step (gloo ranks sharing the
card) from the one-rank step, and of the one-rank step on the batch's
rows in each other order of ORDERS (reversed, and rolled by 1, 2 and 3
rows). One JSON line a case on stdout (and in FILE). These readings set
chip_smoke.py's DP_SPREAD: max-pool picks and leaky-ReLU slopes within
f32 rounding of a kink follow the summation order, so no fixed gradient
tolerance holds both a dp step and the one-rank step on its rows
reordered.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ssdr_al_torch.config import ConfigS3DIS, class_weights
from ssdr_al_torch.device import DEFAULT_DEVICE, resolve_device
from ssdr_al_torch.models.randlanet import init_params
from ssdr_al_torch.parallel import dryrun, launch
from ssdr_al_torch.train.grad_check import spread_weights

ROWS = 4
ORDERS = {"reversed": np.arange(ROWS)[::-1],
          **{f"rolled_{r}": np.roll(np.arange(ROWS), r)
             for r in range(1, ROWS)}}


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
    ones, others = [], []
    for _, _, c in cases:
        ones.append(dryrun.train_step_result(None, device=dev, **c))
        others.append({name: dryrun.train_step_result(None, device=dev, **dict(
            c, batch={k: v[order] for k, v in c["batch"].items()}))
            for name, order in ORDERS.items()})
    out = launch(dryrun.run_calls, ranks, [dev] * ranks, store_dir,
                 [(dryrun.train_step_result, c) for _, _, c in cases])
    rows = []
    for i, (p, w, _) in enumerate(cases):
        one = ones[i]
        dp = [r[i][0] for r in out]

        def loss_rel(x):
            return abs(x["loss"] - one["loss"]) / abs(one["loss"])

        row = {"points": p, "weights": w, "ranks": ranks,
               "dp_loss_rel": max(map(loss_rel, dp)),
               "dp_grad_rel": max(dryrun.gradient_rel(d["grad"],
                                                      one["grad"])
                                  for d in dp)}
        for name, x in others[i].items():
            row[f"{name}_loss_rel"] = loss_rel(x)
            row[f"{name}_grad_rel"] = dryrun.gradient_rel(x["grad"],
                                                          one["grad"])
        rows.append(row)
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
