"""Smoke run of ssdr_al_torch on one NVIDIA GPU: build the CUDA kernels,
hold each against its plain PyTorch version at the main path's shapes
(K1, its centred-product form K5 and K2 at every call of one forward,
both K2 sources, K6 at every call of one exact pyramid, tie-heavy inputs,
K4 at every call of one train step, bitwise, each at S3DIS, Semantic3D
[4 × 65536] and SemanticKITTI [6 × 45056] width, and K3 at a fixed
dispatch and the selection round's shape: ssdr_al_torch/kernels/
measure.py), then drive the closed active-learning loop at RandLA-Net
S3DIS width through the kernels: seed labels, round-1 training with
evaluation to snap-1, the card's train-mode gradient against float32 and
float64 CPU gradients at a seeded state, and at eight seeded states with
the float64 run's leaky-ReLU slopes and max-pool picks pinned in both f32
runs, a full-SSDR selection round from
the trained snap-1 (its K3 call checked again and its GCN-FPS picks
compared on K3's and the plain version's chamfer matrices), and round-2
training on the device training pool (DeviceTrainPool, al_loop's
default) from its pseudo-GT to snap-2. Then the exact-KNN engine at the
same width: a training round
with --knn_engine pallas (K6) from the seed labels, the standalone
evaluation (cli.evaluate) of its snapshot on the validation room, and one
eval step each on the window_og (K1), approx and window-with-K5
(MXU_DISTANCE_DEFAULT) engines. Then the Semantic3D loop at
ConfigSemantic3D width ([4 × 65536]): seed labels,
round-1 training on the PossibilityDevicePool with evaluation, a
full-SSDR selection round (K3) and round-2 training on the pool; one
SemanticKITTI train step and eval step at its width ([6 × 45056], 4
layers); and the median of 20 warm steps of the host-pipeline and pooled
S3DIS steps and the possibility-pooled Semantic3D step
(ssdr_al_torch/train/step_times.py). Then --compute_dtype bfloat16:
K2's bf16-output and K4's bf16-cotangent instantiations at every K2 call
of a bf16 forward [8 × 40960] and every K4 call of a bf16 train step
[6 × 40960], bitwise against their plain versions; from round 1's f32
snap-1, a bf16 training round on the device pool, bf16 and f32 eval steps
[8 × 40960] timed in turns and their class agreement on the validation
room. Then the paper's comparison branches from the same snap-1: one
selection round each with --sampler random, --edcd 1 (K3 per candidate
cloud) and --gcn 1 (K3, the 20 000-step coreGCN fit and k-center), and
one round each of cli.baseline and cli.max_dominant at the smoke's depth.

    python3 chip_smoke.py [--profile [PATH]]

Needs a CUDA device and nvcc; exits non-zero without them. Prints the
card's name and power limit, the build time, each kernel's check, times
and bound, the training and selection phases with their kernel launch
counts, a JSON line of kernel results, and as its last line
{"ok": true, "device": {...}}. Works under <repo>/build/ only.

--profile adds, after the checked loop, the breakdown of warm selection
rounds (wall clock and phase times unprofiled, device busy time and top
device kernels under torch.profiler, host functions under cProfile, one
eval step [8, 40960] and its pyramid by CUDA events) and of one warm
train step [6, 40960] (device busy share and top device kernels under
torch.profiler). It prints a summary and writes everything as JSON to
PATH (default build/profile_round.json).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

KERNELS = {
    "window_topk": ("ssdr_al_torch/csrc/window_topk.cu",
                    "ssdr_al_tpu/ops/knn.py:267"),
    "gather_window": ("ssdr_al_torch/csrc/gather_window.cu",
                      "ssdr_al_tpu/ops/gather.py:62"),
    "chamfer_sums": ("ssdr_al_torch/csrc/chamfer_sums.cu",
                     "ssdr_al_tpu/ops/chamfer.py:320"),
    "scatter_window": ("ssdr_al_torch/csrc/scatter_window.cu",
                       "ssdr_al_tpu/ops/gather.py:184"),
    "window_topk_mxu": ("ssdr_al_torch/csrc/window_topk.cu",
                        "ssdr_al_tpu/ops/knn.py:326"),
    "knn_tiled": ("ssdr_al_torch/csrc/knn_tiled.cu",
                  "ssdr_al_tpu/ops/knn.py:760"),
    "gather_window_bf16": ("ssdr_al_torch/csrc/gather_window.cu",
                           "ssdr_al_tpu/ops/gather.py:62"),
    "scatter_window_bf16": ("ssdr_al_torch/csrc/scatter_window.cu",
                            "ssdr_al_tpu/ops/gather.py:184"),
}
ROOMS, ROOM_POINTS, TARGET_SP, BUDGET = 4, 150_000, 2048, 400
TRAIN_EPOCHS, TRAIN_STEPS, VAL_STEPS = 2, 8, 2
GRAD_SEED = 5                 # the gradient check's seeded state
PINNED_SEEDS = range(8)       # the pinned gradient check's seeded states
EXACT_EPOCHS, EXACT_STEPS = 1, 4      # the --knn_engine pallas round
# the Semantic3D loop: synthetic clouds, grid superpoints a cloud, clicks
S3D_CLOUDS, S3D_CLOUD_POINTS, S3D_TARGET_SP, S3D_BUDGET = 3, 300_000, 4096, 300
S3D_EPOCHS, S3D_STEPS = 2, 6
SSDR_ARGS = ["t0", "sb", "clsbal", "gcn_fps", "WetSU", "NAIL", "0.9", "1",
             "1", "0"]
BF16_EPOCHS, BF16_STEPS = 1, 4        # the bf16 training round
# the comparison branches' selection rounds from snap-1
BRANCH_ARGS = {
    "random": ["t0", "random", "dominant", "0.9", "1", "1", "0"],
    "edcd": ["t0", "sb", "clsbal", "edcd", "WetSU", "NAIL", "0.9", "1", "1",
             "0"],
    "gcn": ["t0", "sb", "clsbal", "gcn", "WetSU", "NAIL", "0.9", "1", "1",
            "0"],
}
# cli.baseline and cli.max_dominant: synthetic rooms, one round
DRIVER_ROOMS, DRIVER_EPOCHS, DRIVER_STEPS = 2, 1, 4


def cuda_ms(fn, reps):
    """Mean device time of fn() in ms over `reps` runs, after a warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_counters():
    """{kernel: (wrapper, attribute holding its launch count)}."""
    from ssdr_al_torch.ops.chamfer import chamfer_sums
    from ssdr_al_torch.ops.gather import gather_window, scatter_window
    from ssdr_al_torch.ops.knn import knn_tiled, window_topk

    return {"window_topk": (window_topk, "launches"),
            "gather_window": (gather_window, "launches"),
            "chamfer_sums": (chamfer_sums, "launches"),
            "scatter_window": (scatter_window, "launches"),
            "window_topk_mxu": (window_topk, "launches_mxu"),
            "knn_tiled": (knn_tiled, "launches"),
            "gather_window_bf16": (gather_window, "launches_bf16"),
            "scatter_window_bf16": (scatter_window, "launches_bf16")}


def reset_counts():
    for fn, attr in kernel_counters().values():
        setattr(fn, attr, 0)


def read_counts():
    return {name: getattr(fn, attr)
            for name, (fn, attr) in kernel_counters().items()}


def require_launched(path, counts, names):
    missing = [n for n in names if counts[n] < 1]
    if missing:
        raise AssertionError(f"{path}: kernels of the path never launched: "
                             f"{missing} ({counts})")


def sorted_batch(rng, b, n, dev):
    from ssdr_al_torch.ops.knn import morton_codes, sort_by_codes

    xyz = torch.from_numpy((rng.rand(b, n, 3) * 6).astype(np.float32)).to(dev)
    lo, hi = xyz.amin(1, keepdim=True), xyz.amax(1, keepdim=True)
    _, _, xs = sort_by_codes(morton_codes(xyz, lo, hi), xyz)
    return xs.contiguous()


def check_kernels(cfg, dev):
    """Each kernel vs its plain version on the card, at the main path's
    shapes: its time, the plain version's, the bound and, where one PyTorch
    call computes the same function, that call's time. K1, K5 and K2 at
    every call of one forward, K6 at every call of one exact pyramid,
    K1, K5, K2 and K6 on tie-heavy inputs, K4 at every call of one train
    step, K3 at two shapes (kernels/measure.py)."""
    from ssdr_al_torch.kernels import measure
    from ssdr_al_torch.ops import knn as kn

    b, n = 8, cfg.num_points
    out = {}

    # every K1, K5, K2 and K4 call of one Semantic3D forward and train step
    # and K6 call of its exact pyramid [4 x 65536], first: a launch setting
    # needed only at these shapes must not be left to an earlier call; then
    # of one SemanticKITTI forward, exact pyramid and train step [6 x
    # 45056] (4 layers)
    from ssdr_al_torch.config import ConfigSemantic3D, ConfigSemanticKITTI

    wide = {}
    for name, c in (("Semantic3D", ConfigSemantic3D),
                    ("SemanticKITTI", ConfigSemanticKITTI)):
        r = wide[name] = measure.check_main_path(
            c, dev, b_eval=c.batch_size, b_train=c.batch_size,
            shape_free=False)
        k4r = r["scatter_window"]
        print(f"{name}: {len(r['window_topk'])} K1 and K5, "
              f"{len(r['gather_window'])} K2, {len(k4r)} K4, "
              f"{len(r['knn_tiled'])} K6 calls equal to "
              f"their plain versions; K4 rows past the bins per call "
              f"{[x.get('overflow_rows') for x in k4r]}")
    s3d, kitti = wide["Semantic3D"], wide["SemanticKITTI"]
    main = measure.check_main_path(cfg, dev)
    k1_calls, _ = main["calls"]
    # the L0 self-search (k=16, W=1792) and the L0 1-NN upsample
    i0 = next(i for i, c in enumerate(k1_calls)
              if c["self"] and c["queries"].shape[1] == n)
    iu = next(i for i, c in enumerate(k1_calls)
              if not c["self"] and c["queries"].shape[1] == n)
    xs, st, w = (k1_calls[i0][key] for key in ("support", "starts",
                                               "window"))
    r1 = main["window_topk"][i0]
    out["window_topk"] = dict(r1, ms_k1=main["window_topk"][iu]["ms"],
                              shapes=main["window_topk"], ties=main["ties"],
                              shapes_semantic3d=s3d["window_topk"],
                              shapes_semantickitti=kitti["window_topk"])
    # K1 on the window_og path: the self-searches of L0 (W=4096) and of L1
    # ([8x10240], W=2048)
    og = {}
    rng_og = np.random.RandomState(4)
    for layer, m, w_og in (("L0", n, 4096), ("L1", n // 4, 2048)):
        x_og = xs if m == n else sorted_batch(rng_og, b, m, dev)
        st_og = kn.self_query_starts(m, m, w_og, device=dev).expand(
            b, -1).contiguous()
        r = measure.check_k1(dict(support=x_og, queries=x_og, starts=st_og,
                                  k=cfg.k_n, window=w_og,
                                  tq=kn.QUERY_TILE, self=True))
        og[layer] = dict(window=w_og, ms=r["ms"], plain_ms=r["plain_ms"],
                         bound_ms=r["bound_ms"])
        print(f"K1 window_topk window_og {layer} {r['shape']}: equal, "
              f"{r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']})")
    out["window_topk"]["window_og"] = og

    # K5: K1 with the centred-product distance and its own block skip, at
    # every K1 call of the three forwards (measure.check_main_path); the
    # row is the L0 self-search's
    k5 = main["window_topk_mxu"]
    agree5 = (kn.window_topk(xs, xs, st, cfg.k_n, w, mxu=True)
              == kn.window_topk(xs, xs, st, cfg.k_n, w)).float().mean().item()
    print(f"K5 window_topk mxu at {len(k5)} + {len(s3d['window_topk_mxu'])} "
          f"+ {len(kitti['window_topk_mxu'])} calls: equal; ms / K1's ms "
          f"{[round(r['ms'] / r['ms_k1'], 3) for r in k5]}; L0 indices "
          f"equal to K1's on {agree5:.5f}")
    out["window_topk_mxu"] = dict(k5[i0], agreement_with_k1=agree5,
                                  shapes=k5,
                                  shapes_semantic3d=s3d["window_topk_mxu"],
                                  shapes_semantickitti=kitti[
                                      "window_topk_mxu"])

    # K6: every call of one exact (`pallas`) pyramid at the three widths
    # (measure.check_k6, each equal to the plain version); the row is the
    # S3DIS L0 self-search [8 x 40960] k=16
    k6 = main["knn_tiled"]
    print(f"K6 knn_tiled at {len(k6)} + {len(s3d['knn_tiled'])} + "
          f"{len(kitti['knn_tiled'])} calls of exact pyramids: equal; "
          f"S3DIS sum {sum(r['ms'] for r in k6):.3f} ms (cdist+topk "
          f"{sum(r['library_ms'] for r in k6):.3f} ms), pairs evaluated "
          f"{[round(100 * r['pair_share'], 3) for r in k6]} %")
    out["knn_tiled"] = dict(k6[0], shapes=k6,
                            shapes_semantic3d=s3d["knn_tiled"],
                            shapes_semantickitti=kitti["knn_tiled"],
                            library_call="torch.topk(torch.cdist(q, s)) in "
                                         "4096-query chunks (two calls)")

    # K2 at the L0 LFA gather of [xyz | 8 features] (the first K2 call)
    out["gather_window"] = dict(main["gather_window"][0],
                                shapes=main["gather_window"],
                                shapes_semantic3d=s3d["gather_window"],
                                shapes_semantickitti=kitti["gather_window"])

    # K4: the 9 calls of one train step [6 x 40960], each bitwise equal to
    # the CPU plain version and to itself (measure.check_k4); the row sums
    # them, each field over the same 9 calls
    k4, k4s, k4k = (x["scatter_window"] for x in (main, s3d, kitti))
    out["scatter_window"] = dict(
        {key: sum(r[key] for r in k4) for key in ("ms", "plain_ms",
                                                  "bound_ms", "library_ms")},
        max_abs_err=max(r["max_abs_err"] for r in k4 + k4s + k4k),
        bound_by="bytes", calls=len(k4), shapes=k4, shapes_semantic3d=k4s,
        shapes_semantickitti=k4k)
    # K3: one [8, 256, 512] dispatch at 60 % valid, and the selection
    # round's call shape (measure.check_k3)
    out["chamfer_sums"] = dict(main["chamfer_sums"][0],
                               shapes=main["chamfer_sums"])
    # K2-bf16 at every K2 call of one bf16 forward [8 x 40960] (the row is
    # the L0 LFA gather's) and K4-bf16 at every K4 call of one bf16 train
    # step [6 x 40960] (the row sums them), each bitwise equal to its
    # plain version (measure.check_bf16_path)
    bf = measure.check_bf16_path(cfg, dev)
    k2b, k4b = bf["gather_window_bf16"], bf["scatter_window_bf16"]
    out["gather_window_bf16"] = dict(k2b[0], shapes=k2b,
                                     library_call="torch.gather of the "
                                     "values cast to bf16")
    out["scatter_window_bf16"] = dict(
        {key: sum(r[key] for r in k4b) for key in ("ms", "plain_ms",
                                                   "bound_ms", "library_ms")},
        max_abs_err=max(r["max_abs_err"] for r in k4b), bound_by="bytes",
        calls=len(k4b), shapes=k4b,
        library_call="index_add_ of the cotangent widened to f32")
    print(f"bf16: {len(k2b)} K2 calls and {len(k4b)} K4 calls bitwise equal "
          f"to their plain versions; K2 sum {sum(r['ms'] for r in k2b):.4f} "
          f"ms (bound {sum(r['bound_ms'] for r in k2b):.4f}), K4 sum "
          f"{out['scatter_window_bf16']['ms']:.4f} ms (bound "
          f"{out['scatter_window_bf16']['bound_ms']:.4f})")
    return out


def check_forward_reference(cfg, state, dev):
    """One 40960-point block: the forward on the card (kernels) against the
    same forward on the CPU (plain versions): finite, same shapes, same
    classes on ≥ 99.9 % of points, penult within 1e-3 relative."""
    from ssdr_al_torch.models.randlanet import RandLANet
    from ssdr_al_torch.train.trainer import make_eval_step

    rng = np.random.RandomState(1)
    xyz = (rng.rand(1, cfg.num_points, 3) * 6).astype(np.float32)
    batch = {"xyz": xyz, "features": np.concatenate(
        [xyz, rng.rand(1, cfg.num_points, 3).astype(np.float32)], -1)}
    gpu = make_eval_step(RandLANet(cfg).to(dev), cfg, "window", False,
                         device=dev)(state, batch)
    cpu_state = {k: v.cpu() for k, v in state.items()}
    cpu = make_eval_step(RandLANet(cfg), cfg, "window", False,
                         device="cpu")(cpu_state, batch)
    for g, c in zip(gpu, cpu):
        if g.shape != c.shape or not torch.isfinite(g).all():
            raise AssertionError(f"forward output {tuple(g.shape)} bad")
    agree = (gpu[0].argmax(-1).cpu() == cpu[0].argmax(-1)).float().mean()
    rel = ((gpu[1].cpu() - cpu[1]).norm() / cpu[1].norm()).item()
    print(f"forward [1x{cfg.num_points}] card vs CPU plain: class agreement "
          f"{agree.item():.5f}, penult rel err {rel:.2e}")
    if agree < 0.999 or rel > 1e-3:
        raise AssertionError("card forward disagrees with the CPU reference")


def check_gradient_reference(cfg, dev):
    """The train-mode gradient of one 40960-point block at the seeded
    state GRAD_SEED on the card (K1, K2, K4) and on the CPU in float32,
    each against the CPU in float64 (train/grad_check.py::
    gradient_errors): the card's loss within 1e-4 relative of the CPU's,
    its gradient's relative L2 error to the f64 gradient at most
    GRAD_ERR_MULTIPLE times the CPU f32 gradient's plus GRAD_ERR_FLOOR."""
    from ssdr_al_torch.train.grad_check import gradient_errors

    res = gradient_errors(cfg, dev, GRAD_SEED)
    if not res["passed"]:
        raise AssertionError("card gradient disagrees with the CPU reference")
    return res


def check_pinned_gradients(cfg, dev):
    """The same check at the seeded states PINNED_SEEDS with every leaky
    ReLU's slope and every max-pool's pick taken from the float64 run
    (train/grad_check.py: gradient_errors(pinned=True)), so that it measures the
    arithmetic rather than which side of a kink an input within f32
    rounding of it lands on: at each seed the card's error within
    GRAD_ERR_MULTIPLE times the CPU f32 error plus GRAD_ERR_FLOOR."""
    from ssdr_al_torch.train.grad_check import gradient_errors

    ratios = {}
    for seed in PINNED_SEEDS:
        res = gradient_errors(cfg, dev, seed, pinned=True)
        ratios[seed] = res["card"] / res["cpu_f32"]
        if not res["passed"]:
            raise AssertionError(f"pinned gradient at seed {seed}: card "
                                 f"{res['card']:.3e} over {res['limit']:.3e}")
    print("pinned gradient check, card/CPU f32 error ratios by seed: "
          + json.dumps({k: round(v, 4) for k, v in ratios.items()}))
    return ratios



def check_selection_picks(k3_call, fps_call):
    """GCN-FPS of the selection round on the chamfer matrix from K3 and on
    the one from its plain version (the same epilogue, on the card), from
    the round's own rng state: the same superpoints. Both matrices are
    rebuilt from one ED part, graph.ed_cd − CD(K3)."""
    from ssdr_al_torch.ops import chamfer as ch

    points, mask = k3_call
    fps, graph, args, kwargs, rng_state = fps_call
    cds = [ch.chamfer_pairwise_blocks(points, mask).cpu().numpy()]
    kernel = ch.chamfer_sums
    ch.chamfer_sums = ch._chamfer_sums_plain
    try:
        cds.append(ch.chamfer_pairwise_blocks(points, mask).cpu().numpy())
    finally:
        ch.chamfer_sums = kernel
    ed = graph.ed_cd.copy()
    for ci, s in enumerate(graph.mask.sum(1)):
        ed[ci, :s, :s] -= cds[0][ci, :s, :s]
    picks = []
    for cd in cds:
        m = graph.ed_cd.copy()
        for ci, s in enumerate(graph.mask.sum(1)):
            m[ci, :s, :s] = ed[ci, :s, :s] + cd[ci, :s, :s]
        rng = np.random.RandomState()
        rng.set_state(rng_state)
        got = fps(dataclasses.replace(graph, ed_cd=m), *args,
                  **dict(kwargs, rng=rng))
        picks.append({k: sorted(int(x) for x in v) for k, v in got.items()})
    real = (cds[1] < 1e12) & (cds[1] > 0)
    rel = float((np.abs(cds[0] - cds[1])[real] / cds[1][real]).max())
    shape = "x".join(map(str, mask.shape))
    print(f"GCN-FPS on the selection call's chamfer [{shape}] from K3 and "
          f"from the plain version: {sum(map(len, picks[0].values()))} "
          f"picks, identical {picks[0] == picks[1]} (matrices' max rel diff "
          f"{rel:.2e})")
    if picks[0] != picks[1]:
        raise AssertionError("GCN-FPS picks differ between K3 and its plain "
                             "version")


def make_workload(cfg, work):
    """Synthetic hard rooms, grid superpoints as the registry, and the seed
    round's precise labels (1/20 of the superpoints)."""
    from ssdr_al_torch.active.samplers import SeedSampler
    from ssdr_al_torch.active.state import ALState, RoundStats
    from ssdr_al_torch.cli.common import write_grid_superpoints
    from ssdr_al_torch.data.synthetic import make_dataset

    t0 = time.perf_counter()
    train, val = make_dataset(num_train=ROOMS, num_val=1,
                              num_points=ROOM_POINTS, seed=0, hard=True)
    total = write_grid_superpoints(ALState(work, []), train, TARGET_SP)
    sp_num = total["sp_num"]
    SeedSampler(ALState(work, ["seed"]), train, sp_num).sampling(
        sp_num // 20, 0, RoundStats())
    print(f"workload: {ROOMS} train rooms + 1 val room x {ROOM_POINTS} "
          f"points, {sp_num} superpoints, setup "
          f"{time.perf_counter() - t0:.1f} s")
    return train, val, total


def train_round(trainer, round_num, clouds, val, pseudo, seed, pool=None):
    """Trainer.train_round with evaluation, on the host pipeline or on
    `pool` (a DeviceTrainPool or PossibilityDevicePool, its planes and
    streams set for the round here); returns the host pipeline and the
    round's wall clock after checking every step's loss (device scalars)."""
    from ssdr_al_torch.data.dataset import TrainingPipeline
    from ssdr_al_torch.train.evaluator import Evaluator
    from ssdr_al_torch.train.possibility_pool import PossibilityDevicePool

    cfg = trainer.cfg
    pipe = TrainingPipeline(clouds, cfg, pseudo_gt=pseudo, seed=seed)
    attr = ("train_step" if pool is None else "possibility_step"
            if isinstance(pool, PossibilityDevicePool) else "pooled_step")
    if pool is not None:
        pool.update_pseudo_gt(pseudo)
        pool.reseed(seed)
        if isinstance(pool, PossibilityDevicePool):
            pool.reset_possibility(seed)
    losses, step = [], getattr(trainer, attr)

    def recording(*args):
        out = step(*args)
        losses.append(out[-1]["loss"])
        return out

    setattr(trainer, attr, recording)
    t0 = time.perf_counter()
    try:
        miou, oa = trainer.train_round(
            round_num, lambda epoch: pipe.batches(cfg.train_steps,
                                                  cfg.batch_size),
            Evaluator(cfg, val, max_epochs=1), device_pool=pool)
    finally:
        setattr(trainer, attr, step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine = f"{trainer.knn_engine}, {attr}"
    loss = torch.stack(losses).cpu()
    if len(losses) != cfg.max_epoch * cfg.train_steps or \
            not torch.isfinite(loss).all():
        raise AssertionError(f"round {round_num}: losses {loss.tolist()}")
    if not os.path.exists(trainer.snapshot_path(round_num)):
        raise AssertionError(f"round {round_num}: no snap-{round_num}")
    print(f"round {round_num} training ({engine}): {len(losses)} steps of "
          f"[{cfg.batch_size}x{cfg.num_points}], {wall:.3f} s wall with "
          f"evaluation, loss {loss[0]:.4f} -> {loss[-1]:.4f}, best mIoU "
          f"{miou:.4f} OA {oa:.4f}, snap-{round_num} written")
    return pipe, wall


def al_loop(cfg, dev, work, profile_out=None):
    """Seed round → round-1 training to snap-1 → selection from snap-1 →
    round-2 training to snap-2, each path's kernel launches counted from 0.
    Returns {path: launch counts} and the timings to report."""
    from ssdr_al_torch.active import region_graph as rg
    from ssdr_al_torch.active import samplers as sm
    from ssdr_al_torch.active.samplers import TSampler, TSamplerArgs
    from ssdr_al_torch.active.state import ALState, RoundStats, sampler_args_str
    from ssdr_al_torch.kernels import measure
    from ssdr_al_torch.train.trainer import Trainer

    train, val, total = make_workload(cfg, work)
    saver = lambda sargs: os.path.join(  # noqa: E731
        work, "saver", sampler_args_str(sargs), "snapshots")
    seed_state = ALState(work, ["seed"])
    report, paths = {}, {}

    # --- round 1: train from the seed labels, evaluate, keep snap-1 -------
    trainer = Trainer(cfg, "S3DIS", save_dir=saver(["seed"]), device=dev)
    trainer.init_state()
    pseudo1 = {c.name: seed_state.load_pseudo_gt(seed_state.round_dir(1),
                                                 c.name) for c in train}
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    pipe, wall = train_round(trainer, 1, train, val, pseudo1, seed=1)
    paths["train_round_1"] = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    print("launches train_round_1 " + json.dumps(paths["train_round_1"]))
    require_launched("train_round_1", paths["train_round_1"],
                     ("window_topk", "gather_window", "scatter_window"))
    batch = pipe.sample_batch(cfg.batch_size)
    step_ms = cuda_ms(lambda: trainer.train_step(
        trainer.train_state, batch, trainer.dropout_gen), 5)
    print(f"train step [{cfg.batch_size}x{cfg.num_points}] {step_ms:.3f} ms "
          f"by CUDA events (host upload included), peak device memory "
          f"{peak / 2**30:.2f} GiB in round 1")
    report.update(train_step_ms=step_ms, train_peak_bytes=peak,
                  train_round_1_wall_s=wall)
    snap1 = trainer.snapshot_path(1)

    check_forward_reference(cfg, trainer.state, dev)
    report["gradient_check"] = check_gradient_reference(cfg, dev)
    report["gradient_check_pinned"] = check_pinned_gradients(cfg, dev)

    # --- round 2: restore snap-1, select, label, retrain to snap-2 ---------
    state = ALState(work, SSDR_ARGS)
    trainer = Trainer(cfg, "S3DIS", save_dir=saver(SSDR_ARGS),
                      seed_save_dir=saver(["seed"]), device=dev)
    trainer.restore_model(1)
    sampler = TSampler(state, train, cfg, TSamplerArgs(), total["sp_num"],
                       device=dev)
    stats = RoundStats()
    # record the round's chamfer call and its GCN-FPS call, for the picks
    # check after it
    k3_calls, fps_calls = [], []
    cd_fn, fps_fn = rg.chamfer_pairwise_blocks, sm.gcn_fps_sampling

    def rec_cd(points, mask):
        k3_calls.append((points.contiguous(), mask.contiguous()))
        return cd_fn(points, mask)

    def rec_fps(graph, *args, **kwargs):
        fps_calls.append((fps_fn, graph, args, kwargs,
                          kwargs["rng"].get_state()))
        return fps_fn(graph, *args, **kwargs)

    rg.chamfer_pairwise_blocks, sm.gcn_fps_sampling = rec_cd, rec_fps
    reset_counts()
    t0 = time.perf_counter()
    try:
        sampler.sampling(trainer.eval_step, trainer.state, BUDGET, 1, stats)
        torch.cuda.synchronize()
    finally:
        rg.chamfer_pairwise_blocks, sm.gcn_fps_sampling = cd_fn, fps_fn
    wall = time.perf_counter() - t0
    paths["selection"] = read_counts()
    r2 = state.round_dir(2)
    after = state.load_registry(r2)["unlabeled"]
    n0 = sum(len(v) for v in total["unlabeled"].values())
    n2 = sum(len(v) for v in after.values())
    gts = [f for f in os.listdir(r2) if f.endswith(".gt")]
    print(f"selection round from {os.path.relpath(snap1, work)}: {wall:.3f} "
          f"s wall, unlabeled {n0} -> {n2} (seed + round), {len(gts)} .gt "
          f"files, NAIL labelled points {stats.p_num + stats.sub_p_num}, "
          f"stats: {stats}")
    print("phase_times " + json.dumps(sampler.phase_times))
    print("launches selection " + json.dumps(paths["selection"]))
    require_launched("selection", paths["selection"],
                     ("window_topk", "gather_window", "chamfer_sums"))
    if not n2 < n0 or len(gts) != ROOMS:
        raise AssertionError("round did not label or did not write .gt files")
    report.update(selection_wall_s=wall,
                  nail_labelled_points=stats.p_num + stats.sub_p_num)
    if len(k3_calls) != 1 or len(fps_calls) != 1:
        raise AssertionError(f"selection made {len(k3_calls)} chamfer and "
                             f"{len(fps_calls)} GCN-FPS calls, not 1 each")
    r3 = measure.check_k3(*k3_calls[0], "selection round")
    print(f"K3 at the selection round's call {r3['shape']}: max rel err "
          f"{r3['max_rel_err']:.2e}, run to run {r3['run_to_run']}, "
          f"{r3['ms']:.3f} ms (plain {r3['plain_ms']:.3f} ms, bound "
          f"{r3['bound_ms']:.4f} ms by {r3['bound_by']})")
    report["k3_selection_call"] = r3
    check_selection_picks(k3_calls[0], fps_calls[0])

    pseudo = {c.name: state.load_pseudo_gt(r2, c.name) for c in train}
    # round 2 on the device pool, as al_loop trains by default
    from ssdr_al_torch.train.device_pool import DeviceTrainPool

    pool = DeviceTrainPool(train, cfg, seed=0, device=dev)
    if not pool.available:
        raise AssertionError("the S3DIS device pool is over its memory gate")
    reset_counts()
    _, wall = train_round(trainer, 2, train, val, pseudo, seed=2, pool=pool)
    paths["train_round_2"] = read_counts()
    del pool
    print("launches train_round_2 " + json.dumps(paths["train_round_2"]))
    require_launched("train_round_2", paths["train_round_2"],
                     ("window_topk", "gather_window", "scatter_window"))
    report["train_round_2_wall_s"] = wall

    paths.update(exact_engine_paths(cfg, dev, work, train, val, pseudo1))
    paths.update(semantickitti_steps(dev, work, train))
    paths.update(bf16_paths(cfg, dev, work, train, val, pseudo))
    paths.update(selection_branches(cfg, dev, work, train, total))
    paths.update(driver_paths(cfg, dev, work))

    if profile_out:
        prof = profile_rounds(cfg, dev, sampler, trainer.eval_step,
                              trainer.state)
        prof.update(profile_train_step(trainer, pipe), report=report)
        os.makedirs(os.path.dirname(profile_out) or ".", exist_ok=True)
        with open(profile_out, "w") as f:
            json.dump(prof, f, indent=1)
        print(f"profile written to {profile_out}")
    return paths


def exact_engine_paths(cfg, dev, work, train, val, pseudo):
    """The other KNN engines at full width, each path's launches counted
    from 0: a --knn_engine pallas training round from the seed labels
    (EXACT_EPOCHS x EXACT_STEPS at B=6, with an evaluation) to its snap-1;
    cli.evaluate of that snapshot on the validation room, written as an
    S3DIS Area_5 room; then one eval step [8x40960] each on window_og
    (K1), approx (exact knn_xla) and window with MXU_DISTANCE_DEFAULT (K5),
    printing each engine's class agreement with pallas (K6)."""
    from ssdr_al_torch.active.state import sampler_args_str
    from ssdr_al_torch.cli import evaluate
    from ssdr_al_torch.data.dataset import PossibilityEvalPipeline
    from ssdr_al_torch.data.ply import write_ply
    from ssdr_al_torch.models.randlanet import RandLANet
    from ssdr_al_torch.ops import knn as kn
    from ssdr_al_torch.train.trainer import Trainer, make_eval_step

    paths = {}
    cfg_p = dataclasses.replace(cfg, max_epoch=EXACT_EPOCHS,
                                train_steps=EXACT_STEPS)
    saver = os.path.join(work, "saver", sampler_args_str(["pallas"]),
                         "snapshots")
    trainer = Trainer(cfg_p, "S3DIS", save_dir=saver, knn_engine="pallas",
                      device=dev)
    trainer.init_state()
    reset_counts()
    pipe, _ = train_round(trainer, 1, train, val, pseudo, seed=3)
    paths["pallas_train_round"] = read_counts()
    print("launches pallas_train_round "
          + json.dumps(paths["pallas_train_round"]))
    require_launched("pallas_train_round", paths["pallas_train_round"],
                     ("knn_tiled",))
    batch = pipe.sample_batch(cfg.batch_size)
    step_ms = cuda_ms(lambda: trainer.train_step(
        trainer.train_state, batch, trainer.dropout_gen), 5)
    print(f"train step --knn_engine pallas [{cfg.batch_size}x"
          f"{cfg.num_points}] {step_ms:.3f} ms by CUDA events (host upload "
          "included)")

    data_root = os.path.join(work, "data")
    room_dir = os.path.join(data_root, "S3DIS", "input_0.040")
    os.makedirs(room_dir, exist_ok=True)
    for c in val:
        write_ply(os.path.join(room_dir, f"Area_5_{c.name}.ply"),
                  [c.xyz, c.colors, c.labels.astype(np.int32)],
                  ["x", "y", "z", "red", "green", "blue", "class"])
    args = evaluate.parser().parse_args([
        "--device", str(dev), "--data_root", data_root, "--knn_engine",
        "pallas", "--num_points", str(cfg.num_points), "--snapshot",
        trainer.snapshot_path(1), "--out", os.path.join(work, "preds")])
    reset_counts()
    t0 = time.perf_counter()
    result = evaluate.run_evaluate(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paths["pallas_evaluate"] = read_counts()
    plys = sorted(os.listdir(args.out))
    print(f"cli.evaluate --knn_engine pallas: {wall:.3f} s wall, wrote "
          f"{plys}, OA {result['oa']:.4f} mIoU {result['miou']:.4f}")
    print("launches pallas_evaluate " + json.dumps(paths["pallas_evaluate"]))
    require_launched("pallas_evaluate", paths["pallas_evaluate"],
                     ("knn_tiled",))
    if plys != [f"Area_5_{c.name}.ply" for c in val] or \
            not 0 <= result["miou"] <= 1:
        raise AssertionError(f"cli.evaluate wrote {plys}: {result}")

    # a few training steps leave the model predicting one class almost
    # everywhere; weights spread at O(1) scale make the engines' class
    # agreement mean something
    from ssdr_al_torch.train.grad_check import spread_weights

    batch = PossibilityEvalPipeline(val, cfg, seed=0).get_batch(8)
    state = spread_weights(trainer.state, seed=0)
    model = RandLANet(cfg).to(dev)
    classes = {}
    for name, engine, mxu, needs in (
            ("pallas_eval_step", "pallas", False, "knn_tiled"),
            ("window_og_eval_step", "window_og", False, "window_topk"),
            ("approx_eval_step", "approx", False, None),
            ("window_eval_step", "window", False, "window_topk"),
            ("mxu_eval_step", "window", True, "window_topk_mxu")):
        step = make_eval_step(model, cfg, engine, False, device=dev)
        kn.MXU_DISTANCE_DEFAULT = mxu
        reset_counts()
        try:
            p, f = step(state, batch)
            torch.cuda.synchronize()
            paths[name] = read_counts()
            ms = cuda_ms(lambda: step(state, batch), 3)
        finally:
            kn.MXU_DISTANCE_DEFAULT = False
        if not (torch.isfinite(p).all() and torch.isfinite(f).all()) or \
                p.shape != (8, cfg.num_points, cfg.num_classes):
            raise AssertionError(f"{name}: outputs {tuple(p.shape)} bad")
        if needs:
            require_launched(name, paths[name], (needs,))
        classes[name] = p.argmax(-1)
        agree = {k: (classes[name] == c).float().mean().item()
                 for k, c in classes.items() if k != name}
        print(f"{name} [8x{cfg.num_points}]: {ms:.3f} ms by CUDA events "
              f"(host upload included), {len(classes[name].unique())} "
              f"classes predicted, class agreement {json.dumps(agree)}; "
              f"launches " + json.dumps(paths[name]))
    return paths


def bf16_paths(cfg, dev, work, train, val, pseudo):
    """--compute_dtype bfloat16 from round 1's f32 snap-1, each path's
    launches counted from 0: a bf16 training round (BF16_EPOCHS x
    BF16_STEPS at B=6, with an evaluation) on the device pool from the
    round-2 pseudo labels; bf16 and f32 `window` eval steps [8 x 40960] on
    a validation batch in turns (step_times.in_turns, 20 steps each); the
    two dtypes' class agreement on that batch, from snap-1 and from
    weights spread at O(1) scale (a few steps leave the model predicting
    almost one class)."""
    from ssdr_al_torch.active.state import sampler_args_str
    from ssdr_al_torch.data.dataset import PossibilityEvalPipeline
    from ssdr_al_torch.models.randlanet import RandLANet
    from ssdr_al_torch.train import step_times
    from ssdr_al_torch.train.device_pool import DeviceTrainPool
    from ssdr_al_torch.train.grad_check import spread_weights
    from ssdr_al_torch.train.trainer import Trainer, make_eval_step

    paths = {}
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16",
                                max_epoch=BF16_EPOCHS,
                                train_steps=BF16_STEPS)
    saver = lambda sargs: os.path.join(  # noqa: E731
        work, "saver", sampler_args_str(sargs), "snapshots")
    trainer = Trainer(cfg16, "S3DIS", save_dir=saver(["bf16"]),
                      seed_save_dir=saver(["seed"]), device=dev)
    trainer.restore_model(1)
    snap1 = {k: v.clone() for k, v in trainer.state.items()}
    pool = DeviceTrainPool(train, cfg16, seed=5, device=dev)
    reset_counts()
    train_round(trainer, 2, train, val, pseudo, seed=2, pool=pool)
    paths["bf16_train_round"] = read_counts()
    del pool
    print("launches bf16_train_round "
          + json.dumps(paths["bf16_train_round"]))
    require_launched("bf16_train_round", paths["bf16_train_round"],
                     ("window_topk", "gather_window_bf16",
                      "scatter_window_bf16"))
    if paths["bf16_train_round"]["gather_window"] or \
            paths["bf16_train_round"]["scatter_window"]:
        raise AssertionError("the bf16 round launched f32 K2 or K4")

    batch = PossibilityEvalPipeline(val, cfg, seed=1).get_batch(8)
    steps = {dt: make_eval_step(RandLANet(c).to(dev), c, "window", False,
                                device=dev)
             for dt, c in (("float32", cfg), ("bfloat16", cfg16))}
    reset_counts()
    probs = {dt: step(snap1, batch)[0] for dt, step in steps.items()}
    torch.cuda.synchronize()
    paths["bf16_eval_step"] = read_counts()   # f32 and bf16, one each
    require_launched("bf16_eval_step", paths["bf16_eval_step"],
                     ("window_topk", "gather_window", "gather_window_bf16"))
    spread = spread_weights(snap1, seed=0)
    agree = {}
    for name, state in (("snap-1", snap1), ("spread weights", spread)):
        p = {dt: step(state, batch)[0] for dt, step in steps.items()}
        for q in p.values():
            if not torch.isfinite(q).all() or q.shape != (
                    8, cfg.num_points, cfg.num_classes):
                raise AssertionError(f"bf16 eval step: probs {q.shape}")
        agree[name] = (p["float32"].argmax(-1) == p["bfloat16"].argmax(-1)
                       ).float().mean().item()
    del probs
    times = step_times.in_turns(
        {dt: (lambda i, step=step: step(snap1, batch))
         for dt, step in steps.items()}, steps=20, warmup=3)
    print(f"bf16 vs f32 class agreement on the validation room [8x"
          f"{cfg.num_points}]: " + json.dumps(agree))
    print(f"eval step [8x{cfg.num_points}] in turns (host clock to a "
          f"synchronize, upload included): " + json.dumps(times))
    if agree["spread weights"] < 0.9:
        raise AssertionError(f"bf16 and f32 classes disagree: {agree}")
    return paths


def selection_branches(cfg, dev, work, train, total):
    """One selection round from snap-1 with each comparison branch
    (BRANCH_ARGS), each path's launches counted from 0: --sampler random
    (the dominant oracle, no forward), --edcd 1 and --gcn 1 (the 20 000-
    step fit). Each labels exactly BUDGET superpoints, all unlabeled
    before the round; K3 launches on edcd and gcn."""
    from ssdr_al_torch.active.samplers import (
        RandomSampler,
        TSampler,
        TSamplerArgs,
    )
    from ssdr_al_torch.active.state import ALState, RoundStats, sampler_args_str
    from ssdr_al_torch.train.trainer import Trainer

    paths = {}
    seed_saver = os.path.join(work, "saver", "seed", "snapshots")
    for branch, sargs in BRANCH_ARGS.items():
        state = ALState(work, sargs)
        before = state.load_registry(os.path.join(work, "sampling", "seed",
                                                  "round_1"))["unlabeled"]
        stats = RoundStats()
        reset_counts()
        t0 = time.perf_counter()
        if branch == "random":
            sampler = RandomSampler(state, train, total["sp_num"], 1,
                                    oracle_mode="dominant", seed=0)
            sampler.sampling(BUDGET, 1, stats)
            phase_times = {}
        else:
            trainer = Trainer(cfg, "S3DIS", save_dir=os.path.join(
                work, "saver", sampler_args_str(sargs), "snapshots"),
                seed_save_dir=seed_saver, device=dev)
            trainer.restore_model(1)
            sampler = TSampler(state, train, cfg,
                               TSamplerArgs(diversity=branch),
                               total["sp_num"], device=dev)
            sampler.sampling(trainer.eval_step, trainer.state, BUDGET, 1,
                             stats)
            phase_times = sampler.phase_times
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        name = f"{branch}_selection"
        paths[name] = read_counts()
        after = state.load_registry(state.round_dir(2))["unlabeled"]
        picked = {(n, int(s)) for n, v in before.items()
                  for s in set(v) - set(after.get(n, []))}
        print(f"{branch} selection round from snap-1: {wall:.3f} s wall, "
              f"{len(picked)} superpoints labelled, stats: {stats}")
        print(f"phase_times {branch} " + json.dumps(phase_times))
        print(f"launches {name} " + json.dumps(paths[name]))
        if branch == "random":
            ok = len(picked) == BUDGET
        else:
            require_launched(name, paths[name],
                             ("window_topk", "gather_window",
                              "chamfer_sums"))
            ok = (stats.extra["gcn_sp_num"] == BUDGET
                  and stats.extra["gcn_unlabel_num"] == BUDGET
                  and 0 < len(picked) <= BUDGET)
        if not ok:
            raise AssertionError(f"{branch} round: {len(picked)} labelled, "
                                 f"stats {stats}")
    return paths


def driver_paths(cfg, dev, work):
    """cli.baseline and cli.max_dominant, each one round at S3DIS width
    (B=6 x 40960, DRIVER_EPOCHS x DRIVER_STEPS with an evaluation) on
    DRIVER_ROOMS synthetic rooms of ROOM_POINTS points with grid
    superpoints, their launches counted from 0."""
    from ssdr_al_torch.cli import baseline, max_dominant
    from ssdr_al_torch.cli.common import (
        add_common_args,
        setup_experiment,
        write_grid_superpoints,
    )

    paths = {}
    ap = argparse.ArgumentParser()
    add_common_args(ap)
    args = ap.parse_args([
        "--device", str(dev), "--synthetic", "--data_root",
        os.path.join(work, "drivers"), "--synthetic_rooms",
        str(DRIVER_ROOMS), "--synthetic_points", str(ROOM_POINTS),
        "--num_points", str(cfg.num_points), "--batch_size",
        str(cfg.batch_size), "--max_epoch", str(DRIVER_EPOCHS),
        "--train_steps", str(DRIVER_STEPS), "--val_steps",
        str(cfg.val_steps)])
    exp = setup_experiment(args)
    total = write_grid_superpoints(exp.make_state([]), exp.train_clouds,
                                   TARGET_SP)
    cwd = os.getcwd()
    os.chdir(work)                      # record_round/ lands in the cwd
    try:
        for name, run in (("cli_baseline", baseline.run_baseline),
                          ("cli_max_dominant", max_dominant.run_max_dominant)):
            reset_counts()
            t0 = time.perf_counter()
            miou, oa = run(args)
            torch.cuda.synchronize()
            paths[name] = read_counts()
            print(f"{name}: {time.perf_counter() - t0:.3f} s wall, "
                  f"{total['sp_num']} superpoints labelled, mIoU {miou:.4f} "
                  f"OA {oa:.4f}; launches " + json.dumps(paths[name]))
            require_launched(name, paths[name], ("window_topk",
                                                 "gather_window",
                                                 "scatter_window"))
            if not (0 <= miou <= 1 and 0 <= oa <= 1):
                raise AssertionError(f"{name}: mIoU {miou} OA {oa}")
    finally:
        os.chdir(cwd)
    return paths


def semantic3d_loop(dev, work):
    """The Semantic3D path at ConfigSemantic3D width ([4 x 65536], 8
    classes, label 0 ignored, the Semantic3D class weights) on synthetic
    clouds: seed labels (1/20 of the grid superpoints), round-1 training on
    the PossibilityDevicePool with evaluation to snap-1, a full-SSDR
    selection round from snap-1, round-2 training on the pool to snap-2;
    each path's launches counted from 0."""
    from ssdr_al_torch.active.samplers import (
        SeedSampler,
        TSampler,
        TSamplerArgs,
    )
    from ssdr_al_torch.active.state import ALState, RoundStats, sampler_args_str
    from ssdr_al_torch.cli.common import write_grid_superpoints
    from ssdr_al_torch.config import ConfigSemantic3D
    from ssdr_al_torch.data.synthetic import make_dataset
    from ssdr_al_torch.train.possibility_pool import PossibilityDevicePool
    from ssdr_al_torch.train.trainer import Trainer

    cfg = dataclasses.replace(ConfigSemantic3D, max_epoch=S3D_EPOCHS,
                              train_steps=S3D_STEPS, val_steps=VAL_STEPS)
    t0 = time.perf_counter()
    train, val = make_dataset(num_train=S3D_CLOUDS, num_val=1,
                              num_points=S3D_CLOUD_POINTS, seed=1, hard=True)
    total = write_grid_superpoints(ALState(work, []), train, S3D_TARGET_SP)
    sp_num = total["sp_num"]
    seed_state = ALState(work, ["seed"])
    SeedSampler(seed_state, train, sp_num).sampling(sp_num // 20, 0,
                                                    RoundStats())
    print(f"Semantic3D workload: {S3D_CLOUDS} train clouds + 1 val cloud x "
          f"{S3D_CLOUD_POINTS} points, {sp_num} superpoints, setup "
          f"{time.perf_counter() - t0:.1f} s")
    saver = lambda sargs: os.path.join(  # noqa: E731
        work, "saver", sampler_args_str(sargs), "snapshots")
    paths = {}
    pseudo1 = {c.name: seed_state.load_pseudo_gt(seed_state.round_dir(1),
                                                 c.name) for c in train}
    pool = PossibilityDevicePool(train, cfg, seed=1, device=dev)
    if not pool.available:
        raise AssertionError("the Semantic3D pool is over its memory gate")
    trainer = Trainer(cfg, "Semantic3D", save_dir=saver(["seed"]),
                      device=dev)
    trainer.init_state()
    reset_counts()
    train_round(trainer, 1, train, val, pseudo1, seed=1, pool=pool)
    paths["semantic3d_train_round_1"] = read_counts()
    print("launches semantic3d_train_round_1 "
          + json.dumps(paths["semantic3d_train_round_1"]))
    require_launched("semantic3d_train_round_1",
                     paths["semantic3d_train_round_1"],
                     ("window_topk", "gather_window", "scatter_window"))

    state = ALState(work, SSDR_ARGS)
    trainer = Trainer(cfg, "Semantic3D", save_dir=saver(SSDR_ARGS),
                      seed_save_dir=saver(["seed"]), device=dev)
    trainer.restore_model(1)
    sampler = TSampler(state, train, cfg, TSamplerArgs(), sp_num, device=dev)
    stats = RoundStats()
    reset_counts()
    t0 = time.perf_counter()
    sampler.sampling(trainer.eval_step, trainer.state, S3D_BUDGET, 1, stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paths["semantic3d_selection"] = read_counts()
    r2 = state.round_dir(2)
    n0 = sum(len(v) for v in total["unlabeled"].values())
    n2 = sum(len(v) for v in state.load_registry(r2)["unlabeled"].values())
    print(f"Semantic3D selection round: {wall:.3f} s wall, unlabeled {n0} "
          f"-> {n2}, stats: {stats}; launches "
          + json.dumps(paths["semantic3d_selection"]))
    require_launched("semantic3d_selection", paths["semantic3d_selection"],
                     ("window_topk", "gather_window", "chamfer_sums"))
    if not n2 < n0:
        raise AssertionError("the Semantic3D round labelled nothing")
    pseudo = {c.name: state.load_pseudo_gt(r2, c.name) for c in train}
    reset_counts()
    train_round(trainer, 2, train, val, pseudo, seed=2, pool=pool)
    paths["semantic3d_train_round_2"] = read_counts()
    print("launches semantic3d_train_round_2 "
          + json.dumps(paths["semantic3d_train_round_2"]))
    require_launched("semantic3d_train_round_2",
                     paths["semantic3d_train_round_2"],
                     ("window_topk", "gather_window", "scatter_window"))
    return paths


def semantickitti_steps(dev, work, rooms):
    """One train step and one eval step at ConfigSemanticKITTI width ([6 x
    45056], 4 layers, 19 classes) on blocks of the smoke's rooms; each
    step's launches counted from 0."""
    from ssdr_al_torch.config import ConfigSemanticKITTI as cfg
    from ssdr_al_torch.data.dataset import TrainingPipeline
    from ssdr_al_torch.train.trainer import Trainer

    trainer = Trainer(cfg, "SemanticKITTI",
                      save_dir=os.path.join(work, "kitti"), device=dev)
    trainer.init_state()
    batch = TrainingPipeline(rooms, cfg, seed=4).sample_batch(cfg.batch_size)
    paths = {}
    reset_counts()
    _, metrics = trainer.train_step(trainer.train_state, batch,
                                    trainer.dropout_gen)
    loss = metrics["loss"].item()
    paths["semantickitti_train_step"] = read_counts()
    reset_counts()
    probs, penult, order = trainer.eval_step(trainer.state, batch)
    torch.cuda.synchronize()
    paths["semantickitti_eval_step"] = read_counts()
    shape = (cfg.batch_size, cfg.num_points, cfg.num_classes)
    print(f"SemanticKITTI [{cfg.batch_size}x{cfg.num_points}], 4 layers: "
          f"train step loss {loss:.4f}, eval step probs "
          f"{tuple(probs.shape)}; launches "
          + json.dumps({k: paths[k] for k in paths}))
    if not np.isfinite(loss) or tuple(probs.shape) != shape or \
            not torch.isfinite(probs).all():
        raise AssertionError(f"SemanticKITTI steps: loss {loss}, probs "
                             f"{tuple(probs.shape)}")
    for name in paths:
        require_launched(name, paths[name], ("window_topk", "gather_window")
                         + (("scatter_window",) if "train" in name else ()))
    return paths


def warm_steps(dev, work):
    """The median of 20 warm steps per training path
    (step_times.measure)."""
    from ssdr_al_torch.train import step_times

    res = step_times.measure(dev, work=os.path.join(work, "step_times"))
    print("warm steps " + json.dumps(res))
    return res



def device_time(prof):
    """(busy µs, {kernel: ms}, {port kernel: ms}) of the CUDA events a
    torch.profiler run recorded: the union of their intervals, the 8
    largest by total, and the totals of the port's own kernels."""
    spans, per_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        per_name[e.name] = per_name.get(e.name, 0.0) + (b - a) / 1e3
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    ours = {k: v for k, v in per_name.items()
            if any(f"{name}_kernel" in k for name in KERNELS)}
    return busy, dict(top), ours


def profile_rounds(cfg, dev, sampler, eval_step, params):
    """Warm selection rounds 3-6 after the checked round 2: round 3
    unprofiled, 4 and 5 under torch.profiler, 6 under cProfile; then one
    eval step."""
    import cProfile
    import io
    import pstats

    from torch.profiler import ProfilerActivity, profile

    from ssdr_al_torch.active.state import RoundStats
    from ssdr_al_torch.models.randlanet import build_pyramid

    def one_round(last):
        t0 = time.perf_counter()
        sampler.sampling(eval_step, params, BUDGET, last, RoundStats())
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    report = {}
    wall = one_round(2)
    report["round3"] = dict(wall_s=wall, phase_times=dict(sampler.phase_times))
    print(f"profile round 3 (no profiler): {wall:.3f} s wall, phase_times "
          + json.dumps(sampler.phase_times))
    for last in (3, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = one_round(last)
        busy_us, top, ours = device_time(prof)
        report[f"round{last + 1}"] = dict(
            wall_s=wall, device_busy_ms=busy_us / 1e3,
            device_busy_share=busy_us / 1e6 / wall,
            phase_times=dict(sampler.phase_times), top_device_ms=top,
            port_kernels_ms=ours)
        print(f"profile round {last + 1} (torch.profiler): {wall:.3f} s wall, "
              f"device busy {busy_us / 1e3:.3f} ms "
              f"({100 * busy_us / 1e6 / wall:.1f} %), prediction_s "
              f"{sampler.phase_times['prediction_s']:.3f}")
        print("  top device ms " + json.dumps(
            [[k[:70], round(v, 3)] for k, v in top.items()]))
    cp = cProfile.Profile()
    cp.enable()
    wall = one_round(5)
    cp.disable()
    buf = io.StringIO()
    pstats.Stats(cp, stream=buf).sort_stats("tottime").print_stats(15)
    report["round6"] = dict(wall_s=wall, phase_times=dict(sampler.phase_times),
                            cprofile_tottime=buf.getvalue())
    print(f"profile round 6 (cProfile): {wall:.3f} s wall; top host "
          "functions by own time:")
    for line in buf.getvalue().splitlines():
        if line.strip() and line.lstrip()[0].isdigit():
            print("  " + line.strip())

    rng = np.random.RandomState(2)
    xyz = (rng.rand(8, cfg.num_points, 3) * 6).astype(np.float32)
    batch = {"xyz": xyz, "features": np.concatenate(
        [xyz, rng.rand(8, cfg.num_points, 3).astype(np.float32)], -1)}
    xyz_dev = torch.from_numpy(xyz).to(dev)
    step_ms = cuda_ms(lambda: eval_step(params, batch), 10)
    with torch.inference_mode():
        pyr_ms = cuda_ms(lambda: build_pyramid(xyz_dev, cfg), 10)
    report.update(eval_step_ms=step_ms, pyramid_ms=pyr_ms)
    print(f"eval step [8x{cfg.num_points}] {step_ms:.3f} ms by CUDA events "
          f"(host upload included), build_pyramid {pyr_ms:.3f} ms")
    return report


def profile_train_step(trainer, pipe):
    """Three warm train steps on one batch: their wall clock unprofiled,
    then under torch.profiler the device busy share and top kernels."""
    from torch.profiler import ProfilerActivity, profile

    batch = pipe.sample_batch(trainer.cfg.batch_size)

    def steps():
        t0 = time.perf_counter()
        for _ in range(3):
            trainer.train_step(trainer.train_state, batch,
                               trainer.dropout_gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 3

    steps()
    wall = steps()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = steps()
    busy_us, top, ours = device_time(prof)
    busy_ms = busy_us / 1e3 / 3
    print(f"profile train step [{trainer.cfg.batch_size}x"
          f"{trainer.cfg.num_points}]: {1e3 * wall:.3f} ms wall unprofiled, "
          f"{1e3 * wall_prof:.3f} ms profiled, device busy {busy_ms:.3f} ms "
          f"per step ({100 * busy_ms / (1e3 * wall_prof):.1f} % of the "
          f"profiled wall)")
    print("  top device ms (3 steps) " + json.dumps(
        [[k[:70], round(v, 3)] for k, v in top.items()]))
    print("  port kernels ms (3 steps) " + json.dumps(
        [[k[:40], round(v, 3)] for k, v in ours.items()]))
    return {"train_step": dict(wall_ms=1e3 * wall,
                               wall_ms_profiled=1e3 * wall_prof,
                               device_busy_ms=busy_ms,
                               device_busy_share=busy_ms / (1e3 * wall_prof),
                               top_device_ms_3_steps=top,
                               port_kernels_ms_3_steps=ours)}


def main() -> int:
    root = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", nargs="?", metavar="PATH",
                    const=os.path.join(root, "build", "profile_round.json"),
                    help="also profile warm rounds; write JSON to PATH")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)

    from ssdr_al_torch.config import ConfigS3DIS
    from ssdr_al_torch.kernels import build

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build.library()
    print(f"kernel build (nvcc + load): {time.perf_counter() - t0:.2f} s")
    cfg = dataclasses.replace(ConfigS3DIS, max_epoch=TRAIN_EPOCHS,
                              train_steps=TRAIN_STEPS, val_steps=VAL_STEPS)
    checks = check_kernels(cfg, dev)

    work = os.path.join(root, "build", "smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    try:
        paths = al_loop(cfg, dev, work, args.profile)
        paths.update(semantic3d_loop(dev, os.path.join(work, "semantic3d")))
        warm_steps(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    rows = []
    for name, (source, replaces) in KERNELS.items():
        c = checks[name]
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces,
                         launches=sum(p[name] for p in paths.values()),
                         launches_by_path={k: p[name]
                                           for k, p in paths.items()},
                         max_abs_err=c["max_abs_err"], ms=c["ms"],
                         plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
                         bound_by=c["bound_by"], library_ms=c["library_ms"],
                         **{k: c[k] for k in ("shapes", "ties",
                                              "shapes_semantic3d",
                                              "shapes_semantickitti")
                            if k in c}))
    jax_side = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "ssdr_al_tpu"))
    if jax_side:
        raise AssertionError(f"the port imported {jax_side[:5]}")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
