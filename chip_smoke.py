"""Smoke run of ssdr_al_torch on one NVIDIA GPU: build the CUDA kernels,
hold each against its plain PyTorch version at the main path's shapes
(K1, its centred-product form K5 and K2 at every call of one forward,
K1 and K5 also at every call of the flagship's [2 × 40960] forward,
both K2 sources, K6 at every call of one exact pyramid, tie-heavy inputs,
K4 at every call of one train step, bitwise, with its transposes, each
at S3DIS, Semantic3D [4 × 65536] and SemanticKITTI [6 × 45056] width,
K4-bf16 at the flagship's [2 × 40960] too, and K3 at a fixed
dispatch and the selection round's shape: ssdr_al_torch/kernels/
measure.py), then ops.knn.knn_window at [6 x 40960] (K1 a probe; k = 16
at W = 2048 with probes 1 and 2 on both curves, the k = 1 upsample at
W = 1024), each call equal to K1's plain version in the kernel's place
and printed with its time and its recall against K6, then drive the
closed active-learning loop at RandLA-Net
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
eval step each on the window_og (K1), approx (K6, timed beside pallas)
and window-with-K5 (MXU_DISTANCE_DEFAULT) engines. Then the Semantic3D
loop at
ConfigSemantic3D width ([4 × 65536]): seed labels,
round-1 training on the PossibilityDevicePool with evaluation, a
full-SSDR selection round (K3) and round-2 training on the pool; one
SemanticKITTI train step and eval step at its width ([6 × 45056], 4
layers); and the median of 10 warm steps of the host-pipeline and pooled
S3DIS steps, the possibility-pooled Semantic3D step and the bf16 pooled
step, each eager and as CUDA-graph replays in turns, with the
device-busy share, launches and capture cost
(ssdr_al_torch/train/step_times.py).
Every training round of the loops runs its steps as one captured
program (Trainer.train_round: 3 eager steps, then replays of one CUDA
graph, train/graphs.py), its K1, K2 and K4 launches counted per
replay. Every evaluation, selection forward and cli.evaluate runs the
eval step as replays of CUDA graphs (train/trainer.py::EvalStep), and
each path prints and checks its eval-graph captures and replays. Then
--compute_dtype bfloat16: K2's bf16-output and K4's bf16-cotangent
instantiations at every K2 call of a bf16 forward [8 × 40960] and every K4 call of a bf16 train step
[6 × 40960], bitwise against their plain versions; from round 1's f32
snap-1, a bf16 training round on the device pool, bf16 and f32 eval steps
[8 × 40960] timed in turns and their class agreement on the validation
room. Then the paper's comparison branches from the same snap-1: one
selection round each with --sampler random, --edcd 1 (K3 per candidate
cloud) and --gcn 1 (K3, the 20 000-step coreGCN fit as CUDA-graph
replays, its wall time and replays printed, and k-center), and
one round each of cli.baseline and cli.max_dominant at the smoke's
depth. Then data parallelism on the one card (data_parallel_path, ranks
spawned from ssdr_al_torch/parallel/ after the kernels are built): two
gloo ranks' [6 x 40960] train step against the one-rank step (loss,
gradient, BatchNorm statistics) and its time, a dp selection round and
a dp evaluation from snap-1 against the single-card round, the step in a
one-rank NCCL group, dryrun_multichip(2) and the flagship forward of
dryrun.entry on the card, with K1, K2, K4 and K3 counted inside the
ranks; the dp and one-rank gradients are each held to a float64 CPU step
with its leaky-ReLU slopes and max-pool picks replayed
(train/grad_check.py::reference_step). After the warm steps: the repeat
phase (two identical train steps from one state and one batch on the
host, device-pool and possibility-pool paths, bitwise equal:
train/repeat_check.py), the replay phase (10 CUDA-graph replays
against 10 eager steps from one state on each path, bitwise equal, the
last replay's device trace holding K1's, K2's and K4's kernels as often
as the replay's launch counts say: repeat_check.replay_paths), the eval
replay phase (10 calls of the eval step's CUDA graph against 10 eager
eval steps and one InferenceRunner group through the graph and eagerly,
bitwise, on `window` and `pallas` at the S3DIS [20 x 40960] and
Semantic3D [16 x 65536] eval shapes, the last replay traced:
repeat_check.eval_replay_paths), the selection at the reference's scale
(selection_scale_phase: the twin of scripts/profile_selection.py, 200
rooms of 4096 points, ~46 000 superpoints, 10 000 clicks; for the
gcn_fps branch, and for gcn and edcd at 30 rooms, a warm round, then
the next round with
the selection forward and the greedy loops (farthest-feature,
farthest-superpoint, k-center) replayed as CUDA graphs and again eagerly
from the same registry, the two rounds' files identical, with each
round's phases and loops, and K3 at the gcn_fps round's call beside its
plain version), the Semantic3D round at the JAX package's Semantic3D
scale (semantic3d_scale_phase: the twin with --dataset Semantic3D, 4
clouds of 1 000 000 points in 65 536-point bf16 chunks, ~8 400
superpoints, 1500 clicks; a warm round, then a graph round and an eager
round from the same registry with identical files, the [8 x 65536]
forward and the farthest-feature loop replayed, K3 held to its plain
version on a block of the round's call and timed on the whole call,
K2-bf16 on the round's first gather), the JAX package's flagship AL
run cut in depth (flagship_phase: the twin scripts/flagship.py through
cli.superpoint, cli.seed and cli.al_loop, 2 hard rooms of 60 000 points,
cut-pursuit at reg_strength 0.03, rounds 1-4 of 8 bf16 steps on
40 960-point blocks and 2 val steps, 150 clicks a round; the reserved
bytes at round 4's end within 5 % of round 3's, the live CUDA graphs
bounded, every mIoU finite, K3 held to its plain version at round 4's
call), one warm
train step under
utils/logging.py::device_trace (its Chrome trace under build/ must name
K2's and K4's kernels), and the sampler ablation twin
(ssdr_al_torch/scripts/ablation.py) at ABLATION.md's headline setting cut
to two rounds of random and ssdr_full. First of the loops, the offline
path at S3DIS room size
(partition_path): raw S3DIS rooms (2 of Area_1 to train, 1 of Area_5 to validate, each of
ROOM_POINTS points from the hard room generator, as Annotations/ text
files), cli.prepare at its 0.04 grid, cli.superpoint at the defaults
users run (k_nn_geof 45, k_nn_adj 10, reg_strength 0.008,
lambda_edge_weight 1.0, knn_backend auto: the 46-NN graph through K6's
K = 64 instantiation, geof on the card, cut-pursuit on the host) with
each room's stage times, the card's graph against the host cKDTree's and
its geof against the CPU's, K6 at the partition's call beside its plain
version, cdist + topk and its bound, then cli.seed and one full-SSDR
cli.al_loop round on that cut-pursuit registry.

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
    "knn_tiled_k64": ("ssdr_al_torch/csrc/knn_tiled.cu",
                      "ssdr_al_tpu/ops/knn.py:760"),
    # K4's transpose of an index set (its count and place kernels), built
    # once for the scatters that share it
    "scatter_window_transpose": ("ssdr_al_torch/csrc/scatter_window.cu",
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
# the partition path: raw rooms to train and to validate, the seed round's
# and the AL round's depth, the AL round's budget of superpoints
PART_TRAIN_ROOMS, PART_VAL_ROOMS = 2, 1
PART_EPOCHS, PART_STEPS, PART_BUDGET = 1, 4, 400
# the selection at the reference's scale (scripts/profile_selection.py's
# defaults: 200 rooms of 4096 points, ~46 000 grid superpoints, 10 000
# clicks a round); the gcn and edcd rounds at SCALE_BRANCH_CLOUDS rooms,
# as the gcn rounds at 200 rooms (~45 s with set-up and the warm round)
# would take the smoke past ~560 s (30 since the flagship phase)
SCALE_CLOUDS, SCALE_POINTS, SCALE_BUDGET = 200, 4096, 10_000
SCALE_BRANCH_CLOUDS = 30
# the Semantic3D selection at the JAX package's Semantic3D scale (bench.py::
# measure_semantic3d_selection; the twin with --dataset Semantic3D):
# clouds of 1 000 000 points cut into the bf16 ConfigSemantic3D's
# 65 536-point chunks, grid superpoints at 2048 a cloud, a seed round at
# seed_div 40; 4 clouds and 1500 clicks a round here, half of JAX's 8 and
# 3000 (at 8 clouds the smoke took 611 s on an H100 80GB HBM3 at 700 W;
# the twin runs all 8)
S3D_SCALE_CLOUDS, S3D_SCALE_POINTS, S3D_SCALE_BUDGET = 4, 1_000_000, 1500
S3D_SCALE_TARGET_SP, S3D_SCALE_SEED_DIV = 2048, 40
# the JAX package's flagship run (scripts/flagship.py; results/
# record_round_flagship/: 6 rooms of 150 000 points, rounds 1-10 of 500
# steps) cut in depth: 2 rooms of 60 000 points, rounds 1-4 of 8 steps
# and 2 val steps at full width (bf16, 40 960-point blocks), 150 clicks
FLAG_ROOMS, FLAG_POINTS, FLAG_ROUNDS = 2, 60_000, 4
FLAG_STEPS, FLAG_VAL_STEPS, FLAG_CLICKS = 8, 2, 150
# the end-of-round reserved bytes may grow by this share from round 3 on
FLAG_RESERVED_GROWTH = 0.05
# warm steps a mode of each training path (step_times.py measures 20),
# graph replays against eager steps a path in the replay phase and eval
# calls a path in the eval replay phase (repeat_check.py runs 20 each): 6,
# 10 and 10 here keep the smoke near its time with the flagship phase
WARM_STEPS = 6
REPLAY_STEPS = 10
EVAL_REPLAY_CALLS = 10
# the data-parallel step against the one-rank step on the card: the loss
# and the BatchNorm statistics within DP_REL. The gradients of both are
# held to a float64 CPU step from the same state (train/grad_check.py::
# reference_step), each f32 run replaying the f64 run's leaky-ReLU slopes
# and max-pool picks, so that a kink within f32 rounding does not decide
# the reading: each within GRAD_ERR_MULTIPLE times the CPU f32 step's own
# error plus GRAD_ERR_FLOOR (`python -m ssdr_al_torch.parallel.agreement`
# reads the same statistic at 2048, 8192 and 40960 points)
DP_REL = 1e-4


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


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


def reset_counts():
    from ssdr_al_torch.kernels import counts

    counts.reset()


def read_counts():
    from ssdr_al_torch.kernels import counts

    return counts.read()


def require_launched(path, counts, names):
    # a path that runs K4's sum pass builds the transposes it reads
    if {"scatter_window", "scatter_window_bf16"} & set(names):
        names = tuple(names) + ("scatter_window_transpose",)
    missing = [n for n in names if counts[n] < 1]
    if missing:
        raise AssertionError(f"{path}: kernels of the path never launched: "
                             f"{missing} ({counts})")


# the eval-step graphs' captures and replays (train/graphs.py::
# ForwardGraphs calls) since the smoke began: count_eval_graphs
EVAL_GRAPHS = {"captures": 0, "replays": 0}


def count_eval_graphs():
    """Count every capture and replay of an eval-step graph
    (ForwardGraphs.__call__) in EVAL_GRAPHS, so that each path can show
    that its evaluations and selection forwards ran as graph replays."""
    from ssdr_al_torch.train import graphs

    call = graphs.ForwardGraphs.__call__

    def counted(self, key, make, batch):
        captures = self.captures
        out = call(self, key, make, batch)
        EVAL_GRAPHS["captures"] += self.captures - captures
        EVAL_GRAPHS["replays"] += 1
        return out

    graphs.ForwardGraphs.__call__ = counted


def require_replayed(path, before, at_least=1) -> dict:
    """The eval-graph captures and replays since `before` (a copy of
    EVAL_GRAPHS), printed; fails below `at_least` replays."""
    got = {k: EVAL_GRAPHS[k] - before[k] for k in EVAL_GRAPHS}
    print(f"eval graphs {path}: {got['captures']} captures, "
          f"{got['replays']} replays")
    if got["replays"] < at_least:
        raise AssertionError(f"{path}: {got['replays']} eval-graph replays, "
                             f"fewer than {at_least}")
    return got


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
              f"their plain versions; K4 as the step runs it "
              f"{measure.k4_step(k4r)[0]:.4f} ms")
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
    # K1 and K5 at every K1 call of the flagship's [2 x 40960] forward
    flag = []
    for call in measure.record_main_path(cfg, dev, b=2)[0]:
        r = measure.check_k1(call)
        r5 = measure.check_k1(call, mxu=True)
        flag.append(dict(r, k5_ms=r5["ms"]))
        print(f"K1 window_topk flagship {r['shape']}: equal, {r['ms']:.4f} "
              f"ms (plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} "
              f"ms); K5 equal, {r5['ms']:.4f} ms")
    print(measure.k1_forward_line("[2 x 40960]", flag))
    out["window_topk"]["shapes_flagship"] = flag

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

    # K4: the 11 calls of one train step [6 x 40960] (9 of the encoder's
    # gathers, 2 at k = 1 of the decoder's windowed upsamples), each
    # bitwise equal to the CPU plain version and to itself, through its
    # own transpose and a shared one (measure.check_k4); the row sums them
    # as the step runs them (every sum pass, each shared transpose once:
    # measure.k4_step), the other fields over the same calls; beside the
    # k = 1 calls, K4-bf16 against scatter_rows, the bf16 model's upsample
    # backward
    k4, k4s, k4k = (x["scatter_window"] for x in (main, s3d, kitti))
    out["scatter_window"] = k4_row(
        k4, max_abs_err=max(r["max_abs_err"] for r in k4 + k4s + k4k),
        shapes_semantic3d=k4s, shapes_semantickitti=k4k,
        k1_bf16_rows=main["scatter_rows_k1"])
    for r in main["scatter_rows_k1"]:
        print(measure.k1_rows_line(r))
    out["scatter_window_transpose"] = transpose_row(k4, k4s, k4k)
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
    k4f = bf["scatter_window_bf16_flagship"]
    out["gather_window_bf16"] = dict(k2b[0], shapes=k2b,
                                     library_call="torch.gather of the "
                                     "values cast to bf16")
    out["scatter_window_bf16"] = k4_row(
        k4b, max_abs_err=max(r["max_abs_err"] for r in k4b + k4f),
        flagship_step=k4_row(k4f, max_abs_err=max(r["max_abs_err"]
                                                  for r in k4f)),
        library_call="index_add_ of the cotangent widened to f32")
    fl = out["scatter_window_bf16"]["flagship_step"]
    print(f"bf16: {len(k2b)} K2 calls and {len(k4b)} + {len(k4f)} K4 calls "
          f"bitwise equal to their plain versions; K2 sum "
          f"{sum(r['ms'] for r in k2b):.4f} ms (bound "
          f"{sum(r['bound_ms'] for r in k2b):.4f}), K4 step [6 x "
          f"{cfg.num_points}] {out['scatter_window_bf16']['ms']:.4f} ms "
          f"(bound {out['scatter_window_bf16']['bound_ms']:.4f}), the "
          f"flagship's [2 x {cfg.num_points}] {fl['ms']:.4f} ms (bound "
          f"{fl['bound_ms']:.4f})")
    return out


def transpose_row(*steps):
    """The JSON row of K4's transposes from measure.check_k4's rows of
    several steps: each distinct index set under shapes (all must equal
    the plain transpose), the row itself the largest set of the first
    step's (the L0 LFA gathers')."""
    sets = [[dict(shape=r["shape"], equal=r["transpose_equal"],
                  ms=r["transpose_ms"], plain_ms=r["transpose_plain_ms"],
                  bound_ms=r["transpose_bound_ms"],
                  sort_ms=r["transpose_sort_ms"], plan=r["transpose_plan"])
             for r in {x["shared"]: x for x in rows}.values()]
            for rows in steps]
    tr = [t for step in sets for t in step]
    if not all(t["equal"] for t in tr):
        raise AssertionError(f"K4 transposes differ from the plain one: {tr}")
    top = max(sets[0], key=lambda t: t["ms"])
    return dict(ms=top["ms"], plain_ms=top["plain_ms"],
                bound_ms=top["bound_ms"], bound_by="bytes", library_ms=None,
                max_abs_err=0, shape=top["shape"], shapes=tr,
                library_call="none: a stable torch.sort of the row keys "
                "(sort_ms) is only its sort")


def k4_row(rows, **extra):
    """A K4 row of the smoke's JSON line from measure.check_k4's rows of
    one step: ms as the step runs them (measure.k4_step), the unshared
    sum, and the plain version's, index_add_'s and the bounds summed."""
    from ssdr_al_torch.kernels import measure

    ms, unshared, bd = measure.k4_step(rows)
    return dict(ms=ms, ms_transpose_each=unshared, bound_ms=bd,
                bound_by="bytes",
                plain_ms=sum(r["plain_ms"] for r in rows),
                library_ms=sum(r["library_ms"] for r in rows),
                calls=len(rows), shapes=rows, **extra)


def check_upsample_windows(dev):
    """Every windowed 1-NN upsample of a sorted pyramid at S3DIS,
    Semantic3D and SemanticKITTI width (random clouds, a batch each):
    window_violations 0 in its gather window (SortedPyramid.up_windows),
    so K2/K4 at k = 1 clamp no index."""
    from ssdr_al_torch.config import (
        ConfigS3DIS,
        ConfigSemantic3D,
        ConfigSemanticKITTI,
    )
    from ssdr_al_torch.models.randlanet import build_pyramid
    from ssdr_al_torch.ops.gather import window_violations

    rng = np.random.RandomState(12)
    out = {}
    for c in (ConfigS3DIS, ConfigSemantic3D, ConfigSemanticKITTI):
        xyz = torch.from_numpy((rng.rand(c.batch_size, c.num_points, 3) * 6)
                               .astype(np.float32)).to(dev)
        pyr = build_pyramid(xyz, c)
        out[c.name] = [(tuple(i.shape), w, window_violations(i, w))
                       for i, w in zip(pyr.interp_idx, pyr.up_windows) if w]
    print("windowed upsamples (interp_idx shape, gather window, "
          "violations): " + json.dumps(out))
    if any(not v or any(x[2] for x in v) for v in out.values()):
        raise AssertionError(f"upsample windows: {out}")
    return out


def knn_window_phase(dev):
    """ops.knn.knn_window, the window search on clouds in their own order,
    at S3DIS L0 width [6 x 40960] on six synthetic rooms (measure.
    knn_window_calls): k = 16, W = 2048, probes 1 and 2 on the morton
    and Hilbert curves, and the k = 1 upsample from the L1 subsample at
    W = 1024, launches counted from 0 (K1 once a probe). Then each call's
    result index for index against K1's plain version in the kernel's
    place, its time by CUDA events, the plain run's, the bound and its
    recall against K6's exact answer."""
    from ssdr_al_torch.kernels import measure
    from ssdr_al_torch.ops import knn as kn

    calls = measure.knn_window_calls(dev)
    reset_counts()
    got = [kn.knn_window(s, q, **kw) for _, s, q, kw in calls]
    torch.cuda.synchronize()
    paths = {"knn_window": read_counts()}
    print("launches knn_window " + json.dumps(paths["knn_window"]))
    require_launched("knn_window", paths["knn_window"], ("window_topk",))
    want = sum(kw["probes"] for *_, kw in calls)
    if paths["knn_window"]["window_topk"] != want:
        raise AssertionError(f"knn_window: {paths['knn_window']} K1 "
                             f"launches, not {want}")
    rows = []
    for (name, s, q, kw), g in zip(calls, got):
        if g.shape != q.shape[:2] + (kw["k"],) or g.min() < 0 or \
                g.max() >= s.shape[1]:
            raise AssertionError(f"knn_window {name}: {tuple(g.shape)}")
        r = measure.check_knn_window(name, s, q, kw, g)
        rows.append(r)
        print(f"knn_window {r['shape']}: equal to the plain version, "
              f"{r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}; exact K6 "
              f"{r['exact_ms']:.3f} ms), recall {r['recall']:.4f}")
    if min(r["recall"] for r in rows) < 0.9:
        raise AssertionError(f"knn_window recall {rows}")
    return paths


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


def graph_ties(xyz, idx_card, idx_host, rel=1e-6):
    """The card's neighbour lists against the host's: row by row, their
    f64 distances agree column by column within `rel` (two exact top-k
    lists differ only in the order of near-equal distances). Returns the
    count of differing entries."""
    x = xyz.astype(np.float64)
    dc = np.linalg.norm(x[idx_card] - x[:, None], axis=-1)
    dh = np.linalg.norm(x[idx_host] - x[:, None], axis=-1)
    bad = np.abs(dc - dh) > rel * dh + 1e-9
    if bad.any():
        raise AssertionError(f"{int(bad.sum())} neighbours of the card's "
                             "graph are not distance ties of the host's")
    return int((idx_card != idx_host).sum())


def geof_agreement(xyz, nb, card, cpu):
    """geof on the card against the CPU on the same neighbourhoods, within
    the CPU tests' tolerance (ops/geof.py::agreement_tolerance, per point
    from its neighbourhood's f64 eigenvalues: ATOL, or ATOL_SQRT for a
    feature built on the root of an eigenvalue under SMALL·λ1, or
    ATOL_NEAR_TIE for verticality where two eigenvalues nearly meet).
    Returns (max difference by feature, share of entries within ATOL,
    share of entries held to ATOL)."""
    from ssdr_al_torch.ops import geof

    d = np.abs(card - cpu)
    tol = geof.agreement_tolerance(geof.neighbourhood_eigenvalues(xyz, nb))
    if not (d <= tol).all() or not np.isfinite(card).all():
        worst = np.unravel_index(np.argmax(d - tol), d.shape)
        raise AssertionError(f"geof on the card off the CPU's: max "
                             f"{d.max(0).tolist()}, worst {worst} "
                             f"{d[worst]:.3e} over {tol[worst]:.1e}")
    return d.max(0).tolist(), float((d <= geof.ATOL).mean()), \
        float((tol == geof.ATOL).mean())


def write_s3dis_raw(raw, area, rooms):
    """Raw S3DIS rooms: <raw>/<area>/room_<i>/Annotations/<class>_1.txt
    with x y z r g b rows, one file a class (the hard generator's labels
    name S3DIS classes in S3DIS_CLASS_NAMES' order)."""
    from ssdr_al_torch.data.prepare import S3DIS_CLASS_NAMES

    for i, c in enumerate(rooms):
        anno = os.path.join(raw, area, f"room_{i}", "Annotations")
        os.makedirs(anno)
        rgb = np.round(c.colors * 255.0)
        for lab in np.unique(c.labels):
            m = c.labels == lab
            np.savetxt(os.path.join(anno, f"{S3DIS_CLASS_NAMES[lab]}_1.txt"),
                       np.hstack([c.xyz[m], rgb[m]]),
                       fmt=["%.4f"] * 3 + ["%d"] * 3)


def partition_path(dev, work):
    """The offline path and a round on its registry, each step's launches
    counted from 0: raw S3DIS rooms → cli.prepare → cli.superpoint (K6 at
    k = 46 on the new K = 64 instantiation, geof on the card, cut-pursuit
    on the host) with per-room stage times; the card's 46-NN graph
    against the host cKDTree's up to distance ties, its geof against the
    CPU's; K6 at the partition's call (measure.check_k6); then cli.seed
    and one full-SSDR cli.al_loop round, which labels exactly
    PART_BUDGET superpoints. Returns ({path: launch counts}, K6's check at
    the partition's call)."""
    from scipy.spatial import cKDTree

    from ssdr_al_torch.active import samplers as sm
    from ssdr_al_torch.active.state import ALState
    from ssdr_al_torch.cli import al_loop as cli_al_loop
    from ssdr_al_torch.cli import prepare, seed, superpoint
    from ssdr_al_torch.cli.common import setup_experiment
    from ssdr_al_torch.data.synthetic import make_dataset
    from ssdr_al_torch.kernels import measure
    from ssdr_al_torch.ops import knn as kn
    from ssdr_al_torch.ops.geof import geometric_features

    paths = {}
    t0 = time.perf_counter()
    train, val = make_dataset(num_train=PART_TRAIN_ROOMS,
                              num_val=PART_VAL_ROOMS, num_points=ROOM_POINTS,
                              seed=6, hard=True)
    raw = os.path.join(work, "raw")
    write_s3dis_raw(raw, "Area_1", train)
    write_s3dis_raw(raw, "Area_5", val)
    t1 = time.perf_counter()
    data_root = os.path.join(work, "data")
    prepare.main(["--device", str(dev), "--dataset", "S3DIS", "--raw", raw,
                  "--out", os.path.join(data_root, "S3DIS")])
    t2 = time.perf_counter()
    print(f"partition path: {PART_TRAIN_ROOMS} + {PART_VAL_ROOMS} raw S3DIS "
          f"rooms of {ROOM_POINTS} points written in {t1 - t0:.1f} s, "
          f"cli.prepare (0.04 grid) {t2 - t1:.1f} s")

    common = ["--device", str(dev), "--dataset", "S3DIS", "--data_root",
              data_root, "--reg_strength", "0.008"]
    args = superpoint.parser().parse_args(common + [
        "--k_nn_geof", "45", "--k_nn_adj", "10", "--lambda_edge_weight",
        "1.0", "--knn_backend", "auto"])
    reset_counts()
    t0 = time.perf_counter()
    total, times = superpoint.run_superpoint(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paths["partition"] = read_counts()
    print(f"cli.superpoint: {wall:.1f} s wall, {total['sp_num']} "
          f"superpoints in {total['file_num']} rooms; launches "
          + json.dumps(paths["partition"]))
    for t in times:
        print(f"  room {t['name']}: {t['points']} prepared points, K6 "
              f"46-NN {t['knn_ms']:.3f} ms ({t['knn_backend']}), geof "
              f"{t['geof_ms']:.3f} ms (CUDA events), cut-pursuit "
              f"{t['cutpursuit_s']:.3f} s, {t['superpoints']} superpoints")
    require_launched("partition", paths["partition"], ("knn_tiled_k64",))
    if paths["partition"]["knn_tiled_k64"] != len(times) or \
            any(t["knn_backend"] != "device" for t in times):
        raise AssertionError("cli.superpoint did not search every room "
                             "through K6's K = 64 instantiation")

    clouds = setup_experiment(args).train_clouds
    for c in clouds:
        x = torch.from_numpy(c.xyz).to(dev)
        idx = kn.knn_tiled(x[None], x[None], 46)[0]
        host = cKDTree(c.xyz).query(c.xyz, k=46)[1]
        differ = graph_ties(c.xyz, idx.cpu().numpy(), host)
        nb = idx[:, 1:]
        card = geometric_features(x, nb).cpu().numpy()
        cpu = geometric_features(x.cpu(), nb.cpu()).numpy()
        dmax, share, tight = geof_agreement(c.xyz, nb.cpu().numpy(), card,
                                            cpu)
        print(f"  room {c.name}: the card's 46-NN graph equals the host "
              f"cKDTree's up to distance ties ({differ} of "
              f"{idx.numel()} entries differ); geof card vs CPU max diff "
              f"{[f'{v:.2e}' for v in dmax]}, {100 * share:.3f} % of "
              f"entries within 2e-5 ({100 * tight:.1f} % held to it)")
    call = measure.partition_call(dev, clouds[0].xyz)
    k64 = measure.check_k6(call)
    k64.update(measure.k6_split(call))
    print(f"K6 knn_tiled_k64 at the partition's call {k64['shape']} "
          f"(route {k64['route']}): equal to the plain version, "
          f"{k64['ms']:.3f} ms (the walk {k64['walk_ms']:.4f} ms, K6's "
          f"codes and layout {k64['kernel_ms'] - k64['walk_ms']:.4f}, the "
          f"sort and the rest {k64['other_ms']:.4f}; plain "
          f"{k64['plain_ms']:.3f} ms, cdist+topk {k64['library_ms']:.3f} "
          f"ms, bound {k64['bound_ms']:.4f} ms by {k64['bound_by']}; pairs "
          f"{100 * k64['pair_share']:.3f} %, a {k64['walk_per']} "
          + json.dumps({n: round(v, 2) for n, v in k64["walk"].items()})
          + ")")

    depth = ["--max_epoch", str(PART_EPOCHS), "--train_steps",
             str(PART_STEPS), "--val_steps", str(VAL_STEPS)]
    cwd = os.getcwd()
    os.chdir(work)                      # record_round/ lands in the cwd
    extras, record = [], sm.TSampler._record_selection_stats

    def recording(self, file_list, total_obj, stats):
        record(self, file_list, total_obj, stats)
        extras.append(dict(stats.extra))

    try:
        reset_counts()
        t0 = time.perf_counter()
        seed.main(common + depth + ["--seed_percent", "0.01"])
        torch.cuda.synchronize()
        paths["partition_seed"] = read_counts()
        print(f"cli.seed on the cut-pursuit registry: "
              f"{time.perf_counter() - t0:.1f} s wall; launches "
              + json.dumps(paths["partition_seed"]))
        sm.TSampler._record_selection_stats = recording
        reset_counts()
        t0 = time.perf_counter()
        cli_al_loop.main(common + depth + [
            "--sampler", "T", "--round", "2", "--rounds", "2", "--classbal",
            "2", "--gcn_fps", "1", "--uncertainty_mode", "WetSU",
            "--point_uncertainty_mode", "sb", "--oracle_mode", "NAIL",
            "--threshold", "0.9", "--min_size", "1", "--t", "0",
            "--sp_batch_size", str(PART_BUDGET)])
        torch.cuda.synchronize()
        paths["partition_al_round"] = read_counts()
    finally:
        sm.TSampler._record_selection_stats = record
        os.chdir(cwd)
    wall = time.perf_counter() - t0
    state = ALState(os.path.join(data_root, "S3DIS", "0.008"), SSDR_ARGS)
    n1 = sum(len(v) for v in state.load_registry(os.path.join(
        state.data_path, "sampling", "seed", "round_1"))["unlabeled"].values())
    n2 = sum(len(v) for v in state.load_registry(
        state.round_dir(2))["unlabeled"].values())
    print(f"cli.al_loop round 2 (full SSDR, budget {PART_BUDGET}): {wall:.1f} "
          f"s wall, selection {extras}, unlabeled {n1} -> {n2}; launches "
          + json.dumps(paths["partition_al_round"]))
    for name in ("partition_seed", "partition_al_round"):
        require_launched(name, paths[name], ("window_topk", "gather_window",
                                             "scatter_window"))
    require_launched("partition_al_round", paths["partition_al_round"],
                     ("chamfer_sums",))
    if len(extras) != 1 or extras[0]["gcn_sp_num"] != PART_BUDGET or \
            extras[0]["gcn_unlabel_num"] != PART_BUDGET or not \
            0 < n1 - n2 <= PART_BUDGET:
        raise AssertionError(f"the AL round on the cut-pursuit registry "
                             f"did not label its budget: {extras}, "
                             f"unlabeled {n1} -> {n2}")
    return paths, k64


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
    round's wall clock after checking every step's loss (device scalars,
    trainer.round_losses) and that the steps after the warm-up were
    replays of one captured step (trainer.graph_stats) and that its
    evaluations replayed the eval step's graph."""
    from ssdr_al_torch.data.dataset import TrainingPipeline
    from ssdr_al_torch.train.evaluator import Evaluator
    from ssdr_al_torch.train.graphs import GRAPH_WARMUP
    from ssdr_al_torch.train.possibility_pool import PossibilityDevicePool

    cfg = trainer.cfg
    pipe = TrainingPipeline(clouds, cfg, pseudo_gt=pseudo, seed=seed)
    kind = ("host pipeline" if pool is None else "possibility pool"
            if isinstance(pool, PossibilityDevicePool) else "device pool")
    if pool is not None:
        pool.update_pseudo_gt(pseudo)
        pool.reseed(seed)
        if isinstance(pool, PossibilityDevicePool):
            pool.reset_possibility(seed)
    t0 = time.perf_counter()
    g0 = dict(EVAL_GRAPHS)
    miou, oa = trainer.train_round(
        round_num, lambda epoch: pipe.batches(cfg.train_steps,
                                              cfg.batch_size),
        Evaluator(cfg, val, max_epochs=1), device_pool=pool)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require_replayed(f"round {round_num} evaluation", g0)
    steps = cfg.max_epoch * cfg.train_steps
    loss = torch.stack(trainer.round_losses).cpu()
    if len(loss) != steps or not torch.isfinite(loss).all():
        raise AssertionError(f"round {round_num}: losses {loss.tolist()}")
    g = trainer.graph_stats
    if g["eager_steps"] != GRAPH_WARMUP or \
            g["replays"] != steps - GRAPH_WARMUP:
        raise AssertionError(f"round {round_num}: not replayed: {g}")
    if not os.path.exists(trainer.snapshot_path(round_num)):
        raise AssertionError(f"round {round_num}: no snap-{round_num}")
    print(f"round {round_num} training ({trainer.knn_engine}, {kind}): "
          f"{steps} steps of [{cfg.batch_size}x{cfg.num_points}], "
          f"{g['eager_steps']} eager and {g['replays']} replays of one "
          f"captured step (capture {g['capture_s']:.3f} s, graph pool "
          f"{g['capture_bytes'] / 2**30:.2f} GiB), {wall:.3f} s wall with "
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
    g0 = dict(EVAL_GRAPHS)
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
    require_replayed("selection", g0)
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
    paths.update(data_parallel_path(cfg, dev, work, train, val, total))

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
    (K1), approx (K6, the pallas engine's search: its classes equal
    pallas') and window with MXU_DISTANCE_DEFAULT (K5), printing each
    engine's class agreement with pallas (K6)."""
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
    g0 = dict(EVAL_GRAPHS)
    t0 = time.perf_counter()
    result = evaluate.run_evaluate(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paths["pallas_evaluate"] = read_counts()
    require_replayed("cli.evaluate", g0, 2)
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
    classes, step_ms = {}, {}
    for name, engine, mxu, needs in (
            ("pallas_eval_step", "pallas", False, "knn_tiled"),
            ("window_og_eval_step", "window_og", False, "window_topk"),
            ("approx_eval_step", "approx", False, "knn_tiled"),
            ("window_eval_step", "window", False, "window_topk"),
            ("mxu_eval_step", "window", True, "window_topk_mxu")):
        step = make_eval_step(model, cfg, engine, False, device=dev)
        kn.MXU_DISTANCE_DEFAULT = mxu
        reset_counts()
        g0 = dict(EVAL_GRAPHS)
        try:
            p, f = step(state, batch)
            torch.cuda.synchronize()
            paths[name] = read_counts()
            ms = step_ms[name] = cuda_ms(lambda: step(state, batch), 3)
        finally:
            kn.MXU_DISTANCE_DEFAULT = False
        require_replayed(name, g0, 5)
        if not (torch.isfinite(p).all() and torch.isfinite(f).all()) or \
                p.shape != (8, cfg.num_points, cfg.num_classes):
            raise AssertionError(f"{name}: outputs {tuple(p.shape)} bad")
        if needs:
            require_launched(name, paths[name], (needs,))
        classes[name] = p.argmax(-1)
        agree = {k: (classes[name] == c).float().mean().item()
                 for k, c in classes.items() if k != name}
        print(f"{name} [8x{cfg.num_points}]: {ms:.3f} ms by CUDA events "
              f"(graph replays, staging and output copies included), "
              f"{len(classes[name].unique())} "
              f"classes predicted, class agreement {json.dumps(agree)}; "
              f"launches " + json.dumps(paths[name]))
    print(f"approx_eval_step {step_ms['approx_eval_step']:.3f} ms beside "
          f"pallas_eval_step {step_ms['pallas_eval_step']:.3f} ms (both K6)")
    same = (classes["approx_eval_step"] == classes["pallas_eval_step"]
            ).float().mean().item()
    if same < 0.999:
        raise AssertionError(f"approx and pallas classes agree on {same}")
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
    g0 = dict(EVAL_GRAPHS)
    probs = {dt: step(snap1, batch)[0] for dt, step in steps.items()}
    torch.cuda.synchronize()
    paths["bf16_eval_step"] = read_counts()   # f32 and bf16, one each
    require_replayed("bf16_eval_step", g0, 2)
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
    print(f"eval step [8x{cfg.num_points}] as graph replays in turns (host "
          f"clock to a synchronize, staging included): " + json.dumps(times))
    if agree["spread weights"] < 0.9:
        raise AssertionError(f"bf16 and f32 classes disagree: {agree}")
    return paths


def selection_branches(cfg, dev, work, train, total):
    """One selection round from snap-1 with each comparison branch
    (BRANCH_ARGS), each path's launches counted from 0: --sampler random
    (the dominant oracle, no forward), --edcd 1 and --gcn 1 (the coreGCN
    fit's 20 000 steps as CUDA-graph replays, its wall time and replays
    printed). Each labels exactly BUDGET superpoints, all unlabeled before
    the round; K3 launches on edcd and gcn."""
    from ssdr_al_torch.active import gcn
    from ssdr_al_torch.train import graphs
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
        g0 = dict(EVAL_GRAPHS)
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
            fits = []
            fit_gcn = gcn.fit_gcn

            def timed_fit(params, adj, *args, **kw):
                with graphs.record_runs() as runs:
                    losses = fit_gcn(params, adj, *args, **kw)
                fits.append(dict(
                    steps=losses.numel(), blocks=list(adj.shape),
                    wall_s=runs[0]["wall_s"], replays=runs[0]["replays"],
                    loss_first_last=[losses[0].item(), losses[-1].item()]))
                return losses

            gcn.fit_gcn = timed_fit
            try:
                sampler.sampling(trainer.eval_step, trainer.state, BUDGET,
                                 1, stats)
            finally:
                gcn.fit_gcn = fit_gcn
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
        if branch == "gcn":
            print("coreGCN fit as CUDA graphs " + json.dumps(fits))
            if len(fits) != 1 or fits[0]["steps"] != 20000 or \
                    fits[0]["replays"] != 20000 - graphs.GRAPH_WARMUP or \
                    not np.isfinite(fits[0]["loss_first_last"]).all():
                raise AssertionError(f"gcn branch: the fit ran {fits}")
        if branch == "random":
            ok = len(picked) == BUDGET
        else:
            require_replayed(name, g0)
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


def data_parallel_path(cfg, dev, work, train, val, total):
    """Data parallelism on the one card (ssdr_al_torch/parallel/): ranks
    are processes spawned from the package with the kernels built here
    already, each path's launches counted from 0 inside every rank.
    Two gloo ranks on the card take one `window` train step at [6 x 40960]
    (3 rows a rank) from spread_weights at GRAD_SEED, dropout off, held
    to the one-rank step on the same batch (loss and BatchNorm statistics
    within DP_REL), both steps' gradients held to a float64 CPU step with
    its slopes and max-pool picks replayed (grad_check.reference_step's
    limit), and timed against the one-rank step; a dp selection
    round and a dp evaluation from snap-1 against the single-card round's
    files and this process's evaluation (differences counted); the same
    step in a one-rank NCCL group; dryrun_multichip(2) and dryrun.entry's
    flagship forward on the card.
    Two ranks on one card measure the collectives' overhead, not a
    speed-up."""
    from ssdr_al_torch.active.state import ALState
    from ssdr_al_torch.config import ConfigS3DIS, class_weights
    from ssdr_al_torch.data.dataset import TrainingPipeline
    from ssdr_al_torch.models.randlanet import init_params
    from ssdr_al_torch.parallel import dryrun, launch
    from ssdr_al_torch.train.grad_check import (
        gradient_rel,
        reference_step,
        spread_weights,
    )
    from ssdr_al_torch.train.trainer import restore_checkpoint

    t_phase = time.perf_counter()
    store = os.path.join(work, "dp_runs")
    batch = TrainingPipeline(train, cfg, seed=11).sample_batch(cfg.batch_size)
    case = dict(cfg=cfg, weights=class_weights("S3DIS"), batch=batch,
                state=spread_weights(init_params(
                    cfg, torch.Generator().manual_seed(0)), GRAD_SEED))
    t0 = time.perf_counter()
    ref = reference_step(cfg, case["state"], batch, case["weights"], dev)
    ref_s = time.perf_counter() - t0
    os.makedirs(store, exist_ok=True)
    pins_path = os.path.join(store, "pins.pt")
    torch.save({"slopes": ref["slopes"], "pools": ref["pools"]}, pins_path)
    pinned = dict(case, pins=pins_path)
    want = dryrun.train_step_result(None, device=dev, pins=ref, **case)
    one_ms = dryrun.train_step_times(None, device=dev, **case)
    snap1 = restore_checkpoint(os.path.join(work, "saver", "seed",
                                            "snapshots", "snap-1"), "cpu")
    sel_dir = os.path.join(work, "dp_selection")
    shutil.copytree(os.path.join(work, "superpoint"),
                    os.path.join(sel_dir, "superpoint"))
    shutil.copytree(os.path.join(work, "sampling", "seed"),
                    os.path.join(sel_dir, "sampling", "seed"))
    g0 = dict(EVAL_GRAPHS)
    eval_one = dryrun.evaluate_result(None, cfg, val, snap1, max_epochs=1,
                                      device=dev)
    require_replayed("single-card evaluation beside dp", g0)
    calls = [(dryrun.train_step_result, pinned),
             (dryrun.train_step_times, case),
             (dryrun.selection_round_result, dict(
                 work=sel_dir, cfg=cfg, clouds=train, state=snap1,
                 sampler_args=SSDR_ARGS, total_num=total["sp_num"],
                 budget=BUDGET)),
             (dryrun.evaluate_result, dict(cfg=cfg, clouds=val, state=snap1,
                                           max_epochs=1))]
    t0 = time.perf_counter()
    ranks = launch(dryrun.run_calls, 2, [dev, dev], store, calls)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    # one rank on one card: NCCL (parallel/mesh.py::backend_for)
    (nccl, nccl_counts), = launch(dryrun.run_calls, 1, [dev], store,
                                  calls[:1])[0]
    os.remove(pins_path)
    nccl_wall = time.perf_counter() - t0

    def step_errors(got):
        bn = max(float(np.abs(got["state"][k] - want["state"][k]).max()
                       / np.abs(want["state"][k]).max())
                 for k in want["state"] if "running" in k)
        return dict(loss=abs(got["loss"] - want["loss"]) / abs(want["loss"]),
                    grad=gradient_rel(got["grad"], want["grad"]),
                    grad_f64=gradient_rel(got["grad"], ref["grad"]),
                    bn_stats=bn)

    def check(name, err):
        if max(err["loss"], err["bn_stats"]) > DP_REL or \
                err["grad_f64"] > ref["limit"]:
            raise AssertionError(f"{name}: step errors {err} (limits "
                                 f"{DP_REL}, gradient to f64 "
                                 f"{ref['limit']:.3e})")

    # the one-rank step to the float64 step, under the same limit
    one_f64 = gradient_rel(want["grad"], ref["grad"])
    print(f"float64 reference step [{cfg.batch_size}x{cfg.num_points}] on "
          f"the CPU ({ref_s:.1f} s with its f32 twin): gradient rel L2 to "
          f"f64: CPU f32 {ref['cpu_f32']:.3e}, one rank on the card "
          f"{one_f64:.3e} (limit {ref['limit']:.3e}; slopes and max-pool "
          "picks of the f64 run replayed)")
    if one_f64 > ref["limit"]:
        raise AssertionError(f"one-rank step: gradient to f64 {one_f64:.3e} "
                             f"over {ref['limit']:.3e}")

    paths, report = {}, {}
    one_state = ALState(work, SSDR_ARGS)
    r2 = one_state.round_dir(2)
    one_reg = one_state.load_registry(r2)
    for r, res in enumerate(ranks):
        (step, c_step), (times, _), (sel, c_sel), (ev, c_ev) = res
        paths[f"dp_train_step_rank{r}"] = c_step
        paths[f"dp_selection_rank{r}"] = c_sel
        paths[f"dp_evaluate_rank{r}"] = c_ev
        err = step_errors(step)
        picks = {n: set(v) for n, v in sel["registry"]["unlabeled"].items()}
        want_picks = {n: set(v) for n, v in one_reg["unlabeled"].items()}
        picks_differ = sum(len(picks.get(n, set()) ^ want_picks.get(
            n, set())) for n in set(picks) | set(want_picks))
        gt_differ = sum(int((sel["pseudo"][c.name] != one_state.load_pseudo_gt(
            r2, c.name)).any(0).sum()) for c in train)
        report[f"rank{r}"] = dict(
            step_errors=err, one_rank_f64=one_f64, limit=ref["limit"],
            step_ms=times, selection_picks_differing=
            picks_differ, selection_points_differing=gt_differ,
            selection_stats=sel["stats"], evaluate=ev)
        print(f"dp rank {r}/2 on {dev}: train step [{cfg.batch_size}x"
              f"{cfg.num_points}] loss rel err {err['loss']:.2e}, gradient "
              f"rel L2 {err['grad']:.2e} (to f64 {err['grad_f64']:.3e}, "
              f"limit {ref['limit']:.3e}), BN statistics "
              f"{err['bn_stats']:.2e}; step {np.median(times):.3f} ms "
              f"(median of {len(times)}); "
              f"selection: {picks_differ} superpoints picked otherwise than "
              f"the single-card round, {gt_differ} points labelled "
              f"otherwise; evaluation mIoU {ev[0]:.4f} OA {ev[1]:.4f} "
              f"(single card {eval_one[0]:.4f} {eval_one[1]:.4f}); "
              "launches " + json.dumps({"step": c_step, "selection": c_sel,
                                        "evaluate": c_ev}))
        check(f"dp rank {r}", err)
        require_launched(f"dp_train_step_rank{r}", c_step,
                         ("window_topk", "gather_window", "scatter_window"))
        require_launched(f"dp_selection_rank{r}", c_sel,
                         ("window_topk", "gather_window", "chamfer_sums"))
        require_launched(f"dp_evaluate_rank{r}", c_ev,
                         ("window_topk", "gather_window"))
    (sel0, _), (ev0, _) = ranks[0][2], ranks[0][3]
    for r in range(1, len(ranks)):
        (sel, _), (ev, _) = ranks[r][2], ranks[r][3]
        if ev != ev0 or sel["registry"] != sel0["registry"] or any(
                not np.array_equal(sel["pseudo"][n], sel0["pseudo"][n])
                for n in sel0["pseudo"]):
            raise AssertionError(f"dp rank {r} disagrees with rank 0 on "
                                 "the selection or the evaluation")
    err = step_errors(nccl)
    paths["dp_nccl_train_step"] = nccl_counts
    print(f"dp NCCL world size 1 on {dev}: loss rel err {err['loss']:.2e}, "
          f"gradient rel L2 {err['grad']:.2e} (to f64 "
          f"{err['grad_f64']:.3e}), BN statistics "
          f"{err['bn_stats']:.2e}, {nccl_wall:.1f} s with the process start"
          "; launches " + json.dumps(nccl_counts))
    check("dp NCCL", err)
    require_launched("dp_nccl_train_step", nccl_counts,
                     ("window_topk", "gather_window", "scatter_window"))
    dp_ms = np.median(report["rank0"]["step_ms"])
    print(f"dp train step [{cfg.batch_size}x{cfg.num_points}] on one "
          f"{card_line()}: 2 gloo ranks {dp_ms:.3f} ms "
          f"against one rank {np.median(one_ms):.3f} ms (medians of "
          f"{len(one_ms)} warm steps; both ranks share the card, so this is "
          "the collectives' overhead, not a speed-up); the 2-rank launch "
          f"{wall:.1f} s with the process start")
    t0 = time.perf_counter()
    dry = dryrun.dryrun_multichip(2, [dev, dev], store)
    print(f"dryrun_multichip(2) on {dev}: {time.perf_counter() - t0:.1f} s; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    if not all(np.isfinite(d["loss"]) for d in dry):
        raise AssertionError("dryrun_multichip: non-finite loss")
    fn, example = dryrun.entry(dev)
    logits = fn(*example)
    print(f"dryrun.entry: logits {tuple(logits.shape)}")
    if logits.shape != (1, ConfigS3DIS.num_points, ConfigS3DIS.num_classes) \
            or not torch.isfinite(logits).all():
        raise AssertionError("dryrun.entry: bad logits")
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
            g0 = dict(EVAL_GRAPHS)
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
            require_replayed(name, g0)
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
    g0 = dict(EVAL_GRAPHS)
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
    require_replayed("semantic3d_selection", g0)
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
    g0 = dict(EVAL_GRAPHS)
    probs, penult, order = trainer.eval_step(trainer.state, batch)
    torch.cuda.synchronize()
    paths["semantickitti_eval_step"] = read_counts()
    require_replayed("semantickitti_eval_step", g0)
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
    """The median of WARM_STEPS warm steps per training path, the eager
    step and its CUDA graph in turns, with each one's device-busy share
    (profiled), launches and the graph's capture cost
    (step_times.measure)."""
    from ssdr_al_torch.train import step_times

    res = step_times.measure(dev, steps=WARM_STEPS,
                             work=os.path.join(work, "step_times"))
    print("warm steps " + json.dumps(res))
    for path, r in res.items():
        print(f"warm steps {path}: " + ", ".join(
            f"{mode} median {r[mode]['median_ms']:.3f} ms ("
            f"{r[mode]['min_ms']:.3f}-{r[mode]['max_ms']:.3f}), busy "
            f"{100 * r[mode]['busy_share']:.1f} %, "
            f"{r[mode]['kernels']:.0f} kernels and "
            f"{r[mode]['host_launches']:.0f} host launches a step"
            for mode in ("eager", "graph"))
            + f"; capture {r['graph']['capture_s']:.3f} s, graph pool "
            f"{r['graph']['capture_bytes'] / 2**30:.2f} GiB, peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB; a replay's top device ms "
            + json.dumps({k[:60]: round(v, 3)
                          for k, v in r["graph"]["top_ms"].items()}))
    return res


def repeat_phase(dev, work):
    """Two identical train steps from one state and one batch on the host
    S3DIS step [6 x 40960], the device-pool step and the Semantic3D
    possibility-pool step [4 x 65536] (train/repeat_check.py): the loss,
    every gradient, the BatchNorm statistics and the updated parameters
    must be bitwise equal; the launches counted from 0."""
    from ssdr_al_torch.train.repeat_check import repeat_paths

    t0 = time.perf_counter()
    reset_counts()
    res = repeat_paths(dev, work=os.path.join(work, "repeat"))
    paths = {"repeat_steps": read_counts()}
    print(f"repeat phase {time.perf_counter() - t0:.1f} s; launches "
          f"repeat_steps " + json.dumps(paths["repeat_steps"]))
    differ = {k: r["differing"][:4] for k, r in res.items() if not r["equal"]}
    if differ or set(res) != {"host", "pool", "possibility"}:
        raise AssertionError(f"two identical train steps differ: {differ}")
    require_launched("repeat_steps", paths["repeat_steps"],
                     ("window_topk", "gather_window", "scatter_window"))
    return paths


def replay_phase(dev, work):
    """REPLAY_STEPS CUDA-graph replays against as many eager steps, after
    the warm-up steps, from one state on the host S3DIS step [6 x 40960], the
    device-pool step and the Semantic3D possibility-pool step [4 x 65536]
    (train/repeat_check.py::replay_paths): every step's loss, the
    gradients, BatchNorm statistics, parameters and Adam moments must be
    bitwise equal; the launches counted from 0, the replays' included.
    The last replay of each path runs under torch.profiler: its trace
    must hold K1's, K2's and K4's device kernels (window_topk_kernel,
    gather_window_kernel, the transposes' *_transpose_kernel, the sums'
    scatter_sum_kernel or scatter_bins_sum_kernel) as often as the counts
    that each replay adds."""
    from ssdr_al_torch.train.repeat_check import replay_paths

    t0 = time.perf_counter()
    reset_counts()
    res = replay_paths(dev, replays=REPLAY_STEPS,
                       work=os.path.join(work, "replay"))
    paths = {"replay_steps": read_counts()}
    print(f"replay phase {time.perf_counter() - t0:.1f} s; launches "
          f"replay_steps " + json.dumps(paths["replay_steps"]))
    differ = {k: r["differing"][:4] for k, r in res.items() if not r["equal"]}
    if differ or set(res) != {"host", "pool", "possibility"} or any(
            r["replays"] != REPLAY_STEPS for r in res.values()):
        raise AssertionError(f"graph replays differ from eager steps: "
                             f"{differ} {res}")
    untraced = {k: (r["traced"], r["counted"]) for k, r in res.items()
                if not r["traced_ok"]}
    if untraced:
        raise AssertionError(f"a replay's device trace does not hold the "
                             f"kernels its counts add: {untraced}")
    require_launched("replay_steps", paths["replay_steps"],
                     ("window_topk", "gather_window", "scatter_window"))
    return paths


def eval_replay_phase(dev):
    """EVAL_REPLAY_CALLS calls of the eval step's graph (a capture, then
    replays) against as many eager eval steps on validation batches, and
    one InferenceRunner
    group through the graph and eagerly, every output bitwise equal, on
    `window` and `pallas` at the S3DIS [20 x 40960] and Semantic3D [16 x
    65536] eval shapes (repeat_check.eval_replay_paths); the last replay
    of each under torch.profiler, its trace holding K1's, K2's and K6's
    kernels as often as its counts say; the launches counted from 0."""
    from ssdr_al_torch.train.repeat_check import eval_replay_paths

    t0 = time.perf_counter()
    reset_counts()
    g0 = dict(EVAL_GRAPHS)
    res = eval_replay_paths(dev, calls=EVAL_REPLAY_CALLS)
    paths = {"eval_replays": read_counts()}
    print(f"eval replay phase {time.perf_counter() - t0:.1f} s; launches "
          f"eval_replays " + json.dumps(paths["eval_replays"]))
    bad = {k: (r["differing"], r["runner_equal"]) for k, r in res.items()
           if not (r["equal"] and r["runner_equal"])}
    if bad or len(res) != 4:
        raise AssertionError(f"eval-graph replays differ from eager calls: "
                             f"{bad}")
    untraced = {k: (r["traced"], r["counted"]) for k, r in res.items()
                if not r["traced_ok"] or not r["traced"][
                    "window_topk" if k.endswith("window") else "knn_tiled"]}
    if untraced:
        raise AssertionError(f"a replay's device trace does not hold the "
                             f"kernels its counts add: {untraced}")
    require_replayed("eval_replays", g0, 4 * (EVAL_REPLAY_CALLS + 1))
    require_launched("eval_replays", paths["eval_replays"],
                     ("window_topk", "gather_window", "knn_tiled"))
    return paths


def scale_round(sampler, steps, params, dev, diversity, budget):
    """From a warm round's registry, the same round with graphs and then
    eagerly (the greedy loops and the selection forward), each from the
    same random state, its kernel launches counted from 0; the K3 call of
    the graph round recorded. Returns ({mode: the twin's round record,
    its loops' runs among them}, {mode: round files moved aside}, {path:
    launches}, the K3 call)."""
    from ssdr_al_torch.active import region_graph as rg
    from ssdr_al_torch.scripts import profile_selection as twin

    state = sampler.state
    rng = sampler.rng.get_state()
    rounds, dirs, paths, k3_calls = {}, {}, {}, []
    cd_fn = rg.chamfer_pairwise_blocks

    def rec_cd(points, mask):
        k3_calls.append((points.contiguous(), mask.contiguous()))
        return cd_fn(points, mask)

    for mode in ("graph", "eager"):
        sampler.rng.set_state(rng)
        sampler.loop_eager = mode == "eager"
        rg.chamfer_pairwise_blocks = rec_cd if mode == "graph" else cd_fn
        reset_counts()
        g0 = dict(EVAL_GRAPHS)
        try:
            rec = twin.run_round(sampler, steps[mode], params, budget, 2,
                                 dev)
        finally:
            rg.chamfer_pairwise_blocks = cd_fn
        paths[f"scale_{diversity}_{mode}"] = read_counts()
        rec["eval_graphs"] = {k: EVAL_GRAPHS[k] - g0[k] for k in EVAL_GRAPHS}
        rounds[mode] = rec
        dirs[mode] = state.round_dir(3) + "_" + mode
        shutil.move(state.round_dir(3), dirs[mode])
    sampler.loop_eager = False
    return rounds, dirs, paths, k3_calls


def same_files(a, b):
    """The names of the files that differ between directories a and b (or
    that only one holds)."""
    names = sorted(set(os.listdir(a)) | set(os.listdir(b)))
    bad = []
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if not (os.path.exists(pa) and os.path.exists(pb)):
            bad.append(n)
            continue
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            if fa.read() != fb.read():
                bad.append(n)
    return bad


def selection_scale_phase(dev, work):
    """The selection round at the reference's scale through the twin of
    scripts/profile_selection.py (ssdr_al_torch/scripts/
    profile_selection.py): SCALE_CLOUDS synthetic rooms of SCALE_POINTS
    points, ~46 000 grid superpoints, the seed round's labels and a bf16
    TSampler at SCALE_BUDGET clicks a round, gcn_fps (the flagship), then
    gcn and edcd at SCALE_BRANCH_CLOUDS rooms and as many clicks a room.
    For each: one warm round, then the next round with graphs (the
    selection forward and every
    greedy loop replayed) and eagerly from the same registry and random
    state (scale_round); the two rounds' files must be identical, every
    greedy loop of the graph round longer than the replay threshold must
    have replayed and none of the eager round's. Prints each round's
    phases, loops and launches, and K3 at the gcn_fps round's call
    against its plain version."""
    from ssdr_al_torch.kernels import measure
    from ssdr_al_torch.models.randlanet import RandLANet
    from ssdr_al_torch.ops import fps
    from ssdr_al_torch.scripts import profile_selection as twin
    from ssdr_al_torch.train.graphs import GRAPH_WARMUP
    from ssdr_al_torch.train.trainer import make_eval_step

    t_phase = time.perf_counter()
    paths, report = {}, {}
    for diversity, clouds in (("gcn_fps", SCALE_CLOUDS),
                              ("gcn", SCALE_BRANCH_CLOUDS),
                              ("edcd", SCALE_BRANCH_CLOUDS)):
        t0 = time.perf_counter()
        w = os.path.join(work, f"scale_{diversity}")
        train, state, total = twin.build_selection_workload(
            w, clouds, SCALE_POINTS, diversity=diversity)
        sampler, step, params = twin.make_selection_sampler(
            train, state, total, SCALE_POINTS, diversity=diversity,
            device=dev)
        steps = {"graph": step, "eager": make_eval_step(
            RandLANet(sampler.cfg).to(dev), sampler.cfg, device=dev,
            eager=True)}
        # 50 clicks a room, as at the reference's scale
        budget = SCALE_BUDGET * clouds // SCALE_CLOUDS
        warm = twin.run_round(sampler, step, params, budget, 1, dev)
        rounds, dirs, p, k3_calls = scale_round(sampler, steps, params, dev,
                                                diversity, budget)
        paths.update(p)
        differ = same_files(dirs["graph"], dirs["eager"])
        print(f"selection at scale, {diversity}: {clouds} clouds x "
              f"{SCALE_POINTS} points, {total['sp_num']} superpoints, "
              f"{budget} clicks; warm round {warm['wall_s']:.3f} s; "
              f"{time.perf_counter() - t0:.1f} s with set-up")
        for mode, rec in rounds.items():
            print(f"scale {diversity} {mode} round: " + json.dumps(rec))
        if differ or len(os.listdir(dirs["graph"])) != clouds + 1:
            raise AssertionError(f"scale {diversity}: the graph and eager "
                                 f"rounds wrote different files: {differ}")
        for mode, rec in rounds.items():
            loops = [r for r in rec["loops"] if r["name"] != "fit_gcn"]
            long = [r for r in loops
                    if r["steps"] >= GRAPH_WARMUP + fps.MIN_REPLAYS]
            # edcd's per-cloud loops (~50 steps) stay under the replay
            # threshold, eager in both rounds by the rule
            if not loops or any((r["replays"] > 0) != (mode == "graph")
                                for r in long) or (
                    mode == "graph" and diversity != "edcd" and not long):
                raise AssertionError(f"scale {diversity} {mode}: loops "
                                     f"{loops}")
            if rec["stats"]["gcn_sp_num"] != budget:
                raise AssertionError(f"scale {diversity} {mode}: "
                                     f"{rec['stats']}")
        if rounds["graph"]["eval_graphs"]["replays"] < 1:
            raise AssertionError(f"scale {diversity}: the selection forward "
                                 "did not replay its graph")
        require_launched(f"scale_{diversity}_graph",
                         paths[f"scale_{diversity}_graph"],
                         ("window_topk", "gather_window_bf16",
                          "chamfer_sums"))
        report[diversity] = dict(rounds, warm_wall_s=warm["wall_s"],
                                 sp_num=total["sp_num"], clouds=clouds)
        if diversity == "gcn_fps":
            if len(k3_calls) != 1:
                raise AssertionError(f"scale round: {len(k3_calls)} K3 "
                                     "calls")
            r3 = measure.check_k3(*k3_calls[0], "selection at scale")
            print(f"K3 at the at-scale round's call {r3['shape']}: max rel "
                  f"err {r3['max_rel_err']:.2e}, run to run "
                  f"{r3['run_to_run']}, {r3['ms']:.3f} ms (plain "
                  f"{r3['plain_ms']:.3f} ms, bound {r3['bound_ms']:.4f} ms "
                  f"by {r3['bound_by']})")
            report["k3"] = r3
        del sampler, steps, params
        shutil.rmtree(w, ignore_errors=True)
    print(f"selection at scale phase {time.perf_counter() - t_phase:.1f} s")
    return paths, report


def semantic3d_scale_phase(dev, work):
    """The Semantic3D selection round at the JAX package's Semantic3D
    scale through the twin (scripts/profile_selection.py --dataset
    Semantic3D): S3D_SCALE_CLOUDS synthetic clouds of S3D_SCALE_POINTS
    points in 65 536-point bf16 chunks, ~2 100 grid superpoints a
    cloud, the seed round's labels and S3D_SCALE_BUDGET clicks a round,
    gcn_fps. One warm round, then the next round with graphs and eagerly
    from the same registry and random state (scale_round): identical
    files, every click spent, K1, K2-bf16 and K3 launched, the [8 x
    65536] forward and the farthest-feature loop replayed in the graph
    round and neither in the eager one. K3 is held to its plain version
    on block 0 of the graph round's call and timed on the whole call;
    K2-bf16 on the eager round's first windowed gather. Prints the
    set-up, each round's phases, S, K3's time and bound, and peak bytes.
    Returns ({path: launches}, {"chamfer_sums": ...,
    "gather_window_bf16": ...})."""
    from ssdr_al_torch.kernels import measure
    from ssdr_al_torch.models import randlanet as rl
    from ssdr_al_torch.ops import chamfer as ch
    from ssdr_al_torch.ops import fps
    from ssdr_al_torch.scripts import profile_selection as twin
    from ssdr_al_torch.train.graphs import GRAPH_WARMUP
    from ssdr_al_torch.train.trainer import make_eval_step

    t_phase = time.perf_counter()
    w = os.path.join(work, "semantic3d_scale")
    setup = {}
    train, state, total = twin.build_selection_workload(
        w, S3D_SCALE_CLOUDS, S3D_SCALE_POINTS,
        target_sp=S3D_SCALE_TARGET_SP, seed_div=S3D_SCALE_SEED_DIV,
        timings=setup)
    sampler, step, params = twin.make_selection_sampler(
        train, state, total, dataset="Semantic3D", device=dev)
    cfg = sampler.cfg
    # InferenceRunner's chunk group at 65 536 points: min(32, max(8,
    # 327 680 // 65 536)) = 8 chunks a forward
    chunk = (8, cfg.num_points)
    steps = {"graph": step, "eager": make_eval_step(
        rl.RandLANet(cfg).to(dev), cfg, device=dev, eager=True)}
    print(f"semantic3d at scale: {S3D_SCALE_CLOUDS} clouds x "
          f"{S3D_SCALE_POINTS} points, chunks [{chunk[0]} x {chunk[1]}] "
          f"{cfg.compute_dtype}, {total['sp_num']} superpoints, "
          f"{S3D_SCALE_BUDGET} clicks; set-up " + json.dumps(setup))
    warm = twin.run_round(sampler, step, params, S3D_SCALE_BUDGET, 1, dev)
    k2_calls, gather = [], rl.gather_window

    def rec_k2(values, idx, starts, window, tq=128, out_dtype=None,
               transpose=None):
        if not k2_calls:
            k2_calls.append(dict(values=values.clone(), idx=idx.clone(),
                                 starts=starts.clone(), window=window,
                                 tq=tq, path="LFA", out_dtype=out_dtype))
        return gather(values, idx, starts, window, tq, out_dtype,
                      transpose=transpose)

    # the graph round replays its captured forward, so only the eager
    # round's forward calls the wrapper
    rl.gather_window = rec_k2
    try:
        rounds, dirs, paths, k3_calls = scale_round(
            sampler, steps, params, dev, "semantic3d", S3D_SCALE_BUDGET)
    finally:
        rl.gather_window = gather
    differ = same_files(dirs["graph"], dirs["eager"])
    print(f"semantic3d at scale: warm round {warm['wall_s']:.3f} s "
          + json.dumps(warm["phases"]))
    for mode, rec in rounds.items():
        print(f"semantic3d at scale {mode} round: " + json.dumps(rec))
    if differ or len(os.listdir(dirs["graph"])) != S3D_SCALE_CLOUDS + 1:
        raise AssertionError("semantic3d at scale: the graph and eager "
                             f"rounds wrote different files: {differ}")
    for mode, rec in rounds.items():
        ffs = [r for r in rec["loops"]
               if r["name"] == "farthest_feature_sample"]
        if not ffs or any(r["steps"] < GRAPH_WARMUP + fps.MIN_REPLAYS or
                          (r["replays"] > 0) != (mode == "graph")
                          for r in ffs):
            raise AssertionError(f"semantic3d at scale {mode}: the "
                                 f"farthest-feature loop {ffs}")
        if rec["stats"]["gcn_sp_num"] != S3D_SCALE_BUDGET:
            raise AssertionError(f"semantic3d at scale {mode}: "
                                 f"{rec['stats']}")
    graph = rounds["graph"]
    kept = [k["shapes"][0] for k in graph["forward_graphs"]["kept"]]
    if graph["eval_graphs"]["replays"] < 1 or \
            rounds["eager"]["eval_graphs"]["replays"] or \
            list(chunk) + [3] not in [list(k) for k in kept]:
        raise AssertionError("semantic3d at scale: the [8 x 65536] "
                             f"forward did not replay: {graph}")
    require_launched("scale_semantic3d_graph",
                     paths["scale_semantic3d_graph"],
                     ("window_topk", "gather_window_bf16", "chamfer_sums"))
    if len(k3_calls) != 1 or len(k2_calls) != 1 or \
            k2_calls[0]["out_dtype"] != torch.bfloat16:
        raise AssertionError(f"semantic3d at scale: {len(k3_calls)} K3 "
                             f"calls, K2 calls {k2_calls[:1]}")
    points, mask = k3_calls[0]
    r3 = measure.check_k3(points[:1], mask[:1], "Semantic3D round block 0")
    out = ch.chamfer_sums(points, mask)
    least, _ = measure.chamfer_bounds(points, mask, out)
    r3.update(call=list(points.shape[:3]),
              valid_share=mask.float().mean().item(),
              call_ms=measure.device_ms(lambda: ch.chamfer_sums(points, mask),
                                        3),
              call_bound_ms=least[0], call_bound_by=least[1],
              launches=paths["scale_semantic3d_graph"]["chamfer_sums"])
    print(f"K3 at the Semantic3D round's call {r3['call']} (S = "
          f"{r3['call'][1]}), {r3['valid_share']:.3f} valid: "
          f"{r3['call_ms']:.3f} ms, bound {r3['call_bound_ms']:.3f} ms by "
          f"{r3['call_bound_by']}; on {r3['shape']}: max rel err "
          f"{r3['max_rel_err']:.2e}, run to run {r3['run_to_run']}, "
          f"{r3['ms']:.3f} ms (plain {r3['plain_ms']:.3f} ms, bound "
          f"{r3['bound_ms']:.4f} ms by {r3['bound_by']})")
    if not (r3["max_rel_err"] <= 1e-5 and r3["run_to_run"]):
        raise AssertionError(f"K3 at the Semantic3D round: {r3}")
    r2 = measure.check_k2(k2_calls[0])
    r2["launches"] = paths["scale_semantic3d_graph"]["gather_window_bf16"]
    print(f"K2 at the Semantic3D round's first gather {r2['shape']}: "
          f"bitwise equal, {r2['ms']:.4f} ms (plain {r2['plain_ms']:.3f} "
          f"ms, torch.gather bf16 {r2['library_ms']:.4f} ms, bound "
          f"{r2['bound_ms']:.4f} ms by {r2['bound_by']})")
    for mode, rec in rounds.items():
        print(f"semantic3d at scale {mode}: {rec['wall_s']:.3f} s, peak "
              f"{rec['peak_bytes'] / 2**30:.2f} GiB allocated, "
              f"{rec['peak_reserved_bytes'] / 2**30:.2f} GiB reserved")
    del sampler, steps, params, k3_calls, k2_calls, points, mask, out
    shutil.rmtree(w, ignore_errors=True)
    print(f"semantic3d at scale phase {time.perf_counter() - t_phase:.1f} s")
    return paths, {"chamfer_sums": r3, "gather_window_bf16": r2}


def flagship_phase(dev, work):
    """The JAX package's flagship AL run through the twin (python -m
    ssdr_al_torch.scripts.flagship) cut in depth: FLAG_ROOMS hard rooms of
    FLAG_POINTS points (and a validation room), the cut-pursuit partition
    at reg_strength 0.03, the 1 % seed round and cli.al_loop's rounds
    2..FLAG_ROUNDS in one call, FLAG_STEPS bf16 steps on 40 960-point
    blocks, FLAG_VAL_STEPS val steps and FLAG_CLICKS clicks a round. Fails
    unless every round's mIoU and losses are finite, every AL round buys
    FLAG_CLICKS clicks, each round's steps replay their StepGraph, the
    live CUDA graphs stay within FORWARD_GRAPHS and one StepGraph, and
    round FLAG_ROUNDS ends with at most FLAG_RESERVED_GROWTH more
    reserved bytes than round FLAG_ROUNDS - 1; the partition and the
    rounds must launch K6-k64, K1, K2-bf16, K4-bf16 and K3 (counted by
    the twin from 0 in each). K3 is held to its plain version at the last
    round's call. Returns ({"flagship": launches}, K3's check)."""
    from ssdr_al_torch.active import region_graph as rg
    from ssdr_al_torch.kernels import measure
    from ssdr_al_torch.ops import chamfer as ch
    from ssdr_al_torch.scripts import flagship
    from ssdr_al_torch.train.graphs import FORWARD_GRAPHS

    t_phase = time.perf_counter()
    recs, k3_calls, cd_fn = [], [], rg.chamfer_pairwise_blocks

    def rec_cd(points, mask):
        k3_calls[:] = [(points.contiguous(), mask.contiguous())]
        return cd_fn(points, mask)

    g0 = dict(EVAL_GRAPHS)
    rg.chamfer_pairwise_blocks = rec_cd
    try:
        flagship.main(["--rooms", str(FLAG_ROOMS), "--points",
                       str(FLAG_POINTS), "--rounds", str(FLAG_ROUNDS),
                       "--train_steps", str(FLAG_STEPS), "--val_steps",
                       str(FLAG_VAL_STEPS), "--clicks", str(FLAG_CLICKS),
                       "--work", os.path.join(work, "flagship"), "--out",
                       os.path.join(work, "flagship_out")], log=recs.append)
    finally:
        rg.chamfer_pairwise_blocks = cd_fn
    for r in recs:
        print("flagship " + json.dumps(r))
    rounds = [r for r in recs if r.get("event") == "round"]
    part = next(r for r in recs if r.get("event") == "partition")
    launches = dict.fromkeys(read_counts(), 0)
    for r in [part] + rounds:
        for k, v in r["launches"].items():
            launches[k] += v
    print("launches flagship " + json.dumps(launches))
    require_launched("flagship", launches,
                     ("knn_tiled_k64", "window_topk", "gather_window_bf16",
                      "scatter_window_bf16", "chamfer_sums"))
    require_replayed("flagship", g0, FLAG_ROUNDS)
    bad = [r["round"] for r in rounds
           if not (np.isfinite(r["miou"]) and np.isfinite(r["oa"])
                   and r["losses_finite"] and r["replays"] >= 1
                   and r["live_graphs"] <= FORWARD_GRAPHS + 1
                   and (r["round"] == 1
                        or r["stats"]["gcn_sp_num"] == FLAG_CLICKS))]
    if [r["round"] for r in rounds] != list(range(1, FLAG_ROUNDS + 1)) or \
            bad:
        raise AssertionError(f"flagship: rounds {bad} failed: {rounds}")
    end = {r["round"]: r["end_reserved_bytes"] for r in rounds}
    if end[FLAG_ROUNDS] > (1 + FLAG_RESERVED_GROWTH) * end[FLAG_ROUNDS - 1]:
        raise AssertionError(f"flagship: reserved bytes at the rounds' ends "
                             f"grew: {end}")
    for r in rounds:
        print(f"flagship round {r['round']}: mIoU {r['miou']:.4f}, OA "
              f"{r['oa']:.4f}, wall {r['wall_s']:.2f} s (selection "
              f"{r['select_s']:.2f}, training {r['train_s']:.2f}, eval "
              f"{r['eval_s']:.2f}), warm step {r['warm_step_ms']:.3f} ms, "
              f"{r['replays']} replays, {r['live_graphs']} live graphs "
              f"({r['graph_pool_bytes'] / 2**30:.2f} GiB), reserved at the "
              f"end {r['end_reserved_bytes'] / 2**30:.3f} GiB, peak "
              f"{r['peak_reserved_bytes'] / 2**30:.3f} GiB, K3 "
              + json.dumps(r["k3"]))
    points, mask = k3_calls[0]
    r3 = measure.check_k3(points, mask, f"flagship round {FLAG_ROUNDS}")
    out = ch.chamfer_sums(points, mask)
    least, _ = measure.chamfer_bounds(points, mask, out)
    r3.update(call=list(points.shape[:3]),
              valid_share=mask.float().mean().item(),
              call_bound_ms=least[0], call_bound_by=least[1],
              launches=launches["chamfer_sums"])
    print(f"K3 at the flagship round's call {r3['call']}, "
          f"{r3['valid_share']:.3f} valid: max rel err "
          f"{r3['max_rel_err']:.2e}, run to run {r3['run_to_run']}, "
          f"{r3['ms']:.3f} ms (plain {r3['plain_ms']:.3f} ms, bound "
          f"{r3['bound_ms']:.4f} ms by {r3['bound_by']})")
    if not (r3["max_rel_err"] <= 1e-5 and r3["run_to_run"]):
        raise AssertionError(f"K3 at the flagship round: {r3}")
    del k3_calls, points, mask, out
    print(f"flagship phase {time.perf_counter() - t_phase:.1f} s")
    return {"flagship": launches}, r3


def trace_phase(dev, root):
    """One warm host train step [6 x 40960] under
    utils/logging.py::device_trace, its Chrome trace written under
    build/device_trace/ and read back: it must name K2's kernel and K4's
    (a transpose's *_transpose_kernel and its sums, the single-use path's
    fill and sum)."""
    from ssdr_al_torch.train.repeat_check import path_steps
    from ssdr_al_torch.utils.logging import device_trace

    trainer, step, _ = path_steps(dev, ("host",), work=os.path.join(
        root, "build", "smoke_work", "trace"))["host"]
    step(trainer.train_state)
    torch.cuda.synchronize()
    log_dir = os.path.join(root, "build", "device_trace")
    shutil.rmtree(log_dir, ignore_errors=True)
    reset_counts()
    with device_trace(log_dir):
        step(trainer.train_state)
    paths = {"device_trace_step": read_counts()}
    path = device_trace.last_path
    with open(path) as f:
        text = f.read()
    names = ("gather_window_kernel", "_transpose_kernel",
             "scatter_sum_kernel", "scatter_fill_kernel",
             "scatter_bins_sum_kernel")
    found = {n: text.count(n) for n in names}
    print(f"device_trace: {os.path.relpath(path, root)} "
          f"({os.path.getsize(path) / 2**20:.1f} MiB), kernel names "
          f"found {found}; launches " + json.dumps(paths["device_trace_step"]))
    if not all(found.values()):
        raise AssertionError(f"device_trace: the trace lacks {found}")
    require_launched("device_trace_step", paths["device_trace_step"],
                     ("window_topk", "gather_window", "scatter_window"))
    return paths


def ablation_phase(dev, work):
    """The sampler ablation twin (python -m ssdr_al_torch.scripts.ablation)
    at ABLATION.md's headline setting cut to two rounds and two configs:
    --rooms 3 --points 12000 --seed_percent 0.02 --clicks 40 --rounds 2
    --configs random,ssdr_full. Every round record must carry a finite
    mIoU and OA; the script's launch counts, read per phase (the
    partition, the seed round, each config), must show K6-k64 in the
    partition, K1, K2 and K4 in the training rounds and K3 in the
    ssdr_full selection."""
    from ssdr_al_torch.scripts import ablation

    recs = []
    t0 = time.perf_counter()
    reset_counts()
    g0 = dict(EVAL_GRAPHS)
    ablation.main(["--rooms", "3", "--points", "12000", "--seed_percent",
                   "0.02", "--clicks", "40", "--rounds", "2", "--configs",
                   "random,ssdr_full", "--workdir",
                   os.path.join(work, "ablation"), "--out",
                   os.path.join(work, "ablation.md")], log=recs.append)
    wall = time.perf_counter() - t0
    for r in recs:
        print("ablation " + json.dumps(r))
    phases = {r["phase"]: r["counts"] for r in recs
              if r.get("event") == "launches"}
    rounds = [r for r in recs if "round" in r]
    bad = [r for r in rounds if not (np.isfinite(r["miou"])
                                     and np.isfinite(r["oa"]))]
    if len(rounds) != 3 or bad:
        raise AssertionError(f"ablation: round records {rounds}")
    want = {"partition": ("knn_tiled_k64",),
            "seed": ("window_topk", "gather_window", "scatter_window"),
            "random": ("window_topk", "gather_window", "scatter_window"),
            "ssdr_full": ("window_topk", "gather_window", "scatter_window",
                          "chamfer_sums")}
    for name, kernels in want.items():
        require_launched(f"ablation {name}", dict.fromkeys(
            read_counts(), 0) | phases.get(name, {}), kernels)
    total = dict.fromkeys(read_counts(), 0)
    for counts in phases.values():
        for k, v in counts.items():
            total[k] += v
    print(f"ablation phase: {wall:.1f} s wall; launches by phase "
          + json.dumps(phases))
    require_replayed("ablation", g0)
    return {"ablation": total}


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
    t_start = time.perf_counter()
    card = card_line()
    print(card)

    from ssdr_al_torch.config import ConfigS3DIS
    from ssdr_al_torch.kernels import build

    count_eval_graphs()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build.library()
    print(f"kernel build (nvcc + load): {time.perf_counter() - t0:.2f} s")
    cfg = dataclasses.replace(ConfigS3DIS, max_epoch=TRAIN_EPOCHS,
                              train_steps=TRAIN_STEPS, val_steps=VAL_STEPS)
    checks = check_kernels(cfg, dev)
    check_upsample_windows(dev)
    window_paths = knn_window_phase(dev)

    work = os.path.join(root, "build", "smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    try:
        paths, checks["knn_tiled_k64"] = partition_path(
            dev, os.path.join(work, "partition"))
        paths.update(window_paths)
        paths.update(al_loop(cfg, dev, work, args.profile))
        paths.update(semantic3d_loop(dev, os.path.join(work, "semantic3d")))
        warm_steps(dev, work)
        paths.update(repeat_phase(dev, work))
        paths.update(replay_phase(dev, work))
        paths.update(eval_replay_phase(dev))
        scale_paths, _ = selection_scale_phase(dev, work)
        paths.update(scale_paths)
        s3d_paths, s3d_checks = semantic3d_scale_phase(dev, work)
        paths.update(s3d_paths)
        for name, c in s3d_checks.items():
            checks[name]["semantic3d_scale"] = c
        flag_paths, checks["chamfer_sums"]["flagship"] = flagship_phase(
            dev, work)
        paths.update(flag_paths)
        paths.update(trace_phase(dev, root))
        paths.update(ablation_phase(dev, work))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("eval graphs of the smoke: " + json.dumps(EVAL_GRAPHS))

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
                                              "shapes_semantickitti",
                                              "semantic3d_scale",
                                              "flagship")
                            if k in c}))
    jax_side = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "ssdr_al_tpu"))
    if jax_side:
        raise AssertionError(f"the port imported {jax_side[:5]}")
    print(f"smoke: {time.perf_counter() - t_start:.1f} s wall, the kernels' "
          "build included")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
