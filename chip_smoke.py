"""Smoke run of ssdr_al_torch on one NVIDIA GPU: build the CUDA kernels,
hold each against its plain PyTorch version at the main path's shapes,
then drive the closed active-learning loop at RandLA-Net S3DIS width
through the kernels: seed labels, round-1 training with evaluation to
snap-1, a full-SSDR selection round from the trained snap-1, and round-2
training from its pseudo-GT to snap-2.

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
}
ROOMS, ROOM_POINTS, TARGET_SP, BUDGET = 4, 150_000, 2048, 400
CHAMFER_SHAPE = (8, 256, 512)     # [C, S, P]: one K3 dispatch
TRAIN_EPOCHS, TRAIN_STEPS, VAL_STEPS = 2, 8, 2
SSDR_ARGS = ["t0", "sb", "clsbal", "gcn_fps", "WetSU", "NAIL", "0.9", "1",
             "1", "0"]
# H100 SXM data sheet: HBM3 bandwidth and the f32 rate outside the tensor
# cores (none of the kernels uses them)
PEAK_BYTES_S, PEAK_F32_OPS_S = 3.35e12, 67e12


def bound(nbytes, nops):
    """(ms, "bytes" | "operations"): the least time for the work."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, nops / PEAK_F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


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
    from ssdr_al_torch.ops.chamfer import chamfer_sums
    from ssdr_al_torch.ops.gather import gather_window, scatter_window
    from ssdr_al_torch.ops.knn import window_topk

    return {"window_topk": window_topk, "gather_window": gather_window,
            "chamfer_sums": chamfer_sums, "scatter_window": scatter_window}


def reset_counts():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_counters().items()}


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
    call computes the same function, that call's time."""
    from ssdr_al_torch.models.randlanet import GATHER_TQ
    from ssdr_al_torch.ops import chamfer as ch
    from ssdr_al_torch.ops import gather as ga
    from ssdr_al_torch.ops import knn as kn

    rng = np.random.RandomState(0)
    b, n = 8, cfg.num_points
    out = {}

    # K1 at L0: self-search k=16 in the 1792-point window; per (query,
    # candidate) 8 operations of d² and 1 compare with the k-th best
    w = cfg.search_window - (GATHER_TQ - kn.QUERY_TILE)
    xs = sorted_batch(rng, b, n, dev)
    st = kn.self_query_starts(n, n, w, device=dev).expand(b, -1).contiguous()
    got = kn.window_topk(xs, xs, st, cfg.k_n, w)
    want = kn._window_topk_plain(xs, xs, st, cfg.k_n, w, kn.QUERY_TILE)
    if not torch.equal(got, want):
        raise AssertionError(f"K1 L0: {(got != want).sum().item()} "
                             "indices differ from the plain version")
    err = (got.long() - want.long()).abs().max().item()
    ms = cuda_ms(lambda: kn.window_topk(xs, xs, st, cfg.k_n, w), 20)
    plain_ms = cuda_ms(lambda: kn._window_topk_plain(
        xs, xs, st, cfg.k_n, w, kn.QUERY_TILE), 3)
    k1_bound = bound(nbytes(xs, st, got), 9 * b * n * w)
    # K1 k=1 upsample: 40960 queries against the 10240-point kept subset
    sub = sorted_batch(rng, b, n // 4, dev)
    st1 = torch.from_numpy(rng.randint(0, (n // 4 - 1024) // 128 + 1,
                                       (b, n // 256)).astype(np.int32) * 128
                           ).to(dev)
    got1 = kn.window_topk(sub, xs, st1, 1, 1024)
    want1 = kn._window_topk_plain(sub, xs, st1, 1, 1024, kn.QUERY_TILE)
    if not torch.equal(got1, want1):
        raise AssertionError("K1 k=1 upsample differs from the plain version")
    ms1 = cuda_ms(lambda: kn.window_topk(sub, xs, st1, 1, 1024), 20)
    plain1 = cuda_ms(lambda: kn._window_topk_plain(sub, xs, st1, 1, 1024,
                                                   kn.QUERY_TILE), 3)
    bound1 = bound(nbytes(sub, xs, st1, got1), 9 * b * n * 1024)
    print(f"K1 window_topk [8x40960] k=16 W={w}: equal, {ms:.3f} ms "
          f"(plain {plain_ms:.3f} ms, bound {k1_bound[0]:.4f} ms by "
          f"{k1_bound[1]}); k=1 W=1024: equal, {ms1:.3f} ms (plain "
          f"{plain1:.3f} ms, bound {bound1[0]:.4f} ms by {bound1[1]})")
    out["window_topk"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=k1_bound[0], bound_by=k1_bound[1],
                              library_ms=None, ms_k1=ms1, plain_ms_k1=plain1,
                              bound_ms_k1=bound1[0])

    # K2: the L0 LFA gather of [xyz | 8 features] with the merged windows
    neigh = (torch.repeat_interleave(st, kn.QUERY_TILE, 1)[..., None] + got
             ).contiguous()
    w_g = w + GATHER_TQ - kn.QUERY_TILE
    gst = torch.clamp(st[:, :: GATHER_TQ // kn.QUERY_TILE], max=n - w_g
                      ).contiguous()
    vals = torch.cat([xs, torch.randn(b, n, 8, device=dev)], -1).contiguous()
    g = ga.gather_window(vals, neigh, gst, w_g, GATHER_TQ)
    gp = ga._gather_window_plain(vals, neigh, gst, w_g, GATHER_TQ)
    if not torch.equal(g, gp):
        raise AssertionError("K2 differs from the plain version")
    gms = cuda_ms(lambda: ga.gather_window(vals, neigh, gst, w_g, GATHER_TQ),
                  20)
    gplain = cuda_ms(lambda: ga._gather_window_plain(vals, neigh, gst, w_g,
                                                     GATHER_TQ), 5)
    flat = neigh.long().reshape(b, -1, 1).expand(-1, -1, vals.shape[-1])
    glib = cuda_ms(lambda: torch.gather(vals, 1, flat), 20)
    gerr = (g - gp).abs().max().item()
    g_bound = bound(nbytes(vals, neigh, gst, g), 0)
    print(f"K2 gather_window [8x40960x16x11] W={w_g}: bitwise equal, "
          f"{gms:.3f} ms (plain {gplain:.3f} ms, torch.gather {glib:.3f} ms, "
          f"bound {g_bound[0]:.4f} ms by {g_bound[1]})")
    out["gather_window"] = dict(max_abs_err=gerr, ms=gms, plain_ms=gplain,
                                bound_ms=g_bound[0], bound_by=g_bound[1],
                                library_ms=glib)

    # K4: the backward of the same L0 gather at the training batch B=6;
    # one add per cotangent value
    bt = cfg.batch_size
    cot = torch.randn(bt, n, cfg.k_n, vals.shape[-1], device=dev)
    idx6, st6 = neigh[:bt].contiguous(), gst[:bt].contiguous()
    # f32 atomics sum in no fixed order: two orders of a sum of m values
    # differ by at most 2·m·ε·Σ|g|, so each element within 1e-5 relative
    # plus that bound
    dv = ga.scatter_window(cot, idx6, st6, n, w_g, GATHER_TQ)
    dvp = ga._scatter_window_plain(cot, idx6, st6, n, w_g, GATHER_TQ)
    m = ga._scatter_window_plain(torch.ones_like(cot), idx6, st6, n, w_g,
                                 GATHER_TQ)
    tol = 1e-5 * dvp.abs() + 2 * m * 2.0 ** -23 * ga._scatter_window_plain(
        cot.abs(), idx6, st6, n, w_g, GATHER_TQ)
    serr = (dv - dvp).abs().max().item()
    if not bool(((dv - dvp).abs() <= tol).all()):
        raise AssertionError(f"K4 differs from the plain version: {serr}")
    sms = cuda_ms(lambda: ga.scatter_window(cot, idx6, st6, n, w_g,
                                            GATHER_TQ), 20)
    splain = cuda_ms(lambda: ga._scatter_window_plain(cot, idx6, st6, n, w_g,
                                                      GATHER_TQ), 5)
    rows = (idx6.long() + (torch.arange(bt, device=dev) * n)[:, None, None]
            ).reshape(-1)
    cot2 = cot.reshape(-1, cot.shape[-1])
    slib = cuda_ms(lambda: torch.zeros(bt * n, cot.shape[-1], device=dev)
                   .index_add_(0, rows, cot2), 20)
    s_bound = bound(nbytes(cot, idx6, st6, dv), cot.numel())
    print(f"K4 scatter_window [6x40960x16x11] -> [6x40960x11] W={w_g}: max "
          f"abs err {serr:.2e} (within 1e-5 rel + 2·m·eps·sum|g|), "
          f"{sms:.3f} ms (plain "
          f"{splain:.3f} ms, index_add_ {slib:.3f} ms, bound "
          f"{s_bound[0]:.4f} ms by {s_bound[1]})")
    out["scatter_window"] = dict(max_abs_err=serr, ms=sms, plain_ms=splain,
                                 bound_ms=s_bound[0], bound_by=s_bound[1],
                                 library_ms=slib)

    # K3: one [8, S, P] chamfer dispatch; per pair of valid points of one
    # block, 8 operations of d² and 1 min
    c, s, p = CHAMFER_SHAPE
    pts = torch.from_numpy((rng.randn(c, s, p, 3) * 0.3).astype(np.float32)
                           ).to(dev)
    msk = torch.from_numpy(rng.rand(c, s, p) < 0.6).to(dev)
    o = ch.chamfer_sums(pts, msk)
    op = ch._chamfer_sums_plain(pts, msk)
    rel = ((o - op).abs() / op.abs().clamp(min=1e-6)).max().item()
    if not rel <= 1e-5:
        raise AssertionError(f"K3 relative error {rel}")
    cms = cuda_ms(lambda: ch.chamfer_sums(pts, msk), 5)
    cplain = cuda_ms(lambda: ch._chamfer_sums_plain(pts, msk), 1)
    pairs = float((msk.sum((1, 2)).double() ** 2).sum())
    c_bound = bound(nbytes(pts, msk, o), 9 * pairs)
    print(f"K3 chamfer_sums [{c},{s},{p}]: max rel err {rel:.2e}, "
          f"{cms:.3f} ms (plain {cplain:.3f} ms, bound {c_bound[0]:.4f} ms "
          f"by {c_bound[1]})")
    out["chamfer_sums"] = dict(max_abs_err=(o - op).abs().max().item(),
                               ms=cms, plain_ms=cplain, bound_ms=c_bound[0],
                               bound_by=c_bound[1], library_ms=None)
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


def check_gradient_reference(cfg, state, dev):
    """One 40960-point block in train mode, dropout off: the loss and the
    gradient of every parameter on the card (K1, K2, K4) against the CPU
    (plain versions) on the same sorted pyramid. Loss within 1e-4
    relative; all gradients as one vector within 1e-3 relative L2 (f32
    sums in other orders, K4's atomics in none). Prints the shapes of the
    step's K4 calls."""
    from ssdr_al_torch.models.randlanet import (
        RandLANet,
        SortedPyramid,
        build_pyramid,
        masked_weighted_ce,
    )
    from ssdr_al_torch.ops import gather as ga

    rng = np.random.RandomState(3)
    n = cfg.num_points
    xyz = torch.from_numpy((rng.rand(1, n, 3) * 6).astype(np.float32))
    feats = torch.cat([xyz, torch.from_numpy(rng.rand(1, n, 3).astype(
        np.float32))], -1)
    labels = torch.from_numpy(rng.randint(0, cfg.num_classes, (1, n)))
    act = torch.from_numpy((rng.rand(1, n) < 0.5).astype(np.float32))
    weights = torch.from_numpy(rng.rand(cfg.num_classes).astype(np.float32)
                               + 0.5)
    with torch.no_grad():
        pyr = build_pyramid(xyz.to(dev), cfg)
    if not isinstance(pyr, SortedPyramid):
        raise AssertionError("the full-width block did not take the sorted "
                             "path")
    cpu_pyr = SortedPyramid(*[[None if t is None else t.cpu() for t in f]
                              if isinstance(f, list) else f.cpu()
                              for f in (pyr.xyz, pyr.neigh_idx, pyr.starts,
                                        pyr.sub_idx, pyr.interp_idx,
                                        pyr.order, pyr.inv)],
                            windows=pyr.windows)
    grads, losses, k4_shapes = [], [], []
    kernel = ga.scatter_window

    def recording(g, idx, starts, n, window, tq):
        k4_shapes.append((tuple(g.shape), n, window, tq))
        return kernel(g, idx, starts, n, window, tq)

    # the wrapper counts its launches on the module's name for it, which
    # is `recording` while it stands in
    recording.launches = 0

    for d, p in ((dev, pyr), (torch.device("cpu"), cpu_pyr)):
        model = RandLANet(cfg).to(d)
        model.load_state_dict({k: v.to(d) for k, v in state.items()})
        model.train()
        model.dp1.eval()
        order = p.order.long()
        ga.scatter_window = recording if d == dev else kernel
        try:
            logits, _ = model(feats.to(d), p, unsort=False)
            loss, _ = masked_weighted_ce(
                logits, torch.gather(labels.to(d), 1, order),
                torch.gather(act.to(d), 1, order),
                torch.gather(labels.to(d), 1, order), weights.to(d))
            loss.backward()
        finally:
            ga.scatter_window = kernel
        losses.append(loss.item())
        grads.append(torch.cat([q.grad.reshape(-1).cpu()
                                for q in model.parameters()]))
    print("K4 calls of one train step, (g shape, n, window, tq): "
          + json.dumps(k4_shapes))
    lrel = abs(losses[0] - losses[1]) / abs(losses[1])
    grel = float((grads[0] - grads[1]).norm() / grads[1].norm())
    print(f"train-mode gradient [1x{n}] card vs CPU plain: loss "
          f"{losses[0]:.6f} vs {losses[1]:.6f} (rel {lrel:.2e}), gradient "
          f"rel L2 {grel:.2e}")
    if not (np.isfinite(losses[0]) and lrel <= 1e-4 and grel <= 1e-3):
        raise AssertionError("card gradient disagrees with the CPU reference")


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


def train_round(trainer, round_num, clouds, val, pseudo, seed):
    """Trainer.train_round on the host pipeline with evaluation; returns the
    losses of every step (device scalars) and the round's wall clock."""
    from ssdr_al_torch.data.dataset import TrainingPipeline
    from ssdr_al_torch.train.evaluator import Evaluator

    cfg = trainer.cfg
    pipe = TrainingPipeline(clouds, cfg, pseudo_gt=pseudo, seed=seed)
    losses, step = [], trainer.train_step

    def recording(state, batch, gen):
        state, metrics = step(state, batch, gen)
        losses.append(metrics["loss"])
        return state, metrics

    trainer.train_step = recording
    t0 = time.perf_counter()
    try:
        miou, oa = trainer.train_round(
            round_num, lambda epoch: pipe.batches(cfg.train_steps,
                                                  cfg.batch_size),
            Evaluator(cfg, val, max_epochs=1))
    finally:
        trainer.train_step = step
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loss = torch.stack(losses).cpu()
    if len(losses) != TRAIN_EPOCHS * TRAIN_STEPS or \
            not torch.isfinite(loss).all():
        raise AssertionError(f"round {round_num}: losses {loss.tolist()}")
    if not os.path.exists(trainer.snapshot_path(round_num)):
        raise AssertionError(f"round {round_num}: no snap-{round_num}")
    print(f"round {round_num} training: {len(losses)} steps of "
          f"[{cfg.batch_size}x{cfg.num_points}], {wall:.3f} s wall with "
          f"evaluation, loss {loss[0]:.4f} -> {loss[-1]:.4f}, best mIoU "
          f"{miou:.4f} OA {oa:.4f}, snap-{round_num} written")
    return pipe, wall


def al_loop(cfg, dev, work, profile_out=None):
    """Seed round → round-1 training to snap-1 → selection from snap-1 →
    round-2 training to snap-2, each path's kernel launches counted from 0.
    Returns {path: launch counts} and the timings to report."""
    from ssdr_al_torch.active.samplers import TSampler, TSamplerArgs
    from ssdr_al_torch.active.state import ALState, RoundStats, sampler_args_str
    from ssdr_al_torch.train.trainer import Trainer

    train, val, total = make_workload(cfg, work)
    saver = lambda sargs: os.path.join(  # noqa: E731
        work, "saver", sampler_args_str(sargs), "snapshots")
    seed_state = ALState(work, ["seed"])
    report, paths = {}, {}

    # --- round 1: train from the seed labels, evaluate, keep snap-1 -------
    trainer = Trainer(cfg, "S3DIS", save_dir=saver(["seed"]), device=dev)
    trainer.init_state()
    pseudo = {c.name: seed_state.load_pseudo_gt(seed_state.round_dir(1),
                                                c.name) for c in train}
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    pipe, wall = train_round(trainer, 1, train, val, pseudo, seed=1)
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
    check_gradient_reference(cfg, trainer.state, dev)

    # --- round 2: restore snap-1, select, label, retrain to snap-2 ---------
    state = ALState(work, SSDR_ARGS)
    trainer = Trainer(cfg, "S3DIS", save_dir=saver(SSDR_ARGS),
                      seed_save_dir=saver(["seed"]), device=dev)
    trainer.restore_model(1)
    sampler = TSampler(state, train, cfg, TSamplerArgs(), total["sp_num"],
                       device=dev)
    stats = RoundStats()
    reset_counts()
    t0 = time.perf_counter()
    sampler.sampling(trainer.eval_step, trainer.state, BUDGET, 1, stats)
    torch.cuda.synchronize()
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

    pseudo = {c.name: state.load_pseudo_gt(r2, c.name) for c in train}
    reset_counts()
    _, wall = train_round(trainer, 2, train, val, pseudo, seed=2)
    paths["train_round_2"] = read_counts()
    print("launches train_round_2 " + json.dumps(paths["train_round_2"]))
    require_launched("train_round_2", paths["train_round_2"],
                     ("window_topk", "gather_window", "scatter_window"))
    report["train_round_2_wall_s"] = wall

    if profile_out:
        prof = profile_rounds(cfg, dev, sampler, trainer.eval_step,
                              trainer.state)
        prof.update(profile_train_step(trainer, pipe), report=report)
        os.makedirs(os.path.dirname(profile_out) or ".", exist_ok=True)
        with open(profile_out, "w") as f:
            json.dump(prof, f, indent=1)
        print(f"profile written to {profile_out}")
    return paths


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
                         bound_by=c["bound_by"], library_ms=c["library_ms"]))
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
