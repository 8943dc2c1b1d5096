"""Smoke run of ssdr_al_torch on one NVIDIA GPU: build the CUDA kernels,
hold each against its plain PyTorch version at the selection round's
shapes, then drive one full-SSDR active-learning selection round at
RandLA-Net S3DIS width through the kernels.

    python3 chip_smoke.py [--profile [PATH]]

Needs a CUDA device and nvcc; exits non-zero without them. Prints the
card's name and power limit, the build time, each kernel's check and
times, the round's phase times, a JSON line of kernel results, and as its
last line {"ok": true, "device": {...}}. Works under <repo>/build/ only.

--profile adds, after the checked round, the breakdown of warm rounds:
wall clock and phase times of an unprofiled round, device busy time and
top device kernels under torch.profiler, the host functions under
cProfile, and one eval step [8, 40960] and its pyramid by CUDA events. It
prints a summary and writes everything as JSON to PATH (default
build/profile_round.json).
"""

from __future__ import annotations

import argparse
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
}
ROOMS, ROOM_POINTS, TARGET_SP, BUDGET = 4, 150_000, 2048, 400
CHAMFER_SHAPE = (8, 256, 512)     # [C, S, P]: one K3 dispatch


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


def sorted_batch(rng, b, n, dev):
    from ssdr_al_torch.ops.knn import morton_codes, sort_by_codes

    xyz = torch.from_numpy((rng.rand(b, n, 3) * 6).astype(np.float32)).to(dev)
    lo, hi = xyz.amin(1, keepdim=True), xyz.amax(1, keepdim=True)
    _, _, xs = sort_by_codes(morton_codes(xyz, lo, hi), xyz)
    return xs.contiguous()


def check_kernels(cfg, dev):
    """Each kernel vs its plain version on the card, at the slice's shapes."""
    from ssdr_al_torch.models.randlanet import GATHER_TQ
    from ssdr_al_torch.ops import chamfer as ch
    from ssdr_al_torch.ops import gather as ga
    from ssdr_al_torch.ops import knn as kn

    rng = np.random.RandomState(0)
    b, n = 8, cfg.num_points
    out = {}

    # K1 at L0: self-search k=16 in the 1792-point window
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
    print(f"K1 window_topk [8x40960] k=16 W={w}: equal, {ms:.3f} ms "
          f"(plain {plain_ms:.3f} ms); k=1 W=1024: equal, {ms1:.3f} ms "
          f"(plain {plain1:.3f} ms)")
    out["window_topk"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              ms_k1=ms1, plain_ms_k1=plain1)

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
    gerr = (g - gp).abs().max().item()
    print(f"K2 gather_window [8x40960x16x11] W={w_g}: bitwise equal, "
          f"{gms:.3f} ms (plain {gplain:.3f} ms)")
    out["gather_window"] = dict(max_abs_err=gerr, ms=gms, plain_ms=gplain)

    # K3: one [8, S, P] chamfer dispatch
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
    print(f"K3 chamfer_sums [{c},{s},{p}]: max rel err {rel:.2e}, "
          f"{cms:.3f} ms (plain {cplain:.3f} ms)")
    out["chamfer_sums"] = dict(max_abs_err=(o - op).abs().max().item(),
                               ms=cms, plain_ms=cplain)
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
    cpu = make_eval_step(RandLANet(cfg), cfg, "window", False)(cpu_state,
                                                                batch)
    for g, c in zip(gpu, cpu):
        if g.shape != c.shape or not torch.isfinite(g).all():
            raise AssertionError(f"forward output {tuple(g.shape)} bad")
    agree = (gpu[0].argmax(-1).cpu() == cpu[0].argmax(-1)).float().mean()
    rel = ((gpu[1].cpu() - cpu[1]).norm() / cpu[1].norm()).item()
    print(f"forward [1x40960] card vs CPU plain: class agreement "
          f"{agree.item():.5f}, penult rel err {rel:.2e}")
    if agree < 0.999 or rel > 1e-3:
        raise AssertionError("card forward disagrees with the CPU reference")


def selection_round(cfg, dev, work, profile_out=None):
    """Seed round + one full-SSDR TSampler round on synthetic rooms, then
    the --profile rounds when profile_out is set."""
    from ssdr_al_torch.active.samplers import (
        SeedSampler,
        TSampler,
        TSamplerArgs,
    )
    from ssdr_al_torch.active.state import ALState, RoundStats
    from ssdr_al_torch.data import grid_superpoints, make_dataset
    from ssdr_al_torch.models.randlanet import RandLANet
    from ssdr_al_torch.train.trainer import (
        init_params,
        make_eval_step,
        restore_checkpoint,
        save_checkpoint,
    )

    t0 = time.perf_counter()
    train, _ = make_dataset(num_train=ROOMS, num_val=0,
                            num_points=ROOM_POINTS, seed=0, hard=True)
    sargs = ["t0", "sb", "clsbal", "gcn_fps", "WetSU", "NAIL", "0.9", "1",
             "1", "0"]
    state = ALState(work, sargs)
    total = {"unlabeled": {}}
    sp_num = 0
    for c in train:
        comps, in_comp = grid_superpoints(c.xyz, TARGET_SP)
        state.write_superpoints(c.name, comps, in_comp, c.num_points)
        total["unlabeled"][c.name] = np.arange(len(comps))
        sp_num += len(comps)
    total.update(file_num=len(train), sp_num=sp_num,
                 point_num=sum(c.num_points for c in train))
    state.write_registry(total)
    SeedSampler(ALState(work, ["seed"]), train, sp_num).sampling(
        sp_num // 20, 0, RoundStats())
    snap = os.path.join(work, "snapshots", "snap-1")
    save_checkpoint(snap, init_params(cfg, torch.Generator().manual_seed(0)))
    params = restore_checkpoint(snap, dev)
    print(f"workload: {ROOMS} rooms x {ROOM_POINTS} points, {sp_num} "
          f"superpoints, setup {time.perf_counter() - t0:.1f} s")

    check_forward_reference(cfg, params, dev)

    from ssdr_al_torch.ops.chamfer import chamfer_sums
    from ssdr_al_torch.ops.gather import gather_window
    from ssdr_al_torch.ops.knn import window_topk

    counters = (window_topk, gather_window, chamfer_sums)
    for fn in counters:
        fn.launches = 0
    sampler = TSampler(state, train, cfg, TSamplerArgs(), sp_num, device=dev)
    eval_step = make_eval_step(RandLANet(cfg).to(dev), cfg, "window", True,
                               device=dev)
    stats = RoundStats()
    t0 = time.perf_counter()
    sampler.sampling(eval_step, params, BUDGET, 1, stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}

    r2 = state.round_dir(2)
    after = state.load_registry(r2)["unlabeled"]
    n0 = sum(len(v) for v in total["unlabeled"].values())
    n2 = sum(len(v) for v in after.values())
    gts = [f for f in os.listdir(r2) if f.endswith(".gt")]
    print(f"selection round: {wall:.3f} s wall, unlabeled {n0} -> {n2} "
          f"(seed + round), {len(gts)} .gt files, stats: {stats}")
    print("phase_times " + json.dumps(sampler.phase_times))
    print("launches " + json.dumps(launches))
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if not n2 < n0 or len(gts) != ROOMS:
        raise AssertionError("round did not label or did not write .gt files")
    if profile_out:
        profile_rounds(cfg, dev, sampler, eval_step, params, profile_out)
    return launches

def device_time(prof):
    """(busy µs, {kernel: ms}) of the CUDA events a torch.profiler run
    recorded: the union of their intervals, and the 8 largest by total."""
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
    return busy, dict(top)


def profile_rounds(cfg, dev, sampler, eval_step, params, out_path):
    """Warm rounds 3-6 after the checked round 2: round 3 unprofiled, 4 and
    5 under torch.profiler, 6 under cProfile; then one eval step."""
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
        busy_us, top = device_time(prof)
        report[f"round{last + 1}"] = dict(
            wall_s=wall, device_busy_ms=busy_us / 1e3,
            device_busy_share=busy_us / 1e6 / wall,
            phase_times=dict(sampler.phase_times), top_device_ms=top)
        print(f"profile round {last + 1} (torch.profiler): {wall:.3f} s wall, "
              f"device busy {busy_us / 1e3:.3f} ms "
              f"({100 * busy_us / 1e6 / wall:.1f} %), prediction_s "
              f"{sampler.phase_times['prediction_s']:.3f}")
        print("  top device ms " + json.dumps(
            {k[:60]: round(v, 3) for k, v in top.items()}))
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
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print(f"profile written to {out_path}")


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
    cfg = ConfigS3DIS
    checks = check_kernels(cfg, dev)

    work = os.path.join(root, "build", "smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    try:
        launches = selection_round(cfg, dev, work, args.profile)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    rows = []
    for name, (source, replaces) in KERNELS.items():
        c = checks[name]
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, launches=launches[name],
                         max_abs_err=c["max_abs_err"], ms=c["ms"],
                         plain_ms=c["plain_ms"]))
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
