"""The active-learning selection round at the reference's scale, phase by
phase: the twin of scripts/profile_selection.py and of bench.py's
Semantic3D-scale round, on the port.

    python -m ssdr_al_torch.scripts.profile_selection [--dataset S3DIS] \
        [--clouds 200] [--points 4096] [--budget 10000] [--target_sp 256] \
        [--seed_div 20] [--rounds 1] [--keep] \
        [--diversity gcn_fps|gcn|edcd] [--chunk_batch N] [--eager] \
        [--profile] [--device cuda|cpu]

    python -m ssdr_al_torch.scripts.profile_selection --dataset Semantic3D \
        --clouds 8 --points 1000000 --target_sp 2048 --seed_div 40 \
        --budget 3000 --rounds 3

`--dataset S3DIS` (the default): the reference's sampling pass covers
every S3DIS training cloud (~200, sampler2.py:589-598) with a 10 000-click
budget (ssdr_main_S3DIS2.py:134). The workload is the JAX script's
(bench.py:424-500): `--clouds` synthetic rooms of `--points` points, grid
superpoints of ~`--target_sp` regions a room (data/synthetic.py::
grid_superpoints; the partition is offline in every system and left
out), a seed round labelling sp_num // seed_div superpoints, and a
TSampler (sb, WetSU, clsbal, NAIL, the `--diversity` branch) over the
bf16 ConfigS3DIS at num_points = `--points`, its weights from a
torch.Generator seeded 0.

`--dataset Semantic3D`: bench.py::measure_semantic3d_selection
(bench.py:643-700), the counterpart of the reference's octant splitting
of large Semantic3D scans (ssdr_main_semantic3d.py:121): the same
workload with clouds of `--points` points (the second command line: 8
clouds of 1 000 000, ~16 400 superpoints, a seed round at seed_div 40,
3000 clicks) and the bf16 ConfigSemantic3D over the synthetic classes,
whose SamplingPipeline cuts each cloud into cfg.num_points = 65 536-point
chunks (16 a cloud, the last padded).

One warm round, then `--rounds` measured rounds, each from the last
round's registry.

`--eager` runs the selection forward and the greedy loops (farthest-
feature, farthest-superpoint, k-center) eagerly on the card, for the
comparison with their replayed CUDA graphs; the coreGCN fit replays its
graph either way. `--chunk_batch` sets the selection forward's chunk
group (scripts/bench_chunk_batch.py sweeps it; 0: InferenceRunner's
rule). `--profile` adds a round under cProfile (the top host functions).

Prints one JSON line a record: {"event": "device"} (the card's name and
power limit), {"event": "setup"} (with the time to make the clouds,
their superpoints and the seed round), {"event": "warm_round"}, one
{"event": "measured_round"} a round (wall, phase times, RoundStats,
each greedy loop's wall, replays, capture time and pool bytes, the K3
calls' shapes and valid shares; on the card kernel launches by kernel,
peak device bytes, allocated and reserved, and the eval step's kept
captures, each with its program, input shapes and pool bytes), on the
card
{"event": "busy_round"} (the first measured round again, from the same
registry, under torch.profiler: the device-busy share) and with
`--profile` {"event": "host_profile"} (that round under cProfile). The JAX script's
`--reference` / `--reference_only` (the reference's numpy selection) need
the reference checkout, which the repository does not hold.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import dataclasses
import json
import os
import pstats
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

# the JAX script's sampler arguments (bench.py:437), the diversity branch
# fourth
SSDR_ARGS = ["t0", "sb", "clsbal", "gcn_fps", "WetSU", "NAIL", "0.9", "1",
             "1", "0"]
HOST_TOP = 25       # host functions the cProfile round reports


def sampler_args(diversity: str):
    """SSDR_ARGS with `diversity` as the branch."""
    args = list(SSDR_ARGS)
    args[3] = diversity
    return args


def build_selection_workload(work, num_rooms, points, *, target_sp=256,
                             seed_div=20, diversity="gcn_fps", timings=None):
    """(train clouds, ALState, registry) under `work`: the rooms, their
    grid superpoints and registry, and the seed round's labels, as
    bench.py::_build_selection_workload(fast_partition=True). `timings`
    (a dict) gets the host seconds of each: clouds_s, superpoints_s,
    seed_s."""
    from ssdr_al_torch.active.samplers import SeedSampler
    from ssdr_al_torch.active.state import ALState, RoundStats
    from ssdr_al_torch.cli.common import write_grid_superpoints
    from ssdr_al_torch.data.synthetic import make_dataset

    timings = {} if timings is None else timings
    t0 = time.perf_counter()
    train, _ = make_dataset(num_train=num_rooms, num_points=points)
    t1 = time.perf_counter()
    state = ALState(work, sampler_args(diversity))
    write_grid_superpoints(state, train, target_sp)
    total = state.load_registry()
    t2 = time.perf_counter()
    # the seed round lives under its own sampler-args dir, as in the CLI
    seeder = SeedSampler(ALState(work, ["seed"]), train, total["sp_num"])
    seeder.sampling(max(1, total["sp_num"] // seed_div), 0, RoundStats())
    timings.update(clouds_s=t1 - t0, superpoints_s=t2 - t1,
                   seed_s=time.perf_counter() - t2)
    return train, state, total


def selection_config(dataset="S3DIS", points_per_chunk=4096):
    """The bf16 selection config over the synthetic classes: for S3DIS
    ConfigS3DIS at num_points = points_per_chunk (bench.py::
    _make_selection_sampler), for Semantic3D ConfigSemantic3D with its own
    65 536-point chunk and no ignored label (bench.py:674-677)."""
    from ssdr_al_torch import config
    from ssdr_al_torch.data.synthetic import NUM_SYNTH_CLASSES

    if dataset == "Semantic3D":
        return dataclasses.replace(
            config.ConfigSemantic3D, num_classes=NUM_SYNTH_CLASSES,
            ignored_label_inds=(), compute_dtype="bfloat16")
    if dataset != "S3DIS":
        raise ValueError(f"selection_config: unknown dataset {dataset!r}")
    return dataclasses.replace(config.ConfigS3DIS,
                               num_points=points_per_chunk,
                               num_classes=NUM_SYNTH_CLASSES,
                               compute_dtype="bfloat16")


def make_selection_sampler(train, state, total, points_per_chunk=4096, *,
                           dataset="S3DIS", diversity="gcn_fps",
                           device="cuda", eager=False, seed=0):
    """(TSampler, eval step, model state): selection_config(dataset,
    points_per_chunk) (points_per_chunk is S3DIS's chunk; Semantic3D keeps
    its own), weights from a torch.Generator seeded `seed` (bench.py
    draws JAX's from PRNGKey(0)); eager=True runs the eval step and the
    greedy loops eagerly on the card."""
    from ssdr_al_torch.active.samplers import TSampler, TSamplerArgs
    from ssdr_al_torch.models.randlanet import RandLANet, init_params
    from ssdr_al_torch.train.trainer import make_eval_step

    cfg = selection_config(dataset, points_per_chunk)
    params = {k: v.to(device) for k, v in init_params(
        cfg, torch.Generator().manual_seed(seed)).items()}
    eval_step = make_eval_step(RandLANet(cfg).to(device), cfg, device=device,
                               eager=eager)
    sampler = TSampler(state, train, cfg,
                       TSamplerArgs(diversity=diversity, oracle_mode="NAIL",
                                    class_balance="clsbal"),
                       total["sp_num"], device=device, eager=eager)
    return sampler, eval_step, params


@contextlib.contextmanager
def chunk_batch(cb: int):
    """InferenceRunner's chunk group set to `cb` inside the block (0: its
    own rule), as scripts/bench_chunk_batch.py sets it."""
    from ssdr_al_torch.active import samplers

    runner = samplers.InferenceRunner
    if cb:
        samplers.InferenceRunner = lambda *a, **kw: runner(
            *a, **dict(kw, chunk_batch=cb))
    try:
        yield
    finally:
        samplers.InferenceRunner = runner


@contextlib.contextmanager
def record_k3_calls():
    """Yields a list that gets, for each chamfer call of the selection
    inside the block (the region graph's and edcd's, one K3 launch each),
    its [C, S, P] shape and its valid points per superpoint ([C, S], left
    on the call's device, so that the round waits for nothing)."""
    from ssdr_al_torch.active import region_graph, samplers

    calls = []
    saved = (region_graph.chamfer_pairwise_blocks, samplers.chamfer_pairwise)

    def wrap(fn):
        def rec(points, mask):
            calls.append((tuple(mask.shape), mask.sum(-1)))
            return fn(points, mask)
        return rec

    region_graph.chamfer_pairwise_blocks = wrap(saved[0])
    samplers.chamfer_pairwise = wrap(saved[1])
    try:
        yield calls
    finally:
        region_graph.chamfer_pairwise_blocks, samplers.chamfer_pairwise = \
            saved


def k3_summary(calls) -> dict:
    """{calls, shape (the largest call's [C, S, P]), valid_share (valid
    points over slots, all calls), pairs (unordered pairs of valid points
    in distinct superpoints of a block, K3's least work: kernels/
    measure.py::chamfer_bounds)} of record_k3_calls' list."""
    if not calls:
        return {"calls": 0}
    slots = valid = pairs = 0
    for shape, cnt in calls:
        cnt = cnt.double().reshape(-1, shape[-2])           # [C, S]
        tot = cnt.sum(-1)
        slots += int(np.prod(shape))
        valid += float(tot.sum())
        pairs += float(((tot * tot - (cnt * cnt).sum(-1)) / 2).sum())
    shape = max((s for s, _ in calls), key=lambda s: int(np.prod(s)))
    return dict(calls=len(calls), shape=list(shape),
                valid_share=valid / slots, pairs=pairs)


def run_round(sampler, eval_step, params, budget, last_round, dev):
    """One selection round from round `last_round`'s registry to a
    synchronize: {round, wall_s, phases, stats, loops (each greedy loop's
    and the coreGCN fit's train/graphs.py::record_runs record: runs on
    the card), k3 (k3_summary of its chamfer calls)}, and on the card
    launches (by kernel), peak_bytes (allocated) and peak_reserved_bytes
    (the allocator's, the kept graphs' pools among them), and
    forward_graphs (the eval step's captures and replays so far, and its
    kept captures, each {program, shapes, pool_bytes})."""
    from ssdr_al_torch.active.state import RoundStats
    from ssdr_al_torch.kernels import counts
    from ssdr_al_torch.train import graphs

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    counts.reset()
    stats = RoundStats()
    t0 = time.perf_counter()
    with graphs.record_runs() as runs, record_k3_calls() as k3:
        sampler.sampling(eval_step, params, budget, last_round, stats)
    if cuda:
        torch.cuda.synchronize(dev)
    out = dict(round=last_round + 1, wall_s=time.perf_counter() - t0,
               phases=dict(sampler.phase_times), stats=stats.as_dict(),
               loops=runs, k3=k3_summary(k3))
    if cuda:
        st = eval_step.stats()
        out.update(launches={k: v for k, v in counts.read().items() if v},
                   peak_bytes=torch.cuda.max_memory_allocated(dev),
                   peak_reserved_bytes=torch.cuda.max_memory_reserved(dev),
                   forward_graphs={k: st[k] for k in ("captures", "replays",
                                                      "capture_bytes", "kept")
                                   if k in st})
    return out


def host_profile(fn, top=HOST_TOP):
    """fn() under cProfile: (wall_s, the `top` functions by own time, each
    {function, calls, tottime_s, cumtime_s})."""
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(fn)
    wall = time.perf_counter() - t0
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:top]
    return wall, [dict(function=f"{os.path.basename(f)}:{line}({name})",
                       calls=nc, tottime_s=tt, cumtime_s=ct)
                  for (f, line, name), (_, nc, tt, ct, _) in rows]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def parser():
    from ssdr_al_torch.device import DEFAULT_DEVICE

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", default="S3DIS",
                   choices=["S3DIS", "Semantic3D"],
                   help="S3DIS: the chunk is --points; Semantic3D: clouds "
                        "of --points points in the config's 65 536-point "
                        "chunks")
    p.add_argument("--clouds", type=int, default=200)
    p.add_argument("--points", type=int, default=4096)
    p.add_argument("--budget", type=int, default=10000)
    p.add_argument("--target_sp", type=int, default=256)
    p.add_argument("--rounds", type=int, default=1,
                   help="measured rounds after the warm round")
    p.add_argument("--seed_div", type=int, default=20,
                   help="the seed round labels sp_num/seed_div superpoints")
    p.add_argument("--keep", action="store_true",
                   help="keep the workload directory")
    p.add_argument("--diversity", default="gcn_fps",
                   choices=["gcn_fps", "gcn", "edcd"])
    p.add_argument("--chunk_batch", type=int, default=0,
                   help="the selection forward's chunk group (0: "
                        "InferenceRunner's rule)")
    p.add_argument("--eager", action="store_true",
                   help="the selection forward and the greedy loops eager")
    p.add_argument("--profile", action="store_true",
                   help="one more round under cProfile")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="cuda (default) or cpu")
    return p


def main(argv=None, log=None) -> list:
    """Run the rounds; returns the records, each also passed to `log`
    (default: one JSON line on stdout)."""
    from ssdr_al_torch.device import resolve_device
    from ssdr_al_torch.kernels import build

    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    records = []

    def emit(rec):
        records.append(rec)
        if log is None:
            print(json.dumps(rec), flush=True)
        else:
            log(rec)

    if dev.type == "cuda":
        emit({"event": "device", "kind": torch.cuda.get_device_name(dev),
              "card": card_line()})
        build.library()
    work = tempfile.mkdtemp(prefix="profile_sel_")
    try:
        t0 = time.perf_counter()
        setup = {}
        train, state, total = build_selection_workload(
            work, args.clouds, args.points, target_sp=args.target_sp,
            seed_div=args.seed_div, diversity=args.diversity,
            timings=setup)
        sampler, eval_step, params = make_selection_sampler(
            train, state, total, args.points, dataset=args.dataset,
            diversity=args.diversity, device=dev, eager=args.eager)
        emit({"event": "setup", "dataset": args.dataset,
              "clouds": args.clouds, "points": args.points,
              "chunk": sampler.cfg.num_points, "sp_num": total["sp_num"],
              "diversity": args.diversity, "eager": args.eager,
              "setup_s": time.perf_counter() - t0, **setup})

        def rnd(last):
            return run_round(sampler, eval_step, params, args.budget, last,
                             dev)

        with chunk_batch(args.chunk_batch):
            rec = rnd(1)
            emit({"event": "warm_round", "wall_s": rec["wall_s"],
                  "phases": rec["phases"]})
            last = 2
            for _ in range(args.rounds):
                emit(dict(event="measured_round", **rnd(last)))
                last += 1
            # the profiled rounds repeat the first measured round, from
            # the same registry
            if dev.type == "cuda":
                from ssdr_al_torch.train.step_times import busy_share

                busy = busy_share(lambda: rnd(2), reps=1)
                emit(dict(event="busy_round", round=3, **busy))
            if args.profile:
                wall, top = host_profile(lambda: rnd(2))
                emit({"event": "host_profile", "round": 3, "wall_s": wall,
                      "top": top})
    finally:
        if args.keep:
            emit({"event": "kept", "dir": work})
        else:
            shutil.rmtree(work, ignore_errors=True)
    return records


if __name__ == "__main__":
    main()
