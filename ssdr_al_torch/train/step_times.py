"""Median wall time of warm train steps on the card, per training path,
eager against CUDA-graph replays.

    python3 ssdr_al_torch/train/step_times.py [--tree DIR] [--out PATH]
        [--extract-sweep | --eval-steps | --dtype bfloat16 | --gcn-fit |
         --greedy-loops | --eager]

Paths, each on a fresh Trainer (`window` engine, random weights) over
synthetic rooms (seed 0):
- host: ConfigS3DIS width [6 × 40960] on 8 batches the host
  TrainingPipeline sampled beforehand, cycled; the step's upload counts.
- pool: the same width on a DeviceTrainPool: the host's draw of cloud ids
  and picks, their upload, extraction on the card and the step.
- possibility: ConfigSemantic3D width [4 × 65536] on a
  PossibilityDevicePool, the field threaded through the steps.
- pool_bf16: the pool path with --compute_dtype bfloat16.
Each path's eager step (Trainer.train_step, pooled_step,
possibility_step) and its graph step (trainer.make_static_step replayed
by a train/graphs.py::StepGraph, its warm-up steps and capture run
first, untimed) are timed in turns of 5 (in_turns): each step by the
host clock from its call to the torch.cuda.synchronize() after it, 3
warm-up steps first; the median and the range of 20 steps. For each
mode: the device-busy share of a step under torch.profiler (busy_share:
the union of its kernels' intervals over the profiled wall, 3 steps),
the device kernels and the host's launch calls a step, the six kernel
names of most device time; the graph's
capture time, its pool's bytes and its kernels' launches a replay; for
the path, the K4 launches a step, the caching allocator's device
allocations (cudaMalloc) during the timed steps and the peak device
memory. The extraction alone (extract_blocks at the batch's and at the
pool's static window, possibility_extract) and the sort inside it
(torch.sort of the largest cloud's d²) are timed by CUDA events.
Then one pooled round ([6 × 40960], 2 epochs × 25 steps, no
evaluation) through Trainer.train_round with the graphs and eagerly
(eager_round), in turns, its wall-clock and peak memory (round_walls).

`--tree DIR` measures the ssdr_al_torch package under DIR (for example a
`git archive` of another commit); a tree without the graphs measures the
eager steps only. `--eager` measures only each path's eager step, and,
where the trainer's Adam is capturable, the same step on Adam's plain
form (a float rate) in turns with it, each with its busy share; then the
data-parallel step [6 × 40960] on one rank and on two gloo ranks sharing
the card (dp_step_times). Run it on two trees in alternate processes to
compare their eager and dp steps. `--extract-sweep` measures only the extraction at
ConfigSemantic3D width (B=4 blocks of 65536 points) on one synthetic
cloud of each size in EXTRACT_SWEEP_POINTS (uniform in 200 × 200 × 20 m,
made on the card): extract_blocks and possibility_extract by CUDA events,
the torch.sort inside each, and the peak device memory each takes beyond
its inputs, per block row (the pool's memory gate counts
EXTRACT_BYTES_PER_ROW). `--eval-steps` measures only eval steps
(`make_eval_step`, sorted_outputs=False) at ConfigS3DIS width [8 × 40960]
on the exact engine (`pallas`, K6), on `approx` (served by the same
search), on `window` (K1) and on `window` with K5
(`MXU_DISTANCE_DEFAULT`), in float32 and bfloat16, random weights
(`init_params`, seed 0) on one random batch: the eager step (its numpy
batch staged through pinned buffers) and the same step as replayed CUDA
graphs in turns (in_turns: each call by the host clock to a synchronize,
the median and the range of 20 calls after 3 warm-up calls, the capture
among them), each with its busy share, kernels and host launches a
call, and the graph's capture time and pool bytes; then the selection's
prediction (TSampler.prediction) on the smoke's S3DIS rooms, eager
against graph in turns (prediction_times). A tree without the eval
graphs measures its eager steps only. `--dtype bfloat16` measures only
--compute_dtype bfloat16 beside float32: the pooled train step [6 × 40960]
(al_loop's default path) and the `window` eval step [8 × 40960], each
dtype on its own Trainer / model from the same random weights, the two
dtypes in turns of 5 steps after 3 warm-up steps each, 20 timed steps a
dtype (median and range as above); then, for each, the device time of
its kernels a step under torch.profiler (kernels/measure.py::
device_breakdown, 3 steps): their sum, the launches a step and the six
largest kernels. `--gcn-fit` measures only the coreGCN fit
(active/gcn.py) on gcn_fit_inputs at [4, S, 32] blocks, S = 512, 1024
and 2048: the s a step of GCN_FIT_STEPS steps by the host clock to a
synchronize, as fit_gcn runs them (one captured step replayed), as
graphs of GCN_GRAPH_SIZES steps, and eagerly (fit_steps' step in a
loop), each twice in turns. `--greedy-loops` measures only the greedy
selection loops (ops/fps.py, ops/kcenter.py: greedy_loop_times), eager
against replayed graphs at the at-scale round's lengths and at an edcd
cloud's short lengths, which set ops/fps.py::MIN_REPLAYS. Prints one
line per path and, as its
last line, the results as JSON (also written to PATH). chip_smoke.py runs
`measure` and `in_turns`.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

S3DIS_ROOMS, S3DIS_ROOM_POINTS = 4, 150_000
S3D_CLOUDS, S3D_CLOUD_POINTS = 3, 300_000
EXTRACT_SWEEP_POINTS = (1 << 20, 1 << 22, 1 << 24, 1 << 26)
GCN_FIT_SLOTS, GCN_FIT_STEPS = (512, 1024, 2048), 2000
GCN_GRAPH_SIZES = (10, 50, 250)


def timed_steps(step, steps, warmup):
    """{median_ms, min_ms, max_ms, steps} of step(i) for i past warmup,
    each to a synchronize."""
    times = []
    for i in range(warmup + steps):
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(1e3 * (time.perf_counter() - t0))
    return dict(median_ms=statistics.median(times), min_ms=min(times),
                max_ms=max(times), steps=steps)


def in_turns(steps_by_name, steps, warmup, turn=5):
    """timed_steps of several step(i) functions in turns of `turn` steps
    (each warmed up first), so that a slow drift of the card or the host
    falls on all of them alike; {name: {median_ms, min_ms, max_ms,
    steps}}."""
    times = {name: [] for name in steps_by_name}
    for name, step in steps_by_name.items():
        for i in range(warmup):
            step(i)
        torch.cuda.synchronize()
    i = warmup
    while any(len(v) < steps for v in times.values()):
        for name, step in steps_by_name.items():
            for _ in range(min(turn, steps - len(times[name]))):
                t0 = time.perf_counter()
                step(i)
                torch.cuda.synchronize()
                times[name].append(1e3 * (time.perf_counter() - t0))
                i += 1
    return {name: dict(median_ms=statistics.median(v), min_ms=min(v),
                       max_ms=max(v), steps=len(v))
            for name, v in times.items()}


def event_ms(fn, reps):
    """Mean device time of fn() in ms by CUDA events, after a warm-up."""
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


def _trainer(cfg, dev, name, work):
    from ssdr_al_torch.train.trainer import Trainer

    trainer = Trainer(cfg, name, save_dir=work, device=dev)
    trainer.init_state()
    return trainer


def busy_share(fn, reps=3):
    """fn() `reps` times under torch.profiler (CPU and CUDA), each to a
    synchronize: {wall_ms a call profiled, busy_ms (the union of the
    device kernels' intervals) a call, busy_share, kernels (device
    kernels a call), host_launches (kernel and graph launch calls from the
    host a call), top_ms (the 6 kernel names of most device ms a call,
    names cut to 90 characters)}."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps
    return profile_summary(prof, wall, reps)


def profile_summary(prof, wall, reps=1):
    """busy_share's dict of a finished torch.profiler run over `reps`
    calls of `wall` s each (host clock, to a synchronize)."""
    spans, launches, by_name = [], 0, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            name = e.name[:90]
            by_name[name] = by_name.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / reps
        elif e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                        "cudaLaunchKernelExC", "cuLaunchKernelEx",
                        "cudaGraphLaunch"):
            launches += 1
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    busy_ms = busy / 1e3 / reps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(wall_ms=1e3 * wall, busy_ms=busy_ms,
                busy_share=busy_ms / (1e3 * wall), kernels=len(spans) / reps,
                host_launches=launches / reps, top_ms=dict(top))


WARM_PATHS = ("host", "pool", "possibility", "pool_bf16")


def _path_steps(path, dev, work, rooms, clouds, steps, warmup, graph=True):
    """(label, trainer, pool, eager, {"eager": step(i), "graph": step(i)
    or absent}, graph) of a warm-step path: eager(train_state) → step(i)
    is the path's eager step (Trainer.train_step / pooled_step /
    possibility_step) on a train state, "eager" it on the trainer's; the
    graph step the path's make_static_step through a StepGraph, captured
    here (its warm-up and capture untimed), unless graph=False."""
    import dataclasses

    from ssdr_al_torch import config
    from ssdr_al_torch.data.dataset import TrainingPipeline
    from ssdr_al_torch.train import device_pool as dp
    from ssdr_al_torch.train import possibility_pool as pp

    kind = "pool" if path == "pool_bf16" else path
    base = config.ConfigSemantic3D if kind == "possibility" \
        else config.ConfigS3DIS
    cfg = dataclasses.replace(base, train_steps=steps, compute_dtype=(
        "bfloat16" if path == "pool_bf16" else "float32"))
    trainer = _trainer(cfg, dev, "Semantic3D" if kind == "possibility"
                       else "S3DIS", work)
    ts, b = trainer.train_state, cfg.batch_size
    pool = None
    if kind == "host":
        pipe = TrainingPipeline(rooms, cfg, seed=1)
        batches = [pipe.sample_batch(b) for _ in range(8)]

        def draw(i):
            return batches[i % len(batches)]

        def eager(st):
            return lambda i: trainer.train_step(st, draw(i),
                                                trainer.dropout_gen)
    elif kind == "pool":
        pool = dp.DeviceTrainPool(rooms, cfg, seed=1, device=dev)
        if not pool.available:
            raise AssertionError("the S3DIS pool is over its memory gate")

        def draw(i):
            return dict(zip(("cloud_ids", "picks"), pool.sample_indices(b)))

        def eager(st):
            return lambda i: trainer.pooled_step(
                st, pool, *draw(i).values(), trainer.dropout_gen)
    else:
        pool = pp.PossibilityDevicePool(clouds, cfg, seed=1, device=dev)
        if not pool.available:
            raise AssertionError("the Semantic3D pool is over its memory "
                                 "gate")
        field = {"poss": pool.init_possibility}
        draw = None

        def eager(st):
            def poss_step(i):
                _, field["poss"], _ = trainer.possibility_step(
                    st, pool, field["poss"], trainer.dropout_gen)
            return poss_step

    fns = {"eager": eager(ts)}
    label = f"[{b}x{cfg.num_points}] {cfg.compute_dtype}"
    try:
        from ssdr_al_torch.train.graphs import GRAPH_WARMUP, StepGraph
        from ssdr_al_torch.train.trainer import make_static_step, set_lr
    except ImportError:
        graph = False                           # a tree without graphs
    if not graph:
        return label, trainer, pool, eager, fns, None
    inputs, step = make_static_step(trainer.model, cfg, trainer.weights,
                                    "window", kind, pool=pool, device=dev)
    graph = StepGraph(lambda: step(ts, trainer.dropout_gen),
                      [trainer.dropout_gen] + ([] if pool is None
                                               else [pool.generator]), dev)
    if kind == "possibility":
        pool.field.copy_(pool.init_possibility)

    def graph_step(i):
        if inputs is not None:
            inputs.stage(draw(i))
        set_lr(ts)
        graph()
        ts.step += 1

    for i in range(GRAPH_WARMUP + 1):
        graph_step(i)
    torch.cuda.synchronize(dev)
    fns["graph"] = graph_step
    return label, trainer, pool, eager, fns, graph


def measure(dev, steps=20, warmup=3, work="build/step_times", log=print):
    """The warm-step medians of every path the tree has (module
    docstring), the eager step and the graph step in turns; returns
    {path: {...}}."""
    from ssdr_al_torch.data.synthetic import make_dataset
    from ssdr_al_torch.ops import gather as ga
    from ssdr_al_torch.train import device_pool as dp
    from ssdr_al_torch.train import possibility_pool as pp

    torch.cuda.init()       # the allocator's statistics need it
    rooms, _ = make_dataset(num_train=S3DIS_ROOMS, num_val=0,
                            num_points=S3DIS_ROOM_POINTS, seed=0, hard=True)
    clouds = None
    out = {}
    for path in WARM_PATHS:
        if path == "possibility" and clouds is None:
            clouds, _ = make_dataset(num_train=S3D_CLOUDS, num_val=0,
                                     num_points=S3D_CLOUD_POINTS, seed=0,
                                     hard=True)
        torch.cuda.reset_peak_memory_stats(dev)
        label, trainer, pool, _, fns, graph = _path_steps(
            path, dev, work, rooms, clouds, steps, warmup)
        k4 = ga.scatter_window.launches + ga.scatter_window.launches_bf16
        segs = torch.cuda.memory_stats(dev).get("segment.all.allocated", 0)
        r = in_turns(fns, steps, warmup)
        r["k4_launches_per_step"] = (ga.scatter_window.launches
                                     + ga.scatter_window.launches_bf16
                                     - k4) / (len(fns) * (warmup + steps))
        r["cuda_mallocs"] = torch.cuda.memory_stats(dev).get(
            "segment.all.allocated", 0) - segs
        for name, fn in fns.items():
            r[name].update(busy_share(lambda: fn(0)))
        if graph is not None:
            r["graph"].update(graph.stats())
        r["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        if path == "pool":
            ids, picks = pool.sample_indices(trainer.cfg.batch_size)
            pick_t = torch.from_numpy(picks).to(dev)
            d2 = dp.block_d2(pool.xyz[:pool.window].expand(
                len(ids), -1, -1), pick_t[:, None])
            r.update(
                extract_ms=event_ms(lambda: pool.extract(ids, picks), 10),
                extract_static_ms=event_ms(lambda: pool.extract(
                    ids, picks, None, pool.window), 10),
                sort_ms=event_ms(lambda: torch.sort(d2, dim=1, stable=True),
                                 10),
                sort_shape=list(d2.shape), window=pool.window)
            del d2
        elif path == "possibility":
            cfg = trainer.cfg
            d2 = dp.block_d2(pool.xyz[:pool.window], pool.xyz[:1])
            r.update(
                extract_ms=event_ms(lambda: pp.possibility_extract(
                    *pool.device_args(), pool.class_weight,
                    pool.init_possibility, pool.generator, cfg.batch_size,
                    cfg.num_points, cfg.noise_init / 10, pool.window,
                    pool.augment), 5),
                sort_ms=event_ms(lambda: torch.sort(d2, stable=True), 10),
                sort_shape=list(d2.shape))
            del d2
        out[path] = r
        log(f"{path} step {label}, eager and graph in turns: "
            + json.dumps(r))
        del trainer, pool, fns, graph
        torch.cuda.empty_cache()
    return out


def dp_step_times(dev, rooms, work, reps=10):
    """Host ms of `reps` warm train steps [6 x 40960] (ConfigS3DIS, init
    weights of seed 0, dropout off, one batch of the host pipeline) by
    parallel/dryrun.py::train_step_times: on one rank in this process and
    on two gloo ranks sharing the card (rank 0's times); {"one_rank",
    "two_ranks": {median_ms, min_ms, max_ms, steps}}."""
    from ssdr_al_torch import config
    from ssdr_al_torch.data.dataset import TrainingPipeline
    from ssdr_al_torch.models.randlanet import init_params
    from ssdr_al_torch.parallel import dryrun, launch

    cfg = config.ConfigS3DIS
    case = dict(cfg=cfg, weights=config.class_weights("S3DIS"),
                batch=TrainingPipeline(rooms, cfg, seed=11).sample_batch(
                    cfg.batch_size),
                state=init_params(cfg, torch.Generator().manual_seed(0)),
                reps=reps)

    def summary(v):
        return dict(median_ms=statistics.median(v), min_ms=min(v),
                    max_ms=max(v), steps=len(v))

    one = dryrun.train_step_times(None, device=dev, **case)
    ranks = launch(dryrun.run_calls, 2, [dev, dev],
                   os.path.join(work, "dp_runs"),
                   [(dryrun.train_step_times, case)])
    return {"one_rank": summary(one), "two_ranks": summary(ranks[0][0][0])}


def eager_steps(dev, steps=20, warmup=3, work="build/step_times",
                log=print):
    """The `--eager` readings (module docstring): {path: {"eager": {...},
    "eager_plain": {...} where the trainer's Adam is capturable}, "dp":
    dp_step_times}."""
    from ssdr_al_torch.data.synthetic import make_dataset
    from ssdr_al_torch.train.trainer import create_train_state

    torch.cuda.init()
    rooms, _ = make_dataset(num_train=S3DIS_ROOMS, num_val=0,
                            num_points=S3DIS_ROOM_POINTS, seed=0, hard=True)
    clouds = None
    out = {}
    for path in WARM_PATHS:
        if path == "possibility" and clouds is None:
            clouds, _ = make_dataset(num_train=S3D_CLOUDS, num_val=0,
                                     num_points=S3D_CLOUD_POINTS, seed=0,
                                     hard=True)
        label, trainer, pool, eager, fns, _ = _path_steps(
            path, dev, work, rooms, clouds, steps, warmup, graph=False)
        if trainer.train_state.optimizer.defaults["capturable"]:
            fns["eager_plain"] = eager(create_train_state(
                trainer.model, trainer.cfg, trainer.steps_per_epoch))
        r = in_turns(fns, steps, warmup)
        for name, fn in fns.items():
            r[name].update(busy_share(lambda: fn(0)))
        out[path] = r
        log(f"{path} step {label}, eager: " + json.dumps(r))
        del trainer, pool, eager, fns
        torch.cuda.empty_cache()
    out["dp"] = dp_step_times(dev, rooms, work)
    log("dp step [6x40960]: " + json.dumps(out["dp"]))
    return out


def eager_round(trainer, pool, round_num):
    """Trainer.train_round's pooled round without evaluation, its steps
    make_static_step's run eagerly: a fresh Adam, each epoch's steps and
    mean loss read back, the snapshot saved."""
    from ssdr_al_torch.train import trainer as tr

    cfg = trainer.cfg
    state = trainer.train_state = tr.reset_optimizer(
        trainer.train_state, cfg, trainer.steps_per_epoch)
    inputs, step = tr.make_static_step(
        trainer.model, cfg, trainer.weights, trainer.knn_engine, "pool",
        pool=pool, device=trainer.device)
    for _ in range(cfg.max_epoch):
        losses = []
        for _ in range(trainer.steps_per_epoch):
            inputs.stage(dict(zip(tr.POOL_INPUTS,
                                  pool.sample_indices(cfg.batch_size))))
            losses.append(tr._advance(state, lambda: step(
                state, trainer.dropout_gen))["loss"].clone())
        float(torch.stack(losses).mean())
    trainer._save(trainer.snapshot_path(round_num))


def round_walls(dev, epochs=2, steps=25, work="build/step_times", log=print):
    """One pooled round's training wall-clock ([6 x 40960], `epochs` x
    `steps` steps, no evaluation) through the graphs (Trainer.train_round)
    and eagerly (eager_round), in turns graph, eager, eager, graph, each
    to a synchronize, with its peak device memory; returns {"graph":
    [{wall_s, peak_bytes, ...graph_stats}], "eager": [...]}."""
    import dataclasses

    from ssdr_al_torch import config
    from ssdr_al_torch.data.synthetic import make_dataset
    from ssdr_al_torch.train.device_pool import DeviceTrainPool

    cfg = dataclasses.replace(config.ConfigS3DIS, max_epoch=epochs,
                              train_steps=steps)
    rooms, _ = make_dataset(num_train=S3DIS_ROOMS, num_val=0,
                            num_points=S3DIS_ROOM_POINTS, seed=0, hard=True)
    trainer = _trainer(cfg, dev, "S3DIS", work)
    trainer.log = lambda m: None
    pool = DeviceTrainPool(rooms, cfg, seed=1, device=dev)
    out = {"graph": [], "eager": []}
    for n, kind in enumerate(("graph", "eager", "eager", "graph")):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        if kind == "graph":
            trainer.train_round(n + 1, None, device_pool=pool)
        else:
            eager_round(trainer, pool, n + 1)
        torch.cuda.synchronize(dev)
        r = dict(wall_s=time.perf_counter() - t0,
                 peak_bytes=torch.cuda.max_memory_allocated(dev))
        if kind == "graph":
            r.update(trainer.graph_stats)
        out[kind].append(r)
    log(f"pooled round [{cfg.batch_size}x{cfg.num_points}], {epochs} x "
        f"{steps} steps, graph and eager in turns: " + json.dumps(out))
    return out


EVAL_ENGINES = (("pallas", "pallas", False), ("approx", "approx", False),
                ("window", "window", False), ("window_k5", "window", True))
# the selection's forward on the smoke's S3DIS workload: grid superpoints
# a room, and the TSampler round's arguments
PREDICTION_SP, PREDICTION_RUNS = 2048, 5
SSDR_ARGS = ["t0", "sb", "clsbal", "gcn_fps", "WetSU", "NAIL", "0.9", "1",
             "1", "0"]


def eval_modes(model, cfg, engine, dev, sorted_outputs=False):
    """{"eager": make_eval_step's eval step run eagerly, "graph": the
    same as replayed CUDA graphs}, or only "eager" on a tree without the
    eval graphs."""
    from ssdr_al_torch.train.trainer import make_eval_step

    try:
        eager = make_eval_step(model, cfg, engine, sorted_outputs,
                               device=dev, eager=True)
    except TypeError:                     # a tree without the eval graphs
        return {"eager": make_eval_step(model, cfg, engine, sorted_outputs,
                                        device=dev)}
    return {"eager": eager, "graph": make_eval_step(
        model, cfg, engine, sorted_outputs, device=dev)}


def eval_steps(dev, steps=20, warmup=3, work="build/step_times", log=print):
    """The `--eval-steps` readings (module docstring): {"<engine>
    <dtype>": {"eager": {...}, "graph": {...}, "peak_bytes"},
    "prediction": prediction_times}."""
    import dataclasses

    import numpy as np

    from ssdr_al_torch import config
    from ssdr_al_torch.models.randlanet import RandLANet, init_params
    from ssdr_al_torch.ops import knn as kn

    n = config.ConfigS3DIS.num_points
    rng = np.random.RandomState(0)
    xyz = (rng.rand(8, n, 3) * 6).astype(np.float32)
    batch = {"xyz": xyz, "features": np.concatenate(
        [xyz, rng.rand(8, n, 3).astype(np.float32)], -1)}
    state = {k: v.to(dev) for k, v in init_params(
        config.ConfigS3DIS, torch.Generator().manual_seed(0)).items()}
    out = {}
    for dt in DTYPES:
        cfg = dataclasses.replace(config.ConfigS3DIS, compute_dtype=dt)
        model = RandLANet(cfg).to(dev)
        for name, engine, mxu in EVAL_ENGINES:
            torch.cuda.reset_peak_memory_stats(dev)
            steps_by_mode = eval_modes(model, cfg, engine, dev)
            calls = {m: (lambda i, f=f: f(state, batch))
                     for m, f in steps_by_mode.items()}
            kn.MXU_DISTANCE_DEFAULT = mxu
            try:
                r = in_turns(calls, steps, warmup)
                for m, f in calls.items():
                    r[m].update(busy_share(lambda: f(0)))
            finally:
                kn.MXU_DISTANCE_DEFAULT = False
            if "graph" in steps_by_mode:
                r["graph"].update(steps_by_mode["graph"].stats())
            r["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            out[f"{name} {dt}"] = r
            log(f"eval step {name} {dt} [8x{n}], eager and graph in turns: "
                + json.dumps(r))
            del steps_by_mode, calls
            torch.cuda.empty_cache()
    out["prediction"] = prediction_times(dev, work, log=log)
    return out


def prediction_times(dev, work="build/step_times", runs=PREDICTION_RUNS,
                     log=print):
    """TSampler.prediction (the selection's forward over every training
    room, its per-point reductions and region scores) at ConfigS3DIS on
    the smoke's S3DIS workload (S3DIS_ROOMS hard rooms of
    S3DIS_ROOM_POINTS points, PREDICTION_SP grid superpoints a room, the
    seed round's registry), init weights of seed 0, `window` engine: with
    the eval step run eagerly and as graphs (eval_modes), in turns after
    one untimed prediction each, `runs` each by the host clock to a
    synchronize, then the device-busy share of one each (busy_share);
    {mode: {median_s, min_s, max_s, runs, ...busy_share}}."""
    import shutil

    from ssdr_al_torch import config
    from ssdr_al_torch.active.samplers import (
        SeedSampler,
        TSampler,
        TSamplerArgs,
    )
    from ssdr_al_torch.active.state import ALState, RoundStats
    from ssdr_al_torch.cli.common import write_grid_superpoints
    from ssdr_al_torch.data.synthetic import make_dataset
    from ssdr_al_torch.models.randlanet import RandLANet, init_params

    cfg = config.ConfigS3DIS
    root = os.path.join(work, "prediction")
    shutil.rmtree(root, ignore_errors=True)
    rooms, _ = make_dataset(num_train=S3DIS_ROOMS, num_val=0,
                            num_points=S3DIS_ROOM_POINTS, seed=0, hard=True)
    total = write_grid_superpoints(ALState(root, []), rooms, PREDICTION_SP)
    seed_state = ALState(root, ["seed"])
    SeedSampler(seed_state, rooms, total["sp_num"]).sampling(
        total["sp_num"] // 20, 0, RoundStats())
    registry = seed_state.load_registry(seed_state.round_dir(1))
    sampler = TSampler(ALState(root, SSDR_ARGS), rooms, cfg, TSamplerArgs(),
                       total["sp_num"], device=dev)
    state = {k: v.to(dev) for k, v in init_params(
        cfg, torch.Generator().manual_seed(0)).items()}
    steps_by_mode = eval_modes(RandLANet(cfg).to(dev), cfg, "window", dev,
                               sorted_outputs=True)

    def predict(step):
        sampler.prediction(step, state, registry, 2, RoundStats())

    times = {m: [] for m in steps_by_mode}
    for m, step in steps_by_mode.items():
        predict(step)
    for _ in range(runs):
        for m, step in steps_by_mode.items():
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            predict(step)
            torch.cuda.synchronize(dev)
            times[m].append(time.perf_counter() - t0)
    out = {}
    for m, v in times.items():
        out[m] = dict(median_s=statistics.median(v), min_s=min(v),
                      max_s=max(v), runs=len(v))
        out[m].update(busy_share(lambda: predict(steps_by_mode[m]), reps=1))
    if "graph" in steps_by_mode:
        out["graph"].update(steps_by_mode["graph"].stats())
    log(f"selection prediction on {S3DIS_ROOMS} rooms x {S3DIS_ROOM_POINTS} "
        f"points ({total['sp_num']} superpoints), eager and graph in turns: "
        + json.dumps(out))
    shutil.rmtree(root, ignore_errors=True)
    return out


DTYPES = ("float32", "bfloat16")


def dtype_steps(dev, steps=20, warmup=3, work="build/step_times",
                log=print):
    """The `--dtype bfloat16` readings (module docstring): {"train":
    {dtype: {...}}, "eval": {dtype: {...}}}."""
    import dataclasses

    import numpy as np

    from ssdr_al_torch import config
    from ssdr_al_torch.data.synthetic import make_dataset
    from ssdr_al_torch.models.randlanet import RandLANet, init_params
    from ssdr_al_torch.train.device_pool import DeviceTrainPool
    from ssdr_al_torch.train.trainer import make_eval_step

    cfgs = {dt: dataclasses.replace(config.ConfigS3DIS, train_steps=steps,
                                    compute_dtype=dt) for dt in DTYPES}
    rooms, _ = make_dataset(num_train=S3DIS_ROOMS, num_val=0,
                            num_points=S3DIS_ROOM_POINTS, seed=0, hard=True)
    pool = DeviceTrainPool(rooms, cfgs["float32"], seed=1, device=dev)
    if not pool.available:
        raise AssertionError("the S3DIS pool is over its memory gate")
    trainers = {dt: _trainer(c, dev, "S3DIS", work) for dt, c in cfgs.items()}
    b = cfgs["float32"].batch_size

    def train(tr):
        return lambda i: tr.pooled_step(tr.train_state, pool,
                                        *pool.sample_indices(b),
                                        tr.dropout_gen)

    from ssdr_al_torch.kernels.measure import device_breakdown

    def kernels(step):
        parts, launches = device_breakdown(lambda: step(0), reps=3)
        return dict(device_ms=sum(parts.values()), launches=launches,
                    top_ms={k[:60]: round(v, 4)
                            for k, v in list(parts.items())[:6]})

    fns = {dt: train(tr) for dt, tr in trainers.items()}
    out = {"train": in_turns(fns, steps, warmup)}
    for dt, f in fns.items():
        out["train"][dt].update(kernels(f))
    log(f"pooled train step [{b}x{cfgs['float32'].num_points}] in turns: "
        + json.dumps(out["train"]))
    del trainers, pool
    n = cfgs["float32"].num_points
    rng = np.random.RandomState(0)
    xyz = (rng.rand(8, n, 3) * 6).astype(np.float32)
    batch = {"xyz": xyz, "features": np.concatenate(
        [xyz, rng.rand(8, n, 3).astype(np.float32)], -1)}
    state = {k: v.to(dev) for k, v in init_params(
        cfgs["float32"], torch.Generator().manual_seed(0)).items()}
    evals = {dt: make_eval_step(RandLANet(c).to(dev), c, "window", False,
                                device=dev) for dt, c in cfgs.items()}
    fns = {dt: (lambda i, f=f: f(state, batch)) for dt, f in evals.items()}
    out["eval"] = in_turns(fns, steps, warmup)
    for dt, f in fns.items():
        out["eval"][dt].update(kernels(f))
    log(f"window eval step [8x{n}] in turns: " + json.dumps(out["eval"]))
    return out


def peak_bytes(fn, dev):
    """Peak device memory fn() allocates beyond what was allocated
    before it."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    fn()
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev) - base


def extraction_sweep(dev, sizes=EXTRACT_SWEEP_POINTS, log=print):
    """extract_blocks and possibility_extract at ConfigSemantic3D width on
    one synthetic cloud of each size (module docstring); returns
    [{points, ...}]."""
    from ssdr_al_torch import config
    from ssdr_al_torch.train import device_pool as dp
    from ssdr_al_torch.train import possibility_pool as pp

    cfg = config.ConfigSemantic3D
    b, k = cfg.batch_size, cfg.num_points
    gen = torch.Generator(dev).manual_seed(0)
    out = []
    for n in sizes:
        xyz = torch.rand((n, 3), generator=gen, device=dev) * torch.tensor(
            [200.0, 200.0, 20.0], device=dev)
        planes = torch.rand((n, 6), generator=gen, device=dev)
        planes[:, 3] = torch.randint(0, cfg.num_classes, (n,), generator=gen,
                                     device=dev).float()
        offsets = torch.zeros(1, dtype=torch.long, device=dev)
        sizes_t = torch.full((1,), n, dtype=torch.long, device=dev)
        ids = torch.zeros(b, dtype=torch.long, device=dev)
        picks = xyz[torch.randint(0, n, (b,), generator=gen, device=dev)]
        row_of = torch.zeros(n, dtype=torch.long, device=dev)
        weight = torch.full((cfg.num_classes,), 1.0 / cfg.num_classes,
                            device=dev)
        poss = torch.rand(n, generator=gen, device=dev) * 1e-3

        def blocks():
            return dp.extract_blocks(xyz, planes, offsets, sizes_t, ids,
                                     picks, k, n, gen)

        def chain():
            return pp.possibility_extract(
                xyz, planes, offsets, sizes_t, row_of, weight, poss, gen, b,
                k, cfg.noise_init / 10, n)

        d2 = dp.block_d2(xyz.expand(b, -1, -1), picks[:, None])
        r = dict(points=n,
                 extract_ms=event_ms(blocks, 5),
                 extract_sort_ms=event_ms(
                     lambda: torch.sort(d2, dim=1, stable=True), 5),
                 possibility_ms=event_ms(chain, 3),
                 possibility_sort_ms=event_ms(
                     lambda: torch.sort(d2[0], stable=True), 5))
        del d2
        r["extract_bytes_per_row"] = peak_bytes(blocks, dev) / (b * n)
        r["possibility_bytes_per_row"] = peak_bytes(chain, dev) / n
        log(f"extraction at one {n}-point cloud [{b} x {k}]: "
            + json.dumps(r))
        out.append(r)
        del xyz, planes, row_of, poss
        torch.cuda.empty_cache()
    return out


def gcn_fit_inputs(device, blocks: int, slots: int, nfeat: int,
                   seed: int = 0):
    """(params, adj, vhat, mask, labeled) of a coreGCN fit on `blocks`
    blocks of `slots` regions with random features of width nfeat,
    symmetric ED + CD in [0, 4), 90 % of the slots valid and 20 % labeled
    (numpy draws from `seed`); the port's initial weights from `seed`."""
    import numpy as np

    from ssdr_al_torch.active import gcn

    rng = np.random.RandomState(seed)
    mask = torch.from_numpy(rng.rand(blocks, slots) < 0.9).to(device)
    ed_cd = torch.from_numpy(rng.rand(blocks, slots, slots).astype(
        np.float32) * 4).to(device)
    feats = torch.from_numpy(rng.randn(blocks, slots, nfeat).astype(
        np.float32)).to(device)
    adj, vhat = gcn._latent_adjacency((ed_cd + ed_cd.transpose(1, 2)) / 2,
                                      mask, feats)
    labeled = torch.from_numpy((rng.rand(blocks, slots) < 0.2).astype(
        np.float32)).to(device)
    params = gcn._init_gcn_params(torch.Generator().manual_seed(seed),
                                  nfeat, device)
    return params, adj, vhat, mask, labeled


def gcn_fit_times(dev, slots=GCN_FIT_SLOTS, num_steps=GCN_FIT_STEPS,
                  sizes=GCN_GRAPH_SIZES, blocks=4, nfeat=32, log=print):
    """{"[blocks, S, nfeat]": {"fit" | "graph_<n>" | "eager": [s a step,
    s a step]}}: the fit as fit_gcn runs it, graphs of n steps
    (graphs.capture_steps, (num_steps − GRAPH_WARMUP) // n replays after the
    warm-up steps) and the eager steps, each from fresh weights with
    dropout on, twice in turns."""
    from ssdr_al_torch.active import gcn
    from ssdr_al_torch.train import graphs

    def run(kind, inputs):
        params, adj, vhat, mask, labeled = inputs
        drop = torch.Generator(dev).manual_seed(0)
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params.items()}
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if kind == "fit":
            gcn.fit_gcn(params, adj, vhat, mask, labeled,
                        num_steps=num_steps, dropout_gen=drop)
            done = num_steps
        else:
            step, _ = gcn.fit_steps(params, adj, vhat, mask, labeled,
                                    num_steps=num_steps, dropout_gen=drop)
            if kind == "eager":
                for _ in range(num_steps):
                    step()
                done = num_steps
            else:
                n = int(kind.split("_")[1])
                graph = graphs.capture_steps(step, n, graphs.GRAPH_WARMUP,
                                             [drop], dev)
                replays = (num_steps - graphs.GRAPH_WARMUP) // n
                for _ in range(replays):
                    graph.replay()
                done = graphs.GRAPH_WARMUP + replays * n
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) / done

    kinds = ["fit"] + [f"graph_{n}" for n in sizes] + ["eager"]
    out = {}
    for s in slots:
        inputs = gcn_fit_inputs(dev, blocks, s, nfeat)
        res = {}
        for kind in kinds + kinds[::-1]:
            res.setdefault(kind, []).append(run(kind, inputs))
        out[f"[{blocks}, {s}, {nfeat}]"] = res
        log(f"gcn fit [{blocks}, {s}, {nfeat}] s a step: {res}")
    return out


def greedy_loop(kind, dev, rows, seed=0):
    """loop(n, eager) → picks: one of the greedy selection loops
    (farthest_feature_sample [rows, 32]; farthest_superpoint_sample [rows,
    3] with a [rows, rows] chamfer; kcenter_greedy [rows, 129] with a
    twentieth of the rows labeled) on inputs made from `seed`, n steps
    through train/graphs.py::run_steps with no replay threshold: eagerly
    or as GRAPH_WARMUP eager steps, a capture and replays."""
    import numpy as np

    from ssdr_al_torch.device import full_f32_matmul
    from ssdr_al_torch.ops import fps, kcenter
    from ssdr_al_torch.train.graphs import run_steps

    rng = np.random.RandomState(seed)

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    if kind == "farthest_feature_sample":
        feats = up(rng.randn(rows, 32).astype(np.float32))

        def make(n):
            return fps.farthest_feature_steps(feats, 0, n + 1)
    elif kind == "farthest_superpoint_sample":
        cents = up((rng.rand(rows, 3) * 6).astype(np.float32))
        cd = up(rng.rand(rows, rows).astype(np.float32))

        def make(n):
            return fps.farthest_superpoint_steps(cents, cd, 0, n + 1)
    else:
        feats = up(rng.randn(rows, 129).astype(np.float32))
        mask = up(rng.rand(rows) < 0.05)

        def make(n):
            return kcenter.kcenter_steps(feats, mask, n)

    def loop(n, eager):
        step, sel = make(n)
        with full_f32_matmul():
            run_steps(step, n, dev, eager=eager, name=kind)
        return sel

    return loop


GREEDY_KINDS = ("farthest_feature_sample", "farthest_superpoint_sample",
                "kcenter_greedy")
# --greedy-loops: the at-scale round's loops (scripts/profile_selection.py
# at 200 clouds and 10 000 clicks: ~20 000 candidates, 10 000 picks), and
# short loops over an edcd candidate cloud's superpoints
GREEDY_ROWS, GREEDY_STEPS = 20_000, 10_000
GREEDY_SHORT_ROWS, GREEDY_SHORT_STEPS = 128, (8, 16, 32, 64, 128, 256)


def greedy_loop_times(dev, reps=5, log=print):
    """{kind: {"[rows] x steps": {eager_ms, graph_ms (medians of `reps`
    calls each, in turns, by the host clock to a synchronize; the graph's
    warm-up steps and capture included), equal (the graph's picks bitwise
    the eager loop's), capture_s, capture_bytes, launches}}}: each greedy
    loop at GREEDY_ROWS rows and GREEDY_STEPS steps and at
    GREEDY_SHORT_ROWS rows and GREEDY_SHORT_STEPS steps, then a loop of
    1000 steps of each under torch.profiler eagerly and as a graph
    (busy_share: kernels and host launches a step)."""
    from ssdr_al_torch.train import graphs

    out = {}
    for kind in GREEDY_KINDS:
        res = out[kind] = {}
        big = greedy_loop(kind, dev, GREEDY_ROWS)
        small = greedy_loop(kind, dev, GREEDY_SHORT_ROWS)
        cases = [(GREEDY_ROWS, GREEDY_STEPS, big)] + [
            (GREEDY_SHORT_ROWS, n, small) for n in GREEDY_SHORT_STEPS
            if kind != "kcenter_greedy"]
        for rows, n, loop in cases:
            times = {"eager": [], "graph": []}
            picks = {}
            for _ in range(reps):
                for mode in times:
                    torch.cuda.synchronize(dev)
                    with graphs.record_runs() as runs:
                        t0 = time.perf_counter()
                        picks[mode] = loop(n, mode == "eager")
                        torch.cuda.synchronize(dev)
                        times[mode].append(1e3 * (time.perf_counter() - t0))
            run = runs[0]
            res[f"[{rows}] x {n}"] = row = dict(
                eager_ms=statistics.median(times["eager"]),
                graph_ms=statistics.median(times["graph"]),
                eager_range_ms=[min(times["eager"]), max(times["eager"])],
                graph_range_ms=[min(times["graph"]), max(times["graph"])],
                equal=bool(torch.equal(picks["eager"], picks["graph"])),
                capture_s=run["capture_s"],
                capture_bytes=run["capture_bytes"],
                launches=run["launches"])
            log(f"{kind} [{rows}] x {n} steps: {json.dumps(row)}")
        for mode in ("eager", "graph"):
            b = busy_share(lambda: big(1000, mode == "eager"), reps=1)
            res[f"profiled {mode} [{GREEDY_ROWS}] x 1000"] = b
            log(f"{kind} {mode} profiled: busy {b['busy_share']:.3f}, "
                f"kernels {b['kernels']}, host launches "
                f"{b['host_launches']} for 1000 steps")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="root of the ssdr_al_torch tree to "
                    "measure (default: the one holding this file)")
    ap.add_argument("--out", help="also write the JSON results here")
    ap.add_argument("--extract-sweep", action="store_true",
                    help="measure only the extraction at cloud sizes "
                         "EXTRACT_SWEEP_POINTS")
    ap.add_argument("--eval-steps", action="store_true",
                    help="measure only the eval steps [8 x 40960] on the "
                         "pallas, approx, window and window + K5 engines "
                         "in f32 and bf16, eager and as graphs, and the "
                         "selection's prediction")
    ap.add_argument("--dtype", choices=["bfloat16"],
                    help="measure only the pooled train step [6 x 40960] "
                         "and the window eval step [8 x 40960] in this "
                         "dtype and in float32, in turns")
    ap.add_argument("--eager", action="store_true",
                    help="measure only each path's eager step (with "
                         "Adam's capturable and plain forms where the "
                         "trainer's is capturable) and the dp step")
    ap.add_argument("--greedy-loops", action="store_true",
                    help="measure only the greedy selection loops, eager "
                         "against replayed graphs, at the at-scale "
                         "round's lengths and at short lengths")
    ap.add_argument("--gcn-fit", action="store_true",
                    help="measure only the coreGCN fit: one captured step "
                         "replayed, graphs of GCN_GRAPH_SIZES steps and "
                         "the eager steps")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, tree)
    if not torch.cuda.is_available():
        print("step_times: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    from ssdr_al_torch.kernels import build

    build.library()
    dev = torch.device("cuda", 0)
    if args.extract_sweep:
        res = {"extraction": extraction_sweep(dev)}
    elif args.eval_steps:
        res = {"eval_steps": eval_steps(dev, work=os.path.join(
            tree, "build", "step_times"))}
    elif args.gcn_fit:
        res = {"gcn_fit": gcn_fit_times(dev)}
    elif args.greedy_loops:
        res = {"greedy_loops": greedy_loop_times(dev)}
    elif args.eager:
        res = {"eager": eager_steps(dev, work=os.path.join(
            tree, "build", "step_times"))}
    elif args.dtype:
        res = {"dtypes": dtype_steps(dev, work=os.path.join(
            tree, "build", "step_times"))}
    else:
        work = os.path.join(tree, "build", "step_times")
        res = measure(dev, work=work)
        if "graph" in res["host"]:
            res["round"] = round_walls(dev, work=work)
    res.update(tree=tree, card=card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
