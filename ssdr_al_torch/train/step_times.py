"""Median wall time of warm train steps on the card, per training path.

    python3 ssdr_al_torch/train/step_times.py [--tree DIR] [--out PATH]
        [--extract-sweep | --eval-steps | --dtype bfloat16]

Paths, each on a fresh Trainer (`window` engine, random weights) over
synthetic rooms (seed 0):
- host: Trainer.train_step at ConfigS3DIS width [6 × 40960] on batches the
  host TrainingPipeline sampled beforehand; the step's upload counts.
- pool: the same width on a DeviceTrainPool: the host's draw of cloud ids
  and picks, their upload, extraction on the card and the step.
- possibility: ConfigSemantic3D width [4 × 65536] on a
  PossibilityDevicePool, the field threaded through the steps.
Each step is timed by the host clock from its call to the
torch.cuda.synchronize() after it, 3 warm-up steps first; the median and
the range of 20 steps. The extraction alone (extract_blocks,
possibility_extract) and the sort inside it (torch.sort of the largest
cloud's d²) are timed by CUDA events. For each path the K4 launches a
step (each allocates three scratch tensors: counts, bins and the overflow
list) and the caching allocator's device allocations (cudaMalloc) during
the timed steps are counted.

`--tree DIR` measures the ssdr_al_torch package under DIR (for example a
`git archive` of another commit); a tree without the pools measures the
host path only. `--extract-sweep` measures only the extraction at
ConfigSemantic3D width (B=4 blocks of 65536 points) on one synthetic
cloud of each size in EXTRACT_SWEEP_POINTS (uniform in 200 × 200 × 20 m,
made on the card): extract_blocks and possibility_extract by CUDA events,
the torch.sort inside each, and the peak device memory each takes beyond
its inputs, per block row (the pool's memory gate counts
EXTRACT_BYTES_PER_ROW). `--eval-steps` measures only eval steps
(`make_eval_step`) at ConfigS3DIS width [8 × 40960] on the exact engine
(`pallas`, K6), on `window` (K1) and on `window` with K5
(`MXU_DISTANCE_DEFAULT`), random weights (`init_params`, seed 0) on one
random batch: each step by the host clock from its call to a
synchronize, its numpy batch's upload included, the median and the
range of 20 steps after 3 warm-up steps. `--dtype bfloat16` measures only
--compute_dtype bfloat16 beside float32: the pooled train step [6 × 40960]
(al_loop's default path) and the `window` eval step [8 × 40960], each
dtype on its own Trainer / model from the same random weights, the two
dtypes in turns of 5 steps after 3 warm-up steps each, 20 timed steps a
dtype (median and range as above); then, for each, the device time of
its kernels a step under torch.profiler (kernels/measure.py::
device_breakdown, 3 steps): their sum, the launches a step and the six
largest kernels. Prints one line per path and, as its
last line, the results as JSON (also written to PATH). chip_smoke.py runs
`measure` and `dtype_steps`.
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


def _counted(run, dev, steps):
    """run() of `steps` steps, with its K4 launches a step and the
    cudaMalloc calls it made."""
    from ssdr_al_torch.ops import gather as ga

    k4 = ga.scatter_window.launches
    segs = torch.cuda.memory_stats(dev).get("segment.all.allocated", 0)
    out = run()
    out["k4_launches_per_step"] = (ga.scatter_window.launches - k4) / steps
    out["cuda_mallocs"] = torch.cuda.memory_stats(dev).get(
        "segment.all.allocated", 0) - segs
    return out


def _trainer(cfg, dev, name, work):
    from ssdr_al_torch.train.trainer import Trainer

    trainer = Trainer(cfg, name, save_dir=work, device=dev)
    trainer.init_state()
    return trainer


def measure(dev, steps=20, warmup=3, work="build/step_times", log=print):
    """The warm-step medians of every path the tree has (module
    docstring); returns {path: {...}}."""
    import dataclasses

    from ssdr_al_torch import config
    from ssdr_al_torch.data.dataset import TrainingPipeline
    from ssdr_al_torch.data.synthetic import make_dataset

    out = {}
    cfg = dataclasses.replace(config.ConfigS3DIS, train_steps=steps)
    rooms, _ = make_dataset(num_train=S3DIS_ROOMS, num_val=0,
                            num_points=S3DIS_ROOM_POINTS, seed=0, hard=True)
    trainer = _trainer(cfg, dev, "S3DIS", work)
    pipe = TrainingPipeline(rooms, cfg, seed=1)
    batches = [pipe.sample_batch(cfg.batch_size)
               for _ in range(warmup + steps)]
    out["host"] = _counted(lambda: timed_steps(
        lambda i: trainer.train_step(trainer.train_state, batches[i],
                                     trainer.dropout_gen),
        steps, warmup), dev, warmup + steps)
    log(f"host-pipeline step [{cfg.batch_size}x{cfg.num_points}]: "
        + json.dumps(out["host"]))
    del batches
    try:
        from ssdr_al_torch.train import device_pool as dp
        from ssdr_al_torch.train import possibility_pool as pp
    except ImportError:
        return out                       # a tree without the pools

    pool = dp.DeviceTrainPool(rooms, cfg, seed=1, device=dev)
    if not pool.available:
        raise AssertionError("the S3DIS pool is over its memory gate")
    out["pool"] = _counted(lambda: timed_steps(
        lambda i: trainer.pooled_step(
            trainer.train_state, pool, *pool.sample_indices(cfg.batch_size),
            trainer.dropout_gen), steps, warmup), dev, warmup + steps)
    ids, picks = pool.sample_indices(cfg.batch_size)
    pick_t = torch.from_numpy(picks).to(dev)
    d2 = dp.block_d2(pool.xyz[:pool.window].expand(cfg.batch_size, -1, -1),
                     pick_t[:, None])
    out["pool"].update(
        extract_ms=event_ms(lambda: pool.extract(ids, picks), 10),
        sort_ms=event_ms(lambda: torch.sort(d2, dim=1, stable=True), 10),
        sort_shape=list(d2.shape))
    log(f"pooled step [{cfg.batch_size}x{cfg.num_points}]: "
        + json.dumps(out["pool"]))
    del trainer, pool, d2

    cfg3 = dataclasses.replace(config.ConfigSemantic3D, train_steps=steps)
    clouds, _ = make_dataset(num_train=S3D_CLOUDS, num_val=0,
                             num_points=S3D_CLOUD_POINTS, seed=0, hard=True)
    trainer = _trainer(cfg3, dev, "Semantic3D", work)
    pool = pp.PossibilityDevicePool(clouds, cfg3, seed=1, device=dev)
    if not pool.available:
        raise AssertionError("the Semantic3D pool is over its memory gate")
    state = {"poss": pool.init_possibility}

    def poss_step(i):
        _, state["poss"], _ = trainer.possibility_step(
            trainer.train_state, pool, state["poss"], trainer.dropout_gen)

    out["possibility"] = _counted(
        lambda: timed_steps(poss_step, steps, warmup), dev, warmup + steps)
    args = pool.device_args()
    d2 = dp.block_d2(pool.xyz[:pool.window], pool.xyz[:1])
    out["possibility"].update(
        extract_ms=event_ms(lambda: pp.possibility_extract(
            *args, pool.class_weight, state["poss"], pool.generator,
            cfg3.batch_size, cfg3.num_points, cfg3.noise_init / 10,
            pool.window, pool.augment), 5),
        sort_ms=event_ms(lambda: torch.sort(d2, stable=True), 10),
        sort_shape=list(d2.shape))
    log(f"possibility-pooled step [{cfg3.batch_size}x{cfg3.num_points}]: "
        + json.dumps(out["possibility"]))
    return out


def eval_steps(dev, steps=20, warmup=3, log=print):
    """The eval-step medians of the `--eval-steps` mode (module
    docstring); returns {engine: {...}}."""
    import numpy as np

    from ssdr_al_torch import config
    from ssdr_al_torch.models.randlanet import RandLANet, init_params
    from ssdr_al_torch.ops import knn as kn
    from ssdr_al_torch.train.trainer import make_eval_step

    cfg = config.ConfigS3DIS
    rng = np.random.RandomState(0)
    xyz = (rng.rand(8, cfg.num_points, 3) * 6).astype(np.float32)
    batch = {"xyz": xyz, "features": np.concatenate(
        [xyz, rng.rand(8, cfg.num_points, 3).astype(np.float32)], -1)}
    state = {k: v.to(dev) for k, v in init_params(
        cfg, torch.Generator().manual_seed(0)).items()}
    model = RandLANet(cfg).to(dev)
    out = {}
    for name, engine, mxu in (("pallas", "pallas", False),
                              ("window", "window", False),
                              ("window_k5", "window", True)):
        step = make_eval_step(model, cfg, engine, False, device=dev)
        kn.MXU_DISTANCE_DEFAULT = mxu
        try:
            out[name] = timed_steps(lambda i: step(state, batch), steps,
                                    warmup)
        finally:
            kn.MXU_DISTANCE_DEFAULT = False
        log(f"eval step {name} [8x{cfg.num_points}]: "
            + json.dumps(out[name]))
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
                         "pallas, window and window + K5 engines")
    ap.add_argument("--dtype", choices=["bfloat16"],
                    help="measure only the pooled train step [6 x 40960] "
                         "and the window eval step [8 x 40960] in this "
                         "dtype and in float32, in turns")
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
        res = {"eval_steps": eval_steps(dev)}
    elif args.dtype:
        res = {"dtypes": dtype_steps(dev, work=os.path.join(
            tree, "build", "step_times"))}
    else:
        res = measure(dev, work=os.path.join(tree, "build", "step_times"))
    res.update(tree=tree, card=card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
