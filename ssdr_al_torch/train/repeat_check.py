"""Two identical train steps from one state and one batch, compared bit
for bit, on each training path; then, on the card, a round's steps as
CUDA-graph replays against the same steps run eagerly; optionally the
backward kernels that scatter or use atomics.

    python -m ssdr_al_torch.train.repeat_check [--paths host,pool,possibility]
        [--profile] [--out PATH] [--device cpu]

Paths, each on a fresh Trainer (`window` engine, the init weights of seed
0) over synthetic rooms (seed 0), as train/step_times.py builds them:
- host: Trainer.train_step at ConfigS3DIS width [6 × 40960] on one batch
  of the host TrainingPipeline;
- pool: the same width on a DeviceTrainPool: one host draw of cloud ids
  and picks, extraction and shuffle on the card;
- possibility: ConfigSemantic3D width [4 × 65536] on a
  PossibilityDevicePool, from its initial field.
Before each of the two steps the model's state, a fresh Adam, the dropout
generator and the pool's generator are restored, so the two steps are the
same computation. The loss, every parameter's gradient, every BatchNorm
statistic and every parameter after the Adam update must be bitwise equal
(`torch.equal`); the count of tensors that differ and the largest
difference are reported. The replay check (`replay_paths`, CUDA only):
GRAPH_WARMUP + 20 steps (20 replays) of the path's static-buffer
step (trainer.make_static_step) on pre-drawn batches or pool draws, once
eagerly and once through a StepGraph (train/graphs.py: the warm-up steps
eager, then one capture replayed), each from the same state with a
fresh Adam, the generators and the possibility field restored: every
step's loss and, after the last, the gradients, BatchNorm statistics,
parameters and Adam moments must be bitwise equal; the learning rate
decays after the warm-up (steps_per_epoch = GRAPH_WARMUP + 1), so the
replays cross an epoch boundary; the last replay runs under
torch.profiler, and its trace must hold K1's, K2's and K4's device
kernels (TRACED) as often as the graph's launch counts say. Then the
eval replays (`eval_replay_paths`, CUDA only): on the `window` and
`pallas` engines at S3DIS [20 × 40960] and Semantic3D [16 × 65536] eval
shapes, 20 calls of make_eval_step's graph (a capture, then replays)
each bitwise equal to the eager call on the same validation batch, one
InferenceRunner group the same through the graph and eagerly, and the
last replay's trace holding K1's, K2's and K6's kernels as counted.
`--profile` runs the two host steps under
torch.profiler and lists every device kernel launched inside the
backward (under an `autograd::engine::evaluate_function` op) whose name
holds "atomic" or "scatter", with the backward op that launched it and
its count. Prints the card's name and power limit and, as its last line,
the results as JSON (also written to PATH); exits 1 if a path's two
steps or its replays differ, or a replay's trace and counts disagree. chip_smoke.py runs `repeat_paths` and
`replay_paths`.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

PATHS = ("host", "pool", "possibility")
# the device kernels of K1, K2 and K4 that a trace of a replay must hold,
# each with its names in the trace and the launch counts
# (kernels/counts.py) it stands for: one K1 or K2 launch is one kernel,
# one K4 call one sum (through a transpose, or the single-use path's), one
# transpose of an index set one *_transpose_kernel (the place kernel of
# plan tiles, or the batch kernel)
TRACED = {"window_topk": (("window_topk_kernel",), ("window_topk",
                                                    "window_topk_mxu")),
          "gather_window": (("gather_window_kernel",),
                            ("gather_window", "gather_window_bf16")),
          "scatter_window": (("scatter_sum_kernel",
                              "scatter_bins_sum_kernel"),
                             ("scatter_window", "scatter_window_bf16")),
          "scatter_window_transpose": (("_transpose_kernel",),
                                       ("scatter_window_transpose",))}
S3DIS_ROOMS, S3DIS_ROOM_POINTS = 4, 150_000
S3D_CLOUDS, S3D_CLOUD_POINTS = 3, 300_000


def _snapshot(trainer, loss) -> dict:
    model = trainer.model
    opt = trainer.train_state.optimizer
    return {"loss": loss.detach().clone(),
            "adam": {f"{k}.{m}": opt.state[p][m].detach().clone()
                     for k, p in model.named_parameters() if p in opt.state
                     for m in ("exp_avg", "exp_avg_sq")},
            "grad": {k: p.grad.detach().clone()
                     for k, p in model.named_parameters()
                     if p.grad is not None},
            "bn": {k: v.detach().clone() for k, v in model.named_buffers()
                   if "running" in k},
            "params": {k: p.detach().clone()
                       for k, p in model.named_parameters()}}


def compare_runs(trainer, runs, generators=(), restore=None) -> dict:
    """run(train_state) → loss for each of `runs`, each from the trainer's
    present state with its Adam reset, the dropout generator and
    `generators` restored, and restore() called, before it; every run
    against the first: {"equal", "differing", "n_differing", "tensors",
    "max_abs_diff", "loss"} over the loss, the gradients, the BatchNorm
    statistics, the parameters and Adam's moments after the run."""
    from ssdr_al_torch.train.trainer import reset_optimizer

    state0 = {k: v.detach().clone()
              for k, v in trainer.model.state_dict().items()}
    gens = (trainer.dropout_gen,) + tuple(generators)
    gen0 = [g.get_state() for g in gens]
    snaps = []
    for run in runs:
        trainer.model.load_state_dict(state0)
        trainer.train_state = reset_optimizer(trainer.train_state,
                                              trainer.cfg,
                                              trainer.steps_per_epoch)
        for g, s in zip(gens, gen0):
            g.set_state(s)
        if restore is not None:
            restore()
        snaps.append(_snapshot(trainer, run(trainer.train_state)))
    trainer.model.load_state_dict(state0)
    a = snaps[0]
    pairs = [("loss", a["loss"], b["loss"]) for b in snaps[1:]] + [
        (f"{kind}:{k}", a[kind][k], b[kind][k]) for b in snaps[1:]
        for kind in ("grad", "bn", "params", "adam") for k in a[kind]]
    differing = [name for name, x, y in pairs if not torch.equal(x, y)]
    worst = max((float((x.double() - y.double()).abs().max())
                 for _, x, y in pairs), default=0.0)
    return {"equal": not differing, "differing": differing[:20],
            "n_differing": len(differing), "tensors": len(pairs),
            "max_abs_diff": worst, "loss": float(a["loss"].reshape(-1)[-1])}


def repeat_step(trainer, step, generators=()) -> dict:
    """step(train_state) → metrics, run twice from the trainer's present
    state (compare_runs)."""
    return compare_runs(trainer, [lambda ts: step(ts)["loss"]] * 2,
                        generators)


def _trainer(cfg, dev, name, work):
    from ssdr_al_torch.train.trainer import Trainer

    trainer = Trainer(cfg, name, save_dir=work, device=dev)
    trainer.init_state()
    return trainer


def path_setups(dev, paths=PATHS, work="build/repeat_check", s3dis=None,
                semantic3d=None):
    """{path: (trainer, pool or None, rooms)} of the paths asked for: a
    fresh Trainer each, the pool of the pooled paths. s3dis / semantic3d:
    (cfg, clouds) to use in place of the module's full-width workloads
    (tests pass small ones)."""
    from ssdr_al_torch import config
    from ssdr_al_torch.data.synthetic import make_dataset
    from ssdr_al_torch.train.device_pool import DeviceTrainPool
    from ssdr_al_torch.train.possibility_pool import PossibilityDevicePool

    out = {}
    if {"host", "pool"} & set(paths):
        cfg, rooms = s3dis or (config.ConfigS3DIS, make_dataset(
            num_train=S3DIS_ROOMS, num_val=0, num_points=S3DIS_ROOM_POINTS,
            seed=0, hard=True)[0])
        trainer = _trainer(cfg, dev, "S3DIS", work)
        if "host" in paths:
            out["host"] = (trainer, None, rooms)
        if "pool" in paths:
            pool = DeviceTrainPool(rooms, cfg, seed=1, device=dev)
            if not pool.available:
                raise AssertionError("the S3DIS pool is over its memory gate")
            out["pool"] = (trainer, pool, rooms)
    if "possibility" in paths:
        cfg3, clouds = semantic3d or (config.ConfigSemantic3D, make_dataset(
            num_train=S3D_CLOUDS, num_val=0, num_points=S3D_CLOUD_POINTS,
            seed=0, hard=True)[0])
        trainer = _trainer(cfg3, dev, "Semantic3D", work)
        pool = PossibilityDevicePool(clouds, cfg3, seed=1, device=dev)
        if not pool.available:
            raise AssertionError("the Semantic3D pool is over its memory gate")
        out["possibility"] = (trainer, pool, clouds)
    return out


def _draws(path, trainer, pool, rooms, n):
    """n steps' host inputs of `path`: host batches, the pool's draws, or
    Nones."""
    from ssdr_al_torch.data.dataset import TrainingPipeline
    from ssdr_al_torch.train.trainer import POOL_INPUTS

    b = trainer.cfg.batch_size
    if path == "host":
        pipe = TrainingPipeline(rooms, trainer.cfg, seed=1)
        return [pipe.sample_batch(b) for _ in range(n)]
    if path == "pool":
        return [dict(zip(POOL_INPUTS, pool.sample_indices(b)))
                for _ in range(n)]
    return [None] * n


def path_steps(dev, paths=PATHS, **kw):
    """{path: (trainer, step(train_state) → metrics, generators)}: the
    path's eager step on one batch or one pool draw (path_setups)."""
    out = {}
    for path, (trainer, pool, rooms) in path_setups(dev, paths, **kw).items():
        d = _draws(path, trainer, pool, rooms, 1)[0]
        if path == "host":
            out[path] = (trainer, lambda ts, t=trainer, b=d:
                         t.train_step(ts, b, t.dropout_gen)[1], ())
        elif path == "pool":
            out[path] = (trainer, lambda ts, t=trainer, p=pool, d=d:
                         t.pooled_step(ts, p, d["cloud_ids"], d["picks"],
                                       t.dropout_gen)[1], (pool.generator,))
        else:
            out[path] = (trainer, lambda ts, t=trainer, p=pool:
                         t.possibility_step(ts, p, p.init_possibility,
                                            t.dropout_gen)[2],
                         (pool.generator,))
    return out


def traced_names(fn, warm=None) -> list:
    """The device kernels' names in a torch.profiler trace of fn() on the
    card. warm() (fn() if None) runs first, in the profiler's warm-up
    step, whose records are dropped: on an H100 a trace now and then
    loses the first part of its device records (a replayed step's trace
    that began after a device sleep has started far into the step, the
    sleep and every K1 kernel gone), and the warm-up step takes that
    loss."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for f in (warm or fn, fn):
            f()
            torch.cuda.synchronize()
            prof.step()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def traced_kernels(fn, warm=None) -> dict:
    """{kernel: device launches} of TRACED's kernels in a torch.profiler
    trace of fn() on the card, after warm() (traced_names)."""
    names = traced_names(fn, warm)
    return {k: sum(any(s in n for s in subs) for n in names)
            for k, (subs, _) in TRACED.items()}


def counted_kernels(launches: dict) -> dict:
    """{kernel of TRACED: the device launches that `launches` (kernel
    launch counts) stand for}."""
    return {name: sum(launches.get(k, 0) for k in keys)
            for name, (_, keys) in TRACED.items()}


def replay_check(trainer, path, pool, draws) -> dict:
    """len(draws) steps of the path's static-buffer step from the
    trainer's present state, eagerly and through a StepGraph
    (GRAPH_WARMUP eager steps, then replays of one capture), compared by
    compare_runs with every step's loss; adds the graph's stats(), and
    the last replay's trace: "traced" (traced_kernels), "counted" (what
    the graph's launch counts stand for, counted_kernels) and "traced_ok"
    (the two equal, each kernel launched)."""
    from ssdr_al_torch.train.graphs import GRAPH_WARMUP, StepGraph
    from ssdr_al_torch.train.trainer import make_static_step, set_lr

    # the rate decays after the warm-up: the replays cross an epoch
    trainer.steps_per_epoch = GRAPH_WARMUP + 1
    inputs, step = make_static_step(trainer.model, trainer.cfg,
                                    trainer.weights,
                                    trainer.knn_engine, path, pool=pool,
                                    device=trainer.device)
    gens = () if pool is None else (pool.generator,)
    graphs, traced = [], {}

    def run(ts, graphed):
        fn = lambda: step(ts, trainer.dropout_gen)      # noqa: E731
        if graphed:
            fn = StepGraph(fn, (trainer.dropout_gen,) + gens, trainer.device)
            graphs.append(fn)
        losses = []

        def one(d):
            if inputs is not None:
                inputs.stage(d)
            set_lr(ts)
            losses.append(fn()["loss"].clone())
            ts.step += 1

        last = len(draws) - 1
        for d in draws[:last - 1] if graphed else draws:
            one(d)
        if graphed:
            # the replay before the last warms the tracer up
            traced.update(traced_kernels(lambda: one(draws[last]),
                                         lambda: one(draws[last - 1])))
        return torch.stack(losses)

    def restore():
        if path == "possibility":
            pool.field.copy_(pool.init_possibility)

    res = compare_runs(trainer, [lambda ts: run(ts, False),
                                 lambda ts: run(ts, True)], gens, restore)
    res.update(graphs[0].stats(), steps=len(draws), traced=traced)
    res["counted"] = counted_kernels(res["launches"])
    res["traced_ok"] = traced == res["counted"] and all(traced.values())
    trainer.steps_per_epoch = trainer.cfg.train_steps
    return res


def replay_paths(dev, paths=PATHS, replays=20, log=print, **kw) -> dict:
    """replay_check on each path of path_setups with GRAPH_WARMUP +
    `replays` steps; {path: result}."""
    from ssdr_al_torch.train.graphs import GRAPH_WARMUP

    out = {}
    for path, (trainer, pool, rooms) in path_setups(dev, paths, **kw).items():
        draws = _draws(path, trainer, pool, rooms, GRAPH_WARMUP + replays)
        r = out[path] = replay_check(trainer, path, pool, draws)
        log(f"replays {path} [{trainer.cfg.batch_size}x"
            f"{trainer.cfg.num_points}]: {r['replays']} replays after "
            f"{r['eager_steps']} eager steps "
            + ("bitwise equal to the eager steps" if r["equal"] else
               f"DIFFER from the eager steps in {r['n_differing']} of "
               f"{r['tensors']} tensors (largest difference "
               f"{r['max_abs_diff']:.3e}; {r['differing'][:6]})")
            + f", capture {r['capture_s']:.3f} s, graph pool "
            f"{r['capture_bytes'] / 2**30:.2f} GiB, launches a replay "
            f"{r['launches']}; the last replay's trace "
            + ("holds" if r["traced_ok"] else "DOES NOT hold")
            + f" them: {r['traced']}")
    return out


# the eval forward's device kernels that a trace of a replay must hold,
# each with its names in the trace and the launch counts it stands for:
# one K1 or K5 launch is one window_topk_kernel, one K2 launch one
# gather_window_kernel, one K6 launch one walk or brute-force kernel
EVAL_TRACED = {
    "window_topk": (("window_topk_kernel",), ("window_topk",
                                              "window_topk_mxu")),
    "gather_window": (("gather_window_kernel",), ("gather_window",
                                                  "gather_window_bf16")),
    "knn_tiled": (("knn_walk_kernel", "knn_walk64_kernel",
                   "knn_brute_kernel"),
                  ("knn_tiled", "knn_tiled_k64"))}
EVAL_ENGINES = ("window", "pallas")


def traced_eval_kernels(fn, warm=None) -> dict:
    """{EVAL_TRACED kernel: device launches} in a torch.profiler trace of
    fn() on the card, after warm() (traced_names)."""
    names = traced_names(fn, warm)
    return {k: sum(any(s in n for s in subs) for n in names)
            for k, (subs, _) in EVAL_TRACED.items()}


def eval_batches(cfg, clouds, calls, seed=0) -> list:
    """`calls` validation batches of cfg.val_batch_size blocks
    (PossibilityEvalPipeline over `clouds`)."""
    from ssdr_al_torch.data.dataset import PossibilityEvalPipeline

    pipe = PossibilityEvalPipeline(clouds, cfg, seed=seed)
    return [pipe.get_batch(cfg.val_batch_size) for _ in range(calls)]


def eval_replay_check(dev, cfg, engine, clouds, batches, seed=0) -> dict:
    """make_eval_step's graph against its eager form on each of `batches`
    (eval_batches over `clouds`), at weights spread at O(1) scale (seed
    `seed`): the first call captures, the rest replay, each compared bit
    for bit with the eager call on the same batch; then
    InferenceRunner.run_many over the
    first cloud (one group of chunks, the selection's fused program)
    through the graph and eagerly, compared bit for bit; the last replay
    of the eval step runs under torch.profiler (traced_eval_kernels)
    against the launches the counts add a replay. {"equal", "differing",
    "runner_equal", "traced", "counted", "traced_ok", "eager_ms",
    "graph_ms" (medians to a synchronize), "stats"}."""
    import statistics
    import time

    import numpy as np

    from ssdr_al_torch.active.samplers import InferenceRunner
    from ssdr_al_torch.kernels import counts
    from ssdr_al_torch.models.randlanet import RandLANet, init_params
    from ssdr_al_torch.train.grad_check import spread_weights
    from ssdr_al_torch.train.trainer import make_eval_step

    state = {k: v.to(dev) for k, v in spread_weights(init_params(
        cfg, torch.Generator().manual_seed(0)), seed).items()}
    model = RandLANet(cfg).to(dev)
    steps = {m: make_eval_step(model, cfg, engine, True, device=dev,
                               eager=m == "eager")
             for m in ("eager", "graph")}
    differing, times = [], {m: [] for m in steps}
    traced = counted = None
    for i, batch in enumerate(batches):
        out = {}
        for m, step in steps.items():
            last = m == "graph" and i == len(batches) - 1
            if last:
                launched = {}

                def traced_call(step=step, batch=batch):
                    before = counts.read()
                    out["graph"] = step(state, batch)
                    launched.update(counts.since(before))

                # one more eager call on the batch warms the tracer up
                traced = traced_eval_kernels(
                    traced_call, lambda batch=batch:
                    steps["eager"](state, batch))
                counted = {k: sum(launched[c] for c in keys)
                           for k, (_, keys) in EVAL_TRACED.items()}
                continue
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out[m] = step(state, batch)
            torch.cuda.synchronize(dev)
            if i:
                times[m].append(1e3 * (time.perf_counter() - t0))
        if not all(torch.equal(a, b) for a, b in zip(out["eager"],
                                                    out["graph"])):
            differing.append(i)
    runs = {}
    for m, step in steps.items():
        runner = InferenceRunner(cfg, clouds[:1], step, state, "sb", seed=1,
                                 device=dev)
        inf = runner.run_many(clouds[:1])[clouds[0].name]
        runs[m] = (inf.prob_class, inf.uncertainty, inf.penult)
    runner_equal = all(np.array_equal(a, b)
                       for a, b in zip(runs["eager"], runs["graph"]))
    return {"equal": not differing, "differing": differing,
            "runner_equal": runner_equal, "traced": traced,
            "counted": counted,
            "traced_ok": traced == counted and any(traced.values()),
            "eager_ms": statistics.median(times["eager"]),
            "graph_ms": statistics.median(times["graph"]),
            "stats": steps["graph"].stats()}


def eval_replay_paths(dev, clouds_by_dataset=None, calls=20,
                      engines=EVAL_ENGINES, log=print) -> dict:
    """eval_replay_check on each engine at each dataset's eval shape, on
    `calls` batches made once a dataset
    (val_batch_size x num_points: S3DIS [20 x 40960] on one validation room
    of S3DIS_ROOM_POINTS points, Semantic3D [16 x 65536] on one cloud of
    S3D_CLOUD_POINTS); clouds_by_dataset: {"S3DIS" | "Semantic3D":
    (cfg, clouds)} in place of those. {"<dataset> <engine>": result}."""
    from ssdr_al_torch import config
    from ssdr_al_torch.data.synthetic import make_dataset

    if clouds_by_dataset is None:
        clouds_by_dataset = {
            "S3DIS": (config.ConfigS3DIS, make_dataset(
                num_train=0, num_val=1, num_points=S3DIS_ROOM_POINTS,
                seed=2, hard=True)[1]),
            "Semantic3D": (config.ConfigSemantic3D, make_dataset(
                num_train=0, num_val=1, num_points=S3D_CLOUD_POINTS,
                seed=3, hard=True)[1])}
    out = {}
    for name, (cfg, clouds) in clouds_by_dataset.items():
        batches = eval_batches(cfg, clouds, calls)
        for engine in engines:
            r = out[f"{name} {engine}"] = eval_replay_check(
                dev, cfg, engine, clouds, batches)
            st = r["stats"]
            log(f"eval replays {name} {engine} [{cfg.val_batch_size}x"
                f"{cfg.num_points}]: {st['replays']} calls of one capture "
                + ("bitwise equal to the eager calls" if r["equal"] else
                   f"DIFFER from the eager calls at {r['differing']}")
                + ", InferenceRunner group "
                + ("equal" if r["runner_equal"] else "DIFFERS")
                + f"; eager {r['eager_ms']:.3f} ms, graph "
                f"{r['graph_ms']:.3f} ms (medians to a synchronize), "
                f"capture {st['capture_s']:.3f} s, pools "
                f"{st['capture_bytes'] / 2**30:.2f} GiB; the last replay's "
                "trace " + ("holds" if r["traced_ok"] else "DOES NOT hold")
                + f" {r['traced']} (counted {r['counted']})")
    return out


def repeat_paths(dev, paths=PATHS, log=print, **kw) -> dict:
    """repeat_step on each path of path_steps; {path: result}."""
    out = {}
    for name, (trainer, step, gens) in path_steps(dev, paths, **kw).items():
        r = out[name] = repeat_step(trainer, step, gens)
        log(f"repeat {name} [{trainer.cfg.batch_size}x"
            f"{trainer.cfg.num_points}]: two identical steps "
            + ("bitwise equal" if r["equal"] else
               f"DIFFER in {r['n_differing']} of {r['tensors']} tensors "
               f"(largest difference {r['max_abs_diff']:.3e}; "
               f"{r['differing'][:6]})")
            + f", loss {r['loss']:.6f}")
    return out


def backward_kernels(prof, words=("atomic", "scatter")) -> list:
    """[{kernel, op, count}]: the device kernels of a torch.profiler run
    launched under an autograd backward op whose name holds one of
    `words` (case-insensitive), with the backward op and count."""
    counts = {}
    for evt in prof.events():
        if not evt.kernels:
            continue
        node, op = evt, None
        while node is not None:
            if node.name.startswith("autograd::engine::evaluate_function"):
                op = node.name.split(": ", 1)[-1]
                break
            node = node.cpu_parent
        if op is None:
            continue
        for k in evt.kernels:
            if any(w in k.name.lower() for w in words):
                key = (k.name, op, evt.name)
                counts[key] = counts.get(key, 0) + 1
    return [{"kernel": k, "backward_op": op, "aten_op": aten, "count": c}
            for (k, op, aten), c in sorted(counts.items())]


def profile_host(dev, log=print, **kw) -> list:
    """Two identical host steps under torch.profiler; backward_kernels."""
    from torch.profiler import ProfilerActivity, profile

    trainer, step, gens = path_steps(dev, ("host",), **kw)["host"]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        repeat_step(trainer, step, gens)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    rows = backward_kernels(prof)
    for r in rows:
        log(f"  backward kernel {r['kernel'][:90]} under {r['backward_op']} "
            f"({r['aten_op']}): {r['count']} launches in two steps")
    return rows


def main() -> int:
    import os
    import subprocess

    from ssdr_al_torch.device import DEFAULT_DEVICE, resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    a = ap.parse_args()
    dev = resolve_device(a.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    paths = tuple(a.paths.split(","))
    out = {"paths": repeat_paths(dev, paths)}
    if dev.type == "cuda":
        out["replays"] = replay_paths(dev, paths)
        out["eval_replays"] = eval_replay_paths(dev)
    if a.profile:
        out["backward_kernels"] = profile_host(dev)
    line = json.dumps(out)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if all(r["equal"] and r.get("traced_ok", True)
                    and r.get("runner_equal", True)
                    for group in ("paths", "replays", "eval_replays")
                    for r in out.get(group, {}).values()) else 1


if __name__ == "__main__":
    sys.exit(main())
