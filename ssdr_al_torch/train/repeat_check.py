"""Two identical train steps from one state and one batch, compared bit
for bit, on each training path; optionally the backward kernels that
scatter or use atomics.

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
difference are reported. `--profile` runs the two host steps under
torch.profiler and lists every device kernel launched inside the
backward (under an `autograd::engine::evaluate_function` op) whose name
holds "atomic" or "scatter", with the backward op that launched it and
its count. Prints the card's name and power limit and, as its last line,
the results as JSON (also written to PATH); exits 1 if a path's two
steps differ. chip_smoke.py runs `repeat_paths`.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

PATHS = ("host", "pool", "possibility")
S3DIS_ROOMS, S3DIS_ROOM_POINTS = 4, 150_000
S3D_CLOUDS, S3D_CLOUD_POINTS = 3, 300_000


def _snapshot(trainer, metrics) -> dict:
    model = trainer.model
    return {"loss": metrics["loss"].detach().clone(),
            "grad": {k: p.grad.detach().clone()
                     for k, p in model.named_parameters()
                     if p.grad is not None},
            "bn": {k: v.detach().clone() for k, v in model.named_buffers()
                   if "running" in k},
            "params": {k: p.detach().clone()
                       for k, p in model.named_parameters()}}


def repeat_step(trainer, step, generators=()) -> dict:
    """step(train_state) → metrics, run twice from the trainer's present
    state with its Adam reset and the dropout generator and `generators`
    restored before each; {"equal", "differing", "max_abs_diff",
    "tensors", "loss"}."""
    from ssdr_al_torch.train.trainer import reset_optimizer

    state0 = {k: v.detach().clone()
              for k, v in trainer.model.state_dict().items()}
    gens = (trainer.dropout_gen,) + tuple(generators)
    gen0 = [g.get_state() for g in gens]
    runs = []
    for _ in range(2):
        trainer.model.load_state_dict(state0)
        trainer.train_state = reset_optimizer(trainer.train_state,
                                              trainer.cfg,
                                              trainer.steps_per_epoch)
        for g, s in zip(gens, gen0):
            g.set_state(s)
        runs.append(_snapshot(trainer, step(trainer.train_state)))
    trainer.model.load_state_dict(state0)
    a, b = runs
    pairs = [("loss", a["loss"], b["loss"])] + [
        (f"{kind}:{k}", a[kind][k], b[kind][k])
        for kind in ("grad", "bn", "params") for k in a[kind]]
    differing = [name for name, x, y in pairs if not torch.equal(x, y)]
    worst = max((float((x.double() - y.double()).abs().max())
                 for _, x, y in pairs), default=0.0)
    return {"equal": not differing, "differing": differing[:20],
            "n_differing": len(differing), "tensors": len(pairs),
            "max_abs_diff": worst, "loss": float(a["loss"])}


def _trainer(cfg, dev, name, work):
    from ssdr_al_torch.train.trainer import Trainer

    trainer = Trainer(cfg, name, save_dir=work, device=dev)
    trainer.init_state()
    return trainer


def path_steps(dev, paths=PATHS, work="build/repeat_check", s3dis=None,
               semantic3d=None):
    """{path: (trainer, step(train_state) → metrics, generators)} of the
    paths asked for. s3dis / semantic3d: (cfg, clouds) to use in place of
    the module's full-width workloads (tests pass small ones)."""
    from ssdr_al_torch import config
    from ssdr_al_torch.data.dataset import TrainingPipeline
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
            batch = TrainingPipeline(rooms, cfg, seed=1).sample_batch(
                cfg.batch_size)
            out["host"] = (trainer, lambda ts, t=trainer, b=batch:
                           t.train_step(ts, b, t.dropout_gen)[1], ())
        if "pool" in paths:
            pool = DeviceTrainPool(rooms, cfg, seed=1, device=dev)
            if not pool.available:
                raise AssertionError("the S3DIS pool is over its memory gate")
            ids, picks = pool.sample_indices(cfg.batch_size)
            out["pool"] = (trainer, lambda ts, t=trainer, p=pool:
                           t.pooled_step(ts, p, ids, picks,
                                         t.dropout_gen)[1], (pool.generator,))
    if "possibility" in paths:
        cfg3, clouds = semantic3d or (config.ConfigSemantic3D, make_dataset(
            num_train=S3D_CLOUDS, num_val=0, num_points=S3D_CLOUD_POINTS,
            seed=0, hard=True)[0])
        trainer = _trainer(cfg3, dev, "Semantic3D", work)
        pool = PossibilityDevicePool(clouds, cfg3, seed=1, device=dev)
        if not pool.available:
            raise AssertionError("the Semantic3D pool is over its memory gate")
        poss = pool.init_possibility
        out["possibility"] = (trainer, lambda ts, t=trainer, p=pool:
                              t.possibility_step(ts, p, poss,
                                                 t.dropout_gen)[2],
                              (pool.generator,))
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
    out = {"paths": repeat_paths(dev, tuple(a.paths.split(",")))}
    if a.profile:
        out["backward_kernels"] = profile_host(dev)
    line = json.dumps(out)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if all(r["equal"] for r in out["paths"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
