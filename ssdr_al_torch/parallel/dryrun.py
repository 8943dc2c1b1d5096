"""Dry runs of the port on n ranks (the twin of __graft_entry__.py's
`entry` and `dryrun_multichip`), and the per-rank functions that tests
and chip_smoke.py launch to hold every data-parallel path against its
single-device run.

    python -m ssdr_al_torch.parallel.dryrun [N] [--device cpu]

runs `dryrun_multichip(N)` (default 2) on cuda:0 … cuda:N−1, or on N CPU
ranks with --device cpu. Every `*_result(group, ...)` function runs one
path on this rank (group=None: the single-device run in this process, on
the card unless the caller passes device="cpu") and returns plain numpy
/ Python values, the same on every rank where the path's result is
replicated; `run_calls` runs several of them in one launch, each with the
kernel launch counts it made.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ssdr_al_torch.config import ConfigS3DIS, class_weights
from ssdr_al_torch.device import DEFAULT_DEVICE, resolve_device
from ssdr_al_torch.kernels import counts
from ssdr_al_torch.kernels.build import BUILD_DIR
from ssdr_al_torch.models.randlanet import (
    RandLANet,
    build_pyramid,
    init_params,
    set_data_group,
)
from ssdr_al_torch.parallel.mesh import launch

RUN_DIR = str(BUILD_DIR.parent / "dp_runs")    # FileStore rendezvous dirs


def _device(group, device):
    return group.device if group is not None else resolve_device(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _model(cfg, state, device, group, dropout: bool = False):
    model = RandLANet(cfg).to(device)
    model.load_state_dict(state)
    set_data_group(model, group)
    if not dropout:
        model.dp1.rate = 0.0
    return model


def _step_out(ts, metrics) -> dict:
    """Loss, accuracy, the summed gradient {parameter: array} and the state
    after the step."""
    model = ts.model
    return {"loss": float(metrics["loss"]),
            "accuracy": float(metrics["accuracy"]),
            "grad": {k: _numpy(p.grad) for k, p in model.named_parameters()},
            "state": {k: _numpy(v) for k, v in model.state_dict().items()}}


def train_step_result(group, cfg, state: dict, batch: dict, weights,
                      knn_engine: str = "window", dropout: bool = False,
                      pins=None, device=DEFAULT_DEVICE) -> dict:
    """One make_train_step step from `state` on the global `batch` (this
    rank uploads its rows). pins: the leaky-ReLU slopes and max-pool
    picks of a float64 run of the global batch ({"slopes", "pools"} of
    grad_check.reference_step, or the path of a torch.save of them),
    replayed on this rank's rows (grad_check.kink_pins)."""
    from ssdr_al_torch.train.grad_check import kink_pins
    from ssdr_al_torch.train.trainer import create_train_state, make_train_step

    dev = _device(group, device)
    model = _model(cfg, state, dev, group, dropout)
    ts = create_train_state(model, cfg, cfg.train_steps)
    step = make_train_step(model, cfg, weights, knn_engine, device=dev,
                           group=group)
    if pins is None:
        ctx = contextlib.nullcontext()
    else:
        if isinstance(pins, str):
            pins = torch.load(pins, weights_only=True)
        rows = None if group is None else group.share(len(batch["xyz"]))
        ctx = kink_pins(pins, rows)
    with ctx:
        ts, metrics = step(ts, batch, torch.Generator(dev).manual_seed(0))
    return _step_out(ts, metrics)


def train_step_times(group, cfg, state: dict, batch: dict, weights,
                     reps: int = 5, knn_engine: str = "window",
                     device=DEFAULT_DEVICE) -> list:
    """Host ms of `reps` warm make_train_step steps on the global batch,
    each ended by a synchronize on a card (one warm-up step first)."""
    from ssdr_al_torch.train.trainer import create_train_state, make_train_step

    dev = _device(group, device)
    model = _model(cfg, state, dev, group)
    ts = create_train_state(model, cfg, cfg.train_steps)
    step = make_train_step(model, cfg, weights, knn_engine, device=dev,
                           group=group)
    gen = torch.Generator(dev).manual_seed(0)
    out = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        ts, metrics = step(ts, batch, gen)
        float(metrics["loss"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out.append(1e3 * (time.perf_counter() - t0))
    return out[1:]


def pooled_step_result(group, cfg, state: dict, clouds, weights,
                       seed: int = 0, steps: int = 1,
                       knn_engine: str = "window",
                       device=DEFAULT_DEVICE) -> dict:
    """`steps` make_pooled_train_step steps on a DeviceTrainPool(seed),
    one held by every rank: the first step's output and every step's
    loss."""
    from ssdr_al_torch.train.device_pool import DeviceTrainPool
    from ssdr_al_torch.train.trainer import (
        create_train_state,
        make_pooled_train_step,
    )

    dev = _device(group, device)
    model = _model(cfg, state, dev, group)
    ts = create_train_state(model, cfg, cfg.train_steps)
    step = make_pooled_train_step(model, cfg, weights, knn_engine,
                                  device=dev, group=group)
    pool = DeviceTrainPool(clouds, cfg, seed=seed, device=dev)
    gen = torch.Generator(dev).manual_seed(0)
    losses, first = [], None
    for _ in range(steps):
        ids, picks = pool.sample_indices(cfg.batch_size)
        ts, metrics = step(ts, pool, ids, picks, gen)
        losses.append(float(metrics["loss"]))
        first = first or _step_out(ts, metrics)
    return dict(first, losses=losses)


def train_round_result(group, cfg, state: dict, clouds, pseudo, weights,
                       save_dir: str, seed: int = 1,
                       knn_engine: str = "window", dropout: bool = False,
                       device=DEFAULT_DEVICE) -> dict:
    """Trainer.train_round(1) on the host pipeline from `state`, without
    evaluation: the state it saved as snap-1."""
    from ssdr_al_torch.data.dataset import TrainingPipeline
    from ssdr_al_torch.train.trainer import Trainer

    dev = _device(group, device)
    trainer = Trainer(cfg, "S3DIS", save_dir=save_dir, knn_engine=knn_engine,
                      weights=weights, device=dev, group=group,
                      log_fn=lambda msg: None)
    trainer.model.load_state_dict(state)
    if not dropout:
        trainer.model.dp1.rate = 0.0
    pipe = TrainingPipeline(clouds, cfg, pseudo_gt=pseudo, seed=seed)
    trainer.train_round(1, lambda epoch: pipe.batches(cfg.train_steps,
                                                      cfg.batch_size))
    return {k: _numpy(v) for k, v in trainer.state.items()}


def _eval_step(cfg, state, dev, knn_engine, group):
    """The eval step of a rank (eager under a group, as its train steps)
    or of the single device, and the state on `dev`."""
    from ssdr_al_torch.train.trainer import make_eval_step

    model = RandLANet(cfg).to(dev)
    return make_eval_step(model, cfg, knn_engine, True, device=dev,
                          group=group), \
        {k: v.to(dev) for k, v in state.items()}


def inference_result(group, cfg, clouds, state: dict, slot_maps: dict,
                     num_slots: int, mode: str = "sb",
                     knn_engine: str = "window",
                     device=DEFAULT_DEVICE) -> dict:
    """InferenceRunner.run_many over `clouds`, once keeping the
    penultimate features on the device (with region_feature_means over
    slot_maps) and once bringing them back: per cloud (classes,
    uncertainties, penult) and the region means."""
    from ssdr_al_torch.active.samplers import InferenceRunner

    dev = _device(group, device)
    step, st = _eval_step(cfg, state, dev, knn_engine, group)
    out = {}
    for keep in (True, False):
        runner = InferenceRunner(cfg, clouds, step, st, mode, seed=3,
                                 keep_penult_on_device=keep, device=dev,
                                 group=group)
        inf = runner.run_many(clouds)
        if keep:
            out["means"] = runner.region_feature_means(slot_maps, num_slots)
        else:
            out["clouds"] = {n: (i.prob_class, i.uncertainty, i.penult)
                             for n, i in inf.items()}
    return out


def chamfer_result(group, clouds, components: dict, regions_by_cloud: dict,
                   cap: Optional[int] = 64,
                   device=DEFAULT_DEVICE) -> dict:
    """build_region_graph's ED + CD blocks [C, S, S] with the regions
    padded there ("padded") and from a SuperpointBlockCache ("cached"),
    the chamfer's blocks split over the ranks."""
    from ssdr_al_torch.active.region_graph import (
        SuperpointBlockCache,
        build_region_graph,
    )

    dev = _device(group, device)
    padded = build_region_graph(regions_by_cloud,
                                {c.name: c.xyz for c in clouds}, components,
                                max_points_per_sp=cap, device=dev,
                                group=group)
    cache = SuperpointBlockCache(cap, device=dev, group=group)
    for c in clouds:
        cache.ensure(c.name, c.xyz, components[c.name])
    cache.finalize()
    cached = build_region_graph(regions_by_cloud, cache=cache)
    return {"padded": padded.ed_cd, "cached": cached.ed_cd}


def selection_round_result(group, work: str, cfg, clouds, state: dict,
                           sampler_args: Sequence[str], total_num: int,
                           budget: int, diversity: str = "gcn_fps",
                           gcn_steps: Optional[int] = None,
                           knn_engine: str = "window",
                           device=DEFAULT_DEVICE) -> dict:
    """One TSampler round with the `diversity` branch (round 2 from the
    seed round under `work`): the registry, pseudo-GT and stats this
    rank's state holds after it (rank 0 wrote them; the others held
    theirs)."""
    from ssdr_al_torch.active.samplers import TSampler, TSamplerArgs
    from ssdr_al_torch.active.state import ALState, RoundStats

    dev = _device(group, device)
    step, st = _eval_step(cfg, state, dev, knn_engine, group)
    al = ALState(work, list(sampler_args),
                 write_files=group is None or group.lead)
    args = TSamplerArgs(diversity=diversity, gcn_steps=gcn_steps)
    sampler = TSampler(al, clouds, cfg, args, total_num, device=dev,
                       group=group)
    stats = RoundStats()
    sampler.sampling(step, st, budget, 1, stats)
    rd = al.round_dir(2)
    return {"registry": al.load_registry(rd),
            "pseudo": {c.name: al.load_pseudo_gt(rd, c.name)
                       for c in clouds},
            "stats": stats.as_dict()}


def evaluate_result(group, cfg, clouds, state: dict, max_epochs: int = 2,
                    knn_engine: str = "window", device=DEFAULT_DEVICE):
    """(mIoU, OA) of the Evaluator over `clouds`."""
    from ssdr_al_torch.train.evaluator import Evaluator

    dev = _device(group, device)
    step, st = _eval_step(cfg, state, dev, knn_engine, group)
    return Evaluator(cfg, clouds, max_epochs=max_epochs, group=group)(step,
                                                                      st)


def run_calls(group, calls: List[tuple]) -> list:
    """[(fn(group, **kwargs), {kernel: launches during it})] of calls
    [(fn, kwargs)], in order."""
    out = []
    for fn, kwargs in calls:
        counts.reset()
        res = fn(group, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        out.append((res, counts.read()))
    return out


# ------------------------------------------------------------- dry run ---

def tiny_config(n: int):
    """__graft_entry__.dryrun_multichip's config: 512 points, 5 narrow
    layers, one row per rank."""
    return dataclasses.replace(ConfigS3DIS, num_points=512,
                               d_out=(4, 8, 8, 8, 8), batch_size=n)


def _dryrun_rank(group) -> dict:
    """The full train step (parameters updated, loss finite), a selection
    forward with point_uncertainty, a dp chamfer chunk, dp region means
    and a dp pooled step, on this rank's share."""
    from ssdr_al_torch.active.uncertainty import point_uncertainty
    from ssdr_al_torch.data.cloud import Cloud
    from ssdr_al_torch.data.synthetic import grid_superpoints

    n, dev = group.size, group.device
    cfg = tiny_config(n)
    weights = class_weights("S3DIS")
    rng = np.random.RandomState(0)
    b, p = n, cfg.num_points
    batch = {
        "xyz": (rng.rand(b, p, 3) * 10).astype(np.float32),
        "features": rng.rand(b, p, 6).astype(np.float32),
        "labels": rng.randint(0, cfg.num_classes, (b, p)).astype(np.int32),
        "activation": np.ones((b, p), np.float32),
        "pseudo": rng.randint(0, cfg.num_classes, (b, p)).astype(np.int32),
    }
    state = init_params(cfg, torch.Generator().manual_seed(0))
    step = train_step_result(group, cfg, state, batch, weights, dropout=True)
    if not np.isfinite(step["loss"]):
        raise AssertionError(f"non-finite loss {step['loss']}")
    if np.array_equal(step["state"]["fc0.weight"],
                      state["fc0.weight"].numpy()):
        raise AssertionError("params did not update")

    new = {k: torch.from_numpy(v) for k, v in step["state"].items()}
    eval_step, st = _eval_step(cfg, new, dev, "window", group)
    probs, penult, _ = eval_step(st, {k: group.shard_rows(batch[k])
                                      for k in ("xyz", "features")})
    unc = point_uncertainty(probs, "sb")
    if not torch.isfinite(unc).all() or penult.shape[-1] != 32:
        raise AssertionError("selection forward: non-finite uncertainty "
                             f"or penult {tuple(penult.shape)}")

    clouds = [Cloud(name=f"c{i}",
                    xyz=(rng.rand(800, 3) * 6).astype(np.float32),
                    colors=rng.rand(800, 3).astype(np.float32),
                    labels=rng.randint(0, cfg.num_classes, 800).astype(
                        np.int32)) for i in range(2)]
    comps = {c.name: grid_superpoints(c.xyz, 8)[0] for c in clouds}
    regions = {c.name: [(s, s % 2 == 0, comps[c.name][s][:3])
                        for s in range(4)] for c in clouds}
    cd = chamfer_result(group, clouds, comps, regions)
    if not np.isfinite(cd["cached"]).all():
        raise AssertionError("non-finite dp chamfer")

    slots = {c.name: rng.randint(-1, 7, c.num_points) for c in clouds}
    means = inference_result(group, cfg, clouds, new, slots, 8)["means"]
    if not np.isfinite(means).all():
        raise AssertionError("non-finite region means")

    pooled = pooled_step_result(group, cfg, new, clouds, weights, seed=0)
    if not np.isfinite(pooled["loss"]):
        raise AssertionError(f"non-finite pooled loss {pooled['loss']}")
    return {"loss": step["loss"], "sel_unc_mean": float(unc.mean()),
            "dp_chamfer_mean": float(cd["cached"].mean()),
            "dp_region_means": tuple(means.shape),
            "dp_pooled_loss": pooled["loss"], "state": step["state"]}


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None,
                     store_dir: str = RUN_DIR) -> List[Dict]:
    """The full data-parallel training step and the dp selection pieces on
    n ranks, one step each on tiny shapes (__graft_entry__.py:57-186);
    devices default to cuda:0 … cuda:n−1. Returns every rank's summary
    after checking the ranks agree on the updated parameters."""
    devices = list(devices or [f"cuda:{i}" for i in range(n_devices)])
    for d in devices:
        resolve_device(d)
    out = launch(_dryrun_rank, n_devices, devices, store_dir)
    for r in out[1:]:
        for k, v in out[0]["state"].items():
            if not np.array_equal(v, r["state"][k]):
                raise AssertionError(f"ranks disagree on {k} after the step")
    s = out[0]
    print(f"dryrun_multichip OK: ranks={n_devices} on "
          f"{sorted(set(map(str, devices)))} loss={s['loss']:.4f} "
          f"sel_unc_mean={s['sel_unc_mean']:.4f} "
          f"dp_chamfer_mean={s['dp_chamfer_mean']:.4f} "
          f"dp_region_means={s['dp_region_means']} "
          f"dp_pooled_loss={s['dp_pooled_loss']:.4f}")
    return out


def entry(device="cuda"):
    """(fn, example_args): the flagship forward, one S3DIS block of 40960
    points through RandLA-Net at fresh weights (__graft_entry__.entry)."""
    dev = resolve_device(device)
    cfg = ConfigS3DIS
    model = RandLANet(cfg).to(dev).eval()
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
    rng = np.random.RandomState(0)
    xyz = torch.from_numpy(
        (rng.rand(1, cfg.num_points, 3) * 10).astype(np.float32)).to(dev)
    feats = torch.cat([xyz, torch.from_numpy(rng.rand(
        1, cfg.num_points, 3).astype(np.float32)).to(dev)], -1)

    def fn(xyz, feats):
        with torch.inference_mode():
            return model(feats, build_pyramid(xyz, cfg))[0]

    return fn, (xyz, feats)


def main(argv=None):
    p = argparse.ArgumentParser(description="data-parallel dry run")
    p.add_argument("n", type=int, nargs="?", default=2)
    p.add_argument("--device", default="cuda",
                   help="cuda (one card a rank) or cpu")
    a = p.parse_args(argv)
    devices = ([f"cuda:{i}" for i in range(a.n)] if a.device == "cuda"
               else [a.device] * a.n)
    dryrun_multichip(a.n, devices)


if __name__ == "__main__":
    main()
