"""Training and the eval step (counterpart of ssdr_al_tpu/train/trainer.py).

One train step is pyramid → forward (train mode) → activation-masked
weighted CE → backward → Adam step, and `make_static_step` is that step
for each path on static device tensors: blocks from the host pipeline
(the batch staged through pinned buffers), from a DeviceTrainPool on the
card (the [B] cloud ids and [B, 3] picks staged, the blocks extracted and
shuffled there), or from a PossibilityDevicePool (the Semantic3D
schedule on the card, its field a static buffer of the pool).
make_train_step, make_pooled_train_step and
make_possibility_pooled_train_step wrap it as functions of one step. The
round loop evaluates from `eval_start_frac` of its epochs on and keeps
the best-mIoU `snap-<round>` (reference RandLANet.py:217-282). Adam runs
at lr0 · decay^epoch with a fresh optimizer and step count each round
(reset_lr, RandLANet.py:213-215), as optax.adam over `make_lr_schedule`
does in the JAX package.

On the card a round's steps run as one captured program, as JAX jits its
step (ssdr_al_tpu/train/trainer.py:135, :166, :197): Trainer.train_round
runs the static step through train/graphs.py::StepGraph, GRAPH_WARMUP
eager steps, then one capture replayed for the rest of the round. The
Trainer's Adam on one card is capturable with a device learning rate
(set_lr fills it before each step), so the eager steps and the replays
are the same arithmetic. The CPU and data-parallel steps stay eager,
with a float rate: the CPU has no graphs, and a dp step's collectives
run over gloo or NCCL process groups outside any graph (ROADMAP.md §3).
The eval step (EvalStep) and the programs fused onto it (the
evaluation's f16 cast, the selection's reductions) run on the card as
replayed CUDA graphs too, one capture per input shape and state, kept
across rounds as JAX keeps its jitted eval step (:344).

A model state is the RandLANet module itself (parameters and BatchNorm
statistics) on the device; checkpoints are its `state_dict` saved with
torch.save, and JAX's `snap-<n>` files restore too (flax_snapshot.py).
A data-parallel group (parallel/mesh.py) makes each of these a rank's
share of JAX's mesh computation. The eval step runs the module functionally on a state_dict
(torch.func.functional_call), as flax's `model.apply(variables, ...)`.
Entry points run on the card unless the caller passes device="cpu".
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
# imported here, not by the first optimizer (torch.optim imports it
# lazily): its first import leaves a reference cycle through the frames
# on the stack (torch.fx.wrap keeps its own frame), which would keep the
# first Trainer of a process, and the CUDA graphs its eval step holds,
# alive after its entry point returns, until a full garbage collection
import torch._dynamo  # noqa: F401
from torch.func import functional_call

from ssdr_al_torch.config import Config, class_weights as get_class_weights
from ssdr_al_torch.device import DEFAULT_DEVICE, resolve_device
from ssdr_al_torch.models.randlanet import (
    KNN_ENGINES,
    RandLANet,
    SortedPyramid,
    build_pyramid,
    init_params,
    label_reduce_table,
    masked_weighted_ce,
    set_data_group,
)
from ssdr_al_torch.ops import gather as gather_ops
from ssdr_al_torch.ops import knn as knn_ops
from ssdr_al_torch.train.device_pool import BLOCK_ORDERS, shuffle_blocks
from ssdr_al_torch.train.flax_snapshot import load_flax_snapshot
from ssdr_al_torch.train.graphs import ForwardGraphs, StepGraph
from ssdr_al_torch.train.possibility_pool import (
    PossibilityDevicePool,
    possibility_extract,
)

__all__ = ["init_params", "make_eval_step", "EvalStep", "fused_program",
           "make_train_step",
           "make_pooled_train_step", "make_possibility_pooled_train_step",
           "make_static_step", "StagedInputs", "make_lr_schedule",
           "TrainState", "create_train_state", "reset_optimizer", "set_lr",
           "apply_gradients", "save_checkpoint",
           "restore_checkpoint", "Trainer"]

ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8     # optax.adam's defaults
STEP_PATHS = ("host", "pool", "possibility")
# the host pipeline's batch as the step takes it
HOST_INPUTS = {"xyz": torch.float32, "features": torch.float32,
               "labels": torch.int64, "activation": torch.float32,
               "pseudo": torch.int64}
POOL_INPUTS = {"cloud_ids": torch.int64, "picks": torch.float32}


def make_lr_schedule(cfg: Config, steps_per_epoch: int):
    """lr = lr0 · decay^(step // steps_per_epoch), read at the step count
    BEFORE the update, as optax's scale_by_schedule does."""

    def schedule(step: int) -> float:
        return cfg.learning_rate * (cfg.lr_decay ** (step // steps_per_epoch))

    return schedule


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its Adam, the lr
    schedule and the step count (optax's `count`)."""

    model: RandLANet
    optimizer: torch.optim.Adam
    schedule: Callable[[int], float]
    step: int = 0


def create_train_state(model: RandLANet, cfg: Config,
                       steps_per_epoch: int, *,
                       capturable: bool = False) -> TrainState:
    """A fresh Adam over the model's parameters at step 0. capturable (on
    the card only): Adam's capturable form with its learning rate a device
    tensor (set_lr fills it), so that a CUDA graph of the step updates in
    place; the Trainer takes it for its single-device steps on the card,
    eager and replayed alike. Otherwise the rate is a float."""
    schedule = make_lr_schedule(cfg, steps_per_epoch)
    dev = next(model.parameters()).device
    capturable = capturable and dev.type == "cuda"
    lr = torch.tensor(schedule(0), dtype=torch.float32, device=dev) \
        if capturable else schedule(0)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=ADAM_BETAS,
                           eps=ADAM_EPS, capturable=capturable)
    return TrainState(model, opt, schedule)


def reset_optimizer(state: TrainState, cfg: Config,
                    steps_per_epoch: int) -> TrainState:
    """Per-round lr reset: a fresh Adam (of the same form) and step
    counter, same model."""
    return create_train_state(
        state.model, cfg, steps_per_epoch,
        capturable=state.optimizer.defaults["capturable"])


def set_lr(state: TrainState):
    """The learning rate of the next update, schedule(step) at the step
    count before it (optax's order): on the card a fill of Adam's device
    rate (no host sync; a graph of the step reads it), else the float."""
    lr = state.schedule(state.step)
    for group in state.optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def apply_gradients(state: TrainState) -> TrainState:
    """One Adam update from the parameters' .grad, at the learning rate of
    the step count before it (optax's order); the count then advances."""
    set_lr(state)
    state.optimizer.step()
    state.step += 1
    return state


def _advance(state: TrainState, run: Callable):
    """run() one update (a step whose last act is optimizer.step()) at
    state.step's learning rate, then count it; run()'s result."""
    set_lr(state)
    out = run()
    state.step += 1
    return out


def _tensor(x, dtype, device):
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _make_step_body(model: RandLANet, cfg: Config, weights: np.ndarray,
                    knn_engine: str, device: torch.device, group=None):
    """body(state, xyz, features, labels, activation, pseudo, generator)
    → metrics on [B, N, ...] tensors on `device`: the part of a train
    step after its blocks are on the card, up to the Adam update at the
    rate the caller set (_advance).

    With a data-parallel group the tensors are this rank's rows of the
    global batch; the model's BatchNorms take the global statistics
    (set_data_group), the loss the global valid count, the gradients are
    summed over the ranks before the same Adam update on every rank, and
    the metrics are the global batch's."""
    table = (torch.as_tensor(label_reduce_table(
        cfg.num_classes, cfg.ignored_label_inds), dtype=torch.long,
        device=device) if cfg.ignored_label_inds else None)
    weights = torch.as_tensor(np.asarray(weights), dtype=torch.float32,
                              device=device)

    def body(state: TrainState, xyz, feats, labels, act, pseudo,
             generator: torch.Generator):
        with torch.no_grad():
            pyramid = build_pyramid(xyz, cfg, engine=knn_engine)
        sorted_mode = isinstance(pyramid, SortedPyramid)
        if sorted_mode:
            order = pyramid.order.long()
            pseudo = torch.gather(pseudo, 1, order)
            labels = torch.gather(labels, 1, order)
            act = torch.gather(act, 1, order)
        state.model.train()
        logits, _ = state.model(feats, pyramid, unsort=not sorted_mode,
                                generator=generator)
        loss, acc = masked_weighted_ce(logits, pseudo, act, labels, weights,
                                       cfg.ignored_label_inds, table, group)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss, act_sum = loss.detach(), act.sum()
        if group is not None:
            group.all_reduce_grads([p for p in state.model.parameters()
                                    if p.grad is not None])
            loss, act_sum = group.all_reduce_sum(torch.stack([loss,
                                                              act_sum]))
        state.optimizer.step()
        return {"loss": loss, "accuracy": acc, "activation_sum": act_sum}

    return body


class StagedInputs:
    """The static device tensors of a step's host inputs ({name: dtype}),
    and the host's way into them. stage(arrays) takes a step's numpy
    arrays by name (with a data-parallel group, the global batch's, of
    which this rank keeps its rows): on the card it writes them into one
    of two pinned buffers and copies that into the static tensors without
    blocking the host, in stream order after the steps before it; a pinned
    buffer is written again only once its last copy has ended (an event
    wait). On the CPU the arrays are copied straight in. The first call
    fixes the shapes; another shape raises (a captured step reads fixed
    shapes)."""

    def __init__(self, device: torch.device, dtypes: dict, group=None):
        self.device = device
        self.dtypes = dict(dtypes)
        self.group = group
        self.static = None
        self._slot = 0

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.static[name]

    def _allocate(self, arrays):
        shapes = {k: tuple(arrays[k].shape) for k in self.dtypes}
        self.static = {k: torch.empty(shapes[k], dtype=dt, device=self.device)
                       for k, dt in self.dtypes.items()}
        if self.device.type == "cuda":
            self._pinned = [{k: torch.empty(shapes[k], dtype=dt,
                                            pin_memory=True)
                             for k, dt in self.dtypes.items()}
                            for _ in range(2)]
            self._copied = [torch.cuda.Event() for _ in range(2)]

    def stage(self, arrays: dict):
        arrays = {k: np.asarray(arrays[k]) for k in self.dtypes}
        if self.group is not None:
            arrays = {k: self.group.shard_rows(a) for k, a in arrays.items()}
        if self.static is None:
            self._allocate(arrays)
        for k, a in arrays.items():
            if tuple(a.shape) != tuple(self.static[k].shape):
                raise ValueError(f"staged {k} of shape {a.shape}, the step "
                                 f"takes {tuple(self.static[k].shape)}")
        if self.device.type != "cuda":
            for k, a in arrays.items():
                self.static[k].copy_(torch.from_numpy(a))
            return
        slot, self._slot = self._slot, 1 - self._slot
        self._copied[slot].synchronize()
        for k, a in arrays.items():
            pinned = self._pinned[slot][k]
            pinned.copy_(torch.from_numpy(a))
            self.static[k].copy_(pinned, non_blocking=True)
        self._copied[slot].record()


def make_static_step(model: RandLANet, cfg: Config, weights: np.ndarray,
                     knn_engine: str = "window", path: str = "host", *,
                     pool=None, device: torch.device | str = DEFAULT_DEVICE,
                     group=None):
    """(inputs, step): the train step of `path` on static device tensors,
    the one step of every path, and the form a CUDA graph captures
    (train/graphs.py::StepGraph).

    inputs: a StagedInputs to stage() before each step: the host
    pipeline's batch dict ("host", HOST_INPUTS) or the pool's draws
    {"cloud_ids" [B], "picks" [B, 3]} ("pool", POOL_INPUTS; a
    DeviceTrainPool's sample_indices); None on the possibility path, whose
    field is the pool's static buffer (PossibilityDevicePool.field),
    updated in place. step(state, generator) → metrics runs one step from
    them up to the Adam update, at the rate the caller set (set_lr, or
    _advance, which also counts the step); generator draws the dropout
    mask. The pooled blocks are extracted (extract_blocks) at the pool's
    static window (pool.window, as JAX's jitted step reads it) and
    shuffled (shuffle_blocks), both drawing from the pool's generator, or
    left in their distance order where pool.blocks is "sorted" when the
    step is made (a graph captured from it keeps that order); the
    possibility path runs the B-block schedule (possibility_extract,
    augmented when pool.augment). On a sorted pyramid the loss is taken in
    morton-sorted row order, with pseudo, labels and activation permuted
    by pyramid.order instead of unsorting the logits (the loss averages
    over points).

    With a data-parallel group (set on the model too, set_data_group)
    every rank stages the same global batch or pool draws, keeps its rows
    and takes its rows of each global random draw, so the blocks are
    those of the single-device step (_make_step_body says how the step
    reduces); the possibility pool is single-device only."""
    if path not in STEP_PATHS:
        raise ValueError(f"unknown step path {path!r}; options: {STEP_PATHS}")
    if path == "possibility" and group is not None:
        raise ValueError("the possibility pool is single-device only")
    device = resolve_device(device)
    body = _make_step_body(model, cfg, weights, knn_engine, device, group)
    inputs = None
    if path == "host":
        inputs = StagedInputs(device, HOST_INPUTS, group)

        def blocks():
            return tuple(inputs[k] for k in HOST_INPUTS)
    elif path == "pool":
        inputs = StagedInputs(device, POOL_INPUTS)
        if pool.blocks not in BLOCK_ORDERS:
            raise ValueError(f"unknown block order {pool.blocks!r}; "
                             f"options: {BLOCK_ORDERS}")
        shuffled = pool.blocks == "shuffled"

        def blocks():
            out = pool.extract(inputs["cloud_ids"], inputs["picks"], group,
                               pool.window)
            return shuffle_blocks(out, pool.generator, group) if shuffled \
                else out
    else:
        def blocks():
            new_poss, *out = possibility_extract(
                *pool.device_args(), pool.class_weight, pool.field,
                pool.generator, cfg.batch_size, cfg.num_points,
                cfg.noise_init / 10, pool.window, pool.augment)
            pool.field.copy_(new_poss)
            return shuffle_blocks(out, pool.generator)

    def step(state: TrainState, generator: torch.Generator):
        return body(state, *blocks(), generator)

    return inputs, step


def make_train_step(model: RandLANet, cfg: Config, weights: np.ndarray,
                    knn_engine: str = "window", *,
                    device: torch.device | str = DEFAULT_DEVICE, group=None):
    """Return train_step(state, batch, generator) → (state, metrics):
    make_static_step's host step, its batch staged and its update counted.

    batch: {"xyz", "features", "labels", "activation", "pseudo"} numpy
    [B, N, ...] arrays (with a group, the global batch). The state is
    updated in place: parameters, Adam moments, BatchNorm statistics and
    the step count."""
    inputs, step = make_static_step(model, cfg, weights, knn_engine, "host",
                                    device=device, group=group)

    def train_step(state: TrainState, batch, generator: torch.Generator):
        inputs.stage(batch)
        return state, _advance(state, lambda: step(state, generator))

    return train_step


def make_pooled_train_step(model: RandLANet, cfg: Config,
                           weights: np.ndarray, knn_engine: str = "window",
                           *, device: torch.device | str = DEFAULT_DEVICE,
                           group=None):
    """Return pooled_step(state, pool, cloud_ids, picks, generator) →
    (state, metrics): make_static_step's pooled step over a
    DeviceTrainPool on `device`, the pool's host draws (sample_indices;
    with a group, the global draws) staged and the update counted."""
    made = {}

    def pooled_step(state: TrainState, pool, cloud_ids, picks,
                    generator: torch.Generator):
        if made.get("pool") is not pool:
            made.update(pool=pool, step=make_static_step(
                model, cfg, weights, knn_engine, "pool", pool=pool,
                device=device, group=group))
        inputs, step = made["step"]
        inputs.stage(dict(zip(POOL_INPUTS, (cloud_ids, picks))))
        return state, _advance(state, lambda: step(state, generator))

    return pooled_step


def make_possibility_pooled_train_step(
        model: RandLANet, cfg: Config, weights: np.ndarray,
        knn_engine: str = "window", *,
        device: torch.device | str = DEFAULT_DEVICE):
    """Return step(state, pool, poss, generator) → (state, new_poss,
    metrics): make_static_step's possibility step over a
    PossibilityDevicePool on `device` (the Semantic3D training path) from
    the field poss, which the caller threads through the steps (the
    pool's static field holds it during the step); the update counted."""
    made = {}

    def step(state: TrainState, pool, poss, generator: torch.Generator):
        if made.get("pool") is not pool:
            made.update(pool=pool, step=make_static_step(
                model, cfg, weights, knn_engine, "possibility", pool=pool,
                device=device)[1])
        pool.field.copy_(poss)
        metrics = _advance(state, lambda: made["step"](state, generator))
        return state, pool.field.clone(), metrics

    return step


EVAL_INPUTS = {"xyz": torch.float32, "features": torch.float32}


class EvalStep:
    """make_eval_step's eval step: eval_step(state, batch) → (probs,
    penult[, order]), and fused(name, tail), the same forward with `tail`
    applied to its outputs as one program.

    On the card every call runs as a replayed CUDA graph
    (train/graphs.py::ForwardGraphs, on `graphs`), as JAX jits its eval
    step (ssdr_al_tpu/train/trainer.py:344) and fuses the selection's
    reductions onto it (ssdr_al_tpu/active/samplers.py:146): one capture
    per program, input shapes, addresses of the state's tensors and K5
    switch (ops.knn.MXU_DISTANCE_DEFAULT), kept across calls, evaluations
    and rounds. A call returns copies of the graph's outputs, which the
    next replay does not touch. A Trainer's state keeps its addresses
    (Trainer.state is the model's state_dict, and restore_model copies in
    place), so its evaluations and selections replay one capture a shape;
    a state of other tensors gets a capture of its own, never a replay of
    stale weights.

    The CPU, a data-parallel group (each rank's forward runs on its rows
    of the batch, eagerly, as its train steps do), SSDR_DEBUG_WINDOW_GUARD
    (its clamp count reads back at every gather, a host sync a capture
    refuses) and eager=True (measurement) run the same body eagerly; on
    the card their numpy batches are staged through pinned buffers
    (StagedInputs), as the train step's are."""

    def __init__(self, model: RandLANet, cfg: Config, knn_engine: str,
                 sorted_outputs: bool, device: torch.device, group=None,
                 eager: bool = False):
        self.model = model
        self.cfg = cfg
        self.knn_engine = knn_engine
        self.sorted_outputs = sorted_outputs
        self.device = device
        self.graphs = (ForwardGraphs(device) if device.type == "cuda"
                       and group is None and not eager else None)
        self._staged = {}

    def body(self, state, xyz, feats):
        """(probs, penult[, order]) of the forward of [B, N, 3] xyz and
        [B, N, 6] features on the device."""
        self.model.eval()
        with torch.inference_mode():
            pyramid = build_pyramid(xyz, self.cfg, engine=self.knn_engine)
            sorted_mode = self.sorted_outputs and isinstance(pyramid,
                                                             SortedPyramid)
            logits, penult = functional_call(
                self.model, state, (feats, pyramid),
                {"unsort": not sorted_mode})
            probs = torch.softmax(logits, dim=-1)
            if not self.sorted_outputs:
                return probs, penult
            if sorted_mode:
                order = pyramid.order
            else:
                b, n = xyz.shape[:2]
                order = torch.arange(n, dtype=torch.int32,
                                     device=xyz.device).repeat(b, 1)
            return probs, penult, order

    def __call__(self, state, batch):
        return self._run(state, batch, None, None)

    def fused(self, name: str, tail: Callable):
        """program(state, batch) → tail(*eval_step(state, batch)): the
        forward and `tail` as one program, one graph a key on the card;
        `name` tells the programs of one eval step apart."""
        return lambda state, batch: self._run(state, batch, name, tail)

    def _run(self, state, batch, name, tail):
        def program(xyz, feats):
            out = self.body(state, xyz, feats)
            if tail is None:
                return out
            with torch.inference_mode():
                return tuple(tail(*out))

        if self.graphs is None or gather_ops.DEBUG_WINDOW_GUARD:
            return program(*self._eager_inputs(batch))
        key = (name, tuple(tuple(batch[k].shape) for k in EVAL_INPUTS),
               tuple((k, v.data_ptr()) for k, v in state.items()),
               knn_ops.MXU_DISTANCE_DEFAULT)

        def make():
            inputs = StagedInputs(self.device, EVAL_INPUTS)
            return (inputs, lambda: program(inputs["xyz"], inputs["features"]),
                    tuple(state.values()))

        return self.graphs(key, make, batch)

    def _eager_inputs(self, batch):
        if self.device.type != "cuda":
            return tuple(_tensor(batch[k], dt, self.device)
                         for k, dt in EVAL_INPUTS.items())
        shapes = tuple(tuple(batch[k].shape) for k in EVAL_INPUTS)
        inputs = self._staged.get(shapes)
        if inputs is None:
            inputs = self._staged[shapes] = StagedInputs(self.device,
                                                          EVAL_INPUTS)
        inputs.stage(batch)
        return tuple(inputs[k] for k in EVAL_INPUTS)

    def stats(self) -> dict:
        """ForwardGraphs.stats() of the graphs and `kept`, one {program,
        shapes (of the inputs), pool_bytes} a kept capture; {} where it
        runs eagerly."""
        if self.graphs is None:
            return {}
        kept = [dict(program=key[0], shapes=key[1],
                     pool_bytes=fwd.graph.pool_bytes)
                for key, fwd in self.graphs.forwards.items()]
        return dict(self.graphs.stats(), kept=kept)


def make_eval_step(model: RandLANet, cfg: Config, knn_engine: str = "window",
                   sorted_outputs: bool = True, *,
                   device: torch.device | str = DEFAULT_DEVICE, group=None,
                   eager: bool = False) -> EvalStep:
    """Return eval_step(state, batch) → (probs, penult[, order]), an
    EvalStep (on the card a replayed CUDA graph; its docstring says when
    it runs eagerly).

    batch: {"xyz": [B, N, 3], "features": [B, N, 6]} numpy arrays (or
    CPU tensors);
    state: a state_dict of `model` on `device`. probs are the softmax of
    the logits, penult the 32-d penultimate features.

    sorted_outputs=True adds `order` [B, N] int32 and, on a sorted pyramid,
    leaves probs and penult in morton-sorted row order (row r is input row
    order[r]); callers permute their host index maps instead of the device
    rows. On an original-order Pyramid (every engine but "window") order
    is the identity. group: the data-parallel group of the ranks that call
    it (eager); eager=True: the eager form on the card too, for
    measurement."""
    return EvalStep(model, cfg, knn_engine, sorted_outputs,
                    resolve_device(device), group, eager)


def fused_program(eval_step, name: str, tail: Callable):
    """program(state, batch) → tail(*eval_step(state, batch)): one
    program where eval_step is make_eval_step's (EvalStep.fused), else
    the two calls in turn."""
    fused = getattr(eval_step, "fused", None)
    if fused is not None:
        return fused(name, tail)
    return lambda state, batch: tuple(tail(*eval_step(state, batch)))


def save_checkpoint(path: str, state: dict):
    """Save a state_dict (tensors moved to the CPU)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state.items()}, path)


def restore_checkpoint(path: str, device: torch.device | str) -> dict:
    """Load a snapshot onto `device` as a state_dict: the port's own
    (save_checkpoint, a torch.save zip) or a JAX `snap-<n>` (flax msgpack
    of {"params", "batch_stats"}, read by flax_snapshot), told apart by
    their first bytes."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"PK\x03\x04":
        return torch.load(path, map_location=device, weights_only=True)
    return {k: v.to(device) for k, v in load_flax_snapshot(path).items()}


class Trainer:
    """Round-based trainer (ssdr_al_tpu/train/trainer.py::Trainer, on the
    host pipeline or a device pool). `state` is the model's state_dict,
    which the eval step and the samplers take.

    group: a data-parallel DataGroup (JAX's `mesh=`); `device` is then
    this rank's. Every rank builds the same state, trains on its rows of
    the same global batches and ends each step with the same parameters;
    rank 0's state is broadcast at each round's start, rank 0 alone
    writes snapshots and log lines, and the others wait for its writes.
    Every rank's dropout generator starts from the single-device seed and
    draws the global batch's mask, of which each rank keeps its rows."""

    # the seed of init_state's fresh weights; cli.seed seeds the seed
    # round's training pipeline with it too. 0, as JAX's PRNGKey(0) and
    # pipeline seed 0: only scripts/flagship.py's seed trials set another
    init_seed = 0

    def __init__(self, cfg: Config, dataset_name: str, *, save_dir: str,
                 seed_save_dir: Optional[str] = None,
                 knn_engine: str = "window",
                 log_fn: Callable[[str], None] = print,
                 weights: Optional[np.ndarray] = None,
                 device: torch.device | str = DEFAULT_DEVICE, group=None):
        if knn_engine not in KNN_ENGINES:
            raise ValueError(f"unknown knn engine {knn_engine!r}; options: "
                             f"{KNN_ENGINES}")
        self.cfg = cfg
        self.dataset_name = dataset_name
        self.knn_engine = knn_engine
        self.save_dir = save_dir
        self.seed_save_dir = seed_save_dir
        self.group = group
        self.log = log_fn if group is None or group.lead else _quiet
        self.device = resolve_device(device)
        self.model = RandLANet(cfg).to(self.device)
        set_data_group(self.model, group)
        self.weights = (get_class_weights(dataset_name) if weights is None
                        else np.asarray(weights, np.float32))
        self.steps_per_epoch = cfg.train_steps
        self.train_step = make_train_step(self.model, cfg, self.weights,
                                          knn_engine, device=self.device,
                                          group=group)
        self.pooled_step = make_pooled_train_step(
            self.model, cfg, self.weights, knn_engine, device=self.device,
            group=group)
        self.possibility_step = make_possibility_pooled_train_step(
            self.model, cfg, self.weights, knn_engine, device=self.device)
        self.eval_step = make_eval_step(self.model, cfg, knn_engine, True,
                                        device=self.device, group=group)
        # Adam's capturable form where the steps are graphs (train_round)
        self.train_state = create_train_state(
            self.model, cfg, self.steps_per_epoch,
            capturable=self.device.type == "cuda" and group is None)
        self.dropout_gen = torch.Generator(self.device).manual_seed(0)
        # the last round's: every step's loss (device scalars), on the
        # card its StepGraph's stats(), and the host seconds of its
        # training epochs and evaluations (as logged)
        self.round_losses = []
        self.graph_stats = None
        self.round_times = {"train_s": 0.0, "eval_s": 0.0}

    @property
    def state(self) -> dict:
        return self.model.state_dict()

    # ------------------------------------------------------------ state ---
    def init_state(self, sample_batch=None) -> dict:
        """Fresh weights (flax initializers) drawn from `init_seed`; the
        sample batch of the JAX signature fixes no shape here."""
        gen = torch.Generator().manual_seed(self.init_seed)
        self.model.load_state_dict(init_params(self.cfg, gen))
        return self.state

    def snapshot_path(self, round_num: int) -> str:
        return os.path.join(self.save_dir, f"snap-{round_num}")

    def restore_model(self, round_num: int):
        """Round 1 restores the seed experiment's snap-1 (stored under its
        own saver dir, as the reference does)."""
        if round_num == 1 and self.seed_save_dir:
            path = os.path.join(self.seed_save_dir, "snap-1")
        else:
            path = self.snapshot_path(round_num)
        self.model.load_state_dict(restore_checkpoint(path, self.device))
        self.log(f"Model restored from {path}")

    # ------------------------------------------------------------ train ---
    def train_round(self, round_num: int, batch_iter_fn, evaluate_fn=None,
                    *, device_pool=None, batch_size: Optional[int] = None):
        """One AL round of training.

        batch_iter_fn(epoch) → iterable of batch dicts (host pipeline).
        evaluate_fn(eval_step, state) → (miou, oa), called from
        cfg.eval_start_frac of the epochs on; the best-mIoU weights are
        saved as snap-<round_num>, or the final ones when evaluate_fn is
        None.

        device_pool: an available DeviceTrainPool on the trainer's device.
        Each epoch then takes steps_per_epoch steps of blocks extracted on
        the card (`batch_size` blocks each, default cfg.batch_size), and
        batch_iter_fn is not called; a PossibilityDevicePool runs its
        schedule (cfg.batch_size blocks a step), its field kept on the pool
        between epochs. Callers update_pseudo_gt() the pool for the round.

        Every step is make_static_step's. On the card the round's steps
        are one captured program (a StepGraph): GRAPH_WARMUP eager steps,
        then a capture replayed for the rest, released at the round's end;
        `graph_stats` keeps its stats(). Under SSDR_DEBUG_WINDOW_GUARD
        (ops/gather.py), whose count reads back at every gather, and on
        the CPU the steps run eagerly. `round_losses` keeps every step's
        loss.

        Under data parallelism the steps stay eager, and the pooled batch
        is rounded down to a multiple of the world size (as JAX's mesh
        path does); the possibility pool is single-device only (its
        schedule is sequential over the batch), and callers train on the
        host pipeline instead."""
        cfg = self.cfg
        group = self.group
        state = reset_optimizer(self.train_state, cfg, self.steps_per_epoch)
        self.train_state = state
        if group is not None:
            group.broadcast_module(self.model)
        best_miou, best_oa = 0.0, 0.0
        snap = self.snapshot_path(round_num)
        bsz = batch_size or cfg.batch_size
        if device_pool is not None and device_pool.device != self.device:
            raise ValueError(f"device pool on {device_pool.device}, trainer "
                             f"on {self.device}")
        poss_pool = isinstance(device_pool, PossibilityDevicePool)
        if group is not None and poss_pool:
            raise ValueError("the possibility pool is single-device only; "
                             "train on the host pipeline under dp")
        if group is not None and device_pool is not None and \
                bsz % group.size:
            new_bsz = max(1, bsz // group.size) * group.size
            self.log(f"dp pooled training: batch {bsz} not divisible by "
                     f"mesh size {group.size} — rounding to {new_bsz}")
            bsz = new_bsz
        path = ("possibility" if poss_pool else "host" if device_pool is None
                else "pool")

        def draws(epoch):
            if path == "host":
                return batch_iter_fn(epoch)
            if path == "pool":
                return (dict(zip(POOL_INPUTS, device_pool.sample_indices(bsz)))
                        for _ in range(self.steps_per_epoch))
            return [None] * self.steps_per_epoch

        inputs, step = make_static_step(
            self.model, cfg, self.weights, self.knn_engine, path,
            pool=device_pool, device=self.device, group=group)
        run = functools.partial(step, state, self.dropout_gen)
        graph = None
        # eager steps under dp, whose BatchNorm, loss and gradient
        # all-reduces run over the group's gloo or NCCL process group
        # outside any graph (ROADMAP.md §3), and under
        # SSDR_DEBUG_WINDOW_GUARD, which reads its clamp count back at
        # every gather (a host sync, which a capture refuses)
        if self.device.type == "cuda" and group is None and \
                not gather_ops.DEBUG_WINDOW_GUARD:
            gens = [self.dropout_gen] + ([] if device_pool is None
                                         else [device_pool.generator])
            run = graph = StepGraph(run, gens, self.device)
        if poss_pool:
            device_pool.field.copy_(
                device_pool.init_possibility
                if device_pool.poss_state is None
                else device_pool.poss_state)

        def one_step(d):
            if inputs is not None:
                inputs.stage(d)
            return _advance(state, run)

        def mean(xs):
            return float(torch.stack(xs).float().mean()) if xs else 0.0

        self.round_losses, self.graph_stats = [], None
        self.round_times = {"train_s": 0.0, "eval_s": 0.0}
        for epoch in range(cfg.max_epoch):
            t0 = time.time()
            losses, accs, act_sum = [], [], 0.0
            metrics = None
            for d in draws(epoch):
                metrics = one_step(d)
                # a graph's outputs are rewritten by its next replay
                losses.append(metrics["loss"].clone())
                accs.append(metrics["accuracy"].clone())
            if metrics is not None:
                act_sum = metrics["activation_sum"]
            if poss_pool:
                device_pool.poss_state = device_pool.field.clone()
            self.round_losses += losses
            loss, acc = mean(losses), mean(accs)    # waits for the steps
            train_s = time.time() - t0
            self.round_times["train_s"] += train_s
            self.log(
                f"Round {round_num} | epoch={epoch} "
                f"L_out={loss:.3f} Acc={acc:.2f} "
                f"train costTime={train_s:.1f}s "
                f"activation_sum={float(act_sum):.0f}")
            if evaluate_fn is not None and \
                    epoch + 1 >= int(cfg.max_epoch * cfg.eval_start_frac):
                t1 = time.time()
                miou, oa = evaluate_fn(self.eval_step, self.state)
                if miou > best_miou:
                    best_miou, best_oa = miou, oa
                    self._save(snap)
                eval_s = time.time() - t1
                self.round_times["eval_s"] += eval_s
                self.log(
                    f"Round {round_num} | Best m_IoU is: {best_miou:.3f}, "
                    f"OA is: {best_oa:.3f} | val costTime={eval_s:.1f}s")
        if evaluate_fn is None:
            self._save(snap)
        if graph is not None:
            # release the graph's memory: its gradients are the last
            # pointers into its pool
            self.graph_stats = graph.stats()
            state.optimizer.zero_grad(set_to_none=True)
        return best_miou, best_oa

    def _save(self, path: str):
        """save_checkpoint on rank 0; every rank leaves once it is
        written."""
        if self.group is None or self.group.lead:
            save_checkpoint(path, self.state)
        if self.group is not None:
            self.group.barrier()


def _quiet(msg: str):
    """The log of a rank other than 0."""
