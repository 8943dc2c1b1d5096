"""Training and the eval step (counterpart of ssdr_al_tpu/train/trainer.py).

One train step is pyramid → forward (train mode) → activation-masked
weighted CE → backward → Adam step. Its blocks come from the host
pipeline (make_train_step), from a DeviceTrainPool on the card
(make_pooled_train_step: the step uploads [B] cloud ids and [B, 3] picks
and extracts and shuffles the blocks there), or from a PossibilityDevicePool
(make_possibility_pooled_train_step: the Semantic3D schedule runs on the
card and the field threads through the steps). The round loop evaluates from
`eval_start_frac` of its epochs on and keeps the best-mIoU `snap-<round>`
(reference RandLANet.py:217-282). Adam runs at lr0 · decay^epoch with a
fresh optimizer and step count each round (reset_lr, RandLANet.py:
213-215), as optax.adam over `make_lr_schedule` does in the JAX package.

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
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
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
from ssdr_al_torch.train.device_pool import shuffle_blocks
from ssdr_al_torch.train.flax_snapshot import load_flax_snapshot
from ssdr_al_torch.train.possibility_pool import (
    PossibilityDevicePool,
    possibility_extract,
)

__all__ = ["init_params", "make_eval_step", "make_train_step",
           "make_pooled_train_step", "make_possibility_pooled_train_step",
           "make_lr_schedule", "TrainState", "create_train_state",
           "reset_optimizer", "apply_gradients", "save_checkpoint",
           "restore_checkpoint", "Trainer"]

ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8     # optax.adam's defaults


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
                       steps_per_epoch: int) -> TrainState:
    schedule = make_lr_schedule(cfg, steps_per_epoch)
    opt = torch.optim.Adam(model.parameters(), lr=schedule(0),
                           betas=ADAM_BETAS, eps=ADAM_EPS)
    return TrainState(model, opt, schedule)


def reset_optimizer(state: TrainState, cfg: Config,
                    steps_per_epoch: int) -> TrainState:
    """Per-round lr reset: a fresh Adam and step counter, same model."""
    return create_train_state(state.model, cfg, steps_per_epoch)


def apply_gradients(state: TrainState) -> TrainState:
    """One Adam update from the parameters' .grad, at the learning rate of
    the step count before it (optax's order); the count then advances."""
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedule(state.step)
    state.optimizer.step()
    state.step += 1
    return state


def _tensor(x, dtype, device):
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _make_step_body(model: RandLANet, cfg: Config, weights: np.ndarray,
                    knn_engine: str, device: torch.device, group=None):
    """body(state, xyz, features, labels, activation, pseudo, generator)
    → (state, metrics) on [B, N, ...] tensors on `device`: the part of a
    train step after its blocks are on the card.

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
        apply_gradients(state)
        metrics = {"loss": loss, "accuracy": acc, "activation_sum": act_sum}
        return state, metrics

    return body


def make_train_step(model: RandLANet, cfg: Config, weights: np.ndarray,
                    knn_engine: str = "window", *,
                    device: torch.device | str = DEFAULT_DEVICE, group=None):
    """Return train_step(state, batch, generator) → (state, metrics).

    batch: {"xyz", "features", "labels", "activation", "pseudo"} numpy
    [B, N, ...] arrays; generator draws the dropout mask (on `device`).
    On a sorted pyramid the loss is taken in morton-sorted row order, with
    pseudo, labels and activation permuted by pyramid.order instead of
    unsorting the logits (the loss averages over points). The state is
    updated in place: parameters, Adam moments, BatchNorm statistics and
    the step count. With a data-parallel group (set on the model too,
    set_data_group) every rank passes the same global batch and uploads
    its rows."""
    device = resolve_device(device)
    body = _make_step_body(model, cfg, weights, knn_engine, device, group)

    def rows(x):
        x = np.asarray(x)
        return x if group is None else group.shard_rows(x)

    def train_step(state: TrainState, batch, generator: torch.Generator):
        return body(state, *(
            _tensor(rows(batch[k]), dt, device) for k, dt in (
                ("xyz", torch.float32), ("features", torch.float32),
                ("labels", torch.int64), ("activation", torch.float32),
                ("pseudo", torch.int64))), generator)

    return train_step


def make_pooled_train_step(model: RandLANet, cfg: Config,
                           weights: np.ndarray, knn_engine: str = "window",
                           *, device: torch.device | str = DEFAULT_DEVICE,
                           group=None):
    """Return pooled_step(state, pool, cloud_ids, picks, generator) →
    (state, metrics): a train step over a DeviceTrainPool on `device`.
    cloud_ids [B] and picks [B, 3] are the pool's host draws
    (pool.sample_indices), the only upload of the step; the blocks are
    extracted on the card (extract_blocks) and shuffled (shuffle_blocks),
    both drawing from the pool's generator; generator draws the dropout
    mask. With a data-parallel group every rank holds a pool seeded alike
    and passes the global draws; it extracts and shuffles its rows, taking
    its rows of each global random draw, so the blocks are those of the
    single-device step."""
    device = resolve_device(device)
    body = _make_step_body(model, cfg, weights, knn_engine, device, group)

    def pooled_step(state: TrainState, pool, cloud_ids, picks,
                    generator: torch.Generator):
        blocks = shuffle_blocks(pool.extract(cloud_ids, picks, group),
                                pool.generator, group)
        return body(state, *blocks, generator)

    return pooled_step


def make_possibility_pooled_train_step(
        model: RandLANet, cfg: Config, weights: np.ndarray,
        knn_engine: str = "window", *,
        device: torch.device | str = DEFAULT_DEVICE):
    """Return step(state, pool, poss, generator) → (state, new_poss,
    metrics): a train step over a PossibilityDevicePool on `device` (the
    Semantic3D training path). The B-block possibility schedule
    (possibility_extract, augmented when pool.augment), the blocks'
    shuffle (shuffle_blocks) and the step run on the card with nothing
    uploaded; poss is the field, threaded through the steps by the
    caller; generator draws the dropout mask."""
    device = resolve_device(device)
    body = _make_step_body(model, cfg, weights, knn_engine, device)

    def step(state: TrainState, pool, poss, generator: torch.Generator):
        new_poss, *blocks = possibility_extract(
            *pool.device_args(), pool.class_weight, poss, pool.generator,
            cfg.batch_size, cfg.num_points, cfg.noise_init / 10, pool.window,
            pool.augment)
        state, metrics = body(state, *shuffle_blocks(blocks, pool.generator),
                              generator)
        return state, new_poss, metrics

    return step


def make_eval_step(model: RandLANet, cfg: Config, knn_engine: str = "window",
                   sorted_outputs: bool = True, *,
                   device: torch.device | str = DEFAULT_DEVICE):
    """Return eval_step(state, batch) → (probs, penult[, order]).

    batch: {"xyz": [B, N, 3], "features": [B, N, 6]} numpy or tensors;
    state: a state_dict of `model` on `device`. probs are the softmax of
    the logits, penult the 32-d penultimate features.

    sorted_outputs=True adds `order` [B, N] int32 and, on a sorted pyramid,
    leaves probs and penult in morton-sorted row order (row r is input row
    order[r]); callers permute their host index maps instead of the device
    rows. On an original-order Pyramid (every engine but "window") order
    is the identity."""
    device = resolve_device(device)

    def eval_step(state, batch):
        xyz = _tensor(batch["xyz"], torch.float32, device)
        feats = _tensor(batch["features"], torch.float32, device)
        model.eval()
        with torch.inference_mode():
            pyramid = build_pyramid(xyz, cfg, engine=knn_engine)
            sorted_mode = sorted_outputs and isinstance(pyramid, SortedPyramid)
            logits, penult = functional_call(
                model, state, (feats, pyramid), {"unsort": not sorted_mode})
            probs = torch.softmax(logits, dim=-1)
            if not sorted_outputs:
                return probs, penult
            if sorted_mode:
                order = pyramid.order
            else:
                b, n = xyz.shape[:2]
                order = torch.arange(n, dtype=torch.int32,
                                     device=device).expand(b, n)
            return probs, penult, order

    return eval_step


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
                                        device=self.device)
        self.train_state = create_train_state(self.model, cfg,
                                              self.steps_per_epoch)
        self.dropout_gen = torch.Generator(self.device).manual_seed(0)

    @property
    def state(self) -> dict:
        return self.model.state_dict()

    # ------------------------------------------------------------ state ---
    def init_state(self, sample_batch=None) -> dict:
        """Fresh weights (flax initializers) drawn from seed 0; the sample
        batch of the JAX signature fixes no shape here."""
        gen = torch.Generator().manual_seed(0)
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

        Under data parallelism the pooled batch is rounded down to a
        multiple of the world size (as JAX's mesh path does); the
        possibility pool is single-device only (its schedule is
        sequential over the batch), and callers train on the host
        pipeline instead."""
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

        def mean(xs):
            return float(torch.stack(xs).float().mean()) if xs else 0.0

        for epoch in range(cfg.max_epoch):
            t0 = time.time()
            losses, accs, act_sum = [], [], 0.0
            metrics = None
            if poss_pool:
                poss = device_pool.poss_state
                if poss is None:
                    poss = device_pool.init_possibility
                for _ in range(self.steps_per_epoch):
                    state, poss, metrics = self.possibility_step(
                        state, device_pool, poss, self.dropout_gen)
                    losses.append(metrics["loss"])
                    accs.append(metrics["accuracy"])
                device_pool.poss_state = poss
            elif device_pool is not None:
                for _ in range(self.steps_per_epoch):
                    ids, picks = device_pool.sample_indices(bsz)
                    state, metrics = self.pooled_step(
                        state, device_pool, ids, picks, self.dropout_gen)
                    losses.append(metrics["loss"])
                    accs.append(metrics["accuracy"])
            else:
                for batch in batch_iter_fn(epoch):
                    state, metrics = self.train_step(state, batch,
                                                     self.dropout_gen)
                    losses.append(metrics["loss"])
                    accs.append(metrics["accuracy"])
            if metrics is not None:
                act_sum = metrics["activation_sum"]
            self.log(
                f"Round {round_num} | epoch={epoch} "
                f"L_out={mean(losses):.3f} Acc={mean(accs):.2f} "
                f"train costTime={time.time() - t0:.1f}s "
                f"activation_sum={float(act_sum):.0f}")
            if evaluate_fn is not None and \
                    epoch + 1 >= int(cfg.max_epoch * cfg.eval_start_frac):
                t1 = time.time()
                miou, oa = evaluate_fn(self.eval_step, self.state)
                if miou > best_miou:
                    best_miou, best_oa = miou, oa
                    self._save(snap)
                self.log(
                    f"Round {round_num} | Best m_IoU is: {best_miou:.3f}, "
                    f"OA is: {best_oa:.3f} | val costTime="
                    f"{time.time() - t1:.1f}s")
        if evaluate_fn is None:
            self._save(snap)
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
