"""Training and the eval step (counterpart of ssdr_al_tpu/train/trainer.py).

One train step is pyramid → forward (train mode) → activation-masked
weighted CE → backward → Adam step; the round loop evaluates from
`eval_start_frac` of its epochs on and keeps the best-mIoU `snap-<round>`
(reference RandLANet.py:217-282). Adam runs at lr0 · decay^epoch with a
fresh optimizer and step count each round (reset_lr, RandLANet.py:
213-215), as optax.adam over `make_lr_schedule` does in the JAX package.

A model state is the RandLANet module itself (parameters and BatchNorm
statistics) on the device; checkpoints are its `state_dict` saved with
torch.save. The eval step runs the module functionally on a state_dict
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
    RandLANet,
    SortedPyramid,
    build_pyramid,
    init_params,
    label_reduce_table,
    masked_weighted_ce,
)

__all__ = ["init_params", "make_eval_step", "make_train_step",
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


def make_train_step(model: RandLANet, cfg: Config, weights: np.ndarray,
                    knn_engine: str = "window", *,
                    device: torch.device | str = DEFAULT_DEVICE):
    """Return train_step(state, batch, generator) → (state, metrics).

    batch: {"xyz", "features", "labels", "activation", "pseudo"} numpy
    [B, N, ...] arrays; generator draws the dropout mask (on `device`).
    On a sorted pyramid the loss is taken in morton-sorted row order, with
    pseudo, labels and activation permuted by pyramid.order instead of
    unsorting the logits (the loss averages over points). The state is
    updated in place: parameters, Adam moments, BatchNorm statistics and
    the step count."""
    device = resolve_device(device)
    table = (torch.as_tensor(label_reduce_table(
        cfg.num_classes, cfg.ignored_label_inds), dtype=torch.long,
        device=device) if cfg.ignored_label_inds else None)
    weights = torch.as_tensor(np.asarray(weights), dtype=torch.float32,
                              device=device)

    def train_step(state: TrainState, batch, generator: torch.Generator):
        xyz = _tensor(batch["xyz"], torch.float32, device)
        feats = _tensor(batch["features"], torch.float32, device)
        labels = _tensor(batch["labels"], torch.int64, device)
        pseudo = _tensor(batch["pseudo"], torch.int64, device)
        act = _tensor(batch["activation"], torch.float32, device)
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
                                       cfg.ignored_label_inds, table)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        apply_gradients(state)
        metrics = {"loss": loss.detach(), "accuracy": acc,
                   "activation_sum": act.sum()}
        return state, metrics

    return train_step


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
    rows. On an exact pyramid (engine "xla") order is the identity."""
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
    """Load a state_dict saved by save_checkpoint onto `device`."""
    return torch.load(path, map_location=device, weights_only=True)


class Trainer:
    """Round-based trainer (ssdr_al_tpu/train/trainer.py::Trainer, the host
    pipeline path; the device pool and the data-parallel mesh are not
    ported, ROADMAP.md). `state` is the model's state_dict, which the eval
    step and the samplers take."""

    def __init__(self, cfg: Config, dataset_name: str, *, save_dir: str,
                 seed_save_dir: Optional[str] = None,
                 knn_engine: str = "window",
                 log_fn: Callable[[str], None] = print,
                 weights: Optional[np.ndarray] = None,
                 device: torch.device | str = DEFAULT_DEVICE):
        self.cfg = cfg
        self.dataset_name = dataset_name
        self.save_dir = save_dir
        self.seed_save_dir = seed_save_dir
        self.log = log_fn
        self.device = resolve_device(device)
        self.model = RandLANet(cfg).to(self.device)
        self.weights = (get_class_weights(dataset_name) if weights is None
                        else np.asarray(weights, np.float32))
        self.steps_per_epoch = cfg.train_steps
        self.train_step = make_train_step(self.model, cfg, self.weights,
                                          knn_engine, device=self.device)
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
    def train_round(self, round_num: int, batch_iter_fn, evaluate_fn=None):
        """One AL round of training.

        batch_iter_fn(epoch) → iterable of batch dicts (host pipeline).
        evaluate_fn(eval_step, state) → (miou, oa), called from
        cfg.eval_start_frac of the epochs on; the best-mIoU weights are
        saved as snap-<round_num>, or the final ones when evaluate_fn is
        None."""
        cfg = self.cfg
        state = reset_optimizer(self.train_state, cfg, self.steps_per_epoch)
        self.train_state = state
        best_miou, best_oa = 0.0, 0.0
        snap = self.snapshot_path(round_num)

        def mean(xs):
            return float(torch.stack(xs).float().mean()) if xs else 0.0

        for epoch in range(cfg.max_epoch):
            t0 = time.time()
            losses, accs, act_sum = [], [], 0.0
            for batch in batch_iter_fn(epoch):
                state, metrics = self.train_step(state, batch,
                                                 self.dropout_gen)
                losses.append(metrics["loss"])
                accs.append(metrics["accuracy"])
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
                    save_checkpoint(snap, self.state)
                self.log(
                    f"Round {round_num} | Best m_IoU is: {best_miou:.3f}, "
                    f"OA is: {best_oa:.3f} | val costTime="
                    f"{time.time() - t1:.1f}s")
        if evaluate_fn is None:
            save_checkpoint(snap, self.state)
        return best_miou, best_oa
