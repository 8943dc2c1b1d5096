"""Vote-smoothed evaluation with possibility scheduling and full-resolution
reprojection (counterpart of ssdr_al_tpu/train/evaluator.py; reference
Network.evaluate_test_s3dis, RandLANet.py:290-424):
  - per-cloud probability accumulators, vote smoothing 0.95·old + 0.05·new
  - possibility-driven block sampling until the least-visited point has
    gained 1
  - sub-cloud confusion rescaled by the true class proportions, or
    probabilities reprojected to the full-resolution points (`val_proj`)
  - OA and mIoU (IoU_from_confusions) over the clouds
Probabilities come back from the device as float16, as in the JAX package,
so both accumulate the same votes.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ssdr_al_torch.data.cloud import Cloud
from ssdr_al_torch.data.dataset import PossibilityEvalPipeline
from ssdr_al_torch.train.metrics import confusion_matrix, iou_from_confusion


def simple_evaluate(eval_step, state, batches, num_classes,
                    ignored_label_inds=()):
    """Plain batched validation without vote smoothing (Network.evaluate,
    RandLANet.py:426-484): a confusion matrix over fixed batches, dropping
    ignored-label points (labels shifted down by their count). eval_step
    returns torch tensors, as make_eval_step's does."""
    conf = np.zeros((num_classes, num_classes), np.int64)
    correct = seen = 0
    pending = []
    for batch in batches:
        res = eval_step(state, batch)
        pending.append((batch, res[0], res[2] if len(res) == 3 else None))
    for batch, probs, order in pending:
        pred = probs.argmax(-1).cpu().numpy().ravel()
        labels = np.asarray(batch["labels"])
        if order is not None:
            # sorted outputs: row r is input row order[r]
            labels = np.take_along_axis(
                labels, order.cpu().numpy().astype(np.int64), axis=1)
        labels = labels.ravel()
        if ignored_label_inds:
            keep = ~np.isin(labels, ignored_label_inds)
            pred = pred[keep]
            labels = labels[keep] - len(ignored_label_inds)
        correct += int((pred == labels).sum())
        seen += len(labels)
        conf += confusion_matrix(labels, pred, num_classes)
    tp = np.diag(conf)
    union = conf.sum(0) + conf.sum(1) - tp
    iou = tp / np.maximum(union, 1)
    return float(iou.mean()), correct / max(seen, 1)


class Evaluator:
    """evaluate(eval_step, state) → (mIoU, OA) over the validation clouds."""

    def __init__(self, cfg, clouds: List[Cloud], *,
                 val_proj: Optional[List[np.ndarray]] = None,
                 val_labels: Optional[List[np.ndarray]] = None,
                 seed: int = 0, max_epochs: int = 100):
        self.cfg = cfg
        self.clouds = clouds
        if val_proj is None and all(c.proj_idx is not None for c in clouds):
            # projection artifacts loaded with the clouds (_proj.pkl)
            val_proj = [c.proj_idx for c in clouds]
            val_labels = [c.full_labels for c in clouds]
        self.val_proj = val_proj
        self.val_labels = val_labels
        self.seed = seed
        self.max_epochs = max_epochs

    def __call__(self, eval_step, state):
        """eval_step(state, batch) → (probs, penult[, order]) tensors."""
        cfg = self.cfg
        pipe = PossibilityEvalPipeline(self.clouds, cfg, seed=self.seed)
        test_probs = [np.zeros((c.num_points, cfg.num_classes), np.float32)
                      for c in self.clouds]
        test_smooth = 0.95
        last_min = -0.5
        for _ in range(self.max_epochs):
            # launch the epoch's device work, then fold the results: block
            # sampling does not depend on the probabilities
            pending = []
            for _ in range(cfg.val_steps):
                batch = pipe.get_batch(cfg.val_batch_size)
                res = eval_step(state, batch)
                pending.append((batch, res[0].half(),
                                res[2] if len(res) == 3 else None))
                if pipe.global_min > last_min + 1:
                    break
            for batch, probs, order in pending:
                probs = probs.cpu().numpy()   # [B, N, C] float16
                order = None if order is None else order.cpu().numpy()
                for j in range(probs.shape[0]):
                    ci = int(batch["cloud_idx"][j])
                    p_idx = batch["point_idx"][j]
                    if order is not None:
                        # sorted outputs: row r is input row order[r]
                        p_idx = p_idx[order[j]]
                    test_probs[ci][p_idx] = (
                        test_smooth * test_probs[ci][p_idx]
                        + (1 - test_smooth) * probs[j])
            if last_min + 1 < pipe.global_min:
                break
        return self._finalize(test_probs)

    def _finalize(self, test_probs):
        cfg = self.cfg
        confs, correct, seen = [], 0, 0
        if self.val_proj is not None:
            # reproject to full resolution (RandLANet.py:375-419)
            for ci in range(len(self.clouds)):
                labels = self.val_labels[ci]
                preds = test_probs[ci][self.val_proj[ci]].argmax(axis=1)
                correct += int((preds == labels).sum())
                seen += len(labels)
                confs.append(confusion_matrix(labels, preds, cfg.num_classes))
            c = np.sum(confs, axis=0)
        else:
            # sub-cloud confusion, rows rescaled to the true per-class point
            # proportions (RandLANet.py:298-302, 365)
            proportions = np.zeros(cfg.num_classes, np.float64)
            for ci, cloud in enumerate(self.clouds):
                preds = test_probs[ci].argmax(axis=1)
                labels = cloud.labels
                correct += int((preds == labels).sum())
                seen += len(labels)
                confs.append(confusion_matrix(labels, preds, cfg.num_classes))
                proportions += np.bincount(
                    labels, minlength=cfg.num_classes).astype(np.float64)
            c = np.sum(confs, axis=0).astype(np.float64)
            c *= (proportions / (c.sum(axis=1) + 1e-6))[:, None]
        ious = iou_from_confusion(np.asarray(c, np.float64))
        return float(np.mean(ious)), float(correct / max(seen, 1))
