"""Confusion matrices and IoU, numpy (a copy of ssdr_al_tpu/train/metrics.py;
reference DataProcessing.IoU_from_confusions, helper_tool.py:237-262)."""

from __future__ import annotations

import numpy as np


def confusion_matrix(labels, preds, num_classes: int) -> np.ndarray:
    """[C, C] with rows = truth, cols = prediction (sklearn convention)."""
    labels = np.asarray(labels).ravel().astype(np.int64)
    preds = np.asarray(preds).ravel().astype(np.int64)
    mask = (labels >= 0) & (labels < num_classes)
    idx = labels[mask] * num_classes + preds[mask]
    return np.bincount(idx, minlength=num_classes * num_classes).reshape(
        num_classes, num_classes
    )


def iou_from_confusion(confusions: np.ndarray) -> np.ndarray:
    """IoU per class; a class absent from the truth takes the mean IoU of
    the present ones (the reference's backfill)."""
    confusions = np.asarray(confusions, np.float64)
    tp = np.diagonal(confusions, axis1=-2, axis2=-1)
    tp_fn = np.sum(confusions, axis=-1)
    tp_fp = np.sum(confusions, axis=-2)
    iou = tp / (tp_fp + tp_fn - tp + 1e-6)
    mask = tp_fn < 1e-3
    counts = np.sum(1 - mask, axis=-1, keepdims=True)
    miou = np.sum(iou, axis=-1, keepdims=True) / (counts + 1e-6)
    return iou + mask * miou
