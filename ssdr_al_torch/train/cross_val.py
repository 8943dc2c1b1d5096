"""Scoring of saved prediction PLYs (numpy copies of
ssdr_al_tpu/train/cross_val.py's score_prediction_plys and six_fold_cv;
reference utils/6_fold_cv.py): OA, per-class IoU and mIoU recomputed from
one PLY per room with fields 'pred' and 'class'."""

from __future__ import annotations

import glob
import os

import numpy as np

from ssdr_al_torch.data.ply import read_ply
from ssdr_al_torch.train.metrics import confusion_matrix, iou_from_confusion


def score_prediction_plys(pred_dir: str, num_classes: int = 13) -> dict:
    """pred_dir: directory of <room>.ply files with 'pred' and 'class'.
    Returns {"oa": …, "miou": …, "iou": [per class]}."""
    files = sorted(glob.glob(os.path.join(pred_dir, "*.ply")))
    if not files:
        raise FileNotFoundError(f"no prediction PLYs under {pred_dir}")
    conf = np.zeros((num_classes, num_classes), np.int64)
    correct = seen = 0
    for path in files:
        data = read_ply(path)
        pred = np.asarray(data["pred"]).astype(np.int64)
        gt = np.asarray(data["class"]).astype(np.int64)
        conf += confusion_matrix(gt, pred, num_classes)
        correct += int((pred == gt).sum())
        seen += len(gt)
    iou = iou_from_confusion(conf.astype(np.float64))
    return {"oa": correct / max(seen, 1), "miou": float(np.mean(iou)),
            "iou": [float(x) for x in iou]}


def six_fold_cv(base_dir: str, num_classes: int = 13, log=print) -> dict:
    """The same scores over the prediction PLYs of Area_1 … Area_6 under
    base_dir together (the 6-fold protocol); logs one line."""
    conf = np.zeros((num_classes, num_classes), np.int64)
    correct = seen = 0
    for area in range(1, 7):
        for path in sorted(glob.glob(os.path.join(base_dir, f"Area_{area}",
                                                  "*.ply"))):
            data = read_ply(path)
            pred = np.asarray(data["pred"]).astype(np.int64)
            gt = np.asarray(data["class"]).astype(np.int64)
            conf += confusion_matrix(gt, pred, num_classes)
            correct += int((pred == gt).sum())
            seen += len(gt)
    iou = iou_from_confusion(conf.astype(np.float64))
    result = {"oa": correct / max(seen, 1), "miou": float(np.mean(iou)),
              "iou": [float(x) for x in iou]}
    log(f"6-fold: OA={result['oa']:.4f} mIoU={result['miou']:.4f}")
    return result
