"""Colored PLY and label exporters (numpy copies of
ssdr_al_tpu/utils/visualize.py): points colored by label or by
superpoint, predictions with their ground truth, and Semantic3D .labels
submissions."""

from __future__ import annotations

import colorsys
import random

import numpy as np

from ssdr_al_torch.data.ply import write_ply


def random_colors(n, bright=True, seed=0):
    """HSV-spread random palette (helper_tool.py:289-295)."""
    brightness = 1.0 if bright else 0.7
    hsv = [(0.15 + i / float(n), 1, brightness) for i in range(n)]
    colors = [colorsys.hsv_to_rgb(*c) for c in hsv]
    random.Random(seed).shuffle(colors)
    return np.asarray(colors, np.float32)


def write_label_ply(path, xyz, labels, num_classes=None, palette=None):
    """Points colored by label id (x, y, z, red, green, blue, class)."""
    labels = np.asarray(labels).astype(np.int64)
    num_classes = num_classes or int(labels.max()) + 1
    if palette is None:
        palette = random_colors(num_classes)
    rgb = (palette[labels % len(palette)] * 255).astype(np.uint8)
    write_ply(path, [np.asarray(xyz, np.float32), rgb,
                     labels.astype(np.int32)],
              ["x", "y", "z", "red", "green", "blue", "class"])


def write_superpoint_ply(path, xyz, in_component, seed=0):
    """Points colored by superpoint id (x, y, z, red, green, blue,
    superpoint), a palette of at most 1024 colors."""
    in_component = np.asarray(in_component).astype(np.int64)
    n_sp = int(in_component.max()) + 1
    palette = random_colors(min(n_sp, 1024), seed=seed)
    rgb = (palette[in_component % len(palette)] * 255).astype(np.uint8)
    write_ply(path, [np.asarray(xyz, np.float32), rgb,
                     in_component.astype(np.int32)],
              ["x", "y", "z", "red", "green", "blue", "superpoint"])


def write_prediction_ply(path, xyz, pred, gt):
    """Prediction and ground truth in one PLY (x, y, z, pred, class), the
    input of train.cross_val.score_prediction_plys."""
    write_ply(path, [np.asarray(xyz, np.float32),
                     np.asarray(pred, np.int32), np.asarray(gt, np.int32)],
              ["x", "y", "z", "pred", "class"])


def export_semantic3d_labels(path, sub_probs, proj_idx, label_values=None):
    """Upsample sub-cloud probabilities to the full cloud through proj_idx
    and write the ascii .labels submission file (reference
    partition/write_Semantic3d.py); label_values maps class index →
    submission label id. Returns the written labels."""
    preds = np.argmax(np.asarray(sub_probs)[np.asarray(proj_idx)], axis=1)
    if label_values is not None:
        preds = np.asarray(label_values)[preds]
    np.savetxt(path, preds.astype(np.int32), fmt="%d")
    return preds
