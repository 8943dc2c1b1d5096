"""Prediction exporters (numpy copies of ssdr_al_tpu/utils/visualize.py's
write_prediction_ply and export_semantic3d_labels)."""

from __future__ import annotations

import numpy as np

from ssdr_al_torch.data.ply import write_ply


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
