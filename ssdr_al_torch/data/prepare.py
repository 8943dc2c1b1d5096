"""Offline dataset preparation: raw scans → PLY + subsampled inputs + proj
(the counterpart of ssdr_al_tpu/data/prepare.py: the same files and
layout; the text tables are parsed with numpy where JAX uses pandas).

Parity with the reference prep scripts (P13 in SURVEY.md):
  S3DIS          utils/data_prepare_s3dis.py:30-81 — annotation txts →
                 original_ply/<Area_room>.ply, input_<grid>/ subclouds
                 (colors/255), projection indices.
  Semantic3D     utils/data_prepare_semantic3d_no_ignore.py:36-80 — 0.01 prune,
                 drop unlabeled (class 0) points, 0.06 subsample; the
                 keep-ignored variant keeps them (data_prepare_semantic3d.py).
  SemanticKITTI  utils/data_prepare_semantickitti.py — velodyne .bin + .label
                 remap, 0.06 grid.

The reference pickles sklearn KDTree objects per cloud; this framework stores
plain arrays instead (block queries need no tree — data/cloud.py) but writes
the same `<cloud>_proj.pkl` projection artifact: [proj_idx int32, labels],
computed as each full-res point's nearest subsampled point.
"""

from __future__ import annotations

import glob
import os
import pickle
from os.path import basename, join
from typing import Optional

import numpy as np

from ssdr_al_torch.data.ply import write_ply
from ssdr_al_torch.ops.grid_subsample import grid_subsample_np
from ssdr_al_torch.partition.provider import read_table

# S3DIS class names, index = label id (reference meta/class_names.txt order)
S3DIS_CLASS_NAMES = [
    "ceiling", "floor", "wall", "beam", "column", "window", "door",
    "table", "chair", "sofa", "bookcase", "board", "clutter",
]


def nearest_sub_index(full_xyz: np.ndarray, sub_xyz: np.ndarray,
                      chunk: int = 200_000) -> np.ndarray:
    """proj_idx[i] = index of the sub point nearest to full point i
    (data_prepare_s3dis.py:68-69). Uses scipy cKDTree (host, offline)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(sub_xyz)
    out = np.empty(len(full_xyz), np.int32)
    for s in range(0, len(full_xyz), chunk):
        out[s : s + chunk] = tree.query(full_xyz[s : s + chunk], k=1)[1]
    return out


def write_cloud_artifacts(out_root: str, name: str, xyz, colors_u8, labels,
                          grid_size: float, *, color_scale: float = 255.0):
    """original ply + input_<grid>/ sub ply + _proj.pkl for one cloud."""
    original_dir = join(out_root, "original_ply")
    sub_dir = join(out_root, "input_{:.3f}".format(grid_size))
    os.makedirs(original_dir, exist_ok=True)
    os.makedirs(sub_dir, exist_ok=True)

    xyz = np.asarray(xyz, np.float32)
    colors_u8 = np.asarray(colors_u8, np.uint8)
    labels = np.asarray(labels, np.uint8)
    write_ply(join(original_dir, name + ".ply"), [xyz, colors_u8, labels],
              ["x", "y", "z", "red", "green", "blue", "class"])

    sub_xyz, sub_colors, sub_labels = grid_subsample_np(
        xyz, features=colors_u8.astype(np.float32), labels=labels,
        grid_size=grid_size,
    )
    sub_colors = (sub_colors / color_scale).astype(np.float32)
    write_ply(join(sub_dir, name + ".ply"),
              [sub_xyz, sub_colors, sub_labels.astype(np.uint8)],
              ["x", "y", "z", "red", "green", "blue", "class"])

    proj_idx = nearest_sub_index(xyz, sub_xyz)
    with open(join(sub_dir, name + "_proj.pkl"), "wb") as f:
        pickle.dump([proj_idx, labels], f)
    return sub_xyz.shape[0]


# --------------------------------------------------------------------------
# S3DIS
# --------------------------------------------------------------------------


def prepare_s3dis_room(anno_path: str, out_root: str, name: str,
                       grid_size: float = 0.04):
    """One room's Annotations/ dir → artifacts (data_prepare_s3dis.py:30-72)."""
    data_list = []
    for f in sorted(glob.glob(join(anno_path, "*.txt"))):
        class_name = basename(f).split("_")[0]
        if class_name not in S3DIS_CLASS_NAMES:  # e.g. 'staris' → clutter
            class_name = "clutter"
        pc = read_table(f)
        label = S3DIS_CLASS_NAMES.index(class_name)
        labels = np.full((pc.shape[0], 1), label)
        data_list.append(np.concatenate([pc, labels], axis=1))
    pc_label = np.concatenate(data_list, axis=0)
    pc_label[:, 0:3] -= pc_label[:, 0:3].min(axis=0)
    return write_cloud_artifacts(
        out_root, name,
        pc_label[:, :3].astype(np.float32),
        pc_label[:, 3:6].astype(np.uint8),
        pc_label[:, 6].astype(np.uint8),
        grid_size,
    )


def prepare_s3dis(dataset_path: str, out_root: str, grid_size: float = 0.04,
                  log=print):
    """All areas: dataset_path = Stanford3dDataset_v1.2_Aligned_Version/."""
    rooms = sorted(glob.glob(join(dataset_path, "Area_*", "*", "Annotations")))
    for anno in rooms:
        parts = anno.rstrip("/").split("/")
        name = parts[-3] + "_" + parts[-2]
        n = prepare_s3dis_room(anno, out_root, name, grid_size)
        log(f"prepared {name}: {n} sub points")


# --------------------------------------------------------------------------
# Semantic3D
# --------------------------------------------------------------------------


def prepare_semantic3d_cloud(txt_path: str, labels_path: Optional[str],
                             out_root: str, *, grid_size: float = 0.06,
                             prune_size: float = 0.01, keep_ignored=False,
                             log=print):
    """One scan (x y z intensity r g b + .labels) → artifacts.

    Parity with data_prepare_semantic3d_no_ignore.py:36-80: 0.01-grid prune
    first (majority label), then drop class-0 (unlabeled) points unless
    keep_ignored, then the working-resolution subsample."""
    name = basename(txt_path)[:-4]
    pc = read_table(txt_path, np.float32)
    xyz = pc[:, :3]
    colors = pc[:, 4:7].astype(np.uint8)
    if labels_path is not None:
        labels = read_table(labels_path, np.uint8).ravel()
        # 0.01 prune with majority label
        sub_xyz, sub_col, sub_lab = grid_subsample_np(
            xyz, features=colors.astype(np.float32), labels=labels,
            grid_size=prune_size,
        )
        if not keep_ignored:
            keep = sub_lab != 0
            sub_xyz, sub_col, sub_lab = sub_xyz[keep], sub_col[keep], sub_lab[keep]
            sub_lab = sub_lab - 1  # classes become 0..7 (no_ignore variant)
        n = write_cloud_artifacts(
            out_root, name, sub_xyz, sub_col.astype(np.uint8), sub_lab,
            grid_size,
        )
    else:  # test scan without labels
        sub_xyz, sub_col = grid_subsample_np(
            xyz, features=colors.astype(np.float32), grid_size=prune_size
        )
        n = write_cloud_artifacts(
            out_root, name, sub_xyz, sub_col.astype(np.uint8),
            np.zeros(len(sub_xyz), np.uint8), grid_size,
        )
    log(f"prepared {name}: {n} sub points")
    return n


def prepare_semantic3d(dataset_path: str, out_root: str, *,
                       grid_size: float = 0.06, keep_ignored=False, log=print):
    for txt in sorted(glob.glob(join(dataset_path, "*.txt"))):
        lab = txt[:-4] + ".labels"
        prepare_semantic3d_cloud(
            txt, lab if os.path.exists(lab) else None, out_root,
            grid_size=grid_size, keep_ignored=keep_ignored, log=log,
        )


# --------------------------------------------------------------------------
# SemanticKITTI
# --------------------------------------------------------------------------

# remap from raw SemanticKITTI ids to train ids (0 = ignored), as the
# reference builds from its yaml (utils/data_prepare_semantickitti.py)
KITTI_LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}


def kitti_remap_table() -> np.ndarray:
    table = np.zeros(max(KITTI_LEARNING_MAP) + 1, np.int32)
    for k, v in KITTI_LEARNING_MAP.items():
        table[k] = v
    return table


def prepare_semantickitti_scan(bin_path: str, label_path: Optional[str],
                               out_root: str, name: str,
                               grid_size: float = 0.06):
    scan = np.fromfile(bin_path, dtype=np.float32).reshape(-1, 4)
    xyz = scan[:, :3]
    if label_path is not None:
        raw = np.fromfile(label_path, dtype=np.uint32)
        sem = (raw & 0xFFFF).astype(np.int64)
        labels = kitti_remap_table()[np.clip(sem, 0, max(KITTI_LEARNING_MAP))]
    else:
        labels = np.zeros(len(xyz), np.int32)
    colors = np.zeros((len(xyz), 3), np.uint8)  # KITTI has no RGB
    return write_cloud_artifacts(
        out_root, name, xyz, colors, labels.astype(np.uint8), grid_size,
        color_scale=1.0,
    )
