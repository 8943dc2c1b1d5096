"""SPG artifact IO, raw-format readers and PLY exporters (the counterpart
of ssdr_al_tpu/partition/provider.py).

Parity with the reference's partition/provider.py (write_spg / read_spg,
write_components / read_components): the superpoint graph built by
partition/sp_graph.py round-trips through the same h5 layout consumed by
SPG-style downstream models. Those four import h5py inside the function,
as JAX's do: h5py is optional (it is not on every machine with a card).
The text readers parse with numpy where JAX uses pandas' whitespace
reader (the same arrays and dtypes), and embedding2ply fits its PCA with
scipy's SVD and sklearn's sign rule, where JAX calls sklearn: no module
here imports pandas or sklearn.
"""

from __future__ import annotations

import itertools
from typing import List

import numpy as np

_SP_KEYS = (
    "sp_centroids", "sp_length", "sp_surface", "sp_volume", "sp_point_count",
    "source", "target", "se_delta_mean", "se_delta_std", "se_delta_norm",
    "se_delta_centroid", "se_length_ratio", "se_surface_ratio",
    "se_volume_ratio", "se_point_count_ratio",
)


def write_spg(path: str, graph: dict):
    """Persist a superpoint graph (reference provider.write_spg layout)."""
    import h5py

    with h5py.File(path, "w") as f:
        for k in _SP_KEYS:
            f.create_dataset(k, data=np.asarray(graph[k]))
        if np.size(graph.get("sp_labels", [])) > 0:
            f.create_dataset("sp_labels", data=np.asarray(graph["sp_labels"]))


def read_spg(path: str) -> dict:
    import h5py

    out = {"is_nn": False}
    with h5py.File(path, "r") as f:
        for k in f.keys():
            out[k] = f[k][()]
    out.setdefault("sp_labels", [])
    return out


def write_components(path: str, components: List[np.ndarray],
                     in_component: np.ndarray):
    """Persist a partition (reference provider.write_components layout:
    one ragged dataset per component + the dense map)."""
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("in_component",
                         data=np.asarray(in_component, np.int32))
        grp = f.create_group("components")
        for i, c in enumerate(components):
            grp.create_dataset(str(i), data=np.asarray(c, np.int64))


def read_components(path: str):
    import h5py

    with h5py.File(path, "r") as f:
        in_component = f["in_component"][()]
        grp = f["components"]
        components = [grp[str(i)][()] for i in range(len(grp))]
    return components, in_component


# ---------------------------------------------------------------------------
# Raw-format readers (reference partition/provider.py:185-372)
# ---------------------------------------------------------------------------


def read_table(source, dtype=np.float64) -> np.ndarray:
    """A whitespace-separated numeric text table (a path, or a list of its
    lines) → [rows, cols], as pd.read_csv(sep=r"\\s+", header=None).values
    reads one: blank lines skipped, no comment character. Integer columns
    come back as `dtype` (pandas keeps an all-integer table int64; every
    caller here converts to float32 or uint8 first)."""
    return np.loadtxt(source, dtype=dtype, comments=None, ndmin=2)


def _chunks(path: str, rows: int):
    """The lines of a text file, `rows` at a time (pandas' chunksize)."""
    with open(path) as f:
        while True:
            lines = list(itertools.islice(f, rows))
            if not lines:
                return
            yield lines

# SPG label ids for S3DIS: 1..13, 0 = stairs/unknown (provider.py:229-248)
S3DIS_OBJECT_LABELS = {
    "ceiling": 1, "floor": 2, "wall": 3, "column": 4, "beam": 5,
    "window": 6, "door": 7, "table": 8, "chair": 9, "bookcase": 10,
    "sofa": 11, "board": 12, "clutter": 13, "stairs": 0,
}


def object_name_to_label(object_class: str) -> int:
    """S3DIS object name → SPG label id (provider.py:229-248)."""
    return S3DIS_OBJECT_LABELS.get(object_class, 0)


def read_s3dis_format(raw_path: str, label_out: bool = True):
    """Room txt (+ Annotations/*.txt) → xyz, rgb[, labels, object indices].

    Parity with provider.read_s3dis_format:185-218: room points get the label
    of the nearest annotated object point (1-NN per object file)."""
    import glob as _glob
    import os as _os

    room = read_table(raw_path)
    xyz = np.ascontiguousarray(room[:, 0:3], dtype=np.float32)
    try:
        rgb = np.ascontiguousarray(room[:, 3:6], dtype=np.uint8)
    except (ValueError, IndexError):
        rgb = np.zeros((room.shape[0], 3), np.uint8)
    if not label_out:
        return xyz, rgb
    from scipy.spatial import cKDTree

    tree = cKDTree(xyz)
    labels = np.zeros(len(xyz), np.uint8)
    object_indices = np.zeros(len(xyz), np.uint32)
    objects = sorted(_glob.glob(
        _os.path.join(_os.path.dirname(raw_path), "Annotations", "*.txt")
    ))
    for i_object, single in enumerate(objects, start=1):
        name = _os.path.splitext(_os.path.basename(single))[0]
        label = object_name_to_label(name.split("_")[0])
        obj = read_table(single)
        _, idx = tree.query(obj[:, 0:3], k=1)
        labels[idx] = label
        object_indices[idx] = i_object
    return xyz, rgb, labels, object_indices


def read_vkitti_format(raw_path: str):
    """vKITTI npy → xyz, rgb, labels (provider.py:219-228: labels shifted +1,
    class 14 remapped to 0/unlabeled)."""
    data = np.load(raw_path)
    xyz = data[:, 0:3]
    rgb = data[:, 3:6]
    labels = data[:, -1] + 1
    labels[labels == 14] = 0
    return xyz, rgb, labels


def prune_voxel(xyz, voxel_width, rgb=None, labels=None, n_class: int = 0):
    """Voxel pruning with per-voxel label HISTOGRAMS — the numpy equivalent
    of the reference's libply_c.prune (ply_c.cpp): voxel barycenters, mean
    rgb, and per-class counts [n_sub, n_class+1]."""
    xyz = np.asarray(xyz, np.float64)
    mins = xyz.min(axis=0)
    cells = np.floor((xyz - mins) / voxel_width).astype(np.int64)
    dims = cells.max(axis=0) + 1
    key = (cells[:, 0] * dims[1] + cells[:, 1]) * dims[2] + cells[:, 2]
    uniq, inv, counts = np.unique(key, return_inverse=True,
                                  return_counts=True)
    n_sub = len(uniq)
    sub_xyz = np.zeros((n_sub, 3), np.float64)
    for d in range(3):
        sub_xyz[:, d] = np.bincount(inv, xyz[:, d], n_sub) / counts
    out = [sub_xyz.astype(np.float32)]
    if rgb is not None:
        rgb = np.asarray(rgb, np.float64)
        sub_rgb = np.zeros((n_sub, 3), np.float64)
        for d in range(3):
            sub_rgb[:, d] = np.bincount(inv, rgb[:, d], n_sub) / counts
        out.append(sub_rgb.astype(np.uint8))
    if labels is not None and n_class > 0:
        labels = np.asarray(labels, np.int64).ravel()
        hist = np.zeros((n_sub, n_class + 1), np.uint32)
        np.add.at(hist, (inv, np.clip(labels, 0, n_class)), 1)
        out.append(hist)
    return tuple(out)


def read_semantic3d_format(data_file: str, n_class: int,
                           file_label_path: str = "",
                           voxel_width: float = 0.05,
                           ver_batch: int = 5_000_000):
    """Chunked reader for huge Semantic3D scans (provider.py:250-303):
    ver_batch lines at a time, each chunk voxel-pruned independently; labels
    come back as per-voxel class histograms [n_sub, n_class+1]."""
    xyz = np.zeros((0, 3), np.float32)
    rgb = np.zeros((0, 3), np.uint8)
    labels = np.zeros((0, n_class + 1), np.uint32)

    vert_iter = _chunks(data_file, ver_batch)
    if n_class > 0:
        chunks = zip(vert_iter, _chunks(file_label_path, ver_batch))
    else:
        chunks = ((v, None) for v in vert_iter)

    for vert_chunk, label_chunk in chunks:
        v = read_table(vert_chunk)
        xyz_full = np.ascontiguousarray(v[:, 0:3], dtype=np.float32)
        rgb_full = np.ascontiguousarray(v[:, 4:7], dtype=np.uint8)
        if n_class > 0:
            lab_full = read_table(label_chunk, np.uint8).squeeze()
            if voxel_width > 0:
                s_xyz, s_rgb, s_hist = prune_voxel(
                    xyz_full, voxel_width, rgb_full, lab_full, n_class
                )
                labels = np.vstack((labels, s_hist))
            else:
                s_xyz, s_rgb = xyz_full, rgb_full
                hist = np.zeros((len(lab_full), n_class + 1), np.uint32)
                hist[np.arange(len(lab_full)),
                     np.clip(lab_full, 0, n_class)] = 1
                labels = np.vstack((labels, hist))
        else:
            if voxel_width > 0:
                s_xyz, s_rgb = prune_voxel(xyz_full, voxel_width, rgb_full)
            else:
                s_xyz, s_rgb = xyz_full, rgb_full
        xyz = np.vstack((xyz, s_xyz))
        rgb = np.vstack((rgb, s_rgb))
    if n_class > 0:
        return xyz, rgb, labels
    return xyz, rgb


# ---------------------------------------------------------------------------
# Full-resolution label upsampling (provider.py:593-651)
# ---------------------------------------------------------------------------


def reduced_labels2full(labels_red, components, n_ver: int):
    """Distribute superpoint labels to their points (provider.py:593-598)."""
    labels_full = np.zeros(n_ver, np.uint8)
    for i_com, comp in enumerate(components):
        labels_full[comp] = labels_red[i_com]
    return labels_full


def interpolate_labels(xyz_up, xyz, labels, ver_batch: int = 0):
    """1-NN label transfer from the pruned cloud to the full cloud
    (provider.py:644-651)."""
    from scipy.spatial import cKDTree

    labels = np.asarray(labels)
    if labels.ndim > 1 and labels.shape[1] > 1:
        labels = np.argmax(labels, axis=1)
    tree = cKDTree(np.asarray(xyz))
    if ver_batch and ver_batch > 0:
        out = np.empty(len(xyz_up), labels.dtype)
        for s in range(0, len(xyz_up), ver_batch):
            _, nn = tree.query(xyz_up[s:s + ver_batch], k=1)
            out[s:s + ver_batch] = labels[nn]
        return out
    _, nn = tree.query(np.asarray(xyz_up), k=1)
    return labels[nn].ravel()


def interpolate_labels_batch(data_file: str, xyz, labels,
                             ver_batch: int = 5_000_000):
    """Chunked-file variant (provider.py:600-642): read the raw scan
    ver_batch lines at a time and 1-NN-transfer labels to each chunk."""
    from scipy.spatial import cKDTree

    labels = np.asarray(labels)
    if labels.ndim > 1 and labels.shape[1] > 1:
        labels = np.argmax(labels, axis=1)
    tree = cKDTree(np.asarray(xyz))
    out = np.zeros((0,), np.uint8)
    for chunk in _chunks(data_file, ver_batch):
        _, nn = tree.query(read_table(chunk)[:, 0:3], k=1)
        out = np.hstack((out, labels[nn].astype(np.uint8).ravel()))
    return out


# ---------------------------------------------------------------------------
# Exporters (provider.py:45-99, 403-429)
# ---------------------------------------------------------------------------

# class-color tables (provider.get_color_from_label:124-180)
LABEL_COLORS = {
    "s3dis": {
        0: [0, 0, 0], 1: [233, 229, 107], 2: [95, 156, 196],
        3: [179, 116, 81], 4: [81, 163, 148], 5: [241, 149, 131],
        6: [77, 174, 84], 7: [108, 135, 75], 8: [79, 79, 76],
        9: [41, 49, 101], 10: [223, 52, 52], 11: [89, 47, 95],
        12: [81, 109, 114], 13: [233, 233, 229],
    },
    "sema3d": {
        0: [0, 0, 0], 1: [200, 200, 200], 2: [0, 70, 0], 3: [0, 255, 0],
        4: [255, 255, 0], 5: [255, 0, 0], 6: [148, 0, 211],
        7: [0, 255, 255], 8: [255, 8, 127],
    },
    "vkitti": {
        0: [0, 0, 0], 1: [200, 90, 0], 2: [0, 128, 50], 3: [0, 220, 0],
        4: [255, 0, 0], 5: [100, 100, 100], 6: [200, 200, 200],
        7: [255, 0, 255], 8: [255, 255, 0], 9: [128, 0, 255],
        10: [255, 200, 150], 11: [0, 128, 255], 12: [0, 200, 255],
        13: [255, 128, 0],
    },
}


def get_color_from_label(object_label: int, dataset: str):
    return LABEL_COLORS[dataset][int(object_label)]


def _write_xyz_rgb(filename, xyz, color_u8):
    from ssdr_al_torch.data.ply import write_ply

    write_ply(filename, [np.asarray(xyz, np.float32),
                         np.asarray(color_u8, np.uint8)],
              ["x", "y", "z", "red", "green", "blue"])


def geof2ply(filename, xyz, geof):
    """Geometric features as colors: [linearity, planarity, verticality]
    (provider.py:45-56 uses geof columns 0, 1, 3)."""
    color = np.array(255 * np.asarray(geof)[:, [0, 1, 3]], np.uint8)
    _write_xyz_rgb(filename, xyz, color)


def prediction2ply(filename, xyz, prediction, n_label, dataset):
    """Class-colored prediction PLY (provider.py:57-72)."""
    prediction = np.asarray(prediction)
    if prediction.ndim > 1 and prediction.shape[1] > 1:
        prediction = np.argmax(prediction, axis=1)
    color = np.zeros((len(xyz), 3), np.uint8)
    for i_label in range(n_label + 1):
        color[prediction == i_label] = get_color_from_label(i_label, dataset)
    _write_xyz_rgb(filename, xyz, color)


def error2ply(filename, xyz, rgb, labels, prediction):
    """Green hue = correct, red = error, keeping per-point brightness
    (provider.py:73-99)."""
    import colorsys

    prediction = np.asarray(prediction)
    labels = np.asarray(labels)
    if prediction.ndim > 1 and prediction.shape[1] > 1:
        prediction = np.argmax(prediction, axis=1)
    if labels.ndim > 1 and labels.shape[1] > 1:
        labels = np.argmax(labels, axis=1)
    color_rgb = np.asarray(rgb, np.float64) / 255.0
    out = np.zeros_like(color_rgb)
    correct = (labels == prediction) | (labels == 0)
    for i in range(len(labels)):
        h, s, v = colorsys.rgb_to_hsv(*color_rgb[i])
        h = 1.0 / 3.0 if correct[i] else 0.0
        s = min(1.0, s + 0.3)
        v = min(1.0, v + 0.1)
        out[i] = colorsys.hsv_to_rgb(h, s, v)
    _write_xyz_rgb(filename, xyz, np.array(out * 255, np.uint8))


def pca3_of_basis(dim: int):
    """(mean [dim], components [3, dim]) of sklearn's PCA(n_components=3)
    fitted on [0; I_dim], as its "full" solver computes them (the one its
    "auto" picks for this matrix up to dim = 499): scipy's SVD of the
    centred rows, each component's sign flipped so that its largest
    absolute entry is positive (svd_flip, u_based_decision=False)."""
    from scipy import linalg

    x = np.vstack((np.zeros(dim), np.eye(dim)))
    mean = np.mean(x, axis=0)
    _, _, vt = linalg.svd(x - mean, full_matrices=False)
    rows = np.argmax(np.abs(vt), axis=1)
    vt *= np.sign(vt[np.arange(vt.shape[0]), rows])[:, None]
    return mean, vt[:3]


def embedding2ply(filename, xyz, embeddings):
    """PCA-to-RGB embedding visualization (provider.py:403-429)."""
    embeddings = np.asarray(embeddings)
    if embeddings.shape[1] > 3:
        mean, comp = pca3_of_basis(embeddings.shape[1])
        # sklearn's transform: the product first, the centring after it
        embeddings = embeddings @ comp.T - (mean[None] @ comp.T)
    value = np.minimum(np.maximum((embeddings + 1) / 2, 0), 1)
    _write_xyz_rgb(filename, xyz, np.array(255 * value, np.uint8))
