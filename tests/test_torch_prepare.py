"""The port's offline preparation against the JAX package on the CPU, on
the same files made from a seed: the text tables (numpy in place of
pandas), the raw-format readers, the label upsampling, the PLY exporters
(embedding2ply's PCA against sklearn's), the HDF5 superpoint-graph files,
the S3DIS, Semantic3D and SemanticKITTI writers, and the entry points
cli.prepare and cli.superpoint with --device cpu. Every comparison is
exact (the same bytes, or equal arrays of the same dtype) but that of the
PCA's f64 transform, held within 1e-12."""

import os
import pickle
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from ssdr_al_tpu.cli import prepare as j_cli_prepare
from ssdr_al_tpu.cli import superpoint as j_cli_superpoint
from ssdr_al_tpu.data import prepare as j_prep
from ssdr_al_tpu.partition import provider as j_prov
from ssdr_al_tpu.partition import sp_graph as j_spg
from ssdr_al_torch.cli import prepare as t_cli_prepare
from ssdr_al_torch.cli import superpoint as t_cli_superpoint
from ssdr_al_torch.data import prepare as t_prep
from ssdr_al_torch.data.synthetic import make_dataset
from ssdr_al_torch.partition import provider as t_prov

torch.set_num_threads(1)


def _same_tree(a_dir, b_dir):
    """Two directory trees hold the same files with the same bytes."""
    files = []
    for root, _, names in os.walk(a_dir):
        files += [os.path.relpath(os.path.join(root, n), a_dir)
                  for n in names]
    other = []
    for root, _, names in os.walk(b_dir):
        other += [os.path.relpath(os.path.join(root, n), b_dir)
                  for n in names]
    assert sorted(files) == sorted(other) and files
    for rel in files:
        with open(os.path.join(a_dir, rel), "rb") as a, \
                open(os.path.join(b_dir, rel), "rb") as b:
            assert a.read() == b.read(), rel


def _same(a, b):
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------ text tables ---


@pytest.mark.parametrize("kind", ["floats", "ints", "mixed", "spaced"])
def test_read_table_matches_pandas(kind, tmp_path):
    """read_table gives pd.read_csv(sep=r"\\s+", header=None).values as
    float64 (the values of an all-integer table too), and with dtype the
    values pandas parses into that dtype."""
    rng = np.random.RandomState(1)
    path = tmp_path / "t.txt"
    if kind == "floats":
        np.savetxt(path, rng.randn(50, 6), fmt="%.6f")
    elif kind == "ints":
        np.savetxt(path, rng.randint(0, 255, (50, 3)), fmt="%d")
    elif kind == "mixed":
        np.savetxt(path, np.hstack([rng.rand(50, 3) * 5,
                                    rng.randint(0, 255, (50, 3))]),
                   fmt=["%.4f"] * 3 + ["%d"] * 3)
    else:  # tabs, runs of spaces and a blank line
        rows = [f"{a:.3f}\t {b:.3f}   {c:.3f}" for a, b, c in rng.rand(20, 3)]
        path.write_text("\n".join(rows[:10] + [""] + rows[10:]) + "\n")
    want = pd.read_csv(path, sep=r"\s+", header=None).values
    got = t_prov.read_table(str(path))
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want.astype(np.float64))
    np.testing.assert_array_equal(
        t_prov.read_table(str(path), np.float32),
        pd.read_csv(path, sep=r"\s+", header=None,
                    dtype=np.float32).values)


def _s3dis_room(root, rng, area="Area_1", room="office_1"):
    """A raw S3DIS room: Annotations/<class>_<i>.txt and the room txt."""
    anno = root / area / room / "Annotations"
    os.makedirs(anno)
    parts = []
    for name, n in (("chair_1", 120), ("wall_2", 200), ("staris_1", 40),
                    ("table_3", 90)):
        pts = np.hstack([rng.rand(n, 3) * 3, rng.randint(0, 256, (n, 3))])
        np.savetxt(anno / f"{name}.txt", pts, fmt=["%.3f"] * 3 + ["%d"] * 3)
        parts.append(pts)
    np.savetxt(root / area / room / f"{room}.txt", np.vstack(parts),
               fmt=["%.3f"] * 3 + ["%d"] * 3)
    return root / area / room


def test_read_s3dis_format_matches_jax(tmp_path):
    room = _s3dis_room(tmp_path, np.random.RandomState(2))
    path = str(room / "office_1.txt")
    _same(t_prov.read_s3dis_format(path), j_prov.read_s3dis_format(path))
    _same(t_prov.read_s3dis_format(path, label_out=False),
          j_prov.read_s3dis_format(path, label_out=False))


def _semantic3d_scan(tmp_path, rng, n=700, n_class=8):
    pts = np.hstack([rng.rand(n, 3) * 3, rng.rand(n, 1),
                     rng.randint(0, 256, (n, 3))])
    np.savetxt(tmp_path / "scan.txt", pts,
               fmt=["%.4f"] * 4 + ["%d"] * 3)
    np.savetxt(tmp_path / "scan.labels", rng.randint(0, n_class + 1, n),
               fmt="%d")
    return str(tmp_path / "scan.txt"), str(tmp_path / "scan.labels")


@pytest.mark.parametrize("voxel", [0.0, 0.4])
def test_read_semantic3d_format_matches_jax(voxel, tmp_path):
    """The chunked reader (300 lines a chunk of 700) with and without the
    voxel prune, labelled and unlabelled."""
    txt, lab = _semantic3d_scan(tmp_path, np.random.RandomState(3))
    for n_class, lab_path in ((8, lab), (0, "")):
        _same(t_prov.read_semantic3d_format(txt, n_class, lab_path, voxel,
                                            ver_batch=300),
              j_prov.read_semantic3d_format(txt, n_class, lab_path, voxel,
                                            ver_batch=300))


def test_small_readers_and_upsampling_match_jax(tmp_path):
    rng = np.random.RandomState(4)
    data = np.hstack([rng.rand(50, 6), rng.randint(0, 14, (50, 1))])
    np.save(tmp_path / "scene.npy", data)
    _same(t_prov.read_vkitti_format(str(tmp_path / "scene.npy")),
          j_prov.read_vkitti_format(str(tmp_path / "scene.npy")))
    xyz = rng.rand(300, 3) * 4
    rgb = rng.randint(0, 256, (300, 3))
    lab = rng.randint(0, 6, 300)
    _same(t_prov.prune_voxel(xyz, 0.5, rgb, lab, n_class=5),
          j_prov.prune_voxel(xyz, 0.5, rgb, lab, n_class=5))
    comps = [np.array([0, 2, 4]), np.array([1, 3])]
    _same(t_prov.reduced_labels2full(np.array([7, 9]), comps, 5),
          j_prov.reduced_labels2full(np.array([7, 9]), comps, 5))
    sub = xyz[:60].astype(np.float32)
    for labels in (lab[:60], np.eye(6)[lab[:60]]):
        for batch in (0, 70):
            _same(t_prov.interpolate_labels(xyz, sub, labels, batch),
                  j_prov.interpolate_labels(xyz, sub, labels, batch))
    np.savetxt(tmp_path / "raw.txt", np.hstack([xyz, rng.rand(300, 4)]),
               fmt="%.6f")
    _same(t_prov.interpolate_labels_batch(str(tmp_path / "raw.txt"), sub,
                                          lab[:60], ver_batch=120),
          j_prov.interpolate_labels_batch(str(tmp_path / "raw.txt"), sub,
                                          lab[:60], ver_batch=120))


# -------------------------------------------------------------- exporters ---


@pytest.mark.parametrize("dim", [4, 32, 64])
def test_pca_of_the_basis_equals_sklearn(dim):
    """pca3_of_basis gives sklearn's PCA(3) mean and components of
    [0; I_dim] bit for bit, and its transform of f32 and f64 embeddings
    within 1e-12 (the same f64 products; OpenBLAS's last bit depends on
    the arrays' alignment in memory, so an equal product is not a
    property of the formula). The colours, 255·clip((x + 1)/2) cast to
    uint8, are equal (test_ply_exporters_match_jax)."""
    from sklearn.decomposition import PCA

    x = np.vstack((np.zeros(dim), np.eye(dim)))
    pca = PCA(n_components=3).fit(x)
    mean, comp = t_prov.pca3_of_basis(dim)
    np.testing.assert_array_equal(mean, pca.mean_)
    np.testing.assert_array_equal(comp, pca.components_)
    emb = np.random.RandomState(dim).randn(100, dim)
    for e in (emb, emb.astype(np.float32)):
        np.testing.assert_allclose(e @ comp.T - mean[None] @ comp.T,
                                   pca.transform(e), rtol=0, atol=1e-12)


def test_ply_exporters_match_jax(tmp_path):
    """geof2ply, prediction2ply (classes and probabilities), error2ply and
    embedding2ply (3 and 32 channels) write the same bytes as JAX's."""
    rng = np.random.RandomState(5)
    n = 80
    xyz = rng.rand(n, 3).astype(np.float32)
    geof = rng.rand(n, 4).astype(np.float32)
    pred = rng.randint(0, 14, n)
    rgb = rng.randint(0, 255, (n, 3)).astype(np.uint8)
    labels = rng.randint(0, 14, n)
    calls = [
        ("geof2ply", (xyz, geof)),
        ("prediction2ply", (xyz, pred, 13, "s3dis")),
        ("prediction2ply", (xyz, np.eye(14)[pred], 13, "s3dis")),
        ("error2ply", (xyz, rgb, labels, pred)),
        ("embedding2ply", (xyz, rng.randn(n, 3) * 0.5)),
        ("embedding2ply", (xyz, rng.randn(n, 32).astype(np.float32))),
    ]
    for i, (name, args) in enumerate(calls):
        a, b = tmp_path / f"j{i}.ply", tmp_path / f"t{i}.ply"
        getattr(j_prov, name)(str(a), *args)
        getattr(t_prov, name)(str(b), *args)
        assert a.read_bytes() == b.read_bytes(), name


def test_spg_files_round_trip_with_jax(tmp_path):
    """write_spg / write_components of the port read back by JAX's readers
    and the other way round (h5py, imported inside the functions)."""
    rng = np.random.RandomState(6)
    xyz = np.vstack([rng.rand(40, 3), rng.rand(40, 3) + [3, 0, 0]]).astype(
        np.float32)
    in_comp = np.array([0] * 40 + [1] * 40)
    comps = [np.arange(40), np.arange(40, 80)]
    g = j_spg.compute_sp_graph(xyz, 0, in_comp, comps,
                               np.array([0] * 40 + [2] * 40), n_labels=3)
    for writer, reader in ((t_prov, j_prov), (j_prov, t_prov)):
        p, c = str(tmp_path / "g.h5"), str(tmp_path / "c.h5")
        writer.write_spg(p, g)
        writer.write_components(c, comps, in_comp)
        g2 = reader.read_spg(p)
        for key in t_prov._SP_KEYS + ("sp_labels",):
            np.testing.assert_array_equal(g2[key], g[key])
        comps2, in_comp2 = reader.read_components(c)
        np.testing.assert_array_equal(in_comp2, in_comp)
        for c1, c2 in zip(comps, comps2):
            np.testing.assert_array_equal(c1, c2)


# ---------------------------------------------------------------- writers ---


def test_write_cloud_artifacts_match_jax(tmp_path):
    """original_ply/, input_<grid>/ and _proj.pkl byte for byte, at two
    colour scales."""
    rng = np.random.RandomState(7)
    xyz = (rng.rand(3000, 3) * 5).astype(np.float32)
    colors = (rng.rand(3000, 3) * 255).astype(np.uint8)
    labels = rng.randint(0, 4, 3000).astype(np.uint8)
    for scale in (255.0, 1.0):
        out_j, out_t = tmp_path / f"j{scale}", tmp_path / f"t{scale}"
        nj = j_prep.write_cloud_artifacts(str(out_j), "roomA", xyz, colors,
                                          labels, 0.25, color_scale=scale)
        nt = t_prep.write_cloud_artifacts(str(out_t), "roomA", xyz, colors,
                                          labels, 0.25, color_scale=scale)
        assert nt == nj < 3000
        _same_tree(out_j, out_t)
    np.testing.assert_array_equal(
        t_prep.nearest_sub_index(xyz, xyz[::7], chunk=500),
        j_prep.nearest_sub_index(xyz, xyz[::7]))


def test_prepare_s3dis_matches_jax(tmp_path):
    """Two rooms of two areas prepared by both packages: the same tree."""
    rng = np.random.RandomState(8)
    raw = tmp_path / "raw"
    _s3dis_room(raw, rng, "Area_1", "office_1")
    _s3dis_room(raw, rng, "Area_5", "hallway_2")
    j_prep.prepare_s3dis(str(raw), str(tmp_path / "j"), 0.1,
                         log=lambda *a: None)
    t_prep.prepare_s3dis(str(raw), str(tmp_path / "t"), 0.1,
                         log=lambda *a: None)
    _same_tree(tmp_path / "j", tmp_path / "t")
    names = sorted(os.listdir(tmp_path / "t" / "original_ply"))
    assert names == ["Area_1_office_1.ply", "Area_5_hallway_2.ply"]


@pytest.mark.parametrize("labelled,keep_ignored", [(True, False),
                                                   (True, True),
                                                   (False, False)])
def test_prepare_semantic3d_matches_jax(labelled, keep_ignored, tmp_path):
    txt, lab = _semantic3d_scan(tmp_path, np.random.RandomState(9), n=1500)
    if not labelled:
        os.remove(lab)
    kw = dict(grid_size=0.3, keep_ignored=keep_ignored, log=lambda *a: None)
    j_prep.prepare_semantic3d(str(tmp_path), str(tmp_path / "j"), **kw)
    t_prep.prepare_semantic3d(str(tmp_path), str(tmp_path / "t"), **kw)
    _same_tree(tmp_path / "j", tmp_path / "t")


def test_prepare_semantickitti_scan_matches_jax(tmp_path):
    rng = np.random.RandomState(10)
    scan = (rng.rand(2000, 4) * 10).astype(np.float32)
    scan.tofile(tmp_path / "000000.bin")
    raw = rng.choice(list(j_prep.KITTI_LEARNING_MAP), 2000).astype(np.uint32)
    (raw | (rng.randint(0, 5, 2000).astype(np.uint32) << 16)).tofile(
        tmp_path / "000000.label")
    for lab in (str(tmp_path / "000000.label"), None):
        nj = j_prep.prepare_semantickitti_scan(
            str(tmp_path / "000000.bin"), lab, str(tmp_path / "j"), "00_0",
            grid_size=0.5)
        nt = t_prep.prepare_semantickitti_scan(
            str(tmp_path / "000000.bin"), lab, str(tmp_path / "t"), "00_0",
            grid_size=0.5)
        assert nt == nj
        _same_tree(tmp_path / "j", tmp_path / "t")


# ------------------------------------------------------------ entry points ---


def _kitti_raw(root, rng):
    for seq in ("00", "01"):
        d = root / seq / "velodyne"
        os.makedirs(d)
        os.makedirs(root / seq / "labels")
        (rng.rand(800, 4) * 8).astype(np.float32).tofile(d / "000000.bin")
        rng.choice(list(j_prep.KITTI_LEARNING_MAP), 800).astype(
            np.uint32).tofile(root / seq / "labels" / "000000.label")


@pytest.mark.parametrize("dataset", ["S3DIS", "semantic3d", "SemanticKITTI"])
def test_cli_prepare_on_the_cpu_matches_jax(dataset, tmp_path):
    """python -m ssdr_al_torch.cli.prepare --device cpu writes the tree
    that ssdr_al_tpu.cli.prepare writes from the same raw files."""
    rng = np.random.RandomState(11)
    raw = tmp_path / "raw"
    if dataset == "S3DIS":
        _s3dis_room(raw, rng, "Area_1", "office_1")
    elif dataset == "semantic3d":
        os.makedirs(raw)
        _semantic3d_scan(raw, rng, n=900)
    else:
        _kitti_raw(raw, rng)
    common = ["--dataset", dataset, "--raw", str(raw), "--grid_size", "0.2"]
    j_cli_prepare.main(common + ["--out", str(tmp_path / "j")])
    t_cli_prepare.main(common + ["--out", str(tmp_path / "t"),
                                 "--device", "cpu"])
    _same_tree(tmp_path / "j", tmp_path / "t")


def test_cli_superpoint_on_the_cpu_matches_jax(tmp_path):
    """python -m ssdr_al_torch.cli.superpoint --device cpu (knn backend
    auto: the host cKDTree) on prepared S3DIS rooms writes the registry and
    superpoint files that ssdr_al_tpu.cli.superpoint --knn_backend host
    writes on a copy of the same rooms, byte for byte."""
    train, val = make_dataset(num_train=2, num_val=1, num_points=4000,
                              hard=True, seed=12)
    for root in ("j", "t"):
        for i, c in enumerate(train + val):
            name = ("Area_5_room" if c in val else f"Area_1_room{i}")
            t_prep.write_cloud_artifacts(
                str(tmp_path / root / "S3DIS"), name, c.xyz,
                (c.colors * 255).astype(np.uint8), c.labels, 0.04)
    flags = ["--dataset", "S3DIS", "--reg_strength", "0.05",
             "--k_nn_geof", "20"]
    j_cli_superpoint.main(flags + ["--data_root", str(tmp_path / "j"),
                                   "--knn_backend", "host"])
    total, times = t_cli_superpoint.run_superpoint(
        t_cli_superpoint.parser().parse_args(
            flags + ["--data_root", str(tmp_path / "t"), "--device",
                     "cpu"]))
    sp = os.path.join("S3DIS", "0.05", "superpoint")
    _same_tree(tmp_path / "j" / sp, tmp_path / "t" / sp)
    with open(tmp_path / "t" / sp / "total.pkl", "rb") as f:
        assert pickle.load(f)["file_num"] == 2
    assert [t["knn_backend"] for t in times] == ["host", "host"]
    assert total["sp_num"] == sum(t["superpoints"] for t in times) > 20
    shutil.rmtree(tmp_path / "j")
