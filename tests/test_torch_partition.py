"""The port's superpoint partition against the JAX package on the CPU, on
the same numpy inputs from a seed: geof (closed-form 3×3 eigh and the
four features), the voxel-grid subsample (numpy and torch variants), the
three cut-pursuit library calls, the KNN graph (host: bitwise; K6's plain
version at k up to 64 against knn_pallas in interpret mode and against
the host graph up to distance ties), partition_cloud, compute_superpoints
and its registry files, the superpoint graph and the SPG pipeline.

Tolerances of geof (ops/geof.py::agreement_tolerance, per point from its
neighbourhood's f64 eigenvalues): both sides compute in f32 in the same
closed form, in other summation orders (XLA's reductions against
torch's). All four features agree within 2e-5 where the eigenvalues are
5 % of λ1 apart and above 1e-3 of λ1. Where λ2 or λ3 is under 1e-3 of λ1
(a line, a plane), that eigenvalue carries an absolute error of a few ulp
of λ1 on both sides and its square root magnifies it: the features built
on that root then agree within 5e-4 (√(4·2⁻²⁴) ≈ 4.9e-4 of √λ1). Where two
eigenvalues nearly meet, the closed form's arccos near ±1 turns an ulp
into ~√ulp: the eigenvalue features agree within 5e-4, and an ulp moves
the eigenvectors inside their plane, so verticality agrees only within
JAX's own 1e-2 against LAPACK; where they are equal in exact arithmetic
(a tilted regular polygon) the two sides may pick other in-plane vectors:
the eigenvalues and the plane agree."""

import importlib
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdr_al_tpu.active import state as j_state
from ssdr_al_tpu.data.synthetic import make_dataset
from ssdr_al_tpu.ops import geof as j_geof
from ssdr_al_tpu.ops import grid_subsample as j_grid
from ssdr_al_tpu.partition import cp as j_cp
from ssdr_al_tpu.partition import sp_graph as j_spg
from ssdr_al_tpu.partition import spg as j_pipe
from ssdr_al_tpu.partition import superpoint as j_sp
from ssdr_al_torch.active import state as t_state
from ssdr_al_torch.ops import geof as t_geof
from ssdr_al_torch.ops import grid_subsample as t_grid
from ssdr_al_torch.ops import knn as t_knn
from ssdr_al_torch.partition import cp as t_cp
from ssdr_al_torch.partition import sp_graph as t_spg
from ssdr_al_torch.partition import spg as t_pipe
from ssdr_al_torch.partition import superpoint as t_sp
from torch_parity import interpret

j_knn = importlib.import_module("ssdr_al_tpu.ops.knn")  # ops/__init__ shadows the module

torch.set_num_threads(1)



def _below(a, b):
    """Every entry of a strictly below b (broadcast)."""
    a, b = np.broadcast_arrays(np.asarray(a), np.asarray(b))
    assert (a < b).all(), f"max excess {(a - b).max()} at {np.argmax(a - b)}"


def _hoods(kind, rng, groups, k=45):
    """`groups` neighbourhoods of k + 1 points each, every point's
    neighbours the other k of its group: random anisotropic ("random",
    spreads 3 : 1.5 : 0.7), a noisy plane ("planar", 1 : 1 : 1e-3) or
    isotropic ("isotropic"), each rotated at random and moved 10 m."""
    scale = {"random": [3.0, 1.5, 0.7], "planar": [1.0, 1.0, 1e-3],
             "isotropic": [1.0, 1.0, 1.0]}[kind]
    pts = []
    for _ in range(groups):
        rot, _ = np.linalg.qr(rng.randn(3, 3))
        pts.append((rng.randn(k + 1, 3) * scale) @ rot.T + rng.randn(3) * 10)
    xyz = np.concatenate(pts).astype(np.float32)
    g = np.arange(len(xyz)) // (k + 1)
    nb = np.stack([np.flatnonzero((g == g[i]) & (np.arange(len(xyz)) != i))
                   for i in range(len(xyz))]).astype(np.int32)
    return xyz, nb


def _covs(xyz, nb):
    pos = xyz[np.concatenate([np.arange(len(xyz))[:, None], nb], 1)]
    c = pos - pos.mean(1, keepdims=True)
    return (np.einsum("nki,nkj->nij", c, c) / nb.shape[1]).astype(np.float32)


def test_agreement_tolerance_by_shape():
    """A line's neighbourhood loosens linearity, planarity and scattering
    (√λ2, √λ3) and verticality (λ2 ≈ λ3), a plane's planarity and
    scattering (√λ3), a ball's none; two near-equal eigenvalues (a disc)
    loosen all four."""
    lam = np.array([[1.0, 1e-5, 1e-6], [1.0, 0.9, 1e-6], [1.0, 0.5, 0.2],
                    [1.0, 0.99, 0.2]])
    tol = t_geof.agreement_tolerance(lam)
    a, s, n = t_geof.ATOL, t_geof.ATOL_SQRT, t_geof.ATOL_NEAR_TIE
    np.testing.assert_array_equal(tol, [[s, s, s, n], [a, s, s, a],
                                        [a, a, a, a], [s, s, s, n]])


@pytest.mark.parametrize("kind", ["random", "planar", "isotropic"])
def test_eigh3x3_matches_jax(kind):
    """Eigenvalues within 1e-5 of λ1; each eigenvector parallel to JAX's
    (|cos| within 1e-4 of 1) where its eigenvalue is 1e-2 of λ1 from the
    others."""
    xyz, nb = _hoods(kind, np.random.RandomState(1), 40)
    cov = _covs(xyz, nb)
    lj, vj = map(np.asarray, j_geof.eigh3x3(jnp.asarray(cov)))
    lt, vt = (x.numpy() for x in t_geof.eigh3x3(torch.from_numpy(cov)))
    scale = np.abs(lj[:, :1])
    _below(np.abs(lt - lj), 1e-5 * scale + 1e-12)
    gaps = np.abs(lj[:, :, None] - lj[:, None, :]) + np.eye(3) * 1e9
    separated = gaps.min(-1) > 1e-2 * scale
    cos = np.abs((vt * vj).sum(-2))                         # [n, 3]
    assert separated.mean() > 0.3
    _below(1 - cos[separated], 1e-4)


def test_eigh3x3_equal_eigenvalues_keep_the_plane():
    """A tilted regular 12-gon (λ1 = λ2 in exact arithmetic) and a regular
    octahedron (λ1 = λ2 = λ3): the eigenvalues agree; on the polygon the
    normal agrees and both sides' in-plane vectors lie in its plane,
    whichever ones ulp differences picked; on the octahedron both take
    the isotropic fallback's columns."""
    a = np.arange(12) * 2 * np.pi / 12
    rot, _ = np.linalg.qr(np.random.RandomState(2).randn(3, 3))
    poly = (np.stack([np.cos(a), np.sin(a), 0 * a], 1) @ rot.T).astype(
        np.float32)
    octa = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    cov = np.stack([c.T @ c / len(c) for c in (poly, octa)]).astype(
        np.float32)
    lj, vj = map(np.asarray, j_geof.eigh3x3(jnp.asarray(cov)))
    lt, vt = (x.numpy() for x in t_geof.eigh3x3(torch.from_numpy(cov)))
    np.testing.assert_allclose(lt, lj, atol=1e-6)
    normal = vj[0, :, 2]
    assert abs(abs(normal @ vt[0, :, 2]) - 1) < 1e-4
    assert np.abs(normal @ vt[0, :, :2]).max() < 1e-3
    np.testing.assert_array_equal(vt[1], vj[1])


@pytest.mark.parametrize("kind", ["random", "planar", "isotropic"])
def test_geometric_features_matches_jax(kind):
    """The four features against JAX's at 45 neighbours within
    agreement_tolerance: the tight ATOL on every feature of most random
    and isotropic neighbourhoods (all but those where two eigenvalues
    nearly meet), ATOL_SQRT on the plane's planarity and scattering. A
    chunk of 64 rows gives the same features as one chunk."""
    xyz, nb = _hoods(kind, np.random.RandomState(3), 30)
    want = np.asarray(j_geof.geometric_features(xyz, nb))
    got = t_geof.geometric_features(torch.from_numpy(xyz),
                                    torch.from_numpy(nb)).numpy()
    tol = t_geof.agreement_tolerance(
        t_geof.neighbourhood_eigenvalues(xyz, nb))
    _below(np.abs(got - want), tol)
    if kind == "planar":
        assert (tol[:, 1:3] == t_geof.ATOL_SQRT).all()
    else:
        assert (tol == t_geof.ATOL).all(1).mean() > 0.5
    small = t_geof.geometric_features(torch.from_numpy(xyz),
                                      torch.from_numpy(nb), chunk=64)
    np.testing.assert_array_equal(small.numpy(), got)


def test_geometric_features_on_a_room_matches_jax():
    """On a synthetic room's cKDTree 45-NN neighbourhoods (walls, floor,
    boxes): every feature within agreement_tolerance, 99 % of them within
    the tight ATOL."""
    from scipy.spatial import cKDTree

    room = make_dataset(num_train=1, num_val=0, num_points=3000,
                        hard=True)[0][0]
    xyz = room.xyz.astype(np.float32)
    nb = cKDTree(xyz).query(xyz, k=46)[1][:, 1:].astype(np.int32)
    want = np.asarray(j_geof.geometric_features(xyz, nb))
    got = t_geof.geometric_features(torch.from_numpy(xyz),
                                    torch.from_numpy(nb)).numpy()
    d = np.abs(got - want)
    _below(d, t_geof.agreement_tolerance(
        t_geof.neighbourhood_eigenvalues(xyz, nb)))
    assert (d < t_geof.ATOL).mean() > 0.99


# ------------------------------------------------------- grid subsample ---


@pytest.mark.parametrize("with_feat,with_lab", [(False, False), (True, False),
                                                (False, True), (True, True)])
def test_grid_subsample_np_bitwise(with_feat, with_lab):
    rng = np.random.RandomState(4)
    pts = (rng.rand(3000, 3) * 3 - 1).astype(np.float32)
    feat = rng.rand(3000, 4).astype(np.float32) if with_feat else None
    lab = rng.randint(0, 5, 3000) if with_lab else None
    want = j_grid.grid_subsample_np(pts, feat, lab, grid_size=0.2)
    got = t_grid.grid_subsample_np(pts, feat, lab, grid_size=0.2)
    for a, b in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("max_voxels", [700, 300])
def test_grid_subsample_torch_matches_jax(max_voxels):
    """The padded torch variant against grid_subsample_jax: the same voxel
    count and order, labels and valid mask equal, means within 1 ulp of
    the mean's scale (f32 sums in another order), zero rows past the
    voxels; with fewer slots than voxels (300 of 512) both drop the
    voxels past them."""
    rng = np.random.RandomState(5)
    pts = (rng.rand(2000, 3) * 2).astype(np.float32)
    feat = rng.rand(2000, 3).astype(np.float32)
    lab = rng.randint(0, 4, 2000).astype(np.int32)
    jp, jf, jl, jv = map(np.asarray, j_grid.grid_subsample_jax(
        pts, 0.25, max_voxels, features=feat, labels=lab, num_classes=4))
    tp, tf, tl, tv = (x.numpy() for x in t_grid.grid_subsample_torch(
        torch.from_numpy(pts), 0.25, max_voxels,
        features=torch.from_numpy(feat), labels=torch.from_numpy(lab),
        num_classes=4))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=4e-7)
    np.testing.assert_allclose(tf, jf, rtol=0, atol=4e-7)
    assert (tp[~tv] == 0).all() and (tl[~tv] == 0).all()
    ref = j_grid.grid_subsample_np(pts, feat, lab, grid_size=0.25)
    np.testing.assert_allclose(tp[tv], ref[0][:max_voxels], atol=4e-7)
    np.testing.assert_array_equal(tl[tv], ref[2][:max_voxels])
    assert tv.all() == (len(ref[0]) >= max_voxels)


# ------------------------------------------------------------ cut-pursuit ---


def _room_graph(seed=6, n=3000):
    room = make_dataset(num_train=1, num_val=0, num_points=n, hard=True,
                        seed=seed)[0][0]
    src, tgt, dist, nb = j_sp.knn_graph(room.xyz.astype(np.float32), 10, 20,
                                        backend="host")
    return room, src, tgt, dist, nb


def test_cutpursuit_matches_jax():
    """The same C++ built by g++ into build/native/ with native/Makefile's
    flags: components and in_component equal to the JAX binding's."""
    room, src, tgt, dist, _ = _room_graph()
    rng = np.random.RandomState(7)
    obs = np.hstack([rng.rand(len(room.xyz), 4), room.colors]).astype(
        np.float32)
    w = (1.0 / (1.0 + dist / dist.mean())).astype(np.float32)
    for reg in (0.01, 0.1):
        jc, ji = j_cp.cutpursuit(obs, src, tgt, w, reg)
        tc, ti = t_cp.cutpursuit(obs, src, tgt, w, reg)
        np.testing.assert_array_equal(ti, ji)
        assert len(tc) == len(jc) > 1
        for a, b in zip(tc, jc):
            np.testing.assert_array_equal(a, b)
    lib = t_cp.build()
    assert lib.parent == t_cp.BUILD_DIR and lib.name.startswith("libssdrcp_")


def test_connected_components_matches_jax():
    room, src, tgt, _, _ = _room_graph(seed=8, n=1500)
    labels = np.random.RandomState(8).randint(0, 3, len(room.xyz))
    np.testing.assert_array_equal(
        t_cp.connected_components(len(room.xyz), src, tgt, labels),
        j_cp.connected_components(len(room.xyz), src, tgt, labels))


def test_grid_subsample_native_matches_jax():
    rng = np.random.RandomState(9)
    pts = (rng.rand(2500, 3) * 2).astype(np.float32)
    feat = rng.rand(2500, 3).astype(np.float32)
    lab = rng.randint(0, 6, 2500)
    for args in ((pts,), (pts, feat), (pts, None, lab), (pts, feat, lab)):
        want = j_cp.grid_subsample_native(*args, grid_size=0.3)
        got = t_cp.grid_subsample_native(*args, grid_size=0.3)
        for a, b in zip(want if isinstance(want, tuple) else (want,),
                        got if isinstance(got, tuple) else (got,)):
            np.testing.assert_array_equal(a, b)


def test_cutpursuit_refuses_bad_edges():
    obs = np.zeros((4, 2), np.float32)
    e = np.array([0, 1], np.uint32)
    with pytest.raises(ValueError, match="past n_ver"):
        t_cp.cutpursuit(obs, e, np.array([1, 4], np.uint32),
                        np.ones(2, np.float32), 0.1)


# --------------------------------------------------------------- KNN graph ---


def test_knn_graph_host_matches_jax():
    """backend="host": source, target, distances and target_geof bitwise
    equal to JAX's (the same cKDTree query)."""
    room = make_dataset(num_train=1, num_val=0, num_points=2500, hard=True,
                        seed=10)[0][0]
    xyz = room.xyz.astype(np.float32)
    want = j_sp.knn_graph(xyz, 10, 45, backend="host")
    got = t_sp.knn_graph(xyz, 10, 45, backend="host", device="cpu")
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [2, 5, 17, 46, 64])
def test_knn_tiled_any_k_matches_knn_pallas(k):
    """K6's plain version at widths between and above the model's (46:
    the partition's k_geof + 1) equals knn_pallas in interpret mode index
    for index (Ns=512, Nq=256)."""
    rng = np.random.RandomState(k)
    s = rng.randn(1, 512, 3).astype(np.float32)
    q = rng.randn(1, 256, 3).astype(np.float32)
    with interpret():
        want = np.asarray(j_knn.knn_pallas(s, q, k))
    got = t_knn.knn_tiled(torch.from_numpy(s), torch.from_numpy(q), k)
    np.testing.assert_array_equal(got.numpy(), want)


def _same_up_to_ties(xyz, idx_a, idx_b, rel=1e-6):
    """Row by row, the f64 distances of two neighbour lists agree column by
    column within `rel` (two exact top-k lists can differ only by the
    order of near-equal distances); returns the differing entries."""
    x = xyz.astype(np.float64)
    da = np.linalg.norm(x[idx_a] - x[:, None], axis=-1)
    db = np.linalg.norm(x[idx_b] - x[:, None], axis=-1)
    _below(np.abs(da - db), rel * db + 1e-9)
    return int((idx_a != idx_b).sum())


def test_knn_graph_device_matches_host_up_to_ties():
    """backend="device" (K6; its plain version on the CPU) against JAX's
    host graph on a room with duplicated points: the 46 neighbours agree
    up to distance ties, the edges' distances within 1e-6 relative, and
    on the room as it is (no exact ties) the graphs are equal."""
    room = make_dataset(num_train=1, num_val=0, num_points=2500, hard=True,
                        seed=11)[0][0]
    xyz = room.xyz.astype(np.float32)
    for cloud in (xyz, np.concatenate([xyz, xyz[:300]])):
        js, jt, jd, jg = j_sp.knn_graph(cloud, 10, 45, backend="host")
        ts, tt, td, tg = t_sp.knn_graph(cloud, 10, 45, backend="device",
                                        device="cpu")
        np.testing.assert_array_equal(ts, js)
        differ = _same_up_to_ties(cloud, tg, jg)
        np.testing.assert_allclose(td, jd, rtol=1e-6)
        if len(cloud) == len(xyz):
            assert differ == 0
            np.testing.assert_array_equal(tt, jt)


def test_knn_tiled_refuses_k_above_64():
    """k past K6's widest instantiation raises on the CPU as on the card."""
    x = torch.zeros(1, 100, 3)
    with pytest.raises(ValueError, match="built for"):
        t_knn.knn_tiled(x, x, 65)
    assert t_knn.knn_kernel_k(46) == 64 and t_knn.knn_kernel_k(5) == 16


def test_knn_backend_auto_follows_the_device():
    assert t_sp.resolve_backend("auto", torch.device("cpu")) == "host"
    assert t_sp.resolve_backend("auto", torch.device("cuda")) == "device"
    assert t_sp.resolve_backend("host", torch.device("cuda")) == "host"
    with pytest.raises(ValueError):
        t_sp.resolve_backend("approx", torch.device("cpu"))


# --------------------------------------------------------------- partition ---


def test_partition_cloud_host_matches_jax():
    """partition_cloud on the host backend: the same components as JAX's
    at two regularisation strengths (geof agrees within its tolerance and
    cut-pursuit takes the same cuts); the stage times are reported."""
    room = make_dataset(num_train=1, num_val=0, num_points=3000, hard=True,
                        seed=12)[0][0]
    for reg, k_geof in ((0.05, 20), (0.008, 45)):
        jc, ji = j_sp.partition_cloud(room.xyz, room.colors, reg,
                                      k_geof=k_geof, knn_backend="host")
        times = {}
        tc, ti = t_sp.partition_cloud(room.xyz, room.colors, reg,
                                      k_geof=k_geof, knn_backend="host",
                                      device="cpu", times=times)
        np.testing.assert_array_equal(ti, ji)
        assert len(tc) == len(jc)
        assert set(times) == {"knn_backend", "knn_ms", "geof_ms",
                              "cutpursuit_s"}


def test_compute_superpoints_matches_jax(tmp_path):
    """compute_superpoints on the host backend writes the same
    .superpoint, .gt and total.pkl files as JAX's, byte for byte, and the
    same size distribution."""
    train, _ = make_dataset(num_train=2, num_val=0, num_points=3000,
                            hard=True, seed=13)
    j_st = j_state.ALState(str(tmp_path / "jax"))
    t_st = t_state.ALState(str(tmp_path / "torch"))
    jt = j_sp.compute_superpoints(train, j_st, 0.05, k_geof=20,
                                  knn_backend="host", log=lambda *a: None)
    times = []
    tt = t_sp.compute_superpoints(train, t_st, 0.05, k_geof=20,
                                  knn_backend="host", device="cpu",
                                  log=lambda *a: None, times=times)
    assert tt["sp_num"] == jt["sp_num"] > 10
    names = sorted(os.listdir(j_st.superpoint_dir))
    assert names == sorted(os.listdir(t_st.superpoint_dir))
    for name in names:
        with open(os.path.join(j_st.superpoint_dir, name), "rb") as a, \
                open(os.path.join(t_st.superpoint_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    assert [t["name"] for t in times] == [c.name for c in train]
    cloud_names = [c.name for c in train]
    assert t_sp.superpoint_size_distribution(t_st, cloud_names) == \
        j_sp.superpoint_size_distribution(j_st, cloud_names)


# ----------------------------------------------------- superpoint graph ---


def _assert_same_dict(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, dict):
            _assert_same_dict(x, y)
        elif isinstance(x, list) and x and isinstance(x[0], np.ndarray):
            assert len(x) == len(y)
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            assert np.asarray(x).dtype == np.asarray(y).dtype, key


def test_compute_sp_graph_matches_jax():
    room, src, tgt, dist, _ = _room_graph(seed=14, n=2000)
    comps, in_comp = j_sp.partition_cloud(room.xyz, room.colors, 0.05,
                                          k_geof=20, knn_backend="host")
    for labels, n_labels in ((room.labels, 8), (np.zeros(1), 1)):
        _assert_same_dict(
            t_spg.compute_sp_graph(room.xyz, 5.0, in_comp, comps, labels,
                                   n_labels),
            j_spg.compute_sp_graph(room.xyz, 5.0, in_comp, comps, labels,
                                   n_labels))


@pytest.mark.parametrize("prune", [0.0, 0.05])
def test_spg_pipeline_matches_jax(prune):
    room = make_dataset(num_train=1, num_val=0, num_points=2500, hard=True,
                        seed=15)[0][0]
    kw = dict(prune_size=prune, reg_strength=0.05, k_geof=20,
              knn_backend="host")
    want = j_pipe.spg_pipeline(room.xyz, room.colors, room.labels, **kw)
    got = t_pipe.spg_pipeline(room.xyz, room.colors, room.labels,
                              device="cpu", **kw)
    _assert_same_dict(got, want)


def test_superpoint_registry_loads_in_both_states(tmp_path):
    """The port's registry files read back through JAX's ALState."""
    train, _ = make_dataset(num_train=1, num_val=0, num_points=2000,
                            hard=True, seed=16)
    st = t_state.ALState(str(tmp_path))
    total = t_sp.compute_superpoints(train, st, 0.05, k_geof=20,
                                     knn_backend="host", device="cpu",
                                     log=lambda *a: None)
    j_total = j_state.ALState(str(tmp_path)).load_registry()
    assert j_total["sp_num"] == total["sp_num"]
    sp = j_state.ALState(str(tmp_path)).load_superpoints(train[0].name)
    assert sp.num_superpoints == total["sp_num"]
    with open(os.path.join(st.superpoint_dir, train[0].name + ".gt"),
              "rb") as f:
        assert pickle.load(f).shape == (2, train[0].num_points)
