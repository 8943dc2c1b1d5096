"""knn_window of ssdr_al_torch against ssdr_al_tpu's on the CPU: the XLA
form (equal up to distance ties), the K1 form (K1's plain version against
JAX's Pallas kernel in interpret mode, equal up to K1's accepted ties),
both probe counts and both curves, the small-cloud exact answer, the
two-probe merge, the shifted Hilbert codes, knn(engine="window") and
JAX's recall gates (tests/test_knn.py::TestKnnWindow) applied to the
port."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdr_al_torch.data.synthetic import make_room
from ssdr_al_torch.ops import knn as tk
from torch_parity import NEAR_TIE_REL, assert_near_ties, interpret, t

jk = importlib.import_module("ssdr_al_tpu.ops.knn")

torch.set_num_threads(1)

# the XLA form on both sides computes the same difference-form d²; XLA may
# contract a product into an FMA, which moves a d² by ~ε relative
XLA_TIE_REL = 1e-6


def _clouds(seed, ns, nq, b=1, scale=6.0):
    rng = np.random.RandomState(seed)
    return ((rng.rand(b, ns, 3) * scale).astype(np.float32),
            (rng.rand(b, nq, 3) * scale).astype(np.float32))


def _jax_window(sup, qry, k, **kw):
    with interpret():
        return np.asarray(jk.knn_window(jnp.asarray(sup), jnp.asarray(qry),
                                        k, **kw))


def _assert_rows(got, want, sup, qry, rel):
    assert got.shape == want.shape and got.dtype == np.int32
    for b in range(got.shape[0]):
        assert_near_ties(qry[b], sup[b], got[b], want[b], rel=rel)


# ------------------------------------------------------------ parity ---


@pytest.mark.parametrize("curve", ["morton", "hilbert"])
@pytest.mark.parametrize("probes", [1, 2])
def test_xla_form_matches_jax(probes, curve):
    """impl="xla" (unaligned windows, exact top-k per window) against
    JAX's _knn_window_single, upsample-style (queries ≠ support): equal up
    to distance ties."""
    sup, qry = _clouds(1, 3000, 2600)
    kw = dict(window=1024, impl="xla", probes=probes, curve=curve)
    got = tk.knn_window(t(sup), t(qry), 16, **kw).numpy()
    _assert_rows(got, _jax_window(sup, qry, 16, **kw), sup, qry,
                 XLA_TIE_REL)


@pytest.mark.parametrize("curve", ["morton", "hilbert"])
@pytest.mark.parametrize("probes", [1, 2])
def test_k1_form_matches_jax(probes, curve):
    """impl="pallas" (K1's plain version here) against JAX's
    _knn_window_single_pallas with its kernel in interpret mode: the same
    starts, so the same windows; indices equal up to K1's tie rule (the
    TPU kernel keeps 12 mantissa bits of d² for the window index)."""
    sup, qry = _clouds(2, 3000, 2600)
    kw = dict(window=1024, impl="pallas", probes=probes, curve=curve)
    got = tk.knn_window(t(sup), t(qry), 16, **kw).numpy()
    _assert_rows(got, _jax_window(sup, qry, 16, **kw), sup, qry,
                 NEAR_TIE_REL)


@pytest.mark.parametrize("k,nq", [(1, 3000), (5, 300), (16, 3000)])
def test_k1_form_widths_and_self_search(k, nq):
    """K1 is built for k = 1 and 16: k = 5 runs the width 16 and keeps its
    first five columns, which are JAX's k = 5 answer up to ties; a
    self-search (query = support) over two batch rows, and 300 queries
    (one tile of 384 rows, 84 of them pads)."""
    sup, _ = _clouds(3, 3000, 0, b=2)
    qry = sup if nq == 3000 else sup[:, :nq]
    kw = dict(window=1024, impl="pallas")
    got = tk.knn_window(t(sup), t(qry), k, **kw).numpy()
    _assert_rows(got, _jax_window(sup, qry, k, **kw), sup, qry,
                 NEAR_TIE_REL)
    if nq == 3000 and k == 16:
        assert (got[..., 0] == np.arange(3000)).mean() > 0.99


def test_auto_is_the_k1_form():
    sup, qry = _clouds(4, 2000, 700)
    got = tk.knn_window(t(sup), t(qry), 16, window=512)
    assert torch.equal(got, tk.knn_window(t(sup), t(qry), 16, window=512,
                                          impl="pallas"))


@pytest.mark.parametrize("ns,k", [(100, 8), (1024, 16), (2000, 1)])
def test_small_cloud_is_exact(ns, k):
    """ns ≤ window (or ns < 2k) takes the exact search, K6 (its plain
    version here): equal to knn_tiled, and to JAX's answer (knn_approx,
    exact on the CPU) up to ties of its matmul-form d²."""
    sup, qry = _clouds(5, ns, 600)
    got = tk.knn_window(t(sup), t(qry), k, window=2048)
    assert torch.equal(got, tk.knn_tiled(t(sup), t(qry), k))
    _assert_rows(got.numpy(), _jax_window(sup, qry, k, window=2048), sup,
                 qry, 1e-3)


def test_merge_probes_matches_jax():
    """merge_probes against JAX's _merge_probes on candidate sets that
    share ids (duplicates set to +inf before the top k)."""
    rng = np.random.RandomState(6)
    sup = (rng.rand(2, 400, 3) * 4).astype(np.float32)
    qry = (rng.rand(2, 90, 3) * 4).astype(np.float32)
    i1 = rng.randint(0, 40, (2, 90, 8)).astype(np.int32)
    i2 = rng.randint(0, 40, (2, 90, 8)).astype(np.int32)
    for row in (i1, i2):      # distinct ids within a search's row
        row[:] = np.argsort(rng.rand(2, 90, 40), -1)[..., :8]
    got = tk.merge_probes(t(sup), t(qry), t(i1), t(i2), 8).numpy()
    for b in range(2):
        want = np.asarray(jk._merge_probes(sup[b], qry[b], i1[b], i2[b], 8))
        assert_near_ties(qry[b], sup[b], got[b], want, rel=XLA_TIE_REL)
        assert all(len(set(r)) == 8 for r in got[b])


@pytest.mark.parametrize("shift", [0, 512])
def test_shifted_hilbert_codes_equal(shift):
    rng = np.random.RandomState(7)
    xyz = (rng.rand(5000, 3) * 9 - 3).astype(np.float32)
    lo, hi = xyz.min(0), xyz.max(0)
    want = np.asarray(jk.hilbert_codes(jnp.asarray(xyz), jnp.asarray(lo),
                                       jnp.asarray(hi), shift))
    got = tk.hilbert_codes(t(xyz), t(lo), t(hi), shift).numpy()
    np.testing.assert_array_equal(got, want)


def test_knn_window_engine_passes_keywords():
    sup, qry = _clouds(8, 3000, 1000, b=2)
    s, q = t(sup), t(qry)
    got = tk.knn(s, q, 16, engine="window", window=512, probes=2)
    assert torch.equal(got, tk.knn_window(s, q, 16, window=512, probes=2))
    assert not torch.equal(got, tk.knn(s, q, 16, engine="window"))
    with pytest.raises(TypeError):
        tk.knn(s, q, 16, engine="window", tile=3)


@pytest.mark.parametrize("kw", [dict(impl="pallas", k=17),
                                dict(impl="pallas", window=8192),
                                dict(impl="kd"), dict(impl="auto", k=17)])
def test_knn_window_refuses(kw):
    """The K1 form takes k ≤ 16 and window ≤ 4096, as JAX's Pallas impl,
    and "auto" is the K1 form; an unknown impl raises too."""
    sup, qry = _clouds(9, 10000, 300)
    k = kw.pop("k", 16)
    with pytest.raises(ValueError):
        tk.knn_window(t(sup), t(qry), k, **kw)


def test_xla_form_takes_k_above_16():
    sup, qry = _clouds(10, 3000, 500)
    got = tk.knn_window(t(sup), t(qry), 24, window=1024, impl="xla")
    _assert_rows(got.numpy(), _jax_window(sup, qry, 24, window=1024,
                                          impl="xla"), sup, qry,
                 XLA_TIE_REL)


# ------------------------------------------- JAX's recall gates, ported ---


@pytest.fixture(scope="module")
def room():
    """tests/test_knn.py's scene: an 8000-point room from RandomState(0),
    and the exact 16 nearest of its first 500 points."""
    pts = make_room(np.random.RandomState(0), "r", num_points=8000).xyz
    d2 = ((pts[:500, None] - pts[None]) ** 2).sum(-1)
    return pts[None], [set(r) for r in np.argsort(d2, 1)[:, :16]]


def _recall(idx, exact, rows=500):
    return np.mean([len(set(g) & e) / 16
                    for g, e in zip(idx[0][:rows], exact[:rows])])


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_recall_on_scene(room, impl):
    pts, exact = room
    idx = tk.knn_window(t(pts), t(pts), 16, window=2048, impl=impl).numpy()
    assert _recall(idx, exact) >= 0.93


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_two_probe_lifts_recall(room, impl):
    """probes=2 beats one probe by more than 0.01 at W=512, returns valid,
    distinct ids, and at two windows of 512 is within 0.03 of one window
    of 1024."""
    pts, exact = room
    s = t(pts)
    i1 = tk.knn_window(s, s, 16, window=512, impl=impl).numpy()
    i2 = tk.knn_window(s, s, 16, window=512, probes=2, impl=impl).numpy()
    ifull = tk.knn_window(s, s, 16, window=1024, impl=impl).numpy()
    assert (i2 >= 0).all() and (i2 < pts.shape[1]).all()
    assert all(len(set(r)) == 16 for r in i2[0][:500])
    r1, r2 = _recall(i1, exact), _recall(i2, exact)
    assert r2 > r1 + 0.01, (r1, r2)
    assert r2 >= _recall(ifull, exact) - 0.03, (r2, _recall(ifull, exact))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_upsample_k1_agreement(impl):
    pts = np.random.RandomState(0).rand(1, 6000, 3).astype(np.float32)
    sub = pts[:, :1500]
    idx = tk.knn_window(t(sub), t(pts), 1, window=1024, impl=impl).numpy()
    d2 = ((pts[0][:300, None] - sub[0][None]) ** 2).sum(-1)
    assert (idx[0][:300, 0] == d2.argmin(1)).mean() > 0.93


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_hilbert_recall_on_par_with_morton(room, impl):
    pts, exact = room
    s = t(pts)

    def recall(curve):
        idx = tk.knn_window(s, s, 16, window=512, curve=curve,
                            impl=impl).numpy()
        assert (idx >= 0).all() and (idx < pts.shape[1]).all()
        assert all(len(set(r)) == 16 for r in idx[0][:200])
        return _recall(idx, exact, 400)

    rm, rh = recall("morton"), recall("hilbert")
    assert rh >= rm - 0.01, (rm, rh)
