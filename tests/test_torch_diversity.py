"""The paper's comparison branches of ssdr_al_torch against ssdr_al_tpu on
the CPU: farthest-superpoint sampling and the per-cloud chamfer of the
edcd branch, k-center greedy and the coreGCN module (adjacency, forward,
AdamW fit, sampling), the edcd selection and the RandomSampler and
AllSampler rounds on the same state directory."""

import importlib
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssdr_al_tpu.active import gcn as j_gcn
from ssdr_al_tpu.active import region_graph as j_rg
from ssdr_al_tpu.active import samplers as j_samplers
from ssdr_al_tpu.active import state as j_state
from ssdr_al_torch.active import gcn as t_gcn
from ssdr_al_torch.active import region_graph as t_rg
from ssdr_al_torch.active import samplers as t_samplers
from ssdr_al_torch.active import state as t_state
from ssdr_al_torch.data.synthetic import grid_superpoints
from ssdr_al_torch.data.synthetic import make_dataset
from ssdr_al_torch.ops import chamfer as t_ch
from ssdr_al_torch.ops import fps as t_fps
from ssdr_al_torch.ops import kcenter as t_kc
from torch_parity import t

j_ch = importlib.import_module("ssdr_al_tpu.ops.chamfer")
j_fps = importlib.import_module("ssdr_al_tpu.ops.fps")
j_kc = importlib.import_module("ssdr_al_tpu.ops.kcenter")
torch.set_num_threads(1)

# f32 on both sides, other summation orders: the adjacency and the forward
GCN_TOL = dict(rtol=1e-5, atol=1e-5)
# a few AdamW steps from the same parameters (dropout off): the moments'
# rounding differs (optax divides by the bias corrections, torch folds
# them into the step size), each step moves a parameter by at most lr
FIT_TOL = dict(rtol=1e-5, atol=1e-6)
CHAMFER_RTOL = 1e-5       # K3's plain version vs JAX's exact form


def _superpoints(seed, s=40, p=64):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(s, p, 3) * 0.3).astype(np.float32)
    msk = rng.rand(s, p) < 0.7
    msk[:, 0] = True                          # no empty superpoint
    cents = (rng.rand(s, 3) * 5).astype(np.float32)
    return pts, msk, cents


def test_chamfer_pairwise_matches_jax_exact():
    pts, msk, _ = _superpoints(0)
    want = np.asarray(j_ch.chamfer_pairwise(jnp.asarray(pts),
                                            jnp.asarray(msk)))
    got = t_ch.chamfer_pairwise(t(pts), t(msk)).numpy()
    np.testing.assert_allclose(got, want, rtol=CHAMFER_RTOL, atol=0)
    assert np.all(np.diag(got) == 0)
    msk[3] = False
    with pytest.raises(ValueError, match="empty"):
        t_ch.chamfer_pairwise(t(pts), t(msk))


@pytest.mark.parametrize("trigger,number", [(0, 12), (7, 40)])
def test_farthest_superpoint_sample_picks_equal(trigger, number):
    """ED² of the centres + the chamfer row, on JAX's own chamfer matrix
    and on the port's: the same picks."""
    pts, msk, cents = _superpoints(1)
    cd = np.asarray(j_ch.chamfer_pairwise(jnp.asarray(pts), jnp.asarray(msk)))
    want = np.asarray(j_fps.farthest_superpoint_sample(
        jnp.asarray(cents), jnp.asarray(cd), trigger, number))
    got = t_fps.farthest_superpoint_sample(t(cents), t(cd), trigger, number)
    np.testing.assert_array_equal(got.numpy(), want)
    got2 = t_fps.farthest_superpoint_sample(
        t(cents), t_ch.chamfer_pairwise(t(pts), t(msk)), trigger, number)
    np.testing.assert_array_equal(got2.numpy(), want)


@pytest.mark.parametrize("labeled_share,batch,chunk",
                         [(0.3, 25, 1024), (0.3, 25, 64), (0.0, 10, 1024)])
def test_kcenter_greedy_picks_equal(labeled_share, batch, chunk):
    rng = np.random.RandomState(2)
    feats = rng.randn(700, 33).astype(np.float32)
    labeled = rng.rand(700) < labeled_share
    want = np.asarray(j_kc.kcenter_greedy(jnp.asarray(feats),
                                          jnp.asarray(labeled), batch))
    got = t_kc.kcenter_greedy(t(feats), t(labeled), batch, chunk).numpy()
    np.testing.assert_array_equal(got, want)
    assert not labeled[got].any() and len(set(got.tolist())) == batch


def _graph(seed, sizes=(20, 15, 11), d=32, labeled_share=0.3):
    """A RegionGraph of three cloud blocks (random symmetric ED + CD, zero
    diagonal) for each side, region features and unlabeled flags."""
    rng = np.random.RandomState(seed)
    c, s = len(sizes), max(sizes)
    ed_cd = np.zeros((c, s, s), np.float32)
    mask = np.zeros((c, s), bool)
    refs, block_of, slot_of = [], [], []
    for ci, n in enumerate(sizes):
        a = rng.rand(n, n).astype(np.float32) * 3
        ed_cd[ci, :n, :n] = (a + a.T) * (1 - np.eye(n, dtype=np.float32))
        mask[ci, :n] = True
        for si in range(n):
            refs.append((f"cloud_{ci}", si, bool(rng.rand() < labeled_share),
                         np.arange(3)))
            block_of.append(ci)
            slot_of.append(si)
    args = ([f"cloud_{ci}" for ci in range(c)],
            np.asarray(block_of, np.int32), np.asarray(slot_of, np.int32),
            ed_cd, mask)
    jg = j_rg.RegionGraph([j_rg.RegionRef(*r) for r in refs], *args)
    tg = t_rg.RegionGraph([t_rg.RegionRef(*r) for r in refs], *args)
    # region features are means of the penultimate features, fc2's leaky
    # ReLU outputs. (With signed N(0, 1) features a column sum of S − I can
    # nearly cancel, and its inverse scales the summation-order rounding of
    # either framework up to ~1e-4 relative.)
    x = rng.randn(len(refs), d).astype(np.float32)
    feats = np.where(x > 0, x, np.float32(0.2) * x)
    unl = np.array([not r[2] for r in refs])
    return jg, tg, feats, unl


def _jax_blocks(jg, feats):
    blocks = jnp.asarray(j_rg.flat_to_blocks(jg, feats))
    return j_gcn._latent_adjacency(jnp.asarray(jg.ed_cd),
                                   jnp.asarray(jg.mask), blocks)


def test_latent_adjacency_and_forward_match_jax():
    jg, tg, feats, _ = _graph(3)
    adj_j, vhat_j = _jax_blocks(jg, feats)
    adj_t, vhat_t = t_gcn._latent_adjacency(
        t(tg.ed_cd), t(tg.mask), t(t_rg.flat_to_blocks(tg, feats)))
    np.testing.assert_allclose(adj_t.numpy(), np.asarray(adj_j), **GCN_TOL)
    np.testing.assert_allclose(vhat_t.numpy(), np.asarray(vhat_j),
                               **GCN_TOL)
    params_j = j_gcn._init_gcn_params(jax.random.PRNGKey(4), feats.shape[1])
    s_j, h_j = j_gcn._gcn_forward(params_j, adj_j, vhat_j,
                                  jnp.asarray(jg.mask))
    params_t = t_gcn.gcn_params_from_jax(params_j)
    with torch.no_grad():
        s_t, h_t = t_gcn._gcn_forward(params_t, adj_t, vhat_t, t(tg.mask))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **GCN_TOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), **GCN_TOL)


def test_init_gcn_params_follow_jax_distributions():
    """Same names, shapes and uniform bounds as JAX's init; the bits come
    from a torch.Generator (ROADMAP §3), the same seed giving the same
    draw."""
    want = j_gcn._init_gcn_params(jax.random.PRNGKey(0), 32)
    got = t_gcn._init_gcn_params(torch.Generator().manual_seed(0), 32, "cpu")
    again = t_gcn._init_gcn_params(torch.Generator().manual_seed(0), 32,
                                   "cpu")
    assert set(got) == set(want) == set(t_gcn.PARAMS)
    for k in want:
        assert tuple(got[k].shape) == tuple(np.asarray(want[k]).shape), k
        bound = 1.0 / np.sqrt(t_gcn.NHID) if k.startswith("gc1") else 1.0
        assert float(got[k].detach().abs().max()) <= bound, k
        assert torch.equal(got[k], again[k]) and got[k].requires_grad
    b1 = 1.0 / np.sqrt(t_gcn.NHID)        # U(-b, b) has std b / sqrt(3)
    assert abs(float(got["gc1_w"].detach().std()) / (b1 / np.sqrt(3)) - 1) \
        < 0.05


def test_gcn_adamw_steps_match_optax():
    """Eight steps of the fit (dropout off) from the same parameters:
    optax.adamw over JAX's loss against fit_gcn; losses and parameters
    within FIT_TOL."""
    jg, tg, feats, unl = _graph(5)
    adj_j, vhat_j = _jax_blocks(jg, feats)
    mask_j = jnp.asarray(jg.mask)
    lbl_j = jnp.asarray(j_rg.flat_to_blocks(
        jg, (~unl).astype(np.float32)[:, None]))[..., 0]
    n_lbl = jnp.maximum(jnp.sum(lbl_j * mask_j), 1.0)
    n_unl = jnp.maximum(jnp.sum((1 - lbl_j) * mask_j), 1.0)
    params = j_gcn._init_gcn_params(jax.random.PRNGKey(6), feats.shape[1])
    tx = optax.adamw(1e-3, weight_decay=5e-4)
    opt = tx.init(params)

    def loss_fn(p):
        scores, _ = j_gcn._gcn_forward(p, adj_j, vhat_j, mask_j)
        s = jnp.clip(scores[..., 0], 1e-7, 1 - 1e-7)
        lnl = jnp.sum(jnp.log(s) * lbl_j * mask_j) / n_lbl
        lnu = jnp.sum(jnp.log(1 - s) * (1 - lbl_j) * mask_j) / n_unl
        return -lnl - 1.2 * lnu

    t_params = t_gcn.gcn_params_from_jax(params)
    want_losses = []
    for _ in range(8):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        want_losses.append(float(loss))
    adj_t, vhat_t = t_gcn._latent_adjacency(
        t(tg.ed_cd), t(tg.mask), t(t_rg.flat_to_blocks(tg, feats)))
    lbl_t = t(t_rg.flat_to_blocks(tg, (~unl).astype(np.float32)[:, None])
              [..., 0])
    losses = t_gcn.fit_gcn(t_params, adj_t, vhat_t, t(tg.mask), lbl_t,
                           num_steps=8)
    np.testing.assert_allclose(losses.numpy(), want_losses, **FIT_TOL)
    for k in ("gc1_w", "gc1_b", "gc3_w", "gc3_b"):
        np.testing.assert_allclose(t_params[k].detach().numpy(),
                                   np.asarray(params[k]), **FIT_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("core_gcn", [True, False])
def test_gcn_sampling_picks_valid_unlabeled(core_gcn):
    """The whole branch (a short fit): sampling_batch distinct unlabeled
    superpoints, per cloud."""
    _, tg, feats, unl = _graph(7)
    got = t_gcn.gcn_sampling(tg, feats, unl, 9, core_gcn=core_gcn,
                             num_steps=60, seed=3, device="cpu")
    picks = [(n, s) for n, v in got.items() for s in v]
    assert len(picks) == len(set(picks)) == 9
    unlabeled = {(r.cloud_name, r.sp_idx) for r, u in zip(tg.refs, unl) if u}
    assert set(picks) <= unlabeled
    again = t_gcn.gcn_sampling(tg, feats, unl, 9, core_gcn=core_gcn,
                               num_steps=60, seed=3, device="cpu")
    assert again == got


# ------------------------------------------------ rounds on a state dir ---

SEED_ARGS = ["seed"]


def _workload(work, sp_per_cloud=48):
    """2 rooms, grid superpoints, registry and a seed round, written with
    the port's state store (equal to JAX's: test_torch_selection.py)."""
    train, _ = make_dataset(num_train=2, num_val=0, num_points=3000, seed=1)
    state = t_state.ALState(work, [])
    total = {"unlabeled": {}, "file_num": len(train), "sp_num": 0,
             "point_num": sum(c.num_points for c in train)}
    for c in train:
        comps, in_comp = grid_superpoints(c.xyz, sp_per_cloud)
        state.write_superpoints(c.name, comps, in_comp, c.num_points)
        total["unlabeled"][c.name] = np.arange(len(comps))
        total["sp_num"] += len(comps)
    state.write_registry(total)
    t_samplers.SeedSampler(t_state.ALState(work, SEED_ARGS), train,
                           total["sp_num"]).sampling(
        total["sp_num"] // 8, 0, t_state.RoundStats())
    return train, total["sp_num"]


def _same_round_files(a_dir, b_dir, rd):
    names = sorted(os.listdir(os.path.join(a_dir, rd)))
    assert names == sorted(os.listdir(os.path.join(b_dir, rd)))
    for fname in names:
        with open(os.path.join(a_dir, rd, fname), "rb") as a, \
                open(os.path.join(b_dir, rd, fname), "rb") as b:
            assert a.read() == b.read(), fname


@pytest.mark.parametrize("sampler", ["random", "all"])
def test_random_and_all_sampler_round_files_match_jax(tmp_path, sampler):
    t_dir, j_dir = str(tmp_path / "t"), str(tmp_path / "j")
    train, sp_num = _workload(t_dir)
    shutil.copytree(t_dir, j_dir)
    sargs = ["t0", sampler]
    for mod, st, work in ((t_samplers, t_state, t_dir),
                          (j_samplers, j_state, j_dir)):
        state = st.ALState(work, sargs)
        if sampler == "random":
            mod.RandomSampler(state, train, sp_num, 1, seed=4).sampling(
                sp_num // 5, 1, st.RoundStats())
        else:
            mod.AllSampler(state, train, sp_num).sampling(
                sp_num, 1, st.RoundStats())
    _same_round_files(t_dir, j_dir,
                      os.path.join("sampling", "-".join(sargs), "round_2"))


def test_edcd_selection_file_list_matches_jax(tmp_path):
    """TSampler._edcd_selection on the same ranked region table: JAX's exact
    chamfer and FPS against the port's (K3's plain version)."""
    work = str(tmp_path)
    train, sp_num = _workload(work)
    rng = np.random.RandomState(8)
    state = t_state.ALState(work, [])
    names, cloud_ids, sp_idx, counts = [], [], [], []
    for ci, c in enumerate(train):
        s = state.load_superpoints(c.name).num_superpoints
        pick = rng.choice(s, s // 2, replace=False)
        names.append(c.name)
        cloud_ids.append(np.full(len(pick), ci, np.int32))
        sp_idx.append(pick.astype(np.int64))
    cloud_ids, sp_idx = np.concatenate(cloud_ids), np.concatenate(sp_idx)
    offsets = np.zeros(len(sp_idx) + 1, np.int64)
    sorted_inds = rng.permutation(len(sp_idx))
    cfg = None
    picks = []
    for mod, rg, st in ((j_samplers, j_rg, j_state),
                        (t_samplers, t_rg, t_state)):
        table = rg.RegionTable(list(names), cloud_ids, sp_idx,
                               np.zeros(len(sp_idx), bool),
                               np.zeros(0, np.int64), offsets)
        kw = {} if mod is j_samplers else {"device": "cpu"}
        sampler = mod.TSampler(st.ALState(work, []), train, cfg,
                               mod.TSamplerArgs(diversity="edcd",
                                                chamfer_cap=64),
                               sp_num, **kw)
        stats = st.RoundStats()
        picks.append(sampler._edcd_selection(table, sorted_inds, 16, stats))
        assert stats.extra["before_gcn_file_num"] == len(picks[-1])
    assert picks[1] == picks[0]
    assert sum(map(len, picks[1].values())) == 16
