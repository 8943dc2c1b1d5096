"""The selection slice of ssdr_al_torch against ssdr_al_tpu on the CPU:
segment reductions, uncertainty, FPS, GCN-FPS, the region graph, the oracle
copy, and one whole TSampler round on the same synthetic workload."""

import importlib
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdr_al_tpu.active import fps_gcn as j_fps_gcn
from ssdr_al_tpu.active import oracle as j_oracle
from ssdr_al_tpu.active import region_graph as j_rg
from ssdr_al_tpu.active import samplers as j_samplers
from ssdr_al_tpu.active import state as j_state
from ssdr_al_tpu.active import uncertainty as j_unc
from ssdr_al_tpu.data.synthetic import grid_superpoints
from ssdr_al_tpu.models.randlanet import RandLANet as JRandLANet
from ssdr_al_tpu.train import trainer as j_trainer
from ssdr_al_torch.active import fps_gcn as t_fps_gcn
from ssdr_al_torch.active import oracle as t_oracle
from ssdr_al_torch.active import region_graph as t_rg
from ssdr_al_torch.active import samplers as t_samplers
from ssdr_al_torch.active import state as t_state
from ssdr_al_torch.active import uncertainty as t_unc
from ssdr_al_torch.data import NUM_SYNTH_CLASSES
from ssdr_al_torch.data import grid_superpoints as t_grid_superpoints
from ssdr_al_torch.data import make_dataset as t_make_dataset
from ssdr_al_torch.models.randlanet import RandLANet, params_from_flax
from ssdr_al_torch.ops import fps as t_fps
from ssdr_al_torch.ops import segment as t_seg
from ssdr_al_torch.train.trainer import make_eval_step
from torch_parity import random_flax_variables, small_cfg, t

j_seg = importlib.import_module("ssdr_al_tpu.ops.segment")
j_fps = importlib.import_module("ssdr_al_tpu.ops.fps")
torch.set_num_threads(1)

SUM_TOL = dict(rtol=1e-6, atol=1e-6)
SSDR_ARGS = ["t0", "sb", "clsbal", "gcn_fps", "WetSU", "NAIL", "0.9", "1",
             "1", "0"]


def _points(seed, n=3000, s=90, c=6):
    rng = np.random.RandomState(seed)
    seg = rng.randint(0, s, n)
    seg[:4] = s + 3                       # out of range: dropped
    labels = rng.randint(0, c, n)
    probs = rng.dirichlet(np.ones(c), n).astype(np.float32)
    return seg, labels, probs


def test_segment_count_and_majority_exact():
    seg, labels, _ = _points(0)
    s, c = 90, 6
    labels[seg == 5] = np.resize([1, 2], (seg == 5).sum())   # tie → 1
    np.testing.assert_array_equal(
        t_seg.segment_count(t(seg), s).numpy(),
        np.asarray(j_seg.segment_count(jnp.asarray(seg), s)))
    jd, jr = j_seg.segment_majority(jnp.asarray(labels), jnp.asarray(seg),
                                    s, c)
    td, tr = t_seg.segment_majority(t(labels), t(seg), s, c)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert int(td[5]) == 1


@pytest.mark.parametrize("mode", ["lc", "entropy", "sb"])
def test_point_uncertainty(mode):
    _, _, probs = _points(1)
    want = np.asarray(j_unc.point_uncertainty(jnp.asarray(probs), mode))
    got = t_unc.point_uncertainty(t(probs), mode).numpy()
    np.testing.assert_allclose(got, want, **SUM_TOL)


@pytest.mark.parametrize("mode", ["mean", "sum_weight", "WetSU"])
def test_region_uncertainty(mode):
    seg, labels, probs = _points(2)
    unc = probs.max(-1)
    want = np.asarray(j_unc.region_uncertainty(
        jnp.asarray(unc), jnp.asarray(labels), jnp.asarray(seg), 90, 6, mode))
    got = t_unc.region_uncertainty(t(unc), t(labels), t(seg), 90, 6,
                                   mode).numpy()
    np.testing.assert_allclose(got, want, **SUM_TOL)


def test_farthest_feature_sample_picks_exact():
    rng = np.random.RandomState(3)
    feats = rng.randn(300, 32).astype(np.float32)
    valid = rng.rand(300) < 0.8
    valid[17] = True
    want = np.asarray(j_fps.farthest_feature_sample(
        jnp.asarray(feats), 17, 40, jnp.asarray(valid)))
    got = t_fps.farthest_feature_sample(t(feats), 17, 40, t(valid)).numpy()
    np.testing.assert_array_equal(got, want)


def _graph_arrays(seed, c=3, s=20):
    rng = np.random.RandomState(seed)
    sizes = [s, s - 5, s - 9]
    ed_cd = np.zeros((c, s, s), np.float32)
    mask = np.zeros((c, s), bool)
    refs_args, block_of, slot_of = [], [], []
    for ci, n in enumerate(sizes):
        a = rng.rand(n, n).astype(np.float32) * 3
        ed_cd[ci, :n, :n] = (a + a.T) * (1 - np.eye(n, dtype=np.float32))
        mask[ci, :n] = True
        for si in range(n):
            refs_args.append((f"cloud_{ci}", si, bool(rng.rand() < 0.3),
                              np.arange(3)))
            block_of.append(ci)
            slot_of.append(si)
    return (refs_args, [f"cloud_{ci}" for ci in range(c)],
            np.asarray(block_of, np.int32), np.asarray(slot_of, np.int32),
            ed_cd, mask)


@pytest.mark.parametrize("gcn_top", [0, 4])
def test_gcn_fps_sampling_picks_equal(gcn_top):
    refs_args, names, bo, so, ed_cd, mask = _graph_arrays(4)
    jg = j_rg.RegionGraph([j_rg.RegionRef(*r) for r in refs_args], names,
                          bo, so, ed_cd, mask)
    tg = t_rg.RegionGraph([t_rg.RegionRef(*r) for r in refs_args], names,
                          bo, so, ed_cd, mask)
    feats = np.random.RandomState(5).randn(len(refs_args), 32).astype(
        np.float32)
    unl = np.array([not r[2] for r in refs_args])
    want = j_fps_gcn.gcn_fps_sampling(jg, feats, unl, 12, gcn_top=gcn_top,
                                      rng=np.random.RandomState(6))
    got = t_fps_gcn.gcn_fps_sampling(tg, feats, unl, 12, gcn_top=gcn_top,
                                     rng=np.random.RandomState(6))
    assert got == want


def _regions(seed):
    rng = np.random.RandomState(seed)
    clouds, comps, regions = {}, {}, {}
    for ci in range(2):
        xyz = (rng.rand(4000, 3) * 5).astype(np.float32)
        comp, _ = grid_superpoints(xyz, 60)
        name = f"cloud_{ci}"
        clouds[name], comps[name] = xyz, comp
        pick = rng.choice(len(comp), 25 + 10 * ci, replace=False)
        regions[name] = [(int(s), bool(i % 3 == 0), np.asarray(comp[s][:5]))
                         for i, s in enumerate(pick)]
    comps["cloud_0"][int(regions["cloud_0"][0][0])] = np.arange(100)  # > cap
    return clouds, comps, regions


@pytest.mark.parametrize("cached", [False, True])
def test_build_region_graph_matches_jax(cached):
    clouds, comps, regions = _regions(7)
    want = j_rg.build_region_graph(regions, clouds, comps,
                                   max_points_per_sp=64, mxu=False)
    cache = None
    if cached:
        cache = t_rg.SuperpointBlockCache(64)
        for name in clouds:
            cache.ensure(name, clouds[name], comps[name])
        cache.finalize()
    got = t_rg.build_region_graph(regions, clouds, comps,
                                  max_points_per_sp=64, cache=cache)
    c, s = got.mask.shape
    np.testing.assert_array_equal(got.mask, want.mask[:c, :s])
    np.testing.assert_array_equal(got.block_of, want.block_of)
    np.testing.assert_array_equal(got.slot_of, want.slot_of)
    assert [(r.cloud_name, r.sp_idx, r.is_labeled) for r in got.refs] == \
        [(r.cloud_name, r.sp_idx, r.is_labeled) for r in want.refs]
    np.testing.assert_allclose(got.ed_cd, want.ed_cd[:c, :s, :s],
                               rtol=1e-5, atol=1e-5)


def test_region_helpers_match_jax():
    """bbox_center, pad_regions_vectorized and the flat/block scatters."""
    clouds, comps, regions = _regions(9)
    xyz, comp = clouds["cloud_0"], comps["cloud_0"]
    ids = [comp[s] for s, _, _ in regions["cloud_0"]]
    for a, b in zip(t_rg.pad_regions_vectorized(xyz, ids, 64),
                    j_rg.pad_regions_vectorized(xyz, ids, 64)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_rg.bbox_center(xyz[ids[0]]),
                                  j_rg.bbox_center(xyz[ids[0]]))
    refs_args, names, bo, so, ed_cd, mask = _graph_arrays(10)
    tg = t_rg.RegionGraph([t_rg.RegionRef(*r) for r in refs_args], names,
                          bo, so, ed_cd, mask)
    jg = j_rg.RegionGraph([j_rg.RegionRef(*r) for r in refs_args], names,
                          bo, so, ed_cd, mask)
    flat = np.random.RandomState(11).randn(len(refs_args), 4).astype(
        np.float32)
    blocks = t_rg.flat_to_blocks(tg, flat)
    np.testing.assert_array_equal(blocks, j_rg.flat_to_blocks(jg, flat))
    np.testing.assert_array_equal(t_rg.blocks_to_flat(tg, blocks), flat)


def test_nail_oracle_copy_matches_jax():
    rng = np.random.RandomState(8)
    n = 2000
    comps = np.array_split(rng.permutation(n), 40)
    gt = rng.randint(0, 4, n)
    gt[comps[0]] = 2                               # one pure superpoint
    pred = rng.randint(0, 4, n)
    out = []
    for mod, st in ((j_oracle, j_state), (t_oracle, t_state)):
        stats = st.RoundStats()
        pseudo = np.zeros((2, n), np.float32)
        budget = {"click": 15}
        sel = []
        pseudo, used = mod.oracle_labeling(
            list(range(25)), comps, gt, pseudo, stats, "NAIL", pred, 0.5,
            budget, 1, sel)
        out.append((pseudo, used, stats.as_dict(), budget, sel))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1:] == out[1][1:]


# ------------------------------------------------------ the whole round ---


def _workload(work):
    """2 rooms, grid superpoints, registry and a seed round, made with the
    port's data module and written with its state store (both equal to the
    JAX ones: tests/test_torch_data.py and test_seed_round_files_match_jax).
    The JAX sampler reads the same Cloud objects."""
    train, _ = t_make_dataset(num_train=2, num_val=0, num_points=3000, seed=0)
    state = t_state.ALState(work, SSDR_ARGS)
    total = {"unlabeled": {}}
    sp_num = 0
    for c in train:
        comps, in_comp = t_grid_superpoints(c.xyz, 64)
        state.write_superpoints(c.name, comps, in_comp, c.num_points)
        total["unlabeled"][c.name] = np.arange(len(comps))
        sp_num += len(comps)
    total.update(file_num=len(train), sp_num=sp_num,
                 point_num=sum(c.num_points for c in train))
    state.write_registry(total)
    t_samplers.SeedSampler(t_state.ALState(work, ["seed"]), train,
                           sp_num).sampling(sp_num // 8, 0,
                                            t_state.RoundStats())
    return train, sp_num


def _picked(work, before):
    with open(os.path.join(work, "sampling", "-".join(SSDR_ARGS), "round_2",
                           "total.pkl"), "rb") as f:
        after = pickle.load(f)["unlabeled"]
    picked = {(n, int(s)) for n, v in before.items()
              for s in set(v) - set(after.get(n, []))}
    return picked, after


def test_seed_round_files_match_jax(tmp_path):
    """The JAX SeedSampler on the same workload writes identical files."""
    t_dir, j_dir = str(tmp_path / "t"), str(tmp_path / "j")
    train, sp_num = _workload(t_dir)
    shutil.copytree(os.path.join(t_dir, "superpoint"),
                    os.path.join(j_dir, "superpoint"))
    j_samplers.SeedSampler(j_state.ALState(j_dir, ["seed"]), train,
                           sp_num).sampling(sp_num // 8, 0,
                                            j_state.RoundStats())
    rd = os.path.join("sampling", "seed", "round_1")
    for fname in sorted(os.listdir(os.path.join(t_dir, rd))):
        with open(os.path.join(t_dir, rd, fname), "rb") as a, \
                open(os.path.join(j_dir, rd, fname), "rb") as b:
            assert a.read() == b.read(), fname


def test_selection_round_matches_jax(tmp_path):
    """One full-SSDR TSampler round on each side (knn_engine "xla", same
    converted weights, same numpy seeds): the picked superpoints overlap,
    the registry shrinks and activation is monotone."""
    t_dir, j_dir = str(tmp_path / "t"), str(tmp_path / "j")
    train, sp_num = _workload(t_dir)
    shutil.copytree(t_dir, j_dir)
    cfg = small_cfg(num_points=1024, num_classes=NUM_SYNTH_CLASSES)
    with open(os.path.join(t_dir, "superpoint", "total.pkl"), "rb") as f:
        before = pickle.load(f)["unlabeled"]

    model = JRandLANet(cfg)
    rng = np.random.RandomState(0)
    sample = {"xyz": (rng.rand(1, cfg.num_points, 3) * 6).astype(np.float32),
              "features": rng.rand(1, cfg.num_points, 6).astype(np.float32)}
    mstate = j_trainer.create_train_state(model, cfg, jax.random.PRNGKey(0),
                                          sample, 500)
    v = random_flax_variables({"params": mstate.params,
                               "batch_stats": mstate.batch_stats}, seed=3)
    mstate = mstate.replace(params=v["params"], batch_stats=v["batch_stats"])
    j_sampler = j_samplers.TSampler(
        j_state.ALState(j_dir, SSDR_ARGS), train, cfg,
        j_samplers.TSamplerArgs(), sp_num)
    j_sampler.sampling(j_trainer.make_eval_step(model, cfg, "xla", True),
                       mstate, 20, 1, j_state.RoundStats())

    t_sampler = t_samplers.TSampler(
        t_state.ALState(t_dir, SSDR_ARGS), train, cfg,
        t_samplers.TSamplerArgs(), sp_num)
    stats = t_state.RoundStats()
    t_sampler.sampling(make_eval_step(RandLANet(cfg), cfg, "xla", True),
                       params_from_flax(v["params"], v["batch_stats"]), 20,
                       1, stats)

    j_pick, _ = _picked(j_dir, before)
    t_pick, after = _picked(t_dir, before)
    overlap = len(j_pick & t_pick) / max(len(j_pick), len(t_pick), 1)
    print(f"selection round: {len(t_pick)} superpoints picked, overlap with "
          f"JAX {overlap:.3f}")
    assert len(t_pick) > 0
    assert overlap >= 0.9
    assert sum(map(len, after.values())) < sum(map(len, before.values()))
    seed_dir = os.path.join(t_dir, "sampling", "seed", "round_1")
    r2 = os.path.join(t_dir, "sampling", "-".join(SSDR_ARGS), "round_2")
    for c in train:
        with open(os.path.join(seed_dir, c.name + ".gt"), "rb") as f:
            g1 = pickle.load(f)
        with open(os.path.join(r2, c.name + ".gt"), "rb") as f:
            g2 = pickle.load(f)
        assert (g2[0] >= g1[0]).all(), "activation must be monotone"
    assert set(t_sampler.phase_times) >= {"prediction_s", "div_graph_s",
                                          "div_gcn_s", "oracle_s"}
