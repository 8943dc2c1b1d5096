"""The greedy selection loops as static steps replayed from one capture
(ops/fps.py, ops/kcenter.py, train/graphs.py::run_steps), and the
selection round at the reference's scale (ssdr_al_torch/scripts/
profile_selection.py).

On the CPU: the step form of farthest_feature_sample (a valid mask and
padded rows, as JAX's _M_LADDER pads), farthest_superpoint_sample and
kcenter_greedy against JAX's lax.fori_loop programs, picks identical, over
seeds and lengths from 1. Then a CPU stand-in for a replay (the capture
runs nothing; each replay runs the static step again on the same tensors,
in place, as a replay of the captured step does): through it, each loop,
gcn_fps_sampling, gcn_sampling's k-center, TSampler._edcd_selection and
TSampler rounds of the gcn_fps and edcd branches pick and write what JAX
writes from the same prediction, and a gcn round writes what the eager
port writes. The rules that keep a loop eager. The twin's workload equals
bench.py::_build_selection_workload's byte for byte, and the twin runs
end to end on the CPU.

Marked `cuda` (skipped here, run on the card): replays bitwise equal to
the eager loop at the at-scale round's lengths (farthest_feature_sample
over 20 000 x 32 rows for 9 999 picks, k-center over 20 000 rows for
10 000 picks) and at edcd's per-cloud lengths; 20-cloud gcn_fps, gcn and
edcd rounds writing identical files with graphs and eagerly; a replay's
kernels and host launches under torch.profiler.

This file imports no jax at its top, so its CUDA tests also run where jax
is not installed:

    python -m pytest tests/test_torch_select_graph.py -m cuda --noconftest -q
"""

import dataclasses
import importlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from ssdr_al_torch.active import fps_gcn as t_fps_gcn
from ssdr_al_torch.active import gcn as t_gcn
from ssdr_al_torch.active import region_graph as t_rg
from ssdr_al_torch.active import samplers as t_samplers
from ssdr_al_torch.active import state as t_state
from ssdr_al_torch.config import ConfigS3DIS
from ssdr_al_torch.data.synthetic import NUM_SYNTH_CLASSES
from ssdr_al_torch.models.randlanet import RandLANet, init_params
from ssdr_al_torch.ops import fps as t_fps
from ssdr_al_torch.ops import kcenter as t_kc
from ssdr_al_torch.scripts import profile_selection as twin
from ssdr_al_torch.train import graphs
from ssdr_al_torch.train.trainer import make_eval_step

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (0, 1, 2)


def _jax(name):
    """A JAX package module, imported inside a CPU test."""
    return importlib.import_module(name)


def _feature_inputs(seed, m=150, pad=42, d=16):
    """[m + pad, d] features, the last `pad` rows zero and invalid, as
    JAX's _M_LADDER pads its candidates; a random fifth of the rest
    invalid too; a valid start row."""
    rng = np.random.RandomState(seed)
    feats = np.zeros((m + pad, d), np.float32)
    feats[:m] = rng.randn(m, d)
    valid = np.zeros(m + pad, bool)
    valid[:m] = rng.rand(m) < 0.8
    start = int(rng.choice(np.flatnonzero(valid)))
    return feats, valid, start


def _superpoint_inputs(seed, s=60):
    rng = np.random.RandomState(seed)
    cents = (rng.rand(s, 3) * 6).astype(np.float32)
    a = rng.rand(s, s).astype(np.float32)
    return cents, (a + a.T) * 0.5, int(rng.randint(s))


def _kcenter_inputs(seed, n=200, d=24):
    rng = np.random.RandomState(seed)
    return rng.randn(n, d).astype(np.float32), rng.rand(n) < 0.15


def _jax_feature_picks(feats, valid, start, n):
    jnp = _jax("jax.numpy")
    return np.asarray(_jax("ssdr_al_tpu.ops.fps").farthest_feature_sample(
        jnp.asarray(feats), start, n, jnp.asarray(valid)))


def _jax_superpoint_picks(cents, cd, trigger, n):
    jnp = _jax("jax.numpy")
    return np.asarray(_jax("ssdr_al_tpu.ops.fps").farthest_superpoint_sample(
        jnp.asarray(cents), jnp.asarray(cd), trigger, n))


def _jax_kcenter_picks(feats, mask, n):
    jnp = _jax("jax.numpy")
    return np.asarray(_jax("ssdr_al_tpu.ops.kcenter").kcenter_greedy(
        jnp.asarray(feats), jnp.asarray(mask), n))


# ----------------------------------------- the step forms against JAX ---


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 9, 40])
def test_farthest_feature_steps_match_jax(seed, n):
    """The port's static step, run n − 1 times by the CPU loop, picks what
    JAX's lax.fori_loop picks, padded rows never."""
    feats, valid, start = _feature_inputs(seed)
    got = t_fps.farthest_feature_sample(torch.from_numpy(feats), start, n,
                                        torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, _jax_feature_picks(feats, valid,
                                                          start, n))
    assert valid[got].all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 12, 30])
def test_farthest_superpoint_steps_match_jax(seed, n):
    cents, cd, trigger = _superpoint_inputs(seed)
    got = t_fps.farthest_superpoint_sample(
        torch.from_numpy(cents), torch.from_numpy(cd), trigger, n).numpy()
    np.testing.assert_array_equal(got, _jax_superpoint_picks(cents, cd,
                                                             trigger, n))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 25])
def test_kcenter_steps_match_jax(seed, n):
    """The chunked init (one pass) and the greedy steps: JAX's picks,
    none of them labeled."""
    feats, mask = _kcenter_inputs(seed)
    got = t_kc.kcenter_greedy(torch.from_numpy(feats), torch.from_numpy(mask),
                              n, chunk=64).numpy()
    np.testing.assert_array_equal(got, _jax_kcenter_picks(feats, mask, n))
    assert not mask[got].any()


# ---------------------------------------------------------- stand-in ---


class _ReplayStandIn:
    """A CPU stand-in for a captured CUDA graph of one static step:
    replay() runs the step again, reading and writing the same tensors in
    place, as a replay of the captured step does."""

    def __init__(self, step):
        self.step = step

    def replay(self):
        self.step()


@pytest.fixture
def standin(monkeypatch):
    """run_steps takes the graph path on the CPU: graphs.warm runs the
    step, graphs.capture records it without running it (its graph a
    _ReplayStandIn), and the device calls around them are stubbed. The
    greedy loops' replay threshold (ops/fps.py::MIN_REPLAYS, k-center's
    too) is 1, so every loop of more than
    GRAPH_WARMUP steps replays."""

    def capture(step, generators, device):
        return graphs.Graph(_ReplayStandIn(step), {}), None

    monkeypatch.setattr(graphs, "capturable", lambda device: True)
    monkeypatch.setattr(graphs, "warm", lambda step, device: step())
    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 0)
    monkeypatch.setattr(t_fps, "MIN_REPLAYS", 1)


LOOPS = ("farthest_feature_sample", "farthest_superpoint_sample",
         "kcenter_greedy")


@pytest.mark.parametrize("kind", LOOPS)
@pytest.mark.parametrize("n", [2, 5, 40])
def test_loops_through_replays_match_jax(standin, kind, n):
    """Each loop through the stand-in: GRAPH_WARMUP eager steps and
    replays of the captured step (recorded by record_runs) pick what JAX
    picks; a loop of at most GRAPH_WARMUP steps runs eagerly."""
    with graphs.record_runs() as runs:
        if kind == "farthest_feature_sample":
            feats, valid, start = _feature_inputs(n)
            got = t_fps.farthest_feature_sample(
                torch.from_numpy(feats), start, n, torch.from_numpy(valid))
            want = _jax_feature_picks(feats, valid, start, n)
            steps = n - 1
        elif kind == "farthest_superpoint_sample":
            cents, cd, trigger = _superpoint_inputs(n)
            got = t_fps.farthest_superpoint_sample(
                torch.from_numpy(cents), torch.from_numpy(cd), trigger, n)
            want = _jax_superpoint_picks(cents, cd, trigger, n)
            steps = n - 1
        else:
            feats, mask = _kcenter_inputs(n)
            got = t_kc.kcenter_greedy(torch.from_numpy(feats),
                                      torch.from_numpy(mask), n, chunk=64)
            want = _jax_kcenter_picks(feats, mask, n)
            steps = n
    np.testing.assert_array_equal(got.numpy(), want)
    replays = max(steps - graphs.GRAPH_WARMUP, 0)
    assert [(r["name"], r["steps"], r["replays"]) for r in runs] == \
        [(kind, steps, replays)]


def test_loop_eager_rules(standin):
    """A loop replays only past GRAPH_WARMUP + MIN_REPLAYS steps, and
    never with eager=True; TSampler keeps its loops eager when told to
    and on ranks that share a card (a gloo group on a card); a CPU rank
    shares no card."""
    feats, valid, start = _feature_inputs(0)
    args = (torch.from_numpy(feats), start, 30, torch.from_numpy(valid))
    with graphs.record_runs() as runs:
        t_fps.farthest_feature_sample(*args)
        t_fps.farthest_feature_sample(*args, eager=True)
        t_fps.MIN_REPLAYS = 27
        t_fps.farthest_feature_sample(*args)
        t_fps.MIN_REPLAYS = 26
        t_fps.farthest_feature_sample(*args)
    assert [r["replays"] for r in runs] == [26, 0, 0, 26]

    def sampler(**kw):
        return t_samplers.TSampler(None, [], None,
                                   t_samplers.TSamplerArgs(), 0,
                                   device="cpu", **kw)

    class Group:
        shares_card = True

    assert not sampler().loop_eager
    assert sampler(eager=True).loop_eager
    assert sampler(group=Group()).loop_eager
    Group.shares_card = False
    assert not sampler(group=Group()).loop_eager
    from ssdr_al_torch.parallel.mesh import DataGroup

    assert not DataGroup(0, 1, torch.device("cpu")).shares_card


def _graph_arrays(seed, sizes=(20, 15, 11)):
    """(refs, names, block_of, slot_of, ed_cd, mask) of a small region
    graph, ~30 % of its regions labeled."""
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
            refs.append((f"cloud_{ci}", si, bool(rng.rand() < 0.3),
                         np.arange(3)))
            block_of.append(ci)
            slot_of.append(si)
    return (refs, [f"cloud_{ci}" for ci in range(c)],
            np.asarray(block_of, np.int32), np.asarray(slot_of, np.int32),
            ed_cd, mask)


@pytest.mark.parametrize("gcn_top", [0, 4])
def test_gcn_fps_sampling_through_replays_matches_jax(standin, gcn_top):
    j_fps_gcn = _jax("ssdr_al_tpu.active.fps_gcn")
    j_rg = _jax("ssdr_al_tpu.active.region_graph")
    refs, names, bo, so, ed_cd, mask = _graph_arrays(4)
    jg = j_rg.RegionGraph([j_rg.RegionRef(*r) for r in refs], names, bo, so,
                          ed_cd, mask)
    tg = t_rg.RegionGraph([t_rg.RegionRef(*r) for r in refs], names, bo, so,
                          ed_cd, mask)
    feats = np.random.RandomState(5).randn(len(refs), 32).astype(np.float32)
    unl = np.array([not r[2] for r in refs])
    want = j_fps_gcn.gcn_fps_sampling(jg, feats, unl, 18, gcn_top=gcn_top,
                                      rng=np.random.RandomState(6))
    with graphs.record_runs() as runs:
        got = t_fps_gcn.gcn_fps_sampling(tg, feats, unl, 18, gcn_top=gcn_top,
                                         rng=np.random.RandomState(6),
                                         device="cpu")
    assert got == want
    assert [r["replays"] for r in runs] == [17 - graphs.GRAPH_WARMUP]


def test_gcn_sampling_kcenter_through_replays_matches_jax(standin,
                                                         monkeypatch):
    """gcn_sampling (a 12-step fit and k-center, both through the
    stand-in): its k-center picks are JAX's kcenter_greedy's on the same
    features and labeled mask, and its file list holds them."""
    refs, names, bo, so, ed_cd, mask = _graph_arrays(7)
    tg = t_rg.RegionGraph([t_rg.RegionRef(*r) for r in refs], names, bo, so,
                          ed_cd, mask)
    feats = np.random.RandomState(8).randn(len(refs), 32).astype(np.float32)
    unl = np.array([not r[2] for r in refs])
    calls = []
    kcenter = t_gcn.kcenter_greedy

    def recorded(feat, labeled, n, **kw):
        sel = kcenter(feat, labeled, n, **kw)
        calls.append((feat.numpy().copy(), labeled.numpy().copy(), n,
                      sel.numpy().copy()))
        return sel

    monkeypatch.setattr(t_gcn, "kcenter_greedy", recorded)
    with graphs.record_runs() as runs:
        got = t_gcn.gcn_sampling(tg, feats, unl, 14, num_steps=12, seed=3,
                                 device="cpu")
    (feat, labeled, n, sel), = calls
    np.testing.assert_array_equal(sel, _jax_kcenter_picks(feat, labeled, n))
    assert [(r["name"], r["replays"]) for r in runs] == [
        ("fit_gcn", 12 - graphs.GRAPH_WARMUP),
        ("kcenter_greedy", 14 - graphs.GRAPH_WARMUP)]
    picked = {(tg.refs[int(i)].cloud_name, tg.refs[int(i)].sp_idx)
              for i in sel}
    assert {(k, s) for k, v in got.items() for s in v} == picked


# --------------------------------------------------- sampler rounds ---


def small_cfg(**over):
    """tests/torch_parity.py's narrow RandLA-Net (3 layers, d_out (8, 16,
    32)), without importing jax."""
    base = dict(num_layers=3, d_out=(8, 16, 32), sub_sampling_ratio=(4, 4, 2),
                num_points=1024, num_classes=NUM_SYNTH_CLASSES)
    base.update(over)
    return dataclasses.replace(ConfigS3DIS, **base)


def _workload(work, clouds=2, points=3000, target_sp=48):
    """The twin's workload (2 rooms of 3000 points, ~48 grid superpoints
    a room, the seed round labelling an eighth)."""
    return twin.build_selection_workload(work, clouds, points,
                                         target_sp=target_sp, seed_div=8)


def _same_files(a_dir, b_dir):
    names = sorted(os.listdir(a_dir))
    assert names == sorted(os.listdir(b_dir)) and names
    for fname in names:
        with open(os.path.join(a_dir, fname), "rb") as a, \
                open(os.path.join(b_dir, fname), "rb") as b:
            assert a.read() == b.read(), fname


def _shared_prediction(work, train, cfg, total, diversity):
    """The port's TSampler.prediction of round 2 on the workload (the
    `xla` engine, init weights of seed 0), and its InferenceRunner."""
    state = t_state.ALState(work, twin.sampler_args(diversity))
    sampler = t_samplers.TSampler(
        state, train, cfg, t_samplers.TSamplerArgs(diversity=diversity),
        total["sp_num"], device="cpu")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    step = make_eval_step(RandLANet(cfg), cfg, "xla", True, device="cpu")
    reg = state.load_registry(os.path.join(work, "sampling", "seed",
                                           "round_1"))
    out = sampler.prediction(step, params, reg, 2, t_state.RoundStats())
    return out, sampler._runner


@pytest.mark.parametrize("diversity", ["gcn_fps", "edcd"])
def test_round_through_replays_writes_jax_files(tmp_path, standin,
                                                diversity):
    """A TSampler round of the gcn_fps or edcd branch, its loops through
    the stand-in, and JAX's TSampler round from the same prediction (the
    port's region table, scores, classes and region features, handed to
    both samplers) write identical round files (registry and pseudo-GT)."""
    j_rg = _jax("ssdr_al_tpu.active.region_graph")
    j_samplers = _jax("ssdr_al_tpu.active.samplers")
    j_state = _jax("ssdr_al_tpu.active.state")
    t_dir, j_dir = str(tmp_path / "t"), str(tmp_path / "j")
    train, _, total = _workload(t_dir)
    shutil.copytree(t_dir, j_dir)
    cfg = small_cfg()
    (table, order, inference, labeled), runner = _shared_prediction(
        t_dir, train, cfg, total, diversity)
    j_table = j_rg.RegionTable(*(getattr(table, f.name) for f in
                                 dataclasses.fields(table)))
    j_inference = {k: j_samplers.CloudInference(v.prob_class, v.uncertainty,
                                                v.penult)
                   for k, v in inference.items()}

    class Runner:              # the port's region means, on JAX's side
        keep_penult = True
        region_feature_means = runner.region_feature_means

    def predicted(sampler, tab, inf, run):
        def prediction(*a, **kw):
            sampler._runner = run
            return tab, order, inf, labeled
        return prediction

    sargs = twin.sampler_args(diversity)
    args = dict(diversity=diversity)
    t_sampler = t_samplers.TSampler(
        t_state.ALState(t_dir, sargs), train, cfg,
        t_samplers.TSamplerArgs(**args), total["sp_num"], device="cpu")
    j_sampler = j_samplers.TSampler(
        j_state.ALState(j_dir, sargs), train, cfg,
        j_samplers.TSamplerArgs(**args), total["sp_num"])
    t_sampler.prediction = predicted(t_sampler, table, inference, runner)
    j_sampler.prediction = predicted(j_sampler, j_table, j_inference,
                                     Runner())
    with graphs.record_runs() as runs:
        t_sampler.sampling(None, None, 30, 1, t_state.RoundStats())
    j_sampler.sampling(None, None, 30, 1, j_state.RoundStats())
    rd = os.path.join("sampling", "-".join(sargs), "round_2")
    _same_files(os.path.join(t_dir, rd), os.path.join(j_dir, rd))
    assert runs and any(r["replays"] for r in runs)


def test_gcn_round_through_replays_writes_eager_files(tmp_path, standin):
    """A gcn-branch round (a 12-step coreGCN fit and k-center) with its
    loops through the stand-in writes the eager port's round files."""
    cfg = small_cfg()
    dirs = []
    for mode in ("graph", "eager"):
        work = str(tmp_path / mode)
        train, state, total = _workload(work)
        sargs = twin.sampler_args("gcn")
        sampler = t_samplers.TSampler(
            t_state.ALState(work, sargs), train, cfg,
            t_samplers.TSamplerArgs(diversity="gcn", gcn_steps=12),
            total["sp_num"], device="cpu", eager=mode == "eager")
        params = init_params(cfg, torch.Generator().manual_seed(0))
        step = make_eval_step(RandLANet(cfg), cfg, "xla", True, device="cpu")
        with graphs.record_runs() as runs:
            sampler.sampling(step, params, 30, 1, t_state.RoundStats())
        replays = {r["name"]: r["replays"] for r in runs}
        assert replays["fit_gcn"] == 12 - graphs.GRAPH_WARMUP
        assert (replays["kcenter_greedy"] > 0) == (mode == "graph")
        dirs.append(os.path.join(work, "sampling", "-".join(sargs),
                                 "round_2"))
    _same_files(*dirs)


# ------------------------------------------------------------ the twin ---


def test_twin_workload_equals_bench(tmp_path):
    """profile_selection.build_selection_workload at 6 clouds x 2048
    points writes bench.py::_build_selection_workload(fast_partition=
    True)'s files byte for byte: the registry, the superpoint files and
    the seed round."""
    sys.path.insert(0, ROOT)
    bench = importlib.import_module("bench")
    t_dir, j_dir = str(tmp_path / "t"), str(tmp_path / "j")
    twin.build_selection_workload(t_dir, 6, 2048)
    bench._build_selection_workload(j_dir, 6, 2048, fast_partition=True)
    for sub in ("superpoint", os.path.join("sampling", "seed", "round_1")):
        _same_files(os.path.join(t_dir, sub), os.path.join(j_dir, sub))
    assert len(os.listdir(os.path.join(t_dir, "superpoint"))) == 13


@pytest.mark.parametrize("extra", [[], ["--diversity", "edcd",
                                         "--chunk_batch", "4"]])
def test_twin_runs_on_the_cpu(extra):
    """python -m ssdr_al_torch.scripts.profile_selection at 4 clouds x
    1024 points and 60 clicks on the CPU (gcn_fps, and edcd with a chunk
    group of 4): one JSON line a record, setup, the warm round and the
    measured round with its phases and stats."""
    r = subprocess.run(
        [sys.executable, "-m", "ssdr_al_torch.scripts.profile_selection",
         "--clouds", "4", "--points", "1024", "--budget", "60",
         "--device", "cpu", *extra], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-2000:]
    recs = [json.loads(line) for line in r.stdout.splitlines()]
    assert [x["event"] for x in recs] == ["setup", "warm_round",
                                          "measured_round"]
    assert recs[0]["clouds"] == 4 and recs[0]["sp_num"] > 0
    m = recs[2]
    assert m["round"] == 3 and m["stats"]["gcn_sp_num"] == 60
    assert {"prediction_s", "diversity_s", "oracle_s"} <= set(m["phases"])
    assert ("div_gcn_s" in m["phases"]) == (not extra)


# ----------------------------------------------------------- the card ---


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _both(loop, n, dev):
    """(eager picks, replayed picks, the replayed run's record)."""
    eager = loop(n, True)
    with graphs.record_runs() as runs:
        graphed = loop(n, False)
    torch.cuda.synchronize(dev)
    return eager, graphed, runs[0]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,steps", [("farthest_feature_sample", 9999),
                                        ("kcenter_greedy", 10000)])
def test_replays_equal_eager_at_round_length(dev, kind, steps):
    """At the at-scale round's lengths (20 000 rows; 9 999 FPS steps over
    32 features, 10 000 k-center steps over 129, the GEMV in full f32):
    the replayed picks are the eager loop's, bit for bit."""
    from ssdr_al_torch.train.step_times import greedy_loop

    eager, graphed, run = _both(greedy_loop(kind, dev, 20_000), steps, dev)
    assert run["replays"] == steps - graphs.GRAPH_WARMUP
    assert torch.equal(eager, graphed)
    assert len(torch.unique(graphed)) == graphed.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [4, 8, 30, 64, 200])
def test_superpoint_replays_equal_eager(dev, steps):
    """edcd's per-cloud loops (a candidate cloud's 256 superpoints): the
    replayed picks are the eager loop's at every length."""
    from ssdr_al_torch.train.step_times import greedy_loop

    eager, graphed, run = _both(
        greedy_loop("farthest_superpoint_sample", dev, 256), steps, dev)
    assert run["replays"] == steps - graphs.GRAPH_WARMUP
    assert torch.equal(eager, graphed)


@pytest.mark.cuda
@pytest.mark.parametrize("diversity", ["gcn_fps", "gcn", "edcd"])
def test_card_round_graph_equals_eager(dev, tmp_path, diversity):
    """A 20-cloud round of the twin's workload (4096 points a cloud, 1000
    clicks) from the seed registry, with graphs and eagerly: identical
    round files, and the graph round replayed each of its loops."""
    work = str(tmp_path)
    train, state, total = twin.build_selection_workload(
        work, 20, 4096, diversity=diversity)
    dirs = []
    for eager in (False, True):
        sampler, step, params = twin.make_selection_sampler(
            train, state, total, 4096, diversity=diversity, device=dev,
            eager=eager)
        with graphs.record_runs() as runs:
            sampler.sampling(step, params, 1000, 1, t_state.RoundStats())
        loops = [r for r in runs if r["name"] != "fit_gcn"]
        assert loops and all((r["replays"] > 0) != eager for r in loops
                             if r["steps"] > 3 + t_fps.MIN_REPLAYS)
        rd = state.round_dir(2)
        dirs.append(rd + ("_eager" if eager else "_graph"))
        shutil.move(rd, dirs[-1])
    _same_files(*dirs)


@pytest.mark.cuda
def test_replay_kernels_as_counted(dev):
    """200 more steps of the FPS loop cost 200 eager steps' kernels and
    host launches eagerly, and the same kernels with one host launch a
    step as replays (torch.profiler, loops of 203 and 403 steps each way);
    no hand-written kernel launches (kernels/counts.py: the loop has
    none)."""
    from ssdr_al_torch.kernels import counts
    from ssdr_al_torch.train.step_times import busy_share, greedy_loop

    loop = greedy_loop("farthest_feature_sample", dev, 20_000)
    loop(300, False)                    # the first capture's set-up
    before = counts.read()
    got = {(mode, n): busy_share(lambda: loop(n, mode == "eager"), reps=1)
           for mode in ("eager", "graph") for n in (203, 403)}
    assert counts.read() == before

    def more(mode, key):
        return got[mode, 403][key] - got[mode, 203][key]

    per_step = more("eager", "kernels") / 200
    assert per_step == int(per_step) >= 5
    assert more("eager", "host_launches") == 200 * per_step
    assert more("graph", "kernels") == 200 * per_step
    assert more("graph", "host_launches") == 200
