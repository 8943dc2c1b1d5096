"""The eval step and the selection's fused forward as captured programs
(train/trainer.py::EvalStep, fused_program; train/graphs.py::
ForwardGraphs).

On the CPU: make_eval_step's static body and InferenceRunner's fused
reduction against JAX's make_eval_step and _eval_reduced_fn on the
`window` (JAX's Pallas kernels in interpret mode), `pallas` and `xla`
engines, within the eval parity bounds of tests/test_torch_model.py and
test_torch_knn_engines.py. Then a CPU stand-in for a replay (the capture
runs the program once; each replay runs it again from the staged inputs
and copies its results into the captured output tensors, in place): run
through it, Evaluator (votes, mIoU, OA), simple_evaluate,
InferenceRunner.run_many (with keep_penult_on_device and
region_feature_means), cli.evaluate and a TSampler round equal the eager
port bit for bit, and JAX's as the existing parity tests hold them. So
no caller keeps an output that the next replay overwrites.

Marked `cuda` (skipped here, run on the card): replays bitwise equal to
eager calls at each call site's shape on all five engines in f32 and
bf16; Evaluator's (mIoU, OA) and a selection round's picks the same with
graphs and eagerly; a replay after restore_model and after a training
round reads the new weights; a replay's K1/K2/K5/K6 launches equal its
capture's, and a profiled replay's trace holds them; a host sync in the
forward makes the capture raise.

This file imports no jax at its top, so its CUDA tests also run where jax
is not installed:

    python -m pytest tests/test_torch_eval_graph.py -m cuda --noconftest -q
"""

import dataclasses
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from ssdr_al_torch.active import samplers as t_samplers
from ssdr_al_torch.active import state as t_state
from ssdr_al_torch.config import ConfigS3DIS
from ssdr_al_torch.kernels import counts
from ssdr_al_torch.models import randlanet as tr
from ssdr_al_torch.train import evaluator as t_eval
from ssdr_al_torch.train import graphs
from ssdr_al_torch.train import trainer as tt

torch.set_num_threads(1)

ENGINES = ("window", "pallas", "xla")
N = 2048
# the eval parity bounds (tests/test_torch_model.py): exact pyramids hold
# probs and penult to rtol 1e-4, atol 1e-5 (penult's atol scaled by its
# magnitude, test_torch_knn_engines.py); on the window engine JAX gathers
# in bf16 inside its kernel, so classes agree on >= 99 % of the points and
# penult within 1e-2 relative L2
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-5
CLASS_AGREEMENT, REL_ERR = 0.99, 1e-2
# an f16 output (uncertainty, clipped penult) rounds once more on each
# side: two of its ulps more
F16_RTOL = 2.0 ** -10
SSDR_ARGS = ["t0", "sb", "clsbal", "gcn_fps", "WetSU", "NAIL", "0.9", "1",
             "1", "0"]


def small_cfg(**over):
    """tests/torch_parity.py's narrow RandLA-Net (3 layers, d_out (8, 16,
    32)), without importing jax."""
    base = dict(num_layers=3, d_out=(8, 16, 32), sub_sampling_ratio=(4, 4, 2),
                num_points=N)
    base.update(over)
    return dataclasses.replace(ConfigS3DIS, **base)


def _batch(seed, b, n=N):
    rng = np.random.RandomState(seed)
    xyz = (rng.rand(b, n, 3) * 4).astype(np.float32)
    return {"xyz": xyz, "features": np.concatenate(
        [xyz, rng.rand(b, n, 3).astype(np.float32)], -1)}


# ---------------------------------------------------------- stand-in ---


class _ReplayStandIn:
    """A CPU stand-in for a captured torch.cuda.CUDAGraph: replay() runs
    the captured program again from its static inputs and writes the
    results into the output tensors the capture returned, in place, as a
    replay rewrites a graph's static outputs."""

    def __init__(self, fn, outputs):
        self.fn = fn
        self.outputs = outputs

    def replay(self):
        with torch.inference_mode():
            for o, new in zip(self.outputs, self.fn()):
                o.copy_(new)


@pytest.fixture
def standin(monkeypatch):
    """graphs.warm and graphs.capture on the CPU (the capture runs the
    program once, its graph a _ReplayStandIn), and the allocator calls
    they make stubbed; returns graphed(eval_step), which gives a CPU
    EvalStep its ForwardGraphs."""

    def capture(step, generators, device):
        out = step()
        return graphs.Graph(_ReplayStandIn(step, out), {}), out

    monkeypatch.setattr(graphs, "warm", lambda step, device: step())
    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 0)

    def graphed(step):
        assert step.graphs is None and step.device.type == "cpu"
        step.graphs = graphs.ForwardGraphs(step.device)
        return step

    return graphed


def _eval_steps(cfg, engine, sorted_outputs, graphed):
    """(eager, graphed) port eval steps on the CPU."""
    eager, graph = (tt.make_eval_step(tr.RandLANet(cfg), cfg, engine,
                                      sorted_outputs, device="cpu")
                    for _ in range(2))
    return eager, graphed(graph)


def _assert_same(a, b, what):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and torch.equal(x, y), (what, i)


# ------------------------------------------------------- JAX parity ---


@pytest.fixture(scope="module")
def jax_case():
    """{engine: (JAX eval outputs, JAX _eval_reduced outputs)}, the port's
    state_dict, the batch and the JAX state: random O(1) flax weights
    (seed 5) on two blocks of N points. On `window` JAX's eval step builds
    its TPU pyramid (the sorted one, its Pallas kernels in interpret
    mode), as tests/test_torch_model.py's sorted_case does."""
    import jax
    import jax.numpy as jnp

    from ssdr_al_tpu.active import samplers as j_samplers
    from ssdr_al_tpu.models import randlanet as jr
    from ssdr_al_tpu.train import trainer as jt
    from torch_parity import interpret, random_flax_variables

    cfg = small_cfg()
    batch = _batch(3, 2)
    model = jr.RandLANet(cfg)
    state = jt.create_train_state(model, cfg, jax.random.PRNGKey(0),
                                  _batch(0, 1, 512), 500)
    v = random_flax_variables({"params": state.params,
                               "batch_stats": state.batch_stats}, seed=5)
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"])
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}

    def tpu_pyramid(xyz, cfg, engine="window"):
        # the TPU's sorted pyramid (JAX's CPU backend takes the XLA one)
        if engine != "window":
            return jr.build_pyramid(xyz, cfg, engine=engine)
        return jax.vmap(lambda x: jr._pyramid_window_sorted_single(x, cfg))(
            xyz)

    out = {}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jt, "build_pyramid", tpu_pyramid)
        for engine in ENGINES:
            step = jt.make_eval_step(model, cfg, engine, sorted_outputs=True)
            with interpret():
                ev = [np.asarray(x) for x in step(state, jbatch)]
                red = [np.asarray(x) for x in j_samplers._eval_reduced_fn(
                    step, "sb")(state, jbatch)]
            out[engine] = (ev, red)
    return cfg, tr.params_from_flax(v["params"], v["batch_stats"]), batch, \
        out, state


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _close_share(a, b, rtol, atol):
    """The share of the rows of a within rtol / atol of b's."""
    ok = np.abs(a - b) <= atol + rtol * np.abs(b)
    return float(ok.reshape(len(ok), -1).all(1).mean())


@pytest.mark.parametrize("engine", ENGINES)
def test_static_eval_body_matches_jax(jax_case, standin, engine):
    """make_eval_step's body on static inputs, replayed through the
    stand-in, equals the eager call bit for bit, and JAX's make_eval_step
    (sorted outputs) within the eval parity bounds; order equal."""
    cfg, sd, batch, want, _ = jax_case
    eager, graph = _eval_steps(cfg, engine, True, standin)
    ref = eager(sd, batch)
    for _ in range(2):                       # the capture, then a replay
        got = graph(sd, batch)
        _assert_same(got, ref, engine)
    assert graph.stats()["replays"] == 2 and graph.stats()["captures"] == 1
    probs, penult, order = (x.numpy() for x in got)
    w_probs, w_penult, w_order = want[engine][0]
    np.testing.assert_array_equal(order, w_order.astype(np.int64))
    if engine == "window":
        agree = float((probs.argmax(-1) == w_probs.argmax(-1)).mean())
        assert agree >= CLASS_AGREEMENT, agree
        assert _rel(penult, w_penult) <= REL_ERR
        assert _rel(probs, w_probs) <= REL_ERR
    else:
        np.testing.assert_allclose(probs, w_probs, rtol=LOGIT_RTOL,
                                   atol=LOGIT_ATOL)
        np.testing.assert_allclose(penult, w_penult, rtol=LOGIT_RTOL,
                                   atol=LOGIT_ATOL * np.abs(w_penult).max())


@pytest.mark.parametrize("engine", ENGINES)
def test_fused_reduction_matches_jax(jax_case, standin, engine):
    """InferenceRunner's program (the forward, point_uncertainty "sb",
    argmax to u8, the clip to f16) as one replayed capture equals the
    eager composition bit for bit, and JAX's _eval_reduced_fn: classes
    and order equal (classes on >= 99 % of points on `window`), the f16
    uncertainty and penult within the eval bounds plus two f16 ulps
    (relative L2 1e-2 on `window`, 2e-2 for the sb ratio of two
    probabilities)."""
    cfg, sd, batch, want, _ = jax_case
    eager, graph = _eval_steps(cfg, engine, True, standin)
    tail = t_samplers._point_reduce("sb")
    program = tt.fused_program(graph, ("point_reduce", "sb"), tail)
    ref = tail(*eager(sd, batch))
    for _ in range(2):
        got = program(sd, batch)
        _assert_same(got, ref, engine)
    cls, unc, f16, order = (x.numpy() for x in got)
    w_cls, w_unc, w_f16, w_order = want[engine][1]
    assert cls.dtype == w_cls.dtype == np.uint8
    assert unc.dtype == w_unc.dtype == f16.dtype == np.float16
    np.testing.assert_array_equal(order, w_order.astype(np.int64))
    unc, w_unc = unc.astype(np.float32), w_unc.astype(np.float32)
    f16, w_f16 = f16.astype(np.float32), w_f16.astype(np.float32)
    if engine == "window":
        # the sb ratio sums the relative errors of its two probabilities
        assert float((cls == w_cls).mean()) >= CLASS_AGREEMENT
        assert _rel(unc, w_unc) <= 2 * REL_ERR and _rel(f16, w_f16) <= REL_ERR
    else:
        # classes differ only where the top two probabilities tie within
        # the probs bound
        probs = want[engine][0][0]
        top2 = np.sort(probs, -1)[..., -2:]
        tie = top2[..., 1] - top2[..., 0] <= 2 * (
            LOGIT_RTOL * top2[..., 1] + LOGIT_ATOL)
        assert ((cls == w_cls) | tie).all()
        np.testing.assert_allclose(unc, w_unc, rtol=2 * LOGIT_RTOL + F16_RTOL,
                                   atol=LOGIT_ATOL)
        np.testing.assert_allclose(f16, w_f16, rtol=LOGIT_RTOL + F16_RTOL,
                                   atol=LOGIT_ATOL * np.abs(w_f16).max())


# ------------------------------------------- callers through the stand-in


def _val_clouds():
    from ssdr_al_torch.data.synthetic import make_dataset

    return make_dataset(num_train=0, num_val=2, num_points=2500, seed=4,
                        hard=True)[1]


def test_evaluator_through_replays(jax_case, standin, monkeypatch):
    """Evaluator (possibility schedule, vote smoothing, two epochs) with
    its f16 program replayed: every vote, the mIoU and the OA equal the
    eager port's bit for bit, and JAX's Evaluator on the same weights
    (xla engine) gives the same mIoU and OA."""
    from ssdr_al_tpu.train import evaluator as j_eval
    from ssdr_al_tpu.train import trainer as jt

    cfg, sd, _, _, jstate = jax_case
    cfg = dataclasses.replace(cfg, val_batch_size=2, val_steps=3)
    clouds = _val_clouds()
    votes = []
    finalize = t_eval.Evaluator._finalize

    def keep_votes(self, test_probs):
        votes.append([p.copy() for p in test_probs])
        return finalize(self, test_probs)

    monkeypatch.setattr(t_eval.Evaluator, "_finalize", keep_votes)
    eager, graph = _eval_steps(cfg, "xla", True, standin)
    got = [t_eval.Evaluator(cfg, clouds, seed=2, max_epochs=2)(s, sd)
           for s in (eager, graph)]
    assert got[0] == got[1]
    for a, b in zip(*votes):
        np.testing.assert_array_equal(a, b)
    st = graph.stats()
    assert st["captures"] == 1 and st["replays"] >= 4
    want = j_eval.Evaluator(cfg, clouds, seed=2, max_epochs=2)(
        jt.make_eval_step(_jax_model(cfg), cfg, "xla", True), jstate)
    assert got[1] == want


def test_simple_evaluate_through_replays(jax_case, standin):
    """simple_evaluate keeps every batch's probabilities before it reads
    any: with replays they equal the eager port's result, and JAX's."""
    from ssdr_al_tpu.data import dataset as j_dataset
    from ssdr_al_tpu.train import evaluator as j_eval
    from ssdr_al_tpu.train import trainer as jt

    cfg, sd, _, _, jstate = jax_case
    pipe = j_dataset.PossibilityEvalPipeline(_val_clouds(), cfg, seed=1)
    batches = [pipe.get_batch(2) for _ in range(3)]
    nc = cfg.num_classes
    eager, graph = _eval_steps(cfg, "xla", True, standin)
    got = [t_eval.simple_evaluate(s, sd, batches, nc) for s in (eager, graph)]
    assert got[0] == got[1]
    assert graph.stats()["replays"] == 3
    want = j_eval.simple_evaluate(
        jt.make_eval_step(_jax_model(cfg), cfg, "xla", True), jstate,
        batches, nc)
    assert got[1] == want


def _jax_model(cfg):
    from ssdr_al_tpu.models import randlanet as jr

    return jr.RandLANet(cfg)


@pytest.mark.parametrize("keep", [False, True])
def test_inference_runner_through_replays(jax_case, standin, keep):
    """InferenceRunner.run_many over two rooms (chunk groups across the
    rooms, the last group padded) with its fused program replayed: the
    classes, uncertainties and penult (or, kept on the device, the
    region_feature_means) equal the eager port's bit for bit; against
    JAX's runner (xla engine) classes, uncertainties and penult agree on
    >= 99 % of the points within the bounds of
    test_fused_reduction_matches_jax (each side's exact search breaks the
    synthetic rooms' distance ties its own way, as the class agreement of
    test_torch_selection.py allows), the region means within 1e-2
    relative L2."""
    from ssdr_al_tpu.active import samplers as j_samplers
    from ssdr_al_tpu.train import trainer as jt
    from ssdr_al_torch.data.synthetic import grid_superpoints, make_dataset

    cfg, sd, _, _, jstate = jax_case
    rooms = make_dataset(num_train=2, num_val=0, num_points=3000, seed=6,
                         hard=True)[0]
    eager, graph = _eval_steps(cfg, "xla", True, standin)
    slots = {c.name: grid_superpoints(c.xyz, 16)[1] for c in rooms}
    offset, slot_maps = 0, {}
    for c in rooms:
        slot_maps[c.name] = slots[c.name] + offset
        offset += int(slots[c.name].max()) + 1

    def run(step, runner_cls, **kw):
        runner = runner_cls(cfg, rooms, step, sd if runner_cls is
                            t_samplers.InferenceRunner else jstate,
                            "sb", seed=1, chunk_batch=3,
                            keep_penult_on_device=keep, **kw)
        inf = runner.run_many(rooms)
        means = runner.region_feature_means(slot_maps, offset) if keep \
            else None
        return inf, means

    (a, ma), (b, mb) = (run(s, t_samplers.InferenceRunner, device="cpu")
                        for s in (eager, graph))
    assert graph.stats()["replays"] >= 2
    for c in rooms:
        for f in ("prob_class", "uncertainty", "penult"):
            x, y = getattr(a[c.name], f), getattr(b[c.name], f)
            assert (x is None) == (y is None) == (f == "penult" and keep)
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=f)
    if keep:
        np.testing.assert_array_equal(ma, mb)
    jinf, jmeans = run(jt.make_eval_step(_jax_model(cfg), cfg, "xla", True),
                       j_samplers.InferenceRunner)
    for c in rooms:
        got, want = b[c.name], jinf[c.name]
        assert float((got.prob_class == want.prob_class).mean()) >= \
            CLASS_AGREEMENT
        assert _close_share(got.uncertainty, want.uncertainty,
                            2 * LOGIT_RTOL + F16_RTOL, LOGIT_ATOL) >= \
            CLASS_AGREEMENT
        if not keep:
            g, w = (x.astype(np.float32) for x in (got.penult, want.penult))
            assert _close_share(g, w, LOGIT_RTOL + F16_RTOL,
                                LOGIT_ATOL * np.abs(w).max()) >= \
                CLASS_AGREEMENT
    if keep:
        assert _rel(mb, jmeans) <= REL_ERR


def test_cli_evaluate_through_replays(standin, tmp_path, monkeypatch,
                                      capsys):
    """cli.evaluate of one snapshot (random O(1) flax weights, as
    tests/test_torch_evaluate.py saves it) on the xla engine, its [1 × N]
    chunks replayed: the same PLYs, .labels files, result and printed
    line as the eager port's run, and the same OA / mIoU / IoU, line and
    predictions as JAX's run_evaluate."""
    import jax

    from ssdr_al_tpu.cli import evaluate as j_evaluate
    from ssdr_al_tpu.cli.common import setup_experiment as j_setup
    from ssdr_al_tpu.models.randlanet import RandLANet as JRandLANet
    from ssdr_al_tpu.train import trainer as jt
    from ssdr_al_torch.cli import evaluate
    from ssdr_al_torch.cli.common import setup_experiment
    from ssdr_al_torch.data.ply import read_ply
    from test_torch_evaluate import make_args
    from torch_parity import random_flax_variables

    monkeypatch.chdir(tmp_path)
    args = make_args(tmp_path, knn_engine="xla")
    setup_experiment(args)
    cfg = j_setup(args).cfg
    state = jt.create_train_state(JRandLANet(cfg), cfg,
                                  jax.random.PRNGKey(0),
                                  _batch(0, 1, cfg.num_points), 500)
    v = random_flax_variables({"params": state.params,
                               "batch_stats": state.batch_stats}, seed=3)
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"])
    j_snap, t_snap = str(tmp_path / "j_snap"), str(tmp_path / "t_snap")
    jt.save_checkpoint(j_snap, state)
    tt.save_checkpoint(t_snap, tr.params_from_flax(v["params"],
                                                   v["batch_stats"]))
    made = []
    make = evaluate.make_eval_step

    def graphed_step(*a, **kw):
        made.append(standin(make(*a, **kw)))
        return made[-1]

    outs, lines = {}, {}
    for mode in ("eager", "graph", "jax"):
        out = str(tmp_path / mode)
        a = make_args(tmp_path, knn_engine="xla", out=out,
                      snapshot=j_snap if mode == "jax" else t_snap)
        if mode == "jax":
            res = j_evaluate.run_evaluate(a)
        else:
            with monkeypatch.context() as m:
                if mode == "graph":
                    m.setattr(evaluate, "make_eval_step", graphed_step)
                res = evaluate.run_evaluate(a)
        outs[mode] = (out, res)
        lines[mode] = capsys.readouterr().out.strip().splitlines()[-1]
    st = made[0].stats()
    assert len(made) == 1 and st["captures"] == 1 and st["replays"] >= 2, st
    assert lines["eager"] == lines["graph"] == lines["jax"]
    assert outs["eager"][1] == outs["graph"][1] == outs["jax"][1]
    names = sorted(os.listdir(outs["eager"][0]))
    assert names == sorted(os.listdir(outs["graph"][0])) and names
    for name in names:
        a, b = (os.path.join(outs[m][0], name) for m in ("eager", "graph"))
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read(), name
        if name.endswith(".ply"):
            np.testing.assert_array_equal(
                read_ply(b)["pred"],
                read_ply(os.path.join(outs["jax"][0], name))["pred"])


def test_selection_round_through_replays(jax_case, standin, tmp_path,
                                         monkeypatch):
    """One full-SSDR TSampler round (gcn_fps: penult kept on the device,
    region_feature_means) with its fused program replayed, its chunks in
    groups of two (several replays a round): the picks, the registry and
    every .gt file equal the eager port's round byte for byte; against
    JAX's round on the same weights the picks overlap as
    tests/test_torch_selection.py holds them (>= 0.9)."""
    from ssdr_al_tpu.active import samplers as j_samplers
    from ssdr_al_tpu.active import state as j_state
    from ssdr_al_tpu.train import trainer as jt
    from test_torch_selection import _picked, _workload

    cfg, sd, _, _, jstate = jax_case
    cfg = dataclasses.replace(cfg, num_points=1024)
    dirs = {m: str(tmp_path / m) for m in ("eager", "graph", "jax")}
    train, sp_num = _workload(dirs["eager"])
    for m in ("graph", "jax"):
        shutil.copytree(dirs["eager"], dirs[m])
    with open(os.path.join(dirs["eager"], "superpoint", "total.pkl"),
              "rb") as f:
        before = pickle.load(f)["unlabeled"]
    eager, graph = _eval_steps(cfg, "xla", True, standin)
    init = t_samplers.InferenceRunner.__init__
    monkeypatch.setattr(t_samplers.InferenceRunner, "__init__",
                        lambda self, *a, **kw: init(self, *a, **dict(
                            kw, chunk_batch=2)))
    for m, step in (("eager", eager), ("graph", graph)):
        t_samplers.TSampler(
            t_state.ALState(dirs[m], SSDR_ARGS), train, cfg,
            t_samplers.TSamplerArgs(), sp_num,
            device="cpu").sampling(step, sd, 20, 1, t_state.RoundStats())
    assert graph.stats()["captures"] == 1 and graph.stats()["replays"] >= 3
    j_samplers.TSampler(
        j_state.ALState(dirs["jax"], SSDR_ARGS), train, cfg,
        j_samplers.TSamplerArgs(), sp_num).sampling(
            jt.make_eval_step(_jax_model(cfg), cfg, "xla", True),
            jstate, 20, 1, j_state.RoundStats())
    rd = os.path.join("sampling", "-".join(SSDR_ARGS), "round_2")
    names = sorted(os.listdir(os.path.join(dirs["eager"], rd)))
    assert names == sorted(os.listdir(os.path.join(dirs["graph"], rd)))
    for name in names:
        with open(os.path.join(dirs["eager"], rd, name), "rb") as f, \
                open(os.path.join(dirs["graph"], rd, name), "rb") as g:
            assert f.read() == g.read(), name
    picks = {m: _picked(dirs[m], before)[0] for m in dirs}
    assert picks["eager"] == picks["graph"] and picks["graph"]
    overlap = len(picks["graph"] & picks["jax"]) / max(
        len(picks["graph"]), len(picks["jax"]))
    assert overlap >= 0.9, overlap


def test_forward_graphs_keys_and_lifetime(standin):
    """ForwardGraphs: one capture per program, shape and state; a state
    of other tensors is captured anew (never a replay of the old
    weights); an in-place copy into the state is read by the next replay;
    a returned output is a copy the next replay leaves alone; at most
    FORWARD_GRAPHS captures are kept, the least recently used dropped."""
    from ssdr_al_torch.train.grad_check import spread_weights

    cfg = small_cfg(num_points=512)
    _, step = _eval_steps(cfg, "xla", False, standin)
    eager = tt.make_eval_step(step.model, cfg, "xla", False, device="cpu")
    # weights at O(1) scale: a fresh init gives near-constant outputs
    sd = spread_weights(tr.init_params(cfg, torch.Generator().manual_seed(
        0)), 1)
    b1, b2 = _batch(1, 2, 512), _batch(2, 2, 512)
    p1, _ = step(sd, b1)
    p2, _ = step(sd, b2)
    assert not torch.equal(p1, p2)
    assert torch.equal(p1, eager(sd, b1)[0])       # not overwritten
    assert torch.equal(p2, eager(sd, b2)[0])
    assert step.stats()["captures"] == 1
    other = {k: v.clone() * (1.5 if v.is_floating_point() else 1)
             for k, v in sd.items()}
    assert torch.equal(step(other, b1)[0], eager(other, b1)[0])
    assert step.stats()["captures"] == 2
    with torch.no_grad():
        for k, v in sd.items():            # restore_model's in-place copy
            v.copy_(other[k])
    assert torch.equal(step(sd, b1)[0], eager(other, b1)[0])
    assert step.stats()["captures"] == 2
    step(sd, _batch(3, 1, 512))                # a new shape
    tt.fused_program(step, "f16", t_eval._probs_f16)(sd, b1)
    assert step.stats()["captures"] == 4
    step(sd, _batch(4, 3, 512))
    st = step.stats()
    assert st["captures"] == 5 and st["graphs"] == graphs.FORWARD_GRAPHS
    # the least recently used capture (of `other`) was dropped
    assert torch.equal(step(other, b1)[0], eager(other, b1)[0])
    assert step.stats()["captures"] == 6


def test_eval_step_runs_eagerly_by_the_rule():
    """make_eval_step has no graphs on the CPU, under a data-parallel
    group or with eager=True; it asks for the card by default."""
    cfg = small_cfg(num_points=512)
    model = tr.RandLANet(cfg)
    for kw in ({}, {"group": object()}, {"eager": True}):
        assert tt.make_eval_step(model, cfg, device="cpu", **kw).graphs \
            is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tt.make_eval_step(model, cfg)


# ----------------------------------------------------------------- card ---


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


CARD_N = 16384
# each call site's batch: Evaluator [val_batch_size x N], InferenceRunner
# [cb x N] (8 at these widths), cli.evaluate [1 x N]
CALL_SITES = {"evaluator": 20, "inference": 8, "evaluate": 1}


def _card_cfg(dtype="float32"):
    return dataclasses.replace(ConfigS3DIS, num_points=CARD_N,
                               compute_dtype=dtype)


def _card_state(cfg, dev, seed=0):
    from ssdr_al_torch.train.grad_check import spread_weights

    return {k: v.to(dev) for k, v in spread_weights(tr.init_params(
        cfg, torch.Generator().manual_seed(0)), seed).items()}


@pytest.fixture(scope="module")
def card_rooms():
    from ssdr_al_torch.data.synthetic import make_dataset

    return make_dataset(num_train=2, num_val=1, num_points=30000, seed=0,
                        hard=True)


def _room_batch(rooms, b, seed):
    from ssdr_al_torch.data.dataset import PossibilityEvalPipeline

    return PossibilityEvalPipeline(rooms, _card_cfg(), seed=seed).get_batch(b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("engine", tr.KNN_ENGINES)
def test_replays_equal_eager_calls(dev, card_rooms, engine, dtype):
    """At each call site's shape, on every engine and dtype: three calls
    (the capture, two replays) of make_eval_step's graph and of its fused
    selection program, each bitwise equal to the eager call on the same
    batch; one capture a shape and program."""
    cfg = _card_cfg(dtype)
    sd = _card_state(cfg, dev)
    model = tr.RandLANet(cfg).to(dev)
    graph = tt.make_eval_step(model, cfg, engine, True, device=dev)
    eager = tt.make_eval_step(model, cfg, engine, True, device=dev,
                              eager=True)
    tail = t_samplers._point_reduce("sb")
    program = tt.fused_program(graph, ("point_reduce", "sb"), tail)
    val, train = card_rooms[1], card_rooms[0]
    for site, b in CALL_SITES.items():
        for i in range(3):
            batch = _room_batch(val if site != "inference" else train, b, i)
            want = eager(sd, batch)
            _assert_same(graph(sd, batch), want, (engine, dtype, site, i))
            _assert_same(program(sd, batch), tail(*want),
                         (engine, dtype, site, i, "fused"))
    st = graph.stats()       # a capture a site and program, 3 calls each
    assert st["captures"] == 2 * len(CALL_SITES) and \
        st["replays"] == 6 * len(CALL_SITES), st


def _evaluator_cfg():
    return dataclasses.replace(_card_cfg(), val_batch_size=6, val_steps=4)


@pytest.mark.cuda
def test_evaluator_and_selection_same_with_graphs(dev, card_rooms,
                                                  tmp_path):
    """Evaluator's (mIoU, OA) and a full-SSDR selection round's registry
    and .gt files are the same with graphs and with the eager eval step;
    the graphs replayed."""
    from ssdr_al_torch.cli.common import write_grid_superpoints

    cfg = _evaluator_cfg()
    sd = _card_state(cfg, dev)
    model = tr.RandLANet(cfg).to(dev)
    steps = {"graph": tt.make_eval_step(model, cfg, "window", True,
                                        device=dev),
             "eager": tt.make_eval_step(model, cfg, "window", True,
                                        device=dev, eager=True)}
    res = {m: t_eval.Evaluator(cfg, card_rooms[1], max_epochs=2)(s, sd)
           for m, s in steps.items()}
    assert res["graph"] == res["eager"]
    assert steps["graph"].stats()["replays"] >= 2
    train = card_rooms[0]
    dirs = {m: str(tmp_path / m) for m in steps}
    total = write_grid_superpoints(t_state.ALState(dirs["eager"], []), train,
                                   256)
    t_samplers.SeedSampler(t_state.ALState(dirs["eager"], ["seed"]), train,
                           total["sp_num"]).sampling(
        total["sp_num"] // 10, 0, t_state.RoundStats())
    shutil.copytree(dirs["eager"], dirs["graph"])
    before = steps["graph"].stats()["replays"]
    for m, s in steps.items():
        t_samplers.TSampler(t_state.ALState(dirs[m], SSDR_ARGS), train, cfg,
                            t_samplers.TSamplerArgs(),
                            total["sp_num"], device=dev).sampling(
            s, sd, 40, 1, t_state.RoundStats())
    assert steps["graph"].stats()["replays"] > before
    rd = os.path.join("sampling", "-".join(SSDR_ARGS), "round_2")
    names = sorted(os.listdir(os.path.join(dirs["eager"], rd)))
    assert names and names == sorted(os.listdir(os.path.join(
        dirs["graph"], rd)))
    for name in names:
        with open(os.path.join(dirs["eager"], rd, name), "rb") as f, \
                open(os.path.join(dirs["graph"], rd, name), "rb") as g:
            assert f.read() == g.read(), name


@pytest.mark.cuda
def test_replay_reads_new_weights(dev, card_rooms, tmp_path):
    """A Trainer's eval graph replays one capture across a restore_model
    and a training round, and each replay reads the weights of the
    moment: equal to an eager call on a copy of the state."""
    from ssdr_al_torch.data.dataset import TrainingPipeline

    cfg = dataclasses.replace(_card_cfg(), batch_size=2, train_steps=4,
                              max_epoch=1)
    trainer = tt.Trainer(cfg, "S3DIS", save_dir=str(tmp_path / "t"),
                         device=dev, log_fn=lambda m: None)
    trainer.init_state()
    eager = tt.make_eval_step(tr.RandLANet(cfg).to(dev), cfg, "window", True,
                              device=dev, eager=True)
    batch = _room_batch(card_rooms[1], 8, 0)

    def check(what):
        copy = {k: v.clone() for k, v in trainer.state.items()}
        _assert_same(trainer.eval_step(trainer.state, batch),
                     eager(copy, batch), what)

    check("init")
    spread = {k: v * 1.25 if v.is_floating_point() else v.clone()
              for k, v in trainer.state.items()}
    tt.save_checkpoint(trainer.snapshot_path(7), spread)
    trainer.restore_model(7)
    assert torch.equal(trainer.state["fc0.weight"],
                       spread["fc0.weight"].to(dev))
    check("restored")
    pipe = TrainingPipeline(card_rooms[0], cfg, seed=1)
    trainer.train_round(1, lambda e: [pipe.sample_batch(cfg.batch_size)
                                      for _ in range(cfg.train_steps)])
    check("trained")
    st = trainer.eval_step.stats()
    assert st["captures"] == 1 and st["replays"] == 3, st


@pytest.mark.cuda
@pytest.mark.parametrize("engine,mxu", [("window", False), ("window", True),
                                        ("pallas", False)])
def test_replays_count_and_trace_their_kernels(dev, card_rooms, engine,
                                               mxu):
    """A replay adds its capture's launches of K1 / K5 / K2 / K6 (counts
    of an eager call), and a torch.profiler trace of a replay holds the
    kernels as often as counted (repeat_check.traced_eval_kernels)."""
    from ssdr_al_torch.ops import knn as kn
    from ssdr_al_torch.train.repeat_check import (
        EVAL_TRACED,
        traced_eval_kernels,
    )

    cfg = _card_cfg()
    sd = _card_state(cfg, dev)
    model = tr.RandLANet(cfg).to(dev)
    batch = _room_batch(card_rooms[1], 4, 0)
    kn.MXU_DISTANCE_DEFAULT = mxu
    try:
        eager = tt.make_eval_step(model, cfg, engine, True, device=dev,
                                  eager=True)
        graph = tt.make_eval_step(model, cfg, engine, True, device=dev)
        counts.reset()
        eager(sd, batch)
        one = counts.read()
        graph(sd, batch)                              # the capture
        counts.reset()
        for _ in range(3):
            graph(sd, batch)
        torch.cuda.synchronize()
        assert counts.read() == {k: 3 * v for k, v in one.items()}
        traced = traced_eval_kernels(lambda: graph(sd, batch))
    finally:
        kn.MXU_DISTANCE_DEFAULT = False
    want = {k: sum(one[c] for c in keys)
            for k, (_, keys) in EVAL_TRACED.items()}
    assert traced == want, (traced, one)
    key = {("window", False): "window_topk", ("window", True):
           "window_topk_mxu", ("pallas", False): "knn_tiled"}[(engine, mxu)]
    # the sorted pyramid gathers through K2, the original-order one not
    assert one[key] > 0 and (one["gather_window"] > 0) == (engine ==
                                                           "window")


_CAPTURE_FAILS = """
import dataclasses, sys
import torch
sys.path.insert(0, "tests")
import test_torch_eval_graph as tg
from ssdr_al_torch.data.synthetic import make_dataset
from ssdr_al_torch.models import randlanet as tr
from ssdr_al_torch.train import trainer as tt

softmax = torch.softmax

def syncing_softmax(x, *a, **kw):
    x.sum().item()      # a host sync, which a stream capture refuses
    return softmax(x, *a, **kw)

torch.softmax = syncing_softmax
dev = torch.device("cuda", 0)
rooms = make_dataset(num_train=0, num_val=1, num_points=30000, seed=0,
                     hard=True)[1]
cfg = tg._card_cfg()
step = tt.make_eval_step(tr.RandLANet(cfg).to(dev), cfg, "window", True,
                         device=dev)
step(tg._card_state(cfg, dev), tg._room_batch(rooms, 2, 0))
print("RAN")
"""


@pytest.mark.cuda
def test_failed_eval_capture_raises(dev, tmp_path):
    """A forward that a capture cannot record (a host sync) makes the eval
    step raise; nothing runs it eagerly instead. In a child process: a
    failed capture may leave the process's CUDA context unusable."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _CAPTURE_FAILS], cwd=root,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode != 0 and "RAN" not in r.stdout, r.stdout
    assert "capture" in r.stderr.lower(), r.stderr[-2000:]
