"""A round's train steps as one captured program (train/graphs.py,
trainer.make_static_step, Trainer.train_round).

On the CPU: the static-buffer step of each path equals today's eager step
bit for bit; Trainer.train_round equals a loop of the eager steps across
an epoch boundary and two rounds; the device learning rate follows
make_lr_schedule; the pooled extraction at the pool's static window
equals the per-batch window's and JAX's extract_blocks; the launch-count
bookkeeping of a captured graph; knn_window's probes and
synth_class_weights against JAX. Marked `cuda` (skipped here, run on the
card): graph replays against eager steps on every path, dtype and engine,
the launch counts per replay and a replay's device trace against them,
the card's Adam against the CPU's, and a failed capture raising.

This file imports no jax at its top, so its CUDA tests also run where jax
is not installed:

    python -m pytest tests/test_torch_train_graph.py -m cuda --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from ssdr_al_torch.config import ConfigS3DIS, ConfigSemantic3D
from ssdr_al_torch.data.cloud import Cloud
from ssdr_al_torch.data.dataset import TrainingPipeline
from ssdr_al_torch.kernels import counts
from ssdr_al_torch.train import graphs
from ssdr_al_torch.train import trainer as tt
from ssdr_al_torch.train.device_pool import DeviceTrainPool
from ssdr_al_torch.train.possibility_pool import PossibilityDevicePool

torch.set_num_threads(1)

TINY = dataclasses.replace(ConfigS3DIS, num_points=512,
                           d_out=(4, 8, 8, 8, 8), num_classes=3,
                           batch_size=2, train_steps=2, max_epoch=2)
PATHS = tt.STEP_PATHS


def _clouds(seed, sizes, num_classes=3):
    """Random clouds with labels, and one round's pseudo-GT {name: [2, n]}."""
    rng = np.random.RandomState(seed)
    clouds, pseudo = [], {}
    for i, n in enumerate(sizes):
        name = f"c{i}"
        clouds.append(Cloud(
            name=name, xyz=(rng.rand(n, 3) * 4).astype(np.float32),
            colors=rng.rand(n, 3).astype(np.float32),
            labels=rng.randint(0, num_classes, n).astype(np.int32)))
        pseudo[name] = np.stack([(rng.rand(n) > 0.4).astype(np.float32),
                                 rng.randint(0, num_classes, n).astype(
                                     np.float32)])
    return clouds, pseudo


def _trainer(cfg, tmp_path, name, dev, engine="xla"):
    """A Trainer from the init weights of seed 0: the dataset's class
    weights, flat ones for the 3-class TINY config."""
    trainer = tt.Trainer(
        cfg, "Semantic3D" if cfg.ignored_label_inds else "S3DIS",
        save_dir=str(tmp_path / name), knn_engine=engine, device=dev,
        weights=np.ones(3, np.float32) if cfg.num_classes == 3 else None,
        log_fn=lambda m: None)
    trainer.init_state()
    return trainer


def _pool(path, clouds, cfg, pseudo, dev, seed=1):
    if path == "pool":
        return DeviceTrainPool(clouds, cfg, pseudo_gt=pseudo, seed=seed,
                               device=dev)
    if path == "possibility":
        return PossibilityDevicePool(clouds, cfg, pseudo_gt=pseudo,
                                     seed=seed, device=dev)
    return None


def _adam_state(state):
    opt = state.optimizer
    return [opt.state[p][k] for p in state.model.parameters()
            for k in ("exp_avg", "exp_avg_sq", "step") if p in opt.state]


def _assert_same_state(a, b, what):
    """Parameters, BatchNorm statistics and Adam's moments bitwise."""
    for (k, x), (_, y) in zip(a.model.state_dict().items(),
                              b.model.state_dict().items()):
        assert torch.equal(x, y), (what, k)
    sa, sb = _adam_state(a), _adam_state(b)
    assert len(sa) == len(sb) > 0, what
    for i, (x, y) in enumerate(zip(sa, sb)):
        assert torch.equal(x, y), (what, "adam", i)
    assert a.step == b.step, what


# ------------------------------------------------------------------ CPU ---


def _dynamic_step(trainer, path, pool):
    """The eager step as it was before the static buffers: numpy blocks
    uploaded inside the step, the pooled blocks extracted at the batch's
    largest cloud, the possibility field threaded as a value; step(draw,
    poss) → (metrics, new poss) on the trainer's state, its update
    counted."""
    from ssdr_al_torch.train.device_pool import shuffle_blocks
    from ssdr_al_torch.train.possibility_pool import possibility_extract

    cfg, state, dev = trainer.cfg, trainer.train_state, trainer.device
    body = tt._make_step_body(trainer.model, cfg, trainer.weights, "xla",
                              dev)

    def step(draw, poss):
        if path == "host":
            blocks = [torch.as_tensor(np.asarray(draw[k]), dtype=dt)
                      for k, dt in tt.HOST_INPUTS.items()]
        elif path == "pool":
            blocks = shuffle_blocks(pool.extract(*draw), pool.generator)
        else:
            poss, *blocks = possibility_extract(
                *pool.device_args(), pool.class_weight, poss,
                pool.generator, cfg.batch_size, cfg.num_points,
                cfg.noise_init / 10, pool.window, pool.augment)
            blocks = shuffle_blocks(blocks, pool.generator)
        return tt._advance(state, lambda: body(
            state, *blocks, trainer.dropout_gen)), poss

    return step


@pytest.mark.parametrize("path", PATHS)
def test_static_step_equals_eager_step(path, tmp_path):
    """make_static_step from the same state and draws as the eager step
    as it was before the static buffers (_dynamic_step), three steps:
    every loss, parameter, BatchNorm statistic and Adam moment bitwise
    equal, and the possibility field too. The pooled clouds differ in
    size, so the static window (the largest cloud) is wider than most
    batches'."""
    clouds, pseudo = _clouds(0, [700, 1500, 900])
    eager, static = (_trainer(TINY, tmp_path, n, "cpu") for n in "ab")
    pools = [_pool(path, clouds, TINY, pseudo, "cpu") for _ in range(2)]
    batches = [TrainingPipeline(clouds, TINY, pseudo_gt=pseudo, seed=2)
               .sample_batch(TINY.batch_size) for _ in range(3)]
    inputs, step = tt.make_static_step(static.model, TINY, static.weights,
                                       "xla", path, pool=pools[1],
                                       device="cpu")
    dynamic = _dynamic_step(eager, path, pools[0])
    poss = None
    if path == "possibility":
        pools[1].field.copy_(pools[1].init_possibility)
        poss = pools[0].init_possibility
    for i in range(3):
        if path == "host":
            want, _ = dynamic(batches[i], None)
            inputs.stage(batches[i])
        elif path == "pool":
            want, _ = dynamic(pools[0].sample_indices(TINY.batch_size), None)
            inputs.stage(dict(zip(tt.POOL_INPUTS,
                                  pools[1].sample_indices(TINY.batch_size))))
        else:
            want, poss = dynamic(None, poss)
        tt.set_lr(static.train_state)
        got = step(static.train_state, static.dropout_gen)
        static.train_state.step += 1
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
    _assert_same_state(eager.train_state, static.train_state, path)
    if path == "possibility":
        assert torch.equal(pools[1].field, poss)


def _eager_round(trainer, path, pool, pipe_seed, clouds, pseudo, cfg):
    """One round as a loop of today's eager steps on the round's draws:
    (losses, final field or None)."""
    state = trainer.train_state = tt.reset_optimizer(
        trainer.train_state, cfg, trainer.steps_per_epoch)
    pipe = TrainingPipeline(clouds, cfg, pseudo_gt=pseudo, seed=pipe_seed)
    poss = None if path != "possibility" else (
        pool.init_possibility if pool.poss_state is None else pool.poss_state)
    losses = []
    for _ in range(cfg.max_epoch * cfg.train_steps):
        if path == "host":
            _, m = trainer.train_step(state, pipe.sample_batch(
                cfg.batch_size), trainer.dropout_gen)
        elif path == "pool":
            _, m = trainer.pooled_step(state, pool, *pool.sample_indices(
                cfg.batch_size), trainer.dropout_gen)
        else:
            _, poss, m = trainer.possibility_step(state, pool, poss,
                                                  trainer.dropout_gen)
        losses.append(m["loss"])
    if poss is not None:
        pool.poss_state = poss
    return torch.stack(losses), poss


def _rounds(path, cfg, clouds, pseudos, dev, tmp_path, engine="xla",
            check=None):
    """Two rounds on `path` through Trainer.train_round and as a loop of
    eager steps, from one state (a reseed, update_pseudo_gt and a fresh
    Adam between them): check(graph_trainer, eager_trainer, losses) after
    each; returns the graph trainer."""
    graph, eager = (_trainer(cfg, tmp_path, n, dev, engine)
                    for n in ("graph", "eager"))
    pools = [_pool(path, clouds, cfg, pseudos[0], dev) for _ in range(2)]
    for r, pseudo in enumerate(pseudos, 1):
        for p in pools:
            if p is not None:
                p.update_pseudo_gt(pseudo)
                p.reseed(r)
                if path == "possibility":
                    p.reset_possibility(r)
        pipe = TrainingPipeline(clouds, cfg, pseudo_gt=pseudo, seed=r)
        graph.train_round(r, lambda e: [pipe.sample_batch(cfg.batch_size)
                                        for _ in range(cfg.train_steps)],
                          device_pool=pools[0])
        want, poss = _eager_round(eager, path, pools[1], r, clouds, pseudo,
                                  cfg)
        got = torch.stack(graph.round_losses)
        assert torch.equal(got, want), (r, got, want)
        _assert_same_state(graph.train_state, eager.train_state, (path, r))
        if poss is not None:
            assert torch.equal(pools[0].poss_state, poss)
        if check is not None:
            check(graph, eager, got)
    return graph


@pytest.mark.parametrize("path", PATHS)
def test_train_round_equals_eager_steps_cpu(path, tmp_path):
    """Trainer.train_round (the static-buffer steps, eager on the CPU)
    against a loop of today's eager steps: two rounds of 2 epochs × 2
    steps, the learning rate decaying at the epoch boundary, a reseed, new
    planes and a fresh Adam between the rounds; every loss, parameter,
    BatchNorm statistic and Adam moment bitwise equal."""
    clouds, p1 = _clouds(3, [700, 1500, 900])
    _, p2 = _clouds(4, [700, 1500, 900])
    trainer = _rounds(path, TINY, clouds, [p1, p2], "cpu", tmp_path)
    assert len(trainer.round_losses) == TINY.max_epoch * TINY.train_steps
    assert trainer.graph_stats is None          # no graphs on the CPU


def test_device_lr_follows_the_schedule():
    """set_lr on a device-style Adam (a tensor learning rate, as the card's
    capturable Adam holds it) at every step count across two epoch
    boundaries: the tensor equals make_lr_schedule's rate rounded to f32,
    and JAX's schedule; apply_gradients reads it before the count
    advances."""
    from ssdr_al_tpu.config import ConfigS3DIS as JConfigS3DIS
    from ssdr_al_tpu.train import trainer as jt

    cfg = dataclasses.replace(TINY, lr_decay=0.5, learning_rate=3e-3)
    jsched = jt.make_lr_schedule(
        dataclasses.replace(JConfigS3DIS, lr_decay=0.5, learning_rate=3e-3),
        3)
    holder = torch.nn.Linear(2, 2)
    opt = torch.optim.Adam(holder.parameters(), lr=torch.tensor(0.0),
                           foreach=False)
    state = tt.TrainState(holder, opt, tt.make_lr_schedule(cfg, 3))
    seen = []
    opt.step = lambda: seen.append(opt.param_groups[0]["lr"].clone())
    for s in range(8):
        tt.apply_gradients(state)
        want = np.float32(state.schedule(s))
        assert seen[-1].dtype == torch.float32
        assert seen[-1].item() == want == np.float32(float(jsched(s))), s
    assert state.step == 8
    assert [t.item() for t in seen[2:5]] == [np.float32(3e-3), np.float32(
        1.5e-3), np.float32(1.5e-3)]


def test_pooled_extraction_at_the_static_window():
    """The captured step's extraction (pool.extract at pool.window rows)
    against the per-batch window (the batch's largest cloud) on the same
    generator state, and against JAX's extract_blocks at the same window,
    on quantization-exact clouds: every plane equal."""
    import jax
    import jax.numpy as jnp

    from ssdr_al_tpu.train import device_pool as jp
    from test_torch_device_pool import J_TINY, both, exact_clouds
    from test_torch_device_pool import TINY as P_TINY

    arrays, pseudo = exact_clouds(7, [900, 1300, 700])
    tc, jc = both(arrays)
    pool = DeviceTrainPool(tc, P_TINY, pseudo_gt=pseudo, seed=0,
                           device="cpu")
    jpool = jp.DeviceTrainPool(jc, J_TINY, pseudo_gt=pseudo, seed=0)
    assert pool.window == 1300
    ids = np.array([0, 2, 0, 2], np.int32)          # largest cloud: 900
    picks = np.stack([tc[int(i)].xyz[j] for i, j in zip(ids, (5, 40, 300,
                                                             611))])
    gen0 = pool.generator.get_state()
    static = pool.extract(torch.from_numpy(ids).long(),
                          torch.from_numpy(picks), None, pool.window)
    pool.generator.set_state(gen0)
    batch = pool.extract(ids, picks)
    want = jp.extract_blocks(*jpool.device_args(), jnp.asarray(ids),
                             jnp.asarray(picks), jax.random.PRNGKey(0),
                             J_TINY.num_points, pool.window)
    for name, a, b, w in zip(("xyz", "features", "labels", "activation",
                              "pseudo"), static, batch, want):
        assert torch.equal(a, b), name
        np.testing.assert_array_equal(a.numpy(), np.asarray(w),
                                      err_msg=name)


def test_possibility_field_is_a_static_buffer(tmp_path):
    """The pool's `field` keeps its storage through a reset and a step (a
    captured step writes it in place), and the step raises it."""
    clouds, _ = _clouds(5, [700, 900])
    pool = PossibilityDevicePool(clouds, TINY, seed=0, device="cpu")
    ptr = pool.field.data_ptr()
    assert pool.field.shape == pool.init_possibility.shape
    pool.reset_possibility(3)
    pool.field.copy_(pool.init_possibility)
    trainer = _trainer(TINY, tmp_path, "t", "cpu")
    _, step = tt.make_static_step(trainer.model, TINY, trainer.weights,
                                  "xla", "possibility", pool=pool,
                                  device="cpu")
    tt.set_lr(trainer.train_state)
    step(trainer.train_state, trainer.dropout_gen)
    assert pool.field.data_ptr() == ptr
    assert (pool.field >= pool.init_possibility).all()
    assert (pool.field > pool.init_possibility).any()


class _FakeGraph:
    """A stand-in for torch.cuda.CUDAGraph: replay() runs nothing."""

    def replay(self):
        pass


def test_replayed_graph_counts_its_capture_launches():
    """graphs.Graph's bookkeeping: the launches a capture counted are
    taken back (the capture ran nothing) and added at every replay, so the
    counts stay the kernels' real launches."""
    from ssdr_al_torch.ops import gather as ga
    from ssdr_al_torch.ops import knn as kn

    counts.reset()
    kn.window_topk.launches += 1              # an eager launch before
    before = counts.read()
    kn.window_topk.launches += 5              # what a capture counts
    ga.gather_window.launches += 11
    ga.scatter_window.launches += 11
    launched = counts.since(before)
    counts.add(launched, -1)
    assert counts.read() == before
    assert launched["window_topk"] == 5 and launched["chamfer_sums"] == 0
    g = graphs.Graph(_FakeGraph(), launched)
    for _ in range(3):
        g.replay()
    now = counts.read()
    assert g.replays == 3
    assert now["window_topk"] == 1 + 15
    assert now["gather_window"] == now["scatter_window"] == 33
    assert now["knn_tiled"] == 0
    counts.reset()


@pytest.mark.parametrize("probes", [0, 3])
def test_knn_window_other_probe_counts_run_two(probes):
    """probes other than 1 run the two-probe search, as JAX's
    `probes == 1` test does (ssdr_al_tpu/ops/knn.py:624): equal to
    probes=2, and to JAX's within its XLA form's ties."""
    from ssdr_al_torch.ops import knn as tk
    from test_torch_knn_window import XLA_TIE_REL, _jax_window
    from torch_parity import assert_near_ties

    rng = np.random.RandomState(21)
    sup = (rng.rand(1, 3000, 3) * 6).astype(np.float32)
    qry = (rng.rand(1, 600, 3) * 6).astype(np.float32)
    kw = dict(window=1024, impl="xla")
    got = tk.knn_window(torch.from_numpy(sup), torch.from_numpy(qry), 8,
                        probes=probes, **kw)
    two = tk.knn_window(torch.from_numpy(sup), torch.from_numpy(qry), 8,
                        probes=2, **kw)
    assert torch.equal(got, two)
    want = _jax_window(sup, qry, 8, probes=probes, **kw)
    assert_near_ties(qry[0], sup[0], got.numpy()[0], want[0],
                     rel=XLA_TIE_REL)


def test_synth_class_weights_match_jax():
    from ssdr_al_tpu.data import synthetic as js
    from ssdr_al_torch.data import synthetic as ts

    got, want = ts.synth_class_weights(), js.synth_class_weights()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------- card ---


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def rooms():
    from ssdr_al_torch.data.synthetic import make_dataset

    return make_dataset(num_train=2, num_val=0, num_points=30000, seed=0,
                        hard=True)[0]


def _card_cfg(path, dtype, **over):
    """16384 points a block, 2 blocks a step, 2 epochs of 12 steps: every
    layer of the window pyramid that runs K1, K2 and K4 at full width runs
    here, and a round is 3 eager steps and 21 replays."""
    base = ConfigSemantic3D if path == "possibility" else ConfigS3DIS
    return dataclasses.replace(base, num_points=16384, batch_size=2,
                               train_steps=12, max_epoch=2,
                               compute_dtype=dtype, **over)


def _card_pseudo(rooms, seed, num_classes):
    rng = np.random.RandomState(seed)
    return {c.name: np.stack([(rng.rand(c.num_points) < 0.5).astype(
        np.float32), rng.randint(0, num_classes, c.num_points).astype(
            np.float32)]) for c in rooms}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", PATHS)
def test_graph_replays_equal_eager_steps(dev, rooms, path, dtype, tmp_path):
    """Two rounds through Trainer.train_round on the card (each 3 eager
    steps and 21 replays of one capture, across an epoch boundary) against
    the same rounds as eager steps from the same state, with a reseed,
    new planes and a fresh Adam between them: every step's loss, the
    parameters, BatchNorm statistics and Adam moments bitwise equal."""
    cfg = _card_cfg(path, dtype)
    pseudos = [_card_pseudo(rooms, s, cfg.num_classes) for s in (1, 2)]

    def check(graph, eager, losses):
        st = graph.graph_stats
        assert st["eager_steps"] == graphs.GRAPH_WARMUP
        assert st["replays"] == cfg.max_epoch * cfg.train_steps \
            - graphs.GRAPH_WARMUP
        assert torch.isfinite(losses).all()

    _rounds(path, cfg, rooms, pseudos, dev, tmp_path, engine="window",
            check=check)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", tt.KNN_ENGINES)
def test_graph_replays_equal_eager_steps_on_every_engine(dev, rooms, engine,
                                                         tmp_path):
    """The host path on each KNN engine: a round of 2 epochs × 4 steps (3
    eager, 5 replays) bitwise equal to the eager steps."""
    cfg = dataclasses.replace(_card_cfg("host", "float32"), train_steps=4)

    def check(graph, eager, losses):
        assert graph.graph_stats["replays"] == 8 - graphs.GRAPH_WARMUP

    _rounds("host", cfg, rooms, [_card_pseudo(rooms, 1, cfg.num_classes)],
            dev, tmp_path, engine=engine, check=check)


@pytest.mark.cuda
def test_replays_count_their_kernels(dev, rooms, tmp_path):
    """K1, K2 and K4 counted once per replay: a round of S steps through
    the graph counts S times one eager step's launches of each."""
    cfg = dataclasses.replace(_card_cfg("pool", "float32"), train_steps=5)
    trainer = _trainer(cfg, tmp_path, "t", dev, "window")
    pool = DeviceTrainPool(rooms, cfg, seed=1, device=dev)
    counts.reset()
    trainer.pooled_step(trainer.train_state, pool,
                        *pool.sample_indices(cfg.batch_size),
                        trainer.dropout_gen)
    one = counts.read()
    assert all(one[k] > 0 for k in ("window_topk", "gather_window",
                                    "scatter_window")), one
    counts.reset()
    trainer.train_round(1, None, device_pool=pool)
    torch.cuda.synchronize()
    got = counts.read()
    steps = cfg.max_epoch * cfg.train_steps
    assert trainer.graph_stats["replays"] == steps - graphs.GRAPH_WARMUP
    assert trainer.graph_stats["launches"] == {k: v for k, v in one.items()
                                               if v}
    assert got == {k: steps * v for k, v in one.items()}, (got, one)


@pytest.mark.cuda
def test_replay_trace_holds_the_counted_kernels(dev, rooms, tmp_path):
    """repeat_check.replay_check on the pool path: GRAPH_WARMUP eager
    steps and 4 replays bitwise equal to 7 eager steps, and a
    torch.profiler trace of the last replay holds K1's, K2's and K4's
    device kernels as often as the launch counts each replay adds
    (Graph.launches), each at least once."""
    from ssdr_al_torch.train import repeat_check as rc

    cfg = _card_cfg("pool", "float32")
    trainer = _trainer(cfg, tmp_path, "t", dev, "window")
    pool = DeviceTrainPool(rooms, cfg, seed=1, device=dev)
    draws = rc._draws("pool", trainer, pool, rooms, graphs.GRAPH_WARMUP + 4)
    res = rc.replay_check(trainer, "pool", pool, draws)
    assert res["equal"], res["differing"]
    assert res["replays"] == 4
    assert res["traced_ok"], (res["traced"], res["counted"])
    assert res["traced"]["scatter_window"] == \
        res["launches"]["scatter_window"]
    assert res["traced"]["scatter_window_transpose"] == \
        res["launches"]["scatter_window_transpose"]


@pytest.mark.cuda
def test_card_adam_matches_cpu_adam(dev, tmp_path):
    """The card's Adam (the Trainer's capturable form, its rate a device
    tensor that set_lr fills, as every single-device step on the card
    takes it) against the CPU's (a float rate, the form the JAX-parity
    tests hold to optax), with the update separated from the gradient:
    the same random gradients handed to both, 5 updates across two
    lr-decay boundaries (2 steps an epoch, decay 0.5). Parameters and both
    moments agree within rtol 1e-5, atol 1e-6: the f32 rounding of the
    two forms' arithmetic, where a wrong rate would move a parameter by
    about 5e-3."""
    cfg = dataclasses.replace(TINY, lr_decay=0.5)
    card, cpu = _trainer(cfg, tmp_path, "card", dev), \
        _trainer(cfg, tmp_path, "cpu", "cpu")
    assert card.train_state.optimizer.defaults["capturable"]
    assert not cpu.train_state.optimizer.defaults["capturable"]
    rng = np.random.RandomState(0)
    for _ in range(5):
        for pc, ph in zip(card.model.parameters(), cpu.model.parameters()):
            g = torch.from_numpy(np.asarray(rng.randn(*ph.shape),
                                            np.float32))
            ph.grad, pc.grad = g, g.to(dev)
        tt.apply_gradients(card.train_state)
        tt.apply_gradients(cpu.train_state)
    assert card.train_state.step == cpu.train_state.step == 5
    assert float(card.train_state.optimizer.param_groups[0]["lr"]) == \
        np.float32(cpu.train_state.optimizer.param_groups[0]["lr"])
    for (k, x), y in zip(card.model.named_parameters(),
                         cpu.model.parameters()):
        torch.testing.assert_close(x.detach().cpu(), y.detach(), rtol=1e-5,
                                   atol=1e-6, msg=k)
    for x, y in zip(_adam_state(card.train_state),
                    _adam_state(cpu.train_state)):
        torch.testing.assert_close(x.detach().cpu().float(), torch.as_tensor(
            y).float(), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_window_guard_keeps_the_steps_eager(dev, rooms, tmp_path,
                                            monkeypatch):
    """SSDR_DEBUG_WINDOW_GUARD reads its clamp count back at every gather,
    which a capture refuses: with it on, Trainer.train_round takes eager
    steps on the card, by the rule at its call, and trains."""
    from ssdr_al_torch.ops import gather as ga

    monkeypatch.setattr(ga, "DEBUG_WINDOW_GUARD", True)
    cfg = dataclasses.replace(_card_cfg("pool", "float32"), train_steps=5,
                              max_epoch=1)
    trainer = _trainer(cfg, tmp_path, "t", dev, "window")
    pool = DeviceTrainPool(rooms, cfg, seed=1, device=dev)
    trainer.train_round(1, None, device_pool=pool)
    assert trainer.graph_stats is None
    assert torch.isfinite(torch.stack(trainer.round_losses)).all()
    assert len(trainer.round_losses) == 5


_CAPTURE_FAILS = """
import dataclasses, pathlib, sys
import torch
from ssdr_al_torch.data.synthetic import make_dataset
from ssdr_al_torch.models import randlanet
from ssdr_al_torch.train import trainer as tt
from ssdr_al_torch.train.device_pool import DeviceTrainPool
sys.path.insert(0, "tests")
import test_torch_train_graph as tg

ce = randlanet.masked_weighted_ce

def syncing_ce(*args, **kw):
    loss, acc = ce(*args, **kw)
    loss.item()     # a host sync, which a stream capture refuses
    return loss, acc

tt.masked_weighted_ce = syncing_ce
dev = torch.device("cuda", 0)
rooms = make_dataset(num_train=2, num_val=0, num_points=30000, seed=0,
                     hard=True)[0]
cfg = dataclasses.replace(tg._card_cfg("pool", "float32"), train_steps=3)
trainer = tg._trainer(cfg, pathlib.Path(sys.argv[1]), "t", dev, "window")
pool = DeviceTrainPool(rooms, cfg, seed=1, device=dev)
trainer.train_round(1, None, device_pool=pool)
print("RAN")
"""


@pytest.mark.cuda
def test_failed_capture_raises(dev, tmp_path):
    """A step that a capture cannot record (a host sync) makes the round
    raise; nothing runs its steps eagerly instead. In a child process: a
    failed capture may leave the process's CUDA context unusable."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _CAPTURE_FAILS,
                        str(tmp_path)], cwd=root, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode != 0 and "RAN" not in r.stdout, r.stdout
    assert "capture" in r.stderr.lower(), r.stderr[-2000:]
