"""The gradient check's pinned mode (train/grad_check.py) on the CPU: the
float64 run's leaky-ReLU slopes and max-pool picks are recorded and
replayed in the float32 runs, so an input that f32 rounding puts on the
other side of a kink still takes the f64 side."""

import numpy as np
import pytest
import torch

from ssdr_al_torch.train import grad_check as gc
from torch_parity import small_cfg

torch.set_num_threads(1)


def test_slope_pins_replay_the_recorded_slopes():
    """Recording returns F.leaky_relu and keeps each call's mask; replaying
    on an input whose signs differ takes the recorded slope in the forward
    value and the gradient, call by call."""
    rng = np.random.RandomState(0)
    x64 = torch.from_numpy(rng.randn(50, 7))
    rec = gc.slope_pins()
    y64 = [rec(x64), rec(-x64)]
    assert torch.equal(y64[0], torch.nn.functional.leaky_relu(x64, 0.2))
    assert len(rec.masks) == 2
    x32 = (-x64).float().requires_grad_(True)    # every sign flipped
    play = gc.slope_pins(rec.masks)
    y = play(x32)
    y.backward(torch.ones_like(y))
    want = torch.where(rec.masks[0], torch.ones_like(x32),
                       torch.full_like(x32, 0.2))
    assert torch.equal(x32.grad, want)
    assert torch.equal(y.detach(), torch.where(rec.masks[0], x32, x32 * 0.2)
                       .detach())
    assert play.calls[0] == 1


def test_gradient_errors_pinned_on_the_cpu():
    """With the CPU in the card's place both f32 gradients are the same
    run, at the f64 run's slopes and picks: equal to each other, as close
    to f64 as the unpinned ones, and every pinned call of the forward
    replayed."""
    cfg = small_cfg(num_points=4096)
    free = gc.gradient_errors(cfg, torch.device("cpu"), 4)
    pinned = gc.gradient_errors(cfg, torch.device("cpu"), 4, pinned=True)
    assert pinned["pinned"] and not free["pinned"]
    assert pinned["card_vs_cpu"] == 0.0 and pinned["passed"]
    assert pinned["cpu_f32"] <= free["cpu_f32"] * 1.01


def test_pool_pins_route_the_gradient_to_the_recorded_pick():
    """The max-pool stand-in records each call's argmax over the neighbour
    axis; replayed on values whose largest neighbour differs, it returns
    the recorded neighbour's value and sends the gradient there."""
    rng = np.random.RandomState(1)
    p64 = torch.from_numpy(rng.randn(2, 30, 16, 5))
    rec = gc.pool_pins()
    assert torch.equal(rec(p64), p64.amax(2))
    p32 = (-p64).float().requires_grad_(True)
    play = gc.pool_pins(rec.masks)
    y = play(p32)
    y.sum().backward()
    pick = p64.argmax(2, keepdim=True)
    assert torch.equal(y.detach(), torch.gather(p32, 2, pick)[:, :, 0]
                       .detach())
    want = torch.zeros_like(p32).scatter_(2, pick, 1.0)
    assert torch.equal(p32.grad, want)


def test_gradient_errors_pins_pools_on_the_cpu():
    """The pinned run stands its recorders and replays in for the model's
    leaky_relu and max_pool, every call of both replayed (the check raises
    otherwise), and puts the model's own functions back after it."""
    from ssdr_al_torch.models import randlanet as rl

    own = (rl.leaky_relu, rl.max_pool)
    cfg = small_cfg(num_points=4096)
    r = gc.gradient_errors(cfg, torch.device("cpu"), 5, pinned=True)
    assert r["pinned"] and r["card_vs_cpu"] == 0.0 and r["passed"]
    assert (rl.leaky_relu, rl.max_pool) == own


def test_kink_pins_replay_a_rank_share_of_the_rows():
    """kink_pins records every leaky-ReLU and max-pool call of a block;
    replayed with `rows`, each call takes those rows of the recorded masks
    (a data-parallel rank's share): the second row alone, sign-flipped,
    takes the recorded slopes and picks, so the block gives the negated
    recorded row; a block
    with a call fewer raises; the model's functions come back."""
    from ssdr_al_torch.models import randlanet as rl

    own = (rl.leaky_relu, rl.max_pool)
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, 40, 16, 5))

    def block(v):
        return rl.max_pool(rl.leaky_relu(v))

    with gc.kink_pins() as rec:
        want = block(x)
    assert len(rec["slopes"]) == len(rec["pools"]) == 1
    with gc.kink_pins(rec, slice(1, 2)):
        got = block(-x[1:])
    assert torch.equal(got, -want[1:])
    with pytest.raises(AssertionError, match="0 leaky_relu calls"):
        with gc.kink_pins(rec):
            pass
    assert (rl.leaky_relu, rl.max_pool) == own


def test_reference_step_holds_a_pinned_cpu_step():
    """reference_step's f64 gradient of the trainer's loss, and the CPU
    f32 step with its pins replayed: the port's train step on the CPU,
    given the same pins, is that f32 run (the same error to f64, bit for
    bit) and within the limit; every layer's pins were recorded."""
    from ssdr_al_torch.config import class_weights
    from ssdr_al_torch.models.randlanet import init_params
    from ssdr_al_torch.parallel import dryrun

    cfg = small_cfg(num_points=2048, batch_size=2)
    rng = np.random.RandomState(3)
    xyz = (rng.rand(2, 2048, 3) * 6).astype(np.float32)
    batch = {"xyz": xyz,
             "features": np.concatenate(
                 [xyz, rng.rand(2, 2048, 3).astype(np.float32)], -1),
             "labels": rng.randint(0, 13, (2, 2048)).astype(np.int32),
             "pseudo": rng.randint(0, 13, (2, 2048)).astype(np.int32),
             "activation": (rng.rand(2, 2048) < 0.6).astype(np.float32)}
    state = gc.spread_weights(init_params(
        cfg, torch.Generator().manual_seed(0)), 5)
    case = dict(cfg=cfg, state=state, batch=batch,
                weights=class_weights("S3DIS"))
    cpu = torch.device("cpu")
    ref = gc.reference_step(cfg, state, batch, case["weights"], cpu)
    one = dryrun.train_step_result(None, device=cpu, pins=ref, **case)
    err = gc.gradient_rel(one["grad"], ref["grad"])
    assert err == ref["cpu_f32"] and 0 < err <= ref["limit"]
    assert len(ref["slopes"]) > 10 and len(ref["pools"]) == cfg.num_layers
