"""The train-mode gradient on the card against float32 and float64 CPU
gradients, at seeded states, with the diagnostics that locate the card's
error.

    python3 ssdr_al_torch/train/grad_check.py [--seeds 0,1,...] [--out PATH]
        [--no-trace]

At each seeded state (`spread_weights` of the flax initialisers' weights)
one 40960-point block at ConfigS3DIS width runs in train mode, dropout
off, on the card (K1, K2, K4) and on the CPU in float32 and float64
(`gradient_errors`): it prints each card/CPU error ratio with the layers
that hold the card's error and, per BatchNorm, where the error grows and
which outputs lie on the other side of 0 from f64's (`bn_trace`); then
the same with every leaky ReLU's slope and every max-pool's pick taken
from the f64 run (`pinned`: `kink_pins`); then the f32 error of three
backward ops over a layer's edge rows and of the backward matmuls
(`backward_op_probe`), on the card and on the CPU. `--no-trace` skips the traces and the probes.
Prints the card's name and power limit and, as its last line, the results
as JSON (also written to PATH). chip_smoke.py runs `gradient_errors` at
one seed, and pinned at eight.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

# the check's limit: the card's f32 error to the f64 gradient within this
# multiple of the CPU f32 error, plus a floor
GRAD_ERR_MULTIPLE, GRAD_ERR_FLOOR = 4.0, 1e-6


def spread_weights(state, seed):
    """state with every float tensor redrawn at O(1) scale: matrices
    N(0, 2/fan_in), BatchNorm scales and variances U(0.5, 1.5), biases and
    means N(0, 0.1²)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, v in state.items():
        if not v.is_floating_point():
            out[name] = v
        elif v.dim() == 2:
            out[name] = torch.randn(v.shape, generator=gen) * (
                2.0 / v.shape[1]) ** 0.5
        elif name.endswith("running_var") or (
                name.endswith("weight") and v.dim() == 1):
            out[name] = torch.rand(v.shape, generator=gen) + 0.5
        else:
            out[name] = torch.randn(v.shape, generator=gen) * 0.1
    return {k: v.to(state[k].device) for k, v in out.items()}


def slope_pins(masks=None):
    """A stand-in for models.randlanet.leaky_relu. With masks=None it
    records each call's slope mask (input > 0, where F.leaky_relu takes
    slope 1) in call order; given a list of such masks it applies the
    leaky ReLU with the i-th call's slopes taken from masks[i], so a
    float32 run takes the float64 run's slopes where its own rounding
    puts an input on the other side of 0."""
    def record(x):
        return (x > 0), torch.nn.functional.leaky_relu(x, 0.2)

    def replay(x, m):
        return torch.where(m, x, x * 0.2)

    return _pins(masks, record, replay)


def pool_pins(masks=None):
    """A stand-in for models.randlanet.max_pool: records each call's
    argmax over the neighbour axis, or takes the recorded neighbour of
    each (point, channel), so a float32 run routes the max-pool's
    gradient where the float64 run does when two neighbours' values lie
    within f32 rounding of each other."""
    def record(p):
        v, i = p.max(2, keepdim=True)
        return i, v[:, :, 0]

    def replay(p, i):
        return torch.gather(p, 2, i)[:, :, 0]

    return _pins(masks, record, replay)


def _pins(masks, record, replay):
    rec = [] if masks is None else None
    calls = [0]

    def fn(x):
        if rec is not None:
            m, y = record(x)
            rec.append(m.cpu())
            return y
        m = masks[calls[0]].to(x.device)
        calls[0] += 1
        return replay(x, m)

    fn.masks = rec if masks is None else masks
    fn.calls = calls
    return fn


def pyramid_on(pyr, device):
    """A pyramid with every tensor moved to `device`."""
    moved = {}
    for f in dataclasses.fields(pyr):
        v = getattr(pyr, f.name)
        if isinstance(v, list):
            moved[f.name] = [None if t is None else t.to(device) for t in v]
        elif torch.is_tensor(v):
            moved[f.name] = v.to(device)
    return dataclasses.replace(pyr, **moved)


@contextlib.contextmanager
def kink_pins(recorded=None, rows=None):
    """Run the block with models.randlanet's leaky_relu and max_pool
    pinned. recorded=None: record each call's slopes and max-pool picks
    (slope_pins, pool_pins) into the yielded {"slopes", "pools"}. Given
    such a record (of a float64 run): replay it, `rows` (a slice) taking
    those rows of every recorded [B, ...] mask, a data-parallel rank's
    share, and raise if the block made another number of calls than were
    recorded."""
    from ssdr_al_torch.models import randlanet as rl

    if recorded is None:
        fns = {"leaky_relu": slope_pins(), "max_pool": pool_pins()}
    else:
        sl, po = recorded["slopes"], recorded["pools"]
        if rows is not None:
            sl, po = [m[rows] for m in sl], [m[rows] for m in po]
        fns = {"leaky_relu": slope_pins(sl), "max_pool": pool_pins(po)}
    saved = {name: getattr(rl, name) for name in fns}
    for name, fn in fns.items():
        setattr(rl, name, fn)
    try:
        yield {"slopes": fns["leaky_relu"].masks,
               "pools": fns["max_pool"].masks}
    finally:
        for name, fn in saved.items():
            setattr(rl, name, fn)
    for name, fn in fns.items():
        if recorded is not None and fn.calls[0] != len(fn.masks):
            raise AssertionError(f"{fn.calls[0]} {name} calls against "
                                 f"{len(fn.masks)} recorded")


def reference_step(cfg, state, batch, weights, dev) -> dict:
    """The float64 reference of one `window` train step (the trainer's
    loss: the batch in sorted order, class weights, the label reduce
    table; dropout off) on the CPU, from `state` on a global `batch`
    (numpy, as make_train_step takes it), on the pyramid that `dev` builds
    for the batch. The f64 run records its leaky-ReLU slopes and max-pool
    picks; the CPU f32 run replays them, and its relative L2 error to the
    f64 gradient sets the limit of the f32 runs on the card:
    GRAD_ERR_MULTIPLE times it plus GRAD_ERR_FLOOR, as gradient_errors
    derives it. Returns {"grad": {parameter: f64 array}, "slopes",
    "pools" (the pins, on the CPU), "cpu_f32", "limit"}."""
    from ssdr_al_torch.models.randlanet import (
        RandLANet,
        build_pyramid,
        label_reduce_table,
        masked_weighted_ce,
    )

    cpu = torch.device("cpu")
    xyz = torch.as_tensor(np.asarray(batch["xyz"]), dtype=torch.float32)
    with torch.no_grad():
        pyr = build_pyramid(xyz.to(dev), cfg)
    pyr = pyramid_on(pyr, cpu)
    order = pyr.order.long()

    def rows(key, dtype):
        x = torch.as_tensor(np.asarray(batch[key]), dtype=dtype)
        return torch.gather(x, 1, order) if x.dim() == 2 else x

    table = (label_reduce_table(cfg.num_classes, cfg.ignored_label_inds)
             if cfg.ignored_label_inds else None)

    def grad(dt):
        model = RandLANet(cfg).to(cpu, dt)
        model.load_state_dict({k: v.to(cpu) for k, v in state.items()})
        model.train()
        model.dp1.rate = 0.0
        p = dataclasses.replace(pyr, xyz=[t.to(dt) for t in pyr.xyz])
        logits, _ = model(rows("features", dt), p, unsort=False)
        loss, _ = masked_weighted_ce(
            logits, rows("pseudo", torch.int64),
            rows("activation", torch.float32),
            rows("labels", torch.int64), np.asarray(weights),
            cfg.ignored_label_inds, table)
        loss.backward()
        return {k: q.grad.double() for k, q in model.named_parameters()}

    with kink_pins() as pins:
        g64 = grad(torch.float64)
    with kink_pins(pins):
        g32 = grad(torch.float32)
    host = gradient_rel(g32, g64)
    return {"grad": {k: v.numpy() for k, v in g64.items()}, **pins,
            "cpu_f32": host,
            "limit": GRAD_ERR_MULTIPLE * host + GRAD_ERR_FLOOR}


def gradient_rel(got: dict, want: dict) -> float:
    """Relative L2 distance of two gradients {parameter: tensor or array},
    in float64 over the parameters of `want`."""
    a, b = (torch.cat([torch.as_tensor(np.asarray(g[k]), dtype=torch.float64)
                       .reshape(-1) for k in want]) for g in (got, want))
    return float((a - b).norm() / b.norm())


def gradient_errors(cfg, dev, seed, trace=False, pinned=False):
    """One 40960-point block in train mode, dropout off, at a state drawn
    from a seed (the flax initialisers' weights, spread at O(1) scale):
    the loss and the gradient of every parameter on the card (K1, K2, K4)
    and on the CPU in float32 (plain versions), each against the CPU in
    float64, all on one sorted pyramid. The card's loss within 1e-4
    relative of the CPU's; its gradient's relative L2 error to the f64
    gradient at most GRAD_ERR_MULTIPLE times the CPU f32 gradient's plus
    GRAD_ERR_FLOOR, so the limit follows the f32 conditioning of the
    state. Prints the three errors, the layers holding most of the card's
    error with the CPU's there, and the shapes of the step's K4 calls;
    returns them with `passed`. `trace` also compares every train-mode
    BatchNorm's output and gradients with the f64 run's (bn_trace).
    `pinned` runs the f64 forward first and gives both f32 runs its
    leaky-ReLU slopes (slope_pins) and max-pool picks (pool_pins), so
    that the check measures the arithmetic and not which side of a kink
    an input within f32 rounding of it lands on."""
    from ssdr_al_torch.models.randlanet import (
        RandLANet,
        SortedPyramid,
        build_pyramid,
        init_params,
        masked_weighted_ce,
    )
    from ssdr_al_torch.ops import gather as ga

    state = spread_weights(init_params(cfg, torch.Generator().manual_seed(0)),
                           seed)
    rng = np.random.RandomState(3)
    n = cfg.num_points
    xyz = torch.from_numpy((rng.rand(1, n, 3) * 6).astype(np.float32))
    feats = torch.cat([xyz, torch.from_numpy(rng.rand(1, n, 3).astype(
        np.float32))], -1)
    labels = torch.from_numpy(rng.randint(0, cfg.num_classes, (1, n)))
    act = torch.from_numpy((rng.rand(1, n) < 0.5).astype(np.float32))
    weights = torch.from_numpy(rng.rand(cfg.num_classes).astype(np.float32)
                               + 0.5)
    with torch.no_grad():
        pyr = build_pyramid(xyz.to(dev), cfg)
    if not isinstance(pyr, SortedPyramid):
        raise AssertionError("the full-width block did not take the sorted "
                             "path")
    cpu_pyr = pyramid_on(pyr, torch.device("cpu"))
    f64_pyr = dataclasses.replace(cpu_pyr, xyz=[t.double()
                                                for t in cpu_pyr.xyz])
    grads, losses, k4_shapes = [], [], []
    kernel = ga.scatter_window

    def recording(g, idx, starts, n, window, tq):
        k4_shapes.append((tuple(g.shape), n, window, tq))
        return kernel(g, idx, starts, n, window, tq)

    # the wrapper counts its launches on the module's name for it, which
    # is `recording` while it stands in
    recording.launches = recording.launches_bf16 = 0

    cpu = torch.device("cpu")
    runs = [(dev, pyr, torch.float32), (cpu, cpu_pyr, torch.float32),
            (cpu, f64_pyr, torch.float64)]
    if pinned:
        runs = runs[2:] + runs[:2]
    bn_out, bn_grad, pins = [], [], None
    for d, p, dt in runs:
        model = RandLANet(cfg).to(d, dt)
        model.load_state_dict({k: v.to(d) for k, v in state.items()})
        model.train()
        model.dp1.eval()
        bn_out.append({})
        bn_grad.append({})
        if trace:
            for name, m in model.named_modules():
                if type(m).__name__ == "BatchNorm":
                    m.register_forward_hook(
                        lambda m, inp, out, name=name, rec=bn_out[-1]:
                        rec.__setitem__(name, (inp[0].detach().cpu()
                                               .double(), out.detach().cpu()
                                               .double())))
                    m.register_full_backward_hook(
                        lambda m, gin, gout, name=name, rec=bn_grad[-1]:
                        rec.__setitem__(name, (gout[0].detach().cpu()
                                               .double(), gin[0].detach()
                                               .cpu().double())))
        order = p.order.long()
        ga.scatter_window = recording if d == dev else kernel
        try:
            with (kink_pins(None if dt == torch.float64 else pins)
                  if pinned else contextlib.nullcontext()) as rec:
                logits, _ = model(feats.to(d, dt), p, unsort=False)
                loss, _ = masked_weighted_ce(
                    logits, torch.gather(labels.to(d), 1, order),
                    torch.gather(act.to(d), 1, order),
                    torch.gather(labels.to(d), 1, order), weights.to(d, dt))
                loss.backward()
        finally:
            ga.scatter_window = kernel
        if pinned and dt == torch.float64:
            pins = rec
        losses.append(loss.item())
        grads.append({k: q.grad.cpu().double()
                      for k, q in model.named_parameters()})
    if pinned:
        # back to the order (card, CPU f32, CPU f64)
        losses = losses[1:] + losses[:1]
        grads = grads[1:] + grads[:1]
        bn_out = bn_out[1:] + bn_out[:1]
        bn_grad = bn_grad[1:] + bn_grad[:1]
    print("K4 calls of one train step, (g shape, n, window, tq): "
          + json.dumps(k4_shapes))
    lrel = abs(losses[0] - losses[1]) / abs(losses[1])
    flat = [torch.cat([g[k].reshape(-1) for k in grads[2]]) for g in grads]
    ref = flat[2].norm()
    card, host = [float((g - flat[2]).norm() / ref) for g in flat[:2]]
    between = float((flat[0] - flat[1]).norm() / flat[1].norm())
    limit = GRAD_ERR_MULTIPLE * host + GRAD_ERR_FLOOR
    pins_txt = ", f64 slopes and pool picks pinned" if pinned else ""
    print(f"train-mode gradient [1x{n}] at seeded state {seed}{pins_txt}: "
          f"loss card "
          f"{losses[0]:.6f}, CPU f32 {losses[1]:.6f} (rel {lrel:.2e}), CPU "
          f"f64 {losses[2]:.6f}; gradient rel L2 to f64: card {card:.3e}, "
          f"CPU f32 {host:.3e} (limit {limit:.3e}); card vs CPU f32 "
          f"{between:.3e}")
    # layer by layer: each module's share of the squared error to f64, and
    # its parameters' own relative error, card and CPU f32
    layers = {}
    for k, g64 in grads[2].items():
        e = layers.setdefault(k.rsplit(".", 1)[0], [0.0, 0.0, 0.0])
        e[0] += float((grads[0][k] - g64).square().sum())
        e[1] += float((grads[1][k] - g64).square().sum())
        e[2] += float(g64.square().sum())
    worst = sorted(layers.items(), key=lambda kv: -kv[1][0])[:6]
    tot = [max(sum(e[i] for e in layers.values()), 1e-300) for i in (0, 1)]
    by_layer = {name: dict(card_share=e[0] / tot[0], cpu_share=e[1] / tot[1],
                           card_rel=(e[0] / max(e[2], 1e-300)) ** 0.5,
                           cpu_rel=(e[1] / max(e[2], 1e-300)) ** 0.5)
                for name, e in worst}
    print("  layers with the most card error (share of the squared error; "
          "own rel err): " + "; ".join(
              f"{k} card {v['card_share']:.2f} ({v['card_rel']:.1e}) CPU "
              f"{v['cpu_share']:.2f} ({v['cpu_rel']:.1e})"
              for k, v in by_layer.items()))
    ok = bool(np.isfinite(losses[0]) and lrel <= 1e-4 and card <= limit)
    out = dict(card=card, cpu_f32=host, card_vs_cpu=between, limit=limit,
               passed=ok, by_layer=by_layer, pinned=pinned)
    if trace:
        out["bn_trace"] = bn_trace(bn_out, bn_grad)
    return out


def bn_trace(runs, grad_runs):
    """Per train-mode BatchNorm, in forward order: the relative L2 error
    to the f64 run, on the card and on the CPU in f32, of its input and
    output (forward) and of the gradient reaching its output and the one
    it passes to its input (backward), with its batch statistics'
    cancellation E[x²]/var (the flax variance E[x²] − E[x]² loses that
    factor of f32 precision), largest over channels, and the count of
    outputs on the other side of 0 from f64's. Prints the BatchNorms
    whose backward grows the card's gradient error most."""
    rows = []

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp(min=1e-300))

    for name, (x64, y64) in runs[2].items():
        dims = tuple(range(x64.dim() - 1))
        var = x64.var(dims, unbiased=False)
        row = dict(bn=name, cancel=float(((x64 * x64).mean(dims)
                                         / var.clamp(min=1e-300)).max()))
        for side, i in (("card", 0), ("cpu", 1)):
            row[f"{side}_in"] = rel(runs[i][name][0], x64)
            row[f"{side}_out"] = rel(runs[i][name][1], y64)
            # outputs on the other side of 0 from f64's: where a leaky
            # ReLU follows, each takes the other slope (1 or 0.2)
            row[f"{side}_flips"] = int(((runs[i][name][1] > 0)
                                        != (y64 > 0)).sum())
            row[f"{side}_gout"] = rel(grad_runs[i][name][0],
                                      grad_runs[2][name][0])
            row[f"{side}_gin"] = rel(grad_runs[i][name][1],
                                     grad_runs[2][name][1])
        rows.append(row)
    worst = sorted(rows, key=lambda r: -(r["card_gin"]
                                         / max(r["card_gout"], 1e-12)))[:6]
    print("  BatchNorms whose backward grows the card's gradient error most "
          "(grad at output -> at input; forward output): " + "; ".join(
              f"{r['bn']} card {r['card_gout']:.1e} -> {r['card_gin']:.1e}"
              f", CPU {r['cpu_gout']:.1e} -> {r['cpu_gin']:.1e}; out card "
              f"{r['card_out']:.1e} CPU {r['cpu_out']:.1e}; E[x^2]/var "
              f"{r['cancel']:.1e}" for r in worst))
    print("  BatchNorm outputs on the other side of 0 from f64's (card, "
          "CPU): " + json.dumps({r["bn"]: [r["card_flips"], r["cpu_flips"]]
                                 for r in rows
                                 if r["card_flips"] or r["cpu_flips"]}))
    # in backward order, the first BatchNorm whose input gradient on the
    # card is 10x further from f64 than the CPU's
    first = next((r for r in reversed(rows)
                  if r["card_gin"] > 10 * r["cpu_gin"]), None)
    print("  first BatchNorm, in backward order, with the card's input "
          "gradient 10x the CPU's error: " + (json.dumps(first)
                                              if first else "none"))
    return rows


def backward_op_probe(dev, rows=(163840, 655360), seed=0):
    """Three backward ops of a train step over `rows` edge rows (B·N·k at
    L1 and L0 of a [1 x 40960] block), 16 channels, on the card and on the
    CPU in f32, each as its relative L2 error to the same op in f64: the
    weight-gradient product Xᵀ·dY (X ≥ 0 as after a leaky ReLU), the
    column sum of dY (the bias gradient, and the reductions of a
    BatchNorm's backward), and the input gradient of a train-mode
    BatchNorm (models.randlanet.BatchNorm, inputs of mean 1 and spread
    0.5 as after a dense layer)."""
    from ssdr_al_torch.models.randlanet import BatchNorm

    rng = np.random.RandomState(seed)
    out = {}

    def bn_grad(x, g, d, dt):
        bn = BatchNorm(16).to(d, dt).train()
        xi = x.to(d, dt).clone().requires_grad_(True)
        (bn(xi) * g.to(d, dt)).sum().backward()
        return xi.grad.cpu().double()

    for k in rows:
        x = torch.from_numpy(np.abs(rng.randn(k, 16)).astype(np.float32))
        dy = torch.from_numpy(rng.randn(k, 16).astype(np.float32))
        xb = torch.from_numpy((1 + 0.5 * rng.randn(1, k, 16)).astype(
            np.float32))
        ops = {"x^T dy": lambda d, dt: (x.to(d, dt).T @ dy.to(d, dt)).cpu()
               .double(),
               "sum(dy)": lambda d, dt: dy.to(d, dt).sum(0).cpu().double(),
               "batchnorm backward": lambda d, dt: bn_grad(xb, dy[None], d,
                                                          dt)}
        out[k] = {}
        for name, op in ops.items():
            ref = op(torch.device("cpu"), torch.float64)
            out[k][name] = {
                side: float((op(d, torch.float32) - ref).norm() / ref.norm())
                for side, d in (("card", dev), ("cpu_f32",
                                                torch.device("cpu")))}
    print("backward ops over [rows x 16], rel L2 err to f64: "
          + json.dumps(out))
    out["matmul_precision"] = matmul_precision_probe(dev)
    return out


def matmul_precision_probe(dev, seed=0):
    """Whether the card's matmuls in the backward pass (run on autograd's
    device thread) keep float32: y = x·w on [65536 x 64]·[64 x 64], then
    y.backward(g), with x.grad and w.grad against f64, under the port's
    settings and with TF32 switched on; and the matmul precision settings
    as the autograd thread reads them."""
    import threading

    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(65536, 64).astype(np.float32))
    w = torch.from_numpy(rng.randn(64, 64).astype(np.float32) / 8)
    g = torch.from_numpy(rng.randn(65536, 64).astype(np.float32))
    seen = {}

    def flags(_):
        seen.update(
            thread=threading.current_thread().name,
            allow_tf32=torch.backends.cuda.matmul.allow_tf32,
            precision=torch.get_float32_matmul_precision(),
            fp32_precision=str(getattr(torch.backends.cuda.matmul,
                                       "fp32_precision", None)))

    def grads(d, dt, hook=False):
        xi = x.to(d, dt).clone().requires_grad_(True)
        wi = w.to(d, dt).clone().requires_grad_(True)
        y = xi @ wi
        if hook:
            y.register_hook(flags)
        y.backward(g.to(d, dt))
        return y.detach().cpu().double(), xi.grad.cpu().double(), \
            wi.grad.cpu().double()

    ref = grads(torch.device("cpu"), torch.float64)

    def errs(got):
        return {k: float((a - b).norm() / b.norm())
                for k, a, b in zip(("y", "x.grad", "w.grad"), got, ref)}

    out = {"main thread": dict(
        allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        precision=torch.get_float32_matmul_precision(),
        fp32_precision=str(getattr(torch.backends.cuda.matmul,
                                   "fp32_precision", None)))}
    out["card"] = errs(grads(dev, torch.float32, hook=True))
    out["autograd thread"] = dict(seen)
    out["cpu_f32"] = errs(grads(torch.device("cpu"), torch.float32))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out["card, TF32 on"] = errs(grads(dev, torch.float32))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    if hasattr(torch.backends, "fp32_precision"):
        generic = torch.backends.fp32_precision
        out["main thread"]["generic_fp32_precision"] = str(generic)
        torch.backends.fp32_precision = "ieee"
        try:
            out["card, generic ieee"] = errs(grads(dev, torch.float32))
        finally:
            torch.backends.fp32_precision = generic
    print("matmul precision, rel L2 err to f64: " + json.dumps(out))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0,1,2,3,4,5",
                    help="the seeded states, comma-separated")
    ap.add_argument("--out", help="also write the JSON results here")
    ap.add_argument("--no-trace", action="store_true",
                    help="skip the BatchNorm traces and the op probes")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "..")))
    if not torch.cuda.is_available():
        print("grad_check: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    from ssdr_al_torch.config import ConfigS3DIS
    from ssdr_al_torch.kernels import build

    build.library()
    dev = torch.device("cuda", 0)
    res = {}
    for seed in map(int, args.seeds.split(",")):
        r = gradient_errors(ConfigS3DIS, dev, seed, trace=not args.no_trace)
        p = gradient_errors(ConfigS3DIS, dev, seed, pinned=True)
        res[seed] = dict(r, ratio=r["card"] / r["cpu_f32"],
                         pinned_run=dict(p, ratio=p["card"] / p["cpu_f32"]))
    print("card/CPU f32 error ratios by seed (free; slopes and pool picks "
          "pinned): " + json.dumps(
              {s: [round(r["ratio"], 4), round(r["pinned_run"]["ratio"], 4)]
               for s, r in res.items()}))
    if not args.no_trace:
        res["op_probe"] = backward_op_probe(dev)
    res["card"] = card
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
