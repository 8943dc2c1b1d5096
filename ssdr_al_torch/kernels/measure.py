"""Check and time K1 and K2 at every call the main path makes.

    python3 ssdr_al_torch/kernels/measure.py [--tree DIR] [--out PATH]

One eval-mode forward of RandLA-Net at ConfigS3DIS width (B=8 × 40960,
`window` engine, weights and cloud drawn from a seed) on the card records
the arguments of every K1 call (`window_topk`: the self-searches of L0-L2
and the two k=1 upsamples) and every K2 call (`gather_window`: two LFA
gathers per sorted layer, and the pool gathers through
`gather_window_auto`). Each recorded call is replayed: the kernel against
its plain version (K1 equal index for index, K2 bitwise), then timed
beside the plain version, its bound and, for K2, `torch.gather` on the same
indices. K2 also runs with its other source (shared-memory slab or L1/L2)
wherever the slab fits in shared memory. Tie-heavy inputs follow:
duplicated points, points on a coarse grid, SENTINEL pad rows and window
starts clamped at the cloud's end, for K1, K5 and K2.

`--tree DIR` measures the `ssdr_al_torch` package under DIR (for example
a `git archive` of another commit) with this file's inputs and timing, so
two versions of the kernels compare on one card. Prints one line per
call and, as its last line, the results as JSON (also written to PATH).
`chip_smoke.py` runs the same checks through `check_main_path`.

Times are CUDA events around `reps` back-to-back launches, queued behind
a device sleep so that the host's launch overhead does not count: the
device time of the launches.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

# H100 SXM data sheet: HBM3 bandwidth and the f32 rate outside the tensor
# cores (none of the port's kernels uses them)
PEAK_BYTES_S, PEAK_F32_OPS_S = 3.35e12, 67e12
SMEM_MAX = 227 * 1024      # shared memory one CTA can opt in to on an H100


def bound(nbytes, nops):
    """(ms, "bytes" | "operations"): the least time for the work."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, nops / PEAK_F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def device_ms(fn, reps):
    """Mean device time of fn() in ms over `reps` runs after a warm-up,
    the runs queued behind a ~20 ms device sleep so the host keeps ahead."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def record_main_path(cfg, dev, b=8, seed=0):
    """(K1 calls, K2 calls) of one eval-mode forward [b × cfg.num_points]:
    each a dict of the wrapper's arguments and the path it serves."""
    from ssdr_al_torch.models import randlanet as rl
    from ssdr_al_torch.ops import gather as ga
    from ssdr_al_torch.ops import knn as kn

    k1, k2 = [], []
    k1_fn, k2_fn = kn.window_topk, ga.gather_window

    def rec_k1(support, queries, starts, k, window, tq=kn.QUERY_TILE,
               mxu=None):
        k1.append(dict(support=support, queries=queries, starts=starts, k=k,
                       window=window, tq=tq,
                       self=support.data_ptr() == queries.data_ptr()))
        return k1_fn(support, queries, starts, k, window, tq, mxu)

    def rec_k2(path):
        def rec(values, idx, starts, window, tq=128):
            k2.append(dict(values=values, idx=idx, starts=starts,
                           window=window, tq=tq, path=path))
            return k2_fn(values, idx, starts, window, tq)
        return rec

    # a wrapper counts its launches on its module's name for it, which is
    # the recorder while it stands in
    rec_k1.launches = rec_k1.launches_mxu = 0
    rec_lfa, rec_pool = rec_k2("LFA"), rec_k2("pool")
    rec_lfa.launches = rec_pool.launches = 0
    rng = np.random.RandomState(seed)
    n = cfg.num_points
    xyz = (rng.rand(b, n, 3) * 6).astype(np.float32)
    feats = np.concatenate([xyz, rng.rand(b, n, 3).astype(np.float32)], -1)
    torch.manual_seed(seed)
    model = rl.RandLANet(cfg).to(dev).eval()
    saved = (kn.window_topk, rl.window_topk, rl.gather_window,
             ga.gather_window)
    kn.window_topk = rl.window_topk = rec_k1
    rl.gather_window, ga.gather_window = rec_lfa, rec_pool
    try:
        with torch.no_grad():
            x = torch.from_numpy(xyz).to(dev)
            model(torch.from_numpy(feats).to(dev), rl.build_pyramid(x, cfg))
    finally:
        (kn.window_topk, rl.window_topk, rl.gather_window,
         ga.gather_window) = saved
    return k1, k2


def check_k1(call, mxu=False, reps=20, plain_reps=3):
    """K1 (K5 with mxu) at one recorded call: equal to its plain version
    index for index; its time, the plain version's and the bound."""
    from ssdr_al_torch.ops import knn as kn

    s, q, st = call["support"], call["queries"], call["starts"]
    k, w, tq = call["k"], call["window"], call["tq"]
    b, nq = q.shape[:2]
    name = (f"[{b}x{nq}] k={k} W={w} "
            + ("self" if call["self"] else f"upsample from {s.shape[1]}"))
    counter = "launches_mxu" if mxu else "launches"
    before = getattr(kn.window_topk, counter)
    got = kn.window_topk(s, q, st, k, w, tq, mxu)
    if getattr(kn.window_topk, counter) != before + 1:
        raise AssertionError(f"K1 {name}: the kernel did not launch")
    want = kn._window_topk_plain(s, q, st, k, w, tq, mxu)
    if not torch.equal(got, want):
        raise AssertionError(f"K{5 if mxu else 1} {name}: "
                             f"{(got != want).sum().item()} indices differ "
                             "from the plain version")
    ins = (s, st) if call["self"] else (s, q, st)
    bd = bound(nbytes(*ins, got), 9 * b * nq * w)
    out = dict(shape=name, max_abs_err=(got.long() - want.long()).abs()
               .max().item(),
               ms=device_ms(lambda: kn.window_topk(s, q, st, k, w, tq, mxu),
                            reps),
               plain_ms=device_ms(lambda: kn._window_topk_plain(
                   s, q, st, k, w, tq, mxu), plain_reps),
               bound_ms=bd[0], bound_by=bd[1], library_ms=None)
    if hasattr(kn, "window_topk_plan"):
        out["plan"] = list(kn.window_topk_plan(b, nq, w, tq))
    return out


def check_k2(call, reps=20, plain_reps=5):
    """K2 at one recorded call: bitwise equal to its plain version with
    the planned source and, where the slab fits, the other one; their
    times, the plain version's, torch.gather's and the bound."""
    from ssdr_al_torch.ops import gather as ga

    v, i, st = call["values"], call["idx"], call["starts"]
    w, tq = call["window"], call["tq"]
    b, n, c = v.shape
    nq, k = i.shape[1:]
    name = f"{call['path']} [{b},{nq},{k},{c}] W={w} tq={tq}"
    want = ga._gather_window_plain(v, i, st, w, tq)
    before = ga.gather_window.launches
    got = ga.gather_window(v, i, st, w, tq)
    if ga.gather_window.launches != before + 1:
        raise AssertionError(f"K2 {name}: the kernel did not launch")
    if not torch.equal(got, want):
        raise AssertionError(f"K2 {name}: differs from the plain version")
    flat = i.long().reshape(b, -1, 1).expand(-1, -1, c)
    bd = bound(nbytes(v, i, st, got), 0)
    out = dict(shape=name, max_abs_err=(got - want).abs().max().item(),
               ms=device_ms(lambda: ga.gather_window(v, i, st, w, tq), reps),
               plain_ms=device_ms(lambda: ga._gather_window_plain(
                   v, i, st, w, tq), plain_reps),
               bound_ms=bd[0], bound_by=bd[1],
               library_ms=device_ms(lambda: torch.gather(v, 1, flat), reps))
    if hasattr(ga, "gather_plan"):
        plan = ga.gather_plan(b, nq, k, c, w, tq)
        out["plan"] = list(plan)
        if w * c * 4 <= SMEM_MAX:
            other = ga.gather_plan(b, nq, k, c, w, tq, slab=not plan[0])
            alt = ga._gather_window_launch(v, i, st, w, tq, other)
            if not torch.equal(alt, want):
                raise AssertionError(f"K2 {name} with plan {other}: differs "
                                     "from the plain version")
            out["other_plan"] = list(other)
            out["other_ms"] = device_ms(lambda: ga._gather_window_launch(
                v, i, st, w, tq, other), reps)
    return out


def tie_inputs(dev, b=2, n=40960, seed=7):
    """{name: sorted cloud [b, n_pad, 3]} full of exact ties: every point
    four times, points on a 0.25 grid, and a cloud of n - 200 points
    padded with SENTINEL rows up to n (sort_cloud's pad)."""
    from ssdr_al_torch.ops import knn as kn

    rng = np.random.RandomState(seed)
    out = {}
    base = rng.rand(b, n // 4, 3).astype(np.float32) * 6
    grid = (rng.randint(0, 24, (b, n, 3)) * 0.25).astype(np.float32)
    real = rng.rand(b, n - 200, 3).astype(np.float32) * 6
    for name, x in (("duplicates", np.repeat(base, 4, axis=1)),
                    ("grid", grid), ("sentinel pad", real)):
        x = torch.from_numpy(x).to(dev)
        lo, hi = x.amin(1, keepdim=True), x.amax(1, keepdim=True)
        out[name] = kn.sort_cloud(x, lo, hi, pad_to=256).xyz_sorted
    return out


def check_ties(dev):
    """K1 (k=16 and 1) and K5 equal to their plain versions on tie-heavy
    clouds, self-searches at W=1792 and W=2560 and a 1-NN search of the
    cloud in its every-4th-point subset, with starts spread over the
    cloud and the last ones past its end (clamped by kernel and plain
    version alike); K2 bitwise equal on the same starts, indices outside
    their windows included, with both sources. Returns the names checked."""
    from ssdr_al_torch.ops import gather as ga
    from ssdr_al_torch.ops import knn as kn

    done = []
    for name, x in tie_inputs(dev).items():
        b, n, _ = x.shape
        sub = x[:, ::4].contiguous()
        tiles = n // kn.QUERY_TILE
        for sup, k, w in ((x, 16, 1792), (x, 16, 2560), (sub, 1, 1024)):
            ns = sup.shape[1]
            st = kn.self_query_starts(n, ns, w, device=dev) if sup is x \
                else torch.arange(tiles, device=dev, dtype=torch.int32) * 64
            st = st.expand(b, -1).contiguous()
            st[:, -2:] = ns             # past the end: clamped to ns - w
            for mxu in (False, True):
                got = kn.window_topk(sup, x, st, k, w, mxu=mxu)
                want = kn._window_topk_plain(sup, x, st, k, w,
                                             kn.QUERY_TILE, mxu)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"K{5 if mxu else 1} ties '{name}' k={k} W={w}: "
                        f"{(got != want).sum().item()} indices differ")
            done.append(f"{name} k={k} W={w}")
        w, tq = 2048, 512
        st = torch.clamp(kn.self_query_starts(n, n, w, tq, dev), max=n - w)
        st = st.expand(b, -1).contiguous()
        st[:, -1] = n                   # clamped to n - w
        st[:, 0] = -300                 # clamped to 0
        lo = torch.repeat_interleave(torch.clamp(st, 0, n - w), tq, 1)
        idx = (lo[..., None] + torch.randint(-40, w + 40, (b, n, 16),
                                             device=dev)).int()
        idx = torch.clamp(idx, 0, n - 1).contiguous()
        vals = torch.cat([x, torch.randn(b, n, 8, device=dev)], -1)
        want = ga._gather_window_plain(vals, idx, st, w, tq)
        runs = {"wrapper": lambda: ga.gather_window(vals, idx, st, w, tq)}
        if hasattr(ga, "gather_plan"):
            for slab in (True, False):
                plan = ga.gather_plan(b, n, 16, 11, w, tq, slab=slab)
                runs[str(plan)] = lambda plan=plan: ga._gather_window_launch(
                    vals, idx, st, w, tq, plan)
        for plan, run in runs.items():
            if not torch.equal(run(), want):
                raise AssertionError(f"K2 '{name}' ({plan}) differs")
        done.append(f"{name} K2 {list(runs)}")
    return done


def check_main_path(cfg, dev, log=print):
    """Record one forward's K1 and K2 calls, check and time each, then the
    tie-heavy inputs. Returns {"window_topk": [...], "gather_window": [...],
    "ties": [...], "calls": (k1 calls, k2 calls)}."""
    k1_calls, k2_calls = record_main_path(cfg, dev)
    k1 = []
    for call in k1_calls:
        r = check_k1(call)
        k1.append(r)
        log(f"K1 {r['shape']}: equal, {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}, plan {r.get('plan')})")
    k2 = []
    for call in k2_calls:
        r = check_k2(call)
        k2.append(r)
        alt = (f", other source {r['other_plan']}: equal, "
               f"{r['other_ms']:.4f} ms") if "other_ms" in r else ""
        log(f"K2 {r['shape']}: bitwise equal, {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.3f} ms, torch.gather {r['library_ms']:.4f} "
            f"ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}, plan "
            f"{r.get('plan')}{alt})")
    ties = check_ties(dev)
    log(f"tie-heavy inputs, equal to the plain versions: {ties}")
    return {"window_topk": k1, "gather_window": k2, "ties": ties,
            "calls": (k1_calls, k2_calls)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="root of the ssdr_al_torch tree to "
                    "measure (default: the one holding this file)")
    ap.add_argument("--out", help="also write the JSON results here")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, tree)
    if not torch.cuda.is_available():
        print("measure: no CUDA device", file=sys.stderr)
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
    res = check_main_path(ConfigS3DIS, dev)
    res.pop("calls")
    res.update(tree=tree, card=card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
