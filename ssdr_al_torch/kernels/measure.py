"""Check and time K1-K6 at every call the main path and the exact engine
make.

    python3 ssdr_al_torch/kernels/measure.py [--tree DIR] [--out PATH]
        [--dataset S3DIS|Semantic3D|SemanticKITTI]
        [--k1-only | --k4-only | --k4-routes | --k6-only]

One eval-mode forward of RandLA-Net at ConfigS3DIS width (B=8 × 40960,
`window` engine, weights and cloud drawn from a seed; with `--dataset
Semantic3D` at ConfigSemantic3D width, B=4 × 65536, and with `--dataset
SemanticKITTI` at ConfigSemanticKITTI width, 4 layers, B=6 × 45056) on
the card records
the arguments of every K1 call (`window_topk`: the self-searches of L0-L2
and the two k=1 upsamples; K5, its centred-product form, is checked at
each of them beside it) and every K2 call (`gather_window`: two LFA
gathers per sorted layer, and the pool gathers through
`gather_window_auto`). One `pallas`-engine pyramid at the same width
records every K6 call (`knn_tiled`: each layer's k=16 self-search and its
1-NN upsample), each timed beside cdist + topk and its bound (both
clouds read and the indices written once), with the operations of the
pairs it evaluated and of every pair beside it. One
train-mode forward and backward (B=6 × 40960,
4 × 65536 or 6 × 45056, dropout off) records every K4 call (`scatter_window`, the
backward of each K2 call) and which calls share a transpose of their index
set (a layer's two LFA gathers); each K4 call is also timed as its sum pass
alone and its transpose alone (`window_transpose`, equal to its plain
version, beside a stable torch.sort of the row keys), and the step's K4
time is summed as the step runs it (`k4_step`: the calls that share a
transpose by their sum passes and the transpose once, every other call
whole: the single-use path, or its own transpose and sum at k = 1). At each k = 1 call (a windowed upsample's
backward) K4-bf16 is timed beside `scatter_rows`, the bf16 model's
upsample backward, on the same rows (`check_rows_k1`). K3
(`chamfer_sums`) runs at one [8, 256, 512] dispatch (60 % valid) and at
the selection round's call: the superpoint slab of the
smoke's four synthetic rooms (`grid_superpoints`, 2048 a room, capped at
512 points) gathered by `SuperpointBlockCache.chamfer` for 310 superpoints
a room. Each call is replayed: the kernel against its plain version (K1
equal index for index, K2 and K4 bitwise, K4's against the CPU's
`index_add_`, K3 within 1e-5 relative), two launches compared bit for bit
(K3, K4), then timed beside the plain version, its bound and, for K2
`torch.gather` and for K4 `index_add_`, on the same indices. K2 also runs
with its other source (shared-memory slab or L1/L2) wherever the slab fits
in shared memory. Tie-heavy inputs follow at S3DIS width: duplicated
points, points on a coarse grid, SENTINEL pad rows and window starts
clamped at the cloud's end, for K1, K5, K2 and K6.

`check_bf16_path` (run here after the f32 checks, and by
`chip_smoke.py`) checks K2 and K4 at every call of the same forward and
train-mode backward of the bf16 model (cfg.compute_dtype "bfloat16"),
and at S3DIS width K4 also at the flagship run's batch [2 × 40960]: K2's
bf16-output instantiation and K4's bf16-cotangent one, each bitwise equal
to its plain version (the f32 gather rounded to bf16; index_add_ of
g.float()), beside `torch.gather` of the values cast to bf16 and
`index_add_` of the cotangent widened to f32; the bound counts the bf16
output and cotangent at 2 bytes a value.

`--k4-only` runs only the K4 calls of one f32 and one bf16 train step
(and the bf16 one at the flagship's batch at S3DIS width).
`--k4-routes` runs K4 at the same calls (f32 at each dataset's width,
bf16 at S3DIS width and at the flagship's batch) on each of its routes
(`k4_routes`: the single-use path, a transpose of the call's own on the
batch and on the tile plan, the sum pass alone), two turns each, for the
margins of the wrapper's choices.
`--k1-only` runs only K1 and K5 at every K1 call of one forward at [8,
6 and 2 × 40960] (the eval step, the S3DIS train step's batch and the
flagship's; with `--dataset`, that dataset's batch), each beside its
plain version and bound, and K1's counter build (ops/knn.py::
window_topk_stats) at each: its counters a warp beside the numpy twin's
(kernels/k1_twin.py) on sampled tiles, equal where the twin walks every
tile, and its time whole, after the staging only and after the fill.
`--k6-only` runs only the K6 calls, and the partition's (`partition_call`:
the k = 46 self-search over one prepared S3DIS-sized room, K6's K = 64
instantiation) over random subsets of that room (46, 700, 3000, 6000,
10 000 and 20 000 points), the room itself and a flagship room
(139 686 points, as scripts/flagship.py makes it), each also on every
route of the wrapper (the brute-force loop, the walk over the clouds in
their own order, the walk over the curve-sorted clouds;
ops/knn.py::knn_tiled_route picks one by the support's size and k) and
split by kernel under torch.profiler (the walk apart from the codes,
sorts and layout). Its walk counters are a warp's for K = 1 and 16 and
a query's for K = 64 (a warp a query). Before them it times the six
flagship rooms' `knn_ms` as cli.superpoint does. `chip_smoke.py` checks
the partition's call on a room its partition phase prepared.

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


def device_breakdown(fn, reps=5):
    """({kernel: device ms per call}, kernel launches per call) of fn()
    under torch.profiler: every CUDA kernel it launched, by name, over
    `reps` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out, n = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n += 1
            out[e.name] = out.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / reps
    return dict(sorted(out.items(), key=lambda kv: -kv[1])), n / reps


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
        def rec(values, idx, starts, window, tq=128, out_dtype=None,
                transpose=None):
            k2.append(dict(values=values, idx=idx, starts=starts,
                           window=window, tq=tq,
                           path="upsample" if idx.shape[2] == 1 else path,
                           out_dtype=out_dtype or values.dtype))
            # a tree without the bf16 output takes no out_dtype, one
            # without shared transposes none
            dt = () if out_dtype is None else (out_dtype,)
            kw = {} if transpose is None else {"transpose": transpose}
            return k2_fn(values, idx, starts, window, tq, *dt, **kw)
        return rec

    # a wrapper counts its launches on its module's name for it, which is
    # the recorder while it stands in
    rec_k1.launches = rec_k1.launches_mxu = 0
    rec_lfa, rec_pool = rec_k2("LFA"), rec_k2("pool")
    rec_lfa.launches = rec_pool.launches = 0
    rec_lfa.launches_bf16 = rec_pool.launches_bf16 = 0
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


def record_exact_path(cfg, dev, b=8, seed=0):
    """K6 calls of one `pallas`-engine pyramid [b × cfg.num_points] (the
    exact engine's forward builds it before the layers run): each layer's
    k=16 self-search and its 1-NN upsample against the layer's prefix, as
    dicts of the wrapper's arguments in launch order."""
    from ssdr_al_torch.models import randlanet as rl
    from ssdr_al_torch.ops import knn as kn

    calls, k6 = [], kn.knn_tiled

    def rec(support, query, k):
        calls.append(dict(support=support, query=query, k=k))
        return k6(support, query, k)

    # the wrapper counts its launches on the module's name for it
    rec.launches = 0
    rng = np.random.RandomState(seed)
    xyz = (rng.rand(b, cfg.num_points, 3) * 6).astype(np.float32)
    kn.knn_tiled = rec
    try:
        with torch.no_grad():
            rl.build_pyramid(torch.from_numpy(xyz).to(dev), cfg,
                             engine="pallas")
    finally:
        kn.knn_tiled = k6
    return calls


# the partition's K6 call (partition/superpoint.py::knn_graph): k_geof + 1
# neighbours at the default k_nn_geof 45, on one S3DIS-sized room (the
# smoke's ROOM_POINTS) prepared as cli.prepare does at the 0.04 grid
PARTITION_K, PARTITION_ROOM_POINTS, PARTITION_GRID = 46, 150_000, 0.04


def partition_call(dev, xyz=None, seed=0):
    """The partition's K6 call as a dict of the wrapper's arguments: the
    self-search of k = PARTITION_K over one prepared room [1, N, 3] on the
    card; xyz, when given, is the prepared room's points, else a
    synthetic hard room of PARTITION_ROOM_POINTS points is shifted to its
    least corner and subsampled on the PARTITION_GRID grid
    (data/prepare.py::prepare_s3dis_room's steps)."""
    if xyz is None:
        from ssdr_al_torch.data.synthetic import make_dataset
        from ssdr_al_torch.ops.grid_subsample import grid_subsample_np

        room = make_dataset(num_train=1, num_val=0,
                            num_points=PARTITION_ROOM_POINTS, seed=seed,
                            hard=True)[0][0]
        xyz = grid_subsample_np(room.xyz - room.xyz.min(0),
                                grid_size=PARTITION_GRID)
    x = torch.from_numpy(np.ascontiguousarray(xyz, np.float32)).to(dev)[None]
    return dict(support=x, query=x, k=PARTITION_K)


def cdist_topk(support, query, k, chunk=4096):
    """The library call for K6: torch.cdist then torch.topk, chunked over
    queries so the [B, chunk, Ns] distance block fits."""
    return torch.cat([torch.topk(torch.cdist(query[:, q0:q0 + chunk],
                                             support), k, dim=-1,
                                 largest=False).indices
                      for q0 in range(0, query.shape[1], chunk)], 1)


def check_k6(call, reps=10, plain_reps=1, lib_reps=2):
    """K6 at one recorded call: equal to its plain version index for index;
    the pairs it evaluated (every pair for a tree without the count); its
    time, the plain version's, cdist + topk's and its bound: the bytes of
    both clouds read once and the indices written once, or the operations
    of the k pairs each query must at least evaluate (9 each: d² and a
    compare), whichever takes longer. Beside it, the operations of the
    pairs this run evaluated (`ops_ms_evaluated`) and of every pair
    (`bound_ms_all_pairs`: the TPU kernel's and the brute-force route's
    work)."""
    from ssdr_al_torch.ops import knn as kn

    s, q, k = call["support"], call["query"], call["k"]
    b, ns, _ = s.shape
    nq = q.shape[1]
    self_search = s.data_ptr() == q.data_ptr() and s.shape == q.shape
    name = (f"[{b}x{nq}] k={k} " + ("self" if self_search
                                     else f"upsample from {ns}"))
    counter = kn.knn_tiled_counter(k)
    before = getattr(kn.knn_tiled, counter)
    got = kn.knn_tiled(s, q, k)
    if getattr(kn.knn_tiled, counter) != before + 1:
        raise AssertionError(f"K6 {name}: the kernel did not launch")
    want = kn._knn_tiled_plain(s, q, k)
    if not torch.equal(got, want):
        raise AssertionError(f"K6 {name}: {(got != want).sum().item()} "
                             "indices differ from the plain version")
    pairs, walk = b * ns * nq, {}
    if hasattr(kn, "knn_tiled_stats"):
        walk = kn.knn_tiled_stats(s, q, k)[1]
        pairs = walk.pop("pairs")
    # the walk's counters per warp (K = 1 and 16, and K = 64 on a tree
    # whose K = 64 walk is a lane per query), or per query (the warp per
    # query of knn_walk64_kernel)
    per_query = kn.knn_kernel_k(k) == 64 and hasattr(kn, "KNN_WALK64_QUERIES")
    nb = nbytes(s, got) + (0 if self_search else nbytes(q))
    bd = bound(nb, 9 * b * nq * min(k, ns))
    return dict(shape=name, route=kn.knn_tiled_route(ns, k)
                if hasattr(kn, "knn_tiled_route") else None,
                max_abs_err=(got.long() - want.long()).abs().max().item(),
                ms=device_ms(lambda: kn.knn_tiled(s, q, k), reps),
                plain_ms=device_ms(lambda: kn._knn_tiled_plain(s, q, k),
                                   plain_reps),
                bound_ms=bd[0], bound_by=bd[1],
                ops_ms_evaluated=bound(0, 9 * pairs)[0],
                bound_ms_all_pairs=bound(0, 9 * b * ns * nq)[0],
                library_ms=device_ms(lambda: cdist_topk(s, q, k), lib_reps),
                pairs=pairs, pair_share=pairs / (b * ns * nq),
                walk_per="query" if per_query else "warp",
                walk={key: v / (nq if per_query else -(-nq // 32)) / b
                      for key, v in walk.items()})


def k6_routes(call, reps=10):
    """K6 at one recorded call on each of its routes (ops/knn.py::
    knn_tiled_route picks one by the support's size): each equal to the
    plain version, its time, the pairs it evaluated, and the device time
    of the route the wrapper picks split by kernel under torch.profiler
    (the walk apart from its codes, sorts and layout)."""
    from ssdr_al_torch.ops import knn as kn

    s, q, k = call["support"], call["query"], call["k"]
    want = kn._knn_tiled_plain(s, q, k)
    out = {}
    for route in kn.KNN_ROUTES:
        got, st = kn.knn_tiled_stats(s, q, k, route=route)
        if not torch.equal(got, want):
            raise AssertionError(f"K6 on the {route} route differs")
        out[route] = dict(ms=device_ms(lambda: kn._knn_tiled(
            s, q, k, route=route), reps), pairs=st["pairs"])
    out = dict(routes=out)
    out.update(k6_split(call))
    return out


def k6_split(call):
    """K6's call on the route the wrapper picks, split by kernel under
    torch.profiler: `walk_ms` the walk (knn_walk*), `kernel_ms` every K6
    kernel (the walk, codes, bounds, layout), `other_ms` the rest (the
    stable torch.sort of the codes, allocations' fills)."""
    from ssdr_al_torch.ops import knn as kn

    s, q, k = call["support"], call["query"], call["k"]
    parts, launches = device_breakdown(lambda: kn.knn_tiled(s, q, k))
    ours = sum(v for n, v in parts.items() if "knn_" in n)
    return dict(walk_ms=sum(v for n, v in parts.items() if "knn_walk" in n),
                kernel_ms=ours, other_ms=sum(parts.values()) - ours,
                device_launches=launches,
                top_kernels_ms={n[:60]: round(v, 4)
                                for n, v in list(parts.items())[:6]})


# the support sizes at which --k6-only times every route of K6's K = 64
# walk (k = 46) below the partition's room: random subsets of it
K64_ROUTE_SIZES = (46, 700, 3000, 6000, 10000, 20000)


def flagship_rooms():
    """The xyz of scripts/flagship.py's six training rooms: cli.common.
    setup_experiment's synthetic set at 6 hard rooms of 150 000 points
    (139 686 each after the generator)."""
    from ssdr_al_torch.data.synthetic import make_dataset

    return [np.asarray(room.xyz, np.float32) for room in make_dataset(
        num_train=6, num_val=1, num_points=150_000, hard=True)[0]]


def flagship_knn_ms(dev, rooms):
    """Each flagship training room's `knn_ms` as cli.superpoint records it
    (partition/superpoint.py::partition_cloud: CUDA events around the
    K = 64 search of `_neighbours`), the rooms in the flagship's order in
    this process: room 0 takes the K = 64 walk's first launch (cold)."""
    from ssdr_al_torch.partition import superpoint as sp

    out = []
    for xyz in rooms:
        timer = sp._Timer(dev)
        xyz_t = torch.from_numpy(xyz).to(dev)
        timer.mark("start")
        sp._neighbours(xyz_t, xyz, PARTITION_K, 10, "device", timer)
        torch.cuda.synchronize()
        out.append(timer.ms("start", "knn"))
    return out


def k64_calls(dev, flagship_xyz):
    """The partition's K6 call at K64_ROUTE_SIZES (subsets of a prepared
    room), at a prepared room and at a flagship room."""
    room = partition_call(dev)
    x = room["support"][0].cpu().numpy()
    rng = np.random.RandomState(1)
    calls = [partition_call(dev, x[np.sort(rng.choice(len(x), n, False))])
             for n in K64_ROUTE_SIZES]
    return calls + [room, partition_call(dev, flagship_xyz)]


def k6_line(r) -> str:
    """One K6 call of --k6-only as a line."""
    return (f"K6 {r['shape']}: equal, {r['ms']:.4f} ms on route "
            f"{r['route']} (walk {r['walk_ms']:.4f}, K6 kernels "
            f"{r['kernel_ms']:.4f}, the rest {r['other_ms']:.4f} ms; pairs "
            f"{100 * r['pair_share']:.3f} %; bound {r['bound_ms']:.4f} ms, "
            f"ops of the pairs evaluated {r['ops_ms_evaluated']:.4f}; "
            f"plain {r['plain_ms']:.3f}, cdist+topk {r['library_ms']:.3f}); "
            "every route " + json.dumps({n: round(v["ms"], 4)
                                         for n, v in r["routes"].items()})
            + f"; a {r['walk_per']} " + json.dumps(
                {n: round(v, 2) for n, v in r["walk"].items()})
            + " " + json.dumps(r["top_kernels_ms"]))


def record_train_backward(cfg, dev, b=6, seed=0):
    """K4 calls of one train-mode forward and backward [b × cfg.num_points]
    (dropout off, a random cotangent on the logits): each a dict of the
    wrapper's arguments, in launch order, and `shared`: the calls that
    share one transpose of their index set (a layer's two LFA scatters)
    have the same number, every other call its own."""
    from ssdr_al_torch.models import randlanet as rl
    from ssdr_al_torch.ops import gather as ga

    calls, keys = [], {}
    k4 = ga.scatter_window

    def rec(g, idx, starts, n, window, tq=128, transpose=None):
        key = len(calls) if transpose is None else \
            keys.setdefault(id(transpose), len(calls))
        calls.append(dict(g=g, idx=idx, starts=starts, n=n, window=window,
                          tq=tq, shared=key))
        kw = {} if transpose is None else {"transpose": transpose}
        return k4(g, idx, starts, n, window, tq, **kw)

    # the wrapper counts its launches on the module's name for it
    rec.launches = rec.launches_bf16 = 0
    rng = np.random.RandomState(seed)
    n = cfg.num_points
    xyz = (rng.rand(b, n, 3) * 6).astype(np.float32)
    feats = np.concatenate([xyz, rng.rand(b, n, 3).astype(np.float32)], -1)
    torch.manual_seed(seed)
    model = rl.RandLANet(cfg).to(dev).train()
    model.dp1.eval()
    with torch.no_grad():
        pyr = rl.build_pyramid(torch.from_numpy(xyz).to(dev), cfg)
    logits, _ = model(torch.from_numpy(feats).to(dev), pyr, unsort=False)
    cot = torch.from_numpy(rng.randn(*logits.shape).astype(np.float32))
    ga.scatter_window = rec
    try:
        logits.backward(cot.to(dev))
    finally:
        ga.scatter_window = k4
    return calls


def check_k4(call, reps=20, plain_reps=5):
    """K4 at one recorded call: two launches equal bit for bit; against
    the plain version on the CPU (index_add_ in (q, j) order, of g.float()
    for a bf16 g) bitwise, or where the tree's K4 sums in no fixed order,
    within 1e-5 relative plus 2·m·ε·Σ|g| (two orders of an f32 sum of m
    values); its time, the plain version's on the card, index_add_'s on
    the same rows (of the cotangent widened to f32 beforehand) and the
    bound."""
    from ssdr_al_torch.ops import gather as ga

    g, i, st = call["g"], call["idx"], call["starts"]
    n, w, tq = call["n"], call["window"], call["tq"]
    b, nq, k, c = g.shape
    bf16 = g.dtype == torch.bfloat16
    name = (f"[{b},{nq},{k},{c}]{' bf16' if bf16 else ''} -> [{b},{n},{c}] "
            f"W={w} tq={tq}")
    counter = "launches_bf16" if bf16 else "launches"
    before = getattr(ga.scatter_window, counter)
    got = ga.scatter_window(g, i, st, n, w, tq)
    again = ga.scatter_window(g, i, st, n, w, tq)
    if getattr(ga.scatter_window, counter) != before + 2:
        raise AssertionError(f"K4 {name}: the kernel did not launch")
    cpu = [t.cpu() for t in (g, i, st)]
    want = ga._scatter_window_plain(*cpu, n, w, tq)
    got_c = got.cpu()
    bitwise = torch.equal(got_c, want)
    if not bitwise:
        m = ga._scatter_window_plain(torch.ones_like(cpu[0]), *cpu[1:], n, w,
                                     tq)
        tol = 1e-5 * want.abs() + 2 * m * 2.0 ** -23 * \
            ga._scatter_window_plain(cpu[0].abs(), *cpu[1:], n, w, tq)
        if not bool(((got_c - want).abs() <= tol).all()):
            raise AssertionError(f"K4 {name}: differs from the plain version")
    rows = (i.long() + (torch.arange(b, device=i.device) * n)[:, None, None]
            ).reshape(-1)
    g2 = g.reshape(-1, c).float()
    per_row = row_entries(i, st, n, w, tq)
    bd = bound(nbytes(g, i, st, got), g.numel())
    out = dict(shape=name, dtype=str(g.dtype).split(".")[-1],
               bitwise=bitwise,
               run_to_run=torch.equal(got, again),
               max_abs_err=(got_c - want).abs().max().item(),
               ms=device_ms(lambda: ga.scatter_window(g, i, st, n, w, tq),
                            reps),
               plain_ms=device_ms(lambda: ga._scatter_window_plain(
                   g, i, st, n, w, tq), plain_reps),
               bound_ms=bd[0], bound_by=bd[1],
               library_ms=device_ms(lambda: torch.zeros(
                   b * n, c, device=g.device).index_add_(0, rows, g2), reps),
               max_row_entries=int(per_row.max()))
    # rows past the bins of the fill's path (this tree's single-use path,
    # a parent tree's only one)
    bins = getattr(ga, "FUSED_BIN", getattr(ga, "SCATTER_BIN", None))
    if bins:
        out["overflow_rows"] = int((per_row > bins).sum())
    if hasattr(ga, "scatter_plan"):
        out["plan"] = list(ga.scatter_plan(b, n, nq, k, c, w, tq,
                                           *((g.dtype,) if bf16 else ())))
    if hasattr(ga, "fused_plan") and tq * k >= ga.TRANSPOSE_SMALL_TILE:
        # the call on its own takes the single-use path
        out["plan"] = ["single-use"] + list(ga.fused_plan(b, n, nq, k, c, w,
                                                           tq, g.dtype))
    if hasattr(ga, "WindowTranspose"):
        # the sum pass alone, through a transpose built beforehand and
        # shared by two calls, and the transpose alone
        tr = ga.WindowTranspose(i, st, n, w, tq)
        shared = [ga.scatter_window(g, i, st, n, w, tq, transpose=tr)
                  for _ in range(2)]
        out.update(check_transpose(i, st, n, w, tq, reps),
                   shared_bitwise=all(torch.equal(x, got) for x in shared),
                   sum_ms=device_ms(lambda: ga.scatter_window(
                       g, i, st, n, w, tq, transpose=tr), reps),
                   transpose_plan=list(ga.transpose_plan(b, n, nq, k, w,
                                                         tq)),
                   shared=call.get("shared"))
    return out


def check_transpose(idx, starts, n, window, tq, reps=20, plain_reps=5):
    """K4's transpose kernels at one index set: one launch counted,
    rowptr and the ids it defines equal to the plain version's (a stable
    sort of the rows); its time, the plain version's, a stable torch.sort
    of the same row keys (the sort alone) and the bound: idx and starts
    read, rowptr and the in-window ids written."""
    from ssdr_al_torch.ops import gather as ga

    before = ga.window_transpose.launches
    rp, ids = ga.window_transpose(idx, starts, n, window, tq)
    if ga.window_transpose.launches != before + 1:
        raise AssertionError("K4 transpose: the kernels did not launch")
    rp0, ids0 = ga._window_transpose_plain(idx, starts, n, window, tq)
    b, nq, k = idx.shape
    ends = rp0.reshape(b, n + 1)[:, n].tolist()
    equal = torch.equal(rp, rp0) and all(
        torch.equal(ids[j * nq * k:j * nq * k + m],
                    ids0[j * nq * k:j * nq * k + m])
        for j, m in enumerate(ends))
    i, inside = ga._window_mask(idx, starts, n, window, tq)
    key = torch.where(inside, i, n).reshape(b, -1)
    bd = bound(nbytes(idx, starts, rp) + 4 * sum(ends), 0)
    return dict(transpose_equal=equal,
                transpose_ms=device_ms(lambda: ga.window_transpose(
                    idx, starts, n, window, tq), reps),
                transpose_plain_ms=device_ms(
                    lambda: ga._window_transpose_plain(idx, starts, n,
                                                       window, tq),
                    plain_reps),
                transpose_bound_ms=bd[0], transpose_bound_by=bd[1],
                transpose_sort_ms=device_ms(
                    lambda: torch.sort(key, dim=1, stable=True), reps))


def k4_routes(call, reps=20, turns=2):
    """K4's routes at one recorded call, each checked bitwise against the
    CPU plain version and timed `turns` times, the routes in turns: the
    single-use path (`fused`: fill and sum), the call through a transpose
    of its own on the batch plan (`batch`, where its ids fit: nq·k <=
    65535 and its shared memory within TRANSPOSE_WHOLE_SMEM) and on the
    tile plan (`tile`), each transpose alone (`batch_t`, `tile_t`) and the
    sum pass alone through a transpose built beforehand (`sum`). The tile
    plan is forced by setting ops/gather.py's TRANSPOSE_WHOLE_SMEM to 0
    for the call. Returns {shape, route (the one the wrapper takes without a
    shared transpose), transpose (the plan it takes), ms: {route: [ms a
    turn]}, bitwise}."""
    from ssdr_al_torch.ops import gather as ga

    g, i, st = call["g"], call["idx"], call["starts"]
    n, w, tq = call["n"], call["window"], call["tq"]
    b, nq, k, c = g.shape
    if g.data_ptr() % 16:
        g = g.clone()            # the kernels load 16-byte aligned units
    name = (f"[{b},{nq},{k},{c}]"
            f"{' bf16' if g.dtype == torch.bfloat16 else ''} -> "
            f"[{b},{n},{c}] W={w} tq={tq}")
    saved = ga.TRANSPOSE_WHOLE_SMEM

    def forced(plan, fn):
        def run():
            if plan == "tile":
                ga.TRANSPOSE_WHOLE_SMEM = 0
            try:
                return fn()
            finally:
                ga.TRANSPOSE_WHOLE_SMEM = saved
        return run

    plans = ["tile"] + (["batch"] if ga.transpose_plan(b, n, nq, k, w, tq)[3]
                        else [])
    fns = {"fused": lambda: ga._scatter_fused(g, i, st, n, w, tq)}
    for plan in plans:
        fns[plan] = forced(plan, lambda: ga._scatter_csr(g, i, st, n, w, tq,
                                                         None))
        fns[plan + "_t"] = forced(plan, lambda: ga.window_transpose(
            i, st, n, w, tq))
    tr = ga.WindowTranspose(i, st, n, w, tq)
    tr.csr()
    fns["sum"] = lambda: ga._scatter_csr(g, i, st, n, w, tq, tr)
    want = ga._scatter_window_plain(g.cpu(), i.cpu(), st.cpu(), n, w, tq)
    bitwise = all(torch.equal(fns[r]().cpu(), want)
                  for r in fns if not r.endswith("_t"))
    ms = {r: [] for r in fns}
    for _ in range(turns):
        for r, fn in fns.items():
            ms[r].append(device_ms(fn, reps))
    route = "fused" if tq * k >= ga.TRANSPOSE_SMALL_TILE else \
        ("batch" if ga.transpose_plan(b, n, nq, k, w, tq)[3] else "tile")
    return dict(shape=name, shared=call.get("shared"), route=route,
                transpose="batch" if ga.transpose_plan(
                    b, n, nq, k, w, tq)[3] else "tile",
                ms=ms, bitwise=bitwise)


def k4_routes_line(r) -> str:
    return (f"K4 routes {r['shape']} (shared {r['shared']}; takes "
            f"{r['route']}, transposes on the {r['transpose']} plan; every "
            f"route bitwise {r['bitwise']}): " + ", ".join(
                f"{n} " + "/".join(f"{v:.4f}" for v in ms)
                for n, ms in r["ms"].items()) + " ms")


def k4_step(rows):
    """(ms, unshared ms, bound ms) of the K4 calls of one step as checked
    by check_k4: the step as it runs (a call that shares its index set's
    transpose with another: its sum pass, and the transpose once; any
    other call: the whole call), every call on its own, and the calls'
    bounds summed. A tree without shared transposes: its calls' times."""
    unshared = sum(r["ms"] for r in rows)
    if not all("sum_ms" in r for r in rows):
        return unshared, unshared, sum(r["bound_ms"] for r in rows)
    groups = {}
    for r in rows:
        groups.setdefault(r["shared"], []).append(r)
    step = sum(sum(r["sum_ms"] for r in g) + g[0]["transpose_ms"]
               if len(g) > 1 else g[0]["ms"] for g in groups.values())
    return step, unshared, sum(r["bound_ms"] for r in rows)


def k4_line(r) -> str:
    """One K4 call's check as a line."""
    line = (f"K4 {r['shape']}: bitwise equal to the CPU plain version "
            f"{r['bitwise']}, run to run {r['run_to_run']}, {r['ms']:.4f} ms"
            f" (plain {r['plain_ms']:.3f} ms, index_add_ "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}, plan {r.get('plan')}; most entries a row "
            f"{r['max_row_entries']})")
    if "sum_ms" in r:
        line += (f"; sum pass {r['sum_ms']:.4f} ms, shared transpose "
                 f"bitwise {r['shared_bitwise']}; transpose {r['shared']} "
                 f"equal {r['transpose_equal']}, {r['transpose_ms']:.4f} ms "
                 f"(plain {r['transpose_plain_ms']:.3f}, stable sort "
                 f"{r['transpose_sort_ms']:.4f}, bound "
                 f"{r['transpose_bound_ms']:.4f} ms, plan "
                 f"{r['transpose_plan']})")
    return line


def k4_ok(r) -> bool:
    """A fixed-order K4 call's check passed: bitwise equal to the plain
    version and to itself, through its own and a shared transpose, the
    transpose equal to the plain one."""
    return (r["bitwise"] and r["run_to_run"]
            and r.get("shared_bitwise", True)
            and r.get("transpose_equal", True))


def row_entries(idx, starts, n, window, tq):
    """[B·n] count of in-window entries per dv row of a K4 call: the rows
    past the fill's bins (FUSED_BIN) take its overflow list."""
    from ssdr_al_torch.ops import gather as ga

    i, inside = ga._window_mask(idx, starts, n, window, tq)
    rows = i + (torch.arange(idx.shape[0], device=idx.device) * n)[:, None,
                                                                   None]
    return torch.bincount(rows[inside], minlength=idx.shape[0] * n)


def chamfer_bounds(points, mask, out):
    """((ms, by) of the least work: each unordered pair of valid points in
    distinct superpoints once, 8 operations of d² and 2 minima), and (ms,
    by) of the looser count: every ordered pair of valid points of a
    block, 9 operations."""
    cnt = mask.sum(-1).double()                                    # [C, S]
    tot = cnt.sum(-1)
    distinct = float(((tot * tot - (cnt * cnt).sum(-1)) / 2).sum())
    nb = nbytes(points, mask, out)
    return bound(nb, 10 * distinct), bound(nb, 9 * float((tot * tot).sum()))


def fixed_chamfer_call(dev, shape=(8, 256, 512), valid=0.6, seed=0):
    """K3's arguments at one [C, S, P] dispatch: points N(0, 0.3²), each
    slot valid with probability `valid`."""
    c, s, p = shape
    rng = np.random.RandomState(seed)
    pts = (rng.randn(c, s, p, 3) * 0.3).astype(np.float32)
    return (torch.from_numpy(pts).to(dev),
            torch.from_numpy(rng.rand(c, s, p) < valid).to(dev))


def selection_chamfer_call(dev, seed=0, per_room=310):
    """K3's arguments at the selection round's call shape: the smoke's four
    synthetic hard rooms of 150 000 points (seed 0), grid superpoints at
    2048 a room in a SuperpointBlockCache (512-point cap), 310 superpoints
    a room (about the smoke's 2·B candidates plus anchors) gathered by
    cache.chamfer, recorded at the chamfer_sums call."""
    from ssdr_al_torch.active.region_graph import SuperpointBlockCache
    from ssdr_al_torch.data.synthetic import grid_superpoints, make_dataset
    from ssdr_al_torch.ops import chamfer as ch

    train, _ = make_dataset(num_train=4, num_val=1, num_points=150_000,
                            seed=0, hard=True)
    cache = SuperpointBlockCache(512, device=dev)
    rng = np.random.RandomState(seed)
    idx = []
    for c in train:
        comps, _ = grid_superpoints(c.xyz, 2048)
        cache.ensure(c.name, c.xyz, comps)
        pick = rng.choice(len(comps), min(per_room, len(comps)), replace=False)
        idx.append(np.sort(pick))
    cache.finalize()
    s = max(len(p) for p in idx)
    rows = np.full((len(train), s), cache.trash_row, np.int64)
    for ci, (c, p) in enumerate(zip(train, idx)):
        rows[ci, :len(p)] = cache.rows(c.name, p)
    calls, k3 = [], ch.chamfer_sums

    def rec(points, mask):
        calls.append((points, mask))
        return k3(points, mask)

    rec.launches = 0
    ch.chamfer_sums = rec
    try:
        cache.chamfer(rows)
    finally:
        ch.chamfer_sums = k3
    return calls[0]


def check_k3(points, mask, name, reps=5):
    """K3 at one call: two launches equal bit for bit, within 1e-5
    relative of its plain version; its time, the plain version's (the one
    call compared, by CUDA events: it takes seconds, so a warm-up would
    add nothing but its time), and both bounds (chamfer_bounds)."""
    from ssdr_al_torch.ops import chamfer as ch

    before = ch.chamfer_sums.launches
    o = ch.chamfer_sums(points, mask)
    again = ch.chamfer_sums(points, mask)
    if ch.chamfer_sums.launches != before + 2:
        raise AssertionError(f"K3 {name}: the kernel did not launch")
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    op = ch._chamfer_sums_plain(points, mask)
    end.record()
    torch.cuda.synchronize()
    rel = ((o - op).abs() / op.abs().clamp(min=1e-6)).max().item()
    if not rel <= 1e-5:
        raise AssertionError(f"K3 {name}: relative error {rel}")
    least, old = chamfer_bounds(points, mask, o)
    c, s, p = mask.shape
    return dict(shape=f"{name} [{c},{s},{p}], {mask.float().mean().item():.3f}"
                      " valid",
                run_to_run=torch.equal(o, again), max_rel_err=rel,
                max_abs_err=(o - op).abs().max().item(),
                ms=device_ms(lambda: ch.chamfer_sums(points, mask), reps),
                plain_ms=start.elapsed_time(end),
                bound_ms=least[0], bound_by=least[1],
                bound_ms_ordered=old[0], library_ms=None)


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


def k1_counters(call, twin_tiles=8, every_tile=24, reps=20):
    """K1's counter build (ops/knn.py::window_topk_stats) at one recorded
    call: equal to the plain version; its counters a warp (and a query for
    the keys) beside the numpy twin's of the same walk
    (kernels/k1_twin.py, "new") on `twin_tiles` tiles drawn from a seed
    (every tile where the call has at most `every_tile`, and then the
    counters they differ in are returned); the counter build's time
    whole, cut after
    the staging and cut after the fill, and the parent design's counters
    by the twin on the same tiles. None where the tree has no counter
    build."""
    from ssdr_al_torch.ops import knn as kn

    if not hasattr(kn, "window_topk_stats"):
        return None
    from ssdr_al_torch.kernels import k1_twin

    s, q, st = call["support"], call["queries"], call["starts"]
    k, w, tq = call["k"], call["window"], call["tq"]
    b, nq = q.shape[:2]
    got, chip = kn.window_topk_stats(s, q, st, k, w, tq)
    if not torch.equal(got, kn._window_topk_plain(s, q, st, k, w, tq)):
        raise AssertionError("K1's counter build differs from the plain "
                             "version")
    nt = nq // tq
    rng = np.random.RandomState(1)
    pick = rng.choice(b * nt, b * nt if b * nt <= every_tile
                      else twin_tiles, replace=False)
    tiles = np.stack([pick // nt, pick % nt], 1)
    plan = kn.window_topk_plan(b, nq, w, tq)
    host = [x.cpu().numpy() for x in (s, q, st)]
    twin = {pol: k1_twin.walk(*host[:2], host[2].astype(np.int64), k, w, tq,
                              plan, call["self"], pol, tiles)[1]
            for pol in ("new", "parent")}
    # where the twin walked every tile: the counters it differs in
    diff = None if len(tiles) < b * nt else {
        n: (chip[n], twin["new"][n]) for n in kn.K1_STATS
        if chip[n] != twin["new"][n]}

    def per(c, queries):
        return {n: c[n] / (queries if n.startswith("keys") else c["warps"])
                for n in kn.K1_STATS if n != "warps"}

    times = {f"cut{cut}_ms": device_ms(
        lambda cut=cut: kn.window_topk_stats(s, q, st, k, w, tq, cut,
                                             read=False), reps)
        for cut in (0, 1, 2)}
    return dict(chip=per(chip, b * nq),
                twin=per(twin["new"], twin["new"]["queries"]),
                twin_parent=per(twin["parent"], twin["parent"]["queries"]),
                twin_differs=diff,
                twin_lone_blocks=twin["new"]["lone_blocks"]
                / twin["new"]["queries"],
                twin_tiles=len(tiles), chip_totals=chip, **times)


def k1_forward_line(name, rows, key="ms"):
    return (f"K1 over the {len(rows)} calls of one {name} forward: "
            f"{sum(r[key] for r in rows):.4f} ms (bound "
            f"{sum(r['bound_ms'] for r in rows):.4f} ms)")


def check_k1_only(cfg, dev, batches, log=print):
    """K1 and K5 at every K1 call of one eval-mode forward [b ×
    cfg.num_points] for each b: equal to their plain versions, timed
    beside the plain version and the bound, with the counter build's
    figures (k1_counters) where the tree has it; then each forward's K1
    and K5 totals."""
    out = {}
    for b in batches:
        k1_calls, _ = record_main_path(cfg, dev, b=b)
        rows = []
        for call in k1_calls:
            r = check_k1(call)
            r5 = check_k1(call, mxu=True)
            r.update(k5_ms=r5["ms"], k5_plain_ms=r5["plain_ms"],
                     counters=k1_counters(call))
            rows.append(r)
            c = r["counters"]
            cl = "" if c is None else (
                f"; counter build {c['cut0_ms']:.4f} ms, staging only "
                f"{c['cut1_ms']:.4f}, staging and fill {c['cut2_ms']:.4f}"
                f"; a warp (twin on {c['twin_tiles']} tiles, parent's "
                f"walk): " + ", ".join(
                    f"{n} {c['chip'][n]:.2f} ({c['twin'][n]:.2f}, "
                    f"{c['twin_parent'][n]:.2f})" for n in c["chip"])
                + f", a lone query's blocks {c['twin_lone_blocks']:.2f}"
                + ("" if c["twin_differs"] is None else
                   f"; every tile: the twin differs in {c['twin_differs']}"))
            log(f"K1 {cfg.name} {r['shape']}: equal, {r['ms']:.4f} ms "
                f"(plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} "
                f"ms by {r['bound_by']}, plan {r.get('plan')}); K5 equal, "
                f"{r['k5_ms']:.4f} ms{cl}")
        log(k1_forward_line(f"{cfg.name} [{b} x {cfg.num_points}]", rows)
            + f"; K5 {sum(r['k5_ms'] for r in rows):.4f} ms")
        out[f"{cfg.name} b={b}"] = rows
    return out


def knn_window_calls(dev, b=6, n=40960, seed=0):
    """The knn_window calls of the smoke's phase on b synthetic rooms of n
    points (data/synthetic.py::make_room): the self-search at k = 16,
    W = 2048 with probes 1 and 2 on the morton and Hilbert curves, and
    the 1-NN upsample from the first n/4 points (the L1 subsample) at
    W = 1024. [(name, support, query, keywords)]."""
    from ssdr_al_torch.data.synthetic import make_room

    rng = np.random.RandomState(seed)
    xyz = torch.from_numpy(np.stack([
        make_room(rng, f"r{i}", num_points=n).xyz for i in range(b)])
        .astype(np.float32)).to(dev)
    calls = [(f"self k=16 W=2048 probes={p} {c}", xyz, xyz,
              dict(k=16, window=2048, probes=p, curve=c))
             for c in ("morton", "hilbert") for p in (1, 2)]
    sub = xyz[:, :n // 4].contiguous()
    calls.append(("upsample k=1 W=1024 probes=1 morton", sub, xyz,
                  dict(k=1, window=1024, probes=1, curve="morton")))
    return calls


def recall(got, exact):
    """Mean share of each row's exact neighbours [B, nq, k] that got
    [B, nq, k] holds."""
    hit = (got[..., :, None] == exact[..., None, :]).any(-1)
    return hit.float().mean().item()


def check_knn_window(name, support, query, kw, got, reps=5, plain_reps=1):
    """knn_window's result `got` of one call on the card, index for index
    against the same call with K1's plain version in the kernel's place
    (on the card); its time and the plain run's by CUDA events, the bound
    of its K1 work (both clouds read, the indices written; 9 operations a
    (query, window point) pair a probe) and its recall against K6's exact
    answer."""
    from ssdr_al_torch.ops import knn as kn

    kernel = kn.window_topk

    def plain(s, q, st, k, window, tq=kn.QUERY_TILE, mxu=None):
        mxu = kn.MXU_DISTANCE_DEFAULT if mxu is None else mxu
        return kn._window_topk_plain(s, q, st, k, window, tq, mxu)

    def run_plain():
        kn.window_topk = plain
        try:
            return kn.knn_window(support, query, **kw)
        finally:
            kn.window_topk = kernel

    want = run_plain()
    if not torch.equal(got, want):
        raise AssertionError(f"knn_window {name}: {(got != want).sum().item()}"
                             " indices differ from the plain version's")
    b, nq = query.shape[:2]
    k = kw["k"]
    bd = bound(nbytes(support, query, got),
               9 * b * nq * kw["window"] * kw["probes"])
    exact = kn.knn_tiled(support, query, k)
    return dict(shape=f"[{b}x{nq}] {name}", max_abs_err=0,
                ms=device_ms(lambda: kn.knn_window(support, query, **kw),
                             reps),
                plain_ms=device_ms(run_plain, plain_reps),
                bound_ms=bd[0], bound_by=bd[1],
                recall=recall(got, exact),
                exact_ms=device_ms(lambda: kn.knn_tiled(support, query, k),
                                   reps))


def _same_bits(a, b):
    """Bit for bit: bf16 tensors by their 16-bit patterns."""
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def check_k2(call, reps=20, plain_reps=5):
    """K2 at one recorded call: bitwise equal to its plain version (for a
    bf16 output, the f32 gather rounded to bf16) with the planned source
    and, where the slab fits, the other one; their times, the plain
    version's, torch.gather's (of the values cast to the output dtype
    beforehand) and the bound (the output at its dtype's size)."""
    from ssdr_al_torch.ops import gather as ga

    v, i, st = call["values"], call["idx"], call["starts"]
    w, tq = call["window"], call["tq"]
    b, n, c = v.shape
    nq, k = i.shape[1:]
    od = call.get("out_dtype", v.dtype)
    bf16 = od == torch.bfloat16
    dt = (od,) if bf16 else ()          # a tree without bf16 takes none
    name = (f"{call['path']} [{b},{nq},{k},{c}]{' bf16' if bf16 else ''} "
            f"W={w} tq={tq}")
    want = ga._gather_window_plain(v, i, st, w, tq, *dt)
    counter = "launches_bf16" if bf16 else "launches"
    before = getattr(ga.gather_window, counter)
    got = ga.gather_window(v, i, st, w, tq, *dt)
    if getattr(ga.gather_window, counter) != before + 1:
        raise AssertionError(f"K2 {name}: the kernel did not launch")
    if got.dtype != od or not _same_bits(got, want):
        raise AssertionError(f"K2 {name}: differs from the plain version")
    flat = i.long().reshape(b, -1, 1).expand(-1, -1, c)
    v_lib = v.to(od)
    bd = bound(nbytes(v, i, st, got), 0)
    out = dict(shape=name, dtype=str(od).split(".")[-1],
               max_abs_err=(got.float() - want.float()).abs().max().item(),
               ms=device_ms(lambda: ga.gather_window(v, i, st, w, tq, *dt),
                            reps),
               plain_ms=device_ms(lambda: ga._gather_window_plain(
                   v, i, st, w, tq, *dt), plain_reps),
               bound_ms=bd[0], bound_by=bd[1],
               library_ms=device_ms(lambda: torch.gather(v_lib, 1, flat),
                                    reps))
    if hasattr(ga, "gather_plan"):
        plan = ga.gather_plan(b, nq, k, c, w, tq,
                              **({"out_dtype": od} if bf16 else {}))
        out["plan"] = list(plan)
        if w * c * 4 <= SMEM_MAX:
            other = ga.gather_plan(b, nq, k, c, w, tq, slab=not plan[0],
                                   **({"out_dtype": od} if bf16 else {}))
            alt = ga._gather_window_launch(v, i, st, w, tq, other, *dt)
            if not _same_bits(alt, want):
                raise AssertionError(f"K2 {name} with plan {other}: differs "
                                     "from the plain version")
            out["other_plan"] = list(other)
            out["other_ms"] = device_ms(lambda: ga._gather_window_launch(
                v, i, st, w, tq, other, *dt), reps)
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
    version alike); K6's k=16 self-search and k=1 search in the same
    subset, on each of its routes; K2 bitwise equal on the same starts, indices outside
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
        for sup, k, what in ((x, 16, "self"), (sub, 1, "upsample")):
            want = kn._knn_tiled_plain(sup, x, k)
            # on every route of a tree whose wrapper has several
            for route in getattr(kn, "KNN_ROUTES", (None,)):
                got = kn.knn_tiled(sup, x, k) if route is None else \
                    kn.knn_tiled_stats(sup, x, k, route=route)[0]
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"K6 ties '{name}' k={k} {what} on route {route}: "
                        f"{(got != want).sum().item()} indices differ")
            done.append(f"{name} K6 k={k} {what}")
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


def check_main_path(cfg, dev, log=print, b_eval=8, b_train=6,
                    shape_free=True):
    """Record one forward's K1 and K2 calls [b_eval × cfg.num_points] (K5
    checked at every K1 call too), one `pallas` pyramid's K6 calls
    [b_eval × cfg.num_points] and one train-mode backward's K4 calls
    [b_train × cfg.num_points], check and time each, then (shape_free)
    the tie-heavy inputs and K3 at its two shapes, neither of which
    depends on cfg. Where the tree's K4 has a launch plan (the fixed-order
    design), every K4 call must equal the plain version and itself bit for
    bit. Returns {"window_topk": [...], "window_topk_mxu": [...],
    "knn_tiled": [...], "gather_window": [...], "scatter_window": [...],
    "chamfer_sums": [...], "ties": [...], "calls": (k1 calls, k2
    calls)}."""
    from ssdr_al_torch.ops import gather as ga

    k1_calls, k2_calls = record_main_path(cfg, dev, b=b_eval)
    k1, k5 = [], []
    for call in k1_calls:
        r = check_k1(call)
        k1.append(r)
        log(f"K1 {r['shape']}: equal, {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}, plan {r.get('plan')})")
        r5 = dict(check_k1(call, mxu=True), ms_k1=r["ms"])
        k5.append(r5)
        log(f"K5 {r5['shape']}: equal, {r5['ms']:.4f} ms (K1 "
            f"{r['ms']:.4f} ms, {r5['ms'] / r['ms']:.2f}x; plain "
            f"{r5['plain_ms']:.3f} ms)")
    k6 = []
    for call in record_exact_path(cfg, dev, b=b_eval):
        r = check_k6(call)
        k6.append(r)
        log(f"K6 {r['shape']}: equal, {r['ms']:.4f} ms on route "
            f"{r['route']} (plain {r['plain_ms']:.3f} ms, cdist+topk "
            f"{r['library_ms']:.3f} ms; bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}; operations of the pairs evaluated "
            f"{r['ops_ms_evaluated']:.4f} ms, of every pair "
            f"{r['bound_ms_all_pairs']:.4f} ms; pairs evaluated "
            f"{r['pairs']} = {100 * r['pair_share']:.3f} %)")
    log(f"K6 sum over the {len(k6)} calls of one exact pyramid: "
        f"{sum(r['ms'] for r in k6):.4f} ms (cdist+topk "
        f"{sum(r['library_ms'] for r in k6):.3f} ms)")
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
    ties = []
    if shape_free:
        ties = check_ties(dev)
        log(f"tie-heavy inputs, equal to the plain versions: {ties}")
    k4, k1_rows = [], []
    strict = hasattr(ga, "scatter_plan")
    for call in record_train_backward(cfg, dev, b=b_train):
        r = check_k4(call)
        k4.append(r)
        log(k4_line(r))
        if strict and not k4_ok(r):
            raise AssertionError(f"K4 {r['shape']}: not bitwise equal to "
                                 "the plain version and to itself")
        if call["g"].shape[2] == 1 and hasattr(ga, "WindowTranspose"):
            k1_rows.append(check_rows_k1(call))
            log(k1_rows_line(k1_rows[-1]))
    step, unshared, bd = k4_step(k4)
    log(f"K4 over the {len(k4)} calls of one train step: {step:.4f} ms as "
        f"the step runs them ({unshared:.4f} ms with a transpose each; "
        f"index_add_ {sum(r['library_ms'] for r in k4):.4f} ms, bound "
        f"{bd:.4f} ms)")
    k3 = []
    for name, call in ((("fixed", fixed_chamfer_call(dev)),
                        ("selection", selection_chamfer_call(dev)))
                       if shape_free else ()):
        r = check_k3(*call, name)
        k3.append(r)
        log(f"K3 {r['shape']}: max rel err {r['max_rel_err']:.2e}, run to "
            f"run {r['run_to_run']}, {r['ms']:.3f} ms (plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}; every ordered pair at 9 operations "
            f"{r['bound_ms_ordered']:.4f} ms)")
        if not r["run_to_run"]:
            raise AssertionError(f"K3 {r['shape']}: two launches differ")
    return {"window_topk": k1, "window_topk_mxu": k5, "knn_tiled": k6,
            "gather_window": k2, "scatter_window": k4, "chamfer_sums": k3,
            "scatter_rows_k1": k1_rows, "ties": ties,
            "calls": (k1_calls, k2_calls)}


def check_rows_k1(call, reps=20):
    """A k = 1 K4 call (a windowed upsample's backward) with its
    cotangent cast to bf16: K4-bf16 against scatter_rows, the row gather's
    fixed-order backward that the bf16 model's upsamples take
    (models/randlanet.py::nearest_interpolation through
    gather_rows_fixed), on the same rows (no index clamped: the window
    holds them), both bitwise equal to index_add_ of g.float() on the CPU;
    their times and index_add_'s on the card."""
    from ssdr_al_torch.ops import gather as ga

    g, i, st = call["g"], call["idx"], call["starts"]
    n, w, tq = call["n"], call["window"], call["tq"]
    b, nq, _, c = g.shape
    g16 = g.to(torch.bfloat16)
    flat = g16.reshape(b, nq, c)
    rows = ga.scatter_rows(flat, i.reshape(b, nq), n)
    k4 = ga.scatter_window(g16, i, st, n, w, tq)
    flat_i = (i.long() + (torch.arange(b, device=i.device) * n)[:, None,
                                                                 None]
              ).reshape(-1)
    # the CPU's index_add_: in index order (the card's adds with atomics)
    want = torch.zeros(b * n, c).index_add_(
        0, flat_i.cpu(), flat.reshape(-1, c).float().cpu())
    lo = torch.repeat_interleave(torch.clamp(st, 0, n - w), tq, 1)[..., None]
    inside = bool(((i >= lo) & (i < lo + w)).all())
    bd = bound(nbytes(g16, i, rows), 0)
    return dict(shape=f"[{b},{nq},1,{c}] bf16 -> [{b},{n},{c}] W={w}",
                all_in_window=inside,
                k4_bitwise=torch.equal(k4.reshape(-1, c).cpu(), want),
                rows_bitwise=torch.equal(rows.reshape(-1, c).cpu(), want),
                k4_ms=device_ms(lambda: ga.scatter_window(g16, i, st, n, w,
                                                          tq), reps),
                rows_ms=device_ms(lambda: ga.scatter_rows(
                    flat, i.reshape(b, nq), n), reps),
                library_ms=device_ms(lambda: torch.zeros(
                    b * n, c, device=g.device).index_add_(
                    0, flat_i, flat.reshape(-1, c).float()), reps),
                bound_ms=bd[0])


def k1_rows_line(r) -> str:
    return (f"k = 1 bf16 {r['shape']}: K4 {r['k4_ms']:.4f} ms, scatter_rows "
            f"{r['rows_ms']:.4f} ms, index_add_ {r['library_ms']:.4f} ms "
            f"(bound {r['bound_ms']:.4f}); both bitwise equal to index_add_ "
            f"of g.float() {r['k4_bitwise']} / {r['rows_bitwise']}, every "
            f"index in its window {r['all_in_window']}")


def check_bf16_path(cfg, dev, b_eval=8, b_train=6, b_flagship=2):
    """K2-bf16 at every K2 call of one forward of the bf16 model [b_eval ×
    cfg.num_points] (unless b_eval is None) and K4-bf16 at every K4 call of
    one train-mode
    backward [b_train × cfg.num_points] and, unless b_flagship is None, of
    one at the flagship run's batch [b_flagship × cfg.num_points]
    (scripts/flagship.py: 500 replays a round), each checked and timed as
    check_k2 / check_k4 do, bitwise and run to run. Returns
    {"gather_window_bf16": [...], "scatter_window_bf16": [...],
    "scatter_window_bf16_flagship": [...]}."""
    import dataclasses

    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    k2_calls = [] if b_eval is None else \
        record_main_path(cfg16, dev, b=b_eval)[1]
    k2 = []
    for call in k2_calls:
        if call["out_dtype"] != torch.bfloat16:
            raise AssertionError(f"the bf16 forward made an f32 K2 call "
                                 f"{tuple(call['values'].shape)}")
        r = check_k2(call)
        k2.append(r)
        alt = (f", other source {r['other_plan']}: equal, "
               f"{r['other_ms']:.4f} ms") if "other_ms" in r else ""
        print(f"K2 {r['shape']}: bitwise equal, {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.3f} ms, torch.gather bf16 "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}, plan {r.get('plan')}{alt})")
    out = {"gather_window_bf16": k2}
    for key, b in (("scatter_window_bf16", b_train),
                   ("scatter_window_bf16_flagship", b_flagship)):
        if b is None:
            continue
        k4 = out[key] = []
        for call in record_train_backward(cfg16, dev, b=b):
            if call["g"].dtype != torch.bfloat16:
                raise AssertionError("the bf16 backward made an f32 K4 call")
            r = check_k4(call)
            k4.append(r)
            print(k4_line(r))
            if not k4_ok(r):
                raise AssertionError(f"K4 {r['shape']}: not bitwise equal "
                                     "to the plain version and to itself")
        step, unshared, bd = k4_step(k4)
        print(f"bf16 [{b} x {cfg.num_points}]: {len(k4)} K4 calls "
              f"{step:.4f} ms as the step runs them ({unshared:.4f} ms with "
              f"a transpose each; index_add_ "
              f"{sum(r['library_ms'] for r in k4):.4f} ms, bound "
              f"{bd:.4f} ms)")
    print(f"bf16: {len(k2)} K2 calls {sum(r['ms'] for r in k2):.4f} ms "
          f"(torch.gather {sum(r['library_ms'] for r in k2):.4f} ms)")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="root of the ssdr_al_torch tree to "
                    "measure (default: the one holding this file)")
    ap.add_argument("--out", help="also write the JSON results here")
    ap.add_argument("--dataset", default="S3DIS",
                    choices=["S3DIS", "Semantic3D", "SemanticKITTI"],
                    help="the width of the recorded calls: S3DIS (B=8 and "
                         "6 × 40960, with the tie inputs and K3), "
                         "Semantic3D (B=4 × 65536) or SemanticKITTI (B=6 "
                         "× 45056, 4 layers), these two K1, K2 and K4 "
                         "only, f32 and bf16")
    ap.add_argument("--k4-only", action="store_true",
                    help="only K4 at every call of one f32 and one bf16 "
                         "train step (and the bf16 one at the flagship's "
                         "batch at S3DIS width)")
    ap.add_argument("--k4-routes", action="store_true",
                    help="only K4's routes (single-use, batch-plan and "
                         "tile-plan transposes, the sum alone) at every "
                         "call of one f32 train step of each dataset's "
                         "width, and of one bf16 step at S3DIS width and "
                         "at the flagship's batch, two turns each")
    ap.add_argument("--k1-only", action="store_true",
                    help="only K1 and K5 at every K1 call of one forward "
                         "[8, 6 and 2 x 40960] (at the dataset's batch "
                         "for Semantic3D and SemanticKITTI) with the "
                         "counter build's figures beside the twin's")
    ap.add_argument("--k6-only", action="store_true",
                    help="only K6 at every call of one exact pyramid and "
                         "at the partition's call (k = 46) over subsets of "
                         "a prepared room, the room and a flagship room, "
                         "on each of its routes, after the flagship "
                         "rooms' knn_ms")
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
    from ssdr_al_torch import config
    from ssdr_al_torch.kernels import build

    build.library()
    dev = torch.device("cuda", 0)
    if args.k4_only:
        cfg = config.get_config(args.dataset)
        b = 6 if args.dataset == "S3DIS" else cfg.batch_size
        res = {"scatter_window": []}
        for call in record_train_backward(cfg, dev, b=b):
            res["scatter_window"].append(check_k4(call))
            print(k4_line(res["scatter_window"][-1]))
        step, unshared, bd = k4_step(res["scatter_window"])
        print(f"K4 over the {len(res['scatter_window'])} calls of one train "
              f"step: {step:.4f} ms as the step runs them ({unshared:.4f} ms "
              f"with a transpose each; bound {bd:.4f} ms)")
        res.update(check_bf16_path(
            cfg, dev, b_eval=None, b_train=b,
            b_flagship=2 if args.dataset == "S3DIS" else None))
        res["calls"] = None
    elif args.k4_routes:
        import dataclasses

        res = {"k4_routes": []}
        cases = [(config.get_config(d), None) for d in
                 ("S3DIS", "Semantic3D", "SemanticKITTI")]
        cases += [(dataclasses.replace(config.ConfigS3DIS,
                                       compute_dtype="bfloat16"), b)
                  for b in (6, 2)]
        for cfg, b in cases:
            b = b or (6 if cfg.name == "S3DIS" else cfg.batch_size)
            print(f"{cfg.name} {cfg.compute_dtype} [{b} x {cfg.num_points}]")
            for call in record_train_backward(cfg, dev, b=b):
                r = k4_routes(call)
                r["case"] = f"{cfg.name} {cfg.compute_dtype} b={b}"
                res["k4_routes"].append(r)
                print(k4_routes_line(r))
                if not r["bitwise"]:
                    raise AssertionError(f"K4 {r['shape']}: a route is not "
                                         "bitwise equal to the plain version")
        res["calls"] = None
    elif args.k1_only:
        cfg = config.get_config(args.dataset)
        res = {"k1": check_k1_only(
            cfg, dev, (8, 6, 2) if args.dataset == "S3DIS"
            else (cfg.batch_size,))}
        res["calls"] = None
    elif args.k6_only:
        cfg = config.get_config(args.dataset)
        res = {"knn_tiled": []}
        rooms = flagship_rooms()
        res["flagship_knn_ms"] = flagship_knn_ms(dev, rooms)
        print("knn_ms of the flagship's rooms as cli.superpoint times them "
              "(room 0 cold): " + json.dumps(
                  [round(t, 4) for t in res["flagship_knn_ms"]]))
        calls = record_exact_path(cfg, dev, b=8 if args.dataset == "S3DIS"
                                  else cfg.batch_size)
        for call in calls + k64_calls(dev, rooms[0]):
            r = check_k6(call)
            r.update(k6_routes(call))
            res["knn_tiled"].append(r)
            print(k6_line(r))
        res["calls"] = None
    elif args.dataset == "S3DIS":
        res = check_main_path(config.ConfigS3DIS, dev)
        res.update(check_bf16_path(config.ConfigS3DIS, dev))
    else:
        cfg = config.get_config(args.dataset)
        res = check_main_path(cfg, dev, b_eval=cfg.batch_size,
                              b_train=cfg.batch_size, shape_free=False)
        res.update(check_bf16_path(cfg, dev, b_eval=cfg.batch_size,
                                   b_train=cfg.batch_size, b_flagship=None))
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
