"""A numpy twin of K1's walk (csrc/window_topk.cu, `window_topk_kernel<K,
false>` at K = 1 and 16) that replays what each warp does and counts it.

    python3 ssdr_al_torch/kernels/k1_twin.py [--tiles N] [--b 8,2]

Each CUDA thread is a lane of the twin: `split` lanes walk one query of a
tile (lane s the groups of four candidates g = s mod split), 32 lanes a
warp, in the launch plan's CTAs (ops/knn.py::window_topk_plan). Every warp
takes the same steps at once, masked where it skips. The walk (POLICIES):

- "parent": the first redesign's walk: the blocks in a spiral from the
  block of the warp's middle query that wraps round the window, each
  tested against every lane's k-th best, its groups filtered, the keys
  under a lane's k-th best buffered, 24 a lane, and all inserted by the
  whole warp when some lane holds more than 15 after a pair of groups
  (`flush`: as many rounds as its busiest lane has keys).
- "new": csrc/window_topk.cu's walk: the same, but a flush inserts the
  lanes' newest keys in 8 rounds (more where a lane would keep more than
  15), so that lanes whose keys come at other times share rounds (the
  kernel merges them 8 at a time by a network, the same keys).
- the candidates the counters turned down, each "new" with one change:
  "every_block" (a flush after every block the warp visits, so the k-th
  best tightens block by block), "supers" (the blocks by super-blocks of
  8 in a spiral without wrap, a super-block's blocks only where its box
  is within some lane's k-th best), "nearest_box" (the blocks in chunks
  of 64 nearest box first by the least d² from the warp's query box, a
  chunk ending at the first box past every lane's k-th best) and
  "own_fill" (on a self-search each lane's list filled from the 16
  candidates round its own rank, which it then skips).

Every walk keeps the k least (d², window rank) keys whatever the order,
so each equals ops/knn.py::_window_topk_plain index for index; the
counters say what each costs: box tests, blocks visited, groups a warp
visits and passes in some lane, keys buffered and kept, flushes and
insertion rounds (a warp's round costs one insertion whatever its
lanes hold), and the
blocks a lone query needs (those whose box_lb is at or under its final
k-th d²). `main` prints them at every K1 call of the [b × 40960]
forwards on sampled tiles; tests/test_torch_knn_walk.py holds the twin
against the plain version, and `kernels/measure.py --k1-only` the counter
build on the card (ops/knn.py::window_topk_stats) against the twin.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

F32 = np.float32
EMPTY = np.uint64(0x7F800000) << np.uint64(32)   # (+inf, rank 0)
LOW = np.uint64(0xFFFFFFFF)
SUPER = 8            # blocks of a super-block in the new walk

POLICIES = {
    "parent": dict(buf=24, spill=15),
    "new": dict(buf=24, spill=15, drain=8),
    "every_block": dict(buf=24, spill=15, drain=8, block_flush=True),
    "supers": dict(buf=24, spill=15, drain=8, supers=True),
    "nearest_box": dict(buf=24, spill=15, drain=8, nearest_box=True),
    "own_fill": dict(buf=24, spill=15, drain=8, own_fill=True),
}
COUNTERS = ("box_tests", "blocks_visited", "lone_blocks", "warp_groups",
            "warp_groups_passed", "groups", "groups_passed", "keys_buffered",
            "keys_kept", "flushes", "insert_rounds", "warps", "queries")


def keys(d2, ranks):
    """(d² bits, sign cleared) above the window rank, as make_key."""
    return ((d2.view(np.uint32) & np.uint32(0x7FFFFFFF)).astype(np.uint64)
            << np.uint64(32)) | ranks.astype(np.uint64)


def key_d2(key):
    return (key >> np.uint64(32)).astype(np.uint32).view(F32)


def sq_dist(q, s):
    """(dx·dx + dy·dy) + dz·dz in float32 (key_topk.cuh::sq_dist)."""
    d = (q - s).astype(F32)
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(F32)


def fma_d2(q, s):
    """dx·dx + (dy·dy + dz·dz) in FMA form (visit_group's filter)."""
    d = (q - s).astype(F32)
    return _fma(d[..., 0], d[..., 0],
                _fma(d[..., 1], d[..., 1], d[..., 2] * d[..., 2]))


def filter_bound(t):
    """key_topk.cuh::filter_bound: fma(t, 1 + 2^-20, 2^-126)."""
    return _fma(t, np.full_like(t, 1 + 2.0 ** -20),
                np.full_like(t, 2.0 ** -126))


def box_lb(lo, hi, q):
    """key_topk.cuh::box_lb, rounded to nearest at every step."""
    e = np.maximum(np.maximum(lo - q, q - hi), F32(0.0))
    return (e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]) \
        + e[..., 2] * e[..., 2]


def spiral(t, c0, n):
    """The t-th of [0, n) in spiral order from c0: c0, c0 - 1, c0 + 1,
    c0 - 2, ..., then the longer side on its own (no wrap)."""
    below, above = c0, n - 1 - c0
    m = np.minimum(below, above)
    near = np.where(t & 1, c0 - ((t + 1) >> 1), c0 + (t >> 1))
    far = np.where(above > below, c0 + (t - m), c0 - (t - m))
    return np.where(t <= 2 * m, near, far)


def wrap_spiral(t, c0, n):
    """The parent's spiral: c0, c0 - 1, c0 + 1, c0 - 2, ... mod n."""
    return np.where(t & 1, c0 - ((t + 1) >> 1), c0 + (t >> 1)) % n


def walk(support, queries, starts, k, window, tq, plan, self_search,
         policy="new", tiles=None):
    """K1 at one call, [B, ns, 3] / [B, nq, 3] float32 and starts [B, T]
    (numpy), through the twin of `policy`'s walk with `plan` (split,
    queries per CTA, threads). tiles: the (b, t) pairs to walk (all by
    default). Returns (out [B, nq, k] int64 window ranks, -1 in rows not
    walked; {counter: sum over the walked warps})."""
    pol = POLICIES[policy] if isinstance(policy, str) else policy
    split, qpc, threads = plan
    b_all, ns, _ = support.shape
    nq = queries.shape[1]
    w = window
    if tiles is None:
        tiles = [(b, t) for b in range(b_all) for t in range(nq // tq)]
    tiles = np.asarray(tiles, np.int64).reshape(-1, 2)
    nt = len(tiles)
    wpad = -(-w // (4 * split)) * 4 * split
    sgroups = wpad // (4 * split)
    nblk = -(-sgroups // 8)
    nsup = -(-nblk // SUPER)

    # the staged windows (pads NaN) and each block's box over its real
    # candidates
    st = np.clip(starts[tiles[:, 0], tiles[:, 1]], 0, ns - w)
    win = np.full((nt, wpad, 3), np.nan, F32)
    for i, (b, _) in enumerate(tiles):
        win[i, :w] = support[b, st[i]:st[i] + w]
    per = 32 * split
    blocks = np.full((nt, nblk * per, 3), np.nan, F32)
    blocks[:, :wpad] = win
    blocks = blocks.reshape(nt, nblk, per, 3)
    with np.errstate(invalid="ignore"), \
            np.testing.suppress_warnings() as sup:
        sup.filter(RuntimeWarning)
        blo, bhi = np.nanmin(blocks, 2), np.nanmax(blocks, 2)
        slo = np.stack([np.nanmin(blo[:, i * SUPER:(i + 1) * SUPER], 1)
                        for i in range(nsup)], 1)
        shi = np.stack([np.nanmax(bhi[:, i * SUPER:(i + 1) * SUPER], 1)
                        for i in range(nsup)], 1)

    # the lanes: every thread of every CTA of every tile walked
    parts = -(-tq // qpc)
    tid = np.arange(threads)
    s_of, qi = tid & (split - 1), tid // split
    lane_tile = np.repeat(np.arange(nt), parts * threads)
    part = np.tile(np.repeat(np.arange(parts), threads), nt)
    s_l = np.tile(s_of, nt * parts)
    qt = part * qpc + np.tile(qi, nt * parts)
    live = (np.tile(qi, nt * parts) < qpc) & (qt < tq)
    qrow = tiles[lane_tile, 1] * tq + np.minimum(qt, tq - 1)
    qxyz = queries[tiles[lane_tile, 0], qrow]
    nl = len(lane_tile)
    nw = nl // 32
    warp = np.arange(nl) // 32
    lane = np.arange(nl) & 31
    wt = lane_tile[::32]                    # each warp's tile

    # where each warp starts: lane 16's window rank (self-search) or the
    # nearest of 32 samples of the window to lane 16's query
    q16 = np.arange(nw) * 32 + 16
    if self_search:
        p0 = np.clip(qrow[q16] - st[wt], 0, w - 1)
    else:
        pr = (np.arange(32) * w) >> 5
        sk = keys(sq_dist(qxyz[q16][:, None], win[wt][:, pr]),
                  np.broadcast_to(pr, (nw, 32)))
        p0 = (sk.min(1) & LOW).astype(np.int64)
    jb0 = np.minimum(((p0 >> 2) // split) >> 3, nblk - 1)

    c = {name: 0 for name in COUNTERS}
    c["warps"], c["queries"] = nw, int((live & (s_l == 0)).sum())
    bk = np.full((nl, k), EMPTY, np.uint64)
    thr = np.full(nl, EMPTY, np.uint64)
    buf = np.zeros((nl, pol["buf"]), np.uint64)
    cnt = np.zeros(nl, np.int64)

    def set_thr(lanes_on):
        m = bk[:, k - 1].reshape(-1, split).min(1).repeat(split)
        thr[lanes_on] = m[lanes_on]

    def flush(warps_on, every=False):
        """The warps of `warps_on` insert their lanes' buffers: every key
        (the parent, and the last flush), or else (drain) the newest keys
        in `drain` rounds, more where a lane would keep more than
        `spill`."""
        on = warps_on[warp]
        if not on.any():
            return
        most = cnt.reshape(nw, 32).max(1)
        rounds = most if every or "drain" not in pol else np.maximum(
            np.minimum(most, pol["drain"]), most - pol["spill"])
        c["flushes"] += int(warps_on.sum())
        c["insert_rounds"] += int(rounds[warps_on].sum())
        for i in range(int(rounds[warps_on].max(initial=0))):
            sel = on & (i < cnt) & (i < rounds[warp])
            key = buf[sel, cnt[sel] - 1 - i]
            ins = key < bk[sel, k - 1]
            c["keys_kept"] += int(ins.sum())
            rows = np.flatnonzero(sel)[ins]
            bk[rows] = np.sort(np.concatenate(
                [bk[rows, :k - 1], key[ins, None]], 1), 1)
        cnt[on] -= np.minimum(cnt, rounds[warp])[on]
        set_thr(on)

    def group_cands(j):
        """[nl, 4] window ranks of group j·split + s of each lane."""
        g = j * split + s_l
        return 4 * g[:, None] + np.arange(4)

    own = np.full(nl, -10, np.int64)     # a lane's own fill (own_fill)

    def visit(j, on):
        """Each lane of `on` visits its group of super-group j [nl]."""
        on = on & ((j < own) | (j >= own + k // 4))
        ranks = group_cands(np.where(on, j, 0))
        pts = win[lane_tile[:, None], ranks]
        with np.errstate(invalid="ignore"):
            fa = np.fmin.reduce(fma_d2(qxyz[:, None], pts), axis=1)
            thr_f = filter_bound(key_d2(thr))
            passed = on & (fa <= thr_f)
        c["groups"] += int(on.sum())
        c["groups_passed"] += int(passed.sum())
        c["warp_groups"] += int(on.reshape(nw, 32).any(1).sum())
        c["warp_groups_passed"] += int(passed.reshape(nw, 32).any(1).sum())
        with np.errstate(invalid="ignore"):
            kk = keys(sq_dist(qxyz[:, None], pts), ranks)
        for ci in range(4):
            take = passed & (kk[:, ci] < thr)
            c["keys_buffered"] += int(take.sum())
            if k == 1:
                bk[take, 0] = kk[take, ci]
                thr[take] = kk[take, ci]
                c["keys_kept"] += int(take.sum())
            else:
                buf[take, cnt[take]] = kk[take, ci]
                cnt[take] += 1

    # the fill: the first k candidates of jb0's block at once (k = 16)
    first = np.zeros(nw, np.int64)
    if k % 8 == 0 and pol.get("own_fill") and self_search and \
            sgroups >= k // 4:
        r = np.clip(qrow - st[lane_tile], 0, w - 1)
        own[:] = np.clip(((r >> 2) // split) - k // 8, 0, sgroups - k // 4)
        cand = np.concatenate([group_cands(own + m) for m in range(k // 4)],
                              1)
        pts = win[lane_tile[:, None], cand]
        with np.errstate(invalid="ignore"):
            bk[:] = np.sort(keys(sq_dist(qxyz[:, None], pts), cand), 1)
        set_thr(np.ones(nl, bool))
    elif k % 8 == 0:
        filled = jb0 * 8 + k // 4 <= sgroups
        fl = filled[warp]
        cand = np.concatenate([group_cands(jb0[warp] * 8 + m)
                               for m in range(k // 4)], 1)
        pts = win[lane_tile[:, None], cand]
        with np.errstate(invalid="ignore"):
            kk = np.sort(keys(sq_dist(qxyz[:, None], pts), cand), 1)
        bk[fl] = kk[fl]
        set_thr(fl)
        first[filled] = k // 4
        c["flushes"] += int(filled.sum())     # the kernel's fill flushes

    # the order of the walk: [nw, slots] blocks (-1: none) and, for the
    # new walk, the super-block tested at the first slot of every 8
    if pol.get("supers"):
        sb0 = jb0 // SUPER
        order, sup_at = [], []
        for t in range(nsup):
            sb = spiral(np.full(nw, t), sb0, nsup)
            lo_b = sb * SUPER
            n_in = np.minimum(lo_b + SUPER, nblk) - lo_b
            piv = np.clip(jb0, lo_b, lo_b + n_in - 1) - lo_b
            for u in range(SUPER):
                order.append(np.where(u < n_in,
                                      lo_b + spiral(np.full(nw, u), piv,
                                                    np.maximum(n_in, 1)),
                                      -1))
                sup_at.append(sb if u == 0 else None)
    else:
        order = [wrap_spiral(np.full(nw, t), jb0, nblk) for t in range(nblk)]
        sup_at = [None] * nblk
    if pol.get("nearest_box"):
        # chunks of 64 blocks in spiral order from jb0's, each nearest
        # box first by the least d² from the warp's query box (a lower
        # bound of every lane's box_lb), ending at the first box past
        # every lane's k-th best
        qb = qxyz.reshape(nw, 32, 3)
        qlo, qhi = qb.min(1), qb.max(1)
        nch = -(-nblk // 64)
        order, sup_at, lbw = [], [], []
        for t in range(nch):
            ch = spiral(np.full(nw, t), jb0 // 64, nch)
            blks = ch[:, None] * 64 + np.arange(64)
            ok = blks < nblk
            bc = np.minimum(blks, nblk - 1)
            e = np.maximum(np.maximum(blo[wt[:, None], bc] - qhi[:, None],
                                      qlo[:, None] - bhi[wt[:, None], bc]),
                           F32(0.0))
            lbb = (e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]) \
                + e[..., 2] * e[..., 2]
            kb = np.where(ok, keys(lbb, blks), np.uint64(2 ** 64 - 1))
            kb = np.sort(kb, 1)
            c["box_tests"] += nw * -(-int(ok[0].sum()) // 32)
            for u in range(64):
                real = kb[:, u] != np.uint64(2 ** 64 - 1)
                order.append(np.where(real, (kb[:, u] & LOW).astype(
                    np.int64), -1))
                lbw.append(key_d2(kb[:, u]))
                sup_at.append(None)
    enter = np.ones(nw, bool)
    for i, (blk, sb) in enumerate(zip(order, sup_at)):
        if pol.get("nearest_box"):
            if i % 64 == 0:
                enter = np.ones(nw, bool)
            with np.errstate(invalid="ignore"):
                enter &= ~(lbw[i][:, None] >
                           key_d2(thr).reshape(nw, 32)).all(1)
        if sb is not None:
            c["box_tests"] += nw
            lb = box_lb(slo[wt, sb][:, None], shi[wt, sb][:, None],
                        qxyz.reshape(nw, 32, 3))
            with np.errstate(invalid="ignore"):
                enter = ~(lb > key_d2(thr).reshape(nw, 32)).all(1)
        real = enter & (blk >= 0)
        c["box_tests"] += int(real.sum())
        bc = np.maximum(blk, 0)
        lb = box_lb(blo[wt, bc][:, None], bhi[wt, bc][:, None],
                    qxyz.reshape(nw, 32, 3))
        with np.errstate(invalid="ignore"):
            go = real & ~(lb > key_d2(thr).reshape(nw, 32)).all(1)
        c["blocks_visited"] += int(go.sum())
        j0 = bc * 8 + np.where(bc == jb0, first, 0)
        j_end = np.minimum(bc * 8 + 8, sgroups)
        for jo in range(0, 8, 2):
            for jj in (jo, jo + 1):
                j = bc * 8 + jj
                on = go & (j >= j0) & (j < j_end)
                if on.any():
                    visit(j[warp], on[warp])
            if k > 1:
                full = (cnt > pol["spill"]).reshape(nw, 32).any(1)
                flush(go & full)
        if k > 1 and pol.get("block_flush"):
            flush(go)
    if k > 1:
        flush(np.ones(nw, bool), every=True)

    # the lists of a query's split lanes merged; the lone query's blocks
    fin = np.sort(bk.reshape(-1, split * k), 1)[:, :k]
    kth = key_d2(fin[:, k - 1])
    head = (s_l == 0) & live
    qlanes = np.flatnonzero(head)
    lb = box_lb(blo[lane_tile[qlanes]], bhi[lane_tile[qlanes]],
                qxyz[qlanes][:, None])
    with np.errstate(invalid="ignore"):
        c["lone_blocks"] = int((~(lb > kth[qlanes // split, None])).sum())
    out = np.full((b_all, nq, k), -1, np.int64)
    out[tiles[lane_tile[qlanes], 0], qrow[qlanes]] = \
        (fin[qlanes // split] & LOW).astype(np.int64)
    return out, c


def pyramid_calls(b, n=40960, seed=0, ratios=(4, 4, 4, 4, 2), search=2048):
    """The K1 calls of one [b × n] forward of the sorted pyramid
    (models/randlanet.py::_pyramid_sorted) on measure.py's cloud
    (rng.rand(b, n, 3) · 6 from `seed`), built on the CPU with the port's
    own sort: [(name, support, queries, starts, k, window, self)] numpy."""
    import torch

    from ssdr_al_torch.ops import knn as kn

    rng = np.random.RandomState(seed)
    xyz = torch.from_numpy((rng.rand(b, n, 3) * 6).astype(F32))
    lo, hi = xyz.amin(1, keepdim=True), xyz.amax(1, keepdim=True)
    _, order, cur_x = kn.sort_by_codes(kn.morton_codes(xyz, lo, hi), xyz)
    cur_r, calls, tq = order, [], kn.QUERY_TILE
    for r in ratios:
        m = cur_x.shape[1]
        m_sub = m // r
        if m > 4096:
            w = (search if m > 16384 else search // 2) - 256
        elif m >= 2048:
            w = m
        else:
            break
        st = kn.self_query_starts(m, m, w).expand(b, -1)
        calls.append((f"L{len(calls) // 2} self [{b}x{m}] k=16 W={w}",
                      cur_x, cur_x, st, 16, w, True))
        kept = cur_r < m_sub
        ar = torch.arange(m, dtype=torch.int32).expand(b, m)
        kept_pos = torch.sort(torch.where(kept, ar, m), 1).values[:, :m_sub]
        nxt_x = torch.gather(cur_x, 1, kept_pos.long()[..., None]
                             .expand(-1, -1, 3))
        nxt_r = torch.gather(cur_r, 1, kept_pos.long())
        if m_sub > 2048:
            ranks = torch.cumsum(kept.int(), 1) - 1
            centers = torch.arange(m // tq) * tq + tq // 2
            su = torch.clamp(ranks[:, centers] - 512, 0, m_sub - 1024)
            su = (su // 128) * 128
            calls.append((f"L{len(calls) // 2} upsample [{b}x{m}] from "
                          f"{m_sub} k=1 W=1024", nxt_x, cur_x, su, 1, 1024,
                          False))
        cur_x, cur_r = nxt_x.contiguous(), nxt_r
    return [(name, np.ascontiguousarray(s.numpy()),
             np.ascontiguousarray(q.numpy()),
             np.ascontiguousarray(st.numpy()).astype(np.int64), k, w, self_)
            for name, s, q, st, k, w, self_ in calls]


def main() -> int:
    from ssdr_al_torch.ops import knn as kn

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiles", type=int, default=12,
                    help="query tiles walked a call, drawn from a seed")
    ap.add_argument("--b", default="8,2", help="batch sizes of the forwards")
    args = ap.parse_args()
    res = []
    for b in map(int, args.b.split(",")):
        for name, s, q, st, k, w, self_ in pyramid_calls(b):
            rng = np.random.RandomState(1)
            nt = q.shape[1] // kn.QUERY_TILE
            pick = rng.choice(b * nt, min(args.tiles, b * nt), replace=False)
            tiles = np.stack([pick // nt, pick % nt], 1)
            plan = kn.window_topk_plan(b, q.shape[1], w, kn.QUERY_TILE)
            for pol in POLICIES:
                _, cn = walk(s, q, st, k, w, kn.QUERY_TILE, plan, self_, pol,
                             tiles)
                row = dict(call=name, policy=pol, plan=list(plan), **cn)
                res.append(row)
                nw, nqr = cn["warps"], cn["queries"]
                print(f"{name} {pol}: a warp tests {cn['box_tests'] / nw:.1f}"
                      f" boxes, visits {cn['blocks_visited'] / nw:.2f} "
                      f"blocks (a lone query needs "
                      f"{cn['lone_blocks'] / nqr:.2f}), "
                      f"{cn['warp_groups'] / nw:.1f} groups "
                      f"({cn['warp_groups_passed'] / nw:.1f} past the "
                      f"filter in some lane), a query buffers "
                      f"{cn['keys_buffered'] / nqr:.2f} keys and keeps "
                      f"{cn['keys_kept'] / nqr:.2f}; a warp "
                      f"{cn['flushes'] / nw:.2f} flushes, "
                      f"{cn['insert_rounds'] / nw:.1f} insertion rounds",
                      flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
