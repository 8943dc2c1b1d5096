"""What the redesigned K4 and K3 kernels rely on, checked on the CPU.

- K4 (csrc/scatter_window.cu) bins the in-window entries (q, j) by their
  dv row: each tile sorts its entries by row, claims a run of slots in
  each row's bin with an atomic and writes its entry ids there in no
  fixed order, past the bin into an overflow list; each row's group sorts
  its ids and adds them in ascending (q, j) order. A numpy twin of those steps, with the atomics' order drawn
  at random, must give every in-window (q, j) exactly one row, in (q, j)
  order, and the plain version's index_add_ bit for bit.
- `scatter_plan` is a pure function of the shapes, inside the kernel's
  limits at every main-path call.
- K3 (csrc/chamfer_sums.cu) hands out the unordered pairs as tasks
  (rows x and S − 1 − x folded) and computes each pair's distances once
  for both directions: a twin of the task → pair map covers every ordered
  pair once, and a numpy twin of a warp's
  pass (±inf padding, the 32 × 32 transpose-reduction of minima) equals
  the plain sums.
"""

import numpy as np
import pytest
import torch

from ssdr_al_torch.ops import chamfer as tc
from ssdr_al_torch.ops import gather as tg

torch.set_num_threads(1)

F32 = np.float32

# (n, nq, k, c, window, tq) of the 9 K4 calls of one train step: the
# backward of the LFA gathers (L0-L2) and of the pool gathers
K4_MAIN = [(40960, 40960, 16, 11, 2048, 512), (40960, 40960, 16, 8, 2048, 512),
           (10240, 10240, 16, 35, 1024, 512), (10240, 10240, 16, 32, 1024, 512),
           (2560, 2560, 16, 67, 2560, 512), (2560, 2560, 16, 64, 2560, 512),
           (40960, 10240, 16, 32, 4096, 128), (10240, 2560, 16, 128, 3072, 128),
           (2560, 640, 16, 256, 2560, 128)]

LIST_CAP = 48      # slots of a row's bin in K4, sorted in shared memory


@pytest.mark.parametrize("n,nq,k,c,window,tq", K4_MAIN)
def test_scatter_plan_at_main_path_shapes(n, nq, k, c, window, tq):
    """A power-of-2 group of 2 to 32 lanes per row: float4 rows covered
    in one pass, float rows by 4 lanes up to 16 channels and 32 above;
    every main-path tile sorted in shared memory within the card's 227 KB
    (2 × window + 2 × entries ints), the sum kernel's sorting lists within
    48 KB, and the bin as wide as the kernel's."""
    b = 6
    group, hist = tg.scatter_plan(b, n, nq, k, c, window, tq)
    assert group in (2, 4, 8, 16, 32)
    if c % 4 == 0:
        assert group == min(max(c // 4, 2), 32)
    else:
        assert group == (4 if c <= 16 else 32)
    assert hist and (2 * window + 2 * tq * k) * 4 <= 227 * 1024
    threads = 128 if group < 4 else 256
    assert (threads // group) * (2 * LIST_CAP + 1) * 4 <= 48 * 1024
    assert tg.SCATTER_BIN == LIST_CAP
    assert nq * k < 2 ** 31
    assert tg.scatter_plan(b, n, nq, k, c, window, tq) == (group, hist)


def test_scatter_plan_values_and_refusals():
    """The main path's plans; a window or a tile past the shared-memory
    sort takes the global claims; shapes the kernel cannot take raise."""
    plan = tg.scatter_plan
    assert plan(6, 40960, 40960, 16, 11, 2048, 512) == (4, True)
    assert plan(6, 40960, 40960, 16, 8, 2048, 512) == (2, True)
    assert plan(6, 10240, 10240, 16, 35, 1024, 512) == (32, True)
    assert plan(6, 10240, 10240, 16, 32, 1024, 512) == (8, True)
    assert plan(6, 2560, 2560, 16, 64, 2560, 512) == (16, True)
    assert plan(6, 2560, 2560, 16, 67, 2560, 512) == (32, True)
    assert plan(6, 10240, 2560, 16, 128, 3072, 128) == (32, True)
    assert plan(6, 2560, 640, 16, 256, 2560, 128) == (32, True)
    assert plan(1, 8, 6, 1, 3, 8, 6) == (4, True)
    assert plan(1, 20000, 256, 16, 8, tg.SCATTER_HIST_MAX + 1, 128) == \
        (2, False)
    assert plan(1, 4096, 1024, 16, 8, 1024, 1024) == (2, False)
    for bad in [(1, 8, 6, 1, 3, 8, 4),                # nq % tq
                (1, 8, 8, 1, 3, 9, 4),                # window > n
                (0, 8, 8, 1, 3, 8, 4),                # no batch
                (70000, 8, 8, 1, 3, 8, 4),            # past the grid's y
                (1, 8, 2 ** 27, 16, 3, 8, 4)]:        # entry ids past int32
        with pytest.raises(ValueError, match="scatter_plan"):
            plan(*bad)


def _k4_twin(g, idx, starts, n, window, tq, group, rng):
    """numpy twin of K4's two kernels. fill: tiles count their in-window
    entries per row, claim their runs of each row's bin in a random order
    and file their ids in a random order (the atomics'), a slot past
    LIST_CAP going with its row to the overflow list; sum: each row's ids
    sorted (by rank counting up to LIST_CAP ids, else by the next larger id
    from the bin and the overflow list) and added in f32 in that order,
    `group` lanes sharing a row's units. Returns (dv, {(b, row): ids in
    added order})."""
    b_, nq, k, c = g.shape
    tiles, ne = nq // tq, tq * k
    dv = np.full((b_, n, c), np.nan, F32)
    added = {}
    for b in range(b_):
        ix = idx[b].reshape(-1)
        lo_t = np.clip(starts[b], 0, n - window)
        cnt = np.zeros(n, np.int64)
        bins = np.full((n, LIST_CAP), -1, np.int64)
        ovf = []
        for t in rng.permutation(tiles):               # fill
            r = ix[t * ne:(t + 1) * ne].astype(np.int64) - lo_t[t]
            ok = (r >= 0) & (r < window)
            counts = np.bincount(r[ok], minlength=window)
            slot = np.zeros(window, np.int64)
            for rr in rng.permutation(np.nonzero(counts)[0]):
                slot[rr] = cnt[lo_t[t] + rr]
                cnt[lo_t[t] + rr] += counts[rr]
            for e in rng.permutation(np.nonzero(ok)[0]):
                row, s = lo_t[t] + r[e], slot[r[e]]
                slot[r[e]] += 1
                if s < LIST_CAP:
                    bins[row, s] = t * ne + e
                else:
                    ovf.append((row, t * ne + e))
        gb = g[b].reshape(-1, c)
        for row in range(n):                           # sum
            m = cnt[row]
            if m <= LIST_CAP:
                run = bins[row, :m]
                assert (run >= 0).all()
                srt = np.empty(m, np.int64)
                for e in run:
                    srt[(run < e).sum()] = e
            else:
                cand = list(bins[row]) + [e for r, e in ovf if r == row]
                assert len(cand) == m and min(cand) >= 0
                srt, prev = [], -1
                for _ in range(m):
                    prev = min(e for e in cand if e > prev)
                    srt.append(prev)
            acc = np.zeros(c, F32)
            for u0 in range(0, c, group):              # a group's passes
                for e in srt:
                    acc[u0:u0 + group] = acc[u0:u0 + group] + \
                        gb[e, u0:u0 + group]
            dv[b, row] = acc
            if m:
                added[(b, row)] = list(srt)
    return dv, added


def _window_inputs(rng, b, n, nq, k, c, window, tq, auto=False):
    tiles = nq // tq
    if auto:
        # gather_window_auto: starts from each tile's minimum, indices
        # clamped into the window
        centre = np.repeat(np.linspace(0, n - 1, tiles), tq)[None, :, None]
        raw = np.clip(centre + rng.randint(-window, window, (b, nq, k)), 0,
                      n - 1).astype(np.int32)
        idx_t = torch.from_numpy(raw)
        st = tg.tile_min_starts(idx_t, n, window, tq)
        lo = torch.repeat_interleave(st, tq, dim=1)[..., None]
        idx = torch.minimum(torch.maximum(idx_t, lo),
                            lo + (window - 1)).numpy()
        starts = st.numpy()
    else:
        starts = rng.randint(-3 * 128, n + 128, (b, tiles)).astype(np.int32)
        starts[:, 0], starts[:, -1] = -200, n + 7    # clamped at both ends
        lo = np.repeat(np.clip(starts, 0, n - window), tq, 1)[..., None]
        idx = (lo + rng.randint(-20, window + 20, (b, nq, k))).astype(
            np.int32)
        idx[0, :3, :2] = lo[0, 0, 0] + 5             # repeated rows
    g = rng.randn(b, nq, k, c).astype(F32)
    return g, idx.astype(np.int32), starts.astype(np.int32)


@pytest.mark.parametrize("auto", [False, True])
@pytest.mark.parametrize("c", [11, 8, 12, 5])
def test_k4_twin_order_and_plain_equality(auto, c):
    """Every in-window (q, j) lands in exactly one row's run, each run is
    added in ascending (q, j), and the ordered f32 adds equal the plain
    version (one index_add_ on the CPU) bit for bit, whatever order the
    atomics file the ids in. The clamped indices of gather_window_auto give
    runs past LIST_CAP."""
    rng = np.random.RandomState(c + 10 * auto)
    b, n, nq, k, window, tq = 2, 512, 256, 4, 128, 32
    g, idx, starts = _window_inputs(rng, b, n, nq, k, c, window, tq, auto)
    group, _ = tg.scatter_plan(b, n, nq, k, c, window, tq)
    got, added = _k4_twin(g, idx, starts, n, window, tq, group, rng)
    want = tg._scatter_window_plain(
        torch.from_numpy(g), torch.from_numpy(idx), torch.from_numpy(starts),
        n, window, tq).numpy()
    np.testing.assert_array_equal(got, want)
    lo = np.repeat(np.clip(starts, 0, n - window), tq, 1)[..., None]
    inside = (idx >= lo) & (idx < lo + window)
    for bb in range(b):
        flat_i, flat_in = idx[bb].reshape(-1), inside[bb].reshape(-1)
        owned = sorted(e for (b2, _), v in added.items() if b2 == bb
                       for e in v)
        assert owned == list(np.nonzero(flat_in)[0])   # each exactly once
        for (b2, r), v in added.items():
            if b2 == bb:
                assert v == sorted(v) and (flat_i[v] == r).all()
    assert inside.sum() < inside.size or auto       # some fall outside
    if auto:
        assert max(map(len, added.values())) > LIST_CAP


def _pair_of_task(l, s):
    """K3's pair_of_task: rows x and S − 1 − x fold into S − 1 tasks, an
    odd S's middle row's (S − 1) / 2 tasks after them."""
    folded = (s // 2) * (s - 1)
    if l >= folded:
        m = s // 2
        return m, m + 1 + (l - folded)
    x, t = divmod(l, s - 1)
    n1 = s - 1 - x
    return (x, x + 1 + t) if t < n1 else (s - 1 - x, s - x + (t - n1))


@pytest.mark.parametrize("s", [1, 2, 5, 8, 33, 256])
def test_k3_pair_enumeration_covers_each_ordered_pair_once(s):
    """The S (S − 1) / 2 tasks are the unordered pairs, each once, written
    to (a, b) and (b, a); the diagonal by its own loop; so every ordered
    pair exactly once."""
    writes = np.eye(s, dtype=np.int64)
    for task in range(s * (s - 1) // 2):
        a, b = _pair_of_task(task, s)
        assert 0 <= a < b < s
        writes[a, b] += 1
        writes[b, a] += 1
    assert (writes == 1).all()


def _d2(p, q):
    """K3's d² in float32: fma(dz, dz, fma(dy, dy, dx·dx)), each fma
    rounded once (through float64, exact for these products)."""
    d = (p[:, None, :] - q[None, :, :]).astype(F32)
    sq = lambda v: v.astype(np.float64) ** 2  # noqa: E731
    xy = (sq(d[..., 1]) + (d[..., 0] * d[..., 0]).astype(np.float64)
          ).astype(F32)
    return (sq(d[..., 2]) + xy.astype(np.float64)).astype(F32)


def _pass_twin(stream, reg, tb):
    """One warp's pair_pass: register points lane + 32 t (−inf pads),
    streamed 32 at a time (+inf pads); row minima per register point, and
    the streamed points' minima through the 32 × 32 transpose-reduction.
    Returns (sum over reg, sum over stream) in the kernel's order."""
    nt, ns = len(reg), len(stream)
    slots = np.full((32 * tb, 3), -np.inf, F32)
    slots[:nt] = reg
    lanes = slots.reshape(tb, 32, 3).transpose(1, 0, 2)    # [lane, t, 3]
    rm = np.full((32, tb), np.inf, F32)
    colsum = np.zeros(32, F32)
    with np.errstate(invalid="raise"):
        for p0 in range(0, ns, 32):
            pts = np.full((32, 3), np.inf, F32)
            pts[:min(32, ns - p0)] = stream[p0:p0 + 32]
            d = np.stack([_d2(pts, lanes[l]) for l in range(32)])  # [l, j, t]
            rm = np.minimum(rm, d.min(1))
            cm = d.min(2)                                   # [lane, j]
            for s in (16, 8, 4, 2, 1):
                up = (np.arange(32) & s) > 0
                new = cm.copy()
                for i in range(s):
                    send = np.where(up, cm[:, i], cm[:, i + s])
                    keep = np.where(up, cm[:, i + s], cm[:, i])
                    new[:, i] = np.minimum(keep, send[np.arange(32) ^ s])
                cm = new
            valid = p0 + np.arange(32) < ns
            colsum = np.where(valid, colsum + np.sqrt(cm[:, 0]), colsum)
    live = (np.arange(32)[:, None] + 32 * np.arange(tb)[None]) < nt
    rowsum = np.zeros(32, F32)
    for t in range(tb):
        rowsum = np.where(live[:, t], rowsum + np.sqrt(rm[:, t]), rowsum)

    def butterfly(v):
        for o in (16, 8, 4, 2, 1):
            v = (v + v[np.arange(32) ^ o]).astype(F32)
        return v[0]
    return butterfly(rowsum), butterfly(colsum)


def test_k3_pass_twin_matches_plain():
    """The warp pass, register side the smaller, gives o[a, b] and o[b, a]
    within 1e-5 relative of the plain version; P not a multiple of 32, an
    empty superpoint (0 both ways) and a one-point superpoint included."""
    rng = np.random.RandomState(4)
    s, p = 5, 75
    pts = (rng.randn(1, s, p, 3) * 0.4).astype(F32)
    msk = rng.rand(1, s, p) < 0.6
    msk[0, 2] = False
    msk[0, 4] = False
    msk[0, 4, 9] = True
    want = tc._chamfer_sums_plain(torch.from_numpy(pts),
                                  torch.from_numpy(msk)).numpy()[0]
    got = np.zeros((s, s), F32)
    for a in range(s):
        for b in range(a + 1, s):
            pa, pb = pts[0, a][msk[0, a]], pts[0, b][msk[0, b]]
            if not (len(pa) and len(pb)):
                continue
            breg = len(pb) <= len(pa)
            reg, stream = (pb, pa) if breg else (pa, pb)
            tb = 2 * -(-len(reg) // 64)
            rs, cs = _pass_twin(stream, reg, tb)
            got[a, b], got[b, a] = (rs, cs) if breg else (cs, rs)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert (want[2] == 0).all() and (want[:, 2] == 0).all()
