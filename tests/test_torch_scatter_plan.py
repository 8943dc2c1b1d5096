"""What the redesigned K4 and K3 kernels rely on, checked on the CPU.

- K4 (csrc/scatter_window.cu) transposes the index set, then sums. The
  transpose takes plan tiles (a query tile, cut into runs of at most
  PART_MAX entries and its window into runs of at most PIECE_MAX rows):
  a histogram kernel counts each plan tile's ids per window row and adds
  them to the rows' totals, a scan turns the totals into offsets, and a
  place kernel puts a plan tile's ids of a row after the row's ids in
  every earlier plan tile that holds it, dropping them into the row's run
  of a shared list in the atomics' order and ranking each in its run. The
  sum kernel adds each row's ids in that order, in f32. A numpy twin of
  those steps, with the atomics' orders drawn at random, must give the
  plain transpose (a stable sort of the rows) and the plain version's
  index_add_ bit for bit; a twin of the bf16 span unit (8 channels from
  up to three aligned 8-byte words, shifted) must read each row's own
  values at every alignment.
- `scatter_plan` and `transpose_plan` are pure functions of the shapes,
  inside the kernels' limits at every main-path call.
- K3 (csrc/chamfer_sums.cu) hands out the unordered pairs as tasks
  (rows x and S − 1 − x folded) and computes each pair's distances once
  for both directions: a twin of the task → pair map covers every ordered
  pair once, and a numpy twin of a warp's
  pass (±inf padding, the 32 × 32 transpose-reduction of minima) equals
  the plain sums.
"""

import os
import re

import numpy as np
import pytest
import torch

from ssdr_al_torch.ops import chamfer as tc
from ssdr_al_torch.ops import gather as tg

torch.set_num_threads(1)

F32 = np.float32
BF16 = torch.bfloat16

# (n, nq, k, c, window, tq) of the 9 K4 calls of one train step: the
# backward of the LFA gathers (L0-L2) and of the pool gathers
K4_MAIN = [(40960, 40960, 16, 11, 2048, 512), (40960, 40960, 16, 8, 2048, 512),
           (10240, 10240, 16, 35, 1024, 512), (10240, 10240, 16, 32, 1024, 512),
           (2560, 2560, 16, 67, 2560, 512), (2560, 2560, 16, 64, 2560, 512),
           (40960, 10240, 16, 32, 4096, 128), (10240, 2560, 16, 128, 3072, 128),
           (2560, 640, 16, 256, 2560, 128)]
# the f32 model's two k = 1 calls: the decoder's windowed upsamples
K4_K1 = [(10240, 40960, 1, 32, 1152, 128), (2560, 10240, 1, 128, 1152, 128)]

LIST_CAP = 48      # slots of a row's bin, the single-use path's fill
TILE_STATIC = 256                 # the place kernel's static shared bytes
SMEM_MAX = 227 * 1024             # shared memory one CTA can opt in to
FUSED_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ssdr_al_torch", "csrc", "scatter_fused.cu")


def _kernel_const(name):
    """An int constant of the single-use path's kernel source."""
    with open(FUSED_SRC) as f:
        found = re.findall(rf"constexpr int {name} = (\d+);", f.read())
    assert len(found) == 1, name
    return int(found[0])


def _fused_limits(b, n, nq, k, c, window, tq, dtype):
    """fused_plan within the single-use path's limits: its group a power
    of 2 from 2 to 32 (float4 or bf16 vector rows covered in one pass,
    single values by 4 lanes up to 16 channels and 32 above), each tile
    sorted in shared memory within the card's 227 KB (2 × window + 2 ×
    entries ints), the sum kernel's sorting lists (2 × LIST_CAP + 1 ints a
    group) within 48 KB, and the bin, the numpy twin's and fused_plan's
    alike, as wide as the kernel's."""
    group, hist = tg.fused_plan(b, n, nq, k, c, window, tq, dtype)
    assert group in (2, 4, 8, 16, 32)
    per = (8 if c % 8 == 0 else 4) if dtype == BF16 else 4
    if c % 4 == 0:
        assert group == min(max(c // per, 2), 32)
    else:
        assert group == (4 if c <= 16 else 32)
    assert hist and (2 * window + 2 * tq * k) * 4 <= SMEM_MAX
    assert window <= tg.FUSED_HIST_MAX == _kernel_const("HIST_MAX")
    assert tq * k <= tg.FUSED_FILL_ENTRIES == \
        _kernel_const("FILL_PER") * _kernel_const("FILL_THREADS")
    threads = 128 if group < 4 else 256
    assert (threads // group) * (2 * LIST_CAP + 1) * 4 <= 48 * 1024
    assert tg.FUSED_BIN == LIST_CAP == _kernel_const("LIST_CAP")
    assert tg.fused_plan(b, n, nq, k, c, window, tq, dtype) == (group, hist)


def _plan_limits(b, n, nq, k, window, tq):
    """transpose_plan within the kernels' limits: plan tiles of at most
    TRANSPOSE_PART entries and TRANSPOSE_PIECE window rows (kept as u16 in
    shared memory and in the counts), the place kernel's shared memory
    (start, claimed and first a row, four lists of earlier plan tiles a
    thread, an id and a u16 row an entry) within the card's 227 KB, and
    the plan-tile count within the grid."""
    parts, pieces, threads, whole = tg.transpose_plan(b, n, nq, k, window,
                                                      tq)
    if whole:
        assert nq * k < 2 ** 16 and 1 <= pieces <= n and \
            (2 * -(-n // pieces) + 1) * 4 + 2 * nq * k + 128 <= SMEM_MAX
        return parts, 1
    ep, wp = -(-tq * k // parts), -(-window // pieces)
    assert ep <= tg.TRANSPOSE_PART < 2 ** 16
    assert wp <= tg.TRANSPOSE_PIECE < 2 ** 16
    assert (3 * wp + 1 + 4 * threads + ep) * 4 + 2 * ep + TILE_STATIC <= \
        SMEM_MAX
    assert nq // tq * parts * pieces < 2 ** 31 and b * nq * k < 2 ** 31
    assert threads in (128, 256, 512, 1024)
    assert threads * tg.TRANSPOSE_HELD >= ep and \
        (threads == 128 or threads * tg.TRANSPOSE_HELD < 2 * ep)
    return parts, pieces


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("n,nq,k,c,window,tq", K4_MAIN + K4_K1)
def test_scatter_plan_at_main_path_shapes(n, nq, k, c, window, tq, dtype):
    """The sum pass: f32 rows in float4s (the group the power of 2 that
    covers them) or single floats (4 lanes up to 16 channels, 32 above);
    bf16 rows in 16-byte units of 8, 8-byte units of 4 or spans of 8 (11,
    35, 67 channels), the group the power of 2 that covers a row's units
    (one lane a row at 8 channels; at most SPAN_LANES for spans, a lane
    then taking several), so no lane of a group is idle where a row has as
    many units. The transpose in one plan tile a query tile at
    every main-path call, within the kernels' limits; a pure function of
    the shapes. Where a call may take the single-use path (tiles of at
    least TRANSPOSE_SMALL_TILE entries), its plan within that path's
    limits (_fused_limits)."""
    b = 6
    group, unit = tg.scatter_plan(b, n, nq, k, c, window, tq, dtype)
    assert group in (1, 2, 4, 8, 16, 32) and unit in tg.SCATTER_UNITS
    if dtype == torch.float32 and c % 4:
        assert (group, unit) == (4 if c <= 16 else 32, "f32x1")
    else:
        per, want = ((4, "f32x4") if dtype == torch.float32 else
                     (8, "bf16x8") if c % 8 == 0 else (4, "bf16x4")
                     if c % 4 == 0 else (8, "bf16span8"))
        units = -(-c // per)
        if want == "bf16span8":
            units = min(units, tg.SPAN_LANES)
        assert unit == want and group >= min(units, 32) and \
            (group == 1 or group < 2 * units)
    assert tg.scatter_plan(b, n, nq, k, c, window, tq, dtype) == \
        (group, unit)
    assert _plan_limits(b, n, nq, k, window, tq) == (1, 1)
    # a batch element's ids in the batch kernel's shared memory wherever
    # they fit in u16 (at every main-path call with no more)
    assert tg.transpose_plan(b, n, nq, k, window, tq)[3] == \
        (nq * k <= 65535)
    if tq * k >= tg.TRANSPOSE_SMALL_TILE:
        # a call with no shared transpose takes the single-use path
        _fused_limits(b, n, nq, k, c, window, tq, dtype)


def test_scatter_plan_values_and_refusals():
    """The main path's plans; tiles and windows past the kernels' limits
    are cut into runs; shapes the kernels cannot take raise."""
    plan = tg.scatter_plan
    assert plan(6, 40960, 40960, 16, 11, 2048, 512) == (4, "f32x1")
    assert plan(6, 40960, 40960, 16, 8, 2048, 512) == (2, "f32x4")
    assert plan(6, 10240, 10240, 16, 35, 1024, 512) == (32, "f32x1")
    assert plan(6, 10240, 10240, 16, 32, 1024, 512) == (8, "f32x4")
    assert plan(6, 2560, 2560, 16, 64, 2560, 512) == (16, "f32x4")
    assert plan(6, 2560, 2560, 16, 67, 2560, 512) == (32, "f32x1")
    assert plan(6, 10240, 2560, 16, 128, 3072, 128) == (32, "f32x4")
    assert plan(6, 2560, 640, 16, 256, 2560, 128) == (32, "f32x4")
    assert plan(6, 10240, 40960, 1, 32, 1152, 128) == (8, "f32x4")
    assert plan(1, 8, 6, 1, 3, 8, 6) == (4, "f32x1")
    for c, want in ((8, (1, "bf16x8")), (11, (2, "bf16span8")),
                    (32, (4, "bf16x8")), (35, (4, "bf16span8")),
                    (64, (8, "bf16x8")), (67, (4, "bf16span8")),
                    (128, (16, "bf16x8")), (256, (32, "bf16x8")),
                    (12, (4, "bf16x4"))):
        assert plan(6, 40960, 40960, 16, c, 2048, 512, BF16) == want, c
    tp = tg.transpose_plan
    assert tp(6, 40960, 40960, 16, 2048, 512) == (1, 1, 1024, False)
    assert tp(6, 40960, 10240, 16, 4096, 128) == (1, 1, 256, False)
    assert tp(6, 10240, 40960, 1, 1152, 128) == (1, 16, 128, True)
    assert tp(6, 10240, 10240, 16, 1024, 512)[3] is False    # 163 840 ids
    assert tp(6, 2560, 2560, 16, 2560, 512) == (1, 16, 1024, True)
    assert tp(4, 4096, 4096, 16, 4096, 512)[3] is False      # 65 536 ids
    assert tp(1, 800000, 8192, 1, 1152, 128)[3] is False     # offsets
    assert tp(6, 2560, 640, 16, 2560, 128) == (1, 16, 256, True)
    assert tp(1, 4096, 1024, 16, 1024, 1024) == (2, 16, 1024, True)
    assert tp(1, 30000, 8192, 16, tg.TRANSPOSE_PIECE + 1, 128) == \
        (1, 2, 256, False)
    assert tp(1, 30000, 256, 16, tg.TRANSPOSE_PIECE + 1, 128) == \
        (1, 16, 256, True)
    for bad in [(1, 8, 6, 1, 3, 8, 4),                # nq % tq
                (1, 8, 8, 1, 3, 9, 4),                # window > n
                (0, 8, 8, 1, 3, 8, 4),                # no batch
                (70000, 8, 8, 1, 3, 8, 4),            # past the grid's y
                (1, 8, 2 ** 27, 16, 3, 8, 4)]:        # entry ids past int32
        with pytest.raises(ValueError, match="scatter_plan"):
            plan(*bad)
        with pytest.raises(ValueError, match="transpose_plan"):
            tp(*bad[:4], *bad[5:])
    with pytest.raises(ValueError, match="transpose_plan"):
        tp(2, 8, 2 ** 26, 16, 8, 4)                   # B·nq·k past int32
    with pytest.raises(TypeError, match="dtype"):
        plan(1, 8, 8, 1, 3, 8, 4, torch.float16)


def _plan_tiles(starts_b, n, window, tq, k, parts, pieces):
    """The plan tiles of one batch element in kernel order, each (t, part,
    e0, e1, r0, r1): tile t's entries [e0, e1) and window rows [r0, r1)."""
    e, ep, wp = tq * k, -(-tq * k // parts), -(-window // pieces)
    out = []
    for t, lo in enumerate(np.clip(starts_b, 0, n - window)):
        for part in range(parts):
            for piece in range(pieces):
                out.append((t, part, t * e + part * ep,
                            t * e + min(e, (part + 1) * ep),
                            lo + piece * wp, lo + min(window,
                                                      (piece + 1) * wp)))
    return out


def _transpose_twin(idx, starts, n, window, tq, parts, pieces, rng):
    """numpy twin of K4's transpose kernels over plan tiles. hist: each
    plan tile counts its ids per row of its window piece, over the span of
    rows its ids reach (the counts, the span, and the counts' sums into the
    rows' totals); scan: each batch element's rows' offsets; place: a plan
    tile's ids of row r start after the row's ids in every earlier plan
    tile (lower (t, part)) whose span holds r, are dropped into the row's
    run in a random order (the atomics') and ranked there. Returns (rowptr
    [B, n + 1], ids [B, nq·k], the most ids a plan tile put in one row)."""
    b_, nq, k = idx.shape
    cnt = np.zeros((b_, n), np.int64)
    hists, tiles = [], []
    for b in range(b_):                                 # hist kernel
        flat = idx[b].reshape(-1).astype(np.int64)
        pts = []
        hb = []
        for t, part, e0, e1, r0, r1 in _plan_tiles(starts[b], n, window,
                                                    tq, k, parts, pieces):
            i = flat[e0:e1]
            i = i[(i >= r0) & (i < r1)]
            s0, s1 = (i.min(), i.max() + 1) if len(i) else (r0, r0)
            h = np.bincount(i - s0, minlength=s1 - s0)
            hb.append(h)
            pts.append((t, part, e0, e1, s0, s1))
            cnt[b, s0:s1] += h
        hists.append(hb)
        tiles.append(pts)
    rowptr = np.zeros((b_, n + 1), np.int64)            # scan kernel
    rowptr[:, 1:] = np.cumsum(cnt, 1)
    ids = np.full((b_, nq * k), -1, np.int64)
    most = 0
    for b in range(b_):                                 # place kernel
        flat = idx[b].reshape(-1).astype(np.int64)
        pts = tiles[b]
        for pt, (t, part, e0, e1, r0, r1) in enumerate(pts):
            h = hists[b][pt]
            first = rowptr[b, r0:r1].copy()
            for q, (t2, part2, _, _, s0, s1) in enumerate(pts):
                if (t2, part2) >= (t, part):
                    break
                lo, hi = max(r0, s0), min(r1, s1)
                if lo < hi:
                    first[lo - r0:hi - r0] += \
                        hists[b][q][lo - s0:hi - s0]
            start = np.concatenate([[0], np.cumsum(h)])
            e = e0 + np.nonzero((flat[e0:e1] >= r0) & (flat[e0:e1] < r1))[0]
            r = flat[e] - r0
            slots = _dropped(e, r, start, rng)
            for s in range(len(slots)):                 # rank in the run
                rr = np.searchsorted(start, s, "right") - 1
                run = slots[start[rr]:start[rr + 1]]
                ids[b, first[rr] + (run < slots[s]).sum()] = slots[s]
            most = max(most, int(h.max(initial=0)))
    return rowptr, ids, most


def _dropped(e, r, start, rng):
    """Entries e of rows r dropped into their rows' runs (starting at
    start[r]) in a random order, the shared atomics'."""
    slots = np.full(len(e), -1, np.int64)
    claimed = np.zeros(len(start), np.int64)
    for p in rng.permutation(len(e)):
        slots[start[r[p]] + claimed[r[p]]] = e[p]
        claimed[r[p]] += 1
    return slots


def _whole_twin(idx, starts, n, window, tq, pieces, rng):
    """numpy twin of K4's transpose by row blocks of a batch element
    (scatter_batch_transpose_kernel): each entry's tile by the
    multiply-high by ceil(2^32 / (tq·k)); a block of ceil(n / pieces) rows
    reads every entry,
    counts its rows' entries and the entries of every row before its own
    (its first offset), scans its offsets, drops its ids into their runs in
    a random order and ranks each in its run (its run found by a binary
    search of the offsets). Returns (rowptr [B, n + 1], ids [B, nq·k])."""
    b_, nq, k = idx.shape
    e_t = tq * k
    magic = ((1 << 32) + e_t - 1) // e_t if e_t > 1 else 0
    rb = -(-n // pieces)
    rowptr = np.full((b_, n + 1), -1, np.int64)
    ids = np.full((b_, nq * k), -1, np.int64)
    for b in range(b_):
        flat = idx[b].reshape(-1).astype(np.int64)
        e = np.arange(nq * k, dtype=np.int64)
        t = (e * magic) >> 32 if e_t > 1 else e
        assert (t == e // e_t).all()
        lo = np.clip(starts[b].astype(np.int64), 0, n - window)[t]
        ok = (flat >= lo) & (flat < lo + window)
        for r0 in range(0, n, rb):
            r1 = min(r0 + rb, n)
            mine = ok & (flat >= r0) & (flat < r1)
            base = (ok & (flat < r0)).sum()
            start = np.concatenate([[0], np.cumsum(np.bincount(
                flat[mine] - r0, minlength=r1 - r0))])
            rowptr[b, r0:r1] = base + start[:-1]
            if r1 == n:
                rowptr[b, n] = base + start[-1]
            slots = _dropped(e[mine], flat[mine] - r0, start, rng)
            for q in range(len(slots)):
                rr = np.searchsorted(start, q, "right") - 1
                run = slots[start[rr]:start[rr + 1]]
                ids[b, base + start[rr] + (run < slots[q]).sum()] = slots[q]
    return rowptr, ids


def _sum_twin(g, rowptr, ids, n):
    """numpy twin of K4's sum pass: each dv row's ids added in order in
    f32, every channel on its own (the lanes' units do not change a
    channel's order)."""
    b_, nq, k, c = g.shape
    gf = g.astype(F32).reshape(b_, nq * k, c)
    dv = np.zeros((b_, n, c), F32)
    for b in range(b_):
        m = np.diff(rowptr[b])
        for j in range(int(m.max(initial=0))):
            has = m > j
            e = ids[b, rowptr[b, :-1][has] + j]
            dv[b, has] = dv[b, has] + gf[b, e]
    return dv


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


def _plain(g, idx, starts, n, window, tq):
    return tg._scatter_window_plain(
        torch.from_numpy(g), torch.from_numpy(idx), torch.from_numpy(starts),
        n, window, tq).numpy()


def _check_transpose(rowptr, ids, idx, starts, n, window, tq):
    """The twin's transpose is the plain version's, and each row's ids are
    its in-window entries, ascending."""
    rp0, ids0 = tg._window_transpose_plain(torch.from_numpy(idx),
                                           torch.from_numpy(starts), n,
                                           window, tq)
    b_, nq, k = idx.shape
    rp0, ids0 = rp0.numpy().reshape(b_, n + 1), ids0.numpy().reshape(b_, -1)
    np.testing.assert_array_equal(rowptr, rp0)
    lo = np.repeat(np.clip(starts, 0, n - window), tq, 1)[..., None]
    inside = (idx >= lo) & (idx < lo + window)
    assert rowptr[:, n].sum() == inside.sum()
    for b in range(b_):
        total = rowptr[b, n]
        np.testing.assert_array_equal(ids[b, :total], ids0[b, :total])
        flat = idx[b].reshape(-1)
        for r in range(n):
            run = ids[b, rowptr[b, r]:rowptr[b, r + 1]]
            assert (np.diff(run) > 0).all() and (flat[run] == r).all()


@pytest.mark.parametrize("auto", [False, True])
@pytest.mark.parametrize("c", [11, 8, 12, 5])
def test_k4_twin_order_and_plain_equality(auto, c):
    """Every in-window (q, j) lands in exactly one row's run, in ascending
    (q, j), whatever order the atomics drop the ids in and however the
    tiles are cut (here each tile's entries into 3 runs and its window
    into 2, as tiles past the kernels' limits are); the ordered f32 adds
    equal the plain version (one index_add_ on the CPU) bit for bit,
    with gather_window_auto's clamped piles too; the same through the
    transpose by row blocks of a batch element (here 3 a batch element)."""
    rng = np.random.RandomState(c + 10 * auto)
    b, n, nq, k, window, tq = 2, 512, 256, 4, 128, 32
    g, idx, starts = _window_inputs(rng, b, n, nq, k, c, window, tq, auto)
    rowptr, ids, most = _transpose_twin(idx, starts, n, window, tq, 3, 2,
                                        rng)
    _check_transpose(rowptr, ids, idx, starts, n, window, tq)
    np.testing.assert_array_equal(_sum_twin(g, rowptr, ids, n),
                                  _plain(g, idx, starts, n, window, tq))
    lo = np.repeat(np.clip(starts, 0, n - window), tq, 1)[..., None]
    inside = (idx >= lo) & (idx < lo + window)
    assert inside.sum() < inside.size or auto       # some fall outside
    assert most > 1
    if auto:
        assert np.diff(rowptr, axis=1).max() > 2 * tq * k // 3
    whole = _whole_twin(idx, starts, n, window, tq, 3, rng)
    np.testing.assert_array_equal(whole[0], rowptr)
    np.testing.assert_array_equal(_sum_twin(g, *whole, n),
                                  _plain(g, idx, starts, n, window, tq))


def _main_inputs(rng, b, n, nq, k, c, window, tq, pile=0):
    """An index set shaped as the sorted pyramid's: query tile t's window
    centred on its queries' rows (starts 128-aligned, the first below 0 and
    the last past n − window: clamped), each index near its query's row
    and inside the window but for a few outside it; `pile` entries of tile
    2 moved onto one row (more ids than a row can rank in the list)."""
    tiles = nq // tq
    centre = (np.arange(tiles) * tq + tq // 2) * n // nq
    starts = ((centre - window // 2) // 128 * 128).astype(np.int32)
    starts = np.broadcast_to(starts, (b, tiles)).copy()
    starts[:, 0], starts[:, -1] = -256, n + 128
    lo = np.repeat(np.clip(starts, 0, n - window), tq, 1)[..., None]
    q = (np.arange(nq) * n // nq)[None, :, None]
    idx = lo + np.mod(q - lo + rng.randint(-window // 3, window // 3,
                                           (b, nq, k)), window)
    idx[:, ::97, 0] = -5                              # outside the window
    idx[:, 5::89, k - 1] = n + 3
    if pile:
        flat = idx[0].reshape(-1)
        e0 = 2 * tq * k
        flat[e0:e0 + pile] = np.clip(starts[0, 2], 0, n - window) + 7
        idx[0] = flat.reshape(nq, k)
    g = torch.from_numpy(rng.randn(b, nq, k, c).astype(F32)).to(BF16)
    return g, idx.astype(np.int32), starts


@pytest.mark.parametrize("n,nq,k,c,window,tq,dtype,pile", [
    (40960, 40960, 16, 11, 2048, 512, BF16, 0),       # L0 LFA, bf16 span
    (40960, 40960, 16, 8, 2048, 512, BF16, 1500),     # a pile on one row
    (40960, 10240, 16, 32, 4096, 128, BF16, 0),       # L0 pool
    (10240, 40960, 1, 32, 1152, 128, torch.float32, 0),   # k = 1 upsamples
    (2560, 10240, 1, 128, 1152, 128, torch.float32, 0),
])
def test_scatter_plan_twin_at_main_path_shapes(n, nq, k, c, window, tq,
                                               dtype, pile):
    """The transpose twin with the kernels' own plan (transpose_plan: plan
    tiles at the L0 calls, row blocks of a batch element at k = 1) on one
    batch
    element shaped as a main-path call, clamped starts and out-of-window
    indices included: the plain transpose, and the ordered adds of the
    (bf16-widened) cotangent equal to index_add_ bit for bit; a pile of
    1500 ids on one row is ranked in one tile."""
    rng = np.random.RandomState(n + c + k)
    g, idx, starts = _main_inputs(rng, 1, n, nq, k, c, window, tq, pile)
    g = g.to(dtype)
    parts, pieces, _, whole = tg.transpose_plan(6, n, nq, k, window, tq)
    assert whole == (k == 1)
    if whole:
        rowptr, ids = _whole_twin(idx, starts, n, window, tq, pieces, rng)
    else:
        rowptr, ids, most = _transpose_twin(idx, starts, n, window, tq,
                                            parts, pieces, rng)
        assert (most >= pile) and (most < 1500 or pile)
    _check_transpose(rowptr, ids, idx, starts, n, window, tq)
    want = tg._scatter_window_plain(g, torch.from_numpy(idx),
                                    torch.from_numpy(starts), n, window,
                                    tq).numpy()
    np.testing.assert_array_equal(
        _sum_twin(g.float().numpy(), rowptr, ids, n), want)


def _span_twin(bits, row, c, u):
    """numpy twin of the bf16 span unit: channels [8u, min(8u + 8, c)) of
    cotangent row `row` from the aligned 8-byte words (4 bf16 values)
    h0 // 4 .. (h0 + nv − 1) // 4 that hold them (no word past the
    unit's last value), as 32-bit pairs; the words moved by one pair where
    h0 % 4 >= 2 and each pair shifted by 16 bits where h0 is odd
    (funnelshift_r). Returns the unit's bf16 bit patterns and the words
    loaded."""
    h0, nv = row * c + 8 * u, min(8, c - 8 * u)
    w0, w1 = h0 >> 2, (h0 + nv - 1) >> 2
    words = np.zeros(12, np.uint32)
    for i in range(3):
        if w0 + i <= w1:
            words[4 * i:4 * i + 4] = bits[4 * (w0 + i):4 * (w0 + i) + 4]
    a = (words[0::2] | (words[1::2] << 16)).astype(np.uint64)  # 6 pairs
    s = h0 & 3
    sel = a[1:6] if s >> 1 else a[0:5]
    out = []
    for i in range(4):
        v = ((sel[i] | (sel[i + 1] << 32)) >> 16) & 0xffffffff \
            if s & 1 else sel[i]
        out += [int(v) & 0xffff, int(v) >> 16]
    return np.array(out[:nv], np.uint16), w1 - w0 + 1


@pytest.mark.parametrize("c", [11, 35, 67, 5, 19])
def test_scatter_plan_span_units_twin(c):
    """The bf16 span unit reads each row's own channels, at every
    alignment of a row's first value to the 8-byte words (rows of every
    batch element, so the batch offset shifts them too), loading 1 to 3
    words and none past the unit; the group covers the row's units."""
    rng = np.random.RandomState(c)
    b, nq, k = 2, 6, 3
    g = torch.from_numpy(rng.randn(b, nq, k, c).astype(F32)).to(BF16)
    bits = g.view(torch.int16).numpy().astype(np.uint16).reshape(-1)
    bits = np.concatenate([bits, np.zeros(12, np.uint16)])
    group, unit = tg.scatter_plan(b, nq, nq, k, c, nq, nq, BF16)
    assert unit == "bf16span8" and group >= min(-(-c // 8), tg.SPAN_LANES)
    shifts, loads = set(), set()
    for row in range(b * nq * k):
        for u in range(-(-c // 8)):
            got, n_words = _span_twin(bits, row, c, u)
            lo = row * c + 8 * u
            np.testing.assert_array_equal(got, bits[lo:lo + len(got)])
            assert (lo + len(got) - 1) // 4 < (lo // 4) + n_words <= \
                (lo + len(got) + 3) // 4
            shifts.add(lo & 3)
            loads.add(n_words)
    assert shifts == {0, 1, 2, 3} and loads >= ({2, 3} if c > 8 else {2})


def test_scatter_plan_shared_transpose_two_calls():
    """A WindowTranspose shared by two scatters of one index set (a bf16
    and an f32 cotangent, 11 and 8 channels): each equals the plain
    version, the transpose is built once and equals the plain one; a
    scatter of another index set through it raises."""
    rng = np.random.RandomState(5)
    b, n, nq, k, window, tq = 2, 512, 256, 4, 128, 32
    g, idx, starts = _window_inputs(rng, b, n, nq, k, 11, window, tq)
    it, st = torch.from_numpy(idx), torch.from_numpy(starts)
    tr = tg.WindowTranspose(it, st, n, window, tq)
    assert not tr.built
    g16 = torch.from_numpy(g).to(BF16)
    g8 = torch.from_numpy(rng.randn(b, nq, k, 8).astype(F32))
    for cot in (g16, g8):
        got = tg.scatter_window(cot, it, st, n, window, tq, transpose=tr)
        assert torch.equal(got, tg._scatter_window_plain(cot, it, st, n,
                                                         window, tq))
    first = tr.csr()
    assert tr.built and tr.csr() is first
    rp0, ids0 = tg._window_transpose_plain(it, st, n, window, tq)
    assert torch.equal(first[0], rp0) and torch.equal(first[1], ids0)
    with pytest.raises(ValueError, match="another index set"):
        tg.scatter_window(g8, it.clone(), st, n, window, tq, transpose=tr)
    with pytest.raises(ValueError, match="another index set"):
        tg.scatter_window(g8, it, st, n, window - 8, tq, transpose=tr)


def test_lfa_gathers_share_one_transpose():
    """The model's two LFA gathers of a layer hand one WindowTranspose of
    their index set to gather_window in a forward with gradients (a
    different one per layer), and none under no_grad, where no backward
    can run; the train-mode gradient is the one without transposes."""
    import dataclasses

    from ssdr_al_torch.config import ConfigS3DIS
    from ssdr_al_torch.models import randlanet as rl

    cfg = dataclasses.replace(ConfigS3DIS, num_layers=3, d_out=(8, 16, 32),
                              sub_sampling_ratio=(4, 4, 2), num_points=8192)
    rng = np.random.RandomState(2)
    xyz = torch.from_numpy((rng.rand(1, 8192, 3) * 4).astype(F32))
    feats = torch.cat([xyz, torch.from_numpy(rng.rand(1, 8192, 3)
                                             .astype(F32))], -1)
    torch.manual_seed(0)
    model = rl.RandLANet(cfg).train()
    model.dp1.eval()
    pyr = rl.build_pyramid(xyz, cfg)
    seen, gather = [], rl.gather_window

    def rec(*args, transpose=None, **kw):
        seen.append(transpose)
        return gather(*args, transpose=transpose, **kw)

    grads = []
    try:
        for share in (True, False):
            rl.gather_window = rec if share else (
                lambda *a, transpose=None, **kw: gather(*a, **kw))
            model.zero_grad()
            model(feats, pyr)[0].square().mean().backward()
            grads.append([p.grad.clone() for p in model.parameters()])
        lfa = [t for t in seen]
        assert len(lfa) >= 2 and len(lfa) % 2 == 0
        for a, c in zip(lfa[0::2], lfa[1::2]):
            assert isinstance(a, tg.WindowTranspose) and a is c
        assert len({id(t) for t in lfa}) == len(lfa) // 2
        seen.clear()
        rl.gather_window = rec
        with torch.no_grad():
            model(feats, pyr)
        assert seen and all(t is None for t in seen)
    finally:
        rl.gather_window = gather
    for a, c in zip(*grads):
        assert torch.equal(a, c)


def test_fused_plan_values_and_refusals():
    """K4's single-use path (the pool gathers' backward): the main path's
    plans; a window or a tile past the shared-memory sort takes the global
    claims; shapes the kernel cannot take raise."""
    plan = tg.fused_plan
    assert plan(6, 40960, 40960, 16, 11, 2048, 512) == (4, True)
    assert plan(6, 40960, 40960, 16, 8, 2048, 512) == (2, True)
    assert plan(6, 10240, 10240, 16, 35, 1024, 512) == (32, True)
    assert plan(6, 10240, 10240, 16, 32, 1024, 512) == (8, True)
    assert plan(6, 2560, 2560, 16, 64, 2560, 512) == (16, True)
    assert plan(6, 2560, 2560, 16, 67, 2560, 512) == (32, True)
    assert plan(6, 10240, 2560, 16, 128, 3072, 128) == (32, True)
    assert plan(6, 2560, 640, 16, 256, 2560, 128) == (32, True)
    assert plan(1, 8, 6, 1, 3, 8, 6) == (4, True)
    assert plan(1, 20000, 256, 16, 8, tg.FUSED_HIST_MAX + 1, 128) == \
        (2, False)
    assert plan(1, 4096, 1024, 16, 8, 1024, 1024) == (2, False)
    for bad in [(1, 8, 6, 1, 3, 8, 4),                # nq % tq
                (1, 8, 8, 1, 3, 9, 4),                # window > n
                (0, 8, 8, 1, 3, 8, 4),                # no batch
                (70000, 8, 8, 1, 3, 8, 4),            # past the grid's y
                (1, 8, 2 ** 27, 16, 3, 8, 4)]:        # entry ids past int32
        with pytest.raises(ValueError, match="scatter_plan"):
            plan(*bad)


def _fused_twin(g, idx, starts, n, window, tq, group, rng):
    """numpy twin of K4's single-use path's two kernels. fill: tiles count their in-window
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


@pytest.mark.parametrize("auto", [False, True])
@pytest.mark.parametrize("c", [11, 8, 12, 5])
def test_k4_fused_twin_order_and_plain_equality(auto, c):
    """K4's single-use path: every in-window (q, j) lands in exactly one
    row's run, each run is added in ascending (q, j), and the ordered f32
    adds equal the plain version (one index_add_ on the CPU) bit for bit,
    whatever order the atomics file the ids in. The clamped indices of
    gather_window_auto give runs past LIST_CAP."""
    rng = np.random.RandomState(c + 10 * auto)
    b, n, nq, k, window, tq = 2, 512, 256, 4, 128, 32
    g, idx, starts = _window_inputs(rng, b, n, nq, k, c, window, tq, auto)
    group, _ = tg.fused_plan(b, n, nq, k, c, window, tq)
    got, added = _fused_twin(g, idx, starts, n, window, tq, group, rng)
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
