// K4: windowed scatter-add, the backward of the windowed gather K2.
//
// Replaces the TPU kernel ssdr_al_tpu/ops/gather.py::_scatter_kernel
// (launched by _scatter_window_impl from _gather_window_bwd, the VJP of
// gather_window). dv[b, r, :] = sum of g[b, q, j, :] over the (q, j) with
// idx[b, q, j] == r, for every index inside its query tile's window
// [starts[b, q / tq], starts[b, q / tq] + window), starts clamped to
// [0, n - window]; an index outside the window contributes nothing, as K2
// reads it as a zero row. Accumulation in f32, into f32 dv. The cotangent
// is f32 (the float32 model) or bf16 (the bfloat16 model, whose K2 stores
// bf16): each bf16 value is widened to f32 in registers and added in the
// same order, so dv equals index_add_ of g.float(). The TPU's VJP cast its
// bf16 cotangent to f32 before its kernel.
//
// Bound on the H100: device-memory bytes. One add per cotangent value; g
// (B * nq * k rows of c values) is read once and dominates the traffic, dv
// is written once.
// Design: output-owned and deterministic. The TPU kernel accumulated each
// tile into a VMEM slab along a sequential grid axis, a fixed order. Here
// the index set is first transposed (dv row -> its in-window entry ids
// e = q * k + j, ascending: a CSR per batch element), and then each dv
// row is summed by one group of lanes in that order, the order of the
// plain version's index_add_ on the CPU, so the result equals it bit for
// bit. No atomic touches a float and dv needs no memset. The transpose is
// a pure function of (idx, starts, n, window, tq), so the two LFA gathers
// of a layer, which share them, build it once (ops/gather.py::
// WindowTranspose) and only the sum pass runs per call.
//  1. The transpose. Plan tiles (a query tile, or a run of its entries and
//     of its window's rows where it has more than PART_MAX entries or
//     PIECE_MAX window rows), a CTA of up to 1024 threads each holding the
//     tile's entries (EPT a thread, one coalesced read of idx a kernel):
//     scatter_hist_kernel counts the tile's ids per row of the span they
//     reach and writes the counts (u16) and adds them to the rows' totals;
//     scatter_scan_kernel turns the totals into each batch element's
//     offsets (and the running reach of the tiles' spans);
//     scatter_place_transpose_kernel puts the tile's ids of row r after
//     the row's ids in every earlier plan tile whose span holds r (read
//     from their counts): it drops each id into its row's run of a
//     shared-memory list (a shared atomic each: any order), ranks it
//     among the run's ids (a tile holds a few a row) and writes it there.
//     Where a batch element's ids fit in u16 and in shared memory (the
//     L2 LFA set's 40 960, the 1-NN upsamples'), scatter_batch_transpose_
//     kernel does it all in one launch, a CTA per run of a batch element's
//     rows (below). The work is set by the entries, not by the window.
//     (A first design, a CTA per block of dv rows reading the idx of every
//     tile whose window met it, read the idx ~3 times with a division an
//     entry: 0.107 ms for the L0 LFA index set, PERF.md. Half of the place
//     kernel's time at L0 is its stores: runs of ~4 ids a row, parts of
//     32-byte sectors.)
//  2. scatter_sum_kernel, G lanes per dv row (G = 1: 32 rows a warp), at
//     most 64 registers a thread (1024 threads an SM): each lane adds its
//     units of the row over the row's ids, 8 (16 for single floats, 4 for
//     spans) loads in flight, and writes them once. A unit is a float4
//     (f32, c % 4 == 0) or one float (f32); for bf16 16 bytes of 8 values
//     (c % 8 == 0), 8 bytes of 4 (c % 4 == 0), else 8 channels read from
//     the aligned 8-byte words that hold them (1-3 loads) and shifted into
//     place, so an 11- or 35-channel bf16 row takes no 2-byte loads. Its
//     random row reads reach ~50 % of the byte bound on the H100 whatever
//     the row's width. (Staging a CTA's ids in shared memory and 16-byte
//     words for the spans measured 5-10 % and 10-90 % slower: PERF.md.)
// ops/gather.py::scatter_plan picks G and the unit, transpose_plan the
// transpose's kernels.
#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE_THREADS = 1024;  // a plan tile's CTA
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ROWS = 4096;     // dv rows a scan CTA offsets
constexpr int PIECE_MAX = 12288;    // window rows of a plan tile
constexpr int PART_MAX = 8192;      // entries of a plan tile
constexpr int EPT = 8;              // entries a plan-tile thread holds
constexpr int BATCH_LOADS = 16;     // idx loads in flight, batch kernel

__device__ __forceinline__ int window_lo(const int* starts, int t, int n,
                                         int window) {
  return min(max(__ldg(starts + t), 0), n - window);
}

// Exclusive scan of one int per thread over the CTA; *total gets the sum.
// Every thread of the CTA calls it (it synchronises).
__device__ int block_exclusive_scan(int v, int* wsum, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nw ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nw) wsum[lane] = s;
  }
  __syncthreads();
  const int before = warp ? wsum[warp - 1] : 0;
  *total = wsum[nw - 1];
  __syncthreads();
  return before + x - v;
}

// A plan tile: entries [e0, e1) of query tile t (part `part` of it) whose
// index lies in the rows [r0, r1) of the tile's window (piece `piece` of
// it). Plan tiles of one batch element are numbered
// pt = (t * parts + part) * pieces + piece: a row's ids come from plan
// tiles in ascending (t, part), so in ascending entry id.
struct PlanTile {
  int t, part, piece, e0, e1, r0, r1;
};

__device__ __forceinline__ PlanTile plan_tile(const int* starts, int b,
                                              int pt, int T, int parts,
                                              int pieces, int E, int n,
                                              int window) {
  PlanTile p;
  p.piece = pt % pieces;
  p.part = (pt / pieces) % parts;
  p.t = pt / (pieces * parts);
  const int ep = (E + parts - 1) / parts, wp = (window + pieces - 1) / pieces;
  p.e0 = p.t * E + p.part * ep;
  p.e1 = p.t * E + min(E, (p.part + 1) * ep);
  const int lo = window_lo(starts, b * T + p.t, n, window);
  p.r0 = lo + p.piece * wp;
  p.r1 = lo + min(window, (p.piece + 1) * wp);
  return p;
}

// The plan tile's entries a thread holds: e = e0 + threadIdx.x + j *
// blockDim.x (j < EPT), and each one's row in the tile's rows, or -1 where
// its index lies outside them (one coalesced pass over idx; unsigned: an
// index below r0 wraps past them).
struct Held {
  int row[EPT];
};

__device__ __forceinline__ Held hold_entries(const int* ixb,
                                             const PlanTile& p) {
  Held h;
  const unsigned rows = (unsigned)(p.r1 - p.r0);
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int e = p.e0 + threadIdx.x + j * blockDim.x;
    const unsigned r =
        e < p.e1 ? (unsigned)__ldg(ixb + e) - (unsigned)p.r0 : rows;
    h.row[j] = r < rows ? (int)r : -1;
  }
  return h;
}

// [lo, hi) of the rows the CTA's held entries reach (lo >= hi: none).
// Every thread calls it (it synchronises).
__device__ int2 held_span(const Held& h, int* wlo, int* whi) {
  int lo = INT_MAX, hi = -1;
#pragma unroll
  for (int j = 0; j < EPT; ++j)
    if (h.row[j] >= 0) {
      lo = min(lo, h.row[j]);
      hi = max(hi, h.row[j]);
    }
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    wlo[warp] = lo;
    whi[warp] = hi;
  }
  __syncthreads();
  lo = INT_MAX;
  hi = -1;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    lo = min(lo, wlo[w]);
    hi = max(hi, whi[w]);
  }
  __syncthreads();
  return make_int2(lo, hi + 1);
}

// 1. Each plan tile's ids per row, over the span of rows its entries reach
// (span [B, T'] int2, relative to the tile's first row; hist [B, T', wp]
// u16, written inside the span only), added to the rows' counts (cnt
// [B * n], zeroed) and to the counts of the SCAN_ROWS-row blocks they fall
// in (tot, zeroed). Dynamic shared memory: wp ints.
__global__ void __launch_bounds__(TILE_THREADS, 2)
scatter_hist_kernel(const int* __restrict__ idx,
                    const int* __restrict__ starts,
                    unsigned short* __restrict__ hist,
                    int2* __restrict__ span, int* __restrict__ cnt,
                    int* __restrict__ tot, int n, int nq, int k, int window,
                    int tq, int parts, int pieces) {
  extern __shared__ int h[];
  __shared__ int wsum[32][5], wlo[32], whi[32];
  const int b = blockIdx.y, pt = blockIdx.x, npt = gridDim.x;
  const int T = nq / tq, E = tq * k;
  const int wp = (window + pieces - 1) / pieces;
  const PlanTile p = plan_tile(starts, b, pt, T, parts, pieces, E, n, window);
  const Held held = hold_entries(idx + (size_t)b * nq * k, p);
  int2 sp = held_span(held, wlo, whi);
  if (sp.x >= sp.y) sp = make_int2(0, 0);   // no entry in the rows
  if (threadIdx.x == 0) span[(size_t)b * npt + pt] = sp;
  for (int r = sp.x + threadIdx.x; r < sp.y; r += blockDim.x) h[r] = 0;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < EPT; ++j)
    if (held.row[j] >= 0) atomicAdd(h + held.row[j], 1);
  __syncthreads();
  // the rows' counts, and each thread's share of the (at most 4) scan
  // blocks the rows fall in
  unsigned short* hb = hist + ((size_t)b * npt + pt) * wp;
  const long long g0 = (long long)b * n + p.r0;
  // the batch element's scan blocks: b * bpb + row / SCAN_ROWS
  const int bpb = (n + SCAN_ROWS - 1) / SCAN_ROWS;
  const long long s0 = (long long)b * bpb + p.r0 / SCAN_ROWS;
  int part[4] = {0, 0, 0, 0};
  for (int r = sp.x + threadIdx.x; r < sp.y; r += blockDim.x) {
    const int v = h[r];
    hb[r] = (unsigned short)v;
    if (v) {
      atomicAdd(cnt + g0 + r, v);
      const int j = (p.r0 + r) / SCAN_ROWS - p.r0 / SCAN_ROWS;
#pragma unroll
      for (int q = 0; q < 4; ++q) part[q] += q == j ? v : 0;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part[q] += __shfl_xor_sync(FULL, part[q], o);
    if (lane == 0) wsum[warp][q] = part[q];
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    int sum = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w)
      sum += wsum[w][threadIdx.x];
    if (sum) atomicAdd(tot + s0 + threadIdx.x, sum);
  }
}

// 2. rowptr [B, n + 1]: each batch element's rows' offsets in its run of
// ids, a CTA per SCAN_ROWS rows of one (its first offset the counts of its
// blocks before it); then a CTA per batch element: reach [B, T'], the
// last row + 1 that plan tiles 0..q reach (a running maximum over their
// spans), so that a plan tile finds the earlier ones that may share its
// rows by a binary search.
__global__ void __launch_bounds__(SCAN_THREADS)
scatter_scan_kernel(const int* __restrict__ cnt, const int* __restrict__ tot,
                    const int* __restrict__ starts,
                    const int2* __restrict__ span, int* __restrict__ rowptr,
                    int* __restrict__ reach, int blocks, int n, int nq, int k,
                    int window, int tq, int parts, int pieces) {
  __shared__ int wsum[32];
  const int blk = blockIdx.x;
  if (blk >= blocks) {
    const int b = blk - blocks, T = nq / tq, npt = T * parts * pieces;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int carry = INT_MIN;
    for (int q0 = 0; q0 < npt; q0 += blockDim.x) {
      const int q = q0 + threadIdx.x;
      int v = INT_MIN;
      if (q < npt) {
        const int2 sp = __ldg(span + (size_t)b * npt + q);
        if (sp.x < sp.y)
          v = plan_tile(starts, b, q, T, parts, pieces, tq * k, n,
                        window).r0 + sp.y;
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, v, o);
        if (lane >= o) v = max(v, y);
      }
      if (lane == 31) wsum[warp] = v;
      __syncthreads();
      for (int w = 0; w < warp; ++w) v = max(v, wsum[w]);
      v = max(v, carry);
      if (q < npt) reach[(size_t)b * npt + q] = v;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w)
        carry = max(carry, wsum[w]);
      __syncthreads();
    }
    return;
  }
  const int bpb = (n + SCAN_ROWS - 1) / SCAN_ROWS;
  const int b = blk / bpb, j0 = b * bpb;
  int s = 0;
  for (int j = j0 + threadIdx.x; j < blk; j += blockDim.x)
    s += __ldg(tot + j);
  int base;
  block_exclusive_scan(s, wsum, &base);
  constexpr int PER = SCAN_ROWS / SCAN_THREADS;
  const int r0 = (blk - j0) * SCAN_ROWS + threadIdx.x * PER;
  const int* cb = cnt + (size_t)b * n;
  int* out = rowptr + (size_t)b * (n + 1);
  int v[PER], sum = 0;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    v[q] = r0 + q < n ? __ldg(cb + r0 + q) : 0;
    sum += v[q];
  }
  int total;
  int run = base + block_exclusive_scan(sum, wsum, &total);
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    if (r0 + q < n) out[r0 + q] = run;
    run += v[q];
  }
  if (blk == j0 + bpb - 1 && threadIdx.x == 0) out[n] = base + total;
}

// 3. ids [B * nq * k]: a plan tile's ids of row r go after the row's ids
// of every earlier plan tile whose span holds r (from their counts), in
// ascending order: dropped into the row's run of a shared-memory list (a
// shared atomic each: any order), then each ranked among its run's.
// Dynamic shared memory: start[wp + 1], claimed[wp], first[wp] ints,
// four lists of the earlier plan tiles (blockDim.x ints each), list[ep]
// ints, list_row[ep] u16. At most 32 registers a thread: two 1024-thread
// CTAs an SM.
__global__ void __launch_bounds__(TILE_THREADS, 2)
scatter_place_transpose_kernel(const int* __restrict__ idx,
                               const int* __restrict__ starts,
                               const unsigned short* __restrict__ hist,
                               const int2* __restrict__ span,
                               const int* __restrict__ reach,
                               const int* __restrict__ rowptr,
                               int* __restrict__ ids, int n, int nq, int k,
                               int window, int tq, int parts, int pieces) {
  extern __shared__ int smem[];
  __shared__ int wsum[32], listed;
  const int b = blockIdx.y, pt = blockIdx.x, npt = gridDim.x;
  const int T = nq / tq, E = tq * k;
  const int wp = (window + pieces - 1) / pieces;
  const int ep = (E + parts - 1) / parts;
  const PlanTile p = plan_tile(starts, b, pt, T, parts, pieces, E, n, window);
  const int2 sp = __ldg(span + (size_t)b * npt + pt);
  if (sp.x >= sp.y) return;                   // no entry in the rows
  int* start = smem;
  int* claimed = start + wp + 1;
  int* first = claimed + wp;
  // the earlier plan tiles listed at once: number, first row, the rows
  // shared with this one
  int* near_pt = first + wp;
  int* near_r0 = near_pt + blockDim.x;
  int* near_lo = near_r0 + blockDim.x;
  int* near_hi = near_lo + blockDim.x;
  int* list = near_hi + blockDim.x;
  unsigned short* list_row = (unsigned short*)(list + ep);
  const unsigned short* hb = hist + (size_t)b * npt * wp;
  // the tile's entries (loaded with the tile's start and span), counted
  // again per row here rather than read back from hist
  const Held held = hold_entries(idx + (size_t)b * nq * k, p);
  for (int r = sp.x + threadIdx.x; r < sp.y; r += blockDim.x) claimed[r] = 0;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < EPT; ++j)
    if (held.row[j] >= 0) atomicAdd(claimed + held.row[j], 1);
  __syncthreads();
  // the runs over the span: a contiguous run of rows a thread
  const int rows = sp.y - sp.x;
  const int per = (rows + blockDim.x - 1) / blockDim.x;
  const int a0 = sp.x + min((int)threadIdx.x * per, rows);
  const int a1 = min(a0 + per, sp.x + rows);
  int sum = 0;
  for (int r = a0; r < a1; ++r) sum += claimed[r];
  int total;
  int run = block_exclusive_scan(sum, wsum, &total);
  for (int r = a0; r < a1; ++r) {
    const int v = claimed[r];
    start[r] = run;
    claimed[r] = 0;
    first[r] = v ? __ldg(rowptr + (size_t)b * (n + 1) + p.r0 + r) : 0;
    run += v;
  }
  if (threadIdx.x == 0) start[sp.x + rows] = total;
  // each row's ids in the earlier plan tiles (lower (t, part)) whose span
  // holds it, listed a CTA's width of plan tiles at a time from the first
  // one that reaches past this one's first row (reach is non-decreasing)
  const int own = pt - p.piece;
  const int* rb = reach + (size_t)b * npt;
  // the first of them: counted a CTA's width of plan tiles at a time from
  // the last, one load a thread, until one does not reach
  int from = own;
  for (int q1 = own; q1 > 0; q1 -= blockDim.x) {
    const int q = q1 - 1 - (int)threadIdx.x;
    const int past = __syncthreads_count(q >= 0 && __ldg(rb + q) >
                                                     p.r0 + sp.x);
    from = q1 - past;
    if (past < (int)blockDim.x) break;      // uniform
  }
  for (int q0 = from; q0 < own; q0 += blockDim.x) {
    if (threadIdx.x == 0) listed = 0;
    __syncthreads();
    const int q = q0 + threadIdx.x;
    if (q < own) {
      const PlanTile o = plan_tile(starts, b, q, T, parts, pieces, E, n,
                                   window);
      const int2 os = __ldg(span + (size_t)b * npt + q);
      const int lo = max(o.r0 + os.x, p.r0 + sp.x);
      const int hi = min(o.r0 + os.y, p.r0 + sp.y);
      if (lo < hi) {
        const int j = atomicAdd(&listed, 1);
        near_pt[j] = q;
        near_r0[j] = o.r0;
        near_lo[j] = lo - p.r0;
        near_hi[j] = hi - p.r0;
      }
    }
    __syncthreads();
    // a row at a time a thread, neighbouring threads on neighbouring rows,
    // four of the listed plan tiles' counts in flight
    const int m = listed;
    for (int r = sp.x + threadIdx.x; r < sp.y; r += blockDim.x) {
      if (start[r + 1] == start[r]) continue;
      int add = 0;
      for (int j0 = 0; j0 < m; j0 += 4) {
        int v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + u;
          v[u] = j < m && r >= near_lo[j] && r < near_hi[j]
                     ? hb[(size_t)near_pt[j] * wp + (p.r0 - near_r0[j]) + r]
                     : 0;
        }
        add += v[0] + v[1] + v[2] + v[3];
      }
      first[r] += add;
    }
    __syncthreads();
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int r = held.row[j];
    if (r >= 0) {
      const int slot = start[r] + atomicAdd(claimed + r, 1);
      list[slot] = p.e0 + threadIdx.x + j * blockDim.x;
      list_row[slot] = (unsigned short)r;
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < total; s += blockDim.x) {
    const int e = list[s], r = list_row[s];
    int rank = 0;
    for (int q = start[r]; q < start[r + 1]; ++q) rank += list[q] < e;
    ids[(size_t)b * nq * k + first[r] + rank] = e;
  }
}

// The transpose of a batch element whose nq * k ids fit in u16 and in a
// CTA's shared memory, its rows cut into runs of rb rows, a CTA each. A
// CTA reads all the batch element's entries (from L2 after the first CTA)
// and keeps those of its rows (16 loads in flight a thread): it counts
// them per row and counts the entries of every row before its own (its
// rows' first offset), scans its rows' offsets, drops each of its ids into
// its row's run (a shared atomic each: any order), ranks each in its run
// and writes them out contiguous. One launch, no scan across CTAs, no
// memset; the reads grow with the runs, the ids a CTA places shrink.
// Dynamic shared memory: start[rb + 1], claimed[rb] ints, list[nq * k]
// u16.
__global__ void __launch_bounds__(SCAN_THREADS)
scatter_batch_transpose_kernel(const int* __restrict__ idx,
                               const int* __restrict__ starts,
                               int* __restrict__ rowptr,
                               int* __restrict__ ids, int n, int nq, int k,
                               int window, int tq, int rb) {
  extern __shared__ int smem[];
  __shared__ int wsum[32];
  const int b = blockIdx.y, T = nq / tq, E = tq * k, ne = nq * k;
  const int r0 = blockIdx.x * rb, r1 = min(r0 + rb, n), rows = r1 - r0;
  int* start = smem;
  int* claimed = start + rb + 1;
  unsigned short* list = (unsigned short*)(claimed + rb);
  const int* ixb = idx + (size_t)b * ne;
  // the entry's tile by a multiplication (exact: entry * E < 2^32); its
  // index's row in the window, or -1
  const unsigned magic = E > 1 ? (unsigned)(((1ull << 32) + E - 1) / E) : 0;
  auto row_of = [&](int e, int i) {
    const int t = E > 1 ? (int)__umulhi((unsigned)e, magic) : e;
    const int lo = window_lo(starts, b * T + t, n, window);
    return (unsigned)i - (unsigned)lo < (unsigned)window ? i : -1;
  };
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    start[r] = 0;
    claimed[r] = 0;
  }
  __syncthreads();
  int below = 0;                          // this thread's entries below r0
  for (int e0 = threadIdx.x; e0 < ne; e0 += BATCH_LOADS * blockDim.x) {
    int i[BATCH_LOADS];
#pragma unroll
    for (int u = 0; u < BATCH_LOADS; ++u) {
      const int e = e0 + u * blockDim.x;
      i[u] = e < ne ? __ldg(ixb + e) : -1;
    }
#pragma unroll
    for (int u = 0; u < BATCH_LOADS; ++u) {
      const int e = e0 + u * blockDim.x;
      const int r = e < ne ? row_of(e, i[u]) : -1;
      if (r >= 0 && r < r0) ++below;
      if (r >= r0 && r < r1) atomicAdd(start + (r - r0), 1);
    }
  }
  int base;
  block_exclusive_scan(below, wsum, &base);   // (syncs: the counts done)
  // the offsets: a contiguous run of rows a thread
  const int per = (rows + blockDim.x - 1) / blockDim.x;
  const int a0 = min((int)threadIdx.x * per, rows), a1 = min(a0 + per, rows);
  int sum = 0;
  for (int r = a0; r < a1; ++r) sum += start[r];
  int total;
  int run = block_exclusive_scan(sum, wsum, &total);
  int* out = rowptr + (size_t)b * (n + 1) + r0;
  for (int r = a0; r < a1; ++r) {
    const int v = start[r];
    start[r] = run;
    out[r] = base + run;
    run += v;
  }
  if (threadIdx.x == 0) {
    start[rows] = total;
    if (r1 == n) out[rows] = base + total;
  }
  __syncthreads();
  for (int e0 = threadIdx.x; e0 < ne; e0 += BATCH_LOADS * blockDim.x) {
    int i[BATCH_LOADS];
#pragma unroll
    for (int u = 0; u < BATCH_LOADS; ++u) {
      const int e = e0 + u * blockDim.x;
      i[u] = e < ne ? __ldg(ixb + e) : -1;
    }
#pragma unroll
    for (int u = 0; u < BATCH_LOADS; ++u) {
      const int e = e0 + u * blockDim.x;
      const int r = e < ne ? row_of(e, i[u]) : -1;
      if (r >= r0 && r < r1)
        list[start[r - r0] + atomicAdd(claimed + (r - r0), 1)] =
            (unsigned short)e;
    }
  }
  __syncthreads();
  int* ib = ids + (size_t)b * ne + base;
  for (int q = threadIdx.x; q < total; q += blockDim.x) {
    // the slot's row: the last one starting at or before it
    int lo = 0, hi = rows;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (start[mid] <= q) lo = mid; else hi = mid - 1;
    }
    const int e = list[q];
    int rank = 0;
    for (int j = start[lo]; j < start[lo + 1]; ++j) rank += list[j] < e;
    ib[start[lo] + rank] = e;
  }
}

// ---------------------------------------------------------- sum pass ---

enum UnitKind { F32X1 = 0, F32X4 = 1, BF16X8 = 2, BF16X4 = 3, BF16SPAN = 4 };

__device__ __forceinline__ void widen_bf16x2(unsigned u, float* o) {
  o[0] = __uint_as_float(u << 16);  // the lower address
  o[1] = __uint_as_float(u & 0xffff0000u);
}

// One unit of a cotangent row: loaded (load: cotangent row `row`, unit u),
// widened and added to V f32 sums in channel order, and the sums stored
// into dv (a bf16's f32 is its 16 bits shifted up: exact).
template <int KIND> struct Unit;

template <> struct Unit<F32X1> {
  static constexpr int V = 1, LOADS = 16;
  using T = float;
  __device__ static int units(int c) { return c; }
  __device__ static T load(const void* g, long long row, int c, int u) {
    return __ldg((const float*)g + row * c + u);
  }
  __device__ static void add(float* acc, const T& y) { acc[0] += y; }
  __device__ static void store(float* o, const float* acc, int, int u) {
    o[u] = acc[0];
  }
};

template <> struct Unit<F32X4> {
  static constexpr int V = 4, LOADS = 8;
  using T = float4;
  __device__ static int units(int c) { return c / 4; }
  __device__ static T load(const void* g, long long row, int c, int u) {
    return __ldg((const float4*)g + row * (c / 4) + u);
  }
  __device__ static void add(float* acc, const T& y) {
    acc[0] += y.x;
    acc[1] += y.y;
    acc[2] += y.z;
    acc[3] += y.w;
  }
  __device__ static void store(float* o, const float* acc, int, int u) {
    reinterpret_cast<float4*>(o)[u] =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
};

template <> struct Unit<BF16X8> {
  static constexpr int V = 8, LOADS = 8;
  using T = uint4;
  __device__ static int units(int c) { return c / 8; }
  __device__ static T load(const void* g, long long row, int c, int u) {
    return __ldg((const uint4*)g + row * (c / 8) + u);
  }
  __device__ static void add(float* acc, const T& y) {
    float w[8];
    widen_bf16x2(y.x, w);
    widen_bf16x2(y.y, w + 2);
    widen_bf16x2(y.z, w + 4);
    widen_bf16x2(y.w, w + 6);
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[v] += w[v];
  }
  __device__ static void store(float* o, const float* acc, int, int u) {
    float4* p = reinterpret_cast<float4*>(o) + 2 * u;
    p[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    p[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
};

template <> struct Unit<BF16X4> {
  static constexpr int V = 4, LOADS = 8;
  using T = uint2;
  __device__ static int units(int c) { return c / 4; }
  __device__ static T load(const void* g, long long row, int c, int u) {
    return __ldg((const uint2*)g + row * (c / 4) + u);
  }
  __device__ static void add(float* acc, const T& y) {
    float w[4];
    widen_bf16x2(y.x, w);
    widen_bf16x2(y.y, w + 2);
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[v] += w[v];
  }
  __device__ static void store(float* o, const float* acc, int, int u) {
    reinterpret_cast<float4*>(o)[u] =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
};

// bf16 rows whose c is not a multiple of 4: unit u is channels
// [8u, min(8u + 8, c)), bf16 value h0 = row * c + 8u onwards of g, held by
// the aligned 8-byte words h0 / 4 .. (h0 + nv - 1) / 4 (1 to 3 of them,
// none past the unit's last value) and shifted by h0 % 4 values.
struct Span {
  uint2 w[3];
  int shift;
};

template <> struct Unit<BF16SPAN> {
  static constexpr int V = 8, LOADS = 4;
  using T = Span;
  __device__ static int units(int c) { return (c + 7) / 8; }
  __device__ static T load(const void* g, long long row, int c, int u) {
    const long long h0 = row * c + 8 * u;
    const int nv = min(8, c - 8 * u);
    const long long w0 = h0 >> 2, w1 = (h0 + nv - 1) >> 2;
    const uint2* p = (const uint2*)g + w0;
    T y;
    y.shift = (int)(h0 & 3);
    y.w[0] = __ldg(p);
    y.w[1] = w1 > w0 ? __ldg(p + 1) : make_uint2(0, 0);
    y.w[2] = w1 > w0 + 1 ? __ldg(p + 2) : make_uint2(0, 0);
    return y;
  }
  __device__ static void add(float* acc, const T& y) {
    const unsigned a[6] = {y.w[0].x, y.w[0].y, y.w[1].x,
                           y.w[1].y, y.w[2].x, y.w[2].y};
    const bool word = y.shift >> 1, half = y.shift & 1;
    unsigned s[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) s[i] = word ? a[i + 1] : a[i];
    float w[8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      widen_bf16x2(half ? __funnelshift_r(s[i], s[i + 1], 16) : s[i],
                   w + 2 * i);
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[v] += w[v];
  }
  __device__ static void store(float* o, const float* acc, int c, int u) {
    const int nv = min(8, c - 8 * u);
#pragma unroll
    for (int v = 0; v < 8; ++v)
      if (v < nv) o[8 * u + v] = acc[v];
  }
};

// G lanes per dv row; lane lg owns the units lg, lg + G, ... of the row
// and adds them over the row's ids in order.
// a sum CTA: 128 threads, 8 an SM (at most 64 registers a thread); 256,
// 4 an SM for the spans' wider units (measured on the H100, PERF.md)
template <int KIND> __host__ __device__ constexpr int sum_threads() {
  return KIND == BF16SPAN ? 256 : 128;
}

template <int KIND, int G>
__global__ void __launch_bounds__(sum_threads<KIND>(),
                                  1024 / sum_threads<KIND>())
scatter_sum_kernel(const void* __restrict__ g, const int* __restrict__ rowptr,
                   const int* __restrict__ ids, float* __restrict__ dv, int n,
                   int nq, int k, int c) {
  using U = Unit<KIND>;
  constexpr int ROWS = sum_threads<KIND>() / G, L = U::LOADS;
  const int lg = threadIdx.x % G;
  const int b = blockIdx.y, row = blockIdx.x * ROWS + threadIdx.x / G;
  if (row >= n) return;
  const size_t rg = (size_t)b * n + row;
  const int* rp = rowptr + (size_t)b * (n + 1) + row;
  const int p0 = __ldg(rp), p1 = __ldg(rp + 1);
  const long long first = (long long)b * nq * k;  // the batch's g rows
  ids += first;                                  // and its ids
  float* out = dv + rg * c;
  const int cu = U::units(c);
  for (int u = lg; u < cu; u += G) {
    float acc[U::V];
#pragma unroll
    for (int v = 0; v < U::V; ++v) acc[v] = 0.f;
    for (int i = p0; i < p1; i += L) {
      int e[L];
#pragma unroll
      for (int q = 0; q < L; ++q) e[q] = i + q < p1 ? __ldg(ids + i + q) : 0;
      typename U::T y[L];
#pragma unroll
      for (int q = 0; q < L; ++q)
        if (i + q < p1) y[q] = U::load(g, first + e[q], c, u);
#pragma unroll
      for (int q = 0; q < L; ++q)  // in order
        if (i + q < p1) U::add(acc, y[q]);
    }
    U::store(out, acc, c, u);
  }
}

template <int KIND, int G>
cudaError_t launch_sum(const void* g, const int* rowptr, const int* ids,
                       float* dv, int B, int n, int nq, int k, int c,
                       cudaStream_t s) {
  constexpr int rows = sum_threads<KIND>() / G;
  const dim3 grid((n + rows - 1) / rows, B);
  scatter_sum_kernel<KIND, G><<<grid, sum_threads<KIND>(), 0, s>>>(
      g, rowptr, ids, dv, n, nq, k, c);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_sum_g(int group, const void* g, const int* rowptr,
                         const int* ids, float* dv, int B, int n, int nq,
                         int k, int c, cudaStream_t s) {
#define K4_SUM(G) launch_sum<KIND, G>(g, rowptr, ids, dv, B, n, nq, k, c, s)
  switch (group) {
    case 1: return K4_SUM(1);
    case 2: return K4_SUM(2);
    case 4: return K4_SUM(4);
    case 8: return K4_SUM(8);
    case 16: return K4_SUM(16);
    default: return K4_SUM(32);
  }
#undef K4_SUM
}

constexpr size_t WHOLE_SMEM = 200 * 1024;  // the batch kernel's at most

size_t batch_smem(int rb, int ne) {
  return (size_t)(2 * rb + 1) * sizeof(int) + (size_t)ne * 2;
}

size_t place_smem(int wp, int ep, int threads) {
  return (size_t)(3 * wp + 1 + 4 * threads + ep) * sizeof(int) +
         (size_t)ep * sizeof(unsigned short);
}

// Lets a kernel take dynamic shared memory past the 48 KiB default (which
// bounds its static and dynamic shared memory together): the opt-in to all
// the card allows beside its static part, once a process.
template <typename K>
cudaError_t opt_in(K kernel, bool* done) {
  if (*done) return cudaSuccess;
  int dev = 0, most = 0;
  cudaFuncAttributes a{};
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most - (int)a.sharedSizeBytes);
  *done = e == cudaSuccess;
  return e;
}

}  // namespace

// The transpose of one windowed index set. idx [B, nq, k] i32; starts
// [B, nq / tq] i32; scratch hist [B, T', wp] u16, span [B, T'] int2 and
// reach [B, T'] i32 (T' = nq / tq * parts * pieces plan tiles, wp =
// ceil(window / pieces)), cnt [B * n] and right after it tot
// [B * ceil(n / SCAN_ROWS)] i32 (zeroed here); out rowptr [B, n + 1] (each
// batch element's offsets in its run of ids) and ids [B, nq * k] i32 (ids
// of batch element b are q * k + j within it; the first rowptr[b, n] of
// its run written). Plan
// (ops/gather.py::transpose_plan): each tile in `parts` runs of entries
// (at most PART_MAX) and its window in `pieces` runs of rows (at most
// PIECE_MAX); `threads` a plan tile (a multiple of 32 up to TILE_THREADS,
// holding a plan tile's entries EPT a thread); `whole` 1: a batch
// element's rows in `pieces` runs instead, a CTA each, with no scratch
// (scatter_batch_transpose_kernel; nq * k <= 65535 and its shared memory
// within WHOLE_SMEM).
extern "C" int scatter_transpose_launch(const void* idx, const void* starts,
                                        void* hist, void* span, void* reach,
                                        void* cnt, void* tot, void* rowptr,
                                        void* ids,
                                        int B, int n, int nq, int k,
                                        int window, int tq, int parts,
                                        int pieces, int threads, int whole,
                                        void* stream) {
  const int E = tq * k;
  const int ep = (E + parts - 1) / parts;
  if (B < 1 || B > 65535 || n < 1 || tq < 1 || nq < 0 || nq % tq ||
      k < 1 || window < 1 || window > n || parts < 1 || pieces < 1 ||
      (long long)B * nq * k >= (1LL << 31) || ep > PART_MAX ||
      (window + pieces - 1) / pieces > PIECE_MAX ||
      (long long)(nq / tq) * parts * pieces >= (1LL << 31) ||
      threads < 32 || threads > TILE_THREADS || threads % 32 ||
      ep > EPT * threads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (whole) {          // a batch element's rows in `pieces` runs, a CTA each
    const int rb = (n + pieces - 1) / pieces;
    const size_t smem = batch_smem(rb, nq * k);
    static bool batch_in = false;
    if (nq * k > 65535 || smem > WHOLE_SMEM)
      return (int)cudaErrorInvalidValue;
    if ((e = opt_in(scatter_batch_transpose_kernel, &batch_in)) != cudaSuccess)
      return (int)e;
    scatter_batch_transpose_kernel<<<dim3(pieces, B), SCAN_THREADS, smem, s>>>(
        (const int*)idx, (const int*)starts, (int*)rowptr, (int*)ids, n, nq,
        k, window, tq, rb);
    return (int)cudaGetLastError();
  }
  const long long rows = (long long)B * n;
  const int bpb = (n + SCAN_ROWS - 1) / SCAN_ROWS;
  const int blocks = B * bpb;
  if ((int*)tot != (int*)cnt + rows) return (int)cudaErrorInvalidValue;
  e = cudaMemsetAsync(cnt, 0, (rows + blocks) * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  if (nq == 0)
    return (int)cudaMemsetAsync(rowptr, 0, (rows + B) * sizeof(int), s);
  const int wp = (window + pieces - 1) / pieces;
  const dim3 grid((nq / tq) * parts * pieces, B);
  static bool hist_in = false, place_in = false;
  if ((e = opt_in(scatter_hist_kernel, &hist_in)) != cudaSuccess ||
      (e = opt_in(scatter_place_transpose_kernel, &place_in)) != cudaSuccess)
    return (int)e;
  scatter_hist_kernel<<<grid, threads, wp * sizeof(int), s>>>(
      (const int*)idx, (const int*)starts, (unsigned short*)hist,
      (int2*)span, (int*)cnt, (int*)tot, n, nq, k, window, tq, parts,
      pieces);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  scatter_scan_kernel<<<blocks + B, SCAN_THREADS, 0, s>>>(
      (const int*)cnt, (const int*)tot, (const int*)starts,
      (const int2*)span, (int*)rowptr, (int*)reach, blocks, n, nq, k,
      window, tq, parts, pieces);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const size_t smem = place_smem(wp, ep, threads);
  scatter_place_transpose_kernel<<<grid, threads, smem, s>>>(
      (const int*)idx, (const int*)starts, (const unsigned short*)hist,
      (const int2*)span, (const int*)reach, (const int*)rowptr, (int*)ids, n,
      nq, k, window, tq, parts, pieces);
  return (int)cudaGetLastError();
}

// dv [B, n, c] f32 (every value written) from g [B, nq, k, c] (f32 or
// bf16, as `unit` says) over the transpose (rowptr, ids). Plan
// (ops/gather.py::scatter_plan): `group` lanes per dv row (1 to 32), the
// unit (UnitKind: 0 float, 1 float4, 2 bf16 x 8, 3 bf16 x 4, 4 bf16 span
// of 8). g 16-byte aligned.
extern "C" int scatter_sum_launch(const void* g, const void* rowptr,
                                  const void* ids, void* dv, int B, int n,
                                  int nq, int k, int c, int group, int unit,
                                  void* stream) {
  if (B < 1 || B > 65535 || n < 1 || nq < 0 || k < 1 || c < 1 ||
      (group != 1 && group != 2 && group != 4 && group != 8 &&
       group != 16 && group != 32) ||
      unit < 0 || unit > 4 || ((unit == F32X4 || unit == BF16X4) && c % 4) ||
      (unit == BF16X8 && c % 8) || (uintptr_t)g % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* rp = (const int*)rowptr;
  const int* id = (const int*)ids;
  float* out = (float*)dv;
  switch (unit) {
    case F32X1:
      return (int)launch_sum_g<F32X1>(group, g, rp, id, out, B, n, nq, k, c,
                                      s);
    case F32X4:
      return (int)launch_sum_g<F32X4>(group, g, rp, id, out, B, n, nq, k, c,
                                      s);
    case BF16X8:
      return (int)launch_sum_g<BF16X8>(group, g, rp, id, out, B, n, nq, k,
                                       c, s);
    case BF16X4:
      return (int)launch_sum_g<BF16X4>(group, g, rp, id, out, B, n, nq, k,
                                       c, s);
    default:
      return (int)launch_sum_g<BF16SPAN>(group, g, rp, id, out, B, n, nq, k,
                                         c, s);
  }
}
