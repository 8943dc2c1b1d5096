// K6: exact k-nearest-neighbour search, pruned over the curve-sorted cloud.
//
// Replaces the TPU kernel ssdr_al_tpu/ops/knn.py::_knn_kernel (launched by
// _knn_pallas_single, the `pallas` KNN engine). For every query, the k
// nearest support points of the same cloud, ascending by squared distance,
// ties to the lower support index.
//
// Bound on the H100: the bytes are both clouds read once and k ints per
// query written (21.6 MB, 6.4 us at [6 x 40960] k=16); the TPU kernel and
// the first design here evaluated every (query, support) pair, 8
// operations of d2 and a compare each (1.35 ms of f32 issue at that
// shape), and one thread per query walking all of them issued ~11.5
// instructions a pair (8.7 ms). No brute-force design comes near the bytes,
// so this one evaluates fewer pairs: it skips what cannot enter.
// Design:
//  - The support and the queries of a batch row are sorted along the
//    morton curve over one box that holds both (for more than
//    ops/knn.py::KNN_SORT_MIN[K] support points: on smaller clouds the
//    sorts cost more than the boxes save): knn_codes_kernel computes
//    the codes of ops/knn.py::morton_codes bit for bit, torch.sort sorts
//    them stably, and knn_layout_kernel lays the sorted support out by
//    groups of four points with its original indices and gives each block
//    of 32 sorted points a bounding box, each super-block of 32 blocks one
//    more (ops/knn.py::knn_sorted_inputs is the plain version of these
//    steps). The K = 1 and 16 walk copies the tables into shared memory where three
//    CTAs an SM still fit (at ~20 000 points and fewer for k=16; beyond,
//    it reads the block boxes through L1, 9 % faster at 40960 points than
//    two CTAs with the tables, kernels/measure.py --k6-only), and reads
//    each query through its sort order.
//  - K = 1 and 16 (knn_walk_kernel): a warp owns 32 consecutive sorted
//    queries, a lane each. It starts at the block of
//    its middle query's rank in the support (its own rank on a
//    self-search, else a 32-way search of the sorted codes), fills its
//    top-k from that block at once (a bitonic sort), then spirals over
//    super-blocks and, in a super-block it keeps, over its blocks. It skips a (super-)block when the least d2 to its
//    box, rounded so that it is never above a candidate's d2
//    (key_topk.cuh::box_lb), is strictly above every lane's k-th best: a
//    candidate at equal d2 may still enter on a lower index. A kept block
//    is copied into the warp's slot of shared memory with its original
//    indices (one coalesced 384-byte read), and evaluated with K1's
//    machinery (key_topk.cuh): the group filter in FMA form and buffered
//    warp-wide insertions of (d2, original index) keys.
//  - Rank order is not distance order, so every super-box is tested; the
//    two levels keep that to ~40 tests a warp at 40960 points plus 32 for
//    each kept super-block. On degenerate clouds (every point alike, or
//    codes all equal) the boxes exclude nothing and the walk evaluates
//    every pair: slower, and still exact.
//  - Small clouds take the first design instead (knn_brute_kernel: a thread
//    per query over every support point, streamed through shared memory),
//    where a warp's walk costs more than it prunes; ops/knn.py::
//    knn_tiled_route picks the route by the support's size and k, from
//    kernels/measure.py --k6-only's times of every route at every call of
//    the three exact pyramids.
//
// Widths: the kernels are instantiated for K = 1, 16 and 64 (ops/knn.py::
// KNN_K). A call with k runs the least K >= k and writes the first k keys
// of each query's list: the keys (d2, original index) are a total order,
// so the first k of the top-K are the top-k. K = 64 serves the partition's
// 46-NN graph (partition/superpoint.py::knn_graph, k_geof + 1), ~140 000
// queries a room. A lane-per-query list of 64 keys takes 128 registers a
// thread (one CTA an SM, 8 warps to hide a chain of dependent steps), a
// 63-step insertion a key, a skip bound at the 64th key where the output
// needs the kout-th, and box tests that keep what any of 32 queries needs;
// so K = 64 has a walk of its own (knn_walk64_kernel): a warp a query.
//  - Its list is warp_topk.cuh's WarpTopK64: 64 keys over the 32 lanes (2
//    registers' worth a lane), candidates merged a block at a time.
//  - The fill takes the query's block and its neighbour on the side of the
//    query's rank, 64 candidates sorted at once: the bound is finite
//    before the walk starts (with fewer real candidates, the empty key
//    (+inf, 0) fills the rest, and a slot past Ns reads index 0).
//  - The lanes test 32 super-boxes at a time (in spiral order from the
//    query's super-block), then, in a kept super-block, its 32 block boxes
//    at once; each level is visited nearest box first (a warp minimum of
//    the box_lb bits, then the lowest lane holding it), so the bound
//    tightens soonest, and ends at the first box whose box_lb is strictly
//    above the kout-th key's d2: every later box of the level is as far.
//    Each test is the query's own: no union of 32 queries, no divergence.
//  - A kept block's 32 points are keyed a lane each (coalesced reads of the
//    groups and original indices) and offered to the list.
//  - 128 threads a CTA (4 queries), 9 CTAs an SM, with no dynamic shared
//    memory: the boxes are read through L1, and ~140 000 queries make
//    ~35 000 small CTAs that fill every SM evenly.
//
// Numerics: d2 = (dx*dx + dy*dy) + dz*dz with round-to-nearest intrinsics
// and no FMA contraction, as the plain PyTorch version
// (ops/knn.py::_knn_tiled_plain) computes it on the unsorted clouds: the
// sort moves rows, not values, and the keys carry the original index, so
// the two agree index for index, ties included. With fewer than k support
// points the slots past them hold index 0 (the empty key), as the TPU
// kernel's zero-initialised best indices do.
#include <cuda_runtime.h>
#include <math.h>

#include "key_topk.cuh"
#include "warp_topk.cuh"

namespace {

constexpr int kBlk = 32;     // sorted support points a block
constexpr int kSup = 32;     // blocks a super-block
constexpr int kBuf6 = 24;    // buffered candidates per thread
constexpr int kThreads = 256;
constexpr int kStage = 128;  // floats of a warp's staged block: 96 + 32 ids

// lohi [B][6]: the least and largest x, y, z of the support and, unless
// it is a self-search, the queries of each batch row (one CTA of 1024
// threads a row).
__global__ void __launch_bounds__(1024)
    knn_bounds_kernel(const float* __restrict__ support,
                      const float* __restrict__ query,
                      float* __restrict__ lohi, int ns, int nq) {
  __shared__ float red[32][6];
  const int b = blockIdx.x, tid = threadIdx.x;
  float v[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY,
                -INFINITY};
  for (int part = 0; part < 2; ++part) {
    const float* f = part ? query + (size_t)b * nq * 3
                          : support + (size_t)b * ns * 3;
    const int n = part ? nq : ns;
#pragma unroll 4
    for (int i = tid; i < n; i += 1024)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float x = __ldg(f + 3 * i + a);
        v[a] = fminf(v[a], x);
        v[3 + a] = fmaxf(v[3 + a], x);
      }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      v[a] = fminf(v[a], __shfl_xor_sync(kFull, v[a], off));
      v[3 + a] = fmaxf(v[3 + a], __shfl_xor_sync(kFull, v[3 + a], off));
    }
  if ((tid & 31) == 0)
#pragma unroll
    for (int a = 0; a < 6; ++a) red[tid >> 5][a] = v[a];
  __syncthreads();
  if (tid < 6) {
    float m = red[0][tid];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      m = tid < 3 ? fminf(m, red[w][tid]) : fmaxf(m, red[w][tid]);
    lohi[b * 6 + tid] = m;
  }
}

// 10 bits spread over 30 (every third position), as ops/knn.py::_part1by2
__device__ __forceinline__ int part1by2(int x) {
  x &= 0x3ff;
  x = (x | (x << 16)) & 0x30000ff;
  x = (x | (x << 8)) & 0x300f00f;
  x = (x | (x << 4)) & 0x30c30c3;
  x = (x | (x << 2)) & 0x9249249;
  return x;
}

// The 30-bit morton codes of ops/knn.py::morton_codes over the box lohi:
// support points first, then queries (nq = 0 on a self-search); each
// coordinate (x - lo) / max(hi - lo, 1e-9) * 1023 rounded as PyTorch
// rounds it, truncated to an integer and clamped to [0, 1023].
__global__ void knn_codes_kernel(const float* __restrict__ support,
                                 const float* __restrict__ query,
                                 const float* __restrict__ lohi,
                                 int* __restrict__ scodes,
                                 int* __restrict__ qcodes, int ns, int nq) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ns + nq) return;
  const float* p = i < ns ? support + ((size_t)b * ns + i) * 3
                          : query + ((size_t)b * nq + i - ns) * 3;
  const float* box = lohi + b * 6;
  int c[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float span = fmaxf(__fsub_rn(box[3 + a], box[a]), 1e-9f);
    const float t = __fmul_rn(__fdiv_rn(__fsub_rn(p[a], box[a]), span),
                              1023.0f);
    c[a] = min(max((int)t, 0), 1023);
  }
  const int code =
      part1by2(c[0]) | (part1by2(c[1]) << 1) | (part1by2(c[2]) << 2);
  if (i < ns)
    scodes[(size_t)b * ns + i] = code;
  else
    qcodes[(size_t)b * nq + i - ns] = code;
}

// The sorted support laid out for the walk: groups [B][nblk * 8][x[4],
// y[4], z[4]] (NaN pads past ns), order [B][nblk * 32] (the original
// index of each sorted rank, 0 on pads), and boxes [B][nsup + nblk][lo xyz
// _, hi xyz _], the super-blocks' then the blocks' (sorder null: the
// support in its original order). One CTA of 32 warps
// per super-block, a warp per block, a lane per point; fminf / fmaxf skip
// the NaN pads.
__global__ void __launch_bounds__(1024)
    knn_layout_kernel(const float* __restrict__ support,
                      const long long* __restrict__ sorder,
                      float* __restrict__ groups, int* __restrict__ order,
                      float* __restrict__ boxes, int ns, int nblk,
                      int nsup) {
  __shared__ float red[32][6];
  const int b = blockIdx.y, sb = blockIdx.x;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int blk = sb * kSup + w;
  const int r = blk * kBlk + lane;
  float x = __int_as_float(0x7fc00000), y = x, z = x;
  int o = 0;
  if (r < ns) {
    o = sorder ? (int)sorder[(size_t)b * ns + r] : r;
    const float* p = support + ((size_t)b * ns + o) * 3;
    x = p[0];
    y = p[1];
    z = p[2];
  }
  if (blk < nblk) {
    float* g = groups + ((size_t)b * nblk * 8 + (r >> 2)) * 12 + (r & 3);
    g[0] = x;
    g[4] = y;
    g[8] = z;
    order[(size_t)b * nblk * kBlk + r] = o;
  }
  float v[6] = {x, y, z, x, y, z};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      v[a] = fminf(v[a], __shfl_xor_sync(kFull, v[a], off));
      v[3 + a] = fmaxf(v[3 + a], __shfl_xor_sync(kFull, v[3 + a], off));
    }
  // a block of pads only (past nblk) reads as the empty box
  if (blk >= nblk)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      v[a] = INFINITY;
      v[3 + a] = -INFINITY;
    }
  float4* tab = reinterpret_cast<float4*>(boxes) + (size_t)b * (nsup + nblk) * 2;
  if (lane == 0) {
    if (blk < nblk) {
      tab[2 * (nsup + blk)] = make_float4(v[0], v[1], v[2], 0.f);
      tab[2 * (nsup + blk) + 1] = make_float4(v[3], v[4], v[5], 0.f);
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) red[w][a] = v[a];
  }
  __syncthreads();
  if (w == 0) {
#pragma unroll
    for (int a = 0; a < 6; ++a) v[a] = red[lane][a];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        v[a] = fminf(v[a], __shfl_xor_sync(kFull, v[a], off));
        v[3 + a] = fmaxf(v[3 + a], __shfl_xor_sync(kFull, v[3 + a], off));
      }
    if (lane == 0) {
      tab[2 * sb] = make_float4(v[0], v[1], v[2], 0.f);
      tab[2 * sb + 1] = make_float4(v[3], v[4], v[5], 0.f);
    }
  }
}

// The first index of the ascending codes[0, n) not below key (lower
// bound), found by the whole warp: each round probes 32 evenly spaced
// positions and keeps the span between the last probe below key and the
// next.
__device__ __forceinline__ int warp_lower_bound(const int* codes, int n,
                                                int key, int lane) {
  int lo = 0, hi = n;
  while (hi > lo) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + lane * step;
    const int c =
        __popc(__ballot_sync(kFull, p < hi && __ldg(codes + p) < key));
    if (c == 0) break;
    const int top = lo + c * step;  // the first probe at or above key
    lo += (c - 1) * step + 1;
    hi = min(hi, top);
  }
  return lo;
}

// groups, order, boxes as knn_layout_kernel writes them; query [B][nq][3]
// in its original order, qorder [B][nq] the original row of each sorted
// query, scodes / qcodes the sorted codes (all three null when the clouds
// were left in their original order); out [B][nq][K] by original query
// row. stats, when given, gains [the (query, candidate) pairs
// evaluated, blocks kept, block box tests (each a warp's), keys buffered
// (each a lane's), insertion rounds (each a warp's)]; each query's first
// kout <= K keys are written. K = 1 and 16 (K = 64 has knn_walk64_kernel):
// at most 85 registers a thread, so that three CTAs fit on an SM
// (ops/knn.py::knn_tiled_plan keeps the box tables in shared memory only
// where that many CTAs still fit).
template <int K>
__global__ void __launch_bounds__(kThreads, 3)
    knn_walk_kernel(const float* __restrict__ groups,
                    const int* __restrict__ order,
                    const float* __restrict__ boxes,
                    const float* __restrict__ query,
                    const long long* __restrict__ qorder,
                    const int* __restrict__ scodes,
                    const int* __restrict__ qcodes, int* __restrict__ out,
                    u64* __restrict__ stats, int ns, int nq, int kout,
                    int nblk, int nsup, int boxes_in_smem, int self_search) {
  // [super boxes][block boxes, where they fit][warp stages][buffers]
  extern __shared__ __align__(16) float smem[];
  const int nwarp = blockDim.x >> 5;
  const int ntab = boxes_in_smem ? nsup + nblk : nsup;
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* stage = smem + ntab * 8;
  u64* buf = reinterpret_cast<u64*>(stage + nwarp * kStage);
  const int b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float4* tab =
      reinterpret_cast<const float4*>(boxes) + (size_t)b * (nsup + nblk) * 2;
  for (int i = tid; i < ntab * 2; i += blockDim.x) sbox[i] = tab[i];
  __syncthreads();
  const float4* bbox = (boxes_in_smem ? sbox : tab) + 2 * nsup;

  const int r0 = (blockIdx.x * nwarp + warp) * 32;  // the warp's first query
  if (r0 >= nq) return;  // warp-uniform, after the CTA's last barrier
  const bool live = r0 + lane < nq;
  const int r = min(r0 + lane, nq - 1);
  const int row = qorder ? (int)qorder[(size_t)b * nq + r] : r;
  const float* qp = query + ((size_t)b * nq + row) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const int mid = min(r0 + 16, nq - 1);
  const int p0 = self_search ? mid
                 : scodes    ? warp_lower_bound(scodes + (size_t)b * ns, ns,
                                                qcodes[(size_t)b * nq + mid],
                                                lane)
                             : 0;
  const int blk0 = min(p0 / kBlk, nblk - 1);
  const int sb0 = blk0 / kSup;

  float* sg = stage + warp * kStage;  // 8 groups of 12 floats, then 32 ids
  const unsigned* sid = reinterpret_cast<const unsigned*>(sg + 96);
  const float* gb = groups + (size_t)b * nblk * 96;
  const int* ob = order + (size_t)b * nblk * kBlk;
  auto stage_block = [&](int blk) {
    __syncwarp();  // every lane is done with the previous block
    const float* g = gb + (size_t)blk * 96;
    sg[lane] = g[lane];
    sg[lane + 32] = g[lane + 32];
    sg[lane + 64] = g[lane + 64];
    reinterpret_cast<int*>(sg + 96)[lane] = ob[blk * kBlk + lane];
    __syncwarp();
  };

  KeyTopK<K, kBuf6, true> top;
  top.init(buf + tid, blockDim.x);
  // what the walk did, for `stats`: real candidates evaluated by each lane,
  // blocks kept and box tests by the warp, keys buffered by each lane,
  // insertion rounds of the warp
  long long seen = 0;
  int kept = 0, tests = 0, keys = 0, rounds = 0;
  auto flush = [&]() {
    keys += top.cnt;
    rounds += (int)__reduce_max_sync(kFull, (unsigned)top.cnt);
    top.flush(1);
  };
  // the fill: the first min(K, 32) candidates of blk0 sorted at once (at
  // K = 64 half the list; the rest stays empty, behind every real key)
  constexpr int kFill = K < kBlk ? K : kBlk;
  int first = 0;       // groups of blk0 the fill took
  if constexpr (K % 8 == 0) {
    if (blk0 * kBlk + kFill <= ns) {
      stage_block(blk0);
#pragma unroll
      for (int m = 0; m < kFill / 4; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          top.bk[4 * m + c] = make_key(
              sq_dist(qx, qy, qz, sg[12 * m + c], sg[12 * m + 4 + c],
                      sg[12 * m + 8 + c]),
              sid[4 * m + c]);
      key_sort<kFill>(top.bk);
      top.flush(1);  // nothing buffered: sets the threshold
      first = kFill / 4;
      seen = kFill;
    }
  }
  // the spiral: sb0, sb0 + 1, sb0 - 1, sb0 + 2, ... over the super-blocks,
  // and in each kept one over its blocks from the one nearest blk0
  for (int i = 0; i < 2 * nsup; ++i) {
    const int dsb = (i + 1) >> 1;
    const int sb = (i & 1) ? sb0 + dsb : sb0 - dsb;
    if (sb < 0 || sb >= nsup) continue;
    if (!__any_sync(kFull, !(box_lb(sbox[2 * sb], sbox[2 * sb + 1], qx, qy,
                                    qz) > top.thr_d)))
      continue;
    // blk0's super-block in a spiral from blk0; one above it upwards from
    // its first block, one below downwards from its last
    const int lo_b = sb * kSup, hi_b = min(lo_b + kSup, nblk);
    const int steps = sb == sb0 ? 2 * kSup : hi_b - lo_b;
    for (int j = 0; j < steps; ++j) {
      const int db = (j + 1) >> 1;
      const int blk = sb > sb0   ? lo_b + j
                      : sb < sb0 ? hi_b - 1 - j
                      : (j & 1)  ? blk0 + db
                                 : blk0 - db;
      if (blk < lo_b || blk >= hi_b) continue;
      ++tests;
      if (!__any_sync(kFull, !(box_lb(bbox[2 * blk], bbox[2 * blk + 1], qx,
                                      qy, qz) > top.thr_d)))
        continue;
      ++kept;
      stage_block(blk);
      const int m0 = blk == blk0 ? first : 0;
      seen += min(kBlk, ns - blk * kBlk) - 4 * m0;
      for (int m = m0; m < 8; m += 2) {
        visit_group(top, qx, qy, qz, sg + 12 * m,
                    [&](int c) { return sid[4 * m + c]; });
        if (m + 1 < 8)
          visit_group(top, qx, qy, qz, sg + 12 * (m + 1),
                      [&](int c) { return sid[4 * (m + 1) + c]; });
        if (top.nearly_full()) flush();
      }
    }
  }
  if (K > 1) flush();

  if (stats) {
    const u64 live_n = (u64)min(32, nq - r0);
    const unsigned all_keys = __reduce_add_sync(kFull, (unsigned)keys);
    if (lane == 0) {
      atomicAdd(stats, (u64)seen * live_n);
      atomicAdd(stats + 1, (u64)kept);
      atomicAdd(stats + 2, (u64)tests);
      atomicAdd(stats + 3, (u64)all_keys);
      atomicAdd(stats + 4, (u64)rounds);
    }
  }
  if (!live) return;
  int* o = out + ((size_t)b * nq + row) * kout;
  if (K % 4 == 0 && kout == K) {
#pragma unroll
    for (int j = 0; j < K; j += 4)
      *reinterpret_cast<int4*>(o + j) = make_int4(
          (int)(unsigned)top.bk[j], (int)(unsigned)top.bk[j + 1],
          (int)(unsigned)top.bk[j + 2], (int)(unsigned)top.bk[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (j < kout) o[j] = (int)(unsigned)top.bk[j];
  }
}

// The K = 64 walk: a warp a query, kQ64 queries a CTA of kThreads64.
constexpr int kThreads64 = 128;
constexpr int kQ64 = kThreads64 / 32;
constexpr unsigned kDone = 0xffffffffu;  // a box visited, or no box

// The t-th of [0, n) in spiral order from c0: c0, c0 + 1, c0 - 1, c0 + 2,
// c0 - 2, ..., and once one side ends, the other side on its own.
__device__ __forceinline__ int spiral_at(int t, int c0, int n) {
  const int below = c0, above = n - 1 - c0, m = min(below, above);
  if (t <= 2 * m) return (t & 1) ? c0 + ((t + 1) >> 1) : c0 - (t >> 1);
  return above > below ? c0 + (t - m) : c0 - (t - m);
}

// K6 for 16 < k <= 64 (the partition's k = 46): the arguments as
// knn_walk_kernel's; a warp a query (its rank r in the sorted queries), a
// WarpTopK64 list. The fill takes the query's block blk0 (that of its own
// rank on a self-search, else of the 32-way search of the sorted codes, 0
// in the clouds' own order) and its neighbour on the side of the query's
// rank within it (blk0 - 1 for the first half, blk0 + 1 for the second, the
// other one at either end). Then the super-blocks, 32 at a time in spiral
// order from blk0's, each group nearest box first, and in each kept
// super-block its blocks but the fill's, nearest box first; a level ends
// at the first box whose box_lb is strictly above the list's kout-th d2.
// stats, when given, gains [pairs evaluated, blocks kept, box tests, keys
// merged, merges], each summed over the queries. At most 64 registers a
// thread (56 with nvcc 12.8), so 9 CTAs of 4 warps an SM: 128-thread CTAs
// fit 36 warps where 256-thread ones fit 32, and timed faster on the
// H100; 64-thread ones timed as 128, fewer registers spilled.
__global__ void __launch_bounds__(kThreads64, 8)
    knn_walk64_kernel(const float* __restrict__ groups,
                      const int* __restrict__ order,
                      const float* __restrict__ boxes,
                      const float* __restrict__ query,
                      const long long* __restrict__ qorder,
                      const int* __restrict__ scodes,
                      const int* __restrict__ qcodes, int* __restrict__ out,
                      u64* __restrict__ stats, int ns, int nq, int kout,
                      int nblk, int nsup, int self_search) {
  __shared__ u64 slots[kQ64][64];
  __shared__ u64 tally[5];
  const int b = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kQ64 + warp;  // the warp's sorted query
  if (stats) {
    if (threadIdx.x < 5) tally[threadIdx.x] = 0;
    __syncthreads();
  }
  if (r < nq) {  // warp-uniform
    const int row = qorder ? (int)qorder[(size_t)b * nq + r] : r;
    const float* qp = query + ((size_t)b * nq + row) * 3;
    const float qx = qp[0], qy = qp[1], qz = qp[2];
    const int p0 = self_search ? r
                   : scodes    ? warp_lower_bound(scodes + (size_t)b * ns, ns,
                                                  qcodes[(size_t)b * nq + r],
                                                  lane)
                               : 0;
    const int blk0 = min(p0 / kBlk, nblk - 1);
    int fa = blk0, fb = blk0 + 1;  // fa = -1 where nblk == 1
    if (((p0 & (kBlk - 1)) < kBlk / 2 && blk0 > 0) || fb >= nblk) {
      fa = blk0 - 1;
      fb = blk0;
    }
    const float4* sup =
        reinterpret_cast<const float4*>(boxes) + (size_t)b * (nsup + nblk) * 2;
    const float4* bbox = sup + 2 * nsup;
    const float* gb = groups + (size_t)b * nblk * 96;
    const int* ob = order + (size_t)b * nblk * kBlk;
    // this lane's candidate of block blk (pad where blk has no such point)
    auto key_of = [&](int blk, u64 pad) -> u64 {
      const int rank = blk * kBlk + lane;
      if (blk < 0 || rank >= ns) return pad;
      const float* g = gb + (size_t)blk * 96 + (lane >> 2) * 12 + (lane & 3);
      return make_key(sq_dist(qx, qy, qz, __ldg(g), __ldg(g + 4),
                              __ldg(g + 8)),
                      (unsigned)__ldg(ob + rank));
    };
    auto real = [&](int blk) { return blk < 0 ? 0 : min(kBlk, ns - blk * kBlk); };

    WarpTopK64 top;
    top.slots = slots[warp];
    top.kout = kout;
    top.lane = lane;
    top.fill(key_of(fa, kEmpty), key_of(fb, kEmpty));
    // what the walk did, for `stats` (the same on every lane)
    u64 pairs = real(fa) + real(fb);
    unsigned kept = 0, tests = 0, keys = 0, merges = 0;
    const int sb0 = blk0 / kSup;
    for (int t0 = 0; t0 < nsup; t0 += 32) {
      const int t = t0 + lane;
      const int sb = t < nsup ? spiral_at(t, sb0, nsup) : 0;
      unsigned lbs = kDone;
      if (t < nsup)
        lbs = __float_as_uint(
            box_lb(__ldg(sup + 2 * sb), __ldg(sup + 2 * sb + 1), qx, qy, qz));
      tests += min(32, nsup - t0);
      for (;;) {
        const unsigned ms = __reduce_min_sync(kFull, lbs);
        if (ms == kDone || __uint_as_float(ms) > top.thr_d) break;
        const int js = __ffs(__ballot_sync(kFull, lbs == ms)) - 1;
        if (lane == js) lbs = kDone;
        const int blk = __shfl_sync(kFull, sb, js) * kSup + lane;
        const bool open = blk < nblk && blk != fa && blk != fb;
        unsigned lbb = kDone;
        if (open)
          lbb = __float_as_uint(box_lb(__ldg(bbox + 2 * blk),
                                       __ldg(bbox + 2 * blk + 1), qx, qy, qz));
        tests += __popc(__ballot_sync(kFull, open));
        for (;;) {
          const unsigned mb = __reduce_min_sync(kFull, lbb);
          if (mb == kDone || __uint_as_float(mb) > top.thr_d) break;
          const int jb = __ffs(__ballot_sync(kFull, lbb == mb)) - 1;
          if (lane == jb) lbb = kDone;
          const int vb = __shfl_sync(kFull, blk, jb);
          const int entered = top.offer(key_of(vb, ~0ull));
          ++kept;
          pairs += real(vb);
          keys += entered;
          merges += entered > 0;
        }
      }
    }
    if (stats && lane == 0) {
      atomicAdd(tally, pairs);
      atomicAdd(tally + 1, (u64)kept);
      atomicAdd(tally + 2, (u64)tests);
      atomicAdd(tally + 3, (u64)keys);
      atomicAdd(tally + 4, (u64)merges);
    }
    int* o = out + ((size_t)b * nq + row) * kout;
    if (lane < kout) o[lane] = (int)(unsigned)top.a;
    if (32 + lane < kout) o[32 + lane] = (int)(unsigned)top.b;
  }
  if (stats) {
    __syncthreads();
    if (threadIdx.x < 5) atomicAdd(stats + threadIdx.x, tally[threadIdx.x]);
  }
}

// Dynamic shared memory of the walk (ops/knn.py::knn_tiled_plan computes
// the same; the launcher refuses a launch where the two differ): for
// K = 1 and 16 the box tables (only the super-blocks' where both do not
// fit), a stage a warp, and the candidate buffers for k > 1; none for
// K = 64 (its 2 KiB of list slots are static, its boxes read through L1).
size_t knn_walk_smem(int nblk, int nsup, int k, int boxes_in_smem) {
  if (k > 16) return 0;
  return (size_t)(boxes_in_smem ? nsup + nblk : nsup) * 8 * sizeof(float) +
         (size_t)(kThreads / 32) * kStage * sizeof(float) +
         (k > 1 ? (size_t)kThreads * kBuf6 * sizeof(u64) : 0);
}

template <int K>
cudaError_t launch_walk(const float* groups, const int* order,
                        const float* boxes, const float* query,
                        const long long* qorder, const int* scodes,
                        const int* qcodes, int* out, u64* stats, int B,
                        int ns, int nq, int kout, int nblk, int nsup,
                        int boxes_in_smem, int self_search, size_t smem,
                        cudaStream_t stream) {
  // the kernel has no static shared memory: a dynamic size above 48 KiB
  // needs the opt-in; it only grows: a CUDA graph holds launches of
  // several sizes
  static size_t opted = 0;
  if (smem > 48 * 1024 && smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        knn_walk_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    opted = smem;
  }
  const dim3 grid((nq + kThreads - 1) / kThreads, B);
  knn_walk_kernel<K><<<grid, kThreads, smem, stream>>>(
      groups, order, boxes, query, qorder, scodes, qcodes, out, stats, ns,
      nq, kout, nblk, nsup, boxes_in_smem, self_search);
  return cudaGetLastError();
}

// Insert candidate (d, idx) into a register top-k sorted ascending by d
// (K static: fully unrolled). A candidate is taken only when d is below
// the current k-th, and the bubble swaps only on a strict <, so equal
// distances keep the order they arrived in: ties go to the lower index
// when candidates arrive in index order.
template <int K>
__device__ __forceinline__ void topk_insert(float d, int idx, float (&bd)[K],
                                            int (&bi)[K]) {
  if (d < bd[K - 1]) {
    bd[K - 1] = d;
    bi[K - 1] = idx;
#pragma unroll
    for (int j = K - 1; j > 0; --j) {
      if (bd[j] < bd[j - 1]) {
        const float tv = bd[j]; bd[j] = bd[j - 1]; bd[j - 1] = tv;
        const int ti = bi[j]; bi[j] = bi[j - 1]; bi[j - 1] = ti;
      }
    }
  }
}

constexpr int kBruteQ = 256;  // queries a CTA, one thread each
constexpr int kBruteS = 512;  // support points a shared-memory tile

// The brute-force route: one CTA per 256-query tile of one cloud, one
// thread per query; the support, in its original order, streamed through
// shared memory in tiles of 512 points as x, y, z arrays and read four
// candidates at a time with 16-byte broadcast loads; a register top-K per
// thread, its first kout written. The pad of the last tile is +inf and is
// never taken; with fewer than k support points the slots past them keep
// index 0.
template <int K>
__global__ void __launch_bounds__(kBruteQ)
    knn_brute_kernel(const float* __restrict__ support,
                     const float* __restrict__ query, int* __restrict__ out,
                     int ns, int nq, int kout) {
  __shared__ __align__(16) float sx[kBruteS];
  __shared__ __align__(16) float sy[kBruteS];
  __shared__ __align__(16) float sz[kBruteS];
  const int b = blockIdx.y;
  const int q = blockIdx.x * kBruteQ + threadIdx.x;
  const bool live = q < nq;
  const float* qp = query + ((size_t)b * nq + (live ? q : nq - 1)) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const float* sb = support + (size_t)b * ns * 3;

  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = INFINITY;
    bi[j] = 0;
  }
  for (int base = 0; base < ns; base += kBruteS) {
    const int cnt = min(kBruteS, ns - base);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kBruteS; i += kBruteQ) {
      if (i < cnt) {
        const float* p = sb + (size_t)(base + i) * 3;
        sx[i] = p[0];
        sy[i] = p[1];
        sz[i] = p[2];
      } else {
        sx[i] = INFINITY;
        sy[i] = INFINITY;
        sz[i] = INFINITY;
      }
    }
    __syncthreads();
    const int cnt4 = (cnt + 3) & ~3;
    for (int j = 0; j < cnt4; j += 4) {
      const float4 x4 = *reinterpret_cast<const float4*>(sx + j);
      const float4 y4 = *reinterpret_cast<const float4*>(sy + j);
      const float4 z4 = *reinterpret_cast<const float4*>(sz + j);
      topk_insert<K>(sq_dist(qx, qy, qz, x4.x, y4.x, z4.x), base + j,
                     bd, bi);
      topk_insert<K>(sq_dist(qx, qy, qz, x4.y, y4.y, z4.y), base + j + 1,
                     bd, bi);
      topk_insert<K>(sq_dist(qx, qy, qz, x4.z, y4.z, z4.z), base + j + 2,
                     bd, bi);
      topk_insert<K>(sq_dist(qx, qy, qz, x4.w, y4.w, z4.w), base + j + 3,
                     bd, bi);
    }
  }
  if (!live) return;
  int* o = out + ((size_t)b * nq + q) * kout;
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (j < kout) o[j] = bi[j];
}

// The instantiated width that serves k (ops/knn.py::knn_kernel_k): the
// least of 1, 16 and 64 at or above it; 0 for k outside [1, 64].
int kernel_k(int k) {
  return k == 1 ? 1 : k >= 2 && k <= 16 ? 16 : k > 16 && k <= 64 ? 64 : 0;
}

}  // namespace

// The brute-force route: support [B, ns, 3], query [B, nq, 3] f32 in their
// original order; out [B, nq, k] i32 support indices, 1 <= k <= 64.
extern "C" int knn_brute_launch(const void* support, const void* query,
                                void* out, int B, int ns, int nq, int k,
                                void* stream) {
  if (B < 1 || B > 65535 || nq < 1 || ns < 1 || !kernel_k(k))
    return (int)cudaErrorInvalidValue;
  const float* s = (const float*)support;
  const float* q = (const float*)query;
  int* o = (int*)out;
  cudaStream_t cs = (cudaStream_t)stream;
  const dim3 grid((nq + kBruteQ - 1) / kBruteQ, B);
  switch (kernel_k(k)) {
    case 1:
      knn_brute_kernel<1><<<grid, kBruteQ, 0, cs>>>(s, q, o, ns, nq, k);
      break;
    case 16:
      knn_brute_kernel<16><<<grid, kBruteQ, 0, cs>>>(s, q, o, ns, nq, k);
      break;
    default:
      knn_brute_kernel<64><<<grid, kBruteQ, 0, cs>>>(s, q, o, ns, nq, k);
  }
  return (int)cudaGetLastError();
}

// support [B, ns, 3], query [B, nq, 3] f32 → scodes [B, ns], qcodes [B, nq]
// i32: the morton codes of both clouds over one box per batch row (query
// and qcodes unused on a self-search).
extern "C" int knn_codes_launch(const void* support, const void* query,
                                void* lohi, void* scodes, void* qcodes,
                                int B, int ns, int nq, int self_search,
                                void* stream) {
  if (B < 1 || B > 65535 || ns < 1 || nq < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t cs = (cudaStream_t)stream;
  const int nq2 = self_search ? 0 : nq;
  const float* s = (const float*)support;
  const float* q = (const float*)query;
  knn_bounds_kernel<<<B, 1024, 0, cs>>>(s, q, (float*)lohi, ns, nq2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  knn_codes_kernel<<<dim3((ns + nq2 + 255) / 256, B), 256, 0, cs>>>(
      s, q, (const float*)lohi, (int*)scodes, (int*)qcodes, ns, nq2);
  return (int)cudaGetLastError();
}

// support [B, ns, 3], query [B, nq, 3] f32 in their original order;
// sorder [B, ns], qorder [B, nq] i64 and scodes [B, ns], qcodes [B, nq] i32
// from the stable sort of the codes (the support's on a self-search for
// both), or all four null to walk the clouds in their original order; groups [B, nblk * 8, 3, 4] f32, order [B, nblk * 32] i32 and boxes
// [B, nsup + nblk, 8] f32 scratch; out [B, nq, k] i32 support indices by
// original query row; stats 5 u64 counters or null (knn_walk_kernel).
// nblk = ceil(ns / 32), nsup = ceil(nblk / 32); threads, boxes_in_smem
// and smem as ops/knn.py::knn_tiled_plan computes them. 1 <= k <= 64: 16
// (cfg.k_n) and 1 (the nearest-neighbour upsample) in the model, 46 in the
// partition; the walk of the least width K >= k (kernel_k) runs.
extern "C" int knn_tiled_launch(const void* support, const void* query,
                                const void* sorder, const void* qorder,
                                const void* scodes, const void* qcodes,
                                void* groups, void* order, void* boxes,
                                void* out, void* stats, int B, int ns, int nq,
                                int k, int threads, int boxes_in_smem,
                                int self_search, int smem, void* stream) {
  const int nblk = (ns + kBlk - 1) / kBlk, nsup = (nblk + kSup - 1) / kSup;
  if (B < 1 || B > 65535 || nq < 1 || ns < 1 || !kernel_k(k) ||
      threads != (kernel_k(k) == 64 ? kThreads64 : kThreads) ||
      (self_search && nq != ns) ||
      !sorder != !qorder || !sorder != !scodes || !sorder != !qcodes ||
      (k > 16 && boxes_in_smem) ||
      (size_t)smem != knn_walk_smem(nblk, nsup, k, boxes_in_smem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t cs = (cudaStream_t)stream;
  float* g = (float*)groups;
  int* o = (int*)order;
  float* bx = (float*)boxes;
  knn_layout_kernel<<<dim3(nsup, B), 1024, 0, cs>>>(
      (const float*)support, (const long long*)sorder, g, o, bx, ns, nblk,
      nsup);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float* q = (const float*)query;
  const long long* qo = (const long long*)qorder;
  const int* sc = (const int*)scodes;
  const int* qc = (const int*)qcodes;
  int* out_i = (int*)out;
  u64* st = (u64*)stats;
  switch (kernel_k(k)) {
    case 1:
      return (int)launch_walk<1>(g, o, bx, q, qo, sc, qc, out_i, st, B, ns,
                                 nq, k, nblk, nsup, boxes_in_smem,
                                 self_search, smem, cs);
    case 16:
      return (int)launch_walk<16>(g, o, bx, q, qo, sc, qc, out_i, st, B, ns,
                                  nq, k, nblk, nsup, boxes_in_smem,
                                  self_search, smem, cs);
    default:
      knn_walk64_kernel<<<dim3((nq + kQ64 - 1) / kQ64, B), kThreads64, 0,
                          cs>>>(g, o, bx, q, qo, sc, qc, out_i, st, ns, nq,
                                k, nblk, nsup, self_search);
      return (int)cudaGetLastError();
  }
}
