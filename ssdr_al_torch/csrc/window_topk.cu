// K1 and K5: window top-k search on curve-sorted clouds.
//
// K1 replaces the TPU kernel ssdr_al_tpu/ops/knn.py::_knn_window_kernel and
// K5 its variant _knn_window_kernel_mxu (both launched by
// _run_window_pallas). For every query tile t of `tq` sorted queries, search
// the support slice [starts[t], starts[t] + window) and write the k nearest
// as window-relative ranks, ascending by squared distance, ties to the
// lower rank.
//
// Bound on the H100: arithmetic. Each query does `window` distance
// evaluations (8 f32 operations, no FMA) plus a compare against its k-th
// best; the bytes moved are one support window per tile and k ints per
// query out. The first design (one thread walking a query's whole window in
// rank order, a 16-deep insertion whenever any lane of the warp found a
// closer point) issued ~50 instructions per (query, candidate) pair.
// Design (the walk of the first redesign, 0.41 ms at L0 [8 x 40960] on the
// H100, kernels/measure.py; its staging and flushes redone after counting
// what the walk does, kernels/k1_twin.py and the counter build below):
//  - Candidates are keyed by (d2, window rank) and kept in a buffered
//    register top-k (key_topk.cuh keys), which frees the order of the walk.
//  - The window is staged once per CTA by 16-byte loads, four candidates a
//    thread (x[4], y[4], z[4] by group; K5 centred, with |s'|^2[4]), and
//    each block's bounding box (8 groups of `split`; K5's also holds the
//    block's largest |s'|^2) is reduced from the same registers by warp
//    shuffles (the first redesign loaded the window point by point and
//    then built each box in one thread). Pad candidates past the window
//    never enter the top-k.
//  - The walk is a spiral over blocks: it starts at the block of the warp's
//    middle query (its own rank on a self-search, else the nearest of 32
//    samples of the window) and steps out one block on each side in turn
//    (mod their count), so the nearest ranks come first and the k-th best
//    tightens early. Its first k candidates fill the list at once, sorted
//    by a bitonic network.
//  - The walk skips a whole block when a lower bound of the d2 of every
//    candidate in it is strictly above the k-th best of every lane of the
//    warp (a candidate at equal d2 may still enter on a lower rank). K1's
//    bound is the least d2 to the box in the same rounded form as d2
//    (key_topk.cuh::box_lb). K5's is the real least d2 to the box in
//    centred coordinates, rounded down, less the rounding error of the
//    expanded form (k5_box_lb). In a block each filters a group on the
//    least of its four d2 in FMA form (K1: at most `filter_bound` above the
//    exact form; K5: k5_filter_err); only a group that may hold a candidate
//    of the top-k has its exact d2 and keys built, and a key under the
//    lane's k-th best goes on its stack of kBuf in shared memory.
//  - Insertions: a key enters by a chain of 15 64-bit compare-exchanges,
//    and a warp's insertion round costs that chain whatever its lanes
//    hold. When some lane may not take two more groups, the first redesign
//    inserted every lane's whole buffer: a warp ran as many rounds as its
//    busiest lane had keys at each flush, ~92 rounds a warp at L0 for ~24
//    keys a lane kept (the twin), the largest share of its instructions.
//    A flush now takes kDrain rounds of the lanes' newest keys (more only
//    where a lane would otherwise overflow), so that lanes whose keys come
//    at other times share rounds (~72 a warp at L0, ~20 % fewer), and
//    merges them 8 at a time by sorting networks (key_merge8: 64
//    compare-exchanges for 8 keys, where 8 chains take 120); fewer than
//    kMerge go in one by one.
//  - Turned down by the counters (kernels/k1_twin.py's other walks, PERF.md
//    §6): a flush after every block, super-boxes of 8 blocks, the blocks
//    nearest box first, a fill round each lane's own rank. Keys held as
//    FP64 values of their bits (they order as the integers do) would
//    insert by branch-free min/max, but the compiler makes most of those
//    FP64 compares and selects, and a variant built that way ran slower
//    than this one at L0 on the H100.
//  - `split` threads may share one query (ops/knn.py::window_topk_plan picks
//    1, 2, 4 or 8 so that a small grid has warps enough): thread s walks
//    the groups g = s (mod split), the lanes of a query filter against the
//    least of their k-th bests, and their lists are merged at the end.
//  - STATS (the counter build, window_topk_stats_launch; the main path never
//    instantiates it) counts what each warp does, as kernels/k1_twin.py
//    does, and `cut` ends the kernel after the staging (1) or the fill (2)
//    so that their share of the time can be read.

// Numerics: K1's d2 = (dx*dx + dy*dy) + dz*dz with round-to-nearest
// intrinsics and no FMA contraction. K5 centres both clouds on the window's
// first support point c and builds d2 = max(m + (|s'|^2 + |q'|^2), 0) with
// m = sum_i (-2 q'_i) s'_i (s' = s - c, q' = q - c), every sum taken left
// to right without FMA; the centred |s'|^2 is computed once per window point
// into shared memory. The TPU kernel forms m as one HIGHEST-precision MXU
// product; on the card the cross term is a 3-deep dot product, which would
// leave a tensor-core tile idle over most of its depth, and a tf32x3 form
// would not give the plain version's bits. The plain PyTorch version
// (ops/knn.py::_window_topk_plain) computes the same values and order for
// both, so each kernel agrees with it index for index. The TPU kernels
// instead zero the low 12 mantissa bits of d2 to pack the index there;
// they can reorder pairs whose distances agree to within 2^-11 relative.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "key_topk.cuh"

namespace {

constexpr int kBuf = 24;                  // buffered candidates per thread
constexpr int kDrain = 8;                 // insertion rounds of a flush
constexpr int kMerge = 5;                 // rounds merged by a network
constexpr int kMaxThreads = 256;
constexpr int kStats = 9;                 // counters of the STATS build

// Up to 8 keys nb (unsorted; ~0 for none) into the ascending list bk of
// 16: nb sorted by Batcher's odd-even network (19 compare-exchanges), the
// least 8 of bk's upper half and nb by one compare a pair (bk[8 + i]
// against nb[7 - i]: a bitonic run, sorted by 12), then the two ascending
// halves merged by Batcher's odd-even merge (25): 64 in all, where
// inserting 8 keys one by one runs 8 chains of 15.
__device__ __forceinline__ void key_merge8(u64 (&nb)[8], u64 (&bk)[16]) {
  cswap(nb[0], nb[1]); cswap(nb[2], nb[3]); cswap(nb[0], nb[2]);
  cswap(nb[1], nb[3]); cswap(nb[1], nb[2]); cswap(nb[4], nb[5]);
  cswap(nb[6], nb[7]); cswap(nb[4], nb[6]); cswap(nb[5], nb[7]);
  cswap(nb[5], nb[6]); cswap(nb[0], nb[4]); cswap(nb[2], nb[6]);
  cswap(nb[2], nb[4]); cswap(nb[1], nb[5]); cswap(nb[3], nb[7]);
  cswap(nb[3], nb[5]); cswap(nb[1], nb[2]); cswap(nb[3], nb[4]);
  cswap(nb[5], nb[6]);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    bk[8 + i] = nb[7 - i] < bk[8 + i] ? nb[7 - i] : bk[8 + i];
#pragma unroll
  for (int j = 4; j > 0; j >>= 1)
#pragma unroll
    for (int i = 8; i < 16; ++i)
      if ((i & j) == 0) cswap(bk[i], bk[i + j]);
  cswap(bk[0], bk[8]); cswap(bk[4], bk[12]); cswap(bk[4], bk[8]);
  cswap(bk[2], bk[10]); cswap(bk[6], bk[14]); cswap(bk[6], bk[10]);
  cswap(bk[2], bk[4]); cswap(bk[6], bk[8]); cswap(bk[10], bk[12]);
  cswap(bk[1], bk[9]); cswap(bk[5], bk[13]); cswap(bk[5], bk[9]);
  cswap(bk[3], bk[11]); cswap(bk[7], bk[15]); cswap(bk[7], bk[11]);
  cswap(bk[3], bk[5]); cswap(bk[7], bk[9]); cswap(bk[11], bk[13]);
  cswap(bk[1], bk[2]); cswap(bk[3], bk[4]); cswap(bk[5], bk[6]);
  cswap(bk[7], bk[8]); cswap(bk[9], bk[10]); cswap(bk[11], bk[12]);
  cswap(bk[13], bk[14]);
}

// A thread's top-k of keys (key_topk.cuh: d2's bits above the window
// rank) and its candidate buffer buf[i * stride], i < kBuf (K > 1), a
// stack. thr is the k-th best of the query's lanes at the last flush,
// thr_d its d2 and thr_f the group filter's bound of it (K1: filter_bound;
// K5 bounds each block apart). STATS adds the keys buffered and kept and
// the warp's flushes and insertion rounds to st[].
template <int K, bool FMA_FILTER, bool STATS>
struct WindowTopK {
  u64 bk[K];
  u64 thr;
  float thr_d, thr_f;
  int cnt;
  u64* buf;
  int stride;
  unsigned long long* st;  // STATS: this lane's counters

  __device__ __forceinline__ void init(u64* b, int s,
                                       unsigned long long* c) {
#pragma unroll
    for (int j = 0; j < K; ++j) bk[j] = kEmpty;
    buf = b;
    stride = s;
    cnt = 0;
    st = c;
    set_thr(kEmpty);
  }
  __device__ __forceinline__ void set_thr(u64 key) {
    thr = key;
    thr_d = __uint_as_float((unsigned)(key >> 32));
    thr_f = FMA_FILTER ? filter_bound(thr_d) : thr_d;
  }
  // Insert the lanes' newest keys, as many rounds as `all` asks (every key)
  // or else kDrain, and more where a lane would keep more than kBuf - 9
  // (so that each takes two groups more); the `split` lanes of a query
  // (consecutive, a power of two) then share the least of their k-th
  // bests: any of them holds K keys below its own, so a key at or above
  // the least is out. A flush costs its rounds whatever the lanes hold,
  // so bounding them lets the lanes whose keys come later share the
  // rounds of the busiest.
  __device__ __forceinline__ void flush(int split, bool all = false) {
    const int most = (int)__reduce_max_sync(kFull, (unsigned)cnt);
    const int rounds =
        all ? most : max(min(most, kDrain), most - (kBuf - 9));
    if (STATS) {
      st[6] += 1;
      st[7] += rounds;
    }
    // 8 rounds at a time by key_merge8 while kMerge or more are left (the
    // counter build inserts one by one, as the twin counts the keys kept)
    int i = 0;
    if constexpr (K == 16 && !STATS) {
      const int mine = min(cnt, rounds);
#pragma unroll 1
      for (; rounds - i >= kMerge; i += 8) {
        u64 nb[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          nb[j] = i + j < mine ? buf[(cnt - 1 - i - j) * stride] : ~0ull;
        key_merge8(nb, bk);
      }
    }
#pragma unroll 1
    for (; i < rounds; ++i)
      if (i < cnt) {
        const u64 key = buf[(cnt - 1 - i) * stride];
        if (STATS) st[5] += key < bk[K - 1];
        key_insert<K>(key, bk);
      }
    cnt = max(cnt - rounds, 0);
    u64 m = bk[K - 1];
    for (int off = 1; off < split; off <<= 1) {
      const u64 o = __shfl_xor_sync(kFull, m, off);
      m = o < m ? o : m;
    }
    set_thr(m);
  }
  __device__ __forceinline__ void consider(float d, unsigned rank) {
    const u64 key = make_key(d, rank);
    if (key < thr) {
      if (STATS) st[4] += 1;
      if constexpr (K == 1) {
        bk[0] = key;
        set_thr(key);
        if (STATS) st[5] += 1;
      } else {
        buf[cnt * stride] = key;
        ++cnt;
      }
    }
  }
  // true on every lane when some lane may not take 8 more candidates
  __device__ __forceinline__ bool nearly_full() const {
    return K > 1 && __any_sync(kFull, cnt > kBuf - 9);
  }
};

// K5's block bound. For stored centred floats q', s' with the real
// D = |q' - s'|^2, the computed d2 (each product and sum rounded to
// nearest, u = 2^-24) satisfies d2 >= D (1 - u) - gamma_4 S with
// S = sum_i |2 q'_i s'_i| + |s'|^2 + |q'|^2 <= 2 (|q'|^2 + |s'|^2):
// the cross term and each squared norm are 3-term dot products (error
// gamma_3 of their absolute sums), their sum adds one rounding, and the
// final sum one more, relative to its result. |q'|^2 and |s'|^2 are at
// most q2 and the block's largest w2 times 1 / (1 - gamma_3), so
// 2^-20 (q2 + w2max) covers the error term twice over (8u (1 + 4u) is
// needed); 2^-126 covers the absolute error of subnormal products. L is
// the real least D over the box, computed with every step rounded down.
// A NaN bound (overflowed coordinates) never skips.
__device__ __forceinline__ float k5_box_lb(float4 lo, float4 hi, float qx,
                                           float qy, float qz, float q2) {
  auto gap = [](float l, float x, float h) {
    return fmaxf(fmaxf(__fsub_rd(l, x), __fsub_rd(x, h)), 0.f);
  };
  const float ex = gap(lo.x, qx, hi.x), ey = gap(lo.y, qy, hi.y);
  const float ez = gap(lo.z, qz, hi.z);
  const float l = __fadd_rd(__fadd_rd(__fmul_rd(ex, ex), __fmul_rd(ey, ey)),
                            __fmul_rd(ez, ez));
  const float err = __fmaf_ru(__fadd_ru(q2, lo.w), 0x1p-20f, 0x1p-126f);
  return __fsub_rd(__fmul_rd(l, 1.0f - 0x1p-23f), err);
}

// K5's group filter bound. The FMA form f = fma(m_x, s_x, fma(m_y, s_y,
// fma(m_z, s_z, t))) with t = fl(w2 + q2), 4 operations a candidate, and
// the exact form's d2 = max(fl(m + t), 0) both approximate m + t with
// errors of at most gamma_3 (sum_i |m_i s_i| + t), and sum_i |m_i s_i| <=
// |q'|^2 + |s'|^2 <= t (1 + gamma_4); so f <= d2 (1 + u) + 11 u t. A
// candidate of the block with d2 <= thr therefore has f <= thr (1 + 2^-22)
// + err with err = 2^-19 (q2 + w2max) + 2^-126 (the subnormal floor as
// in filter_bound), each step rounded up: k5_filter_err, once a block.
__device__ __forceinline__ float k5_filter_err(float q2, float w2max) {
  return __fmaf_ru(__fadd_ru(q2, w2max), 0x1p-19f, 0x1p-126f);
}

// Groups of 4 candidates a sub-box of the staging's box reduction: the
// block's 8 * split groups when they fit in a warp, else half of them
// (split 8: two sub-boxes a block, united after a barrier).
__host__ __device__ constexpr int sub_groups(int split) {
  return 8 * split < 32 ? 8 * split : 32;
}

template <int K, bool CENTERED, bool STATS>
__global__ void __launch_bounds__(kMaxThreads)
    window_topk_kernel(const float* __restrict__ support,
                       const float* __restrict__ queries,
                       const int* __restrict__ starts, int* __restrict__ out,
                       int ns, int nq, int window, int tq, int split,
                       int qpc, int wpad, int self_search,
                       unsigned long long* __restrict__ stats, int cut) {
  // the window by groups of four candidates: x[4], y[4], z[4] (K5: centred,
  // then |s'|^2[4]); then the block boxes [nblk][lo xyz w2max, hi xyz _]
  // (split 8: two sub-boxes a block until they are united); then for K > 1
  // each thread's candidate buffer [kBuf][blockDim.x]
  constexpr int kG = CENTERED ? 16 : 12;  // floats per group
  const int ngroups = wpad / 4;
  const int sgroups = ngroups / split;     // super-groups of split groups
  const int nblk = (sgroups + 7) >> 3;     // blocks of 8 super-groups
  const int subs = 8 * split / sub_groups(split);  // sub-boxes a block
  extern __shared__ __align__(16) float win[];
  float* box = win + ngroups * kG;
  u64* buf = reinterpret_cast<u64*>(box + nblk * subs * 8);
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int b = blockIdx.y;
  const int parts = (tq + qpc - 1) / qpc;
  const int t = blockIdx.x / parts;
  const int part = blockIdx.x - t * parts;
  int start = starts[b * (nq / tq) + t];
  start = min(max(start, 0), ns - window);  // the plain version clamps too
  const float* src = support + ((size_t)b * ns + start) * 3;
  const float cx = CENTERED ? src[0] : 0.f;
  const float cy = CENTERED ? src[1] : 0.f;
  const float cz = CENTERED ? src[2] : 0.f;
  // 16-byte loads where the window starts on a multiple of 4 points
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int sg = sub_groups(split);
  // Stage: thread tid takes group base + tid (every thread runs every
  // round, so the shuffles see whole warps); pads are NaN for K1 (fails
  // every compare) and +inf at a rank above 0 for K5 (a key above the
  // empty slot's (+inf, 0)); the box of each run of sg groups is reduced
  // over sg lanes.
  for (int base = 0; base < ngroups; base += nthr) {
    const int g = base + tid;
    float x[4], y[4], z[4], w2[4];
    const float pad = CENTERED ? 0.f : __int_as_float(0x7fc00000);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      x[c] = y[c] = z[c] = pad;
      w2[c] = INFINITY;
    }
    if (g < ngroups) {
      if (vec && 4 * g + 3 < window) {
        const float4* p = reinterpret_cast<const float4*>(src + 12 * g);
        const float4 A = p[0], B = p[1], C = p[2];
        x[0] = A.x, y[0] = A.y, z[0] = A.z, x[1] = A.w;
        y[1] = B.x, z[1] = B.y, x[2] = B.z, y[2] = B.w;
        z[2] = C.x, x[3] = C.y, y[3] = C.z, z[3] = C.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (4 * g + c < window) {
            x[c] = src[12 * g + 3 * c];
            y[c] = src[12 * g + 3 * c + 1];
            z[c] = src[12 * g + 3 * c + 2];
          }
      }
    }
    float4 lo = make_float4(INFINITY, INFINITY, INFINITY, 0.f);
    float4 hi = make_float4(-INFINITY, -INFINITY, -INFINITY, 0.f);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool real = g < ngroups && 4 * g + c < window;
      if (CENTERED && real) {
        x[c] = __fsub_rn(x[c], cx);
        y[c] = __fsub_rn(y[c], cy);
        z[c] = __fsub_rn(z[c], cz);
        w2[c] = __fadd_rn(__fadd_rn(__fmul_rn(x[c], x[c]),
                                    __fmul_rn(y[c], y[c])),
                          __fmul_rn(z[c], z[c]));
      }
      if (real) {
        lo.x = fminf(lo.x, x[c]);
        lo.y = fminf(lo.y, y[c]);
        lo.z = fminf(lo.z, z[c]);
        hi.x = fmaxf(hi.x, x[c]);
        hi.y = fmaxf(hi.y, y[c]);
        hi.z = fmaxf(hi.z, z[c]);
        if (CENTERED) lo.w = fmaxf(lo.w, w2[c]);
      }
    }
    if (g < ngroups) {
      float4* o = reinterpret_cast<float4*>(win + g * kG);
      o[0] = make_float4(x[0], x[1], x[2], x[3]);
      o[1] = make_float4(y[0], y[1], y[2], y[3]);
      o[2] = make_float4(z[0], z[1], z[2], z[3]);
      if (CENTERED) o[3] = make_float4(w2[0], w2[1], w2[2], w2[3]);
    }
    for (int off = 1; off < sg; off <<= 1) {
      lo.x = fminf(lo.x, __shfl_xor_sync(kFull, lo.x, off));
      lo.y = fminf(lo.y, __shfl_xor_sync(kFull, lo.y, off));
      lo.z = fminf(lo.z, __shfl_xor_sync(kFull, lo.z, off));
      lo.w = fmaxf(lo.w, __shfl_xor_sync(kFull, lo.w, off));
      hi.x = fmaxf(hi.x, __shfl_xor_sync(kFull, hi.x, off));
      hi.y = fmaxf(hi.y, __shfl_xor_sync(kFull, hi.y, off));
      hi.z = fmaxf(hi.z, __shfl_xor_sync(kFull, hi.z, off));
    }
    if ((lane & (sg - 1)) == 0 && g < ngroups) {
      reinterpret_cast<float4*>(box)[2 * (g / sg)] = lo;
      reinterpret_cast<float4*>(box)[2 * (g / sg) + 1] = hi;
    }
  }
  __syncthreads();
  if (subs > 1) {
    // split 8: a block's box is the union of its two sub-boxes
    float4 lo, hi;
    const float4* bx = reinterpret_cast<const float4*>(box);
    const bool mine = tid < nblk;
    if (mine) {
      const float4 l0 = bx[4 * tid], h0 = bx[4 * tid + 1];
      lo = l0, hi = h0;
      if (2 * tid + 1 < (ngroups + sg - 1) / sg) {
        const float4 l1 = bx[4 * tid + 2], h1 = bx[4 * tid + 3];
        lo = make_float4(fminf(l0.x, l1.x), fminf(l0.y, l1.y),
                         fminf(l0.z, l1.z), fmaxf(l0.w, l1.w));
        hi = make_float4(fmaxf(h0.x, h1.x), fmaxf(h0.y, h1.y),
                         fmaxf(h0.z, h1.z), 0.f);
      }
    }
    __syncthreads();
    if (mine) {
      reinterpret_cast<float4*>(box)[2 * tid] = lo;
      reinterpret_cast<float4*>(box)[2 * tid + 1] = hi;
    }
    __syncthreads();
  }
  if (STATS && cut == 1) return;

  const int s = tid & (split - 1);
  const int qi = tid / split;
  const int qt = part * qpc + qi;  // query rank inside the tile
  const bool live = qi < qpc && qt < tq;
  const int q = t * tq + min(qt, tq - 1);
  const float* qp = queries + ((size_t)b * nq + q) * 3;
  // K1: the query; K5: the centred query, its |q'|^2 and -2 q'
  float qx = qp[0], qy = qp[1], qz = qp[2];
  float q2 = 0.f, mx = 0.f, my = 0.f, mz = 0.f;
  if (CENTERED) {
    qx = __fsub_rn(qx, cx);
    qy = __fsub_rn(qy, cy);
    qz = __fsub_rn(qz, cz);
    q2 = __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)),
                   __fmul_rn(qz, qz));
    mx = __fmul_rn(-2.f, qx);
    my = __fmul_rn(-2.f, qy);
    mz = __fmul_rn(-2.f, qz);
  }

  // Where the walk starts: the window rank of the warp's middle query (lane
  // 16) on a self-search; otherwise the nearest to it of 32 samples.
  int p0;
  if (self_search) {
    p0 = min(max(__shfl_sync(kFull, q, 16) - start, 0), window - 1);
  } else {
    const float px = __shfl_sync(kFull, qx, 16);
    const float py = __shfl_sync(kFull, qy, 16);
    const float pz = __shfl_sync(kFull, qz, 16);
    const int pr = (int)(((long long)lane * window) >> 5);
    const float* g = win + (pr >> 2) * kG + (pr & 3);
    u64 pk = make_key(sq_dist(px, py, pz, g[0], g[4], g[8]), pr);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const u64 o = __shfl_xor_sync(kFull, pk, off);
      pk = o < pk ? o : pk;
    }
    p0 = (int)(unsigned)pk;
  }
  const int jb0 = min(((p0 >> 2) / split) >> 3, nblk - 1);

  // STATS: per lane [box tests, blocks visited, groups, groups past the
  // filter (warp-level counts, summed from lane 0), keys buffered, keys
  // kept, flushes, insertion rounds (lane 0), warps]
  unsigned long long cn[kStats] = {};
  WindowTopK<K, !CENTERED, STATS> top;
  top.init(buf + tid, nthr, cn);
  // one group of four candidates: a filter on its least d2 in FMA form
  // (K1: under filter_bound of the k-th best; K5: under the bound that
  // the block's k5_filter_err `e5` gives), then the exact d2 and key of
  // each candidate that may enter
  auto visit = [&](int j, float e5) {
    const int g = j * split + s;
    const int w0 = 4 * g;
    const float4* p = reinterpret_cast<const float4*>(win + g * kG);
    const float4 X = p[0], Y = p[1], Z = p[2];
    const float sx[4] = {X.x, X.y, X.z, X.w};
    const float sy[4] = {Y.x, Y.y, Y.z, Y.w};
    const float sz[4] = {Z.x, Z.y, Z.z, Z.w};
    bool pass;
    if constexpr (CENTERED) {
      const float4 W = p[3];
      const float sw[4] = {W.x, W.y, W.z, W.w};
      float tw[4], f[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        tw[c] = __fadd_rn(sw[c], q2);
        f[c] = __fmaf_rn(mx, sx[c],
                         __fmaf_rn(my, sy[c], __fmaf_rn(mz, sz[c], tw[c])));
      }
      pass = fminf(fminf(f[0], f[1]), fminf(f[2], f[3])) <=
             __fmaf_ru(top.thr_d, 1.0f + 0x1p-22f, e5);
      if (pass) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float m = __fadd_rn(
              __fadd_rn(__fmul_rn(mx, sx[c]), __fmul_rn(my, sy[c])),
              __fmul_rn(mz, sz[c]));
          top.consider(fmaxf(__fadd_rn(m, tw[c]), 0.f), w0 + c);
        }
      }
    } else {
      float dx[4], dy[4], dz[4], fa[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dx[c] = __fsub_rn(qx, sx[c]);
        dy[c] = __fsub_rn(qy, sy[c]);
        dz[c] = __fsub_rn(qz, sz[c]);
        fa[c] = __fmaf_rn(dx[c], dx[c],
                          __fmaf_rn(dy[c], dy[c], __fmul_rn(dz[c], dz[c])));
      }
      pass = fminf(fminf(fa[0], fa[1]), fminf(fa[2], fa[3])) <= top.thr_f;
      if (pass) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          top.consider(__fadd_rn(__fadd_rn(__fmul_rn(dx[c], dx[c]),
                                           __fmul_rn(dy[c], dy[c])),
                                 __fmul_rn(dz[c], dz[c])),
                       w0 + c);
      }
    }
    if (STATS) {
      cn[2] += 1;
      cn[3] += __any_sync(kFull, pass);
    }
  };
  auto block_lb = [&](int blk) {
    const float4 lo = reinterpret_cast<const float4*>(box)[2 * blk];
    const float4 hi = reinterpret_cast<const float4*>(box)[2 * blk + 1];
    return CENTERED ? k5_box_lb(lo, hi, qx, qy, qz, q2)
                    : box_lb(lo, hi, qx, qy, qz);
  };

  // The walk: blocks of 8 super-groups (of `split` groups) in a spiral from
  // p0's block, one block out on each side in turn (mod their count), each
  // block's super-groups in order; a block is skipped when its bound is
  // beyond every lane's k-th best.
  int first = 0;  // super-groups of the first block the fill took
  if constexpr (K % 8 == 0) {
    if (jb0 * 8 + K / 4 <= sgroups) {
      // the first K candidates fill the list at once: their exact keys,
      // sorted by a network
#pragma unroll
      for (int m = 0; m < K / 4; ++m) {
        const int g = (jb0 * 8 + m) * split + s;
        const float* c4 = win + g * kG;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float d;
          if constexpr (CENTERED) {
            const float m2 = __fadd_rn(
                __fadd_rn(__fmul_rn(mx, c4[c]), __fmul_rn(my, c4[4 + c])),
                __fmul_rn(mz, c4[8 + c]));
            d = fmaxf(__fadd_rn(m2, __fadd_rn(c4[12 + c], q2)), 0.f);
          } else {
            d = sq_dist(qx, qy, qz, c4[c], c4[4 + c], c4[8 + c]);
          }
          top.bk[4 * m + c] = make_key(d, 4 * g + c);
        }
      }
      key_sort<K>(top.bk);
      top.flush(split);  // nothing buffered: shares the threshold
      first = K / 4;
    }
  }
  if (STATS && cut == 2) {
    if ((unsigned)top.bk[0] == 0xffffffffu) out[0] = 0;  // keeps the fill
    return;
  }
  int bf = jb0, bb = (jb0 == 0 ? nblk : jb0) - 1;
  for (int it = 0; it < nblk; ++it) {
    int blk;
    if (it & 1) {
      blk = bb;
      bb = (bb == 0 ? nblk : bb) - 1;
    } else {
      blk = bf;
      bf = bf + 1 == nblk ? 0 : bf + 1;
    }
    if (STATS) cn[0] += 1;
    if (!__any_sync(kFull, !(block_lb(blk) > top.thr_d))) continue;
    if (STATS) cn[1] += 1;
    const float e5 =
        CENTERED ? k5_filter_err(q2, reinterpret_cast<const float4*>(box)[
                                         2 * blk].w)
                 : 0.f;
    const int j_end = min(blk * 8 + 8, sgroups);
    for (int j = blk * 8 + (it == 0 ? first : 0); j < j_end; j += 2) {
      visit(j, e5);
      if (j + 1 < j_end) visit(j + 1, e5);
      if (top.nearly_full()) top.flush(split);
    }
  }
  if (K > 1) top.flush(split, true);

  // merge the partial lists of a query's split lanes, pairwise
  u64(&bk)[K] = top.bk;
  for (int off = 1; off < split; off <<= 1) {
    if constexpr (K == 1) {
      const u64 o = __shfl_xor_sync(kFull, bk[0], off);
      bk[0] = o < bk[0] ? o : bk[0];
    } else {
#pragma unroll
      for (int j = 0; j < K; ++j) buf[j * nthr + tid] = bk[j];
      __syncwarp();
#pragma unroll 1
      for (int j = 0; j < K; ++j) {
        const u64 o = buf[j * nthr + (tid ^ off)];
        if (!(o < bk[K - 1])) break;  // the partner's list is ascending
        key_insert<K>(o, bk);
      }
      __syncwarp();
    }
  }
  if (STATS) {
    // warp-level counts from lane 0, lane sums of the keys
    unsigned long long tot[kStats];
#pragma unroll
    for (int i = 0; i < kStats; ++i) tot[i] = cn[i];
    tot[4] = __reduce_add_sync(kFull, (unsigned)cn[4]);
    tot[5] = __reduce_add_sync(kFull, (unsigned)cn[5]);
    tot[8] = 1;
    if (lane == 0)
#pragma unroll
      for (int i = 0; i < kStats; ++i) atomicAdd(stats + i, tot[i]);
  }
  if (!live || s) return;
  int* o = out + ((size_t)b * nq + q) * K;
  if (K % 4 == 0) {
#pragma unroll
    for (int j = 0; j < K; j += 4)
      *reinterpret_cast<int4*>(o + j) =
          make_int4((int)(unsigned)bk[j], (int)(unsigned)bk[j + 1],
                    (int)(unsigned)bk[j + 2], (int)(unsigned)bk[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) o[j] = (int)(unsigned)bk[j];
  }
}

// Dynamic shared memory of a launch: the staged window, the block boxes
// (two sub-boxes a block at split 8) and, for K > 1, the candidate buffers
// (ops/knn.py::window_topk_smem computes the same; the launcher refuses a
// launch where the two differ).
size_t window_topk_smem(int window, int k, bool centered, int split,
                        int threads) {
  const int wpad = (window + 4 * split - 1) / (4 * split) * (4 * split);
  const int nblk = (wpad / (4 * split) + 7) / 8;
  return (size_t)wpad * (centered ? 4 : 3) * sizeof(float) +
         (size_t)nblk * (8 * split / sub_groups(split)) * 8 * sizeof(float) +
         (k > 1 ? (size_t)threads * kBuf * sizeof(u64) : 0);
}

template <int K, bool CENTERED, bool STATS>
cudaError_t launch_k(const float* support, const float* queries,
                     const int* starts, int* out, int B, int ns, int nq,
                     int window, int tq, int split, int qpc, int threads,
                     int self_search, size_t smem,
                     unsigned long long* stats, int cut,
                     cudaStream_t stream) {
  const int wpad = (window + 4 * split - 1) / (4 * split) * (4 * split);
  static_assert(K == 1 || K <= kBuf, "the merge stages a list in the buffer");
  // the kernel has no static shared memory, so only a dynamic size above
  // 48 KiB needs the opt-in; it only grows: a CUDA graph holds launches of
  // several sizes
  static size_t opted = 0;
  if (smem > 48 * 1024 && smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        window_topk_kernel<K, CENTERED, STATS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted = smem;
  }
  const int parts = (tq + qpc - 1) / qpc;
  const dim3 grid((nq / tq) * parts, B);
  window_topk_kernel<K, CENTERED, STATS><<<grid, threads, smem, stream>>>(
      support, queries, starts, out, ns, nq, window, tq, split, qpc, wpad,
      self_search, stats, cut);
  return cudaGetLastError();
}

bool bad_args(int B, int ns, int nq, int window, int k, int tq, int centered,
              int split, int qpc, int threads, int smem) {
  return B < 1 || B > 65535 || tq < 1 || nq % tq || window < k ||
         window > ns ||
         (split != 1 && split != 2 && split != 4 && split != 8) || qpc < 1 ||
         qpc > tq || threads != (qpc * split + 31) / 32 * 32 ||
         threads > kMaxThreads ||
         (size_t)smem != window_topk_smem(window, k, centered, split,
                                          threads);
}

}  // namespace

// support [B, ns, 3] f32; queries [B, nq, 3] f32; starts [B, nq / tq] i32;
// out [B, nq, k] i32 window-relative ranks. nq % tq == 0, k <= window <= ns.
// k is 16 (cfg.k_n) or 1 (the nearest-neighbour upsample): the two widths
// the model uses; another width needs its own instantiation. centered = 0
// launches K1, 1 launches K5. Plan (ops/knn.py::window_topk_plan): split
// threads per query (1, 2, 4 or 8), qpc queries per CTA, threads per CTA
// = qpc * split rounded up to a warp, at most 256; smem the dynamic
// shared memory the wrapper computed (ops/knn.py::window_topk_smem).
extern "C" int window_topk_launch(const void* support, const void* queries,
                                  const void* starts, void* out, int B,
                                  int ns, int nq, int window, int k, int tq,
                                  int centered, int split, int qpc,
                                  int threads, int self_search, int smem,
                                  void* stream) {
  if (bad_args(B, ns, nq, window, k, tq, centered, split, qpc, threads,
               smem))
    return (int)cudaErrorInvalidValue;
  if (nq == 0) return (int)cudaSuccess;
  const float* s = (const float*)support;
  const float* q = (const float*)queries;
  const int* st = (const int*)starts;
  int* o = (int*)out;
  cudaStream_t cs = (cudaStream_t)stream;
  if (k == 1 && !centered)
    return (int)launch_k<1, false, false>(s, q, st, o, B, ns, nq, window, tq,
                                          split, qpc, threads, self_search,
                                          smem, nullptr, 0, cs);
  if (k == 16 && !centered)
    return (int)launch_k<16, false, false>(s, q, st, o, B, ns, nq, window,
                                           tq, split, qpc, threads,
                                           self_search, smem, nullptr, 0, cs);
  if (k == 1 && centered)
    return (int)launch_k<1, true, false>(s, q, st, o, B, ns, nq, window, tq,
                                         split, qpc, threads, self_search,
                                         smem, nullptr, 0, cs);
  if (k == 16 && centered)
    return (int)launch_k<16, true, false>(s, q, st, o, B, ns, nq, window, tq,
                                          split, qpc, threads, self_search,
                                          smem, nullptr, 0, cs);
  return (int)cudaErrorInvalidValue;
}

// The counter build of K1 (centered = 0 only), for measurement: the same
// arguments, plus stats [9] u64 (zeroed by the caller) gaining [box tests,
// blocks visited, groups visited, groups past the filter in some lane (all
// four a warp's), keys buffered, keys kept (a lane's), flushes, insertion
// rounds (a warp's), warps] (kernels/k1_twin.py counts the same), and cut:
// 0 the whole kernel, 1 only the staging, 2 the staging and the fill
// (nothing written).
extern "C" int window_topk_stats_launch(const void* support,
                                        const void* queries,
                                        const void* starts, void* out, int B,
                                        int ns, int nq, int window, int k,
                                        int tq, int split, int qpc,
                                        int threads, int self_search,
                                        int smem, void* stats, int cut,
                                        void* stream) {
  if (bad_args(B, ns, nq, window, k, tq, 0, split, qpc, threads, smem) ||
      cut < 0 || cut > 2)
    return (int)cudaErrorInvalidValue;
  if (nq == 0) return (int)cudaSuccess;
  const float* s = (const float*)support;
  const float* q = (const float*)queries;
  const int* st = (const int*)starts;
  int* o = (int*)out;
  auto* c = (unsigned long long*)stats;
  cudaStream_t cs = (cudaStream_t)stream;
  if (k == 1)
    return (int)launch_k<1, false, true>(s, q, st, o, B, ns, nq, window, tq,
                                         split, qpc, threads, self_search,
                                         smem, c, cut, cs);
  if (k == 16)
    return (int)launch_k<16, false, true>(s, q, st, o, B, ns, nq, window, tq,
                                          split, qpc, threads, self_search,
                                          smem, c, cut, cs);
  return (int)cudaErrorInvalidValue;
}
