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
// rank order, interleaved xyz, a 16-deep insertion whenever any lane of the
// warp found a closer point) issued ~50 instructions per (query,
// candidate) pair: three shared-memory loads per pair, a warp-wide insertion
// on most steps, and one serial walk per query on grids smaller than the
// card at L1 and L2.
// Design (0.41 ms at L0 on the H100, kernels/measure.py; the walk and the
// insertions of the candidates that enter take about equal time):
//  - Candidates are keyed by (d2, window rank) and kept in a buffered
//    register top-k (key_topk.cuh), which frees the order of the walk.
//  - The window is staged by groups of four candidates (x[4], y[4], z[4],
//    K5's |s'|^2[4]), three 16-byte broadcast loads per group, with the
//    bounding box of each block of 8 groups (32 ranks times `split`; K5's
//    also holds the block's largest |s'|^2). Pad candidates past the
//    window never enter the top-k.
//  - The walk is a spiral over blocks: it starts at the block of the warp's
//    middle query (its own rank on a self-search, else the nearest of 32
//    samples of the window) and steps out one block on each side in turn,
//    so the nearest ranks come first and the k-th best tightens early. Its
//    first k candidates fill the list at once, sorted by a bitonic network.
//  - The walk skips a whole block when a lower bound of the d2 of every
//    candidate in it is strictly above the k-th best of every lane of the
//    warp (a candidate at equal d2 may still enter on a lower rank): most
//    blocks at L0. K1's bound is the least d2 to the box in the same
//    rounded form as d2 (key_topk.cuh::box_lb). K5's is the real least d2
//    to the box in centred coordinates, rounded down, less the rounding
//    error of the expanded form (k5_box_lb). In a block each filters a
//    group on the least of its four d2 in FMA form (K1: at most
//    `filter_bound` above the exact form; K5: k5_filter_err); only a group
//    that may hold a candidate of the top-k has its exact d2 and keys
//    built.
//  - `split` threads may share one query (ops/knn.py::window_topk_plan picks
//    1, 2, 4 or 8 so that a small grid has warps enough): thread s walks
//    the groups g = s (mod split), the lanes of a query filter against the
//    least of their k-th bests, and their lists are merged at the end.

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

#include "key_topk.cuh"

namespace {

constexpr int kBuf = 24;                  // buffered candidates per thread
constexpr int kMaxThreads = 256;

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

template <int K, bool CENTERED>
__global__ void __launch_bounds__(kMaxThreads)
    window_topk_kernel(const float* __restrict__ support,
                       const float* __restrict__ queries,
                       const int* __restrict__ starts, int* __restrict__ out,
                       int ns, int nq, int window, int tq, int split,
                       int qpc, int wpad, int self_search) {
  // the window by groups of four candidates: x[4], y[4], z[4] (K5: centred,
  // then |s'|^2[4]); then the block boxes [nblk][lo xyz w2max, hi xyz _];
  // then for K > 1 each thread's candidate buffer [kBuf][blockDim.x]
  constexpr int kG = CENTERED ? 16 : 12;  // floats per group
  const int sgroups = wpad / (4 * split);  // super-groups of split groups
  const int nblk = (sgroups + 7) >> 3;     // blocks of 8 super-groups
  extern __shared__ __align__(16) float win[];
  float* box = win + wpad / 4 * kG;
  u64* buf = reinterpret_cast<u64*>(box + nblk * 8);
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
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
  for (int i = tid; i < wpad; i += nthr) {
    // pad: K1's d2 is NaN (fails every compare); K5's is +inf at a rank
    // above 0, whose key is above the empty slot's (+inf, 0)
    float x = CENTERED ? 0.f : __int_as_float(0x7fc00000), y = x, z = x;
    float w2 = INFINITY;
    if (i < window) {
      x = src[3 * i];
      y = src[3 * i + 1];
      z = src[3 * i + 2];
      if (CENTERED) {
        x = __fsub_rn(x, cx);
        y = __fsub_rn(y, cy);
        z = __fsub_rn(z, cz);
        w2 = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                       __fmul_rn(z, z));
      }
    }
    float* g = win + (i >> 2) * kG + (i & 3);
    g[0] = x;
    g[4] = y;
    g[8] = z;
    if (CENTERED) g[12] = w2;
  }
  __syncthreads();
  // each block's box over its candidates inside the window (pads are
  // never keys of the top-k), and K5's largest |s'|^2 in lo.w
  for (int blk = tid; blk < nblk; blk += nthr) {
    float4 lo = make_float4(INFINITY, INFINITY, INFINITY, 0.f);
    float4 hi = make_float4(-INFINITY, -INFINITY, -INFINITY, 0.f);
    const int g1 = min((blk + 1) * 8 * split, wpad / 4);
    for (int g = blk * 8 * split; g < g1; ++g) {
      const float* p = win + g * kG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (4 * g + c >= window) break;
        lo.x = fminf(lo.x, p[c]);
        lo.y = fminf(lo.y, p[4 + c]);
        lo.z = fminf(lo.z, p[8 + c]);
        hi.x = fmaxf(hi.x, p[c]);
        hi.y = fmaxf(hi.y, p[4 + c]);
        hi.z = fmaxf(hi.z, p[8 + c]);
        if (CENTERED) lo.w = fmaxf(lo.w, p[12 + c]);
      }
    }
    reinterpret_cast<float4*>(box)[2 * blk] = lo;
    reinterpret_cast<float4*>(box)[2 * blk + 1] = hi;
  }
  __syncthreads();

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
  const int lane = tid & 31;
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

  KeyTopK<K, kBuf, !CENTERED> top;
  top.init(buf + tid, nthr);
  // one group of four candidates: a filter on its least d2 in FMA form
  // (K1: under filter_bound of the k-th best; K5: under the bound that
  // the block's k5_filter_err `e5` gives), then the exact d2 and key of each candidate
  // that may enter
  auto visit = [&](int j, float e5) {
    const int g = j * split + s;
    const int w0 = 4 * g;
    if constexpr (CENTERED) {
      const float4* p = reinterpret_cast<const float4*>(win + g * kG);
      const float4 X = p[0], Y = p[1], Z = p[2], W = p[3];
      const float sx[4] = {X.x, X.y, X.z, X.w};
      const float sy[4] = {Y.x, Y.y, Y.z, Y.w};
      const float sz[4] = {Z.x, Z.y, Z.z, Z.w};
      const float sw[4] = {W.x, W.y, W.z, W.w};
      float tw[4], f[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        tw[c] = __fadd_rn(sw[c], q2);
        f[c] = __fmaf_rn(mx, sx[c],
                         __fmaf_rn(my, sy[c], __fmaf_rn(mz, sz[c], tw[c])));
      }
      if (fminf(fminf(f[0], f[1]), fminf(f[2], f[3])) <=
          __fmaf_ru(top.thr_d, 1.0f + 0x1p-22f, e5)) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float m = __fadd_rn(
              __fadd_rn(__fmul_rn(mx, sx[c]), __fmul_rn(my, sy[c])),
              __fmul_rn(mz, sz[c]));
          top.consider(fmaxf(__fadd_rn(m, tw[c]), 0.f), w0 + c);
        }
      }
    } else {
      visit_group(top, qx, qy, qz, win + g * kG,
                  [&](int c) { return (unsigned)(w0 + c); });
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
      // sorted by a network (K insertions would cost 4x more)
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
    if (!__any_sync(kFull, !(block_lb(blk) > top.thr_d))) continue;
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
  if (K > 1) top.flush(split);

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
// and, for K > 1, the candidate buffers (ops/knn.py::window_topk_smem
// computes the same; the launcher refuses a launch where the two differ).
size_t window_topk_smem(int window, int k, bool centered, int split,
                        int threads) {
  const int wpad = (window + 4 * split - 1) / (4 * split) * (4 * split);
  const int nblk = (wpad / (4 * split) + 7) / 8;
  return (size_t)wpad * (centered ? 4 : 3) * sizeof(float) +
         (size_t)nblk * 8 * sizeof(float) +
         (k > 1 ? (size_t)threads * kBuf * sizeof(u64) : 0);
}

template <int K, bool CENTERED>
cudaError_t launch_k(const float* support, const float* queries,
                     const int* starts, int* out, int B, int ns, int nq,
                     int window, int tq, int split, int qpc, int threads,
                     int self_search, size_t smem, cudaStream_t stream) {
  const int wpad = (window + 4 * split - 1) / (4 * split) * (4 * split);
  static_assert(K == 1 || K <= kBuf, "the merge stages a list in the buffer");
  // the kernel has no static shared memory, so only a dynamic size above
  // 48 KiB needs the opt-in; it only grows: a CUDA graph holds launches of
  // several sizes
  static size_t opted = 0;
  if (smem > 48 * 1024 && smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        window_topk_kernel<K, CENTERED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted = smem;
  }
  const int parts = (tq + qpc - 1) / qpc;
  const dim3 grid((nq / tq) * parts, B);
  window_topk_kernel<K, CENTERED><<<grid, threads, smem, stream>>>(
      support, queries, starts, out, ns, nq, window, tq, split, qpc, wpad,
      self_search);
  return cudaGetLastError();
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
  if (B < 1 || B > 65535 || tq < 1 || nq % tq || window < k || window > ns ||
      (split != 1 && split != 2 && split != 4 && split != 8) || qpc < 1 ||
      qpc > tq || threads != (qpc * split + 31) / 32 * 32 ||
      threads > kMaxThreads ||
      (size_t)smem != window_topk_smem(window, k, centered, split, threads))
    return (int)cudaErrorInvalidValue;
  if (nq == 0) return (int)cudaSuccess;
  const float* s = (const float*)support;
  const float* q = (const float*)queries;
  const int* st = (const int*)starts;
  int* o = (int*)out;
  cudaStream_t cs = (cudaStream_t)stream;
  if (k == 1 && !centered)
    return (int)launch_k<1, false>(s, q, st, o, B, ns, nq, window, tq, split,
                                   qpc, threads, self_search, smem, cs);
  if (k == 16 && !centered)
    return (int)launch_k<16, false>(s, q, st, o, B, ns, nq, window, tq,
                                    split, qpc, threads, self_search, smem,
                                    cs);
  if (k == 1 && centered)
    return (int)launch_k<1, true>(s, q, st, o, B, ns, nq, window, tq, split,
                                  qpc, threads, self_search, smem, cs);
  if (k == 16 && centered)
    return (int)launch_k<16, true>(s, q, st, o, B, ns, nq, window, tq,
                                   split, qpc, threads, self_search, smem,
                                   cs);
  return (int)cudaErrorInvalidValue;
}
