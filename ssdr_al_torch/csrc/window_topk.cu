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
//  - Every candidate is keyed by (d2, window rank) as one 64-bit integer:
//    the bits of d2 (>= +0, so they order as the floats do) above the rank.
//    A top-k of keys equals the plain version's stable sort whatever order
//    the candidates arrive in, which frees the order of the walk.
//  - The window is staged by groups of four candidates (x[4], y[4], z[4],
//    K5's |s'|^2[4]), three 16-byte broadcast loads per group, and K1 keeps
//    the bounding box of each block of 8 groups (32 ranks times `split`).
//    Pad candidates past the window never enter the top-k.
//  - The walk is a spiral over blocks: it starts at the block of the warp's
//    middle query (its own rank on a self-search, else the nearest of 32
//    samples of the window) and steps out one block on each side in turn,
//    so the nearest ranks come first and the k-th best tightens early. Its
//    first k candidates fill the list at once, sorted by a bitonic network.
//  - K1 skips a whole block when the least d2 from the query to its box,
//    in the same rounded form as d2 (so never above a candidate's), exceeds
//    the k-th best of every lane of the warp: most blocks at L0. In a
//    block it filters a group on the least of its four d2 in FMA
//    form (6 operations a candidate; at most `filter_bound` above the exact
//    form), and computes the exact d2 and key only for a group that may
//    hold a candidate of the top-k.
//  - A candidate below the k-th best known at the last flush is appended to
//    the thread's buffer in shared memory; when any lane's buffer nears
//    full, the whole warp inserts its buffers into the register top-k
//    together, so the 16-deep insertion runs per buffered candidate of the
//    busiest lane, not on every step where any lane improves.
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
// product; the tensor-core form (tf32x3 mma.sync) is later tuning. The plain
// PyTorch version (ops/knn.py::_window_topk_plain) computes the same values
// and order for both, so each kernel agrees with it index for index. The
// TPU kernels instead zero the low 12 mantissa bits of d2 to pack the index
// there; they can reorder pairs whose distances agree to within 2^-11
// relative.
#include <cuda_runtime.h>
#include <math.h>

#include "topk.cuh"

namespace {

typedef unsigned long long u64;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBuf = 24;                  // buffered candidates per thread
constexpr int kMaxThreads = 256;
constexpr u64 kEmpty = 0x7f800000ull << 32;  // (+inf, rank 0)

__device__ __forceinline__ u64 make_key(float d, int w) {
  // the sign bit is cleared so that -0 orders as +0
  return ((u64)(__float_as_uint(d) & 0x7fffffffu) << 32) | (unsigned)w;
}

// a, b = min, max
__device__ __forceinline__ void cswap(u64& a, u64& b) {
  const bool swap = b < a;
  const u64 lo = swap ? b : a;
  b = swap ? a : b;
  a = lo;
}

// Insert key into the ascending register list bk (K static: fully unrolled).
template <int K>
__device__ __forceinline__ void key_insert(u64 key, u64 (&bk)[K]) {
  if (key < bk[K - 1]) {
    bk[K - 1] = key;
#pragma unroll
    for (int j = K - 1; j > 0; --j) cswap(bk[j - 1], bk[j]);
  }
}

// Sort K (a power of two) keys ascending: a bitonic network, static indices.
template <int K>
__device__ __forceinline__ void key_sort(u64 (&bk)[K]) {
#pragma unroll
  for (int k = 2; k <= K; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1)
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int l = i ^ j;
        if (l > i) {
          if (i & k)
            cswap(bk[l], bk[i]);
          else
            cswap(bk[i], bk[l]);
        }
      }
}

// K1's filter bound: the FMA form dx*dx + (dy*dy + dz*dz) of d2 is within
// 6.1 * 2^-24 relative (plus subnormal steps) of the exact form, both sums
// of non-negative terms; so a candidate whose exact d2 is <= t has its FMA
// form <= bound(t).
__device__ __forceinline__ float filter_bound(float t) {
  return __fmaf_rn(t, 1.0f + 0x1p-20f, 0x1p-126f);
}

template <int K, bool CENTERED>
__global__ void __launch_bounds__(kMaxThreads)
    window_topk_kernel(const float* __restrict__ support,
                       const float* __restrict__ queries,
                       const int* __restrict__ starts, int* __restrict__ out,
                       int ns, int nq, int window, int tq, int split,
                       int qpc, int wpad, int self_search) {
  // the window by groups of four candidates: x[4], y[4], z[4] (K5: centred,
  // then |s'|^2[4]); then K1's block boxes [nblk][lo xyz_, hi xyz_]; then
  // for K > 1 each thread's candidate buffer [kBuf][blockDim.x]
  constexpr int kG = CENTERED ? 16 : 12;  // floats per group
  const int sgroups = wpad / (4 * split);  // super-groups of split groups
  const int nblk = (sgroups + 7) >> 3;     // blocks of 8 super-groups
  extern __shared__ __align__(16) float win[];
  float* box = win + wpad / 4 * kG;
  u64* buf = reinterpret_cast<u64*>(box + (CENTERED ? 0 : nblk * 8));
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
  if constexpr (!CENTERED) {
    for (int blk = tid; blk < nblk; blk += nthr) {
      float4 lo = make_float4(INFINITY, INFINITY, INFINITY, 0.f);
      float4 hi = make_float4(-INFINITY, -INFINITY, -INFINITY, 0.f);
      const int g1 = min(blk + 1, nblk) * 8 * split;
      for (int g = blk * 8 * split; g < min(g1, wpad / 4); ++g) {
        const float4* p = reinterpret_cast<const float4*>(win + g * kG);
        const float4 v[3] = {p[0], p[1], p[2]};  // fminf skips NaN pads
        float l[3], h[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          l[a] = fminf(fminf(v[a].x, v[a].y), fminf(v[a].z, v[a].w));
          h[a] = fmaxf(fmaxf(v[a].x, v[a].y), fmaxf(v[a].z, v[a].w));
        }
        lo = make_float4(fminf(lo.x, l[0]), fminf(lo.y, l[1]),
                         fminf(lo.z, l[2]), 0.f);
        hi = make_float4(fmaxf(hi.x, h[0]), fmaxf(hi.y, h[1]),
                         fmaxf(hi.z, h[2]), 0.f);
      }
      reinterpret_cast<float4*>(box)[2 * blk] = lo;
      reinterpret_cast<float4*>(box)[2 * blk + 1] = hi;
    }
    __syncthreads();
  }

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

  u64 bk[K];
#pragma unroll
  for (int j = 0; j < K; ++j) bk[j] = kEmpty;
  u64 thr = kEmpty;  // the k-th best of the query's lanes at the last flush
  float thr_d = INFINITY;  // its d2, and K1's filter bound of it
  float thr_f = INFINITY;
  int cnt = 0;
  auto set_thr = [&](u64 key) {
    thr = key;
    thr_d = __uint_as_float((unsigned)(key >> 32));
    thr_f = CENTERED ? thr_d : filter_bound(thr_d);
  };
  auto flush = [&]() {
    const int most = (int)__reduce_max_sync(kFull, (unsigned)cnt);
#pragma unroll 1
    for (int i = 0; i < most; ++i)
      if (i < cnt) key_insert<K>(buf[i * nthr + tid], bk);
    cnt = 0;
    // any of the query's lanes holds K keys below its k-th best, so a key
    // at or above the least of them is out
    u64 m = bk[K - 1];
    for (int off = 1; off < split; off <<= 1) {
      const u64 o = __shfl_xor_sync(kFull, m, off);
      m = o < m ? o : m;
    }
    set_thr(m);
  };
  auto consider = [&](float d, int w) {
    const u64 key = make_key(d, w);
    if (key < thr) {
      if constexpr (K == 1) {
        bk[0] = key;
        set_thr(key);
      } else {
        buf[cnt * nthr + tid] = key;
        ++cnt;
      }
    }
  };
  // one group of four candidates: a filter on its least d2 (K1: the FMA
  // form), then the exact d2 and key of each candidate that may enter
  auto visit = [&](int j) {
    const int g = j * split + s;
    const float4* p = reinterpret_cast<const float4*>(win + g * kG);
    const float4 X = p[0], Y = p[1], Z = p[2];
    const int w0 = 4 * g;
    if constexpr (CENTERED) {
      const float4 W = p[3];
      auto dist = [&](float x, float y, float z, float w2) {
        const float m = __fadd_rn(
            __fadd_rn(__fmul_rn(mx, x), __fmul_rn(my, y)), __fmul_rn(mz, z));
        return fmaxf(__fadd_rn(m, __fadd_rn(w2, q2)), 0.f);
      };
      const float d0 = dist(X.x, Y.x, Z.x, W.x);
      const float d1 = dist(X.y, Y.y, Z.y, W.y);
      const float d2 = dist(X.z, Y.z, Z.z, W.z);
      const float d3 = dist(X.w, Y.w, Z.w, W.w);
      if (fminf(fminf(d0, d1), fminf(d2, d3)) <= thr_f) {  // rarely taken
        consider(d0, w0);
        consider(d1, w0 + 1);
        consider(d2, w0 + 2);
        consider(d3, w0 + 3);
      }
    } else {
      float dx[4], dy[4], dz[4], fa[4];
      const float sx[4] = {X.x, X.y, X.z, X.w};
      const float sy[4] = {Y.x, Y.y, Y.z, Y.w};
      const float sz[4] = {Z.x, Z.y, Z.z, Z.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dx[c] = __fsub_rn(qx, sx[c]);
        dy[c] = __fsub_rn(qy, sy[c]);
        dz[c] = __fsub_rn(qz, sz[c]);
        fa[c] = __fmaf_rn(dx[c], dx[c],
                          __fmaf_rn(dy[c], dy[c], __fmul_rn(dz[c], dz[c])));
      }
      if (fminf(fminf(fa[0], fa[1]), fminf(fa[2], fa[3])) <= thr_f) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          consider(__fadd_rn(__fadd_rn(__fmul_rn(dx[c], dx[c]),
                                       __fmul_rn(dy[c], dy[c])),
                             __fmul_rn(dz[c], dz[c])),
                   w0 + c);
      }
    }
  };
  // K1: the least exact-form d2 from the query to block `blk`'s box. Every
  // rounding step is monotone, so it is at most the d2 of any candidate in
  // the box: a block where it exceeds the k-th best of every lane of the
  // warp holds no candidate of any of their top-k.
  auto block_lb = [&](int blk) {
    const float4 lo = reinterpret_cast<const float4*>(box)[2 * blk];
    const float4 hi = reinterpret_cast<const float4*>(box)[2 * blk + 1];
    auto gap = [](float l, float x, float h) {
      return fmaxf(fmaxf(__fsub_rn(l, x), __fsub_rn(x, h)), 0.f);
    };
    const float ex = gap(lo.x, qx, hi.x), ey = gap(lo.y, qy, hi.y);
    const float ez = gap(lo.z, qz, hi.z);
    return __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                     __fmul_rn(ez, ez));
  };

  // The walk: blocks of 8 super-groups (of `split` groups) in a spiral from
  // p0's block, one block out on each side in turn (mod their count), each
  // block's super-groups in order; K1 skips a block when its box is beyond
  // every lane's k-th best.
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
          bk[4 * m + c] = make_key(d, 4 * g + c);
        }
      }
      key_sort<K>(bk);
      flush();  // nothing buffered: shares the threshold
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
    if constexpr (!CENTERED) {
      if (!__any_sync(kFull, block_lb(blk) <= thr_d)) continue;
    }
    const int j_end = min(blk * 8 + 8, sgroups);
    for (int j = blk * 8 + (it == 0 ? first : 0); j < j_end; j += 2) {
      visit(j);
      if (j + 1 < j_end) visit(j + 1);
      if (K > 1 && __any_sync(kFull, cnt > kBuf - 9)) flush();
    }
  }
  if (K > 1) flush();

  // merge the partial lists of a query's split lanes, pairwise
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

template <int K, bool CENTERED>
cudaError_t launch_k(const float* support, const float* queries,
                     const int* starts, int* out, int B, int ns, int nq,
                     int window, int tq, int split, int qpc, int threads,
                     int self_search, cudaStream_t stream) {
  const int wpad = (window + 4 * split - 1) / (4 * split) * (4 * split);
  static_assert(K == 1 || K <= kBuf, "the merge stages a list in the buffer");
  const int nblk = (wpad / (4 * split) + 7) / 8;
  const size_t smem = (size_t)wpad * (CENTERED ? 4 : 3) * sizeof(float) +
                      (CENTERED ? 0 : (size_t)nblk * 8 * sizeof(float)) +
                      (K > 1 ? (size_t)threads * kBuf * sizeof(u64) : 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        window_topk_kernel<K, CENTERED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
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
// = qpc * split rounded up to a warp, at most 256.
extern "C" int window_topk_launch(const void* support, const void* queries,
                                  const void* starts, void* out, int B,
                                  int ns, int nq, int window, int k, int tq,
                                  int centered, int split, int qpc,
                                  int threads, int self_search,
                                  void* stream) {
  if (B < 1 || B > 65535 || tq < 1 || nq % tq || window < k || window > ns ||
      (split != 1 && split != 2 && split != 4 && split != 8) || qpc < 1 ||
      qpc > tq || threads != (qpc * split + 31) / 32 * 32 ||
      threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  if (nq == 0) return (int)cudaSuccess;
  const float* s = (const float*)support;
  const float* q = (const float*)queries;
  const int* st = (const int*)starts;
  int* o = (int*)out;
  cudaStream_t cs = (cudaStream_t)stream;
  if (k == 1 && !centered)
    return (int)launch_k<1, false>(s, q, st, o, B, ns, nq, window, tq, split,
                                   qpc, threads, self_search, cs);
  if (k == 16 && !centered)
    return (int)launch_k<16, false>(s, q, st, o, B, ns, nq, window, tq,
                                    split, qpc, threads, self_search, cs);
  if (k == 1 && centered)
    return (int)launch_k<1, true>(s, q, st, o, B, ns, nq, window, tq, split,
                                  qpc, threads, self_search, cs);
  if (k == 16 && centered)
    return (int)launch_k<16, true>(s, q, st, o, B, ns, nq, window, tq,
                                   split, qpc, threads, self_search, cs);
  return (int)cudaErrorInvalidValue;
}
