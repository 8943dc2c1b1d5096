// The keyed top-k shared by the KNN walks (window_topk.cu: K1 and K5;
// knn_tiled.cu: K6).
//
// Every candidate is keyed by (d2, id) as one 64-bit integer: the bits of
// d2 (>= +0, so they order as the floats do) above a 32-bit id (a window
// rank in K1/K5, an original support index in K6). A top-k of keys equals
// a stable sort by d2 of the ids in ascending order, whatever order the
// walk takes the candidates in.
//
// A thread keeps its k least keys in registers. A candidate below the k-th
// best known at the last flush goes to the thread's buffer in shared
// memory; when any lane's buffer nears full, the whole warp inserts its
// buffers together, so the K-deep insertion runs once per buffered key of
// the busiest lane rather than on every step where some lane improves.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

typedef unsigned long long u64;
constexpr unsigned kFull = 0xffffffffu;
constexpr u64 kEmpty = 0x7f800000ull << 32;  // (+inf, id 0)

__device__ __forceinline__ u64 make_key(float d, unsigned id) {
  // the sign bit is cleared so that -0 orders as +0
  return ((u64)(__float_as_uint(d) & 0x7fffffffu) << 32) | id;
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

// Sort the first N (a power of two, at most K) keys of bk ascending: a
// bitonic network, static indices.
template <int N, int K>
__device__ __forceinline__ void key_sort(u64 (&bk)[K]) {
  static_assert(N <= K && (N & (N - 1)) == 0, "N: a power of two <= K");
#pragma unroll
  for (int k = 2; k <= N; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1)
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int l = i ^ j;
        if (l > i) {
          if (i & k)
            cswap(bk[l], bk[i]);
          else
            cswap(bk[i], bk[l]);
        }
      }
}

// (dx*dx + dy*dy) + dz*dz with round-to-nearest intrinsics, so nvcc cannot
// contract it into FMAs: the plain PyTorch versions (ops/knn.py::_sq_dist)
// compute the same value.
__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float sx, float sy, float sz) {
  const float dx = __fsub_rn(qx, sx);
  const float dy = __fsub_rn(qy, sy);
  const float dz = __fsub_rn(qz, sz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The group filter's bound: the FMA form dx*dx + (dy*dy + dz*dz) of d2 is
// within 6.1 * 2^-24 relative (plus subnormal steps) of the exact form,
// both sums of non-negative terms; so a candidate whose exact d2 is <= t
// has its FMA form <= bound(t).
__device__ __forceinline__ float filter_bound(float t) {
  return __fmaf_rn(t, 1.0f + 0x1p-20f, 0x1p-126f);
}

// The least (dx*dx + dy*dy) + dz*dz from (qx, qy, qz) to the box [lo, hi],
// rounded to nearest at each step. Every step is monotone, so it is at
// most the d2 (sq_dist) of any point in the box: a box where it exceeds a
// lane's k-th best holds no candidate of that lane's top-k.
__device__ __forceinline__ float box_lb(float4 lo, float4 hi, float qx,
                                        float qy, float qz) {
  auto gap = [](float l, float x, float h) {
    return fmaxf(fmaxf(__fsub_rn(l, x), __fsub_rn(x, h)), 0.f);
  };
  const float ex = gap(lo.x, qx, hi.x), ey = gap(lo.y, qy, hi.y);
  const float ez = gap(lo.z, qz, hi.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                   __fmul_rn(ez, ez));
}

// A thread's top-k of keys with its candidate buffer buf[i * stride],
// i < BUF. FMA_FILTER: the groups are filtered on d2 in FMA form, so the
// filter threshold is filter_bound of the k-th best's d2.
template <int K, int BUF, bool FMA_FILTER>
struct KeyTopK {
  u64 bk[K];
  u64 thr;       // the k-th best of the query's lanes at the last flush
  float thr_d;   // its d2, and the group filter's bound of it
  float thr_f;
  int cnt;
  u64* buf;
  int stride;

  __device__ __forceinline__ void init(u64* b, int s) {
#pragma unroll
    for (int j = 0; j < K; ++j) bk[j] = kEmpty;
    buf = b;
    stride = s;
    cnt = 0;
    set_thr(kEmpty);
  }
  __device__ __forceinline__ void set_thr(u64 key) {
    thr = key;
    thr_d = __uint_as_float((unsigned)(key >> 32));
    thr_f = FMA_FILTER ? filter_bound(thr_d) : thr_d;
  }
  // Insert every lane's buffer; the `split` lanes of a query (consecutive,
  // a power of two) then share the least of their k-th bests: any of them
  // holds K keys below its own, so a key at or above the least is out.
  __device__ __forceinline__ void flush(int split) {
    const int most = (int)__reduce_max_sync(kFull, (unsigned)cnt);
#pragma unroll 1
    for (int i = 0; i < most; ++i)
      if (i < cnt) key_insert<K>(buf[i * stride], bk);
    cnt = 0;
    u64 m = bk[K - 1];
    for (int off = 1; off < split; off <<= 1) {
      const u64 o = __shfl_xor_sync(kFull, m, off);
      m = o < m ? o : m;
    }
    set_thr(m);
  }
  __device__ __forceinline__ void consider(float d, unsigned id) {
    const u64 key = make_key(d, id);
    if (key < thr) {
      if constexpr (K == 1) {
        bk[0] = key;
        set_thr(key);
      } else {
        buf[cnt * stride] = key;
        ++cnt;
      }
    }
  }
  // true on every lane when some lane may not take 8 more candidates
  __device__ __forceinline__ bool nearly_full() const {
    return K > 1 && __any_sync(kFull, cnt > BUF - 9);
  }
};

// One group of four candidates g = x[4], y[4], z[4] (16-byte aligned,
// shared memory) against the query (qx, qy, qz): a filter on the least of
// their d2 in FMA form (6 operations a candidate), then the exact d2
// (sq_dist's form) and key of each candidate of a group that may hold one
// of the top-k; id(c) is candidate c's id. NaN coordinates (pads) fail
// every compare and never enter.
template <class Top, class Id>
__device__ __forceinline__ void visit_group(Top& top, float qx, float qy,
                                            float qz, const float* g, Id id) {
  const float4* p = reinterpret_cast<const float4*>(g);
  const float4 X = p[0], Y = p[1], Z = p[2];
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
  if (fminf(fminf(fa[0], fa[1]), fminf(fa[2], fa[3])) <= top.thr_f) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      top.consider(__fadd_rn(__fadd_rn(__fmul_rn(dx[c], dx[c]),
                                       __fmul_rn(dy[c], dy[c])),
                             __fmul_rn(dz[c], dz[c])),
                   id(c));
  }
}
