// K4: windowed scatter-add, the backward of the windowed gather K2.
//
// Replaces the TPU kernel ssdr_al_tpu/ops/gather.py::_scatter_kernel
// (launched by _scatter_window_impl from _gather_window_bwd, the VJP of
// gather_window). dv[b, r, :] = sum of g[b, q, j, :] over the (q, j) with
// idx[b, q, j] == r, for every index inside its query tile's window
// [starts[b, q / tq], starts[b, q / tq] + window), starts clamped to
// [0, n - window]; an index outside the window contributes nothing, as K2
// reads it as a zero row. Accumulation in f32, into f32 dv. Two
// instantiations: an f32 cotangent (the float32 model) and a bf16 one (the
// bfloat16 model, whose K2 stores bf16): each bf16 value is widened to f32
// in registers and added in the same order, so dv equals index_add_ of
// g.float(). The TPU's VJP cast its bf16 cotangent to f32 before its kernel.
//
// Bound on the H100: device-memory bytes. One add per cotangent value; g
// (B * nq * k rows of c values) is read once and dominates the traffic, dv
// is written once. The first design (one thread per cotangent value, four
// integer divisions and a reload of starts per value, an f32 atomicAdd
// into a zeroed dv) ran at a quarter of the bound and summed in an order
// that changed from run to run.
// Design: output-owned and deterministic. The TPU kernel accumulated each
// tile into a VMEM slab along a sequential grid axis, a fixed order. Here
// the entries (q, j) are first binned by their dv row (int32 entry ids;
// g is not touched), and then each dv row is summed by one group of lanes
// in ascending (q, j) order, the order of the plain version's index_add_
// on the CPU, so the result equals it bit for bit. No atomic touches a
// float and dv needs no memset.
//  1. scatter_fill_kernel, a CTA of 1024 threads per (tile, batch
//     element): reads the tile's idx once into registers, counts its
//     in-window entries per row of the window in shared memory, sorts
//     the tile's entry ids by row there (a scan of the counts), claims a
//     run of slots per row with one integer atomicAdd on the row's count
//     (zeroed), and writes each run into the row's bin of LIST_CAP slots,
//     neighbouring threads on neighbouring slots; a slot past the bin goes,
//     with its row, to the batch element's overflow list. The order in a
//     bin is whatever the atomics gave. One scattered 4-byte store per
//     entry costs five times the rest of this kernel at L0. A window
//     wider than HIST_MAX rows or a tile of more than 8192 entries claims
//     one slot per entry with a global atomic instead.
//  2. scatter_sum_kernel, G lanes per dv row: the row's m ids (about k on
//     average; the first 16 loaded with m, as int4s) sorted in shared
//     memory by rank counting, then each lane adds its channels over the
//     sorted ids, 8-16 loads in flight, and writes them once. A lane
//     loads a row's channels in units: float4s where c % 4 == 0 (f32);
//     for bf16 16-byte units of 8 where c % 8 == 0, 8-byte units of 4
//     where c % 4 == 0; else one value. A row with more than LIST_CAP ids (rare: about k
//     on average) takes the next id in ascending order from its bin and
//     the overflow list by a group minimum.
// No scan and no loop division: tile and batch come from the grid,
// channels from the lane. ops/gather.py::scatter_plan picks G and the
// counting mode.
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int LIST_CAP = 48;     // slots of a row's bin, sorted in smem
constexpr int HIST_MAX = 12288;  // window rows counted in shared memory
constexpr int FILL_THREADS = 1024;
constexpr int FILL_PER = 8;      // entries a fill thread keeps in registers

__device__ __forceinline__ int window_lo(const int* starts, int t, int n,
                                         int window) {
  return min(max(__ldg(starts + t), 0), n - window);
}

// The row of index i in the window [lo, lo + window), or -1 outside it
// (unsigned: an index below lo wraps past the window).
__device__ __forceinline__ int window_row(int i, int lo, int window) {
  const unsigned r = (unsigned)i - (unsigned)lo;
  return r < (unsigned)window ? (int)r : -1;
}

// The tile's in-window entries visited by this thread: f(row, entry).
template <typename F>
__device__ __forceinline__ void for_window_entries(const int* ix, int ne,
                                                   int lo, int window, F f) {
  for (int e = threadIdx.x; e < ne; e += blockDim.x) {
    const int r = window_row(__ldg(ix + e), lo, window);
    if (r >= 0) f(r, e);
  }
}

// slot[r] holds the tile's count of row lo + r; claim that many slots of
// the row's bin (four claims in flight a thread), leaving the first slot.
__device__ void claim_runs(int* slot, int* cb, int window) {
  for (int r0 = threadIdx.x; r0 < window; r0 += 4 * blockDim.x) {
    int h[4], got[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + u * blockDim.x;
      h[u] = r < window ? slot[r] : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (h[u]) got[u] = atomicAdd(cb + r0 + u * blockDim.x, h[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (h[u]) slot[r0 + u * blockDim.x] = got[u];
  }
  __syncthreads();
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

// bins [B, n, LIST_CAP] entry ids; cnt [B, n] ids per row (zeroed);
// ovf [B, nq * k] (row, id) past a bin, ovf_n [B] their count (zeroed).
// Shared memory (hist): claim[window], end[window], ids[ne], rows[ne].
__global__ void __launch_bounds__(FILL_THREADS)
scatter_fill_kernel(const int* __restrict__ idx,
                    const int* __restrict__ starts, int* __restrict__ cnt,
                    int* __restrict__ bins, int2* __restrict__ ovf,
                    int* __restrict__ ovf_n, int n, int nq, int k,
                    int window, int tq, int hist) {
  extern __shared__ int smem[];
  __shared__ int wsum[32];
  const int t = blockIdx.x, b = blockIdx.y;
  const int lo = window_lo(starts, b * (nq / tq) + t, n, window);
  const int ne = tq * k;
  const int* ix = idx + ((size_t)b * nq + (size_t)t * tq) * k;
  int* cb = cnt + (size_t)b * n + lo;
  int* bb = bins + ((size_t)b * n + lo) * LIST_CAP;
  const int e0 = t * ne;                   // the tile's first entry id
  auto file = [&](int r, int e, int s) {
    if (s < LIST_CAP) {
      bb[(size_t)r * LIST_CAP + s] = e0 + e;
    } else {
      const int o = atomicAdd(ovf_n + b, 1);
      ovf[(size_t)b * nq * k + o] = make_int2(lo + r, e0 + e);
    }
  };
  if (!hist || ne > FILL_PER * (int)blockDim.x) {
    // one global claim per entry (never at the main path's shapes)
    for_window_entries(ix, ne, lo, window, [&](int r, int e) {
      file(r, e, atomicAdd(cb + r, 1));
    });
    return;
  }
  int* claim = smem;                       // counts, then the bin slots
  int* end = smem + window;                // the tile list's row runs
  int* ids = end + window;
  int* rows = ids + ne;
  // one read of idx, the window rows kept in registers
  int rr[FILL_PER];
#pragma unroll
  for (int p = 0; p < FILL_PER; ++p) {
    const int e = p * blockDim.x + threadIdx.x;
    rr[p] = e < ne ? window_row(__ldg(ix + e), lo, window) : -1;
  }
  for (int r = threadIdx.x; r < window; r += blockDim.x) claim[r] = 0;
  __syncthreads();
#pragma unroll
  for (int p = 0; p < FILL_PER; ++p)
    if (rr[p] >= 0) atomicAdd(&claim[rr[p]], 1);
  __syncthreads();
  // the tile's list sorted by row: a contiguous run of rows a thread
  const int per = (window + blockDim.x - 1) / blockDim.x;
  const int r0 = min((int)threadIdx.x * per, window);
  const int r1 = min(r0 + per, window);
  int sum = 0;
  for (int r = r0; r < r1; ++r) sum += claim[r];
  int total;
  int run = block_exclusive_scan(sum, wsum, &total);
  for (int r = r0; r < r1; ++r) {          // end[r]: cursor, then run end
    end[r] = run;
    run += claim[r];
  }
  __syncthreads();
  claim_runs(claim, cb, window);           // claim[r]: the first bin slot
#pragma unroll
  for (int p = 0; p < FILL_PER; ++p)
    if (rr[p] >= 0) {
      const int pos = atomicAdd(&end[rr[p]], 1);
      ids[pos] = p * blockDim.x + threadIdx.x;
      rows[pos] = rr[p];
    }
  __syncthreads();
  // write the list out: neighbouring threads on one row's run write
  // neighbouring slots of its bin
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = rows[i];
    const int first = r ? end[r - 1] : 0;  // the run's start in the list
    file(r, ids[i], claim[r] + (i - first));
  }
}

// One unit of a cotangent row: loaded as one T, widened to V f32 values
// (a bf16's f32 is its 16 bits shifted up: exact).
template <typename T> struct Unit;
template <> struct Unit<float> {
  static constexpr int V = 1;
  __device__ static void widen(float x, float* o) { o[0] = x; }
};
template <> struct Unit<float4> {
  static constexpr int V = 4;
  __device__ static void widen(float4 x, float* o) {
    o[0] = x.x;
    o[1] = x.y;
    o[2] = x.z;
    o[3] = x.w;
  }
};
__device__ __forceinline__ void widen_bf16x2(unsigned u, float* o) {
  o[0] = __uint_as_float(u << 16);  // the lower address
  o[1] = __uint_as_float(u & 0xffff0000u);
}
template <> struct Unit<unsigned short> {  // one bf16
  static constexpr int V = 1;
  __device__ static void widen(unsigned short x, float* o) {
    o[0] = __uint_as_float((unsigned)x << 16);
  }
};
template <> struct Unit<uint2> {  // 4 bf16
  static constexpr int V = 4;
  __device__ static void widen(uint2 x, float* o) {
    widen_bf16x2(x.x, o);
    widen_bf16x2(x.y, o + 2);
  }
};
template <> struct Unit<uint4> {  // 8 bf16
  static constexpr int V = 8;
  __device__ static void widen(uint4 x, float* o) {
    widen_bf16x2(x.x, o);
    widen_bf16x2(x.y, o + 2);
    widen_bf16x2(x.z, o + 4);
    widen_bf16x2(x.w, o + 6);
  }
};

// acc[v] += the unit's values, channel by channel in f32
template <typename T>
__device__ __forceinline__ void add_unit(float* acc, T y) {
  float w[Unit<T>::V];
  Unit<T>::widen(y, w);
#pragma unroll
  for (int v = 0; v < Unit<T>::V; ++v) acc[v] += w[v];
}

// V sums written to dv (16-byte stores where V is a multiple of 4)
template <int V>
__device__ __forceinline__ void store_sums(float* o, const float* acc) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int v = 0; v < V; v += 4)
      reinterpret_cast<float4*>(o)[v / 4] =
          make_float4(acc[v], acc[v + 1], acc[v + 2], acc[v + 3]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = acc[v];
  }
}

template <int G> __host__ __device__ constexpr int sum_threads() {
  return G < 4 ? 128 : 256;
}

// G lanes per dv row; T the unit of a cotangent row (Unit<T>: float4 or
// float for an f32 cotangent, uint4, uint2 or one bf16 for a bf16 one).
// Lane lg owns the units lg, lg + G, ... of the row.
template <typename T, int G>
__global__ void __launch_bounds__(sum_threads<G>(), 2048 / sum_threads<G>() / 2)
scatter_sum_kernel(const T* __restrict__ g, const int* __restrict__ cnt,
                   const int* __restrict__ bins,
                   const int2* __restrict__ ovf,
                   const int* __restrict__ ovf_n, float* __restrict__ dv,
                   int n, int nq, int k, int c) {
  constexpr int V = Unit<T>::V;
  constexpr int GROUPS = sum_threads<G>() / G;
  constexpr int STRIDE = 2 * LIST_CAP + 1;  // odd: groups on other banks
  constexpr int SPEC = G < 16 ? 16 : G;      // ids loaded with the count
  constexpr int PER = SPEC / G;              // consecutive ids a lane loads
  constexpr int UNROLL = sizeof(T) >= 16 ? 8 : 16;  // loads in flight
  __shared__ int ids[GROUPS * STRIDE];
  const int lane = threadIdx.x & 31, lg = lane & (G - 1);
  const int grp = threadIdx.x / G;
  const unsigned gmask =
      G == 32 ? FULL : ((1u << G) - 1u) << (lane & ~(G - 1));
  const int b = blockIdx.y, row = blockIdx.x * GROUPS + grp;
  if (row >= n) return;                    // the whole group
  const size_t rb = (size_t)b * n + row;
  const int* bin = bins + rb * LIST_CAP;
  // the bin's first SPEC ids (inside the bin, past m unused) with the
  // count, as int4s where a lane takes 4 or 8
  int pre[PER];
  const int* mine = bin + lg * PER;
  if constexpr (PER % 4 == 0) {
#pragma unroll
    for (int v = 0; v < PER; v += 4) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(mine + v));
      pre[v] = q.x;
      pre[v + 1] = q.y;
      pre[v + 2] = q.z;
      pre[v + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int v = 0; v < PER; ++v) pre[v] = __ldg(mine + v);
  }
  const int m = __ldg(cnt + rb);
  const int cv = c / V;                    // units in a cotangent row
  const T* gb = g + (size_t)b * nq * k * cv;
  float* out = dv + rb * c;
  if (m <= LIST_CAP) {
    int* s = ids + grp * STRIDE;
    int* sorted = s + LIST_CAP;
#pragma unroll
    for (int v = 0; v < PER; ++v)
      if (lg * PER + v < m) s[lg * PER + v] = pre[v];
    for (int i = SPEC + lg; i < m; i += G) s[i] = __ldg(bin + i);
    __syncwarp(gmask);
    for (int i = lg; i < m; i += G) {      // ids are distinct: a rank each
      const int e = s[i];
      int rank = 0;
      for (int j = 0; j < m; ++j) rank += s[j] < e;
      sorted[rank] = e;
    }
    __syncwarp(gmask);
    for (int u = lg; u < cv; u += G) {
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.f;
      for (int i = 0; i < m; i += UNROLL) {
        T y[UNROLL];
#pragma unroll
        for (int q = 0; q < UNROLL; ++q)
          if (i + q < m) y[q] = __ldg(gb + (size_t)sorted[i + q] * cv + u);
#pragma unroll
        for (int q = 0; q < UNROLL; ++q)  // in order
          if (i + q < m) add_unit(acc, y[q]);
      }
      store_sums<V>(out + (size_t)u * V, acc);
    }
  } else {
    // a long row: the next id in ascending order, from the bin and the
    // overflow list, by a group minimum
    const int no = ovf_n[b];
    const int2* ob = ovf + (size_t)b * nq * k;
    for (int u0 = 0; u0 < cv; u0 += G) {
      const int u = u0 + lg;
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.f;
      int prev = -1;
      for (int it = 0; it < m; ++it) {
        int nxt = 0x7fffffff;
        for (int i = lg; i < LIST_CAP; i += G) {
          const int e = __ldg(bin + i);
          if (e > prev) nxt = min(nxt, e);
        }
        for (int i = lg; i < no; i += G) {
          const int2 o = __ldg(ob + i);
          if (o.x == row && o.y > prev) nxt = min(nxt, o.y);
        }
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1)
          nxt = min(nxt, __shfl_xor_sync(gmask, nxt, o));
        if (u < cv) add_unit(acc, __ldg(gb + (size_t)nxt * cv + u));
        prev = nxt;
      }
      if (u < cv) store_sums<V>(out + (size_t)u * V, acc);
    }
  }
}

template <typename T, int G>
cudaError_t launch_sum(const void* g, const int* cnt, const int* bins,
                       const int2* ovf, const int* ovf_n, void* dv, int B,
                       int n, int nq, int k, int c, cudaStream_t s) {
  constexpr int groups = sum_threads<G>() / G;
  const dim3 grid((n + groups - 1) / groups, B);
  scatter_sum_kernel<T, G><<<grid, sum_threads<G>(), 0, s>>>(
      (const T*)g, cnt, bins, ovf, ovf_n, (float*)dv, n, nq, k, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sum_g(int group, const void* g, const int* cnt,
                         const int* bins, const int2* ovf, const int* ovf_n,
                         void* dv, int B, int n, int nq, int k, int c,
                         cudaStream_t s) {
#define K4_SUM(G) \
  launch_sum<T, G>(g, cnt, bins, ovf, ovf_n, dv, B, n, nq, k, c, s)
  switch (group) {
    case 2: return K4_SUM(2);
    case 4: return K4_SUM(4);
    case 8: return K4_SUM(8);
    case 16: return K4_SUM(16);
    default: return K4_SUM(32);
  }
#undef K4_SUM
}

}  // namespace

// g [B, nq, k, c] f32 (g_bf16 0) or bf16 (g_bf16 1); idx [B, nq, k] i32; starts [B, nq / tq] i32;
// scratch: counts [B * n + B] i32 (per row, then the overflow counts),
// bins [B, n, LIST_CAP] i32, ovf [B, nq * k] int2; dv [B, n, c] f32 (every
// value written). Plan (ops/gather.py::scatter_plan): `group` lanes per
// dv row (2, 4, 8, 16 or 32), `hist` 1 to sort each tile in shared memory
// (window <= HIST_MAX and tq * k <= FILL_PER * FILL_THREADS).
extern "C" int scatter_window_launch(const void* g, const void* idx,
                                     const void* starts, void* counts,
                                     void* bins, void* ovf, void* dv, int B,
                                     int n, int nq, int k, int c, int window,
                                     int tq, int group, int hist,
                                     int g_bf16, void* stream) {
  if (B < 1 || B > 65535 || n < 1 || tq < 1 || nq < 0 || nq % tq || k < 1 ||
      c < 1 || window < 1 || window > n ||
      (group != 2 && group != 4 && group != 8 && group != 16 &&
       group != 32) ||
      (hist && (window > HIST_MAX ||
                (long long)tq * k > FILL_PER * FILL_THREADS)) ||
      (long long)nq * k >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (nq == 0) return (int)cudaMemsetAsync(dv, 0, (size_t)B * n * c * 4, s);
  int* cnt = (int*)counts;
  int* ovf_n = cnt + (size_t)B * n;
  cudaError_t e =
      cudaMemsetAsync(cnt, 0, ((size_t)B * n + B) * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  const size_t fill_smem =
      hist ? (2 * (size_t)window + 2 * (size_t)tq * k) * sizeof(int) : 0;
  // the opt-in is needed where dynamic plus static shared memory (wsum)
  // passes the 48 KiB default: Semantic3D's [4, 1024, 16, 256] pool call
  // asks exactly 48 KiB dynamic
  static const size_t fill_static = [] {
    cudaFuncAttributes a{};
    return cudaFuncGetAttributes(&a, scatter_fill_kernel) == cudaSuccess
               ? a.sharedSizeBytes
               : (size_t)48 * 1024;
  }();
  // the opt-in only grows: a CUDA graph holds launches of several sizes
  static size_t opted = 0;
  if (fill_smem > 0 && fill_smem + fill_static > 48 * 1024 &&
      fill_smem > opted) {
    e = cudaFuncSetAttribute(scatter_fill_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)fill_smem);
    if (e != cudaSuccess) return (int)e;
    opted = fill_smem;
  }
  scatter_fill_kernel<<<dim3(nq / tq, B), FILL_THREADS, fill_smem, s>>>(
      (const int*)idx, (const int*)starts, cnt, (int*)bins, (int2*)ovf, ovf_n,
      n, nq, k, window, tq, hist);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int2* o = (const int2*)ovf;
  const int* bn = (const int*)bins;
#define K4_UNIT(T) \
  launch_sum_g<T>(group, g, cnt, bn, o, ovf_n, dv, B, n, nq, k, c, s)
  if (g_bf16)
    return (int)(c % 8 == 0   ? K4_UNIT(uint4)
                 : c % 4 == 0 ? K4_UNIT(uint2)
                              : K4_UNIT(unsigned short));
  return (int)(c % 4 == 0 ? K4_UNIT(float4) : K4_UNIT(float));
#undef K4_UNIT
}
