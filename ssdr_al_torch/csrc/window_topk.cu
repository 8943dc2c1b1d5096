// K1: window top-k search on morton-sorted clouds.
//
// Replaces the TPU kernel ssdr_al_tpu/ops/knn.py::_knn_window_kernel
// (launched by _run_window_pallas). For every query tile t of `tq` sorted
// queries, search the support slice [starts[t], starts[t] + window) and write
// the k nearest as window-relative ranks, ascending by squared distance.
//
// Bound on the H100: arithmetic. Each query does `window` distance
// evaluations (9 FLOP) plus a compare against its k-th best; the bytes moved
// are one support window per tile (window * 12 B) and k ints per query out.
// Design: one CTA per (tile, cloud), one thread per query. The tile's window
// is staged once in shared memory (48 KB at window = 4096; more than 48 KB is
// opted in as dynamic shared memory) and every thread reads the same point
// in the same step, so each read is a broadcast. Each thread keeps a sorted
// top-k in registers (K is a template parameter, so all indices are static).
//
// Numerics: d2 = (dx*dx + dy*dy) + dz*dz with round-to-nearest intrinsics
// and no FMA contraction, ties broken toward the lower window index. The
// plain PyTorch version (ops/knn.py::_window_topk_plain) computes the same
// values and order, so the two agree index for index. The TPU kernel instead
// zeroes the low 12 mantissa bits of d2 to pack the index there; it can
// reorder pairs whose distances agree to within 2^-11 relative.
#include <cuda_runtime.h>
#include <math.h>

template <int K>
__global__ void window_topk_kernel(const float* __restrict__ support,
                                   const float* __restrict__ queries,
                                   const int* __restrict__ starts,
                                   int* __restrict__ out, int ns, int nq,
                                   int window, int tq, int tiles) {
  extern __shared__ float win[];  // [window * 3], xyz interleaved
  const int b = blockIdx.y;
  const int t = blockIdx.x;
  int start = starts[b * tiles + t];
  start = min(max(start, 0), ns - window);  // the plain version clamps too
  const float* src = support + ((size_t)b * ns + start) * 3;
  for (int i = threadIdx.x; i < window * 3; i += blockDim.x) win[i] = src[i];
  __syncthreads();

  const int q = t * tq + threadIdx.x;
  const float* qp = queries + ((size_t)b * nq + q) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = INFINITY;
    bi[j] = 0;
  }
  for (int w = 0; w < window; ++w) {
    const float dx = __fsub_rn(qx, win[3 * w]);
    const float dy = __fsub_rn(qy, win[3 * w + 1]);
    const float dz = __fsub_rn(qz, win[3 * w + 2]);
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz));
    if (d < bd[K - 1]) {
      bd[K - 1] = d;
      bi[K - 1] = w;
      // strict < keeps an earlier (lower-index) equal distance in front
#pragma unroll
      for (int j = K - 1; j > 0; --j) {
        if (bd[j] < bd[j - 1]) {
          const float tv = bd[j]; bd[j] = bd[j - 1]; bd[j - 1] = tv;
          const int ti = bi[j]; bi[j] = bi[j - 1]; bi[j - 1] = ti;
        }
      }
    }
  }
  int* o = out + ((size_t)b * nq + q) * K;
#pragma unroll
  for (int j = 0; j < K; ++j) o[j] = bi[j];
}

template <int K>
static cudaError_t launch_k(const float* support, const float* queries,
                            const int* starts, int* out, int B, int ns,
                            int nq, int window, int tq, cudaStream_t stream) {
  const size_t smem = (size_t)window * 3 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        window_topk_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int tiles = nq / tq;
  window_topk_kernel<K><<<dim3(tiles, B), tq, smem, stream>>>(
      support, queries, starts, out, ns, nq, window, tq, tiles);
  return cudaGetLastError();
}

// support [B, ns, 3] f32; queries [B, nq, 3] f32; starts [B, nq / tq] i32;
// out [B, nq, k] i32 window-relative ranks. nq % tq == 0, k <= window <= ns,
// tq <= 1024. k is 16 (cfg.k_n) or 1 (the nearest-neighbour upsample): the
// two widths the model uses; another width needs its own instantiation.
extern "C" int window_topk_launch(const void* support, const void* queries,
                                  const void* starts, void* out, int B,
                                  int ns, int nq, int window, int k, int tq,
                                  void* stream) {
  if (B < 1 || tq < 1 || tq > 1024 || nq % tq || window < k || window > ns)
    return (int)cudaErrorInvalidValue;
  const float* s = (const float*)support;
  const float* q = (const float*)queries;
  const int* st = (const int*)starts;
  int* o = (int*)out;
  cudaStream_t cs = (cudaStream_t)stream;
  switch (k) {
    case 1:
      return (int)launch_k<1>(s, q, st, o, B, ns, nq, window, tq, cs);
    case 16:
      return (int)launch_k<16>(s, q, st, o, B, ns, nq, window, tq, cs);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
