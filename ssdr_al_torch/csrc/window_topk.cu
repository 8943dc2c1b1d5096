// K1 and K5: window top-k search on curve-sorted clouds.
//
// K1 replaces the TPU kernel ssdr_al_tpu/ops/knn.py::_knn_window_kernel and
// K5 its variant _knn_window_kernel_mxu (both launched by
// _run_window_pallas). For every query tile t of `tq` sorted queries, search
// the support slice [starts[t], starts[t] + window) and write the k nearest
// as window-relative ranks, ascending by squared distance.
//
// Bound on the H100: arithmetic. Each query does `window` distance
// evaluations (9 FLOP) plus a compare against its k-th best; the bytes moved
// are one support window per tile (window * 12 B) and k ints per query out.
// Design: one CTA per (tile, cloud), one thread per query. The tile's window
// is staged once in shared memory (48 KB at window = 4096 for K1, 64 KB for
// K5; more than 48 KB is opted in as dynamic shared memory) and every thread
// reads the same point in the same step, so each read is a broadcast. Each
// thread keeps a sorted top-k in registers (K is a template parameter, so
// all indices are static).
//
// Numerics: K1's d2 = (dx*dx + dy*dy) + dz*dz with round-to-nearest
// intrinsics and no FMA contraction, ties broken toward the lower window
// index. K5 centres both clouds on the window's first support point c and
// builds d2 = max(m + (|s'|^2 + |q'|^2), 0) with m = sum_i (-2 q'_i) s'_i
// (s' = s - c, q' = q - c), every sum taken left to right without FMA; the
// centred |s'|^2 is computed once per window point into shared memory. The
// TPU kernel forms m as one HIGHEST-precision MXU product; the tensor-core
// form (tf32x3 mma.sync) is later tuning. The plain PyTorch version
// (ops/knn.py::_window_topk_plain) computes the same values and order for
// both, so each kernel agrees with it index for index. The TPU kernels
// instead zero the low 12 mantissa bits of d2 to pack the index there; they
// can reorder pairs whose distances agree to within 2^-11 relative.
#include <cuda_runtime.h>
#include <math.h>

#include "topk.cuh"

template <int K, bool CENTERED>
__global__ void window_topk_kernel(const float* __restrict__ support,
                                   const float* __restrict__ queries,
                                   const int* __restrict__ starts,
                                   int* __restrict__ out, int ns, int nq,
                                   int window, int tq, int tiles) {
  // K1: [window * 3], xyz interleaved. K5: [window * 4], centred xyz and
  // the centred squared norm of each window point.
  extern __shared__ __align__(16) float win[];
  const int b = blockIdx.y;
  const int t = blockIdx.x;
  int start = starts[b * tiles + t];
  start = min(max(start, 0), ns - window);  // the plain version clamps too
  const float* src = support + ((size_t)b * ns + start) * 3;
  const float cx = CENTERED ? src[0] : 0.f;
  const float cy = CENTERED ? src[1] : 0.f;
  const float cz = CENTERED ? src[2] : 0.f;
  if (CENTERED) {
    for (int i = threadIdx.x; i < window; i += blockDim.x) {
      const float x = __fsub_rn(src[3 * i], cx);
      const float y = __fsub_rn(src[3 * i + 1], cy);
      const float z = __fsub_rn(src[3 * i + 2], cz);
      reinterpret_cast<float4*>(win)[i] = make_float4(
          x, y, z,
          __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                    __fmul_rn(z, z)));
    }
  } else {
    for (int i = threadIdx.x; i < window * 3; i += blockDim.x)
      win[i] = src[i];
  }
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
  if (CENTERED) {
    const float ux = __fsub_rn(qx, cx);
    const float uy = __fsub_rn(qy, cy);
    const float uz = __fsub_rn(qz, cz);
    const float q2 = __fadd_rn(__fadd_rn(__fmul_rn(ux, ux), __fmul_rn(uy, uy)),
                               __fmul_rn(uz, uz));
    const float mx = __fmul_rn(-2.f, ux);
    const float my = __fmul_rn(-2.f, uy);
    const float mz = __fmul_rn(-2.f, uz);
    for (int w = 0; w < window; ++w) {
      const float4 s = reinterpret_cast<const float4*>(win)[w];
      const float m = __fadd_rn(__fadd_rn(__fmul_rn(mx, s.x),
                                          __fmul_rn(my, s.y)),
                                __fmul_rn(mz, s.z));
      const float d = fmaxf(__fadd_rn(m, __fadd_rn(s.w, q2)), 0.f);
      topk_insert<K>(d, w, bd, bi);
    }
  } else {
    for (int w = 0; w < window; ++w)
      topk_insert<K>(
          sq_dist(qx, qy, qz, win[3 * w], win[3 * w + 1], win[3 * w + 2]), w,
          bd, bi);
  }
  int* o = out + ((size_t)b * nq + q) * K;
#pragma unroll
  for (int j = 0; j < K; ++j) o[j] = bi[j];
}

template <int K, bool CENTERED>
static cudaError_t launch_k(const float* support, const float* queries,
                            const int* starts, int* out, int B, int ns,
                            int nq, int window, int tq, cudaStream_t stream) {
  const size_t smem = (size_t)window * (CENTERED ? 4 : 3) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        window_topk_kernel<K, CENTERED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int tiles = nq / tq;
  window_topk_kernel<K, CENTERED><<<dim3(tiles, B), tq, smem, stream>>>(
      support, queries, starts, out, ns, nq, window, tq, tiles);
  return cudaGetLastError();
}

// support [B, ns, 3] f32; queries [B, nq, 3] f32; starts [B, nq / tq] i32;
// out [B, nq, k] i32 window-relative ranks. nq % tq == 0, k <= window <= ns,
// tq <= 1024. k is 16 (cfg.k_n) or 1 (the nearest-neighbour upsample): the
// two widths the model uses; another width needs its own instantiation.
// centered = 0 launches K1, 1 launches K5.
extern "C" int window_topk_launch(const void* support, const void* queries,
                                  const void* starts, void* out, int B,
                                  int ns, int nq, int window, int k, int tq,
                                  int centered, void* stream) {
  if (B < 1 || tq < 1 || tq > 1024 || nq % tq || window < k || window > ns)
    return (int)cudaErrorInvalidValue;
  const float* s = (const float*)support;
  const float* q = (const float*)queries;
  const int* st = (const int*)starts;
  int* o = (int*)out;
  cudaStream_t cs = (cudaStream_t)stream;
  if (k == 1 && !centered)
    return (int)launch_k<1, false>(s, q, st, o, B, ns, nq, window, tq, cs);
  if (k == 16 && !centered)
    return (int)launch_k<16, false>(s, q, st, o, B, ns, nq, window, tq, cs);
  if (k == 1 && centered)
    return (int)launch_k<1, true>(s, q, st, o, B, ns, nq, window, tq, cs);
  if (k == 16 && centered)
    return (int)launch_k<16, true>(s, q, st, o, B, ns, nq, window, tq, cs);
  return (int)cudaErrorInvalidValue;
}
