// K6: exact brute-force k-nearest-neighbour search.
//
// Replaces the TPU kernel ssdr_al_tpu/ops/knn.py::_knn_kernel (launched by
// _knn_pallas_single, the `pallas` KNN engine). For every query, the k
// nearest support points of the same cloud, ascending by squared distance,
// ties to the lower support index.
//
// Bound on the H100: arithmetic. Every (query, support) pair costs 8
// operations of d2 and one compare; the bytes moved are the two clouds read
// once and k ints per query written. With no FMA the f32 pipes execute 8
// instructions per pair where the 67 TFLOP/s peak counts an FMA as two, so
// about twice the operation bound is the floor of this design.
// Design: one CTA per 256-query tile of one cloud, one thread per query. The
// support is streamed through shared memory in tiles of 512 points stored
// as x, y, z arrays, read four candidates at a time with 16-byte broadcast
// loads. Each thread keeps a sorted top-k in registers (K is a template
// parameter, so the insertion is fully unrolled); a candidate is rejected
// when its d2 is not below the current k-th, which keeps equal distances in
// index order. The pad of the last tile is +inf and is never taken.
//
// Numerics: d2 = (dx*dx + dy*dy) + dz*dz with round-to-nearest intrinsics
// and no FMA contraction, as the plain PyTorch version
// (ops/knn.py::_knn_tiled_plain) computes it, so the two agree index for
// index. With fewer than k support points the slots past them keep index 0,
// as the TPU kernel's zero-initialised best indices do.
#include <cuda_runtime.h>
#include <math.h>

#include "topk.cuh"

namespace {

constexpr int TQ = 256;  // queries per CTA, one thread each
constexpr int TS = 512;  // support points per shared-memory tile

template <int K>
__global__ void __launch_bounds__(TQ)
    knn_tiled_kernel(const float* __restrict__ support,
                     const float* __restrict__ query, int* __restrict__ out,
                     int ns, int nq) {
  __shared__ __align__(16) float sx[TS];
  __shared__ __align__(16) float sy[TS];
  __shared__ __align__(16) float sz[TS];
  const int b = blockIdx.y;
  const int q = blockIdx.x * TQ + threadIdx.x;
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
  for (int base = 0; base < ns; base += TS) {
    const int cnt = min(TS, ns - base);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < TS; i += TQ) {
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
  int* o = out + ((size_t)b * nq + q) * K;
#pragma unroll
  for (int j = 0; j < K; ++j) o[j] = bi[j];
}

}  // namespace

// support [B, ns, 3] f32; query [B, nq, 3] f32; out [B, nq, k] i32 support
// indices. nq >= 1; k is 16 (cfg.k_n) or 1 (the nearest-neighbour
// upsample), the two widths the model uses.
extern "C" int knn_tiled_launch(const void* support, const void* query,
                                void* out, int B, int ns, int nq, int k,
                                void* stream) {
  if (B < 1 || B > 65535 || nq < 1 || ns < 0)
    return (int)cudaErrorInvalidValue;
  const float* s = (const float*)support;
  const float* q = (const float*)query;
  int* o = (int*)out;
  cudaStream_t cs = (cudaStream_t)stream;
  const dim3 grid((nq + TQ - 1) / TQ, B);
  switch (k) {
    case 1:
      knn_tiled_kernel<1><<<grid, TQ, 0, cs>>>(s, q, o, ns, nq);
      break;
    case 16:
      knn_tiled_kernel<16><<<grid, TQ, 0, cs>>>(s, q, o, ns, nq);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
