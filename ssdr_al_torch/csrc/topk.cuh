// Per-thread pieces shared by the KNN kernels (window_topk.cu, knn_tiled.cu).
#pragma once

#include <cuda_runtime.h>

// Insert candidate (d, idx) into a register top-k sorted ascending by d.
// K is a template parameter, so the insertion is fully unrolled and every
// index is static. A candidate is taken only when d is below the current
// k-th, and the bubble swaps only on a strict <, so equal distances keep
// the order they arrived in: ties go to the lower index when candidates
// arrive in index order.
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
