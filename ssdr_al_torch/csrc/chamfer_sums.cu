// K3: directional chamfer sums between padded superpoints.
//
// Replaces the TPU kernel ssdr_al_tpu/ops/chamfer.py::_chamfer_sums_kernel
// (launched by chamfer_pairwise_blocks_pallas). For every block c and every
// ordered pair (a, b) of superpoints:
//   out[c, a, b] = sum over b's valid points q of min over a's valid points p
//                  of ||p - q||
// and 0 when a has no valid point. The combine epilogue (division by the
// counts, transpose-add, 1e15 at empty superpoints, zero diagonal) stays in
// PyTorch (ops/chamfer.py::chamfer_pairwise_blocks), as it stayed in XLA on
// the TPU.
//
// Bound on the H100: FP32 arithmetic, C * S^2 * P^2 distance evaluations
// against a few MB of input. Design: one CTA per (source superpoint a,
// block c). a's valid points are compacted into shared memory (at most
// 12 * P bytes, 6 KB at the 512-point cap); each warp takes target
// superpoints b in turn, each lane walks b's points, takes the exact f32
// minimum over a (FFMA distance, every lane reads the same shared point, a
// broadcast), adds its square root, and the warp reduces by shuffles in a
// fixed order. No atomics touch the output, so the result is deterministic.
// The TPU kernel built d^2 with a bf16x3 matmul; this one is exact f32.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

__global__ void chamfer_sums_kernel(const float* __restrict__ points,
                                    const uint8_t* __restrict__ mask,
                                    float* __restrict__ out, int S, int P) {
  extern __shared__ float a_pts[];  // [P * 3], the valid points of a
  __shared__ int n_valid;
  const int ai = blockIdx.x;
  const int c = blockIdx.y;
  const size_t a_row = (size_t)c * S + ai;
  const float* pa = points + a_row * P * 3;
  const uint8_t* ma = mask + a_row * P;
  if (threadIdx.x == 0) n_valid = 0;
  __syncthreads();
  // compaction order does not matter: the minimum is order-free
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    if (ma[p]) {
      const int slot = atomicAdd(&n_valid, 1);
      a_pts[3 * slot] = pa[3 * p];
      a_pts[3 * slot + 1] = pa[3 * p + 1];
      a_pts[3 * slot + 2] = pa[3 * p + 2];
    }
  }
  __syncthreads();
  const int na = n_valid;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float* orow = out + a_row * S;
  for (int bj = warp; bj < S; bj += nwarps) {
    const size_t b_row = (size_t)c * S + bj;
    const float* pb = points + b_row * P * 3;
    const uint8_t* mb = mask + b_row * P;
    float sum = 0.0f;
    if (na > 0) {
      for (int q = lane; q < P; q += 32) {
        if (!mb[q]) continue;
        const float qx = pb[3 * q], qy = pb[3 * q + 1], qz = pb[3 * q + 2];
        float m = INFINITY;
        for (int i = 0; i < na; ++i) {
          const float dx = qx - a_pts[3 * i];
          const float dy = qy - a_pts[3 * i + 1];
          const float dz = qz - a_pts[3 * i + 2];
          m = fminf(m, fmaf(dz, dz, fmaf(dy, dy, dx * dx)));
        }
        sum += sqrtf(m);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_down_sync(0xffffffffu, sum, off);
    if (lane == 0) orow[bj] = sum;
  }
}

// points [C, S, P, 3] f32; mask [C, S, P] u8 (torch.bool); out [C, S, S] f32.
extern "C" int chamfer_sums_launch(const void* points, const void* mask,
                                   void* out, int C, int S, int P,
                                   void* stream) {
  if (C < 1 || S < 1 || P < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)P * 3 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        chamfer_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  chamfer_sums_kernel<<<dim3(S, C), 256, smem, (cudaStream_t)stream>>>(
      (const float*)points, (const uint8_t*)mask, (float*)out, S, P);
  return (int)cudaGetLastError();
}
