// K4: windowed scatter-add, the backward of the windowed gather K2.
//
// Replaces the TPU kernel ssdr_al_tpu/ops/gather.py::_scatter_kernel
// (launched by _scatter_window_impl from _gather_window_bwd, the VJP of
// gather_window). dv[b, r, :] = sum of g[b, q, j, :] over the (q, j) with
// idx[b, q, j] == r, for every index inside its query tile's window
// [starts[b, q / tq], starts[b, q / tq] + window); an index outside the
// window contributes nothing, as K2 reads it as a zero row.
//
// Bound on the H100: device-memory bytes. One add per cotangent value; g
// (B * nq * k rows of C values) is read once and dominates the traffic,
// dv is zeroed and accumulated in L2 (at most ~11 MB on the training path).
// Design: the TPU carried the whole [N, C] slab in VMEM across a
// sequential grid axis and built one-hot OH^T @ G products on the MXU;
// CUDA blocks run in no order, so here each thread owns one cotangent value
// and adds it into dv with an f32 atomicAdd (compiled to RED, no return).
// Neighbouring threads read neighbouring values of g (coalesced) and add
// into neighbouring channels of one dv row. Each dv row receives ~k adds,
// so contention is low. The summation order varies from run to run: the
// result is not bitwise reproducible (checked against the plain version
// to a tolerance). The TPU kernel also rounded g to bf16; this one keeps
// f32. 32-bit index arithmetic when the value count fits, 64-bit beyond.
#include <cuda_runtime.h>

template <typename I>
__global__ void scatter_window_kernel(const float* __restrict__ g,
                                      const int* __restrict__ idx,
                                      const int* __restrict__ starts,
                                      float* __restrict__ dv, int n, int nq,
                                      int k, int c, int window, int tq,
                                      int tiles, I total) {
  const I stride = (I)gridDim.x * blockDim.x;
  for (I t = (I)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const I row = t / c;                        // (b * nq + q) * k + j
    const int ch = (int)(t - row * c);
    const I bq = row / k;
    const int b = (int)(bq / nq);
    const int q = (int)(bq - (I)b * nq);
    int lo = starts[b * tiles + q / tq];
    lo = min(max(lo, 0), n - window);           // the plain version clamps too
    const int i = idx[row];
    if (i >= lo && i < lo + window)
      atomicAdd(&dv[((long long)b * n + i) * c + ch], g[t]);
  }
}

// g [B, nq, k, c] f32; idx [B, nq, k] i32; starts [B, nq / tq] i32;
// dv [B, n, c] f32 (zeroed here, on the stream, before the adds).
extern "C" int scatter_window_launch(const void* g, const void* idx,
                                     const void* starts, void* dv, int B,
                                     int n, int nq, int k, int c, int window,
                                     int tq, void* stream) {
  if (B < 1 || n < 1 || tq < 1 || nq % tq || k < 1 || c < 1 || window < 1 ||
      window > n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(dv, 0, (size_t)B * n * c * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * nq * k * c;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  if (total < (1LL << 31) - (long long)blocks * threads)
    scatter_window_kernel<int><<<(unsigned)blocks, threads, 0, s>>>(
        (const float*)g, (const int*)idx, (const int*)starts, (float*)dv, n,
        nq, k, c, window, tq, nq / tq, (int)total);
  else
    scatter_window_kernel<long long><<<(unsigned)blocks, threads, 0, s>>>(
        (const float*)g, (const int*)idx, (const int*)starts, (float*)dv, n,
        nq, k, c, window, tq, nq / tq, total);
  return (int)cudaGetLastError();
}
