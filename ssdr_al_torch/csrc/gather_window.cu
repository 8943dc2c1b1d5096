// K2: windowed neighbour gather.
//
// Replaces the TPU kernel ssdr_al_tpu/ops/gather.py::_gather_kernel
// (launched by _gather_window_impl from gather_window / gather_window_auto).
// out[b, q, j, :] = values[b, idx[b, q, j], :] for every index inside its
// query tile's window [starts[b, q / tq], starts[b, q / tq] + window); an
// index outside the window gives a zero row, as the TPU one-hot matmul does.
//
// Bound on the H100: device-memory bytes. Nothing is computed; the output
// (B * nq * k rows of C values) is written once and dominates the traffic,
// and the windowed reads hit L2 (a window is at most a few hundred KB).
// Design: a grid-stride loop over output values, so neighbouring threads
// write neighbouring values of the output and read neighbouring values of
// one source row: a warp covers one group of gathered rows with coalesced
// C-wide copies. The copy is exact: f32 in, f32 out. The TPU kernel rounded
// every value to bf16 for its MXU one-hot product.
#include <cuda_runtime.h>

__global__ void gather_window_kernel(const float* __restrict__ values,
                                     const int* __restrict__ idx,
                                     const int* __restrict__ starts,
                                     float* __restrict__ out, int n, int nq,
                                     int k, int c, int window, int tq,
                                     int tiles, long long total) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long row = t / c;               // (b * nq + q) * k + j
    const int ch = (int)(t - row * c);
    const long long bq = row / k;
    const int b = (int)(bq / nq);
    const int q = (int)(bq - (long long)b * nq);
    int lo = starts[b * tiles + q / tq];
    lo = min(max(lo, 0), n - window);          // the plain version clamps too
    const int i = idx[row];
    float v = 0.0f;
    if (i >= lo && i < lo + window) v = values[((long long)b * n + i) * c + ch];
    out[t] = v;
  }
}

// values [B, n, c] f32; idx [B, nq, k] i32; starts [B, nq / tq] i32;
// out [B, nq, k, c] f32.
extern "C" int gather_window_launch(const void* values, const void* idx,
                                    const void* starts, void* out, int B,
                                    int n, int nq, int k, int c, int window,
                                    int tq, void* stream) {
  if (B < 1 || tq < 1 || nq % tq || k < 1 || c < 1 || window < 1 ||
      window > n)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * nq * k * c;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  gather_window_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)values, (const int*)idx, (const int*)starts, (float*)out,
      n, nq, k, c, window, tq, nq / tq, total);
  return (int)cudaGetLastError();
}
