// K2: windowed neighbour gather.
//
// Replaces the TPU kernel ssdr_al_tpu/ops/gather.py::_gather_kernel
// (launched by _gather_window_impl from gather_window / gather_window_auto).
// out[b, q, j, :] = values[b, idx[b, q, j], :] for every index inside its
// query tile's window [starts[b, q / tq], starts[b, q / tq] + window); an
// index outside the window gives a zero row, as the TPU one-hot matmul does.
// The copy is exact: f32 in, f32 out. The TPU kernel rounded every value to
// bf16 for its MXU one-hot product.
//
// Bound on the H100: device-memory bytes. Nothing is computed; the output
// (B * nq * k rows of c values) is written once and dominates the traffic,
// and the windowed reads hit L1 or L2 (a window is at most a few hundred
// KB). The first design (one thread per output value, 64-bit divisions and
// reloads of idx and starts for each value, scalar stores) was bound by
// instruction issue instead, at half the rate of torch.gather.
// Design: one CTA writes `rows` consecutive output rows of one gather tile:
// one contiguous span of rows * c floats, 16-byte aligned (the wrapper
// keeps tq a multiple of 4). Each thread writes whole float4s, neighbouring
// threads on neighbouring addresses. The tile's start is read once per CTA;
// a float4's first row comes from a multiply-high by ceil(2^32 / c) (exact
// for spans below 2^24 floats, c <= 256), and the next rows by stepping the
// channel, so there is no division; every offset is 32-bit. Sources:
//  - SLAB: the CTA copies the window [W, c] into shared memory first and
//    gathers from there (one CTA per whole tile, for a small window on a
//    grid of many tiles: the L0 LFA gather of 8 channels);
//  - otherwise rows are read through L1/L2 with __ldg.
// ops/gather.py::gather_plan picks the source, `rows` and the CTA size.
// On the H100 both reach 55-68 % of the bytes bound at the main path's
// shapes, and 1.2-1.6x torch.gather's rate on the same indices.
#include <cuda_runtime.h>

namespace {

template <bool SLAB>
__global__ void gather_window_kernel(const float* __restrict__ values,
                                     const int* __restrict__ idx,
                                     const int* __restrict__ starts,
                                     float* __restrict__ out, int n, int nq,
                                     int k, int c, int window, int tq,
                                     int rows, unsigned magic) {
  extern __shared__ __align__(16) float slab[];
  const int b = blockIdx.y;
  const int parts = tq * k / rows;
  const int t = blockIdx.x / parts;
  const int part = blockIdx.x - t * parts;
  int lo = starts[b * (nq / tq) + t];
  lo = min(max(lo, 0), n - window);  // the plain version clamps too
  const float* win = values + ((size_t)b * n + lo) * c;
  const size_t row0 = ((size_t)b * nq + (size_t)t * tq) * k +
                      (size_t)part * rows;
  const int* ix = idx + row0;
  float4* o4 = reinterpret_cast<float4*>(out + row0 * c);
  if (SLAB) {
    for (int i = threadIdx.x; i < window * c; i += blockDim.x)
      slab[i] = __ldg(win + i);
    __syncthreads();
  }
  const int n4 = rows * c / 4;
#pragma unroll 2
  for (int v = threadIdx.x; v < n4; v += blockDim.x) {
    const unsigned p = 4u * v;
    int r = c == 1 ? (int)p : (int)__umulhi(p, magic);  // p / c
    int ch = (int)p - r * c;
    int i = __ldg(ix + r) - lo;
    float e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j && ++ch == c) {
        ch = 0;
        i = __ldg(ix + ++r) - lo;
      }
      const bool in = (unsigned)i < (unsigned)window;
      e[j] = in ? (SLAB ? slab[i * c + ch] : __ldg(win + i * c + ch)) : 0.f;
    }
    o4[v] = make_float4(e[0], e[1], e[2], e[3]);
  }
}

}  // namespace

// values [B, n, c] f32; idx [B, nq, k] i32; starts [B, nq / tq] i32;
// out [B, nq, k, c] f32. Plan (ops/gather.py::gather_plan): slab 0 or 1,
// rows per CTA dividing tq * k with rows * c a multiple of 4, threads per
// CTA.
extern "C" int gather_window_launch(const void* values, const void* idx,
                                    const void* starts, void* out, int B,
                                    int n, int nq, int k, int c, int window,
                                    int tq, int slab, int rows, int threads,
                                    void* stream) {
  if (B < 1 || B > 65535 || tq < 1 || nq % tq || k < 1 || c < 1 ||
      c > 256 || window < 1 || window > n || rows < 1 || (tq * k) % rows ||
      (rows * c) % 4 || (long long)rows * c >= (1LL << 24) || threads < 32 ||
      threads > 1024 || threads % 32 || (long long)window * c >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * nq * k == 0) return (int)cudaSuccess;
  const unsigned magic = c == 1 ? 0u : 0xFFFFFFFFu / (unsigned)c + 1u;
  const long long ctas = (long long)(nq / tq) * (tq * k / rows);
  if (ctas > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ctas, B);
  cudaStream_t cs = (cudaStream_t)stream;
  if (slab) {
    const size_t smem = (size_t)window * c * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        gather_window_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    gather_window_kernel<true><<<grid, threads, smem, cs>>>(
        (const float*)values, (const int*)idx, (const int*)starts,
        (float*)out, n, nq, k, c, window, tq, rows, magic);
  } else {
    gather_window_kernel<false><<<grid, threads, 0, cs>>>(
        (const float*)values, (const int*)idx, (const int*)starts,
        (float*)out, n, nq, k, c, window, tq, rows, magic);
  }
  return (int)cudaGetLastError();
}
