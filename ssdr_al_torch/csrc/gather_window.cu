// K2: windowed neighbour gather.
//
// Replaces the TPU kernel ssdr_al_tpu/ops/gather.py::_gather_kernel
// (launched by _gather_window_impl from gather_window / gather_window_auto).
// out[b, q, j, :] = values[b, idx[b, q, j], :] for every index inside its
// query tile's window [starts[b, q / tq], starts[b, q / tq] + window); an
// index outside the window gives a zero row, as the TPU one-hot matmul does.
// Two instantiations: f32 in, f32 out, an exact copy (the float32 model);
// and f32 in, bf16 out (the bfloat16 model), each value rounded to nearest
// even, as the TPU kernel rounded every value to bf16 for its MXU one-hot
// product and stored bf16.
//
// Bound on the H100: device-memory bytes. Nothing is computed; the output
// (B * nq * k rows of c values) is written once and dominates the traffic,
// and the windowed reads hit L1 or L2 (a window is at most a few hundred
// KB). The first design (one thread per output value, 64-bit divisions and
// reloads of idx and starts for each value, scalar stores) was bound by
// instruction issue instead, at half the rate of torch.gather.
// Design: one CTA writes `rows` consecutive output rows of one gather tile:
// one contiguous span of rows * c values, aligned to the store unit (the
// wrapper keeps tq a multiple of 4). Each thread writes whole units of U
// values, neighbouring threads on neighbouring addresses: float4s (U = 4)
// for f32; for bf16 16-byte units of 8 where rows * c % 8 == 0, else 8-byte
// units of 4. The tile's start is read once per CTA; a unit's first row
// comes from a multiply-high by ceil(2^32 / c) (exact for spans below 2^24
// values, c <= 256), and the next rows by stepping the channel, so there is
// no division; every offset is 32-bit. Sources (both read f32):
//  - SLAB: the CTA copies the window [W, c] into shared memory first and
//    gathers from there (one CTA per whole tile, for a small window on a
//    grid of many tiles: the L0 LFA gather of 8 channels);
//  - otherwise rows are read through L1/L2 with __ldg.
// ops/gather.py::gather_plan picks the source, `rows` and the CTA size.
// On the H100 both reach 55-68 % of the bytes bound at the main path's
// shapes, and 1.2-1.6x torch.gather's rate on the same indices.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  // two values rounded to nearest even, `lo` at the lower address
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// One store of U consecutive output values.
template <typename Out, int U> struct Unit;
template <> struct Unit<float, 4> {
  __device__ static void put(float* o, int v, const float (&e)[4]) {
    reinterpret_cast<float4*>(o)[v] = make_float4(e[0], e[1], e[2], e[3]);
  }
};
template <> struct Unit<__nv_bfloat16, 8> {
  __device__ static void put(__nv_bfloat16* o, int v, const float (&e)[8]) {
    reinterpret_cast<uint4*>(o)[v] =
        make_uint4(bf16x2(e[0], e[1]), bf16x2(e[2], e[3]),
                   bf16x2(e[4], e[5]), bf16x2(e[6], e[7]));
  }
};
template <> struct Unit<__nv_bfloat16, 4> {
  __device__ static void put(__nv_bfloat16* o, int v, const float (&e)[4]) {
    reinterpret_cast<uint2*>(o)[v] =
        make_uint2(bf16x2(e[0], e[1]), bf16x2(e[2], e[3]));
  }
};

template <bool SLAB, typename Out, int U>
__global__ void gather_window_kernel(const float* __restrict__ values,
                                     const int* __restrict__ idx,
                                     const int* __restrict__ starts,
                                     Out* __restrict__ out, int n, int nq,
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
  Out* o = out + row0 * c;
  if (SLAB) {
    for (int i = threadIdx.x; i < window * c; i += blockDim.x)
      slab[i] = __ldg(win + i);
    __syncthreads();
  }
  const int nu = rows * c / U;
#pragma unroll 2
  for (int v = threadIdx.x; v < nu; v += blockDim.x) {
    const unsigned p = (unsigned)U * v;
    int r = c == 1 ? (int)p : (int)__umulhi(p, magic);  // p / c
    int ch = (int)p - r * c;
    int i = __ldg(ix + r) - lo;
    float e[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (j && ++ch == c) {
        ch = 0;
        i = __ldg(ix + ++r) - lo;
      }
      const bool in = (unsigned)i < (unsigned)window;
      e[j] = in ? (SLAB ? slab[i * c + ch] : __ldg(win + i * c + ch)) : 0.f;
    }
    Unit<Out, U>::put(o, v, e);
  }
}

template <typename Out, int U>
cudaError_t launch(const float* values, const int* idx, const int* starts,
                   void* out, dim3 grid, int threads, bool slab, int n,
                   int nq, int k, int c, int window, int tq, int rows,
                   unsigned magic, cudaStream_t cs) {
  if (slab) {
    const size_t smem = (size_t)window * c * sizeof(float);
    // the opt-in only grows: a CUDA graph holds launches of several sizes
    static size_t opted = 0;
    if (smem > opted) {
      cudaError_t e = cudaFuncSetAttribute(
          gather_window_kernel<true, Out, U>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      opted = smem;
    }
    gather_window_kernel<true, Out, U><<<grid, threads, smem, cs>>>(
        values, idx, starts, (Out*)out, n, nq, k, c, window, tq, rows, magic);
  } else {
    gather_window_kernel<false, Out, U><<<grid, threads, 0, cs>>>(
        values, idx, starts, (Out*)out, n, nq, k, c, window, tq, rows, magic);
  }
  return cudaGetLastError();
}

}  // namespace

// values [B, n, c] f32; idx [B, nq, k] i32; starts [B, nq / tq] i32;
// out [B, nq, k, c] f32 (out_bf16 0) or bf16 (out_bf16 1). Plan
// (ops/gather.py::gather_plan): slab 0 or 1, rows per CTA dividing tq * k
// with rows * c a multiple of the unit, threads per CTA, and the unit:
// values per store, 4 for f32, 8 or 4 for bf16.
extern "C" int gather_window_launch(const void* values, const void* idx,
                                    const void* starts, void* out, int B,
                                    int n, int nq, int k, int c, int window,
                                    int tq, int slab, int rows, int threads,
                                    int out_bf16, int unit, void* stream) {
  if (B < 1 || B > 65535 || tq < 1 || nq % tq || k < 1 || c < 1 ||
      c > 256 || window < 1 || window > n || rows < 1 || (tq * k) % rows ||
      !(unit == 4 || (out_bf16 && unit == 8)) || (rows * c) % unit ||
      (long long)rows * c >= (1LL << 24) || threads < 32 ||
      threads > 1024 || threads % 32 || (long long)window * c >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * nq * k == 0) return (int)cudaSuccess;
  const unsigned magic = c == 1 ? 0u : 0xFFFFFFFFu / (unsigned)c + 1u;
  const long long ctas = (long long)(nq / tq) * (tq * k / rows);
  if (ctas > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ctas, B);
  const float* v = (const float*)values;
  const int* ix = (const int*)idx;
  const int* st = (const int*)starts;
  cudaStream_t cs = (cudaStream_t)stream;
  if (!out_bf16)
    return (int)launch<float, 4>(v, ix, st, out, grid, threads, slab, n, nq,
                                 k, c, window, tq, rows, magic, cs);
  if (unit == 8)
    return (int)launch<__nv_bfloat16, 8>(v, ix, st, out, grid, threads, slab,
                                         n, nq, k, c, window, tq, rows,
                                         magic, cs);
  return (int)launch<__nv_bfloat16, 4>(v, ix, st, out, grid, threads, slab,
                                       n, nq, k, c, window, tq, rows, magic,
                                       cs);
}
