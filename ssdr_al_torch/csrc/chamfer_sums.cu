// K3: directional chamfer sums between padded superpoints.
//
// Replaces the TPU kernel ssdr_al_tpu/ops/chamfer.py::_chamfer_sums_kernel
// (launched by chamfer_pairwise_blocks_pallas). For every block c and every
// ordered pair (a, b) of superpoints:
//   out[c, a, b] = sum over b's valid points q of min over a's valid points p
//                  of ||p - q||
// and 0 when a or b has no valid point. The combine epilogue (division by
// the counts, transpose-add, 1e15 at empty superpoints, zero diagonal)
// stays in PyTorch (ops/chamfer.py::chamfer_pairwise_blocks), as it stayed
// in XLA on the TPU.
//
// Bound on the H100: FP32 arithmetic against a few MB of input. The least
// work is one d^2 per unordered pair of valid points in distinct
// superpoints (8 operations) and its two minima. d^2 stays exact f32 in
// the difference form, fma(dz, dz, fma(dy, dy, dx * dx)), symmetric in p
// and q to the bit; the TPU kernel built it with a bf16x3 matmul.
// The first design (a CTA per source superpoint, a lane per target point,
// three scalar shared loads per pair, masked targets idling, every pair
// computed for (a, b) and again for (b, a)) was load-issue bound at a
// quarter of the operation bound. This design:
//  1. chamfer_pack_kernel compacts each superpoint's valid points, in
//     order, into float4 rows [C, S, P] with their counts (a warp a row).
//  2. chamfer_pairs_kernel: each warp takes unordered pairs (a, b), a < b,
//     one at a time from a global task counter (three CTAs of 8 warps an
//     SM, 80 registers a thread), so the card stays busy to the last
//     pair; tasks fold rows x and S - 1 - x into S - 1 pairs. The
//     smaller side's points sit in registers, TB per lane (TB the least
//     even number with 32 * TB >= their count, at most 16); the other
//     side streams 32 points at a time, one per lane, through 512 bytes
//     of shared memory a warp, each read a broadcast. Each d^2 updates
//     the register point's minimum (one direction) and a per-stream-point
//     minimum (the other), which a 32 x 32 transpose-reduction of shuffles
//     finishes, evaluated depth first (col_min). So each d^2 is
//     computed once and gives both sums. Padding is +inf on the streamed
//     side and -inf on the register side, so no pad value reaches a
//     minimum of real points and no NaN arises.
// Sums run in a fixed order (per lane, then a shuffle butterfly), and a
// minimum is exact: the result is deterministic. Pairs whose sides both
// exceed 512 points (uncapped superpoints) take each direction in turn,
// 512 register points at a time.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TB_MAX = 16;                 // register points per lane
constexpr int PAIR_THREADS = 256;          // 8 warps a CTA of the pair kernel

// One warp per superpoint row: its valid points, in order, as float4s.
__global__ void chamfer_pack_kernel(const float* __restrict__ points,
                                    const uint8_t* __restrict__ mask,
                                    float4* __restrict__ packed,
                                    int* __restrict__ counts, int P,
                                    long long rows) {
  if (blockIdx.x == 0 && threadIdx.x == 0) counts[rows] = 0;  // task counter
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* pts = points + row * P * 3;
  const uint8_t* m = mask + row * P;
  float4* out = packed + row * P;
  int cnt = 0;
  for (int p0 = 0; p0 < P; p0 += 32) {
    const int p = p0 + lane;
    const bool v = p < P && m[p];
    const unsigned bal = __ballot_sync(FULL, v);
    if (v)
      out[cnt + __popc(bal & ((1u << lane) - 1u))] =
          make_float4(pts[3 * p], pts[3 * p + 1], pts[3 * p + 2], 0.f);
    cnt += __popc(bal);
  }
  if (lane == 0) counts[row] = cnt;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The 32 x 32 transpose-reduction of column minima, evaluated depth
// first: the minimum over the lane's register points of d^2 to streamed
// point I of buf, at S == 32 (updating the row minima rm on the way), and
// below that the step in which lanes that differ in bit S swap halves and
// keep the minimum of the half they own. col_min<TB, 1, 0> leaves lane l
// with the least d^2 from streamed point l to any register point. Depth
// first, at most one partial per level is live (not 32 column minima), and
// each shuffle overlaps the next point's arithmetic.
template <int TB, int S, int I>
__device__ __forceinline__ float col_min(const float4* buf,
                                         const float (&qx)[TB],
                                         const float (&qy)[TB],
                                         const float (&qz)[TB],
                                         float (&rm)[TB], int lane) {
  if constexpr (S == 32) {
    const float4 pj = buf[I];               // a broadcast
    float m[2];
#pragma unroll
    for (int t = 0; t < TB; ++t) {
      const float dx = pj.x - qx[t], dy = pj.y - qy[t], dz = pj.z - qz[t];
      const float d = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
      rm[t] = fminf(rm[t], d);
      m[t & 1] = t < 2 ? d : fminf(m[t & 1], d);  // two chains
    }
    return fminf(m[0], m[1]);
  } else {
    const float lo = col_min<TB, 2 * S, I>(buf, qx, qy, qz, rm, lane);
    const float hi = col_min<TB, 2 * S, I + S>(buf, qx, qy, qz, rm, lane);
    const bool up = lane & S;
    return fminf(up ? hi : lo, __shfl_xor_sync(FULL, up ? lo : hi, S));
  }
}

// One warp: nt <= 32 * TB register points `reg`, ns streamed points `str`.
// Returns this lane's (sum over its register points of sqrt(min over str
// of d^2), sum over its streamed points of sqrt(min over reg of d^2)).
// buf: this warp's 32 float4s of shared memory.
template <int TB>
__device__ __forceinline__ float2 pair_pass(const float4* __restrict__ str,
                                         int ns,
                                         const float4* __restrict__ reg,
                                         int nt, float4* buf) {
  const int lane = threadIdx.x & 31;
  const float4 pad = make_float4(INFINITY, INFINITY, INFINITY, 0.f);
  float rowsum = 0.f, colsum = 0.f;
  float qx[TB], qy[TB], qz[TB], rm[TB];
#pragma unroll
  for (int t = 0; t < TB; ++t) {
    const int j = lane + 32 * t;
    if (j < nt) {
      const float4 q = reg[j];
      qx[t] = q.x;
      qy[t] = q.y;
      qz[t] = q.z;
    } else {
      qx[t] = qy[t] = qz[t] = -INFINITY;
    }
    rm[t] = INFINITY;
  }
  float4 next = lane < ns ? str[lane] : pad;
  for (int p0 = 0; p0 < ns; p0 += 32) {
    __syncwarp();
    buf[lane] = next;                       // each read below a broadcast
    __syncwarp();
    next = p0 + 32 + lane < ns ? str[p0 + 32 + lane] : pad;  // prefetch
    const float cm = col_min<TB, 1, 0>(buf, qx, qy, qz, rm, lane);
    if (p0 + lane < ns) colsum += sqrtf(cm);
  }
#pragma unroll
  for (int t = 0; t < TB; ++t)
    if (lane + 32 * t < nt) rowsum += sqrtf(rm[t]);
  return make_float2(rowsum, colsum);
}

// pair_pass with the least even TB that holds nt <= 32 * TB_MAX points
__device__ float2 pair_dispatch(const float4* str, int ns, const float4* reg,
                                int nt, float4* buf) {
  switch ((nt + 63) >> 6) {
    case 1: return pair_pass<2>(str, ns, reg, nt, buf);
    case 2: return pair_pass<4>(str, ns, reg, nt, buf);
    case 3: return pair_pass<6>(str, ns, reg, nt, buf);
    case 4: return pair_pass<8>(str, ns, reg, nt, buf);
    case 5: return pair_pass<10>(str, ns, reg, nt, buf);
    case 6: return pair_pass<12>(str, ns, reg, nt, buf);
    case 7: return pair_pass<14>(str, ns, reg, nt, buf);
    default: return pair_pass<16>(str, ns, reg, nt, buf);
  }
}

// The unordered pair (a, b), a < b, of task l of a block of S
// superpoints: rows x and S - 1 - x fold into S - 1 tasks (the row x
// pairs, then the row S - 1 - x pairs), and an odd S's middle row has
// (S - 1) / 2 of its own after them; S (S - 1) / 2 tasks in all.
__device__ __forceinline__ int2 pair_of_task(int l, int S) {
  const int folded = (S / 2) * (S - 1);
  if (l >= folded) {                        // the middle row of an odd S
    const int m = S / 2;
    return make_int2(m, m + 1 + (l - folded));
  }
  const int x = l / (S - 1), t = l - x * (S - 1);
  const int n1 = S - 1 - x;
  return t < n1 ? make_int2(x, x + 1 + t)
                : make_int2(S - 1 - x, S - x + (t - n1));
}

// at most 80 registers a thread: three CTAs of 8 warps an SM (the rare
// TB = 14 and 16 passes spill a little). Warps take
// pair tasks from a global counter (zeroed by the pack kernel), so the
// card stays balanced to the last pair; each output is written by the
// one warp that took its task, in a fixed order, whichever warp that is.
__global__ void __launch_bounds__(PAIR_THREADS, 3)
chamfer_pairs_kernel(const float4* __restrict__ packed,
                     const int* __restrict__ counts, int* __restrict__ next,
                     float* __restrict__ out, int C, int S, int P) {
  __shared__ float4 stream_buf[PAIR_THREADS / 32][32];  // 32 points a warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < C * S;
       i += gridDim.x * blockDim.x)
    out[(size_t)i * S + i % S] = 0.f;       // a superpoint against itself
  const int per_c = S * (S - 1) / 2;
  const int total = C * per_c;
  for (;;) {
    int task = 0;
    if (lane == 0) task = atomicAdd(next, 1);
    task = __shfl_sync(FULL, task, 0);
    if (task >= total) break;
    const int c = task / per_c;
    const int2 ab = pair_of_task(task - c * per_c, S);
    const int a = ab.x, b = ab.y;
    const int na = counts[(size_t)c * S + a], nb = counts[(size_t)c * S + b];
    float oab = 0.f, oba = 0.f;             // o[a, b]: sum over b's points
    if (na > 0 && nb > 0) {
      const float4* pa = packed + ((size_t)c * S + a) * P;
      const float4* pb = packed + ((size_t)c * S + b) * P;
      // the smaller side in registers
      const bool breg = nb <= na;
      const float4* reg = breg ? pb : pa;
      const float4* str = breg ? pa : pb;
      const int nt = breg ? nb : na, ns = breg ? na : nb;
      float rs = 0.f, cs = 0.f;             // sums over reg, over str
      if (nt <= 32 * TB_MAX) {
        const float2 v = pair_dispatch(str, ns, reg, nt, stream_buf[warp]);
        rs = v.x;
        cs = v.y;
      } else {                              // each direction in turn
        for (int r0 = 0; r0 < nt; r0 += 32 * TB_MAX)
          rs += pair_pass<TB_MAX>(str, ns, reg + r0,
                                  min(32 * TB_MAX, nt - r0),
                                  stream_buf[warp]).x;
        for (int r0 = 0; r0 < ns; r0 += 32 * TB_MAX)
          cs += pair_pass<TB_MAX>(reg, nt, str + r0,
                                  min(32 * TB_MAX, ns - r0),
                                  stream_buf[warp]).x;
      }
      rs = warp_sum(rs);
      cs = warp_sum(cs);
      oab = breg ? rs : cs;
      oba = breg ? cs : rs;
    }
    if (lane == 0) {
      float* oc = out + (size_t)c * S * S;
      oc[(size_t)a * S + b] = oab;
      oc[(size_t)b * S + a] = oba;
    }
  }
}

}  // namespace

// points [C, S, P, 3] f32; mask [C, S, P] u8 (torch.bool); packed [C, S, P]
// float4 and counts [C * S + 1] i32 (the last the task counter) scratch;
// out [C, S, S] f32.
extern "C" int chamfer_sums_launch(const void* points, const void* mask,
                                   void* packed, void* counts, void* out,
                                   int C, int S, int P, void* stream) {
  if (C < 1 || C > 65535 || S < 1 || P < 1 ||
      (long long)C * S * (S - 1) / 2 >= (1LL << 31) ||
      (long long)C * S >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long rows = (long long)C * S;
  const int bt = 256;
  chamfer_pack_kernel<<<(unsigned)((rows * 32 + bt - 1) / bt), bt, 0, s>>>(
      (const float*)points, (const uint8_t*)mask, (float4*)packed,
      (int*)counts, P, rows);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // three CTAs an SM (the register cap), each warp taking tasks until none
  chamfer_pairs_kernel<<<3 * sms, PAIR_THREADS, 0, s>>>(
      (const float4*)packed, (const int*)counts, (int*)counts + rows,
      (float*)out, C, S, P);
  return (int)cudaGetLastError();
}
