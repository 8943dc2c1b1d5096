// The warp-cooperative top-k of K6's K = 64 walk (knn_tiled.cu::
// knn_walk64_kernel): one query's list of 64 ascending keys spread over
// the 32 lanes of its warp, the key at list position p in lane p % 32
// (a for p < 32, b for p >= 32).
//
// The keys are key_topk.cuh's (d2 bits above the original index), a total
// order, so a list of the least keys equals a stable sort by d2. Where a
// lane-per-query list of 64 keys takes 128 registers a thread (one CTA an
// SM), this one takes 4, and the candidates come 32 at a time, one a lane:
//  - fill: two blocks' 64 candidates sorted at once (a bitonic network of
//    shuffles), so the threshold is set before the walk starts;
//  - offer: a block's candidates below the threshold (the key at position
//    kout - 1: only the first kout keys are written, and a key at or above
//    it is not among them) enter together. Up to kRankMerge entrants: for
//    each, in lane order, one broadcast and two ballots give every list key
//    the entrants below it and the entrant the list keys below it; then
//    each key is stored at its new position in the warp's 64 slots of
//    shared memory (those past 63 drop out) and the list is read back.
//    More entrants (mostly the first blocks after the fill): the block's
//    keys sorted descending, their least 32 with the list's upper half
//    (elementwise minimum against it ascending), that sorted and merged
//    with the lower half by bitonic stages of shuffles, 32 stages whatever
//    their number. A block with no entrant costs one ballot.
// The first kout keys are the exact top-kout of every candidate offered,
// whatever the order of the blocks: an entrant is below the kout-th key,
// and a candidate at or above it cannot be among the first kout.
#pragma once

#include "key_topk.cuh"

// One compare-exchange of a bitonic network over the lanes: the pair (this
// lane, lane ^ j), this lane taking the lesser key where `lower`.
__device__ __forceinline__ u64 lane_cx(u64 v, int j, bool lower) {
  const u64 o = __shfl_xor_sync(kFull, v, j);
  return (o < v) == lower ? o : v;
}

// Entrants of a block merged by ranks up to this many, by bitonic stages
// beyond: on the H100 at [1 x 139 686], 6 and 8 timed faster than 0, 4,
// 10, 12 and 16, and than ranks for every block.
constexpr int kRankMerge = 8;

// One key a lane sorted over the warp: ascending with the lane, or
// descending where DESC.
template <bool DESC>
__device__ __forceinline__ u64 warp_sort32(u64 v, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1)
      v = lane_cx(v, j, (((lane & j) == 0) == ((lane & k) == 0)) != DESC);
  return v;
}

struct WarpTopK64 {
  u64 a, b;      // the keys at list positions lane and 32 + lane
  u64 thr;       // the key at position kout - 1
  float thr_d;   // its d2: a box whose box_lb is strictly above it holds
                 // no entrant (an equal d2 may still enter on a lower index)
  u64* slots;    // the warp's 64 keys of shared memory
  int kout, lane;

  __device__ __forceinline__ void set_thr() {
    // kout is the same on every lane: one shuffle of a or of b
    thr = __shfl_sync(kFull, kout > 32 ? b : a, (kout - 1) & 31);
    thr_d = __uint_as_float((unsigned)(thr >> 32));
  }
  // (a ascending, b descending), one bitonic sequence of 64 → ascending: a
  // half-cleaner, then five shuffle stages on each half.
  __device__ __forceinline__ void sort_bitonic64() {
    const u64 lo = b < a ? b : a;
    b = b < a ? a : b;
    a = lo;
#pragma unroll
    for (int j = 16; j > 0; j >>= 1) {
      a = lane_cx(a, j, (lane & j) == 0);
      b = lane_cx(b, j, (lane & j) == 0);
    }
  }
  // The list from 64 candidates, c0 and c1 a lane (the empty key for a slot
  // with no candidate).
  __device__ __forceinline__ void fill(u64 c0, u64 c1) {
    a = warp_sort32<false>(c0, lane);
    b = warp_sort32<true>(c1, lane);
    sort_bitonic64();
    set_thr();
  }
  // Merge this lane's candidate c if it is below the threshold; returns the
  // number of entrants of the warp.
  __device__ __forceinline__ int offer(u64 c) {
    const bool in = c < thr;
    const unsigned mask = __ballot_sync(kFull, in);
    if (!mask) return 0;
    if (__popc(mask) > kRankMerge) {
      // b ascending against the entrants descending: the elementwise
      // minimum is the least 32 of both, one bitonic sequence; sorted
      // descending, it makes one with a
      const u64 cd = warp_sort32<true>(in ? c : ~0ull, lane);
      b = cd < b ? cd : b;
#pragma unroll
      for (int j = 16; j > 0; j >>= 1) b = lane_cx(b, j, (lane & j) != 0);
      sort_bitonic64();
      set_thr();
      return __popc(mask);
    }
    int sa = 0, sb = 0, below_c = 0, rank = 0;
#pragma unroll 1
    for (unsigned m = mask; m; m &= m - 1) {
      const int j = __ffs(m) - 1;
      const u64 cj = __shfl_sync(kFull, c, j);
      const bool ga = cj < a, gb = cj < b;  // cj goes before a / b
      sa += ga;
      sb += gb;
      // no list key equals an entrant (each support index enters once)
      const int under = __popc(__ballot_sync(kFull, !ga)) +
                        __popc(__ballot_sync(kFull, !gb));
      if (lane == j) rank = under;
      below_c += cj < c;
    }
    __syncwarp();
    if (lane + sa < 64) slots[lane + sa] = a;
    if (lane + 32 + sb < 64) slots[lane + 32 + sb] = b;
    if (in && rank + below_c < 64) slots[rank + below_c] = c;
    __syncwarp();
    a = slots[lane];
    b = slots[32 + lane];
    set_thr();
    return __popc(mask);
  }
};
