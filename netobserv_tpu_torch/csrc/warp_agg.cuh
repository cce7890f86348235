// Warp aggregation of equal keys (kernels 1, 3, 4, 6, 7 and 8:
// countmin_fold2.cu, hll_fold.cu, signal_agg.cuh for signal_fold.cu and
// signal_fold_tiered.cu, countmin_tier2.cu).
//
// Before an atomic, the lanes of a warp that target the same cell sum (or,
// for the HLL max folds, take the maximum of) their values and only the
// group's first lane issues the atomic, so a hot key costs one atomic per
// warp instead of one per record. It pays where the atomics go to L2
// (kernels 1, 3, 4, 7 and 8) and for f32 adds into shared memory, which
// sm_90 runs as a compare-and-swap loop (kernel 6); kernel 2's integer max
// atomics into a CTA's own shared memory were cheaper than the aggregation
// on the H100 (PERF.md). The pattern:
//
//   unsigned peers = warp_peers(key);          // lanes with this lane's key
//   group_sum<NV>(peers, v);                   // the leader holds the total
//   if (group_leader(peers)) atomicAdd(cell(key), v[0]);
//
// Every lane of the warp must call warp_peers, group_sum and group_max
// (all use the full mask), so a loop around them runs the same trip count
// on all 32 lanes and a lane past the end of its data passes a key it then
// ignores.

#pragma once

#include <cuda_runtime.h>

#define FULL_MASK 0xFFFFFFFFu

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// the lanes of this warp whose key equals this lane's
__device__ __forceinline__ unsigned warp_peers(int key) {
  return __match_any_sync(FULL_MASK, key);
}

// true on the lowest lane of a group: the one that holds its total
__device__ __forceinline__ bool group_leader(unsigned peers) {
  return lane_id() == __ffs(peers) - 1;
}

// Sum each of v[0..NV) over the lane's group, by pointer jumping along the
// group's lanes in lane order: a round adds the value of the lane `nxt`
// points at into this lane's and doubles the jump. After
// ceil(log2(group size)) rounds (none for a warp whose keys are all
// distinct) the group's leader holds the group's total. The sums come out
// in a tree order, so they equal the sequential sum exactly while every
// partial sum is an integer below 2^24.
template <int NV>
__device__ __forceinline__ void group_sum(unsigned peers, float (&v)[NV]) {
  // the next lane of the group above this one (32: none); 2u << 31 == 0
  const unsigned later = peers & ~((2u << lane_id()) - 1u);
  int nxt = later ? __ffs(later) - 1 : 32;
  while (__any_sync(FULL_MASK, nxt < 32)) {
    const int src = nxt & 31;
    float got[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) got[j] = __shfl_sync(FULL_MASK, v[j], src);
    const int jump = __shfl_sync(FULL_MASK, nxt, src);
    if (nxt < 32) {
#pragma unroll
      for (int j = 0; j < NV; ++j) v[j] += got[j];
      nxt = jump;
    }
  }
}

// The maximum of v over the lane's group, by the pointer jumping of
// group_sum: the group's leader holds it, exact in any order. On the H100
// this beat __reduce_max_sync(peers, v), whose groups' disjoint masks the
// hardware takes one group at a time (PERF.md).
__device__ __forceinline__ int group_max(unsigned peers, int v) {
  const unsigned later = peers & ~((2u << lane_id()) - 1u);
  int nxt = later ? __ffs(later) - 1 : 32;
  while (__any_sync(FULL_MASK, nxt < 32)) {
    const int src = nxt & 31;
    const int got = __shfl_sync(FULL_MASK, v, src);
    const int jump = __shfl_sync(FULL_MASK, nxt, src);
    if (nxt < 32) {
      v = max(v, got);
      nxt = jump;
    }
  }
  return v;
}
