// The three per-slot reductions of the persistent-slot top-K table, in one
// launch of one thread-block cluster.
//
// Replaces the Pallas kernel netobserv_tpu/ops/pallas/topk_kernel.py
// `reduce` (`_reduce_kernel`), which walks the batch in chunks against all K
// slot lanes (B*K compares). For each slot k:
//   match_max[k] = max est among rows with mslot == k (-1 if none);
//   chall_max[k] = max est among rows with target == k (-1 if none);
//   win_row[k]   = the LOWEST row at chall_max with est > -1, or
//                  NO_WINNER (0x7FFFFFFF) if there is none.
//
// f32 values are mapped to an unsigned key whose integer order is the float
// order (flip all bits of a negative, set the sign bit of a positive; -0 is
// taken as +0, which compares equal to it), so a max is an integer atomicMax
// and exact in any order. The winner rides one 64-bit max on
// (ordered est << 32) | ~row: the largest key has the largest est and,
// among equal est, the smallest row. Rows with est <= -1 never challenge,
// which leaves -1 / NO_WINNER for a slot with no live challenger.
//
// Design. One launch of one cluster of TOPK_CLUSTER CTAs. Each CTA folds a
// strided share of the rows into its own private copy of the slot tables
// in shared memory (12 B a slot: the ordered match max and the winner key)
// with shared-memory atomics; a hot slot's atomics stay inside each SM.
// After cluster.sync() the CTAs split the slots: each takes a
// contiguous 1/C of them, reads that range of all C private copies through
// distributed shared memory, one peer per lane, combines them by shuffles
// and writes the three outputs. A last cluster.sync() keeps every copy
// alive until its peers have read it. Slots go in tiles of at most
// TOPK_TILE (a CTA's shared memory), each tile one walk over the rows, so
// any K takes the kernel. No global atomics, no scratch in device memory
// and nothing carried between launches; maxima are exact in any order, so
// the result is deterministic.
//
// Three designs measured slower on the H100, in turns on one card
// (PERF.md): the first one (init, fold and finalize kernels with global
// atomics); slots sharded over the cluster's CTAs with the atomics routed
// through distributed shared memory; and this one with warp aggregation of
// equal slots before the shared-memory atomics. The sharded design takes
// 32-bit atomics only: a 64-bit atomicMax into a peer CTA's shared memory
// lost updates in a test on the H100, where the same atomic into the CTA's own
// shared memory, or a CAS loop into the peer's, was exact (PERF.md).
//
// Bound on this card: 20 B of row reads per row and 12 B of outputs per
// slot (0.33 MiB at B = 16,384, K = 1,024), 0.1 us at 3.35 TB/s; the
// single launch and the cluster barriers set the time.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_launch.cuh"

namespace cg = cooperative_groups;

#define NO_WINNER 0x7FFFFFFF
#define TOPK_CLUSTER 8
#define TOPK_THREADS 1024
// slots of one tile: a private copy of their tables fills a CTA's 227 KiB
#define TOPK_TILE (232448 / 12)

__device__ __forceinline__ uint32_t ord_of(float f) {
  uint32_t u = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float f32_of(uint32_t o) {
  uint32_t u = (o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o;
  return __uint_as_float(u);
}

// slots of the first (largest) tile
static inline int tile_slots(int k) { return k < TOPK_TILE ? k : TOPK_TILE; }

__global__ void __launch_bounds__(TOPK_THREADS)
topk_reduce_kernel(float* __restrict__ match_max,
                   float* __restrict__ chall_max, int* __restrict__ win_row,
                   const int64_t* __restrict__ mslot,
                   const int64_t* __restrict__ target,
                   const float* __restrict__ est, int n, int k, int tile) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  extern __shared__ unsigned long long best[];     // [tile] winner keys
  uint32_t* match_ord = (uint32_t*)(best + tile);  // [tile] ordered maxima
  // merge: thread (slot, peer) reads peer `peer`'s copy of one slot; the
  // TOPK_CLUSTER threads of a slot are adjacent lanes of one warp
  const int peer = (int)threadIdx.x % TOPK_CLUSTER;
  const int slots_per_pass = TOPK_THREADS / TOPK_CLUSTER;

  for (int t0 = 0; t0 < k; t0 += tile) {
    const int tn = min(tile, k - t0);
    for (int l = threadIdx.x; l < tn; l += TOPK_THREADS) {
      best[l] = 0ull;
      match_ord[l] = ord_of(-1.0f);
    }
    __syncthreads();

    for (int base = rank * TOPK_THREADS; base < n;
         base += TOPK_CLUSTER * TOPK_THREADS) {
      const int b = base + (int)threadIdx.x;
      const bool live = b < n;
      const float e = live ? est[b] : -1.0f;
      const int64_t ms = (live ? mslot[b] : -1) - t0;
      const int64_t tg = (live ? target[b] : -1) - t0;

      if (ms >= 0 && ms < tn) atomicMax(match_ord + ms, ord_of(e));
      if (tg >= 0 && tg < tn && e > -1.0f)
        atomicMax(best + tg, ((unsigned long long)ord_of(e) << 32)
                                 | (unsigned long long)(~(uint32_t)b));
    }
    cluster.sync();  // every CTA's copy of the tile is final

    // this CTA's contiguous share of the tile's slots
    const int share = (tn + TOPK_CLUSTER - 1) / TOPK_CLUSTER;
    const int lo = min(tn, rank * share);
    const int hi = min(tn, lo + share);
    for (int s0 = lo; s0 < hi; s0 += slots_per_pass) {
      const int j = s0 + (int)threadIdx.x / TOPK_CLUSTER;
      uint32_t mo = ord_of(-1.0f);
      unsigned long long bk = 0ull;
      if (j < hi) {
        mo = *cluster.map_shared_rank(match_ord + j, peer);
        bk = *cluster.map_shared_rank(best + j, peer);
      }
#pragma unroll
      for (int d = TOPK_CLUSTER / 2; d > 0; d /= 2) {
        mo = max(mo, __shfl_xor_sync(0xFFFFFFFFu, mo, d));
        const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, bk, d);
        bk = o > bk ? o : bk;
      }
      if (j < hi && peer == 0) {
        const int s = t0 + j;
        match_max[s] = f32_of(mo);
        chall_max[s] = bk ? f32_of((uint32_t)(bk >> 32)) : -1.0f;
        win_row[s] = bk ? (int)(~(uint32_t)bk) : NO_WINNER;
      }
    }
    cluster.sync();  // no copy is reset, or goes away, while a peer reads it
  }
}

// One launch of one cluster (the wrapper's `launch_shape`).
extern "C" int topk_reduce(float* match_max, float* chall_max, int* win_row,
                           const int64_t* mslot, const int64_t* target,
                           const float* est, int n, int k,
                           cudaStream_t stream) {
  if (n < 0 || k < 0) return (int)cudaErrorInvalidValue;
  const int tile = tile_slots(k);
  cudaError_t err = launch_clusters(topk_reduce_kernel, 1, TOPK_CLUSTER,
                                    TOPK_THREADS, (size_t)tile * 12, stream,
                                    match_max, chall_max, win_row, mslot,
                                    target, est, n, k, tile);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
