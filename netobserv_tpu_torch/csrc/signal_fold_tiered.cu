// Tiered signal megakernel (kernel 7): the signal fold of kernel 4 plus a
// max fold of the global source HLL straight into its 6-bit packed bank,
// in one launch. The bank is never unpacked into device memory.
//
// Replaces the Pallas kernel netobserv_tpu/ops/pallas/signal_kernel.py
// `update_tiered` (`_fold_tiered_kernel`), whose grid tiles the packed
// register triples and runs the signal fold on its first step.
//
// Design. One launch of two roles, TIERED_THREADS threads a block:
// - The first n3 / tile_r blocks each own tile_r packed triples (4 * tile_r
//   registers; TILE_R = 512 triples, 8 blocks at the default p = 14). A
//   block unpacks its triples into shared memory (tier_tiles.cuh) and walks
//   the batch in rounds of HLL_UNROLL records a thread: it tests tile
//   membership on h1 alone (register h1 & (m-1), 8 B a record), loads
//   valid and h2 only for its hits, applies rank clz(h2) + 1 with the
//   native shared-memory atomicMax on int where that raises the register,
//   and packs the triples back. A triple is 3 bytes and straddles 32- and
//   64-bit words, and no aligned atomic covers every 6-bit field: one block
//   owning whole triples is what makes the update safe. These blocks walk
//   the whole batch, so they come first and start first.
// - The other ceil(B / TIERED_THREADS) blocks run kernel 4's per-record
//   body (signal_agg.cuh): one thread per record, warp-aggregated atomics
//   into the L2-resident tables. No shared-memory copy of the tables, so
//   the table width m has no bound.
// The two roles run side by side on different SMs, about 4-5 us each at
// B = 16,384; the HLL blocks' walk is two rounds of about 4,000 cycles,
// bound by each block reading the whole of h1 from L2.
//
// Measured and dropped on the H100 (PERF.md has the times): the first
// design, a private copy of all eight tables in each of 16 blocks' shared
// memory folded with f32 shared-memory atomicAdd (a compare-and-swap loop
// on sm_90) beside HLL blocks that loaded all three columns; blocks of 256
// or 512 threads (fewer h1 loads in flight: the HLL blocks set the pace);
// two launches; more loads in flight a thread, or the next round's h1
// loaded early; signal blocks of fewer records; the walk's start staggered
// by block; and a cluster of 8 HLL CTAs that each walk an eighth of the
// batch and merge their maxima through distributed shared memory (its two
// cluster barriers and the merge cost what the shorter walk saves).
//
// Bound on this card: kernel 4's bytes, plus the batch's h1, h2 and valid
// read once (a record's h2 and valid are read by the one block its
// register falls in), plus the packed sectors the valid records reach
// (12 KiB bank at p = 14) read and written once. Every HLL block reads the
// whole of h1 (128 KiB at B = 16,384) from L2; that is not in the bound.
//
// The max fold is order-free: the packed bank is bit-exact against the
// plain version in every regime. The signal tables keep kernel 4's two
// regimes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "signal_agg.cuh"
#include "tier_tiles.cuh"

#define TIERED_THREADS 1024
#define TILE_R 512
#define HLL_UNROLL 8

// max-fold the batch into triples [t0, t0 + tile_r) of the packed bank;
// regs holds 4 * tile_r ints of shared memory
__device__ __forceinline__ void hll_tile_fold(
    uint8_t* __restrict__ packed, const int64_t* __restrict__ h1,
    const int64_t* __restrict__ h2, const unsigned char* __restrict__ valid,
    int n, int m_hll, int t0, int tile_r, int* regs) {
  const int nr = 4 * tile_r;
  for (int t = threadIdx.x; t < tile_r; t += TIERED_THREADS)
    tier_unpack_triple(packed + (size_t)3 * (t0 + t), regs + 4 * t);
  __syncthreads();
  const uint32_t mask = (uint32_t)(m_hll - 1);
  const int r0 = 4 * t0;
  for (int base = (int)threadIdx.x; base < n;
       base += TIERED_THREADS * HLL_UNROLL) {
    int reg[HLL_UNROLL];  // the record's register, less r0; -1 past the end
#pragma unroll
    for (int u = 0; u < HLL_UNROLL; ++u) {
      const int b = base + u * TIERED_THREADS;
      reg[u] = b < n ? (int)((uint32_t)h1[b] & mask) - r0 : -1;
    }
    int rank[HLL_UNROLL];  // 0: not in this tile, or an invalid row
#pragma unroll
    for (int u = 0; u < HLL_UNROLL; ++u) {
      const int b = base + u * TIERED_THREADS;
      const bool hit = (unsigned)reg[u] < (unsigned)nr;
      const unsigned char ok = hit ? valid[b] : 0;
      const uint32_t x = hit ? (uint32_t)h2[b] : 0u;
      rank[u] = ok ? __clz((int)x) + 1 : 0;
    }
#pragma unroll
    for (int u = 0; u < HLL_UNROLL; ++u)
      if (rank[u] > 0 && regs[reg[u]] < rank[u])
        atomicMax(regs + reg[u], rank[u]);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < tile_r; t += TIERED_THREADS)
    tier_pack_triple(regs + 4 * t, packed + (size_t)3 * (t0 + t));
}

__global__ void __launch_bounds__(TIERED_THREADS)
signal_fold_tiered_kernel(
    SignalTables tabs, const int64_t* __restrict__ idx,
    const float* __restrict__ vals, uint8_t* __restrict__ packed,
    const int64_t* __restrict__ h1, const int64_t* __restrict__ h2,
    const unsigned char* __restrict__ valid, int n, int m, int n_dscp,
    int n_cause, int n_hll_blocks, int m_hll, int tile_r) {
  extern __shared__ int regs[];
  if ((int)blockIdx.x < n_hll_blocks) {
    hll_tile_fold(packed, h1, h2, valid, n, m_hll, blockIdx.x * tile_r,
                  tile_r, regs);
    return;
  }
  // every lane of a warp runs the warp calls: none returns early
  signal_fold_record(
      tabs, idx, vals,
      ((int)blockIdx.x - n_hll_blocks) * TIERED_THREADS + (int)threadIdx.x,
      n, m, n_dscp, n_cause);
}

// One launch of n3 / tile_r HLL blocks and ceil(n / TIERED_THREADS) signal
// blocks, with 4 * tile_r ints of shared memory (the wrapper's
// `launch_shape_tiered`, which makes no call for an empty batch).
extern "C" int signal_fold_tiered(float* ddos, float* syn, float* drops,
                                  float* synack, float* conv_fwd,
                                  float* conv_rev, float* dscp, float* cause,
                                  const int64_t* idx, const float* vals,
                                  uint8_t* packed, const int64_t* h1,
                                  const int64_t* h2,
                                  const unsigned char* valid, int n, int m,
                                  int n_dscp, int n_cause, int n_packed,
                                  cudaStream_t stream) {
  const int n3 = n_packed / 3;
  if (n < 1 || m < 1 || n3 < 1) return (int)cudaErrorInvalidValue;
  SignalTables tabs = {{ddos, syn, drops, synack, conv_fwd, conv_rev, dscp,
                        cause}};
  const int tile_r = n3 < TILE_R ? n3 : TILE_R;
  const int n_hll = n3 / tile_r;
  const int n_sig = (n + TIERED_THREADS - 1) / TIERED_THREADS;
  signal_fold_tiered_kernel<<<n_hll + n_sig, TIERED_THREADS,
                              (size_t)4 * tile_r * sizeof(int), stream>>>(
      tabs, idx, vals, packed, h1, h2, valid, n, m, n_dscp, n_cause, n_hll,
      4 * n3, tile_r);
  return (int)cudaGetLastError();
}
