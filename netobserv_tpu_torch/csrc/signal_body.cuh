// The fused signal-plane fold of one thread block, kernel 7's
// (signal_fold_tiered.cu); the counterpart of `_signal_fold_body` in
// netobserv_tpu/ops/pallas/signal_kernel.py. It is the first design of
// kernel 4, which now folds on thread-block clusters (signal_fold.cu).
//
// Eight value rows add into six m-wide tables and two small aux tables:
//   rows 0-2 (ddos, syn, drops)   <- idx 0 (dst bucket)
//   row  3   (synack)             <- idx 1 (src bucket)
//   rows 4-5 (conv_fwd, conv_rev) <- idx 2 (pair bucket)
//   row  6   (dscp bytes)         <- idx 3 (dscp code)
//   row  7   (drop causes)        <- idx 4 (cause)
// An index outside its table is dropped, as the scatter's mode="drop" does.
//
// All tables together are (6m + 2*256) f32, 98 KiB at m = 4096, so each
// block keeps a private copy in dynamic shared memory: it zeroes it, folds
// its slice of SIGNAL_ROWS_PER_BLOCK records with shared-memory atomics (a
// hot key contends only inside its block), then adds each non-zero cell
// into the global table with one atomicAdd.
//
// Atomics reorder float adds: bit-exact against the plain version only
// while every per-cell sum stays an integer below 2^24.

#pragma once

#include <stdint.h>

#define SIGNAL_N_MAIN 6
#define SIGNAL_AUX_W 256
#define SIGNAL_ROWS_PER_BLOCK 1024
#define SIGNAL_THREADS 512

struct SignalTables {
  float* t[8];
};

// shared memory one signal block needs
static inline size_t signal_smem_bytes(int m) {
  return (size_t)(SIGNAL_N_MAIN * m + 2 * SIGNAL_AUX_W) * sizeof(float);
}

// number of signal blocks for n records
static inline int signal_blocks(int n) {
  return (n + SIGNAL_ROWS_PER_BLOCK - 1) / SIGNAL_ROWS_PER_BLOCK;
}

// fold records [blk * ROWS, (blk + 1) * ROWS) into the tables; sm holds
// signal_smem_bytes(m)
__device__ __forceinline__ void signal_fold_block(
    const SignalTables& tabs, const int64_t* __restrict__ idx,
    const float* __restrict__ vals, int n, int m, int n_dscp, int n_cause,
    int blk, float* sm) {
  const int n_cells = SIGNAL_N_MAIN * m + 2 * SIGNAL_AUX_W;
  for (int c = threadIdx.x; c < n_cells; c += blockDim.x) sm[c] = 0.0f;
  __syncthreads();

  const int fam[SIGNAL_N_MAIN] = {0, 0, 0, 1, 2, 2};
  int lo = blk * SIGNAL_ROWS_PER_BLOCK;
  int hi = min(n, lo + SIGNAL_ROWS_PER_BLOCK);
  for (int b = lo + threadIdx.x; b < hi; b += blockDim.x) {
#pragma unroll
    for (int j = 0; j < SIGNAL_N_MAIN; ++j) {
      float v = vals[(size_t)j * n + b];
      int64_t i = idx[(size_t)fam[j] * n + b];
      if (v != 0.0f && i >= 0 && i < m) atomicAdd(sm + j * m + i, v);
    }
    float vd = vals[(size_t)6 * n + b];
    int64_t id = idx[(size_t)3 * n + b];
    if (vd != 0.0f && id >= 0 && id < n_dscp)
      atomicAdd(sm + SIGNAL_N_MAIN * m + id, vd);
    float vc = vals[(size_t)7 * n + b];
    int64_t ic = idx[(size_t)4 * n + b];
    if (vc != 0.0f && ic >= 0 && ic < n_cause)
      atomicAdd(sm + SIGNAL_N_MAIN * m + SIGNAL_AUX_W + ic, vc);
  }
  __syncthreads();

  for (int c = threadIdx.x; c < SIGNAL_N_MAIN * m; c += blockDim.x) {
    float v = sm[c];
    if (v != 0.0f) atomicAdd(tabs.t[c / m] + (c % m), v);
  }
  for (int c = threadIdx.x; c < n_dscp; c += blockDim.x) {
    float v = sm[SIGNAL_N_MAIN * m + c];
    if (v != 0.0f) atomicAdd(tabs.t[6] + c, v);
  }
  for (int c = threadIdx.x; c < n_cause; c += blockDim.x) {
    float v = sm[SIGNAL_N_MAIN * m + SIGNAL_AUX_W + c];
    if (v != 0.0f) atomicAdd(tabs.t[7] + c, v);
  }
}
