// Fused signal-plane fold: eight value rows into six m-wide tables and two
// small aux tables in one batch walk.
//
// Replaces the Pallas kernel netobserv_tpu/ops/pallas/signal_kernel.py
// `update` (`_fold_kernel` / `_signal_fold_body`), which builds one-hot
// matrices per index family and contracts them on the MXU. Value row j adds
// into table j at the index of its family:
//   rows 0-2 (ddos, syn, drops)   <- idx 0 (dst bucket)
//   row  3   (synack)             <- idx 1 (src bucket)
//   rows 4-5 (conv_fwd, conv_rev) <- idx 2 (pair bucket)
//   row  6   (dscp bytes)         <- idx 3 (dscp code)
//   row  7   (drop causes)        <- idx 4 (cause)
// An index outside its table is dropped, as the scatter's mode="drop" does.
//
// All tables together are (6m + 2*256) f32, 98 KiB at m = 4096, so each
// block keeps a private copy in dynamic shared memory: it zeroes it, folds
// its slice of the batch with shared-memory atomics (a hot key contends
// only inside its block), then adds each non-zero cell into the global
// table with one atomicAdd. Bound on this card: 8B value reads and 5B index
// reads from HBM (under 1 MiB per fold), then per block a sweep of the
// 98 KiB shared copy twice; with B/ROWS_PER_BLOCK blocks the sweeps, not
// the bytes, set the time.
//
// Atomics reorder float adds: bit-exact against the plain version only
// while every per-cell sum stays an integer below 2^24.

#include <cuda_runtime.h>
#include <stdint.h>

#define N_MAIN 6
#define AUX_W 256
#define ROWS_PER_BLOCK 1024
#define THREADS 512

struct Tables {
  float* t[8];
};

__global__ void signal_fold_kernel(Tables tabs, const int64_t* __restrict__ idx,
                                   const float* __restrict__ vals, int n,
                                   int m, int n_dscp, int n_cause) {
  extern __shared__ float sm[];
  const int n_cells = N_MAIN * m + 2 * AUX_W;
  for (int c = threadIdx.x; c < n_cells; c += blockDim.x) sm[c] = 0.0f;
  __syncthreads();

  const int fam[N_MAIN] = {0, 0, 0, 1, 2, 2};
  int lo = blockIdx.x * ROWS_PER_BLOCK;
  int hi = min(n, lo + ROWS_PER_BLOCK);
  for (int b = lo + threadIdx.x; b < hi; b += blockDim.x) {
#pragma unroll
    for (int j = 0; j < N_MAIN; ++j) {
      float v = vals[(size_t)j * n + b];
      int64_t i = idx[(size_t)fam[j] * n + b];
      if (v != 0.0f && i >= 0 && i < m) atomicAdd(sm + j * m + i, v);
    }
    float vd = vals[(size_t)6 * n + b];
    int64_t id = idx[(size_t)3 * n + b];
    if (vd != 0.0f && id >= 0 && id < n_dscp)
      atomicAdd(sm + N_MAIN * m + id, vd);
    float vc = vals[(size_t)7 * n + b];
    int64_t ic = idx[(size_t)4 * n + b];
    if (vc != 0.0f && ic >= 0 && ic < n_cause)
      atomicAdd(sm + N_MAIN * m + AUX_W + ic, vc);
  }
  __syncthreads();

  for (int c = threadIdx.x; c < N_MAIN * m; c += blockDim.x) {
    float v = sm[c];
    if (v != 0.0f) atomicAdd(tabs.t[c / m] + (c % m), v);
  }
  for (int c = threadIdx.x; c < n_dscp; c += blockDim.x) {
    float v = sm[N_MAIN * m + c];
    if (v != 0.0f) atomicAdd(tabs.t[6] + c, v);
  }
  for (int c = threadIdx.x; c < n_cause; c += blockDim.x) {
    float v = sm[N_MAIN * m + AUX_W + c];
    if (v != 0.0f) atomicAdd(tabs.t[7] + c, v);
  }
}

extern "C" int signal_fold(float* ddos, float* syn, float* drops,
                           float* synack, float* conv_fwd, float* conv_rev,
                           float* dscp, float* cause, const int64_t* idx,
                           const float* vals, int n, int m, int n_dscp,
                           int n_cause, cudaStream_t stream) {
  if (n > 0) {
    Tables tabs = {{ddos, syn, drops, synack, conv_fwd, conv_rev, dscp,
                    cause}};
    size_t smem = (size_t)(N_MAIN * m + 2 * AUX_W) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        signal_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    int blocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    signal_fold_kernel<<<blocks, THREADS, smem, stream>>>(
        tabs, idx, vals, n, m, n_dscp, n_cause);
  }
  return (int)cudaGetLastError();
}
