// Fused signal-plane fold: eight value rows into six m-wide tables and two
// small aux tables in one batch walk.
//
// Replaces the Pallas kernel netobserv_tpu/ops/pallas/signal_kernel.py
// `update` (`_fold_kernel` / `_signal_fold_body`), which builds one-hot
// matrices per index family and contracts them on the MXU. Each block runs
// `signal_fold_block` (signal_body.cuh, shared with kernel 7) on its slice
// of SIGNAL_ROWS_PER_BLOCK records. Bound on this card: 8B value reads and
// 5B index reads from HBM (under 1 MiB per fold), then per block a sweep
// of the 98 KiB shared copy twice; with B/SIGNAL_ROWS_PER_BLOCK blocks the
// sweeps, not the bytes, set the time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "signal_body.cuh"

__global__ void signal_fold_kernel(SignalTables tabs,
                                   const int64_t* __restrict__ idx,
                                   const float* __restrict__ vals, int n,
                                   int m, int n_dscp, int n_cause) {
  extern __shared__ float sm[];
  signal_fold_block(tabs, idx, vals, n, m, n_dscp, n_cause, blockIdx.x, sm);
}

extern "C" int signal_fold(float* ddos, float* syn, float* drops,
                           float* synack, float* conv_fwd, float* conv_rev,
                           float* dscp, float* cause, const int64_t* idx,
                           const float* vals, int n, int m, int n_dscp,
                           int n_cause, cudaStream_t stream) {
  if (n > 0) {
    SignalTables tabs = {{ddos, syn, drops, synack, conv_fwd, conv_rev, dscp,
                          cause}};
    size_t smem = signal_smem_bytes(m);
    cudaError_t err = cudaFuncSetAttribute(
        signal_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    signal_fold_kernel<<<signal_blocks(n), SIGNAL_THREADS, smem, stream>>>(
        tabs, idx, vals, n, m, n_dscp, n_cause);
  }
  return (int)cudaGetLastError();
}
