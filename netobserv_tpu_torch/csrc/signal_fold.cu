// Fused signal-plane fold (kernel 4): eight value rows into six m-wide
// tables and two small aux tables in one batch walk.
//
// Replaces the Pallas kernel netobserv_tpu/ops/pallas/signal_kernel.py
// `update` (`_fold_kernel` / `_signal_fold_body`), which builds one-hot
// matrices per index family and contracts them on the MXU:
//   rows 0-2 (ddos, syn, drops)   <- idx 0 (dst bucket)
//   row  3   (synack)             <- idx 1 (src bucket)
//   rows 4-5 (conv_fwd, conv_rev) <- idx 2 (pair bucket)
//   row  6   (dscp bytes)         <- idx 3 (dscp code)
//   row  7   (drop causes)        <- idx 4 (cause)
// An index outside its table is dropped, as the scatter's mode="drop" does.
//
// Design. One thread per record, SIGNAL_THREADS records per block, so the
// batch spreads over the card (128 blocks at B = 16,384). Each thread runs
// the per-record body of signal_agg.cuh (shared with kernel 7): the lanes
// of a warp with the same index combine their values once per index family,
// and the group's leader adds each non-zero sum straight into the global
// table with one atomic (a reduction the L2 performs). All eight tables
// together are 98 KiB at m = 4096 and stay in L2, and a hot bucket costs
// one atomic per warp and table instead of one per record. No shared
// memory, so any m fits.
//
// Two designs measured slower on the H100: a private copy of all eight
// tables in each block's shared memory, zeroed, folded and flushed (the
// sweeps of 98 KiB per block set its time), and the tables sharded over a
// thread-block cluster with the adds routed through distributed shared
// memory (the remote atomics set its time). PERF.md has the three times.
//
// Atomics and the warp sums reorder float adds: bit-exact against the plain
// version only while every per-cell sum stays an integer below 2^24.
//
// Bound on this card: 8B value reads and 5B index reads from HBM (under
// 1 MiB per fold at B = 16,384), 0.4 us at 3.35 TB/s; the launch and the
// atomics' round trips to L2 set the time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "signal_agg.cuh"

#define SIGNAL_THREADS 128

__global__ void __launch_bounds__(SIGNAL_THREADS)
signal_fold_kernel(SignalTables tabs, const int64_t* __restrict__ idx,
                   const float* __restrict__ vals, int n, int m, int n_dscp,
                   int n_cause) {
  // every lane of a warp runs the warp calls: none returns early
  signal_fold_record(tabs, idx, vals,
                     blockIdx.x * SIGNAL_THREADS + (int)threadIdx.x, n, m,
                     n_dscp, n_cause);
}

// One launch of ceil(n / SIGNAL_THREADS) blocks (the wrapper's
// `launch_shape`, which makes no call for an empty batch).
extern "C" int signal_fold(float* ddos, float* syn, float* drops,
                           float* synack, float* conv_fwd, float* conv_rev,
                           float* dscp, float* cause, const int64_t* idx,
                           const float* vals, int n, int m, int n_dscp,
                           int n_cause, cudaStream_t stream) {
  if (n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  SignalTables tabs = {{ddos, syn, drops, synack, conv_fwd, conv_rev, dscp,
                        cause}};
  signal_fold_kernel<<<(n + SIGNAL_THREADS - 1) / SIGNAL_THREADS,
                       SIGNAL_THREADS, 0, stream>>>(tabs, idx, vals, n, m,
                                                    n_dscp, n_cause);
  return (int)cudaGetLastError();
}
