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
// batch spreads over the card (128 blocks at B = 16,384). A warp first
// combines the lanes with the same index, once per index family
// (warp_agg.cuh); the group's leader then adds each non-zero sum straight
// into the global table with one atomicAdd whose result is unused (a
// reduction the L2 performs). All eight tables together are 98 KiB at
// m = 4096 and stay in L2, and a hot bucket costs one atomic per warp and
// table instead of one per record. No shared memory, so any m fits.
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

#include "warp_agg.cuh"

#define SIGNAL_THREADS 128

struct SignalTables {
  float* t[8];
};

// one index family: warp-combine its NR value rows by index `key` (-1:
// dropped), then the leader adds each non-zero sum into tab[r][key]
template <int NR>
__device__ __forceinline__ void fold_family(float* const* tab, int key,
                                            float (&v)[NR]) {
  const unsigned peers = warp_peers(key);
  group_sum<NR>(peers, v);
  if (key < 0 || !group_leader(peers)) return;
#pragma unroll
  for (int r = 0; r < NR; ++r)
    if (v[r] != 0.0f) atomicAdd(tab[r] + key, v[r]);
}

__global__ void __launch_bounds__(SIGNAL_THREADS)
signal_fold_kernel(SignalTables tabs, const int64_t* __restrict__ idx,
                   const float* __restrict__ vals, int n, int m, int n_dscp,
                   int n_cause) {
  // every lane of a warp runs the warp calls: none returns early
  const int b = blockIdx.x * SIGNAL_THREADS + (int)threadIdx.x;
  const bool live = b < n;
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = live ? vals[(size_t)j * n + b] : 0.0f;
  int key[5];
#pragma unroll
  for (int f = 0; f < 5; ++f) {
    const int size = f < 3 ? m : (f == 3 ? n_dscp : n_cause);
    const int64_t i = live ? idx[(size_t)f * n + b] : -1;
    key[f] = (i >= 0 && i < size) ? (int)i : -1;
  }
  float dst[3] = {v[0], v[1], v[2]};
  fold_family<3>(tabs.t, key[0], dst);
  float src[1] = {v[3]};
  fold_family<1>(tabs.t + 3, key[1], src);
  float pair[2] = {v[4], v[5]};
  fold_family<2>(tabs.t + 4, key[2], pair);
  float dscp[1] = {v[6]};
  fold_family<1>(tabs.t + 6, key[3], dscp);
  float cause[1] = {v[7]};
  fold_family<1>(tabs.t + 7, key[4], cause);
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
