// The per-record body of the signal-plane fold, shared by kernel 4
// (signal_fold.cu) and kernel 7 (signal_fold_tiered.cu), so the two folds
// cannot drift; the counterpart of `_signal_fold_body` in
// netobserv_tpu/ops/pallas/signal_kernel.py.
//
// Eight value rows add into six m-wide tables and two small aux tables:
//   rows 0-2 (ddos, syn, drops)   <- idx 0 (dst bucket)
//   row  3   (synack)             <- idx 1 (src bucket)
//   rows 4-5 (conv_fwd, conv_rev) <- idx 2 (pair bucket)
//   row  6   (dscp bytes)         <- idx 3 (dscp code)
//   row  7   (drop causes)        <- idx 4 (cause)
// An index outside its table is dropped, as the scatter's mode="drop" does.
//
// One thread per record. A warp first combines the lanes with the same
// index, once per index family (warp_agg.cuh); the group's leader then adds
// each non-zero sum straight into the global table with one atomicAdd
// whose result is unused (a reduction the L2 performs). The tables stay in
// L2, and a hot bucket costs one atomic per warp and table instead of one
// per record. No shared memory, so any m fits, and nothing depends on the
// block size.
//
// Atomics and the warp sums reorder float adds: bit-exact against the plain
// version only while every per-cell sum stays an integer below 2^24.

#pragma once

#include <stdint.h>

#include "warp_agg.cuh"

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

// Fold record b of n into the eight tables. Every lane of the warp must
// call it (the warp calls use the full mask): a lane with b >= n passes
// zero values and key -1 to every family.
__device__ __forceinline__ void signal_fold_record(
    const SignalTables& tabs, const int64_t* __restrict__ idx,
    const float* __restrict__ vals, int b, int n, int m, int n_dscp,
    int n_cause) {
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
