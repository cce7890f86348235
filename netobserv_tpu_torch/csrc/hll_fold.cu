// HyperLogLog max folds: the global source HLL (kernel 3) and the per-dst /
// per-src register grids (kernel 8), as one warp-aggregated body that folds
// up to HLL_MAX_FOLDS register files in one launch.
//
// A fold is {registers, bucket lane, register lane, rank lane, valid lane,
// D, m}: the record's cell (bucket & (D-1)) * m + (reg & (m-1)) takes
// max(., rank), rank = clz(rank lane as int32) + 1 in [1, 33] on a valid
// row and 0 otherwise. Kernel 8 is a fold over the D x m grid; kernel 3 is
// the fold with D = 1, where the mask is 0 and any lane serves as the
// bucket lane. Replaces the Pallas kernel
// netobserv_tpu/ops/pallas/hll_kernel.py `_fold_flat` (`_fold_kernel`),
// the one body of its `update` (kernel 3) and `update_per_dst` (kernel 8),
// which compares every record with every register lane (B*m compares; D*m
// for a grid, 262,144 a record at 4096 x 64).
//
// Three C entries launch the one __global__: `hll_fold` (kernel 3, one
// fold), `hll_fold_grid` (kernel 8, one fold) and `hll_fold_folds` (1-3
// folds of one batch: the ingest folds its global HLL and both grids in
// one launch). blockIdx.y picks a block's fold; unused fold slots repeat a
// used one and no block reads them.
//
// Bound on this card: B 8-byte loads of each lane a fold and 4-byte max
// atomics into register files (64 KiB global, 1 MiB a grid) that stay in
// L2; at B = 16,384 the bytes take 0.1-0.2 us a fold, so launch and
// latency set the time. A thread issues its four loads together, with no
// branch on `valid` before them, and an invalid row or one past n carries
// rank 0. The lanes of a warp that hit one cell then take their group's
// maximum (warp_agg.cuh `group_max`) and the group's first lane makes one
// atomicMax whose result is unused (a reduction with no return), none
// where the maximum is 0: a hot key costs one atomic a warp. The integer
// maximum is exact in any order.
//
// Variants measured against this design on the H100
// (scripts/hll_fold_variants.py, readings in PERF.md): the group maximum
// by __reduce_max_sync was slower (the card takes the groups' disjoint
// masks one at a time), and so was one atomic a valid row on the batch's
// hot key; a leader that reads its register first and skips the atomic
// was no faster, and blocks of 128 threads were level. One atomic a valid
// row behind that read-first skip was faster on warm registers and slower
// on uniform keys.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_agg.cuh"

#define HLL_THREADS 256
#define HLL_MAX_FOLDS 3

struct HllFold {
  int* regs;
  const int64_t* bucket;
  const int64_t* reg;
  const int64_t* rank;
  const unsigned char* valid;
  uint32_t dmask;  // D - 1
  uint32_t m;      // registers per bucket, a power of two
};

struct HllFolds {
  HllFold f[HLL_MAX_FOLDS];
};

__global__ void __launch_bounds__(HLL_THREADS)
    hll_fold_kernel(const HllFolds folds, int n) {
  // constant indices keep the folds in the parameter bank
  const HllFold f = blockIdx.y == 0   ? folds.f[0]
                    : blockIdx.y == 1 ? folds.f[1]
                                      : folds.f[2];
  const int b = blockIdx.x * HLL_THREADS + threadIdx.x;
  uint32_t cell = 0;
  int rank = 0;
  if (b < n) {
    const unsigned char v = f.valid[b];
    const uint32_t bucket = (uint32_t)f.bucket[b];
    const uint32_t reg = (uint32_t)f.reg[b];
    const uint32_t h2 = (uint32_t)f.rank[b];
    cell = (bucket & f.dmask) * f.m + (reg & (f.m - 1));
    rank = v ? __clz((int)h2) + 1 : 0;
  }
  // every lane of the warp reaches the match, rows past n included
  const unsigned peers = warp_peers((int)cell);
  const int top = group_max(peers, rank);
  if (group_leader(peers) && top > 0) atomicMax(f.regs + cell, top);
}

static int launch(HllFolds& folds, int nfolds, int n, cudaStream_t stream) {
  if (nfolds < 1 || nfolds > HLL_MAX_FOLDS) return (int)cudaErrorInvalidValue;
  for (int i = nfolds; i < HLL_MAX_FOLDS; ++i) folds.f[i] = folds.f[0];
  if (n > 0) {
    const dim3 grid((n + HLL_THREADS - 1) / HLL_THREADS, nfolds);
    hll_fold_kernel<<<grid, HLL_THREADS, 0, stream>>>(folds, n);
  }
  return (int)cudaGetLastError();
}

static HllFold fold(int* regs, const int64_t* bucket, const int64_t* reg,
                    const int64_t* rank, const unsigned char* valid,
                    int dbuckets, int m) {
  return HllFold{regs, bucket, reg, rank, valid, (uint32_t)(dbuckets - 1),
                 (uint32_t)m};
}

extern "C" int hll_fold(int* regs, const int64_t* h1, const int64_t* h2,
                        const unsigned char* valid, int n, int m,
                        cudaStream_t stream) {
  HllFolds folds;
  folds.f[0] = fold(regs, h1, h1, h2, valid, 1, m);
  return launch(folds, 1, n, stream);
}

extern "C" int hll_fold_grid(int* regs, const int64_t* dst_h,
                             const int64_t* src_h1, const int64_t* src_h2,
                             const unsigned char* valid, int n, int dbuckets,
                             int m, cudaStream_t stream) {
  HllFolds folds;
  folds.f[0] = fold(regs, dst_h, src_h1, src_h2, valid, dbuckets, m);
  return launch(folds, 1, n, stream);
}

extern "C" int hll_fold_folds(
    int* regs0, const int64_t* bucket0, const int64_t* reg0,
    const int64_t* rank0, const unsigned char* valid0, int* regs1,
    const int64_t* bucket1, const int64_t* reg1, const int64_t* rank1,
    const unsigned char* valid1, int* regs2, const int64_t* bucket2,
    const int64_t* reg2, const int64_t* rank2, const unsigned char* valid2,
    int nfolds, int n, int d0, int m0, int d1, int m1, int d2, int m2,
    cudaStream_t stream) {
  HllFolds folds;
  folds.f[0] = fold(regs0, bucket0, reg0, rank0, valid0, d0, m0);
  folds.f[1] = fold(regs1, bucket1, reg1, rank1, valid1, d1, m1);
  folds.f[2] = fold(regs2, bucket2, reg2, rank2, valid2, d2, m2);
  return launch(folds, nfolds, n, stream);
}
