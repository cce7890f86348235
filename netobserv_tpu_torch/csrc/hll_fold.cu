// HyperLogLog max folds: the global source HLL (kernel 3) and the per-dst /
// per-src register grids (kernel 8), one integer atomicMax per record.
//
// Kernel 3, `hll_fold`: regs[h1 & (m-1)] = max(., rank(h2)). Replaces the
// Pallas kernel netobserv_tpu/ops/pallas/hll_kernel.py `update`
// (`_fold_flat` / `_fold_kernel`), which compares every record with every
// register lane (B*m compares).
//
// Kernel 8, `hll_fold_grid`: the (bucket, register) grid as one flat array
// of D*m registers, cell = (dst_h & (D-1)) * m + (src_h1 & (m-1)), takes
// max(., rank(src_h2)). Replaces the Pallas kernel `update_per_dst` (the
// same `_fold_flat` over the D*m grid), whose one-hot form pays D*m lane
// compares per record (262,144 at 4096 x 64); here a record costs one
// atomic, whatever the grid's size.
//
// Both: one thread per record computes the rank with the hardware count of
// leading zeros, clz(h2 as int32) + 1 in [1, 33], and applies it with an
// integer atomicMax, so the result is exact whatever the order. Invalid
// rows have rank 0 and make no atomic.
//
// Bound on this card: B 4-byte atomics into a register file (64 KiB global,
// 1 MiB per grid) that stays in L2. A hot key sends its rows to one
// register; since registers only grow, a thread first reads the register
// and skips the atomic when the register already holds its rank, which
// takes the repeats of a hot key off the atomic unit.

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void max_into(int* reg, int64_t h2) {
  int rank = __clz((int)(uint32_t)h2) + 1;
  if (*((volatile int*)reg) >= rank) return;
  atomicMax(reg, rank);
}

__global__ void hll_fold_kernel(int* __restrict__ regs,
                                const int64_t* __restrict__ h1,
                                const int64_t* __restrict__ h2,
                                const unsigned char* __restrict__ valid,
                                int n, int m) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n || !valid[b]) return;
  max_into(regs + ((uint32_t)h1[b] & (uint32_t)(m - 1)), h2[b]);
}

__global__ void hll_fold_grid_kernel(int* __restrict__ regs,
                                     const int64_t* __restrict__ dst_h,
                                     const int64_t* __restrict__ src_h1,
                                     const int64_t* __restrict__ src_h2,
                                     const unsigned char* __restrict__ valid,
                                     int n, int dbuckets, int m) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n || !valid[b]) return;
  size_t cell = (size_t)((uint32_t)dst_h[b] & (uint32_t)(dbuckets - 1))
                * (size_t)m
                + ((uint32_t)src_h1[b] & (uint32_t)(m - 1));
  max_into(regs + cell, src_h2[b]);
}

extern "C" int hll_fold(int* regs, const int64_t* h1, const int64_t* h2,
                        const unsigned char* valid, int n, int m,
                        cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    hll_fold_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
        regs, h1, h2, valid, n, m);
  }
  return (int)cudaGetLastError();
}

extern "C" int hll_fold_grid(int* regs, const int64_t* dst_h,
                             const int64_t* src_h1, const int64_t* src_h2,
                             const unsigned char* valid, int n, int dbuckets,
                             int m, cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    hll_fold_grid_kernel<<<(n + threads - 1) / threads, threads, 0,
                           stream>>>(regs, dst_h, src_h1, src_h2, valid, n,
                                     dbuckets, m);
  }
  return (int)cudaGetLastError();
}
