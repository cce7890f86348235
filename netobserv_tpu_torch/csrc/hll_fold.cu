// Global source HyperLogLog fold: regs[h1 & (m-1)] = max(., rank(h2)).
//
// Replaces the Pallas kernel netobserv_tpu/ops/pallas/hll_kernel.py `update`
// (`_fold_flat` / `_fold_kernel`), which compares every record with every
// register lane (B*m compares). Here one thread per record computes the
// rank with the hardware count of leading zeros, clz(h2 as int32) + 1 in
// [1, 33], and applies it with an integer atomicMax, so the result is exact
// whatever the order. Invalid rows have rank 0 and make no atomic.
//
// Bound on this card: B 4-byte atomics into a 64 KiB register file that
// stays in L2. A hot key sends its rows to one register; since registers
// only grow, a thread first reads the register and skips the atomic when
// the register already holds its rank, which takes the repeats of a hot
// key off the atomic unit.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void hll_fold_kernel(int* __restrict__ regs,
                                const int64_t* __restrict__ h1,
                                const int64_t* __restrict__ h2,
                                const unsigned char* __restrict__ valid,
                                int n, int m) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n || !valid[b]) return;
  int rank = __clz((int)(uint32_t)h2[b]) + 1;
  int* reg = regs + ((uint32_t)h1[b] & (uint32_t)(m - 1));
  if (*((volatile int*)reg) >= rank) return;
  atomicMax(reg, rank);
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
