// Tiered signal megakernel: the fused signal fold plus a max fold
// of the global source HLL straight into its 6-bit packed bank, in one
// launch. The bank is never unpacked into device memory.
//
// Replaces the Pallas kernel netobserv_tpu/ops/pallas/signal_kernel.py
// `update_tiered` (`_fold_tiered_kernel`), whose grid tiles the packed
// register triples and runs the signal fold on its first step. Here the
// first signal_blocks(B) blocks run `signal_fold_block` (signal_body.cuh,
// kernel 4's first design), and each of the remaining n3 / TILE_R blocks
// owns TILE_R packed triples (4 * TILE_R registers, 8 at the default
// p = 14): it unpacks them into shared memory (tier_tiles.cuh), walks all
// B records, computes register h1 & (m-1) and rank clz(h2) + 1 itself
// (rank 0 for an invalid row, a no-op under max), applies the ones that
// fall in its tile with a shared-memory atomicMax, and packs the triples
// back. A triple is 3 bytes and straddles 32-bit words, and there is no
// atomic on a 6-bit field: tile ownership is what makes the update safe.
//
// Bound on this card: kernel 4's bytes plus the packed bank (12 KiB) read
// and written once and the batch's h1, h2 and valid. Every HLL block
// walks the whole batch from L2; that is not in the byte bound.
//
// The max fold is order-free: the packed bank is bit-exact against the
// plain version in every regime. The signal tables keep kernel 4's two
// regimes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "signal_body.cuh"
#include "tier_tiles.cuh"

#define TILE_R 512

__global__ void signal_fold_tiered_kernel(
    SignalTables tabs, const int64_t* __restrict__ idx,
    const float* __restrict__ vals, uint8_t* __restrict__ packed,
    const int64_t* __restrict__ h1, const int64_t* __restrict__ h2,
    const unsigned char* __restrict__ valid, int n, int m, int n_dscp,
    int n_cause, int n_sig_blocks, int m_hll, int tile_r) {
  extern __shared__ float sm[];
  if ((int)blockIdx.x < n_sig_blocks) {
    signal_fold_block(tabs, idx, vals, n, m, n_dscp, n_cause, blockIdx.x,
                      sm);
    return;
  }
  int* regs = (int*)sm;                                // [4 * tile_r]
  const int t0 = ((int)blockIdx.x - n_sig_blocks) * tile_r;  // first triple
  const int r0 = 4 * t0;                               // first register
  for (int t = threadIdx.x; t < tile_r; t += blockDim.x)
    tier_unpack_triple(packed + (size_t)3 * (t0 + t), regs + 4 * t);
  __syncthreads();
  for (int b = threadIdx.x; b < n; b += blockDim.x) {
    if (!valid[b]) continue;
    const int reg = (int)((uint32_t)h1[b] & (uint32_t)(m_hll - 1)) - r0;
    if (reg < 0 || reg >= 4 * tile_r) continue;
    const int rank = __clz((int)(uint32_t)h2[b]) + 1;
    if (regs[reg] < rank) atomicMax(regs + reg, rank);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < tile_r; t += blockDim.x)
    tier_pack_triple(regs + 4 * t, packed + (size_t)3 * (t0 + t));
}

extern "C" int signal_fold_tiered(float* ddos, float* syn, float* drops,
                                  float* synack, float* conv_fwd,
                                  float* conv_rev, float* dscp, float* cause,
                                  const int64_t* idx, const float* vals,
                                  uint8_t* packed, const int64_t* h1,
                                  const int64_t* h2,
                                  const unsigned char* valid, int n, int m,
                                  int n_dscp, int n_cause, int n_packed,
                                  cudaStream_t stream) {
  if (n > 0) {
    SignalTables tabs = {{ddos, syn, drops, synack, conv_fwd, conv_rev, dscp,
                          cause}};
    const int n3 = n_packed / 3;
    const int tile_r = n3 < TILE_R ? n3 : TILE_R;
    const int n_sig = signal_blocks(n);
    size_t smem = signal_smem_bytes(m);
    const size_t hll_smem = (size_t)4 * tile_r * sizeof(int);
    if (hll_smem > smem) smem = hll_smem;
    cudaError_t err = cudaFuncSetAttribute(
        signal_fold_tiered_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    signal_fold_tiered_kernel<<<n_sig + n3 / tile_r, SIGNAL_THREADS, smem,
                                stream>>>(
        tabs, idx, vals, packed, h1, h2, valid, n, m, n_dscp, n_cause, n_sig,
        4 * n3, tile_r);
  }
  return (int)cudaGetLastError();
}
