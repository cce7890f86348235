// Count-Min folds: the dual-plane fold (kernel 1, bytes and packets planes
// in one launch) and the single-plane fold (kernel 5), as one
// warp-aggregated body templated on the number of planes.
//
// Replaces the Pallas kernels netobserv_tpu/ops/pallas/countmin_kernel.py
// `update_two` (`_fold2_kernel`, kernel 1) and `update` (`_fold_kernel`,
// kernel 5). The TPU form builds a one-hot matrix per width tile and
// contracts it on the MXU, which costs d*B*W compares; here each thread
// owns one (depth row, record) pair, computes the column (h1 + r*h2) & (W-1)
// itself and adds the record's masked values into the planes in place
// with atomicAdd. Two C entries launch the one __global__: `cm_fold2`
// (NP = 2 planes) and `cm_fold` (NP = 1).
//
// Bound on this card: d*B pairs, each one 4-byte read-modify-write a plane
// into 1 MiB planes (4 x 65536 f32) that stay in the 50 MB L2, so L2
// atomic throughput bounds the kernel, not HBM. Same-address atomics
// serialize, and Zipf traffic puts a hot key's rows (about 2,900 of a
// batch's 16,384) on the same d cells. So the threads run row-major,
// t = r * B + b: a warp holds 32 consecutive records of one row (two rows
// where it straddles a row's end), its lanes with the same cell sum their
// values (warp_agg.cuh), and only the group's leader makes the atomics. A
// hot key then costs one atomic per warp and cell (B / 32 = 512 warps a
// row at B = 16,384) instead of one per record. Rows whose values are all
// zero (invalid or padding rows) take a sentinel key, still reach the
// warp's match, and add nothing; a group whose sum on one plane is zero
// adds nothing to that plane.
//
// Indices are 32-bit: the wrappers launch only where d * max(W, B) < 2^31
// (`countmin_kernel.fold_fits`), so the cell r * W + col, the pair count
// d * B and the thread index (unsigned, at most d * B + 255) cannot
// overflow.
//
// Variants measured against this design for kernel 5 on the H100
// (scripts/countmin_fold_variants.py, readings in PERF.md): one thread per
// record looping over the d rows was slower on the batch and on uniform
// keys; row-major threads with no warp aggregation, like the record-major
// kernel this body replaced (one atomic per (record, row)), were about
// 2.5x slower on the batch and faster only on uniform keys, where no
// cell is hot.
//
// Atomics and the warp's tree sums reorder float adds: the result is
// bit-exact against the plain version only while every per-cell sum stays
// an integer below 2^24.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_agg.cuh"

#define CM2_THREADS 256

template <int NP>
__global__ void cm_fold2_kernel(float* __restrict__ cm_a,
                                float* __restrict__ cm_b,
                                const int64_t* __restrict__ h1,
                                const int64_t* __restrict__ h2,
                                const float* __restrict__ va,
                                const float* __restrict__ vb,
                                int n, int depth, int width) {
  // every lane reaches warp_peers: a lane past the end keeps the sentinel
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  float v[NP];
  v[0] = 0.0f;
  if constexpr (NP == 2) v[1] = 0.0f;
  int key = -1;  // the cell r * W + col; -1: nothing to add
  if (t < (unsigned)n * (unsigned)depth) {
    const int r = (int)t / n;
    const int b = (int)t - r * n;
    v[0] = va[b];
    bool any = v[0] != 0.0f;
    if constexpr (NP == 2) {
      v[1] = vb[b];
      any = any || v[1] != 0.0f;
    }
    if (any) {
      const uint32_t col = ((uint32_t)h1[b] + (uint32_t)r * (uint32_t)h2[b])
                           & (uint32_t)(width - 1);
      key = r * width + (int)col;
    }
  }
  const unsigned peers = warp_peers(key);
  group_sum<NP>(peers, v);
  if (key >= 0 && group_leader(peers)) {
    if (v[0] != 0.0f) atomicAdd(cm_a + key, v[0]);
    if constexpr (NP == 2) {
      if (v[1] != 0.0f) atomicAdd(cm_b + key, v[1]);
    }
  }
}

// ceil(d * n / CM2_THREADS) blocks (the wrapper's `launch_shape`)
static int fold_blocks(int n, int depth) {
  return (int)(((long long)n * depth + CM2_THREADS - 1) / CM2_THREADS);
}

// Kernel 1: one launch folding both planes.
extern "C" int cm_fold2(float* cm_a, float* cm_b, const int64_t* h1,
                        const int64_t* h2, const float* va, const float* vb,
                        int n, int depth, int width, cudaStream_t stream) {
  if (n > 0) {
    cm_fold2_kernel<2><<<fold_blocks(n, depth), CM2_THREADS, 0, stream>>>(
        cm_a, cm_b, h1, h2, va, vb, n, depth, width);
  }
  return (int)cudaGetLastError();
}

// Kernel 5: one launch folding one plane.
extern "C" int cm_fold(float* cm, const int64_t* h1, const int64_t* h2,
                       const float* vals, int n, int depth, int width,
                       cudaStream_t stream) {
  if (n > 0) {
    cm_fold2_kernel<1><<<fold_blocks(n, depth), CM2_THREADS, 0, stream>>>(
        cm, nullptr, h1, h2, vals, nullptr, n, depth, width);
  }
  return (int)cudaGetLastError();
}
