// Dual-plane Count-Min fold (bytes and packets planes in one launch).
//
// Replaces the Pallas kernel netobserv_tpu/ops/pallas/countmin_kernel.py
// `update_two` (`_fold2_kernel`). The TPU form builds a one-hot matrix per
// width tile and contracts it on the MXU, which costs d*B*W compares; here
// each thread owns one (depth row, record) pair, computes the column
// (h1 + r*h2) & (W-1) itself and adds the record's two masked values into
// the planes in place with atomicAdd.
//
// Bound on this card: d*B pairs, each two 4-byte read-modify-writes into
// two 1 MiB planes (4 x 65536 f32) that stay in the 50 MB L2, so L2 atomic
// throughput bounds the kernel, not HBM. Same-address atomics serialize,
// and Zipf traffic puts a hot key's rows (about 2,900 of a batch's 16,384)
// on the same d cells. So the threads run row-major, t = r * B + b: a warp
// holds 32 consecutive records of one row (two rows where it straddles a
// row's end), its lanes with the same cell sum their two values
// (warp_agg.cuh), and only the group's leader makes the atomics. A hot
// key then costs one atomic per warp and cell (B / 32 = 512 warps a row
// at B = 16,384) instead of one per record. Rows whose two values are
// both zero (invalid or padding rows) take a sentinel key, still reach
// the warp's match, and add nothing; a group whose sum on one plane is
// zero adds nothing to that plane.
//
// Atomics and the warp's tree sums reorder float adds: the result is
// bit-exact against the plain version only while every per-cell sum stays
// an integer below 2^24.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_agg.cuh"

#define CM2_THREADS 256

__global__ void cm_fold2_kernel(float* __restrict__ cm_a,
                                float* __restrict__ cm_b,
                                const int64_t* __restrict__ h1,
                                const int64_t* __restrict__ h2,
                                const float* __restrict__ va,
                                const float* __restrict__ vb,
                                int n, int depth, int width) {
  // every lane reaches warp_peers: a lane past the end keeps the sentinel
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float v[2] = {0.0f, 0.0f};
  int key = -1;  // the cell r * W + col; -1: nothing to add
  if (t < n * depth) {
    const int r = t / n;
    const int b = t - r * n;
    v[0] = va[b];
    v[1] = vb[b];
    if (v[0] != 0.0f || v[1] != 0.0f) {
      const uint32_t col = ((uint32_t)h1[b] + (uint32_t)r * (uint32_t)h2[b])
                           & (uint32_t)(width - 1);
      key = r * width + (int)col;
    }
  }
  const unsigned peers = warp_peers(key);
  group_sum<2>(peers, v);
  if (key >= 0 && group_leader(peers)) {
    if (v[0] != 0.0f) atomicAdd(cm_a + key, v[0]);
    if (v[1] != 0.0f) atomicAdd(cm_b + key, v[1]);
  }
}

// One launch of ceil(d * n / CM2_THREADS) blocks (the wrapper's
// `launch_shape`); the wrapper guarantees d * W < 2^31 and d * n < 2^31.
extern "C" int cm_fold2(float* cm_a, float* cm_b, const int64_t* h1,
                        const int64_t* h2, const float* va, const float* vb,
                        int n, int depth, int width, cudaStream_t stream) {
  if (n > 0) {
    const int blocks = (n * depth + CM2_THREADS - 1) / CM2_THREADS;
    cm_fold2_kernel<<<blocks, CM2_THREADS, 0, stream>>>(cm_a, cm_b, h1, h2,
                                                        va, vb, n, depth,
                                                        width);
  }
  return (int)cudaGetLastError();
}
