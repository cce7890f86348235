// Dual-plane Count-Min fold (bytes and packets planes in one launch).
//
// Replaces the Pallas kernel netobserv_tpu/ops/pallas/countmin_kernel.py
// `update_two` (`_fold2_kernel`). The TPU form builds a one-hot matrix per
// width tile and contracts it on the MXU, which costs d*B*W compares; here
// each thread owns one (record, depth row) pair, computes the column
// (h1 + r*h2) & (W-1) itself and adds the record's two masked values with
// atomicAdd, in place.
//
// Bound on this card: d*B pairs, each two 4-byte read-modify-writes into
// two 1 MiB planes (4 x 65536 f32) that stay in the 50 MB L2, so L2 atomic
// throughput bounds the kernel, not HBM. Same-address atomics serialize: a
// key holding a large share of the batch (Zipf traffic) puts that many
// atomics on the same d cells. Rows whose two values are both zero (invalid
// or padding rows) make no atomic at all.
//
// Atomics reorder float adds: the result is bit-exact against the plain
// version only while every per-cell sum stays an integer below 2^24.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void cm_fold2_kernel(float* __restrict__ cm_a,
                                float* __restrict__ cm_b,
                                const int64_t* __restrict__ h1,
                                const int64_t* __restrict__ h2,
                                const float* __restrict__ va,
                                const float* __restrict__ vb,
                                int n, int depth, int width) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * depth) return;
  int b = t / depth;  // neighbouring threads share a record
  int r = t - b * depth;
  float a = va[b];
  float c = vb[b];
  if (a == 0.0f && c == 0.0f) return;
  uint32_t col = ((uint32_t)h1[b] + (uint32_t)r * (uint32_t)h2[b])
                 & (uint32_t)(width - 1);
  size_t off = (size_t)r * (size_t)width + col;
  atomicAdd(cm_a + off, a);
  atomicAdd(cm_b + off, c);
}

extern "C" int cm_fold2(float* cm_a, float* cm_b, const int64_t* h1,
                        const int64_t* h2, const float* va, const float* vb,
                        int n, int depth, int width, cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    int blocks = (n * depth + threads - 1) / threads;
    cm_fold2_kernel<<<blocks, threads, 0, stream>>>(cm_a, cm_b, h1, h2, va,
                                                    vb, n, depth, width);
  }
  return (int)cudaGetLastError();
}
