// Single-plane Count-Min fold.
//
// Replaces the Pallas kernel netobserv_tpu/ops/pallas/countmin_kernel.py
// `update` (`_fold_kernel`). The TPU form builds a one-hot matrix per width
// tile and contracts it with the value row on the MXU, which costs d*B*W
// compares; here each thread owns one (record, depth row) pair, computes
// the column (h1 + r*h2) & (W-1) itself and adds the record's masked value
// with one atomicAdd, in place. It is kernel 1 (countmin_fold2.cu) with one
// value row.
//
// Bound on this card: d*B pairs, each one 4-byte read-modify-write into a
// 1 MiB plane (4 x 65536 f32) that stays in the 50 MB L2, so L2 atomic
// throughput bounds the kernel, not HBM. Same-address atomics serialize: a
// key holding a large share of the batch puts that many atomics on the
// same d cells. Rows whose value is zero (invalid or padding rows) make no
// atomic at all.
//
// Atomics reorder float adds: the result is bit-exact against the plain
// version only while every per-cell sum stays an integer below 2^24.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void cm_fold_kernel(float* __restrict__ cm,
                               const int64_t* __restrict__ h1,
                               const int64_t* __restrict__ h2,
                               const float* __restrict__ vals,
                               int n, int depth, int width) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * depth) return;
  int b = t / depth;  // neighbouring threads share a record
  int r = t - b * depth;
  float v = vals[b];
  if (v == 0.0f) return;
  uint32_t col = ((uint32_t)h1[b] + (uint32_t)r * (uint32_t)h2[b])
                 & (uint32_t)(width - 1);
  atomicAdd(cm + (size_t)r * (size_t)width + col, v);
}

extern "C" int cm_fold(float* cm, const int64_t* h1, const int64_t* h2,
                       const float* vals, int n, int depth, int width,
                       cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    int blocks = (n * depth + threads - 1) / threads;
    cm_fold_kernel<<<blocks, threads, 0, stream>>>(cm, h1, h2, vals, n,
                                                   depth, width);
  }
  return (int)cudaGetLastError();
}
