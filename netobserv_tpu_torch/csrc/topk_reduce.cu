// The three per-slot reductions of the persistent-slot top-K table.
//
// Replaces the Pallas kernel netobserv_tpu/ops/pallas/topk_kernel.py
// `reduce` (`_reduce_kernel`), which walks the batch in chunks against all K
// slot lanes (B*K compares). For each slot k:
//   match_max[k] = max est among rows with mslot == k (-1 if none);
//   chall_max[k] = max est among rows with target == k (-1 if none);
//   win_row[k]   = the LOWEST row at chall_max with est > -1, or
//                  NO_WINNER (0x7FFFFFFF) if there is none.
//
// One thread per row. f32 values are mapped to an unsigned key whose integer
// order is the float order (flip all bits of a negative, set the sign bit of
// a positive), so a max is an integer atomicMax and exact in any order. The
// winner rides one 64-bit atomicMax on (ordered est << 32) | ~row: the
// largest key has the largest est and, among equal est, the smallest row,
// so the winner is deterministic. Rows with est <= -1 never take part,
// which leaves -1 / NO_WINNER for a slot with no live challenger.
//
// Bound on this card: B rows, at most two atomics each, onto K-entry tables
// (12 KiB) that live in L2; three launches (init, fold, finalize) in one
// call. Same-slot atomics serialize under a hot key.

#include <cuda_runtime.h>
#include <stdint.h>

#define NO_WINNER 0x7FFFFFFF

__device__ __forceinline__ uint32_t ord_of(float f) {
  uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float f32_of(uint32_t o) {
  uint32_t u = (o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o;
  return __uint_as_float(u);
}

__global__ void topk_init_kernel(uint32_t* __restrict__ match_ord,
                                 unsigned long long* __restrict__ best,
                                 int k) {
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= k) return;
  match_ord[s] = ord_of(-1.0f);
  best[s] = 0ull;
}

__global__ void topk_fold_kernel(uint32_t* __restrict__ match_ord,
                                 unsigned long long* __restrict__ best,
                                 const int64_t* __restrict__ mslot,
                                 const int64_t* __restrict__ target,
                                 const float* __restrict__ est, int n,
                                 int k) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  float e = est[b];
  int64_t ms = mslot[b];
  if (ms >= 0 && ms < k) atomicMax(match_ord + ms, ord_of(e));
  int64_t tg = target[b];
  if (tg >= 0 && tg < k && e > -1.0f) {
    unsigned long long key = ((unsigned long long)ord_of(e) << 32)
                             | (unsigned long long)(~(uint32_t)b);
    atomicMax(best + tg, key);
  }
}

// match_ord and match_max are the same buffer: no __restrict__ on either
__global__ void topk_finalize_kernel(const uint32_t* match_ord,
                                     const unsigned long long* __restrict__ best,
                                     float* match_max,
                                     float* __restrict__ chall_max,
                                     int* __restrict__ win_row, int k) {
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= k) return;
  float m = f32_of(match_ord[s]);
  unsigned long long v = best[s];
  // match_max aliases match_ord: read before write, same thread
  match_max[s] = m;
  if (v == 0ull) {
    chall_max[s] = -1.0f;
    win_row[s] = NO_WINNER;
  } else {
    chall_max[s] = f32_of((uint32_t)(v >> 32));
    win_row[s] = (int)(~(uint32_t)v);
  }
}

// match_max doubles as the ordered-key scratch of the match reduction;
// best is a caller-allocated u64[k] scratch.
extern "C" int topk_reduce(float* match_max, float* chall_max, int* win_row,
                           unsigned long long* best, const int64_t* mslot,
                           const int64_t* target, const float* est, int n,
                           int k, cudaStream_t stream) {
  const int threads = 256;
  uint32_t* match_ord = (uint32_t*)match_max;
  int kb = (k + threads - 1) / threads;
  topk_init_kernel<<<kb, threads, 0, stream>>>(match_ord, best, k);
  if (n > 0) {
    topk_fold_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
        match_ord, best, mslot, target, est, n, k);
  }
  topk_finalize_kernel<<<kb, threads, 0, stream>>>(match_ord, best, match_max,
                                                   chall_max, win_row, k);
  return (int)cudaGetLastError();
}
