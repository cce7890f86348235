// Tier-interior dual-plane Count-Min fold: decode the narrow tiers of both
// planes, fold the batch, promote the per-counter delta back into the
// tiers, and gather the post-fold bytes estimate of every record. The wide
// f32 view lives only in shared memory, never in device memory.
//
// Replaces the Pallas kernel netobserv_tpu/ops/pallas/countmin_kernel.py
// `update_two_tiered` (`_tier2_kernel`), which walks 512-column strips,
// decodes them in VMEM, folds with one-hot matrix products and promotes
// with group-sum matrices. Here one thread block owns one tile of TILE_W
// columns of both planes and all d rows (2 x 4 x 512 f32 = 16 KiB of wide
// view at the default geometry). The tile holds whole top groups (the
// wrapper asserts `tiered_eligible`), so promotion never crosses a block.
// Each block:
//   1. decodes its tiles into shared memory twice: `dec` (the pre-fold
//      view) and `wide` (the view the fold adds into);
//   2. walks all B records, RB at a time per thread (their loads in flight
//      together: the walk is bound by load latency, not bandwidth),
//      computes each row's column (h1 + r*h2) & (W-1) itself, and adds the
//      record's two masked values with shared-memory atomicAdd where the
//      column falls in its tile;
//   3. writes q[r, b] = wide[r, col] of the bytes plane for its columns
//      (the post-fold, pre-promotion view: each (r, b) lies in exactly one
//      tile, so a plain store), and promotes: base per counter, then mid
//      per mid cell, then top per top cell, each from the one below, with
//      the arithmetic of tier_tiles.cuh, written back in place.
// A second small kernel takes est[b] = min over r of q[r, b].
//
// Bound on this card: the tier bytes of both planes (u8 base, u16 mid,
// u32 top: 2 x 0.54 MB at the default geometry) read and written once,
// plus the batch's h1, h2 and values. Every block walks the whole batch
// twice from L2, and a hot key puts all its rows on one shared-memory
// address per row; neither is in the byte bound.
//
// Atomics reorder float adds: the tiers and est are bit-exact against the
// plain version only while every decoded cell plus its fold sum is an
// integer below 2^24. Outside it, `ceil((new - dec) / unit)` can land one
// unit apart, and a shared mid or top cell adds up those units.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tier_tiles.cuh"

#define TILE_W 512
#define THREADS 512
#define RB 4  // records per thread per step of a batch walk

struct TierPlane {
  uint8_t* base;   // [d, w]
  uint16_t* mid;   // [d, w / mg]
  uint32_t* top;   // [d, w / tg]
};

__global__ void cm_tier2_kernel(TierPlane pa, TierPlane pb,
                                const int64_t* __restrict__ h1,
                                const int64_t* __restrict__ h2,
                                const float* __restrict__ va,
                                const float* __restrict__ vb,
                                float* __restrict__ q, int n, int depth,
                                int width, int mg, int tg, float unit_a,
                                float unit_b) {
  extern __shared__ float sm[];
  const int cells = depth * TILE_W;    // per plane
  const int tm = TILE_W / mg;          // mid cells per row of the tile
  const int tt = TILE_W / tg;          // top cells per row of the tile
  const int wm = width / mg, wt = width / tg;
  float* dec = sm;                     // [2][d][TILE_W], later the overflow
  float* wide = sm + 2 * cells;        // [2][d][TILE_W]
  float* mspill = sm + 4 * cells;      // [2][d][tm]
  const int lo = blockIdx.x * TILE_W;

  // 1. decode both planes' tiles
  for (int i = threadIdx.x; i < 2 * cells; i += blockDim.x) {
    const int p = i / cells;
    const int r = (i - p * cells) / TILE_W;
    const int col = lo + (i - p * cells - r * TILE_W);
    const TierPlane pl = p ? pb : pa;
    float v = tier_decode(pl.base[(size_t)r * width + col],
                          pl.mid[(size_t)r * wm + col / mg],
                          pl.top[(size_t)r * wt + col / tg],
                          p ? unit_b : unit_a);
    dec[i] = v;
    wide[i] = v;
  }
  __syncthreads();

  // 2. fold the batch into the tile's wide view
  const uint32_t wmask = (uint32_t)(width - 1);
  const int step = RB * blockDim.x;
  for (int b0 = threadIdx.x; b0 < n; b0 += step) {
    float a[RB], c[RB];
    uint32_t x[RB], y[RB];
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      const int b = b0 + k * blockDim.x;
      const bool in = b < n;
      a[k] = in ? va[b] : 0.0f;
      c[k] = in ? vb[b] : 0.0f;
      x[k] = in ? (uint32_t)h1[b] : 0u;
      y[k] = in ? (uint32_t)h2[b] : 0u;
    }
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      if (a[k] == 0.0f && c[k] == 0.0f) continue;
      for (int r = 0; r < depth; ++r) {
        const int off = (int)((x[k] + (uint32_t)r * y[k]) & wmask) - lo;
        if (off < 0 || off >= TILE_W) continue;
        if (a[k] != 0.0f) atomicAdd(wide + r * TILE_W + off, a[k]);
        if (c[k] != 0.0f) atomicAdd(wide + cells + r * TILE_W + off, c[k]);
      }
    }
  }
  __syncthreads();

  // 3a. post-fold bytes estimate per (row, record) in this tile
  for (int b0 = threadIdx.x; b0 < n; b0 += step) {
    uint32_t x[RB], y[RB];
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      const int b = b0 + k * blockDim.x;
      x[k] = b < n ? (uint32_t)h1[b] : 0u;
      y[k] = b < n ? (uint32_t)h2[b] : 0u;
    }
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      const int b = b0 + k * blockDim.x;
      if (b >= n) continue;
      for (int r = 0; r < depth; ++r) {
        const int off = (int)((x[k] + (uint32_t)r * y[k]) & wmask) - lo;
        if (off >= 0 && off < TILE_W)
          q[(size_t)r * n + b] = wide[r * TILE_W + off];
      }
    }
  }
  // 3b. promote: base per counter (the overflow replaces dec)
  for (int i = threadIdx.x; i < 2 * cells; i += blockDim.x) {
    const int p = i / cells;
    const int r = (i - p * cells) / TILE_W;
    const int col = lo + (i - p * cells - r * TILE_W);
    const TierPlane pl = p ? pb : pa;
    uint8_t* bp = pl.base + (size_t)r * width + col;
    dec[i] = tier_promote_base(*bp, dec[i], wide[i], p ? unit_b : unit_a,
                               bp);
  }
  __syncthreads();
  // 3c. mid per mid cell: its group's overflow, summed in column order
  const int mcells = depth * tm;
  for (int i = threadIdx.x; i < 2 * mcells; i += blockDim.x) {
    const int p = i / mcells;
    const int r = (i - p * mcells) / tm;
    const int k = i - p * mcells - r * tm;
    const float* ov = dec + p * cells + r * TILE_W + k * mg;
    float gsum = 0.0f;
    for (int j = 0; j < mg; ++j) gsum = __fadd_rn(gsum, ov[j]);
    const TierPlane pl = p ? pb : pa;
    uint16_t* mp = pl.mid + (size_t)r * wm + lo / mg + k;
    mspill[i] = tier_promote_mid(*mp, gsum, mp);
  }
  __syncthreads();
  // 3d. top per top cell: its mid cells' overflow, summed in order
  const int gpt = tg / mg;
  const int tcells = depth * tt;
  for (int i = threadIdx.x; i < 2 * tcells; i += blockDim.x) {
    const int p = i / tcells;
    const int r = (i - p * tcells) / tt;
    const int k = i - p * tcells - r * tt;
    const float* sp = mspill + p * mcells + r * tm + k * gpt;
    float spill = 0.0f;
    for (int j = 0; j < gpt; ++j) spill = __fadd_rn(spill, sp[j]);
    const TierPlane pl = p ? pb : pa;
    uint32_t* tp = pl.top + (size_t)r * wt + lo / tg + k;
    *tp = tier_promote_top(*tp, spill);
  }
}

__global__ void cm_tier2_est_kernel(const float* __restrict__ q,
                                    float* __restrict__ est, int n,
                                    int depth) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  float m = q[b];
  for (int r = 1; r < depth; ++r) m = fminf(m, q[(size_t)r * n + b]);
  est[b] = m;
}

extern "C" int cm_tier2(uint8_t* base_a, uint16_t* mid_a, uint32_t* top_a,
                        uint8_t* base_b, uint16_t* mid_b, uint32_t* top_b,
                        const int64_t* h1, const int64_t* h2,
                        const float* va, const float* vb, float* q,
                        float* est, int n, int depth, int width, int mg,
                        int tg, int unit_a, int unit_b,
                        cudaStream_t stream) {
  if (n > 0) {
    const size_t smem = ((size_t)4 * depth * TILE_W
                         + (size_t)2 * depth * (TILE_W / mg)) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        cm_tier2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    TierPlane pa = {base_a, mid_a, top_a};
    TierPlane pb = {base_b, mid_b, top_b};
    cm_tier2_kernel<<<width / TILE_W, THREADS, smem, stream>>>(
        pa, pb, h1, h2, va, vb, q, n, depth, width, mg, tg, (float)unit_a,
        (float)unit_b);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cm_tier2_est_kernel<<<(n + 255) / 256, 256, 0, stream>>>(q, est, n,
                                                             depth);
  }
  return (int)cudaGetLastError();
}
