// Tier-interior dual-plane Count-Min fold: decode the narrow tiers of both
// planes, fold the batch, promote the per-counter delta back into the
// tiers, and gather the post-fold bytes estimate of every record. The wide
// f32 view lives only in shared memory, never in device memory.
//
// Replaces the Pallas kernel netobserv_tpu/ops/pallas/countmin_kernel.py
// `update_two_tiered` (`_tier2_kernel`), which walks 512-column strips,
// decodes them in VMEM, folds the whole batch into each strip with one-hot
// matrix products, gathers the estimate in a second whole-batch walk and
// promotes with group-sum matrices. That shape suits the MXU; on this card
// a block that walks the whole batch for one tile drops 127 of every 128
// (record, row) pairs it computes. So the batch is binned by tile first,
// and each tile's block walks only its own pairs. Four launches and one
// memset, all in this file's one C entry (`cm_tier2`):
//   0. memset the per-tile counts and cursors to zero;
//   1. count (one thread per record): each row's tile
//      ((h1 + r*h2) & (W-1)) / TILE_W into a per-block shared histogram,
//      then one global add per block and tile. Rows whose two values are
//      both zero are binned too: the estimate needs every (record, row);
//   2. scatter (one thread per record): the entry b * d + r goes to its
//      tile's bin. A bin starts at the sum of the counts of the tiles below
//      it (each block takes the prefix of the counts itself, so there is no
//      scan launch). A block counts its pairs per tile again, reserves one
//      run per tile with one global atomic on the tile's cursor, and hands
//      out slots from shared cursors: one atomic per warp and tile, the
//      lane's rank among its group's lanes on top;
//   3. fold and promote (one block of TIER2_THREADS per TILE_W-column tile
//      of both planes and all d rows: 2 x 4 x 512 f32 = 16 KiB of wide view
//      at the default geometry; the tile holds whole top groups, the
//      wrapper asserts `tiered_eligible`, so promotion never crosses a
//      block). TILE_W, the tier groups and the unit are powers of two, so
//      every index is a shift or a mask:
//      a. the tile's mid and top cells and its base tier (as 32-bit words
//         of 4 columns) into shared memory, and the bin's start as a
//         warp-reduced sum of the counts below; decode both planes into
//         `dec` (the pre-fold view, padded by one f32 per mid group so the
//         mid sums below read distinct banks) and `wide` (the view the
//         fold adds into);
//      b. walk the tile's bin, RK rounds of the block at a time: their
//         entries, then the records' values and hashes, are loaded
//         together, so a round costs one latency, not two. The lanes of a
//         warp with the same cell sum their two values (warp_agg.cuh) and
//         the group's leader adds them with shared-memory atomicAdd. An f32
//         add into shared memory has no native instruction on sm_90: it
//         compiles to a compare-and-swap loop (ATOMS.CAST.SPIN), so the
//         hot key's adds, one per warp instead of one per row, are a loop
//         each. Zero rows pass a sentinel and add nothing;
//      c. store q[r, b] = wide[r, col] of the bytes plane (the post-fold,
//         pre-promotion view: each (r, b) lies in one tile, so a plain
//         store), from the cells and indices the lanes kept of the last RK
//         rounds (earlier rounds of a longer bin are walked again), then
//         promote: base per counter from the shared base bytes, written
//         back as words, mid per mid cell, top per top cell, each from the
//         one below, with the arithmetic of tier_tiles.cuh, in place;
//   4. est[b] = min over r of q[r, b].
// The hot key's rows (about 2,900 of the bench traffic's 16,384 a fold)
// land in at most d bins, so the hottest block walks about 3,400 entries
// where each block walked all 65,536 (record, row) pairs twice.
//
// Scratch (the wrapper's `torch.empty`): counts and cursors int32[2 x W /
// TILE_W] and the entries int32[d x B]; neither holds a counter.
//
// Bound on this card: the tier bytes of both planes (u8 base, u16 mid,
// u32 top: 2 x 0.54 MB at the default geometry) read and written once,
// plus the batch's h1, h2 and values. The bins' 2 x 4 x d x B bytes, the
// bin walks' gathers from the L2-resident batch and the chain of dependent
// steps in each block (counts, tiers, bin, gathers, promotion) are not in
// it: four launches' floors and those latencies set most of the time.
//
// Atomics and the warp's tree sums reorder float adds: the tiers and est
// are bit-exact against the plain version only while every decoded cell
// plus its fold sum is an integer below 2^24. Outside it,
// `ceil((new - dec) / unit)` can land one unit apart, and a shared mid or
// top cell adds up those units.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tier_tiles.cuh"
#include "warp_agg.cuh"

#define TILE_W 512
#define TIER2_THREADS 1024  // fold block: one per tile
#define BIN_THREADS 256    // count and scatter blocks: one thread a record
#define EST_THREADS 256
#define RK 4               // bin rounds a fold lane loads and keeps at once

struct TierPlane {
  uint8_t* base;   // [d, w]
  uint16_t* mid;   // [d, w / mg]
  uint32_t* top;   // [d, w / tg]
};

__device__ __forceinline__ int cm_col(uint32_t x, uint32_t y, int r,
                                      uint32_t wmask) {
  return (int)((x + (uint32_t)r * y) & wmask);
}

// 1. per-tile counts of the batch's (record, row) pairs
__global__ void cm_tier2_count_kernel(const int64_t* __restrict__ h1,
                                      const int64_t* __restrict__ h2,
                                      int* __restrict__ counts, int n,
                                      int depth, int width, int n_tiles) {
  extern __shared__ int hist[];
  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = b < n;
  const uint32_t x = in ? (uint32_t)h1[b] : 0u;
  const uint32_t y = in ? (uint32_t)h2[b] : 0u;
  const uint32_t wmask = (uint32_t)(width - 1);
  for (int r = 0; r < depth; ++r) {
    const int tile = in ? cm_col(x, y, r, wmask) / TILE_W : -1;
    const unsigned peers = warp_peers(tile);
    if (in && group_leader(peers)) atomicAdd(hist + tile, __popc(peers));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x)
    if (hist[i]) atomicAdd(counts + i, hist[i]);
}

// start[i] = counts[0] + ... + counts[i - 1], by warp 0 in chunks of 32
__device__ __forceinline__ void bin_starts(const int* __restrict__ counts,
                                           int* start, int n_tiles) {
  if (threadIdx.x >= 32) return;
  const int lane = lane_id();
  int carry = 0;
  for (int i0 = 0; i0 < n_tiles; i0 += 32) {
    const int i = i0 + lane;
    const int v = i < n_tiles ? counts[i] : 0;
    int s = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL_MASK, s, o);
      if (lane >= o) s += u;
    }
    if (i < n_tiles) start[i] = carry + s - v;
    carry += __shfl_sync(FULL_MASK, s, 31);
  }
}

// 2. every (record, row) pair's entry b * d + r into its tile's bin: a
// block counts its pairs per tile in shared memory, reserves one run per
// tile with one global atomic, then hands out slots from shared cursors
__global__ void cm_tier2_scatter_kernel(const int64_t* __restrict__ h1,
                                        const int64_t* __restrict__ h2,
                                        const int* __restrict__ counts,
                                        int* __restrict__ cursors,
                                        int* __restrict__ entries, int n,
                                        int depth, int width, int n_tiles) {
  extern __shared__ int start[];     // [n_tiles] bin starts, then
  int* local = start + n_tiles;      // [n_tiles] this block's counts
  int* run = local + n_tiles;        // [n_tiles] this block's run starts
  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) local[i] = 0;
  bin_starts(counts, start, n_tiles);
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = b < n;
  const uint32_t x = in ? (uint32_t)h1[b] : 0u;
  const uint32_t y = in ? (uint32_t)h2[b] : 0u;
  const uint32_t wmask = (uint32_t)(width - 1);
  for (int r = 0; r < depth; ++r) {
    const int tile = in ? cm_col(x, y, r, wmask) / TILE_W : -1;
    const unsigned peers = warp_peers(tile);
    if (in && group_leader(peers)) atomicAdd(local + tile, __popc(peers));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) {
    const int c = local[i];
    run[i] = c ? start[i] + atomicAdd(cursors + i, c) : 0;
    local[i] = 0;
  }
  __syncthreads();
  const unsigned below = (1u << lane_id()) - 1u;
  for (int r = 0; r < depth; ++r) {
    const int tile = in ? cm_col(x, y, r, wmask) / TILE_W : -1;
    const unsigned peers = warp_peers(tile);
    int slot = 0;
    if (in && group_leader(peers))
      slot = run[tile] + atomicAdd(local + tile, __popc(peers));
    slot = __shfl_sync(FULL_MASK, slot, __ffs(peers) - 1);
    if (in) entries[slot + __popc(peers & below)] = b * depth + r;
  }
}

// 3. decode, fold the tile's bin, gather q, promote. TILE_W and the tier
// groups are powers of two, so every index below is a shift or a mask; the
// flat index i over both planes' tiles is (p * d + r) * TILE_W + column.
__global__ void cm_tier2_kernel(TierPlane pa, TierPlane pb,
                                const int64_t* __restrict__ h1,
                                const int64_t* __restrict__ h2,
                                const float* __restrict__ va,
                                const float* __restrict__ vb,
                                const int* __restrict__ counts,
                                const int* __restrict__ entries,
                                float* __restrict__ q, int n, int depth,
                                int width, int mg, int tg, float unit_a,
                                float unit_b) {
  extern __shared__ float sm[];
  __shared__ int bin[2];               // this tile's start and length
  const int lmg = __ffs(mg) - 1, ltg = __ffs(tg) - 1;
  const int cells = 2 * depth * TILE_W;  // both planes
  const int tm = TILE_W >> lmg;        // mid cells per row of the tile
  const int tt = TILE_W >> ltg;        // top cells per row of the tile
  const int mcells = 2 * depth * tm, tcells = 2 * depth * tt;
  // dec (later the overflow) is padded by one float per mid group, so the
  // mid sums' lanes (one group each) read distinct banks
  float* dec = sm;                                 // [cells + cells / mg]
  float* wide = dec + cells + (cells >> lmg);      // [cells]
  float* mspill = wide + cells;                    // [mcells]
  uint32_t* stop = (uint32_t*)(mspill + mcells);   // [tcells] top tier
  uint16_t* smid = (uint16_t*)(stop + tcells);     // [mcells] mid tier
  uint8_t* sbase = (uint8_t*)(smid + mcells);      // [cells] base tier
  const int tile = blockIdx.x;
  const int lo = tile * TILE_W;
  const int wm = width >> lmg, wt = width >> ltg;
  const uint32_t wmask = (uint32_t)(width - 1);

  // a. the bin's start (the counts of the tiles below) and length; the
  // tile's mid and top cells into shared memory; the base tier moves as
  // 32-bit words of 4 columns (a thread's first word is loaded first, so
  // its latency hides behind the rest)
  const int words = cells / 4;
  uint32_t w0 = 0;
  if ((int)threadIdx.x < words) {
    const int i = 4 * threadIdx.x, pr = i / TILE_W;
    const int p = pr >= depth, r = pr - p * depth;
    w0 = *(const uint32_t*)((p ? pb : pa).base + (size_t)r * width + lo
                            + (i & (TILE_W - 1)));
  }
  if (threadIdx.x == 0) {
    bin[0] = 0;
    bin[1] = counts[tile];
  }
  for (int i = threadIdx.x; i < mcells; i += blockDim.x) {
    const int pr = i / tm, k = i - pr * tm;
    const int p = pr >= depth, r = pr - p * depth;
    smid[i] = (p ? pb : pa).mid[(size_t)r * wm + (lo >> lmg) + k];
  }
  for (int i = threadIdx.x; i < tcells; i += blockDim.x) {
    const int pr = i / tt, k = i - pr * tt;
    const int p = pr >= depth, r = pr - p * depth;
    stop[i] = (p ? pb : pa).top[(size_t)r * wt + (lo >> ltg) + k];
  }
  int below = 0;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) below += counts[i];
  below = __reduce_add_sync(FULL_MASK, below);
  __syncthreads();
  if (lane_id() == 0 && below) atomicAdd(bin, below);
  //    decode both planes' tiles into `dec` (the pre-fold view) and `wide`
  //    (the view the fold adds into)
  for (int j = threadIdx.x; j < words; j += blockDim.x) {
    const int i = 4 * j, col = i & (TILE_W - 1), pr = i / TILE_W;
    const int p = pr >= depth, r = pr - p * depth;
    const uint32_t w4 = j == (int)threadIdx.x
        ? w0 : *(const uint32_t*)((p ? pb : pa).base + (size_t)r * width
                                   + lo + col);
    const float unit = p ? unit_b : unit_a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint8_t b8 = (uint8_t)(w4 >> (8 * c));
      const float v = tier_decode(b8, smid[pr * tm + ((col + c) >> lmg)],
                                  stop[pr * tt + ((col + c) >> ltg)], unit);
      dec[i + c + ((i + c) >> lmg)] = v;
      wide[i + c] = v;
      sbase[i + c] = b8;
    }
  }
  __syncthreads();
  const int* mine = entries + bin[0];
  const int len = bin[1];
  const int half = cells / 2;  // the packets plane's offset in `wide`
  const int rounds = (len + blockDim.x - 1) / blockDim.x;

  // b. fold the bin, RK rounds of blockDim.x entries at a time: their
  // entries, then their gathers, are loaded together, and each lane keeps
  // its cells and q indices for step c; every lane of a warp runs the same
  // trips
  int cell[RK], qi[RK];  // r * TILE_W + offset in the tile, r * n + b
#pragma unroll
  for (int k = 0; k < RK; ++k) cell[k] = qi[k] = -1;
  for (int k0 = 0; k0 < rounds; k0 += RK) {
    int e[RK];
    float v0[RK], v1[RK];
#pragma unroll
    for (int k = 0; k < RK; ++k) {
      const int i = (k0 + k) * blockDim.x + threadIdx.x;
      e[k] = i < len ? mine[i] : -1;
    }
#pragma unroll
    for (int k = 0; k < RK; ++k) {
      cell[k] = qi[k] = -1;
      v0[k] = v1[k] = 0.0f;
      if (e[k] >= 0) {
        const int b = e[k] / depth;
        const int r = e[k] - b * depth;
        v0[k] = va[b];
        v1[k] = vb[b];
        cell[k] = r * TILE_W
                  + cm_col((uint32_t)h1[b], (uint32_t)h2[b], r, wmask) - lo;
        qi[k] = r * n + b;
      }
    }
#pragma unroll
    for (int k = 0; k < RK; ++k) {
      if (k0 + k >= rounds) break;  // the same for every lane
      float v[2] = {v0[k], v1[k]};
      const int key = v[0] != 0.0f || v[1] != 0.0f ? cell[k] : -1;
      const unsigned peers = warp_peers(key);
      group_sum<2>(peers, v);
      if (key >= 0 && group_leader(peers)) {
        if (v[0] != 0.0f) atomicAdd(wide + key, v[0]);
        if (v[1] != 0.0f) atomicAdd(wide + half + key, v[1]);
      }
    }
  }
  __syncthreads();

  // c. post-fold bytes estimate of each of the bin's (row, record) pairs:
  // the last RK rounds' from the lane's registers, earlier ones reloaded
#pragma unroll
  for (int k = 0; k < RK; ++k)
    if (qi[k] >= 0) q[qi[k]] = wide[cell[k]];
  const int reloaded = rounds > RK ? (rounds - 1) / RK * RK : 0;
  for (int i = threadIdx.x; i < reloaded * (int)blockDim.x;
       i += blockDim.x) {
    const int e = mine[i];
    const int b = e / depth;
    const int r = e - b * depth;
    const int off = cm_col((uint32_t)h1[b], (uint32_t)h2[b], r, wmask) - lo;
    q[(size_t)r * n + b] = wide[r * TILE_W + off];
  }
  //    promote: base per counter (the overflow replaces dec), 4 columns a
  //    word
  for (int j = threadIdx.x; j < words; j += blockDim.x) {
    const int i = 4 * j, col = i & (TILE_W - 1), pr = i / TILE_W;
    const int p = pr >= depth, r = pr - p * depth;
    const float inv = 1.0f / (p ? unit_b : unit_a);  // exact: a power of 2
    uint32_t w4 = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float* ov = dec + i + c + ((i + c) >> lmg);
      uint8_t nb;
      *ov = tier_promote_base(sbase[i + c], *ov, wide[i + c], inv, &nb);
      w4 |= (uint32_t)nb << (8 * c);
    }
    *(uint32_t*)((p ? pb : pa).base + (size_t)r * width + lo + col) = w4;
  }
  __syncthreads();
  //    mid per mid cell: its group's overflow, summed in column order
  for (int i = threadIdx.x; i < mcells; i += blockDim.x) {
    const int pr = i / tm, k = i - pr * tm;
    const int p = pr >= depth, r = pr - p * depth;
    const float* ov = dec + i * (mg + 1);
    float gsum = 0.0f;
    for (int j = 0; j < mg; ++j) gsum = __fadd_rn(gsum, ov[j]);
    mspill[i] = tier_promote_mid(
        smid[i], gsum, (p ? pb : pa).mid + (size_t)r * wm + (lo >> lmg) + k);
  }
  __syncthreads();
  //    top per top cell: its mid cells' overflow, summed in order
  const int gpt = tg >> lmg;
  for (int i = threadIdx.x; i < tcells; i += blockDim.x) {
    const int pr = i / tt, k = i - pr * tt;
    const int p = pr >= depth, r = pr - p * depth;
    const float* sp = mspill + pr * tm + k * gpt;
    float spill = 0.0f;
    for (int j = 0; j < gpt; ++j) spill = __fadd_rn(spill, sp[j]);
    (p ? pb : pa).top[(size_t)r * wt + (lo >> ltg) + k] =
        tier_promote_top(stop[i], spill);
  }
}

// 4. the estimate: min over the rows
__global__ void cm_tier2_est_kernel(const float* __restrict__ q,
                                    float* __restrict__ est, int n,
                                    int depth) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  float m = q[b];
  for (int r = 1; r < depth; ++r) m = fminf(m, q[(size_t)r * n + b]);
  est[b] = m;
}

// dynamic shared memory past the default 48 KiB needs the attribute
template <typename K>
static cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The wrapper's `launch_shapes_tier2` gives the four grids; it guarantees
// d * n < 2^31 and that each block's shared memory fits.
extern "C" int cm_tier2(uint8_t* base_a, uint16_t* mid_a, uint32_t* top_a,
                        uint8_t* base_b, uint16_t* mid_b, uint32_t* top_b,
                        const int64_t* h1, const int64_t* h2,
                        const float* va, const float* vb, float* q,
                        float* est, int* counts, int* entries, int n,
                        int depth, int width, int mg, int tg, int unit_a,
                        int unit_b, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int n_tiles = width / TILE_W;
  int* cursors = counts + n_tiles;
  const size_t bin_smem = (size_t)n_tiles * sizeof(int);
  // dec (padded), wide and the mid spill (f32), the top (u32), mid (u16)
  // and base (u8) tiers of both planes' tiles
  const size_t cells = (size_t)2 * depth * TILE_W;
  const size_t mcells = cells / mg, tcells = cells / tg;
  const size_t smem = (2 * cells + 2 * mcells) * sizeof(float)
                      + tcells * sizeof(uint32_t)
                      + mcells * sizeof(uint16_t) + cells;
  cudaError_t err = allow_smem(cm_tier2_count_kernel, bin_smem);
  if (err == cudaSuccess)
    err = allow_smem(cm_tier2_scatter_kernel, 3 * bin_smem);
  if (err == cudaSuccess) err = allow_smem(cm_tier2_kernel, smem);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(counts, 0, 2 * bin_smem, stream);
  if (err != cudaSuccess) return (int)err;
  const int bin_blocks = (n + BIN_THREADS - 1) / BIN_THREADS;
  cm_tier2_count_kernel<<<bin_blocks, BIN_THREADS, bin_smem, stream>>>(
      h1, h2, counts, n, depth, width, n_tiles);
  cm_tier2_scatter_kernel<<<bin_blocks, BIN_THREADS, 3 * bin_smem, stream>>>(
      h1, h2, counts, cursors, entries, n, depth, width, n_tiles);
  TierPlane pa = {base_a, mid_a, top_a};
  TierPlane pb = {base_b, mid_b, top_b};
  cm_tier2_kernel<<<n_tiles, TIER2_THREADS, smem, stream>>>(
      pa, pb, h1, h2, va, vb, counts, entries, q, n, depth, width, mg, tg,
      (float)unit_a, (float)unit_b);
  cm_tier2_est_kernel<<<(n + EST_THREADS - 1) / EST_THREADS, EST_THREADS, 0,
                        stream>>>(q, est, n, depth);
  return (int)cudaGetLastError();
}
