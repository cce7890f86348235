// Shared tier-tile lanes of the two tier-interior kernels
// (countmin_tier2.cu, signal_fold_tiered.cu).
//
// Replaces netobserv_tpu/ops/pallas/tier_tiles.py (`decode_tile`,
// `promote_tile`, `unpack_reg_rows`, `pack_reg_rows`): one home for the
// tier arithmetic so the two kernels cannot drift from each other. Each
// function is the per-cell form of its twin in sketch/tiered.py, step for
// step: the same f32 adds in the same order, every rounding step upwards
// (ceil to the unit, u32 integer saturating add at the top), and the f32
// spill clamped to TOP_MAX before its cast to u32 (a float -> u32 cast of
// a value past 2^32 is undefined in CUDA).
//
// The constants are twins of sketch/tiered.py's BASE_MAX / MID_MAX /
// TOP_MAX; tests/test_torch_tiered.py reads them from this file and pins
// them against tiered.py.

#pragma once

#include <stdint.h>

constexpr int BASE_MAX = 255;
constexpr int MID_MAX = 65535;
constexpr uint32_t TOP_MAX = 1073741824u;  // 2^30

// tiered.decode_plane for one counter: base b, its mid cell m and its top
// cell t, in units, times the unit.
__device__ __forceinline__ float tier_decode(int b, int m, uint32_t t,
                                             float unit) {
  float mid_tot = __fadd_rn((float)m, m == MID_MAX ? __uint2float_rn(t)
                                                   : 0.0f);
  float units = __fadd_rn((float)b, b == BASE_MAX ? mid_tot : 0.0f);
  return unit > 1.0f ? __fmul_rn(units, unit) : units;
}

// tiered.plane_add's base step for one counter: the fold's delta
// new - dec, ceiled to the unit, onto base b. Writes the new base and
// returns the overflow that group-sums into mid. The unit is a power of two
// (TierSpec), so multiplying by inv_unit = 1 / unit is the division exactly.
__device__ __forceinline__ float tier_promote_base(int b, float dec,
                                                   float nw, float inv_unit,
                                                   uint8_t* base_out) {
  float du = ceilf(__fmul_rn(fmaxf(__fsub_rn(nw, dec), 0.0f), inv_unit));
  float s = __fadd_rn((float)b, du);
  float nb = fminf(s, (float)BASE_MAX);
  *base_out = (uint8_t)nb;
  return __fsub_rn(s, nb);
}

// tiered._spill's mid step for one mid cell: the group's summed overflow
// onto mid cell m. Writes the new mid and returns its overflow.
__device__ __forceinline__ float tier_promote_mid(uint16_t m, float gsum,
                                                  uint16_t* mid_out) {
  float s2 = __fadd_rn((float)m, gsum);
  float nm = fminf(s2, (float)MID_MAX);
  *mid_out = (uint16_t)nm;
  return __fsub_rn(s2, nm);
}

// tiered._spill's top step for one top cell: clamp the f32 spill before
// the cast, then a u32 saturating add against the room left.
__device__ __forceinline__ uint32_t tier_promote_top(uint32_t t,
                                                     float spill) {
  uint32_t inc = (uint32_t)fminf(spill, (float)TOP_MAX);
  uint32_t room = TOP_MAX - t;
  return t + (inc < room ? inc : room);
}

// tiered.unpack_hll for one packed triple: register 4t + r lives in bits
// 6r..6r+5 of the little-endian 24-bit word of bytes 3t..3t+2.
__device__ __forceinline__ void tier_unpack_triple(const uint8_t* p,
                                                   int* regs4) {
  uint32_t v = (uint32_t)p[0] | ((uint32_t)p[1] << 8)
               | ((uint32_t)p[2] << 16);
#pragma unroll
  for (int r = 0; r < 4; ++r) regs4[r] = (int)((v >> (6 * r)) & 63u);
}

// tiered.pack_hll for one triple: lossless while every rank is <= 63.
__device__ __forceinline__ void tier_pack_triple(const int* regs4,
                                                 uint8_t* p) {
  uint32_t v = (uint32_t)regs4[0] | ((uint32_t)regs4[1] << 6)
               | ((uint32_t)regs4[2] << 12) | ((uint32_t)regs4[3] << 18);
  p[0] = (uint8_t)(v & 0xFFu);
  p[1] = (uint8_t)((v >> 8) & 0xFFu);
  p[2] = (uint8_t)((v >> 16) & 0xFFu);
}
