// The arithmetic of the NVFP4 kernels (csrc/nvfp4_quantize.cu), bit-exact
// to quantize/qmath.py and quantize/hadamard.py: the RHT of a run of 16
// with its signs folded in, the rounding onto the e2m1 grid (to nearest,
// or stochastically) and the quantize of one block of 16 under its tensor
// scale. Kept apart from the kernels so that a host program can hold the
// rounding to its rule over every f32 (tools/flash_host_sim).
#pragma once

#include "common.cuh"

namespace nvfp4 {

// The RHT of one run v[0..15] (quantize/hadamard.py rotate with
// rht_matrix(mask)), in place:
//   out[j] = (s_0(j) + s_1(j)) + (s_2(j) + s_3(j)),
//   s_r(j) = (((0 + t_r,j) + t_r+4,j) + t_r+8,j) + t_r+12,j,
//   t_i,j  = v_i * h_i,j, h_i,j = +-1/4 with the sign (-1)^popc(i & j),
//            negated where bit i of the mask is set.
// Round to nearest is symmetric, so t_i,j = (-1)^popc(i & j) u_i with
// u_i = v_i * (+-1/4) (the mask's sign folded in once). With i = r + 4k
// and j = jl + 4 jh the sign splits into (-1)^popc(r & jl) and
// (-1)^popc(k & jh): s_r(j) is Q_r(jh), the same ordered sum with the
// k-signs only, or 0 - Q_r(jh) where popc(r & jl) is odd (negating every
// term of a sum from +0 negates its nonzero results, and its zeros are
// +0 either way: no partial sum from +0 is ever -0). The 16 sums of 4 then
// serve all 16 outputs, and since no s_r is -0, s_a + (0 - s_b) is
// s_a - s_b and (0 - a) + (0 - b) is 0 - (a + b): with A = Q0 + Q1,
// B = Q0 - Q1, C = Q2 + Q3 and D = Q2 - Q3 of one jh, the outputs
// jl = 0..3 are A + C, B + D, A - C and B - D. Every operation rounds on
// its own: 16 products and 76 sums for 16 values.
__device__ __forceinline__ void rht16(float (&v)[16], int mask) {
  float u[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    u[i] = __fmul_rn(v[i], (mask >> i) & 1 ? -0.25f : 0.25f);
  float q[4][4];  // q[jh][r] = Q_r(jh)
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float a = __fadd_rn(0.f, u[r]);
    const float p = __fadd_rn(a, u[r + 4]), n = __fsub_rn(a, u[r + 4]);
    q[0][r] = __fadd_rn(__fadd_rn(p, u[r + 8]), u[r + 12]);
    q[1][r] = __fsub_rn(__fadd_rn(n, u[r + 8]), u[r + 12]);
    q[2][r] = __fsub_rn(__fsub_rn(p, u[r + 8]), u[r + 12]);
    q[3][r] = __fadd_rn(__fsub_rn(n, u[r + 8]), u[r + 12]);
  }
#pragma unroll
  for (int jh = 0; jh < 4; ++jh) {
    const float a = __fadd_rn(q[jh][0], q[jh][1]);
    const float b = __fsub_rn(q[jh][0], q[jh][1]);
    const float c = __fadd_rn(q[jh][2], q[jh][3]);
    const float d = __fsub_rn(q[jh][2], q[jh][3]);
    v[4 * jh] = __fadd_rn(a, c);
    v[4 * jh + 1] = __fadd_rn(b, d);
    v[4 * jh + 2] = __fsub_rn(a, c);
    v[4 * jh + 3] = __fsub_rn(b, d);
  }
}

// Round to nearest onto the e2m1 grid {0, 0.5, 1, 1.5, 2, 3, 4, 6}, |y|
// clipped to 6 (NaN to 6, as fminf gives), y's sign kept (a negative y
// that rounds to 0 is -0). The reference's table (qmath._FP4_BOUNDS, a
// value on a bound going up where the bound's index is odd) is round half
// to even of the grid index, which is IEEE rounding in ax's binade: the
// grid's spacing is 0.5 below 2, 1 in [2, 4) and 2 in [4, 6], so adding
// and subtracting 2^(e + 22), e = max(exponent of ax, 0), an f32 whose ulp
// is that spacing, rounds ax onto the grid with ties to even. Both sums
// are exact but for the rounding that is wanted.
__device__ __forceinline__ float fp4_grid_rn(float y) {
  const float ax = fminf(fabsf(y), 6.f);
  const int e = max(static_cast<int>(__float_as_uint(ax) & 0x7F800000u),
                    0x3F800000);
  const float big = __uint_as_float(static_cast<uint32_t>(e) + (22u << 23));
  const float g = __fsub_rn(__fadd_rn(ax, big), big);
  return __uint_as_float(__float_as_uint(g) |
                         (__float_as_uint(y) & 0x80000000u));
}

// The e4m3 bytes of two grid values (each an e4m3 value, so the
// conversion is exact), the first in the low byte.
__device__ __forceinline__ uint32_t fp4_pair(float a, float b) {
  return __nv_cvt_float2_to_fp8x2(make_float2(a, b), __NV_SATFINITE,
                                  __NV_E4M3);
}

__device__ __forceinline__ float fp4_value(int idx) {
  switch (idx) {
    case 0: return 0.f;
    case 1: return 0.5f;
    case 2: return 1.f;
    case 3: return 1.5f;
    case 4: return 2.f;
    case 5: return 3.f;
    case 6: return 4.f;
    default: return 6.f;
  }
}

// The e4m3 byte of the e2m1 magnitude with index idx (0x00, 0x30, 0x38,
// 0x3C, 0x40, 0x44, 0x48, 0x4C), with the sign of y.
__device__ __forceinline__ uint8_t fp4_byte(int idx, float y) {
  const int mag = idx < 2 ? idx * 48 : idx * 4 + 48;
  return static_cast<uint8_t>(mag | (signbit(y) ? 0x80 : 0));
}

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// Stochastic rounding between the two grid neighbours of |y|
// (qmath._stochastic_cast_fp4): up with probability (|y| - lo) / (up - lo).
__device__ __forceinline__ uint8_t fp4_round_sr(float y, uint32_t bits) {
  const float ax = fminf(fabsf(y), 6.f);
  int il = -1;
#pragma unroll
  for (int i = 0; i < 8; ++i) il += ax >= fp4_value(i);
  il = min(max(il, 0), 7);
  const int iu = min(il + 1, 7);
  const float lo = fp4_value(il), up = fp4_value(iu);
  const float p = up > lo
      ? __fdiv_rn(__fsub_rn(ax, lo), fmaxf(__fsub_rn(up, lo), 0x1p-126f))
      : 0.f;
  const float u = __fmul_rn(static_cast<float>(bits >> 8), 0x1p-24f);
  return fp4_byte(u < p ? iu : il, y);
}

// One block of 16 (qmath.nvfp4_encode): its 16 code bytes into `codes`
// (byte i the code of v[i]) and its e4m3 scale byte returned:
//   s_e4m3 = e4m3(clip((bamax / 6) / ts, +-448)), s_eff = s_e4m3 * ts,
//   inv = s_eff > 0 ? 1 / max(s_eff, 2^-126) : 0, y = v * inv.
// With kSr, y rounds stochastically from lowbias32((index + i) ^ key),
// `index` being the payload index of v[0].
template <bool kSr>
__device__ __forceinline__ uint8_t quantize16(const float (&v)[16], float ts,
                                              uint32_t key, uint32_t index,
                                              uint4& codes) {
  float bamax = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) bamax = fmaxf(bamax, fabsf(v[i]));
  const float q = fminf(fmaxf(__fdiv_rn(__fdiv_rn(bamax, 6.f), ts), -448.f),
                        448.f);
  const __nv_fp8_storage_t s8 =
      __nv_cvt_float_to_fp8(q, __NV_SATFINITE, __NV_E4M3);
  const float s_e4m3 = __half2float(__half(__nv_cvt_fp8_to_halfraw(
      s8, __NV_E4M3)));
  const float s_eff = __fmul_rn(s_e4m3, ts);
  const float inv = s_eff > 0.f ? __fdiv_rn(1.f, fmaxf(s_eff, 0x1p-126f))
                                : 0.f;
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (kSr) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = 4 * k + b;
        word |= static_cast<uint32_t>(fp4_round_sr(
                    __fmul_rn(v[i], inv), lowbias32((index + i) ^ key)))
                << (8 * b);
      }
      w[k] = word;
    } else {
      const uint32_t lo =
          fp4_pair(fp4_grid_rn(__fmul_rn(v[4 * k], inv)),
                   fp4_grid_rn(__fmul_rn(v[4 * k + 1], inv)));
      const uint32_t hi =
          fp4_pair(fp4_grid_rn(__fmul_rn(v[4 * k + 2], inv)),
                   fp4_grid_rn(__fmul_rn(v[4 * k + 3], inv)));
      w[k] = lo | (hi << 16);
    }
  }
  codes = make_uint4(w[0], w[1], w[2], w[3]);
  return s8;
}

}  // namespace nvfp4
