// Host simulation of ptx.cuh's instructions (warp-wide through sim::Warp).
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace simptx {
inline float bf(uint16_t b) { uint32_t u = uint32_t(b) << 16; float f; memcpy(&f, &u, 4); return f; }
inline uint16_t half_of(uint32_t r, int hi) { return hi ? uint16_t(r >> 16) : uint16_t(r & 0xffff); }
inline void ldm(uint32_t (&r)[4], const void* p, bool trans) {
  auto& w = sim::warp(); unsigned l = sim::lane();
  if (reinterpret_cast<uintptr_t>(p) % 16) sim::fail("ldmatrix row address not 16-byte aligned");
  sim::check_smem(p, 16);
  w.x[l][0] = reinterpret_cast<uintptr_t>(p);
  w.bar.arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    if (!trans) {
      const unsigned char* row = reinterpret_cast<const unsigned char*>(w.x[i * 8 + l / 4][0]);
      memcpy(&r[i], row + 4 * (l % 4), 4);
    } else {
      const int c = l / 4, r0 = 2 * (l % 4);
      uint16_t lo, hi;
      memcpy(&lo, reinterpret_cast<const unsigned char*>(w.x[i * 8 + r0][0]) + 2 * c, 2);
      memcpy(&hi, reinterpret_cast<const unsigned char*>(w.x[i * 8 + r0 + 1][0]) + 2 * c, 2);
      r[i] = uint32_t(lo) | (uint32_t(hi) << 16);
    }
  }
  w.bar.arrive_and_wait();
}
}  // namespace simptx

inline void ldmatrix_x4(uint32_t (&r)[4], const void* p) { simptx::ldm(r, p, false); }
inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) { simptx::ldm(r, p, true); }

inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  auto& w = sim::warp(); unsigned l = sim::lane();
  for (int i = 0; i < 4; ++i) w.x[l][i] = a[i];
  w.x[l][4] = b0; w.x[l][5] = b1;
  w.bar.arrive_and_wait();
  const int g = l / 4, t = l % 4;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    float sum = 0.f;
    for (int kk = 0; kk < 16; ++kk) {
      const int areg = (row >= 8) + 2 * (kk >= 8), alane = (row % 8) * 4 + (kk % 8) / 2;
      const int breg = 4 + (kk >= 8), blane = col * 4 + (kk % 8) / 2;
      const float av = simptx::bf(simptx::half_of(uint32_t(w.x[alane][areg]), kk % 2));
      const float bv = simptx::bf(simptx::half_of(uint32_t(w.x[blane][breg]), kk % 2));
      sum += av * bv;
    }
    d[e] += sum;
  }
  w.bar.arrive_and_wait();
}

inline void cp_async16(void* dst, const void* src, bool valid) {
  if (reinterpret_cast<uintptr_t>(dst) % 16 || reinterpret_cast<uintptr_t>(src) % 16) sim::fail("cp.async not 16-byte aligned");
  sim::check_smem(dst, 16);
  if (valid) memcpy(dst, src, 16); else memset(dst, 0, 16);
}
inline uint4 ldg_stream(const void* p) { uint4 v; memcpy(&v, p, 16); return v; }
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}

inline uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  const uint64_t pool = uint64_t(a) | (uint64_t(b) << 32);
  uint32_t d = 0;
  for (int i = 0; i < 4; ++i) {
    const unsigned s = (sel >> (4 * i)) & 15u;
    uint32_t byte = uint32_t(pool >> (8 * (s & 7u))) & 0xffu;
    if (s & 8u) byte = (byte & 0x80u) ? 0xffu : 0u;
    d |= byte << (8 * i);
  }
  return d;
}
namespace simptx {
// The f16 bits of a value that f16 holds exactly (or NaN).
inline uint16_t f16_bits(float f) {
  const uint16_t s = std::signbit(f) ? 0x8000 : 0;
  const float a = std::fabs(f);
  if (std::isnan(f)) return 0x7e00;
  if (a == 0.f) return s;
  int e;
  const float m = std::frexp(a, &e);  // a = m 2^e, m in [0.5, 1)
  const int E = e - 1 + 15;
  if (E >= 1) return s | uint16_t(E << 10) | uint16_t((m * 2.f - 1.f) * 1024.f);
  return s | uint16_t(a * 16777216.f);
}
}  // namespace simptx
inline uint32_t cvt_f16x2_e4m3x2(uint32_t pair) {
  return uint32_t(simptx::f16_bits(sim_fp8_to_float(pair & 0xffu, 0))) |
         (uint32_t(simptx::f16_bits(sim_fp8_to_float((pair >> 8) & 0xffu, 0))) << 16);
}
inline uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d = 0;
  for (int h = 0; h < 2; ++h) {
    const float p = simptx::bf(simptx::half_of(a, h)) * simptx::bf(simptx::half_of(b, h));
    d |= uint32_t(__float2bfloat16(p).x) << (16 * h);
  }
  return d;
}
