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
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
