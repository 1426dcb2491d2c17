// Host simulation of ptx.cuh's instructions (warp-wide through sim::Warp).
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

#include <chrono>
#include <optional>

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

// The bulk copies and mbarriers: a copy lands at once and counts its bytes
// off the barrier. An mbarrier's state in its 8 bytes: completed phases
// (bits 0-7), the arrival count (8-15), arrivals pending (16-23), bytes
// pending (24-55, signed) and a mark (56-63) that shows a use before init.
namespace simptx {
constexpr uint64_t kMbarMark = 0x5Bull;
inline void mbar_step(uint64_t* bar, unsigned arrivals, int64_t bytes) {
  std::lock_guard<std::mutex> g(sim::atomics_mutex());
  const uint64_t w = *bar;
  if ((w >> 56) != kMbarMark) sim::fail("mbarrier used before its init");
  unsigned phase = w & 0xff, count = (w >> 8) & 0xff, pending = (w >> 16) & 0xff;
  int64_t tx = int32_t(uint32_t(w >> 24)) + bytes;
  if (pending < arrivals) sim::fail("mbarrier: more arrivals than its count");
  pending -= arrivals;
  if (pending == 0 && tx == 0) { phase = (phase + 1) & 0xff; pending = count; }
  *bar = (kMbarMark << 56) | (uint64_t(uint32_t(int32_t(tx))) << 24) | (uint64_t(pending) << 16) | (uint64_t(count) << 8) | phase;
}
inline sim::Cluster& cluster() {
  if (sim::tl_block->cluster == nullptr) sim::fail("cluster primitive outside a cluster launch");
  return *sim::tl_block->cluster;
}
inline thread_local std::optional<std::barrier<>::arrival_token> cluster_token;
}  // namespace simptx

inline void mbar_init(uint64_t* bar, unsigned count) {
  sim::check_smem(bar, 8);
  if (reinterpret_cast<uintptr_t>(bar) % 8 || count < 1 || count > 255) sim::fail("mbarrier init");
  std::lock_guard<std::mutex> g(sim::atomics_mutex());
  *bar = (simptx::kMbarMark << 56) | (uint64_t(count) << 16) | (uint64_t(count) << 8);
}
inline void mbar_fence_init() {}
inline void mbar_arrive_expect(uint64_t* bar, unsigned bytes) { simptx::mbar_step(bar, 1, bytes); }
inline void mbar_wait(uint64_t* bar, unsigned parity) {
  // A phase that never completes (a copy into another tile, a missing
  // arrival) hangs the card; here it fails after 30 s.
  const auto give_up = std::chrono::steady_clock::now() + std::chrono::seconds(30);
  for (;;) {
    uint64_t w;
    {
      std::lock_guard<std::mutex> g(sim::atomics_mutex());
      w = *bar;
    }
    if ((w >> 56) != simptx::kMbarMark) sim::fail("mbarrier waited on before its init");
    if ((w & 1) != parity) return;
    if (std::chrono::steady_clock::now() > give_up) sim::fail("mbarrier phase never completed");
    std::this_thread::yield();
  }
}
inline void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  if (reinterpret_cast<uintptr_t>(dst) % 16 || reinterpret_cast<uintptr_t>(src) % 16 || bytes % 16 || bytes == 0) sim::fail("bulk copy not 16-byte aligned or sized");
  sim::check_smem(dst, bytes);
  memcpy(dst, src, bytes);
  simptx::mbar_step(bar, 0, -int64_t(bytes));
}
inline void fence_proxy_async() {}
inline unsigned cluster_rank() { simptx::cluster(); return sim::tl_block->rank; }
inline void cluster_sync() { simptx::cluster().bar->arrive_and_wait(); }
inline void cluster_arrive() {
  if (simptx::cluster_token) sim::fail("cluster arrive twice without a wait");
  simptx::cluster_token.emplace(simptx::cluster().bar->arrive());
}
inline void cluster_wait() {
  if (!simptx::cluster_token) sim::fail("cluster wait without an arrive");
  simptx::cluster().bar->wait(std::move(*simptx::cluster_token));
  simptx::cluster_token.reset();
}
template <typename T>
inline T* cluster_map(T* p, unsigned rank) {
  auto& cl = simptx::cluster();
  const unsigned char* c = reinterpret_cast<const unsigned char*>(p);
  if (c < sim::tl_block->smem || c + sizeof(T) > sim::tl_block->smem + sim::tl_block->smem_size) sim::fail("cluster_map of an address outside shared memory");
  if (rank >= cl.smem.size()) sim::fail("cluster_map to a rank outside the cluster");
  return reinterpret_cast<T*>(cl.smem[rank] + (c - sim::tl_block->smem));
}
