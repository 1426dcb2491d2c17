// Holds the NVFP4 kernels' rounding to nearest (csrc/nvfp4.cuh
// fp4_grid_rn) to the rule it replaced: the table walk below, the body of
// the kernels' earlier fp4_round copied as it was. Every f32 of magnitude
// at most 8 of both signs, +-inf and four quiet NaNs go through both;
// the new grid value, its sign included, must be the e4m3 value of the
// rule's byte bit for bit (the kernel turns it into that byte by an exact
// conversion). Prints the count of patterns and of differences, and the
// first few differences; exits 1 on any. Signaling NaNs are left out:
// the host's fminf quiets them where the card's returns the other operand
// (6), which both forms share.
//
//   g++ -std=c++20 -O2 -pthread -ffp-contract=off -w -I include -I CSRC \
//       nvfp4_sweep.cpp sim.cpp -o nvfp4_sweep && ./nvfp4_sweep [THREADS]
#include "cuda_shim.h"
#include "nvfp4.cuh"

namespace {

// The rule: round to nearest on the grid; a value on a bound goes up where
// the bound's index is odd (qmath._FP4_TIE_UP); |y| clipped to 6; the
// e4m3 byte of the grid value with y's sign.
uint8_t rule_byte(float y) {
  const float ax = fminf(fabsf(y), 6.f);
  const float bounds[7] = {0.25f, 0.75f, 1.25f, 1.75f, 2.5f, 3.5f, 5.f};
  int lo = 0, hi = 0;
  for (int b = 0; b < 7; ++b) {
    lo += ax > bounds[b];
    hi += ax >= bounds[b];
  }
  const int idx = (lo != hi && (lo & 1)) ? hi : lo;
  const int mag = idx < 2 ? idx * 48 : idx * 4 + 48;
  return static_cast<uint8_t>(mag | (signbit(y) ? 0x80 : 0));
}

uint32_t e4m3_bits[256];

bool same(uint32_t pattern) {
  const float y = __uint_as_float(pattern);
  return __float_as_uint(nvfp4::fp4_grid_rn(y)) ==
         e4m3_bits[rule_byte(y)];
}

}  // namespace

int main(int argc, char** argv) {
  const unsigned threads = argc > 1 ? std::atoi(argv[1]) : 4;
  for (int c = 0; c < 256; ++c)
    e4m3_bits[c] = __float_as_uint(sim_fp8_to_float(uint8_t(c), 0));
  const uint64_t top = 0x41000000u;  // the bits of 8.0f
  const uint64_t total = 2 * (top + 1);
  std::atomic<uint64_t> diffs{0};
  std::mutex mu;
  std::vector<uint32_t> shown;
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < threads; ++t)
    pool.emplace_back([&, t]() {
      uint64_t local = 0;
      for (uint64_t k = t; k < total; k += threads) {
        const uint32_t p = static_cast<uint32_t>(k >> 1) |
                           (static_cast<uint32_t>(k & 1) << 31);
        if (same(p)) continue;
        ++local;
        std::lock_guard<std::mutex> g(mu);
        if (shown.size() < 8) shown.push_back(p);
      }
      diffs += local;
    });
  for (auto& th : pool) th.join();
  const uint32_t specials[] = {0x7F800000u, 0xFF800000u, 0x7FC00000u,
                               0xFFC00000u, 0x7FFFFFFFu, 0xFFFFFFFFu};
  for (uint32_t p : specials)
    if (!same(p)) {
      ++diffs;
      if (shown.size() < 8) shown.push_back(p);
    }
  const uint64_t checked = total + sizeof(specials) / sizeof(specials[0]);
  printf("nvfp4 rounding sweep: %llu patterns, %llu differ\n",
         static_cast<unsigned long long>(checked),
         static_cast<unsigned long long>(diffs.load()));
  for (uint32_t p : shown) {
    const float y = __uint_as_float(p);
    printf("  y 0x%08x (%g): new 0x%08x, rule byte 0x%02x\n", p, y,
           __float_as_uint(nvfp4::fp4_grid_rn(y)), rule_byte(y));
  }
  return diffs.load() ? 1 : 0;
}
