// The host simulation's runtime (see run.py): a grid runs block after
// block, each block's threads as std::threads over a fresh shared-memory
// buffer filled with a byte pattern (a read before a write shows) and
// guarded past its end; fp8 conversions by table; atomics under a lock.
#include "cuda_shim.h"
thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
namespace sim {
thread_local Block* tl_block = nullptr;
static cudaError_t err = cudaSuccess;
static std::mutex mu;
void fail(const char* what) { fprintf(stderr, "SIM FAIL: %s (block %u %u %u thread %u)\n", what, blockIdx.x, blockIdx.y, blockIdx.z, threadIdx.x); fflush(stderr); abort(); }
cudaError_t last_error() { cudaError_t e = err; err = cudaSuccess; return e; }
void run_grid(dim3 grid, dim3 block, size_t smem, const std::function<void()>& body) {
  const unsigned n = block.x * block.y * block.z;
  if (n > 1024 || smem > 232448) { err = cudaErrorInvalidValue; return; }
  const size_t guard = 256;
  std::vector<unsigned char> buf(smem + guard + 16);
  unsigned char* base = buf.data() + (16 - reinterpret_cast<uintptr_t>(buf.data()) % 16) % 16;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        memset(base, 0xA5, smem + guard);  // garbage: a read before a write shows
        std::barrier<> bar(n);
        std::vector<Warp> warps((n + 31) / 32);
        Block blk{&bar, warps.data(), base, smem};
        std::vector<std::thread> th;
        for (unsigned t = 0; t < n; ++t)
          th.emplace_back([&, t]() {
            threadIdx = dim3(t, 0, 0); blockIdx = dim3(bx, by, bz); blockDim = block; gridDim = grid;
            tl_block = &blk; body();
          });
        for (auto& x : th) x.join();
        for (size_t i = 0; i < guard; ++i) if (base[smem + i] != 0xA5) { fprintf(stderr, "SIM FAIL: shared memory written past its size\n"); abort(); }
      }
}
}  // namespace sim
int atomicMax(int* p, int v) { std::lock_guard<std::mutex> g(sim::mu); int o = *p; if (v > o) *p = v; return o; }
unsigned atomicAdd(unsigned* p, unsigned v) { std::lock_guard<std::mutex> g(sim::mu); unsigned o = *p; *p = o + v; return o; }
static float fp8_value(uint8_t c, int e5m2) {
  const int ebits = e5m2 ? 5 : 4, mbits = e5m2 ? 2 : 3, bias = e5m2 ? 15 : 7;
  const int s = c >> 7, e = (c >> mbits) & ((1 << ebits) - 1), m = c & ((1 << mbits) - 1);
  float v;
  if (!e5m2 && e == 15 && m == 7) v = NAN;
  else if (e5m2 && e == 31) v = m ? NAN : INFINITY;
  else if (e == 0) v = std::ldexp((float)m, 1 - bias - mbits);
  else v = std::ldexp(1.f + m / float(1 << mbits), e - bias);
  return s ? -v : v;
}
float sim_fp8_to_float(uint8_t c, int e5m2) { return fp8_value(c, e5m2); }
uint8_t sim_float_to_fp8(float f, int e5m2) {
  // nearest finite code, ties to the even code (f already clipped to range)
  if (std::isnan(f)) return e5m2 ? 0x7f : 0x7f;
  int best = -1; float bd = INFINITY;
  for (int c = 0; c < 256; ++c) {
    float v = fp8_value(c, e5m2);
    if (!std::isfinite(v)) continue;
    if ((c >> 7) != (std::signbit(f) ? 1 : 0)) continue;
    float d = std::fabs(v - f);
    if (d < bd || (d == bd && (c & 1) == 0)) { bd = d; best = c; }
  }
  return (uint8_t)best;
}
