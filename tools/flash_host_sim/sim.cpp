// The host simulation's runtime (see run.py): a grid runs block after
// block, each block's threads as std::threads over a fresh shared-memory
// buffer filled with a byte pattern (a read before a write shows) and
// guarded past its end; fp8 conversions by table; atomics under a lock.
#include "cuda_shim.h"
#include <memory>
thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
namespace sim {
thread_local Block* tl_block = nullptr;
static cudaError_t err = cudaSuccess;
static std::mutex mu;
void fail(const char* what) { fprintf(stderr, "SIM FAIL: %s (block %u %u %u thread %u)\n", what, blockIdx.x, blockIdx.y, blockIdx.z, threadIdx.x); fflush(stderr); abort(); }
cudaError_t last_error() { cudaError_t e = err; err = cudaSuccess; return e; }
std::mutex& atomics_mutex() { return mu; }
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
void run_cluster_grid(dim3 grid, dim3 block, size_t smem, unsigned cdim, const std::function<void()>& body) {
  const unsigned n = block.x * block.y * block.z;
  if (n > 1024 || smem > 232448 || cdim < 1 || cdim > 8 || grid.x % cdim) { err = cudaErrorInvalidValue; return; }
  const size_t guard = 256;
  std::vector<std::vector<unsigned char>> bufs(cdim, std::vector<unsigned char>(smem + guard + 16));
  std::vector<unsigned char*> bases(cdim);
  for (unsigned b = 0; b < cdim; ++b) bases[b] = bufs[b].data() + (16 - reinterpret_cast<uintptr_t>(bufs[b].data()) % 16) % 16;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned cx = 0; cx < grid.x / cdim; ++cx) {
        for (unsigned b = 0; b < cdim; ++b) memset(bases[b], 0xA5, smem + guard);
        std::barrier<> cbar(cdim * n);
        Cluster cl{&cbar, bases};
        std::vector<std::unique_ptr<std::barrier<>>> bars;
        std::vector<std::vector<Warp>> warps(cdim);
        std::vector<Block> blks;
        for (unsigned b = 0; b < cdim; ++b) {
          bars.push_back(std::make_unique<std::barrier<>>(n));
          warps[b] = std::vector<Warp>((n + 31) / 32);
        }
        for (unsigned b = 0; b < cdim; ++b) blks.push_back(Block{bars[b].get(), warps[b].data(), bases[b], smem, b, &cl});
        std::vector<std::thread> th;
        for (unsigned b = 0; b < cdim; ++b)
          for (unsigned t = 0; t < n; ++t)
            th.emplace_back([&, b, t]() {
              threadIdx = dim3(t, 0, 0); blockIdx = dim3(cx * cdim + b, by, bz); blockDim = block; gridDim = grid;
              tl_block = &blks[b]; body();
            });
        for (auto& x : th) x.join();
        for (unsigned b = 0; b < cdim; ++b)
          for (size_t i = 0; i < guard; ++i) if (bases[b][smem + i] != 0xA5) { fprintf(stderr, "SIM FAIL: shared memory written past its size\n"); abort(); }
      }
}
}  // namespace sim
int atomicMax(int* p, int v) { std::lock_guard<std::mutex> g(sim::mu); int o = *p; if (v > o) *p = v; return o; }
unsigned atomicAdd(unsigned* p, unsigned v) { std::lock_guard<std::mutex> g(sim::mu); unsigned o = *p; *p = o + v; return o; }
unsigned atomicMax(unsigned* p, unsigned v) { std::lock_guard<std::mutex> g(sim::mu); unsigned o = *p; if (v > o) *p = v; return o; }
unsigned atomicExch(unsigned* p, unsigned v) { std::lock_guard<std::mutex> g(sim::mu); unsigned o = *p; *p = v; return o; }
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
// Each code's value, computed once.
static const float* fp8_table(int e5m2) {
  static const auto tables = [] {
    std::vector<float> t(512);
    for (int k = 0; k < 2; ++k)
      for (int c = 0; c < 256; ++c) t[256 * k + c] = fp8_value(uint8_t(c), k);
    return t;
  }();
  return tables.data() + 256 * (e5m2 ? 1 : 0);
}
float sim_fp8_to_float(uint8_t c, int e5m2) { return fp8_table(e5m2)[c]; }
uint8_t sim_float_to_fp8(float f, int e5m2) {
  // nearest finite code, ties to the even code: saturating, as SATFINITE
  if (std::isnan(f)) return e5m2 ? 0x7f : 0x7f;
  if (std::isinf(f)) f = std::copysign(3.0e38f, f);
  const float* table = fp8_table(e5m2);
  int best = -1; float bd = INFINITY;
  for (int c = 0; c < 256; ++c) {
    float v = table[c];
    if (!std::isfinite(v)) continue;
    if ((c >> 7) != (std::signbit(f) ? 1 : 0)) continue;
    float d = std::fabs(v - f);
    if (d < bd || (d == bd && (c & 1) == 0)) { bd = d; best = c; }
  }
  return (uint8_t)best;
}
