// Host stand-in for the CUDA headers the flash kernels include (see
// run.py): the qualifiers as macros, the vector, bf16 and fp8 types, the
// intrinsics they call, and the launch: each block's threads are
// std::threads, and warp collectives exchange through per-warp buffers
// between barriers.
#pragma once
#include <stdint.h>
#include <string.h>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <barrier>
#include <thread>
#include <vector>
#include <mutex>
#include <atomic>
#include <functional>
#include <type_traits>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
// A static __shared__ array becomes a static one: right while one block runs
// at a time (a plain grid), wrong for a cluster, whose blocks run at once
// (the cluster kernels keep their shared memory in extern arrays).
#define __shared__ static

struct dim3 { unsigned x, y, z; constexpr dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint4 { unsigned x, y, z, w; };
struct uint2 { unsigned x, y; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline float2 make_float2(float a, float b) { return {a, b}; }

extern thread_local dim3 threadIdx, blockIdx;
extern thread_local dim3 blockDim, gridDim;

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9, cudaErrorLaunchFailure = 719 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <typename K> inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return cudaSuccess; }
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
// An H100's 132 SMs, two blocks each.
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 132; return cudaSuccess; }
template <typename K> inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) { *n = 2; return cudaSuccess; }

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

inline float __int_as_float(int v) { float f; memcpy(&f, &v, 4); return f; }
inline int __float_as_int(float v) { int i; memcpy(&i, &v, 4); return i; }
inline float __uint_as_float(unsigned v) { float f; memcpy(&f, &v, 4); return f; }
inline unsigned __float_as_uint(float v) { unsigned u; memcpy(&u, &v, 4); return u; }
using std::signbit;
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline float __fdividef(float a, float b) { return a / b; }
template <typename T> inline T __ldg(const T* p) { return *p; }

// bf16
struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u; memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) { return __float2bfloat16(f); }
inline float __bfloat162float(__nv_bfloat16 b) { uint32_t u = uint32_t(b.x) << 16; float f; memcpy(&f, &u, 4); return f; }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {__float2bfloat16(a), __float2bfloat16(b)}; }

// fp8
typedef uint16_t __nv_fp8x2_storage_t;
enum __nv_fp8_interpretation_t { __NV_E4M3, __NV_E5M2 };
enum __nv_saturation_t { __NV_NOSAT, __NV_SATFINITE };
float sim_fp8_to_float(uint8_t c, int e5m2);
uint8_t sim_float_to_fp8(float f, int e5m2);
struct __nv_fp8_e4m3 { uint8_t __x; explicit operator float() const { return sim_fp8_to_float(__x, 0); } };
struct __nv_fp8_e5m2 { uint8_t __x; explicit operator float() const { return sim_fp8_to_float(__x, 1); } };
struct __half2_raw { float x, y; };
struct __half2 { float x, y; __half2() = default; __half2(__half2_raw r) : x(r.x), y(r.y) {} };
inline __half2_raw __nv_cvt_fp8x2_to_halfraw2(__nv_fp8x2_storage_t v, __nv_fp8_interpretation_t k) {
  return {sim_fp8_to_float(v & 0xff, k == __NV_E5M2), sim_fp8_to_float(v >> 8, k == __NV_E5M2)};
}
inline float2 __half22float2(__half2 h) { return {h.x, h.y}; }
inline uint8_t __nv_cvt_float_to_fp8(float f, __nv_saturation_t, __nv_fp8_interpretation_t k) { return sim_float_to_fp8(f, k == __NV_E5M2); }
inline __nv_fp8x2_storage_t __nv_cvt_float2_to_fp8x2(float2 f, __nv_saturation_t, __nv_fp8_interpretation_t k) {
  return __nv_fp8x2_storage_t(sim_float_to_fp8(f.x, k == __NV_E5M2) | (sim_float_to_fp8(f.y, k == __NV_E5M2) << 8));
}
typedef uint8_t __nv_fp8_storage_t;
struct __half_raw { float x; };
struct __half { float x; __half() = default; __half(__half_raw r) : x(r.x) {} };
inline __half_raw __nv_cvt_fp8_to_halfraw(__nv_fp8_storage_t v, __nv_fp8_interpretation_t k) { return {sim_fp8_to_float(v, k == __NV_E5M2)}; }
inline float __half2float(__half h) { return h.x; }

namespace sim {
struct Warp { std::barrier<> bar{32}; uint64_t x[32][8]; };
// A cluster's barrier over all its blocks' threads and its blocks' shared
// memory, by rank.
struct Cluster { std::barrier<>* bar; std::vector<unsigned char*> smem; };
struct Block { std::barrier<>* bar; Warp* warps; unsigned char* smem; size_t smem_size; unsigned rank = 0; Cluster* cluster = nullptr; };
extern thread_local Block* tl_block;
std::mutex& atomics_mutex();
inline Warp& warp() { return tl_block->warps[threadIdx.x >> 5]; }
inline unsigned lane() { return threadIdx.x & 31; }
inline void* smem() { return tl_block->smem; }
void fail(const char* what);
inline void check_smem(const void* p, size_t n) {
  const unsigned char* c = static_cast<const unsigned char*>(p);
  if (c < tl_block->smem || c + n > tl_block->smem + tl_block->smem_size) fail("shared access out of range");
}
void run_grid(dim3 grid, dim3 block, size_t smem, const std::function<void()>& body);
// A grid of clusters of `cdim` blocks along x: a cluster's blocks run at once.
void run_cluster_grid(dim3 grid, dim3 block, size_t smem, unsigned cdim, const std::function<void()>& body);
template <typename K>
struct Launcher {
  K kernel; dim3 grid, block; size_t smem;
  template <typename... A> void operator()(A... args) {
    run_grid(grid, block, smem, [&]() { kernel(args...); });
  }
};
template <typename K>
Launcher<K> launch(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t) { return {kernel, grid, block, smem}; }
template <typename K>
Launcher<K> launch(K kernel, dim3 grid, int block, size_t smem, cudaStream_t) { return {kernel, grid, dim3(block), smem}; }
cudaError_t last_error();
}  // namespace sim

inline void __syncthreads() { sim::tl_block->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { sim::warp().bar.arrive_and_wait(); }
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int o) {
  static_assert(sizeof(T) <= 8);
  auto& w = sim::warp(); unsigned l = sim::lane();
  uint64_t bits = 0; memcpy(&bits, &v, sizeof(T)); w.x[l][7] = bits;
  w.bar.arrive_and_wait();
  bits = w.x[l ^ o][7];
  w.bar.arrive_and_wait();
  T r; memcpy(&r, &bits, sizeof(T)); return r;
}
template <typename T>
inline T __shfl_sync(unsigned, T v, int src) {
  static_assert(sizeof(T) <= 8);
  auto& w = sim::warp(); unsigned l = sim::lane();
  uint64_t bits = 0; memcpy(&bits, &v, sizeof(T)); w.x[l][7] = bits;
  w.bar.arrive_and_wait();
  bits = w.x[src & 31][7];
  w.bar.arrive_and_wait();
  T r; memcpy(&r, &bits, sizeof(T)); return r;
}
int atomicMax(int* p, int v);
unsigned atomicMax(unsigned* p, unsigned v);
unsigned atomicAdd(unsigned* p, unsigned v);
unsigned atomicExch(unsigned* p, unsigned v);
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
template <typename T> inline T __ldcg(const T* p) { return *p; }
inline cudaError_t cudaGetLastError() { return sim::last_error(); }
inline bool __all_sync(unsigned, bool v) {
  auto& w = sim::warp(); unsigned l = sim::lane();
  w.x[l][6] = v; w.bar.arrive_and_wait();
  bool all = true; for (int i = 0; i < 32; ++i) all = all && w.x[i][6];
  w.bar.arrive_and_wait(); return all;
}

// cudaLaunchKernelEx with a cluster dimension (along x), and the occupancy
// API's clusters: 16 blocks at once over the cluster's size (two clusters
// of 8), so that small shapes make persistent clusters walk several strips.
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue { struct { unsigned x, y, z; } clusterDim; };
struct cudaLaunchAttribute { cudaLaunchAttributeID id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim; size_t dynamicSmemBytes; cudaStream_t stream;
  cudaLaunchAttribute* attrs; unsigned numAttrs;
};
namespace sim {
inline unsigned cluster_dim(const cudaLaunchConfig_t* c) {
  for (unsigned i = 0; i < c->numAttrs; ++i)
    if (c->attrs[i].id == cudaLaunchAttributeClusterDimension) {
      if (c->attrs[i].val.clusterDim.y != 1 || c->attrs[i].val.clusterDim.z != 1) fail("cluster dimension other than along x");
      return c->attrs[i].val.clusterDim.x;
    }
  return 1;
}
}  // namespace sim
template <typename K>
inline cudaError_t cudaOccupancyMaxActiveClusters(int* n, K, const cudaLaunchConfig_t* c) {
  *n = c->dynamicSmemBytes > 232448 ? 0 : 16 / (int)sim::cluster_dim(c);
  return cudaSuccess;
}
template <typename... E, typename... A>
inline cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* c, void (*kernel)(E...), A&&... args) {
  sim::run_cluster_grid(c->gridDim, c->blockDim, c->dynamicSmemBytes, sim::cluster_dim(c), [&]() { kernel(args...); });
  return sim::last_error();
}
