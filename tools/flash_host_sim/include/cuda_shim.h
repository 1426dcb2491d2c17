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

struct dim3 { unsigned x, y, z; constexpr dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint4 { unsigned x, y, z, w; };
struct uint2 { unsigned x, y; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }

extern thread_local dim3 threadIdx, blockIdx;
extern thread_local dim3 blockDim, gridDim;

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorLaunchFailure = 719 };
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

namespace sim {
struct Warp { std::barrier<> bar{32}; uint64_t x[32][8]; };
struct Block { std::barrier<>* bar; Warp* warps; unsigned char* smem; size_t smem_size; };
extern thread_local Block* tl_block;
inline Warp& warp() { return tl_block->warps[threadIdx.x >> 5]; }
inline unsigned lane() { return threadIdx.x & 31; }
inline void* smem() { return tl_block->smem; }
void fail(const char* what);
inline void check_smem(const void* p, size_t n) {
  const unsigned char* c = static_cast<const unsigned char*>(p);
  if (c < tl_block->smem || c + n > tl_block->smem + tl_block->smem_size) fail("shared access out of range");
}
void run_grid(dim3 grid, dim3 block, size_t smem, const std::function<void()>& body);
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
int atomicMax(int* p, int v);
unsigned atomicAdd(unsigned* p, unsigned v);
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
template <typename T> inline T __ldcg(const T* p) { return *p; }
inline cudaError_t cudaGetLastError() { return sim::last_error(); }
inline bool __all_sync(unsigned, bool v) {
  auto& w = sim::warp(); unsigned l = sim::lane();
  w.x[l][6] = v; w.bar.arrive_and_wait();
  bool all = true; for (int i = 0; i < 32; ++i) all = all && w.x[i][6];
  w.bar.arrive_and_wait(); return all;
}
