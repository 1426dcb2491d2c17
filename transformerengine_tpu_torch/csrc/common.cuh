// Shared helpers for the port's Hopper kernels: dtype codes that the
// Python wrappers pass through ctypes, conversions to f32, 16-byte loads
// and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Dtype codes; keep in step with DTYPE_CODES in _build.py.
enum DTypeCode { kFloat32 = 0, kBFloat16 = 1, kFloat8E4M3 = 2 };

// The JAX reference's mask and running-max floors (ops/flash_attention.py,
// ops/decode_attention.py).
constexpr float kNegInf = -1e30f;
constexpr float kMasked = -2e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch and XLA
}

// Round an f32 value to T's precision and back (the JAX kernels cast the
// softmax weights to V's dtype before the PV product).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// Widens the 16 / sizeof(T) elements of a 16-byte register vector to f32.
template <typename T>
__device__ __forceinline__ void widen16(const uint4& raw, float* out) {
  constexpr int kVec = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec; ++i) out[i] = to_float(e[i]);
}

// e4m3 pairs go through the two-wide hardware conversion to f16 (exact:
// every e4m3 value is an f16 value), half as many conversions as one by
// one.
template <>
__device__ __forceinline__ void widen16<__nv_fp8_e4m3>(const uint4& raw,
                                                       float* out) {
  const __nv_fp8x2_storage_t* pairs =
      reinterpret_cast<const __nv_fp8x2_storage_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 f =
        __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(pairs[i], __NV_E4M3)));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Loads 16 bytes (16 / sizeof(T) elements) from a 16-byte-aligned address
// and widens them to f32.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  widen16<T>(__ldg(reinterpret_cast<const uint4*>(p)), out);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Reductions over the 16 lanes of one half-warp.
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Raises the dynamic shared memory limit of `kernel` when it needs more
// than the 48 KB default.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
