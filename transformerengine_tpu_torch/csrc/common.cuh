// Shared helpers for the port's Hopper kernels: dtype codes that the
// Python wrappers pass through ctypes, conversions to f32, 16-byte loads
// and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

// Dtype codes; keep in step with DTYPE_CODES in _build.py.
enum DTypeCode { kFloat32 = 0, kBFloat16 = 1, kFloat8E4M3 = 2, kFloat8E5M2 = 3 };

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
__device__ __forceinline__ float to_float(__nv_fp8_e5m2 v) {
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

// e5m2 pairs likewise (every e5m2 value is an f16 value).
template <>
__device__ __forceinline__ void widen16<__nv_fp8_e5m2>(const uint4& raw,
                                                       float* out) {
  const __nv_fp8x2_storage_t* pairs =
      reinterpret_cast<const __nv_fp8x2_storage_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 f =
        __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(pairs[i], __NV_E5M2)));
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

// The per-tensor FP8 cast of quantize/qmath.py: clip to +-q_max, then
// round to nearest even (the clip comes first, so saturation never
// decides a value).
struct Fp8Cast {
  float q_max;
  __nv_fp8_interpretation_t kind;
  __host__ __device__ explicit Fp8Cast(int e5m2)
      : q_max(e5m2 ? 57344.f : 448.f), kind(e5m2 ? __NV_E5M2 : __NV_E4M3) {}
  __device__ __forceinline__ uint8_t operator()(float y) const {
    y = fminf(fmaxf(y, -q_max), q_max);
    return __nv_cvt_float_to_fp8(y, __NV_SATFINITE, kind);
  }
};

// Stores v as element i of a tensor of dtype `code` (a DTypeCode): f32,
// bf16 rounded to nearest even, or fp8 through Fp8Cast (clip, then round
// to nearest even).
__device__ __forceinline__ void store_as(void* p, int code, size_t i,
                                         float v) {
  switch (code) {
    case kFloat32:
      static_cast<float*>(p)[i] = v;
      break;
    case kBFloat16:
      static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
      break;
    default:
      static_cast<uint8_t*>(p)[i] = Fp8Cast(code == kFloat8E5M2)(v);
      break;
  }
}

// The FP8 attention branch: Q/K/V arrive as e4m3 payloads, and the softmax
// weights and score gradients round to bf16 (not to the payloads' type)
// before their products.
template <typename T>
constexpr bool kIsFp8 = std::is_same<T, __nv_fp8_e4m3>::value;
template <typename T>
using RoundT = typename std::conditional<kIsFp8<T>, __nv_bfloat16, T>::type;

// Block-wide max of a non-negative value per thread into *out (which
// the caller zeroed): an atomicMax on the f32 bit pattern, exact because
// the order of a max does not matter. `scratch` holds one float per warp.
__device__ __forceinline__ void block_amax_to(float v, float* scratch,
                                              float* out) {
  v = warp_max(v);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, scratch[w]);
    atomicMax(reinterpret_cast<int*>(out), __float_as_int(m));
  }
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

// The blocks of `kernel` (`threads` threads, `smem` bytes of shared memory)
// that the card holds at once: its SMs times the blocks an SM takes.
template <typename Kernel>
inline int resident_blocks(Kernel kernel, int threads, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  return sms * per_sm > 0 ? sms * per_sm : 1;
}

// Attention dropout (the reference's `_dropout_keep`, its integer hash):
// the score of query i, key j and query head h of batch b is kept when
// hash(seed, b, h / G, the reference's tile origin (i - i % bq, j - j % bk),
// row (h % G) * bq + i % bq, column j % bk) >= thr, with the reference's
// tile sizes (bq, bk) (its `_effective_blocks`), never this kernel's; a
// kept value is multiplied by `inv`. Every kernel derives the same bits
// for a score, so the backward replays the forward's mask.
struct Dropout {
  const int* seed;  // the two seed words, (2,) int32 on the card, or null
  unsigned thr;     // keep where the hash >= thr
  float inv;        // 1 / (1 - rate), rounded to f32
  int bq, bk;       // the reference's tile sizes
};

// A row's or a column's share of the hash: its index within the
// reference's tile, multiplied, and its tile origin's term (for a row with
// the seed, batch and kv head folded in).
struct DropPart {
  uint32_t idx, origin;
};

// The seed, batch and kv head terms of the hash, summed mod 2^32.
__device__ __forceinline__ uint32_t drop_head(const Dropout& d, int b,
                                              int hk) {
  return (uint32_t)__ldg(d.seed) * 0xC2B2AE35u + (uint32_t)__ldg(d.seed + 1) +
         (uint32_t)b * 0x27D4EB2Fu + (uint32_t)hk * 0x165667B1u;
}

// Query qi of the g-th query head of its GQA group.
__device__ __forceinline__ DropPart drop_row(const Dropout& d, uint32_t head,
                                             int g, int qi) {
  const int r = qi % d.bq;
  return {(uint32_t)(g * d.bq + r) * 0x9E3779B9u,
          head + (uint32_t)(qi - r) * 0x9E3779B1u};
}

__device__ __forceinline__ DropPart drop_col(const Dropout& d, int kj) {
  const int c = kj % d.bk;
  return {(uint32_t)c * 0x85EBCA6Bu, (uint32_t)(kj - c) * 0x85EBCA77u};
}

// The reference's hash: its two index products, the terms' sum, then the
// finalizer; uint32 arithmetic wraps as the reference's does.
__device__ __forceinline__ bool drop_keep(const Dropout& d, DropPart row,
                                          DropPart col) {
  uint32_t x = (row.idx ^ col.idx) ^ (row.origin + col.origin);
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= d.thr;
}

// where(keep, v * inv, 0), the product rounded on its own (no contraction
// into a later add), as the reference's f32 operations.
__device__ __forceinline__ float drop_apply(const Dropout& d, bool keep,
                                            float v) {
  return keep ? __fmul_rn(v, d.inv) : 0.f;
}

// The flash kernels' score terms (the reference's `_fwd_block_body`,
// `_bwd_dq_block_body` and `_bwd_dkv_block_body`): a post-scale bias, ALiBi
// or the soft cap. At most one of the three is set, and none with FP8 Q/K/V.
// The dropout instances read `drop` too.
struct ScoreTerms {
  const void* bias;     // (bias_b, Hq, Sq, Skv), f32 or bf16, or null
  int bias_code;        // its DTypeCode
  int bias_b;           // 1 (broadcast over the batch) or B
  const float* slopes;  // (Hq,) f32 ALiBi slopes, or null
  float scale;          // the softmax scale (ALiBi's and the cap's q is
                        // not pre-scaled)
  float cap;            // the soft cap (> 0), or 0 for none
  Dropout drop;         // dropout (its seed null without)
};

// Which score terms a flash kernel instance computes, a template argument
// of each kernel: none, a bias or ALiBi (chosen at run time by which
// pointer is set), or the soft cap. Each kind is an instance of its own,
// so a kernel without a kind compiles as it would without the code.
enum TermsKind { kNoTerms = 0, kBiasAlibi = 1, kSoftCap = 2 };

// Score s of query qi (bottom-right offset `offset`) and key kj in head h
// of sequence b, in the exp2 domain.
// - kBiasAlibi, with a bias: s comes from pre-scaled q and becomes
//   s + bias * log2(e); with ALiBi, s is the unscaled q . k and becomes
//   (s * scale - slope_h * |qi + offset - kj|) * log2(e). Positions past
//   Sq or Skv read no bias: the mask replaces them.
// - kSoftCap (the reference's `soft_cap_mod`, Gemma-2's logit cap): s is
//   the unscaled q . k and becomes cap * tanh(s * scale / cap) * log2(e),
//   and `th` takes tanh(...) for the backward's derivative. The order is
//   the reference's jaxpr (`score_mod(s * scale) * LOG2E` with the mod
//   `cap * jnp.tanh(score / cap)`): a true division (not a product with
//   1 / cap) and CUDA's tanhf (no fast math).
// Each operation rounds on its own as the reference's f32 ops (no
// contraction into an FMA).
template <int kKind>
__device__ __forceinline__ float add_score_terms(const ScoreTerms& t,
                                                 float s, int b, int h,
                                                 int Hq, int Sq, int Skv,
                                                 int qi, int kj, int offset,
                                                 float& th) {
  constexpr float kLog2eF = 1.4426950408889634f;
  if constexpr (kKind == kSoftCap) {
    th = tanhf(__fdiv_rn(__fmul_rn(s, t.scale), t.cap));
    return __fmul_rn(__fmul_rn(t.cap, th), kLog2eF);
  }
  if (t.bias != nullptr) {
    float bv = 0.f;
    if (qi < Sq && kj < Skv) {
      const size_t i =
          (((size_t)(t.bias_b > 1 ? b : 0) * Hq + h) * Sq + qi) * Skv + kj;
      bv = t.bias_code == kFloat32
               ? __ldg(static_cast<const float*>(t.bias) + i)
               : __bfloat162float(static_cast<const __nv_bfloat16*>(t.bias)[i]);
    }
    return __fadd_rn(s, __fmul_rn(bv, kLog2eF));
  }
  if (t.slopes != nullptr) {
    const float dist = fabsf(static_cast<float>(qi + offset - kj));
    return __fmul_rn(
        __fsub_rn(__fmul_rn(s, t.scale), __fmul_rn(__ldg(t.slopes + h), dist)),
        kLog2eF);
  }
  return s;
}

// The soft cap's VJP applied to the score gradient ds (before ds is
// rounded), from th = tanh(s * scale / cap) of add_score_terms: JAX's
// transpose of tanh's JVP `(g + g * t) * (1 - t)` between the mod's product
// with cap and its division by cap, in that order: g = cap * ds,
// w = g * (1 - t), then (w + w * t) / cap, each operation rounded on its
// own. 1 - t is exact near saturation (|t| -> 1), where 1 - t^2 cancels.
__device__ __forceinline__ float soft_cap_grad(float cap, float th,
                                               float ds) {
  const float w = __fmul_rn(__fmul_rn(cap, ds), __fsub_rn(1.f, th));
  return __fdiv_rn(__fadd_rn(w, __fmul_rn(w, th)), cap);
}

// The C entry points' check of the score terms: a bias of f32 or bf16
// whose batch is 1 or B; a finite positive cap; at most one of a bias,
// slopes and a cap, and none with FP8 Q/K/V; dropout with positive tile
// sizes (FP8 Q/K/V included).
inline bool bad_terms(const ScoreTerms& t, int B, bool fp8) {
  const bool has_bias = t.bias != nullptr;
  const bool has_slopes = t.slopes != nullptr;
  const bool has_cap = t.cap != 0.f;
  const bool has_drop = t.drop.seed != nullptr;
  return (has_bias && ((t.bias_code != kFloat32 && t.bias_code != kBFloat16) ||
                       (t.bias_b != 1 && t.bias_b != B))) ||
         (has_cap && !(t.cap > 0.f && std::isfinite(t.cap))) ||
         (int(has_bias) + int(has_slopes) + int(has_cap) > 1) ||
         (has_drop && (t.drop.bq < 1 || t.drop.bk < 1)) ||
         (fp8 && (has_bias || has_slopes || has_cap));
}
