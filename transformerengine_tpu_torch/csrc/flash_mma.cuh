// Shared pieces of the flash kernels' tensor-core bodies (the forward in
// flash_attention.cu, the dQ and dK/dV kernels in flash_attention_bwd.cu):
// bf16 tiles in shared memory, their loads from BSHD tensors, the warp's
// products over them, and paired stores of the results.
//
// A tile holds R rows of one head as bf16, DMAX values each (the head dim
// D, a multiple of 16, zero-padded to the instance's DMAX of 64, 128 or
// 256), with a row stride of DMAX + 8 elements: 16 bytes of padding, so
// that the 8 rows an ldmatrix reads start (DMAX / 8 + 1) * 16 bytes apart,
// an odd multiple of 16, and fall on 8 distinct groups of 4 banks. Every
// loop over a tile's columns then has a compile-time trip count and no
// branch, so the compiler can issue each k-step's ldmatrix ahead of the
// products that wait for it; a padded column adds zeros to every product.
#pragma once

#include "common.cuh"
#include "ptx.cuh"

namespace flash_mma {

using bf16 = __nv_bfloat16;

// Every tensor-core body runs 4 warps; each owns 16 rows of the tile its
// products write (queries in the forward and dQ kernels, keys in dK/dV).
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// The row stride of a tile, in elements.
template <int DMAX>
constexpr int kLd = DMAX + 8;

// Two f32 values rounded to bf16 (nearest even) in one register, the first
// in the low half: two columns of an A fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Widens 16 fp8 values (e4m3 or e5m2) to bf16, exactly: every value of
// either format is an f16 and a bf16 value.
template <typename T>
__device__ __forceinline__ void widen16_bf16(const uint4& raw, uint4& lo,
                                             uint4& hi) {
  float f[16];
  widen16<T>(raw, f);
  uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
  uint32_t* u = reinterpret_cast<uint32_t*>(&hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = pack_bf16(f[2 * i], f[2 * i + 1]);
    u[i] = pack_bf16(f[8 + 2 * i], f[8 + 2 * i + 1]);
  }
}

// Copies rows [r0, r0 + R) of head h of a BSHD tensor (S rows, H heads,
// D values a row) into a shared bf16 tile; rows past S and columns past D
// are zeros. bf16 rows go by cp.async (the caller commits and waits), fp8
// rows through registers, widened on the way (16 values a load).
template <typename T, int R, int DMAX>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, int b,
                                          int r0, int S, int H, int h, int D,
                                          bf16* dst) {
  constexpr int ld = kLd<DMAX>;
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int kChunks = DMAX / 8;
    static_assert(R * kChunks % kThreads == 0, "whole rounds of chunks");
#pragma unroll
    for (int j = 0; j < R * kChunks / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / kChunks;
      const int c = (i % kChunks) * 8;
      const bool in = r0 + r < S && c < D;
      const T* from = src + (((size_t)b * S + (in ? r0 + r : 0)) * H + h) * D +
                      (in ? c : 0);
      cp_async16(dst + r * ld + c, from, in);
    }
  } else {
    constexpr int kChunks = DMAX / 16;
    static_assert(R * kChunks % kThreads == 0, "whole rounds of chunks");
#pragma unroll
    for (int j = 0; j < R * kChunks / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / kChunks;
      const int c = (i % kChunks) * 16;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < S && c < D)
        raw = __ldg(reinterpret_cast<const uint4*>(
            src + (((size_t)b * S + r0 + r) * H + h) * D + c));
      uint4 lo, hi;
      widen16_bf16<T>(raw, lo, hi);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = lo;
      *reinterpret_cast<uint4*>(dst + r * ld + c + 8) = hi;
    }
  }
}

// load_rows for a tensor whose dtype (bf16, e4m3 or e5m2) is known at run
// time, a DTypeCode.
template <int R, int DMAX>
__device__ __forceinline__ void load_rows_as(const void* src, int code, int b,
                                             int r0, int S, int H, int h,
                                             int D, bf16* dst) {
  switch (code) {
    case kBFloat16:
      load_rows<bf16, R, DMAX>(static_cast<const bf16*>(src), b, r0, S, H, h,
                               D, dst);
      break;
    case kFloat8E4M3:
      load_rows<__nv_fp8_e4m3, R, DMAX>(
          static_cast<const __nv_fp8_e4m3*>(src), b, r0, S, H, h, D, dst);
      break;
    default:
      load_rows<__nv_fp8_e5m2, R, DMAX>(
          static_cast<const __nv_fp8_e5m2*>(src), b, r0, S, H, h, D, dst);
      break;
  }
}

// c[n] += A B^T over the tile's kKS * 16 columns: A is the warp's 16 rows
// at `a`, B^T the rows at `bm` (row 8n + j is column j of n-tile n), both
// shared tiles of row stride LD. kN n-tiles (even). Each k-step loads its
// A fragment and its kN / 2 B fragments, then runs its kN products.
template <int kN, int kKS, int LD>
__device__ __forceinline__ void mma_abt(float (&c)[kN][4], const bf16* a,
                                        const bf16* bm, int lane) {
  const bf16* ap = a + (lane & 15) * LD + (lane >> 4) * 8;
  const bf16* bp =
      bm + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
    uint32_t af[4], bf[kN / 2][4];
    ldmatrix_x4(af, ap + kk * 16);
#pragma unroll
    for (int n = 0; n < kN; n += 2)
      ldmatrix_x4(bf[n / 2], bp + n * 8 * LD + kk * 16);
#pragma unroll
    for (int n = 0; n < kN; n += 2) {
      mma_bf16(c[n], af, bf[n / 2][0], bf[n / 2][1]);
      mma_bf16(c[n + 1], af, bf[n / 2][2], bf[n / 2][3]);
    }
  }
}

// c[n] += A B over the tile's kKQ * 16 rows: A in registers (`a[kk]`, the
// fragment of k-step kk), B the rows at `bm` (row k, columns 8n onwards) of
// a shared tile of row stride LD.
template <int kKQ, int kN, int LD>
__device__ __forceinline__ void mma_ab(float (&c)[kN][4],
                                       const uint32_t (&a)[kKQ][4],
                                       const bf16* bm, int lane) {
  const bf16* bp =
      bm + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < kKQ; ++kk) {
#pragma unroll
    for (int n = 0; n < kN; n += 2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, bp + kk * 16 * LD + n * 8);
      mma_bf16(c[n], a[kk], bf[0], bf[1]);
      mma_bf16(c[n + 1], a[kk], bf[2], bf[3]);
    }
  }
}

// Stores v0 and v1 as elements i and i + 1 (i even) of a tensor of dtype
// `code`, as store_as rounds them.
__device__ __forceinline__ void store2_as(void* p, int code, size_t i,
                                          float v0, float v1) {
  switch (code) {
    case kFloat32:
      *reinterpret_cast<float2*>(static_cast<float*>(p) + i) =
          make_float2(v0, v1);
      break;
    case kBFloat16:
      *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p) + i) =
          __floats2bfloat162_rn(v0, v1);
      break;
    default: {
      const Fp8Cast cast(code == kFloat8E5M2);
      *reinterpret_cast<uint16_t*>(static_cast<uint8_t*>(p) + i) =
          static_cast<uint16_t>(cast(v0) | (cast(v1) << 8));
      break;
    }
  }
}

// The keys [lo, hi) that query qi sees under the causal rule with its
// offset, the window's active sides, the lengths and the sequence ends
// (key j is visible when qi + offset - left <= j <= qi + offset + right and
// j <= qi + offset under the causal rule): computed once a row, so that a
// score's mask is two compares (and the segment ids' one).
struct Span {
  int lo, hi;
  __device__ __forceinline__ bool has(int j) const { return j >= lo && j < hi; }
};

__device__ __forceinline__ Span key_span(int qi, int Sq, int Skv, int qlen,
                                         int klen, bool causal, int offset,
                                         bool left_on, int left,
                                         bool right_on, int right) {
  Span sp{0, qi < Sq && qi < qlen ? min(Skv, klen) : 0};
  if (causal) sp.hi = min(sp.hi, qi + offset + 1);
  if (right_on) sp.hi = min(sp.hi, qi + offset + right + 1);
  if (left_on) sp.lo = qi + offset - left;
  return sp;
}

// The queries [lo, hi) that see key kj, the same rule read from the key.
__device__ __forceinline__ Span query_span(int kj, int Sq, int Skv, int qlen,
                                           int klen, bool causal, int offset,
                                           bool left_on, int left,
                                           bool right_on, int right) {
  Span sp{0, kj < Skv && kj < klen ? min(Sq, qlen) : 0};
  if (causal) sp.lo = max(sp.lo, kj - offset);
  if (right_on) sp.lo = max(sp.lo, kj - offset - right);
  if (left_on) sp.hi = min(sp.hi, kj - offset + left + 1);
  return sp;
}

// The max and the sum over the 4 lanes of a quad, which hold one row of
// an accumulator fragment between them.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace flash_mma
