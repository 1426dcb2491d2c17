// The MXFP8 quantize of one 32 x 64 tile, shared by mxfp8_quantize.cu and
// mxfp8_norm_quantize.cu: E8M0 scales per 1 x 32 block of the rowwise
// usage and per 32 x 1 block of the colwise one (the (N, M) transpose
// quantized along M), with ragged edges masked.
//
// The rule is that of quantize/qmath.py mxfp8_quantize and the reference's
// `_e8m0_exp` (transformerengine_tpu/ops/quantize_kernels.py:233): the
// block's exponent is e = clip(floor_log2(max(amax, 2^-126)) - 8, -127,
// 127), or 0 where the amax is 0, with floor_log2 read from the f32 bits;
// the payload is clip(x * 2^-e, +-q_max) cast round-to-nearest-even
// (SATFINITE); the stored scale is the byte e + 127. Values outside the
// tensor count as zeros, so a ragged block's amax is over the elements
// that exist. Subnormal inputs meet multipliers up to 2^127 here: the
// sources build without --use_fast_math and without -ftz=true, so no
// product is flushed to zero.
#pragma once

#include "common.cuh"

namespace mxfp8 {

constexpr int kTileRows = 32;  // one colwise block
constexpr int kTileCols = 64;  // two rowwise blocks
constexpr int kThreads = 256;  // 32 rows x 8 segments of 8 columns
constexpr int kBias = 127;
// The element emax of the exponent rule: 8 for every element dtype, e5m2
// included, as the reference takes it (upstream TransformerEngine takes
// 15 for e5m2).
constexpr int kEmax = 8;

__device__ __forceinline__ int e8m0_exponent(float amax) {
  if (!(amax > 0.f)) return 0;
  const int e =
      (__float_as_int(fmaxf(amax, 1.17549435e-38f)) >> 23) - 127 - kEmax;
  return min(max(e, -kBias), kBias);
}

// 2^-e from its f32 bits, exact. An f32 amax gives e <= 120 (inf gives
// 120), so 127 - e >= 7 and the multiplier is a normal number; e = 127,
// whose multiplier 2^-127 would be subnormal, is out of reach.
__device__ __forceinline__ float quant_multiplier(int e) {
  return __int_as_float((127 - e) << 23);
}

// Max over the 4 consecutive lanes of an aligned group: the 4 threads
// that hold one 32-element block.
__device__ __forceinline__ float group4_max(float a) {
  a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 1));
  return fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 2));
}

// Loads 8 elements x[m][n .. n + 7] of an (M, N) tensor as f32: 16-byte
// loads where all 8 exist and the address allows, else one by one with
// zeros outside the tensor.
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ x, int M, int N,
                                      int m, int n, float (&v)[8]) {
  constexpr int kVec = 16 / sizeof(T);
  const T* p = x + (size_t)m * N + n;
  if (m < M && n + 8 <= N && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int k = 0; k < 8; k += kVec) load16(p + k, v + k);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = (m < M && n + j < N) ? to_float(p[j]) : 0.f;
}

// Stores the first `count` (<= 8) of q at dst: one 8-byte store when all
// 8 go and the address allows.
__device__ __forceinline__ void store8(uint8_t* dst, const uint8_t (&q)[8],
                                       int count) {
  if (count == 8 && (reinterpret_cast<uintptr_t>(dst) & 7) == 0) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(q);
    return;
  }
  for (int j = 0; j < count; ++j) dst[j] = q[j];
}

// Quantizes the tile (blockIdx.y, blockIdx.x) of an (M, N) tensor whose
// values v[8] each of the kThreads threads holds: thread t holds row
// t / 8 of the tile, columns 8 * (t % 8) .. + 7, zeros outside the
// tensor. Rowwise: the 4 threads of a 32-column block reduce its amax by
// shuffles and each writes 8 payload bytes; the first writes the scale.
// Colwise: the tile goes through shared memory; thread t then takes
// column t / 4, rows 8 * (t % 4) .. + 7, so the 4 threads of a 32-row
// block write 32 consecutive bytes of one colwise row.
template <bool kRow, bool kCol>
__device__ __forceinline__ void quantize_tile(
    const float (&v)[8], int M, int N, const Fp8Cast& cast,
    uint8_t* __restrict__ row, uint8_t* __restrict__ col,
    uint8_t* __restrict__ srow, uint8_t* __restrict__ scol) {
  const int t = threadIdx.x;
  const int m0 = blockIdx.y * kTileRows;
  const int n0 = blockIdx.x * kTileCols;
  const int r = t >> 3;
  const int c = (t & 7) * 8;
  if (kRow) {
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) a = fmaxf(a, fabsf(v[j]));
    const int e = e8m0_exponent(group4_max(a));
    const float s = quant_multiplier(e);
    alignas(8) uint8_t q[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) q[j] = cast(__fmul_rn(v[j], s));
    const int m = m0 + r;
    const int n = n0 + c;
    if (m < M && n < N) {
      store8(row + (size_t)m * N + n, q, min(8, N - n));
      if ((t & 3) == 0)
        srow[(size_t)m * ((N + 31) / 32) + n / 32] = (uint8_t)(e + kBias);
    }
  }
  if (kCol) {
    // A row stride of 65 words keeps both the writes and the column
    // reads below free of bank conflicts beyond two-way.
    __shared__ float tile[kTileRows][kTileCols + 1];
#pragma unroll
    for (int j = 0; j < 8; ++j) tile[r][c + j] = v[j];
    __syncthreads();
    const int cc = t >> 2;
    const int g = t & 3;
    float w[8];
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      w[i] = tile[8 * g + i][cc];
      a = fmaxf(a, fabsf(w[i]));
    }
    const int e = e8m0_exponent(group4_max(a));
    const float s = quant_multiplier(e);
    alignas(8) uint8_t q[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) q[i] = cast(__fmul_rn(w[i], s));
    const int n = n0 + cc;
    const int m = m0 + 8 * g;
    if (n < N && m < M) {
      store8(col + (size_t)n * M + m, q, min(8, M - m));
      if (g == 0)
        scol[(size_t)n * ((M + 31) / 32) + m0 / 32] = (uint8_t)(e + kBias);
    }
  }
}

// The grid of an (M, N) tensor's tiles; false when it exceeds the
// launch limits.
inline bool tile_grid(int M, int N, dim3* grid) {
  if (M < 1 || N < 1) return false;
  const int gy = (M + kTileRows - 1) / kTileRows;
  if (gy > 65535) return false;
  *grid = dim3((N + kTileCols - 1) / kTileCols, gy);
  return true;
}

}  // namespace mxfp8
