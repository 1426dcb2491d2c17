// RMSNorm or LayerNorm of an (M, H) tensor fused with the MXFP8 quantize:
// the rowwise (M, H) payload and its (M, H/32) E8M0 grid, unless
// rowwise-only the colwise (H, M) payload and its (H, M/32) grid, rsigma
// (M) and, for LayerNorm, mu (M). The normalized tensor is never written.
// M and H are multiples of 32.
//
// Replaces transformerengine_tpu/ops/quantize_kernels.py
// mxfp8_norm_quantize_2x (`_mxfp8_norm_kernel`). Numerics follow it:
// statistics in f32 (as norm_cast_transpose.cu), y = (x - mu) * rsigma *
// gamma (+ 1 with zero-centered gamma) (+ beta), y ROUNDED TO THE INPUT
// DTYPE, then the MXFP8 quantize of mxfp8.cuh, bit-exact to
// quantize/qmath.py mxfp8_quantize of the rounded values. The row sums
// run in another order than PyTorch's, so rsigma may differ by an f32
// ulp from the plain version's.
//
// Bound on an H100: bytes. At (4096, 4096) bf16 the 2x form reads x once
// and writes two one-byte payloads and two grids: 67 MB, 20 us at
// 3.35 TB/s.
//
// Design: 32 whole bf16 rows of H = 4096 (one colwise block's height) are
// 256 KB, more than the 227 KB of shared memory a block can have, so no
// tile holds whole rows. One C call makes two launches: the statistics,
// one warp per row (16-byte loads, shuffle sums); then the 32 x 64 tiles
// of mxfp8.cuh, each thread normalizing the 8 values it loads before the
// tile's quantize. The second launch reads x again, mostly from the
// 50 MB L2 at this size; the two take about three times the byte bound
// on an H100 (PERF.md).
#include "mxfp8.cuh"

namespace {

using namespace mxfp8;

constexpr int kStatRows = 8;  // one warp per row

template <typename T>
__global__ void __launch_bounds__(kStatRows * 32)
    norm_stats_kernel(const T* __restrict__ x, float* __restrict__ rsigma,
                      float* __restrict__ mu, int M, int H, int layernorm,
                      float eps) {
  const int m = blockIdx.x * kStatRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (m >= M) return;
  float mean, rs;
  row_stats<T>(x + (size_t)m * H, H, layernorm, eps, lane, mean, rs);
  if (lane == 0) {
    rsigma[m] = rs;
    if (mu != nullptr) mu[m] = mean;
  }
}

template <typename T, bool kCol>
__global__ void __launch_bounds__(kThreads)
    norm_quantize_kernel(const T* __restrict__ x,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         const float* __restrict__ rsigma,
                         const float* __restrict__ mu, int zero_centered,
                         int e5m2, uint8_t* __restrict__ row,
                         uint8_t* __restrict__ col, uint8_t* __restrict__ srow,
                         uint8_t* __restrict__ scol, int M, int H) {
  const int t = threadIdx.x;
  const int m = blockIdx.y * kTileRows + (t >> 3);
  const int n = blockIdx.x * kTileCols + (t & 7) * 8;
  float v[8];
  load8(x, M, H, m, n, v);
  if (m < M) {
    float g[8], b[8];
    load8(gamma, 1, H, 0, n, g);
    if (beta != nullptr) load8(beta, 1, H, 0, n, b);
    const float rs = rsigma[m];
    const float mean = mu != nullptr ? mu[m] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (n + j >= H) continue;  // stays 0, outside the tensor
      const float ge = zero_centered ? __fadd_rn(g[j], 1.f) : g[j];
      const float xc = mu != nullptr ? __fsub_rn(v[j], mean) : v[j];
      float y = __fmul_rn(__fmul_rn(xc, rs), ge);
      if (beta != nullptr) y = __fadd_rn(y, b[j]);
      v[j] = round_to<T>(y);
    }
  }
  quantize_tile<true, kCol>(v, M, H, Fp8Cast(e5m2), row, col, srow, scol);
}

template <typename T>
cudaError_t launch(const void* x, const float* gamma, const float* beta,
                   int e5m2, void* row, void* col, void* srow, void* scol,
                   float* rsigma, float* mu, int M, int H, int layernorm,
                   int zero_centered, float eps, cudaStream_t s) {
  dim3 grid;
  if (!tile_grid(M, H, &grid)) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  norm_stats_kernel<T><<<(M + kStatRows - 1) / kStatRows, kStatRows * 32, 0,
                         s>>>(xt, rsigma, layernorm ? mu : nullptr, M, H,
                              layernorm, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  uint8_t* r = static_cast<uint8_t*>(row);
  uint8_t* c = static_cast<uint8_t*>(col);
  uint8_t* sr = static_cast<uint8_t*>(srow);
  uint8_t* sc = static_cast<uint8_t*>(scol);
  const float* mu_in = layernorm ? mu : nullptr;
  if (c != nullptr) {
    norm_quantize_kernel<T, true><<<grid, kThreads, 0, s>>>(
        xt, gamma, beta, rsigma, mu_in, zero_centered, e5m2, r, c, sr, sc, M,
        H);
  } else {
    norm_quantize_kernel<T, false><<<grid, kThreads, 0, s>>>(
        xt, gamma, beta, rsigma, mu_in, zero_centered, e5m2, r, c, sr, sc, M,
        H);
  }
  return cudaGetLastError();
}

}  // namespace

// `col` and `scol` NULL: rowwise only. `mu` is written for LayerNorm.
extern "C" int te_mxfp8_norm_quantize(const void* x, int x_dtype,
                                      const float* gamma, const float* beta,
                                      int q_dtype, void* row, void* col,
                                      void* srow, void* scol, float* rsigma,
                                      float* mu, int M, int H, int layernorm,
                                      int zero_centered, float eps,
                                      void* stream) {
  if (M < 32 || H < 32 || M % 32 || H % 32 || row == nullptr ||
      srow == nullptr || (col == nullptr) != (scol == nullptr) ||
      (layernorm && mu == nullptr) ||
      (q_dtype != kFloat8E4M3 && q_dtype != kFloat8E5M2))
    return cudaErrorInvalidValue;
  const int e5m2 = q_dtype == kFloat8E5M2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kBFloat16:
      return launch<__nv_bfloat16>(x, gamma, beta, e5m2, row, col, srow, scol,
                                   rsigma, mu, M, H, layernorm, zero_centered,
                                   eps, s);
    case kFloat32:
      return launch<float>(x, gamma, beta, e5m2, row, col, srow, scol, rsigma,
                           mu, M, H, layernorm, zero_centered, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}
