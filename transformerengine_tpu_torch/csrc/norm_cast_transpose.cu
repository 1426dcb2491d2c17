// RMSNorm or LayerNorm of an (M, H) tensor fused with the per-tensor FP8
// cast into both orientations: the rowwise (M, H) payload, the colwise
// (H, M) payload, the amax of the normalized values, rsigma (M) and, for
// LayerNorm, mu (M). The normalized tensor itself is never written.
//
// Replaces transformerengine_tpu/ops/quantize_kernels.py
// norm_cast_transpose (`_norm_cast_transpose_kernel`). Numerics follow it:
// statistics in f32 (mu = mean(x); var = mean(xc * xc) with xc = x - mu
// for LayerNorm and x for RMSNorm; rsigma = 1 / sqrt(var + eps)),
// y = xc * rsigma * gamma (+ 1 with zero-centered gamma) (+ beta), y
// ROUNDED TO THE INPUT DTYPE before the amax and the cast, then the cast
// of quantize/qmath.py (clip, round to nearest even). The row sums run in
// another order than XLA's, so rsigma may differ by an f32 ulp and, where
// that moves a value across a rounding boundary, a payload byte by one
// fp8 step.
//
// Bound on an H100: bytes. At (4096, 4096) bf16 it reads x once and
// writes two one-byte payloads, 67 MB, 20 us at 3.35 TB/s.
//
// Design: one block of 8 warps per 8 rows. Each warp reduces one row's
// statistics with 16-byte loads and warp shuffles; then the block walks
// the row tile 128 columns at a time, each thread normalizing and casting
// 4 values, writing 4 rowwise bytes and keeping them in a shared tile,
// and after a barrier 128 threads each write 8 bytes of one colwise row.
// The second pass reads x again (from L2 for these tiles). H % 128 == 0
// and M % 8 == 0 keep every access inside the tensor.
#include "common.cuh"

namespace {

constexpr int kRows = 8;
constexpr int kChunk = 128;
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    norm_cast_transpose_kernel(const T* __restrict__ x,
                               const float* __restrict__ gamma,
                               const float* __restrict__ beta,
                               const float* __restrict__ scale_p, int e5m2,
                               uint8_t* __restrict__ row,
                               uint8_t* __restrict__ col,
                               float* __restrict__ amax_out,
                               float* __restrict__ rsigma_out,
                               float* __restrict__ mu_out, int M, int H,
                               int layernorm, int zero_centered, float eps) {
  __shared__ float s_mu[kRows];
  __shared__ float s_rs[kRows];
  __shared__ uint8_t tile[kRows][kChunk + 16];
  __shared__ float scratch[kThreads / 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * kRows;

  {
    float mean, rs;
    row_stats<T>(x + (size_t)(m0 + warp) * H, H, layernorm, eps, lane, mean,
                 rs);
    if (lane == 0) {
      s_mu[warp] = mean;
      s_rs[warp] = rs;
      rsigma_out[m0 + warp] = rs;
      if (mu_out != nullptr) mu_out[m0 + warp] = mean;
    }
  }
  __syncthreads();

  const Fp8Cast cast(e5m2);
  const float scale = *scale_p;
  const int r = warp;
  const int c4 = lane * 4;
  const float mean = s_mu[r];
  const float rs = s_rs[r];
  const T* xr = x + (size_t)(m0 + r) * H;
  uint8_t* rr = row + (size_t)(m0 + r) * H;
  float amax = 0.f;
  for (int h0 = 0; h0 < H; h0 += kChunk) {
    const int h = h0 + c4;
    float v[4], g[4], b[4] = {0.f, 0.f, 0.f, 0.f};
    load4(xr + h, v);
    load4(gamma + h, g);
    if (beta != nullptr) load4(beta + h, b);
    alignas(4) uint8_t q[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float ge = zero_centered ? __fadd_rn(g[e], 1.f) : g[e];
      const float xc = layernorm ? __fsub_rn(v[e], mean) : v[e];
      float y = __fmul_rn(__fmul_rn(xc, rs), ge);
      if (beta != nullptr) y = __fadd_rn(y, b[e]);
      y = round_to<T>(y);
      amax = fmaxf(amax, fabsf(y));
      q[e] = cast(__fmul_rn(y, scale));
      tile[r][c4 + e] = q[e];
    }
    *reinterpret_cast<uint32_t*>(rr + h) = *reinterpret_cast<const uint32_t*>(q);
    __syncthreads();
    if (threadIdx.x < kChunk) {
      alignas(8) uint8_t t[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) t[i] = tile[i][threadIdx.x];
      *reinterpret_cast<uint2*>(col + (size_t)(h0 + threadIdx.x) * M + m0) =
          *reinterpret_cast<const uint2*>(t);
    }
    __syncthreads();
  }
  block_amax_to(amax, scratch, amax_out);
}

template <typename T>
cudaError_t launch(const void* x, const float* gamma, const float* beta,
                   const float* scale, int e5m2, void* row, void* col,
                   float* amax, float* rsigma, float* mu, int M, int H,
                   int layernorm, int zero_centered, float eps,
                   cudaStream_t s) {
  norm_cast_transpose_kernel<T><<<M / kRows, kThreads, 0, s>>>(
      static_cast<const T*>(x), gamma, beta, scale, e5m2,
      static_cast<uint8_t*>(row), static_cast<uint8_t*>(col), amax, rsigma,
      mu, M, H, layernorm, zero_centered, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int te_norm_cast_transpose(const void* x, int x_dtype,
                                      const float* gamma, const float* beta,
                                      const float* scale, int q_dtype,
                                      void* row, void* col, float* amax,
                                      float* rsigma, float* mu, int M, int H,
                                      int layernorm, int zero_centered,
                                      float eps, void* stream) {
  if (M < kRows || H < kChunk || M % kRows || H % kChunk ||
      (layernorm && mu == nullptr) ||
      (q_dtype != kFloat8E4M3 && q_dtype != kFloat8E5M2))
    return cudaErrorInvalidValue;
  const int e5m2 = q_dtype == kFloat8E5M2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kBFloat16:
      return launch<__nv_bfloat16>(x, gamma, beta, scale, e5m2, row, col, amax,
                                   rsigma, mu, M, H, layernorm, zero_centered,
                                   eps, s);
    case kFloat32:
      return launch<float>(x, gamma, beta, scale, e5m2, row, col, amax, rsigma,
                           mu, M, H, layernorm, zero_centered, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}
