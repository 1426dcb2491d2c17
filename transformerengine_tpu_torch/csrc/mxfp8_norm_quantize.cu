// RMSNorm or LayerNorm of an (M, H) tensor fused with the MXFP8 quantize:
// the rowwise (M, H) payload and its (M, H/32) E8M0 grid, unless
// rowwise-only the colwise (H, M) payload and its (H, M/32) grid, rsigma
// (M) and, for LayerNorm, mu (M). The normalized tensor is never written.
// M and H are multiples of 32.
//
// Replaces transformerengine_tpu/ops/quantize_kernels.py
// mxfp8_norm_quantize_2x (`_mxfp8_norm_kernel`). Numerics follow it:
// statistics in f32, y = (x - mu) * rsigma * gamma (+ 1 with zero-centered
// gamma) (+ beta), y ROUNDED TO THE INPUT DTYPE, then the MXFP8 quantize of
// mxfp8.cuh, bit-exact to quantize/qmath.py mxfp8_quantize of the rounded
// values. The row sums run in another order than PyTorch's, so rsigma may
// differ by an f32 ulp from the plain version's.
//
// Bound on an H100: bytes. At (4096, 4096) bf16 the 2x form reads x once
// and writes two one-byte payloads and two grids: 68 MB, 20 us at
// 3.35 TB/s. One launch of the body in norm_quant.cuh (a cluster per strip
// of 32 rows, x read once by bulk copies, the statistics exchanged through
// distributed shared memory).
#include "norm_quant.cuh"

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
  norm_quant::Args a = {};
  a.x = x;
  a.gamma = gamma;
  a.beta = beta;
  a.row = static_cast<uint8_t*>(row);
  a.col = static_cast<uint8_t*>(col);
  a.srow = static_cast<uint8_t*>(srow);
  a.scol = static_cast<uint8_t*>(scol);
  a.rsigma = rsigma;
  a.mu = layernorm ? mu : nullptr;
  a.M = M;
  a.H = H;
  a.layernorm = layernorm;
  a.zero_centered = zero_centered;
  a.e5m2 = q_dtype == kFloat8E5M2;
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kBFloat16:
      return norm_quant::launch<__nv_bfloat16, true>(a, s);
    case kFloat32:
      return norm_quant::launch<float, true>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}
