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
// writes two one-byte payloads, 67 MB, 20 us at 3.35 TB/s. One launch of
// the body in norm_quant.cuh, as mxfp8_norm_quantize.cu: its last block
// writes the amax, so `amax` needs no zeroing. M % 8 == 0 and H % 128 ==
// 0; a last strip of fewer than 32 rows is masked.
#include "norm_quant.cuh"

extern "C" int te_norm_cast_transpose(const void* x, int x_dtype,
                                      const float* gamma, const float* beta,
                                      const float* scale, int q_dtype,
                                      void* row, void* col, float* amax,
                                      float* rsigma, float* mu, int M, int H,
                                      int layernorm, int zero_centered,
                                      float eps, void* stream) {
  if (M < 8 || H < 128 || M % 8 || H % 128 || row == nullptr ||
      scale == nullptr || amax == nullptr || (layernorm && mu == nullptr) ||
      (q_dtype != kFloat8E4M3 && q_dtype != kFloat8E5M2))
    return cudaErrorInvalidValue;
  norm_quant::Args a = {};
  a.x = x;
  a.gamma = gamma;
  a.beta = beta;
  a.scale = scale;
  a.row = static_cast<uint8_t*>(row);
  a.col = static_cast<uint8_t*>(col);
  a.amax = amax;
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
      return norm_quant::launch<__nv_bfloat16, false>(a, s);
    case kFloat32:
      return norm_quant::launch<float, false>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}
