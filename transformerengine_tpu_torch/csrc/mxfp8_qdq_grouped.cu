// MXFP8 quantize-dequantize of stacked expert kernels, both bf16
// orientations from one read (te_mxfp8_qdq_2x_grouped): for an (E, K, M)
// input, each 32-element block along K (one column m of one expert) takes
// the E8M0 exponent of its amax, its values go to e4m3 (or e5m2) and back
// to bf16 times that power of two, and the result is written as nn
// (E, K, M) and as its transpose tn (E, M, K). K must be a multiple of 32
// and M of 64.
//
// Replaces transformerengine_tpu/ops/quantize_kernels.py
// mxfp8_qdq_2x_grouped (`_mxfp8_qdq_kernel`). Bit-exact to the chain
// quantize(swapaxes(k)) -> dequantize -> swapaxes of quantize/qmath.py
// mxfp8_quantize (the rule is in mxfp8.cuh, emax 8 for both element
// types); the dequantize multiplies the fp8 value, widened exactly to
// f32, by 2^e built from its bits (a subnormal for e = -127), and rounds
// once to bf16, as the chain's bf16 product of two exact bf16 values
// does.
//
// Bound on an H100: bytes. Two bytes read and four written per element:
// at the MoE up-projection's (8, 4096, 28672) that is 5.64 GB, 1.68 ms at
// 3.35 TB/s, and 0.84 ms at the down-projection's (8, 14336, 4096). A few
// operations per byte.
//
// Design: one block of 256 threads per expert and 32 x 64 tile of (K, M),
// so a tile holds whole 32-element blocks. Each thread loads 8
// consecutive elements of one K row with a 16-byte load (two for f32) and
// stages them in shared memory (a row stride of 65 words: no bank
// conflicts); thread t then takes column t / 4, rows 8 * (t % 4) .. + 7,
// and the 4 threads of a column reduce its amax by shuffles. Each thread
// writes its 8 dequantized values as 16 contiguous bytes of one tn row
// (its 4-lane group 64 consecutive bytes), and puts them back in shared
// memory, from which every thread writes 16 bytes of one nn row (8
// threads, 128 consecutive bytes). Left for later: more bytes in flight
// per thread, TMA loads and stores.
#include "mxfp8.cuh"

namespace {

using namespace mxfp8;

constexpr int kQdqRows = 32;  // one block along K
constexpr int kQdqCols = 64;  // columns of M per tile

// 2^e for an E8M0 exponent e in [-127, 127], exact: a normal number from
// its bits, or the subnormal 2^-127.
__device__ __forceinline__ float dequant_multiplier(int e) {
  return e > -127 ? __int_as_float((127 + e) << 23) : __int_as_float(1 << 22);
}

__device__ __forceinline__ float fp8_to_float(uint8_t q,
                                              __nv_fp8_interpretation_t kind) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(q, kind)));
}

// Stores 8 values, rounded to bf16, as 16 bytes at a 16-byte-aligned dst.
__device__ __forceinline__ void store8_bf16(__nv_bfloat16* dst,
                                            const float (&v)[8]) {
  alignas(16) __nv_bfloat16 b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) b[j] = __float2bfloat16(v[j]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mxfp8_qdq_grouped_kernel(const T* __restrict__ x, int e5m2,
                             __nv_bfloat16* __restrict__ nn,
                             __nv_bfloat16* __restrict__ tn, int K, int M) {
  __shared__ float tile[kQdqRows][kQdqCols + 1];
  const int t = threadIdx.x;
  const size_t expert = (size_t)blockIdx.z * K * M;
  const int k0 = blockIdx.y * kQdqRows;
  const int m0 = blockIdx.x * kQdqCols;
  const int r = t >> 3;
  const int c = (t & 7) * 8;
  float v[8];
  load8(x + expert, K, M, k0 + r, m0 + c, v);
#pragma unroll
  for (int j = 0; j < 8; ++j) tile[r][c + j] = v[j];
  __syncthreads();

  const Fp8Cast cast(e5m2);
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
  const float d = dequant_multiplier(e);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = __bfloat162float(__float2bfloat16(
        __fmul_rn(fp8_to_float(cast(__fmul_rn(w[i], s)), cast.kind), d)));
  store8_bf16(tn + expert + (size_t)(m0 + cc) * K + k0 + 8 * g, w);
  // Each element of the tile was read by this thread alone, so it can
  // take its dequantized value back without a barrier.
#pragma unroll
  for (int i = 0; i < 8; ++i) tile[8 * g + i][cc] = w[i];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = tile[r][c + j];
  store8_bf16(nn + expert + (size_t)(k0 + r) * M + m0 + c, v);
}

template <typename T>
cudaError_t launch(const void* x, int e5m2, void* nn, void* tn, int E, int K,
                   int M, cudaStream_t s) {
  if (E < 1 || K < 1 || M < 1 || K % kQdqRows || M % kQdqCols ||
      K / kQdqRows > 65535 || E > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(M / kQdqCols, K / kQdqRows, E);
  mxfp8_qdq_grouped_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), e5m2, static_cast<__nv_bfloat16*>(nn),
      static_cast<__nv_bfloat16*>(tn), K, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" int te_mxfp8_qdq_2x_grouped(const void* x, int x_dtype,
                                       int q_dtype, void* nn, void* tn, int E,
                                       int K, int M, void* stream) {
  if (nn == nullptr || tn == nullptr) return cudaErrorInvalidValue;
  if (q_dtype != kFloat8E4M3 && q_dtype != kFloat8E5M2)
    return cudaErrorInvalidValue;
  const int e5m2 = q_dtype == kFloat8E5M2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kBFloat16:
      return launch<__nv_bfloat16>(x, e5m2, nn, tn, E, K, M, s);
    case kFloat32:
      return launch<float>(x, e5m2, nn, tn, E, K, M, s);
    default:
      return cudaErrorInvalidValue;
  }
}
