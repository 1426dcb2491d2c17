// Per-tensor FP8 cast of an (M, N) tensor into both orientations in one
// read: the rowwise (M, N) payload, the colwise (N, M) payload and the
// amax of |x|.
//
// Replaces transformerengine_tpu/ops/quantize_kernels.py cast_transpose
// (`_cast_transpose_kernel`). Bit-exact to quantize/qmath.py: y = x * scale
// in f32, clipped to +-q_max, then rounded to nearest even into e4m3 or
// e5m2; the amax is exact (a max does not depend on order).
//
// Bound on an H100: bytes. It reads x once and writes two one-byte
// payloads: at the MLP's (4096, 14336) bf16 that is 235 MB, 70 us at
// 3.35 TB/s; at (4096, 4096), 67 MB, 20 us. A few operations per byte.
//
// Design: one block per 64 x 64 tile. Threads read x with 16-byte loads,
// write the rowwise bytes straight out (8 or 4 bytes a thread) and keep
// them in a shared-memory tile; after one barrier each thread gathers 16
// bytes of one column of the tile and writes them as one 16-byte store of
// the colwise payload. Each block reduces its amax over the warps and
// adds it with one atomicMax. That kernel needs M % 16 == 0 and
// N % 16 == 0, so every vector lies wholly inside or outside the tensor;
// any other shape takes a kernel with the same tiles that reads, casts
// and stores one element at a time and masks the ragged edges.
#include "common.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cast_transpose_kernel(const T* __restrict__ x,
                          const float* __restrict__ scale_p, int e5m2,
                          uint8_t* __restrict__ row, uint8_t* __restrict__ col,
                          float* __restrict__ amax_out, int M, int N) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecsPerRow = kTile / kVec;
  __shared__ uint8_t tile[kTile][kTile + 16];
  __shared__ float scratch[kThreads / 32];
  const Fp8Cast cast(e5m2);
  const float scale = *scale_p;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;

  float amax = 0.f;
  for (int i = threadIdx.x; i < kTile * kVecsPerRow; i += kThreads) {
    const int r = i / kVecsPerRow;
    const int c = (i - r * kVecsPerRow) * kVec;
    const int m = m0 + r;
    const int n = n0 + c;
    if (m >= M || n >= N) continue;
    float v[kVec];
    load16(x + (size_t)m * N + n, v);
    alignas(8) uint8_t q[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      amax = fmaxf(amax, fabsf(v[e]));
      q[e] = cast(__fmul_rn(v[e], scale));
      tile[r][c + e] = q[e];
    }
    uint8_t* dst = row + (size_t)m * N + n;
    if constexpr (kVec == 8) {
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(q);
    } else {
      *reinterpret_cast<uint32_t*>(dst) =
          *reinterpret_cast<const uint32_t*>(q);
    }
  }
  __syncthreads();

  // Colwise: 64 rows of the transpose (columns n of x), each 64 bytes
  // long, written as four 16-byte chunks.
  for (int i = threadIdx.x; i < kTile * (kTile / 16); i += kThreads) {
    const int c = i / (kTile / 16);
    const int chunk = (i - c * (kTile / 16)) * 16;
    const int n = n0 + c;
    const int m = m0 + chunk;
    if (n >= N || m >= M) continue;
    alignas(16) uint8_t b[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) b[j] = tile[chunk + j][c];
    *reinterpret_cast<uint4*>(col + (size_t)n * M + m) =
        *reinterpret_cast<const uint4*>(b);
  }
  block_amax_to(amax, scratch, amax_out);
}

// Any M and N: the tiles above, one element at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cast_transpose_ragged_kernel(const T* __restrict__ x,
                                 const float* __restrict__ scale_p, int e5m2,
                                 uint8_t* __restrict__ row,
                                 uint8_t* __restrict__ col,
                                 float* __restrict__ amax_out, int M, int N) {
  __shared__ uint8_t tile[kTile][kTile + 1];
  __shared__ float scratch[kThreads / 32];
  const Fp8Cast cast(e5m2);
  const float scale = *scale_p;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;

  float amax = 0.f;
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile;
    const int c = i - r * kTile;
    const int m = m0 + r;
    const int n = n0 + c;
    if (m >= M || n >= N) continue;
    const float v = to_float(x[(size_t)m * N + n]);
    amax = fmaxf(amax, fabsf(v));
    const uint8_t q = cast(__fmul_rn(v, scale));
    tile[r][c] = q;
    row[(size_t)m * N + n] = q;
  }
  __syncthreads();

  // Consecutive threads walk down one column of the tile: consecutive
  // bytes of one row of the colwise payload.
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int c = i / kTile;
    const int r = i - c * kTile;
    const int n = n0 + c;
    const int m = m0 + r;
    if (n >= N || m >= M) continue;
    col[(size_t)n * M + m] = tile[r][c];
  }
  block_amax_to(amax, scratch, amax_out);
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, int e5m2, void* row,
                   void* col, float* amax, int M, int N, cudaStream_t s) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  const T* xt = static_cast<const T*>(x);
  uint8_t* r = static_cast<uint8_t*>(row);
  uint8_t* c = static_cast<uint8_t*>(col);
  if (M % 16 == 0 && N % 16 == 0) {
    cast_transpose_kernel<T><<<grid, kThreads, 0, s>>>(xt, scale, e5m2, r, c,
                                                       amax, M, N);
  } else {
    cast_transpose_ragged_kernel<T><<<grid, kThreads, 0, s>>>(
        xt, scale, e5m2, r, c, amax, M, N);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int te_cast_transpose(const void* x, int x_dtype,
                                 const float* scale, int q_dtype, void* row,
                                 void* col, float* amax, int M, int N,
                                 void* stream) {
  if (M < 1 || N < 1 || (M + kTile - 1) / kTile > 65535 ||
      (q_dtype != kFloat8E4M3 && q_dtype != kFloat8E5M2))
    return cudaErrorInvalidValue;
  const int e5m2 = q_dtype == kFloat8E5M2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kBFloat16:
      return launch<__nv_bfloat16>(x, scale, e5m2, row, col, amax, M, N, s);
    case kFloat32:
      return launch<float>(x, scale, e5m2, row, col, amax, M, N, s);
    default:
      return cudaErrorInvalidValue;
  }
}
