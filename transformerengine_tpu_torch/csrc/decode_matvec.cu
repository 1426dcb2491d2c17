// Small-M decode GEMM against a resident (N, K) weight:
//   out[m, n] = scale * sum_k x[m, k] * w[n, k]      (f32 out)
// x is (M <= 32, K) bf16 or f32; w is the resident e4m3 or bf16 payload;
// scale is a device scalar (nullptr means 1).
//
// Replaces transformerengine_tpu/ops/decode_matmul.py decode_tn_matvec
// (the Pallas `_kernel`, N-tiled stripes of the resident weight).
//
// Bound on an H100: bytes. Every weight byte is read once and feeds only
// 2*M flops (16 at M = 8 for fp8), far under the ~590 flop/byte the fp8
// tensor cores need, so the floor is N*K*sizeof(w) / 3.35 TB/s: about
// 65 us for the four fp8 GEMMs of one LLAMA_8B layer. This design works
// on the CUDA cores, though: each SM must widen about 25 weights a cycle
// to e4m3's share of the memory rate, and at M = 8 each takes 8 f32 FMAs,
// more than the 128 FMA lanes and the conversion units of an SM give.
// Reaching the byte bound needs the tensor cores (mma on an exact
// e4m3-to-bf16 dequant), a later step.
//
// Design: each warp streams R rows of W along K with 16-byte loads, two
// steps of 32 lanes x 16 bytes at a time so that 2R loads are in flight
// per lane, widens them once (e4m3 two at a time) and keeps R*M partial
// sums per lane in f32 registers; a warp-shuffle sum finishes each dot
// product. x is reused by every row,
// so the block stages it in shared memory in its own dtype, 64 KB at a
// time (4096 bf16 columns at M = 8): the whole of x does not fit (M = 8
// at K = 14336 in bf16 is 229,376 B, just under the 232,448 B a block
// may use, and M = 32 is four times over). R falls as M grows to bound
// the registers.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageBytes = 64 * 1024;  // x staged per pass
constexpr int kUnroll = 2;              // K steps whose loads are in flight

template <typename XT, int MAXM>
__host__ __device__ constexpr int chunk_of() {
  return kStageBytes / (MAXM * static_cast<int>(sizeof(XT)));
}

// Widens the n-th element of a 16-byte register vector of T.
template <typename T>
__device__ __forceinline__ float elem(const uint4& v, int n) {
  return to_float(reinterpret_cast<const T*>(&v)[n]);
}

template <typename XT, typename WT, int MAXM, int R>
__global__ void __launch_bounds__(kThreads)
    tn_matvec_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                     const float* __restrict__ scale, float* __restrict__ out,
                     int M, int N, int K) {
  extern __shared__ uint4 smem_raw[];
  XT* xs = reinterpret_cast<XT*>(smem_raw);  // [MAXM][kChunk]
  constexpr int kChunk = chunk_of<XT, MAXM>();
  constexpr int kVec = 16 / sizeof(WT);   // weights per 16-byte load
  constexpr int kXVec = 16 / sizeof(XT);  // x values per 16-byte load
  constexpr int kXLoads = kVec / kXVec > 0 ? kVec / kXVec : 1;
  static_assert(kVec >= kXVec, "x vectors must not be wider than w's");
  constexpr int kStep = 32 * kVec;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x * kWarps + warp) * R;

  float acc[R][MAXM];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MAXM; ++m) acc[r][m] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kc = min(kChunk, K - k0);  // a multiple of 16
    __syncthreads();  // the previous chunk is no longer read
    const int vecs_per_row = kc / kXVec;
    for (int i = threadIdx.x; i < M * vecs_per_row; i += kThreads) {
      const int m = i / vecs_per_row;
      const int kk = (i - m * vecs_per_row) * kXVec;
      *reinterpret_cast<uint4*>(xs + m * kChunk + kk) = __ldg(
          reinterpret_cast<const uint4*>(x + (size_t)m * K + k0 + kk));
    }
    __syncthreads();
    for (int kk = lane * kVec; kk < kc; kk += kUnroll * kStep) {
      uint4 raw[kUnroll][R];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = kk + u * kStep;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int n = row0 + r;
          raw[u][r] = (n < N && k < kc)
                          ? __ldg(reinterpret_cast<const uint4*>(
                                w + (size_t)n * K + k0 + k))
                          : make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = kk + u * kStep;
        if (k >= kc) break;
        float wf[R][kVec];
#pragma unroll
        for (int r = 0; r < R; ++r) widen16<WT>(raw[u][r], wf[r]);
#pragma unroll
        for (int m = 0; m < MAXM; ++m) {
          if (m < M) {
            uint4 xv[kXLoads];
#pragma unroll
            for (int l = 0; l < kXLoads; ++l)
              xv[l] = *reinterpret_cast<const uint4*>(xs + m * kChunk + k +
                                                      l * kXVec);
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
              const float xf = elem<XT>(xv[j / kXVec], j % kXVec);
#pragma unroll
              for (int r = 0; r < R; ++r)
                acc[r][m] = fmaf(xf, wf[r][j], acc[r][m]);
            }
          }
        }
      }
    }
  }

  const float s = scale != nullptr ? *scale : 1.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int n = row0 + r;
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      if (m < M) {
        const float v = warp_sum(acc[r][m]);
        if (lane == 0 && n < N) out[(size_t)m * N + n] = v * s;
      }
    }
  }
}

template <typename XT, typename WT, int MAXM, int R>
cudaError_t launch(const void* x, const void* w, const float* scale,
                   float* out, int M, int N, int K, cudaStream_t stream) {
  auto kernel = tn_matvec_kernel<XT, WT, MAXM, R>;
  const size_t smem = kStageBytes;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int rows_per_block = kWarps * R;
  const dim3 grid((N + rows_per_block - 1) / rows_per_block);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const XT*>(x),
                                           static_cast<const WT*>(w), scale,
                                           out, M, N, K);
  return cudaGetLastError();
}

template <typename XT, typename WT>
cudaError_t launch_m(const void* x, const void* w, const float* scale,
                     float* out, int M, int N, int K, cudaStream_t stream) {
  if (M <= 8) return launch<XT, WT, 8, 4>(x, w, scale, out, M, N, K, stream);
  if (M <= 16) return launch<XT, WT, 16, 2>(x, w, scale, out, M, N, K, stream);
  if (M <= 32) return launch<XT, WT, 32, 1>(x, w, scale, out, M, N, K, stream);
  return cudaErrorInvalidValue;
}

template <typename XT>
cudaError_t launch_w(int w_dtype, const void* x, const void* w,
                     const float* scale, float* out, int M, int N, int K,
                     cudaStream_t stream) {
  switch (w_dtype) {
    case kFloat8E4M3:
      return launch_m<XT, __nv_fp8_e4m3>(x, w, scale, out, M, N, K, stream);
    case kBFloat16:
      return launch_m<XT, __nv_bfloat16>(x, w, scale, out, M, N, K, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int te_decode_tn_matvec(const void* x, int x_dtype, const void* w,
                                   int w_dtype, const float* scale, float* out,
                                   int M, int N, int K, void* stream) {
  if (M < 1 || M > 32 || N < 1 || K < 1 || K % 16 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kBFloat16:
      return launch_w<__nv_bfloat16>(w_dtype, x, w, scale, out, M, N, K, s);
    case kFloat32:
      return launch_w<float>(w_dtype, x, w, scale, out, M, N, K, s);
    default:
      return cudaErrorInvalidValue;
  }
}
