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
// 65 us for the four fp8 GEMMs of one LLAMA_8B layer. At that rate each SM
// must take in about 14 e4m3 weights a cycle.
//
// A bf16 x runs on the tensor cores (tn_mma_kernel): the products of
// bf16 x and the weight widened exactly to bf16 are exact in
// mma.m16n8k16's f32 sums, as the reference's (a bf16 dot with f32
// accumulation). decode_mma.cuh has the fragment map: W is the A operand,
// fed from 16-byte loads of 16 k of two rows a lane, and x^T the B
// operand. A block owns RT 16-row tiles (one where N / 16 blocks fill the
// card at most once, else two, and one B fragment then serves both); its 8
// warps split K in steps of 64 (warp w takes steps w, w + 8, ...), each
// with kU steps' loads in flight, and add their sums through shared memory
// in warp order: one launch, no atomics. W's loads stream past L1 (read
// once, they would evict x, which every block reads again). An e4m3 weight
// widens two at a time (a cvt to f16, a shift, two logic operations and a
// bf16 product) where the FMA body needs 8 FMAs a weight at M = 8.
//
// An f32 x keeps the FMA body (tn_matvec_kernel), since a bf16 operand
// would round it: each warp streams R rows of W along K with 16-byte loads,
// two steps of 32 lanes x 16 bytes at a time so that 2R loads are in flight
// per lane, widens them once (e4m3 two at a time) and keeps R*M partial
// sums per lane in f32 registers; a warp-shuffle sum finishes each dot
// product. x is reused by every row, so the block stages it in shared
// memory in its own dtype, 64 KB at a time (the whole of x does not fit
// for M = 32). R falls as M grows to bound the registers.
#include "common.cuh"
#include "decode_mma.cuh"

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

// The tensor-core body for a bf16 x: MT n8 tiles of x's rows (M <= 8 MT),
// RT 16-row tiles of W a block.
template <typename WT, int MT, int RT>
__global__ void __launch_bounds__(kThreads, 1)
    tn_mma_kernel(const __nv_bfloat16* __restrict__ x,
                  const WT* __restrict__ w, const float* __restrict__ scale,
                  float* __restrict__ out, int M, int N, int K) {
  using decode_mma::word;
  extern __shared__ float red[];  // [kWarps][MT * 8][kRedLd]
  constexpr int kRows = RT * 16;
  constexpr int kRedLd = kRows + 4;  // 8t + g: distinct banks for D
  constexpr bool kFp8 = sizeof(WT) == 1;
  constexpr int kLoads = kFp8 ? 1 : 2;  // 16-byte loads a row and step
  // Steps whose loads are in flight: about 8 KB of W a warp.
  constexpr int kU = (kFp8 ? 4 : 2) / MT > 0 ? (kFp8 ? 4 : 2) / MT : 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kRows;
  const int steps = (K + 63) / 64;

  const WT* wp[RT][2];
  bool wok[RT][2];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 16 * r + 8 * h + g;
      wok[r][h] = n < N;
      wp[r][h] = w + (size_t)(wok[r][h] ? n : 0) * K + 16 * t;
    }
  const __nv_bfloat16* xp[MT];
  bool xok[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    xok[i] = 8 * i + g < M;
    xp[i] = x + (size_t)(xok[i] ? 8 * i + g : 0) * K + 16 * t;
  }

  float acc[RT][MT][4];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][i][e] = 0.f;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int s0 = warp; s0 < steps; s0 += kWarps * kU) {
    uint4 wr[kU][RT][2][kLoads], xr[kU][MT][2];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int k = (s0 + u * kWarps) * 64;
      const bool kok = k + 16 * t < K;  // K % 16 == 0: whole 16-k pieces
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int l = 0; l < kLoads; ++l)
            wr[u][r][h][l] =
                kok && wok[r][h]
                    ? ldg_stream(reinterpret_cast<const uint4*>(wp[r][h] + k) +
                                 l)
                    : zero;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int l = 0; l < 2; ++l)
          xr[u][i][l] =
              kok && xok[i]
                  ? __ldg(reinterpret_cast<const uint4*>(xp[i] + k) + l)
                  : zero;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        // a[h][q]: bf16 pair q (k 2q, 2q + 1 of the lane's 16) of row h.
        uint32_t a[2][8];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            if constexpr (kFp8) {
              const uint32_t v = word(wr[u][r][h][0], q / 2);
              a[h][q] = decode_mma::e4m3x2_to_bf16x2(q % 2 ? v >> 16 : v);
            } else {
              a[h][q] = word(wr[u][r][h][q / 4], q % 4);
            }
          }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t af[4] = {a[0][2 * j], a[1][2 * j], a[0][2 * j + 1],
                                  a[1][2 * j + 1]};
#pragma unroll
          for (int i = 0; i < MT; ++i)
            mma_bf16(acc[r][i], af, word(xr[u][i][j / 2], (2 * j) % 4),
                     word(xr[u][i][j / 2], (2 * j + 1) % 4));
        }
      }
  }

  // The warps' sums in warp order, then the scale.
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float* p = red + (warp * MT * 8 + 8 * i + 2 * t) * kRedLd + 16 * r + g;
      p[0] = acc[r][i][0];
      p[kRedLd] = acc[r][i][1];
      p[8] = acc[r][i][2];
      p[kRedLd + 8] = acc[r][i][3];
    }
  __syncthreads();
  const float s = scale != nullptr ? *scale : 1.f;
  for (int e = threadIdx.x; e < MT * 8 * kRows; e += kThreads) {
    const int m = e / kRows;
    const int row = e - m * kRows;
    const int n = n0 + row;
    if (m >= M || n >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) v += red[(q * MT * 8 + m) * kRedLd + row];
    out[(size_t)m * N + n] = v * s;
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

template <int MT, int RT>
constexpr size_t mma_smem() {
  return sizeof(float) * kWarps * MT * 8 * (RT * 16 + 4);
}

template <typename WT, int MT, int RT>
cudaError_t launch_mma(const void* x, const void* w, const float* scale,
                       float* out, int M, int N, int K, cudaStream_t stream) {
  auto kernel = tn_mma_kernel<WT, MT, RT>;
  const size_t smem = mma_smem<MT, RT>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + RT * 16 - 1) / (RT * 16));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const WT*>(w), scale,
      out, M, N, K);
  return cudaGetLastError();
}

// One 16-row tile a block where those blocks fill the card at most once;
// else two, and one B fragment serves both.
template <typename WT, int MT>
cudaError_t launch_mma_rt(const void* x, const void* w, const float* scale,
                          float* out, int M, int N, int K,
                          cudaStream_t stream) {
  static const int slots = resident_blocks(
      tn_mma_kernel<WT, MT, 1>, kThreads, mma_smem<MT, 1>());
  if ((N + 15) / 16 <= slots)
    return launch_mma<WT, MT, 1>(x, w, scale, out, M, N, K, stream);
  return launch_mma<WT, MT, 2>(x, w, scale, out, M, N, K, stream);
}

template <typename WT>
cudaError_t launch_mma_m(const void* x, const void* w, const float* scale,
                         float* out, int M, int N, int K,
                         cudaStream_t stream) {
  if (M <= 8) return launch_mma_rt<WT, 1>(x, w, scale, out, M, N, K, stream);
  if (M <= 16) return launch_mma_rt<WT, 2>(x, w, scale, out, M, N, K, stream);
  return launch_mma_rt<WT, 4>(x, w, scale, out, M, N, K, stream);
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
      switch (w_dtype) {
        case kFloat8E4M3:
          return launch_mma_m<__nv_fp8_e4m3>(x, w, scale, out, M, N, K, s);
        case kBFloat16:
          return launch_mma_m<__nv_bfloat16>(x, w, scale, out, M, N, K, s);
        default:
          return cudaErrorInvalidValue;
      }
    case kFloat32:
      return launch_w<float>(w_dtype, x, w, scale, out, M, N, K, s);
    default:
      return cudaErrorInvalidValue;
  }
}
