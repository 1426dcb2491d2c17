// Small-M decode GEMM against a block-scaled resident weight stored
// contraction-major (K, N):
//   out[m, n] = out_scale * sum_k x[m, k] * bf16(w[k, n] * s[k / block, n])
// x is (M <= 32, K) bf16 or f32; the payload is (K, N) e4m3 bytes, or
// (K/2, N) uint8 split-plane packed e2m1 codes (the low nibble of byte row
// r is code row r, the high nibble code row r + K/2); s is (K/block, N)
// bf16; out_scale an optional device scalar; out (M, N) f32.
//
// Replaces transformerengine_tpu/ops/decode_matmul.py decode_kn_matvec
// (the Pallas `_kn_kernel`, with `_unpack_nibbles_to_bf16` and
// `_e2m1_code_to_e4m3_bits`). As there, each weight is dequantized to bf16
// by its block scale (a bf16 product, exact for these payloads and
// power-of-two or e4m3 scales), multiplied by x in f32 and summed in f32;
// out_scale goes on the f32 sum.
//
// Bound on an H100: bytes. Each payload byte feeds 2*M flops (16 at
// M = 8), so the floor is the payload plus the scales over 3.35 TB/s:
// 218 M e4m3 weights and 13.6 MB of scales for the four GEMMs of one
// LLAMA_8B layer, about 0.069 ms.
//
// Design: a block owns 128 columns and 1024 stored rows. Its 256 threads
// are 8 across the columns (16 columns each, one 16-byte load a row, so a
// row of the tile is one 128-byte line) by 32 down the rows (32
// consecutive rows each, so a thread loads its block scale once per 32
// rows). Each thread keeps 8 rows of x times 16 columns of partial sums in
// f32 registers; x's rows of the chunk are staged in shared memory. The
// 32 row-threads' sums meet through warp shuffles and shared memory, and
// the block writes its chunk's (M, 128) partial sums. The K chunks are
// split across blocks (blockIdx.y) so that enough blocks fill the card
// (N = 4096 has 32 column tiles); a second kernel adds the chunks' sums in
// a fixed order, so the result is the same from run to run (no atomics).
// M > 8 takes one pass over the chunk per 8 rows of x.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kColT = 8;                     // threads across the columns
constexpr int kRowT = kThreads / kColT;      // threads down the rows
constexpr int kTileN = kColT * 16;           // 128 columns a block
constexpr int kRowsPer = 32;                 // rows a thread
constexpr int kChunk = kRowT * kRowsPer;     // 1024 stored rows a block
constexpr int kMT = 8;                       // rows of x a pass
// x is staged [kMT][kXLd]: 4 floats of padding after every 32 rows, so
// that the 4 row-threads of a warp read 16-byte vectors from distinct
// banks.
constexpr int kXLd = kChunk + kChunk / kRowsPer * 4;

__device__ __forceinline__ int xpos(int r) { return r + (r >> 5) * 4; }

// The value of a 4-bit e2m1 code ({0, .5, 1, 1.5, 2, 3, 4, 6}, sign in
// bit 3) built from its f32 bits: the same grid values as the reference's
// exact e2m1 -> e4m3 re-encoding.
__device__ __forceinline__ float e2m1_value(uint32_t code) {
  const uint32_t mag = code & 7u;
  uint32_t bits = 0;
  if (mag == 1) bits = 126u << 23;
  else if (mag >= 2) bits = (((mag >> 1) + 126u) << 23) | ((mag & 1u) << 22);
  return __uint_as_float(bits | ((code & 8u) << 28));
}

// Rounds the block-scaled weight to bf16, as the reference's bf16
// multiply does (exact for e4m3 and e2m1 payloads times bf16 scales
// inside bf16's normal range).
__device__ __forceinline__ float dq(float w, float s) {
  return __bfloat162float(__float2bfloat16_rn(w * s));
}

__device__ __forceinline__ void load_scales(const __nv_bfloat16* p,
                                            float* out) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  widen16<__nv_bfloat16>(a, out);
  widen16<__nv_bfloat16>(b, out + 8);
}

template <typename XT>
__device__ __forceinline__ void stage_x(float* xs, const XT* __restrict__ x,
                                        int m0, int M, int K, int col0,
                                        int rows) {
  for (int i = threadIdx.x; i < kMT * kChunk; i += kThreads) {
    const int m = i / kChunk;
    const int r = i - m * kChunk;
    float v = 0.f;
    if (m0 + m < M && r < rows) v = to_float(x[(size_t)(m0 + m) * K + col0 + r]);
    xs[m * kXLd + xpos(r)] = v;
  }
}

// Adds 4 consecutive rows' worth of products into acc: w[u][c] is row u's
// dequantized weight of column c, xs the staged x at the first row.
__device__ __forceinline__ void fma_rows(float (&acc)[kMT][16],
                                         const float (&w)[16],
                                         const float* xs, int u) {
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    const float xv = xs[m * kXLd + u];
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[m][c] = fmaf(xv, w[c], acc[m][c]);
  }
}

template <typename XT, bool PACKED>
__global__ void __launch_bounds__(kThreads, 1)
    kn_matvec_kernel(const XT* __restrict__ x,
                     const uint8_t* __restrict__ payload,
                     const __nv_bfloat16* __restrict__ scale,
                     float* __restrict__ partial, int M, int N, int K,
                     int block) {
  extern __shared__ float smem[];
  float* xs_lo = smem;                         // [kMT][kXLd]
  float* xs_hi = smem + kMT * kXLd;            // packed only
  float* red = smem + (PACKED ? 2 : 1) * kMT * kXLd;  // [8 warps][kMT][128]

  const int k_store = PACKED ? K / 2 : K;
  const int col_t = threadIdx.x & (kColT - 1);
  const int row_t = threadIdx.x / kColT;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kTileN + col_t * 16;
  const int r0 = blockIdx.y * kChunk;
  const int rows = min(kChunk, k_store - r0);   // a multiple of 4
  const int my0 = row_t * kRowsPer;             // first row in the chunk
  const int my_rows = max(0, min(kRowsPer, rows - my0));
  const bool col_ok = n0 < N;

  for (int m0 = 0; m0 < M; m0 += kMT) {
    __syncthreads();  // the previous pass no longer reads shared memory
    stage_x(xs_lo, x, m0, M, K, r0, rows);
    if (PACKED) stage_x(xs_hi, x, m0, M, K, K / 2 + r0, rows);
    __syncthreads();

    float acc[kMT][16];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[m][c] = 0.f;

    if (col_ok) {
      float s_lo[16], s_hi[16];
      int g_lo = -1, g_hi = -1;
      for (int i = 0; i < my_rows; i += 4) {
        const int r = r0 + my0 + i;  // stored row of the first of 4
        uint4 raw[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          raw[u] = __ldg(reinterpret_cast<const uint4*>(
              payload + (size_t)(r + u) * N + n0));
        // A group of 4 rows never crosses a block (block % 4 == 0).
        if (r / block != g_lo) {
          g_lo = r / block;
          load_scales(scale + (size_t)g_lo * N + n0, s_lo);
        }
        if (PACKED && (r + K / 2) / block != g_hi) {
          g_hi = (r + K / 2) / block;
          load_scales(scale + (size_t)g_hi * N + n0, s_hi);
        }
        const float* xl = xs_lo + xpos(my0 + i);
        const float* xh = xs_hi + xpos(my0 + i);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float w[16];
          if (PACKED) {
            const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&raw[u]);
#pragma unroll
            for (int c = 0; c < 16; ++c)
              w[c] = dq(e2m1_value(bytes[c] & 15u), s_lo[c]);
            fma_rows(acc, w, xl, u);
#pragma unroll
            for (int c = 0; c < 16; ++c)
              w[c] = dq(e2m1_value(bytes[c] >> 4), s_hi[c]);
            fma_rows(acc, w, xh, u);
          } else {
            widen16<__nv_fp8_e4m3>(raw[u], w);
#pragma unroll
            for (int c = 0; c < 16; ++c) w[c] = dq(w[c], s_lo[c]);
            fma_rows(acc, w, xl, u);
          }
        }
      }
    }

    // The 4 row-threads of a warp (lanes col_t, +8, +16, +24), then the 8
    // warps in order.
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        float v = acc[m][c];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[m][c] = v;
      }
    if (lane < kColT) {
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int c = 0; c < 16; ++c)
          red[(warp * kMT + m) * kTileN + lane * 16 + c] = acc[m][c];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kMT * kTileN; i += kThreads) {
      const int m = i / kTileN;
      const int col = i - m * kTileN;
      const int n = blockIdx.x * kTileN + col;
      if (m0 + m >= M || n >= N) continue;
      float s = 0.f;
      for (int w = 0; w < kThreads / 32; ++w)
        s += red[(w * kMT + m) * kTileN + col];
      partial[((size_t)blockIdx.y * M + m0 + m) * N + n] = s;
    }
  }
}

// out[m, n] = out_scale * the sum over the K chunks, in chunk order.
__global__ void kn_reduce_kernel(const float* __restrict__ partial,
                                 const float* __restrict__ out_scale,
                                 float* __restrict__ out, int MN, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[(size_t)k * MN + i];
  if (out_scale != nullptr) s *= out_scale[0];
  out[i] = s;
}

template <typename XT, bool PACKED>
cudaError_t launch(const void* x, const void* payload, const void* scale,
                   float* ws, int M, int N, int K, int block, int splits,
                   cudaStream_t stream) {
  auto kernel = kn_matvec_kernel<XT, PACKED>;
  const size_t smem =
      sizeof(float) * ((PACKED ? 2 : 1) * (size_t)kMT * kXLd +
                       (size_t)(kThreads / 32) * kMT * kTileN);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTileN - 1) / kTileN, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(payload),
      static_cast<const __nv_bfloat16*>(scale), ws, M, N, K, block);
  return cudaGetLastError();
}

}  // namespace

// ws holds ceil(K_store / 1024) * M * N floats (K_store = K, or K / 2
// packed): each K chunk's partial sums.
extern "C" int te_decode_kn_matvec(const void* x, int x_dtype,
                                   const void* payload, int packed,
                                   const void* scale, const float* out_scale,
                                   float* ws, float* out, int M, int N, int K,
                                   int block, void* stream) {
  const int k_store = packed ? K / 2 : K;
  if (M < 1 || M > 32 || N < 16 || N % 16 != 0 || block < 4 ||
      block % 4 != 0 || K % block != 0 || (packed && K % (2 * block) != 0))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = (k_store + kChunk - 1) / kChunk;
  cudaError_t err;
  if (x_dtype == kBFloat16)
    err = packed ? launch<__nv_bfloat16, true>(x, payload, scale, ws, M, N, K,
                                               block, splits, s)
                 : launch<__nv_bfloat16, false>(x, payload, scale, ws, M, N,
                                                K, block, splits, s);
  else if (x_dtype == kFloat32)
    err = packed ? launch<float, true>(x, payload, scale, ws, M, N, K, block,
                                       splits, s)
                 : launch<float, false>(x, payload, scale, ws, M, N, K, block,
                                        splits, s);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  const int mn = M * N;
  kn_reduce_kernel<<<(mn + 255) / 256, 256, 0, s>>>(ws, out_scale, out, mn,
                                                   splits);
  return cudaGetLastError();
}
