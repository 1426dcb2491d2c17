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
// A bf16 x with a block of 16 or a multiple runs on the tensor cores
// (kn_mma_kernel; decode_mma.cuh has the fragment map): a warp owns 128
// columns, each lane 16 of them at 4 stored rows a step (4 16-byte loads,
// which stream past L1), and dequantizes in registers: e4m3 pairs of two
// rows, interleaved by prmt, widen exactly to bf16 and take their block
// scales in one bf16 pair product, rounding as the reference's multiply;
// packed bytes turn into bf16 pairs of their two codes by prmt lookups of
// the magnitudes' bytes, then take the scale pair {s[r / block, n],
// s[(r + K/2) / block, n]}. A 16-row step never crosses a block. The 8
// warps of a block split its chunk of rows, two steps' loads in flight
// each, and add their sums through shared memory in warp order. Where the
// column tiles' blocks cannot fill the card once, K is also split across
// blocks (blockIdx.y) until they do; each block writes its chunk's partial
// sums, and the last block of a column tile to finish (a ticket counter,
// which it resets) adds them in chunk order: one launch, and the same
// result from run to run (no float atomics).
//
// An f32 x (and another block) keeps the FMA body, kn_matvec_kernel: a
// block owns 128 columns and 1024 stored rows. Its 256 threads are 8 across
// the columns (16 columns each, one 16-byte load a row, so a row of the
// tile is one 128-byte line) by 32 down the rows (32 consecutive rows each,
// so a thread loads its block scale once per 32 rows). Each thread keeps 8
// rows of x times 16 columns of partial sums in f32 registers; x's rows of
// the chunk are staged in shared memory. The 32 row-threads' sums meet
// through warp shuffles and shared memory, and the block writes its
// chunk's (M, 128) partial sums; a second kernel adds the chunks' sums in
// chunk order. M > 8 takes one pass over the chunk per 8 rows of x.
#include "common.cuh"
#include "decode_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kColT = 8;                     // threads across the columns
constexpr int kRowT = kThreads / kColT;      // threads down the rows
constexpr int kTileN = kColT * 16;           // 128 columns a block
constexpr int kWarps = kThreads / 32;
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

// The tensor-core body's chunks of K hold at least kMmaChunk stored rows
// (the workspace holds ceil(K_store / kMmaChunk) chunks; _KN_CHUNK in
// ops/decode_matmul.py).
constexpr int kMmaChunk = 256;
constexpr int kMaxTiles = 4096;  // column tiles with a ticket counter

// The column tiles' tickets: how many of a tile's blocks have written
// their partial sums. The last resets its tile's to 0, so every launch
// finds them at 0. Launches on two streams at once would share them; the
// port launches on one.
__device__ unsigned int kn_tickets[kMaxTiles];

// The tensor-core body for a bf16 x: MT n8 tiles of x's rows (M <= 8 MT).
// Block (x, y) owns columns [128 x, 128 x + 128) and stored rows
// [chunk y, chunk (y + 1)), each warp an eighth of them.
template <bool PACKED, int MT>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 2 : 1)
    kn_mma_kernel(const __nv_bfloat16* __restrict__ x,
                  const uint8_t* __restrict__ payload,
                  const __nv_bfloat16* __restrict__ scale,
                  const float* __restrict__ out_scale,
                  float* __restrict__ ws, float* __restrict__ out, int M,
                  int N, int K, int block, int chunk) {
  using decode_mma::word;
  extern __shared__ float red[];  // [kWarps][MT * 8][kRedLd], then a flag
  constexpr int kRedLd = kTileN + 4;
  constexpr int kU = MT == 1 ? 2 : 1;  // steps whose loads are in flight
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k_store = PACKED ? K / 2 : K;
  const int col = blockIdx.x * kTileN + 16 * g;  // the group's 16 columns
  const bool nok = col < N;                      // N % 16 == 0
  const int per_warp = chunk / kWarps;           // a multiple of 16
  const int r_begin = blockIdx.y * chunk + warp * per_warp;
  const int r_end = min(k_store, r_begin + per_warp);
  const uint8_t* pp = payload + (size_t)4 * t * N + (nok ? col : 0);
  const __nv_bfloat16* sp = scale + (nok ? col : 0);
  const __nv_bfloat16* xp[MT];
  bool xok[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    xok[i] = 8 * i + g < M;
    xp[i] = x + (size_t)(xok[i] ? 8 * i + g : 0) * K + 4 * t;
  }

  float acc[MT][8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  constexpr int kScaleLoads = PACKED ? 4 : 2;  // 16 columns, 1 or 2 rows
  constexpr int kXLoads = PACKED ? 2 : 1;      // k r.., and r + K/2..
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  uint2 zero2;
  zero2.x = zero2.y = 0u;
  for (int r0 = r_begin; r0 < r_end; r0 += 16 * kU) {
    uint4 raw[kU][4], sc[kU][kScaleLoads];
    uint2 xr[kU][MT][kXLoads];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = r0 + 16 * u;  // a whole step: r_end - r0 % 16 == 0
      const bool ok = r < r_end && nok;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        raw[u][q] = ok ? ldg_stream(pp + (size_t)(r + q) * N)
                       : zero4;
#pragma unroll
      for (int h = 0; h < kScaleLoads / 2; ++h) {
        const int kb = (r + h * (K / 2)) / block;  // PACKED: lo, hi rows
#pragma unroll
        for (int l = 0; l < 2; ++l)
          sc[u][2 * h + l] =
              ok ? __ldg(reinterpret_cast<const uint4*>(sp + (size_t)kb * N) +
                         l)
                 : zero4;
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < kXLoads; ++h)
          xr[u][i][h] = r < r_end && xok[i]
                            ? __ldg(reinterpret_cast<const uint2*>(
                                  xp[i] + r + h * (K / 2)))
                            : zero2;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      // s2[c]: the bf16 scale pair of the group's column c.
      uint32_t s2[16];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint32_t lo = word(sc[u][q / 4], q % 4);
        if constexpr (PACKED) {  // {s[r / block, c], s[(r + K/2) / block, c]}
          const uint32_t hi = word(sc[u][2 + q / 4], q % 4);
          s2[2 * q] = prmt(lo, hi, 0x5410);
          s2[2 * q + 1] = prmt(lo, hi, 0x7632);
        } else {  // {s[r / block, c], s[r / block, c]}
          s2[2 * q] = prmt(lo, lo, 0x1010);
          s2[2 * q + 1] = prmt(lo, lo, 0x3232);
        }
      }
      if constexpr (PACKED) {
        // k-tile kt: stored rows 2kt and 2kt + 1 of the lane's 4; its B
        // pairs x[m, r] with x[m, r + K/2].
#pragma unroll
        for (int kt = 0; kt < 2; ++kt) {
          uint32_t b[MT][2];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const uint32_t xl = kt ? xr[u][i][0].y : xr[u][i][0].x;
            const uint32_t xh = kt ? xr[u][i][1].y : xr[u][i][1].x;
            b[i][0] = prmt(xl, xh, 0x5410);
            b[i][1] = prmt(xl, xh, 0x7632);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            uint32_t d0[4], d1[4];  // columns 4q .. 4q + 3
            decode_mma::e2m1x8_to_bf16x2(word(raw[u][2 * kt], q), d0);
            decode_mma::e2m1x8_to_bf16x2(word(raw[u][2 * kt + 1], q), d1);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int j = 2 * q + h;
              const uint32_t af[4] = {mul_bf16x2(d0[2 * h], s2[2 * j]),
                                      mul_bf16x2(d0[2 * h + 1], s2[2 * j + 1]),
                                      mul_bf16x2(d1[2 * h], s2[2 * j]),
                                      mul_bf16x2(d1[2 * h + 1], s2[2 * j + 1])};
#pragma unroll
              for (int i = 0; i < MT; ++i)
                mma_bf16(acc[i][j], af, b[i][0], b[i][1]);
            }
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // Rows 0 and 1 (2 and 3) interleaved: the pair of column
          // 4q + 2h + e in the 16 bits at 16e of p[h].
          const uint32_t p01[2] = {
              prmt(word(raw[u][0], q), word(raw[u][1], q), 0x5140),
              prmt(word(raw[u][0], q), word(raw[u][1], q), 0x7362)};
          const uint32_t p23[2] = {
              prmt(word(raw[u][2], q), word(raw[u][3], q), 0x5140),
              prmt(word(raw[u][2], q), word(raw[u][3], q), 0x7362)};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = 2 * q + h;
            const uint32_t af[4] = {
                mul_bf16x2(decode_mma::e4m3x2_to_bf16x2(p01[h]), s2[2 * j]),
                mul_bf16x2(decode_mma::e4m3x2_to_bf16x2(p01[h] >> 16),
                           s2[2 * j + 1]),
                mul_bf16x2(decode_mma::e4m3x2_to_bf16x2(p23[h]), s2[2 * j]),
                mul_bf16x2(decode_mma::e4m3x2_to_bf16x2(p23[h] >> 16),
                           s2[2 * j + 1])};
#pragma unroll
            for (int i = 0; i < MT; ++i)
              mma_bf16(acc[i][j], af, xr[u][i][0].x, xr[u][i][0].y);
          }
        }
      }
    }
  }

  // The warps' sums in warp order: the chunk's sum, or with one chunk the
  // result.
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* p =
          red + (warp * MT * 8 + 8 * i + 2 * t) * kRedLd + 16 * g + 2 * j;
      p[0] = acc[i][j][0];
      p[kRedLd] = acc[i][j][1];
      p[1] = acc[i][j][2];
      p[kRedLd + 1] = acc[i][j][3];
    }
  __syncthreads();
  const int splits = gridDim.y;
  const int n0 = blockIdx.x * kTileN;
  for (int e = threadIdx.x; e < MT * 8 * kTileN; e += kThreads) {
    const int m = e / kTileN;
    const int c = e - m * kTileN;
    if (m >= M || n0 + c >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) v += red[(q * MT * 8 + m) * kRedLd + c];
    if (splits == 1)
      out[(size_t)m * N + n0 + c] = out_scale != nullptr ? v * *out_scale : v;
    else
      ws[((size_t)blockIdx.y * M + m) * N + n0 + c] = v;
  }
  if (splits == 1) return;

  // The last block of the column tile adds the chunks' sums in order.
  int* last = reinterpret_cast<int*>(red + kWarps * MT * 8 * kRedLd);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *last = atomicAdd(&kn_tickets[blockIdx.x], 1u) == (unsigned)splits - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  // Each thread's columns and rows, 8 chunks' sums at a time in flight.
  constexpr int kPer = MT * 8 * kTileN / kThreads;
  float v[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) v[e] = 0.f;
  for (int y0 = 0; y0 < splits; y0 += 8) {
    float part[kPer][8];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int m = idx / kTileN, c = idx % kTileN;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        part[e][u] = y0 + u < splits && m < M && n0 + c < N
                         ? __ldcg(ws + ((size_t)(y0 + u) * M + m) * N + n0 + c)
                         : 0.f;
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e)
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (y0 + u < splits) v[e] += part[e][u];
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    const int m = idx / kTileN, c = idx % kTileN;
    if (m < M && n0 + c < N)
      out[(size_t)m * N + n0 + c] =
          out_scale != nullptr ? v[e] * *out_scale : v[e];
  }
  if (threadIdx.x == 0) kn_tickets[blockIdx.x] = 0u;
}

template <int MT>
constexpr size_t mma_smem() {
  return sizeof(float) * kWarps * MT * 8 * (kTileN + 4) + 16;
}

template <bool PACKED, int MT>
cudaError_t launch_mma(const void* x, const void* payload, const void* scale,
                       const float* out_scale, float* ws, float* out, int M,
                       int N, int K, int block, int tiles, int chunk,
                       int splits, cudaStream_t stream) {
  auto kernel = kn_mma_kernel<PACKED, MT>;
  const size_t smem = mma_smem<MT>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles, splits), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const uint8_t*>(payload),
      static_cast<const __nv_bfloat16*>(scale), out_scale, ws, out, M, N, K,
      block, chunk);
  return cudaGetLastError();
}

template <bool PACKED>
cudaError_t launch_mma_m(const void* x, const void* payload,
                         const void* scale, const float* out_scale, float* ws,
                         float* out, int M, int N, int K, int block,
                         cudaStream_t stream) {
  // K is split so that the column tiles' blocks fill the card once (as the
  // M <= 8 instance holds them, for every M: the sums' order then does not
  // depend on M), in chunks of whole steps of every warp.
  static const int slots = resident_blocks(
      kn_mma_kernel<PACKED, 1>, kThreads, mma_smem<1>());
  const int k_store = PACKED ? K / 2 : K;
  const int tiles = (N + kTileN - 1) / kTileN;
  const int want = max(1, slots / tiles);
  const int rows = kWarps * 16;
  int chunk = ((k_store + want - 1) / want + rows - 1) / rows * rows;
  chunk = max(chunk, kMmaChunk);
  const int splits = (k_store + chunk - 1) / chunk;
  if (M <= 8)
    return launch_mma<PACKED, 1>(x, payload, scale, out_scale, ws, out, M, N,
                                 K, block, tiles, chunk, splits, stream);
  if (M <= 16)
    return launch_mma<PACKED, 2>(x, payload, scale, out_scale, ws, out, M, N,
                                 K, block, tiles, chunk, splits, stream);
  return launch_mma<PACKED, 4>(x, payload, scale, out_scale, ws, out, M, N, K,
                               block, tiles, chunk, splits, stream);
}

}  // namespace

// ws holds ceil(K_store / kMmaChunk) * M * N floats (K_store = K, or K / 2
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
  if (x_dtype == kBFloat16 && block % 16 == 0 &&
      (N + kTileN - 1) / kTileN <= kMaxTiles)
    return packed ? launch_mma_m<true>(x, payload, scale, out_scale, ws, out,
                                       M, N, K, block, s)
                  : launch_mma_m<false>(x, payload, scale, out_scale, ws, out,
                                        M, N, K, block, s);
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
