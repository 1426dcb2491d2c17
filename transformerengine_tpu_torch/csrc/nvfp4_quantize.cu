// NVFP4 quantize of an (M, N) tensor, M and N multiples of 16, in two
// passes that each read x once:
//   te_nvfp4_amax_2x      amax(|x|) and amax(|RHT(x^T)|), the inputs of
//                         the two per-tensor scales;
//   te_nvfp4_quantize_2x  the rowwise (M, N) payload with its (M, N/16)
//                         e4m3 block scales under ts_row, and the colwise
//                         (N, M) payload, x^T rotated along M in runs of
//                         16 when asked, with its (N, M/16) scales under
//                         ts_col. Payloads are e2m1 values in e4m3 bytes.
//
// Replaces transformerengine_tpu/ops/quantize_kernels.py nvfp4_amax_2x
// (`_nvfp4_amax_kernel`) and nvfp4_quantize_2x (`_nvfp4_cast_kernel`,
// `_nvfp4_quantize_block`, `_rht_rotate`, `_fp4_grid_round[_sr]`).
// Bit-exact to quantize/qmath.py nvfp4_encode of each orientation:
//   s_e4m3 = e4m3(clip((bamax / 6) / ts, +-448)), s_eff = s_e4m3 * ts,
//   inv = s_eff > 0 ? 1 / max(s_eff, 2^-126) : 0, y = x * inv,
// y rounded onto the e2m1 grid by the table of bounds and ties, the sign
// kept (a negative y that rounds to 0 is -0, byte 0x80); or, with a key,
// stochastically from lowbias32(index ^ key) (qmath.sr_bits). The RHT
// sums its 16 exact products (the entries are +-1/4) in one fixed order,
// that of quantize/hadamard.py: four partial sums of i = r, r+4, r+8,
// r+12 from +0, then (s0 + s1) + (s2 + s3). The cross-block amax is an
// atomicMax on the f32 bits, exact for non-negative values.
//
// Bound on an H100: bytes. At the MLP's (4096, 14336) bf16 the amax pass
// reads 117 MB (35 us at 3.35 TB/s) and the quantize pass reads 117 MB
// and writes two one-byte payloads and two scale grids, 242 MB (72 us);
// the RHT's 32 f32 operations an element (1.9 GFLOP) fit under the bytes.
//
// Design: one block of 256 threads per 64 x 64 tile. Each thread loads
// 16 consecutive elements of one row (16-byte loads) and quantizes them
// as one rowwise block, a 16-byte store of codes; the tile goes through
// shared memory (17.7 KB with the matrix) so that each thread then reads
// 16 consecutive rows of one column, rotates them (the matrix built from
// the sign mask in shared memory) and quantizes them as one colwise
// block. Edges are masked in 16-element groups. Left for later:
// coalesced colwise stores, more bytes in flight per thread.
#include "common.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kPad = kTile + 1;

// Entry (i, j) of the normalized Hadamard matrix with row i negated where
// bit i of the mask is set (quantize/hadamard.py rht_matrix_np).
__device__ __forceinline__ float rht_entry(int i, int j, int mask) {
  const float v = (__popc(i & j) & 1) ? -0.25f : 0.25f;
  return ((mask >> i) & 1) ? -v : v;
}

__device__ __forceinline__ void build_rht(float* h, int mask) {
  for (int e = threadIdx.x; e < 256; e += blockDim.x)
    h[e] = rht_entry(e >> 4, e & 15, mask);
}

// out[j] = sum_i v[i] * h[i][j] in the order stated above.
__device__ __forceinline__ void rotate16(const float* v, const float* h,
                                         float* out) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float s[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int i = r; i < 16; i += 4)
        acc = __fadd_rn(acc, __fmul_rn(v[i], h[i * 16 + j]));
      s[r] = acc;
    }
    out[j] = __fadd_rn(__fadd_rn(s[0], s[1]), __fadd_rn(s[2], s[3]));
  }
}

__device__ __forceinline__ float fp4_value(int idx) {
  switch (idx) {
    case 0: return 0.f;
    case 1: return 0.5f;
    case 2: return 1.f;
    case 3: return 1.5f;
    case 4: return 2.f;
    case 5: return 3.f;
    case 6: return 4.f;
    default: return 6.f;
  }
}

// The e4m3 byte of the e2m1 magnitude with index idx (0x00, 0x30, 0x38,
// 0x3C, 0x40, 0x44, 0x48, 0x4C), with the sign of y.
__device__ __forceinline__ uint8_t fp4_byte(int idx, float y) {
  const int mag = idx < 2 ? idx * 48 : idx * 4 + 48;
  return static_cast<uint8_t>(mag | (signbit(y) ? 0x80 : 0));
}

// Round to nearest on the grid; a value on a bound goes up where the
// bound's index is odd (qmath._FP4_TIE_UP).
__device__ __forceinline__ uint8_t fp4_round(float y) {
  const float ax = fminf(fabsf(y), 6.f);
  const float bounds[7] = {0.25f, 0.75f, 1.25f, 1.75f, 2.5f, 3.5f, 5.f};
  int lo = 0, hi = 0;
#pragma unroll
  for (int b = 0; b < 7; ++b) {
    lo += ax > bounds[b];
    hi += ax >= bounds[b];
  }
  const int idx = (lo != hi && (lo & 1)) ? hi : lo;
  return fp4_byte(idx, y);
}

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// Stochastic rounding between the two grid neighbours of |y|
// (qmath._stochastic_cast_fp4): up with probability (|y| - lo) / (up - lo).
__device__ __forceinline__ uint8_t fp4_round_sr(float y, uint32_t bits) {
  const float ax = fminf(fabsf(y), 6.f);
  int il = -1;
#pragma unroll
  for (int i = 0; i < 8; ++i) il += ax >= fp4_value(i);
  il = min(max(il, 0), 7);
  const int iu = min(il + 1, 7);
  const float lo = fp4_value(il), up = fp4_value(iu);
  const float p = up > lo
      ? __fdiv_rn(__fsub_rn(ax, lo), fmaxf(__fsub_rn(up, lo), 0x1p-126f))
      : 0.f;
  const float u = __fmul_rn(static_cast<float>(bits >> 8), 0x1p-24f);
  return fp4_byte(u < p ? iu : il, y);
}

// One 16-element block: its 16 code bytes into `codes` and its e4m3 scale
// byte returned. `index` is the payload index of v[0] (for the random
// bits of stochastic rounding, with key `key`).
__device__ __forceinline__ uint8_t quantize16(const float* v, float ts,
                                              bool sr, uint32_t key,
                                              uint32_t index,
                                              uint8_t* codes) {
  float bamax = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) bamax = fmaxf(bamax, fabsf(v[i]));
  const float q = fminf(fmaxf(__fdiv_rn(__fdiv_rn(bamax, 6.f), ts), -448.f),
                        448.f);
  const __nv_fp8_storage_t s8 =
      __nv_cvt_float_to_fp8(q, __NV_SATFINITE, __NV_E4M3);
  const float s_e4m3 = __half2float(__half(__nv_cvt_fp8_to_halfraw(
      s8, __NV_E4M3)));
  const float s_eff = __fmul_rn(s_e4m3, ts);
  const float inv = s_eff > 0.f ? __fdiv_rn(1.f, fmaxf(s_eff, 0x1p-126f))
                                : 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float y = __fmul_rn(v[i], inv);
    codes[i] = sr ? fp4_round_sr(y, lowbias32((index + i) ^ key))
                  : fp4_round(y);
  }
  return s8;
}

__device__ __forceinline__ void store16(uint8_t* dst, const uint8_t* codes) {
  uint4 raw;
  uint8_t* b = reinterpret_cast<uint8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i) b[i] = codes[i];
  *reinterpret_cast<uint4*>(dst) = raw;
}

// Loads this thread's 16 elements (row t / 4 of the tile, columns
// 16 * (t % 4) ...) to v and to the tile in shared memory; false (and
// zeros) where the group lies outside x.
template <typename T>
__device__ __forceinline__ bool load_tile(const T* __restrict__ x, int M,
                                          int N, int m0, int n0, float* v,
                                          float* tile) {
  const int lr = threadIdx.x >> 2, g = threadIdx.x & 3;
  const int m = m0 + lr, n = n0 + 16 * g;
  const bool ok = m < M && n < N;
  if (ok) {
    constexpr int kVec = 16 / sizeof(T);
    const T* p = x + static_cast<size_t>(m) * N + n;
#pragma unroll
    for (int k = 0; k < 16; k += kVec) load16(p + k, v + k);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = 0.f;
  }
  if (tile != nullptr) {
#pragma unroll
    for (int i = 0; i < 16; ++i) tile[lr * kPad + 16 * g + i] = v[i];
  }
  return ok;
}

// This thread's colwise run: column t % 64 of the tile, rows
// 16 * (t / 64) ... ; false where it lies outside x.
__device__ __forceinline__ bool column_run(const float* tile, int M, int N,
                                           int m0, int n0, float* w) {
  const int lc = threadIdx.x & 63, j = threadIdx.x >> 6;
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = tile[(16 * j + i) * kPad + lc];
  return n0 + lc < N && m0 + 16 * j < M;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    nvfp4_amax_kernel(const T* __restrict__ x, int with_rht, int mask,
                      float* __restrict__ out, int M, int N) {
  __shared__ float tile[kTile * kPad];
  __shared__ float h[256];
  __shared__ float scratch[kThreads / 32];
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  if (with_rht) build_rht(h, mask);
  float v[16];
  load_tile(x, M, N, m0, n0, v, with_rht ? tile : nullptr);
  float arow = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) arow = fmaxf(arow, fabsf(v[i]));
  float acol = arow;
  if (with_rht) {
    __syncthreads();
    float w[16], rot[16];
    acol = 0.f;
    if (column_run(tile, M, N, m0, n0, w)) {
      rotate16(w, h, rot);
#pragma unroll
      for (int i = 0; i < 16; ++i) acol = fmaxf(acol, fabsf(rot[i]));
    }
  }
  block_amax_to(arow, scratch, out);
  __syncthreads();
  block_amax_to(acol, scratch, out + 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    nvfp4_quantize_kernel(const T* __restrict__ x,
                          const float* __restrict__ ts, int with_rht,
                          int mask, int sr, uint32_t key_row,
                          uint32_t key_col, uint8_t* __restrict__ row,
                          uint8_t* __restrict__ srow,
                          uint8_t* __restrict__ col,
                          uint8_t* __restrict__ scol, int M, int N) {
  __shared__ float tile[kTile * kPad];
  __shared__ float h[256];
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  if (with_rht) build_rht(h, mask);
  const float ts_row = ts[0], ts_col = ts[1];
  float v[16];
  uint8_t codes[16];
  if (load_tile(x, M, N, m0, n0, v, tile)) {
    const int m = m0 + (threadIdx.x >> 2), n = n0 + 16 * (threadIdx.x & 3);
    const size_t off = static_cast<size_t>(m) * N + n;
    const uint8_t s = quantize16(v, ts_row, sr, key_row,
                                 static_cast<uint32_t>(off), codes);
    store16(row + off, codes);
    srow[static_cast<size_t>(m) * (N / 16) + n / 16] = s;
  }
  __syncthreads();
  float w[16];
  if (column_run(tile, M, N, m0, n0, w)) {
    if (with_rht) {
      float rot[16];
      rotate16(w, h, rot);
#pragma unroll
      for (int i = 0; i < 16; ++i) w[i] = rot[i];
    }
    const int n = n0 + (threadIdx.x & 63), m = m0 + 16 * (threadIdx.x >> 6);
    const size_t off = static_cast<size_t>(n) * M + m;
    const uint8_t s = quantize16(w, ts_col, sr, key_col,
                                 static_cast<uint32_t>(off), codes);
    store16(col + off, codes);
    scol[static_cast<size_t>(n) * (M / 16) + m / 16] = s;
  }
}

bool shape_ok(int M, int N) {
  return M > 0 && N > 0 && M % 16 == 0 && N % 16 == 0 &&
         static_cast<long long>(M) * N < (1LL << 32);
}

dim3 tiles(int M, int N) {
  return dim3((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
}

}  // namespace

// out (2,) f32, zeroed by the caller: amax(|x|), amax(|RHT(x^T)|) (the
// first again without the RHT).
extern "C" int te_nvfp4_amax_2x(const void* x, int x_dtype, int with_rht,
                                int mask, void* out, int M, int N,
                                void* stream) {
  if (!shape_ok(M, N) || out == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (x_dtype) {
    case kBFloat16:
      nvfp4_amax_kernel<<<tiles(M, N), kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), with_rht, mask, o, M, N);
      break;
    case kFloat32:
      nvfp4_amax_kernel<<<tiles(M, N), kThreads, 0, s>>>(
          static_cast<const float*>(x), with_rht, mask, o, M, N);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ts (2,) f32 device: the rowwise and colwise tensor scales. With `sr`,
// stochastic rounding from the keys of qmath.sr_key(seed, 0 / 1).
extern "C" int te_nvfp4_quantize_2x(const void* x, int x_dtype,
                                    const void* ts, int with_rht, int mask,
                                    int sr, unsigned key_row,
                                    unsigned key_col, void* row, void* srow,
                                    void* col, void* scol, int M, int N,
                                    void* stream) {
  if (!shape_ok(M, N) || ts == nullptr || row == nullptr ||
      srow == nullptr || col == nullptr || scol == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(ts);
  uint8_t* r = static_cast<uint8_t*>(row);
  uint8_t* sr8 = static_cast<uint8_t*>(srow);
  uint8_t* c = static_cast<uint8_t*>(col);
  uint8_t* sc8 = static_cast<uint8_t*>(scol);
  switch (x_dtype) {
    case kBFloat16:
      nvfp4_quantize_kernel<<<tiles(M, N), kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), t, with_rht, mask, sr,
          key_row, key_col, r, sr8, c, sc8, M, N);
      break;
    case kFloat32:
      nvfp4_quantize_kernel<<<tiles(M, N), kThreads, 0, s>>>(
          static_cast<const float*>(x), t, with_rht, mask, sr, key_row,
          key_col, r, sr8, c, sc8, M, N);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
