// NVFP4 quantize of an (M, N) tensor, M and N multiples of 16, in two
// passes that each read x once:
//   te_nvfp4_amax_2x      amax(|x|) and amax(|RHT(x^T)|), the inputs of
//                         the two per-tensor scales;
//   te_nvfp4_quantize_2x  the rowwise (M, N) payload with its (M, N/16)
//                         e4m3 block scales under ts_row, and the colwise
//                         (N, M) payload, x^T rotated along M in runs of
//                         16 when asked, with its (N, M/16) scales under
//                         ts_col. Payloads are e2m1 values in e4m3 bytes.
// The tensor scales need the global amax before any cast, as in the
// reference, so the passes stay two.
//
// Replaces transformerengine_tpu/ops/quantize_kernels.py nvfp4_amax_2x
// (`_nvfp4_amax_kernel`) and nvfp4_quantize_2x (`_nvfp4_cast_kernel`,
// `_nvfp4_quantize_block`, `_rht_rotate`, `_fp4_grid_round[_sr]`).
// Bit-exact to quantize/qmath.py nvfp4_encode of each orientation and to
// quantize/hadamard.py's RHT, in the forms that csrc/nvfp4.cuh derives.
//
// Bound on an H100: bytes. At the MLP's (4096, 14336) bf16 the amax pass
// reads 117 MB (35 us at 3.35 TB/s) and the quantize pass reads 117 MB
// and writes two one-byte payloads and two scale grids, 242 MB (72 us).
// The arithmetic stays under the bytes' time: the RHT in its folded form
// is 5.75 f32 operations an element (16 products and 76 sums a run of 16,
// no matrix), the rounding to nearest 7 and half a conversion (a pair of
// e4m3 bytes a cvt), the block scale about 2 (three divisions a block of
// 16). What is left is the traffic's pattern: one read stream, two code
// streams and two scale grids written in pieces of 4 to 64 bytes.
//
// Design of the quantize pass: persistent blocks of 256 threads, as many
// as the card holds at once, each walking over 64 x 128 tiles in the
// order of tile_origin. A tile arrives by cp.async into a ring of two in
// shared memory (x's own type, 16-byte chunks swizzled so that the
// rowwise and the colwise reads are free of bank conflicts), the next
// tile's copy in flight while the current one is quantized. Each thread
// quantizes two rowwise runs of 16 (16-byte code stores, 8 threads a
// 128-byte row) and one colwise run of two adjacent columns; the colwise
// codes and both scale grids are staged in shared memory and stored
// after a barrier as whole spans: 64 bytes of each col row from 4
// consecutive threads, 4 scale bytes of a scol row and 8 of a srow row
// at once.
//
// The amax pass: at most one wave of blocks, each looping over its share
// of x. Without the RHT it is a streaming |x| max over 16-byte loads (8
// in flight a thread); with it, each thread reads strips of 16 rows by 8
// bytes (16 loads in flight), takes |x| of every element and the RHT of
// each column of the strip. A block folds its pair into two running
// maxima with one atomicMax each (exact in any order); the last block
// (a ticket) moves them to `out` and resets them and the ticket for the
// next launch, so `out` needs no zeroing. The maxima and the ticket are
// one set for the device: launches of this kernel must not overlap.
#include "nvfp4.cuh"
#include "ptx.cuh"

namespace {

using nvfp4::quantize16;
using nvfp4::rht16;

constexpr int kThreads = 256;
constexpr int kTileM = 64;
constexpr int kTileN = 128;
// Tile rows of a group in the quantize pass's order (see tile_origin).
constexpr int kGroup = 8;
// 16-byte loads in flight a thread in the amax pass without the RHT.
constexpr int kAmaxLoads = 8;

// The quantize pass's tile of x in shared memory: kTileM rows of kTileN
// elements, kChunks 16-byte chunks a row, a run of 16 elements kRun chunks.
// Chunk c of a row lies at c ^ ((c >> 3) & (kRun - 1)) within it. The 8
// threads of a quarter warp then read or write 8 chunks in 8 distinct
// bank groups both where they take the runs of one row (chunks kRun * g +
// i for g = 0..7, one i at a time) and where they take 8 consecutive
// chunks (the copies in, and the column reads, which XOR an aligned group
// of 8 with one value).
template <typename T>
struct Tile {
  static constexpr int kChunks = kTileN * static_cast<int>(sizeof(T)) / 16;
  static constexpr int kRun = static_cast<int>(sizeof(T));
  static constexpr int kBytes = kTileM * kTileN * static_cast<int>(sizeof(T));
  static __device__ __forceinline__ int chunk(int row, int c) {
    return row * kChunks + (c ^ ((c >> 3) & (kRun - 1)));
  }
};

// The staged colwise codes: kTileN rows of 4 chunks (kTileM bytes); chunk
// j of row r lies at j ^ ((r >> 2) & 3). A quarter warp writes rows
// 2w + (w & 1) first (even and odd rows alternate, which take the two
// halves of the banks) and reads 2 whole rows: no conflicts either way.
__device__ __forceinline__ int code_chunk(int row, int j) {
  return row * 4 + (j ^ ((row >> 2) & 3));
}

constexpr int kCodeBytes = kTileN * kTileM;
constexpr int kScolBytes = kTileN * (kTileM / 16);
constexpr int kSrowBytes = kTileM * (kTileN / 16);

template <typename T>
constexpr size_t quantize_smem() {
  return 2 * Tile<T>::kBytes + kCodeBytes + kScolBytes + kSrowBytes;
}

// The origin of tile `tile` in the quantize pass's order: groups of
// kGroup tile rows, each walked down its columns of tiles. The blocks in
// flight at once then cover a region some kGroup tiles tall and hundreds
// wide, so that x is read, and row, col and their scales are written, in
// runs of kilobytes: in row order alone, each col row would get 64-byte
// pieces far apart in time.
__device__ __forceinline__ void tile_origin(int tile, int tiles_m,
                                            int tiles_n, int& m0, int& n0) {
  const int g = tile / (kGroup * tiles_n);
  const int i = tile - g * kGroup * tiles_n;
  const int rows = min(kGroup, tiles_m - g * kGroup);
  m0 = (g * kGroup + i % rows) * kTileM;
  n0 = i / rows * kTileN;
}

// Copies the tile at (m0, n0) into `dst`, zeros where it lies outside x.
template <typename T>
__device__ __forceinline__ void copy_tile(const T* __restrict__ x, int M,
                                          int N, int m0, int n0,
                                          unsigned char* dst) {
  using S = Tile<T>;
  constexpr int kRows = kThreads / S::kChunks;
  const int c = threadIdx.x % S::kChunks;
  const int n = n0 + c * (16 / static_cast<int>(sizeof(T)));
#pragma unroll
  for (int r = threadIdx.x / S::kChunks; r < kTileM; r += kRows) {
    const int m = m0 + r;
    const bool ok = m < M && n < N;
    cp_async16(dst + 16 * S::chunk(r, c),
               ok ? x + static_cast<size_t>(m) * N + n : x, ok);
  }
}

// The rowwise runs: thread t takes run t % 8 of rows t / 8 and t / 8 + 32,
// stores their codes and stages their scales in ssrow (kTileM x 8).
template <typename T, bool kSr>
__device__ __forceinline__ void rowwise(const unsigned char* tile, float ts,
                                        uint32_t key, uint8_t* row,
                                        uint8_t* ssrow, int M, int N, int m0,
                                        int n0) {
  using S = Tile<T>;
  const int g = threadIdx.x & 7;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = (threadIdx.x >> 3) + 32 * h;
    const int m = m0 + r, n = n0 + 16 * g;
    if (m >= M || n >= N) continue;
    float v[16];
#pragma unroll
    for (int k = 0; k < S::kRun; ++k)
      widen16<T>(*reinterpret_cast<const uint4*>(
                     tile + 16 * S::chunk(r, S::kRun * g + k)),
                 v + k * (16 / S::kRun));
    const size_t off = static_cast<size_t>(m) * N + n;
    uint4 codes;
    ssrow[r * 8 + g] = quantize16<kSr>(v, ts, key,
                                       static_cast<uint32_t>(off), codes);
    *reinterpret_cast<uint4*>(row + off) = codes;
  }
}

// The colwise runs: thread t takes columns 2w and 2w + 1 (w = t % 64) of
// rows 16j ... 16j + 15 (j = t / 64), rotates each column when asked,
// and stages both runs' codes and scales.
template <typename T, bool kRht, bool kSr>
__device__ __forceinline__ void colwise(const unsigned char* tile, int mask,
                                        float ts, uint32_t key,
                                        uint8_t* ccodes, uint8_t* sscol,
                                        int M, int N, int m0, int n0) {
  using S = Tile<T>;
  const int w = threadIdx.x & 63, j = threadIdx.x >> 6;
  const int n = n0 + 2 * w, m = m0 + 16 * j;
  if (n >= N || m >= M) return;
  constexpr int kPair = 2 * static_cast<int>(sizeof(T));  // bytes a pair
  const int c = w * kPair / 16, o = w * kPair % 16;
  using Pair = typename std::conditional<sizeof(T) == 2, uint32_t,
                                         float2>::type;
  Pair raw[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    raw[i] = *reinterpret_cast<const Pair*>(
        tile + 16 * S::chunk(16 * j + i, c) + o);
  uint4 codes[2];
  uint8_t scale[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if constexpr (sizeof(T) == 2)
        v[i] = __uint_as_float(h ? raw[i] & 0xFFFF0000u : raw[i] << 16);
      else
        v[i] = h ? raw[i].y : raw[i].x;
    }
    if constexpr (kRht) rht16(v, mask);
    scale[h] = quantize16<kSr>(
        v, ts, key,
        static_cast<uint32_t>(static_cast<size_t>(n + h) * M + m), codes[h]);
  }
  const int odd = w & 1;
  *reinterpret_cast<uint4*>(ccodes + 16 * code_chunk(2 * w + odd, j)) =
      odd ? codes[1] : codes[0];
  *reinterpret_cast<uint4*>(ccodes + 16 * code_chunk(2 * w + 1 - odd, j)) =
      odd ? codes[0] : codes[1];
  sscol[8 * w + j] = scale[0];
  sscol[8 * w + 4 + j] = scale[1];
}

// Stores the staged colwise codes (64-byte spans of col's rows) and the
// two scale grids' spans: 4 bytes of each scol row and 8 of each srow row
// where the tile is whole and the span aligned, else byte by byte.
__device__ __forceinline__ void store_staged(const uint8_t* ccodes,
                                             const uint8_t* sscol,
                                             const uint8_t* ssrow,
                                             uint8_t* col, uint8_t* srow,
                                             uint8_t* scol, int M, int N,
                                             int m0, int n0) {
#pragma unroll
  for (int e = threadIdx.x; e < kTileN * 4; e += kThreads) {
    const int r = e >> 2, j = e & 3;
    const int n = n0 + r, m = m0 + 16 * j;
    if (n < N && m < M)
      *reinterpret_cast<uint4*>(col + static_cast<size_t>(n) * M + m) =
          *reinterpret_cast<const uint4*>(ccodes + 16 * code_chunk(r, j));
  }
  const int t = threadIdx.x;
  if (t < kTileN) {
    const int n = n0 + t, mb = M / 16;
    if (n >= N) return;
    uint8_t* dst = scol + static_cast<size_t>(n) * mb + m0 / 16;
    if (m0 + kTileM <= M && mb % 4 == 0) {
      *reinterpret_cast<uint32_t*>(dst) =
          *reinterpret_cast<const uint32_t*>(sscol + 4 * t);
    } else {
      for (int j = 0; j < 4 && m0 + 16 * j < M; ++j) dst[j] = sscol[4 * t + j];
    }
  } else if (t < kTileN + kTileM) {
    const int r = t - kTileN, m = m0 + r, nb = N / 16;
    if (m >= M) return;
    uint8_t* dst = srow + static_cast<size_t>(m) * nb + n0 / 16;
    if (n0 + kTileN <= N && nb % 8 == 0) {
      *reinterpret_cast<uint2*>(dst) =
          *reinterpret_cast<const uint2*>(ssrow + 8 * r);
    } else {
      for (int g = 0; g < 8 && n0 + 16 * g < N; ++g) dst[g] = ssrow[8 * r + g];
    }
  }
}

template <typename T, bool kRht, bool kSr>
__global__ void __launch_bounds__(kThreads)
    nvfp4_quantize_kernel(const T* __restrict__ x,
                          const float* __restrict__ ts, int mask,
                          uint32_t key_row, uint32_t key_col,
                          uint8_t* __restrict__ row,
                          uint8_t* __restrict__ srow,
                          uint8_t* __restrict__ col,
                          uint8_t* __restrict__ scol, int M, int N) {
  extern __shared__ __align__(16) unsigned char nvfp4_smem[];
  using S = Tile<T>;
  uint8_t* ccodes = nvfp4_smem + 2 * S::kBytes;
  uint8_t* sscol = ccodes + kCodeBytes;
  uint8_t* ssrow = sscol + kScolBytes;
  const float ts_row = __ldg(ts), ts_col = __ldg(ts + 1);
  const int tiles_m = (M + kTileM - 1) / kTileM;
  const int tiles_n = (N + kTileN - 1) / kTileN;
  const int tiles = tiles_m * tiles_n;
  int tile = blockIdx.x;
  int m0, n0;
  if (tile < tiles) {
    tile_origin(tile, tiles_m, tiles_n, m0, n0);
    copy_tile(x, M, N, m0, n0, nvfp4_smem);
  }
  cp_async_commit();
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    // The next tile goes into the slot quantized in the last iteration
    // (the barrier before its stores ended every read of it).
    const int next = tile + gridDim.x;
    if (next < tiles) {
      tile_origin(next, tiles_m, tiles_n, m0, n0);
      copy_tile(x, M, N, m0, n0, nvfp4_smem + ((it + 1) & 1) * S::kBytes);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* cur = nvfp4_smem + (it & 1) * S::kBytes;
    tile_origin(tile, tiles_m, tiles_n, m0, n0);
    rowwise<T, kSr>(cur, ts_row, key_row, row, ssrow, M, N, m0, n0);
    colwise<T, kRht, kSr>(cur, mask, ts_col, key_col, ccodes, sscol, M, N,
                          m0, n0);
    __syncthreads();
    store_staged(ccodes, sscol, ssrow, col, srow, scol, M, N, m0, n0);
  }
}

// The amax pass's running maxima (f32 bits, non-negative, so ordered as
// unsigned integers) and the ticket of its blocks.
__device__ unsigned int amax_bits[2];
__device__ unsigned int amax_ticket;

// Folds this block's (arow, acol) into the running maxima; the last block
// of the launch writes them to out and resets them and the ticket.
__device__ __forceinline__ void finish_amax(float arow, float acol,
                                            float* red, float* out) {
  arow = warp_max(arow);
  acol = warp_max(acol);
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
  if ((threadIdx.x & 31) == 0) {
    red[warp] = arow;
    red[kWarps + warp] = acol;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float a = 0.f, b = 0.f;
  for (int i = 0; i < kWarps; ++i) {
    a = fmaxf(a, red[i]);
    b = fmaxf(b, red[kWarps + i]);
  }
  atomicMax(&amax_bits[0], __float_as_uint(a));
  atomicMax(&amax_bits[1], __float_as_uint(b));
  __threadfence();
  if (atomicAdd(&amax_ticket, 1u) != gridDim.x - 1) return;
  __threadfence();
  out[0] = __uint_as_float(atomicExch(&amax_bits[0], 0u));
  out[1] = __uint_as_float(atomicExch(&amax_bits[1], 0u));
  amax_ticket = 0u;
}

// Elements of x a strip column holds (a strip: 16 rows of 8 bytes).
template <typename T>
constexpr int kStripCols = 8 / static_cast<int>(sizeof(T));

template <typename T, bool kRht>
__global__ void __launch_bounds__(kThreads)
    nvfp4_amax_kernel(const T* __restrict__ x, int mask,
                      float* __restrict__ out, int M, int N) {
  extern __shared__ float amax_red[];
  const unsigned stride = gridDim.x * kThreads;
  const unsigned tid = blockIdx.x * kThreads + threadIdx.x;
  float arow = 0.f, acol = 0.f;
  if constexpr (!kRht) {
    constexpr int kVec = 16 / static_cast<int>(sizeof(T));
    const unsigned chunks = static_cast<unsigned>(
        static_cast<size_t>(M) * N / kVec);
    const uint4* p = reinterpret_cast<const uint4*>(x);
    for (unsigned c = tid; c < chunks; c += kAmaxLoads * stride) {
      uint4 raw[kAmaxLoads];
#pragma unroll
      for (int u = 0; u < kAmaxLoads; ++u)
        raw[u] = c + u * stride < chunks ? ldg_stream(p + c + u * stride)
                                         : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < kAmaxLoads; ++u) {
        float v[kVec];
        widen16<T>(raw[u], v);
#pragma unroll
        for (int e = 0; e < kVec; ++e) arow = fmaxf(arow, fabsf(v[e]));
      }
    }
    acol = arow;
  } else {
    constexpr int kCols = kStripCols<T>;
    const unsigned groups = N / kCols;
    const unsigned strips = M / 16 * groups;
    for (unsigned s = tid; s < strips; s += stride) {
      const unsigned rr = s / groups, cg = s - rr * groups;
      const T* p = x + static_cast<size_t>(16 * rr) * N + cg * kCols;
      uint2 raw[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        raw[i] = __ldg(reinterpret_cast<const uint2*>(
            p + static_cast<size_t>(i) * N));
#pragma unroll
      for (int h = 0; h < kCols; ++h) {
        float v[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if constexpr (sizeof(T) == 2) {
            const uint32_t word = h < 2 ? raw[i].x : raw[i].y;
            v[i] = __uint_as_float(h & 1 ? word & 0xFFFF0000u : word << 16);
          } else {
            v[i] = __uint_as_float(h ? raw[i].y : raw[i].x);
          }
          arow = fmaxf(arow, fabsf(v[i]));
        }
        rht16(v, mask);
#pragma unroll
        for (int i = 0; i < 16; ++i) acol = fmaxf(acol, fabsf(v[i]));
      }
    }
  }
  finish_amax(arow, acol, amax_red, out);
}

bool shape_ok(int M, int N) {
  return M > 0 && N > 0 && M % 16 == 0 && N % 16 == 0 &&
         static_cast<long long>(M) * N < (1LL << 32);
}

template <typename T, bool kRht>
cudaError_t launch_amax(const void* x, int mask, float* out, int M, int N,
                        cudaStream_t stream) {
  auto kernel = nvfp4_amax_kernel<T, kRht>;
  const size_t smem = 2 * (kThreads / 32) * sizeof(float);
  static const int slots = resident_blocks(kernel, kThreads, smem);
  // Work items: kAmaxLoads chunks of 16 bytes without the RHT, strips
  // with it.
  const long long items =
      !kRht ? (static_cast<long long>(M) * N * sizeof(T) / 16 +
                   kAmaxLoads - 1) / kAmaxLoads
                : static_cast<long long>(M / 16) * (N / kStripCols<T>);
  const long long want = (items + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < slots ? want : slots);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), mask,
                                           out, M, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t amax_t(const void* x, int with_rht, int mask, float* out, int M,
                   int N, cudaStream_t stream) {
  return with_rht ? launch_amax<T, true>(x, mask, out, M, N, stream)
                  : launch_amax<T, false>(x, mask, out, M, N, stream);
}

struct QuantizeArgs {
  const float* ts;
  int mask;
  uint32_t key_row, key_col;
  uint8_t *row, *srow, *col, *scol;
  int M, N;
};

template <typename T, bool kRht, bool kSr>
cudaError_t launch_quantize(const void* x, const QuantizeArgs& a,
                            cudaStream_t stream) {
  auto kernel = nvfp4_quantize_kernel<T, kRht, kSr>;
  const size_t smem = quantize_smem<T>();
  static const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  static const int slots = resident_blocks(kernel, kThreads, smem);
  const int tiles =
      (a.M + kTileM - 1) / kTileM * ((a.N + kTileN - 1) / kTileN);
  kernel<<<tiles < slots ? tiles : slots, kThreads, smem, stream>>>(
      static_cast<const T*>(x), a.ts, a.mask, a.key_row, a.key_col, a.row,
      a.srow, a.col, a.scol, a.M, a.N);
  return cudaGetLastError();
}

template <typename T, bool kSr>
cudaError_t quantize_t(const void* x, int with_rht, const QuantizeArgs& a,
                       cudaStream_t stream) {
  return with_rht ? launch_quantize<T, true, kSr>(x, a, stream)
                  : launch_quantize<T, false, kSr>(x, a, stream);
}

}  // namespace

// out (2,) f32: amax(|x|), amax(|RHT(x^T)|) (the first again without the
// RHT). The kernel writes both; out need not be zeroed.
extern "C" int te_nvfp4_amax_2x(const void* x, int x_dtype, int with_rht,
                                int mask, void* out, int M, int N,
                                void* stream) {
  if (!shape_ok(M, N) || out == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (x_dtype) {
    case kBFloat16:
      return amax_t<__nv_bfloat16>(x, with_rht, mask, o, M, N, s);
    case kFloat32: return amax_t<float>(x, with_rht, mask, o, M, N, s);
    default: return cudaErrorInvalidValue;
  }
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
  const QuantizeArgs a{static_cast<const float*>(ts), mask, key_row,
                       key_col, static_cast<uint8_t*>(row),
                       static_cast<uint8_t*>(srow), static_cast<uint8_t*>(col),
                       static_cast<uint8_t*>(scol), M, N};
  switch (x_dtype) {
    case kBFloat16:
      return sr ? quantize_t<__nv_bfloat16, true>(x, with_rht, a, s)
                : quantize_t<__nv_bfloat16, false>(x, with_rht, a, s);
    case kFloat32:
      return sr ? quantize_t<float, true>(x, with_rht, a, s)
                : quantize_t<float, false>(x, with_rht, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}
