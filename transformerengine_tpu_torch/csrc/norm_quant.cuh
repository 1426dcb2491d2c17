// The one body of the fused norm-quantize kernels (mxfp8_norm_quantize.cu
// and norm_cast_transpose.cu): RMSNorm or LayerNorm of an (M, H) tensor x
// (bf16 or f32), y rounded to x's dtype, quantized into both orientations
// without y ever reaching device memory. The MXFP8 form (kMx) writes the
// rowwise (M, H) codes with their (M, H/32) E8M0 grid and the colwise
// (H, M) codes with their (H, M/32) grid (the rule of mxfp8.cuh); the
// per-tensor form writes both payloads under one scale and the amax of
// |y|. Both write rsigma (M) and, for LayerNorm, mu (M).
//
// Numerics (the reference's): statistics in f32, mu = sum(x) / H and
// var = sum((x - mu)^2) / H for LayerNorm (x^2 for RMSNorm), rsigma =
// 1 / sqrt(var + eps) correctly rounded; y = (xc * rsigma) * gamma (+ 1
// with zero-centered gamma) (+ beta), each step rounded to f32, then to
// x's dtype before any amax or cast. The casts are the fp8 pair
// conversion with SATFINITE, which is qmath's clip for every value but
// NaN (kept NaN, as torch's clamp keeps it). The sums run in another order
// than PyTorch's (lane-strided 16-byte vectors, the warp's xor tree, then
// the cluster's partials in rank order), so rsigma may differ by an f32
// ulp; every launch sums alike, so two launches give the same bits.
//
// Bound on an H100: bytes. At (4096, 4096) bf16 x is read once (33.5 MB)
// and the MXFP8 form writes 34.6 MB, 20 us at 3.35 TB/s.
//
// Design: one launch of persistent clusters. A strip of 32 rows (the
// height of an MXFP8 colwise block) does not fit one block's shared memory
// at the widths of the paths (256 KB at H = 4096 bf16), so a cluster of C
// blocks (C in {2, 4, 8}) on neighbouring SMs splits it along H: block
// `rank` holds the 32 rows of its slice of whole 32-column blocks (blocks
// rank nb / C to (rank + 1) nb / C of the nb = H / 32, so slices differ by
// at most one block). Every colwise block is then local to one block, and
// only the row statistics cross blocks. As many clusters as the card holds
// at once walk the strips (cluster g takes strips g, g + G, ...). Hopper's
// 1-D TMA (`cp.async.bulk`, one copy per row segment onto the warp's
// mbarrier) brings a strip's slice into a tile, and gamma's and beta's
// slices once. Each warp takes 4 rows of a strip:
// 1. Statistics: the warp sums its rows' slice, and lanes 0..C-1 store the
//    4 partials into block `lane`'s shared memory (distributed shared
//    memory, no round trip); after the cluster's barrier every block adds
//    the C partials in rank order (LayerNorm: the mean first, then the
//    squares about it). Rank 0 writes rsigma and mu.
// 2. Normalize and rowwise: each lane normalizes 8 consecutive values of a
//    row (two rows at a time, in straight-line code), writes y back over x
//    (exact: y is rounded to x's dtype) and casts them: the 4 lanes of a
//    32-column block reduce its amax by shuffles, so a warp writes 256
//    consecutive code bytes of a row, and the strip's E8M0 bytes of the
//    slice go out as one run a row.
// 3. Colwise: two neighbouring lanes take a column, rows 0-15 and 16-31,
//    and share the block's amax by a shuffle; a warp's 16-byte stores fill
//    whole sectors of 16 colwise rows. The clusters at work at once hold
//    neighbouring strips, so they write neighbouring pieces of the same
//    colwise rows and scale rows.
// With two tiles a block (kPiped) the strips run in a pipeline: strip k's
// first statistics round crosses the cluster while the block does strip
// k - 1's colwise step, and strip k + 1's tile loads while the round ends
// and strip k's rows are normalized. The per-tensor form's amax: one max a
// block; the last block (a ticket it resets) writes it, so `amax` needs no
// zeroing.
//
// C is the smallest whose slice fits kBudget (32 KB: C = 8 at H = 4096
// bf16, the fastest of 2, 4 and 8 in tools/norm_budget.py's timing there,
// PERF.md §6); f32 takes twice bf16's C. Where two tiles of the slice exceed
// kMaxTiles (H above 12288 bf16 or 6144 f32 at C = 8), the same body
// (kPiped false) reads each row's slice once for the statistics and again,
// in chunks of kBudget, for the normalize, instead of keeping it.
#pragma once

#include <algorithm>
#include <cstring>
#include <mutex>
#include <utility>
#include <vector>

#include "mxfp8.cuh"
#include "ptx.cuh"

namespace norm_quant {

constexpr int kRows = 32;                  // a strip: one colwise block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpRows = kRows / kWarps;  // 4 rows a warp
constexpr int kMaxC = 8;
// Blocks an SM holds at once: registers for 3 (80 a thread).
constexpr int kMinBlocks = 3;
#ifndef TE_NORM_QUANT_BUDGET
#define TE_NORM_QUANT_BUDGET (32 * 1024)
#endif
constexpr size_t kBudget = TE_NORM_QUANT_BUDGET;
constexpr size_t kMaxTiles = 192 * 1024;

struct Args {
  const void* x;
  const float* gamma;
  const float* beta;   // or null
  const float* scale;  // the per-tensor form's scale (1,), on the card
  uint8_t* row;
  uint8_t* col;        // null: rowwise only
  uint8_t* srow;       // MXFP8 grids (col's null with col)
  uint8_t* scol;
  float* amax;         // the per-tensor form's amax (1,)
  float* rsigma;
  float* mu;           // LayerNorm only, else null
  int M, H, layernorm, zero_centered, e5m2;
  float eps;
};

// The launch's shape: C blocks a strip, each holding at most nbl 32-column
// blocks; with `piped` two tiles of a slice, else one tile of `chunk`
// columns into which x is read a second time.
struct Plan {
  int C, nbl, chunk;
  bool piped;
  size_t smem;
};

// Shared memory before the tiles: the mbarriers (one a warp and tile, then
// gamma's), the partials that the cluster's blocks store here (two strips'
// sums and squares from up to 8 ranks), the warps' amaxes, the rowwise
// E8M0 bytes of a strip's slice, (32, nbl), and the slice's gamma and beta
// (nbl 32-column blocks of f32 each).
constexpr int kBars = 2 * kWarps + 1;
// The mbarriers' bytes, rounded up to a multiple of 64 so that what
// follows stays 16-byte aligned.
constexpr size_t kBarBytes = (8 * kBars + 63) / 64 * 64;
constexpr size_t kRecv = 2 * 2 * kMaxC * kRows;  // floats
__host__ __device__ inline size_t head_bytes(int nbl) {
  return kBarBytes + 4 * (kRecv + kWarps) +
         ((size_t)kRows * nbl + 15) / 16 * 16 + 2 * 128 * (size_t)nbl;
}

template <typename T>
inline Plan make_plan(int H) {
  const int nb = H / 32;
  const auto tile = [](int cols) { return (size_t)kRows * cols * sizeof(T); };
  int C = kMaxC;
  for (int c = 2; c < kMaxC; c *= 2) {
    if (tile(32 * ((nb + c - 1) / c)) <= kBudget) {
      C = c;
      break;
    }
  }
  Plan p;
  p.C = C;
  p.nbl = (nb + C - 1) / C;
  const size_t slice = tile(32 * p.nbl);
  p.piped = 2 * slice <= kMaxTiles;
  p.chunk = p.piped ? 32 * p.nbl : (int)(kBudget / tile(32)) * 32;
  p.smem = head_bytes(p.nbl) + tile(p.chunk) * (p.piped ? 2 : 1);
  return p;
}

struct Shared {
  uint64_t* bar;        // bar[t * kWarps + w]: warp w's rows in tile t;
                        // bar[2 * kWarps]: gamma and beta
  float* recv;          // [strip parity][sum, sq][rank][row]
  float* amax;          // each warp's largest |y| (the per-tensor form)
  uint8_t* ex;          // a strip's rowwise E8M0 bytes of the slice
  float* gamma;         // the slice's gamma, then beta
  float* beta;
  unsigned char* tile;  // x's rows, then y's, (32, chunk) of T, per tile
};

__device__ __forceinline__ Shared carve(unsigned char* base, int nbl) {
  Shared s;
  s.bar = reinterpret_cast<uint64_t*>(base);
  s.recv = reinterpret_cast<float*>(base + kBarBytes);
  s.amax = s.recv + kRecv;
  s.ex = reinterpret_cast<uint8_t*>(s.amax + kWarps);
  s.gamma = reinterpret_cast<float*>(
      s.ex + ((size_t)kRows * nbl + 15) / 16 * 16);
  s.beta = s.gamma + 32 * nbl;
  s.tile = base + head_bytes(nbl);
  return s;
}

// The 16 / sizeof(T) values of T in 16 bytes, as f32 (bf16 by its bits:
// one 16-byte load, where a T-by-T reading of it may not stay one).
template <typename T>
__device__ __forceinline__ void unpack16(const uint4 raw, float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (sizeof(T) == 2) {
      out[2 * k] = __uint_as_float(w[k] << 16);
      out[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    } else {
      out[k] = __uint_as_float(w[k]);
    }
  }
}

// 16 bytes of T widened to f32, from device memory or shared memory.
template <typename T, bool kGlobal>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if (kGlobal)
    load16(p, out);
  else
    unpack16<T>(*reinterpret_cast<const uint4*>(p), out);
}

// The warp's sum over the n elements of a row (n a multiple of 32) of
// (x - mean)^2, or of x when `plain`: each lane sums its 16-byte vectors
// (lane, lane + 32, ...) in order, then the warp's xor tree. Every lane
// gets it.
template <typename T, bool kGlobal>
__device__ __forceinline__ float row_partial(const T* p, int n, bool plain,
                                             float mean, int lane) {
  constexpr int kVec = 16 / sizeof(T);
  float acc = 0.f;
  for (int c = lane * kVec; c < n; c += 32 * kVec) {
    float v[kVec];
    load_vec<T, kGlobal>(p + c, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if (plain) {
        acc = __fadd_rn(acc, v[e]);
      } else {
        const float d = __fsub_rn(v[e], mean);
        acc = __fadd_rn(acc, __fmul_rn(d, d));
      }
    }
  }
  return warp_sum(acc);
}

// Lane 0 of a warp: the bulk copies of its 4 rows' n columns from column c
// (rows m.. of x) into `tile`, announced on `bar`.
template <typename T>
__device__ __forceinline__ void load_rows(unsigned char* tile, uint64_t* bar,
                                          const T* x, int H, int m, int c,
                                          int n, int pitch) {
  if (n == 0) return;
  const unsigned bytes = n * sizeof(T);
  mbar_arrive_expect(bar, kWarpRows * bytes);
  const int r0 = (threadIdx.x >> 5) * kWarpRows;
  for (int i = 0; i < kWarpRows; ++i)
    bulk_load(tile + (size_t)(r0 + i) * pitch * sizeof(T),
              x + (size_t)(m + i) * H + c, bytes, bar);
}

// The statistics cross the cluster in rounds: each warp's partials of its
// 4 rows are stored into slot `rank` of every block's `recv` (lanes
// 0..C-1, one block each: distributed shared memory, no round trip); the
// cluster's barrier makes them visible; each block then sums the C slots
// in rank order. `recv` holds a round's [rank][row] partials.
__device__ __forceinline__ void push(float* recv, const float (&part)[4],
                                     int C, int rank) {
  const int lane = threadIdx.x & 31;
  if (lane < C) {
    float* dst = cluster_map(
        recv + rank * kRows + (threadIdx.x >> 5) * kWarpRows, lane);
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) dst[i] = part[i];
  }
}

__device__ __forceinline__ void gather(const float* recv, int C,
                                       float (&total)[4]) {
  const int r0 = (threadIdx.x >> 5) * kWarpRows;
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    float t = 0.f;
    for (int k = 0; k < C; ++k) t = __fadd_rn(t, recv[k * kRows + r0 + i]);
    total[i] = t;
  }
}

// This warp's partials over the slices at src (shared memory, or device
// memory with kGlobal): of x when `plain`, else of (x - mean)^2.
template <typename T, bool kGlobal>
__device__ __forceinline__ void partials(const T* const (&src)[4], int W,
                                         bool live, bool plain,
                                         const float (&mean)[4],
                                         float (&part)[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i)
    part[i] = live ? row_partial<T, kGlobal>(src[i], W, plain, mean[i], lane)
                   : 0.f;
}

// From the first round's totals: LayerNorm's mean (the second round's
// input), else 0 and the variance, whose rsigma `finish` takes.
__device__ __forceinline__ void first_round(const Args& a,
                                            const float (&total)[4],
                                            float (&mean)[4],
                                            float (&var)[4]) {
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    const float t = __fdiv_rn(total[i], (float)a.H);
    mean[i] = a.layernorm ? t : 0.f;
    var[i] = t;
  }
}

__device__ __forceinline__ void finish(const Args& a, float (&var)[4],
                                       float (&rs)[4]) {
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i)
    rs[i] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var[i], a.eps)));
}

// Step 1 in one go: the statistics of this warp's 4 rows (mean 0 for
// RMSNorm), in every lane. `recv` is the strip parity's half of s.recv.
template <typename T, bool kGlobal>
__device__ __forceinline__ void statistics(const Args& a, float* recv,
                                           const T* const (&src)[4], int C,
                                           int rank, bool live, int W,
                                           float (&mean)[kWarpRows],
                                           float (&rs)[kWarpRows]) {
  float part[kWarpRows], total[kWarpRows];
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) mean[i] = 0.f;
  partials<T, kGlobal>(src, W, live, a.layernorm, mean, part);
  push(recv, part, C, rank);
  cluster_sync();
  gather(recv, C, total);
  first_round(a, total, mean, rs);
  if (a.layernorm) {
    partials<T, kGlobal>(src, W, live, false, mean, part);
    push(recv + kMaxC * kRows, part, C, rank);
    cluster_sync();
    gather(recv + kMaxC * kRows, C, rs);
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) rs[i] = __fdiv_rn(rs[i], (float)a.H);
  }
  finish(a, rs, rs);
}

// Two fp8 codes of the pair conversion, a's in the low byte.
__device__ __forceinline__ uint32_t fp8_pair(float a, float b,
                                             __nv_fp8_interpretation_t kind) {
  return __nv_cvt_float2_to_fp8x2(make_float2(a, b), __NV_SATFINITE, kind);
}

// Rounds the 8 f32 values y to T (in place) and packs them into raw; bf16
// by the pair conversion (round to nearest even, as __float2bfloat16).
template <typename T>
__device__ __forceinline__ void round8(float (&y)[8],
                                       uint4 (&raw)[8 * sizeof(T) / 16]) {
  if constexpr (sizeof(T) == 2) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * k], y[2 * k + 1]);
      memcpy(&w[k], &h, 4);
      y[2 * k] = __uint_as_float(w[k] << 16);
      y[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
    raw[0] = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      raw[k] = make_uint4(__float_as_uint(y[4 * k]), __float_as_uint(y[4 * k + 1]),
                          __float_as_uint(y[4 * k + 2]),
                          __float_as_uint(y[4 * k + 3]));
  }
}

// Step 2 for this warp's 4 rows (of m0.. in x) over the chunk's wc
// columns: the tile's from 0, x's from cg, the slice's from cc. Two rows at
// a time in straight-line code (a lane past wc reads column 0 and stores
// nothing), so that their chains of loads, products and shuffles overlap.
template <typename T, bool kMx, bool kCol, bool kBeta>
__device__ __forceinline__ void normalize_rows(
    const Args& a, const Shared& s, unsigned char* tile, int pitch, int nbl,
    int m0, int cg, int cc, int wc, const float (&mean)[kWarpRows],
    const float (&rs)[kWarpRows], float scale,
    __nv_fp8_interpretation_t kind, float& amax) {
  constexpr int kVecs = 8 * sizeof(T) / 16;  // 16-byte vectors of 8 values
  constexpr int kPair = 2;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kWarpRows;
  for (int j0 = 0; j0 < wc; j0 += 256) {
    const bool on = j0 + lane * 8 < wc;  // alike for a block's 4 lanes
    const int j = on ? j0 + lane * 8 : 0;  // the tile's column
    float ge[8], be[8];
    {
      const float4* g = reinterpret_cast<const float4*>(s.gamma + cc + j);
      const float4* b = reinterpret_cast<const float4*>(s.beta + cc + j);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float4 gk = g[k];
        ge[4 * k] = gk.x, ge[4 * k + 1] = gk.y;
        ge[4 * k + 2] = gk.z, ge[4 * k + 3] = gk.w;
        if (kBeta) {
          const float4 bk = b[k];
          be[4 * k] = bk.x, be[4 * k + 1] = bk.y;
          be[4 * k + 2] = bk.z, be[4 * k + 3] = bk.w;
        }
      }
      if (a.zero_centered) {
#pragma unroll
        for (int e = 0; e < 8; ++e) ge[e] = __fadd_rn(ge[e], 1.f);
      }
    }
#pragma unroll
    for (int i0 = 0; i0 < kWarpRows; i0 += kPair) {
      float y[kPair][8];
      uint4* p[kPair];
      uint4 raw[kPair][kVecs];
#pragma unroll
      for (int h = 0; h < kPair; ++h) {
        p[h] = reinterpret_cast<uint4*>(reinterpret_cast<T*>(tile) +
                                        (size_t)(r0 + i0 + h) * pitch + j);
#pragma unroll
        for (int k = 0; k < kVecs; ++k) raw[h][k] = p[h][k];
      }
#pragma unroll
      for (int h = 0; h < kPair; ++h) {
        float v[8];
#pragma unroll
        for (int k = 0; k < kVecs; ++k)
          unpack16<T>(raw[h][k], v + 8 / kVecs * k);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          // x - 0 is x, so RMSNorm (mean 0) takes the same steps.
          float u = __fmul_rn(
              __fmul_rn(__fsub_rn(v[e], mean[i0 + h]), rs[i0 + h]), ge[e]);
          if (kBeta) u = __fadd_rn(u, be[e]);
          y[h][e] = u;
        }
        round8<T>(y[h], raw[h]);
        if (kCol && on) {
#pragma unroll
          for (int k = 0; k < kVecs; ++k) p[h][k] = raw[h][k];
        }
      }
      float mul[kPair];
      int ex[kPair];
#pragma unroll
      for (int h = 0; h < kPair; ++h) {
        float am = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) am = fmaxf(am, fabsf(y[h][e]));
        if (kMx) {
          ex[h] = mxfp8::e8m0_exponent(mxfp8::group4_max(am));
          mul[h] = mxfp8::quant_multiplier(ex[h]);
        } else {
          if (on) amax = fmaxf(amax, am);
          mul[h] = scale;
        }
      }
#pragma unroll
      for (int h = 0; h < kPair; ++h) {
        uint32_t q[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          q[e] = fp8_pair(__fmul_rn(y[h][2 * e], mul[h]),
                          __fmul_rn(y[h][2 * e + 1], mul[h]), kind);
        if (on) {
          *reinterpret_cast<uint2*>(a.row + (size_t)(m0 + r0 + i0 + h) * a.H +
                                    cg + j) =
              make_uint2(q[0] | (q[1] << 16), q[2] | (q[3] << 16));
          if (kMx && (lane & 3) == 0)
            s.ex[(r0 + i0 + h) * nbl + ((cc + j) >> 5)] =
                (uint8_t)(ex[h] + mxfp8::kBias);
        }
      }
    }
  }
}

// Step 3 over the tile's columns lo..hi - 1 (x's from cg + lo; lo and hi
// multiples of 32) of rows m0.. : two neighbouring lanes take a column,
// rows 0-15 and 16-31, so that each 16-byte store of a warp fills whole
// sectors of 16 colwise rows; the pair shares its block's amax by a
// shuffle.
template <typename T, bool kMx>
__device__ __forceinline__ void quantize_cols(const Args& a,
                                              const unsigned char* tile,
                                              int pitch, int m0, int rows,
                                              int cg, int lo, int hi,
                                              float scale,
                                              __nv_fp8_interpretation_t kind) {
  constexpr int kHalf = kRows / 2;
  const int half = threadIdx.x & 1;
  // The half's rows that exist: 16, or fewer (a multiple of 8) in the
  // per-tensor form's last strip.
  const int hr = min(kHalf, max(0, rows - kHalf * half));
  // A warp's 16 columns are all inside hi or all past it (hi % 32 == 0),
  // so the shuffle below sees the whole warp.
  for (int c = lo + (threadIdx.x >> 1); c < hi; c += kThreads / 2) {
    const T* v = reinterpret_cast<const T*>(tile) +
                 (size_t)kHalf * half * pitch + c;
    float f[kHalf];
#pragma unroll
    for (int r = 0; r < kHalf; ++r) f[r] = to_float(v[(size_t)r * pitch]);
    float mul = scale;
    int ex = 0;
    if (kMx) {
      float am = 0.f;
#pragma unroll
      for (int r = 0; r < kHalf; ++r) am = fmaxf(am, fabsf(f[r]));
      am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, 1));
      ex = mxfp8::e8m0_exponent(am);
      mul = mxfp8::quant_multiplier(ex);
    }
    uint32_t q[kHalf / 4];
#pragma unroll
    for (int r = 0; r < kHalf; r += 4)
      q[r / 4] = fp8_pair(__fmul_rn(f[r], mul), __fmul_rn(f[r + 1], mul),
                          kind) |
                 (fp8_pair(__fmul_rn(f[r + 2], mul), __fmul_rn(f[r + 3], mul),
                           kind)
                  << 16);
    const int n = cg + c;
    uint8_t* dst = a.col + (size_t)n * a.M + m0 + kHalf * half;
    if (hr == kHalf && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(q[0], q[1], q[2], q[3]);
    } else {
      for (int i = 0; i < hr / 8; ++i)
        reinterpret_cast<uint2*>(dst)[i] = make_uint2(q[2 * i], q[2 * i + 1]);
    }
    if (kMx && half == 0)
      a.scol[(size_t)n * (a.M / kRows) + m0 / kRows] =
          (uint8_t)(ex + mxfp8::kBias);
  }
}

namespace {
// The per-tensor form's running amax (f32 bits, non-negative, so ordered
// as unsigned integers) and the ticket of its blocks.
__device__ unsigned int nq_amax_bits;
__device__ unsigned int nq_amax_ticket;
}  // namespace

// Folds this block's amax into the running one; the launch's last block
// writes it to out and resets it and the ticket.
__device__ __forceinline__ void finish_amax(float v, float* red, float* out) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = 0.f;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red[w]);
    atomicMax(&nq_amax_bits, __float_as_uint(m));
    __threadfence();
    if (atomicAdd(&nq_amax_ticket, 1u) == gridDim.x - 1) {
      __threadfence();
      *out = __uint_as_float(atomicExch(&nq_amax_bits, 0u));
      nq_amax_ticket = 0u;
    }
  }
}

// This warp's rows' E8M0 bytes of the slice (from s.ex) as one run a row.
__device__ __forceinline__ void write_srow(const Args& a, const Shared& s,
                                           int nbl, int m0, int b0, int W) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  for (int i = 0; i < kWarpRows; ++i) {
    const int r = (threadIdx.x >> 5) * kWarpRows + i;
    uint8_t* dst = a.srow + (size_t)(m0 + r) * (a.H / 32) + b0;
    for (int j = lane; j < W / 32; j += 32) dst[j] = s.ex[r * nbl + j];
  }
}

// Lane 0 of each warp with rows in strip `strip`: its rows' copies into
// tile t.
template <typename T>
__device__ __forceinline__ void load_strip(const Args& a, const Shared& s,
                                           const Plan& p, int strip, int t,
                                           int c0, int W) {
  const int warp = threadIdx.x >> 5;
  const int m = strip * kRows + warp * kWarpRows;
  if ((threadIdx.x & 31) == 0 && m < a.M && W > 0)
    load_rows<T>(s.tile + (size_t)t * kRows * p.chunk * sizeof(T),
                 &s.bar[t * kWarps + warp], static_cast<const T*>(a.x), a.H,
                 m, c0, W, p.chunk);
}

// Once every thread is done with tile t (the strip before's), the rows of
// strip `strip` (when it exists) into it.
template <typename T>
__device__ __forceinline__ void reload_tile(const Args& a, const Shared& s,
                                            const Plan& p, int strip, int t,
                                            int c0, int W) {
  fence_proxy_async();  // the last strip's accesses before the copies
  __syncthreads();
  if (strip * kRows < a.M) load_strip<T>(a, s, p, strip, t, c0, W);
}

// Waits for this warp's rows of tile t (when the strip has them) and
// points src at them.
template <typename T>
__device__ __forceinline__ void tile_rows(const Shared& s, const Plan& p,
                                          int t, bool live, int W,
                                          unsigned& phase,
                                          const T* (&src)[kWarpRows]) {
  const int warp = threadIdx.x >> 5;
  if (live && W > 0) {
    mbar_wait(&s.bar[t * kWarps + warp], (phase >> t) & 1);
    phase ^= 1u << t;
  }
  const T* tile = reinterpret_cast<const T*>(
      s.tile + (size_t)t * kRows * p.chunk * sizeof(T));
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i)
    src[i] = tile + (size_t)(warp * kWarpRows + i) * p.chunk;
}

// One block of a cluster: grid (C * G), clusters of (C), G persistent
// clusters over the strips.
template <typename T, bool kMx, bool kCol, bool kBeta, bool kPiped>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    norm_quant_kernel(const Args a, const Plan p) {
  extern __shared__ __align__(16) unsigned char nq_smem[];
  const Shared s = carve(nq_smem, p.nbl);
  const int rank = (int)cluster_rank();
  const int C = p.C;
  const int G = gridDim.x / C;
  const int first = blockIdx.x / C;
  const int strips = (a.M + kRows - 1) / kRows;
  const int nb = a.H / 32;
  const int b0 = rank * nb / C;
  const int W = ((rank + 1) * nb / C - b0) * 32;  // this block's columns
  const int c0 = b0 * 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* x = static_cast<const T*>(a.x);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kBars; ++i) mbar_init(&s.bar[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0 && W > 0) {
    const unsigned bytes = W * sizeof(float);
    mbar_arrive_expect(&s.bar[2 * kWarps], (kBeta ? 2 : 1) * bytes);
    bulk_load(s.gamma, a.gamma + c0, bytes, &s.bar[2 * kWarps]);
    if (kBeta) bulk_load(s.beta, a.beta + c0, bytes, &s.bar[2 * kWarps]);
  }
  if (kPiped) load_strip<T>(a, s, p, first, 0, c0, W);
  cluster_sync();  // the cluster's blocks all run: partials may be stored
  if (W > 0) mbar_wait(&s.bar[2 * kWarps], 0);  // gamma and beta
  const __nv_fp8_interpretation_t kind = a.e5m2 ? __NV_E5M2 : __NV_E4M3;
  const float scale = kMx ? 1.f : __ldg(a.scale);
  float amax = 0.f;
  unsigned phase = 0;  // bit t: the parity of this warp's barrier of tile t
  if (kPiped) {
    // A pipeline over two tiles: strip k's first statistics round crosses
    // the cluster while the block quantizes strip k - 1's columns, and
    // strip k + 1's tile loads (into strip k - 1's) while the round ends
    // and strip k's rows are normalized.
    int last_m0 = 0, last_rows = 0;
    int k = 0;
    for (int strip = first; strip < strips; ++k, strip += G) {
      const int m0 = strip * kRows;
      const int rows = min(kRows, a.M - m0);  // a multiple of 8
      const bool live = warp * kWarpRows < rows;
      const int t = k & 1;
      unsigned char* tile = s.tile + (size_t)t * kRows * p.chunk * sizeof(T);
      float* recv = s.recv + t * 2 * kMaxC * kRows;
      const T* src[kWarpRows];
      tile_rows<T>(s, p, t, live, W, phase, src);
      float mean[kWarpRows], rs[kWarpRows], part[kWarpRows];
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i) mean[i] = 0.f;
      partials<T, false>(src, W, live, a.layernorm, mean, part);
      push(recv, part, C, rank);
      cluster_arrive();
      // LayerNorm's second round crosses the cluster over the second half
      // of the colwise step.
      const unsigned char* last = s.tile + (size_t)(t ^ 1) * kRows * p.chunk *
                                               sizeof(T);
      const int split = a.layernorm ? W / 64 * 32 : W;
      if (kCol && k > 0)
        quantize_cols<T, kMx>(a, last, p.chunk, last_m0, last_rows, c0, 0,
                              split, scale, kind);
      if (!a.layernorm) reload_tile<T>(a, s, p, strip + G, t ^ 1, c0, W);
      cluster_wait();
      gather(recv, C, part);
      first_round(a, part, mean, rs);
      if (a.layernorm) {
        partials<T, false>(src, W, live, false, mean, part);
        push(recv + kMaxC * kRows, part, C, rank);
        cluster_arrive();
        if (kCol && k > 0)
          quantize_cols<T, kMx>(a, last, p.chunk, last_m0, last_rows, c0,
                                split, W, scale, kind);
        reload_tile<T>(a, s, p, strip + G, t ^ 1, c0, W);
        cluster_wait();
        gather(recv + kMaxC * kRows, C, rs);
#pragma unroll
        for (int i = 0; i < kWarpRows; ++i)
          rs[i] = __fdiv_rn(rs[i], (float)a.H);
      }
      finish(a, rs, rs);
      if (rank == 0 && live && lane == 0) {
#pragma unroll
        for (int i = 0; i < kWarpRows; ++i) {
          const int m = m0 + warp * kWarpRows + i;
          a.rsigma[m] = rs[i];
          if (a.mu != nullptr) a.mu[m] = mean[i];
        }
      }
      if (live) {
        normalize_rows<T, kMx, kCol, kBeta>(a, s, tile, p.chunk, p.nbl, m0,
                                            c0, 0, W, mean, rs, scale, kind,
                                            amax);
        if (kMx) write_srow(a, s, p.nbl, m0, b0, W);
      }
      __syncthreads();  // strip k's y, for its colwise step
      last_m0 = m0;
      last_rows = rows;
    }
    if (kCol && k > 0)
      quantize_cols<T, kMx>(
          a, s.tile + (size_t)((k - 1) & 1) * kRows * p.chunk * sizeof(T),
          p.chunk, last_m0, last_rows, c0, 0, W, scale, kind);
  }
  // Without: each strip's statistics from device memory, then its chunks
  // of columns read again into the one tile.
  for (int k = 0, strip = kPiped ? strips : first; strip < strips;
       ++k, strip += G) {
    const int m0 = strip * kRows;
    const int rows = min(kRows, a.M - m0);  // a multiple of 8
    const bool live = warp * kWarpRows < rows;
    unsigned char* tile = s.tile;
    float mean[kWarpRows], rs[kWarpRows];
    const T* src[kWarpRows];
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i)
      src[i] = x + (size_t)(m0 + warp * kWarpRows + i) * a.H + c0;
    statistics<T, true>(a, s.recv + (k & 1) * 2 * kMaxC * kRows, src, C,
                        rank, live, W, mean, rs);
    if (rank == 0 && live && lane == 0) {
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i) {
        const int m = m0 + warp * kWarpRows + i;
        a.rsigma[m] = rs[i];
        if (a.mu != nullptr) a.mu[m] = mean[i];
      }
    }
    for (int cc = 0; cc < W; cc += p.chunk) {
      const int wc = min(p.chunk, W - cc);
      if (live) {
        if (lane == 0)
          load_rows<T>(tile, &s.bar[warp], x, a.H, m0 + warp * kWarpRows,
                       c0 + cc, wc, p.chunk);
        mbar_wait(&s.bar[warp], phase & 1);
        phase ^= 1u;
        normalize_rows<T, kMx, kCol, kBeta>(a, s, tile, p.chunk, p.nbl, m0,
                                            c0 + cc, cc, wc, mean, rs, scale,
                                            kind, amax);
      }
      if (kCol) {
        __syncthreads();
        quantize_cols<T, kMx>(a, tile, p.chunk, m0, rows, c0 + cc, 0, wc,
                              scale, kind);
      }
      fence_proxy_async();  // this chunk's accesses before the next copies
      __syncthreads();
    }
    if (kMx && live) write_srow(a, s, p.nbl, m0, b0, W);
  }
  if (!kMx) finish_amax(amax, s.amax, a.amax);
}

// The clusters of this launch the card holds at once: the occupancy API,
// asked once for each kernel, cluster size and shared memory.
template <typename K>
inline cudaError_t resident_clusters(K kernel, const cudaLaunchConfig_t& cfg,
                                     int* clusters) {
  static std::mutex mu;
  static std::vector<std::pair<std::pair<const void*, size_t>, int>> known;
  const auto key = std::make_pair(
      reinterpret_cast<const void*>(kernel),
      cfg.dynamicSmemBytes * 16 + cfg.attrs[0].val.clusterDim.x);
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& k : known) {
    if (k.first == key) {
      *clusters = k.second;
      return cudaSuccess;
    }
  }
  const cudaError_t err = cudaOccupancyMaxActiveClusters(clusters, kernel,
                                                         &cfg);
  if (err != cudaSuccess) return err;
  if (*clusters < 1) return cudaErrorInvalidConfiguration;
  known.emplace_back(key, *clusters);
  return cudaSuccess;
}

template <typename T, bool kMx, bool kCol, bool kBeta, bool kPiped>
inline cudaError_t launch_plan(const Args& a, const Plan& p,
                               cudaStream_t stream) {
  const auto kernel = norm_quant_kernel<T, kMx, kCol, kBeta, kPiped>;
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(p.C);
  int clusters = 0;
  err = resident_clusters(kernel, cfg, &clusters);
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3(p.C * std::min(clusters, (a.M + kRows - 1) / kRows));
  return cudaLaunchKernelEx(&cfg, kernel, a, p);
}

// Launches the body for a's shape: C and the tiles from make_plan, the
// colwise step where a.col is given, beta where given.
template <typename T, bool kMx, bool kCol, bool kBeta>
inline cudaError_t launch_tiles(const Args& a, const Plan& p,
                                cudaStream_t stream) {
  return p.piped ? launch_plan<T, kMx, kCol, kBeta, true>(a, p, stream)
                 : launch_plan<T, kMx, kCol, kBeta, false>(a, p, stream);
}

template <typename T, bool kMx>
inline cudaError_t launch(const Args& a, cudaStream_t stream) {
  const Plan p = make_plan<T>(a.H);
  const bool col = a.col != nullptr;
  if (a.beta != nullptr)
    return col ? launch_tiles<T, kMx, true, true>(a, p, stream)
               : launch_tiles<T, kMx, false, true>(a, p, stream);
  return col ? launch_tiles<T, kMx, true, false>(a, p, stream)
             : launch_tiles<T, kMx, false, false>(a, p, stream);
}

}  // namespace norm_quant
