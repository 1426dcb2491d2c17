// The decode attention kernels' one body (decode_attention.cu over a
// contiguous cache, paged_decode_attention.cu over a paged pool): one query
// token per sequence, G = Hq / Hkv query heads of a GQA group against the
// keys of their kv head.
//
// Numerics, as the reference's Pallas forms (`_decode_kernel`,
// `_paged_kernel`): K and V are dequantized to f32 where they are used
// (payload * kv_scale), scores are f32 dot products times the softmax
// scale, and an online softmax runs in the natural exp domain with -1e30
// as the mask value; a sink joins the denominator at the end, and a row
// with no visible key (and no sink) gives zeros.
//
// Bound on an H100: bytes. Each visible key's K and V rows are read once.
//
// Design. The grid is (splits, Hkv, B): the keys of a (batch row, kv head)
// are split across `splits` blocks, chosen on the host from shapes alone
// (the span of keys a row can reach, B * Hkv and the blocks the card holds
// at once), so that the grid fills the card once. Each block reads its
// row's length on the card and takes an even share of the row's 64-key
// tiles. A block has one warp per query head; its K and V tiles stream
// into a two-stage ring of shared memory by cp.async (all of a tile's
// copies issued before any is waited on; the next tile's while this one is
// scored) and stay in the cache's dtype there, in rows of an odd number of
// 16-byte chunks, so that the 8 rows a quarter-warp reads at one chunk
// fall in 8 different bank groups. Lanes own keys for the scores (two
// each) and DMAX / 32 consecutive head-dim columns for the PV product,
// and dequantize each value where they use it. With one split the block
// writes O. With more, each block writes its heads' (m, l, acc[D]) in f32
// to a workspace, and the last block of the row to finish (a ticket
// counter, which it resets, so that a launch leaves no state behind and is
// safe inside a CUDA graph) combines them in split order: m = max m_i,
// l = sum l_i e^(m_i - m), acc = sum acc_i e^(m_i - m) (a split with
// m_i <= -1e30 / 2 weighs 0), then the sink and the division. The result
// does not depend on which block ends last.
//
// tools/decode_attn_probe.py times each block's phases on the card (the
// length's and the tile's loads, the arithmetic, the ticket, the combine).
#pragma once

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "common.cuh"
#include "ptx.cuh"

namespace decode_attn {

constexpr int kBS = 64;  // keys a tile
// Splits of a row at most, and (batch row, kv head) pairs with a ticket
// counter; keep both in step with ops/decode_attention.py.
constexpr int kMaxSplits = 64;
constexpr int kMaxRows = 16384;
constexpr size_t kMaxSmem = 232448;

namespace {
// How many blocks of a row have written their partial results. The last
// resets its row's to 0. Launches on two streams at once would share them;
// the port launches on one.
__device__ unsigned int tickets[kMaxRows];
}  // namespace

// Where key `pos` of batch row b and kv head hk lies in a contiguous
// (B, S, Hkv, D) cache. A tile starts at a multiple of kBS.
struct ContiguousRows {
  int S, Hkv, D, window_left;
  __device__ int length(int raw) const { return min(raw, S); }
  // The first key a row reads (its window's edge, rounded down to a tile)
  // and the first it sees.
  __device__ int first(int len) const {
    return window_left >= 0 ? max(0, len - 1 - window_left) / kBS * kBS : 0;
  }
  __device__ int visible_from(int len) const {
    return window_left >= 0 ? len - 1 - window_left : 0;
  }
  __device__ long long tile_base(int b, int hk, int t0) const {
    return (((long long)b * S + t0) * Hkv + hk) * D;
  }
  __device__ long long row(int b, int hk, long long base, int pos,
                           int j) const {
    return base + (long long)j * Hkv * D;
  }
};

// Key `pos` of a paged (P, page, Hkv, D) pool: page table[b, pos / page]
// (clamped into the pool, as the reference's), row pos % page. A sequence
// reads at most max_pages * page keys.
struct PagedRows {
  const int* table;
  int P, page, max_pages, Hkv, D;
  __device__ int length(int raw) const {
    return max(0, min(raw, max_pages * page));
  }
  __device__ int first(int) const { return 0; }
  __device__ int visible_from(int) const { return 0; }
  __device__ int phys(int b, int idx) const {
    return min(max(__ldg(table + (size_t)b * max_pages + idx), 0), P - 1);
  }
  // Where the page is a multiple of the tile, the tile lies in one page and
  // its table entry is read once; else each row reads its own (-1).
  __device__ long long tile_base(int b, int hk, int t0) const {
    if (page % kBS != 0) return -1;
    return (((long long)phys(b, t0 / page) * page + t0 % page) * Hkv + hk) *
           D;
  }
  __device__ long long row(int b, int hk, long long base, int pos,
                           int j) const {
    if (base >= 0) return base + (long long)j * Hkv * D;
    return (((long long)phys(b, pos / page) * page + pos % page) * Hkv + hk) *
           D;
  }
};

// N bytes as one register value (N = 2, 4, 8, 16 or 32).
struct Raw32 {
  uint4 a, b;
};
template <int N>
struct RawT;
template <>
struct RawT<2> {
  using type = unsigned short;
};
template <>
struct RawT<4> {
  using type = unsigned int;
};
template <>
struct RawT<8> {
  using type = uint2;
};
template <>
struct RawT<16> {
  using type = uint4;
};
template <>
struct RawT<32> {
  using type = Raw32;
};

// N consecutive CT values held as raw bytes, as f32.
template <typename CT, int N>
__device__ __forceinline__ void widen_raw(
    const typename RawT<N * sizeof(CT)>::type& r, float (&out)[N]) {
  constexpr int kBytes = N * (int)sizeof(CT);
  uint32_t w[(kBytes + 3) / 4];
  if constexpr (kBytes <= 4) {
    w[0] = r;
  } else if constexpr (kBytes == 8) {
    w[0] = r.x;
    w[1] = r.y;
  } else if constexpr (kBytes == 16) {
    w[0] = r.x;
    w[1] = r.y;
    w[2] = r.z;
    w[3] = r.w;
  } else {
    const uint4 h[2] = {r.a, r.b};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      w[4 * i] = h[i].x;
      w[4 * i + 1] = h[i].y;
      w[4 * i + 2] = h[i].z;
      w[4 * i + 3] = h[i].w;
    }
  }
  if constexpr (kIsFp8<CT>) {
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w[k / 2] >> (16 * (k % 2))),
          __NV_E4M3)));
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  } else if constexpr (std::is_same<CT, __nv_bfloat16>::value) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      out[i] = __uint_as_float(i % 2 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __uint_as_float(w[i]);
  }
}

// N consecutive CT values at p (N * sizeof(CT) bytes, aligned to that size
// up to 16) as f32.
template <typename CT, int N>
__device__ __forceinline__ void widen_n(const unsigned char* p,
                                        float (&out)[N]) {
  widen_raw<CT, N>(
      *reinterpret_cast<const typename RawT<N * sizeof(CT)>::type*>(p), out);
}

// Values 4 i .. 4 i + 3 of a 16-byte vector of CT values as f32.
template <typename CT>
__device__ __forceinline__ void widen4(const uint4& r, int i,
                                       float (&out)[4]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  if constexpr (sizeof(CT) == 1)
    widen_raw<CT, 4>(w[i], out);
  else if constexpr (sizeof(CT) == 2)
    widen_raw<CT, 4>(uint2{w[2 * i], w[2 * i + 1]}, out);
  else
    widen_raw<CT, 4>(r, out);
}

// N (2, 4 or 8) f32 values at a 4N-byte-aligned address of the workspace.
template <int N>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[N]) {
  if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = float2{v[0], v[1]};
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          float4{v[i], v[i + 1], v[i + 2], v[i + 3]};
  }
}

// ... and their loads through L2 (other blocks wrote them).
template <int N>
__device__ __forceinline__ void load_f32_cg(const float* p, float (&v)[N]) {
  if constexpr (N == 2) {
    const float2 a = __ldcg(reinterpret_cast<const float2*>(p));
    v[0] = a.x;
    v[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 a = __ldcg(reinterpret_cast<const float4*>(p + i));
      v[i] = a.x;
      v[i + 1] = a.y;
      v[i + 2] = a.z;
      v[i + 3] = a.w;
    }
  }
}

// Copies the K and V rows of the tile at t0 into a stage of the ring
// ([K|V][kBS][ld] bytes); keys at or past the length are zeros.
template <typename CT, typename Rows>
__device__ __forceinline__ void issue_tile(unsigned char* stage,
                                           const CT* __restrict__ kc,
                                           const CT* __restrict__ vc,
                                           const Rows& rows, int b, int hk,
                                           int t0, int len, int C, int ld) {
  constexpr int kVec = 16 / sizeof(CT);
  const long long base = rows.tile_base(b, hk, t0);
  for (int i = threadIdx.x; i < kBS * C; i += blockDim.x) {
    const int j = i / C;
    const int c = i - j * C;
    const int pos = t0 + j;
    const bool valid = pos < len;
    const long long off = valid ? rows.row(b, hk, base, pos, j) : 0;
    cp_async16(stage + j * ld + c * 16, kc + off + c * kVec, valid);
    cp_async16(stage + (kBS + j) * ld + c * 16, vc + off + c * kVec, valid);
  }
  cp_async_commit();
}

// O = acc / l with the sink in the denominator, as the reference's end.
template <typename QT, int kW>
__device__ __forceinline__ void write_out(QT* __restrict__ out,
                                          const float* __restrict__ sink,
                                          int h, float m, float l,
                                          const float (&acc)[kW], bool active,
                                          size_t at) {
  float mult;
  if (sink != nullptr) {
    const float s0 = __ldg(sink + h);
    const float m2 = fmaxf(m, s0);
    const float a2 = m2 <= kNegInf / 2 ? 0.f : expf(m - m2);
    mult = a2 / (l * a2 + expf(s0 - m2));
  } else {
    mult = 1.f / (l > 0.f ? l : 1.f);
  }
  if (active) {
#pragma unroll
    for (int w = 0; w < kW; ++w) out[at + w] = from_float<QT>(acc[w] * mult);
  }
}

// Block (split, hk, b), 32 G threads. ws: [B Hkv][splits][G][D] partial
// accumulators, then [B Hkv][splits][G][2] (m, l); unused with one split.
template <typename QT, typename CT, int DMAX, typename Rows>
__global__ void __launch_bounds__(1024) decode_attn_kernel(
    const QT* __restrict__ q, const CT* __restrict__ kc,
    const CT* __restrict__ vc, const int* __restrict__ lengths,
    const float* __restrict__ kv_scale, int scale_per_row,
    const float* __restrict__ sink, QT* __restrict__ out,
    float* __restrict__ ws, int Hq, int D, float scale, int stages,
    Rows rows) {
  constexpr int kW = DMAX / 32;  // head-dim columns a lane
  constexpr int kVec = 16 / sizeof(CT);
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = blockDim.x >> 5;
  const int g = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int split = blockIdx.x, splits = gridDim.x;
  const int hk = blockIdx.y, Hkv = gridDim.y;
  const int b = blockIdx.z;
  const int h = hk * G + g;
  const int C = D / kVec;          // 16-byte chunks a row
  const int ld = (C | 1) * 16;     // a staged row's bytes
  const int stage_bytes = 2 * kBS * ld;
  int* last = reinterpret_cast<int*>(smem);
  float* qs = reinterpret_cast<float*>(smem + 16);  // [G][D]
  float* ps = qs + G * D;                          // [G][kBS]
  unsigned char* ring = reinterpret_cast<unsigned char*>(ps + G * kBS);

  // Head h's q: the lane's kW columns, loaded before the row's length.
  const bool active = lane * kW < D;
  float qr[kW];
  if (active)
    widen_n<QT, kW>(reinterpret_cast<const unsigned char*>(
                        q + ((size_t)b * Hq + h) * D + lane * kW),
                    qr);
  const int len = rows.length(__ldg(lengths + b));
  const int lo = rows.visible_from(len);
  const int tb = rows.first(len) / kBS;
  const int n = len > 0 ? (len + kBS - 1) / kBS - tb : 0;
  const int t_begin = tb + (int)((long long)split * n / splits);
  const int t_end = tb + (int)((long long)(split + 1) * n / splits);
  const float ks = __ldg(kv_scale + (scale_per_row ? b : 0));
  if (t_begin < t_end)
    issue_tile(ring, kc, vc, rows, b, hk, t_begin * kBS, len, C, ld);
  if (active) store_f32<kW>(qs + g * D + lane * kW, qr);

  float m = kNegInf, l = 0.f, acc[kW];
#pragma unroll
  for (int w = 0; w < kW; ++w) acc[w] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int it = t - t_begin;
    const unsigned char* Ks = ring + (stages == 2 ? (it & 1) : 0) * stage_bytes;
    const unsigned char* Vs = Ks + kBS * ld;
    if (stages == 2 && t + 1 < t_end) {
      issue_tile(ring + ((it + 1) & 1) * stage_bytes, kc, vc, rows, b, hk,
                 (t + 1) * kBS, len, C, ld);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the tile (and q) landed for every thread
    const int t0 = t * kBS;

    // Scores of keys lane and lane + 32, four partial sums each so that
    // the FMAs do not wait on each other.
    float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
    const float* qg = qs + g * D;
    for (int c = 0; c < C; ++c) {
      const uint4 r0 = *reinterpret_cast<const uint4*>(Ks + lane * ld + c * 16);
      const uint4 r1 =
          *reinterpret_cast<const uint4*>(Ks + (lane + 32) * ld + c * 16);
#pragma unroll
      for (int i = 0; i < kVec / 4; ++i) {
        float k0[4], k1[4];
        widen4<CT>(r0, i, k0);
        widen4<CT>(r1, i, k1);
        const float4 qv =
            *reinterpret_cast<const float4*>(qg + c * kVec + 4 * i);
        const float qe[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          d0[u] = fmaf(qe[u], k0[u] * ks, d0[u]);
          d1[u] = fmaf(qe[u], k1[u] * ks, d1[u]);
        }
      }
    }
    const int p0 = t0 + lane, p1 = p0 + 32;
    const bool v0 = p0 >= lo && p0 < len, v1 = p1 >= lo && p1 < len;
    const float s0 = v0 ? ((d0[0] + d0[1]) + (d0[2] + d0[3])) * scale : kNegInf;
    const float s1 = v1 ? ((d1[0] + d1[1]) + (d1[2] + d1[3])) * scale : kNegInf;
    const float m_new = fmaxf(m, warp_max(fmaxf(s0, s1)));
    const float alpha = m_new <= kNegInf / 2 ? 0.f : expf(m - m_new);
    const float e0 = v0 ? expf(s0 - m_new) : 0.f;
    const float e1 = v1 ? expf(s1 - m_new) : 0.f;
    l = l * alpha + warp_sum(e0 + e1);
    m = m_new;
    ps[g * kBS + lane] = e0;
    ps[g * kBS + lane + 32] = e1;
    __syncwarp();

#pragma unroll
    for (int w = 0; w < kW; ++w) acc[w] *= alpha;
    if (active) {
      // Keys past the length weigh 0 and are not read.
      const int jn = min(kBS, len - t0);
      const unsigned char* vcol = Vs + lane * kW * (int)sizeof(CT);
      for (int j = 0; j < jn; ++j) {
        const float p = ps[g * kBS + j];
        float v[kW];
        widen_n<CT, kW>(vcol + j * ld, v);
#pragma unroll
        for (int w = 0; w < kW; ++w) acc[w] = fmaf(p, v[w] * ks, acc[w]);
      }
    }
    __syncthreads();  // the stage is refilled next
    if (stages == 1 && t + 1 < t_end)
      issue_tile(ring, kc, vc, rows, b, hk, (t + 1) * kBS, len, C, ld);
  }

  const size_t row = (size_t)b * Hkv + hk;
  const size_t at = ((size_t)b * Hq + h) * D + lane * kW;
  if (splits == 1) {
    write_out<QT, kW>(out, sink, h, m, l, acc, active, at);
    return;
  }
  const size_t n_rows = (size_t)gridDim.z * Hkv;
  float* ws_ml = ws + n_rows * splits * G * D;
  if (active)
    store_f32<kW>(ws + ((row * splits + split) * G + g) * D + lane * kW, acc);
  if (lane == 0) {
    ws_ml[((row * splits + split) * G + g) * 2] = m;
    ws_ml[((row * splits + split) * G + g) * 2 + 1] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const bool is_last =
        atomicAdd(&tickets[row], 1u) == (unsigned)splits - 1;
    if (is_last) __threadfence();
    *last = is_last;
  }
  __syncthreads();
  if (!*last) return;

  // The last block: each warp combines its head's splits in split order.
  // Lane i holds split i's (m, l) and lane i's second pair split i + 32's;
  // the first splits' partial accumulators load alongside.
  const float* cml = ws_ml + (row * splits * G + g) * 2;
  const float* cacc = ws + (row * splits * G + g) * D + lane * kW;
  constexpr int kU = 16 / kW;  // splits' accumulators in flight
  float a[kU][kW];
  auto load_acc = [&](int i0) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int w = 0; w < kW; ++w) a[u][w] = 0.f;
      if (active && i0 + u < splits)
        load_f32_cg<kW>(cacc + (size_t)(i0 + u) * G * D, a[u]);
    }
  };
  load_acc(0);
  float m_a = kNegInf, l_a = 0.f, m_b = kNegInf, l_b = 0.f;
  if (lane < splits) {
    m_a = __ldcg(cml + (size_t)lane * G * 2);
    l_a = __ldcg(cml + (size_t)lane * G * 2 + 1);
  }
  if (lane + 32 < splits) {
    m_b = __ldcg(cml + (size_t)(lane + 32) * G * 2);
    l_b = __ldcg(cml + (size_t)(lane + 32) * G * 2 + 1);
  }
  const float mx = warp_max(fmaxf(m_a, m_b));
  const float w_a = m_a <= kNegInf / 2 ? 0.f : expf(m_a - mx);
  const float w_b = m_b <= kNegInf / 2 ? 0.f : expf(m_b - mx);
  float lsum = 0.f, asum[kW];
#pragma unroll
  for (int w = 0; w < kW; ++w) asum[w] = 0.f;
  for (int i0 = 0; i0 < splits; i0 += kU) {
    if (i0 > 0) load_acc(i0);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u;
      if (i < splits) {
        const float wgt = __shfl_sync(0xffffffffu, i < 32 ? w_a : w_b, i & 31);
        const float li = __shfl_sync(0xffffffffu, i < 32 ? l_a : l_b, i & 31);
        lsum = fmaf(li, wgt, lsum);
#pragma unroll
        for (int w = 0; w < kW; ++w) asum[w] = fmaf(a[u][w], wgt, asum[w]);
      }
    }
  }
  write_out<QT, kW>(out, sink, h, mx, lsum, asum, active, at);
  if (threadIdx.x == 0) tickets[row] = 0u;
}

// A launch's arguments, as the C entry points take them; span is how many
// keys a row can reach (what bounds its tiles).
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  const float* kv_scale;
  int scale_per_row;
  const float* sink;
  void* out;
  float* ws;
  int max_splits;
  int B, Hq, Hkv, D;
  float scale;
  long long span;
  cudaStream_t stream;
};

template <typename QT, typename CT, int DMAX, typename Rows>
cudaError_t launch(const Args& a, const Rows& rows) {
  auto kernel = decode_attn_kernel<QT, CT, DMAX, Rows>;
  const int G = a.Hq / a.Hkv;
  const int threads = 32 * G;
  const int ld = ((a.D * (int)sizeof(CT) / 16) | 1) * 16;
  const size_t stage = 2 * (size_t)kBS * ld;
  const size_t fixed = 16 + sizeof(float) * ((size_t)G * a.D + (size_t)G * kBS);
  const int stages_max = fixed + 2 * stage <= kMaxSmem ? 2 : 1;
  const size_t smem_max = fixed + stages_max * stage;
  cudaError_t err = allow_smem(kernel, smem_max);
  if (err != cudaSuccess) return err;
  // The blocks the card holds at once, read once for each shape of block.
  static std::atomic<unsigned long long> memo{0};
  const unsigned long long key =
      ((unsigned long long)smem_max << 11 | (unsigned)threads) << 20;
  unsigned long long seen = memo.load(std::memory_order_relaxed);
  if (seen >> 20 != key >> 20) {
    seen = key | (unsigned)resident_blocks(kernel, threads, smem_max);
    memo.store(seen, std::memory_order_relaxed);
  }
  const int slots = (int)(seen & 0xfffff);
  // Enough splits to fill the card once, each at least one tile.
  const long long tiles = (a.span + kBS - 1) / kBS;
  int splits = slots / (a.B * a.Hkv);
  splits = (int)std::min<long long>(splits, tiles);
  splits = std::min(std::min(splits, kMaxSplits), a.ws ? a.max_splits : 1);
  splits = std::max(splits, 1);
  const int stages = (tiles + splits - 1) / splits > 1 ? stages_max : 1;
  const size_t smem = fixed + stages * stage;
  kernel<<<dim3(splits, a.Hkv, a.B), threads, smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const CT*>(a.k),
      static_cast<const CT*>(a.v), a.lengths, a.kv_scale, a.scale_per_row,
      a.sink, static_cast<QT*>(a.out), a.ws, a.Hq, a.D, a.scale, stages,
      rows);
  return cudaGetLastError();
}

template <typename QT, typename CT, typename Rows>
cudaError_t launch_d(const Args& a, const Rows& rows) {
  if (a.D <= 64) return launch<QT, CT, 64>(a, rows);
  if (a.D <= 128) return launch<QT, CT, 128>(a, rows);
  return launch<QT, CT, 256>(a, rows);
}

template <typename QT, typename Rows>
cudaError_t launch_c(int cache_dtype, const Args& a, const Rows& rows) {
  switch (cache_dtype) {
    case kFloat8E4M3:
      return launch_d<QT, __nv_fp8_e4m3>(a, rows);
    case kBFloat16:
      return launch_d<QT, __nv_bfloat16>(a, rows);
    case kFloat32:
      return launch_d<QT, float>(a, rows);
    default:
      return cudaErrorInvalidValue;
  }
}

// The entry points' checks: D of 16-256 in steps of 16, G <= 32, and at
// most kMaxRows (batch row, kv head) pairs; then the dtype dispatch.
template <typename Rows>
cudaError_t run(int q_dtype, int cache_dtype, const Args& a,
                const Rows& rows) {
  if (a.B < 1 || a.Hkv < 1 || a.Hq % a.Hkv != 0 || a.Hq / a.Hkv > 32 ||
      a.D < 16 || a.D > 256 || a.D % 16 != 0 ||
      (long long)a.B * a.Hkv > kMaxRows || a.max_splits < 1)
    return cudaErrorInvalidValue;
  switch (q_dtype) {
    case kBFloat16:
      return launch_c<__nv_bfloat16>(cache_dtype, a, rows);
    case kFloat32:
      return launch_c<float>(cache_dtype, a, rows);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace decode_attn
