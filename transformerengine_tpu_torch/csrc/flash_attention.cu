// Flash attention forward over BSHD tensors, returning O and the
// log-sum-exp of each query row.
//
// Replaces transformerengine_tpu/ops/flash_attention.py flash_attention,
// forward (`_flash_fwd` with the Pallas `_fwd_kernel_steps` /
// `_fwd_kernel`, bodies `_fwd_block_body` and `_fwd_write_out`). Scope:
// no mask, causal with a bottom-right offset, the padding mask from
// per-sequence lengths, a static sliding window (`_mask_scores`: key j is
// visible to query i when i + offset - left <= j <= i + offset + right,
// each side where it is >= 0) and a per-head softmax sink; GQA with
// Hq % Hkv == 0; bf16 or f32; D <= 256.
//
// Numerics follow the reference: the caller folds scale * log2(e) into q
// in q's dtype, scores run in the exp2 domain, masked scores are -2e30
// under a running max that starts at -1e30 (so they underflow to exactly
// 0), the softmax weights are rounded to V's dtype before the PV product,
// and a row with no visible key writes O = 0 and LSE = -1e30. The sink
// (an (Hq,) f32 logit, `_fwd_write_out`'s epilogue) is one virtual key
// with no value that joins the denominator at the end, in the exp2
// domain: s0 = sink * log2(e), m2 = max(m, s0), l2 = l * 2^(m - m2) +
// 2^(s0 - m2), O = acc * 2^(m - m2) / l2, LSE = m2 * ln(2) + ln(l2); a row
// with no visible key then writes O = 0 and LSE = sink. The decode kernel
// (decode_attention.cu) applies the same epilogue in the exp domain.
//
// Bound on an H100: bytes. The serving path's prefill (B = 8, padded to
// S = 512, lengths 512 and 384 mixed, Hq = 32, Hkv = 8, D = 128) reads Q,
// K and V over the 3584 valid rows and writes O and LSE in full, about
// 78 MB: 23 us at 3.35 TB/s. Its causal products are 13.45 GFLOP, 14 us
// at the 989 TFLOP/s bf16 tensor-core peak. This design does them with
// f32 FMAs on the CUDA cores, whose much lower rate is its real limit;
// tensor cores come later. GPT-OSS's banded prefill (B 8, S 512, Hq 64,
// Hkv 8, D 64, band 128, a sink) moves about 71 MB (21 us) for 6.5 GFLOP
// over the band's pairs: bytes again. Starting each tile loop at the
// band's left edge cuts the K tiles a (q head, sequence) visits from the
// causal triangle's 36 to 21.
//
// Design (simple and right first; wgmma and TMA come later): one block
// per (q tile of 64 rows, q head, batch). The block holds its Q tile in
// shared memory as f32 (read with 16-byte loads, as are K and V) and
// loops over 64-key K/V tiles, from the first tile the window's left edge
// reaches (as the reference's `_enumerate_steps`) to the causal diagonal,
// the window's right edge and the sequence's length: a tile with no
// visible key leaves the running sums unchanged, so skipping it is exact,
// and a banded layer does the band's work, not the causal triangle's. Each of the 256 threads computes a
// 4 x 4 block of scores with FMAs (rows 4 * (tid / 16) + r, keys
// tid % 16 + 16 * c), the online softmax reduces over the 16 lanes that
// share a row, and the same threads own 4 rows x D / 16 columns of the
// output accumulator. K rows are padded to D + 1 floats so that the 16
// lanes reading 16 keys hit distinct banks.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) +
                          (size_t)kBK * D + (size_t)kBQ * (kBK + 1));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, const int* __restrict__ qlens,
                     const int* __restrict__ klens,
                     const float* __restrict__ sink, int Sq, int Skv, int Hq,
                     int Hkv, int D, int causal, int offset, int left,
                     int right) {
  constexpr int kCols = DMAX / 16;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;              // [kBQ][D + 1]
  float* Ks = Qs + kBQ * ld;     // [kBK][D + 1]
  float* Vs = Ks + kBK * ld;     // [kBK][D]
  float* Ps = Vs + kBK * D;      // [kBQ][kBK + 1]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const int qlen = qlens != nullptr ? qlens[b] : Sq;
  const int klen = klens != nullptr ? klens[b] : Skv;
  // Keys past kend are masked for every row of this tile.
  int kend = min(Skv, klen);
  if (causal) kend = min(kend, q0 + kBQ + offset);
  if (right >= 0) kend = min(kend, q0 + kBQ + offset + right);
  if (q0 >= qlen) kend = 0;
  // Keys before kbeg are outside the window of every row of this tile.
  const int kbeg = left >= 0 ? max(0, q0 + offset - left) / kBK * kBK : 0;

  // Tiles move with 16-byte loads of kVec values (D % 16 == 0).
  constexpr int kVec = 16 / sizeof(T);
  const int vecs_per_row = D / kVec;
  for (int i = tid; i < kBQ * vecs_per_row; i += kThreads) {
    const int r = i / vecs_per_row;
    const int d = (i - r * vecs_per_row) * kVec;
    const int qi = q0 + r;
    float qv[kVec];
    if (qi < Sq) {
      load16(q + (((size_t)b * Sq + qi) * Hq + h) * D + d, qv);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) qv[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) Qs[r * ld + d + e] = qv[e];
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    __syncthreads();  // Q is loaded; the previous tile is no longer read
    for (int i = tid; i < kBK * vecs_per_row; i += kThreads) {
      const int j = i / vecs_per_row;
      const int d = (i - j * vecs_per_row) * kVec;
      const int kj = k0 + j;
      float kv[kVec], vv[kVec];
      if (kj < Skv) {
        const size_t src = (((size_t)b * Skv + kj) * Hkv + hk) * D + d;
        load16(k + src, kv);
        load16(v + src, vv);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kv[e] = vv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        Ks[j * ld + d + e] = kv[e];
        Vs[j * D + d + e] = vv[e];
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = Qs[(ty * 4 + r) * ld + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * ld + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty * 4 + r;
      float mx = kMasked;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        bool visible = kj < Skv;
        if (causal) visible = visible && kj <= qi + offset;
        if (left >= 0) visible = visible && kj >= qi + offset - left;
        if (right >= 0) visible = visible && kj <= qi + offset + right;
        if (qlens != nullptr) visible = visible && qi < qlen && kj < klen;
        if (!visible) s[r][c] = kMasked;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], half_warp_max(mx));
      const float alpha = exp2f(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(s[r][c] - m_new);
        rs += p;
        Ps[(ty * 4 + r) * (kBK + 1) + tx + 16 * c] = round_to<T>(p);
      }
      l[r] = l[r] * alpha + half_warp_sum(rs);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < kBK; ++j) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = Ps[(ty * 4 + r) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (c * 16 < D) {
          const float vv = Vs[j * D + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(p[r], vv, acc[r][c]);
        }
      }
    }
  }

  const float s0 = sink != nullptr ? sink[h] * kLog2e : 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty * 4 + r;
    if (qi >= Sq) continue;
    const size_t row = ((size_t)b * Sq + qi) * Hq + h;
    float lse_r;
    if (sink != nullptr) {
      // 2^(m - m2) is 0 for a row with no visible key (m at the floor),
      // and l2 >= 2^(s0 - m2) > 0.
      const float m2 = fmaxf(m[r], s0);
      const float alpha = exp2f(m[r] - m2);
      const float l2 = l[r] * alpha + exp2f(s0 - m2);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (c * 16 < D)
          o[row * D + tx + 16 * c] = from_float<T>(acc[r][c] * alpha / l2);
      }
      lse_r = m2 * kLn2 + logf(l2);
    } else {
      const float l_safe = l[r] > 0.f ? l[r] : 1.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (c * 16 < D)
          o[row * D + tx + 16 * c] = from_float<T>(acc[r][c] / l_safe);
      }
      lse_r = l[r] > 0.f ? m[r] * kLn2 + logf(l_safe) : kNegInf;
    }
    if (tx == 0) lse[((size_t)b * Hq + h) * Sq + qi] = lse_r;
  }
}

struct Mask {
  int causal, offset, left, right;
};

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int* qlens, const int* klens,
                   const float* sink, int B, int Sq, int Skv, int Hq, int Hkv,
                   int D, const Mask& mk, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DMAX>;
  const size_t smem = smem_bytes(D);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, qlens, klens, sink,
      Sq, Skv, Hq, Hkv, D, mk.causal, mk.offset, mk.left, mk.right);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     float* lse, const int* qlens, const int* klens,
                     const float* sink, int B, int Sq, int Skv, int Hq,
                     int Hkv, int D, const Mask& mk, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, lse, qlens, klens, sink, B, Sq, Skv, Hq,
                         Hkv, D, mk, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, lse, qlens, klens, sink, B, Sq, Skv, Hq,
                          Hkv, D, mk, stream);
  return launch<T, 256>(q, k, v, o, lse, qlens, klens, sink, B, Sq, Skv, Hq,
                        Hkv, D, mk, stream);
}

}  // namespace

extern "C" int te_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, int dtype, void* o,
                                      float* lse, const int* qlens,
                                      const int* klens, const float* sink,
                                      int B, int Sq, int Skv, int Hq, int Hkv,
                                      int D, int causal, int offset, int left,
                                      int right, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || Hq % Hkv != 0 || D < 16 ||
      D > 256 || D % 16 != 0 || left < -1 || right < -1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mask mk{causal, offset, left, right};
  switch (dtype) {
    case kBFloat16:
      return launch_d<__nv_bfloat16>(q, k, v, o, lse, qlens, klens, sink, B,
                                     Sq, Skv, Hq, Hkv, D, mk, s);
    case kFloat32:
      return launch_d<float>(q, k, v, o, lse, qlens, klens, sink, B, Sq, Skv,
                             Hq, Hkv, D, mk, s);
    default:
      return cudaErrorInvalidValue;
  }
}
