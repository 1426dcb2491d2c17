// Flash attention forward over BSHD tensors, returning O and the
// log-sum-exp of each query row.
//
// Replaces transformerengine_tpu/ops/flash_attention.py flash_attention,
// forward (`_flash_fwd` with the Pallas `_fwd_kernel_steps` /
// `_fwd_kernel`, bodies `_fwd_block_body` and `_fwd_write_out`). Scope:
// no mask, causal with a bottom-right offset, the padding mask from
// per-sequence lengths, segment ids of packed documents (below), a static
// sliding window (`_mask_scores`: key j is visible to query i when
// i + offset - left <= j <= i + offset + right, each side where it is
// >= 0) and a per-head softmax sink; GQA with Hq % Hkv == 0; bf16 or f32,
// or e4m3 payloads (the FP8 branch below); D <= 256.
//
// Segment branch (the reference's `use_segments`, `_mask_scores`): with
// `qseg` and `kseg`, (B, Sq) and (B, Skv) int32 ids, key j is visible to
// query i only where qseg[b, i] == kseg[b, j] != 0, beside the other
// terms (the causal rule and the window compare indices, as the
// reference's kernel does). Any ids in any order: the rule is equality.
// The block keeps its Q tile's ids in shared memory and loads each K/V
// tile's with the tile, each in its tile's padding column (index D of a
// row, which the products never read), so the branch adds no shared
// memory: at D = 128 two blocks still fit an SM. A query with id 0 sees
// no key and writes O = 0 and LSE = -1e30 (the sink with one). Tiles are
// not skipped by segment: a packed row does the causal triangle's work.
//
// Bias and ALiBi branches (the reference's `use_bias` and its ALiBi
// `score_mod`, `_fwd_block_body`): a post-scale bias (`bias_b` = 1 or B,
// Hq, Sq, Skv), f32 or bf16 and read in its own dtype, adds bias * log2(e)
// in f32 to each pre-scaled score before the mask; a first dimension of 1
// broadcasts it over the batch, and each query head reads its own plane
// under GQA. ALiBi takes q unscaled and the (Hq,) f32 slopes: each score
// becomes (s * scale - slope_h * |i + offset - j|) * log2(e). Each thread
// reads the bias elements of its own 4 x 4 score block straight from
// global memory (16 lanes read 16 consecutive keys of a row), so the
// branch adds no shared memory; it is a template instance of its own
// (bf16 and f32 only, built in flash_attention_terms.cu beside this
// file), so the kernel without it compiles as it did: a runtime flag in
// the shared instance cost the bias-free forward 5 % and backward 18 %
// (an H100 80GB HBM3 at 700 W). Tiles are skipped by the mask alone, so
// a bidirectional (padding-mask) layer visits every (Q tile, K tile) pair
// below the lengths: up to twice the causal triangle's work at the same
// shape (1.56x at lengths 2048 and 1536). Bound at
// the encoder's training shape (B 2, S 2048, Hq 32, Hkv 8, D 128, bf16,
// lengths 2048 and 1536, an f32 (1, 32, 2048, 2048) bias): the products
// over the visible pairs (107 GFLOP, 0.109 ms at the bf16 peak) against
// the bias's 512 MiB read once with Q, K, V, O and LSE (about 622 MB,
// 0.19 ms): bytes.
//
// Dropout branch (the reference's `dropout_rate`, `_fwd_block_body` with
// `_dropout_keep`): each visible score's weight p still joins the
// denominator l, and the PV product takes where(keep, p * inv, 0), rounded
// to V's dtype; keep is common.cuh's `drop_keep`, the reference's hash of
// the score's place in the reference's tiles (not this kernel's), computed
// where the weight is, so no mask is stored and the backward kernels
// replay it. Each thread computes its rows' parts of the hash once and its
// columns' once a tile, then some twelve integer operations a score. The
// branch is a template instance of its own (bf16 and f32, built in
// flash_attention_dropout.cu beside this file, composing with the bias,
// ALiBi, the masks, the window and the sink); it adds no shared memory.
// Bound at the LLAMA_8B training shape (B 2, S 2048, Hq 32, Hkv 8, D 128,
// bf16, causal, rate 0.1): the products (68.7 GFLOP at the bf16 peak) plus
// the hash's integer operations over the causal pairs (about 14 a score,
// 1.9 G, at the 67 T/s of the CUDA cores): operations, about 0.1 ms.
//
// Soft-cap branch (the reference's `score_mod` with `soft_cap_mod`, which
// its `flex_attention(impl="flash")` traces into `_fwd_block_body`): q
// arrives unscaled and each score becomes cap * tanh(s * scale / cap) *
// log2(e) before the mask (common.cuh `add_score_terms`, in the reference
// jaxpr's order: a true division, CUDA's tanhf, no FMA contraction). Its
// own template instances (bf16 and f32, with and without dropout, built in
// flash_attention_softcap.cu and flash_attention_softcap_dropout.cu
// beside this file), so the other instances compile as they did; no added
// shared memory. Bound at the LLAMA_8B training shape (B 2, S 2048, Hq 32,
// Hkv 8, D 128, bf16, causal, cap 50): the products (68.8 GFLOP at the
// bf16 peak) plus five cap operations per visited score at the CUDA
// cores' rate: operations, about 0.08 ms.
//
// FP8 with dropout (the reference's `_fp8_core` and `_fp8_mha_core` with a
// dropout rate): the dropout instances also take e4m3 Q/K/V payloads
// (built in flash_attention_dropout.cu), O in bf16, f32 or through the
// fp8 O epilogue; the weights round to bf16 after the mask, as the
// reference's (`p.astype(bf16)` after the keep select).
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
// FP8 branch (the reference's `fp8` and `fp8_out`, `_fwd_block_body` and
// `_fwd_write_out` with `scales_ref`): Q, K and V arrive as e4m3 payloads
// of per-tensor-scaled tensors, with a device vector `scales` = [smult,
// sv_inv, out_scale] (smult = sq_inv * sk_inv * scale * log2(e)), read on
// the card, so the host never waits for a scale. q is not pre-scaled: the
// f32 score sums are multiplied by smult before the mask; the softmax
// weights round to bf16 (not to V's type) before the PV product; the
// accumulator takes sv_inv at write-out. O is written in bf16 or f32, or
// (fp8_mha under delayed scaling, `o_amax` given) as the fp8 cast of
// O * out_scale, clipped to the format's range and rounded to nearest
// even, with the amax of O before the cast reduced into *o_amax: one
// atomicMax on the f32 bits per block, exact for non-negative values, and
// a row with no visible key adds 0. Every product is exact in f32 (e4m3 x
// e4m3 and bf16 x e4m3), so the branch differs from its plain version in
// summation order alone. A window and a sink compose with it.
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
// lanes reading 16 keys hit distinct banks. The FP8 branch keeps this
// design: its payloads are widened to f32 as they are loaded (16 e4m3
// values per 16-byte load), and the fp8 tensor-core products come with the
// kernel's redesign; its bound at the training shape (B 2, S 2048, Hq 32,
// Hkv 8, D 128, causal) is the bytes (about 29 MB with an fp8 O, 9 us),
// against 4.3 us for its 8.6 GFLOP at the 1,979 TFLOP/s fp8 peak.
#include "common.cuh"

// Which instances a translation unit compiles: 0 (this file) the C entry
// point and the instances without the terms; 1 (flash_attention_terms.cu)
// the bias and ALiBi instances; 2 (flash_attention_dropout.cu) the dropout
// instances, which take the terms too, and e4m3 Q/K/V; 3
// (flash_attention_softcap.cu) the soft-cap instances; 4
// (flash_attention_softcap_dropout.cu) the soft-cap instances with
// dropout. bf16 and f32 each.
#ifndef TE_FLASH_UNIT
#define TE_FLASH_UNIT 0
#endif

// The causal rule with its offset and the window's sides; shared by both
// translation units.
struct Mask {
  int causal, offset, left, right;
};

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

template <typename T, int DMAX, int kTerms, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, void* __restrict__ o,
                     int out_code, float* __restrict__ lse,
                     const int* __restrict__ qlens,
                     const int* __restrict__ klens,
                     const int* __restrict__ qseg,
                     const int* __restrict__ kseg,
                     const float* __restrict__ sink,
                     const float* __restrict__ scales,
                     float* __restrict__ o_amax, ScoreTerms terms, int Sq,
                     int Skv, int Hq, int Hkv, int D, int causal, int offset,
                     int left, int right) {
  constexpr int kCols = DMAX / 16;
  constexpr bool kFp8 = kIsFp8<T>;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;              // [kBQ][D + 1]
  float* Ks = Qs + kBQ * ld;     // [kBK][D + 1]
  float* Vs = Ks + kBK * ld;     // [kBK][D]
  float* Ps = Vs + kBK * D;      // [kBQ][kBK + 1]
  // With segments, Qs[r][D] and Ks[j][D] hold the rows' ids as int bits.

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const float smult = kFp8 ? scales[0] : 1.f;

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
  if (qseg != nullptr && tid < kBQ)
    Qs[tid * ld + D] =
        __int_as_float(q0 + tid < Sq ? qseg[(size_t)b * Sq + q0 + tid] : 0);

  // The dropout hash's parts of this thread's rows.
  DropPart drow[4];
  if constexpr (kDropout) {
    const uint32_t head = drop_head(terms.drop, b, hk);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      drow[r] = drop_row(terms.drop, head, h - hk * (Hq / Hkv),
                         q0 + ty * 4 + r);
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
    if (kseg != nullptr && tid < kBK)
      Ks[tid * ld + D] = __int_as_float(
          k0 + tid < Skv ? kseg[(size_t)b * Skv + k0 + tid] : 0);
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

    DropPart dcol[4];
    if constexpr (kDropout) {
#pragma unroll
      for (int c = 0; c < 4; ++c) dcol[c] = drop_col(terms.drop, k0 + tx + 16 * c);
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
        if (qseg != nullptr) {
          const int qs = __float_as_int(Qs[(ty * 4 + r) * ld + D]);
          visible = visible && qs != 0 &&
                    qs == __float_as_int(Ks[(tx + 16 * c) * ld + D]);
        }
        if (kFp8) s[r][c] *= smult;
        if constexpr (kTerms != kNoTerms) {
          float th;  // the soft cap's tanh, which the forward does not need
          s[r][c] = add_score_terms<kTerms>(terms, s[r][c], b, h, Hq, Sq,
                                            Skv, qi, kj, offset, th);
        }
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
        if constexpr (kDropout) {
          // l sums the undropped weight; PV takes the dropped one.
          const float pd = drop_apply(
              terms.drop, drop_keep(terms.drop, drow[r], dcol[c]), p);
          Ps[(ty * 4 + r) * (kBK + 1) + tx + 16 * c] = round_to<RoundT<T>>(pd);
        } else {
          Ps[(ty * 4 + r) * (kBK + 1) + tx + 16 * c] = round_to<RoundT<T>>(p);
        }
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
  const float sv_inv = kFp8 ? scales[1] : 1.f;
  const float o_scale = o_amax != nullptr ? scales[2] : 1.f;
  float o_max = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty * 4 + r;
    if (qi >= Sq) continue;
    const size_t row = ((size_t)b * Sq + qi) * Hq + h;
    // O = acc * mult / div, in the reference's order: V's sv_inv first.
    float mult, div, lse_r;
    if (sink != nullptr) {
      // 2^(m - m2) is 0 for a row with no visible key (m at the floor),
      // and l2 >= 2^(s0 - m2) > 0.
      const float m2 = fmaxf(m[r], s0);
      mult = exp2f(m[r] - m2);
      div = l[r] * mult + exp2f(s0 - m2);
      lse_r = m2 * kLn2 + logf(div);
    } else {
      mult = 1.f;
      div = l[r] > 0.f ? l[r] : 1.f;
      lse_r = l[r] > 0.f ? m[r] * kLn2 + logf(div) : kNegInf;
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c * 16 < D) {
        float a = kFp8 ? acc[r][c] * sv_inv : acc[r][c];
        if (sink != nullptr) a *= mult;
        const float o_true = a / div;
        o_max = fmaxf(o_max, fabsf(o_true));
        store_as(o, out_code, row * D + tx + 16 * c, o_true * o_scale);
      }
    }
    if (tx == 0) lse[((size_t)b * Hq + h) * Sq + qi] = lse_r;
  }
  if (o_amax != nullptr) {
    __syncthreads();  // every thread is past its last read of Ps
    block_amax_to(o_max, Ps, o_amax);
  }
}

template <typename T, int DMAX, int kTerms, bool kDropout>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int out_code, float* lse, const int* qlens,
                   const int* klens, const int* qseg, const int* kseg,
                   const float* sink, const float* scales,
                   float* o_amax, const ScoreTerms& terms, int B, int Sq,
                   int Skv, int Hq, int Hkv, int D, const Mask& mk,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DMAX, kTerms, kDropout>;
  const size_t smem = smem_bytes(D);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), o, out_code, lse, qlens, klens, qseg, kseg,
      sink, scales, o_amax, terms, Sq, Skv, Hq, Hkv, D, mk.causal, mk.offset,
      mk.left, mk.right);
  return cudaGetLastError();
}

template <typename T, int kTerms, bool kDropout>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int out_code, float* lse, const int* qlens,
                     const int* klens, const int* qseg, const int* kseg,
                     const float* sink,
                     const float* scales, float* o_amax,
                     const ScoreTerms& terms, int B, int Sq, int Skv, int Hq,
                     int Hkv, int D, const Mask& mk, cudaStream_t stream) {
#define TE_FWD(DM)                                                         \
  launch<T, DM, kTerms, kDropout>(q, k, v, o, out_code, lse, qlens, klens, \
                                  qseg, kseg, sink, scales, o_amax, terms, \
                                  B, Sq, Skv, Hq, Hkv, D, mk, stream)
  return D <= 64 ? TE_FWD(64) : D <= 128 ? TE_FWD(128) : TE_FWD(256);
#undef TE_FWD
}

}  // namespace

// The instances of the other translation units, each a function of this
// signature (`dtype` Q/K/V's DTypeCode): the bias and ALiBi instances
// (bf16, f32), the dropout instances (bf16 and f32 with the bias and ALiBi
// terms, and e4m3 payloads), the soft-cap instances (bf16, f32) and the
// soft-cap instances with dropout (bf16, f32). nvcc builds the units at
// once, and the kernels without them compile as they did.
#define TE_FWD_ARGS                                                           \
  int dtype, const void *q, const void *k, const void *v, void *o,           \
      int out_code, float *lse, const int *qlens, const int *klens,          \
      const int *qseg, const int *kseg, const float *sink,                   \
      const float *scales, float *o_amax, const ScoreTerms &terms, int B,    \
      int Sq, int Skv, int Hq, int Hkv, int D, const Mask &mk,               \
      cudaStream_t stream
cudaError_t flash_fwd_terms(TE_FWD_ARGS);
cudaError_t flash_fwd_dropout(TE_FWD_ARGS);
cudaError_t flash_fwd_softcap(TE_FWD_ARGS);
cudaError_t flash_fwd_softcap_dropout(TE_FWD_ARGS);

#if TE_FLASH_UNIT != 0
#if TE_FLASH_UNIT == 1
#define TE_FWD_UNIT flash_fwd_terms
#define TE_FWD_KIND kBiasAlibi
#define TE_FWD_DROPOUT false
#elif TE_FLASH_UNIT == 2
#define TE_FWD_UNIT flash_fwd_dropout
#define TE_FWD_KIND kBiasAlibi
#define TE_FWD_DROPOUT true
#elif TE_FLASH_UNIT == 3
#define TE_FWD_UNIT flash_fwd_softcap
#define TE_FWD_KIND kSoftCap
#define TE_FWD_DROPOUT false
#else
#define TE_FWD_UNIT flash_fwd_softcap_dropout
#define TE_FWD_KIND kSoftCap
#define TE_FWD_DROPOUT true
#endif
cudaError_t TE_FWD_UNIT(TE_FWD_ARGS) {
#define TE_FWD_AS(T, KIND)                                                  \
  launch_d<T, KIND, TE_FWD_DROPOUT>(q, k, v, o, out_code, lse, qlens, klens, \
                                    qseg, kseg, sink, scales, o_amax, terms, \
                                    B, Sq, Skv, Hq, Hkv, D, mk, stream)
  switch (dtype) {
    case kBFloat16:
      return TE_FWD_AS(__nv_bfloat16, TE_FWD_KIND);
    case kFloat32:
      return TE_FWD_AS(float, TE_FWD_KIND);
#if TE_FLASH_UNIT == 2
    // FP8 Q/K/V with dropout: no score terms, O through any epilogue.
    case kFloat8E4M3:
      return TE_FWD_AS(__nv_fp8_e4m3, kNoTerms);
#endif
    default:
      return cudaErrorInvalidValue;
  }
#undef TE_FWD_AS
}
#undef TE_FWD_DROPOUT
#undef TE_FWD_KIND
#undef TE_FWD_UNIT
#else
// `dtype` is Q/K/V's (f32, bf16, or e4m3 payloads with `scales`), O's is
// `out_dtype`: Q's outside the FP8 branch; bf16, f32, or an fp8 type with
// `o_amax` (zeroed by the caller) in it. `qlens`/`klens` and `qseg`/`kseg`
// are each both given or both null. `bias` (`bias_b` = 1 or B, Hq, Sq,
// Skv) of `bias_dtype` f32 or bf16, or the (Hq,) ALiBi `slopes`, or the
// soft cap `cap` > 0 (0 for none), at most one of them, with the softmax
// `scale` (q then unscaled for the slopes and the cap); none with FP8.
// `seed`, the (2,) int32 dropout seed words on the card, with the
// threshold `thr`, `inv` = 1 / (1 - rate) and the reference's tile sizes
// `bq` and `bk`, or a null seed without dropout; FP8 included.
extern "C" int te_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, int dtype, void* o,
                                      int out_dtype, float* lse,
                                      const int* qlens, const int* klens,
                                      const int* qseg, const int* kseg,
                                      const float* sink, const float* scales,
                                      float* o_amax, const void* bias,
                                      int bias_dtype, int bias_b,
                                      const float* slopes, int B, int Sq,
                                      int Skv, int Hq, int Hkv, int D,
                                      int causal, int offset, int left,
                                      int right, float scale, float cap,
                                      const int* seed, unsigned thr,
                                      float inv, int bq, int bk,
                                      void* stream) {
  const ScoreTerms terms{bias, bias_dtype, bias_b, slopes, scale, cap,
                         Dropout{seed, thr, inv, bq, bk}};
  if (bad_terms(terms, B, dtype == kFloat8E4M3)) return cudaErrorInvalidValue;
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || Hq % Hkv != 0 || D < 16 ||
      D > 256 || D % 16 != 0 || left < -1 || right < -1 ||
      (qlens == nullptr) != (klens == nullptr) ||
      (qseg == nullptr) != (kseg == nullptr))
    return cudaErrorInvalidValue;
  const bool fp8 = dtype == kFloat8E4M3;
  const bool fp8_out = out_dtype == kFloat8E4M3 || out_dtype == kFloat8E5M2;
  if (fp8 != (scales != nullptr) || fp8_out != (o_amax != nullptr) ||
      (fp8_out && !fp8) || (!fp8 && out_dtype != dtype) || out_dtype < 0 ||
      out_dtype > kFloat8E5M2)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mask mk{causal, offset, left, right};
#define TE_FWD_UNIT_CALL(UNIT)                                              \
  UNIT(dtype, q, k, v, o, out_dtype, lse, qlens, klens, qseg, kseg, sink,  \
       scales, o_amax, terms, B, Sq, Skv, Hq, Hkv, D, mk, s)
  if (cap != 0.f)
    return seed != nullptr ? TE_FWD_UNIT_CALL(flash_fwd_softcap_dropout)
                           : TE_FWD_UNIT_CALL(flash_fwd_softcap);
  if (seed != nullptr) return TE_FWD_UNIT_CALL(flash_fwd_dropout);
  if (bias != nullptr || slopes != nullptr)
    return TE_FWD_UNIT_CALL(flash_fwd_terms);
#undef TE_FWD_UNIT_CALL
  switch (dtype) {
    case kBFloat16:
      return launch_d<__nv_bfloat16, kNoTerms, false>(
          q, k, v, o, out_dtype, lse, qlens, klens, qseg, kseg, sink, scales,
          o_amax, terms, B, Sq, Skv, Hq, Hkv, D, mk, s);
    case kFloat32:
      return launch_d<float, kNoTerms, false>(
          q, k, v, o, out_dtype, lse, qlens, klens, qseg, kseg, sink, scales,
          o_amax, terms, B, Sq, Skv, Hq, Hkv, D, mk, s);
    case kFloat8E4M3:
      return launch_d<__nv_fp8_e4m3, kNoTerms, false>(
          q, k, v, o, out_dtype, lse, qlens, klens, qseg, kseg, sink, scales,
          o_amax, terms, B, Sq, Skv, Hq, Hkv, D, mk, s);
    default:
      return cudaErrorInvalidValue;
  }
}
#endif  // TE_FLASH_UNIT
#undef TE_FWD_ARGS
