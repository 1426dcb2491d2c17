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
// Each block loads each K/V tile's ids with the tile (the bodies below say
// where they sit). A query with id 0 sees no key and writes O = 0 and
// LSE = -1e30 (the sink with one). Tiles are not skipped by segment: a
// packed row does the causal triangle's work.
//
// Bias and ALiBi branches (the reference's `use_bias` and its ALiBi
// `score_mod`, `_fwd_block_body`): a post-scale bias (`bias_b` = 1 or B,
// Hq, Sq, Skv), f32 or bf16 and read in its own dtype, adds bias * log2(e)
// in f32 to each pre-scaled score before the mask; a first dimension of 1
// broadcasts it over the batch, and each query head reads its own plane
// under GQA. ALiBi takes q unscaled and the (Hq,) f32 slopes: each score
// becomes (s * scale - slope_h * |i + offset - j|) * log2(e). Each thread
// reads the bias elements of its own scores straight from global memory,
// so the branch adds no shared memory; it is a template instance of its own
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
// Runtime positions (the reference's `qoff` scalar-prefetch operand, with
// its dynamic window under `_win_dynamic`; ring and all-gather context
// parallelism pass them): every instance takes an optional int32 vector
// [qoff, left, right] on the card. Each block reads it once at its start;
// qoff adds to the static offset (`off = offset + qoff_ref[0]`), and the
// sides the static window makes active take their bounds from it. The tile
// loop's bounds come from the values read, so a step whose queries sit
// before every key (a negative qoff) visits no tile and writes O = 0 and
// LSE = -1e30. A side's activity is the static bound's sign, never the
// value read: a striped ring step's left bound may be a live -1 (keys at
// or after the query's own index + 1). Nothing is read back to the host,
// so a ring step can be captured in a CUDA graph. One load a block, no
// per-score branch beyond the static window's own.
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
// at the 989 TFLOP/s bf16 tensor-core peak. GPT-OSS's banded prefill (B 8,
// S 512, Hq 64, Hkv 8, D 64, band 128, a sink) moves about 71 MB (21 us)
// for 6.5 GFLOP over the band's pairs: bytes again. Starting each tile
// loop at the band's left edge cuts the K tiles a (q head, sequence)
// visits to the band's. At the training shape (B 2, S 2048, Hq 32, Hkv 8,
// D 128, causal) the products, 68.7 GFLOP (69 us), bound it; on e4m3 Q/K/V
// too, QK^T's half at the 1,979 TFLOP/s fp8 peak and PV's at bf16's
// (52 us).
//
// Two bodies. Every instance whose product operands are 16 bits or
// narrower (bf16 Q/K/V, and e4m3 payloads, widened to bf16 exactly as they
// enter shared memory) runs the tensor-core body below; f32 Q/K/V keep
// the FMA body, since a bf16 operand would round what the reference's f32
// dot keeps. `launch` picks the body from Q's type.
//
// Tensor-core body (flash_fwd_mma_kernel; flash_mma.cuh and ptx.cuh): one
// block of 4 warps per (Q tile of 64 rows, q head, batch); each warp owns
// 16 query rows. Q (64 rows), two stages of K tiles and one V tile (64
// keys, 32 at D = 256) sit in shared memory as bf16 with rows padded by 16
// bytes, so ldmatrix reads them without bank conflicts, and every column
// loop has a compile-time trip count (D is zero-padded to the instance's
// 64, 128 or 256): 70 KB a block at D = 128, 3 blocks an SM by shared
// memory, and by registers where the instance fits 170 a thread without
// spills (`mma_min_blocks`). bf16 tiles come by cp.async: the next K tile
// loads while this tile computes, the next V tile while the next K tile's
// scores compute. S = Q K^T runs on mma.sync m16n8k16 (bf16 operands,
// f32 accumulators): Q's A fragments and K's B fragments by ldmatrix. Each
// lane holds rows g = lane / 4 and g + 8 and two neighbouring keys of
// every 8-key n-tile, and applies every score term there, at its own
// (i, j): the FP8 multiplier, the bias, ALiBi or the soft cap (common.cuh
// `add_score_terms`), then the mask (the row's visible keys [lo, hi), from
// the causal rule, the window and the lengths, computed once a row; the
// segment ids' compare in a copy of the loop of its own, chosen once a
// tile; the ids of each K tile in a small shared array beside it). The
// online softmax reduces over the 4 lanes of a quad. The weights, rounded
// to bf16 (the dropout instances' after their keep select, `drop_keep` on
// the row's and the column's parts of the hash), become the A fragments of
// PV in registers: two n-tiles of the C layout are one k-step of the A
// layout. V's B fragments come by ldmatrix.trans. Causal tiles launch
// heaviest first. The epilogue adds the sink and writes LSE and O in bf16,
// f32 or through the fp8 cast with its amax (one atomicMax a block); O's
// division by l >= 1 is the fast one (within 2 ulps). What keeps it from its
// bound at the path's shapes (PERF.md section 6 has its times): the
// per-score work (mask, exp2 and rounding, some 20 instructions a score on
// the CUDA cores) stands beside the products, and mma.sync is not the
// card's full tensor rate (wgmma with TMA tiles is later work).
//
// FMA body (flash_fwd_kernel, f32 only): one block per (q tile of 64 rows,
// q head, batch). The block holds its Q tile in shared memory as f32
// (read with 16-byte loads, as are K and V) and loops over 64-key K/V
// tiles, from the first tile the window's left edge reaches (as the
// reference's `_enumerate_steps`) to the causal diagonal, the window's
// right edge and the sequence's length: a tile with no visible key leaves
// the running sums unchanged, so skipping it is exact (both bodies). Each
// of the 256 threads computes a 4 x 4 block of scores with FMAs (rows
// 4 * (tid / 16) + r, keys tid % 16 + 16 * c), the online softmax reduces
// over the 16 lanes that share a row, and the same threads own 4 rows x
// D / 16 columns of the output accumulator. K rows are padded to D + 1
// floats so that the 16 lanes reading 16 keys hit distinct banks; the
// segment ids of the Q and K tiles sit in that padding column.
#include "flash_mma.cuh"

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
// `pos`, the runtime positions [qoff, left, right] on the card or null:
// see te_flash_attention_fwd.
struct Mask {
  int causal, offset, left, right;
  const int* pos;
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

// The FMA body, f32 Q/K/V and O only: see the design notes at the head of
// this file.
template <int DMAX, int kTerms, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, const int* __restrict__ qlens,
                     const int* __restrict__ klens,
                     const int* __restrict__ qseg,
                     const int* __restrict__ kseg,
                     const float* __restrict__ sink, ScoreTerms terms, int Sq,
                     int Skv, int Hq, int Hkv, int D, int causal, int offset,
                     int left, int right, const int* __restrict__ pos) {
  using T = float;
  constexpr int kCols = DMAX / 16;
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
  // A side of the window is active where the caller's static bound is
  // >= 0; the runtime positions may then set it to any value, -1 included.
  const bool left_on = left >= 0, right_on = right >= 0;
  if (pos != nullptr) {
    offset += __ldg(pos);
    if (left_on) left = __ldg(pos + 1);
    if (right_on) right = __ldg(pos + 2);
  }

  const int qlen = qlens != nullptr ? qlens[b] : Sq;
  const int klen = klens != nullptr ? klens[b] : Skv;
  // Keys past kend are masked for every row of this tile.
  int kend = min(Skv, klen);
  if (causal) kend = min(kend, q0 + kBQ + offset);
  if (right_on) kend = min(kend, q0 + kBQ + offset + right);
  if (q0 >= qlen) kend = 0;
  // Keys before kbeg are outside the window of every row of this tile.
  const int kbeg = left_on ? max(0, q0 + offset - left) / kBK * kBK : 0;

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
        if (left_on) visible = visible && kj >= qi + offset - left;
        if (right_on) visible = visible && kj <= qi + offset + right;
        if (qlens != nullptr) visible = visible && qi < qlen && kj < klen;
        if (qseg != nullptr) {
          const int qs = __float_as_int(Qs[(ty * 4 + r) * ld + D]);
          visible = visible && qs != 0 &&
                    qs == __float_as_int(Ks[(tx + 16 * c) * ld + D]);
        }
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
          Ps[(ty * 4 + r) * (kBK + 1) + tx + 16 * c] = pd;
        } else {
          Ps[(ty * 4 + r) * (kBK + 1) + tx + 16 * c] = p;
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
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty * 4 + r;
    if (qi >= Sq) continue;
    const size_t row = ((size_t)b * Sq + qi) * Hq + h;
    // O = acc * mult / div, in the reference's order.
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
        const float a = sink != nullptr ? acc[r][c] * mult : acc[r][c];
        o[row * D + tx + 16 * c] = a / div;
      }
    }
    if (tx == 0) lse[((size_t)b * Hq + h) * Sq + qi] = lse_r;
  }
}

// The tensor-core body's tiles: 64 queries (16 a warp) by 64 keys, or 32
// at D = 256. The weights round to bf16 against the running max of the
// key tiles seen so far, so the key tile sets where a row's rounding can
// differ from one softmax over all its keys: with 64 keys a prompt of up
// to 64 tokens rounds as the plain version does, as the FMA body's tiles
// did (32-key tiles moved the bf16 O of a 64-token prefill in 4 % of its
// elements, enough to move an NVFP4 activation's tensor scale).
template <int DMAX>
struct MmaTiles {
  static constexpr int kBQ = 16 * flash_mma::kWarps;
  static constexpr int kBK = DMAX <= 128 ? 64 : 32;
};

// Q's tile, two stages of K tiles and one V tile (bf16), the K tiles'
// segment ids and the amax's per-warp scratch: 70 KB a block at D = 128,
// so that 3 blocks fit an SM.
template <int DMAX>
size_t mma_smem_bytes() {
  using Tl = MmaTiles<DMAX>;
  constexpr size_t ld = flash_mma::kLd<DMAX>;
  return sizeof(__nv_bfloat16) * (Tl::kBQ + 3 * Tl::kBK) * ld +
         sizeof(int) * 2 * Tl::kBK + sizeof(float) * flash_mma::kWarps;
}

// The tensor-core body (bf16, or e4m3 payloads widened to bf16): see the
// design notes at the head of this file. Each warp owns 16 query rows;
// lane l holds rows g = l / 4 and g + 8 of them (its rows r = 0, 1) and, of
// each 8-key n-tile, keys 2 (l % 4) and 2 (l % 4) + 1.
// Blocks an SM the launch bounds ask for: 3 (at most 170 registers a
// thread, which shared memory allows at D <= 128) where the instance fits
// them without spills; 2 for the bias and ALiBi, dropout and e4m3
// instances at D = 128 (under 170 registers they spilled) and at D = 256.
template <typename T, int DMAX, int kTerms>
constexpr int mma_min_blocks(bool dropout) {
  return DMAX <= 64 || (DMAX <= 128 && kTerms != kBiasAlibi && !dropout &&
                        !kIsFp8<T>)
             ? 3
             : 2;
}

template <typename T, int DMAX, int kTerms, bool kDropout>
__global__ void __launch_bounds__(
    flash_mma::kThreads, (mma_min_blocks<T, DMAX, kTerms>(kDropout)))
    flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, void* __restrict__ o,
                         int out_code, float* __restrict__ lse,
                         const int* __restrict__ qlens,
                         const int* __restrict__ klens,
                         const int* __restrict__ qseg,
                         const int* __restrict__ kseg,
                         const float* __restrict__ sink,
                         const float* __restrict__ scales,
                         float* __restrict__ o_amax, ScoreTerms terms, int Sq,
                         int Skv, int Hq, int Hkv, int D, int causal,
                         int offset, int left, int right,
                         const int* __restrict__ pos) {
  using namespace flash_mma;
  constexpr int kBQ = MmaTiles<DMAX>::kBQ, kBK = MmaTiles<DMAX>::kBK;
  constexpr int kNT = kBK / 8;    // n-tiles of a score tile
  constexpr int kDT = DMAX / 8;   // n-tiles of O
  constexpr int kKS = DMAX / 16;  // k-steps over D
  constexpr bool kFp8 = kIsFp8<T>;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  constexpr int ld = kLd<DMAX>;
  bf16* Qs = reinterpret_cast<bf16*>(mma_smem);  // [kBQ][ld]
  bf16* Ks = Qs + kBQ * ld;                      // [2][kBK][ld]
  bf16* Vs = Ks + 2 * kBK * ld;                  // [kBK][ld]
  int* kseg_s = reinterpret_cast<int*>(Vs + kBK * ld);  // [2][kBK]
  float* red = reinterpret_cast<float*>(kseg_s + 2 * kBK);  // [kWarps]

  // Causal tiles run heaviest (latest) first, so the longest blocks do not
  // finish last.
  const int tile = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = tile * kBQ;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float smult = kFp8 ? scales[0] : 1.f;
  const bool left_on = left >= 0, right_on = right >= 0;
  if (pos != nullptr) {
    offset += __ldg(pos);
    if (left_on) left = __ldg(pos + 1);
    if (right_on) right = __ldg(pos + 2);
  }

  const int qlen = qlens != nullptr ? qlens[b] : Sq;
  const int klen = klens != nullptr ? klens[b] : Skv;
  int kend = min(Skv, klen);
  if (causal) kend = min(kend, q0 + kBQ + offset);
  if (right_on) kend = min(kend, q0 + kBQ + offset + right);
  if (q0 >= qlen) kend = 0;
  const int kbeg = left_on ? max(0, q0 + offset - left) / kBK * kBK : 0;

  // This thread's two rows: their indices, visible keys, segment ids (a
  // row of id 0 sees no key) and dropout parts.
  int qi[2], qs[2];
  Span span[2];
  DropPart drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qi[r] = q0 + warp * 16 + g + 8 * r;
    qs[r] = qseg == nullptr ? 1 : qi[r] < Sq ? qseg[(size_t)b * Sq + qi[r]] : 0;
    span[r] = key_span(qi[r], Sq, Skv, qlen, klen, causal, offset, left_on,
                       left, right_on, right);
    if (qs[r] == 0) span[r].hi = 0;
    if constexpr (kDropout)
      drow[r] = drop_row(terms.drop, drop_head(terms.drop, b, hk),
                         h - hk * (Hq / Hkv), qi[r]);
  }

  // K tiles (with their segment ids) in two stages, V in one: the copy
  // groups are committed in the order K0 (with Q), V0, K1, V1, ..., each
  // K tile loading while the tile before computes, each V tile while its
  // own K tile's scores compute.
  auto load_k = [&](int k0, int st) {
    load_rows<T, kBK, DMAX>(k, b, k0, Skv, Hkv, hk, D, Ks + st * kBK * ld);
    if (kseg != nullptr && threadIdx.x < kBK)
      kseg_s[st * kBK + threadIdx.x] =
          k0 + threadIdx.x < Skv ? kseg[(size_t)b * Skv + k0 + threadIdx.x]
                                 : 0;
  };
  load_rows<T, kBQ, DMAX>(q, b, q0, Sq, Hq, h, D, Qs);
  if (kbeg < kend) load_k(kbeg, 0);
  cp_async_commit();
  if (kbeg < kend) load_rows<T, kBK, DMAX>(v, b, kbeg, Skv, Hkv, hk, D, Vs);
  cp_async_commit();

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int st = 0;
  for (int k0 = kbeg; k0 < kend; k0 += kBK, st ^= 1) {
    const bool next = k0 + kBK < kend;
    if (next) load_k(k0 + kBK, st ^ 1);
    cp_async_commit();
    cp_async_wait<2>();  // this K tile (this V tile and the next K may fly)
    __syncthreads();
    const bf16* Kt = Ks + st * kBK * ld;

    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    mma_abt<kNT, kKS, ld>(s, Qs + warp * 16 * ld, Kt, lane);

    // The score terms and the mask, with the segment ids' compare in its
    // own copy of the loop (a uniform branch a tile, not one a score).
    float mx[2] = {kMasked, kMasked};
    auto mask = [&](bool seg) {
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int key = n * 8 + 2 * t + (e & 1);
          const int kj = k0 + key;
          bool visible = span[r].has(kj);
          if (seg) visible = visible && qs[r] == kseg_s[st * kBK + key];
          float sv = s[n][e];
          if (kFp8) sv *= smult;
          if constexpr (kTerms != kNoTerms) {
            float th;  // the soft cap's tanh, which the forward ignores
            sv = add_score_terms<kTerms>(terms, sv, b, h, Hq, Sq, Skv, qi[r],
                                         kj, offset, th);
          }
          s[n][e] = visible ? sv : kMasked;
          mx[r] = fmaxf(mx[r], s[n][e]);
        }
      }
    };
    if (qseg != nullptr)
      mask(true);
    else
      mask(false);

    float alpha[2], m_new[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2f(m[r] - m_new[r]);
    }
    // The weights, rounded to bf16 (V's dtype, or bf16 on the FP8
    // branch), in the A fragments of the PV product.
    uint32_t pa[kNT / 2][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = exp2f(s[n][e] - m_new[e >> 1]);
      rs[0] += p[0] + p[1];
      rs[1] += p[2] + p[3];
      if constexpr (kDropout) {
        // l sums the undropped weight; PV takes the dropped one.
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const DropPart dcol = drop_col(terms.drop, k0 + n * 8 + 2 * t + c);
#pragma unroll
          for (int r = 0; r < 2; ++r)
            p[2 * r + c] = drop_apply(
                terms.drop, drop_keep(terms.drop, drow[r], dcol), p[2 * r + c]);
        }
      }
      pa[n / 2][(n & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
      m[r] = m_new[r];
    }
#pragma unroll
    for (int n = 0; n < kDT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    cp_async_wait<1>();  // this V tile (the next K may fly)
    __syncthreads();
    mma_ab<kNT / 2, kDT, ld>(acc, pa, Vs, lane);
    __syncthreads();  // every warp is done with V and with this K stage
    if (next) load_rows<T, kBK, DMAX>(v, b, k0 + kBK, Skv, Hkv, hk, D, Vs);
    cp_async_commit();
  }
  cp_async_wait<0>();  // Q's copies, where no tile ran

  const float s0 = sink != nullptr ? sink[h] * kLog2e : 0.f;
  const float sv_inv = kFp8 ? scales[1] : 1.f;
  const float o_scale = o_amax != nullptr ? scales[2] : 1.f;
  float o_max = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= Sq) continue;
    const size_t row = ((size_t)b * Sq + qi[r]) * Hq + h;
    // O = acc * mult / div, in the reference's order: V's sv_inv first.
    float mult, div, lse_r;
    if (sink != nullptr) {
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
    for (int n = 0; n < kDT; ++n) {
      if (n * 8 < D) {
        float out[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float a = kFp8 ? acc[n][2 * r + c] * sv_inv : acc[n][2 * r + c];
          if (sink != nullptr) a *= mult;
          // div >= 1 (the row's largest weight is 1), where the fast
          // division is within 2 ulps and needs no slow-path call, whose
          // saved registers spilled.
          out[c] = __fdividef(a, div);
          o_max = fmaxf(o_max, fabsf(out[c]));
        }
        store2_as(o, out_code, row * D + n * 8 + 2 * t, out[0] * o_scale,
                  out[1] * o_scale);
      }
    }
    if (t == 0) lse[((size_t)b * Hq + h) * Sq + qi[r]] = lse_r;
  }
  if (o_amax != nullptr) block_amax_to(o_max, red, o_amax);
}

template <typename T, int DMAX, int kTerms, bool kDropout>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int out_code, float* lse, const int* qlens,
                   const int* klens, const int* qseg, const int* kseg,
                   const float* sink, const float* scales,
                   float* o_amax, const ScoreTerms& terms, int B, int Sq,
                   int Skv, int Hq, int Hkv, int D, const Mask& mk,
                   cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    auto kernel = flash_fwd_kernel<DMAX, kTerms, kDropout>;
    const size_t smem = smem_bytes(D);
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, qlens,
        klens, qseg, kseg, sink, terms, Sq, Skv, Hq, Hkv, D, mk.causal,
        mk.offset, mk.left, mk.right, mk.pos);
  } else {
    constexpr int kTileQ = MmaTiles<DMAX>::kBQ;
    auto kernel = flash_fwd_mma_kernel<T, DMAX, kTerms, kDropout>;
    const size_t smem = mma_smem_bytes<DMAX>();
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(Hq, B, (Sq + kTileQ - 1) / kTileQ);
    kernel<<<grid, flash_mma::kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), o, out_code, lse, qlens, klens, qseg, kseg,
        sink, scales, o_amax, terms, Sq, Skv, Hq, Hkv, D, mk.causal,
        mk.offset, mk.left, mk.right, mk.pos);
  }
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
// `offset`, `left` and `right` are static, -1 for an inactive side. `pos`,
// the runtime positions (the reference's `qoff` operand with its dynamic
// window), is null or an int32 vector [qoff, left, right] on the card that
// each block reads once at its start: qoff adds to `offset`, and each side
// that `left` or `right` makes active (>= 0; its value is then a
// placeholder) takes its bound from the vector, which may be any int, -1
// included. No bound crosses to the host.
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
                                      int right, const int* pos, float scale,
                                      float cap,
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
  const Mask mk{causal, offset, left, right, pos};
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
