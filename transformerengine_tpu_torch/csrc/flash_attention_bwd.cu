// Flash attention backward over BSHD tensors: dQ, dK and dV from the
// forward's log-sum-exp, without the S x S probabilities in memory.
//
// Replaces transformerengine_tpu/ops/flash_attention.py `_flash_bwd`
// (the Pallas `_bwd_dq_kernel[_steps]` and `_bwd_dkv_kernel[_steps]`,
// bodies `_bwd_dq_block_body` and `_bwd_dkv_block_body`). Scope: exactly
// the forward kernel's (no mask, causal with a bottom-right offset, the
// padding mask from per-sequence lengths, segment ids, a static sliding
// window; GQA with Hq % Hkv == 0; bf16 or f32; D <= 256 with
// D % 16 == 0). Segment ids (`qseg`, `kseg`, (B, Sq) and (B, Skv) int32,
// or null) add the forward's term qseg[b, i] == kseg[b, j] != 0 to each
// pair's visibility; each kernel keeps the ids of the tile it holds in
// shared memory and loads the other side's with each tile it walks, in the
// Q and K tiles' padding column as the forward does (no added shared
// memory), so a query with id 0 gets dQ = 0 and adds nothing to dK or dV.
// A softmax sink needs nothing here: it enters through the forward's LSE,
// and its own gradient is computed from the LSE outside the kernels, as
// the reference does (`_flash_core_bwd`).
//
// Bias and ALiBi branches (the reference's `use_bias` with its dbias
// output, and its ALiBi `score_mod`): both kernels add the forward's
// score terms (common.cuh `add_score_terms`) to the recomputed scores,
// in template instances of their own (bf16 and f32 only, built in
// flash_attention_bwd_terms.cu beside this file), so the kernels without
// them compile as they did.
// The dQ kernel also writes dbias, the per-batch f32 ds (B, Hq, Sq, Skv)
// before its rounding: it owns every key of its (Q tile, head, batch)
// rows, so it writes each element once with no atomics, ds = 0 for masked
// pairs and exact zeros for the keys of the tiles its loop skips (the
// reference's skipped blocks read 0). A broadcast bias is summed over the
// batch outside the kernel, as the reference does. Under ALiBi q is
// unscaled and dQ and dK both take `scale` as their multiplier (the mod's
// VJP is the identity). Bound at the encoder's training shape (B 2,
// S 2048, Hq 32, Hkv 8, D 128, bf16, lengths 2048 and 1536, an f32
// broadcast bias): the five products over the visible pairs (268 GFLOP,
// 0.27 ms at the bf16 peak) against the inputs, the bias's 512 MiB and
// dbias's 1 GiB (about 1.78 GB, 0.53 ms): bytes.
//
// Dropout branch (the reference's `dropout_rate` in `_bwd_dq_block_body`
// and `_bwd_dkv_block_body`): both kernels recompute the forward's keep
// bit of each visible score (common.cuh `drop_keep`, the reference's hash
// over its own tiles) and set dp to where(keep, dp * inv, 0) before
// ds = p * (dp - delta); the dK/dV kernel also takes where(keep, p * inv,
// 0) as dV's weights. With a bias, dbias is that ds. The mask is never
// stored: the hash costs some twelve integer operations a score in each
// kernel. Template instances of their own (bf16 and f32, built in
// flash_attention_bwd_dropout.cu, composing with the bias, ALiBi and the
// masks); no added shared memory. Bound at the LLAMA_8B training shape
// (B 2, S 2048, Hq 32, Hkv 8, D 128, bf16, causal, rate 0.1): the five
// products (172 GFLOP at the bf16 peak) and the hash twice over the
// causal pairs (3.8 G integer operations at the CUDA cores' 67 T/s):
// operations, about 0.23 ms.
//
// Soft-cap branch (the reference's `score_mod` with `soft_cap_mod` in
// `_bwd_dq_block_body` and `_bwd_dkv_block_body`, its `jax.vjp` of the
// mod): q arrives unscaled, both kernels recompute t = tanh(s * scale /
// cap) with the forward's score, and multiply ds by the mod's VJP before
// ds is rounded (common.cuh `soft_cap_grad`: w = (cap * ds) * (1 - t),
// then (w + w * t) / cap, the order of JAX's transpose of its tanh rule;
// 1 - t stays exact where t saturates, where 1 - t^2 would cancel); dQ
// and dK take `scale` as their multiplier. Template instances of their own
// (bf16 and f32, with and without dropout, built in
// flash_attention_bwd_softcap.cu and flash_attention_bwd_softcap_dropout.cu).
// Bound at the LLAMA_8B training shape with the cap at 50: the five
// products (171.9 GFLOP at the bf16 peak) plus the cap's eleven operations
// per visited score in each kernel (2.95 G at the CUDA cores' rate):
// operations, about 0.22 ms.
//
// FP8 with dropout: the dropout instances also take e4m3 Q/K/V payloads
// with a bf16 or f32 dO, or e4m3 O and an e5m2 dO (built in
// flash_attention_bwd_dropout.cu); p and ds round to bf16 after the mask.
//
// Numerics follow the reference: the caller passes q pre-scaled by
// scale * log2(e) in q's dtype, LSE moved into the log2 domain
// (lse2 = lse * log2(e), (B, Hq, Sq)) and delta = rowsum(dO * O) in f32
// ((B, Sq, Hq), the layout the row sum leaves). For each
// visible (query, key) pair p = exp2(s - lse2) and ds = p * (dp - delta)
// with dp = dO . v; masked pairs give p = 0, so fully masked rows
// (LSE = -1e30) and padded keys yield exact zeros. ds is rounded to the
// inputs' dtype before both of its products and p before the dV product.
// Epilogues: dQ = scale * sum(ds k); dK = ln(2) * sum(ds q_scaled) (q
// carries scale * log2(e)); dV = sum(p dO).
//
// FP8 branch (the reference's `fp8` with `scales_ref`, and NVTE_FP8_DPA_BWD
// for fp8_mha): q, k and v are the forward's e4m3 payloads (q not
// pre-scaled) and `scales` a device vector [smult, sv_inv * sdo,
// scale * sk_inv, scale * sq_inv, sdo] (sdo: dO's dequant scale, 1 for a
// high-precision dO). dO is bf16 or f32 (fp8_dpa) or an e5m2 or e4m3
// payload (fp8_mha; the caller then computes delta on the O and dO
// payloads times so * sdo). s = (q . k) * smult before the mask, dp =
// (dO . v) * (sv_inv * sdo); p and ds round to bf16 before their products
// with the payloads; the epilogues multiply dQ by scale * sk_inv, dK by
// scale * sq_inv and dV by sdo; the gradients are written in bf16 or f32
// (`grad_dtype`). Every product is exact in f32 (e4m3 x e4m3, bf16 x e4m3,
// bf16 x e5m2), so the branch differs from its plain version in summation
// order alone. dO and the gradients take their dtype at run time (a
// switch around each tile load and each store), Q/K/V as a template.
//
// Bound on an H100: operations. At the training shape (B 2, S 2048,
// Hq 32, Hkv 8, D 128, bf16, causal) the five products over half the S^2
// pairs are 1.72e11 FLOP, 0.17 ms at the 989 TFLOP/s bf16 tensor-core
// peak; the bytes (Q, K, V, O, dO, LSE in; dQ, dK, dV out) are about
// 168 MB, 0.05 ms. This design runs its products as f32 FMAs on the CUDA
// cores (and recomputes s and dp in both kernels: seven products), so
// the FMA rate, not the bound, is its real limit; tensor cores come later.
// GPT-OSS's banded layers (B 2, S 2048, Hq 64, Hkv 8, D 64, band 128)
// need 21 GFLOP over the band's pairs (0.021 ms) and move about 152 MB
// (0.045 ms): bytes. With the band's tile ranges each block visits at
// most 3 tiles of the other side instead of up to 32.
//
// Design (simple and right first): two kernels, no atomics, so the result
// is deterministic.
// - dQ: one block per (q tile, q head, batch), the forward kernel's
//   layout: Q and dO tiles stay in shared memory as f32 while the block
//   walks the K/V tiles from the window's left edge up to the causal
//   diagonal, the window's right edge and the sequence's length. Each of the 256 threads holds a (BQ/16) x (BK/16) block of s
//   and dp (rows 16-apart lanes share), writes ds to shared memory, and
//   accumulates BQ/16 rows x D/16 columns of dQ.
// - dK/dV: one block per (k tile, kv head, batch). It walks the q tiles
//   of every query head of its GQA group (so the group's sum stays inside
//   one block), from the first tile the causal mask and the window's
//   right edge let see its keys to the last tile its left edge reaches
//   (the reference's `_enumerate_steps`, order "kq"). Threads hold s and dp transposed (keys x queries), write p and
//   ds to shared memory, and accumulate BK/16 keys x D/16 columns of dK
//   and of dV.
// Tiles are 64 x 64 for D <= 128 and 32 x 32 for D = 256, which keeps
// the f32 tiles within the 227 KB of shared memory a block may use; rows
// are padded to D + 1 floats so that lanes reading 16 rows hit distinct
// banks. The FP8 branch widens its payloads as it loads them (16 values a
// 16-byte load) and keeps this design; at the training shape its bound is
// the operations at the fp8 peak (1.72e11 FLOP, 0.087 ms) against about
// 92 MB of bytes with fp8 O and dO (0.027 ms).
#include "common.cuh"

// Which instances a translation unit compiles: 0 (this file) the C entry
// points and the instances without the terms; 1
// (flash_attention_bwd_terms.cu) the bias and ALiBi instances; 2
// (flash_attention_bwd_dropout.cu) the dropout instances, which take the
// terms too, and e4m3 Q/K/V; 3 (flash_attention_bwd_softcap.cu) the
// soft-cap instances; 4 (flash_attention_bwd_softcap_dropout.cu) the
// soft-cap instances with dropout. bf16 and f32 each.
#ifndef TE_FLASH_UNIT
#define TE_FLASH_UNIT 0
#endif

// The shape and mask of a call; shared by both translation units.
struct Shape {
  int Sq, Skv, Hq, Hkv, D, causal, offset, left, right;
};

namespace {

constexpr int kThreads = 256;
constexpr float kLn2 = 0.6931471805599453f;

// Copies the segment ids of rows [r0, r0 + R) of sequence b into the
// padding column (index D) of a shared [R][ld] tile, as int bits (0 past
// S), or 1s without segments.
template <int R>
__device__ __forceinline__ void load_seg(const int* __restrict__ seg, int b,
                                         int r0, int S, float* tile, int ld,
                                         int D) {
  for (int i = threadIdx.x; i < R; i += kThreads)
    tile[i * ld + D] = __int_as_float(
        seg == nullptr ? 1 : r0 + i < S ? seg[(size_t)b * S + r0 + i] : 0);
}

// The segment id load_seg left in row i of a tile.
__device__ __forceinline__ int seg_of(const float* tile, int ld, int D,
                                      int i) {
  return __float_as_int(tile[i * ld + D]);
}

// Copies rows [r0, r0 + R) of one head of a BSHD tensor into a shared
// [R][ld] f32 tile; rows past S read as 0.
template <typename T, int R>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int b,
                                          int r0, int S, int H, int h, int D,
                                          float* dst, int ld) {
  constexpr int kVec = 16 / sizeof(T);
  const int vecs = D / kVec;
  for (int i = threadIdx.x; i < R * vecs; i += kThreads) {
    const int r = i / vecs;
    const int d = (i - r * vecs) * kVec;
    float v[kVec];
    if (r0 + r < S) {
      load16(src + (((size_t)b * S + r0 + r) * H + h) * D + d, v);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[r * ld + d + e] = v[e];
  }
}

// load_tile for a tensor whose dtype is known at run time (a DTypeCode).
template <int R>
__device__ __forceinline__ void load_tile_as(const void* src, int code,
                                             int b, int r0, int S, int H,
                                             int h, int D, float* dst,
                                             int ld) {
  switch (code) {
    case kFloat32:
      load_tile<float, R>(static_cast<const float*>(src), b, r0, S, H, h, D,
                          dst, ld);
      break;
    case kBFloat16:
      load_tile<__nv_bfloat16, R>(static_cast<const __nv_bfloat16*>(src), b,
                                  r0, S, H, h, D, dst, ld);
      break;
    case kFloat8E4M3:
      load_tile<__nv_fp8_e4m3, R>(static_cast<const __nv_fp8_e4m3*>(src), b,
                                  r0, S, H, h, D, dst, ld);
      break;
    default:
      load_tile<__nv_fp8_e5m2, R>(static_cast<const __nv_fp8_e5m2*>(src), b,
                                  r0, S, H, h, D, dst, ld);
      break;
  }
}

// `qs` and `ks`: the pair's segment ids, both 1 without segments.
__device__ __forceinline__ bool visible(const Shape& sh, int qi, int kj,
                                        int qlen, int klen, int qs, int ks) {
  bool ok = qi < sh.Sq && kj < sh.Skv && qi < qlen && kj < klen &&
            qs != 0 && qs == ks;
  if (sh.causal) ok = ok && kj <= qi + sh.offset;
  if (sh.left >= 0) ok = ok && kj >= qi + sh.offset - sh.left;
  if (sh.right >= 0) ok = ok && kj <= qi + sh.offset + sh.right;
  return ok;
}

template <int DMAX>
struct Tiles {
  static constexpr int kB = DMAX <= 128 ? 64 : 32;  // BQ = BK
  static constexpr int kR = kB / 16;                // rows (or keys) a thread
  static constexpr int kCols = DMAX / 16;           // columns a thread
};

template <typename T, int DMAX, int kTerms, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const void* __restrict__ dout, int do_code,
                        const float* __restrict__ lse2,
                        const float* __restrict__ delta,
                        void* __restrict__ dq, int g_code,
                        const int* __restrict__ qlens,
                        const int* __restrict__ klens,
                        const int* __restrict__ qseg,
                        const int* __restrict__ kseg,
                        const float* __restrict__ scales, ScoreTerms terms,
                        float* __restrict__ dbias, Shape sh) {
  constexpr int kB = Tiles<DMAX>::kB, kR = Tiles<DMAX>::kR;
  constexpr int kCols = Tiles<DMAX>::kCols;
  constexpr bool kFp8 = kIsFp8<T>;
  const float smult = kFp8 ? scales[0] : 1.f;
  const float dp_mult = kFp8 ? scales[1] : 1.f;
  extern __shared__ float smem[];
  const int D = sh.D, ld = D + 1;
  float* Qs = smem;             // [kB][ld]
  float* dOs = Qs + kB * ld;    // [kB][ld]
  float* Ks = dOs + kB * ld;    // [kB][ld]
  float* Vs = Ks + kB * ld;     // [kB][ld]
  float* dSs = Vs + kB * ld;    // [kB][kB + 1]
  float* Ls = dSs + kB * (kB + 1);  // [kB]
  float* Dl = Ls + kB;              // [kB]

  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (sh.Hq / sh.Hkv);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int qlen = qlens != nullptr ? qlens[b] : sh.Sq;
  const int klen = klens != nullptr ? klens[b] : sh.Skv;
  int kend = min(sh.Skv, klen);
  if (sh.causal) kend = min(kend, q0 + kB + sh.offset);
  if (sh.right >= 0) kend = min(kend, q0 + kB + sh.offset + sh.right);
  if (q0 >= qlen) kend = 0;
  const int kbeg =
      sh.left >= 0 ? max(0, q0 + sh.offset - sh.left) / kB * kB : 0;
  // dbias's row q0 of this (batch, head).
  const size_t dbias_row = (((size_t)b * sh.Hq + h) * sh.Sq + q0) * sh.Skv;

  load_tile<T, kB>(q, b, q0, sh.Sq, sh.Hq, h, D, Qs, ld);
  load_tile_as<kB>(dout, do_code, b, q0, sh.Sq, sh.Hq, h, D, dOs, ld);
  load_seg<kB>(qseg, b, q0, sh.Sq, Qs, ld, D);
  for (int i = threadIdx.x; i < kB; i += kThreads) {
    const bool in = q0 + i < sh.Sq;
    const size_t at = ((size_t)b * sh.Hq + h) * sh.Sq + q0 + i;
    const size_t dat = ((size_t)b * sh.Sq + q0 + i) * sh.Hq + h;
    Ls[i] = in ? lse2[at] : 0.f;
    Dl[i] = in ? delta[dat] : 0.f;
  }

  // The dropout hash's parts of this thread's rows.
  DropPart drow[kR];
  if constexpr (kDropout) {
    const uint32_t head = drop_head(terms.drop, b, hk);
#pragma unroll
    for (int r = 0; r < kR; ++r)
      drow[r] = drop_row(terms.drop, head, h - hk * (sh.Hq / sh.Hkv),
                         q0 + ty * kR + r);
  }

  float acc[kR][kCols];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kB) {
    __syncthreads();  // Q/dO loaded; the previous K/V/dS no longer read
    load_tile<T, kB>(k, b, k0, sh.Skv, sh.Hkv, hk, D, Ks, ld);
    load_tile<T, kB>(v, b, k0, sh.Skv, sh.Hkv, hk, D, Vs, ld);
    load_seg<kB>(kseg, b, k0, sh.Skv, Ks, ld, D);
    __syncthreads();

    float s[kR][kR], dp[kR][kR];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < kR; ++c) s[r][c] = dp[r][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[kR], ov[kR], kv[kR], vv[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        qv[r] = Qs[(ty * kR + r) * ld + d];
        ov[r] = dOs[(ty * kR + r) * ld + d];
      }
#pragma unroll
      for (int c = 0; c < kR; ++c) {
        kv[c] = Ks[(tx + 16 * c) * ld + d];
        vv[c] = Vs[(tx + 16 * c) * ld + d];
      }
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int c = 0; c < kR; ++c) {
          s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
          dp[r][c] = fmaf(ov[r], vv[c], dp[r][c]);
        }
    }
    DropPart dcol[kR];
    if constexpr (kDropout) {
#pragma unroll
      for (int c = 0; c < kR; ++c)
        dcol[c] = drop_col(terms.drop, k0 + tx + 16 * c);
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int row = ty * kR + r;
      const int qi = q0 + row;
#pragma unroll
      for (int c = 0; c < kR; ++c) {
        const int key = tx + 16 * c;
        const int kj = k0 + key;
        float ds = 0.f;
        if (visible(sh, qi, kj, qlen, klen, seg_of(Qs, ld, D, row),
                    seg_of(Ks, ld, D, key))) {
          float sv = s[r][c] * smult;
          float th = 0.f;  // the soft cap's tanh
          if constexpr (kTerms != kNoTerms)
            sv = add_score_terms<kTerms>(terms, sv, b, h, sh.Hq, sh.Sq,
                                         sh.Skv, qi, kj, sh.offset, th);
          const float p = exp2f(sv - Ls[row]);
          if constexpr (kDropout) {
            const float dpd = drop_apply(
                terms.drop, drop_keep(terms.drop, drow[r], dcol[c]),
                dp[r][c] * dp_mult);
            ds = p * (dpd - Dl[row]);
          } else {
            ds = p * (dp[r][c] * dp_mult - Dl[row]);
          }
          if constexpr (kTerms == kSoftCap)
            ds = soft_cap_grad(terms.cap, th, ds);
        }
        // dbias is ds before its rounding (the reference returns the f32
        // ds block); masked pairs write 0.
        if constexpr (kTerms == kBiasAlibi)
          if (dbias != nullptr && qi < sh.Sq && kj < sh.Skv)
            dbias[dbias_row + (size_t)row * sh.Skv + kj] = ds;
        dSs[row * (kB + 1) + key] = round_to<RoundT<T>>(ds);
      }
    }
    __syncthreads();

    for (int j = 0; j < kB; ++j) {
      float dsv[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) dsv[r] = dSs[(ty * kR + r) * (kB + 1) + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (c * 16 < D) {
          const float kk = Ks[j * ld + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < kR; ++r) acc[r][c] = fmaf(dsv[r], kk, acc[r][c]);
        }
      }
    }
  }

  if (kTerms == kBiasAlibi && dbias != nullptr) {
    // The keys of the tiles the loop skipped (before kbeg, and from the
    // end of its last tile on) get exact zeros, as the reference's
    // skipped dbias blocks.
    const int kstop =
        kend > kbeg ? kbeg + (kend - kbeg + kB - 1) / kB * kB : kbeg;
    const int lo = min(kbeg, sh.Skv);
    for (int row = 0; row < kB && q0 + row < sh.Sq; ++row) {
      float* out = dbias + dbias_row + (size_t)row * sh.Skv;
      for (int j = threadIdx.x; j < lo; j += kThreads) out[j] = 0.f;
      for (int j = kstop + threadIdx.x; j < sh.Skv; j += kThreads)
        out[j] = 0.f;
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int qi = q0 + ty * kR + r;
    if (qi >= sh.Sq) continue;
    const size_t at = (((size_t)b * sh.Sq + qi) * sh.Hq + h) * D;
    const float mult = kFp8 ? scales[2] : terms.scale;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (c * 16 < D) store_as(dq, g_code, at + tx + 16 * c, acc[r][c] * mult);
  }
}

template <typename T, int DMAX, int kTerms, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const void* __restrict__ dout, int do_code,
                         const float* __restrict__ lse2,
                         const float* __restrict__ delta,
                         void* __restrict__ dk, void* __restrict__ dv,
                         int g_code, const int* __restrict__ qlens,
                         const int* __restrict__ klens,
                         const int* __restrict__ qseg,
                         const int* __restrict__ kseg,
                         const float* __restrict__ scales, ScoreTerms terms,
                         Shape sh) {
  constexpr int kB = Tiles<DMAX>::kB, kR = Tiles<DMAX>::kR;
  constexpr int kCols = Tiles<DMAX>::kCols;
  constexpr bool kFp8 = kIsFp8<T>;
  const float smult = kFp8 ? scales[0] : 1.f;
  const float dp_mult = kFp8 ? scales[1] : 1.f;
  extern __shared__ float smem[];
  const int D = sh.D, ld = D + 1;
  float* Ks = smem;             // [kB][ld]
  float* Vs = Ks + kB * ld;     // [kB][ld]
  float* Qs = Vs + kB * ld;     // [kB][ld]
  float* dOs = Qs + kB * ld;    // [kB][ld]
  float* Pt = dOs + kB * ld;    // [kB keys][kB + 1]
  float* dSt = Pt + kB * (kB + 1);  // [kB keys][kB + 1]
  float* Ls = dSt + kB * (kB + 1);  // [kB]
  float* Dl = Ls + kB;              // [kB]

  const int k0 = blockIdx.x * kB;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = sh.Hq / sh.Hkv;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int qlen = qlens != nullptr ? qlens[b] : sh.Sq;
  const int klen = klens != nullptr ? klens[b] : sh.Skv;
  // Queries past qend see none of this tile's keys: padded rows, and rows
  // whose window's left edge lies past the tile's last key.
  int qend = min(sh.Sq, qlen);
  if (sh.left >= 0) qend = min(qend, k0 + kB + sh.left - sh.offset);
  // Queries before qbeg see none of them either (causal, right edge).
  int qbeg = sh.causal ? max(0, k0 - sh.offset) : 0;
  if (sh.right >= 0) qbeg = max(qbeg, k0 - sh.offset - sh.right);
  qbeg = (qbeg / kB) * kB;
  const bool live = k0 < min(sh.Skv, klen);

  load_tile<T, kB>(k, b, k0, sh.Skv, sh.Hkv, hk, D, Ks, ld);
  load_tile<T, kB>(v, b, k0, sh.Skv, sh.Hkv, hk, D, Vs, ld);
  load_seg<kB>(kseg, b, k0, sh.Skv, Ks, ld, D);

  // The dropout hash's parts of this thread's keys, and its seed, batch
  // and kv head terms.
  DropPart dcol[kR];
  uint32_t dhead = 0;
  if constexpr (kDropout) {
    dhead = drop_head(terms.drop, b, hk);
#pragma unroll
    for (int r = 0; r < kR; ++r)
      dcol[r] = drop_col(terms.drop, k0 + ty * kR + r);
  }

  float acc_k[kR][kCols], acc_v[kR][kCols];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  for (int h = hk * group; live && h < (hk + 1) * group; ++h) {
    for (int q0 = qbeg; q0 < qend; q0 += kB) {
      __syncthreads();  // K/V loaded; the previous Q/dO/P/dS no longer read
      load_tile<T, kB>(q, b, q0, sh.Sq, sh.Hq, h, D, Qs, ld);
      load_tile_as<kB>(dout, do_code, b, q0, sh.Sq, sh.Hq, h, D, dOs, ld);
      load_seg<kB>(qseg, b, q0, sh.Sq, Qs, ld, D);
      for (int i = threadIdx.x; i < kB; i += kThreads) {
        const bool in = q0 + i < sh.Sq;
        const size_t at = ((size_t)b * sh.Hq + h) * sh.Sq + q0 + i;
        const size_t dat = ((size_t)b * sh.Sq + q0 + i) * sh.Hq + h;
        Ls[i] = in ? lse2[at] : 0.f;
        Dl[i] = in ? delta[dat] : 0.f;
      }
      __syncthreads();

      // Transposed blocks: keys ty * kR + r, queries tx + 16 * c.
      float st[kR][kR], dpt[kR][kR];
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int c = 0; c < kR; ++c) st[r][c] = dpt[r][c] = 0.f;
      for (int d = 0; d < D; ++d) {
        float kv[kR], vv[kR], qv[kR], ov[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          kv[r] = Ks[(ty * kR + r) * ld + d];
          vv[r] = Vs[(ty * kR + r) * ld + d];
        }
#pragma unroll
        for (int c = 0; c < kR; ++c) {
          qv[c] = Qs[(tx + 16 * c) * ld + d];
          ov[c] = dOs[(tx + 16 * c) * ld + d];
        }
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int c = 0; c < kR; ++c) {
            st[r][c] = fmaf(kv[r], qv[c], st[r][c]);
            dpt[r][c] = fmaf(vv[r], ov[c], dpt[r][c]);
          }
      }
      DropPart drow[kR];
      if constexpr (kDropout) {
#pragma unroll
        for (int c = 0; c < kR; ++c)
          drow[c] = drop_row(terms.drop, dhead, h - hk * group,
                             q0 + tx + 16 * c);
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int key = ty * kR + r;
#pragma unroll
        for (int c = 0; c < kR; ++c) {
          const int row = tx + 16 * c;
          float p = 0.f, ds = 0.f;
          if (visible(sh, q0 + row, k0 + key, qlen, klen,
                      seg_of(Qs, ld, D, row), seg_of(Ks, ld, D, key))) {
            float sv = st[r][c] * smult;
            float th = 0.f;  // the soft cap's tanh
            if constexpr (kTerms != kNoTerms)
              sv = add_score_terms<kTerms>(terms, sv, b, h, sh.Hq, sh.Sq,
                                           sh.Skv, q0 + row, k0 + key,
                                           sh.offset, th);
            p = exp2f(sv - Ls[row]);
            if constexpr (kDropout) {
              // dV takes the dropped weight, ds the dropped dp.
              const bool keep = drop_keep(terms.drop, drow[c], dcol[r]);
              ds = p * (drop_apply(terms.drop, keep, dpt[r][c] * dp_mult) -
                        Dl[row]);
              p = drop_apply(terms.drop, keep, p);
            } else {
              ds = p * (dpt[r][c] * dp_mult - Dl[row]);
            }
            if constexpr (kTerms == kSoftCap)
              ds = soft_cap_grad(terms.cap, th, ds);
          }
          Pt[key * (kB + 1) + row] = round_to<RoundT<T>>(p);
          dSt[key * (kB + 1) + row] = round_to<RoundT<T>>(ds);
        }
      }
      __syncthreads();

      for (int j = 0; j < kB; ++j) {
        float pv[kR], dsv[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          pv[r] = Pt[(ty * kR + r) * (kB + 1) + j];
          dsv[r] = dSt[(ty * kR + r) * (kB + 1) + j];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          if (c * 16 < D) {
            const float ov = dOs[j * ld + tx + 16 * c];
            const float qv = Qs[j * ld + tx + 16 * c];
#pragma unroll
            for (int r = 0; r < kR; ++r) {
              acc_v[r][c] = fmaf(pv[r], ov, acc_v[r][c]);
              acc_k[r][c] = fmaf(dsv[r], qv, acc_k[r][c]);
            }
          }
        }
      }
    }
  }

  // q carries scale * log2(e), except under ALiBi and the soft cap, where
  // it is unscaled.
  const float dk_mult = kFp8 ? scales[3]
                        : (kTerms == kSoftCap || terms.slopes != nullptr)
                            ? terms.scale
                            : kLn2;
  const float dv_mult = kFp8 ? scales[4] : 1.f;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int kj = k0 + ty * kR + r;
    if (kj >= sh.Skv) continue;
    const size_t at = (((size_t)b * sh.Skv + kj) * sh.Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c * 16 < D) {
        store_as(dk, g_code, at + tx + 16 * c, acc_k[r][c] * dk_mult);
        store_as(dv, g_code, at + tx + 16 * c, acc_v[r][c] * dv_mult);
      }
    }
  }
}

template <int DMAX>
size_t dq_smem(int D) {
  constexpr int kB = Tiles<DMAX>::kB;
  return sizeof(float) *
         (4 * (size_t)kB * (D + 1) + (size_t)kB * (kB + 1) + 2 * kB);
}

template <int DMAX>
size_t dkv_smem(int D) {
  constexpr int kB = Tiles<DMAX>::kB;
  return sizeof(float) *
         (4 * (size_t)kB * (D + 1) + 2 * (size_t)kB * (kB + 1) + 2 * kB);
}

template <typename T, int DMAX, int kTerms, bool kDropout>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, int do_code, const float* lse2,
                      const float* delta, void* dq, int g_code,
                      const int* qlens, const int* klens, const int* qseg,
                      const int* kseg, const float* scales,
                      const ScoreTerms& terms, float* dbias, int B,
                      const Shape& sh, cudaStream_t stream) {
  constexpr int kB = Tiles<DMAX>::kB;
  auto kernel = flash_bwd_dq_kernel<T, DMAX, kTerms, kDropout>;
  const size_t smem = dq_smem<DMAX>(sh.D);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.Sq + kB - 1) / kB, sh.Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), dout, do_code, lse2, delta, dq, g_code, qlens,
      klens, qseg, kseg, scales, terms, dbias, sh);
  return cudaGetLastError();
}

template <typename T, int DMAX, int kTerms, bool kDropout>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, int do_code, const float* lse2,
                       const float* delta, void* dk, void* dv, int g_code,
                       const int* qlens, const int* klens, const int* qseg,
                       const int* kseg, const float* scales,
                       const ScoreTerms& terms, int B, const Shape& sh,
                       cudaStream_t stream) {
  constexpr int kB = Tiles<DMAX>::kB;
  auto kernel = flash_bwd_dkv_kernel<T, DMAX, kTerms, kDropout>;
  const size_t smem = dkv_smem<DMAX>(sh.D);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.Skv + kB - 1) / kB, sh.Hkv, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), dout, do_code, lse2, delta, dk, dv, g_code,
      qlens, klens, qseg, kseg, scales, terms, sh);
  return cudaGetLastError();
}

// Q/K/V of `dtype` (f32, bf16, or e4m3 payloads with `scales`); dO of
// `do_dtype` (Q's outside the FP8 branch); gradients of `grad_dtype` (f32
// or bf16; Q's outside the FP8 branch); lengths and segment ids each both
// given or both null.
bool bad_args(int B, int Sq, int Skv, int Hq, int Hkv, int D, int left,
              int right, int dtype, int do_dtype, int grad_dtype,
              const float* scales, const int* qlens, const int* klens,
              const int* qseg, const int* kseg) {
  const bool fp8 = dtype == kFloat8E4M3;
  return B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || Hq % Hkv != 0 || D < 16 ||
         D > 256 || D % 16 != 0 || B > 65535 || Hq > 65535 || left < -1 ||
         right < -1 || fp8 != (scales != nullptr) || do_dtype < 0 ||
         do_dtype > kFloat8E5M2 ||
         (grad_dtype != kFloat32 && grad_dtype != kBFloat16) ||
         (!fp8 && (do_dtype != dtype || grad_dtype != dtype)) ||
         (qlens == nullptr) != (klens == nullptr) ||
         (qseg == nullptr) != (kseg == nullptr);
}

}  // namespace

#define TE_DQ(T, DM, TERMS, DROP)                                           \
  launch_dq<T, DM, TERMS, DROP>(q, k, v, dout, do_dtype, lse2, delta, dq,   \
                                grad_dtype, qlens, klens, qseg, kseg,       \
                                scales, terms, dbias, B, sh, s)
#define TE_DKV(T, DM, TERMS, DROP)                                          \
  launch_dkv<T, DM, TERMS, DROP>(q, k, v, dout, do_dtype, lse2, delta, dk,  \
                                 dv, grad_dtype, qlens, klens, qseg, kseg,  \
                                 scales, terms, B, sh, s)
#define TE_BY_D(LAUNCH, T, TERMS, DROP)                                    \
  (sh.D <= 64 ? LAUNCH(T, 64, TERMS, DROP)                                 \
              : sh.D <= 128 ? LAUNCH(T, 128, TERMS, DROP)                  \
                            : LAUNCH(T, 256, TERMS, DROP))

// The instances of the other translation units, each a pair of functions
// of these signatures (`dtype` Q/K/V's DTypeCode): the bias and ALiBi
// instances (bf16, f32), the dropout instances (bf16 and f32 with the bias
// and ALiBi terms, and e4m3 payloads with any dO), the soft-cap instances
// (bf16, f32) and the soft-cap instances with dropout (bf16, f32). nvcc
// builds the units at once, and the kernels without them compile as they
// did.
#define TE_DQ_ARGS                                                          \
  const void *q, const void *k, const void *v, int dtype, const void *dout, \
      int do_dtype, const float *lse2, const float *delta, void *dq,       \
      int grad_dtype, const int *qlens, const int *klens, const int *qseg, \
      const int *kseg, const float *scales, const ScoreTerms &terms,       \
      float *dbias, int B, const Shape &sh, cudaStream_t s
#define TE_DKV_ARGS                                                         \
  const void *q, const void *k, const void *v, int dtype, const void *dout, \
      int do_dtype, const float *lse2, const float *delta, void *dk,       \
      void *dv, int grad_dtype, const int *qlens, const int *klens,        \
      const int *qseg, const int *kseg, const float *scales,               \
      const ScoreTerms &terms, int B, const Shape &sh, cudaStream_t s
cudaError_t flash_bwd_dq_terms(TE_DQ_ARGS);
cudaError_t flash_bwd_dkv_terms(TE_DKV_ARGS);
cudaError_t flash_bwd_dq_dropout(TE_DQ_ARGS);
cudaError_t flash_bwd_dkv_dropout(TE_DKV_ARGS);
cudaError_t flash_bwd_dq_softcap(TE_DQ_ARGS);
cudaError_t flash_bwd_dkv_softcap(TE_DKV_ARGS);
cudaError_t flash_bwd_dq_softcap_dropout(TE_DQ_ARGS);
cudaError_t flash_bwd_dkv_softcap_dropout(TE_DKV_ARGS);

#if TE_FLASH_UNIT != 0
#if TE_FLASH_UNIT == 1
#define TE_UNIT_DQ flash_bwd_dq_terms
#define TE_UNIT_DKV flash_bwd_dkv_terms
#define TE_UNIT_KIND kBiasAlibi
#define TE_UNIT_DROPOUT false
#elif TE_FLASH_UNIT == 2
#define TE_UNIT_DQ flash_bwd_dq_dropout
#define TE_UNIT_DKV flash_bwd_dkv_dropout
#define TE_UNIT_KIND kBiasAlibi
#define TE_UNIT_DROPOUT true
#elif TE_FLASH_UNIT == 3
#define TE_UNIT_DQ flash_bwd_dq_softcap
#define TE_UNIT_DKV flash_bwd_dkv_softcap
#define TE_UNIT_KIND kSoftCap
#define TE_UNIT_DROPOUT false
#else
#define TE_UNIT_DQ flash_bwd_dq_softcap_dropout
#define TE_UNIT_DKV flash_bwd_dkv_softcap_dropout
#define TE_UNIT_KIND kSoftCap
#define TE_UNIT_DROPOUT true
#endif
cudaError_t TE_UNIT_DQ(TE_DQ_ARGS) {
  switch (dtype) {
    case kBFloat16:
      return TE_BY_D(TE_DQ, __nv_bfloat16, TE_UNIT_KIND, TE_UNIT_DROPOUT);
    case kFloat32:
      return TE_BY_D(TE_DQ, float, TE_UNIT_KIND, TE_UNIT_DROPOUT);
#if TE_FLASH_UNIT == 2
    case kFloat8E4M3:  // FP8 Q/K/V with dropout: no score terms
      return TE_BY_D(TE_DQ, __nv_fp8_e4m3, kNoTerms, true);
#endif
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t TE_UNIT_DKV(TE_DKV_ARGS) {
  switch (dtype) {
    case kBFloat16:
      return TE_BY_D(TE_DKV, __nv_bfloat16, TE_UNIT_KIND, TE_UNIT_DROPOUT);
    case kFloat32:
      return TE_BY_D(TE_DKV, float, TE_UNIT_KIND, TE_UNIT_DROPOUT);
#if TE_FLASH_UNIT == 2
    case kFloat8E4M3:
      return TE_BY_D(TE_DKV, __nv_fp8_e4m3, kNoTerms, true);
#endif
    default:
      return cudaErrorInvalidValue;
  }
}
#undef TE_UNIT_DROPOUT
#undef TE_UNIT_KIND
#undef TE_UNIT_DKV
#undef TE_UNIT_DQ
#else
// `bias` (`bias_b` = 1 or B, Hq, Sq, Skv) of `bias_dtype` f32 or bf16,
// with `dbias` its per-batch f32 (B, Hq, Sq, Skv) gradient, every element
// of which the dQ kernel writes; or the (Hq,) ALiBi `slopes` (q unscaled);
// or the soft cap `cap` > 0 (q unscaled; 0 for none); at most one, and
// none with FP8. `seed`, `thr`, `inv`, `bq` and `bk`: the forward's
// dropout, or a null seed without; FP8 included.
extern "C" int te_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, int dtype, const void* dout,
    int do_dtype, const float* lse2, const float* delta, void* dq,
    int grad_dtype, const int* qlens, const int* klens, const int* qseg,
    const int* kseg, const float* scales, const void* bias, int bias_dtype,
    int bias_b, const float* slopes, float* dbias, int B, int Sq, int Skv,
    int Hq, int Hkv, int D, int causal, int offset, int left, int right,
    float scale, float cap, const int* seed, unsigned thr, float inv, int bq,
    int bk, void* stream) {
  const ScoreTerms terms{bias, bias_dtype, bias_b, slopes, scale, cap,
                         Dropout{seed, thr, inv, bq, bk}};
  if (bad_args(B, Sq, Skv, Hq, Hkv, D, left, right, dtype, do_dtype,
               grad_dtype, scales, qlens, klens, qseg, kseg) ||
      bad_terms(terms, B, dtype == kFloat8E4M3) ||
      (bias != nullptr) != (dbias != nullptr))
    return cudaErrorInvalidValue;
  const Shape sh{Sq, Skv, Hq, Hkv, D, causal, offset, left, right};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TE_DQ_UNIT(UNIT)                                                    \
  UNIT(q, k, v, dtype, dout, do_dtype, lse2, delta, dq, grad_dtype, qlens, \
       klens, qseg, kseg, scales, terms, dbias, B, sh, s)
  if (cap != 0.f)
    return seed != nullptr ? TE_DQ_UNIT(flash_bwd_dq_softcap_dropout)
                           : TE_DQ_UNIT(flash_bwd_dq_softcap);
  if (seed != nullptr) return TE_DQ_UNIT(flash_bwd_dq_dropout);
  if (bias != nullptr || slopes != nullptr)
    return TE_DQ_UNIT(flash_bwd_dq_terms);
#undef TE_DQ_UNIT
  switch (dtype) {
    case kBFloat16:
      return TE_BY_D(TE_DQ, __nv_bfloat16, kNoTerms, false);
    case kFloat32:
      return TE_BY_D(TE_DQ, float, kNoTerms, false);
    case kFloat8E4M3:
      return TE_BY_D(TE_DQ, __nv_fp8_e4m3, kNoTerms, false);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int te_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, int dtype, const void* dout,
    int do_dtype, const float* lse2, const float* delta, void* dk, void* dv,
    int grad_dtype, const int* qlens, const int* klens, const int* qseg,
    const int* kseg, const float* scales, const void* bias, int bias_dtype,
    int bias_b, const float* slopes, int B, int Sq, int Skv, int Hq, int Hkv,
    int D, int causal, int offset, int left, int right, float scale,
    float cap, const int* seed, unsigned thr, float inv, int bq, int bk,
    void* stream) {
  const ScoreTerms terms{bias, bias_dtype, bias_b, slopes, scale, cap,
                         Dropout{seed, thr, inv, bq, bk}};
  if (bad_args(B, Sq, Skv, Hq, Hkv, D, left, right, dtype, do_dtype,
               grad_dtype, scales, qlens, klens, qseg, kseg) ||
      bad_terms(terms, B, dtype == kFloat8E4M3))
    return cudaErrorInvalidValue;
  const Shape sh{Sq, Skv, Hq, Hkv, D, causal, offset, left, right};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TE_DKV_UNIT(UNIT)                                                   \
  UNIT(q, k, v, dtype, dout, do_dtype, lse2, delta, dk, dv, grad_dtype,    \
       qlens, klens, qseg, kseg, scales, terms, B, sh, s)
  if (cap != 0.f)
    return seed != nullptr ? TE_DKV_UNIT(flash_bwd_dkv_softcap_dropout)
                           : TE_DKV_UNIT(flash_bwd_dkv_softcap);
  if (seed != nullptr) return TE_DKV_UNIT(flash_bwd_dkv_dropout);
  if (bias != nullptr || slopes != nullptr)
    return TE_DKV_UNIT(flash_bwd_dkv_terms);
#undef TE_DKV_UNIT
  switch (dtype) {
    case kBFloat16:
      return TE_BY_D(TE_DKV, __nv_bfloat16, kNoTerms, false);
    case kFloat32:
      return TE_BY_D(TE_DKV, float, kNoTerms, false);
    case kFloat8E4M3:
      return TE_BY_D(TE_DKV, __nv_fp8_e4m3, kNoTerms, false);
    default:
      return cudaErrorInvalidValue;
  }
}
#endif  // TE_FLASH_UNIT
#undef TE_DKV_ARGS
#undef TE_DQ_ARGS
#undef TE_BY_D
#undef TE_DKV
#undef TE_DQ
