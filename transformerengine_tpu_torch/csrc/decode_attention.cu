// Decode attention: one query token per sequence over a BSHD KV cache.
//   q (B, Hq, D) bf16|f32; cache (B, S, Hkv, D) e4m3|bf16|f32;
//   lengths (B,) int32; kv_scale (1,) or (B,) f32 dequant scales;
//   optional window_left and per-head softmax sink (Hq,) f32.
//
// Replaces transformerengine_tpu/ops/decode_attention.py decode_attention
// in its Pallas form (`_decode_kernel`): K and V are dequantized to f32
// (payload * kv_scale), scores are f32 dot products times the softmax
// scale, and an online softmax in the natural exp domain runs over the
// cache with -1e30 as the mask value; a sink joins the denominator at the
// end. The JAX default, the einsum form `_xla_decode_attention`, is the
// port's plain version.
//
// Bound on an H100: bytes. The cache read is 2 * B * len * Hkv * D bytes
// for fp8, about 8.9 MB per LLAMA_8B layer at B = 8 and length 544:
// about 2.7 us at 3.35 TB/s.
//
// Design: decode_attn.cuh's body, the sequence split across blocks, with
// the contiguous address rule: key pos of row b and kv head hk at
// ((b S + pos) Hkv + hk) D. A row reads the keys [start, len), start its
// sliding window's edge rounded down to a 64-key tile.
#include "decode_attn.cuh"

// ws holds min(ceil(span / 64), 64) * B * Hq * (D + 2) floats, span being S,
// or min(S, window_left + 64) with a window (the keys a row can reach);
// max_splits is that count of splits (1 where ws is null).
extern "C" int te_decode_attention(const void* q, int q_dtype, const void* k,
                                   const void* v, int cache_dtype,
                                   const int* lengths, const float* kv_scale,
                                   int scale_per_row, const float* sink,
                                   void* out, float* ws, int max_splits, int B,
                                   int S, int Hq, int Hkv, int D, float scale,
                                   int window_left, void* stream) {
  if (S < 1) return cudaErrorInvalidValue;
  const long long span =
      window_left >= 0 ? std::min<long long>(S, window_left + 64LL) : S;
  const decode_attn::Args a{q, k, v, lengths, kv_scale, scale_per_row, sink,
                            out, ws, max_splits, B, Hq, Hkv, D, scale,
                            span,
                            static_cast<cudaStream_t>(stream)};
  return decode_attn::run(q_dtype, cache_dtype, a,
                          decode_attn::ContiguousRows{S, Hkv, D, window_left});
}
