// Paged decode attention: one query token per sequence over a paged KV
// cache, read through its page table.
//   q (B, Hq, D) bf16|f32; pages (P, page, Hkv, D) e4m3|bf16|f32;
//   table (B, max_pages) int32 (-1 unallocated); lengths (B,) int32;
//   kv_scale (1,) or (B,) f32 dequant scales; optional sink (Hq,) f32.
//
// Replaces transformerengine_tpu/ops/paged_attention.py
// paged_decode_attention (the Pallas `_paged_kernel`): K and V are
// dequantized to f32 (payload * kv_scale), scores are f32 dot products
// times the softmax scale, and an online softmax in the natural exp
// domain runs over the sequence's pages with -1e30 as the mask value; a
// sink joins the denominator at the end, and a sequence with no entries
// gives a zero row. Table entries are clamped into the pool, as the
// reference's are, and a sequence reads at most max_pages * page entries.
//
// Bound on an H100: bytes. The pages a sequence owns are read once:
// 2 * sum(len) * Hkv * D bytes for fp8, about 8.9 MB per LLAMA_8B layer
// at B = 8 and lengths 400/528 (about 2.7 us at 3.35 TB/s).
//
// Design: decode_attn.cuh's body, the sequence split across blocks, with
// the paged address rule: key pos at row pos % page of page
// table[b, pos / page], read in place (the pool is never copied). Where the
// page is a multiple of the 64-key tile, a tile lies in one page and reads
// its table entry once.
#include "decode_attn.cuh"

// ws holds min(ceil(max_pages * page / 64), 64) * B * Hq * (D + 2) floats;
// max_splits is that count of splits (1 where ws is null).
extern "C" int te_paged_decode_attention(
    const void* q, int q_dtype, const void* k, const void* v, int cache_dtype,
    const int* table, const int* lengths, const float* kv_scale,
    int scale_per_row, const float* sink, void* out, float* ws,
    int max_splits, int B, int P, int page, int max_pages, int Hq, int Hkv,
    int D, float scale, void* stream) {
  if (P < 1 || page < 1 || max_pages < 1 ||
      (long long)max_pages * page > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const decode_attn::Args a{q, k, v, lengths, kv_scale, scale_per_row, sink,
                            out, ws, max_splits, B, Hq, Hkv, D, scale,
                            (long long)max_pages * page,
                            static_cast<cudaStream_t>(stream)};
  return decode_attn::run(
      q_dtype, cache_dtype, a,
      decode_attn::PagedRows{table, P, page, max_pages, Hkv, D});
}
