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
// Design: one block per (kv head, batch row), one warp per query head of
// its GQA group, so the G query heads share every K/V tile the block
// stages in shared memory (64 keys at a time, read with 16-byte loads,
// dequantized to f32, K rows padded to D + 1 floats). Lanes own keys for
// the scores and head-dim columns for the accumulator. Tiles start at the sliding window's edge
// and stop at the sequence's length. B * Hkv blocks (64 at B = 8) leave
// most of the 132 SMs idle: splitting the sequence across blocks is the
// next step.
#include "common.cuh"

namespace {

constexpr int kBS = 64;

size_t smem_bytes(int G, int D) {
  return sizeof(float) * ((size_t)G * D + (size_t)kBS * (D + 1) +
                          (size_t)kBS * D + (size_t)G * kBS);
}

template <typename QT, typename CT, int DMAX>
__global__ void decode_attention_kernel(
    const QT* __restrict__ q, const CT* __restrict__ kc,
    const CT* __restrict__ vc, const int* __restrict__ lengths,
    const float* __restrict__ kv_scale, int scale_per_row,
    const float* __restrict__ sink, QT* __restrict__ out, int S, int Hq,
    int Hkv, int D, float scale, int window_left) {
  constexpr int kCols = DMAX / 32;
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  const int ld = D + 1;
  float* qs = smem;             // [G][D]
  float* Ks = qs + G * D;       // [kBS][D + 1]
  float* Vs = Ks + kBS * ld;    // [kBS][D]
  float* Ps = Vs + kBS * D;     // [G][kBS]

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int g = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nthreads = blockDim.x;
  const int h = hk * G + g;

  constexpr int kVec = 16 / sizeof(CT);
  const int vecs_per_row = D / kVec;
  const int len = min(lengths[b], S);
  const float ks = kv_scale[scale_per_row ? b : 0];
  int start = 0;
  if (window_left >= 0) start = max(0, len - 1 - window_left) / kBS * kBS;

  for (int i = threadIdx.x; i < G * D; i += nthreads)
    qs[i] = to_float(q[((size_t)b * Hq + hk * G) * D + i]);

  float m = kNegInf, l = 0.f, acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;

  for (int t0 = start; t0 < len; t0 += kBS) {
    __syncthreads();  // q is loaded; the previous tile is no longer read
    // 16-byte loads, kVec values each; keys past the length load as 0.
    for (int i = threadIdx.x; i < kBS * vecs_per_row; i += nthreads) {
      const int j = i / vecs_per_row;
      const int d = (i - j * vecs_per_row) * kVec;
      const int pos = t0 + j;
      float kv[kVec], vv[kVec];
      if (pos < len) {
        const size_t src = (((size_t)b * S + pos) * Hkv + hk) * D + d;
        load16(kc + src, kv);
        load16(vc + src, vv);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kv[e] = vv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        Ks[j * ld + d + e] = kv[e] * ks;
        Vs[j * D + d + e] = vv[e] * ks;
      }
    }
    __syncthreads();

    // Each lane scores kBS / 32 keys, with four partial sums per key so
    // that the FMAs do not wait on each other.
    float dot[kBS / 32][4];
#pragma unroll
    for (int jj = 0; jj < kBS / 32; ++jj)
#pragma unroll
      for (int u = 0; u < 4; ++u) dot[jj][u] = 0.f;
    for (int d = 0; d < D; d += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float qv = qs[g * D + d + u];
#pragma unroll
        for (int jj = 0; jj < kBS / 32; ++jj)
          dot[jj][u] = fmaf(qv, Ks[(lane + 32 * jj) * ld + d + u], dot[jj][u]);
      }
    }
    float sc[kBS / 32];
    bool vis[kBS / 32];
    float mx = kNegInf;
#pragma unroll
    for (int jj = 0; jj < kBS / 32; ++jj) {
      const int pos = t0 + lane + 32 * jj;
      vis[jj] = pos < len && (window_left < 0 || pos >= len - 1 - window_left);
      const float sum = (dot[jj][0] + dot[jj][1]) + (dot[jj][2] + dot[jj][3]);
      sc[jj] = vis[jj] ? sum * scale : kNegInf;
      mx = fmaxf(mx, sc[jj]);
    }
    const float m_new = fmaxf(m, warp_max(mx));
    const float alpha = m_new <= kNegInf / 2 ? 0.f : expf(m - m_new);
    float rs = 0.f;
#pragma unroll
    for (int jj = 0; jj < kBS / 32; ++jj) {
      const float p = vis[jj] ? expf(sc[jj] - m_new) : 0.f;
      rs += p;
      Ps[g * kBS + lane + 32 * jj] = p;
    }
    l = l * alpha + warp_sum(rs);
    m = m_new;
    __syncwarp();
    // The columns' sums are independent chains, interleaved key by key.
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] *= alpha;
    for (int j = 0; j < kBS; ++j) {
      const float p = Ps[g * kBS + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        if (d < D) acc[c] = fmaf(p, Vs[j * D + d], acc[c]);
      }
    }
  }

  float mult;
  if (sink != nullptr) {
    const float s0 = sink[h];
    const float m2 = fmaxf(m, s0);
    const float a2 = m2 <= kNegInf / 2 ? 0.f : expf(m - m2);
    mult = a2 / (l * a2 + expf(s0 - m2));
  } else {
    mult = 1.f / (l > 0.f ? l : 1.f);
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int d = lane + 32 * c;
    if (d < D) out[((size_t)b * Hq + h) * D + d] = from_float<QT>(acc[c] * mult);
  }
}

template <typename QT, typename CT, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, const float* kv_scale, int scale_per_row,
                   const float* sink, void* out, int B, int S, int Hq, int Hkv,
                   int D, float scale, int window_left, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<QT, CT, DMAX>;
  const int G = Hq / Hkv;
  const size_t smem = smem_bytes(G, D);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Hkv, B), 32 * G, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(k),
      static_cast<const CT*>(v), lengths, kv_scale, scale_per_row, sink,
      static_cast<QT*>(out), S, Hq, Hkv, D, scale, window_left);
  return cudaGetLastError();
}

template <typename QT, typename CT>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int* lengths, const float* kv_scale,
                     int scale_per_row, const float* sink, void* out, int B,
                     int S, int Hq, int Hkv, int D, float scale,
                     int window_left, cudaStream_t stream) {
  if (D <= 64)
    return launch<QT, CT, 64>(q, k, v, lengths, kv_scale, scale_per_row, sink,
                              out, B, S, Hq, Hkv, D, scale, window_left,
                              stream);
  if (D <= 128)
    return launch<QT, CT, 128>(q, k, v, lengths, kv_scale, scale_per_row,
                               sink, out, B, S, Hq, Hkv, D, scale,
                               window_left, stream);
  return launch<QT, CT, 256>(q, k, v, lengths, kv_scale, scale_per_row, sink,
                             out, B, S, Hq, Hkv, D, scale, window_left,
                             stream);
}

template <typename QT>
cudaError_t launch_c(int cache_dtype, const void* q, const void* k,
                     const void* v, const int* lengths, const float* kv_scale,
                     int scale_per_row, const float* sink, void* out, int B,
                     int S, int Hq, int Hkv, int D, float scale,
                     int window_left, cudaStream_t stream) {
  switch (cache_dtype) {
    case kFloat8E4M3:
      return launch_d<QT, __nv_fp8_e4m3>(q, k, v, lengths, kv_scale,
                                         scale_per_row, sink, out, B, S, Hq,
                                         Hkv, D, scale, window_left, stream);
    case kBFloat16:
      return launch_d<QT, __nv_bfloat16>(q, k, v, lengths, kv_scale,
                                         scale_per_row, sink, out, B, S, Hq,
                                         Hkv, D, scale, window_left, stream);
    case kFloat32:
      return launch_d<QT, float>(q, k, v, lengths, kv_scale, scale_per_row,
                                 sink, out, B, S, Hq, Hkv, D, scale,
                                 window_left, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int te_decode_attention(const void* q, int q_dtype, const void* k,
                                   const void* v, int cache_dtype,
                                   const int* lengths, const float* kv_scale,
                                   int scale_per_row, const float* sink,
                                   void* out, int B, int S, int Hq, int Hkv,
                                   int D, float scale, int window_left,
                                   void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || Hq % Hkv != 0 || Hq / Hkv > 32 || D < 16 ||
      D > 256 || D % 16 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case kBFloat16:
      return launch_c<__nv_bfloat16>(cache_dtype, q, k, v, lengths, kv_scale,
                                     scale_per_row, sink, out, B, S, Hq, Hkv,
                                     D, scale, window_left, s);
    case kFloat32:
      return launch_c<float>(cache_dtype, q, k, v, lengths, kv_scale,
                             scale_per_row, sink, out, B, S, Hq, Hkv, D, scale,
                             window_left, s);
    default:
      return cudaErrorInvalidValue;
  }
}
