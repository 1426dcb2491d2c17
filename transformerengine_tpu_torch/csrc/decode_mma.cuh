// Shared pieces of the decode GEMMs' tensor-core bodies (decode_matvec.cu,
// decode_kn_matvec.cu): the weight's dequantization to bf16 pairs in
// registers, and the fragment map.
//
// Both GEMMs have M <= 32 rows of x against thousands of weight columns,
// so the operands are swapped: the weight is the A operand (16 output
// columns n x 16 k) and x^T the B operand (16 k x 8 rows m of x), and each
// mma.m16n8k16 yields a 16 n x 8 m tile of out^T; M <= 8 fills one n8
// tile, M <= 16 takes two and M <= 32 four (rows of x past M are zeros).
// With ptx.cuh's layouts (lane l, g = l / 4, t = l % 4):
//   A: a0 = (row g, k slots 2t, 2t+1), a1 = (row g + 8, 2t, 2t+1),
//      a2 = (row g, 2t+8, 2t+9),        a3 = (row g + 8, 2t+8, 2t+9);
//   B: b0 = (k slots 2t, 2t+1; m g),    b1 = (2t+8, 2t+9; m g);
//   D: d0, d1 = (row g; m 2t, 2t+1),    d2, d3 = (row g + 8; m 2t, 2t+1).
// A lane's k slots depend on t alone, in A as in B, and a sum over k does
// not care which k a slot holds as long as A and B agree. So each kernel
// gives slots {2t, 2t+1, 2t+8, 2t+9} of a k-tile the k that its lane
// loaded, and feeds fragments straight from 16-byte global loads, with no
// shared-memory staging or ldmatrix:
// - decode_tn_matvec, W (N, K): lane (g, t) loads 16 contiguous k at
//   k0 + 16t of its rows g and g + 8 (the group's 4 lanes read 64 bytes of
//   a row). K-tile j (0-3) of the 64 k gives slots 2t, 2t+1 the k
//   k0 + 16t + 4j, +1 and slots 2t+8, 2t+9 the k +2, +3: in bf16 pairs,
//   words 2j and 2j + 1 of the lane's 16 k, of W's row as of x's row g.
//   A rows are the rows of W, so D's rows are n and its columns m.
// - decode_kn_matvec, W (K, N): lane (g, t) loads 16 contiguous n (the
//   group's; a warp reads one 128-byte line a row) at each of 4 stored
//   rows r0 + 4t .. r0 + 4t + 3. Fragment j (0-7) takes the group's n pair
//   (2j, 2j + 1) as A rows g and g + 8. e4m3: slots 2t, 2t+1 get k r0 + 4t,
//   +1 and slots 2t+8, 2t+9 get +2, +3: x's row g at r0 + 4t is b0, b1 as
//   loaded. Packed e2m1: a byte holds code rows r and r + K/2 at one n,
//   which is one bf16 pair of A: k-tile 0 gives slots 2t, 2t+1 stored row
//   r0 + 4t (k r and r + K/2) and slots 2t+8, 2t+9 row r0 + 4t + 1; k-tile 1
//   rows +2 and +3; B pairs x[m, r] with x[m, r + K/2] to match. D's row g
//   is n 16g + 2j and row g + 8 is n 16g + 2j + 1.
#pragma once

#include "common.cuh"
#include "ptx.cuh"

namespace decode_mma {

// The bf16 pair {2^112, 2^112}.
constexpr uint32_t kTwo112 = 0x77807780u;

// The two e4m3 values of the low 16 bits of `pair` (the first in the low
// byte) as a bf16 pair, exactly. The hardware widens them to f16, where
// every nonzero e4m3 value is normal (2^-9 and up); shifting an f16's
// exponent and top 7 mantissa bits right by 3 lands them in bf16's fields
// with the exponent still biased by 15, which is the value times 2^-112, a
// normal bf16, and the product with 2^112 restores it (zero stays zero).
// e4m3's NaN codes come out finite; no payload holds them (the casts
// saturate).
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t pair) {
  const uint32_t h = cvt_f16x2_e4m3x2(pair);
  return mul_bf16x2(((h >> 3) & 0x0fff0fffu) | (h & 0x80008000u), kTwo112);
}

// The low and high bytes of the bf16 values of e2m1's magnitude codes 0-7
// ({0, .5, 1, 1.5, 2, 3, 4, 6}), as prmt pools of codes 0-3 and 4-7.
constexpr uint32_t kE2m1LoA = 0xC0800000u, kE2m1LoB = 0xC0804000u;
constexpr uint32_t kE2m1HiA = 0x3F3F3F00u, kE2m1HiB = 0x40404040u;

// Four packed bytes (byte i: e2m1 code c_i in the low nibble, c'_i in the
// high one) as four bf16 pairs {value(c_i), value(c'_i)}, exactly: prmt
// looks up the bytes of the codes' magnitudes with the codes as selectors
// (low bytes, and high bytes with each code's sign, bit 3 of its nibble,
// as their top bit: the top bit of byte i of w << 4 or of w), then
// interleaves low and high bytes.
__device__ __forceinline__ void e2m1x8_to_bf16x2(uint32_t w,
                                                 uint32_t (&out)[4]) {
  const uint32_t mag = w & 0x77777777u;
  const uint32_t w4 = w << 4;
  const uint32_t lo01 = prmt(kE2m1LoA, kE2m1LoB, mag);
  const uint32_t lo23 = prmt(kE2m1LoA, kE2m1LoB, mag >> 16);
  const uint32_t hi01 = prmt(kE2m1HiA, kE2m1HiB, mag) |
                        (prmt(w4, w, 0xD9C8) & 0x80808080u);
  const uint32_t hi23 = prmt(kE2m1HiA, kE2m1HiB, mag >> 16) |
                        (prmt(w4, w, 0xFBEA) & 0x80808080u);
  out[0] = prmt(lo01, hi01, 0x5140);
  out[1] = prmt(lo01, hi01, 0x7362);
  out[2] = prmt(lo23, hi23, 0x5140);
  out[3] = prmt(lo23, hi23, 0x7362);
}

// Word i of a 16-byte register vector.
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

}  // namespace decode_mma
