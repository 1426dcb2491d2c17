// The PTX instructions of the tensor-core bodies: warp-wide fragment loads
// from shared memory (ldmatrix), the bf16 matrix product with f32
// accumulators (mma.sync m16n8k16), 16-byte asynchronous copies from
// global to shared memory (cp.async), and for the decode GEMMs' weights
// streaming loads, byte permutes (prmt), the e4m3 pair conversion and the
// bf16 pair product.
//
// Fragment layouts of mma.m16n8k16 (lane l, g = l / 4, t = l % 4), each
// 32-bit register holding two consecutive 16-bit values, the lower column
// (or k) in the low half:
// - A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..2t+1),
//   a2 = (g, 2t+8..2t+9), a3 = (g + 8, 2t+8..2t+9);
// - B (16 x 8, k x n): b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g);
// - C and D (16 x 8, f32): c0, c1 = (g, 2t), (g, 2t+1); c2, c3 = (g + 8,
//   2t), (g + 8, 2t+1).
// So the C fragments of two neighbouring n-tiles, rounded to bf16 in
// pairs, are the A fragment of one 16-deep k-step: a score tile in
// registers feeds the next product without a trip through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// Four 8 x 8 matrices of 16-bit values: lane l gives the shared address of
// row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned); register i
// receives matrix i, lane l holding its row l / 4, columns 2 (l % 4) and
// 2 (l % 4) + 1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// ldmatrix_x4 transposed: lane l holds column l / 4 of each matrix, rows
// 2 (l % 4) and 2 (l % 4) + 1.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += A B for one m16n8k16 tile: bf16 operands, f32 accumulators. Not
// volatile: the compiler may move it past other instructions (its operands
// order it), so loads can issue ahead of it.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// prmt.b32 in its default mode: byte i of the result is byte s_i & 7 of the
// pool {a, b} (a's bytes 0-3, b's 4-7), s_i the i-th 4-bit field of sel's
// low 16 bits; where bit 3 of s_i is set, that byte's sign bit fills all 8
// bits instead.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// The two e4m3 values of the low 16 bits of `pair` (the first in the low
// byte) as an f16 pair, exactly: every e4m3 value is an f16 value.
__device__ __forceinline__ uint32_t cvt_f16x2_e4m3x2(uint32_t pair) {
  uint32_t d;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n"
      : "=r"(d)
      : "h"(static_cast<unsigned short>(pair)));
  return d;
}

// The products of two bf16 pairs, each rounded to nearest even (a bf16
// multiply, as the reference's).
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// A 16-byte load of data read once: it is not kept in L1 (where it would
// evict what is read again), and L2 fetches the whole 128-byte line.
__device__ __forceinline__ uint4 ldg_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::128B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// Copies 16 bytes from global to shared memory without the registers, or
// writes 16 zero bytes when `valid` is false (nothing is read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// Closes the group of this thread's copies issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
