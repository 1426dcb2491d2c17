// The PTX instructions of the flash kernels' tensor-core bodies: warp-wide
// fragment loads from shared memory (ldmatrix), the bf16 matrix product
// with f32 accumulators (mma.sync m16n8k16) and 16-byte asynchronous
// copies from global to shared memory (cp.async).
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
