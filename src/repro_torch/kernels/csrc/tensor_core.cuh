// bf16 tensor-core and copy helpers for sm_90a: mma.sync.m16n8k16 with
// fp32 accumulation, the bf16 packing of its operands (also the forward's,
// flash_fwd.cu), ldmatrix fragment loads from shared memory and 16-byte
// cp.async copies into it (the backward, flash_bwd.cu).
//
// Fragment layout of m16n8k16 (lane = 4 g + t):
//   A (16 x 16, row-major): a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1],
//                           a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9];
//   B (16 x 8, k-major):    b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g];
//   C (16 x 8, fp32):       c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1].
// The C fragments of two n-tiles side by side are exactly the A fragment of
// a 16 x 16 tile, so a product's output feeds the next product's A operand
// without leaving registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace dash_mma {

// D(16x8, fp32) += A(16x16, bf16, row) * B(16x8, bf16, col)
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats -> one register of two bf16, the lower index in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// fp32 x0, x1 as two bf16 pairs with x = hi + lo to about 2^-16 relative:
// hi = bf16(x), lo = bf16(x - hi) (x - hi is exact in fp32)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(__fsub_rn(x0, hf.x), __fsub_rn(x1, hf.y));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 address the rows of matrix i, and
// lane 4g + t receives row g, columns 2t and 2t+1 of each (.trans: column
// g, rows 2t and 2t+1)
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// 16 bytes device -> shared, bypassing L1
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace dash_mma
