// Inline-PTX building blocks of the port's tensor-core kernels (sm_80 and
// later; the port builds them for sm_90a): 16-byte cp.async copies from
// global to shared memory, ldmatrix loads of 8x8 b16 tiles, and the bf16
// mma.sync m16n8k16 with f32 accumulators.
//
// Fragment layouts of mma.m16n8k16.row.col (lane = 4 * g + t):
//   A (16 x 16, row-major), 4 registers of two bf16 each:
//     a[0] = A[g][2t, 2t+1]      a[1] = A[g+8][2t, 2t+1]
//     a[2] = A[g][2t+8, 2t+9]    a[3] = A[g+8][2t+8, 2t+9]
//   B (16 x 8, "col"), 2 registers: b[0] = B[2t, 2t+1][g], b[1] = B[2t+8,
//     2t+9][g]
//   C/D (16 x 8, f32): c[0], c[1] = C[g][2t, 2t+1]; c[2], c[3] = C[g+8][...]
// The lower half of a register holds the element of the smaller index.
//
// ldmatrix: lanes 8i .. 8i+7 give the row addresses (16 bytes each) of
// matrix i.  Without .trans lane 4g+t receives row g, columns 2t, 2t+1 of
// each matrix; with .trans it receives rows 2t, 2t+1 of column g.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; the bytes past ``src_bytes``
// (0 or 16) are written as zeros, so a masked chunk costs no load.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
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

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// lanes 0..15 give the addresses
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += A B, bf16 inputs, f32 accumulators.  Not volatile: it has no side
// effects, so the compiler may schedule it among the fragment loads.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (to nearest even), lo in the lower half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

}  // namespace tc
