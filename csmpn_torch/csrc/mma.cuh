// Warp-level tensor-core helpers shared by the kernels that use mma.sync:
// the dense CEMLP block tiles (cemlp_tile.cuh: K2, K3, K4 and K5 in fast
// mode) and the pair form's tiles.  The envelope probe's P2 runs on wgmma
// (wgmma.cuh), whose per-warp fragments are the ones described here.
//
// Fragment layouts of mma.sync (PTX ISA, "Matrix fragments for
// mma.m16n8k16 / m16n8k8"), g = lane / 4, t = lane % 4:
//   A m16 x k16 bf16: {(g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)}
//   B k16 x n8 bf16:  {(2t..2t+1, g), (2t+8.., g)}
//   A m16 x k8 tf32:  {(g, t), (g+8, t), (g, t+4), (g+8, t+4)}
//   B k8 x n8 tf32:   {(t, g), (t+4, g)}
//   C m16 x n8 f32:   {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}
// A 32-bit register of a bf16 fragment holds two elements, the lower
// column (A) or row (B) in its low half.  Each fragment is four (A) or two
// (B) 8 x 8 matrices of 16-bit elements, which ldmatrix loads from shared
// memory: lanes 8j..8j+7 give the row addresses of matrix j (16 bytes a
// row), and register j then holds, at lane 4g + t, row g and elements 2t,
// 2t + 1 of matrix j; with .trans, column g and rows 2t, 2t + 1.  So
//   * A stored row-major [m][k] loads plainly (lanes 0-15 rows 0-15 at k0,
//     lanes 16-31 the same rows at k0 + 8), and A stored as its transpose
//     [k][m] loads with .trans;
//   * B stored as [n][k] (a row of B transposed) loads plainly, and B
//     stored [k][n] with .trans.
// A row pitch that is an odd multiple of 16 bytes puts the 8 rows of a
// matrix in 32 distinct banks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Two matrices: lanes 0-15 give the row addresses (the other lanes'
// addresses are not read, but must be valid shared addresses).
__device__ __forceinline__ void ldsm2(uint32_t (&r)[2], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

__device__ __forceinline__ void ldsm2_t(uint32_t (&r)[2], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

// The transposed loads from a shared-state-space address.
__device__ __forceinline__ void ldsm4_t_s(uint32_t (&r)[4], unsigned s) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm2_t_s(uint32_t (&r)[2], unsigned s) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The same product as an asm statement the compiler may schedule (its
// operands are registers only).
__device__ __forceinline__ void mma_bf16_s(float (&c)[4],
                                           const uint32_t (&a)[4],
                                           const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace
