// Warpgroup tensor-core helpers for Hopper (sm_90a), written in inline PTX
// like mma.cuh: the shared-memory matrix descriptor of `wgmma`, its fence,
// commit and wait, and the two `wgmma.mma_async` forms the envelope probe's
// P2 issues (envelope.cu): m64n128k16 bf16 and m64n128k8 tf32, A from
// registers.  No CUTLASS or CuTe header is included.
//
// A warpgroup is four consecutive warps (128 threads, the first warp's
// index a multiple of 4).  One m64nNk* product covers a 64 x N tile:
// warp w of the warpgroup owns rows 16w..16w+15, and within a warp the
// fragments are mma.sync's (mma.cuh), g = lane / 4, t = lane % 4:
//   A from registers, k16 bf16: {(g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..),
//     (g+8, 2t+8..)}, the lower column in the low half of a register;
//     k8 tf32: {(g, t), (g+8, t), (g, t+4), (g+8, t+4)};
//   D, N/2 fp32 a thread: d[4j..4j+3] = (g, 8j+2t), (g, 8j+2t+1),
//     (g+8, 8j+2t), (g+8, 8j+2t+1) for each n8 block j.
//
// Operands in shared memory use the canonical K-major layout with the
// 128-byte swizzle (PTX ISA, "Shared memory matrix layout"; CUTLASS's
// Swizzle<3,4,3> o ((8,m),(T,2)):((8T,SBO),(1,T))): a panel of `rows`
// rows (N of B) by K is stored as K/(128 bytes) atoms of
// [rows][128 bytes], one after another; in an atom, the 16-byte unit c
// (0-7) of row r lies at unit c ^ (r % 8) of the row.  Each group of 8
// rows is 1,024 bytes (the stride byte offset, SBO), and every atom
// starts on a 1,024-byte boundary, since the hardware takes the swizzle
// from address bits 4-6 xor 7-9.  A product's k-step reads 32 bytes of
// each row (k16 bf16, k8 tf32): k-step s starts at atom s / 4 plus
// (s % 4) * 32 bytes, which the hardware swizzles like any other address.
// ops/probe_kernels.py mirrors this layout and the descriptor
// (`panel_offset`, `wgmma_desc`), and the CPU tests hold them to the
// swizzle pattern and to each k-step's slice.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {
namespace wgmma {

constexpr int kAtomBytes = 128;    // bytes of a row in one swizzle atom
constexpr int kGroupBytes = 1024;  // 8 rows of an atom: the SBO

// Byte offset of 16-byte unit c (along K) of row r in a swizzled K-major
// panel of `rows` rows.
__device__ __forceinline__ uint32_t unit_offset(int r, int c, int rows) {
  return (uint32_t)((c >> 3) * rows * kAtomBytes + r * kAtomBytes +
                    (((c & 7) ^ (r & 7)) << 4));
}

// Descriptor of a K-major, 128-byte-swizzled operand at shared address
// `addr`: start address >> 4 in bits 0-13, leading byte offset 1 (unused
// by swizzled K-major layouts) in bits 16-29, SBO >> 4 in bits 32-45,
// base offset 0 (atoms 1,024-byte aligned) in bits 49-51, layout 1
// (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(kGroupBytes >> 4) << 32) | ((uint64_t)1 << 62);
}

// The descriptor of k-step s of a panel of `rows` rows at `base`.
__device__ __forceinline__ uint64_t kstep_desc(uint32_t base, int s,
                                               int rows) {
  return desc(base + (s >> 2) * rows * kAtomBytes + (s & 3) * 32);
}

// Orders this thread's earlier register (and, with fence_proxy_async,
// shared-memory) writes before the products issued after it.
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pins registers in place around the asynchronous products: the compiler
// sees them read and written here, so it neither reads an accumulator
// before the wait that completes it nor moves a write of an A fragment
// above the wait that frees it.
template <int N>
__device__ __forceinline__ void fence_operand(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operand(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d += a @ b over one k-step of a 64 x 128 tile, fp32 sums: A from
// registers, B from shared memory through its descriptor, K-major (no
// transpose).
__device__ __forceinline__ void mma_bf16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

__device__ __forceinline__ void mma_tf32(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

}  // namespace wgmma
}  // namespace
