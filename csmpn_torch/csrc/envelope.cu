// P1-P3 — the envelope probe's kernels on Hopper (sm_90a): a scaled copy,
// a resident matrix product on the tensor cores (or the CUDA cores), and a
// dependent FMA chain.  Together they measure what this card delivers to a
// stream, to `mma.sync` and to FFMA, so that a kernel's bound can be set
// against the card's own envelope beside the data sheet's.
//
// Replaces: tools/mxu_probe.py, the three Pallas kernels of the TPU's
// envelope probe:
//   P1 `copy.kernel` (:87)      o = x * 2 over (R, 256) float32 in row tiles;
//   P2 `resident.kernel` (:112) acc += a @ b, `reps` times, with
//                               a <- a + a * 1e-7 in the operand type
//                               between reps, operands resident on chip;
//   P3 `vpu.kernel` (:150)      v <- v * 1.0001 + 0.001, 256 times.
//
// Bounds on this card (the data sheet's H100 SXM rates):
//   P1 memory: 8 bytes moved per element for one multiply, so the least
//      time is 2 * R * 256 * 4 bytes over 3.35 TB/s (80.1 us at R = 131,072).
//   P2 operations: 2 * M * K * N * reps over 989 TFLOP/s (bf16), 495 (tf32)
//      or 67 (fp32 outside the tensor cores); the operands are read once.
//   P3 operations: two per FMA over 67 TFLOP/s; its bytes take a third of that.
//
// Design.
//   P1: one CTA per tile of `tile_rows` rows (the TPU probe's tile heights),
//      16-byte loads and stores, eight loads in flight per thread.  Small
//      tiles give many CTAs per SM, which is what a stream needs to keep
//      enough bytes in flight; the large ones show what too few CTAs cost.
//   P2: one CTA per 64 x 128 output tile (512 x 2048 -> 128 CTAs on 132
//      SMs).  The CTA stages its A panel (64 x K) and its B panel (K x 128,
//      stored transposed) in shared memory once, in the operand type; every
//      rep reads the fragments from there, so nothing streams from device
//      memory inside the rep loop.  Between reps the CTA perturbs its A
//      panel in place, rounded in the operand type as the TPU probe does,
//      behind two barriers.  Rows are padded so that a fragment load (8
//      rows of 16 bytes) hits 32 distinct banks.
//        bf16: mma.sync m16n8k16 bf16 -> f32 (the probe's bf16 DEFAULT);
//        tf32: mma.sync m16n8k8 tf32 -> f32, operands rounded by
//              cvt.rna.tf32.f32 (what an fp32 product becomes with TF32
//              allowed: the probe's f32 DEFAULT);
//      16 warps of 16 x 32 outputs, fragments by ldmatrix, one depth step
//      loaded ahead: of the warp tilings tried on the H100 (16 x 16 to
//      64 x 32 outputs a warp, 4 to 32 warps, with and without ldmatrix)
//      the fastest, though none came near the data sheet's rate.
//        fp32: FFMA on the CUDA cores (the probe's f32 HIGHEST): A panel
//              transposed, 8 warps, each thread an 8 x 4 block of the
//              tile, 2 + 1 16-byte shared loads per 32 FMAs.
//      mma.sync is not wgmma: it is not expected to reach the data sheet's
//      tensor-core rates, which are wgmma figures.
//   P3: each thread carries 8 independent elements (two float4) through
//      the dependent chain, so a warp has 8 FMAs to issue per step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------------ P1

constexpr int kCopyThreads = 256;
constexpr int kCopyUnroll = 8;

__global__ void __launch_bounds__(kCopyThreads)
copy_scale_kernel(const float4* __restrict__ x, float4* __restrict__ o,
                  int64_t rows, int row_vec, int tile_rows) {
  const int64_t r0 = (int64_t)blockIdx.x * tile_rows;
  const int64_t r1 = r0 + tile_rows < rows ? r0 + tile_rows : rows;
  const int64_t base = r0 * row_vec;
  const int64_t n = (r1 - r0) * row_vec;
  for (int64_t i = threadIdx.x; i < n; i += kCopyThreads * kCopyUnroll) {
    float4 v[kCopyUnroll];
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) {
      const int64_t j = i + u * kCopyThreads;
      v[u] = j < n ? __ldg(x + base + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) {
      const int64_t j = i + u * kCopyThreads;
      if (j < n)
        o[base + j] = make_float4(v[u].x * 2.f, v[u].y * 2.f, v[u].z * 2.f,
                                  v[u].w * 2.f);
    }
  }
}

// ------------------------------------------------------------------ P2

constexpr int kTileM = 64;
constexpr int kTileN = 128;
constexpr int kMmaWarpsN = 4;      // mma: 4 x 4 warps of 16 x 32 outputs
constexpr int kMmaThreads = 32 * (kTileM / 16) * kMmaWarpsN;
constexpr int kFfmaThreads = 256;  // FFMA: 8 warps of 8 x 128 outputs
constexpr float kEps = 1e-7f;      // the probe's perturbation

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// Four 8 x 8 matrices of 16-bit elements (or 8 x 4 of 32-bit) from shared
// memory, lanes 8j..8j+7 giving the row addresses of matrix j: register j
// then holds, at lane 4g + t, row g and elements 2t, 2t + 1 of matrix j.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The operand type of each mode: bf16 values, or fp32 values (tf32 mode
// rounds them to tf32 where they enter the tensor cores; B, which never
// changes, is rounded once when it is staged).  perturb() applies
// a <- a + a * eps to 16 bytes of A, each operation rounded in the
// operand type.
template <bool TF32> struct Operand;
template <> struct Operand<false> {
  using T = __nv_bfloat16;
  static constexpr int kStep = 16;   // mma depth
  static constexpr int kPad = 8;     // row stride K + 8 halves: 4 words mod 32
  __device__ static T cvt_b(float x) { return __float2bfloat16_rn(x); }
  __device__ static void store4(T* p, float4 v) {   // p 8-byte aligned
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  }
  // bf16 products and sums, each rounded to bf16 (a * 1e-7 lies below
  // half an ulp of a, so a keeps its value, as on the TPU)
  __device__ static void perturb(uint4& v) {
    const __nv_bfloat162 eps = __float2bfloat162_rn(kEps);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __hadd2(h[i], __hmul2(h[i], eps));
  }
};
template <> struct Operand<true> {
  using T = float;
  static constexpr int kStep = 8;
  static constexpr int kPad = 4;     // row stride K + 4 words: 4 mod 32
  __device__ static T cvt_b(float x) { return __uint_as_float(to_tf32(x)); }
  __device__ static void store4(T* p, float4 v) {   // p 16-byte aligned
    *reinterpret_cast<float4*>(p) = v;
  }
  __device__ static void perturb(uint4& v) {
    float* f = reinterpret_cast<float*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __fadd_rn(f[i], __fmul_rn(f[i], kEps));
  }
};

// One warp's operand fragments for one mma depth step: one m16 tile of A
// and four n8 tiles of B.  Fragment layouts of mma.sync (PTX ISA, "Matrix
// fragments for mma.m16n8k16 / m16n8k8"), g = lane / 4, t = lane % 4:
//   A m16 x k16 bf16: {(g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)}
//   B k16 x n8 bf16:  {(2t..2t+1, g), (2t+8.., g)}
//   A m16 x k8 tf32:  {(g, t), (g+8, t), (g, t+4), (g+8, t+4)}
//   B k8 x n8 tf32:   {(t, g), (t+4, g)}
//   C m16 x n8 f32:   {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}
// Each is four (A) or two (B) 8 x 8 matrices of 16-bit elements: ldmatrix
// loads A's four in one instruction (rows 0-7 / 8-15 at depth 0 / 8 halves,
// 16 bytes) and two n8 tiles of B in another, B being stored transposed.
// In tf32 the same 16 bytes hold 4 floats, which is the tf32 layout.
struct Frags {
  uint32_t a[4];
  uint32_t b[4][2];
};

// As and Bs point at the warp's first A row and first B column (a row of
// B transposed), at depth k0.
template <bool TF32, typename T>
__device__ __forceinline__ void load_frags(Frags& f, const T* As, const T* Bs,
                                           int ld, int lane) {
  const char* pa = reinterpret_cast<const char*>(As + (lane & 15) * ld) +
                   (lane >> 4) * 16;
  ldsm4(f.a, pa);
  if constexpr (TF32) {
#pragma unroll
    for (int q = 0; q < 4; ++q) f.a[q] = to_tf32(__uint_as_float(f.a[q]));
  }
  const int j = lane >> 3;   // (n tile, depth half) of the matrix addressed
#pragma unroll
  for (int nt = 0; nt < 4; nt += 2) {
    const char* pb = reinterpret_cast<const char*>(
                         Bs + ((nt + (j >> 1)) * 8 + (lane & 7)) * ld) +
                     (j & 1) * 16;
    uint32_t r[4];
    ldsm4(r, pb);
    f.b[nt][0] = r[0];
    f.b[nt][1] = r[1];
    f.b[nt + 1][0] = r[2];
    f.b[nt + 1][1] = r[3];
  }
}

template <bool TF32>
__device__ __forceinline__ void mma_frags(float (&acc)[4][4], const Frags& f) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    if constexpr (TF32)
      mma_tf32(acc[nt], f.a, f.b[nt]);
    else
      mma_bf16(acc[nt], f.a, f.b[nt]);
  }
}

// Staging reads A and B as 16-byte vectors: A along its rows; B with the
// lanes along k, so that the transposed stores are conflict-free.  The
// depth loop holds two fragment sets, loading one step ahead of the
// products (K % (2 * kStep) == 0).
template <bool TF32>
__global__ void __launch_bounds__(kMmaThreads, 1)
resident_mma_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ out, int K, int N, int reps) {
  using Op = Operand<TF32>;
  using T = typename Op::T;
  constexpr int kWarps = kMmaThreads / 32;
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = K + Op::kPad;
  T* As = reinterpret_cast<T*>(smem);   // [kTileM][ld] row-major
  T* Bs = As + kTileM * ld;             // [kTileN][ld]: B transposed
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kTileM; r += kWarps)
    for (int k = lane * 4; k < K; k += 128)
      Op::store4(As + r * ld + k, __ldg(reinterpret_cast<const float4*>(
                                      a + (int64_t)(m0 + r) * K + k)));
  for (int n = warp * 4; n < kTileN; n += kWarps * 4)
    for (int k = lane; k < K; k += 32) {
      const float4 v = __ldg(
          reinterpret_cast<const float4*>(b + (int64_t)k * N + n0 + n));
      Bs[n * ld + k] = Op::cvt_b(v.x);
      Bs[(n + 1) * ld + k] = Op::cvt_b(v.y);
      Bs[(n + 2) * ld + k] = Op::cvt_b(v.z);
      Bs[(n + 3) * ld + k] = Op::cvt_b(v.w);
    }
  __syncthreads();

  const int wm = (warp / kMmaWarpsN) * 16, wn = (warp % kMmaWarpsN) * 32;
  const T* Aw = As + wm * ld;
  const T* Bw = Bs + wn * ld;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  constexpr int S = Op::kStep;
  for (int rep = 0; rep < reps; ++rep) {
    Frags f0, f1;
    load_frags<TF32>(f0, Aw, Bw, ld, lane);
    for (int k0 = 0; k0 < K; k0 += 2 * S) {
      load_frags<TF32>(f1, Aw + k0 + S, Bw + k0 + S, ld, lane);
      mma_frags<TF32>(acc, f0);
      if (k0 + 2 * S < K)
        load_frags<TF32>(f0, Aw + k0 + 2 * S, Bw + k0 + 2 * S, ld, lane);
      mma_frags<TF32>(acc, f1);
    }
    if (rep + 1 < reps) {   // the last rep's perturbation is never read
      __syncthreads();
      for (int r = warp; r < kTileM; r += kWarps)
        for (int k = lane * kVec; k < K; k += 32 * kVec) {
          uint4* p = reinterpret_cast<uint4*>(As + r * ld + k);
          uint4 v = *p;
          Op::perturb(v);
          *p = v;
        }
      __syncthreads();
    }
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int r = m0 + wm + g, c = n0 + wn + nt * 8 + 2 * t;
    *reinterpret_cast<float2*>(out + (int64_t)r * N + c) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(out + (int64_t)(r + 8) * N + c) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// fp32 on the CUDA cores: warp w owns rows 8w..8w+7 of the tile, lane l
// columns 4l..4l+3; per k a warp reads its 8 A values (a broadcast) and
// 128 B values (one 16-byte load a lane).
__global__ void __launch_bounds__(kFfmaThreads, 1)
resident_ffma_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ out, int K, int N, int reps) {
  constexpr int kWarps = kFfmaThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* At = reinterpret_cast<float*>(smem);   // [K][kTileM]: A transposed
  float* Bs = At + K * kTileM;                  // [K][kTileN]
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = warp * 4; k < K; k += kWarps * 4)
    for (int r = lane; r < kTileM; r += 32) {
      const float4 v = __ldg(
          reinterpret_cast<const float4*>(a + (int64_t)(m0 + r) * K + k));
      At[k * kTileM + r] = v.x;
      At[(k + 1) * kTileM + r] = v.y;
      At[(k + 2) * kTileM + r] = v.z;
      At[(k + 3) * kTileM + r] = v.w;
    }
  for (int i = threadIdx.x; i < K * kTileN / 4; i += kFfmaThreads) {
    const int k = i / (kTileN / 4), n = (i % (kTileN / 4)) * 4;
    reinterpret_cast<float4*>(Bs)[i] =
        __ldg(reinterpret_cast<const float4*>(b + (int64_t)k * N + n0 + n));
  }
  __syncthreads();

  const int r0 = warp * 8, c0 = lane * 4;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int rep = 0; rep < reps; ++rep) {
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float4 lo = *reinterpret_cast<const float4*>(At + k * kTileM + r0);
      const float4 hi =
          *reinterpret_cast<const float4*>(At + k * kTileM + r0 + 4);
      const float4 bv = *reinterpret_cast<const float4*>(Bs + k * kTileN + c0);
      const float av[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    if (rep + 1 < reps) {
      __syncthreads();
      for (int i = threadIdx.x; i < K * kTileM / 4; i += kFfmaThreads) {
        uint4 v = reinterpret_cast<uint4*>(At)[i];
        Operand<true>::perturb(v);
        reinterpret_cast<uint4*>(At)[i] = v;
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    *reinterpret_cast<float4*>(out + (int64_t)(m0 + r0 + i) * N + n0 + c0) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// ------------------------------------------------------------------ P3

constexpr int kChainThreads = 256;

__device__ __forceinline__ void chain4(float4& v) {
  v.x = fmaf(v.x, 1.0001f, 0.001f);
  v.y = fmaf(v.y, 1.0001f, 0.001f);
  v.z = fmaf(v.z, 1.0001f, 0.001f);
  v.w = fmaf(v.w, 1.0001f, 0.001f);
}

// thread i carries float4 i and float4 i + half (coalesced in both halves)
__global__ void __launch_bounds__(kChainThreads)
fma_chain_kernel(const float4* __restrict__ x, float4* __restrict__ o,
                 int64_t half, int steps) {
  const int64_t i = (int64_t)blockIdx.x * kChainThreads + threadIdx.x;
  if (i >= half) return;
  float4 u = __ldg(x + i), v = __ldg(x + i + half);
  for (int s = 0; s < steps; ++s) {
    chain4(u);
    chain4(v);
  }
  o[i] = u;
  o[i + half] = v;
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError().

// o = 2 * x, x and o (rows, cols) float32, cols % 4 == 0, 16-byte aligned.
extern "C" int csmpn_probe_copy(const float* x, float* o, int64_t rows,
                                int cols, int tile_rows, void* stream) {
  if (rows > 0) {
    const int64_t grid = (rows + tile_rows - 1) / tile_rows;
    copy_scale_kernel<<<(unsigned)grid, kCopyThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(o),
        rows, cols / 4, tile_rows);
  }
  return cudaGetLastError();
}

// out (m, n) = sum over reps of a_r @ b, a (m, k) and b (k, n) float32 read
// once; mode 0 bf16 mma.sync, 1 tf32 mma.sync, 2 fp32 FFMA.  m % 64 == 0,
// n % 128 == 0, k % 32 == 0, and the panels fit shared memory (the wrapper
// checks; ops/probe_kernels.resident_smem_bytes mirrors the sizes here).
extern "C" int csmpn_probe_resident(const float* a, const float* b, float* out,
                                    int m, int k, int n, int reps, int mode,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = kTileM + kTileN;
  const int bytes = mode == 0   ? rows * (k + Operand<false>::kPad) * 2
                    : mode == 1 ? rows * (k + Operand<true>::kPad) * 4
                                : rows * k * 4;
  const dim3 grid(n / kTileN, m / kTileM);
  if (m > 0 && n > 0) {
    if (mode == 0) {
      cudaFuncSetAttribute(resident_mma_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      resident_mma_kernel<false><<<grid, kMmaThreads, bytes, st>>>(a, b, out, k,
                                                                   n, reps);
    } else if (mode == 1) {
      cudaFuncSetAttribute(resident_mma_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      resident_mma_kernel<true><<<grid, kMmaThreads, bytes, st>>>(a, b, out, k,
                                                                  n, reps);
    } else {
      cudaFuncSetAttribute(resident_ffma_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      resident_ffma_kernel<<<grid, kFfmaThreads, bytes, st>>>(a, b, out, k, n,
                                                             reps);
    }
  }
  return cudaGetLastError();
}

// o = x after `steps` of v <- fma(v, 1.0001, 0.001), n % 8 == 0 elements.
extern "C" int csmpn_probe_fma_chain(const float* x, float* o, int64_t n,
                                     int steps, void* stream) {
  const int64_t half = n / 8;
  if (half > 0) {
    const int64_t grid = (half + kChainThreads - 1) / kChainThreads;
    fma_chain_kernel<<<(unsigned)grid, kChainThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(o), half,
        steps);
  }
  return cudaGetLastError();
}
