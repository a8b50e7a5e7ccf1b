// K2p in fast mode: the pair-form CEMLP block forward in row tiles, with
// the channel-mixing linears on the tensor cores.  cemlp_pair_kernels.cuh
// launches it for a fast-mode forward at Cl(5,0) and Cl(4,0); exact mode
// keeps that file's row kernel (fp32 throughout).
//
// Replaces (with the row kernel): csmpn_tpu/ops/cemlp_kernel.py,
// `_fwd_kernel` in its pair form (`_pair_form`, `_gp_pair_fwd`): one
// block's output from its input rows.
//
// Bound on this card: at the hulls widths (34 -> 28 channels, Cl(5)) a row
// reads 4.4 KB of x and writes 3.6 KB: the byte bound is 31 us at 13,184
// rows.  The work: three channel-mixing linears (~2 x 32 x 28 x 90 FLOP a
// row) on the tensor cores, and the pair product, 1,024 terms a (row,
// channel), each two fp32 products, a bf16 rounding and an add: bound by
// the instruction rate of the FP32 and conversion pipes, ~4 instructions
// a term.
//
// A CTA step takes 256 (row, blade) pairs, R = 8 rows at Cl(5) and 16 at
// Cl(4), a warp a row; its tiles and its phases for the linears are the
// backward's (cemlp_pair_tile.cuh, shared; the backward's step is half as
// many rows on 12 and 8 warps):
//   x    the step's rows of x, rounded to bf16, into the x tile;
//   F1   Y = X W1 on the tensor cores -> fa;
//   S1   MVSiLU, a thread per (row, channel) -> z (bf16);
//   F2   YR = z Wr -> fb, FI = z WL -> fa;
//   row  (first, the CTA's next step's rows of x are prefetched into L2,
//        which took 3.7% off the hulls edge block: PERF.md) a warp per
//        row, a thread per channel (the lane): the tile rows
//        [r (NB + 1) + i][channel] are read without bank conflicts.  The
//        thread holds the row's NB blades of z, of the normalised right
//        operand yn and of the product in registers and runs the Cayley
//        terms of pair_terms.cuh, unrolled at compile time (left blade,
//        right blade, sign and path are constants: no table loads, no
//        shuffles); the terms come sorted by path, so the path weight is
//        one shared-memory load a path, not a term.  A term is rounded to
//        bf16 by one `cvt.rn.bf16x2.f32` against a zero, whose upper half
//        is the rounded value as fp32 (two terms a conversion, unpacked by
//        integer operations, ran slower, and the conversions are what the
//        pair phase waits on: PERF.md).  The output o (pre-norm)
//        overwrites fa; the layer norm's channel mean is a warp sum, and
//        the warp writes its row of y as float4s, coalesced.
// Every warp runs the same unrolled code at about the same time (three
// warps a row, each on a third of the output blades, ran slower: PERF.md).
//
// Precision: the rounding points of the plain fast version and the row
// kernel: x, z, the weights and each pair term (z_i yn_k) w to bf16 (the
// path weight fp32), yn rounded, the grade and blade sums of rounded
// squares; fp32 accumulation.  The pair sum of an output blade runs in
// path order, not in right-blade order: only the order of fp32 sums
// differs.  Every sum has one owner (a thread, or the row's warp in a fixed
// order): no atomics, bitwise repeatable.
//
// Shared memory: the backward's weights, parameters, row lists, x, z, fa
// and fb tiles, ~110 KB at the hulls widths.  At every width the row
// kernel takes, this kernel fits (chip_smoke.py checks).
#pragma once

#include <utility>

#include "cemlp_pair_tile.cuh"
#include "pair_terms.cuh"

namespace {

// The forward's step: 256 (row, blade) pairs, a warp a row.
constexpr int PT_FWD_PAIRS = 256;
template <class A>
using PFwd = PTile<A, PT_FWD_PAIRS / A::NB, PT_FWD_PAIRS / A::NB>;

// v rounded to bf16, as an fp32 value: one conversion, whose packed pair's
// upper half is v's bf16 and lower half a zero's.
__device__ __forceinline__ float rnd_bf16(float v) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(v), "f"(0.f));
  return __uint_as_float(r);
}

// Term Q of the pair product, added into its output blade's sum; the
// path's weight w is loaded at the first term of each path (gw: the path
// weights of this channel, a path every fp floats).
template <class T, int NB, int Q>
__device__ __forceinline__ void pair_term(float (&gp)[NB],
                                          const float (&z)[NB],
                                          const float (&yn)[NB],
                                          const float* gw, int fp,
                                          float& w) {
  constexpr int e = T::term(Q);
  if constexpr (((e >> 23) & 1) != 0) w = gw[((e >> 16) & 127) * fp];
  const float t = rnd_bf16((z[(e >> 10) & 31] * yn[(e >> 5) & 31]) * w);
  if constexpr (((e >> 15) & 1) != 0)
    gp[e & 31] -= t;
  else
    gp[e & 31] += t;
}

template <class T, int NB, int... Q>
__device__ __forceinline__ void pair_terms(float (&gp)[NB],
                                           const float (&z)[NB],
                                           const float (&yn)[NB],
                                           const float* gw, int fp,
                                           std::integer_sequence<int, Q...>) {
  float w = 0.f;
  (pair_term<T, NB, Q>(gp, z, yn, gw, fp, w), ...);
}

// Row r's o at channel n over fa; returns the channel's layer-norm term
// sqrt(sqrt(qc^2 + 1e-16)), qc the sum of its blades' rounded squares.
template <class A>
__device__ __forceinline__ float pair_fwd_channel(const PBufs<A>& b,
                                                  const PLayout& L,
                                                  const Tabs<A>& tb, int r,
                                                  int n) {
  using T = PairTerms<A::NB>;
  constexpr int NB = A::NB, NG = A::NG;
  const int c = L.c, fp = L.fp, t0 = r * (NB + 1);
  // the right operand's grade-norm normalisation, rounded
  float yn[NB], qg[NG], den[NG];
#pragma unroll
  for (int i = 0; i < NB; ++i) yn[i] = b.fb[(t0 + i) * fp + n];
#pragma unroll
  for (int g = 0; g < NG; ++g) qg[g] = 0.f;
#pragma unroll
  for (int i = 0; i < NB; ++i)
    qg[A::grade(i)] += rnd<true>(yn[i] * yn[i] * tb.bc[i]);
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const float s1g = sqrtf(qg[g] * qg[g] + 1e-16f);
    den[g] = b.nsig[g * c + n] * (sqrtf(s1g) - 1.f) + 1.f + EPS;
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) yn[i] = rnd<true>(yn[i] / den[A::grade(i)]);
  float z[NB];
  const unsigned short* zt =
      reinterpret_cast<const unsigned short*>(b.z) + t0 * L.ldc + n;
#pragma unroll
  for (int i = 0; i < NB; ++i)
    z[i] = __uint_as_float((uint32_t)zt[i * L.ldc] << 16);
  float gp[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) gp[j] = 0.f;
  pair_terms<T, NB>(gp, z, yn, b.gw + n, fp,
                    std::make_integer_sequence<int, NB * NB>{});
  float qc = 0.f;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    float* f = b.fa + (t0 + j) * fp + n;
    const float first = *f + (j == 0 ? b.bl[n] : 0.f);
    const float o = (first + gp[j]) * SQRT2_INV;
    *f = o;
    qc += rnd<true>(o * o * tb.bc[j]);
  }
  return sqrtf(sqrtf(qc * qc + 1e-16f));
}

template <class A>
__global__ void __launch_bounds__(PFwd<A>::THREADS, 1)
cemlp_pair_fwd_tile_kernel(const float* __restrict__ x, Params p,
                           Tabs<A> tb, float* __restrict__ out, int rows,
                           int cin, int c) {
  using P = PFwd<A>;
  constexpr int NB = A::NB, R = P::R;
  static_assert(P::WARPS == R, "a warp a row");
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const PLayout L = pair_tile_layout<A, P>(cin, c, true);
  const PBufs<A> b = carve_pbufs<A>(base, L);
  stage_pair_tile<A, true, P>(p, nullptr, b, L, base);
  const int warp = threadIdx.y, lane = threadIdx.x;
  const int per = c * NB;   // floats of an output row

  const int n_steps = (rows + R - 1) / R;
  for (int step = blockIdx.x; step < n_steps; step += gridDim.x) {
    const int64_t row0 = (int64_t)step * R;
    const int nrow = rows - row0 < R ? (int)(rows - row0) : R;
    __syncthreads();   // the previous step's rows are written
    load_pair_x<A, P>(x, b, L, row0, nrow);
    __syncthreads();
    pt_f1<A, P>(b, L, c, warp, lane);  // Y = X W1 -> fa
    __syncthreads();
    pt_s1<A, P>(b, L, tb, c, nrow);  // MVSiLU -> z
    __syncthreads();
    pt_f2<A, P>(b, L, c, warp, lane);  // YR = z Wr -> fb, FI = z WL -> fa
    __syncthreads();
    {   // the CTA's next step's rows of x into L2 while the rows compute
      const int64_t nx = (int64_t)(step + gridDim.x) * R;
      if (nx < rows) {
        const int nr = rows - nx < R ? (int)(rows - nx) : R;
        const char* xn = reinterpret_cast<const char*>(x + nx * cin * NB);
        const int lines = (nr * cin * NB * 4 + 127) / 128;
        for (int q = threadIdx.x + 32 * warp; q < lines; q += P::THREADS)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(xn + 128 * q));
      }
    }
    // ---- row `warp`: the pair product and o, a lane a channel; the layer
    // norm's divisor, channels in lane order; y = aln / m * o
    if (warp < nrow) {
      float tot = 0.f;
      for (int n = lane; n < c; n += 32)
        tot += pair_fwd_channel<A>(b, L, tb, warp, n);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tot += __shfl_xor_sync(0xffffffffu, tot, off);
      const float mden = tot / (float)c + EPS;
      __syncwarp();
      float4* dst = reinterpret_cast<float4*>(out + (row0 + warp) * per);
      for (int e4 = lane; e4 < per / 4; e4 += 32) {
        const int n = 4 * e4 / NB, j = 4 * e4 % NB;
        const float s = b.aln[n] / mden;
        const float* f = b.fa + (warp * (NB + 1) + j) * L.fp + n;
        dst[e4] = make_float4(s * f[0], s * f[L.fp], s * f[2 * L.fp],
                              s * f[3 * L.fp]);
      }
    }
  }
}

// Shared-memory bytes of a launch; 0 where the widths do not fit.
template <class A>
size_t pair_fwd_tile_smem_bytes(int cin, int c) {
  if (cin < 1 || c < 1) return 0;
  const size_t n = pair_tile_layout<A, PFwd<A>>(cin, c, true).total;
  return n > kMaxSmem ? 0 : n;
}

template <class A>
int launch_pair_tile_fwd(const float* x, const Params& p, const Tabs<A>& tb,
                         float* out, int rows, int cin, int c, int grid,
                         cudaStream_t st) {
  const size_t bytes = pair_fwd_tile_smem_bytes<A>(cin, c);
  if (bytes == 0) return (int)cudaErrorInvalidValue;
  if (rows > 0) {
    cudaFuncSetAttribute(cemlp_pair_fwd_tile_kernel<A>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    cemlp_pair_fwd_tile_kernel<A><<<grid, dim3(32, PFwd<A>::WARPS), bytes,
                                    st>>>(x, p, tb, out, rows, cin, c);
  }
  return (int)cudaGetLastError();
}

}  // namespace
