// One CEMLP block for one row per warp: the exact-mode device code shared
// by the block kernels (cemlp.cu, K2 and K3 at Cl(3,0) and Cl(2,0)) and
// the fused message-passing kernels (fused_egcl.cu, K4 and K5 at Cl(3,0)
// and Cl(2,0)); fast mode is the row tiles of cemlp_tile.cuh, which share
// this file's algebra traits, tables and constants.
//
// A block is
//     MVLinear -> MVSiLU -> SGP (right linear, grade-norm normalisation,
//     geometric product, + left linear, / sqrt 2) -> MVLayerNorm,
// the function of `_post_linear_math` and of the composed layers in
// csmpn_tpu/nn/modules.py.
//
// The algebra is a traits type (Cl3, Cl2): its blade count NB, grades NG,
// nonzero grade paths NP, the short-lex blade bitmap and the grade-path
// index.  A lane owns A::SLOTS output channels of the row, lane and
// lane + 32: one slot at Cl(3) (up to 32 channels), two at Cl(2) (up to
// 64), where two 4-blade channels hold the floats of one 8-blade channel.
//
//   * the three channel-mixing linears (W1, Wr, WL) are per-grade FMA
//     loops over the input channels, reading the row from shared memory as
//     a broadcast and the weights as a conflict-free lane-contiguous run;
//   * the grade sums, the normalisation and the geometric product are done
//     in registers per (row, channel): the product uses the Cayley pair
//     structure — for each (output j, right k) exactly one left blade
//     i = i_of(j, k) with one sign — NB^2 FMAs instead of an NB^3 table;
//   * the layer norm's channel mean sums a lane's slots, then reduces over
//     the warp with shuffles.
//
// The exact backward of a row (`block_backward_row`) recomputes nothing:
// it takes the row's forward state and its output cotangent, writes dx for
// the row and the row's cotangents into shared-memory tiles, and adds the
// per-channel parameter gradients into registers (`Acc`).  The
// channel-mixing weight gradients are summed over a tile of rows by
// `weight_grads`, each entry owned by one thread.
//
// Precision: fp32 throughout.  `rnd<true>` is the bf16 rounding of the
// fast-mode row tiles.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;        // rows (warps) per CTA
constexpr int THREADS = 32 * ROWS;
constexpr int NQ = 4;          // output channels per thread, weight grads
constexpr float EPS = 1e-6f;
constexpr float SQRT2_INV = 0.70710678118654752440f;
constexpr size_t kMaxSmem = 232448;   // 227 KB opt-in per block

// Cl(3,0): blades 1, e1, e2, e3, e12, e13, e23, e123 (short-lex).
struct Cl3 {
  static constexpr int NB = 8, NG = 4, NP = 20, SLOTS = 1;
  // short-lex blade index <-> bitmap (self-inverse)
  __host__ __device__ static constexpr int bitmap(int i) {
    return i == 3 ? 4 : (i == 4 ? 3 : i);
  }
  // index of the grade path (left a, output b, right c) among the 20
  // nonzero paths, in lexicographic order (numpy argwhere of
  // geometric_product_paths); the host checks it against the algebra.  An
  // explicit switch: nvcc's host compiler mis-evaluated a loop-built one.
  __host__ __device__ static constexpr int path_id(int a, int b, int c) {
    switch (a * 16 + b * 4 + c) {
      case 0: return 0;    // (0,0,0)
      case 5: return 1;    // (0,1,1)
      case 10: return 2;   // (0,2,2)
      case 15: return 3;   // (0,3,3)
      case 17: return 4;   // (1,0,1)
      case 20: return 5;   // (1,1,0)
      case 22: return 6;   // (1,1,2)
      case 25: return 7;   // (1,2,1)
      case 27: return 8;   // (1,2,3)
      case 30: return 9;   // (1,3,2)
      case 34: return 10;  // (2,0,2)
      case 37: return 11;  // (2,1,1)
      case 39: return 12;  // (2,1,3)
      case 40: return 13;  // (2,2,0)
      case 42: return 14;  // (2,2,2)
      case 45: return 15;  // (2,3,1)
      case 51: return 16;  // (3,0,3)
      case 54: return 17;  // (3,1,2)
      case 57: return 18;  // (3,2,1)
      case 60: return 19;  // (3,3,0)
      default: return -1;
    }
  }
};

// Cl(2,0): blades 1, e1, e2, e12 (short-lex order is the bitmap order).
struct Cl2 {
  static constexpr int NB = 4, NG = 3, NP = 10, SLOTS = 2;
  __host__ __device__ static constexpr int bitmap(int i) { return i; }
  __host__ __device__ static constexpr int path_id(int a, int b, int c) {
    switch (a * 16 + b * 4 + c) {
      case 0: return 0;    // (0,0,0)
      case 5: return 1;    // (0,1,1)
      case 10: return 2;   // (0,2,2)
      case 17: return 3;   // (1,0,1)
      case 20: return 4;   // (1,1,0)
      case 22: return 5;   // (1,1,2)
      case 25: return 6;   // (1,2,1)
      case 34: return 7;   // (2,0,2)
      case 37: return 8;   // (2,1,1)
      case 40: return 9;   // (2,2,0)
      default: return -1;
    }
  }
};

template <class A>
__host__ __device__ constexpr int grade(int i) {
  return (A::bitmap(i) & 1) + ((A::bitmap(i) >> 1) & 1) +
         ((A::bitmap(i) >> 2) & 1);
}
// the one left blade contributing to (output j, right k)
template <class A>
__host__ __device__ constexpr int i_of(int j, int k) {
  return A::bitmap(A::bitmap(j) ^ A::bitmap(k));
}

// Rows of the per-channel gradient block `loc` ([N][C]): b1, silu.a (NG),
// silu.b (NG), gp.weight (NP), d sigmoid(normalization.a) (NG), bL, ln.a.
template <class A>
struct Loc {
  static constexpr int B1 = 0, SA = 1, SB = SA + A::NG, GW = SB + A::NG,
                       NS = GW + A::NP, BL = NS + A::NG, ALN = BL + 1,
                       N = ALN + 1;
};

template <class A>
struct Tabs {
  float bc[A::NB];            // quadratic-form coefficient per blade
  float sign[A::NB * A::NB];  // Cayley sign of the pair (j, k)
};

template <bool FAST>
__device__ __forceinline__ float rnd(float x) {
  if (FAST) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Output channel of slot u of this lane, clamped into [0, c): lanes past
// the last channel compute on a valid one and are masked out of every
// result.
__device__ __forceinline__ int slot_channel(int lane, int u, int c) {
  const int n = lane + 32 * u;
  return n < c ? n : c - 1;
}

// Block parameters staged in shared memory.  Channel-mixing weights are
// laid out [m][g][n] with an odd pitch per input channel m, so that lanes
// along n (forward) and lanes along m (backward) both hit distinct banks.
struct Smem {
  float *w1, *wr, *wl;             // [m * pm + g * C + n]
  float *b1, *ra, *sb, *nsig, *gw, *bl, *aln;
  int pm1, pm;
};

template <class A>
__host__ __device__ inline int params_floats(int cin, int c) {
  return cin * (A::NG * c + 1) + 2 * c * (A::NG * c + 1) +
         c * (3 + 3 * A::NG + A::NP);
}

template <class A>
__device__ inline void carve_params(float* base, int cin, int c, Smem& s) {
  s.pm1 = A::NG * c + 1;
  s.pm = A::NG * c + 1;
  s.w1 = base;
  s.wr = s.w1 + cin * s.pm1;
  s.wl = s.wr + c * s.pm;
  s.b1 = s.wl + c * s.pm;
  s.ra = s.b1 + c;
  s.sb = s.ra + A::NG * c;
  s.nsig = s.sb + A::NG * c;
  s.gw = s.nsig + A::NG * c;
  s.bl = s.gw + A::NP * c;
  s.aln = s.bl + c;
}

struct Params {
  const float *w1, *b1, *sa, *sb, *gw, *wr, *na, *wl, *bl, *aln;
};

template <class A>
__device__ void stage_params(const Params& p, const Smem& s, int cin, int c) {
  constexpr int NG = A::NG, NP = A::NP;
  const int tid = threadIdx.x + 32 * threadIdx.y;
  for (int e = tid; e < c * cin * NG; e += THREADS) {   // flax (n, m, g)
    const int g = e % NG, m = (e / NG) % cin, n = e / (NG * cin);
    s.w1[m * s.pm1 + g * c + n] = p.w1[e];
  }
  for (int e = tid; e < c * c * NG; e += THREADS) {
    const int g = e % NG, m = (e / NG) % c, n = e / (NG * c);
    s.wr[m * s.pm + g * c + n] = p.wr[e];
    s.wl[m * s.pm + g * c + n] = p.wl[e];
  }
  for (int e = tid; e < c * NG; e += THREADS) {          // (n, g)
    const int g = e % NG, n = e / NG;
    s.ra[g * c + n] = p.sa[e];
    s.sb[g * c + n] = p.sb[e];
    s.nsig[g * c + n] = 1.f / (1.f + expf(-p.na[e]));
  }
  for (int e = tid; e < c * NP; e += THREADS) {          // (n, path)
    const int q = e % NP, n = e / NP;
    s.gw[q * c + n] = p.gw[e];
  }
  for (int e = tid; e < c; e += THREADS) {
    s.b1[e] = p.b1[e];
    s.bl[e] = p.bl[e];
    s.aln[e] = p.aln[e];
  }
}

// Loads a tile of ROWS input rows, (rows, cin, NB) row-major in global
// memory, into shared memory as [r][i][m].
template <class A>
__device__ void load_x_tile(const float* __restrict__ x, float* xs,
                            int64_t row0, int rows, int cin) {
  constexpr int NB = A::NB;
  const int tid = threadIdx.x + 32 * threadIdx.y;
  const int per_row = cin * NB;
  int nrow = rows - (int)row0;
  nrow = nrow < ROWS ? nrow : ROWS;
  for (int e = tid; e < ROWS * per_row; e += THREADS) {
    const int r = e / per_row, rem = e % per_row;
    const int m = rem / NB, i = rem % NB;
    xs[(r * NB + i) * cin + m] =
        r < nrow ? x[row0 * per_row + e] : 0.f;
  }
}

// Forward state of one (row, channel slot).
template <class A>
struct Fwd {
  float y[A::NB], z[A::NB], zr[A::NB], yr[A::NB], yn[A::NB], ynr[A::NB],
      o[A::NB];
  float inv[A::NG], s[A::NG], qg[A::NG], s1g[A::NG], nr[A::NG], den[A::NG];
  float qc, s1c, nc, m;
};

// Forward of one block for (row of this warp, this lane's channel slots).
// xr is the row's [i][m] tile, zt the row's [i][n] tile for z.  Every lane
// of the warp must call it (shuffle reduction).  The block's output for
// slot u is s.aln[n_u] / f[u].m * f[u].o[i], n_u = slot_channel(lane, u).
template <class A>
__device__ __forceinline__ void block_forward(Fwd<A> (&f)[A::SLOTS],
                                              const Smem& s,
                                              const Tabs<A>& tb,
                                              const float* xr, float* zt,
                                              int cin, int c, int lane) {
  constexpr int NB = A::NB, NG = A::NG, S = A::SLOTS;
  int nn[S];
  bool act[S];
#pragma unroll
  for (int u = 0; u < S; ++u) {
    nn[u] = slot_channel(lane, u, c);
    act[u] = lane + 32 * u < c;
  }
  // ---- MVLinear
#pragma unroll
  for (int u = 0; u < S; ++u)
#pragma unroll
    for (int i = 0; i < NB; ++i) f[u].y[i] = 0.f;
  for (int m = 0; m < cin; ++m) {
    float w[S][NG];
#pragma unroll
    for (int u = 0; u < S; ++u)
#pragma unroll
      for (int g = 0; g < NG; ++g) w[u][g] = s.w1[m * s.pm1 + g * c + nn[u]];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const float xv = xr[i * cin + m];
#pragma unroll
      for (int u = 0; u < S; ++u) f[u].y[i] += xv * w[u][grade<A>(i)];
    }
  }
#pragma unroll
  for (int u = 0; u < S; ++u) {
    Fwd<A>& fu = f[u];
    const int n = nn[u];
    fu.y[0] += s.b1[n];
    // ---- MVSiLU: gate per grade from the scalar blade / squared magnitudes
#pragma unroll
    for (int g = 0; g < NG; ++g) fu.inv[g] = 0.f;
    fu.inv[0] = fu.y[0];
#pragma unroll
    for (int i = 1; i < NB; ++i)
      fu.inv[grade<A>(i)] += fu.y[i] * fu.y[i] * tb.bc[i];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float gate = s.ra[g * c + n] * fu.inv[g] + s.sb[g * c + n];
      fu.s[g] = 1.f / (1.f + expf(-gate));
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      fu.z[i] = fu.s[grade<A>(i)] * fu.y[i];
      fu.zr[i] = fu.z[i];
      if (act[u]) zt[i * c + n] = fu.zr[i];
    }
  }
  __syncwarp();
  // ---- right and left linears of the SGP (channel mixing in the row)
  float first[S][NB];
#pragma unroll
  for (int u = 0; u < S; ++u)
#pragma unroll
    for (int i = 0; i < NB; ++i) { f[u].yr[i] = 0.f; first[u][i] = 0.f; }
  for (int m = 0; m < c; ++m) {
    float wr[S][NG], wl[S][NG];
#pragma unroll
    for (int u = 0; u < S; ++u)
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        wr[u][g] = s.wr[m * s.pm + g * c + nn[u]];
        wl[u][g] = s.wl[m * s.pm + g * c + nn[u]];
      }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const float zv = zt[i * c + m];
#pragma unroll
      for (int u = 0; u < S; ++u) {
        f[u].yr[i] += zv * wr[u][grade<A>(i)];
        first[u][i] += zv * wl[u][grade<A>(i)];
      }
    }
  }
  float tot = 0.f;
#pragma unroll
  for (int u = 0; u < S; ++u) {
    Fwd<A>& fu = f[u];
    const int n = nn[u];
    first[u][0] += s.bl[n];
    // ---- grade-norm normalisation of the right operand
#pragma unroll
    for (int g = 0; g < NG; ++g) fu.qg[g] = 0.f;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      fu.qg[grade<A>(i)] += fu.yr[i] * fu.yr[i] * tb.bc[i];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      fu.s1g[g] = sqrtf(fu.qg[g] * fu.qg[g] + 1e-16f);
      fu.nr[g] = sqrtf(fu.s1g[g]);
      fu.den[g] = s.nsig[g * c + n] * (fu.nr[g] - 1.f) + 1.f + EPS;
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      fu.yn[i] = fu.yr[i] / fu.den[grade<A>(i)];
      fu.ynr[i] = fu.yn[i];
    }
    // ---- weighted geometric product, Cayley pair form, + first order
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float gp = 0.f;
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const int i = i_of<A>(j, k);
        const float cw =
            tb.sign[j * NB + k] *
            s.gw[A::path_id(grade<A>(i), grade<A>(j), grade<A>(k)) * c + n];
        gp += cw * fu.zr[i] * fu.ynr[k];
      }
      fu.o[j] = (first[u][j] + gp) * SQRT2_INV;
    }
    // ---- MVLayerNorm: channel mean of the smooth-abs-sqrt norms
    fu.qc = 0.f;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      fu.qc += fu.o[i] * fu.o[i] * tb.bc[i];
    fu.s1c = sqrtf(fu.qc * fu.qc + 1e-16f);
    fu.nc = sqrtf(fu.s1c);
    tot += act[u] ? fu.nc : 0.f;
  }
  const float mean = warp_sum(tot) / (float)c + EPS;
#pragma unroll
  for (int u = 0; u < S; ++u) f[u].m = mean;
}

// Per-channel parameter gradients of one block, summed over the rows this
// thread (warp row, lane channel slot) handled.
template <class A>
struct Acc {
  float b1, bl, aln;
  float sa[A::NG], sb[A::NG], ns[A::NG], gw[A::NP];
};

template <class A>
__device__ __forceinline__ void acc_zero(Acc<A> (&a)[A::SLOTS]) {
#pragma unroll
  for (int u = 0; u < A::SLOTS; ++u) {
    a[u].b1 = 0.f; a[u].bl = 0.f; a[u].aln = 0.f;
#pragma unroll
    for (int g = 0; g < A::NG; ++g) {
      a[u].sa[g] = 0.f; a[u].sb[g] = 0.f; a[u].ns[g] = 0.f;
    }
#pragma unroll
    for (int q = 0; q < A::NP; ++q) a[u].gw[q] = 0.f;
  }
}

// Backward of one block for (row of this warp, this lane's channel slots),
// from the row's forward state f and its output cotangent go (zero for a
// slot past the last channel), in fp32.  Writes the row's cotangents
// d(first) = d(gp), d(yr) and d(y) into its [i][n] tiles dft, drt, dyt
// (read by `weight_grads`), and dx into dxr, laid out [m][i] over the cin
// input channels.  Every lane of the warp must call it.
template <class A>
__device__ __forceinline__ void block_backward_row(
    const Fwd<A> (&f)[A::SLOTS], const Smem& s, const Tabs<A>& tb,
    const float (&go)[A::SLOTS][A::NB], Acc<A> (&a)[A::SLOTS], float* dft,
    float* drt, float* dyt, float* dxr, int cin, int c, int lane) {
  constexpr int NB = A::NB, NG = A::NG, S = A::SLOTS;
  int nn[S];
  bool act[S];
#pragma unroll
  for (int u = 0; u < S; ++u) {
    nn[u] = slot_channel(lane, u, c);
    act[u] = lane + 32 * u < c;
  }
  const float mean = f[0].m;
  // ---- MVLayerNorm backward: out = aln * o / m
  float t = 0.f;
#pragma unroll
  for (int u = 0; u < S; ++u) {
    const float aln = s.aln[nn[u]];
    float ta = 0.f;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      ta += go[u][i] * f[u].o[i];
      t += go[u][i] * aln * f[u].o[i];
    }
    a[u].aln += ta / mean;
  }
  const float dm = -warp_sum(t) / (mean * mean);
  float dfr[S][NB], dz[S][NB], dyn[S][NB];
#pragma unroll
  for (int u = 0; u < S; ++u) {
    const Fwd<A>& fu = f[u];
    const int n = nn[u];
    const float aln = s.aln[n];
    const float dqc = dm / (float)c * 0.5f * fu.qc / (fu.s1c * fu.nc);
    float dfg[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const float d_o = aln * go[u][i] / mean + dqc * 2.f * tb.bc[i] * fu.o[i];
      dfg[i] = d_o * SQRT2_INV;
      dfr[u][i] = dfg[i];
      if (act[u]) dft[i * c + n] = dfr[u][i];
    }
    a[u].bl += dfg[0];
    // ---- geometric product backward (pair form)
#pragma unroll
    for (int i = 0; i < NB; ++i) { dz[u][i] = 0.f; dyn[u][i] = 0.f; }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const int i = i_of<A>(j, k);
        const int q = A::path_id(grade<A>(i), grade<A>(j), grade<A>(k));
        const float sg = tb.sign[j * NB + k];
        const float cw = sg * s.gw[q * c + n];
        dz[u][i] += dfr[u][j] * cw * fu.ynr[k];
        dyn[u][k] += dfr[u][j] * cw * fu.zr[i];
        a[u].gw[q] += dfr[u][j] * sg * fu.zr[i] * fu.ynr[k];
      }
    }
    // ---- normalisation backward: yn = yr / den
    float dden[NG], dyr[NB];
#pragma unroll
    for (int g = 0; g < NG; ++g) dden[g] = 0.f;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const float dn = fu.den[grade<A>(i)];
      dyr[i] = dyn[u][i] / dn;
      dden[grade<A>(i)] += -dyn[u][i] * fu.yn[i] / dn;
    }
    float dqg[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      a[u].ns[g] += dden[g] * (fu.nr[g] - 1.f);
      const float dnr = dden[g] * s.nsig[g * c + n];
      dqg[g] = dnr * 0.5f * fu.qg[g] / (fu.s1g[g] * fu.nr[g]);
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      dyr[i] += dqg[grade<A>(i)] * 2.f * tb.bc[i] * fu.yr[i];
      if (act[u]) drt[i * c + n] = dyr[i];
    }
  }
  __syncwarp();
  // ---- transposed channel mixing: slot u is input channel n_u
  for (int q = 0; q < c; ++q) {
    float wr[S][NG], wl[S][NG];
#pragma unroll
    for (int u = 0; u < S; ++u)
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        wr[u][g] = s.wr[nn[u] * s.pm + g * c + q];
        wl[u][g] = s.wl[nn[u] * s.pm + g * c + q];
      }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const float df = dft[i * c + q], dr = drt[i * c + q];
#pragma unroll
      for (int u = 0; u < S; ++u)
        dz[u][i] += df * wl[u][grade<A>(i)] + dr * wr[u][grade<A>(i)];
    }
  }
#pragma unroll
  for (int u = 0; u < S; ++u) {
    const Fwd<A>& fu = f[u];
    const int n = nn[u];
    // ---- MVSiLU backward: z = sigmoid(a * inv + b) * y
    float dy[NB], dgate[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const float sg = fu.s[grade<A>(i)];
      dy[i] = dz[u][i] * sg;
      dgate[i] = dz[u][i] * fu.y[i] * sg * (1.f - sg);
    }
    float dgs[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) dgs[g] = 0.f;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      dgs[grade<A>(i)] += dgate[i];
    }
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      a[u].sb[g] += dgs[g];
      a[u].sa[g] += fu.inv[g] * dgs[g];
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const float dv = s.ra[grade<A>(i) * c + n] * dgs[grade<A>(i)];
      dy[i] += (i == 0) ? dv : 2.f * tb.bc[i] * fu.y[i] * dv;
    }
    a[u].b1 += dy[0];
#pragma unroll
    for (int i = 0; i < NB; ++i)
      if (act[u]) dyt[i * c + n] = dy[i];
  }
  __syncwarp();
  // ---- dx: transposed input linear, lanes over input channels
  for (int m = lane; m < cin; m += 32) {
    float acc[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) acc[i] = 0.f;
    for (int q = 0; q < c; ++q) {
      float w[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g) w[g] = s.w1[m * s.pm1 + g * c + q];
#pragma unroll
      for (int i = 0; i < NB; ++i) acc[i] += dyt[i * c + q] * w[grade<A>(i)];
    }
    float* d = dxr + m * NB;
#pragma unroll
    for (int i = 0; i < NB; ++i) d[i] = acc[i];
  }
}

// Channel-mixing weight gradients over a tile's first nrow rows, added into
// aw1, awr, awl laid out [(m * NG + g) * C + n] (shared or global memory).
// A thread owns one input channel m and NQ consecutive output channels q,
// for all grades at once: each load of the row's x (or z) value feeds
// NQ FMAs.  Entries are owned by one thread: no races, and the same thread
// owns the same entries on every call.  A thread reads all its old values
// before the row loop, so that in global memory their loads overlap
// instead of waiting on each other's stores.  All threads of the CTA call
// it.
template <class A>
__device__ __forceinline__ void weight_grads(
    const float* xs, const float* zs, const float* dfs, const float* drs,
    const float* dys, int nrow, int cin, int c, float* aw1, float* awr,
    float* awl) {
  constexpr int NB = A::NB, NG = A::NG;
  const int tid = threadIdx.x + 32 * threadIdx.y;
  const int nqb = (c + NQ - 1) / NQ;
  for (int p = tid; p < cin * nqb; p += THREADS) {
    const int m = p / nqb, q0 = (p % nqb) * NQ;
    float acc[NQ][NG], old[NQ][NG];
#pragma unroll
    for (int u = 0; u < NQ; ++u)
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        acc[u][g] = 0.f;
        old[u][g] = q0 + u < c ? aw1[(m * NG + g) * c + q0 + u] : 0.f;
      }
    for (int rr = 0; rr < nrow; ++rr) {
      const float* xt = xs + rr * NB * cin;
      const float* dt = dys + rr * NB * c + q0;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const float xv = xt[i * cin + m];
#pragma unroll
        for (int u = 0; u < NQ; ++u)
          acc[u][grade<A>(i)] += xv * dt[i * c + u];
      }
    }
#pragma unroll
    for (int u = 0; u < NQ; ++u)
      if (q0 + u < c)
#pragma unroll
        for (int g = 0; g < NG; ++g)
          aw1[(m * NG + g) * c + q0 + u] = old[u][g] + acc[u][g];
  }
  for (int p = tid; p < c * nqb; p += THREADS) {
    const int m = p / nqb, q0 = (p % nqb) * NQ;
    float accr[NQ][NG], accl[NQ][NG], oldr[NQ][NG], oldl[NQ][NG];
#pragma unroll
    for (int u = 0; u < NQ; ++u)
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        accr[u][g] = 0.f;
        accl[u][g] = 0.f;
        const bool in = q0 + u < c;
        oldr[u][g] = in ? awr[(m * NG + g) * c + q0 + u] : 0.f;
        oldl[u][g] = in ? awl[(m * NG + g) * c + q0 + u] : 0.f;
      }
    for (int rr = 0; rr < nrow; ++rr) {
      const float* zt2 = zs + rr * NB * c;
      const float* rt = drs + rr * NB * c + q0;
      const float* ft = dfs + rr * NB * c + q0;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const float zv = zt2[i * c + m];
#pragma unroll
        for (int u = 0; u < NQ; ++u) {
          accr[u][grade<A>(i)] += zv * rt[i * c + u];
          accl[u][grade<A>(i)] += zv * ft[i * c + u];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < NQ; ++u)
      if (q0 + u < c)
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          awr[(m * NG + g) * c + q0 + u] = oldr[u][g] + accr[u][g];
          awl[(m * NG + g) * c + q0 + u] = oldl[u][g] + accl[u][g];
        }
  }
}

// Adds every thread's per-channel accumulators into loc ([Loc::N][C],
// shared memory, rows as in `Loc`), warp by warp in a fixed order.  All
// threads of the CTA call it.
template <class A>
__device__ inline void acc_to_loc(const Acc<A> (&a)[A::SLOTS], float* loc,
                                  int c, int lane) {
  using L = Loc<A>;
  const int r = threadIdx.y;
  for (int w = 0; w < ROWS; ++w) {
    __syncthreads();
    if (r == w) {
#pragma unroll
      for (int u = 0; u < A::SLOTS; ++u) {
        const int n = lane + 32 * u;
        if (n >= c) continue;
        loc[L::B1 * c + n] += a[u].b1;
#pragma unroll
        for (int g = 0; g < A::NG; ++g) {
          loc[(L::SA + g) * c + n] += a[u].sa[g];
          loc[(L::SB + g) * c + n] += a[u].sb[g];
          loc[(L::NS + g) * c + n] += a[u].ns[g];
        }
#pragma unroll
        for (int q = 0; q < A::NP; ++q) loc[(L::GW + q) * c + n] += a[u].gw[q];
        loc[L::BL * c + n] += a[u].bl;
        loc[L::ALN * c + n] += a[u].aln;
      }
    }
  }
  __syncthreads();
}

// out[q] = sum over CTAs of partials[cta][q], in CTA order.
__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       float* __restrict__ out, int64_t n,
                                       int parts) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  float acc = 0.f;
#pragma unroll 8   // loads issued ahead, added in CTA order
  for (int t = 0; t < parts; ++t) acc += partials[(int64_t)t * n + q];
  out[q] = acc;
}

template <class A>
Tabs<A> make_tabs(const float* bc, const float* sign) {
  Tabs<A> tb;
  for (int i = 0; i < A::NB; ++i) tb.bc[i] = bc[i];
  for (int i = 0; i < A::NB * A::NB; ++i) tb.sign[i] = sign[i];
  return tb;
}

// Structural tables the kernels assume, for the host to check against the
// algebra: i_of (NB^2 ints), path ids (NB^2 ints), grades (NB ints).
template <class A>
void structural_tables(int* i_of_out, int* path_out, int* grade_out) {
  for (int j = 0; j < A::NB; ++j)
    for (int k = 0; k < A::NB; ++k) {
      i_of_out[j * A::NB + k] = i_of<A>(j, k);
      path_out[j * A::NB + k] =
          A::path_id(grade<A>(i_of<A>(j, k)), grade<A>(j), grade<A>(k));
    }
  for (int i = 0; i < A::NB; ++i) grade_out[i] = grade<A>(i);
}

}  // namespace
