// One CEMLP block of Cl(3,0) for one row per warp and one output channel
// per lane: the device code shared by the block kernels (cemlp.cu, K2 and
// K3) and the fused message-passing kernels (fused_egcl.cu, K4 and K5).
//
// A block is
//     MVLinear -> MVSiLU -> SGP (right linear, grade-norm normalisation,
//     geometric product, + left linear, / sqrt 2) -> MVLayerNorm,
// the function of `_post_linear_math` and of the composed layers in
// csmpn_tpu/nn/modules.py.
//
//   * the three channel-mixing linears (W1, Wr, WL) are per-grade FMA
//     loops over the input channels, reading the row from shared memory as
//     a broadcast and the weights as a conflict-free lane-contiguous run;
//   * the grade sums, the normalisation and the geometric product are done
//     in registers per (row, channel): the product uses the Cayley pair
//     structure — for each (output j, right k) exactly one left blade
//     i = i_of(j, k) with one sign — 64 FMAs instead of a 512-entry table;
//   * the layer norm's channel mean is a warp shuffle reduction.
//
// The backward of a row (`block_backward_row`) recomputes nothing itself:
// it takes the row's forward state and its output cotangent, writes dx for
// the row and the row's cotangents into shared-memory tiles, and adds the
// per-channel parameter gradients into registers (`Acc`).  The
// channel-mixing weight gradients are summed over a tile of rows by
// `weight_grads`, each entry owned by one thread.
//
// Precision: FAST = false is fp32 throughout.  FAST = true rounds to bf16
// the operands of each product that the TPU kernel feeds its matrix unit
// (`_cast_pair`/`_dot*`), and accumulates in fp32.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NB = 8;          // blades of Cl(3)
constexpr int NG = 4;          // grades
constexpr int NP = 20;         // nonzero grade paths of the geometric product
constexpr int ROWS = 8;        // rows (warps) per CTA
constexpr int THREADS = 32 * ROWS;
constexpr int NLOC = 35;       // per-channel gradient accumulators
constexpr int NQ = 4;          // output channels per thread, weight grads
constexpr float EPS = 1e-6f;
constexpr float SQRT2_INV = 0.70710678118654752440f;
constexpr size_t kMaxSmem = 232448;   // 227 KB opt-in per block

// short-lex blade index <-> bitmap (self-inverse for dim 3):
// 1, e1, e2, e3, e12, e13, e23, e123
__host__ __device__ constexpr int bitmap(int i) {
  return i == 3 ? 4 : (i == 4 ? 3 : i);
}
__host__ __device__ constexpr int grade(int i) {
  return (bitmap(i) & 1) + ((bitmap(i) >> 1) & 1) + ((bitmap(i) >> 2) & 1);
}
// the one left blade contributing to (output j, right k)
__host__ __device__ constexpr int i_of(int j, int k) {
  return bitmap(bitmap(j) ^ bitmap(k));
}
// index of the grade path (left a, output b, right c) among the 20
// nonzero paths of Cl(3), in lexicographic order (numpy argwhere of
// geometric_product_paths); the host checks it against the algebra
__host__ __device__ constexpr int path_id(int a, int b, int c) {
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

struct Tabs {
  float bc[NB];          // quadratic-form coefficient per blade
  float sign[NB * NB];   // Cayley sign of the pair (j, k)
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

// Block parameters staged in shared memory.  Channel-mixing weights are
// laid out [m][g][n] with an odd pitch per input channel m, so that lanes
// along n (forward) and lanes along m (backward) both hit distinct banks.
struct Smem {
  float *w1, *wr, *wl;             // [m * pm + g * C + n]
  float *b1, *ra, *sb, *nsig, *gw, *bl, *aln;
  int pm1, pm;
};

__host__ __device__ inline int params_floats(int cin, int c) {
  return cin * (4 * c + 1) + 2 * c * (4 * c + 1) + c * (3 + 3 * NG + NP);
}

__device__ inline void carve_params(float* base, int cin, int c, Smem& s) {
  s.pm1 = 4 * c + 1;
  s.pm = 4 * c + 1;
  s.w1 = base;
  s.wr = s.w1 + cin * s.pm1;
  s.wl = s.wr + c * s.pm;
  s.b1 = s.wl + c * s.pm;
  s.ra = s.b1 + c;
  s.sb = s.ra + NG * c;
  s.nsig = s.sb + NG * c;
  s.gw = s.nsig + NG * c;
  s.bl = s.gw + NP * c;
  s.aln = s.bl + c;
}

struct Params {
  const float *w1, *b1, *sa, *sb, *gw, *wr, *na, *wl, *bl, *aln;
};

template <bool FAST>
__device__ void stage_params(const Params& p, const Smem& s, int cin, int c) {
  const int tid = threadIdx.x + 32 * threadIdx.y;
  for (int e = tid; e < c * cin * NG; e += THREADS) {   // flax (n, m, g)
    const int g = e % NG, m = (e / NG) % cin, n = e / (NG * cin);
    s.w1[m * s.pm1 + g * c + n] = rnd<FAST>(p.w1[e]);
  }
  for (int e = tid; e < c * c * NG; e += THREADS) {
    const int g = e % NG, m = (e / NG) % c, n = e / (NG * c);
    s.wr[m * s.pm + g * c + n] = rnd<FAST>(p.wr[e]);
    s.wl[m * s.pm + g * c + n] = rnd<FAST>(p.wl[e]);
  }
  for (int e = tid; e < c * NG; e += THREADS) {          // (n, g)
    const int g = e % NG, n = e / NG;
    s.ra[g * c + n] = rnd<FAST>(p.sa[e]);
    s.sb[g * c + n] = p.sb[e];
    s.nsig[g * c + n] = 1.f / (1.f + expf(-p.na[e]));
  }
  for (int e = tid; e < c * NP; e += THREADS) {          // (n, path)
    const int q = e % NP, n = e / NP;
    s.gw[q * c + n] = rnd<FAST>(p.gw[e]);
  }
  for (int e = tid; e < c; e += THREADS) {
    s.b1[e] = p.b1[e];
    s.bl[e] = p.bl[e];
    s.aln[e] = p.aln[e];
  }
}

// Loads a tile of ROWS input rows, (rows, cin, 8) row-major in global
// memory, into shared memory as [r][i][m], rounded in fast mode.
template <bool FAST>
__device__ void load_x_tile(const float* __restrict__ x, float* xs,
                            int64_t row0, int rows, int cin) {
  const int tid = threadIdx.x + 32 * threadIdx.y;
  const int per_row = cin * NB;
  int nrow = rows - (int)row0;
  nrow = nrow < ROWS ? nrow : ROWS;
  for (int e = tid; e < ROWS * per_row; e += THREADS) {
    const int r = e / per_row, rem = e % per_row;
    const int m = rem / NB, i = rem % NB;
    xs[(r * NB + i) * cin + m] =
        r < nrow ? rnd<FAST>(x[row0 * per_row + e]) : 0.f;
  }
}

struct Fwd {
  float y[NB], z[NB], zr[NB], yr[NB], yn[NB], ynr[NB], o[NB];
  float inv[NG], s[NG], qg[NG], s1g[NG], nr[NG], den[NG];
  float qc, s1c, nc, m;
};

// Forward of one block for (row of this warp, channel n = lane).  xr is
// the row's [i][m] tile, zt the row's [i][n] tile for z.  Every lane of
// the warp must call it (shuffle reduction); lanes n >= c compute on a
// clamped channel and are masked out of every result.  The block's output
// for the lane is s.aln[n] / f.m * f.o[i].
template <bool FAST>
__device__ __forceinline__ void block_forward(Fwd& f, const Smem& s,
                                              const Tabs& tb,
                                              const float* xr, float* zt,
                                              int cin, int c, int n,
                                              bool act) {
  // ---- MVLinear
#pragma unroll
  for (int i = 0; i < NB; ++i) f.y[i] = 0.f;
  for (int m = 0; m < cin; ++m) {
    float w[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) w[g] = s.w1[m * s.pm1 + g * c + n];
#pragma unroll
    for (int i = 0; i < NB; ++i) f.y[i] += xr[i * cin + m] * w[grade(i)];
  }
  f.y[0] += s.b1[n];
  // ---- MVSiLU: gate per grade from the scalar blade / squared magnitudes
#pragma unroll
  for (int g = 0; g < NG; ++g) f.inv[g] = 0.f;
  f.inv[0] = rnd<FAST>(f.y[0]);
#pragma unroll
  for (int i = 1; i < NB; ++i)
    f.inv[grade(i)] += rnd<FAST>(f.y[i] * f.y[i] * tb.bc[i]);
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const float gate = s.ra[g * c + n] * f.inv[g] + s.sb[g * c + n];
    f.s[g] = 1.f / (1.f + expf(-gate));
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    f.z[i] = f.s[grade(i)] * f.y[i];
    f.zr[i] = rnd<FAST>(f.z[i]);
    if (act) zt[i * c + n] = f.zr[i];
  }
  __syncwarp();
  // ---- right and left linears of the SGP (channel mixing in the row)
  float first[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) { f.yr[i] = 0.f; first[i] = 0.f; }
  for (int m = 0; m < c; ++m) {
    float wr[NG], wl[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      wr[g] = s.wr[m * s.pm + g * c + n];
      wl[g] = s.wl[m * s.pm + g * c + n];
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const float zv = zt[i * c + m];
      f.yr[i] += zv * wr[grade(i)];
      first[i] += zv * wl[grade(i)];
    }
  }
  first[0] += s.bl[n];
  // ---- grade-norm normalisation of the right operand
#pragma unroll
  for (int g = 0; g < NG; ++g) f.qg[g] = 0.f;
#pragma unroll
  for (int i = 0; i < NB; ++i)
    f.qg[grade(i)] += rnd<FAST>(f.yr[i] * f.yr[i] * tb.bc[i]);
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    f.s1g[g] = sqrtf(f.qg[g] * f.qg[g] + 1e-16f);
    f.nr[g] = sqrtf(f.s1g[g]);
    f.den[g] = s.nsig[g * c + n] * (f.nr[g] - 1.f) + 1.f + EPS;
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    f.yn[i] = f.yr[i] / f.den[grade(i)];
    f.ynr[i] = rnd<FAST>(f.yn[i]);
  }
  // ---- weighted geometric product, Cayley pair form, + first order
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    float gp = 0.f;
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const int i = i_of(j, k);
      const float cw =
          tb.sign[j * NB + k] * s.gw[path_id(grade(i), grade(j), grade(k)) * c + n];
      gp += cw * f.zr[i] * f.ynr[k];
    }
    f.o[j] = (first[j] + gp) * SQRT2_INV;
  }
  // ---- MVLayerNorm: channel mean of the smooth-abs-sqrt norms
  f.qc = 0.f;
#pragma unroll
  for (int i = 0; i < NB; ++i) f.qc += rnd<FAST>(f.o[i] * f.o[i] * tb.bc[i]);
  f.s1c = sqrtf(f.qc * f.qc + 1e-16f);
  f.nc = sqrtf(f.s1c);
  f.m = warp_sum(act ? f.nc : 0.f) / (float)c + EPS;
}

// Per-channel parameter gradients of one block, summed over the rows this
// thread (warp row, lane channel) handled.
struct Acc {
  float b1, bl, aln;
  float sa[NG], sb[NG], ns[NG], gw[NP];
};

__device__ __forceinline__ void acc_zero(Acc& a) {
  a.b1 = 0.f; a.bl = 0.f; a.aln = 0.f;
#pragma unroll
  for (int g = 0; g < NG; ++g) { a.sa[g] = 0.f; a.sb[g] = 0.f; a.ns[g] = 0.f; }
#pragma unroll
  for (int q = 0; q < NP; ++q) a.gw[q] = 0.f;
}

// Backward of one block for (row of this warp, channel n = lane), from the
// row's forward state f and its output cotangent go.  Writes the row's
// rounded cotangents d(first) = d(gp), d(yr) and d(y) into its [i][n]
// tiles dft, drt, dyt (read by `weight_grads`), and dx into dxr, laid out
// [m][i] over the cin input channels.  Every lane of the warp must call it.
template <bool FAST>
__device__ __forceinline__ void block_backward_row(
    const Fwd& f, const Smem& s, const Tabs& tb, const float (&go)[NB],
    Acc& a, float* dft, float* drt, float* dyt, float* dxr, int cin, int c,
    int n, int lane, bool act) {
  // ---- MVLayerNorm backward: out = aln * o / m
  const float aln = s.aln[n];
  float t = 0.f, ta = 0.f;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    ta += go[i] * f.o[i];
    t += go[i] * aln * f.o[i];
  }
  a.aln += ta / f.m;
  const float dm = -warp_sum(t) / (f.m * f.m);
  const float dqc =
      rnd<FAST>(dm / (float)c * 0.5f * f.qc / (f.s1c * f.nc));
  float dfg[NB], dfr[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const float d_o = aln * go[i] / f.m + dqc * 2.f * tb.bc[i] * f.o[i];
    dfg[i] = d_o * SQRT2_INV;
    dfr[i] = rnd<FAST>(dfg[i]);
    if (act) dft[i * c + n] = dfr[i];
  }
  a.bl += dfg[0];
  // ---- geometric product backward (pair form)
  float dz[NB], dyn[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) { dz[i] = 0.f; dyn[i] = 0.f; }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const int i = i_of(j, k);
      const int q = path_id(grade(i), grade(j), grade(k));
      const float sg = tb.sign[j * NB + k];
      const float cw = sg * s.gw[q * c + n];
      dz[i] += dfr[j] * cw * f.ynr[k];
      dyn[k] += dfr[j] * cw * f.zr[i];
      a.gw[q] += dfr[j] * sg * f.zr[i] * f.ynr[k];
    }
  }
  // ---- normalisation backward: yn = yr / den
  float dden[NG], dyr[NB];
#pragma unroll
  for (int g = 0; g < NG; ++g) dden[g] = 0.f;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const float dn = f.den[grade(i)];
    dyr[i] = dyn[i] / dn;
    dden[grade(i)] += -dyn[i] * f.yn[i] / dn;
  }
  float dqg[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    a.ns[g] += dden[g] * (f.nr[g] - 1.f);
    const float dnr = dden[g] * s.nsig[g * c + n];
    dqg[g] = rnd<FAST>(dnr * 0.5f * f.qg[g] / (f.s1g[g] * f.nr[g]));
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    dyr[i] += dqg[grade(i)] * 2.f * tb.bc[i] * f.yr[i];
    if (act) drt[i * c + n] = rnd<FAST>(dyr[i]);
  }
  __syncwarp();
  // ---- transposed channel mixing: this lane is input channel n
  for (int q = 0; q < c; ++q) {
    float wr[NG], wl[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      wr[g] = s.wr[n * s.pm + g * c + q];
      wl[g] = s.wl[n * s.pm + g * c + q];
    }
#pragma unroll
    for (int i = 0; i < NB; ++i)
      dz[i] += dft[i * c + q] * wl[grade(i)] + drt[i * c + q] * wr[grade(i)];
  }
  // ---- MVSiLU backward: z = sigmoid(a * inv + b) * y
  float dy[NB], dgate[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const float sg = f.s[grade(i)];
    dy[i] = dz[i] * sg;
    dgate[i] = dz[i] * f.y[i] * sg * (1.f - sg);
  }
  float dgs[NG], dgr[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) { dgs[g] = 0.f; dgr[g] = 0.f; }
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    dgs[grade(i)] += dgate[i];
    dgr[grade(i)] += rnd<FAST>(dgate[i]);
  }
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    a.sb[g] += dgs[g];
    a.sa[g] += f.inv[g] * dgr[g];
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const float dv = s.ra[grade(i) * c + n] * dgr[grade(i)];
    dy[i] += (i == 0) ? dv : 2.f * tb.bc[i] * f.y[i] * dv;
  }
  a.b1 += dy[0];
#pragma unroll
  for (int i = 0; i < NB; ++i)
    if (act) dyt[i * c + n] = rnd<FAST>(dy[i]);
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
      for (int i = 0; i < NB; ++i) acc[i] += dyt[i * c + q] * w[grade(i)];
    }
    float* d = dxr + m * NB;
#pragma unroll
    for (int i = 0; i < NB; ++i) d[i] = acc[i];
  }
}

// Channel-mixing weight gradients over a tile's first nrow rows, added into
// aw1, awr, awl laid out [(m * 4 + g) * C + n] (shared or global memory).
// A thread owns one input channel m and NQ consecutive output channels q,
// for all four grades at once: each load of the row's x (or z) value feeds
// NQ FMAs.  Entries are owned by one thread: no races, and the same thread
// owns the same entries on every call.  A thread reads all its old values
// before the row loop, so that in global memory their loads overlap
// instead of waiting on each other's stores.  All threads of the CTA call
// it.
__device__ __forceinline__ void weight_grads(
    const float* xs, const float* zs, const float* dfs, const float* drs,
    const float* dys, int nrow, int cin, int c, float* aw1, float* awr,
    float* awl) {
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
          acc[u][grade(i)] += xv * dt[i * c + u];
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
          accr[u][grade(i)] += zv * rt[i * c + u];
          accl[u][grade(i)] += zv * ft[i * c + u];
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

// Adds every thread's per-channel accumulators into loc ([NLOC][C], shared
// memory), warp by warp in a fixed order: rows k = 0 b1, 1-4 silu.a,
// 5-8 silu.b, 9-28 gp.weight, 29-32 d sigmoid(normalization.a), 33 bL,
// 34 layer-norm a.  All threads of the CTA call it.
__device__ inline void acc_to_loc(const Acc& a, float* loc, int c, int n,
                                  bool act) {
  const int r = threadIdx.y;
  for (int w = 0; w < ROWS; ++w) {
    __syncthreads();
    if (r == w && act) {
      loc[0 * c + n] += a.b1;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        loc[(1 + g) * c + n] += a.sa[g];
        loc[(5 + g) * c + n] += a.sb[g];
        loc[(29 + g) * c + n] += a.ns[g];
      }
#pragma unroll
      for (int q = 0; q < NP; ++q) loc[(9 + q) * c + n] += a.gw[q];
      loc[33 * c + n] += a.bl;
      loc[34 * c + n] += a.aln;
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
  for (int t = 0; t < parts; ++t) acc += partials[(int64_t)t * n + q];
  out[q] = acc;
}

Tabs make_tabs(const float* bc, const float* sign) {
  Tabs tb;
  for (int i = 0; i < NB; ++i) tb.bc[i] = bc[i];
  for (int i = 0; i < NB * NB; ++i) tb.sign[i] = sign[i];
  return tb;
}

// Structural tables the kernels assume, for the host to check against the
// algebra: i_of (64 ints), path ids (64 ints), grades (8 ints).
void structural_tables(int* i_of_out, int* path_out, int* grade_out) {
  for (int j = 0; j < NB; ++j)
    for (int k = 0; k < NB; ++k) {
      i_of_out[j * NB + k] = i_of(j, k);
      path_out[j * NB + k] = path_id(grade(i_of(j, k)), grade(j), grade(k));
    }
  for (int i = 0; i < NB; ++i) grade_out[i] = grade(i);
}

}  // namespace
