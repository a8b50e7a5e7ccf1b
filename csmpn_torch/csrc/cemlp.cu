// K2 and K3 — one whole CEMLP block, forward and backward, Cl(3,0), on
// Hopper (sm_90a).
//
// Replaces: csmpn_tpu/ops/cemlp_kernel.py, `_fwd_kernel` (K2, launched by
// `_pallas_fwd`, entry `apply_fused_cemlp`) and `_bwd_kernel` (K3,
// launched by `_fused_block_bwd`).  One block is
//     MVLinear -> MVSiLU -> SGP (right linear, grade-norm normalisation,
//     geometric product, + left linear, / sqrt 2) -> MVLayerNorm,
// the function of `_post_linear_math` and of the composed layers in
// csmpn_tpu/nn/modules.py.
//
// Bound on this card: at the motion task's widths (C = 28 channels, up to
// 59 input channels, 8 blades) a row costs ~2*8*C*(Cin + 2C) + 6*64*C
// FLOPs against 4*8*(Cin + C) bytes, ~40 FLOP/byte in fp32: memory-bound
// against the tensor cores, near the fp32 FMA ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte).  The backward does about three times the
// forward's work on the same bytes.
//
// Design: the TPU kernel turns the grade sums and the geometric product into
// MXU matrix products over lane tables (Bcat, Kcat, G, H), inflating the
// work 8-fold.  Here a warp owns one row and a lane owns one output
// channel, so
//   * the three channel-mixing linears (W1, Wr, WL) are per-grade FMA
//     loops over the input channels, reading the row from shared memory as
//     a broadcast and the weights as a conflict-free lane-contiguous run;
//   * the grade sums, the normalisation and the geometric product are done
//     in registers per (row, channel): the product uses the Cayley pair
//     structure — for each (output j, right k) exactly one left blade
//     i = i_of(j, k) with one sign — 64 FMAs instead of a 512-entry table;
//   * the layer norm's channel mean is a warp shuffle reduction.
// The block's parameters are staged once per CTA in shared memory, and a
// CTA walks over row tiles so the staging is amortised.  The backward
// recomputes the forward in the tile (as the TPU kernel does), writes dx
// per row, and accumulates the parameter gradients: per-channel ones in
// registers, channel-mixing ones in shared memory, each entry owned by one
// thread.  CUDA blocks run concurrently, so each CTA writes its partial
// sums to a scratch buffer and a second kernel reduces them in a fixed
// order: no atomics, deterministic results.
//
// Precision: FAST = false is fp32 throughout.  FAST = true rounds to bf16
// the operands of each product that the TPU kernel feeds its matrix unit
// (`_cast_pair`/`_dot*`), and accumulates in fp32.

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
// clamped channel and are masked out of every result.
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

template <bool FAST>
__global__ void __launch_bounds__(THREADS)
cemlp_fwd_kernel(const float* __restrict__ x, Params p, Tabs tb,
                 float* __restrict__ out, int rows, int cin, int c) {
  extern __shared__ float smem[];
  Smem s;
  carve_params(smem, cin, c, s);
  float* xs = smem + params_floats(cin, c);   // [ROWS][NB][cin]
  float* zs = xs + ROWS * NB * cin;           // [ROWS][NB][c]
  stage_params<FAST>(p, s, cin, c);

  const int lane = threadIdx.x, r = threadIdx.y;
  const bool act = lane < c;
  const int n = act ? lane : c - 1;
  const int n_tiles = (rows + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = (int64_t)tile * ROWS;
    __syncthreads();   // staging done / previous tile consumed
    load_x_tile<FAST>(x, xs, row0, rows, cin);
    __syncthreads();
    const int64_t row = row0 + r;
    if (row >= rows) continue;   // whole warp: no shuffle partner missing
    Fwd f;
    block_forward<FAST>(f, s, tb, xs + r * NB * cin, zs + r * NB * c, cin,
                        c, n, act);
    if (act) {
      const float scale = s.aln[n] / f.m;
      float* o = out + (row * c + n) * NB;
#pragma unroll
      for (int i = 0; i < NB; ++i) o[i] = scale * f.o[i];
    }
  }
}

// Gradient vector layout (flax parameter order and shapes):
//   dW1 (C, Cin, 4) | db1 (C) | dsilu_a (C, 4) | dsilu_b (C, 4) |
//   dgp_weight (C, 20) | dWr (C, C, 4) | dsigmoid(norm_a) (C, 4) |
//   dWL (C, C, 4) | dbL (C) | dln_a (C)
__host__ __device__ inline int64_t grad_floats(int cin, int c) {
  return (int64_t)c * cin * NG + c + 2 * NG * c + NP * c + c * c * NG +
         NG * c + c * c * NG + 2 * c;
}

template <bool FAST>
__global__ void __launch_bounds__(THREADS)
cemlp_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dout,
                 Params p, Tabs tb, float* __restrict__ dx,
                 float* __restrict__ partials, int rows, int cin, int c) {
  extern __shared__ float smem[];
  Smem s;
  carve_params(smem, cin, c, s);
  float* xs = smem + params_floats(cin, c);   // [ROWS][NB][cin]
  float* zs = xs + ROWS * NB * cin;           // [ROWS][NB][c], rounded z
  float* dfs = zs + ROWS * NB * c;            // d(first) = d(gp)
  float* drs = dfs + ROWS * NB * c;           // d(yr)
  float* dys = drs + ROWS * NB * c;           // d(y)
  float* aw1 = dys + ROWS * NB * c;           // [(m*4+g)*C + n]
  float* awr = aw1 + cin * NG * c;
  float* awl = awr + c * NG * c;
  float* loc = awl + c * NG * c;              // [NLOC][C]
  stage_params<FAST>(p, s, cin, c);
  const int tid = threadIdx.x + 32 * threadIdx.y;
  for (int e = tid; e < cin * NG * c; e += THREADS) aw1[e] = 0.f;
  for (int e = tid; e < c * NG * c; e += THREADS) { awr[e] = 0.f; awl[e] = 0.f; }
  for (int e = tid; e < NLOC * c; e += THREADS) loc[e] = 0.f;

  const int lane = threadIdx.x, r = threadIdx.y;
  const bool act = lane < c;
  const int n = act ? lane : c - 1;
  // per-channel gradient accumulators (this thread's rows)
  float a_b1 = 0.f, a_bl = 0.f, a_aln = 0.f;
  float a_sa[NG], a_sb[NG], a_ns[NG], a_gw[NP];
#pragma unroll
  for (int g = 0; g < NG; ++g) { a_sa[g] = 0.f; a_sb[g] = 0.f; a_ns[g] = 0.f; }
#pragma unroll
  for (int q = 0; q < NP; ++q) a_gw[q] = 0.f;

  const int n_tiles = (rows + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = (int64_t)tile * ROWS;
    __syncthreads();
    load_x_tile<FAST>(x, xs, row0, rows, cin);
    __syncthreads();
    const int64_t row = row0 + r;
    float* zt = zs + r * NB * c;
    float* dft = dfs + r * NB * c;
    float* drt = drs + r * NB * c;
    float* dyt = dys + r * NB * c;
    if (row < rows) {
      Fwd f;
      block_forward<FAST>(f, s, tb, xs + r * NB * cin, zt, cin, c, n, act);
      float go[NB];
#pragma unroll
      for (int i = 0; i < NB; ++i)
        go[i] = act ? dout[(row * c + n) * NB + i] : 0.f;
      // ---- MVLayerNorm backward: out = aln * o / m
      const float aln = s.aln[n];
      float t = 0.f, ta = 0.f;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        ta += go[i] * f.o[i];
        t += go[i] * aln * f.o[i];
      }
      a_aln += ta / f.m;
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
      a_bl += dfg[0];
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
          a_gw[q] += dfr[j] * sg * f.zr[i] * f.ynr[k];
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
        a_ns[g] += dden[g] * (f.nr[g] - 1.f);
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
        a_sb[g] += dgs[g];
        a_sa[g] += f.inv[g] * dgr[g];
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const float dv = s.ra[grade(i) * c + n] * dgr[grade(i)];
        dy[i] += (i == 0) ? dv : 2.f * tb.bc[i] * f.y[i] * dv;
      }
      a_b1 += dy[0];
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
        float* d = dx + (row * cin + m) * NB;
#pragma unroll
        for (int i = 0; i < NB; ++i) d[i] = acc[i];
      }
    }
    __syncthreads();
    // ---- channel-mixing weight gradients over the tile's rows.  A
    // thread owns one input channel m and NQ consecutive output channels
    // q, for all four grades at once: each load of the row's x (or z)
    // value feeds NQ FMAs.  Entries are owned by one thread: no races.
    int nrow = rows - (int)row0;
    nrow = nrow < ROWS ? nrow : ROWS;
    const int nqb = (c + NQ - 1) / NQ;
    for (int p = tid; p < cin * nqb; p += THREADS) {
      const int m = p / nqb, q0 = (p % nqb) * NQ;
      float acc[NQ][NG];
#pragma unroll
      for (int u = 0; u < NQ; ++u)
#pragma unroll
        for (int g = 0; g < NG; ++g) acc[u][g] = 0.f;
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
            aw1[(m * NG + g) * c + q0 + u] += acc[u][g];
    }
    for (int p = tid; p < c * nqb; p += THREADS) {
      const int m = p / nqb, q0 = (p % nqb) * NQ;
      float accr[NQ][NG], accl[NQ][NG];
#pragma unroll
      for (int u = 0; u < NQ; ++u)
#pragma unroll
        for (int g = 0; g < NG; ++g) { accr[u][g] = 0.f; accl[u][g] = 0.f; }
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
            awr[(m * NG + g) * c + q0 + u] += accr[u][g];
            awl[(m * NG + g) * c + q0 + u] += accl[u][g];
          }
    }
  }
  // ---- per-channel accumulators: add the warps in a fixed order
  for (int w = 0; w < ROWS; ++w) {
    __syncthreads();
    if (r == w && act) {
      loc[0 * c + n] += a_b1;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        loc[(1 + g) * c + n] += a_sa[g];
        loc[(5 + g) * c + n] += a_sb[g];
        loc[(29 + g) * c + n] += a_ns[g];
      }
#pragma unroll
      for (int q = 0; q < NP; ++q) loc[(9 + q) * c + n] += a_gw[q];
      loc[33 * c + n] += a_bl;
      loc[34 * c + n] += a_aln;
    }
  }
  __syncthreads();
  // ---- this CTA's partial gradient vector, in flax layout
  float* part = partials + (int64_t)blockIdx.x * grad_floats(cin, c);
  int64_t o = 0;
  for (int e = tid; e < c * cin * NG; e += THREADS) {    // (n, m, g)
    const int g = e % NG, m = (e / NG) % cin, q = e / (NG * cin);
    part[o + e] = aw1[(m * NG + g) * c + q];
  }
  o += (int64_t)c * cin * NG;
  for (int e = tid; e < c; e += THREADS) part[o + e] = loc[0 * c + e];
  o += c;
  for (int e = tid; e < c * NG; e += THREADS)
    part[o + e] = loc[(1 + e % NG) * c + e / NG];
  o += NG * c;
  for (int e = tid; e < c * NG; e += THREADS)
    part[o + e] = loc[(5 + e % NG) * c + e / NG];
  o += NG * c;
  for (int e = tid; e < c * NP; e += THREADS)
    part[o + e] = loc[(9 + e % NP) * c + e / NP];
  o += NP * c;
  for (int e = tid; e < c * c * NG; e += THREADS) {
    const int g = e % NG, m = (e / NG) % c, q = e / (NG * c);
    part[o + e] = awr[(m * NG + g) * c + q];
  }
  o += (int64_t)c * c * NG;
  for (int e = tid; e < c * NG; e += THREADS)
    part[o + e] = loc[(29 + e % NG) * c + e / NG];
  o += NG * c;
  for (int e = tid; e < c * c * NG; e += THREADS) {
    const int g = e % NG, m = (e / NG) % c, q = e / (NG * c);
    part[o + e] = awl[(m * NG + g) * c + q];
  }
  o += (int64_t)c * c * NG;
  for (int e = tid; e < c; e += THREADS) part[o + e] = loc[33 * c + e];
  o += c;
  for (int e = tid; e < c; e += THREADS) part[o + e] = loc[34 * c + e];
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

size_t fwd_smem_bytes(int cin, int c) {
  return sizeof(float) *
         ((size_t)params_floats(cin, c) + ROWS * NB * (size_t)(cin + c));
}

size_t bwd_smem_bytes(int cin, int c) {
  return sizeof(float) *
         ((size_t)params_floats(cin, c) + ROWS * NB * (size_t)(cin + 4 * c) +
          (size_t)(cin + 2 * c) * NG * c + (size_t)NLOC * c);
}

constexpr size_t kMaxSmem = 232448;   // 227 KB opt-in per block

}  // namespace

extern "C" {

// Shared-memory bytes a launch needs (0 if the widths are not supported).
size_t csmpn_cemlp_smem_bytes(int cin, int c, int backward) {
  if (c < 1 || c > 32 || cin < 1) return 0;
  return backward ? bwd_smem_bytes(cin, c) : fwd_smem_bytes(cin, c);
}

int csmpn_cemlp_fwd(const float* x, const float* w1, const float* b1,
                    const float* sa, const float* sb, const float* gw,
                    const float* wr, const float* na, const float* wl,
                    const float* bl, const float* aln, const float* bc,
                    const float* sign, float* out, int rows, int cin, int c,
                    int fast, int grid, void* stream) {
  const size_t bytes = fwd_smem_bytes(cin, c);
  if (c < 1 || c > 32 || bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  Params p{w1, b1, sa, sb, gw, wr, na, wl, bl, aln};
  Tabs tb = make_tabs(bc, sign);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 block(32, ROWS);
  if (rows > 0) {
    if (fast) {
      cudaFuncSetAttribute(cemlp_fwd_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      cemlp_fwd_kernel<true><<<grid, block, bytes, st>>>(x, p, tb, out, rows,
                                                         cin, c);
    } else {
      cudaFuncSetAttribute(cemlp_fwd_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      cemlp_fwd_kernel<false><<<grid, block, bytes, st>>>(x, p, tb, out, rows,
                                                          cin, c);
    }
  }
  return (int)cudaGetLastError();
}

// partials: (grid, grad_floats) scratch; grads: (grad_floats,) output.
int csmpn_cemlp_bwd(const float* x, const float* dout, const float* w1,
                    const float* b1, const float* sa, const float* sb,
                    const float* gw, const float* wr, const float* na,
                    const float* wl, const float* bl, const float* aln,
                    const float* bc, const float* sign, float* dx,
                    float* partials, float* grads, int rows, int cin, int c,
                    int fast, int grid, void* stream) {
  const size_t bytes = bwd_smem_bytes(cin, c);
  if (c < 1 || c > 32 || bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  Params p{w1, b1, sa, sb, gw, wr, na, wl, bl, aln};
  Tabs tb = make_tabs(bc, sign);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 block(32, ROWS);
  if (fast) {
    cudaFuncSetAttribute(cemlp_bwd_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    cemlp_bwd_kernel<true><<<grid, block, bytes, st>>>(x, dout, p, tb, dx,
                                                       partials, rows, cin, c);
  } else {
    cudaFuncSetAttribute(cemlp_bwd_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    cemlp_bwd_kernel<false><<<grid, block, bytes, st>>>(x, dout, p, tb, dx,
                                                        partials, rows, cin, c);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = grad_floats(cin, c);
  reduce_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      partials, grads, n, grid);
  return (int)cudaGetLastError();
}

// Structural tables the kernels assume, for the host to check against the
// algebra: i_of (64 ints), path ids (64 ints), grades (8 ints).
void csmpn_cemlp_tables(int* i_of_out, int* path_out, int* grade_out) {
  for (int j = 0; j < NB; ++j)
    for (int k = 0; k < NB; ++k) {
      i_of_out[j * NB + k] = i_of(j, k);
      path_out[j * NB + k] = path_id(grade(i_of(j, k)), grade(j), grade(k));
    }
  for (int i = 0; i < NB; ++i) grade_out[i] = grade(i);
}

}  // extern "C"
