// K2w and K3w — one whole CEMLP block, forward and backward, dense form, on
// Hopper (sm_90a), at the widths the row kernels and row tiles of cemlp.cu
// do not take: every C <= 128 output and Cin <= 320 input channels, at
// Cl(3,0) (8 blades) and Cl(2,0) (4 blades), in both modes.  This header
// holds the device code and its host launchers, templated on the
// algebra; cemlp_wide.cu (Cl(3,0)) and cemlp_wide_cl2.cu (Cl(2,0)) each
// instantiate one algebra's C entry points, so that the two build in
// parallel.
//
// Replaces: csmpn_tpu/ops/cemlp_kernel.py, `_fwd_kernel` (K2, launched by
// `_pallas_fwd`, entry `apply_fused_cemlp`) and `_bwd_kernel` (K3,
// launched by `_fused_block_bwd`), dense form, at the widths the TPU
// kernel pads to 128 lanes and tiles by VMEM (`_tile_rows`,
// `_vmem_params`).  One block is
//     MVLinear -> MVSiLU -> SGP (right linear, grade-norm normalisation,
//     geometric product, + left linear, / sqrt 2) -> MVLayerNorm,
// the function of cemlp.cu's kernels; the wrapper
// (ops/cemlp_kernel.block_route) sends a launch here only where their plan
// does not take its widths.  fused_egcl_wide.cuh (K4w/K5w) runs the same
// device code over gathered edge rows (a linear's input rows come from a
// source type: XRows here, its gather there).
//
// Bound on this card: at the motion task's edge block at hidden 128 (134
// -> 128 channels, 8 blades) a row costs ~2*8*128*(134 + 2*128) FLOPs of
// channel mixing against 4*8*(134 + 128) bytes, ~95 FLOP/byte: above the
// fp32 FFMA ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte), so these
// FFMA kernels are bound by operations, not bytes.  The backward does about
// three times the forward's work on twice its bytes.
//
// Design (simple first; the products on the tensor cores are later work):
//   * Weights: at these widths they do not fit in one CTA (C = 128, Cin =
//     282 at Cl(3): W1 alone is 577 KB in fp32), so a first launch
//     (`cemlp_wide_pack_kernel`) lays them out once a call as an image in
//     global memory: each linear as rows [input channel][grade][output
//     channel, padded to a multiple of 32], for the backward also each
//     transposed, W1's cut into blocks of output columns; the per-channel
//     parameters as [field][channel] rows.  A CTA streams the rows of a
//     linear through one shared-memory panel of KC input channels at a
//     time (16-byte loads), shared by its 8 warps.
//   * Rows: a CTA step takes ROWS = 8 rows, a warp a row, a lane the
//     channels lane, lane + 32, ... (ceil(C / 32) slots, at most 4), as the
//     row kernels of cemlp_block.cuh do at one or two slots.  The row's
//     state between phases lives in shared-memory tiles [row][channel]
//     [blade] (z, first, and in the backward y, yr and d(yr)); each product
//     reads a row value as a broadcast and a panel row as a lane-contiguous
//     run, NB FFMAs a weight.  The layer norm's channel mean and d(mean)
//     are warp shuffles over the slots.
//   * Backward (`cemlp_wide_bwd_kernel`): recompute the forward of the
//     step, the row phase's backward (two passes over the slots: the
//     row's sums, then each channel), d(z) += d(first) WL^T + d(yr) Wr^T,
//     MVSiLU's backward, dx = d(y) W1^T, and the cotangent rows z, d(y),
//     d(yr), d(first) to a scratch in global memory.  The per-channel
//     gradients add into the warp's own slab of partials (no atomics: one
//     owner a value).  The weight gradients X^T d(y), z^T d(yr) and z^T
//     d(first) are a separate kernel (`cemlp_wide_wgrad_kernel`) over the
//     scratch: a CTA takes a 64 x 64 tile of (input, output) channels, all
//     grades, over one fixed run of rows, into its own slab; a last kernel
//     (`cemlp_wide_reduce_kernel`) sums the slabs of both kinds in a fixed
//     order into the flax-layout gradient vector.  They did not fit in
//     registers (hundreds of tiles a warp at C = 128), and a partial slab
//     each CTA rewrites at every step of rows would move the whole weight
//     set through L2 per step.
// Every output element has one owner and every sum a fixed order, so two
// launches give the same bits.
//
// Precision: exact mode is fp32 throughout.  Fast mode rounds to bf16 at
// the points the row tiles of cemlp_tile.cuh do, which are the plain fast
// version's (`block_forward_plain`, ops/cemlp_kernel.py): x, the weights,
// silu.a and the path weight, z, yn and the squared terms of the grade
// norms; in the backward the three cotangents d(first), d(yr) and d(y)
// before they enter a product.  The products are FFMAs of the rounded
// values, exact in fp32, so only the order of the fp32 sums differs from
// a tensor-core product.

#pragma once

#include "cemlp_block.cuh"

namespace {

constexpr int WMAX_C = 128;    // output channels (4 slots of 32 lanes)
constexpr int WMAX_CIN = 320;  // input channels
constexpr int WS = 4;          // channel slots a lane, at most
constexpr int KC = 16;         // rows of a linear a panel holds
constexpr int KQ = KC / 2;     // rows of WL^T and of Wr^T a panel pair holds
constexpr int WG_T = 64;       // input and output channels of a wgrad tile
constexpr int WG_R = 8;        // rows a wgrad stage loads

__host__ __device__ inline int wslots(int c) { return (c + 31) / 32; }

// The parameter image: offsets (floats) of its sections.  Every section is
// rows of cp floats (cp = 32 * slots), so every row starts 16-byte aligned.
// The forward's image is a prefix of the backward's.
struct WLayout {
  int cin, c, s, cp, nblk;   // nblk: blocks of cp output columns of W1^T
  int64_t w1f, wrf, wlf;     // [m][NG][cp]: W[n][m][g] at (m, g, n)
  int64_t b1, sa, sb, nsig, gw, bl, aln;   // [field][cp]
  int64_t wrb, wlb;          // [q][NG][cp]: W[q][m][g] at (q, g, m)
  int64_t w1b;               // [blk][q][NG][cp]: W1[q][blk * cp + m][g]
  int64_t total;
};

template <class A>
__host__ __device__ inline WLayout wlayout(int cin, int c, bool bwd) {
  constexpr int NG = A::NG, NP = A::NP;
  WLayout L;
  L.cin = cin;
  L.c = c;
  L.s = wslots(c);
  L.cp = 32 * L.s;
  L.nblk = (cin + L.cp - 1) / L.cp;
  const int64_t row = (int64_t)NG * L.cp;
  int64_t o = 0;
  L.w1f = o; o += (int64_t)cin * row;
  L.wrf = o; o += (int64_t)c * row;
  L.wlf = o; o += (int64_t)c * row;
  L.b1 = o; o += L.cp;
  L.sa = o; o += NG * L.cp;
  L.sb = o; o += NG * L.cp;
  L.nsig = o; o += NG * L.cp;
  L.gw = o; o += NP * L.cp;
  L.bl = o; o += L.cp;
  L.aln = o; o += L.cp;
  L.wrb = L.wlb = L.w1b = o;
  if (bwd) {
    L.wrb = o; o += (int64_t)c * row;
    L.wlb = o; o += (int64_t)c * row;
    L.w1b = o; o += (int64_t)L.nblk * c * row;
  }
  L.total = o;
  return L;
}

// Shared memory of a launch (floats): the x chunk [ROWS][KC][NB], one
// panel of KC rows of a linear, and the row tiles [ROWS][cp][NB]: z and
// first (the forward), also y, yr and d(yr) (the backward).
template <class A>
__host__ __device__ inline int64_t wide_smem_floats(int c, bool bwd) {
  const int cp = 32 * wslots(c);
  const int64_t tile = (int64_t)ROWS * cp * A::NB;
  return (int64_t)ROWS * KC * A::NB + (int64_t)KC * A::NG * cp +
         (bwd ? 5 : 2) * tile;
}

// The flax-layout gradient vector (as cemlp.cu's grad_floats):
//   dW1 (C, Cin, NG) | db1 (C) | dsilu_a (C, NG) | dsilu_b (C, NG) |
//   dgp_weight (C, NP) | dWr (C, C, NG) | dsigmoid(norm_a) (C, NG) |
//   dWL (C, C, NG) | dbL (C) | dln_a (C)
template <class A>
__host__ __device__ inline int64_t wide_grad_floats(int cin, int c) {
  return (int64_t)c * cin * A::NG + c + 2 * A::NG * c + A::NP * c +
         (int64_t)c * c * A::NG + A::NG * c + (int64_t)c * c * A::NG + 2 * c;
}

// The weight gradients' part of a wgrad slab: dW1 | dWr | dWL, each in
// its flax layout.
template <class A>
__host__ __device__ inline int64_t wide_wpart_floats(int cin, int c) {
  return (int64_t)c * cin * A::NG + 2 * (int64_t)c * c * A::NG;
}

// ---------------------------------------------------------------- the image

// The parameter image of a launch, one thread an element (grid stride).
// Fast mode rounds the weights, silu.a and the path weight to bf16 here.
template <class A, bool FAST>
__global__ void __launch_bounds__(256)
cemlp_wide_pack_kernel(Params p, WLayout L, float* __restrict__ img) {
  constexpr int NG = A::NG, NP = A::NP;
  const int cin = L.cin, c = L.c, cp = L.cp;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < L.total; e += stride) {
    const int col = (int)(e % cp);
    float v = 0.f;
    if (e < L.b1) {   // forward linears: (m, g, n = col)
      const float* w = e < L.wrf ? p.w1 : e < L.wlf ? p.wr : p.wl;
      const int64_t base = e < L.wrf ? L.w1f : e < L.wlf ? L.wrf : L.wlf;
      const int m_in = e < L.wrf ? cin : c;
      const int64_t rr = (e - base) / cp;
      const int g = (int)(rr % NG), m = (int)(rr / NG);
      if (col < c) v = rnd<FAST>(w[((int64_t)col * m_in + m) * NG + g]);
    } else if (e < L.wrb) {   // per-channel rows: (field row, n = col)
      const int n = col;
      if (n < c) {
        if (e < L.sa) {
          v = p.b1[n];
        } else if (e < L.sb) {
          v = rnd<FAST>(p.sa[n * NG + (int)((e - L.sa) / cp)]);
        } else if (e < L.nsig) {
          v = p.sb[n * NG + (int)((e - L.sb) / cp)];
        } else if (e < L.gw) {
          v = 1.f / (1.f + expf(-p.na[n * NG + (int)((e - L.nsig) / cp)]));
        } else if (e < L.bl) {
          v = rnd<FAST>(p.gw[n * NP + (int)((e - L.gw) / cp)]);
        } else if (e < L.aln) {
          v = p.bl[n];
        } else {
          v = p.aln[n];
        }
      }
    } else if (e < L.w1b) {   // WL^T / Wr^T: (q, g, m = col)
      const float* w = e < L.wlb ? p.wr : p.wl;
      const int64_t rr = (e - (e < L.wlb ? L.wrb : L.wlb)) / cp;
      const int g = (int)(rr % NG), q = (int)(rr / NG);
      if (col < c) v = rnd<FAST>(w[((int64_t)q * c + col) * NG + g]);
    } else {   // W1^T in column blocks: (blk, q, g, m = blk * cp + col)
      const int64_t rr = (e - L.w1b) / cp;
      const int g = (int)(rr % NG), q = (int)((rr / NG) % c),
                blk = (int)(rr / ((int64_t)NG * c));
      const int m = blk * cp + col;
      if (m < cin) v = rnd<FAST>(p.w1[((int64_t)q * cin + m) * NG + g]);
    }
    img[e] = v;
  }
}

// --------------------------------------------------------- the step's parts

struct WSmem {
  float *xs, *pan, *zs, *fs, *ys, *rs, *ds;
};

template <class A>
__device__ inline WSmem carve_wide(float* base, int cp, bool bwd) {
  constexpr int NB = A::NB;
  const int64_t tile = (int64_t)ROWS * cp * NB;
  WSmem s;
  s.xs = base;
  s.pan = s.xs + ROWS * KC * NB;
  s.zs = s.pan + (int64_t)KC * A::NG * cp;
  s.fs = s.zs + tile;
  s.ys = s.rs = s.ds = nullptr;
  if (bwd) {
    s.ys = s.fs + tile;
    s.rs = s.ys + tile;
    s.ds = s.rs + tile;
  }
  return s;
}

// n floats (a multiple of 4, 16-byte aligned) from global memory into
// shared memory, all threads of the CTA.
__device__ __forceinline__ void stage4(float* dst,
                                       const float* __restrict__ src, int n) {
  const int tid = threadIdx.x + 32 * threadIdx.y;
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll 4
  for (int e = tid; e < n / 4; e += THREADS) d[e] = __ldg(s + e);
}

// Input channels [k0, k0 + kn) of the step's rows into xs [r][k][i]
// (rounded in fast mode), rows past `rows` zero.
template <class A, bool FAST>
__device__ __forceinline__ void load_x_rows(const float* __restrict__ x,
                                            float* xs, int64_t row0, int rows,
                                            int cin, int k0, int kn) {
  constexpr int NB = A::NB;
  const int tid = threadIdx.x + 32 * threadIdx.y;
  const int per4 = kn * NB / 4;
  for (int e = tid; e < ROWS * per4; e += THREADS) {
    const int r = e / per4, q = e % per4;
    const int64_t row = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows)
      v = __ldg(reinterpret_cast<const float4*>(
                    x + (row * cin + k0) * NB) + q);
    v.x = rnd<FAST>(v.x);
    v.y = rnd<FAST>(v.y);
    v.z = rnd<FAST>(v.z);
    v.w = rnd<FAST>(v.w);
    reinterpret_cast<float4*>(xs + r * KC * NB)[q] = v;
  }
}

// acc[u][i] += sum over k < kn of row[k][i] * pan[k][grade(i)][lane + 32u]
// for the lane's s slots: one channel-mixing product of one row (row: the
// row's values of kn channels, NB floats each, a broadcast; pan: kn rows
// of a linear's image).
template <class A>
__device__ __forceinline__ void mix(float (&acc)[WS][A::NB],
                                    const float* row, const float* pan,
                                    int kn, int cp, int s, int lane) {
  constexpr int NB = A::NB, NG = A::NG;
#pragma unroll 2
  for (int k = 0; k < kn; ++k) {
    float xv[NB];
    const float4* xp = reinterpret_cast<const float4*>(row + k * NB);
#pragma unroll
    for (int v = 0; v < NB / 4; ++v) {
      const float4 t = xp[v];
      xv[4 * v] = t.x;
      xv[4 * v + 1] = t.y;
      xv[4 * v + 2] = t.z;
      xv[4 * v + 3] = t.w;
    }
    const float* w = pan + (int64_t)k * NG * cp + lane;
#pragma unroll
    for (int u = 0; u < WS; ++u) {
      if (u < s) {
        float wg[NG];
#pragma unroll
        for (int g = 0; g < NG; ++g) wg[g] = w[g * cp + 32 * u];
#pragma unroll
        for (int i = 0; i < NB; ++i)
          acc[u][i] = fmaf(xv[i], wg[grade<A>(i)], acc[u][i]);
      }
    }
  }
}

template <class A>
__device__ __forceinline__ void zero_acc(float (&acc)[WS][A::NB]) {
#pragma unroll
  for (int u = 0; u < WS; ++u)
#pragma unroll
    for (int i = 0; i < A::NB; ++i) acc[u][i] = 0.f;
}

// Where a linear's input rows come from.  A staged source loads the
// step's rows a chunk of kn input channels at a time into xs (all threads
// of the CTA; K2w/K3w read x in global memory, K4w gathers it), and a warp
// reads its row there; TileRows is the warp's row already in a
// shared-memory tile [channel][NB].
template <class A, bool FAST>
struct XRows {
  const float* __restrict__ x;
  int64_t row0;
  int rows, cin;
  __device__ __forceinline__ void load(float* xs, int k0, int kn) const {
    load_x_rows<A, FAST>(x, xs, row0, rows, cin, k0, kn);
  }
  __device__ __forceinline__ const float* at(const float* xs, int warp,
                                             int) const {
    return xs + warp * KC * A::NB;
  }
};

template <class A>
struct TileRows {
  const float* row;
  __device__ __forceinline__ void load(float*, int, int) const {}
  __device__ __forceinline__ const float* at(const float*, int,
                                             int k0) const {
    return row + k0 * A::NB;
  }
};

// One linear over the step's rows, acc = the rows of `src` times the
// linear whose image rows start at `w`; the panels are staged by all
// threads of the CTA.
template <class A, class Src>
__device__ __forceinline__ void linear_rows(float (&acc)[WS][A::NB],
                                            const Src& src,
                                            const float* __restrict__ w,
                                            const WSmem& sm, const WLayout& L,
                                            int k_in, int warp, int lane) {
  constexpr int NB = A::NB, NG = A::NG;
  zero_acc<A>(acc);
  for (int k0 = 0; k0 < k_in; k0 += KC) {
    const int kn = k_in - k0 < KC ? k_in - k0 : KC;
    __syncthreads();   // the previous panel (and x chunk) consumed
    src.load(sm.xs, k0, kn);
    stage4(sm.pan, w + (int64_t)k0 * NG * L.cp, kn * NG * L.cp);
    __syncthreads();
    mix<A>(acc, src.at(sm.xs, warp, k0), sm.pan, kn, L.cp, L.s, lane);
  }
}

// MVSiLU's gates of a (row, channel) from its linear output y (bias in).
template <class A, bool FAST>
__device__ __forceinline__ void wide_gates(const float (&y)[A::NB],
                                           const float* __restrict__ img,
                                           const WLayout& L,
                                           const Tabs<A>& tb, int n,
                                           float (&inv)[A::NG],
                                           float (&sg)[A::NG]) {
#pragma unroll
  for (int g = 0; g < A::NG; ++g) inv[g] = 0.f;
  inv[0] = rnd<FAST>(y[0]);
#pragma unroll
  for (int i = 1; i < A::NB; ++i)
    inv[grade<A>(i)] += rnd<FAST>(y[i] * y[i] * tb.bc[i]);
#pragma unroll
  for (int g = 0; g < A::NG; ++g) {
    const float gate = __ldg(img + L.sa + g * L.cp + n) * inv[g] +
                       __ldg(img + L.sb + g * L.cp + n);
    sg[g] = 1.f / (1.f + expf(-gate));
  }
}

// The step's block up to the right linear: y = x W1 + b1 with x the rows
// of `src` (y into ys where the backward keeps it), z = MVSiLU(y) into zs
// (rounded in fast mode), first = z WL + bL into fs; returns yr = z Wr in
// acc.
template <class A, bool FAST, bool BWD, class Src>
__device__ __forceinline__ void wide_front(float (&acc)[WS][A::NB],
                                           const Src& src,
                                           const float* __restrict__ img,
                                           const WLayout& L,
                                           const Tabs<A>& tb, const WSmem& sm,
                                           int warp, int lane) {
  constexpr int NB = A::NB, NG = A::NG;
  const int cp = L.cp;
  float* zr = sm.zs + (int64_t)warp * cp * NB;
  float* fr = sm.fs + (int64_t)warp * cp * NB;
  linear_rows<A>(acc, src, img + L.w1f, sm, L, L.cin, warp, lane);
#pragma unroll
  for (int u = 0; u < WS; ++u) {
    if (u >= L.s) continue;
    const int n = lane + 32 * u;
    float y[NB], inv[NG], sg[NG];
#pragma unroll
    for (int i = 0; i < NB; ++i) y[i] = acc[u][i];
    y[0] += __ldg(img + L.b1 + n);
    wide_gates<A, FAST>(y, img, L, tb, n, inv, sg);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      zr[n * NB + i] = rnd<FAST>(sg[grade<A>(i)] * y[i]);
      if (BWD) sm.ys[((int64_t)warp * cp + n) * NB + i] = y[i];
    }
  }
  linear_rows<A>(acc, TileRows<A>{zr}, img + L.wlf, sm, L, L.c, warp, lane);
#pragma unroll
  for (int u = 0; u < WS; ++u) {
    if (u >= L.s) continue;
    const int n = lane + 32 * u;
    const float bl = __ldg(img + L.bl + n);
#pragma unroll
    for (int i = 0; i < NB; ++i)
      fr[n * NB + i] = acc[u][i] + (i == 0 ? bl : 0.f);
  }
  linear_rows<A>(acc, TileRows<A>{zr}, img + L.wrf, sm, L, L.c, warp, lane);
}

// The row phase's forward state of one (row, channel).
template <class A>
struct WPost {
  float yr[A::NB], zr[A::NB], yn[A::NB], ynr[A::NB], o[A::NB];
  float qg[A::NG], s1g[A::NG], nr[A::NG], den[A::NG];
  float qc, s1c, nc;
};

// From yr, first (frow) and z (zrow) of a (row, channel n): the right
// operand's normalisation, the weighted geometric product in the Cayley
// pair form, + first, / sqrt 2, and the layer norm's per-channel norm.
template <class A, bool FAST>
__device__ __forceinline__ void wide_post(WPost<A>& f, const float (&yr)[A::NB],
                                          const float* frow, const float* zrow,
                                          const float* __restrict__ img,
                                          const WLayout& L, const Tabs<A>& tb,
                                          int n) {
  constexpr int NB = A::NB, NG = A::NG, NP = A::NP;
  float first[NB], gw[NP];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    f.yr[i] = yr[i];
    first[i] = frow[i];
    f.zr[i] = zrow[i];
  }
#pragma unroll
  for (int q = 0; q < NP; ++q) gw[q] = __ldg(img + L.gw + q * L.cp + n);
#pragma unroll
  for (int g = 0; g < NG; ++g) f.qg[g] = 0.f;
#pragma unroll
  for (int i = 0; i < NB; ++i)
    f.qg[grade<A>(i)] += rnd<FAST>(f.yr[i] * f.yr[i] * tb.bc[i]);
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    f.s1g[g] = sqrtf(f.qg[g] * f.qg[g] + 1e-16f);
    f.nr[g] = sqrtf(f.s1g[g]);
    f.den[g] =
        __ldg(img + L.nsig + g * L.cp + n) * (f.nr[g] - 1.f) + 1.f + EPS;
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    f.yn[i] = f.yr[i] / f.den[grade<A>(i)];
    f.ynr[i] = rnd<FAST>(f.yn[i]);
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    float gp = 0.f;
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const int i = i_of<A>(j, k);
      const float cw = tb.sign[j * NB + k] *
                       gw[A::path_id(grade<A>(i), grade<A>(j), grade<A>(k))];
      gp += cw * f.zr[i] * f.ynr[k];
    }
    f.o[j] = (first[j] + gp) * SQRT2_INV;
  }
  f.qc = 0.f;
#pragma unroll
  for (int i = 0; i < NB; ++i) f.qc += rnd<FAST>(f.o[i] * f.o[i] * tb.bc[i]);
  f.s1c = sqrtf(f.qc * f.qc + 1e-16f);
  f.nc = sqrtf(f.s1c);
}

// --------------------------------------------------------------- K2w

// The forward's row phase after wide_front: o of each of the lane's
// channels into acc (from yr in acc, first and z in the warp's tiles),
// and the layer norm's mean over the row's channels (shuffles); the
// block's output is aln / mean * o.
template <class A, bool FAST>
__device__ __forceinline__ float wide_out(float (&acc)[WS][A::NB],
                                          const float* __restrict__ img,
                                          const WLayout& L, const Tabs<A>& tb,
                                          const WSmem& sm, int warp,
                                          int lane) {
  constexpr int NB = A::NB;
  const float* fr = sm.fs + (int64_t)warp * L.cp * NB;
  const float* zr = sm.zs + (int64_t)warp * L.cp * NB;
  float tot = 0.f;
#pragma unroll
  for (int u = 0; u < WS; ++u) {
    if (u >= L.s) continue;
    const int n = lane + 32 * u;
    WPost<A> f;
    wide_post<A, FAST>(f, acc[u], fr + n * NB, zr + n * NB, img, L, tb, n);
#pragma unroll
    for (int i = 0; i < NB; ++i) acc[u][i] = f.o[i];
    if (n < L.c) tot += f.nc;
  }
  return warp_sum(tot) / (float)L.c + EPS;
}

// A CTA walks over steps of ROWS rows: wide_front, then the row phase (a
// warp its row: the mean over the slots by shuffles) writes the block's
// output aln / mean * o, a lane its channels' NB floats.
template <class A, bool FAST>
__global__ void __launch_bounds__(THREADS, 2)
cemlp_wide_fwd_kernel(const float* __restrict__ x,
                      const float* __restrict__ img, Tabs<A> tb,
                      float* __restrict__ out, int rows, WLayout L) {
  constexpr int NB = A::NB;
  extern __shared__ __align__(16) float smem[];
  const WSmem sm = carve_wide<A>(smem, L.cp, false);
  const int warp = threadIdx.y, lane = threadIdx.x, c = L.c;
  const int n_tiles = (rows + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = (int64_t)tile * ROWS, row = row0 + warp;
    float acc[WS][NB];
    wide_front<A, FAST, false>(acc, XRows<A, FAST>{x, row0, rows, L.cin},
                               img, L, tb, sm, warp, lane);
    const float mean = wide_out<A, FAST>(acc, img, L, tb, sm, warp, lane);
    if (row >= rows) continue;
#pragma unroll
    for (int u = 0; u < WS; ++u) {
      const int n = lane + 32 * u;
      if (u >= L.s || n >= c) continue;
      const float scale = __ldg(img + L.aln + n) / mean;
      float4* d = reinterpret_cast<float4*>(out + (row * c + n) * NB);
#pragma unroll
      for (int v = 0; v < NB / 4; ++v)
        d[v] = make_float4(scale * acc[u][4 * v], scale * acc[u][4 * v + 1],
                           scale * acc[u][4 * v + 2],
                           scale * acc[u][4 * v + 3]);
    }
  }
}

// --------------------------------------------------------------- K3w

// The per-channel gradient of field f and channel n in a warp's slab
// ([Loc::N][C]): a += v (the slab's one owner of the value).
__device__ __forceinline__ void slab_add(float* slab, int f, int c, int n,
                                         float v) {
  slab[f * c + n] += v;
}

// A CTA walks over steps of ROWS rows: wide_front; the row phase's
// backward (first each row's mean and d(mean) over its slots, then each
// channel: d(first), d(yr) and the product's d(z)); d(z) += d(first) WL^T
// + d(yr) Wr^T; MVSiLU's backward -> d(y); the rows of z, d(y), d(yr) and
// d(first) to the scratch (each rows x C x NB, in that order); dx = d(y)
// W1^T in blocks of cp input channels.  The per-channel gradients add
// into the warp's slab of lpart ([CTA][warp][Loc::N][C]).
template <class A, bool FAST>
__global__ void __launch_bounds__(THREADS, 1)
cemlp_wide_bwd_kernel(const float* __restrict__ x,
                      const float* __restrict__ dout,
                      const float* __restrict__ img, Tabs<A> tb,
                      float* __restrict__ dx, float* __restrict__ scratch,
                      float* __restrict__ lpart, int rows, WLayout L) {
  constexpr int NB = A::NB, NG = A::NG, NP = A::NP;
  using LC = Loc<A>;
  extern __shared__ __align__(16) float smem[];
  const WSmem sm = carve_wide<A>(smem, L.cp, true);
  const int warp = threadIdx.y, lane = threadIdx.x, c = L.c, cp = L.cp,
            cin = L.cin;
  float* slab = lpart + ((int64_t)blockIdx.x * ROWS + warp) * LC::N * c;
  for (int f = 0; f < LC::N; ++f)
    for (int n = lane; n < c; n += 32) slab[f * c + n] = 0.f;
  const int64_t plane = (int64_t)rows * c * NB;
  float* zsc = scratch;
  float* dysc = scratch + plane;
  float* drsc = scratch + 2 * plane;
  float* dfsc = scratch + 3 * plane;
  float* zr = sm.zs + (int64_t)warp * cp * NB;
  float* fr = sm.fs + (int64_t)warp * cp * NB;
  float* yrw = sm.ys + (int64_t)warp * cp * NB;
  float* rr = sm.rs + (int64_t)warp * cp * NB;
  float* dr = sm.ds + (int64_t)warp * cp * NB;

  const int n_tiles = (rows + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = (int64_t)tile * ROWS, row = row0 + warp;
    const bool live = row < rows;
    float acc[WS][NB];
    wide_front<A, FAST, true>(acc, XRows<A, FAST>{x, row0, rows, cin}, img,
                              L, tb, sm, warp, lane);
#pragma unroll
    for (int u = 0; u < WS; ++u) {
      if (u >= L.s) continue;
      const int n = lane + 32 * u;
#pragma unroll
      for (int i = 0; i < NB; ++i) rr[n * NB + i] = acc[u][i];
    }
    // ---- the row's sums: the mean and d(mean)
    float tot = 0.f, tt = 0.f;
#pragma unroll
    for (int u = 0; u < WS; ++u) {
      const int n = lane + 32 * u;
      if (u >= L.s || n >= c) continue;
      WPost<A> f;
      float yr[NB];
#pragma unroll
      for (int i = 0; i < NB; ++i) yr[i] = rr[n * NB + i];
      wide_post<A, FAST>(f, yr, fr + n * NB, zr + n * NB, img, L, tb, n);
      tot += f.nc;
      if (live) {
        const float aln = __ldg(img + L.aln + n);
#pragma unroll
        for (int i = 0; i < NB; ++i)
          tt += dout[(row * c + n) * NB + i] * aln * f.o[i];
      }
    }
    const float mean = warp_sum(tot) / (float)c + EPS;
    const float dm = -warp_sum(tt) / (mean * mean);
    // ---- each channel: layer norm, product and normalisation backward
#pragma unroll
    for (int u = 0; u < WS; ++u) {
      const int n = lane + 32 * u;
      if (u >= L.s || n >= c) continue;
      WPost<A> f;
      float yr[NB], go[NB], gw[NP];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        yr[i] = rr[n * NB + i];
        go[i] = live ? dout[(row * c + n) * NB + i] : 0.f;
      }
      wide_post<A, FAST>(f, yr, fr + n * NB, zr + n * NB, img, L, tb, n);
#pragma unroll
      for (int q = 0; q < NP; ++q) gw[q] = __ldg(img + L.gw + q * cp + n);
      const float aln = __ldg(img + L.aln + n);
      float ta = 0.f;
#pragma unroll
      for (int i = 0; i < NB; ++i) ta += go[i] * f.o[i];
      const float dqc =
          rnd<FAST>(dm / (float)c * 0.5f * f.qc / (f.s1c * f.nc));
      float dfr[NB], dz[NB], dyn[NB], pgw[NP];
      float pbl = 0.f;
#pragma unroll
      for (int q = 0; q < NP; ++q) pgw[q] = 0.f;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const float d_o = aln * go[i] / mean + dqc * 2.f * tb.bc[i] * f.o[i];
        const float dfg = d_o * SQRT2_INV;
        if (i == 0) pbl = dfg;
        dfr[i] = rnd<FAST>(dfg);
        fr[n * NB + i] = dfr[i];   // first -> d(first)
        dz[i] = 0.f;
        dyn[i] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int k = 0; k < NB; ++k) {
          const int i = i_of<A>(j, k);
          const int q = A::path_id(grade<A>(i), grade<A>(j), grade<A>(k));
          const float t1 = dfr[j] * tb.sign[j * NB + k];
          const float t1g = t1 * gw[q];
          dz[i] = fmaf(t1g, f.ynr[k], dz[i]);
          dyn[k] = fmaf(t1g, f.zr[i], dyn[k]);
          pgw[q] = fmaf(t1 * f.zr[i], f.ynr[k], pgw[q]);
        }
      }
      float dden[NG], dyr[NB], dqg[NG], pns[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g) dden[g] = 0.f;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const float dn = f.den[grade<A>(i)];
        dyr[i] = dyn[i] / dn;
        dden[grade<A>(i)] -= dyn[i] * f.yn[i] / dn;
      }
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        pns[g] = dden[g] * (f.nr[g] - 1.f);
        const float dnr = dden[g] * __ldg(img + L.nsig + g * cp + n);
        dqg[g] = rnd<FAST>(dnr * 0.5f * f.qg[g] / (f.s1g[g] * f.nr[g]));
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        dyr[i] += dqg[grade<A>(i)] * 2.f * tb.bc[i] * f.yr[i];
        dr[n * NB + i] = rnd<FAST>(dyr[i]);
        rr[n * NB + i] = dz[i];   // yr -> the product's d(z)
      }
      if (live) {
        slab_add(slab, LC::ALN, c, n, ta / mean);
        slab_add(slab, LC::BL, c, n, pbl);
#pragma unroll
        for (int q = 0; q < NP; ++q) slab_add(slab, LC::GW + q, c, n, pgw[q]);
#pragma unroll
        for (int g = 0; g < NG; ++g) slab_add(slab, LC::NS + g, c, n, pns[g]);
      }
    }
    // ---- d(z) += d(first) WL^T + d(yr) Wr^T
#pragma unroll
    for (int u = 0; u < WS; ++u) {
      const int n = lane + 32 * u;
#pragma unroll
      for (int i = 0; i < NB; ++i)
        acc[u][i] = u < L.s && n < c ? rr[n * NB + i] : 0.f;
    }
    for (int q0 = 0; q0 < c; q0 += KQ) {
      const int kq = c - q0 < KQ ? c - q0 : KQ;
      __syncthreads();
      stage4(sm.pan, img + L.wlb + (int64_t)q0 * NG * cp, kq * NG * cp);
      stage4(sm.pan + KQ * NG * cp, img + L.wrb + (int64_t)q0 * NG * cp,
             kq * NG * cp);
      __syncthreads();
      mix<A>(acc, fr + q0 * NB, sm.pan, kq, cp, L.s, lane);
      mix<A>(acc, dr + q0 * NB, sm.pan + KQ * NG * cp, kq, cp, L.s, lane);
    }
    // ---- MVSiLU's backward: d(y) over y in ys; the cotangent rows out
#pragma unroll
    for (int u = 0; u < WS; ++u) {
      const int n = lane + 32 * u;
      if (u >= L.s || n >= c) continue;
      float y[NB], inv[NG], sg[NG], dy[NB], dgs[NG], dgr[NG];
#pragma unroll
      for (int i = 0; i < NB; ++i) y[i] = yrw[n * NB + i];
      wide_gates<A, FAST>(y, img, L, tb, n, inv, sg);
#pragma unroll
      for (int g = 0; g < NG; ++g) { dgs[g] = 0.f; dgr[g] = 0.f; }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const float sv = sg[grade<A>(i)], dzv = acc[u][i];
        dy[i] = dzv * sv;
        const float dgate = dzv * y[i] * sv * (1.f - sv);
        dgs[grade<A>(i)] += dgate;
        dgr[grade<A>(i)] += rnd<FAST>(dgate);
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const float dv = __ldg(img + L.sa + grade<A>(i) * cp + n) *
                         dgr[grade<A>(i)];
        dy[i] += (i == 0) ? dv : 2.f * tb.bc[i] * y[i] * dv;
      }
      if (live) {
        slab_add(slab, LC::B1, c, n, dy[0]);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          slab_add(slab, LC::SB + g, c, n, dgs[g]);
          slab_add(slab, LC::SA + g, c, n, inv[g] * dgr[g]);
        }
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) yrw[n * NB + i] = rnd<FAST>(dy[i]);
      if (live) {
        const int64_t o = (row * c + n) * NB;
#pragma unroll
        for (int v = 0; v < NB / 4; ++v) {
          const int i = 4 * v;
          reinterpret_cast<float4*>(zsc + o)[v] = make_float4(
              zr[n * NB + i], zr[n * NB + i + 1], zr[n * NB + i + 2],
              zr[n * NB + i + 3]);
          reinterpret_cast<float4*>(dysc + o)[v] = make_float4(
              yrw[n * NB + i], yrw[n * NB + i + 1], yrw[n * NB + i + 2],
              yrw[n * NB + i + 3]);
          reinterpret_cast<float4*>(drsc + o)[v] = make_float4(
              dr[n * NB + i], dr[n * NB + i + 1], dr[n * NB + i + 2],
              dr[n * NB + i + 3]);
          reinterpret_cast<float4*>(dfsc + o)[v] = make_float4(
              fr[n * NB + i], fr[n * NB + i + 1], fr[n * NB + i + 2],
              fr[n * NB + i + 3]);
        }
      }
    }
    // ---- dx = d(y) W1^T, blocks of cp input channels
    for (int blk = 0; blk < L.nblk; ++blk) {
      linear_rows<A>(acc, TileRows<A>{yrw},
                     img + L.w1b + (int64_t)blk * c * NG * cp, sm, L, c, warp,
                     lane);
      if (!live) continue;
#pragma unroll
      for (int u = 0; u < WS; ++u) {
        const int m = blk * cp + lane + 32 * u;
        if (u >= L.s || m >= cin) continue;
        float4* d = reinterpret_cast<float4*>(dx + (row * cin + m) * NB);
#pragma unroll
        for (int v = 0; v < NB / 4; ++v)
          d[v] = make_float4(acc[u][4 * v], acc[u][4 * v + 1],
                             acc[u][4 * v + 2], acc[u][4 * v + 3]);
      }
    }
  }
}

// The weight gradients over the scratch: CTA (job, split) takes the tile
// of WG_T input channels x WG_T output channels of job (dW1: x against
// d(y); dWr: z against d(yr); dWL: z against d(first)), all grades, over
// the rows [split * chunk, (split + 1) * chunk), a thread 4 x 4 channels,
// and writes it into its split's slab of wpart (dW1 | dWr | dWL, flax
// layouts).  Fast mode rounds x on load (the scratch rows are rounded).
template <class A, bool FAST>
__global__ void __launch_bounds__(256)
cemlp_wide_wgrad_kernel(const float* __restrict__ x,
                        const float* __restrict__ scratch,
                        float* __restrict__ wpart, int rows, int cin, int c,
                        int chunk) {
  constexpr int NB = A::NB, NG = A::NG;
  __shared__ __align__(16) float as[WG_R * NB * WG_T];
  __shared__ __align__(16) float bs[WG_R * NB * WG_T];
  const int mt0 = (cin + WG_T - 1) / WG_T, mt1 = (c + WG_T - 1) / WG_T,
            nt = mt1;
  int job = blockIdx.x, which, mt, ntile;
  if (job < mt0 * nt) {
    which = 0;
  } else {
    job -= mt0 * nt;
    which = 1 + job / (mt1 * nt);
    job %= mt1 * nt;
  }
  mt = job / nt;
  ntile = job % nt;
  const int M = which == 0 ? cin : c;
  const int64_t plane = (int64_t)rows * c * NB;
  const float* a = which == 0 ? x : scratch;
  const float* b = scratch + (which == 0 ? 1 : which == 1 ? 2 : 3) * plane;
  const int m0 = mt * WG_T, n0 = ntile * WG_T;
  const int64_t r_begin = (int64_t)blockIdx.y * chunk;
  const int64_t r_end = r_begin + chunk < rows ? r_begin + chunk : rows;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4][NG];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int g = 0; g < NG; ++g) acc[p][q][g] = 0.f;
  for (int64_t r0 = r_begin; r0 < r_end; r0 += WG_R) {
    __syncthreads();
    for (int e = tid; e < WG_R * WG_T * NB; e += 256) {
      const int r = e / (WG_T * NB), q = e % (WG_T * NB);
      const int mm = q / NB, i = q % NB;
      const int64_t row = r0 + r;
      const bool in = row < r_end;
      float va = in && m0 + mm < M ? a[(row * M + m0 + mm) * NB + i] : 0.f;
      if (which == 0) va = rnd<FAST>(va);
      as[(r * NB + i) * WG_T + mm] = va;
      bs[(r * NB + i) * WG_T + mm] =
          in && n0 + mm < c ? b[(row * c + n0 + mm) * NB + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < WG_R; ++r) {
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const float4 av =
            reinterpret_cast<const float4*>(as + (r * NB + i) * WG_T)[tx];
        const float4 bv =
            reinterpret_cast<const float4*>(bs + (r * NB + i) * WG_T)[ty];
        const float ax[4] = {av.x, av.y, av.z, av.w};
        const float bx[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[p][q][grade<A>(i)] =
                fmaf(ax[p], bx[q], acc[p][q][grade<A>(i)]);
      }
    }
  }
  float* out = wpart + (int64_t)blockIdx.y * wide_wpart_floats<A>(cin, c);
  const int64_t off = which == 0 ? 0
                      : which == 1 ? (int64_t)c * cin * NG
                                   : (int64_t)c * cin * NG +
                                         (int64_t)c * c * NG;
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + 4 * tx + p, n = n0 + 4 * ty + q;
      if (m >= M || n >= c) continue;
#pragma unroll
      for (int g = 0; g < NG; ++g)
        out[off + ((int64_t)n * M + m) * NG + g] = acc[p][q][g];
    }
}

// The gradient vector (flax layout, wide_grad_floats) from the slabs: the
// weight gradients summed over the wgrad splits, the per-channel ones
// over the row kernel's warps, each in slab order; with `accum` added
// onto the vector's values (K5w sums its slabs of edge rows so, in order).
template <class A>
__global__ void __launch_bounds__(256)
cemlp_wide_reduce_kernel(const float* __restrict__ wpart, int splits,
                         const float* __restrict__ lpart, int nloc,
                         float* __restrict__ grads, int cin, int c,
                         int accum) {
  constexpr int NG = A::NG, NP = A::NP;
  using LC = Loc<A>;
  int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= wide_grad_floats<A>(cin, c)) return;
  const int64_t nw = wide_wpart_floats<A>(cin, c);
  const int64_t w1 = (int64_t)c * cin * NG, wc = (int64_t)c * c * NG;
  int64_t w = -1;   // index in a wgrad slab, or -1: a per-channel value
  int field = 0, n = 0;
  int64_t e = q;
  if (e < w1) {
    w = e;
  } else if ((e -= w1) < c) {
    field = LC::B1; n = (int)e;
  } else if ((e -= c) < NG * c) {
    field = LC::SA + (int)(e % NG); n = (int)(e / NG);
  } else if ((e -= NG * c) < NG * c) {
    field = LC::SB + (int)(e % NG); n = (int)(e / NG);
  } else if ((e -= NG * c) < NP * c) {
    field = LC::GW + (int)(e % NP); n = (int)(e / NP);
  } else if ((e -= NP * c) < wc) {
    w = w1 + e;
  } else if ((e -= wc) < NG * c) {
    field = LC::NS + (int)(e % NG); n = (int)(e / NG);
  } else if ((e -= NG * c) < wc) {
    w = w1 + wc + e;
  } else if ((e -= wc) < c) {
    field = LC::BL; n = (int)e;
  } else {
    field = LC::ALN; n = (int)(e - c);
  }
  float acc = 0.f;
  if (w >= 0) {
    for (int p = 0; p < splits; ++p) acc += wpart[(int64_t)p * nw + w];
  } else {
    for (int l = 0; l < nloc; ++l)
      acc += lpart[((int64_t)l * LC::N + field) * c + n];
  }
  grads[q] = accum ? grads[q] + acc : acc;
}

// ------------------------------------------------------------------ host

template <class A>
bool wide_ok(int cin, int c) {
  return cin >= 1 && c >= 1 && c <= WMAX_C && cin <= WMAX_CIN;
}

template <class A>
size_t wide_smem_bytes(int cin, int c, int backward) {
  if (!wide_ok<A>(cin, c)) return 0;
  return sizeof(float) * (size_t)wide_smem_floats<A>(c, backward != 0);
}

template <class A>
long long wide_img_floats(int cin, int c, int backward) {
  if (!wide_ok<A>(cin, c)) return 0;
  return (long long)wlayout<A>(cin, c, backward != 0).total;
}

template <class A>
int wide_wgrad_jobs(int cin, int c) {
  const int mt0 = (cin + WG_T - 1) / WG_T, mt1 = (c + WG_T - 1) / WG_T;
  return mt1 * (mt0 + 2 * mt1);
}

// Row splits of the weight-gradient kernel: about two CTAs an SM, each
// over at least 64 rows.
template <class A>
int wide_wgrad_splits(int rows, int cin, int c, int sms) {
  if (!wide_ok<A>(cin, c)) return 0;
  const int jobs = wide_wgrad_jobs<A>(cin, c);
  int p = (2 * sms + jobs - 1) / jobs;
  const int most = (rows + 63) / 64;
  if (p > most) p = most;
  return p < 1 ? 1 : p;
}

template <class A, bool FAST>
void launch_pack(const Params& p, const WLayout& L, float* img,
                 cudaStream_t st) {
  int64_t blocks = (L.total + 255) / 256;
  if (blocks > 2048) blocks = 2048;
  cemlp_wide_pack_kernel<A, FAST><<<(unsigned)blocks, 256, 0, st>>>(p, L, img);
}

template <class A, bool FAST>
void launch_wide_fwd(const float* x, const Params& p, const Tabs<A>& tb,
                     float* out, float* img, int rows, const WLayout& L,
                     int grid, size_t bytes, cudaStream_t st) {
  launch_pack<A, FAST>(p, L, img, st);
  cudaFuncSetAttribute(cemlp_wide_fwd_kernel<A, FAST>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  cemlp_wide_fwd_kernel<A, FAST>
      <<<grid, dim3(32, ROWS), bytes, st>>>(x, img, tb, out, rows, L);
}

template <class A>
int wide_fwd(const float* x, const Params& p, const float* bc,
             const float* sign, float* out, float* img, int rows, int cin,
             int c, int fast, int grid, void* stream) {
  const size_t bytes = wide_smem_bytes<A>(cin, c, 0);
  if (bytes == 0 || bytes > kMaxSmem || grid < 1)
    return (int)cudaErrorInvalidValue;
  const WLayout L = wlayout<A>(cin, c, false);
  const Tabs<A> tb = make_tabs<A>(bc, sign);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    if (fast)
      launch_wide_fwd<A, true>(x, p, tb, out, img, rows, L, grid, bytes, st);
    else
      launch_wide_fwd<A, false>(x, p, tb, out, img, rows, L, grid, bytes, st);
  }
  return (int)cudaGetLastError();
}

template <class A, bool FAST>
void launch_wide_bwd(const float* x, const float* dout, const Params& p,
                     const Tabs<A>& tb, float* dx, float* img, float* scratch,
                     float* lpart, float* wpart, int rows, const WLayout& L,
                     int grid, int splits, size_t bytes, cudaStream_t st) {
  launch_pack<A, FAST>(p, L, img, st);
  cudaFuncSetAttribute(cemlp_wide_bwd_kernel<A, FAST>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  cemlp_wide_bwd_kernel<A, FAST><<<grid, dim3(32, ROWS), bytes, st>>>(
      x, dout, img, tb, dx, scratch, lpart, rows, L);
  const int chunk = (rows + splits - 1) / splits;
  cemlp_wide_wgrad_kernel<A, FAST>
      <<<dim3(wide_wgrad_jobs<A>(L.cin, L.c), splits), 256, 0, st>>>(
          x, scratch, wpart, rows, L.cin, L.c, chunk < 1 ? 1 : chunk);
}

template <class A>
int wide_bwd(const float* x, const float* dout, const Params& p,
             const float* bc, const float* sign, float* dx, float* img,
             float* scratch, float* lpart, float* wpart, float* grads,
             int rows, int cin, int c, int fast, int grid, int splits,
             void* stream) {
  const size_t bytes = wide_smem_bytes<A>(cin, c, 1);
  if (bytes == 0 || bytes > kMaxSmem || grid < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  const WLayout L = wlayout<A>(cin, c, true);
  const Tabs<A> tb = make_tabs<A>(bc, sign);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fast)
    launch_wide_bwd<A, true>(x, dout, p, tb, dx, img, scratch, lpart, wpart,
                             rows, L, grid, splits, bytes, st);
  else
    launch_wide_bwd<A, false>(x, dout, p, tb, dx, img, scratch, lpart, wpart,
                              rows, L, grid, splits, bytes, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = wide_grad_floats<A>(cin, c);
  cemlp_wide_reduce_kernel<A><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      wpart, splits, lpart, grid * ROWS, grads, cin, c, 0);
  return (int)cudaGetLastError();
}

}  // namespace

// One set of C entry points per algebra: csmpn_cemlp_wide_* (Cl(3,0),
// cemlp_wide.cu) and csmpn_cemlp_wide_cl2_* (Cl(2,0), cemlp_wide_cl2.cu).
// The 10 block parameters are device pointers in flax order (w1 b1 sa sb
// gw wr na wl bl aln); x (rows, cin, NB) fp32, out (rows, c, NB); img the
// parameter image (img_floats of the direction).  The backward writes dx
// (rows, cin, NB) and grads (cemlp.cu's grad_floats layout), with scratch
// (4 x rows x c x NB), lpart (grid x 8 x loc_floats) and wpart (splits x
// wpart_floats) as scratch; splits from wgrad_splits.  The size entries
// return long long; smem_bytes gives a launch's shared memory, 0 where
// the widths are outside C <= WMAX_C, Cin <= WMAX_CIN, which the range
// entry writes (out[0] = WMAX_C, out[1] = WMAX_CIN); the tables entry the
// structural tables the kernels assume (as cemlp.cu's).
#define CSMPN_WIDE_PARAMS_DECL                                                \
  const float *w1, const float *b1, const float *sa, const float *sb,         \
      const float *gw, const float *wr, const float *na, const float *wl,     \
      const float *bl, const float *aln
#define CSMPN_WIDE_PARAMS Params{w1, b1, sa, sb, gw, wr, na, wl, bl, aln}
#define CSMPN_WIDE_ENTRIES(PREFIX, ALG)                                       \
  long long PREFIX##_smem_bytes(int cin, int c, int backward) {               \
    return (long long)wide_smem_bytes<ALG>(cin, c, backward);                 \
  }                                                                           \
  long long PREFIX##_img_floats(int cin, int c, int backward) {               \
    return wide_img_floats<ALG>(cin, c, backward);                            \
  }                                                                           \
  long long PREFIX##_wgrad_splits(int rows, int cin, int c, int sms) {        \
    return wide_wgrad_splits<ALG>(rows, cin, c, sms);                         \
  }                                                                           \
  long long PREFIX##_wpart_floats(int cin, int c) {                           \
    return (long long)wide_wpart_floats<ALG>(cin, c);                         \
  }                                                                           \
  long long PREFIX##_loc_floats(int c) { return Loc<ALG>::N * c; }            \
  void PREFIX##_range(int* out) {                                             \
    out[0] = WMAX_C;                                                          \
    out[1] = WMAX_CIN;                                                        \
  }                                                                           \
  int PREFIX##_fwd(const float* x, CSMPN_WIDE_PARAMS_DECL, const float* bc,   \
                   const float* sign, float* out, void* img, int rows,        \
                   int cin, int c, int fast, int grid, void* stream) {        \
    return wide_fwd<ALG>(x, CSMPN_WIDE_PARAMS, bc, sign, out,                 \
                         static_cast<float*>(img), rows, cin, c, fast, grid,  \
                         stream);                                             \
  }                                                                           \
  int PREFIX##_bwd(const float* x, const float* dout, CSMPN_WIDE_PARAMS_DECL, \
                   const float* bc, const float* sign, float* dx, void* img,  \
                   float* scratch, float* lpart, float* wpart, float* grads,  \
                   int rows, int cin, int c, int fast, int grid, int splits,  \
                   void* stream) {                                            \
    return wide_bwd<ALG>(x, dout, CSMPN_WIDE_PARAMS, bc, sign, dx,            \
                         static_cast<float*>(img), scratch, lpart, wpart,     \
                         grads, rows, cin, c, fast, grid, splits, stream);    \
  }                                                                           \
  void PREFIX##_tables(int* i_of_out, int* path_out, int* grade_out) {        \
    structural_tables<ALG>(i_of_out, path_out, grade_out);                    \
  }
