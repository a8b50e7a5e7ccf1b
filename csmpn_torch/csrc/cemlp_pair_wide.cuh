// K2pw and K3pw — one whole CEMLP block in its pair form, forward and
// backward, on Hopper (sm_90a), at the widths K2p/K3p (cemlp_pair_kernels.cuh
// and its row tiles) do not take: every C <= 64 output and Cin <= 160 input
// channels, at Cl(5,0) (32 blades) and Cl(4,0) (16 blades), in both modes.
// This header holds the device code and its host launchers, templated on
// the pair algebra traits of cemlp_pair.cuh; cemlp_pair_wide.cu (Cl(5,0))
// and cemlp_pair_wide_cl4.cu (Cl(4,0)) each instantiate one algebra's C
// entry points, so that the two build in parallel.
//
// Replaces: csmpn_tpu/ops/cemlp_kernel.py, `_fwd_kernel` (K2, launched by
// `_pallas_fwd`) and `_bwd_kernel` (K3, launched by `_fused_block_bwd`) in
// their pair form (`_pair_form`: `_gp_pair_fwd`, `_post_linear_math`, the
// pair branch of `_post_linear_bwd`), at the widths the TPU kernel pads to
// 128 lanes and tiles by VMEM (`_tile_rows`, `_vmem_params`).  One block is
//     MVLinear -> MVSiLU -> SGP (right linear, grade-norm normalisation,
//     geometric product over the Cayley pairs, + left linear, / sqrt 2)
//     -> MVLayerNorm,
// the function of K2p/K3p; the wrapper (ops/cemlp_kernel.block_route)
// sends a launch here only where their plan does not take its widths.
// fused_egcl_pair_wide.cuh (K4pw/K5pw) runs the same device code over
// gathered edge rows (a linear's input rows come from a source type:
// PWXRows here, its gather there).
//
// Bound on this card: at the hulls edge block 0 at hidden 64 (13,184 rows,
// 70 -> 64 channels, 32 blades) a row costs ~2*32*64*(70 + 2*64) FLOPs of
// channel mixing and ~2*32*32*64 of pair product, ~0.94 MFLOP, against
// 4*32*(70 + 64) bytes, ~55 FLOP/byte: above the fp32 FFMA ridge (67
// TFLOP/s over 3.35 TB/s = 20 FLOP/byte), so these FFMA kernels are bound
// by operations (~185 us at the fp32 peak; ~14 us at the bf16 tensor-core
// rate, where bytes bound it at ~68 us).  The backward does about three
// times the forward's work.
//
// Design (simple first; the products on the tensor cores are later work):
//   * Weights: at these widths they do not fit in one CTA beside the rows
//     (Wr and WL alone are 194 KB at C = 64, Cl(5)), so a first launch
//     (`cemlp_pair_wide_pack_kernel`) lays them out once a call as an image
//     in global memory: each linear as rows [input channel][grade][output
//     channel], a grade's run padded to a pitch whose quarter is odd (the
//     float4 reads of the grades a quarter-warp holds fall in distinct
//     banks), for the backward also WL and Wr transposed and W1 transposed
//     in blocks of 64 input channels; the per-channel parameters as
//     [field][channel] rows; the path weights [channel][path] in fp32.  A
//     CTA streams a linear's rows through one shared-memory panel of
//     PW_KC input channels at a time, shared by its warps.
//   * Rows: a row is a member of NB lanes, a lane a blade, as in K2p's row
//     code (a warp at Cl(5); two rows a warp at Cl(4)).  A CTA step takes
//     one row a member, its warps chosen by the host from the shared memory
//     the widths leave (pw_warps: 10 warps forward, 5 backward at 70 -> 64
//     at Cl(5)).  A lane holds its blade of all C output channels of a
//     linear in registers (16 float4 groups) while it walks the input
//     channels: one x value and C/4 float4 weight reads (a broadcast across
//     the lanes of a grade) a step.  The row's state between phases lives
//     in shared-memory tiles [row][channel][blade]: z and y_n / the
//     product in the forward; z, yr -> d(yr), o -> d(first), y_n -> d(z)
//     -> d(y) in the backward.  The grade sums (MVSiLU's invariants, the
//     normalisation) go through a per-member scratch row, four channels at
//     once; the layer norm's blade sums are shuffles.
//   * The geometric product out_j = sum_k sign * w[path] * z_i * yn_k,
//     i = i_of(j, k), per channel: NB steps a lane over the packed pair
//     table T1 in shared memory, z_i a gather and yn_k a broadcast from the
//     row's tiles, w from the CTA's copy of the path weights; the backward
//     walks T2 (d(z)) and T3 (d(yn)) as K3p's row code does.
//   * Backward (`cemlp_pair_wide_bwd_kernel`): recompute the forward of the
//     step, the layer norm's backward (two passes over the channels: the
//     row's sums, then each channel), the pair product's and the
//     normalisation's backward, d(z) += d(first) WL^T + d(yr) Wr^T, the
//     input linear again and MVSiLU's backward, dx = d(y) W1^T in blocks of
//     64 input channels; the cotangent rows z, d(y), d(yr), d(first) and
//     the rounded yn to a scratch in global memory.  The per-channel
//     gradients add into the member's own slab of partials (one owner a
//     value).  The weight gradients X^T d(y), z^T d(yr), z^T d(first) are
//     a kernel of their own over the scratch (`cemlp_pair_wide_wgrad_kernel`,
//     a CTA a 64 x 64 tile of (input, output) channels, all grades, over
//     a run of rows, into its own slab), and so are the path-weight
//     gradients (`cemlp_pair_wide_pgrad_kernel`, a thread a (channel,
//     path), walking the path's pairs over a run of rows); a last kernel
//     (`cemlp_pair_wide_reduce_kernel`) sums every kind of slab in a fixed
//     order into the flax-layout gradient vector.
// Every output element has one owner and every sum a fixed order, so two
// launches give the same bits.
//
// Precision: exact mode is fp32 throughout.  Fast mode rounds to bf16 at
// the points K2p's and K3p's row code (cemlp_pair.cuh) does, which are the
// plain fast version's (`block_forward_plain`, ops/cemlp_kernel.py): x,
// the weights and silu.a, z, yn, each pair product z_i * yn_k * w (the path
// weight itself stays fp32), the squared terms of the grade norms; in the
// backward d(first), d(yr), d(y), MVSiLU's gate cotangent and each pair
// product of the product's backward.  The products are FFMAs of the
// rounded values, so only the order of the fp32 sums differs from a
// tensor-core product.

#pragma once

#include "cemlp_pair.cuh"

namespace {

constexpr int PW_MAX_C = 64;      // output channels (16 groups of 4 a lane)
constexpr int PW_MAX_CIN = 160;   // input channels
constexpr int PW_Q = PW_MAX_C / 4;   // channel groups of a lane's accumulators
constexpr int PW_KC = 8;          // rows of a linear a panel holds
constexpr int PW_KQ = PW_KC / 2;  // rows of WL^T, and of Wr^T, a panel holds
constexpr int PW_BLK = 64;        // input channels a block of dx takes
// warps a CTA takes at most: 12 forward (168 registers a thread, no
// spills); 8 backward, whose four row tiles leave room for no more than 8
// at any width (5 at C = 64, Cl(5)), so that it has 255 registers
constexpr int PW_MAX_WARPS = 12;
constexpr int PW_MAX_WARPS_BWD = 8;
constexpr int PW_THREADS = 32 * PW_MAX_WARPS;
constexpr int PW_THREADS_BWD = 32 * PW_MAX_WARPS_BWD;
constexpr int PW_WG_T = 64;       // input and output channels of a wgrad tile
constexpr int PW_PG_C = 4;        // channels a path-gradient CTA takes
constexpr int PW_PG_R = 16;       // rows a path-gradient stage loads

// The pitch (floats) of a grade's run of output channels in the image and
// the panels: C padded to a multiple of 4 whose quarter is odd.
__host__ __device__ inline int pw_pitch(int c) {
  const int c4 = pad4(c);
  return (c4 / 4) % 2 ? c4 : c4 + 4;
}
constexpr int PW_BGP = 68;        // pw_pitch(PW_BLK), the widest pitch

// The parameter image: offsets (floats) of its sections, each a multiple
// of 4.  The forward's image is a prefix of the backward's.
struct PWLayout {
  int cin, c, c4, gp, npp, nblk;
  int64_t w1f, wrf, wlf;   // [m][NG][gp]: W[n][m][g] at (m, g, n)
  int64_t b1;              // [field][gp]: b1, sa (NG rows), sb (NG),
                           // sigmoid(normalization.a) (NG), bL, ln.a
  int64_t sa, sb, nsig, bl, aln;
  int64_t gw;              // [c4][npp]: the path weights, fp32
  int64_t wrb, wlb;        // [q][NG][gp]: W[q][m][g] at (q, g, m)
  int64_t w1b;             // [blk][q][NG][PW_BGP]: W1[q][blk * 64 + m][g]
  int64_t total;
};

template <class A>
__host__ __device__ inline PWLayout pw_layout(int cin, int c, bool bwd) {
  constexpr int NG = A::NG;
  PWLayout L;
  L.cin = cin;
  L.c = c;
  L.c4 = pad4(c);
  L.gp = pw_pitch(c);
  L.npp = pad4(A::NP);
  L.nblk = (cin + PW_BLK - 1) / PW_BLK;
  const int64_t row = (int64_t)NG * L.gp;
  int64_t o = 0;
  L.w1f = o; o += (int64_t)cin * row;
  L.wrf = o; o += (int64_t)c * row;
  L.wlf = o; o += (int64_t)c * row;
  L.b1 = o; o += L.gp;
  L.sa = o; o += NG * L.gp;
  L.sb = o; o += NG * L.gp;
  L.nsig = o; o += NG * L.gp;
  L.bl = o; o += L.gp;
  L.aln = o; o += L.gp;
  L.gw = o; o += (int64_t)L.c4 * L.npp;
  L.wrb = L.wlb = L.w1b = o;
  if (bwd) {
    L.wrb = o; o += (int64_t)c * row;
    L.wlb = o; o += (int64_t)c * row;
    L.w1b = o; o += (int64_t)L.nblk * c * NG * PW_BGP;
  }
  L.total = o;
  return L;
}

// Shared memory of a launch (floats) with `warps` warps: the x chunk
// [row][PW_KC][NB], one panel of PW_KC rows at the widest pitch, the path
// weights [c4][npp], the packed pair tables, the grade-sum scratch
// [row][NB][4], and the row tiles [tile][row][c4][NB] (2 forward, 4
// backward).
template <class A>
__host__ __device__ inline int64_t pw_smem_floats(int c, int warps, bool bwd) {
  const int64_t nrow = (int64_t)warps * A::MW, c4 = pad4(c);
  return nrow * PW_KC * A::NB + (int64_t)PW_KC * A::NG * PW_BGP +
         c4 * pad4(A::NP) + A::TAB_FLOATS + nrow * A::NB * 4 +
         (bwd ? 4 : 2) * nrow * c4 * A::NB;
}

// The flax-layout gradient vector (as cemlp_pair_tile.cuh's grad_floats):
//   dW1 (C, Cin, NG) | db1 (C) | dsilu_a (C, NG) | dsilu_b (C, NG) |
//   dgp_weight (C, NP) | dWr (C, C, NG) | dsigmoid(norm_a) (C, NG) |
//   dWL (C, C, NG) | dbL (C) | dln_a (C)
template <class A>
__host__ __device__ inline int64_t pw_grad_floats(int cin, int c) {
  return (int64_t)c * cin * A::NG + c + 2 * A::NG * c + A::NP * c +
         (int64_t)c * c * A::NG + A::NG * c + (int64_t)c * c * A::NG + 2 * c;
}

// The weight gradients' part of a wgrad slab: dW1 | dWr | dWL, flax layouts.
template <class A>
__host__ __device__ inline int64_t pw_wpart_floats(int cin, int c) {
  return (int64_t)c * cin * A::NG + 2 * (int64_t)c * c * A::NG;
}

// ---------------------------------------------------------------- the image

// The parameter image of a launch, one thread an element (grid stride).
// Fast mode rounds the weights and silu.a to bf16 here; the path weights
// stay fp32.
template <class A, bool FAST>
__global__ void __launch_bounds__(256)
cemlp_pair_wide_pack_kernel(Params p, PWLayout L, float* __restrict__ img) {
  constexpr int NG = A::NG, NP = A::NP;
  const int cin = L.cin, c = L.c, gp = L.gp;
  const int64_t gw_end = L.gw + (int64_t)L.c4 * L.npp;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < L.total; e += stride) {
    float v = 0.f;
    if (e < L.b1) {   // forward linears: (m, g, n)
      const float* w = e < L.wrf ? p.w1 : e < L.wlf ? p.wr : p.wl;
      const int64_t base = e < L.wrf ? L.w1f : e < L.wlf ? L.wrf : L.wlf;
      const int m_in = e < L.wrf ? cin : c;
      const int n = (int)((e - base) % gp);
      const int64_t rr = (e - base) / gp;
      const int g = (int)(rr % NG), m = (int)(rr / NG);
      if (n < c) v = rnd<FAST>(w[((int64_t)n * m_in + m) * NG + g]);
    } else if (e < L.gw) {   // per-channel rows: (field row, n)
      const int n = (int)((e - L.b1) % gp), fr = (int)((e - L.b1) / gp);
      if (n < c) {
        if (fr == 0)
          v = p.b1[n];
        else if (fr <= NG)
          v = rnd<FAST>(p.sa[n * NG + fr - 1]);
        else if (fr <= 2 * NG)
          v = p.sb[n * NG + fr - 1 - NG];
        else if (fr <= 3 * NG)
          v = sigmoid_f(p.na[n * NG + fr - 1 - 2 * NG]);
        else if (fr == 3 * NG + 1)
          v = p.bl[n];
        else
          v = p.aln[n];
      }
    } else if (e < gw_end) {   // path weights: (n, path)
      const int n = (int)((e - L.gw) / L.npp), q = (int)((e - L.gw) % L.npp);
      if (n < c && q < NP) v = p.gw[n * NP + q];
    } else if (e < L.w1b) {   // Wr^T / WL^T: (q, g, m)
      const float* w = e < L.wlb ? p.wr : p.wl;
      const int64_t off = e - (e < L.wlb ? L.wrb : L.wlb);
      const int m = (int)(off % gp);
      const int64_t rr = off / gp;
      const int g = (int)(rr % NG), q = (int)(rr / NG);
      if (m < c) v = rnd<FAST>(w[((int64_t)q * c + m) * NG + g]);
    } else {   // W1^T in blocks of 64 input channels: (blk, q, g, m)
      const int64_t off = e - L.w1b;
      const int mm = (int)(off % PW_BGP);
      const int64_t rr = off / PW_BGP;
      const int g = (int)(rr % NG), q = (int)((rr / NG) % c),
                blk = (int)(rr / ((int64_t)NG * c));
      const int m = blk * PW_BLK + mm;
      if (mm < PW_BLK && m < cin)
        v = rnd<FAST>(p.w1[((int64_t)q * cin + m) * NG + g]);
    }
    img[e] = v;
  }
}

// --------------------------------------------------------- the step's parts

struct PWSmem {
  float *xs, *pan, *gws, *sc, *tiles;
  uint16_t* tab;
};

template <class A>
__device__ inline PWSmem pw_carve(float* base, const PWLayout& L, int nrow) {
  PWSmem s;
  s.xs = base;
  s.pan = s.xs + nrow * PW_KC * A::NB;
  s.gws = s.pan + PW_KC * A::NG * PW_BGP;
  s.tab = reinterpret_cast<uint16_t*>(s.gws + L.c4 * L.npp);
  s.sc = s.gws + L.c4 * L.npp + A::TAB_FLOATS;
  s.tiles = s.sc + nrow * A::NB * 4;
  return s;
}

// This thread's place: its blade b (grade g, the grade's run [lo, hi),
// quadratic coefficient bc) and its row slot in the CTA step.
struct PWLane {
  int b, g, lo, hi, slot;
  float bc;
};

// n floats (a multiple of 4, 16-byte aligned) from global memory into
// shared memory, all threads of the CTA.
__device__ __forceinline__ void pw_stage4(float* dst,
                                          const float* __restrict__ src,
                                          int n) {
  const int tid = threadIdx.x + 32 * threadIdx.y, nt = 32 * blockDim.y;
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll 4
  for (int e = tid; e < n / 4; e += nt) d[e] = __ldg(s + e);
}

// Input channels [k0, k0 + kn) of the step's nrow rows into xs
// [r][PW_KC][NB] (rounded in fast mode), rows past `rows` zero.
template <class A, bool FAST>
__device__ __forceinline__ void pw_load_x(const float* __restrict__ x,
                                          float* xs, int64_t row0, int nrow,
                                          int rows, int cin, int k0, int kn) {
  constexpr int NB = A::NB;
  const int tid = threadIdx.x + 32 * threadIdx.y, nt = 32 * blockDim.y;
  const int per4 = kn * NB / 4;
  for (int e = tid; e < nrow * per4; e += nt) {
    const int r = e / per4, q = e % per4;
    const int64_t row = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows)
      v = __ldg(reinterpret_cast<const float4*>(x + (row * cin + k0) * NB) +
                q);
    v.x = rnd<FAST>(v.x);
    v.y = rnd<FAST>(v.y);
    v.z = rnd<FAST>(v.z);
    v.w = rnd<FAST>(v.w);
    reinterpret_cast<float4*>(xs + r * PW_KC * NB)[q] = v;
  }
}

// Where a linear's input rows come from.  A staged source loads the
// step's rows a chunk of kn input channels at a time into xs (all threads
// of the CTA; K2pw/K3pw read x in global memory, K4pw gathers it), and a
// member reads its row there; PWTileRows is the member's row already in a
// shared-memory tile [channel][NB].
template <class A, bool FAST>
struct PWXRows {
  const float* __restrict__ x;
  int64_t row0;
  int nrow, rows, cin;
  __device__ __forceinline__ void load(float* xs, int k0, int kn) const {
    pw_load_x<A, FAST>(x, xs, row0, nrow, rows, cin, k0, kn);
  }
  __device__ __forceinline__ const float* at(const float* xs, int slot,
                                             int) const {
    return xs + slot * PW_KC * A::NB;
  }
};

template <class A>
struct PWTileRows {
  const float* row;
  __device__ __forceinline__ void load(float*, int, int) const {}
  __device__ __forceinline__ const float* at(const float*, int,
                                             int k0) const {
    return row + k0 * A::NB;
  }
};

__device__ __forceinline__ void pw_zero(float (&acc)[PW_Q][4]) {
#pragma unroll
  for (int q = 0; q < PW_Q; ++q)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[q][u] = 0.f;
}

// acc[q][u] += sum over k < kn of v[k * NB] * w[k * NG * pitch + 4q + u]
// for q < nq: one channel-mixing product at this lane's blade (v: the row's
// values of kn input channels at the lane's blade; w: kn panel rows at the
// lane's grade).
template <class A>
__device__ __forceinline__ void pw_mix(float (&acc)[PW_Q][4], const float* v,
                                       const float* w, int kn, int pitch,
                                       int nq) {
  constexpr int NB = A::NB, NG = A::NG;
#pragma unroll 2
  for (int k = 0; k < kn; ++k) {
    const float xv = v[k * NB];
    const float4* wr = reinterpret_cast<const float4*>(w + k * NG * pitch);
#pragma unroll
    for (int q = 0; q < PW_Q; ++q) {
      if (q < nq) {
        const float4 t = wr[q];
        acc[q][0] = fmaf(xv, t.x, acc[q][0]);
        acc[q][1] = fmaf(xv, t.y, acc[q][1]);
        acc[q][2] = fmaf(xv, t.z, acc[q][2]);
        acc[q][3] = fmaf(xv, t.w, acc[q][3]);
      }
    }
  }
}

// One linear over the step's rows: acc = the rows of `src` (k_in input
// channels) times the linear whose image rows (pitch `pitch`) start at
// `w`, for 4 nq output channels; the panels (and x chunks) are staged by
// all threads of the CTA.
template <class A, class Src>
__device__ __forceinline__ void pw_linear(float (&acc)[PW_Q][4],
                                          const Src& src,
                                          const float* __restrict__ w,
                                          int pitch, int k_in, int nq,
                                          const PWSmem& sm,
                                          const PWLane& ln) {
  constexpr int NG = A::NG;
  pw_zero(acc);
  for (int k0 = 0; k0 < k_in; k0 += PW_KC) {
    const int kn = k_in - k0 < PW_KC ? k_in - k0 : PW_KC;
    __syncthreads();   // the previous panel (and x chunk) consumed
    src.load(sm.xs, k0, kn);
    pw_stage4(sm.pan, w + (int64_t)k0 * NG * pitch, kn * NG * pitch);
    __syncthreads();
    pw_mix<A>(acc, src.at(sm.xs, ln.slot, k0) + ln.b, sm.pan + ln.g * pitch,
              kn, pitch, nq);
  }
}

// Sums over the lanes of this lane's grade of four channels' values, the
// same on every lane of the grade; sc is the member's [NB][4] scratch.
template <class A>
__device__ __forceinline__ void pw_grade_sum4(float (&v)[4], float* sc,
                                              const PWLane& ln) {
  __syncwarp();
  reinterpret_cast<float4*>(sc)[ln.b] = make_float4(v[0], v[1], v[2], v[3]);
  __syncwarp();
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t = ln.lo; t < ln.hi; ++t) {
    const float4 u = reinterpret_cast<const float4*>(sc)[t];
    s[0] += u.x;
    s[1] += u.y;
    s[2] += u.z;
    s[3] += u.w;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = s[u];
}

// MVSiLU of four channels n0.. from their linear outputs acc (no bias):
// y (bias in), the invariants inv and the gates sg.
template <class A, bool FAST>
__device__ __forceinline__ void pw_gates(const float (&acc)[4], int n0,
                                         const float* __restrict__ img,
                                         const PWLayout& L, float* sc,
                                         const PWLane& ln, float (&y)[4],
                                         float (&inv)[4], float (&sg)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    y[u] = acc[u] + (ln.b == 0 ? __ldg(img + L.b1 + n0 + u) : 0.f);
    inv[u] = ln.b == 0 ? rnd<FAST>(y[u]) : rnd<FAST>(y[u] * y[u] * ln.bc);
  }
  pw_grade_sum4<A>(inv, sc, ln);
#pragma unroll
  for (int u = 0; u < 4; ++u)
    sg[u] = sigmoid_f(__ldg(img + L.sa + ln.g * L.gp + n0 + u) * inv[u] +
                      __ldg(img + L.sb + ln.g * L.gp + n0 + u));
}

// A row's tiles ([n][NB] each, this member's row) and its scratch row.
struct PWRow {
  float *z, *yr, *yn, *gp, *sc;
};

// The step's block up to the left linear: z = MVSiLU(x W1 + b1), x the
// rows of `src`, into rw.z (rounded in fast mode); yr = z Wr (into rw.yr
// in the backward), its normalisation, the rounded yn into rw.yn; the pair
// product into rw.gp (in the forward the same tile as rw.yn: each group of
// four channels is written after the member read its yn); returns z WL
// (no bias) in acc.
template <class A, bool FAST, bool BWD, class Src>
__device__ __forceinline__ void pw_front(float (&acc)[PW_Q][4],
                                         const Src& src,
                                         const float* __restrict__ img,
                                         const PWLayout& L, const PWSmem& sm,
                                         const PWRow& rw, const PWLane& ln) {
  constexpr int NB = A::NB;
  const int c = L.c, nq = L.c4 / 4, gp = L.gp, b = ln.b;
  pw_linear<A>(acc, src, img + L.w1f, gp, L.cin, nq, sm, ln);
#pragma unroll
  for (int q = 0; q < PW_Q; ++q) {
    if (q < nq) {
      float y[4], inv[4], sg[4];
      pw_gates<A, FAST>(acc[q], 4 * q, img, L, rw.sc, ln, y, inv, sg);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        rw.z[(4 * q + u) * NB + b] = rnd<FAST>(sg[u] * y[u]);
    }
  }
  pw_linear<A>(acc, PWTileRows<A>{rw.z}, img + L.wrf, gp, c, nq, sm, ln);
#pragma unroll
  for (int q = 0; q < PW_Q; ++q) {
    if (q < nq) {
      float s[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        s[u] = rnd<FAST>(acc[q][u] * acc[q][u] * ln.bc);
      pw_grade_sum4<A>(s, rw.sc, ln);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int n = 4 * q + u;
        const float s1 = sqrtf(s[u] * s[u] + 1e-16f);
        const float nr = sqrtf(s1);
        const float den =
            __ldg(img + L.nsig + ln.g * gp + n) * (nr - 1.f) + 1.f + EPS;
        if (BWD) rw.yr[n * NB + b] = acc[q][u];
        rw.yn[n * NB + b] = rnd<FAST>(acc[q][u] / den);
      }
    }
  }
  __syncwarp();   // the member's yn in place
  // the pair product, four channels at a time (channels past c read zero
  // z and path weights)
  const uint16_t* t1 = sm.tab;
  for (int n0 = 0; n0 < c; n0 += 4) {
    float gpv[4] = {0.f, 0.f, 0.f, 0.f};
    const float* zr = rw.z + n0 * NB;
    const float* yr = rw.yn + n0 * NB;
    const float* gwn = sm.gws + n0 * L.npp;
#pragma unroll 4
    for (int k = 0; k < NB; ++k) {
      const int t = t1[k * NB + b];
      const int i = t & FIELD, p = t >> 6;
      const bool neg = t & (FIELD + 1);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float pr =
            rnd<FAST>((zr[u * NB + i] * yr[u * NB + k]) * gwn[u * L.npp + p]);
        gpv[u] += neg ? -pr : pr;
      }
    }
    if (!BWD) __syncwarp();   // the member read this group's yn
#pragma unroll
    for (int u = 0; u < 4; ++u) rw.gp[(n0 + u) * NB + b] = gpv[u];
  }
  pw_linear<A>(acc, PWTileRows<A>{rw.z}, img + L.wlf, gp, c, nq, sm, ln);
}

// o = (first + bL + gp) / sqrt 2 into acc; returns the layer norm's
// divisor, the mean over the row's channels of the per-channel norm.
template <class A, bool FAST>
__device__ __forceinline__ float pw_out(float (&acc)[PW_Q][4],
                                        const float* __restrict__ img,
                                        const PWLayout& L, const float* gpt,
                                        const PWLane& ln) {
  constexpr int NB = A::NB;
  const int c = L.c, nq = L.c4 / 4, b = ln.b;
  float msum = 0.f;
#pragma unroll
  for (int q = 0; q < PW_Q; ++q) {
    if (q < nq) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int n = 4 * q + u;
        const float o = (acc[q][u] + (b == 0 ? __ldg(img + L.bl + n) : 0.f) +
                         gpt[n * NB + b]) * SQRT2_INV;
        acc[q][u] = o;
        const float qc = blade_sum<A>(rnd<FAST>(o * o * ln.bc));
        if (n < c) msum += sqrtf(sqrtf(qc * qc + 1e-16f));
      }
    }
  }
  return msum / (float)c + EPS;
}

template <class A>
__device__ __forceinline__ PWLane pw_lane(const Tabs<A>& tb) {
  PWLane ln;
  ln.b = blade_lane<A>();
  ln.g = A::grade(ln.b);
  ln.lo = A::gstart(ln.g);
  ln.hi = A::gstart(ln.g + 1);
  ln.slot = (int)threadIdx.y * A::MW + half_of_warp<A>();
  ln.bc = tb.bc[ln.b];
  return ln;
}

// The CTA's copies of the path weights and of the first ntab entries of
// the packed pair tables.
template <class A>
__device__ __forceinline__ void pw_stage_common(
    const PWSmem& sm, const float* __restrict__ img,
    const uint16_t* __restrict__ tabs, const PWLayout& L, int ntab) {
  const int tid = threadIdx.x + 32 * threadIdx.y, nt = 32 * blockDim.y;
  pw_stage4(sm.gws, img + L.gw, L.c4 * L.npp);
  for (int e = tid; e < ntab; e += nt) sm.tab[e] = tabs[e];
}

// --------------------------------------------------------------- K2pw

// A CTA walks over steps of one row a member: pw_front, the output linear's
// o and the layer norm's mean, then the block's output aln / mean * o, a
// lane its blade of every channel.
template <class A, bool FAST>
__global__ void __launch_bounds__(PW_THREADS, 1)
cemlp_pair_wide_fwd_kernel(const float* __restrict__ x,
                           const float* __restrict__ img,
                           const uint16_t* __restrict__ tabs, Tabs<A> tb,
                           float* __restrict__ out, int rows, PWLayout L) {
  constexpr int NB = A::NB;
  extern __shared__ float4 pw_smem4[];
  const int nrow = (int)blockDim.y * A::MW;
  const PWSmem sm = pw_carve<A>(reinterpret_cast<float*>(pw_smem4), L, nrow);
  pw_stage_common<A>(sm, img, tabs, L, NB * NB);
  const PWLane ln = pw_lane<A>(tb);
  const int c = L.c, c4 = L.c4, nq = c4 / 4;
  PWRow rw;
  rw.z = sm.tiles + (int64_t)ln.slot * c4 * NB;
  rw.yn = rw.gp = sm.tiles + ((int64_t)nrow + ln.slot) * c4 * NB;
  rw.yr = nullptr;
  rw.sc = sm.sc + ln.slot * NB * 4;
  const int n_tiles = (rows + nrow - 1) / nrow;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = (int64_t)tile * nrow, row = row0 + ln.slot;
    float acc[PW_Q][4];
    const PWXRows<A, FAST> xr{x, row0, nrow, rows, L.cin};
    pw_front<A, FAST, false>(acc, xr, img, L, sm, rw, ln);
    const float m = pw_out<A, FAST>(acc, img, L, rw.gp, ln);
    if (row >= rows) continue;
#pragma unroll
    for (int q = 0; q < PW_Q; ++q) {
      if (q < nq) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int n = 4 * q + u;
          if (n < c)
            out[(row * c + n) * NB + ln.b] =
                __ldg(img + L.aln + n) / m * acc[q][u];
        }
      }
    }
  }
}

// --------------------------------------------------------------- K3pw

// A CTA walks over steps of one row a member: pw_front and the output's o
// and mean; the layer norm's backward (the row's sums, then each channel:
// d(first)); the pair product's and the normalisation's backward (d(z)
// of the product, d(yr)); d(z) += d(first) WL^T + d(yr) Wr^T; the input
// linear again and MVSiLU's backward -> d(y); dx = d(y) W1^T in blocks of
// 64 input channels.  The rows of z, d(y), d(yr), d(first) and the rounded
// yn go to the scratch (each rows x C x NB, in that order); the
// per-channel gradients add into the member's slab of lpart
// ([CTA][row slot][NLOC][C]).
template <class A, bool FAST>
__global__ void __launch_bounds__(PW_THREADS_BWD, 1)
cemlp_pair_wide_bwd_kernel(const float* __restrict__ x,
                           const float* __restrict__ dout,
                           const float* __restrict__ img,
                           const uint16_t* __restrict__ tabs, Tabs<A> tb,
                           float* __restrict__ dx, float* __restrict__ scratch,
                           float* __restrict__ lpart, int rows, PWLayout L) {
  constexpr int NB = A::NB, NG = A::NG;
  extern __shared__ float4 pw_smem4[];
  const int nrow = (int)blockDim.y * A::MW;
  const PWSmem sm = pw_carve<A>(reinterpret_cast<float*>(pw_smem4), L, nrow);
  pw_stage_common<A>(sm, img, tabs, L, A::TAB_T);
  const uint16_t* T2 = sm.tab + NB * NB;
  const uint16_t* T3 = sm.tab + 2 * NB * NB;
  const PWLane ln = pw_lane<A>(tb);
  const int b = ln.b, g = ln.g, c = L.c, c4 = L.c4, nq = c4 / 4, gp = L.gp,
            cin = L.cin, npp = L.npp;
  const float bc = ln.bc;
  float* slab = lpart + ((int64_t)blockIdx.x * nrow + ln.slot) * A::NLOC * c;
  for (int e = b; e < A::NLOC * c; e += NB) slab[e] = 0.f;
  const int64_t plane = (int64_t)rows * c * NB;
  float* zsc = scratch;
  float* dysc = scratch + plane;
  float* drsc = scratch + 2 * plane;
  float* dfsc = scratch + 3 * plane;
  float* ynsc = scratch + 4 * plane;
  const int64_t tsz = (int64_t)nrow * c4 * NB;
  PWRow rw;
  rw.z = sm.tiles + (int64_t)ln.slot * c4 * NB;   // z
  rw.yr = rw.z + tsz;                             // yr -> d(yr)
  rw.gp = rw.z + 2 * tsz;                         // product -> d(first)
  rw.yn = rw.z + 3 * tsz;                         // yn -> d(z) -> d(y)
  rw.sc = sm.sc + ln.slot * NB * 4;
  float* const zt = rw.z;
  float* const rt = rw.yr;
  float* const ft = rw.gp;
  float* const dt = rw.yn;

  const int n_tiles = (rows + nrow - 1) / nrow;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = (int64_t)tile * nrow, row = row0 + ln.slot;
    const bool live = row < rows;
    float acc[PW_Q][4];
    const PWXRows<A, FAST> xr{x, row0, nrow, rows, cin};
    pw_front<A, FAST, true>(acc, xr, img, L, sm, rw, ln);
    const float m = pw_out<A, FAST>(acc, img, L, rw.gp, ln);
    if (live)
      for (int n = 0; n < c; ++n) {
        zsc[(row * c + n) * NB + b] = zt[n * NB + b];
        ynsc[(row * c + n) * NB + b] = dt[n * NB + b];
      }
    // ---- the layer norm's backward: the row's sums, then d(first)
    float tt = 0.f;
#pragma unroll
    for (int q = 0; q < PW_Q; ++q) {
      if (q < nq) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int n = 4 * q + u;
          const float gv =
              live && n < c ? dout[(row * c + n) * NB + b] : 0.f;
          tt += gv * __ldg(img + L.aln + n) * acc[q][u];
          const float ta = blade_sum<A>(gv * acc[q][u]);
          if (live && n < c && b == 0) slab[A::L_ALN * c + n] += ta / m;
        }
      }
    }
    const float dm = -blade_sum<A>(tt) / (m * m);
#pragma unroll
    for (int q = 0; q < PW_Q; ++q) {
      if (q < nq) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int n = 4 * q + u;
          const float gv =
              live && n < c ? dout[(row * c + n) * NB + b] : 0.f;
          const float o = acc[q][u];
          const float qc = blade_sum<A>(rnd<FAST>(o * o * bc));
          const float s1c = sqrtf(qc * qc + 1e-16f);
          const float nc = sqrtf(s1c);
          const float dqc =
              rnd<FAST>(dm / (float)c * 0.5f * qc / (s1c * nc));
          const float dfg = (__ldg(img + L.aln + n) * gv / m +
                             dqc * 2.f * bc * o) * SQRT2_INV;
          const float dfr = rnd<FAST>(dfg);
          ft[n * NB + b] = dfr;
          if (live && n < c) {
            dfsc[(row * c + n) * NB + b] = dfr;
            if (b == 0) slab[A::L_BL * c + n] += dfg;
          }
        }
      }
    }
    __syncwarp();   // the member's d(first) in place
    // ---- the pair product's and the normalisation's backward, four
    // channels at a time: d(z) of the product into dt, d(yr) into rt
    for (int n0 = 0; n0 < c; n0 += 4) {
      float yr[4], qg[4], s1g[4], nr[4], den[4], yn[4], nsig[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        yr[u] = rt[(n0 + u) * NB + b];
        qg[u] = rnd<FAST>(yr[u] * yr[u] * bc);
      }
      pw_grade_sum4<A>(qg, rw.sc, ln);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        s1g[u] = sqrtf(qg[u] * qg[u] + 1e-16f);
        nr[u] = sqrtf(s1g[u]);
        nsig[u] = __ldg(img + L.nsig + g * gp + n0 + u);
        den[u] = nsig[u] * (nr[u] - 1.f) + 1.f + EPS;
        yn[u] = yr[u] / den[u];
      }
      float dzg[4] = {0.f, 0.f, 0.f, 0.f}, dyn[4] = {0.f, 0.f, 0.f, 0.f};
      const float* zr = zt + n0 * NB;
      const float* ynr = dt + n0 * NB;
      const float* df = ft + n0 * NB;
      const float* gwn = sm.gws + n0 * npp;
#pragma unroll 4
      for (int k = 0; k < NB; ++k) {   // lane = left blade i
        const int e = T2[k * NB + b];
        const int j = e & FIELD, p = e >> 6;
        const bool neg = e & (FIELD + 1);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float d = neg ? -df[u * NB + j] : df[u * NB + j];
          dzg[u] += rnd<FAST>((d * ynr[u * NB + k]) * gwn[u * npp + p]);
        }
      }
#pragma unroll 4
      for (int j = 0; j < NB; ++j) {   // lane = right blade k
        const int e = T3[j * NB + b];
        const int i = e & FIELD, p = e >> 6;
        const bool neg = e & (FIELD + 1);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float dj = df[u * NB + j];
          const float d = neg ? -dj : dj;
          dyn[u] += rnd<FAST>((d * zr[u * NB + i]) * gwn[u * npp + p]);
        }
      }
      float dd[4], dr[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) dd[u] = -dyn[u] * yn[u] / den[u];
      pw_grade_sum4<A>(dd, rw.sc, ln);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int n = n0 + u;
        if (live && n < c && b == ln.lo)
          slab[(A::L_NS + g) * c + n] += dd[u] * (nr[u] - 1.f);
        const float dnr = dd[u] * nsig[u];
        const float dqg =
            rnd<FAST>(dnr * 0.5f * qg[u] / (s1g[u] * nr[u]));
        dr[u] = rnd<FAST>(dyn[u] / den[u] + dqg * 2.f * bc * yr[u]);
      }
      __syncwarp();   // the member read this group's yn
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int n = n0 + u;
        rt[n * NB + b] = dr[u];
        dt[n * NB + b] = dzg[u];
        if (live && n < c) drsc[(row * c + n) * NB + b] = dr[u];
      }
    }
    // ---- d(z) += d(first) WL^T + d(yr) Wr^T
#pragma unroll
    for (int q = 0; q < PW_Q; ++q)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        acc[q][u] = q < nq ? dt[(4 * q + u) * NB + b] : 0.f;
    for (int q0 = 0; q0 < c; q0 += PW_KQ) {
      const int kq = c - q0 < PW_KQ ? c - q0 : PW_KQ;
      __syncthreads();
      pw_stage4(sm.pan, img + L.wlb + (int64_t)q0 * NG * gp, kq * NG * gp);
      pw_stage4(sm.pan + PW_KQ * NG * gp, img + L.wrb + (int64_t)q0 * NG * gp,
                kq * NG * gp);
      __syncthreads();
      pw_mix<A>(acc, ft + q0 * NB + b, sm.pan + g * gp, kq, gp, nq);
      pw_mix<A>(acc, rt + q0 * NB + b, sm.pan + PW_KQ * NG * gp + g * gp, kq,
                gp, nq);
    }
#pragma unroll
    for (int q = 0; q < PW_Q; ++q)
      if (q < nq)
#pragma unroll
        for (int u = 0; u < 4; ++u) dt[(4 * q + u) * NB + b] = acc[q][u];
    // ---- MVSiLU's backward over y recomputed: d(y) into dt
    pw_linear<A>(acc, xr, img + L.w1f, gp, cin, nq, sm, ln);
#pragma unroll
    for (int q = 0; q < PW_Q; ++q) {
      if (q < nq) {
        float y[4], inv[4], sg[4], dz[4], dgs[4], dgr[4];
        pw_gates<A, FAST>(acc[q], 4 * q, img, L, rw.sc, ln, y, inv, sg);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          dz[u] = dt[(4 * q + u) * NB + b];
          dgs[u] = dz[u] * y[u] * sg[u] * (1.f - sg[u]);
          dgr[u] = rnd<FAST>(dgs[u]);
        }
        pw_grade_sum4<A>(dgs, rw.sc, ln);
        pw_grade_sum4<A>(dgr, rw.sc, ln);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int n = 4 * q + u;
          const bool own = live && n < c;
          if (own && b == ln.lo) {
            slab[(A::L_SB + g) * c + n] += dgs[u];
            slab[(A::L_SA + g) * c + n] += inv[u] * dgr[u];
          }
          const float dv = __ldg(img + L.sa + g * gp + n) * dgr[u];
          const float dy =
              dz[u] * sg[u] + (b == 0 ? dv : 2.f * bc * y[u] * dv);
          if (own && b == 0) slab[A::L_B1 * c + n] += dy;
          const float dyr = rnd<FAST>(dy);
          dt[n * NB + b] = dyr;
          if (own) dysc[(row * c + n) * NB + b] = dyr;
        }
      }
    }
    // ---- dx = d(y) W1^T, blocks of 64 input channels
    for (int blk = 0; blk < L.nblk; ++blk) {
      const int left = (cin - blk * PW_BLK + 3) / 4;
      const int mq = left < PW_Q ? left : PW_Q;
      pw_linear<A>(acc, PWTileRows<A>{dt},
                   img + L.w1b + (int64_t)blk * c * NG * PW_BGP, PW_BGP, c,
                   mq, sm, ln);
      if (!live) continue;
#pragma unroll
      for (int q = 0; q < PW_Q; ++q) {
        if (q < mq) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int mi = blk * PW_BLK + 4 * q + u;
            if (mi < cin) dx[(row * cin + mi) * NB + b] = acc[q][u];
          }
        }
      }
    }
  }
}

// The weight gradients over the scratch: CTA (job, split) takes the tile
// of 64 input x 64 output channels of job (dW1: x against d(y); dWr: z
// against d(yr); dWL: z against d(first)), all grades, over the rows
// [split * chunk, (split + 1) * chunk), a thread 4 x 4 channels, and
// writes it into its split's slab of wpart (dW1 | dWr | dWL, flax
// layouts).  A stage loads 64 / NB rows.  Fast mode rounds x on load (the
// scratch rows are rounded).
template <class A, bool FAST>
__global__ void __launch_bounds__(256)
cemlp_pair_wide_wgrad_kernel(const float* __restrict__ x,
                             const float* __restrict__ scratch,
                             float* __restrict__ wpart, int rows, int cin,
                             int c, int chunk) {
  constexpr int NB = A::NB, NG = A::NG, WR = 64 / NB, NB4 = NB / 4;
  __shared__ __align__(16) float as[WR * NB * PW_WG_T];
  __shared__ __align__(16) float bs[WR * NB * PW_WG_T];
  const int mt0 = (cin + PW_WG_T - 1) / PW_WG_T,
            mt1 = (c + PW_WG_T - 1) / PW_WG_T, nt = mt1;
  int job = blockIdx.x, which;
  if (job < mt0 * nt) {
    which = 0;
  } else {
    job -= mt0 * nt;
    which = 1 + job / (mt1 * nt);
    job %= mt1 * nt;
  }
  const int mt = job / nt, ntile = job % nt;
  const int M = which == 0 ? cin : c;
  const int64_t plane = (int64_t)rows * c * NB;
  const float* a = which == 0 ? x : scratch;
  const float* bp = scratch + (which == 0 ? 1 : which == 1 ? 2 : 3) * plane;
  const int m0 = mt * PW_WG_T, n0 = ntile * PW_WG_T;
  const int64_t r_begin = (int64_t)blockIdx.y * chunk;
  const int64_t r_end = r_begin + chunk < rows ? r_begin + chunk : rows;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4][NG];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int gg = 0; gg < NG; ++gg) acc[p][q][gg] = 0.f;
  for (int64_t r0 = r_begin; r0 < r_end; r0 += WR) {
    __syncthreads();
    // a thread a float4 of 4 blades of one (row, channel): neighbouring
    // threads take neighbouring channels, so the stores to the tiles
    // [(r * NB + i) * 64 + channel] fall in distinct banks
    for (int e = tid; e < WR * NB4 * PW_WG_T; e += 256) {
      const int mm = e % PW_WG_T, ri = e / PW_WG_T;
      const int i4 = ri % NB4, r = ri / NB4;
      const int64_t row = r0 + r;
      const bool in = row < r_end;
      float4 va = make_float4(0.f, 0.f, 0.f, 0.f), vb = va;
      if (in && m0 + mm < M)
        va = __ldg(reinterpret_cast<const float4*>(
            a + (row * M + m0 + mm) * NB) + i4);
      if (in && n0 + mm < c)
        vb = __ldg(reinterpret_cast<const float4*>(
            bp + (row * c + n0 + mm) * NB) + i4);
      if (which == 0) {
        va.x = rnd<FAST>(va.x);
        va.y = rnd<FAST>(va.y);
        va.z = rnd<FAST>(va.z);
        va.w = rnd<FAST>(va.w);
      }
      float* ad = as + (r * NB + 4 * i4) * PW_WG_T + mm;
      float* bd = bs + (r * NB + 4 * i4) * PW_WG_T + mm;
      ad[0] = va.x;
      ad[PW_WG_T] = va.y;
      ad[2 * PW_WG_T] = va.z;
      ad[3 * PW_WG_T] = va.w;
      bd[0] = vb.x;
      bd[PW_WG_T] = vb.y;
      bd[2 * PW_WG_T] = vb.z;
      bd[3 * PW_WG_T] = vb.w;
    }
    __syncthreads();
#pragma unroll 1
    for (int r = 0; r < WR; ++r) {
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const float4 av =
            reinterpret_cast<const float4*>(as + (r * NB + i) * PW_WG_T)[tx];
        const float4 bv =
            reinterpret_cast<const float4*>(bs + (r * NB + i) * PW_WG_T)[ty];
        const float ax[4] = {av.x, av.y, av.z, av.w};
        const float bx[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[p][q][A::grade(i)] =
                fmaf(ax[p], bx[q], acc[p][q][A::grade(i)]);
      }
    }
  }
  float* out = wpart + (int64_t)blockIdx.y * pw_wpart_floats<A>(cin, c);
  const int64_t off = which == 0 ? 0
                      : which == 1 ? (int64_t)c * cin * NG
                                   : (int64_t)c * cin * NG +
                                         (int64_t)c * c * NG;
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int mi = m0 + 4 * tx + p, n = n0 + 4 * ty + q;
      if (mi >= M || n >= c) continue;
#pragma unroll
      for (int gg = 0; gg < NG; ++gg)
        out[off + ((int64_t)n * M + mi) * NG + gg] = acc[p][q][gg];
    }
}

// The path-weight gradients over the scratch: CTA (channel group, split)
// takes PW_PG_C channels over the rows [split * chunk, (split + 1) *
// chunk), a thread one (channel, path), and walks the path's pairs (the
// packed LIST, grouped by path) over a stage's rows: the sum of (z_i *
// yn_k) * (sign * d(first)_j), as K3p's path_grads; it writes its split's
// slab of ppart ([C][NP]).
template <class A>
__global__ void __launch_bounds__(256)
cemlp_pair_wide_pgrad_kernel(const float* __restrict__ scratch,
                             const uint16_t* __restrict__ tabs,
                             float* __restrict__ ppart, int rows, int c,
                             int chunk) {
  constexpr int NB = A::NB, NP = A::NP;
  constexpr int NLIST = NB * NB + NP + 1;
  __shared__ uint16_t list[NLIST];
  __shared__ __align__(16) float st[3][PW_PG_R][PW_PG_C][NB];
  const int tid = threadIdx.x;
  for (int e = tid; e < NLIST; e += 256) list[e] = tabs[A::TAB_T + e];
  const uint16_t* off = list + NB * NB;
  const int n0 = blockIdx.x * PW_PG_C, nl = tid >> 6, p = tid & 63;
  const bool mine = p < NP && n0 + nl < c;
  const int64_t plane = (int64_t)rows * c * NB;
  const float* src[3] = {scratch, scratch + 4 * plane, scratch + 3 * plane};
  const int64_t r_begin = (int64_t)blockIdx.y * chunk;
  const int64_t r_end = r_begin + chunk < rows ? r_begin + chunk : rows;
  float acc = 0.f;
  for (int64_t r0 = r_begin; r0 < r_end; r0 += PW_PG_R) {
    __syncthreads();
    for (int e = tid; e < 3 * PW_PG_R * PW_PG_C * NB; e += 256) {
      const int i = e % NB, cl = (e / NB) % PW_PG_C,
                r = (e / (NB * PW_PG_C)) % PW_PG_R,
                w = e / (NB * PW_PG_C * PW_PG_R);
      const int64_t row = r0 + r;
      const int n = n0 + cl;
      st[w][r][cl][i] =
          row < r_end && n < c ? src[w][(row * c + n) * NB + i] : 0.f;
    }
    __syncthreads();
    if (mine) {   // each pair's entry read once a stage, then its rows
      for (int t = off[p]; t < off[p + 1]; ++t) {
        const int Lq = list[t];
        const int j = Lq & FIELD, k = (Lq >> 5) & FIELD,
                  i = (Lq >> 10) & FIELD;
        const bool neg = Lq >> 15;
#pragma unroll
        for (int r = 0; r < PW_PG_R; ++r) {
          const float d = st[2][r][nl][j];
          acc += (st[0][r][nl][i] * st[1][r][nl][k]) * (neg ? -d : d);
        }
      }
    }
  }
  if (mine) ppart[(int64_t)blockIdx.y * c * NP + (n0 + nl) * NP + p] = acc;
}

// The gradient vector (flax layout, pw_grad_floats) from the slabs: the
// weight gradients summed over the wgrad splits, the path weights' over
// the pgrad splits, the per-channel ones over the row kernel's row slots,
// each in slab order; with `accum` added onto the vector's values (K5pw
// sums its slabs of edge rows so, in order).
template <class A>
__global__ void __launch_bounds__(256)
cemlp_pair_wide_reduce_kernel(const float* __restrict__ wpart, int splits,
                              const float* __restrict__ ppart, int psplits,
                              const float* __restrict__ lpart, int nloc,
                              float* __restrict__ grads, int cin, int c,
                              int accum) {
  constexpr int NG = A::NG, NP = A::NP;
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= pw_grad_floats<A>(cin, c)) return;
  const int64_t nw = pw_wpart_floats<A>(cin, c);
  const int64_t w1 = (int64_t)c * cin * NG, wc = (int64_t)c * c * NG;
  int64_t w = -1, pq = -1;   // index in a wgrad / pgrad slab
  int field = 0, n = 0;
  int64_t e = q;
  if (e < w1) {
    w = e;
  } else if ((e -= w1) < c) {
    field = A::L_B1; n = (int)e;
  } else if ((e -= c) < NG * c) {
    field = A::L_SA + (int)(e % NG); n = (int)(e / NG);
  } else if ((e -= NG * c) < NG * c) {
    field = A::L_SB + (int)(e % NG); n = (int)(e / NG);
  } else if ((e -= NG * c) < NP * c) {
    pq = e;
  } else if ((e -= NP * c) < wc) {
    w = w1 + e;
  } else if ((e -= wc) < NG * c) {
    field = A::L_NS + (int)(e % NG); n = (int)(e / NG);
  } else if ((e -= NG * c) < wc) {
    w = w1 + wc + e;
  } else if ((e -= wc) < c) {
    field = A::L_BL; n = (int)e;
  } else {
    field = A::L_ALN; n = (int)(e - c);
  }
  float acc = 0.f;
  if (w >= 0) {
    for (int s = 0; s < splits; ++s) acc += wpart[(int64_t)s * nw + w];
  } else if (pq >= 0) {
    for (int s = 0; s < psplits; ++s)
      acc += ppart[(int64_t)s * c * NP + pq];
  } else {
    for (int l = 0; l < nloc; ++l)
      acc += lpart[((int64_t)l * A::NLOC + field) * c + n];
  }
  grads[q] = accum ? grads[q] + acc : acc;
}

// ------------------------------------------------------------------ host

inline bool pw_ok(int cin, int c) {
  return cin >= 1 && c >= 1 && c <= PW_MAX_C && cin <= PW_MAX_CIN;
}

// Warps a CTA of the direction takes: the most, up to PW_MAX_WARPS
// (PW_MAX_WARPS_BWD), whose shared memory fits in 227 KB (0 outside the
// range).
template <class A>
int pw_warps(int cin, int c, int backward) {
  if (!pw_ok(cin, c)) return 0;
  for (int w = backward ? PW_MAX_WARPS_BWD : PW_MAX_WARPS; w >= 1; --w)
    if (sizeof(float) * (size_t)pw_smem_floats<A>(c, w, backward != 0) <=
        kMaxSmem)
      return w;
  return 0;
}

template <class A>
size_t pw_smem_bytes(int cin, int c, int backward) {
  const int w = pw_warps<A>(cin, c, backward);
  return w ? sizeof(float) * (size_t)pw_smem_floats<A>(c, w, backward != 0)
           : 0;
}

template <class A>
long long pw_img_floats(int cin, int c, int backward) {
  if (!pw_ok(cin, c)) return 0;
  return (long long)pw_layout<A>(cin, c, backward != 0).total;
}

template <class A>
int pw_wgrad_jobs(int cin, int c) {
  const int mt0 = (cin + PW_WG_T - 1) / PW_WG_T,
            mt1 = (c + PW_WG_T - 1) / PW_WG_T;
  return mt1 * (mt0 + 2 * mt1);
}

// Row splits of a gradient kernel of `jobs` CTAs a split: about two CTAs
// an SM, each over at least 64 rows.
inline int pw_splits(int rows, int jobs, int sms) {
  int p = (2 * sms + jobs - 1) / jobs;
  const int most = (rows + 63) / 64;
  if (p > most) p = most;
  return p < 1 ? 1 : p;
}

template <class A, bool FAST>
void launch_pw_pack(const Params& p, const PWLayout& L, float* img,
                    cudaStream_t st) {
  int64_t blocks = (L.total + 255) / 256;
  if (blocks > 2048) blocks = 2048;
  cemlp_pair_wide_pack_kernel<A, FAST>
      <<<(unsigned)blocks, 256, 0, st>>>(p, L, img);
}

template <class A, bool FAST>
void launch_pw_fwd(const float* x, const Params& p, const Tabs<A>& tb,
                   const uint16_t* tabs, float* out, float* img, int rows,
                   const PWLayout& L, int grid, int warps, size_t bytes,
                   cudaStream_t st) {
  launch_pw_pack<A, FAST>(p, L, img, st);
  cudaFuncSetAttribute(cemlp_pair_wide_fwd_kernel<A, FAST>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  cemlp_pair_wide_fwd_kernel<A, FAST><<<grid, dim3(32, warps), bytes, st>>>(
      x, img, tabs, tb, out, rows, L);
}

template <class A>
int pair_wide_fwd(const float* x, const Params& p, const float* bc,
                  const uint16_t* tabs, float* out, float* img, int rows,
                  int cin, int c, int fast, int grid, void* stream) {
  const int warps = pw_warps<A>(cin, c, 0);
  const size_t bytes = pw_smem_bytes<A>(cin, c, 0);
  if (warps == 0 || bytes > kMaxSmem || grid < 1)
    return (int)cudaErrorInvalidValue;
  const PWLayout L = pw_layout<A>(cin, c, false);
  const Tabs<A> tb = make_tabs<A>(bc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    if (fast)
      launch_pw_fwd<A, true>(x, p, tb, tabs, out, img, rows, L, grid, warps,
                             bytes, st);
    else
      launch_pw_fwd<A, false>(x, p, tb, tabs, out, img, rows, L, grid, warps,
                              bytes, st);
  }
  return (int)cudaGetLastError();
}

template <class A, bool FAST>
void launch_pw_bwd(const float* x, const float* dout, const Params& p,
                   const Tabs<A>& tb, const uint16_t* tabs, float* dx,
                   float* img, float* scratch, float* lpart, float* wpart,
                   float* ppart, int rows, const PWLayout& L, int grid,
                   int warps, int splits, int psplits, size_t bytes,
                   cudaStream_t st) {
  launch_pw_pack<A, FAST>(p, L, img, st);
  cudaFuncSetAttribute(cemlp_pair_wide_bwd_kernel<A, FAST>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  cemlp_pair_wide_bwd_kernel<A, FAST><<<grid, dim3(32, warps), bytes, st>>>(
      x, dout, img, tabs, tb, dx, scratch, lpart, rows, L);
  const int chunk = (rows + splits - 1) / splits;
  cemlp_pair_wide_wgrad_kernel<A, FAST>
      <<<dim3(pw_wgrad_jobs<A>(L.cin, L.c), splits), 256, 0, st>>>(
          x, scratch, wpart, rows, L.cin, L.c, chunk < 1 ? 1 : chunk);
  const int pchunk = (rows + psplits - 1) / psplits;
  cemlp_pair_wide_pgrad_kernel<A>
      <<<dim3((L.c + PW_PG_C - 1) / PW_PG_C, psplits), 256, 0, st>>>(
          scratch, tabs, ppart, rows, L.c, pchunk < 1 ? 1 : pchunk);
}

template <class A>
int pair_wide_bwd(const float* x, const float* dout, const Params& p,
                  const float* bc, const uint16_t* tabs, float* dx,
                  float* img, float* scratch, float* lpart, float* wpart,
                  float* ppart, float* grads, int rows, int cin, int c,
                  int fast, int grid, int splits, int psplits, void* stream) {
  const int warps = pw_warps<A>(cin, c, 1);
  const size_t bytes = pw_smem_bytes<A>(cin, c, 1);
  if (warps == 0 || bytes > kMaxSmem || grid < 1 || splits < 1 ||
      psplits < 1)
    return (int)cudaErrorInvalidValue;
  const PWLayout L = pw_layout<A>(cin, c, true);
  const Tabs<A> tb = make_tabs<A>(bc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fast)
    launch_pw_bwd<A, true>(x, dout, p, tb, tabs, dx, img, scratch, lpart,
                           wpart, ppart, rows, L, grid, warps, splits, psplits,
                           bytes, st);
  else
    launch_pw_bwd<A, false>(x, dout, p, tb, tabs, dx, img, scratch, lpart,
                            wpart, ppart, rows, L, grid, warps, splits,
                            psplits, bytes, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = pw_grad_floats<A>(cin, c);
  cemlp_pair_wide_reduce_kernel<A>
      <<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
          wpart, splits, ppart, psplits, lpart, grid * warps * A::MW, grads,
          cin, c, 0);
  return (int)cudaGetLastError();
}

}  // namespace

// One set of C entry points per algebra: csmpn_cemlp_pair_wide_* (Cl(5,0),
// cemlp_pair_wide.cu) and csmpn_cemlp_pair_wide_cl4_* (Cl(4,0),
// cemlp_pair_wide_cl4.cu).  The 10 block parameters are device pointers in
// flax order (w1 b1 sa sb gw wr na wl bl aln); bc the host quadratic-form
// coefficients; tabs the packed pair tables on the device (the packed
// entry's); x (rows, cin, NB) fp32, out (rows, c, NB); img the parameter
// image (img_floats of the direction).  The backward writes dx (rows, cin,
// NB) and grads (the flax-layout vector), with scratch (5 x rows x c x
// NB), lpart (grid x rows a CTA x loc_floats), wpart (splits x
// wpart_floats) and ppart (psplits x c x NP) as scratch; splits and
// psplits from the splits entries, the rows a CTA step takes warps(...) x
// (32 / NB).  The size entries return long long; smem_bytes gives a
// launch's shared memory, 0 where the widths are outside C <= PW_MAX_C,
// Cin <= PW_MAX_CIN, which the range entry writes (out[0] = PW_MAX_C,
// out[1] = PW_MAX_CIN); the tables entry the structural tables the kernels
// assume and the packed entry the tables they read (as cemlp_pair.cu's).
#define CSMPN_PAIR_WIDE_PARAMS_DECL                                           \
  const float *w1, const float *b1, const float *sa, const float *sb,         \
      const float *gw, const float *wr, const float *na, const float *wl,     \
      const float *bl, const float *aln
#define CSMPN_PAIR_WIDE_PARAMS Params{w1, b1, sa, sb, gw, wr, na, wl, bl, aln}
#define CSMPN_PAIR_WIDE_ENTRIES(PREFIX, ALG)                                  \
  long long PREFIX##_smem_bytes(int cin, int c, int backward) {               \
    return (long long)pw_smem_bytes<ALG>(cin, c, backward);                   \
  }                                                                           \
  long long PREFIX##_warps(int cin, int c, int backward) {                    \
    return pw_warps<ALG>(cin, c, backward);                                   \
  }                                                                           \
  long long PREFIX##_img_floats(int cin, int c, int backward) {               \
    return pw_img_floats<ALG>(cin, c, backward);                              \
  }                                                                           \
  long long PREFIX##_wgrad_splits(int rows, int cin, int c, int sms) {        \
    return pw_ok(cin, c)                                                 \
               ? pw_splits(rows, pw_wgrad_jobs<ALG>(cin, c), sms)             \
               : 0;                                                           \
  }                                                                           \
  long long PREFIX##_pgrad_splits(int rows, int c, int sms) {                 \
    return pw_ok(1, c)                                                   \
               ? pw_splits(rows, (c + PW_PG_C - 1) / PW_PG_C, sms)            \
               : 0;                                                           \
  }                                                                           \
  long long PREFIX##_wpart_floats(int cin, int c) {                           \
    return (long long)pw_wpart_floats<ALG>(cin, c);                           \
  }                                                                           \
  long long PREFIX##_loc_floats(int c) { return (long long)ALG::NLOC * c; }  \
  void PREFIX##_range(int* out) {                                             \
    out[0] = PW_MAX_C;                                                        \
    out[1] = PW_MAX_CIN;                                                      \
  }                                                                           \
  int PREFIX##_fwd(const float* x, CSMPN_PAIR_WIDE_PARAMS_DECL,               \
                   const float* bc, const uint16_t* tabs, float* out,         \
                   void* img, int rows, int cin, int c, int fast, int grid,   \
                   void* stream) {                                            \
    return pair_wide_fwd<ALG>(x, CSMPN_PAIR_WIDE_PARAMS, bc, tabs, out,       \
                              static_cast<float*>(img), rows, cin, c, fast,   \
                              grid, stream);                                  \
  }                                                                           \
  int PREFIX##_bwd(const float* x, const float* dout,                         \
                   CSMPN_PAIR_WIDE_PARAMS_DECL, const float* bc,              \
                   const uint16_t* tabs, float* dx, void* img,                \
                   float* scratch, float* lpart, float* wpart, float* ppart,  \
                   float* grads, int rows, int cin, int c, int fast,          \
                   int grid, int splits, int psplits, void* stream) {         \
    return pair_wide_bwd<ALG>(x, dout, CSMPN_PAIR_WIDE_PARAMS, bc, tabs, dx,  \
                              static_cast<float*>(img), scratch, lpart,       \
                              wpart, ppart, grads, rows, cin, c, fast, grid,  \
                              splits, psplits, stream);                       \
  }                                                                           \
  void PREFIX##_tables(int* i_of_out, int* path_out, int* grade_out,          \
                       float* sign_out) {                                     \
    structural_tables<ALG>(i_of_out, path_out, grade_out, sign_out);          \
  }                                                                           \
  int PREFIX##_packed(uint16_t* out, int cap) {                               \
    if (cap < ALG::TAB_LEN) return -1;                                        \
    return make_packed<ALG>(out);                                             \
  }
