// K2p and K3p — one whole CEMLP block of Cl(5,0), forward and backward, on
// Hopper (sm_90a): the pair form of the CEMLP block kernels.
//
// Replaces: csmpn_tpu/ops/cemlp_kernel.py, `_fwd_kernel` (K2p, launched by
// `_pallas_fwd`) and `_bwd_kernel` (K3p, launched by `_fused_block_bwd`) in
// their pair form (`_pair_form`, nb 16/32: `_gp_pair_fwd` and the pair
// branch of `_post_linear_bwd`).  One block is
//     MVLinear -> MVSiLU -> SGP (right linear, grade-norm normalisation,
//     geometric product, + left linear, / sqrt 2) -> MVLayerNorm
// on (rows, Cin, 32) float32 activations, 32 blades in short-lex order,
// 6 grades, 56 nonzero grade paths of the geometric product.
//
// Bound on this card: at the hulls task's widths (C = 28, Cin up to 59) a
// row costs ~2*32*C*(Cin + 2C) + 2*32*32*C FLOPs (three channel-mixing
// linears and the pair product) against 4*32*(Cin + C) bytes, ~30 FLOP
// per byte: memory-bound against the tensor cores, near the fp32 FMA
// ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte).  The backward does
// about three times the forward's work on about twice the bytes.
//
// Design.  The TPU kernel folds the blade axis into 128-lane channel
// groups and expands the pair structure into 0/1 matrix products (Rz, Ry,
// S4).  Here the 32 blades of Cl(5) are a warp's 32 lanes, a lane owning
// one blade of every channel, and a team of warps owns a row (2 warps in
// the forward, 4 in the backward; each takes every 2nd or 4th group of
// four channels).  One CTA fits on an SM (the parameters and row buffers
// take ~180-220 KB of shared memory), so the teams are what puts 16 warps
// on an SM to hide the latency of the shared-memory loads and shuffles.
//   * the channel-mixing linears are FMA loops over the input channels,
//     reading the row from shared memory (lane-contiguous) and four output
//     channels' weights at once as one float4 (six distinct addresses per
//     warp, one per grade: a broadcast);
//   * the grade sums (grades are contiguous runs of blades, sizes 1, 5,
//     10, 10, 5, 1) are read back from a per-warp scratch row, each lane
//     summing its grade's run in a fixed order;
//   * the geometric product out_j = sum_k sign * w[path] * z_i * yn_k,
//     i = i_of(j, k), is 32 steps of a shuffle (yn_k) and a shared-memory
//     read (z_i) per lane, with (i, sign, path) from a packed table in
//     shared memory, for four channels at once (four independent chains);
//     the layer norm's channel mean is a warp sum per channel, and the
//     channel sums of a team meet in shared memory, added in warp order;
//   * the block's parameters are staged once per CTA in shared memory.
// The backward recomputes the forward in the row (as the TPU kernel does),
// keeps the row's cotangents in shared memory, and writes dx per row.  Its
// parameter gradients: per-channel ones in a per-row shared-memory slice
// (each channel owned by one warp of the team),
// the 56 path weights' in a CTA slice owned entry by entry (pairs grouped
// by path), the channel-mixing weights' in the CTA's slice of global
// scratch (no room is left in shared memory), each entry owned by one
// thread.  CTAs write partial sums that a second kernel adds in a fixed
// order: no atomics, bitwise repeatable.
//
// Precision: FAST = false is fp32 throughout.  FAST = true rounds to bf16
// the operands of each product that the TPU kernel feeds its matrix unit
// (`_cast_pair`/`_dot*`), and accumulates in fp32.  In the pair form that
// includes the pair product z_i * yn_k * w (the operand of the S4 sum;
// the path weight w itself stays fp32), and in the backward the products
// (d(gp)_j * sign * yn_k) * w and (d(gp)_j * sign * z_i) * w.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NB = 32;         // blades of Cl(5)
constexpr int NG = 6;          // grades
constexpr int NP = 56;         // nonzero grade paths
constexpr int ROWS_F = 8;      // rows per CTA at a time, forward
constexpr int TEAM_F = 2;      // warps per row, forward
constexpr int WARPS_F = ROWS_F * TEAM_F;
constexpr int THREADS_F = 32 * WARPS_F;
constexpr int ROWS_B = 4;      // rows per CTA tile, backward
constexpr int TEAM_B = 4;      // warps per row, backward
constexpr int WARPS_B = ROWS_B * TEAM_B;
constexpr int THREADS_B = 32 * WARPS_B;
constexpr int XCH = 8;         // a row's exchange slots: 2 sums x 4 warps
constexpr int RP = 33;         // shared-memory pitch of a channel's blades
constexpr int NLOC = 21;       // per-channel gradient rows of a row slot
constexpr int TAB_T = 3 * NB * NB;          // T1 | T2 | T3
constexpr int TAB_LEN = TAB_T + NB * NB + NP + 1;   // + pair list, offsets
constexpr int TAB_FLOATS = ((TAB_LEN + 1) / 2 + 3) / 4 * 4;
constexpr float EPS = 1e-6f;
constexpr float SQRT2_INV = 0.70710678118654752440f;
constexpr size_t kMaxSmem = 232448;   // 227 KB opt-in per block

// grade of short-lex blade i, and the first blade of grade g
__host__ __device__ constexpr int grade5(int i) {
  return i == 0 ? 0 : i < 6 ? 1 : i < 16 ? 2 : i < 26 ? 3 : i < 31 ? 4 : 5;
}
__host__ __device__ constexpr int gstart(int g) {
  return g == 0 ? 0 : g == 1 ? 1 : g == 2 ? 6 : g == 3 ? 16 : g == 4 ? 26
       : g == 5 ? 31 : 32;
}

// ------------------------------------------------------------ host tables

// short-lex index -> bitmap of Cl(5)
const int kBitmap[NB] = {0, 1, 2, 4, 8, 16, 3, 5, 9, 17, 6, 10, 18, 12, 20,
                         24, 7, 11, 19, 13, 21, 25, 14, 22, 26, 28, 15, 23,
                         27, 29, 30, 31};

int popcount(int v) {
  int n = 0;
  for (; v; v >>= 1) n += v & 1;
  return n;
}

int index_of_bitmap(int bm) {
  for (int i = 0; i < NB; ++i)
    if (kBitmap[i] == bm) return i;
  return -1;
}

// sign of e_A e_B for bitmaps A, B with every basis vector squaring to +1
int reorder_sign(int a, int b) {
  int swaps = 0;
  for (a >>= 1; a; a >>= 1) swaps += popcount(a & b);
  return (swaps & 1) ? -1 : 1;
}

// The pair structure: for output j and right k the left blade i, the sign
// of e_i e_k = sign e_j, and the index of the grade path (g(i), g(j), g(k))
// among the nonzero ones in lexicographic order.
struct Pairs {
  int i_of[NB][NB], path[NB][NB], sign[NB][NB];
};

void make_pairs(Pairs& t) {
  int pid[NG][NG][NG];
  bool valid[NG][NG][NG] = {};
  for (int i = 0; i < NB; ++i)
    for (int k = 0; k < NB; ++k)
      valid[grade5(i)][popcount(kBitmap[i] ^ kBitmap[k])][grade5(k)] = true;
  int n = 0;
  for (int a = 0; a < NG; ++a)
    for (int b = 0; b < NG; ++b)
      for (int c = 0; c < NG; ++c) pid[a][b][c] = valid[a][b][c] ? n++ : -1;
  for (int j = 0; j < NB; ++j)
    for (int k = 0; k < NB; ++k) {
      const int i = index_of_bitmap(kBitmap[j] ^ kBitmap[k]);
      t.i_of[j][k] = i;
      t.sign[j][k] = reorder_sign(kBitmap[i], kBitmap[k]);
      t.path[j][k] = pid[grade5(i)][grade5(j)][grade5(k)];
    }
}

uint16_t pack(int blade, int sign, int path) {
  return (uint16_t)(blade | (sign < 0 ? 32 : 0) | (path << 6));
}

// Packed tables, uint16:
//   T1[k*32 + j] = (i, sign, path) of pair (j, k)   lane j, loop k
//   T2[k*32 + i] = (j, sign, path) of pair (j, k), j = i_of(i, k)
//                                                   lane i, loop k
//   T3[j*32 + k] = (i, sign, path) of pair (j, k)   lane k, loop j
//   LIST[q] = j | k << 5 | i << 10 | neg << 15, the pairs grouped by path
//   OFF[p] = first LIST entry of path p, OFF[56] = 1024
int make_packed(uint16_t* out) {
  Pairs t;
  make_pairs(t);
  for (int j = 0; j < NB; ++j)
    for (int k = 0; k < NB; ++k) {
      const uint16_t e = pack(t.i_of[j][k], t.sign[j][k], t.path[j][k]);
      out[k * NB + j] = e;
      out[2 * NB * NB + j * NB + k] = e;
    }
  for (int i = 0; i < NB; ++i)
    for (int k = 0; k < NB; ++k) {
      const int j = index_of_bitmap(kBitmap[i] ^ kBitmap[k]);
      out[NB * NB + k * NB + i] = pack(j, t.sign[j][k], t.path[j][k]);
    }
  uint16_t* list = out + TAB_T;
  uint16_t* off = list + NB * NB;
  int q = 0;
  for (int p = 0; p < NP; ++p) {
    off[p] = (uint16_t)q;
    for (int j = 0; j < NB; ++j)
      for (int k = 0; k < NB; ++k)
        if (t.path[j][k] == p)
          list[q++] = (uint16_t)(j | (k << 5) | (t.i_of[j][k] << 10) |
                                 (t.sign[j][k] < 0 ? (1 << 15) : 0));
  }
  off[NP] = (uint16_t)q;
  return q == NB * NB ? TAB_LEN : -1;
}

// ---------------------------------------------------------- device helpers

struct Params {
  const float *w1, *b1, *sa, *sb, *gw, *wr, *na, *wl, *bl, *aln;
};

struct Tabs {
  float bc[NB];          // quadratic-form coefficient per blade
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

// Sum of v over the lanes of this lane's grade [lo, hi), the same value
// on every lane of the grade.  sc is the warp's 32-float scratch row.
__device__ __forceinline__ float grade_sum(float v, float* sc, int lane,
                                           int lo, int hi) {
  __syncwarp();
  sc[lane] = v;
  __syncwarp();
  float s = 0.f;
  for (int t = lo; t < hi; ++t) s += sc[t];
  return s;
}

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.f / (1.f + expf(-v));
}

__host__ __device__ inline int pad4(int c) { return (c + 3) & ~3; }

// Block parameters staged in shared memory.  Channel-mixing weights are
// laid out [m][g][n] with the output channels n padded to C4 = pad4(C)
// (zeros), so four channels' weights are one aligned float4.
struct Smem {
  float *w1, *wr, *wl;             // [m * pm + g * C4 + n]
  float *ra, *sb, *nsig, *gw;      // [g * C4 + n], gw [p * C4 + n]
  float *b1, *bl, *aln;            // [n]
  int pm1, pm, c4;
};

__host__ __device__ inline int params_floats(int cin, int c) {
  const int c4 = pad4(c), pm = NG * c4 + 4;
  return cin * pm + 2 * c * pm + c4 * (3 * NG + NP + 3);
}

__device__ inline void carve_params(float* base, int cin, int c, Smem& s) {
  s.c4 = pad4(c);
  s.pm1 = NG * s.c4 + 4;
  s.pm = s.pm1;
  s.w1 = base;
  s.wr = s.w1 + cin * s.pm1;
  s.wl = s.wr + c * s.pm;
  s.ra = s.wl + c * s.pm;
  s.sb = s.ra + NG * s.c4;
  s.nsig = s.sb + NG * s.c4;
  s.gw = s.nsig + NG * s.c4;
  s.b1 = s.gw + NP * s.c4;
  s.bl = s.b1 + s.c4;
  s.aln = s.bl + s.c4;
}

template <bool FAST>
__device__ void stage_params(const Params& p, const Smem& s, int cin, int c,
                             int nthreads) {
  const int tid = threadIdx.x + 32 * threadIdx.y;
  const int c4 = s.c4;
  for (int e = tid; e < cin * NG * c4; e += nthreads) {   // [m][g][n]
    const int n = e % c4, g = (e / c4) % NG, m = e / (c4 * NG);
    s.w1[m * s.pm1 + g * c4 + n] =
        n < c ? rnd<FAST>(p.w1[(n * cin + m) * NG + g]) : 0.f;
  }
  for (int e = tid; e < c * NG * c4; e += nthreads) {
    const int n = e % c4, g = (e / c4) % NG, m = e / (c4 * NG);
    const bool in = n < c;
    s.wr[m * s.pm + g * c4 + n] = in ? rnd<FAST>(p.wr[(n * c + m) * NG + g]) : 0.f;
    s.wl[m * s.pm + g * c4 + n] = in ? rnd<FAST>(p.wl[(n * c + m) * NG + g]) : 0.f;
  }
  for (int e = tid; e < NG * c4; e += nthreads) {          // [g][n]
    const int n = e % c4, g = e / c4;
    const bool in = n < c;
    s.ra[e] = in ? rnd<FAST>(p.sa[n * NG + g]) : 0.f;
    s.sb[e] = in ? p.sb[n * NG + g] : 0.f;
    s.nsig[e] = in ? sigmoid_f(p.na[n * NG + g]) : 0.f;
  }
  for (int e = tid; e < NP * c4; e += nthreads) {          // [p][n], fp32
    const int n = e % c4, q = e / c4;
    s.gw[e] = n < c ? p.gw[n * NP + q] : 0.f;
  }
  for (int e = tid; e < c4; e += nthreads) {
    const bool in = e < c;
    s.b1[e] = in ? p.b1[e] : 0.f;
    s.bl[e] = in ? p.bl[e] : 0.f;
    s.aln[e] = in ? p.aln[e] : 0.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

}  // namespace

namespace {

// This lane's blade: its grade's run [lo, hi) and quadratic coefficient.
struct Lane {
  int id, g, lo, hi;
  float bc;
};

__device__ __forceinline__ Lane make_lane(const Tabs& tb) {
  Lane l;
  l.id = threadIdx.x;
  l.g = grade5(l.id);
  l.lo = gstart(l.g);
  l.hi = gstart(l.g + 1);
  l.bc = tb.bc[l.id];
  return l;
}

// The warps that share a row: warp h of nh (1, 2 or 4), their named
// barrier (for nh > 1), and the row's XCH exchange slots in shared memory.
// Each warp takes every nh-th group of four channels; sums over channels
// meet in the exchange slots and are added in warp order, so every warp of
// the row holds the same bits.
struct Team {
  int h, nh, bar;
  float* xch;
};

__device__ __forceinline__ void team_sync(const Team& t) {
  if (t.nh == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(t.bar), "r"(32 * t.nh) : "memory");
}

// The team's sum of a warp-uniform partial; slot 0 or 1.
__device__ __forceinline__ float team_sum(const Team& t, float v, int slot) {
  if (t.nh == 1) return v;
  if (threadIdx.x == 0) t.xch[4 * slot + t.h] = v;
  team_sync(t);
  float sum = 0.f;
  for (int k = 0; k < t.nh; ++k) sum += t.xch[4 * slot + k];
  return sum;
}

// The input linear for output channels n0..n0+3 at this lane's blade:
// acc[u] = sum_m xs[m] * W1[n0+u, m, g].
__device__ __forceinline__ void linear4(const float* rows, const float* w,
                                        int pitch, int nin, int g, int c4,
                                        int n0, int lane, float (&acc)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) acc[u] = 0.f;
  for (int m = 0; m < nin; ++m) {
    const float v = rows[m * RP + lane];
    const float4 ww = ld4(w + m * pitch + g * c4 + n0);
    acc[0] += v * ww.x;
    acc[1] += v * ww.y;
    acc[2] += v * ww.z;
    acc[3] += v * ww.w;
  }
}

// Input linear and MVSiLU of channel n from its linear output y (without
// bias): returns y with bias; sets inv (grade invariant) and sg (gate).
template <bool FAST>
__device__ __forceinline__ float silu_in(const Smem& s, const Lane& l,
                                         float* sc, int n, float acc,
                                         float& inv, float& sg) {
  const float y = acc + (l.id == 0 ? s.b1[n] : 0.f);
  const float v = l.id == 0 ? rnd<FAST>(y) : rnd<FAST>(y * y * l.bc);
  inv = grade_sum(v, sc, l.id, l.lo, l.hi);
  sg = sigmoid_f(s.ra[l.g * s.c4 + n] * inv + s.sb[l.g * s.c4 + n]);
  return y;
}

// Grade-norm normalisation of channel n's right operand yr.
struct Norm {
  float qg, s1g, nr, den, yn;
};

template <bool FAST>
__device__ __forceinline__ Norm normalise(const Smem& s, const Lane& l,
                                          float* sc, int n, float yr) {
  Norm q;
  q.qg = grade_sum(rnd<FAST>(yr * yr * l.bc), sc, l.id, l.lo, l.hi);
  q.s1g = sqrtf(q.qg * q.qg + 1e-16f);
  q.nr = sqrtf(q.s1g);
  q.den = s.nsig[l.g * s.c4 + n] * (q.nr - 1.f) + 1.f + EPS;
  q.yn = yr / q.den;
  return q;
}

// Forward of one block for the row of this team.  xs: the row's [m][RP]
// input (rounded in fast mode); writes the rounded z to zs, the rounded
// normalised right operand to ys (if not null) and the pre-norm output o
// to os, all [n][RP], each warp its own channels.  Returns the layer
// norm's divisor m.  Every lane of the team must call it.
template <bool FAST>
__device__ float row_forward(const Smem& s, const Lane& l, const Team& tm,
                             const uint16_t* t1, const float* xs, float* zs,
                             float* ys, float* os, float* sc, int cin,
                             int c) {
  const int lane = l.id, step = 4 * tm.nh;
  // ---- MVLinear + MVSiLU
  for (int n0 = 4 * tm.h; n0 < c; n0 += step) {
    float acc[4];
    linear4(xs, s.w1, s.pm1, cin, l.g, s.c4, n0, lane, acc);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int n = n0 + u;
      if (n < c) {
        float inv, sg;
        const float y = silu_in<FAST>(s, l, sc, n, acc[u], inv, sg);
        zs[n * RP + lane] = rnd<FAST>(sg * y);
      }
    }
  }
  team_sync(tm);
  // ---- SGP: right and left linears, normalisation, pair product; four
  // channels at a time, so the product loop runs four independent chains
  float msum = 0.f;
  for (int n0 = 4 * tm.h; n0 < c; n0 += step) {
    float ar[4], al[4], ynr[4], gp[4];
    linear4(zs, s.wr, s.pm, c, l.g, s.c4, n0, lane, ar);
    linear4(zs, s.wl, s.pm, c, l.g, s.c4, n0, lane, al);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ynr[u] = 0.f;
      gp[u] = 0.f;
      if (n0 + u < c) {
        ynr[u] = rnd<FAST>(normalise<FAST>(s, l, sc, n0 + u, ar[u]).yn);
        if (ys) ys[(n0 + u) * RP + lane] = ynr[u];
      }
    }
    // channels past c read the next buffer's rows and zero weights; their
    // sums are dropped
    const float* zrow = zs + n0 * RP;
    const float* gwn = s.gw + n0;
#pragma unroll 4
    for (int k = 0; k < NB; ++k) {
      const int t = t1[k * NB + lane];
      const int i = t & 31, q = (t >> 6) * s.c4;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float yk = __shfl_sync(0xffffffffu, ynr[u], k);
        const float pr = rnd<FAST>((zrow[u * RP + i] * yk) * gwn[q + u]);
        gp[u] += (t & 32) ? -pr : pr;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int n = n0 + u;
      if (n >= c) continue;
      const float first = al[u] + (lane == 0 ? s.bl[n] : 0.f);
      const float o = (first + gp[u]) * SQRT2_INV;
      os[n * RP + lane] = o;
      const float qc = warp_sum(rnd<FAST>(o * o * l.bc));
      msum += sqrtf(sqrtf(qc * qc + 1e-16f));
    }
  }
  return team_sum(tm, msum, 0) / (float)c + EPS;
}

template <bool FAST>
__global__ void __launch_bounds__(THREADS_F)
cemlp_pair_fwd_kernel(const float* __restrict__ x, Params p, Tabs tb,
                      const uint16_t* __restrict__ tabs,
                      float* __restrict__ out, int rows, int cin, int c) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  Smem s;
  carve_params(smem, cin, c, s);
  uint16_t* t1 = reinterpret_cast<uint16_t*>(smem + params_floats(cin, c));
  float* sc = smem + params_floats(cin, c) + TAB_FLOATS;   // [WARPS_F][32]
  float* xch = sc + WARPS_F * NB;                          // [ROWS_F][XCH]
  float* rowbuf = xch + ROWS_F * XCH;
  stage_params<FAST>(p, s, cin, c, THREADS_F);
  const int tid = threadIdx.x + 32 * threadIdx.y;
  for (int e = tid; e < NB * NB; e += THREADS_F) t1[e] = tabs[e];
  __syncthreads();

  const Lane l = make_lane(tb);
  // warps TEAM_F * r ... share row slot r (named barrier 1 + r)
  const int w = threadIdx.y, r = w / TEAM_F;
  const Team tm{w % TEAM_F, TEAM_F, 1 + r, xch + XCH * r};
  float* xs = rowbuf + r * (cin + 2 * pad4(c)) * RP;
  float* zs = xs + cin * RP;
  float* os = zs + pad4(c) * RP;
  float* scw = sc + w * NB;
  // row slots are independent after the staging
  for (int64_t row = (int64_t)blockIdx.x * ROWS_F + r; row < rows;
       row += (int64_t)gridDim.x * ROWS_F) {
    team_sync(tm);   // the previous row's output is written
    for (int m = tm.h; m < cin; m += tm.nh)
      xs[m * RP + l.id] = rnd<FAST>(x[(row * cin + m) * NB + l.id]);
    team_sync(tm);
    const float mden = row_forward<FAST>(s, l, tm, t1, xs, zs, nullptr, os,
                                         scw, cin, c);
    for (int n = tm.h; n < c; n += tm.nh)
      out[(row * c + n) * NB + l.id] = s.aln[n] / mden * os[n * RP + l.id];
  }
}

size_t fwd_smem_bytes(int cin, int c) {
  return sizeof(float) * ((size_t)params_floats(cin, c) + TAB_FLOATS +
                          WARPS_F * NB + ROWS_F * XCH +
                          (size_t)ROWS_F * (cin + 2 * pad4(c)) * RP);
}

}  // namespace

namespace {

// Per-warp gradient rows of loc ([NLOC][C4]): 0 b1, 1 bL, 2 layer-norm a,
// 3-8 silu.a, 9-14 silu.b, 15-20 d sigmoid(normalization.a), per grade.
constexpr int L_B1 = 0, L_BL = 1, L_ALN = 2, L_SA = 3, L_SB = 9, L_NS = 15;

// Row buffers of the backward, each [n][RP], in this order after xs; the
// channel buffers have C4 = pad4(C) rows, so the four-channel loops stay
// inside them.
struct Rows {
  float *xs, *zs, *ys, *fs, *dz, *dr;   // x, z, yn (rounded), d(first)
};                                       // (was o), d(z) then d(y), d(yr)

__host__ __device__ inline int row_floats(int cin, int c) {
  return (cin + 5 * pad4(c)) * RP;
}

__device__ __forceinline__ Rows carve_rows(float* base, int cin, int c) {
  const int c4 = pad4(c);
  Rows b;
  b.xs = base;
  b.zs = b.xs + cin * RP;
  b.ys = b.zs + c4 * RP;
  b.fs = b.ys + c4 * RP;
  b.dz = b.fs + c4 * RP;
  b.dr = b.dz + c4 * RP;
  return b;
}

// Backward of one block for the row of this warp, from the row's input
// (b.xs, loaded) and output cotangent go ((C, 32) in global memory).
// Writes dx for the row, leaves the rounded z, yn, d(first), d(y), d(yr)
// of the row in b for the CTA's weight-gradient passes, and adds the
// per-channel gradients of its warp's channels into loc.  Every lane of
// the team must call it.
template <bool FAST>
__device__ void row_backward(const Smem& s, const Lane& l, const Team& tm,
                             const uint16_t* t1, const uint16_t* t2,
                             const uint16_t* t3, const Rows& b, float* sc,
                             float* loc, const float* __restrict__ go,
                             float* __restrict__ dxr, int cin, int c) {
  const int lane = l.id, c4 = s.c4, step = 4 * tm.nh;
  const float mden = row_forward<FAST>(s, l, tm, t1, b.xs, b.zs, b.ys, b.fs,
                                       sc, cin, c);
  // ---- MVLayerNorm backward: out = aln * o / m (this warp's channels)
  float t = 0.f;
  for (int n0 = 4 * tm.h; n0 < c; n0 += step)
    for (int n = n0; n < n0 + 4 && n < c; ++n) {
      const float g = go[n * NB + lane], o = b.fs[n * RP + lane];
      t += g * s.aln[n] * o;
      const float ta = warp_sum(g * o);
      if (lane == 0) loc[L_ALN * c4 + n] += ta / mden;
    }
  const float dm = -team_sum(tm, warp_sum(t), 1) / (mden * mden);
  for (int n0 = 4 * tm.h; n0 < c; n0 += step)
    for (int n = n0; n < n0 + 4 && n < c; ++n) {
      const float g = go[n * NB + lane], o = b.fs[n * RP + lane];
      const float qc = warp_sum(rnd<FAST>(o * o * l.bc));
      const float s1c = sqrtf(qc * qc + 1e-16f);
      const float nc = sqrtf(s1c);
      const float dqc = rnd<FAST>(dm / (float)c * 0.5f * qc / (s1c * nc));
      const float dfg =
          (s.aln[n] * g / mden + dqc * 2.f * l.bc * o) * SQRT2_INV;
      b.fs[n * RP + lane] = rnd<FAST>(dfg);
      if (lane == 0) loc[L_BL * c4 + n] += dfg;
    }
  __syncwarp();
  // ---- pair-product and normalisation backward, four channels at a time
  // (four independent chains per loop; channels past c read padded rows
  // and zero weights, and their results are dropped)
  for (int n0 = 4 * tm.h; n0 < c; n0 += step) {
    float yr[4], ynr[4], dfr[4], dzg[4], dyn[4];
    Norm q[4];
    linear4(b.zs, s.wr, s.pm, c, l.g, c4, n0, lane, yr);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (n0 + u < c) q[u] = normalise<FAST>(s, l, sc, n0 + u, yr[u]);
      ynr[u] = n0 + u < c ? b.ys[(n0 + u) * RP + lane] : 0.f;
      dfr[u] = n0 + u < c ? b.fs[(n0 + u) * RP + lane] : 0.f;
      dzg[u] = 0.f;
      dyn[u] = 0.f;
    }
    const float* zrow = b.zs + n0 * RP;
    const float* drow = b.fs + n0 * RP;
    const float* gwn = s.gw + n0;
#pragma unroll 4
    for (int k = 0; k < NB; ++k) {       // lane = left blade i
      const int e = t2[k * NB + lane];
      const int j = e & 31, p = (e >> 6) * c4;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float yk = __shfl_sync(0xffffffffu, ynr[u], k);
        const float d = (e & 32) ? -drow[u * RP + j] : drow[u * RP + j];
        dzg[u] += rnd<FAST>((d * yk) * gwn[p + u]);
      }
    }
#pragma unroll 4
    for (int j = 0; j < NB; ++j) {       // lane = right blade k
      const int e = t3[j * NB + lane];
      const int i = e & 31, p = (e >> 6) * c4;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float dj = __shfl_sync(0xffffffffu, dfr[u], j);
        const float d = (e & 32) ? -dj : dj;
        dyn[u] += rnd<FAST>((d * zrow[u * RP + i]) * gwn[p + u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int n = n0 + u;
      if (n >= c) continue;
      // yn = yr / den
      const float dden = grade_sum(-dyn[u] * q[u].yn / q[u].den, sc, lane,
                                   l.lo, l.hi);
      if (lane == l.lo) loc[(L_NS + l.g) * c4 + n] += dden * (q[u].nr - 1.f);
      const float dnr = dden * s.nsig[l.g * c4 + n];
      const float dqg = rnd<FAST>(dnr * 0.5f * q[u].qg / (q[u].s1g * q[u].nr));
      const float dyr = dyn[u] / q[u].den + dqg * 2.f * l.bc * yr[u];
      b.dr[n * RP + lane] = rnd<FAST>(dyr);
      b.dz[n * RP + lane] = dzg[u];
    }
  }
  team_sync(tm);   // every channel's d(first) and d(yr) are in place
  // ---- transposed right/left linears, then MVSiLU backward, four
  // channels m at a time (their input linear recomputed as in the forward)
  for (int m0 = 4 * tm.h; m0 < c; m0 += step) {
    float ylin[4];
    linear4(b.xs, s.w1, s.pm1, cin, l.g, c4, m0, lane, ylin);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int m = m0 + u;
      if (m >= c) continue;
      float dz = b.dz[m * RP + lane];
      const float* wl = s.wl + m * s.pm + l.g * c4;
      const float* wr = s.wr + m * s.pm + l.g * c4;
      for (int n1 = 0; n1 < c; n1 += 4) {
        const float4 fl = ld4(wl + n1), fr = ld4(wr + n1);
        const float wlv[4] = {fl.x, fl.y, fl.z, fl.w};
        const float wrv[4] = {fr.x, fr.y, fr.z, fr.w};
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (n1 + v < c)
            dz += b.fs[(n1 + v) * RP + lane] * wlv[v] +
                  b.dr[(n1 + v) * RP + lane] * wrv[v];
      }
      float inv, sg;
      const float y = silu_in<FAST>(s, l, sc, m, ylin[u], inv, sg);
      const float dgate = dz * y * sg * (1.f - sg);
      const float dgs = grade_sum(dgate, sc, lane, l.lo, l.hi);
      const float dgr = grade_sum(rnd<FAST>(dgate), sc, lane, l.lo, l.hi);
      if (lane == l.lo) {
        loc[(L_SB + l.g) * c4 + m] += dgs;
        loc[(L_SA + l.g) * c4 + m] += inv * dgr;
      }
      const float dv = s.ra[l.g * c4 + m] * dgr;
      const float dy = dz * sg + (lane == 0 ? dv : 2.f * l.bc * y * dv);
      if (lane == 0) loc[L_B1 * c4 + m] += dy;
      b.dz[m * RP + lane] = rnd<FAST>(dy);
    }
  }
  team_sync(tm);   // every channel's d(y) is in place
  // ---- dx: transposed input linear, input channels split over the team
  for (int mi = tm.h; mi < cin; mi += tm.nh) {
    const float* w = s.w1 + mi * s.pm1 + l.g * c4;
    float acc = 0.f;
    for (int n1 = 0; n1 < c; n1 += 4) {
      const float4 f = ld4(w + n1);
      const float wv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (n1 + v < c) acc += b.dz[(n1 + v) * RP + lane] * wv[v];
    }
    dxr[mi * NB + lane] = acc;
  }
}

// One channel-mixing weight gradient over a tile's first nrow rows, added
// into aw ([(m * 6 + g) * C4 + n], the CTA's slice of global scratch):
// which = 0 for W1 (x with d(y)), 1 for Wr (z with d(yr)), 2 for WL (z with
// d(first)).  A thread owns one input channel m and four output channels,
// all six grades; the same thread owns the same entries on every call.
__device__ void mix_grads(const float* rowbuf, int rstride, int nrow, int cin,
                          int c, int c4, int which, float* aw) {
  const int tid = threadIdx.x + 32 * threadIdx.y;
  const int nq = c4 / 4, nin = which == 0 ? cin : c;
  for (int p = tid; p < nin * nq; p += THREADS_B) {
    const int m = p / nq, n0 = (p % nq) * 4;
    float acc[4][NG] = {};
    for (int r = 0; r < nrow; ++r) {
      const Rows b = carve_rows(const_cast<float*>(rowbuf) + r * rstride,
                                cin, c);
      const float* in = (which == 0 ? b.xs : b.zs) + m * RP;
      const float* d = (which == 0 ? b.dz : which == 1 ? b.dr : b.fs) + n0 * RP;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const float v = in[i];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (n0 + u < c) acc[u][grade5(i)] += v * d[u * RP + i];
      }
    }
    // all old values are loaded before any store, so their loads overlap
    float old[4][NG] = {};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (n0 + u < c)
#pragma unroll
        for (int g = 0; g < NG; ++g) old[u][g] = aw[(m * NG + g) * c4 + n0 + u];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (n0 + u < c)
#pragma unroll
        for (int g = 0; g < NG; ++g)
          aw[(m * NG + g) * c4 + n0 + u] = old[u][g] + acc[u][g];
  }
}

// Path-weight gradients of a tile's first nrow rows, added into gacc
// ([p * C4 + n], shared): a thread owns (path p, channel n) and walks the
// path's pairs (j, k): sum of (z_i * yn_k) * (sign * d(first)_j).
__device__ void path_grads(const float* rowbuf, int rstride, int nrow,
                           int cin, int c, int c4, const uint16_t* list,
                           const uint16_t* off, float* gacc) {
  const int tid = threadIdx.x + 32 * threadIdx.y;
  for (int e = tid; e < NP * c; e += THREADS_B) {
    const int q = e / c, n = e % c;
    float acc = 0.f;
    for (int r = 0; r < nrow; ++r) {
      const Rows b = carve_rows(const_cast<float*>(rowbuf) + r * rstride,
                                cin, c);
      const float* zr = b.zs + n * RP;
      const float* yr = b.ys + n * RP;
      const float* df = b.fs + n * RP;
      for (int t = off[q]; t < off[q + 1]; ++t) {
        const int L = list[t];
        const float d = (L >> 15) ? -df[L & 31] : df[L & 31];
        acc += (zr[(L >> 10) & 31] * yr[(L >> 5) & 31]) * d;
      }
    }
    gacc[q * c4 + n] += acc;
  }
}

// Gradient vector layout (flax parameter order and shapes):
//   dW1 (C, Cin, 6) | db1 (C) | dsilu_a (C, 6) | dsilu_b (C, 6) |
//   dgp_weight (C, 56) | dWr (C, C, 6) | dsigmoid(norm_a) (C, 6) |
//   dWL (C, C, 6) | dbL (C) | dln_a (C)
__host__ __device__ inline int64_t grad_floats(int cin, int c) {
  return (int64_t)c * cin * NG + c + 2 * NG * c + NP * c + c * c * NG +
         NG * c + c * c * NG + 2 * c;
}

// One CTA's scratch: its partial gradient vector, then its channel-mixing
// accumulators.
__host__ __device__ inline int64_t partial_floats(int cin, int c) {
  return grad_floats(cin, c) + (int64_t)(cin + 2 * c) * NG * pad4(c);
}

template <bool FAST>
__global__ void __launch_bounds__(THREADS_B)
cemlp_pair_bwd_kernel(const float* __restrict__ x,
                      const float* __restrict__ dout, Params p, Tabs tb,
                      const uint16_t* __restrict__ tabs,
                      float* __restrict__ dx, float* __restrict__ partials,
                      int rows, int cin, int c) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  Smem s;
  carve_params(smem, cin, c, s);
  const int c4 = s.c4;
  uint16_t* tab = reinterpret_cast<uint16_t*>(smem + params_floats(cin, c));
  const uint16_t *t1 = tab, *t2 = tab + NB * NB, *t3 = tab + 2 * NB * NB;
  const uint16_t *list = tab + TAB_T, *off = list + NB * NB;
  float* sc = smem + params_floats(cin, c) + TAB_FLOATS;   // [WARPS_B][32]
  float* locs = sc + WARPS_B * NB;                   // [ROWS_B][NLOC][C4]
  float* gacc = locs + ROWS_B * NLOC * c4;           // [NP][C4]
  float* xch = gacc + NP * c4;                       // [ROWS_B][XCH]
  float* rowbuf = xch + ROWS_B * XCH;                // [ROWS_B][rows]
  const int tid = threadIdx.x + 32 * threadIdx.y;
  stage_params<FAST>(p, s, cin, c, THREADS_B);
  for (int e = tid; e < TAB_LEN; e += THREADS_B) tab[e] = tabs[e];
  for (int e = tid; e < ROWS_B * NLOC * c4; e += THREADS_B) locs[e] = 0.f;
  for (int e = tid; e < NP * c4; e += THREADS_B) gacc[e] = 0.f;
  float* part = partials + (int64_t)blockIdx.x * partial_floats(cin, c);
  float* aw1 = part + grad_floats(cin, c);
  float* awr = aw1 + cin * NG * c4;
  float* awl = awr + c * NG * c4;
  const int rstride = row_floats(cin, c);
  for (int e = tid; e < (cin + 2 * c) * NG * c4; e += THREADS_B) aw1[e] = 0.f;

  const Lane l = make_lane(tb);
  // warps TEAM_B * r ... share row slot r (named barrier 1 + r) and its
  // per-channel gradient slice (each warp adds only its own channels)
  const int w = threadIdx.y, r = w / TEAM_B;
  const Team tm{w % TEAM_B, TEAM_B, 1 + r, xch + XCH * r};
  const Rows b = carve_rows(rowbuf + r * rstride, cin, c);
  float* loc = locs + r * NLOC * c4;
  const int n_tiles = (rows + ROWS_B - 1) / ROWS_B;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row = (int64_t)tile * ROWS_B + r;
    __syncthreads();   // staging done / previous tile consumed
    if (row < rows) {
      for (int m = tm.h; m < cin; m += tm.nh)
        b.xs[m * RP + l.id] = rnd<FAST>(x[(row * cin + m) * NB + l.id]);
      team_sync(tm);
      row_backward<FAST>(s, l, tm, t1, t2, t3, b, sc + w * NB, loc,
                         dout + row * c * NB, dx + row * cin * NB, cin, c);
    }
    __syncthreads();
    int nrow = rows - tile * ROWS_B;
    nrow = nrow < ROWS_B ? nrow : ROWS_B;
    mix_grads(rowbuf, rstride, nrow, cin, c, c4, 0, aw1);
    mix_grads(rowbuf, rstride, nrow, cin, c, c4, 1, awr);
    mix_grads(rowbuf, rstride, nrow, cin, c, c4, 2, awl);
    path_grads(rowbuf, rstride, nrow, cin, c, c4, list, off, gacc);
  }
  __syncthreads();
  // ---- this CTA's partial gradient vector, in flax layout; per-row
  // gradients summed in row-slot order
  auto locsum = [&](int k, int n) {
    float v = 0.f;
    for (int r = 0; r < ROWS_B; ++r) v += locs[(r * NLOC + k) * c4 + n];
    return v;
  };
  int64_t o = 0;
  for (int e = tid; e < c * cin * NG; e += THREADS_B) {    // (n, m, g)
    const int g = e % NG, m = (e / NG) % cin, n = e / (NG * cin);
    part[o + e] = aw1[(m * NG + g) * c4 + n];
  }
  o += (int64_t)c * cin * NG;
  for (int e = tid; e < c; e += THREADS_B) part[o + e] = locsum(L_B1, e);
  o += c;
  for (int e = tid; e < c * NG; e += THREADS_B)
    part[o + e] = locsum(L_SA + e % NG, e / NG);
  o += NG * c;
  for (int e = tid; e < c * NG; e += THREADS_B)
    part[o + e] = locsum(L_SB + e % NG, e / NG);
  o += NG * c;
  for (int e = tid; e < c * NP; e += THREADS_B)
    part[o + e] = gacc[(e % NP) * c4 + e / NP];
  o += NP * c;
  for (int e = tid; e < c * c * NG; e += THREADS_B) {
    const int g = e % NG, m = (e / NG) % c, n = e / (NG * c);
    part[o + e] = awr[(m * NG + g) * c4 + n];
  }
  o += (int64_t)c * c * NG;
  for (int e = tid; e < c * NG; e += THREADS_B)
    part[o + e] = locsum(L_NS + e % NG, e / NG);
  o += NG * c;
  for (int e = tid; e < c * c * NG; e += THREADS_B) {
    const int g = e % NG, m = (e / NG) % c, n = e / (NG * c);
    part[o + e] = awl[(m * NG + g) * c4 + n];
  }
  o += (int64_t)c * c * NG;
  for (int e = tid; e < c; e += THREADS_B) part[o + e] = locsum(L_BL, e);
  o += c;
  for (int e = tid; e < c; e += THREADS_B) part[o + e] = locsum(L_ALN, e);
}

// out[q] = sum over CTAs of partials[cta * stride + q], in CTA order.
__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       float* __restrict__ out, int64_t n,
                                       int64_t stride, int parts) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  float acc = 0.f;
  for (int t = 0; t < parts; ++t) acc += partials[(int64_t)t * stride + q];
  out[q] = acc;
}

size_t bwd_smem_bytes(int cin, int c) {
  return sizeof(float) *
         ((size_t)params_floats(cin, c) + TAB_FLOATS + WARPS_B * NB +
          (size_t)(ROWS_B * NLOC + NP) * pad4(c) + ROWS_B * XCH +
          (size_t)ROWS_B * row_floats(cin, c));
}

Tabs make_tabs(const float* bc) {
  Tabs tb;
  for (int i = 0; i < NB; ++i) tb.bc[i] = bc[i];
  return tb;
}

}  // namespace

extern "C" {

// Shared-memory bytes a launch needs (0 if the widths are not supported).
size_t csmpn_cemlp_pair_smem_bytes(int cin, int c, int backward) {
  if (c < 1 || cin < 1) return 0;
  const size_t n = backward ? bwd_smem_bytes(cin, c) : fwd_smem_bytes(cin, c);
  return n > kMaxSmem ? 0 : n;
}

// Floats of one CTA's slice of the backward's scratch.
long long csmpn_cemlp_pair_partial_floats(int cin, int c) {
  return (long long)partial_floats(cin, c);
}

// The structure the kernels assume, for the host to check against the
// algebra: i_of, path ids and signs of the pairs [j * 32 + k] (1024 each),
// grades (32).
void csmpn_cemlp_pair_tables(int* i_of_out, int* path_out, int* grade_out,
                             float* sign_out) {
  Pairs t;
  make_pairs(t);
  for (int j = 0; j < NB; ++j)
    for (int k = 0; k < NB; ++k) {
      i_of_out[j * NB + k] = t.i_of[j][k];
      path_out[j * NB + k] = t.path[j][k];
      sign_out[j * NB + k] = (float)t.sign[j][k];
    }
  for (int i = 0; i < NB; ++i)
    grade_out[i] = grade5(i) == popcount(kBitmap[i]) ? grade5(i) : -1;
}

// The packed tables the kernels read (uint16); returns their length, or
// -1 if cap is too small.
int csmpn_cemlp_pair_packed(uint16_t* out, int cap) {
  if (cap < TAB_LEN) return -1;
  return make_packed(out);
}

int csmpn_cemlp_pair_fwd(const float* x, const float* w1, const float* b1,
                         const float* sa, const float* sb, const float* gw,
                         const float* wr, const float* na, const float* wl,
                         const float* bl, const float* aln, const float* bc,
                         const uint16_t* tabs, float* out, int rows, int cin,
                         int c, int fast, int grid, void* stream) {
  const size_t bytes = csmpn_cemlp_pair_smem_bytes(cin, c, 0);
  if (bytes == 0) return (int)cudaErrorInvalidValue;
  Params p{w1, b1, sa, sb, gw, wr, na, wl, bl, aln};
  Tabs tb = make_tabs(bc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 block(32, WARPS_F);
  if (rows > 0) {
    if (fast) {
      cudaFuncSetAttribute(cemlp_pair_fwd_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      cemlp_pair_fwd_kernel<true><<<grid, block, bytes, st>>>(
          x, p, tb, tabs, out, rows, cin, c);
    } else {
      cudaFuncSetAttribute(cemlp_pair_fwd_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      cemlp_pair_fwd_kernel<false><<<grid, block, bytes, st>>>(
          x, p, tb, tabs, out, rows, cin, c);
    }
  }
  return (int)cudaGetLastError();
}

// partials: (grid, partial_floats) scratch; grads: (grad_floats,) output.
int csmpn_cemlp_pair_bwd(const float* x, const float* dout, const float* w1,
                         const float* b1, const float* sa, const float* sb,
                         const float* gw, const float* wr, const float* na,
                         const float* wl, const float* bl, const float* aln,
                         const float* bc, const uint16_t* tabs, float* dx,
                         float* partials, float* grads, int rows, int cin,
                         int c, int fast, int grid, void* stream) {
  const size_t bytes = csmpn_cemlp_pair_smem_bytes(cin, c, 1);
  if (bytes == 0) return (int)cudaErrorInvalidValue;
  Params p{w1, b1, sa, sb, gw, wr, na, wl, bl, aln};
  Tabs tb = make_tabs(bc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 block(32, WARPS_B);
  if (fast) {
    cudaFuncSetAttribute(cemlp_pair_bwd_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    cemlp_pair_bwd_kernel<true><<<grid, block, bytes, st>>>(
        x, dout, p, tb, tabs, dx, partials, rows, cin, c);
  } else {
    cudaFuncSetAttribute(cemlp_pair_bwd_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    cemlp_pair_bwd_kernel<false><<<grid, block, bytes, st>>>(
        x, dout, p, tb, tabs, dx, partials, rows, cin, c);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = grad_floats(cin, c);
  reduce_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      partials, grads, n, partial_floats(cin, c), grid);
  return (int)cudaGetLastError();
}

}  // extern "C"
