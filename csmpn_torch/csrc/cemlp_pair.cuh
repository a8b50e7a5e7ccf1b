// The pair form of one CEMLP block, per row, templated on the algebra: the
// device code shared by the pair-form block kernels (cemlp_pair_kernels.cuh,
// K2p and K3p) and the pair-form fused message-passing kernels
// (fused_egcl_pair.cuh, K4p and K5p), each compiled for Cl(5,0) (32 blades)
// and Cl(4,0) (16 blades) by its own thin source.
//
// A row's NB blades are NB lanes, a lane owning one blade of every channel.
// At Cl(5) a row member is a whole warp; at Cl(4) it is a half-warp, so a
// warp holds two members of one row side by side (each taking its own
// groups of four channels).  A team of members shares a row, each member
// taking every nh-th group of four channels (cemlp_pair_kernels.cuh's
// header says why).  Every collective of a member (the shuffles of the pair
// product, the blade sums, the grade sums' scratch) names only its own
// lanes: at Cl(4) the shuffles have width 16 and the half-warp's mask, so
// the two halves may run different channel counts.  Here:
//   * the traits `Cl5`/`Cl4`: blades, grades, grade paths, the short-lex
//     bitmap and grade runs, and the sizes derived from them;
//   * the host tables: the Cayley pairs (left blade, sign and grade path of
//     every (output j, right k)) and their packed form;
//   * the block's parameters staged in shared memory (`stage_params`);
//   * `row_forward`: one block's forward for a row; `row_backward`: its
//     backward, recomputing the forward, with the per-channel gradients of
//     the row's channels added into a per-row slice;
//   * `mix_grads` and `path_grads`: the channel-mixing and path-weight
//     gradients summed over a tile of rows, each entry owned by one thread.
//
// Precision: FAST = false is fp32 throughout.  FAST = true rounds to bf16
// the operands of each product that the TPU kernel feeds its matrix unit,
// including the pair product z_i * yn_k * w (the path weight w itself
// stays fp32), and accumulates in fp32.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float EPS = 1e-6f;
constexpr float SQRT2_INV = 0.70710678118654752440f;
constexpr size_t kMaxSmem = 232448;   // 227 KB opt-in per block

// Sizes every pair-form algebra derives from its blades, grades and paths.
template <int NB_, int NG_, int NP_>
struct PairAlgebra {
  static constexpr int NB = NB_;            // blades
  static constexpr int NG = NG_;            // grades
  static constexpr int NP = NP_;            // nonzero grade paths
  static constexpr int MW = 32 / NB;        // row members a warp holds
  static constexpr int RP = NB + 1;         // shared-memory pitch of a channel
  static constexpr int NLOC = 3 + 3 * NG;   // per-channel gradient rows
  // a row's exchange slots: 2 sums x at most 4 warps x MW members
  static constexpr int XCH = 8 * MW;
  static constexpr int TAB_T = 3 * NB * NB;                 // T1 | T2 | T3
  static constexpr int TAB_LEN = TAB_T + NB * NB + NP + 1;  // + pairs, offsets
  static constexpr int TAB_FLOATS = ((TAB_LEN + 1) / 2 + 3) / 4 * 4;
  // rows of loc ([NLOC][C4]): 0 b1, 1 bL, 2 layer-norm a, then silu.a,
  // silu.b and d sigmoid(normalization.a), NG rows each
  static constexpr int L_B1 = 0, L_BL = 1, L_ALN = 2, L_SA = 3,
                       L_SB = 3 + NG, L_NS = 3 + 2 * NG;
};

// Cl(5,0): 32 blades in short-lex order, grade runs 1, 5, 10, 10, 5, 1.
struct Cl5 : PairAlgebra<32, 6, 56> {
  __host__ __device__ static constexpr int grade(int i) {
    return i == 0 ? 0 : i < 6 ? 1 : i < 16 ? 2 : i < 26 ? 3 : i < 31 ? 4 : 5;
  }
  // the first blade of grade g
  __host__ __device__ static constexpr int gstart(int g) {
    return g == 0 ? 0 : g == 1 ? 1 : g == 2 ? 6 : g == 3 ? 16 : g == 4 ? 26
         : g == 5 ? 31 : 32;
  }
  // short-lex index -> bitmap
  static int bitmap(int i) {
    static const int t[32] = {0, 1, 2, 4, 8, 16, 3, 5, 9, 17, 6, 10, 18, 12,
                              20, 24, 7, 11, 19, 13, 21, 25, 14, 22, 26, 28,
                              15, 23, 27, 29, 30, 31};
    return t[i];
  }
};

// Cl(4,0): 16 blades in short-lex order, grade runs 1, 4, 6, 4, 1.
struct Cl4 : PairAlgebra<16, 5, 35> {
  __host__ __device__ static constexpr int grade(int i) {
    return i == 0 ? 0 : i < 5 ? 1 : i < 11 ? 2 : i < 15 ? 3 : 4;
  }
  __host__ __device__ static constexpr int gstart(int g) {
    return g == 0 ? 0 : g == 1 ? 1 : g == 2 ? 5 : g == 3 ? 11 : g == 4 ? 15
         : 16;
  }
  static int bitmap(int i) {
    static const int t[16] = {0, 1, 2, 4, 8, 3, 5, 9, 6, 10, 12, 7, 11, 13,
                              14, 15};
    return t[i];
  }
};

// The packed tables keep one layout at every algebra: a blade or index
// field is 5 bits (FIELD), a sign bit above it, the path above that.
constexpr int FIELD = 31;

// ------------------------------------------------------------ host tables

int popcount(int v) {
  int n = 0;
  for (; v; v >>= 1) n += v & 1;
  return n;
}

template <class A>
int index_of_bitmap(int bm) {
  for (int i = 0; i < A::NB; ++i)
    if (A::bitmap(i) == bm) return i;
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
template <class A>
struct Pairs {
  int i_of[A::NB][A::NB], path[A::NB][A::NB], sign[A::NB][A::NB];
};

template <class A>
void make_pairs(Pairs<A>& t) {
  constexpr int NB = A::NB, NG = A::NG;
  int pid[NG][NG][NG];
  bool valid[NG][NG][NG] = {};
  for (int i = 0; i < NB; ++i)
    for (int k = 0; k < NB; ++k)
      valid[A::grade(i)][popcount(A::bitmap(i) ^ A::bitmap(k))]
           [A::grade(k)] = true;
  int n = 0;
  for (int a = 0; a < NG; ++a)
    for (int b = 0; b < NG; ++b)
      for (int c = 0; c < NG; ++c) pid[a][b][c] = valid[a][b][c] ? n++ : -1;
  for (int j = 0; j < NB; ++j)
    for (int k = 0; k < NB; ++k) {
      const int i = index_of_bitmap<A>(A::bitmap(j) ^ A::bitmap(k));
      t.i_of[j][k] = i;
      t.sign[j][k] = reorder_sign(A::bitmap(i), A::bitmap(k));
      t.path[j][k] = pid[A::grade(i)][A::grade(j)][A::grade(k)];
    }
}

uint16_t pack(int blade, int sign, int path) {
  return (uint16_t)(blade | (sign < 0 ? FIELD + 1 : 0) | (path << 6));
}

// Packed tables, uint16:
//   T1[k*NB + j] = (i, sign, path) of pair (j, k)   lane j, loop k
//   T2[k*NB + i] = (j, sign, path) of pair (j, k), j = i_of(i, k)
//                                                   lane i, loop k
//   T3[j*NB + k] = (i, sign, path) of pair (j, k)   lane k, loop j
//   LIST[q] = j | k << 5 | i << 10 | neg << 15, the pairs grouped by path
//   OFF[p] = first LIST entry of path p, OFF[NP] = NB * NB
template <class A>
int make_packed(uint16_t* out) {
  constexpr int NB = A::NB, NP = A::NP;
  Pairs<A> t;
  make_pairs(t);
  for (int j = 0; j < NB; ++j)
    for (int k = 0; k < NB; ++k) {
      const uint16_t e = pack(t.i_of[j][k], t.sign[j][k], t.path[j][k]);
      out[k * NB + j] = e;
      out[2 * NB * NB + j * NB + k] = e;
    }
  for (int i = 0; i < NB; ++i)
    for (int k = 0; k < NB; ++k) {
      const int j = index_of_bitmap<A>(A::bitmap(i) ^ A::bitmap(k));
      out[NB * NB + k * NB + i] = pack(j, t.sign[j][k], t.path[j][k]);
    }
  uint16_t* list = out + A::TAB_T;
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
  return q == NB * NB ? A::TAB_LEN : -1;
}

// The structure the kernels assume, for the host to check against the
// algebra: i_of, path ids and signs of the pairs [j * NB + k], grades.
template <class A>
void structural_tables(int* i_of_out, int* path_out, int* grade_out,
                       float* sign_out) {
  constexpr int NB = A::NB;
  Pairs<A> t;
  make_pairs(t);
  for (int j = 0; j < NB; ++j)
    for (int k = 0; k < NB; ++k) {
      i_of_out[j * NB + k] = t.i_of[j][k];
      path_out[j * NB + k] = t.path[j][k];
      sign_out[j * NB + k] = (float)t.sign[j][k];
    }
  for (int i = 0; i < NB; ++i)
    grade_out[i] = A::grade(i) == popcount(A::bitmap(i)) ? A::grade(i) : -1;
}

// ---------------------------------------------------------- device helpers

struct Params {
  const float *w1, *b1, *sa, *sb, *gw, *wr, *na, *wl, *bl, *aln;
};

template <class A>
struct Tabs {
  float bc[A::NB];       // quadratic-form coefficient per blade
};

template <bool FAST>
__device__ __forceinline__ float rnd(float x) {
  if (FAST) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// This thread's blade, its member of the warp (0 at Cl(5); the half-warp
// at Cl(4)) and the mask of its member's lanes.
template <class A>
__device__ __forceinline__ int blade_lane() {
  return A::MW == 1 ? (int)threadIdx.x : (int)threadIdx.x & (A::NB - 1);
}
template <class A>
__device__ __forceinline__ int half_of_warp() {
  return A::MW == 1 ? 0 : (int)threadIdx.x / A::NB;
}
template <class A>
__device__ __forceinline__ unsigned member_mask() {
  return A::MW == 1 ? 0xffffffffu : (0xffffu << (threadIdx.x & 16));
}

// Sum of v over the member's NB lanes, the same value on each of them.
template <class A>
__device__ __forceinline__ float blade_sum(float v) {
#pragma unroll
  for (int off = A::NB / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(member_mask<A>(), v, off);
  return v;
}

// v at blade k of this member's row.
template <class A>
__device__ __forceinline__ float from_blade(float v, int k) {
  return __shfl_sync(member_mask<A>(), v, k, A::NB);
}

// Sum of v over the lanes of this lane's grade [lo, hi), the same value
// on every lane of the grade.  sc is the member's NB-float scratch row.
template <class A>
__device__ __forceinline__ float grade_sum(float v, float* sc, int lane,
                                           int lo, int hi) {
  __syncwarp(member_mask<A>());
  sc[lane] = v;
  __syncwarp(member_mask<A>());
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

template <class A>
__host__ __device__ inline int params_floats(int cin, int c) {
  const int c4 = pad4(c), pm = A::NG * c4 + 4;
  return cin * pm + 2 * c * pm + c4 * (3 * A::NG + A::NP + 3);
}

template <class A>
__device__ inline void carve_params(float* base, int cin, int c, Smem& s) {
  s.c4 = pad4(c);
  s.pm1 = A::NG * s.c4 + 4;
  s.pm = s.pm1;
  s.w1 = base;
  s.wr = s.w1 + cin * s.pm1;
  s.wl = s.wr + c * s.pm;
  s.ra = s.wl + c * s.pm;
  s.sb = s.ra + A::NG * s.c4;
  s.nsig = s.sb + A::NG * s.c4;
  s.gw = s.nsig + A::NG * s.c4;
  s.b1 = s.gw + A::NP * s.c4;
  s.bl = s.b1 + s.c4;
  s.aln = s.bl + s.c4;
}

template <class A, bool FAST>
__device__ void stage_params(const Params& p, const Smem& s, int cin, int c,
                             int nthreads) {
  constexpr int NG = A::NG, NP = A::NP;
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


// This lane's blade: its grade's run [lo, hi) and quadratic coefficient.
struct Lane {
  int id, g, lo, hi;
  float bc;
};

template <class A>
__device__ __forceinline__ Lane make_lane(const Tabs<A>& tb) {
  Lane l;
  l.id = blade_lane<A>();
  l.g = A::grade(l.id);
  l.lo = A::gstart(l.g);
  l.hi = A::gstart(l.g + 1);
  l.bc = tb.bc[l.id];
  return l;
}

// A kernel's row tile: ROWS_F row slots of TEAM_F warps in the forward,
// ROWS_B of TEAM_B in the backward.
template <int ROWS_F_, int TEAM_F_, int ROWS_B_, int TEAM_B_>
struct RowTile {
  static constexpr int ROWS_F = ROWS_F_, TEAM_F = TEAM_F_;
  static constexpr int WARPS_F = ROWS_F * TEAM_F, THREADS_F = 32 * WARPS_F;
  static constexpr int ROWS_B = ROWS_B_, TEAM_B = TEAM_B_;
  static constexpr int WARPS_B = ROWS_B * TEAM_B, THREADS_B = 32 * WARPS_B;
};

// The members that share a row: member h of nh (nh / MW warps), their
// named barrier (for more than one warp), and the row's XCH exchange slots
// in shared memory.  Each member takes every nh-th group of four channels;
// sums over channels meet in the exchange slots and are added in member
// order, so every member of the row holds the same bits.
struct Team {
  int h, nh, bar;
  float* xch;
};

// The team of warp w's members at row slot r, for teams of `warps` warps.
template <class A>
__device__ __forceinline__ Team make_team(int w, int warps, float* xch) {
  const int r = w / warps;
  return Team{(w % warps) * A::MW + half_of_warp<A>(), warps * A::MW, 1 + r,
              xch + A::XCH * r};
}

template <class A>
__device__ __forceinline__ void team_sync(const Team& t) {
  if (t.nh == A::MW)
    __syncwarp();
  else if (A::MW == 1)
    asm volatile("bar.sync %0, %1;" ::"r"(t.bar), "r"(32 * t.nh) : "memory");
  else   // the halves of a warp may reach it apart
    asm volatile("barrier.sync %0, %1;" ::"r"(t.bar),
                 "r"(32 * t.nh / A::MW) : "memory");
}

// The team's sum of a member-uniform partial; slot 0 or 1.
template <class A>
__device__ __forceinline__ float team_sum(const Team& t, float v, int slot) {
  if (A::MW == 1 && t.nh == 1) return v;
  if (blade_lane<A>() == 0) t.xch[A::XCH / 2 * slot + t.h] = v;
  team_sync<A>(t);
  float sum = 0.f;
  for (int k = 0; k < t.nh; ++k) sum += t.xch[A::XCH / 2 * slot + k];
  return sum;
}

// The input linear for output channels n0..n0+3 at this lane's blade:
// acc[u] = sum_m xs[m] * W1[n0+u, m, g].
template <class A>
__device__ __forceinline__ void linear4(const float* rows, const float* w,
                                        int pitch, int nin, int g, int c4,
                                        int n0, int lane, float (&acc)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) acc[u] = 0.f;
  for (int m = 0; m < nin; ++m) {
    const float v = rows[m * A::RP + lane];
    const float4 ww = ld4(w + m * pitch + g * c4 + n0);
    acc[0] += v * ww.x;
    acc[1] += v * ww.y;
    acc[2] += v * ww.z;
    acc[3] += v * ww.w;
  }
}

// Input linear and MVSiLU of channel n from its linear output y (without
// bias): returns y with bias; sets inv (grade invariant) and sg (gate).
template <class A, bool FAST>
__device__ __forceinline__ float silu_in(const Smem& s, const Lane& l,
                                         float* sc, int n, float acc,
                                         float& inv, float& sg) {
  const float y = acc + (l.id == 0 ? s.b1[n] : 0.f);
  const float v = l.id == 0 ? rnd<FAST>(y) : rnd<FAST>(y * y * l.bc);
  inv = grade_sum<A>(v, sc, l.id, l.lo, l.hi);
  sg = sigmoid_f(s.ra[l.g * s.c4 + n] * inv + s.sb[l.g * s.c4 + n]);
  return y;
}

// Grade-norm normalisation of channel n's right operand yr.
struct Norm {
  float qg, s1g, nr, den, yn;
};

template <class A, bool FAST>
__device__ __forceinline__ Norm normalise(const Smem& s, const Lane& l,
                                          float* sc, int n, float yr) {
  Norm q;
  q.qg = grade_sum<A>(rnd<FAST>(yr * yr * l.bc), sc, l.id, l.lo, l.hi);
  q.s1g = sqrtf(q.qg * q.qg + 1e-16f);
  q.nr = sqrtf(q.s1g);
  q.den = s.nsig[l.g * s.c4 + n] * (q.nr - 1.f) + 1.f + EPS;
  q.yn = yr / q.den;
  return q;
}

// Forward of one block for the row of this team.  xs: the row's [m][RP]
// input (rounded in fast mode); writes the rounded z to zs, the rounded
// normalised right operand to ys (if not null) and the pre-norm output o
// to os, all [n][RP], each member its own channels.  Returns the layer
// norm's divisor m.  Every lane of the team must call it.
template <class A, bool FAST>
__device__ float row_forward(const Smem& s, const Lane& l, const Team& tm,
                             const uint16_t* t1, const float* xs, float* zs,
                             float* ys, float* os, float* sc, int cin,
                             int c) {
  constexpr int NB = A::NB, RP = A::RP;
  const int lane = l.id, step = 4 * tm.nh;
  // ---- MVLinear + MVSiLU
  for (int n0 = 4 * tm.h; n0 < c; n0 += step) {
    float acc[4];
    linear4<A>(xs, s.w1, s.pm1, cin, l.g, s.c4, n0, lane, acc);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int n = n0 + u;
      if (n < c) {
        float inv, sg;
        const float y = silu_in<A, FAST>(s, l, sc, n, acc[u], inv, sg);
        zs[n * RP + lane] = rnd<FAST>(sg * y);
      }
    }
  }
  team_sync<A>(tm);
  // ---- SGP: right and left linears, normalisation, pair product; four
  // channels at a time, so the product loop runs four independent chains
  float msum = 0.f;
  for (int n0 = 4 * tm.h; n0 < c; n0 += step) {
    float ar[4], al[4], ynr[4], gp[4];
    linear4<A>(zs, s.wr, s.pm, c, l.g, s.c4, n0, lane, ar);
    linear4<A>(zs, s.wl, s.pm, c, l.g, s.c4, n0, lane, al);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ynr[u] = 0.f;
      gp[u] = 0.f;
      if (n0 + u < c) {
        ynr[u] = rnd<FAST>(normalise<A, FAST>(s, l, sc, n0 + u, ar[u]).yn);
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
      const int i = t & FIELD, q = (t >> 6) * s.c4;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float yk = from_blade<A>(ynr[u], k);
        const float pr = rnd<FAST>((zrow[u * RP + i] * yk) * gwn[q + u]);
        gp[u] += (t & (FIELD + 1)) ? -pr : pr;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int n = n0 + u;
      if (n >= c) continue;
      const float first = al[u] + (lane == 0 ? s.bl[n] : 0.f);
      const float o = (first + gp[u]) * SQRT2_INV;
      os[n * RP + lane] = o;
      const float qc = blade_sum<A>(rnd<FAST>(o * o * l.bc));
      msum += sqrtf(sqrtf(qc * qc + 1e-16f));
    }
  }
  return team_sum<A>(tm, msum, 0) / (float)c + EPS;
}


// Row buffers of the backward, each [n][RP], in this order after xs; the
// channel buffers have C4 = pad4(C) rows, so the four-channel loops stay
// inside them.
struct Rows {
  float *xs, *zs, *ys, *fs, *dz, *dr;   // x, z, yn (rounded), d(first)
};                                       // (was o), d(z) then d(y), d(yr)

template <class A>
__host__ __device__ inline int row_floats(int cin, int c) {
  return (cin + 5 * pad4(c)) * A::RP;
}

template <class A>
__device__ __forceinline__ Rows carve_rows(float* base, int cin, int c) {
  const int c4 = pad4(c);
  Rows b;
  b.xs = base;
  b.zs = b.xs + cin * A::RP;
  b.ys = b.zs + c4 * A::RP;
  b.fs = b.ys + c4 * A::RP;
  b.dz = b.fs + c4 * A::RP;
  b.dr = b.dz + c4 * A::RP;
  return b;
}

// Backward of one block for the row of this team, from the row's input
// (b.xs, loaded) and output cotangent go ((C, NB) in global memory).
// Writes dx for the row, leaves the rounded z, yn, d(first), d(y), d(yr)
// of the row in b for the CTA's weight-gradient passes, and adds the
// per-channel gradients of its member's channels into loc.  Every lane of
// the team must call it.
template <class A, bool FAST>
__device__ void row_backward(const Smem& s, const Lane& l, const Team& tm,
                             const uint16_t* t1, const uint16_t* t2,
                             const uint16_t* t3, const Rows& b, float* sc,
                             float* loc, const float* __restrict__ go,
                             float* __restrict__ dxr, int cin, int c) {
  constexpr int NB = A::NB, RP = A::RP;
  const int lane = l.id, c4 = s.c4, step = 4 * tm.nh;
  const float mden = row_forward<A, FAST>(s, l, tm, t1, b.xs, b.zs, b.ys,
                                          b.fs, sc, cin, c);
  // ---- MVLayerNorm backward: out = aln * o / m (this member's channels)
  float t = 0.f;
  for (int n0 = 4 * tm.h; n0 < c; n0 += step)
    for (int n = n0; n < n0 + 4 && n < c; ++n) {
      const float g = go[n * NB + lane], o = b.fs[n * RP + lane];
      t += g * s.aln[n] * o;
      const float ta = blade_sum<A>(g * o);
      if (lane == 0) loc[A::L_ALN * c4 + n] += ta / mden;
    }
  const float dm = -team_sum<A>(tm, blade_sum<A>(t), 1) / (mden * mden);
  for (int n0 = 4 * tm.h; n0 < c; n0 += step)
    for (int n = n0; n < n0 + 4 && n < c; ++n) {
      const float g = go[n * NB + lane], o = b.fs[n * RP + lane];
      const float qc = blade_sum<A>(rnd<FAST>(o * o * l.bc));
      const float s1c = sqrtf(qc * qc + 1e-16f);
      const float nc = sqrtf(s1c);
      const float dqc = rnd<FAST>(dm / (float)c * 0.5f * qc / (s1c * nc));
      const float dfg =
          (s.aln[n] * g / mden + dqc * 2.f * l.bc * o) * SQRT2_INV;
      b.fs[n * RP + lane] = rnd<FAST>(dfg);
      if (lane == 0) loc[A::L_BL * c4 + n] += dfg;
    }
  __syncwarp(member_mask<A>());
  // ---- pair-product and normalisation backward, four channels at a time
  // (four independent chains per loop; channels past c read padded rows
  // and zero weights, and their results are dropped)
  for (int n0 = 4 * tm.h; n0 < c; n0 += step) {
    float yr[4], ynr[4], dfr[4], dzg[4], dyn[4];
    Norm q[4];
    linear4<A>(b.zs, s.wr, s.pm, c, l.g, c4, n0, lane, yr);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (n0 + u < c) q[u] = normalise<A, FAST>(s, l, sc, n0 + u, yr[u]);
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
      const int j = e & FIELD, p = (e >> 6) * c4;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float yk = from_blade<A>(ynr[u], k);
        const float d = (e & (FIELD + 1)) ? -drow[u * RP + j]
                                          : drow[u * RP + j];
        dzg[u] += rnd<FAST>((d * yk) * gwn[p + u]);
      }
    }
#pragma unroll 4
    for (int j = 0; j < NB; ++j) {       // lane = right blade k
      const int e = t3[j * NB + lane];
      const int i = e & FIELD, p = (e >> 6) * c4;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float dj = from_blade<A>(dfr[u], j);
        const float d = (e & (FIELD + 1)) ? -dj : dj;
        dyn[u] += rnd<FAST>((d * zrow[u * RP + i]) * gwn[p + u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int n = n0 + u;
      if (n >= c) continue;
      // yn = yr / den
      const float dden = grade_sum<A>(-dyn[u] * q[u].yn / q[u].den, sc,
                                      lane, l.lo, l.hi);
      if (lane == l.lo)
        loc[(A::L_NS + l.g) * c4 + n] += dden * (q[u].nr - 1.f);
      const float dnr = dden * s.nsig[l.g * c4 + n];
      const float dqg = rnd<FAST>(dnr * 0.5f * q[u].qg / (q[u].s1g * q[u].nr));
      const float dyr = dyn[u] / q[u].den + dqg * 2.f * l.bc * yr[u];
      b.dr[n * RP + lane] = rnd<FAST>(dyr);
      b.dz[n * RP + lane] = dzg[u];
    }
  }
  team_sync<A>(tm);   // every channel's d(first) and d(yr) are in place
  // ---- transposed right/left linears, then MVSiLU backward, four
  // channels m at a time (their input linear recomputed as in the forward)
  for (int m0 = 4 * tm.h; m0 < c; m0 += step) {
    float ylin[4];
    linear4<A>(b.xs, s.w1, s.pm1, cin, l.g, c4, m0, lane, ylin);
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
      const float y = silu_in<A, FAST>(s, l, sc, m, ylin[u], inv, sg);
      const float dgate = dz * y * sg * (1.f - sg);
      const float dgs = grade_sum<A>(dgate, sc, lane, l.lo, l.hi);
      const float dgr = grade_sum<A>(rnd<FAST>(dgate), sc, lane, l.lo, l.hi);
      if (lane == l.lo) {
        loc[(A::L_SB + l.g) * c4 + m] += dgs;
        loc[(A::L_SA + l.g) * c4 + m] += inv * dgr;
      }
      const float dv = s.ra[l.g * c4 + m] * dgr;
      const float dy = dz * sg + (lane == 0 ? dv : 2.f * l.bc * y * dv);
      if (lane == 0) loc[A::L_B1 * c4 + m] += dy;
      b.dz[m * RP + lane] = rnd<FAST>(dy);
    }
  }
  team_sync<A>(tm);   // every channel's d(y) is in place
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
// into aw ([(m * NG + g) * C4 + n], the CTA's slice of global scratch):
// which = 0 for W1 (x with d(y)), 1 for Wr (z with d(yr)), 2 for WL (z with
// d(first)).  A thread owns one input channel m and four output channels,
// all grades; the same thread owns the same entries on every call.
// NTHREADS is the CTA's thread count.
template <class A, int NTHREADS>
__device__ void mix_grads(const float* rowbuf, int rstride, int nrow, int cin,
                          int c, int c4, int which, float* aw) {
  constexpr int NB = A::NB, NG = A::NG, RP = A::RP;
  const int tid = threadIdx.x + 32 * threadIdx.y;
  const int nq = c4 / 4, nin = which == 0 ? cin : c;
  for (int p = tid; p < nin * nq; p += NTHREADS) {
    const int m = p / nq, n0 = (p % nq) * 4;
    float acc[4][NG] = {};
    for (int r = 0; r < nrow; ++r) {
      const Rows b = carve_rows<A>(const_cast<float*>(rowbuf) + r * rstride,
                                   cin, c);
      const float* in = (which == 0 ? b.xs : b.zs) + m * RP;
      const float* d = (which == 0 ? b.dz : which == 1 ? b.dr : b.fs) + n0 * RP;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const float v = in[i];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (n0 + u < c) acc[u][A::grade(i)] += v * d[u * RP + i];
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
template <class A, int NTHREADS>
__device__ void path_grads(const float* rowbuf, int rstride, int nrow,
                           int cin, int c, int c4, const uint16_t* list,
                           const uint16_t* off, float* gacc) {
  constexpr int RP = A::RP;
  const int tid = threadIdx.x + 32 * threadIdx.y;
  for (int e = tid; e < A::NP * c; e += NTHREADS) {
    const int q = e / c, n = e % c;
    float acc = 0.f;
    for (int r = 0; r < nrow; ++r) {
      const Rows b = carve_rows<A>(const_cast<float*>(rowbuf) + r * rstride,
                                   cin, c);
      const float* zr = b.zs + n * RP;
      const float* yr = b.ys + n * RP;
      const float* df = b.fs + n * RP;
      for (int t = off[q]; t < off[q + 1]; ++t) {
        const int L = list[t];
        const float d = (L >> 15) ? -df[L & FIELD] : df[L & FIELD];
        acc += (zr[(L >> 10) & FIELD] * yr[(L >> 5) & FIELD]) * d;
      }
    }
    gacc[q * c4 + n] += acc;
  }
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

template <class A>
Tabs<A> make_tabs(const float* bc) {
  Tabs<A> tb;
  for (int i = 0; i < A::NB; ++i) tb.bc[i] = bc[i];
  return tb;
}

}  // namespace
