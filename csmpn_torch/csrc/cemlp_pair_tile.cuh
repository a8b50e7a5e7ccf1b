// K3p in fast mode: the pair-form CEMLP block backward in row tiles, with
// the channel-mixing linears on the tensor cores.  cemlp_pair_kernels.cuh
// launches it for a fast-mode backward at Cl(5,0) and Cl(4,0); exact mode
// keeps that file's row kernel (fp32 throughout).  Its step is the device
// function pair_tile_block_backward, whose hooks load the x tile, give each
// row's output cotangent and take dx; the fast K5p's backward sweeps
// (fused_egcl_pair_tile.cuh) run the same step with hooks of their own.
//
// Replaces (with the row kernel): csmpn_tpu/ops/cemlp_kernel.py,
// `_bwd_kernel` in its pair form (`_post_linear_bwd` over `_gp_pair_fwd`):
// dx and the 10 parameter gradients of one block.
//
// Bound on this card: at the hulls widths (C = 28, Cin 34, Cl(5)) a row
// reads x and d(out) and writes dx, ~12 KB: the byte bound is 48 us at
// 13,184 rows.  The kernel is far from it: the pair product and its two
// backward products (3 x 1,024 pairs a channel and row, each a gathered
// operand, a shared one and a gathered path weight) run on the shared
// memory and issue pipes; the linears and their weight gradients on the
// tensor cores are a small share (PERF.md, section 6).
//
// A CTA step takes R = 128 / NB rows (4 at Cl(5), 8 at Cl(4)): 128
// (row, blade) pairs, with 12 warps at Cl(5) (three a row) and 8 at Cl(4)
// (one a row).  The step's tiles are indexed by tile row r * (NB + 1) + i
// for blade i of row r; the row after each row's blades stays zero (row NB
// is the zero row of null entries) and spreads the rows' tile rows over
// the banks.  Phases, each behind a barrier:
//   x    the step's rows of x, rounded to bf16, into the x tile;
//   F1   Y = X W1 on the tensor cores -> fp32 tile fa;
//   S1   MVSiLU, a thread per (row, channel) over its NB blades -> z (bf16);
//   F2   YR = z Wr -> fb, FI = z WL -> fa (fp32);
//   row  a team of members per row (a member is a warp at Cl(5), a
//        half-warp at Cl(4)), a lane per blade, as the row kernel: the
//        right operand's normalisation, the pair product, the layer norm
//        and their backward -> yn, d(first), d(yr) (bf16) and the
//        product's d(z) over fb (pair_row_phase says how);
//   B2   the path-weight gradients (a thread per (path, two channels)),
//        and on the tensor cores Y again and d(z) += d(first) WL^T +
//        d(yr) Wr^T;
//   S2   MVSiLU's backward, a thread per (row, channel) -> d(y) (bf16);
//   B3   the channel-mixing weight gradients X^T d(y), z^T d(yr), z^T
//        d(first) into accumulators each warp keeps in registers for all
//        of the CTA's steps (fixed (grade, m16, n8) tiles; MAXT of them a
//        warp, an instance each at 16, 24 and 32), and B4 dx = d(y) W1^T
//        written straight to global memory.
// Every product is bf16 `mma.sync.m16n8k16` with fp32 accumulators.  The
// M side of a product runs over (row, blade) pairs of one grade (the
// grade's weight), 16 at a time, listed row by row (so a tile of grade
// runs 1 and 5 is padded with null entries that read the zero row); the
// ldmatrix row addresses come from that list.  Every operand is a value
// the row kernel rounds to bf16 at the same point (x, z, the weights, the
// three cotangents), so the products are exact and only the order of the
// fp32 sums differs from the row kernel and the plain version.
//
// Shared memory: the three linears' weights as bf16 [g * C + n][m] with a
// zero row for the padded channels (rows n >= C read it), the per-channel
// parameters fp32, the packed pair tables, the tiles, and the per-channel
// gradient sums: ~170 KB at the hulls widths, one CTA an SM.  At every
// width the row kernel takes, this kernel fits too (chip_smoke.py checks).
//
// Determinism: every gradient sum has one owner: the weight gradients a
// (warp, lane, fragment position), the path weights a thread, the row
// phase's per-channel sums the row's member that owns the channel, the
// MVSiLU ones the thread of the (row, channel).  The CTA's partial vector
// is reduced over its rows in a fixed order, and a second kernel adds the
// CTAs' vectors in CTA order: no atomics, bitwise repeatable.
#pragma once

#include "cemlp_pair.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int PT_PAIRS = 128;   // (row, blade) pairs a step holds
constexpr int PT_GROUP = 4;     // channels a row member takes side by side

// Gradient vector layout (flax parameter order and shapes):
//   dW1 (C, Cin, NG) | db1 (C) | dsilu_a (C, NG) | dsilu_b (C, NG) |
//   dgp_weight (C, NP) | dWr (C, C, NG) | dsigmoid(norm_a) (C, NG) |
//   dWL (C, C, NG) | dbL (C) | dln_a (C)
template <class A>
__host__ __device__ inline int64_t grad_floats(int cin, int c) {
  constexpr int NG = A::NG;
  return (int64_t)c * cin * NG + c + 2 * NG * c + A::NP * c + c * c * NG +
         NG * c + c * c * NG + 2 * c;
}

__host__ __device__ inline int pt_up16(int x) { return (x + 15) / 16 * 16; }
__host__ __device__ inline size_t pt_al16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

// A step of R rows on WARPS warps: by default the backward's.
template <class A, int R_ = PT_PAIRS / A::NB, int WARPS_ = A::NB == 32 ? 12
                                                                      : 8>
struct PTile {
  static constexpr int NB = A::NB, NG = A::NG;
  static constexpr int R = R_;                    // rows a step
  // the backward's warps: three row members a row at Cl(5), as many as the
  // registers allow (the weight-gradient tiles take fewer a warp with more
  // warps)
  static constexpr int WARPS = WARPS_, THREADS = 32 * WARPS;
  static constexpr int MR = R * (NB + 1);         // tile rows
  static constexpr int ZROW = NB;                 // a zero tile row
  static constexpr int WPR = WARPS / R;           // warps a row (row phase)
  static constexpr int NLOC = NG + 2;             // row phase sums a channel
  static constexpr int NSIL = 1 + 2 * NG;         // MVSiLU sums a channel
  __host__ __device__ static int count(int g) {
    return A::gstart(g + 1) - A::gstart(g);
  }
  // m16 tiles of grade g's (row, blade) pairs
  __host__ __device__ static int gtiles(int g) {
    return (R * count(g) + 15) / 16;
  }
  // the longest grade run (10 blades at Cl(5), 6 at Cl(4)), and the most
  // m16 tiles a grade takes
  static constexpr int MAXRUN = NB == 32 ? 10 : 6;
  static constexpr int GTMAX = (R * MAXRUN + 15) / 16;
  __host__ __device__ static int mtiles() {
    int n = 0;
    for (int g = 0; g < NG; ++g) n += gtiles(g);
    return n;
  }
};

// A launch's geometry and the byte offsets of its shared regions, for the
// step P.  The forward (cemlp_pair_fwd_tile.cuh, K2p; fwd = true) takes
// the weights, parameters, row lists, x, z, fa and fb, and no others.  The
// bf16 tiles' and weights' rows are padded by xpad columns (8: their
// ldmatrix rows fall in different banks).
struct PLayout {
  int cin, c, c2, kin, kc, nt, ntm, ldx, ldc, fp, mt;
  size_t w1, wr, wl, prm, tab, ml, x, z, df, dr, yd, fa, fb, loc, gacc,
      sacc, sc, ps, xch, wd, total;
};

template <class A, class P = PTile<A>>
__host__ __device__ inline PLayout pair_tile_layout(int cin, int c,
                                                    bool fwd = false,
                                                    int xpad = 8) {
  constexpr int NG = A::NG, NP = A::NP;
  PLayout L;
  L.cin = cin;
  L.c = c;
  L.c2 = (c + 1) / 2;
  L.kin = pt_up16(cin);
  L.kc = pt_up16(c);
  L.nt = (c + 7) / 8;
  L.ntm = (cin + 7) / 8;
  L.ldx = L.kin + xpad;
  L.ldc = L.kc + xpad;
  L.fp = c | 1;
  L.mt = P::mtiles();
  size_t o = 0;
  auto take = [&](size_t bytes) {
    const size_t at = o;
    o += pt_al16(bytes);
    return at;
  };
  const size_t b = fwd ? 0 : 1;   // the backward's regions
  L.w1 = take(2 * (size_t)(NG * c + 1) * L.ldx);
  L.wr = take(2 * (size_t)(NG * c + 1) * L.ldc);
  L.wl = take(2 * (size_t)(NG * c + 1) * L.ldc);
  L.prm = take(4 * ((size_t)c * (3 * NG + 3) + (size_t)NP * L.fp));
  L.tab = take(b * 2 * A::TAB_LEN);
  L.ml = take(2 * (size_t)L.mt * 17 + 2 * (NG + 1));
  L.x = take(2 * (size_t)P::MR * L.ldx);
  L.z = take(2 * (size_t)P::MR * L.ldc);
  L.df = take(b * 2 * P::MR * L.ldc);
  L.dr = take(b * 2 * P::MR * L.ldc);
  L.yd = take(b * 2 * P::MR * L.ldc);
  L.fa = take(4 * ((size_t)P::MR * L.fp + 8));
  L.fb = take(4 * ((size_t)P::MR * L.fp + 8));
  L.loc = take(b * 4 * P::R * P::NLOC * c);
  L.gacc = take(b * 4 * NP * c);
  L.sacc = take(b * 4 * P::NSIL * P::R * c);
  L.sc = take(b * 4 * P::WARPS * 32 * PT_GROUP);
  L.ps = take(b * 4 * P::WARPS * 4 * 32);
  L.xch = take(b * 4 * P::R * A::XCH);
  L.wd = take(b * 4 * P::WARPS * 32);
  L.total = o;
  return L;
}

// Weight-gradient tiles (grade, m16, n8) of dW1, dWr and dWL, in that
// order; warp w owns tiles w, w + 8, ...
template <class A>
__host__ __device__ inline int pair_wgrad_tiles(const PLayout& L) {
  return A::NG * L.nt * (L.kin / 16 + 2 * (L.kc / 16));
}

// The register tiles a warp needs, rounded up to an instance (16, 24 or
// 32); 0 if more.
template <class A, class P = PTile<A>>
__host__ __device__ inline int pair_tile_maxt(int cin, int c) {
  const PLayout L = pair_tile_layout<A, P>(cin, c);
  constexpr int W = P::WARPS;
  const int per = (pair_wgrad_tiles<A>(L) + W - 1) / W;
  return per <= 16 ? 16 : per <= 24 ? 24 : per <= 32 ? 32 : 0;
}

// Weight-gradient tile q packed as which (0 dW1, 1 dWr, 2 dWL) | grade << 2
// | m16 tile << 5 | n8 tile << 15, or -1 past the last tile.
template <class A>
__host__ __device__ inline int pack_wtile(const PLayout& L, int q) {
  const int wt1 = A::NG * L.nt * (L.kin / 16), wtc = A::NG * L.nt * (L.kc / 16);
  if (q >= wt1 + 2 * wtc) return -1;
  int which, mtl, rem;
  if (q < wt1) { which = 0; mtl = L.kin / 16; rem = q; }
  else if (q < wt1 + wtc) { which = 1; mtl = L.kc / 16; rem = q - wt1; }
  else { which = 2; mtl = L.kc / 16; rem = q - wt1 - wtc; }
  return which | (rem / (mtl * L.nt)) << 2 | ((rem / L.nt) % mtl) << 5 |
         (rem % L.nt) << 15;
}

// Shared-memory bytes of a launch; 0 where the widths do not fit.
template <class A>
size_t pair_tile_smem_bytes(int cin, int c) {
  if (cin < 1 || c < 1 || pair_tile_maxt<A>(cin, c) == 0) return 0;
  const size_t n = pair_tile_layout<A>(cin, c).total;
  return n > kMaxSmem ? 0 : n;
}

// The step's shared regions.
template <class A>
struct PBufs {
  bf16 *w1, *wr, *wl, *x, *z, *df, *dr, *yd;
  float *ra, *sb, *nsig, *gw, *b1, *bl, *aln;
  float *fa, *fb, *loc, *gacc, *sacc, *sc, *xch;
  uint32_t* ps;   // the row members' scratch rows of bf16 pairs
  int* wd;        // the weight-gradient tiles of each warp, packed
  const uint16_t *t1, *t2, *t3, *list, *off;
  short *mrow, *mtg, *tfirst;   // tile rows of the M tiles, their grades,
                                // each grade's first tile
};

template <class A>
__device__ inline PBufs<A> carve_pbufs(char* base, const PLayout& L) {
  constexpr int NG = A::NG, NP = A::NP, NB = A::NB;
  const int c = L.c;
  PBufs<A> b;
  b.w1 = reinterpret_cast<bf16*>(base + L.w1);
  b.wr = reinterpret_cast<bf16*>(base + L.wr);
  b.wl = reinterpret_cast<bf16*>(base + L.wl);
  float* p = reinterpret_cast<float*>(base + L.prm);
  b.ra = p;
  b.sb = p + NG * c;
  b.nsig = p + 2 * NG * c;
  b.gw = p + 3 * NG * c;      // [path][fp]: an odd pitch, so that lanes
  b.b1 = b.gw + NP * L.fp;    // of different paths read different banks
  b.bl = b.b1 + c;
  b.aln = b.bl + c;
  const uint16_t* tab = reinterpret_cast<const uint16_t*>(base + L.tab);
  b.t1 = tab;
  b.t2 = tab + NB * NB;
  b.t3 = tab + 2 * NB * NB;
  b.list = tab + A::TAB_T;
  b.off = b.list + NB * NB;
  b.mrow = reinterpret_cast<short*>(base + L.ml);
  b.mtg = b.mrow + 16 * L.mt;
  b.tfirst = b.mtg + L.mt;
  b.x = reinterpret_cast<bf16*>(base + L.x);
  b.z = reinterpret_cast<bf16*>(base + L.z);
  b.df = reinterpret_cast<bf16*>(base + L.df);
  b.dr = reinterpret_cast<bf16*>(base + L.dr);
  b.yd = reinterpret_cast<bf16*>(base + L.yd);
  b.fa = reinterpret_cast<float*>(base + L.fa);
  b.fb = reinterpret_cast<float*>(base + L.fb);
  b.loc = reinterpret_cast<float*>(base + L.loc);
  b.gacc = reinterpret_cast<float*>(base + L.gacc);
  b.sacc = reinterpret_cast<float*>(base + L.sacc);
  b.sc = reinterpret_cast<float*>(base + L.sc);
  b.ps = reinterpret_cast<uint32_t*>(base + L.ps);
  b.wd = reinterpret_cast<int*>(base + L.wd);
  b.xch = reinterpret_cast<float*>(base + L.xch);
  return b;
}

// Zeroes all of shared memory, then stages the parameters (the linears'
// weights rounded to bf16, silu.a rounded, sigmoid(normalization.a), the
// path weights fp32), the M tiles' row lists and, for the backward
// (!FWD), the packed tables and the weight-gradient tiles.
template <class A, bool FWD = false, class P = PTile<A>>
__device__ void stage_pair_tile(const Params& p, const uint16_t* tabs,
                                const PBufs<A>& b, const PLayout& L,
                                char* base) {
  constexpr int NG = A::NG, NP = A::NP, NB = A::NB;
  const int tid = threadIdx.x + 32 * threadIdx.y;
  const int c = L.c, cin = L.cin;
  uint4* z4 = reinterpret_cast<uint4*>(base);
  for (size_t e = tid; e < L.total / 16; e += P::THREADS)
    z4[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  for (int e = tid; e < c * cin * NG; e += P::THREADS) {   // (n, m, g)
    const int g = e % NG, m = (e / NG) % cin, n = e / (NG * cin);
    b.w1[(g * c + n) * L.ldx + m] = __float2bfloat16_rn(p.w1[e]);
  }
  for (int e = tid; e < c * c * NG; e += P::THREADS) {
    const int g = e % NG, m = (e / NG) % c, n = e / (NG * c);
    b.wr[(g * c + n) * L.ldc + m] = __float2bfloat16_rn(p.wr[e]);
    b.wl[(g * c + n) * L.ldc + m] = __float2bfloat16_rn(p.wl[e]);
  }
  for (int e = tid; e < c * NG; e += P::THREADS) {          // (n, g)
    const int g = e % NG, n = e / NG;
    b.ra[g * c + n] = rnd<true>(p.sa[e]);
    b.sb[g * c + n] = p.sb[e];
    b.nsig[g * c + n] = sigmoid_f(p.na[e]);
  }
  for (int e = tid; e < c * NP; e += P::THREADS) {          // (n, path)
    const int q = e % NP, n = e / NP;
    b.gw[q * L.fp + n] = p.gw[e];
  }
  for (int e = tid; e < c; e += P::THREADS) {
    b.b1[e] = p.b1[e];
    b.bl[e] = p.bl[e];
    b.aln[e] = p.aln[e];
  }
  if (!FWD) {
    uint16_t* tab = const_cast<uint16_t*>(b.t1);
    for (int e = tid; e < A::TAB_LEN; e += P::THREADS) tab[e] = tabs[e];
  }
  // M tile t of grade g holds the grade's (row, blade) pairs 16 (t - first)
  // ... + 15, row by row; past the last pair, the zero row
  for (int q = tid; q < 16 * L.mt; q += P::THREADS) {
    const int t = q / 16;
    int g = 0, first = 0;
    while (t >= first + P::gtiles(g)) first += P::gtiles(g++);
    const int e = (t - first) * 16 + q % 16, cnt = P::count(g);
    b.mrow[q] = (short)(e < P::R * cnt
                            ? (e / cnt) * (NB + 1) + A::gstart(g) + e % cnt
                            : P::ZROW);
    if (q % 16 == 0) b.mtg[t] = (short)g;
  }
  // after the row lists, as before the forward shared this function: with
  // these first, ptxas allocated K3p's registers at Cl(5) otherwise,
  // spilled ~4% more and ran 6% slower (PERF.md)
  if (!FWD)
    for (int e = tid; e < P::WARPS * 32; e += P::THREADS)   // [warp][j]
      b.wd[e] = pack_wtile<A>(L, e / 32 + P::WARPS * (e % 32));
  if (tid == 0) {
    int first = 0;
    for (int g = 0; g < NG; ++g) {
      b.tfirst[g] = (short)first;
      first += P::gtiles(g);
    }
    b.tfirst[NG] = (short)first;
  }
  __syncthreads();
}

__device__ __forceinline__ int pfrag_row(int lane, int q) {
  return (lane >> 2) + 8 * (q >> 1);
}
__device__ __forceinline__ int pfrag_col(int lane, int q) {
  return 2 * (lane & 3) + (q & 1);
}
// Two bf16 values from 4 bytes of shared memory (4-byte aligned).
__device__ __forceinline__ float2 bf2(const bf16* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// acc += A W_g over one m16 tile of (row, blade) pairs and output columns
// n0..n0+7: A bf16 [tile row][lda] (depth `depth`, list-addressed), W bf16
// [g * c + n][k] (pitch ldw; rows n >= c read its zero row).
__device__ __forceinline__ void p_linear(float (&acc)[4], const bf16* a,
                                         int lda, int depth, const bf16* w,
                                         int ldw, int g, int c, int zrow_w,
                                         const short* mrow, int n0,
                                         int lane) {
  const bf16* arow = a + (size_t)mrow[lane & 15] * lda + (lane >> 4) * 8;
  const int n = n0 + (lane & 7);
  const bf16* brow = w + (size_t)(n < c ? g * c + n : zrow_w) * ldw +
                     ((lane >> 3) & 1) * 8;
  for (int ks = 0; ks < depth; ks += 16) {
    uint32_t af[4], bfr[2];
    ldsm4(af, arow + ks);
    ldsm2(bfr, brow + ks);
    mma_bf16_s(acc, af, bfr);
  }
}

// acc += D W_g^T over one m16 tile and columns m0..m0+7 of W's input side:
// D bf16 [tile row][ldd] over the depth kc (W's output channels), W bf16
// [g * c + n][m] (pitch ldw; rows n >= c read its zero row).
__device__ __forceinline__ void p_linear_t(float (&acc)[4], const bf16* d,
                                           int ldd, int kc, const bf16* w,
                                           int ldw, int g, int c, int zrow_w,
                                           const short* mrow, int m0,
                                           int lane) {
  const bf16* drow = d + (size_t)mrow[lane & 15] * ldd + (lane >> 4) * 8;
  for (int ks = 0; ks < kc; ks += 16) {
    const int n = ks + (lane & 15);
    uint32_t af[4], bfr[2];
    ldsm4(af, drow + ks);
    ldsm2_t(bfr, w + (size_t)(n < c ? g * c + n : zrow_w) * ldw + m0);
    mma_bf16_s(acc, af, bfr);
  }
}

// Stores an m16 x n8 fragment of fp32 into tile f ([tile row][fp]) at its
// list rows, for columns < c.
__device__ __forceinline__ void p_store(const float (&acc)[4], float* f,
                                        int fp, int c, const short* mrow,
                                        int n0, int zrow, int lane) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = mrow[pfrag_row(lane, q)], n = n0 + pfrag_col(lane, q);
    if (row != zrow && n < c) f[row * fp + n] = acc[q];
  }
}

// Sums of four values a lane over the lanes of its grade (the same value
// on every lane of the grade), the four side by side: the member's scratch
// sc holds a float4 a blade, each lane adding its grade's run in blade
// order (lanes of one grade read the same address).
template <class A>
__device__ __forceinline__ void grade_sums(float (&v)[4], float* sc,
                                           const Lane& l) {
  constexpr int RUN = PTile<A>::MAXRUN;
  float4* s4 = reinterpret_cast<float4*>(sc);
  __syncwarp(member_mask<A>());
  s4[l.id] = make_float4(v[0], v[1], v[2], v[3]);
  __syncwarp(member_mask<A>());
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = 0.f;
#pragma unroll
  for (int t = 0; t < RUN; ++t)
    if (l.lo + t < l.hi) {
      const float4 w = s4[l.lo + t];
      v[0] += w.x;
      v[1] += w.y;
      v[2] += w.z;
      v[3] += w.w;
    }
}

// Sums of four values a lane over the member's NB lanes, side by side.
template <class A>
__device__ __forceinline__ void blade_sums(float (&v)[4]) {
#pragma unroll
  for (int off = A::NB / 2; off > 0; off >>= 1)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] += __shfl_xor_sync(member_mask<A>(), v[u], off);
}

// The right operand's grade-norm normalisation of four channels n[u] (yr
// at this lane's blade), as cemlp_pair.cuh's normalise.
template <class A>
__device__ __forceinline__ void normalise4(const PBufs<A>& b, const Lane& l,
                                           float* sc, const int (&n)[4],
                                           int c, const float (&yr)[4],
                                           Norm (&q)[4]) {
  float v[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = rnd<true>(yr[u] * yr[u] * l.bc);
  grade_sums<A>(v, sc, l);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    q[u].qg = v[u];
    q[u].s1g = sqrtf(q[u].qg * q[u].qg + 1e-16f);
    q[u].nr = sqrtf(q[u].s1g);
    q[u].den = b.nsig[l.g * c + n[u]] * (q[u].nr - 1.f) + 1.f + EPS;
    q[u].yn = yr[u] / q[u].den;
  }
}

// The four values rounded to bf16 (two conversions of a pair each).
__device__ __forceinline__ void rnd4(float (&v)[4]) {
#pragma unroll
  for (int u = 0; u < 4; u += 2) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[u], v[u + 1]);
    const uint32_t w = *reinterpret_cast<const uint32_t*>(&h);
    v[u] = __uint_as_float(w << 16);
    v[u + 1] = __uint_as_float(w & 0xffff0000u);
  }
}

// The pair sign of a packed table entry as +1 or -1.
__device__ __forceinline__ float pair_sign(int e) {
  return __int_as_float(0x3f800000 | ((e & (FIELD + 1)) << 26));
}

// Four bf16 values from 8 bytes of shared memory (8-byte aligned).
__device__ __forceinline__ void ld_bf16x4(const bf16* p, float (&v)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(w.x << 16);
  v[1] = __uint_as_float(w.x & 0xffff0000u);
  v[2] = __uint_as_float(w.y << 16);
  v[3] = __uint_as_float(w.y & 0xffff0000u);
}

// Four values of one blade as two bf16 pairs at column lane of the member's
// two 32-bit scratch rows (ps, ps + 32): a row of 32 words takes each word
// in its own bank, so any gather by blade is conflict-free.
__device__ __forceinline__ void put_pairs(uint32_t* ps, int lane,
                                          const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  ps[lane] = *reinterpret_cast<const uint32_t*>(&a);
  ps[32 + lane] = *reinterpret_cast<const uint32_t*>(&b);
}
__device__ __forceinline__ void get_pairs(const uint32_t* ps, int i,
                                          float (&v)[4]) {
  const uint32_t a = ps[i], b = ps[32 + i];
  v[0] = __uint_as_float(a << 16);
  v[1] = __uint_as_float(a & 0xffff0000u);
  v[2] = __uint_as_float(b << 16);
  v[3] = __uint_as_float(b & 0xffff0000u);
}

// The row phase for row r of the step (every lane of its team calls it):
// the forward after the linears and the backward up to them, as
// cemlp_pair.cuh's row_backward computes it, from fa (first), fb (yr), z
// and the row's output cotangent go ((C, NB) fp32, read rounded to bf16
// where GO_RND); leaves yn, d(first) and d(yr) in their bf16 tiles, d(z)
// of the pair product over fb, and adds the row's per-channel gradients
// (layer-norm gain, bL, d sigmoid(normalization.a)) to the row's sums in
// loc.
//
// The pair loops are bound by the shared-memory and shuffle pipe, not by
// arithmetic, so a member takes groups of four channels (every nh-th) side
// by side, and each loop step reads the four channels' operands at once:
// the one operand all lanes share (yn_k, or d_j) as one 8-byte broadcast
// from its tile, the one each lane gathers by blade (z_i, or d_j) as two
// words of the member's scratch rows (ps, conflict-free), the path weight
// per channel.  Grade and blade sums of the four channels run side by side
// too.  The pair sign multiplies the rounded product (rounding commutes
// with it).  Channels past c compute on the zero padding (and on the next
// path weights) and are dropped.
template <class A, bool GO_RND = false>
__device__ __forceinline__ void pair_row_phase(const PBufs<A>& b,
                                               const PLayout& L,
                                               const Lane& l, const Team& tm,
                                               float* sc, uint32_t* ps,
                                               const float* __restrict__ go,
                                               int r) {
  using P = PTile<A>;
  constexpr int NB = A::NB, U = PT_GROUP;
  const int c = L.c, fp = L.fp, ldc = L.ldc, lane = l.id, step = U * tm.nh;
  const int row0 = r * (NB + 1);
  const int trow = row0 + lane;
  float* fa = b.fa + trow * fp;
  float* fb = b.fb + trow * fp;
  const bf16* zt = b.z + trow * ldc;
  bf16* yt = b.yd + trow * ldc;
  bf16* dft = b.df + trow * ldc;
  bf16* drt = b.dr + trow * ldc;
  float* loc = b.loc + r * P::NLOC * c;   // [aln, bL, ns (NG)][C]
  const unsigned mm = member_mask<A>();
  auto channels = [&](int n0, int (&n)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) n[u] = n0 + u < c ? n0 + u : c - 1;
  };
  // ---- forward: normalisation, pair product, layer norm's mean
  float msum = 0.f;
  for (int n0 = U * tm.h; n0 < c; n0 += step) {
    int n[U];
    channels(n0, n);
    float yr[U], zo[U], ynr[U], gp[U], qc[U];
    Norm q[U];
#pragma unroll
    for (int u = 0; u < U; ++u) yr[u] = fb[n[u]];
    ld_bf16x4(zt + n0, zo);   // columns past c read the zero padding
    normalise4<A>(b, l, sc, n, c, yr, q);   // begins with __syncwarp
    put_pairs(ps, lane, zo);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ynr[u] = rnd<true>(q[u].yn);
      gp[u] = 0.f;
      if (n0 + u < c) yt[n0 + u] = __float2bfloat16_rn(ynr[u]);
    }
    __syncwarp(mm);
#pragma unroll 4
    for (int k = 0; k < NB; ++k) {       // lane = output blade j
      const int t = b.t1[k * NB + lane];
      const float* gwq = b.gw + (t >> 6) * fp + n0;
      const float sg = pair_sign(t);
      float yk[U], zi[U], pr[U];
      ld_bf16x4(b.yd + (row0 + k) * ldc + n0, yk);
      get_pairs(ps, t & FIELD, zi);
#pragma unroll
      for (int u = 0; u < U; ++u) pr[u] = (zi[u] * yk[u]) * gwq[u];
      rnd4(pr);
#pragma unroll
      for (int u = 0; u < U; ++u) gp[u] = fmaf(sg, pr[u], gp[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float first = fa[n[u]] + (lane == 0 ? b.bl[n[u]] : 0.f);
      const float o = (first + gp[u]) * SQRT2_INV;
      if (n0 + u < c) fa[n0 + u] = o;
      qc[u] = rnd<true>(o * o * l.bc);
    }
    blade_sums<A>(qc);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (n0 + u < c) msum += sqrtf(sqrtf(qc[u] * qc[u] + 1e-16f));
  }
  const float mden = team_sum<A>(tm, msum, 0) / (float)c + EPS;
  // ---- MVLayerNorm backward: out = aln * o / m (this member's channels)
  float t = 0.f;
  for (int n0 = U * tm.h; n0 < c; n0 += step) {
    int n[U];
    channels(n0, n);
    float ta[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float g = rnd<GO_RND>(go[n[u] * NB + lane]), o = fa[n[u]];
      if (n0 + u < c) t += g * b.aln[n[u]] * o;
      ta[u] = g * o;
    }
    blade_sums<A>(ta);
    if (lane == 0)
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (n0 + u < c) loc[n[u]] += ta[u] / mden;
  }
  const float dm = -team_sum<A>(tm, blade_sum<A>(t), 1) / (mden * mden);
  for (int n0 = U * tm.h; n0 < c; n0 += step) {
    int n[U];
    channels(n0, n);
    float g[U], o[U], qc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      g[u] = rnd<GO_RND>(go[n[u] * NB + lane]);
      o[u] = fa[n[u]];
      qc[u] = rnd<true>(o[u] * o[u] * l.bc);
    }
    blade_sums<A>(qc);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (n0 + u >= c) continue;
      const float s1c = sqrtf(qc[u] * qc[u] + 1e-16f);
      const float nc = sqrtf(s1c);
      const float dqc = rnd<true>(dm / (float)c * 0.5f * qc[u] / (s1c * nc));
      const float dfg =
          (b.aln[n[u]] * g[u] / mden + dqc * 2.f * l.bc * o[u]) * SQRT2_INV;
      dft[n0 + u] = __float2bfloat16_rn(dfg);
      if (lane == 0) loc[c + n[u]] += dfg;
    }
  }
  // ---- pair-product and normalisation backward
  for (int n0 = U * tm.h; n0 < c; n0 += step) {
    int n[U];
    channels(n0, n);
    float yr[U], zo[U], dfr[U], dzg[U], dyn[U], dd[U];
    Norm q[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      yr[u] = fb[n[u]];
      dzg[u] = 0.f;
      dyn[u] = 0.f;
    }
    ld_bf16x4(zt + n0, zo);
    normalise4<A>(b, l, sc, n, c, yr, q);   // begins with __syncwarp
    ld_bf16x4(dft + n0, dfr);
    put_pairs(ps, lane, dfr);
    put_pairs(ps + 64, lane, zo);
    __syncwarp(mm);
#pragma unroll 4
    for (int k = 0; k < NB; ++k) {       // lane = left blade i
      const int e = b.t2[k * NB + lane];
      const float* gwp = b.gw + (e >> 6) * fp + n0;
      const float sg = pair_sign(e);
      float yk[U], dj[U], pr[U];
      ld_bf16x4(b.yd + (row0 + k) * ldc + n0, yk);
      get_pairs(ps, e & FIELD, dj);
#pragma unroll
      for (int u = 0; u < U; ++u) pr[u] = (dj[u] * yk[u]) * gwp[u];
      rnd4(pr);
#pragma unroll
      for (int u = 0; u < U; ++u) dzg[u] = fmaf(sg, pr[u], dzg[u]);
    }
#pragma unroll 4
    for (int j = 0; j < NB; ++j) {       // lane = right blade k
      const int e = b.t3[j * NB + lane];
      const float* gwp = b.gw + (e >> 6) * fp + n0;
      const float sg = pair_sign(e);
      float dj[U], zi[U], pr[U];
      ld_bf16x4(b.df + (row0 + j) * ldc + n0, dj);
      get_pairs(ps + 64, e & FIELD, zi);
#pragma unroll
      for (int u = 0; u < U; ++u) pr[u] = (dj[u] * zi[u]) * gwp[u];
      rnd4(pr);
#pragma unroll
      for (int u = 0; u < U; ++u) dyn[u] = fmaf(sg, pr[u], dyn[u]);
    }
    // yn = yr / den
#pragma unroll
    for (int u = 0; u < U; ++u) dd[u] = -dyn[u] * q[u].yn / q[u].den;
    grade_sums<A>(dd, sc, l);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (n0 + u >= c) continue;
      if (lane == l.lo) loc[(2 + l.g) * c + n[u]] += dd[u] * (q[u].nr - 1.f);
      const float dnr = dd[u] * b.nsig[l.g * c + n[u]];
      const float dqg =
          rnd<true>(dnr * 0.5f * q[u].qg / (q[u].s1g * q[u].nr));
      const float dyr = dyn[u] / q[u].den + dqg * 2.f * l.bc * yr[u];
      drt[n0 + u] = __float2bfloat16_rn(dyr);
      fb[n0 + u] = dzg[u];
    }
  }
}

// MVSiLU's gates of a (row, channel) from its linear output y (bias added
// here): the grade invariants inv and the gates sg.
template <class A>
__device__ __forceinline__ void pair_gates(float (&y)[A::NB],
                                           const PBufs<A>& b,
                                           const Tabs<A>& tb, int n, int c,
                                           float (&inv)[A::NG],
                                           float (&sg)[A::NG]) {
  y[0] += b.b1[n];
#pragma unroll
  for (int g = 0; g < A::NG; ++g) inv[g] = 0.f;
  inv[0] = rnd<true>(y[0]);
#pragma unroll
  for (int i = 1; i < A::NB; ++i)
    inv[A::grade(i)] += rnd<true>(y[i] * y[i] * tb.bc[i]);
#pragma unroll
  for (int g = 0; g < A::NG; ++g)
    sg[g] = sigmoid_f(b.ra[g * c + n] * inv[g] + b.sb[g * c + n]);
}

// The x tile of the step: rows row0 .. row0 + nrow - 1 of x, rounded to
// bf16, at tile rows r * (NB + 1) + i, column m.
template <class A, class P = PTile<A>>
__device__ __forceinline__ void load_pair_x(const float* __restrict__ x,
                                            const PBufs<A>& b,
                                            const PLayout& L, int64_t row0,
                                            int nrow) {
  constexpr int NB = A::NB;
  const int tid = threadIdx.x + 32 * threadIdx.y;
  const float4* src =
      reinterpret_cast<const float4*>(x + row0 * L.cin * NB);
  const int n4 = nrow * L.cin * NB / 4;
  for (int e0 = tid; e0 < n4; e0 += 4 * P::THREADS) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * P::THREADS;
      v[u] = e < n4 ? __ldg(src + e) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = 4 * (e0 + u * P::THREADS);
      if (e >= 4 * n4) continue;
      const int i = e % NB, m = (e / NB) % L.cin, r = e / (NB * L.cin);
      bf16* dst = b.x + (size_t)(r * (NB + 1) + i) * L.ldx + m;
      dst[0] = __float2bfloat16_rn(v[u].x);
      dst[L.ldx] = __float2bfloat16_rn(v[u].y);
      dst[2 * L.ldx] = __float2bfloat16_rn(v[u].z);
      dst[3 * L.ldx] = __float2bfloat16_rn(v[u].w);
    }
  }
}

// The step's three linears and MVSiLU, the phases the forward (K2p) and
// the backward (K3p) share; each ends before a barrier.  c is the
// caller's output width (L.c), passed so that the kernel keeps one copy
// of it live (with L.c beside it the backward spilled more).
// F1: Y = X W1 -> fa.
template <class A, class P = PTile<A>>
__device__ __forceinline__ void pt_f1(const PBufs<A>& b, const PLayout& L,
                                      int c, int warp, int lane) {
  const int zw1 = A::NG * c;   // the weights' zero row
  for (int task = warp; task < L.mt * L.nt; task += P::WARPS) {
    const int t = task / L.nt, n0 = 8 * (task % L.nt);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    p_linear(acc, b.x, L.ldx, L.kin, b.w1, L.ldx, b.mtg[t], c, zw1,
             b.mrow + 16 * t, n0, lane);
    p_store(acc, b.fa, L.fp, c, b.mrow + 16 * t, n0, P::ZROW, lane);
  }
}

// S1: MVSiLU, a thread per (row, channel) -> z (zero past the step's
// nrow rows).
template <class A, class P = PTile<A>>
__device__ __forceinline__ void pt_s1(const PBufs<A>& b, const PLayout& L,
                                      const Tabs<A>& tb, int c, int nrow) {
  constexpr int NB = A::NB, NG = A::NG;
  const int tid = threadIdx.x + 32 * threadIdx.y;
  for (int it = tid; it < P::R * c; it += P::THREADS) {
    const int r = it / c, n = it % c, t0 = r * (NB + 1);
    float y[NB], inv[NG], sg[NG];
#pragma unroll
    for (int i = 0; i < NB; ++i) y[i] = b.fa[(t0 + i) * L.fp + n];
    pair_gates<A>(y, b, tb, n, c, inv, sg);
#pragma unroll
    for (int i = 0; i < NB; ++i)
      b.z[(t0 + i) * L.ldc + n] = __float2bfloat16_rn(
          r < nrow ? rnd<true>(sg[A::grade(i)] * y[i]) : 0.f);
  }
}

// F2: YR = z Wr -> fb, FI = z WL -> fa, one z fragment for both.
template <class A, class P = PTile<A>>
__device__ __forceinline__ void pt_f2(const PBufs<A>& b, const PLayout& L,
                                      int c, int warp, int lane) {
  const int zw1 = A::NG * c;
  for (int task = warp; task < L.mt * L.nt; task += P::WARPS) {
    const int t = task / L.nt, n0 = 8 * (task % L.nt), g = b.mtg[t];
    const short* mr = b.mrow + 16 * t;
    float ar[4] = {0.f, 0.f, 0.f, 0.f}, al[4] = {0.f, 0.f, 0.f, 0.f};
    const bf16* arow = b.z + (size_t)mr[lane & 15] * L.ldc + (lane >> 4) * 8;
    const int n = n0 + (lane & 7);
    const size_t wrow = (size_t)(n < c ? g * c + n : zw1) * L.ldc +
                        ((lane >> 3) & 1) * 8;
    for (int ks = 0; ks < L.kc; ks += 16) {
      uint32_t af[4], br[2], bl[2];
      ldsm4(af, arow + ks);
      ldsm2(br, b.wr + wrow + ks);
      ldsm2(bl, b.wl + wrow + ks);
      mma_bf16_s(ar, af, br);
      mma_bf16_s(al, af, bl);
    }
    p_store(ar, b.fb, L.fp, c, mr, n0, P::ZROW, lane);
    p_store(al, b.fa, L.fp, c, mr, n0, P::ZROW, lane);
  }
}

// What a warp of the backward's step needs besides the tiles: its row (in
// the row phase), its team and lane, its scratch rows.
template <class A>
struct PWarp {
  Lane l;
  Team tm;
  int warp, lane, tid, r_team;
  float* scw;      // the member's grade-sum scratch
  uint32_t* psw;   // the member's scratch rows of bf16 pairs
};

template <class A, class P = PTile<A>>
__device__ __forceinline__ PWarp<A> make_pwarp(const PBufs<A>& b,
                                               const Tabs<A>& tb) {
  PWarp<A> w;
  w.warp = threadIdx.y;
  w.lane = threadIdx.x;
  w.tid = w.lane + 32 * w.warp;
  w.l = make_lane<A>(tb);
  w.r_team = w.warp / P::WPR;
  w.tm = make_team<A>(w.warp, P::WPR, b.xch);
  w.scw = b.sc + (w.warp * 32 + half_of_warp<A>() * A::NB) * PT_GROUP;
  // a member's scratch rows: its lanes' words of each of the warp's four
  // 32-word rows (a half-warp member at Cl(4) takes half of each)
  w.psw = b.ps + w.warp * 4 * 32 + half_of_warp<A>() * A::NB;
  return w;
}

// The whole backward of a block for one step of nrow rows; every thread of
// the CTA calls it behind a barrier that ends the previous step's use of
// the tiles.  Hooks:
//   load()     brings the step's rows of x into the x tile (rows past nrow
//              may keep older finite values: their cotangents are zero);
//   go_of(r)   row r's output cotangent ((C, NB) fp32, read rounded to
//              bf16 where GO_RND), or nullptr for a zero cotangent;
//   sink(r, i, m, v)  dx of row r, blade i, input channel m (B4).
// The weight gradients go into the warp's register tiles wacc, the
// per-channel ones into b.loc, b.sacc and b.gacc.  Ends after B4, before
// a barrier.
template <class A, int MAXT, bool GO_RND, class P = PTile<A>, class Load,
          class Go, class Sink>
__device__ __forceinline__ void pair_tile_block_backward(
    const PBufs<A>& b, const PLayout& L, const Tabs<A>& tb, const PWarp<A>& w,
    int c, int nrow, Load load, Go go_of, Sink sink, float (&wacc)[MAXT][4]) {
  constexpr int NB = A::NB, NG = A::NG, NP = A::NP, R = P::R;
  const int tid = w.tid, warp = w.warp, lane = w.lane;
  const int zw1 = NG * c;   // the weights' zero row
  load();
  __syncthreads();
  pt_f1<A, P>(b, L, c, warp, lane);  // Y = X W1 -> fa
  __syncthreads();
  pt_s1<A, P>(b, L, tb, c, nrow);  // MVSiLU -> z
  __syncthreads();
  pt_f2<A, P>(b, L, c, warp, lane);  // YR = z Wr -> fb, FI = z WL -> fa
  __syncthreads();
  // ---- the row phase (rows past nrow and rows without a cotangent: zero
  // cotangents, and no d(z) from the pair product)
  {
    const float* go = w.r_team < nrow ? go_of(w.r_team) : nullptr;
    if (go != nullptr) {
      pair_row_phase<A, GO_RND>(b, L, w.l, w.tm, w.scw, w.psw, go, w.r_team);
    } else {
      const int trow = w.r_team * (NB + 1) + w.l.id;
      for (int n = w.tm.h; n < c; n += w.tm.nh) {
        b.df[trow * L.ldc + n] = __float2bfloat16_rn(0.f);
        b.dr[trow * L.ldc + n] = __float2bfloat16_rn(0.f);
        b.fb[trow * L.fp + n] = 0.f;
      }
    }
  }
  __syncthreads();
  // ---- path-weight gradients: a thread per (path, two channels), its
  // pairs (j, k, i) over the step's rows side by side: sum of (z_i *
  // yn_k) * (sign d_j), each row's sum in pair order, then the rows in
  // order (bf16 pairs: a channel past c reads the zero padding)
  for (int it = tid; it < NP * L.c2; it += P::THREADS) {
    const int q = it / L.c2, n = 2 * (it % L.c2);
    float acc[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0.f;
    for (int k = b.off[q]; k < b.off[q + 1]; ++k) {
      const int e = b.list[k];
      const int j = e & FIELD, kk = (e >> 5) & FIELD, i = (e >> 10) & FIELD;
      const float sg = (e >> 15) ? -1.f : 1.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int t0 = r * (NB + 1);
        const float2 dj = bf2(b.df + (t0 + j) * L.ldc + n);
        const float2 zi = bf2(b.z + (t0 + i) * L.ldc + n);
        const float2 yk = bf2(b.yd + (t0 + kk) * L.ldc + n);
        acc[r][0] += (zi.x * yk.x) * (sg * dj.x);
        acc[r][1] += (zi.y * yk.y) * (sg * dj.y);
      }
    }
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s0 += acc[r][0];
      s1 += acc[r][1];
    }
    b.gacc[q * c + n] += s0;
    if (n + 1 < c) b.gacc[q * c + n + 1] += s1;
  }
  // ---- B2: Y -> fa, d(z) = fb + d(first) WL^T + d(yr) Wr^T -> fb
  for (int task = warp; task < L.mt * L.nt; task += P::WARPS) {
    const int t = task / L.nt, n0 = 8 * (task % L.nt), g = b.mtg[t];
    const short* mr = b.mrow + 16 * t;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    p_linear(acc, b.x, L.ldx, L.kin, b.w1, L.ldx, g, c, zw1, mr, n0, lane);
    float dz[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = mr[pfrag_row(lane, q)], n = n0 + pfrag_col(lane, q);
      dz[q] = (row != P::ZROW && n < c) ? b.fb[row * L.fp + n] : 0.f;
    }
    p_linear_t(dz, b.df, L.ldc, L.kc, b.wl, L.ldc, g, c, zw1, mr, n0,
               lane);
    p_linear_t(dz, b.dr, L.ldc, L.kc, b.wr, L.ldc, g, c, zw1, mr, n0,
               lane);
    p_store(acc, b.fa, L.fp, c, mr, n0, P::ZROW, lane);
    p_store(dz, b.fb, L.fp, c, mr, n0, P::ZROW, lane);
  }
  __syncthreads();
  // ---- S2: MVSiLU backward -> d(y) over yn's tile (zero past the rows)
  for (int it = tid; it < R * c; it += P::THREADS) {
    const int r = it / c, n = it % c, t0 = r * (NB + 1);
    if (r >= nrow) {
#pragma unroll
      for (int i = 0; i < NB; ++i)
        b.yd[(t0 + i) * L.ldc + n] = __float2bfloat16_rn(0.f);
      continue;
    }
    float y[NB], inv[NG], sg[NG], dgs[NG], dgr[NG];
#pragma unroll
    for (int i = 0; i < NB; ++i) y[i] = b.fa[(t0 + i) * L.fp + n];
    pair_gates<A>(y, b, tb, n, c, inv, sg);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      dgs[g] = 0.f;
      dgr[g] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const float sv = sg[A::grade(i)];
      const float dgate = b.fb[(t0 + i) * L.fp + n] * y[i] * sv * (1.f - sv);
      dgs[A::grade(i)] += dgate;
      dgr[A::grade(i)] += rnd<true>(dgate);
    }
    float* sa = b.sacc + it;   // [NSIL][R * C]
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      sa[(1 + NG + g) * R * c] += dgs[g];
      sa[(1 + g) * R * c] += inv[g] * dgr[g];
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int g = A::grade(i);
      const float dv = b.ra[g * c + n] * dgr[g];
      const float dz = b.fb[(t0 + i) * L.fp + n];
      const float dy = dz * sg[g] + (i == 0 ? dv : 2.f * tb.bc[i] * y[i] * dv);
      if (i == 0) sa[0] += dy;
      b.yd[(t0 + i) * L.ldc + n] = __float2bfloat16_rn(dy);
    }
  }
  __syncthreads();
  // ---- B3: weight gradients into the warp's register tiles; K runs over
  // the grade's M tiles
  {
    const int arow = (lane & 7) + ((lane >> 4) & 1) * 8;
    const int acol = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      const int d = b.wd[warp * 32 + j];
      if (d < 0) continue;
      const int which = d & 3, g = (d >> 2) & 7;
      const int m0 = 16 * ((d >> 5) & 1023), n0 = 8 * (d >> 15);
      const bf16* as = which == 0 ? b.x : b.z;
      const int lda = which == 0 ? L.ldx : L.ldc;
      const bf16* bs = which == 0 ? b.yd : which == 1 ? b.dr : b.df;
      const int t0 = b.tfirst[g], tn = b.tfirst[g + 1] - t0;
#pragma unroll
      for (int tt = 0; tt < P::GTMAX; ++tt) {
        if (tt >= tn) break;
        const short* mr = b.mrow + 16 * (t0 + tt);
        uint32_t af[4], bfr[2];
        ldsm4_t_s(af, (unsigned)__cvta_generic_to_shared(
                          as + (size_t)mr[arow] * lda + m0 + acol));
        ldsm2_t_s(bfr, (unsigned)__cvta_generic_to_shared(
                           bs + (size_t)mr[lane & 15] * L.ldc + n0));
        mma_bf16_s(wacc[j], af, bfr);
      }
    }
  }
  // ---- B4: dx = d(y) W1^T, to the sink
  for (int task = warp; task < L.mt * L.ntm; task += P::WARPS) {
    const int t = task / L.ntm, m0 = 8 * (task % L.ntm), g = b.mtg[t];
    const short* mr = b.mrow + 16 * t;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    p_linear_t(acc, b.yd, L.ldc, L.kc, b.w1, L.ldx, g, c, zw1, mr, m0, lane);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = mr[pfrag_row(lane, q)], m = m0 + pfrag_col(lane, q);
      const int r = row / (NB + 1), i = row % (NB + 1);
      if (row != P::ZROW && r < nrow && m < L.cin) sink(r, i, m, acc[q]);
    }
  }
}

template <class A, int MAXT>
__global__ void __launch_bounds__(PTile<A>::THREADS, 1)
cemlp_pair_bwd_tile_kernel(const float* __restrict__ x,
                           const float* __restrict__ dout, Params p,
                           Tabs<A> tb, const uint16_t* __restrict__ tabs,
                           float* __restrict__ dx,
                           float* __restrict__ partials, int rows, int cin,
                           int c) {
  using P = PTile<A>;
  constexpr int NB = A::NB, NG = A::NG, NP = A::NP, R = P::R;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const PLayout L = pair_tile_layout<A>(cin, c);
  const PBufs<A> b = carve_pbufs<A>(base, L);
  stage_pair_tile<A>(p, tabs, b, L, base);
  const PWarp<A> w = make_pwarp<A>(b, tb);
  const int tid = w.tid, warp = w.warp, lane = w.lane;
  float wacc[MAXT][4];
#pragma unroll
  for (int j = 0; j < MAXT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) wacc[j][q] = 0.f;

  const int n_steps = (rows + R - 1) / R;
  for (int step = blockIdx.x; step < n_steps; step += gridDim.x) {
    const int64_t row0 = (int64_t)step * R;
    const int nrow = rows - row0 < R ? (int)(rows - row0) : R;
    __syncthreads();   // the previous step's tiles are consumed
    pair_tile_block_backward<A, MAXT, false>(
        b, L, tb, w, c, nrow, [&] { load_pair_x<A>(x, b, L, row0, nrow); },
        [&](int r) { return dout + (row0 + r) * c * NB; },
        [&](int r, int i, int m, float v) {
          dx[((row0 + r) * cin + m) * NB + i] = v;
        },
        wacc);
  }
  __syncthreads();
  // ---- this CTA's partial gradient vector, in flax layout; per-row sums
  // added in row order
  float* part = partials + (int64_t)blockIdx.x * grad_floats<A>(cin, c);
  const int64_t o_r = (int64_t)c * cin * NG + c + 2 * NG * c + NP * c;
  const int64_t o_l = o_r + (int64_t)c * c * NG + NG * c;
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
    const int d = b.wd[warp * 32 + j];
    if (d < 0) continue;
    const int which = d & 3, g = (d >> 2) & 7;
    const int m0 = 16 * ((d >> 5) & 1023), n0 = 8 * (d >> 15);
    const int mmax = which == 0 ? cin : c;
    float* dst = part + (which == 0 ? 0 : which == 1 ? o_r : o_l);
#pragma unroll
    for (int p4 = 0; p4 < 4; ++p4) {
      const int m = m0 + pfrag_row(lane, p4), n = n0 + pfrag_col(lane, p4);
      if (m < mmax && n < c) dst[((int64_t)n * mmax + m) * NG + g] = wacc[j][p4];
    }
  }
  auto rsum = [&](const float* v, int stride) {   // sum over the R rows
    float a = 0.f;
    for (int r = 0; r < R; ++r) a += v[r * stride];
    return a;
  };
  int64_t o = (int64_t)c * cin * NG;
  for (int e = tid; e < c; e += P::THREADS)                   // db1
    part[o + e] = rsum(b.sacc + e, c);
  o += c;
  for (int e = tid; e < c * NG; e += P::THREADS)              // dsilu.a
    part[o + e] = rsum(b.sacc + (1 + e % NG) * R * c + e / NG, c);
  o += NG * c;
  for (int e = tid; e < c * NG; e += P::THREADS)              // dsilu.b
    part[o + e] = rsum(b.sacc + (1 + NG + e % NG) * R * c + e / NG, c);
  o += NG * c;
  for (int e = tid; e < c * NP; e += P::THREADS)              // dgp.weight
    part[o + e] = b.gacc[(e % NP) * c + e / NP];
  o += NP * c + (int64_t)c * c * NG;
  for (int e = tid; e < c * NG; e += P::THREADS)              // d sigmoid(a)
    part[o + e] = rsum(b.loc + (2 + e % NG) * c + e / NG, P::NLOC * c);
  o += NG * c + (int64_t)c * c * NG;
  for (int e = tid; e < c; e += P::THREADS)                   // dbL
    part[o + e] = rsum(b.loc + c + e, P::NLOC * c);
  o += c;
  for (int e = tid; e < c; e += P::THREADS)                   // dln.a
    part[o + e] = rsum(b.loc + e, P::NLOC * c);
}

template <class A, int MAXT>
int launch_pair_tile(const float* x, const float* dout, const Params& p,
                     const Tabs<A>& tb, const uint16_t* tabs, float* dx,
                     float* partials, int rows, int cin, int c, size_t bytes,
                     int grid, cudaStream_t st) {
  cudaFuncSetAttribute(cemlp_pair_bwd_tile_kernel<A, MAXT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  cemlp_pair_bwd_tile_kernel<A, MAXT><<<grid, dim3(32, PTile<A>::WARPS),
                                        bytes,
                                        st>>>(x, dout, p, tb, tabs, dx,
                                              partials, rows, cin, c);
  return (int)cudaGetLastError();
}

// partials: (grid, grad_floats) scratch; grads: (grad_floats,) output.
template <class A>
int launch_pair_tile_bwd(const float* x, const float* dout, const Params& p,
                         const Tabs<A>& tb, const uint16_t* tabs, float* dx,
                         float* partials, float* grads, int rows, int cin,
                         int c, int grid, cudaStream_t st) {
  const size_t bytes = pair_tile_smem_bytes<A>(cin, c);
  if (bytes == 0) return (int)cudaErrorInvalidValue;
  int err;
  switch (pair_tile_maxt<A>(cin, c)) {
    case 16:
      err = launch_pair_tile<A, 16>(x, dout, p, tb, tabs, dx, partials, rows,
                                    cin, c, bytes, grid, st);
      break;
    case 24:
      err = launch_pair_tile<A, 24>(x, dout, p, tb, tabs, dx, partials, rows,
                                    cin, c, bytes, grid, st);
      break;
    default:
      err = launch_pair_tile<A, 32>(x, dout, p, tb, tabs, dx, partials, rows,
                                    cin, c, bytes, grid, st);
  }
  if (err != cudaSuccess) return err;
  const int64_t n = grad_floats<A>(cin, c);
  reduce_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      partials, grads, n, n, grid);
  return (int)cudaGetLastError();
}

}  // namespace
