// The dense CEMLP block in row tiles, fast mode: the device code of K2
// and K3 (cemlp.cu, `cemlp_fwd_tile_kernel`, `cemlp_bwd_tile_kernel`), K4
// and K5 (fused_egcl.cu, `fused_mp_fwd_tile_kernel`,
// `fused_mp_bwd_tile_kernel`) at Cl(3,0) and Cl(2,0).  Exact mode keeps
// the row-per-warp code of cemlp_block.cuh (fp32 throughout: neither bf16
// nor TF32 products meet its 1e-5 forward and 1e-4 backward).
//
// A block's forward (`tile_block_forward`) is the phases F1, F2 and row
// below, its output handed to the caller's sink; its backward
// (`tile_block_backward`) is all of them.
//
// A CTA step takes R = TROWS = 16 rows, with 8 warps.  Its block math runs
// in phases, each behind a barrier, on tiles in shared memory:
//   F1   Y = X W1 on the tensor cores, then MVSiLU in the accumulator
//        registers -> z (bf16 tile);
//   F2   YR = z Wr and FI = z WL on the tensor cores -> fp32 tiles;
//   row  a warp per row, a lane per channel (two at Cl(2)): the right
//        operand's normalisation, the Cayley pair product and the layer
//        norm, the row's mean and d(mean) by warp shuffles -> the
//        block's output (the forward), or their backward -> d(first),
//        d(yr) (bf16 tiles) and the product's d(z) (fp32, over YR);
//   B2   Y again and d(z) += d(first) WL^T + d(yr) Wr^T on the tensor
//        cores, then MVSiLU's backward in the accumulator registers -> d(y);
//   B3   the channel-mixing weight gradients X^T d(y), z^T d(yr), z^T
//        d(first) on the tensor cores, into accumulators each warp keeps in
//        registers over all of the CTA's steps (fixed (grade, m16, n8)
//        tiles, warp q % 8 owning tile q; MAXT of them a warp, a kernel
//        instance each at 16, 20, 24 and 32, and K3's chunked one at 40)
//        and writes once;
//   B4   dx = d(y) W1^T on the tensor cores, each thread holding every
//        blade of its (row, input channel) positions, written to the
//        caller's sink.
// Every product is bf16 `mma.sync.m16n8k16` with fp32 accumulators.  Its
// operands are the values the row code rounds to bf16 at the same points
// (the weights, x, z and the three cotangents), so the products are exact
// and only the order of the fp32 sums differs.  For a product of grade g,
// blade i's rows form one m16 tile against the grade's weight: the warp
// loops over the blades, so a thread ends holding all blades of its four
// (row, channel) positions, which is what MVSiLU and dx need.  Where two
// warps fit an n8 tile (C <= 32), each takes half of its rows' MVSiLU.
//
// Why R = 16: the tiles grow with R, and at 32 rows the widest shapes of
// the tasks (MD17's 90 -> 32 block; K5's two blocks and window) no longer
// fit in 227 KB; the weight-gradient registers do not grow with R.
//
// The x tile may hold the input channels in chunks of kch (a multiple of
// 16; nch chunks over Cin): where the whole tile does not fit, the phases
// that read x (F1, B2, B3) load its chunks in turn through the caller's
// loader, each behind barriers.  The sums over Cin run in the same order
// either way, so the results do not depend on kch.  Only K3 and K2 take
// chunks, where they need them (wide inputs at narrow outputs), each in
// one instance of its own (CHUNKED; K3's at 40 tiles a warp): the chunk
// loops and the loader cost registers, and the whole-tile instances keep
// the code without them.
//
// Code size costs time here: every warp runs each phase's code once per
// step, and the whole kernel does not stay in the instruction cache.  So
// the row phase takes the pair product's forward once (not once for the
// row sums and again for the backward) and the epilogue loops stay rolled.
//
// Padding: C is padded to 16 (the depth of the products over channels)
// and Cin to 16, with zeros in both operands: the tiles are zeroed once,
// their padded columns are never written (but for the last chunk of a
// chunked x tile, whose loader zeroes them), and every phase writes zeros
// into the rows past the step's last row.  Row pitches are 8 bf16 past a
// multiple of 16, an odd multiple of 16 bytes (mma.cuh).
//
// Per-channel gradients are summed in registers (MVSiLU's in the fragment
// layout) or in each warp's own shared-memory slots (the row phase's),
// and reduced over the CTA's threads in a fixed order at the end, as the
// layer norm's row sums are by shuffles: results are bitwise repeatable.
#pragma once

#include "cemlp_block.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TWARPS = THREADS / 32;   // 8 warps
constexpr int TROWS = 16;              // rows a CTA step takes

__host__ __device__ constexpr int up16(int x) { return (x + 15) / 16 * 16; }
__host__ __device__ constexpr int up8(int x) { return (x + 7) / 8 * 8; }
__host__ __device__ inline size_t al16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

struct TileGeom {
  int cin, c;     // input and output channels
  int kin, kc;    // cin and c padded to the product depth, 16
  int nt;         // n8 tiles over c
  int ntm;        // n8 tiles over cin
  int ldx, ldc;   // bf16 row pitches: kin + 8, kc + 8
  int fp;         // fp32 row pitch of the c-wide fp32 tiles
  int ns;         // warps an n8 tile of the fragment phases: 2 where
                  // 2 * nt warps fit, each taking half the rows' MVSiLU
  int kch, ldb;   // the x tile: input channels a chunk (a multiple of 16),
                  // its bf16 row pitch kch + 8
  int nch;        // chunks over kin
};

// The geometry of (cin, c), the x tile cut into chunks of kch input
// channels (0: one chunk of kin).
__host__ __device__ inline TileGeom tile_geom(int cin, int c, int kch = 0) {
  TileGeom t;
  t.cin = cin;
  t.c = c;
  t.kin = up16(cin);
  t.kc = up16(c);
  t.nt = up8(c) / 8;
  t.ntm = up8(cin) / 8;
  t.ldx = t.kin + 8;
  t.ldc = t.kc + 8;
  t.fp = up8(c) + 8;
  t.ns = 2 * t.nt <= TWARPS ? 2 : 1;
  t.kch = kch > 0 ? kch : t.kin;
  t.ldb = t.kch + 8;
  t.nch = (t.kin + t.kch - 1) / t.kch;
  return t;
}

// Weight-gradient tiles (grade, m16, n8) of dW1, dWr and dWL, in that
// order; warp w owns tiles w, w + 8, ...
template <class A>
__host__ __device__ inline int wgrad_tiles(const TileGeom& t) {
  return A::NG * t.nt * (t.kin / 16 + 2 * (t.kc / 16));
}

// The register accumulators a warp needs, rounded up to an instantiated
// size (16, 20, 24, 32 or 40 tiles a warp); 0 if more.
template <class A>
__host__ __device__ inline int tile_maxt(const TileGeom& t) {
  const int per = (wgrad_tiles<A>(t) + TWARPS - 1) / TWARPS;
  return per <= 16 ? 16 : per <= 20 ? 20 : per <= 24 ? 24 : per <= 32 ? 32
       : per <= 40 ? 40 : 0;
}

// Moves n floats from global memory, eight loads in flight a thread:
// v = ld(e), then st(e, v), for the e < n of thread tid of `stride`.
template <class Ld, class St>
__device__ __forceinline__ void copy_in(int n, Ld ld, St st, int tid,
                                        int stride) {
  for (int e0 = tid; e0 < n; e0 += 8 * stride) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * stride;
      v[u] = e < n ? ld(e) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * stride;
      if (e < n) st(e, v[u]);
    }
  }
}

// Block parameters in shared memory: the channel-mixing weights as bf16
// [g][n < kc][m] (pitch ldx for W1, ldc for Wr and WL), the per-channel
// ones fp32 as in `Smem`.
struct TParams {
  bf16 *w1, *wr, *wl;
  float *b1, *ra, *sb, *nsig, *gw, *bl, *aln;
};

template <class A>
__host__ __device__ inline size_t tparams_bytes(const TileGeom& t) {
  return al16(2 * (size_t)A::NG * t.kc * t.ldx) +
         2 * al16(2 * (size_t)A::NG * t.kc * t.ldc) +
         al16(4 * (size_t)t.c * (3 + 3 * A::NG + A::NP));
}

template <class A>
__device__ inline char* carve_tparams(char* p, const TileGeom& t,
                                      TParams& s) {
  constexpr int NG = A::NG, NP = A::NP;
  const int c = t.c;
  s.w1 = reinterpret_cast<bf16*>(p);
  p += al16(2 * (size_t)NG * t.kc * t.ldx);
  s.wr = reinterpret_cast<bf16*>(p);
  p += al16(2 * (size_t)NG * t.kc * t.ldc);
  s.wl = reinterpret_cast<bf16*>(p);
  p += al16(2 * (size_t)NG * t.kc * t.ldc);
  s.b1 = reinterpret_cast<float*>(p);
  s.ra = s.b1 + c;
  s.sb = s.ra + NG * c;
  s.nsig = s.sb + NG * c;
  s.gw = s.nsig + NG * c;
  s.bl = s.gw + NP * c;
  s.aln = s.bl + c;
  return p + al16(4 * (size_t)c * (3 + 3 * NG + NP));
}

// Writes a block's parameters in the layout carve_tparams carves, zero
// padding included, each element by one of `stride` threads (tid is this
// thread's): a CTA's threads staging them in shared memory
// (stage_tparams), or a grid's building them once in global memory (K2's
// parameter image).
template <class A>
__device__ __forceinline__ void write_tparams(const Params& p,
                                              const TParams& s,
                                              const TileGeom& t, int tid,
                                              int stride) {
  constexpr int NG = A::NG, NP = A::NP;
  const int c = t.c, cin = t.cin;
  copy_in(
      NG * t.kc * t.ldx,
      [&](int e) {
        const int m = e % t.ldx, n = (e / t.ldx) % t.kc,
                  g = e / (t.ldx * t.kc);
        return (n < c && m < cin) ? p.w1[((size_t)n * cin + m) * NG + g]
                                  : 0.f;
      },
      [&](int e, float v) { s.w1[e] = __float2bfloat16_rn(v); }, tid,
      stride);
  for (int k = 0; k < 2; ++k) {
    const float* src = k == 0 ? p.wr : p.wl;
    bf16* dstw = k == 0 ? s.wr : s.wl;
    copy_in(
        NG * t.kc * t.ldc,
        [&](int e) {
          const int m = e % t.ldc, n = (e / t.ldc) % t.kc,
                    g = e / (t.ldc * t.kc);
          return (n < c && m < c) ? src[(n * c + m) * NG + g] : 0.f;
        },
        [&](int e, float v) { dstw[e] = __float2bfloat16_rn(v); }, tid,
        stride);
  }
  for (int e = tid; e < c * NG; e += stride) {   // (n, g)
    const int g = e % NG, n = e / NG;
    s.ra[g * c + n] = rnd<true>(p.sa[e]);
    s.sb[g * c + n] = p.sb[e];
    s.nsig[g * c + n] = 1.f / (1.f + expf(-p.na[e]));
  }
  for (int e = tid; e < c * NP; e += stride) {   // (n, path)
    const int q = e % NP, n = e / NP;
    s.gw[q * c + n] = rnd<true>(p.gw[e]);
  }
  for (int e = tid; e < c; e += stride) {
    s.b1[e] = p.b1[e];
    s.bl[e] = p.bl[e];
    s.aln[e] = p.aln[e];
  }
}

template <class A>
__device__ void stage_tparams(const Params& p, const TParams& s,
                              const TileGeom& t) {
  write_tparams<A>(p, s, t, threadIdx.x + 32 * threadIdx.y, THREADS);
}

// The step's tiles besides its input: z, d(first), d(yr), d(y) bf16
// [NB][R][ldc]; yr (then d(z)) and first fp32 [NB][R][fp]; the per-channel
// gradient block [Loc::N][C]; each warp's own sums of the row phase's
// per-channel gradients, [warp][C][PSTRIDE] (the fields of a channel at
// fixed offsets, an odd stride between channels); the descriptors of the
// `ntile` weight-gradient tiles; the step's rows of the output cotangent,
// one pointer a row (null: zero; rounded to bf16 where go_rnd).
struct TileBufs {
  bf16 *z, *df, *dr, *dy;
  float *yr, *ff, *loc, *pacc;
  int4* wd;
  const float** gor;
  bool go_rnd;
};

// floats of a (warp, channel) record of the row phase's sums: aln, bL,
// the path weights, the normalisation gates; odd, so that the lanes'
// records fall in distinct banks
template <class A>
__host__ __device__ constexpr int pstride() {
  return (2 + A::NP + A::NG) | 1;
}

template <class A>
__host__ __device__ inline int pacc_floats(const TileGeom& t) {
  return TWARPS * t.c * pstride<A>();
}

template <class A>
__host__ __device__ inline size_t tilebufs_bytes(const TileGeom& t,
                                                 int ntile) {
  return 4 * al16(2 * (size_t)A::NB * TROWS * t.ldc) +
         2 * al16(4 * (size_t)A::NB * TROWS * t.fp) +
         al16(4 * (size_t)Loc<A>::N * t.c) + al16(4 * (size_t)pacc_floats<A>(t)) +
         16 * (size_t)ntile + 8 * TROWS;
}

template <class A>
__device__ inline char* carve_tilebufs(char* p, const TileGeom& t, int ntile,
                                       TileBufs& b) {
  const size_t tb = al16(2 * (size_t)A::NB * TROWS * t.ldc);
  b.z = reinterpret_cast<bf16*>(p);
  b.df = reinterpret_cast<bf16*>(p + tb);
  b.dr = reinterpret_cast<bf16*>(p + 2 * tb);
  b.dy = reinterpret_cast<bf16*>(p + 3 * tb);
  p += 4 * tb;
  b.yr = reinterpret_cast<float*>(p);
  p += al16(4 * (size_t)A::NB * TROWS * t.fp);
  b.ff = reinterpret_cast<float*>(p);
  p += al16(4 * (size_t)A::NB * TROWS * t.fp);
  b.loc = reinterpret_cast<float*>(p);
  p += al16(4 * (size_t)Loc<A>::N * t.c);
  b.pacc = reinterpret_cast<float*>(p);
  p += al16(4 * (size_t)pacc_floats<A>(t));
  b.wd = reinterpret_cast<int4*>(p);
  p += 16 * (size_t)ntile;
  b.gor = reinterpret_cast<const float**>(p);
  b.go_rnd = false;
  return p + 8 * TROWS;
}

// copy_in for a contiguous run of n4 float4 values (16-byte aligned).
template <class Ld, class St>
__device__ __forceinline__ void copy_in4(int n4, Ld ld, St st) {
  const int tid = threadIdx.x + 32 * threadIdx.y;
  for (int e0 = tid; e0 < n4; e0 += 8 * THREADS) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * THREADS;
      v[u] = e < n4 ? ld(e) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * THREADS;
      if (e < n4) st(e, v[u]);
    }
  }
}

// The output cotangent of one (row, channel) from the go tile.
template <class A>
__device__ __forceinline__ void load_go(const TileBufs& b, const TileGeom& t,
                                        int r, int n, float (&v)[A::NB]) {
  const float* row = b.gor[r];
#pragma unroll
  for (int k = 0; k < A::NB / 4; ++k) {
    const float4 u = row != nullptr
        ? reinterpret_cast<const float4*>(row + (size_t)n * A::NB)[k]
        : make_float4(0.f, 0.f, 0.f, 0.f);
    v[4 * k] = u.x;
    v[4 * k + 1] = u.y;
    v[4 * k + 2] = u.z;
    v[4 * k + 3] = u.w;
  }
  if (b.go_rnd) {
#pragma unroll
    for (int i = 0; i < A::NB; ++i) v[i] = rnd<true>(v[i]);
  }
}

__device__ inline void zero_bf16(bf16* p, int n) {
  const int tid = threadIdx.x + 32 * threadIdx.y;
  for (int e = tid; e < n; e += THREADS) p[e] = __float2bfloat16_rn(0.f);
}

// Stores NB values, each times s (zeros where !on), as NB bf16 in one
// vector store (p aligned to 2 NB bytes).
template <int NB>
__device__ __forceinline__ void st_bf16(bf16* p, const float (&v)[NB],
                                        float s, bool on) {
  uint32_t w[NB / 2];
#pragma unroll
  for (int k = 0; k < NB / 2; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(
        on ? s * v[2 * k] : 0.f, on ? s * v[2 * k + 1] : 0.f);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  if constexpr (NB == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// Zeroes the bf16 tiles once: their padded columns stay zero.
template <class A>
__device__ inline void zero_tilebufs(const TileBufs& b, const TileGeom& t) {
  const int n = A::NB * TROWS * t.ldc;
  zero_bf16(b.z, n);
  zero_bf16(b.df, n);
  zero_bf16(b.dr, n);
  zero_bf16(b.dy, n);
}

// Per-channel gradient accumulators of a thread: MVSiLU's in the fragment
// layout (the thread's two channels), the rest in the (row, channel) one.
template <class A>
struct FragAcc {
  float b1[2], sa[2][A::NG], sb[2][A::NG];
};
template <class A>
struct PairAcc {
  float aln, bl, gw[A::NP], ns[A::NG];
};

template <class A>
__device__ __forceinline__ void zero_pair_acc(PairAcc<A>& p) {
  p.aln = 0.f;
  p.bl = 0.f;
#pragma unroll
  for (int q = 0; q < A::NP; ++q) p.gw[q] = 0.f;
#pragma unroll
  for (int g = 0; g < A::NG; ++g) p.ns[g] = 0.f;
}

// Zeroes the per-channel sums: a thread's fa in registers, and (with the
// CTA's other threads, before a barrier) the warps' slots in b.pacc.
template <class A>
__device__ __forceinline__ void zero_accs(FragAcc<A>& f, const TileBufs& b,
                                          const TileGeom& t) {
  const int tid = threadIdx.x + 32 * threadIdx.y;
  for (int e = tid; e < pacc_floats<A>(t); e += THREADS) b.pacc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    f.b1[e] = 0.f;
#pragma unroll
    for (int g = 0; g < A::NG; ++g) { f.sa[e][g] = 0.f; f.sb[e][g] = 0.f; }
  }
}

// ------------------------------------------------------- tensor-core phases

template <class A>
__device__ __forceinline__ void zero_frag(float (&acc)[A::NB][4]) {
#pragma unroll
  for (int i = 0; i < A::NB; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
}

// acc[i] += X_i W_g(i) over rows r0..r0+15 and output channels n0..n0+7:
// X bf16 [NB][R][lda] (depth `depth`), W bf16 [g][n][k] (pitch ldw, kc
// rows a grade).
template <class A>
__device__ __forceinline__ void frag_linear(float (&acc)[A::NB][4],
                                            const bf16* x, int lda, int depth,
                                            const bf16* w, int ldw, int kc,
                                            int r0, int n0, int lane) {
  constexpr int NB = A::NB, NG = A::NG;
  for (int ks = 0; ks < depth; ks += 16) {
    uint32_t b[NG][2];
#pragma unroll
    for (int g = 0; g < NG; ++g)
      ldsm2(b[g], w + (size_t)(g * kc + n0 + (lane & 7)) * ldw + ks +
                      ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      uint32_t a[4];
      ldsm4(a, x + (size_t)(i * TROWS + r0 + (lane & 15)) * lda + ks +
                   (lane >> 4) * 8);
      mma_bf16_s(acc[i], a, b[grade<A>(i)]);
    }
  }
}

// acc[i] += D_i W_g(i)^T over rows r0..r0+15 and columns n0..n0+7 of W's
// input side: D bf16 [NB][R][lda] over the depth kc (W's output channels),
// W bf16 [g][n][m] (pitch ldw, kc rows a grade).
template <class A>
__device__ __forceinline__ void frag_linear_t(float (&acc)[A::NB][4],
                                              const bf16* d, int lda,
                                              const bf16* w, int ldw, int kc,
                                              int r0, int n0, int lane) {
  constexpr int NB = A::NB, NG = A::NG;
  for (int ks = 0; ks < kc; ks += 16) {
    uint32_t b[NG][2];
#pragma unroll
    for (int g = 0; g < NG; ++g)
      ldsm2_t(b[g], w + (size_t)(g * kc + ks + (lane & 15)) * ldw + n0);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      uint32_t a[4];
      ldsm4(a, d + (size_t)(i * TROWS + r0 + (lane & 15)) * lda + ks +
                   (lane >> 4) * 8);
      mma_bf16_s(acc[i], a, b[grade<A>(i)]);
    }
  }
}

// Fragment position q of this lane: (row, column) offsets in the m16 x n8
// tile.
__device__ __forceinline__ int frag_row(int lane, int q) {
  return (lane >> 2) + 8 * (q >> 1);
}
__device__ __forceinline__ int frag_col(int lane, int q) {
  return 2 * (lane & 3) + (q & 1);
}

template <class A>
__device__ __forceinline__ void store_frag_f32(const float (&acc)[A::NB][4],
                                               float* tile, int fp, int r0,
                                               int n0, int lane) {
#pragma unroll
  for (int i = 0; i < A::NB; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* p = tile + (size_t)(i * TROWS + r0 + (lane >> 2) + 8 * h) * fp +
                 n0 + 2 * (lane & 3);
      *reinterpret_cast<float2*>(p) = make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
    }
}

// MVSiLU of a (row, channel) from its linear output y (bias added here):
// the gate inputs inv and the gates s, per grade.
template <class A>
__device__ __forceinline__ void silu_gates(const float (&yv)[A::NB],
                                           const TParams& s,
                                           const Tabs<A>& tb, int n, int c,
                                           float (&inv)[A::NG],
                                           float (&sg)[A::NG]) {
#pragma unroll
  for (int g = 0; g < A::NG; ++g) inv[g] = 0.f;
  inv[0] = rnd<true>(yv[0]);
#pragma unroll
  for (int i = 1; i < A::NB; ++i)
    inv[grade<A>(i)] += rnd<true>(yv[i] * yv[i] * tb.bc[i]);
#pragma unroll
  for (int g = 0; g < A::NG; ++g) {
    const float gate = s.ra[g * c + n] * inv[g] + s.sb[g * c + n];
    sg[g] = 1.f / (1.f + expf(-gate));
  }
}

// Fragment position q's value of a thread's accumulator (one of four).
__device__ __forceinline__ float pick4(const float (&v)[4], int q) {
  return q == 0 ? v[0] : q == 1 ? v[1] : q == 2 ? v[2] : v[3];
}

// The fragment positions an epilogue takes: all four, or the two of its
// row half where two warps share the n8 tile.  The loop over them is kept
// rolled: the kernels' code is large enough that its size costs time.
__device__ __forceinline__ int q_first(const TileGeom& t, int half) {
  return t.ns == 2 ? 2 * half : 0;
}
__device__ __forceinline__ int q_end(const TileGeom& t, int half) {
  return t.ns == 2 ? 2 * half + 2 : 4;
}

// F1's epilogue: z = MVSiLU(y + b1) into the z tile, zero past the step's
// rows and the channels.
template <class A>
__device__ __forceinline__ void frag_silu_fwd(const float (&y)[A::NB][4],
                                              const TParams& s,
                                              const Tabs<A>& tb,
                                              const TileBufs& b,
                                              const TileGeom& t, int r0,
                                              int n0, int half, int nrow,
                                              int lane) {
  constexpr int NB = A::NB, NG = A::NG;
  const int c = t.c;
#pragma unroll 1
  for (int q = q_first(t, half); q < q_end(t, half); ++q) {
    const int r = r0 + frag_row(lane, q), n = n0 + frag_col(lane, q);
    const bool ok = r < nrow && n < c;
    const int nn = n < c ? n : c - 1;
    float yv[NB], inv[NG], sg[NG];
#pragma unroll
    for (int i = 0; i < NB; ++i) yv[i] = pick4(y[i], q);
    yv[0] += s.b1[nn];
    silu_gates<A>(yv, s, tb, nn, c, inv, sg);
#pragma unroll
    for (int i = 0; i < NB; ++i)
      b.z[(size_t)(i * TROWS + r) * t.ldc + n] =
          __float2bfloat16_rn(ok ? sg[grade<A>(i)] * yv[i] : 0.f);
  }
}

// B2's epilogue: MVSiLU's backward from d(z), the gate parameters'
// gradients into fa, d(y) into the d(y) tile (zero past the rows and
// channels).
template <class A>
__device__ __forceinline__ void frag_silu_bwd(const float (&y)[A::NB][4],
                                              const float (&dz)[A::NB][4],
                                              const TParams& s,
                                              const Tabs<A>& tb,
                                              const TileBufs& b,
                                              const TileGeom& t, int r0,
                                              int n0, int half, int nrow,
                                              int lane, FragAcc<A>& fa) {
  constexpr int NB = A::NB, NG = A::NG;
  const int c = t.c;
#pragma unroll 1
  for (int q = q_first(t, half); q < q_end(t, half); ++q) {
    const int r = r0 + frag_row(lane, q), n = n0 + frag_col(lane, q);
    const bool ok = r < nrow && n < c;
    const int nn = n < c ? n : c - 1;
    // the thread's accumulators of channel n: e = q & 1, kept as selects
    const float w0 = ok && !(q & 1) ? 1.f : 0.f, w1 = ok && (q & 1) ? 1.f : 0.f;
    float yv[NB], inv[NG], sg[NG];
#pragma unroll
    for (int i = 0; i < NB; ++i) yv[i] = pick4(y[i], q);
    yv[0] += s.b1[nn];
    silu_gates<A>(yv, s, tb, nn, c, inv, sg);
    float dy[NB], dgs[NG], dgr[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) { dgs[g] = 0.f; dgr[g] = 0.f; }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const float sv = sg[grade<A>(i)], dzv = pick4(dz[i], q);
      dy[i] = dzv * sv;
      const float dgate = dzv * yv[i] * sv * (1.f - sv);
      dgs[grade<A>(i)] += dgate;
      dgr[grade<A>(i)] += rnd<true>(dgate);
    }
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      fa.sb[0][g] = fmaf(w0, dgs[g], fa.sb[0][g]);
      fa.sb[1][g] = fmaf(w1, dgs[g], fa.sb[1][g]);
      const float da = inv[g] * dgr[g];
      fa.sa[0][g] = fmaf(w0, da, fa.sa[0][g]);
      fa.sa[1][g] = fmaf(w1, da, fa.sa[1][g]);
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const float dv = s.ra[grade<A>(i) * c + nn] * dgr[grade<A>(i)];
      dy[i] += (i == 0) ? dv : 2.f * tb.bc[i] * yv[i] * dv;
    }
    fa.b1[0] = fmaf(w0, dy[0], fa.b1[0]);
    fa.b1[1] = fmaf(w1, dy[0], fa.b1[1]);
#pragma unroll
    for (int i = 0; i < NB; ++i)
      b.dy[(size_t)(i * TROWS + r) * t.ldc + n] =
          __float2bfloat16_rn(ok ? dy[i] : 0.f);
  }
}

// The weight-gradient tiles' descriptors, built once per launch from the
// tiles' fixed places: for tile q, {shared address of its A operand (x or
// z at its grade's first blade, row 0, its m16 column in the x tile's
// chunk or in z), of its B operand (d(y), d(yr) or d(first), its n8
// column), its grade's blade count, the chunk of x that holds its m16
// column for dW1 (A in x) or -1 (A in z)}.
template <class A>
__device__ inline void build_wdesc(const TileBufs& b, const TileGeom& t,
                                   const bf16* x) {
  const int mtin = t.kin / 16, mtc = t.kc / 16, nt = t.nt;
  const int n1 = A::NG * mtin * nt, n2 = A::NG * mtc * nt;
  const int tid = threadIdx.x + 32 * threadIdx.y;
  for (int q = tid; q < n1 + 2 * n2; q += THREADS) {
    int which, mtiles, rem;
    if (q < n1) { which = 0; mtiles = mtin; rem = q; }
    else if (q < n1 + n2) { which = 1; mtiles = mtc; rem = q - n1; }
    else { which = 2; mtiles = mtc; rem = q - n1 - n2; }
    const int g = rem / (mtiles * nt), mtile = (rem / nt) % mtiles,
              ntile = rem % nt;
    int first = A::NB, count = 0;
    for (int i = A::NB - 1; i >= 0; --i)
      if (grade<A>(i) == g) { first = i; ++count; }
    const int chunk = which == 0 ? 16 * mtile / t.kch : -1;
    const bf16* sa =
        which == 0
            ? x + (size_t)first * TROWS * t.ldb + 16 * mtile - chunk * t.kch
            : b.z + (size_t)first * TROWS * t.ldc + 16 * mtile;
    const bf16* sb = which == 0 ? b.dy : which == 1 ? b.dr : b.df;
    b.wd[q] = make_int4(
        (int)__cvta_generic_to_shared(sa),
        (int)__cvta_generic_to_shared(sb + (size_t)first * TROWS * t.ldc +
                                      8 * ntile),
        count, chunk);
  }
}

// B3: the weight gradients of this step into the warp's register tiles:
// the dW1 tiles of x's chunk `chunk` (the one in the x tile), and the
// dWr and dWL tiles where with_z (all of them unless CHUNKED).
template <class A, int MAXT, bool CHUNKED>
__device__ __forceinline__ void frag_wgrads(float (&wacc)[MAXT][4],
                                            const TileBufs& b,
                                            const TileGeom& t, int chunk,
                                            bool with_z, int warp, int lane) {
  const int total = wgrad_tiles<A>(t);
  // lane parts of the ldmatrix addresses (bytes): A transposed, rows 0-15
  // of a blade's tile and columns + 8; B transposed, rows 0-15
  const int arow = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int acol = ((lane >> 3) & 1) * 16;
  const unsigned a_x = 2 * arow * t.ldb + acol, a_z = 2 * arow * t.ldc + acol;
  const unsigned b_l = 2 * (lane & 15) * t.ldc;
  const unsigned s_x = 2 * TROWS * t.ldb, s_c = 2 * TROWS * t.ldc;
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
    const int q = warp + TWARPS * j;
    if (q < total) {
      const int4 d = b.wd[q];
      const bool zt = d.w < 0;
      if (CHUNKED && (zt ? !with_z : d.w != chunk)) continue;
      unsigned pa = (unsigned)d.x + (zt ? a_z : a_x);
      unsigned pb = (unsigned)d.y + b_l;
      const unsigned sa = zt ? s_c : s_x;
      for (int k = 0; k < d.z; ++k, pa += sa, pb += s_c) {
        uint32_t a[4], bb[2];
        ldsm4_t_s(a, pa);
        ldsm2_t_s(bb, pb);
        mma_bf16_s(wacc[j], a, bb);
      }
    }
  }
}

// Hands each weight-gradient entry this thread owns to
// out(which, m, n, g, value): which 0 is W1 (m < cin), 1 Wr, 2 WL (m < c).
template <class A, int MAXT, class Out>
__device__ __forceinline__ void write_wgrads(const float (&wacc)[MAXT][4],
                                             const TileGeom& t, int warp,
                                             int lane, Out out) {
  const int mtin = t.kin / 16, mtc = t.kc / 16, nt = t.nt;
  const int n1 = A::NG * mtin * nt, n2 = A::NG * mtc * nt;
  const int total = n1 + 2 * n2;
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
    const int q = warp + TWARPS * j;
    if (q >= total) continue;
    int which, mtiles, rem;
    if (q < n1) { which = 0; mtiles = mtin; rem = q; }
    else if (q < n1 + n2) { which = 1; mtiles = mtc; rem = q - n1; }
    else { which = 2; mtiles = mtc; rem = q - n1 - n2; }
    const int g = rem / (mtiles * nt), mtile = (rem / nt) % mtiles,
              ntile = rem % nt;
    const int mmax = which == 0 ? t.cin : t.c;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int m = 16 * mtile + frag_row(lane, p);
      const int n = 8 * ntile + frag_col(lane, p);
      if (m < mmax && n < t.c) out(which, m, n, g, wacc[j][p]);
    }
  }
}

// B4: dx = d(y) W1^T.  A warp takes (n8 tile of input channels) tasks; a
// thread ends with every blade of its four (row, input channel) positions
// and hands each to sink(r, m, v[NB]) for rows < nrow and m < cin.  Where
// ORDERED, the warp hands them over row by row in ascending order, behind
// a __syncwarp each, so that a sink may add rows of one target into one
// place in a fixed order (an input channel is one warp's).
template <class A, bool ORDERED, class Sink>
__device__ __forceinline__ void frag_dx(const TParams& s, const TileBufs& b,
                                        const TileGeom& t, int nrow,
                                        int warp, int lane, Sink sink) {
  constexpr int NB = A::NB;
  for (int task = warp; task < t.ntm; task += TWARPS) {
    const int m0 = 8 * task;
    float acc[NB][4];
    zero_frag<A>(acc);
    frag_linear_t<A>(acc, b.dy, t.ldc, s.w1, t.ldx, t.kc, 0, m0, lane);
    if constexpr (ORDERED) {
      // row r is in lanes 4 (r % 8) .. + 3, at positions 2 (r / 8) + 0, 1
#pragma unroll 1
      for (int r = 0; r < nrow; ++r) {
        if ((lane >> 2) == (r & 7)) {
#pragma unroll 1
          for (int q = 2 * (r >> 3); q < 2 * (r >> 3) + 2; ++q) {
            const int m = m0 + frag_col(lane, q);
            if (m < t.cin) {
              float v[NB];
#pragma unroll
              for (int i = 0; i < NB; ++i) v[i] = pick4(acc[i], q);
              sink(r, m, v);
            }
          }
        }
        __syncwarp();
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = frag_row(lane, q), m = m0 + frag_col(lane, q);
        if (r < nrow && m < t.cin) {
          float v[NB];
#pragma unroll
          for (int i = 0; i < NB; ++i) v[i] = acc[i][q];
          sink(r, m, v);
        }
      }
    }
  }
}

// ------------------------------------------- (row, channel) phases, F3/B1

// The block's forward after the channel mixing for one (row, channel),
// from the yr, first and z tiles.
template <class A>
struct Post {
  float yr[A::NB], zr[A::NB], yn[A::NB], ynr[A::NB], o[A::NB];
  float qg[A::NG], s1g[A::NG], nr[A::NG], rden[A::NG];   // 1 / den
  float qc, s1c, nc;
};

template <class A>
__device__ __forceinline__ void post_forward(Post<A>& f, const TParams& s,
                                             const Tabs<A>& tb,
                                             const TileBufs& b,
                                             const TileGeom& t, int r,
                                             int n) {
  constexpr int NB = A::NB, NG = A::NG;
  const int c = t.c;
  float first[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const size_t k = (size_t)(i * TROWS + r) * t.fp + n;
    f.yr[i] = b.yr[k];
    first[i] = b.ff[k];
    f.zr[i] = __bfloat162float(b.z[(size_t)(i * TROWS + r) * t.ldc + n]);
  }
  first[0] += s.bl[n];
#pragma unroll
  for (int g = 0; g < NG; ++g) f.qg[g] = 0.f;
#pragma unroll
  for (int i = 0; i < NB; ++i)
    f.qg[grade<A>(i)] += rnd<true>(f.yr[i] * f.yr[i] * tb.bc[i]);
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    f.s1g[g] = sqrtf(f.qg[g] * f.qg[g] + 1e-16f);
    f.nr[g] = sqrtf(f.s1g[g]);
    f.rden[g] = 1.f / (s.nsig[g * c + n] * (f.nr[g] - 1.f) + 1.f + EPS);
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    f.yn[i] = f.yr[i] * f.rden[grade<A>(i)];
    f.ynr[i] = rnd<true>(f.yn[i]);
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    float gp = 0.f;
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const int i = i_of<A>(j, k);
      const float cw =
          tb.sign[j * NB + k] *
          s.gw[A::path_id(grade<A>(i), grade<A>(j), grade<A>(k)) * c + n];
      gp += cw * f.zr[i] * f.ynr[k];
    }
    f.o[j] = (first[j] + gp) * SQRT2_INV;
  }
  f.qc = 0.f;
#pragma unroll
  for (int i = 0; i < NB; ++i) f.qc += rnd<true>(f.o[i] * f.o[i] * tb.bc[i]);
  f.s1c = sqrtf(f.qc * f.qc + 1e-16f);
  f.nc = sqrtf(f.s1c);
}

// The backward after the channel mixing for one (row, channel), from its
// forward f, output cotangent g and the row's mean and d(mean): d(first)
// and d(yr) into their bf16 tiles, the product's d(z) over the yr tile,
// the per-channel gradients into pa.
template <class A>
__device__ __forceinline__ void post_backward(const Post<A>& f,
                                              const float (&g)[A::NB],
                                              float mean, float dm,
                                              const TParams& s,
                                              const Tabs<A>& tb,
                                              const TileBufs& b,
                                              const TileGeom& t, int r,
                                              int n, PairAcc<A>& pa) {
  constexpr int NB = A::NB, NG = A::NG;
  const int c = t.c;
  const size_t kb = (size_t)r * t.ldc + n;
  const float rmean = 1.f / mean, aln = s.aln[n];
  float ta = 0.f;
#pragma unroll
  for (int i = 0; i < NB; ++i) ta += g[i] * f.o[i];
  pa.aln += ta * rmean;
  const float dqc = rnd<true>(dm / (float)c * 0.5f * f.qc / (f.s1c * f.nc));
  float dfr[NB], dz[NB], dyn[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const float d_o = aln * g[i] * rmean + dqc * 2.f * tb.bc[i] * f.o[i];
    const float dfg = d_o * SQRT2_INV;
    if (i == 0) pa.bl += dfg;
    dfr[i] = rnd<true>(dfg);
    b.df[(size_t)i * TROWS * t.ldc + kb] = __float2bfloat16_rn(dfr[i]);
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
      const float t1g = t1 * s.gw[q * c + n];
      dz[i] = fmaf(t1g, f.ynr[k], dz[i]);
      dyn[k] = fmaf(t1g, f.zr[i], dyn[k]);
      pa.gw[q] = fmaf(t1 * f.zr[i], f.ynr[k], pa.gw[q]);
    }
  }
  float dden[NG], dyr[NB];
#pragma unroll
  for (int gg = 0; gg < NG; ++gg) dden[gg] = 0.f;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const float rdn = f.rden[grade<A>(i)];
    dyr[i] = dyn[i] * rdn;
    dden[grade<A>(i)] -= dyn[i] * f.yn[i] * rdn;
  }
  float dqg[NG];
#pragma unroll
  for (int gg = 0; gg < NG; ++gg) {
    pa.ns[gg] += dden[gg] * (f.nr[gg] - 1.f);
    const float dnr = dden[gg] * s.nsig[gg * c + n];
    dqg[gg] = rnd<true>(dnr * 0.5f * f.qg[gg] / (f.s1g[gg] * f.nr[gg]));
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    dyr[i] += dqg[grade<A>(i)] * 2.f * tb.bc[i] * f.yr[i];
    b.dr[(size_t)i * TROWS * t.ldc + kb] = __float2bfloat16_rn(dyr[i]);
    b.yr[(size_t)(i * TROWS + r) * t.fp + n] = dz[i];
  }
}

// The row phase, the block's layer norm and what sits between the channel
// mixings: a warp takes rows warp, warp + 8, a lane its channel slots
// (lane and lane + 32 at Cl(2)).  For each row the forward after the
// mixing, the row's mean and d(mean) by warp shuffles (a fixed order),
// then, when `backward`, post_backward for each channel, or else the
// block's output aln / mean * o of each (row r, channel n) to
// sink(r, n, v[NB]).  Rows past nrow get zeros (the sink is handed zeros
// for them).  The per-channel gradients are added to the warp's slots in
// b.pacc at the end (one thread a channel).
template <class A, class Sink>
__device__ __forceinline__ void row_phase(const TParams& s, const Tabs<A>& tb,
                                          const TileBufs& b,
                                          const TileGeom& t, int nrow,
                                          bool backward, Sink sink, int warp,
                                          int lane) {
  constexpr int NB = A::NB, S = A::SLOTS;
  const int c = t.c;
  PairAcc<A> pa[S];
#pragma unroll
  for (int u = 0; u < S; ++u) zero_pair_acc<A>(pa[u]);
  for (int r = warp; r < TROWS; r += TWARPS) {
    if (r >= nrow) {
      float zero[NB];
#pragma unroll
      for (int i = 0; i < NB; ++i) zero[i] = 0.f;
      for (int n = lane; n < c; n += 32) {
        if (backward) {
#pragma unroll
          for (int i = 0; i < NB; ++i) {
            const size_t k = (size_t)(i * TROWS + r) * t.ldc + n;
            b.df[k] = __float2bfloat16_rn(0.f);
            b.dr[k] = __float2bfloat16_rn(0.f);
          }
        } else {
          sink(r, n, zero);
        }
      }
      continue;
    }
    Post<A> f[S];
    float g[S][NB];
    float tot = 0.f, tt = 0.f;
#pragma unroll
    for (int u = 0; u < S; ++u) {
      const int n = slot_channel(lane, u, c);
      const bool act = lane + 32 * u < c;
      post_forward<A>(f[u], s, tb, b, t, r, n);
      if (act) tot += f[u].nc;
      if (backward) {
        load_go<A>(b, t, r, n, g[u]);
        if (act)
#pragma unroll
          for (int i = 0; i < NB; ++i) tt += g[u][i] * s.aln[n] * f[u].o[i];
      }
    }
    const float mean = warp_sum(tot) / (float)c + EPS;
    if (backward) {
      const float dm = -warp_sum(tt) / (mean * mean);
#pragma unroll
      for (int u = 0; u < S; ++u) {
        const int n = lane + 32 * u;
        if (n < c) post_backward<A>(f[u], g[u], mean, dm, s, tb, b, t, r, n,
                                    pa[u]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < S; ++u) {
        const int n = lane + 32 * u;
        if (n >= c) continue;
        const float scale = s.aln[n] / mean;
        float v[NB];
#pragma unroll
        for (int i = 0; i < NB; ++i) v[i] = scale * f[u].o[i];
        sink(r, n, v);
      }
    }
  }
  if (!backward) return;
#pragma unroll
  for (int u = 0; u < S; ++u) {
    const int n = lane + 32 * u;
    if (n >= c) continue;
    float* su = b.pacc + (warp * c + n) * pstride<A>();
    su[0] += pa[u].aln;
    su[1] += pa[u].bl;
#pragma unroll
    for (int q = 0; q < A::NP; ++q) su[2 + q] += pa[u].gw[q];
#pragma unroll
    for (int gg = 0; gg < A::NG; ++gg) su[2 + A::NP + gg] += pa[u].ns[gg];
  }
}

// A row phase's sink that writes a block's output rounded to bf16 into a
// tile [NB][R][ld] (the next block's input tile), zeros included: K4's
// and K5's sweep 0.
template <int NB>
struct Bf16TileSink {
  bf16* out;
  int ld;
  __device__ __forceinline__ void operator()(int r, int n,
                                             const float (&v)[NB]) const {
#pragma unroll
    for (int i = 0; i < NB; ++i)
      out[(size_t)(i * TROWS + r) * ld + n] = __float2bfloat16_rn(v[i]);
  }
};

// F2: yr = z Wr and first = z WL into their fp32 tiles; where two warps
// share an n8 tile, each takes one of the two products.
template <class A>
__device__ __forceinline__ void frag_right_left(const TParams& s,
                                                const TileBufs& b,
                                                const TileGeom& t, bool fw,
                                                int n0, int half, int lane) {
  if (!fw) return;
  float y[A::NB][4];
  if (t.ns == 1 || half == 0) {
    zero_frag<A>(y);
    frag_linear<A>(y, b.z, t.ldc, t.kc, s.wr, t.ldc, t.kc, 0, n0, lane);
    store_frag_f32<A>(y, b.yr, t.fp, 0, n0, lane);
  }
  if (t.ns == 1 || half == 1) {
    zero_frag<A>(y);
    frag_linear<A>(y, b.z, t.ldc, t.kc, s.wl, t.ldc, t.kc, 0, n0, lane);
    store_frag_f32<A>(y, b.ff, t.fp, 0, n0, lane);
  }
}

// ------------------------------------------------------------ one step

// y = X W1 for the fw warps from the x tile ([NB][R][ldb]), whole, or
// where CHUNKED over its chunks: chunk 0 is in the tile on entry unless
// `reload`; load(ch) (all threads, between barriers) brings chunk ch.
// Leaves the last chunk in the tile.
template <class A, bool CHUNKED, class Load>
__device__ __forceinline__ void x_linear(float (&y)[A::NB][4],
                                         const TParams& s, const bf16* x,
                                         const TileGeom& t, bool fw, int n0,
                                         int lane, bool reload, Load load) {
  zero_frag<A>(y);
  if constexpr (!CHUNKED) {
    if (fw) frag_linear<A>(y, x, t.ldb, t.kin, s.w1, t.ldx, t.kc, 0, n0,
                           lane);
  } else {
    for (int ch = 0; ch < t.nch; ++ch) {
      if (ch > 0 || (reload && t.nch > 1)) {
        __syncthreads();
        load(ch);
        __syncthreads();
      }
      const int k0 = ch * t.kch;
      const int kw = t.kin - k0 < t.kch ? t.kin - k0 : t.kch;
      if (fw) frag_linear<A>(y, x, t.ldb, kw, s.w1 + k0, t.ldx, t.kc, 0, n0,
                             lane);
    }
  }
}

// F1, F2 and the row phase of a block's forward for one step of nrow rows
// from its input tile x ([NB][R][ldb] bf16: whole, or where CHUNKED chunk
// 0 of it, and load(ch) brings chunk ch, as in x_linear), its output to
// sink(r, n, v[NB]) (see row_phase): K2's step, and K4's and K5's block
// forwards (whole tiles, a bf16 tile sink).  Starts after a barrier behind
// x; ends behind one.
template <class A, bool CHUNKED, class Sink, class Load>
__device__ __forceinline__ void tile_block_forward(
    const TParams& s, const Tabs<A>& tb, const bf16* x, const TileBufs& b,
    const TileGeom& t, int nrow, Sink sink, Load load, int warp, int lane) {
  constexpr int NB = A::NB;
  const bool fw = warp < t.nt * t.ns;
  const int n0 = 8 * (warp % t.nt), half = warp / t.nt;
  {   // F1
    float y[NB][4];
    x_linear<A, CHUNKED>(y, s, x, t, fw, n0, lane, false, load);
    if (fw) frag_silu_fwd<A>(y, s, tb, b, t, 0, n0, half, nrow, lane);
  }
  __syncthreads();
  frag_right_left<A>(s, b, t, fw, n0, half, lane);   // F2
  __syncthreads();
  row_phase<A>(s, tb, b, t, nrow, false, sink, warp, lane);
  __syncthreads();
}

// The whole backward of a block for one step of nrow rows from its input
// tile x ([NB][R][ldb] bf16: whole, or where CHUNKED chunk 0 of it, and
// load(ch) brings chunk ch) and its output cotangent (the rows of b.gor):
// dx to sink(r, m, v[NB]) (in row order where ORDERED, see frag_dx), the
// gradients into b.pacc, fa and wacc.  Starts after a barrier behind
// both; ends before one.
template <class A, int MAXT, bool ORDERED, bool CHUNKED, class Sink,
          class Load>
__device__ __forceinline__ void tile_block_backward(
    const TParams& s, const Tabs<A>& tb, const bf16* x, const TileBufs& b,
    const TileGeom& t, int nrow, Sink sink, Load load, FragAcc<A>& fa,
    float (&wacc)[MAXT][4], int warp, int lane) {
  constexpr int NB = A::NB;
  const bool fw = warp < t.nt * t.ns;
  const int n0 = 8 * (warp % t.nt), half = warp / t.nt;
  {   // F1
    float y[NB][4];
    x_linear<A, CHUNKED>(y, s, x, t, fw, n0, lane, false, load);
    if (fw) frag_silu_fwd<A>(y, s, tb, b, t, 0, n0, half, nrow, lane);
  }
  __syncthreads();
  frag_right_left<A>(s, b, t, fw, n0, half, lane);   // F2
  __syncthreads();
  row_phase<A>(s, tb, b, t, nrow, true,
               [](int, int, const float (&)[NB]) {}, warp, lane);
  __syncthreads();
  {   // B2
    float y[NB][4];
    x_linear<A, CHUNKED>(y, s, x, t, fw, n0, lane, true, load);
    if (fw) {
      float dz[NB][4];
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 v = *reinterpret_cast<const float2*>(
              b.yr + (size_t)(i * TROWS + (lane >> 2) + 8 * h) * t.fp + n0 +
              2 * (lane & 3));
          dz[i][2 * h] = v.x;
          dz[i][2 * h + 1] = v.y;
        }
      frag_linear_t<A>(dz, b.df, t.ldc, s.wl, t.ldc, t.kc, 0, n0, lane);
      frag_linear_t<A>(dz, b.dr, t.ldc, s.wr, t.ldc, t.kc, 0, n0, lane);
      frag_silu_bwd<A>(y, dz, s, tb, b, t, 0, n0, half, nrow, lane, fa);
    }
  }
  // B3, where CHUNKED the chunks of x last to first (the last is in the
  // tile)
  __syncthreads();
  if constexpr (!CHUNKED) {
    frag_wgrads<A, MAXT, false>(wacc, b, t, 0, true, warp, lane);
  } else {
    for (int k = 0; k < t.nch; ++k) {
      const int ch = t.nch - 1 - k;
      if (k > 0) {
        __syncthreads();
        load(ch);
        __syncthreads();
      }
      frag_wgrads<A, MAXT, true>(wacc, b, t, ch, k == 0, warp, lane);
    }
  }
  frag_dx<A, ORDERED>(s, b, t, nrow, warp, lane, sink);   // B4
}

// Adds every thread's per-channel sums into b.loc ([Loc::N][C], zeroed
// here), in a fixed order: MVSiLU's summed over a warp's row lanes by a
// butterfly, then warp by warp; the row phase's slots warp by warp.  All
// threads of the CTA call it.
template <class A>
__device__ void accs_to_loc(FragAcc<A> fa, const TileBufs& b,
                            const TileGeom& t, int warp, int lane) {
  using L = Loc<A>;
  constexpr int NG = A::NG, S = A::SLOTS;
  const int tid = threadIdx.x + 32 * threadIdx.y, c = t.c;
  __syncthreads();
  for (int e = tid; e < L::N * c; e += THREADS) b.loc[e] = 0.f;
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      fa.b1[e] += __shfl_xor_sync(0xffffffffu, fa.b1[e], off);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        fa.sa[e][g] += __shfl_xor_sync(0xffffffffu, fa.sa[e][g], off);
        fa.sb[e][g] += __shfl_xor_sync(0xffffffffu, fa.sb[e][g], off);
      }
    }
  for (int w = 0; w < TWARPS; ++w) {
    __syncthreads();
    if (warp != w) continue;
    if (w < t.nt * t.ns && lane < 4) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * (w % t.nt) + 2 * lane + e;
        if (n >= c) continue;
        b.loc[L::B1 * c + n] += fa.b1[e];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          b.loc[(L::SA + g) * c + n] += fa.sa[e][g];
          b.loc[(L::SB + g) * c + n] += fa.sb[e][g];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < S; ++u) {
      const int n = lane + 32 * u;
      if (n >= c) continue;
      const float* su = b.pacc + (w * c + n) * pstride<A>();
#pragma unroll
      for (int q = 0; q < A::NP; ++q) b.loc[(L::GW + q) * c + n] += su[2 + q];
#pragma unroll
      for (int g = 0; g < NG; ++g) b.loc[(L::NS + g) * c + n] += su[2 + A::NP + g];
      b.loc[L::BL * c + n] += su[1];
      b.loc[L::ALN * c + n] += su[0];
    }
  }
  __syncthreads();
}

}  // namespace
