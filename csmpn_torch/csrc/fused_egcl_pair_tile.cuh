// K4p and K5p in fast mode: the EGCL edge side of the pair form on the row
// tiles of K2p (cemlp_pair_fwd_tile.cuh) and K3p (cemlp_pair_tile.cuh),
// templated on the algebra; fused_egcl_pair.cuh launches them for a
// fast-mode call at Cl(5,0) and Cl(4,0) and keeps its row kernels for
// exact mode.  Four tile sweeps over all edge rows, each a launch of one
// template (SWEEP), the steps of a CTA strided over the grid as in K2p and
// K3p, and two window-sum kernels:
//   0  block 1's forward (K2p's step, a warp a row) on the message tile
//      x = [h[dst] - hj, attr], built in the x tile from an indexed load of
//      the target rows (a masked row is zero); its output rows, block 2's
//      input rounded to bf16, to the scratch x2s ([E][NB][C]);
//   3  block 2's forward from x2s; its output rows (the messages), rounded
//      to bf16, over x2s, each row over its own input;
//   then pair_msg_sum_kernel: a CTA a window of wn targets, a thread an
//      element of the message rows, each target's unmasked rows added in
//      edge order into an fp32 sum, the window written once (an empty
//      window writes 0);
//   1  block 2's backward (K3p's step) from x2s and d(agg) gathered at each
//      row's target, rounded to bf16 (a masked row: a zero cotangent); its
//      dx rows, block 1's output cotangent, to the scratch dx2 (fp32, rows
//      of max(C, Cm + Ca) x NB floats);
//   2  block 1's backward on the rebuilt message tile from dx2; its dx rows
//      (the message cotangent dmsg) over dx2, each row over its own
//      cotangent;
//   then pair_dmsg_sum_kernel: a CTA a window, a thread an element of the
//      dmsg rows, each target's unmasked rows added in edge order into its
//      d(h) row, written once; dhj = -dmsg and dattr written as bf16 for
//      every row (masked rows exact zeros).
// K4p is sweeps 0 and 3 and the message sum (three launches); K5p sweeps
// 0, 1 and 2, the dmsg sum and the reduce of the partials (five).  A tile
// sweep has no window to fill, so its CTAs take as many steps each and no
// step is cut short by a window's end; sweeps that walked the windows and
// summed in shared memory ran slower on the H100 (PERF.md).  The
// sums cost a write and a read of the scratch rows instead.
//
// Precision: the rounding points of the plain fast version: h, hj and attr
// streamed as bf16; block 1's input (the message tile), block 2's input
// (x2s), each message row and d(agg) rounded to bf16; each pair term
// (z_i yn_k) w rounded as K2p and K3p round it; dhj and dattr written as
// bf16; fp32 accumulation.  Only the order of fp32 sums differs.
//
// Determinism: as K3p, every gradient sum has one owner; sweeps 1 and 2
// each write their block's slice of the CTA's partial vector (K5's layout,
// block_part_floats) once, and reduce_partials_kernel adds the CTAs'
// vectors in CTA order; every node row's sum has one owner thread, which
// adds its rows in edge order.  No atomics: bitwise repeatable.
#pragma once

#include <type_traits>

#include "cemlp_pair_fwd_tile.cuh"
#include "fused_mp.cuh"

namespace {

// rows of the per-channel gradient block of K5's partial layout: b1,
// silu.a (NG), silu.b (NG), gp.weight (NP), d sigmoid(normalization.a)
// (NG), bL, ln.a
template <class A>
__host__ __device__ constexpr int loc_out() {
  return 1 + 3 * A::NG + A::NP + 2;
}

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// One block's part of a CTA's partial gradient vector, K5's layout:
//   aw1 [(m*NG+g)*C + n] (Cin) | awr (C) | awl (C) | loc [LOC_OUT][C]
// with loc rows b1, silu.a, silu.b, gp.weight, d sigmoid(norm.a), bL,
// ln.a.  The host maps the summed vector onto the flax shapes.
template <class A>
__host__ __device__ inline int64_t block_part_floats(int cin, int c) {
  return (int64_t)(cin + 2 * c) * A::NG * c + (int64_t)loc_out<A>() * c;
}

// One CTA's slice of the backward's scratch: block 1's part, block 2's,
// then the exact row kernel's channel-mixing accumulators of the sweep's
// block, padded to C4 (the tile sweeps leave them unused).
template <class A>
__host__ __device__ inline int64_t slice_floats(int cin1, int c) {
  return block_part_floats<A>(cin1, c) + block_part_floats<A>(c, c) +
         (int64_t)(imax(cin1, c) + 2 * c) * A::NG * pad4(c);
}

// The step of sweep SWEEP: K2p's (a warp a row) for the forwards (0, 3),
// K3p's for the backwards (1, 2).
template <class A, int SWEEP>
using PSweep =
    std::conditional_t<SWEEP == 0 || SWEEP == 3, PFwd<A>, PTile<A>>;

// A sweep's shared memory: its block's layout (K2p's or K3p's), then each
// row's target (sweeps 1-3; [R] int, -1 for none).  Where the layout does
// not fit, the bf16 tiles' rows go unpadded: so the forward step (16 rows
// at Cl(4)) takes every input width the exact kernels take (at C = 4, up
// to 339 channels), its ldmatrix rows then sharing banks.
template <class A, int SWEEP>
__host__ __device__ inline PLayout pair_sweep_layout(int cm, int ca, int c,
                                                     size_t* rowt = nullptr) {
  using P = PSweep<A, SWEEP>;
  const int cin = SWEEP == 1 || SWEEP == 3 ? c : cm + ca;
  const bool fwd = SWEEP == 0 || SWEEP == 3;
  PLayout L = pair_tile_layout<A, P>(cin, c, fwd);
  if (L.total > kMaxSmem) L = pair_tile_layout<A, P>(cin, c, fwd, 0);
  if (rowt != nullptr) *rowt = L.total;
  if (SWEEP != 0) L.total += pt_al16(4 * (size_t)P::R);
  return L;
}

template <class A, int SWEEP>
size_t pair_sweep_bytes(int cm, int ca, int c) {
  return pair_sweep_layout<A, SWEEP>(cm, ca, c).total;
}

// Floats of a row of dx2: block 2's dx, then block 1's (the message
// cotangent) over it.
__host__ __device__ inline int dx2_pitch(int nb, int cm, int ca, int c) {
  return nb * imax(c, cm + ca);
}

// First edge in [lo, hi) whose target is >= v (dst ascending).
__device__ __forceinline__ int64_t first_edge(const int* __restrict__ dst,
                                              int64_t lo, int64_t hi, int v) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;
    if (dst[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The first edge of each target of window w into off[0 .. nn] (off[nn] the
// window's end); returns nn, the window's targets (fewer past the last
// node).  All threads of the CTA call it; ends behind a barrier.
__device__ __forceinline__ int window_offsets(const Geom& gm,
                                              const int64_t* __restrict__ bounds,
                                              const int* __restrict__ dst,
                                              int w, int64_t* off) {
  const int base = w * gm.wn;
  const int nn = gm.n_nodes - base < gm.wn ? gm.n_nodes - base : gm.wn;
  const int64_t e0 = bounds[w], e1 = bounds[w + 1];
  for (int t = threadIdx.x; t <= nn; t += blockDim.x)
    off[t] = t == 0 ? e0 : t == nn ? e1 : first_edge(dst, e0, e1, base + t);
  __syncthreads();
  return nn;
}

constexpr int SUM_THREADS = 256;

// K4p's window sums: agg[v] = sum of the message rows (bf16 [NB][C] in
// msg) of v's unmasked edges, in edge order, fp32; a CTA a window (of the
// windows w = blockIdx.x, + gridDim.x, ...), a thread an element; the
// window's rows go through shared memory ([wn][C][NB]) to be written in
// the output's layout, once.
template <class A>
__global__ void __launch_bounds__(SUM_THREADS)
pair_msg_sum_kernel(const bf16* __restrict__ msg, const int* __restrict__ dst,
                    const uint8_t* __restrict__ mask,
                    const int64_t* __restrict__ bounds,
                    float* __restrict__ out, Geom gm) {
  constexpr int NB = A::NB;
  extern __shared__ float4 smem4[];
  float* win = reinterpret_cast<float*>(smem4);          // [wn][C][NB]
  const int c = gm.c, per = c * NB;
  int64_t* off = reinterpret_cast<int64_t*>(win + gm.wn * per);
  for (int w = blockIdx.x; w < gm.n_win; w += gridDim.x) {
    const int nn = window_offsets(gm, bounds, dst, w, off);
    for (int e = threadIdx.x; e < per; e += SUM_THREADS) {   // e = j * C + n
      const int j = e / c, n = e % c;
      for (int t = 0; t < nn; ++t) {
        float acc = 0.f;
        for (int64_t row = off[t]; row < off[t + 1]; ++row)
          if (mask == nullptr || mask[row])
            acc += __bfloat162float(msg[row * per + e]);
        win[t * per + n * NB + j] = acc;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nn * per; e += SUM_THREADS)
      out[(int64_t)w * gm.wn * per + e] = win[e];
    __syncthreads();   // the window written before the next one's offsets
  }
}

// K5p's window sums: d(h)[v] = sum of the message cotangent rows (fp32
// [Cm + Ca][NB] in dx2, pitch pd) of v's unmasked edges, in edge order;
// dhj = -dmsg and dattr (bf16) for every row, masked rows exact zeros.  A
// CTA a window, a thread an element.
template <class A>
__global__ void __launch_bounds__(SUM_THREADS)
pair_dmsg_sum_kernel(const float* __restrict__ dmsg,
                     const int* __restrict__ dst,
                     const uint8_t* __restrict__ mask,
                     const int64_t* __restrict__ bounds, float* __restrict__ dh,
                     bf16* __restrict__ dhj, bf16* __restrict__ dattr,
                     Geom gm) {
  constexpr int NB = A::NB;
  extern __shared__ float4 smem4[];
  int64_t* off = reinterpret_cast<int64_t*>(smem4);
  const int mw = gm.cm * NB, aw = gm.ca * NB;
  const int pd = dx2_pitch(NB, gm.cm, gm.ca, gm.c);
  for (int w = blockIdx.x; w < gm.n_win; w += gridDim.x) {
    const int nn = window_offsets(gm, bounds, dst, w, off);
    for (int e = threadIdx.x; e < mw + aw; e += SUM_THREADS) {
      for (int t = 0; t < nn; ++t) {
        float acc = 0.f;
        for (int64_t row = off[t]; row < off[t + 1]; ++row) {
          const bool keep = mask == nullptr || mask[row];
          const float v = keep ? dmsg[row * pd + e] : 0.f;
          if (e < mw) {
            dhj[row * mw + e] = __float2bfloat16_rn(-v);
            acc += v;
          } else {
            dattr[row * aw + (e - mw)] = __float2bfloat16_rn(v);
          }
        }
        if (e < mw) dh[((int64_t)w * gm.wn + t) * mw + e] = acc;
      }
    }
    __syncthreads();   // the offsets used before the next window's
  }
}

// Elements [0, n) moved by the CTA's threads, four loads in flight a
// thread: store(e, load(e)).
template <int THREADS, class Load, class Store>
__device__ __forceinline__ void copy4(int n, Load load, Store store) {
  const int tid = threadIdx.x + 32 * threadIdx.y;
  for (int e0 = tid; e0 < n; e0 += 4 * THREADS) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * THREADS;
      v[u] = e < n ? load(e) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e0 + u * THREADS < n) store(e0 + u * THREADS, v[u]);
  }
}

__device__ __forceinline__ float4 ldg_bf16x4(const bf16* p) {   // 8-byte aligned
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

// The step's message rows x = [h[dst] - hj, attr] (rows row0 .. row0 +
// nrow - 1), rounded to bf16, into the x tile at tile rows r (NB + 1) + i,
// column m, four blades a load; a masked row is zero.
template <class A, class P>
__device__ __forceinline__ void load_msg_pair_x(
    const bf16* __restrict__ h, const bf16* __restrict__ hj,
    const bf16* __restrict__ attr, const int* __restrict__ dst,
    const uint8_t* __restrict__ mask, int64_t row0, int nrow, int cm, int ca,
    const PBufs<A>& b, const PLayout& L) {
  constexpr int NB = A::NB;
  const int per4 = (cm + ca) * NB / 4, mw = cm * NB;
  copy4<P::THREADS>(
      nrow * per4,
      [&](int e) {
        const int r = e / per4, k = 4 * (e % per4);
        const int64_t row = row0 + r;
        if (mask != nullptr && !mask[row]) return make_float4(0.f, 0.f, 0.f, 0.f);
        if (k >= mw) return ldg_bf16x4(attr + row * ca * NB + (k - mw));
        const float4 u = ldg_bf16x4(h + (int64_t)dst[row] * mw + k);
        const float4 v = ldg_bf16x4(hj + row * mw + k);
        return make_float4(u.x - v.x, u.y - v.y, u.z - v.z, u.w - v.w);
      },
      [&](int e, float4 v) {
        const int r = e / per4, k = 4 * (e % per4);
        bf16* d = b.x + (size_t)(r * (NB + 1) + k % NB) * L.ldx + k / NB;
        d[0] = __float2bfloat16_rn(v.x);
        d[L.ldx] = __float2bfloat16_rn(v.y);
        d[2 * L.ldx] = __float2bfloat16_rn(v.z);
        d[3 * L.ldx] = __float2bfloat16_rn(v.w);
      });
}

// The step's rows of x2s ([E][NB][C] bf16) into the x tile at tile rows
// r (NB + 1) + i, column n; four channels a load where C % 4 == 0.  Masked
// rows are zero.
template <class A, class P>
__device__ __forceinline__ void load_x2s_pair(const bf16* __restrict__ x2s,
                                              const uint8_t* __restrict__ mask,
                                              int64_t row0, int nrow, int c,
                                              const PBufs<A>& b,
                                              const PLayout& L) {
  constexpr int NB = A::NB;
  const int per = NB * c;
  auto keep = [&](int r) { return mask == nullptr || mask[row0 + r]; };
  if (c % 4 == 0) {
    const int per4 = per / 4;
    copy4<P::THREADS>(
        nrow * per4,
        [&](int e) {
          const int r = e / per4;
          return keep(r) ? ldg_bf16x4(x2s + (row0 + r) * per + 4 * (e % per4))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        },
        [&](int e, float4 v) {
          const int r = e / per4, k = 4 * (e % per4);
          bf16* d = b.x + (size_t)(r * (NB + 1) + k / c) * L.ldx + k % c;
          const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
          // columns k % c .. + 3 of one tile row (C % 4 == 0), 4-byte aligned
          reinterpret_cast<__nv_bfloat162*>(d)[0] = lo;
          reinterpret_cast<__nv_bfloat162*>(d)[1] = hi;
        });
  } else {
    copy4<P::THREADS>(
        nrow * per,
        [&](int e) {
          const int r = e / per;
          return make_float4(
              keep(r) ? __bfloat162float(x2s[(row0 + r) * per + e % per])
                      : 0.f,
              0.f, 0.f, 0.f);
        },
        [&](int e, float4 v) {
          const int r = e / per, k = e % per;
          b.x[(size_t)(r * (NB + 1) + k / c) * L.ldx + k % c] =
              __float2bfloat16_rn(v.x);
        });
  }
}

// Each row's target into rowt (-1 for a masked row or one past nrow).
template <class P>
__device__ __forceinline__ void row_targets(int* rowt,
                                            const int* __restrict__ dst,
                                            const uint8_t* __restrict__ mask,
                                            int64_t row0, int nrow) {
  const int tid = threadIdx.x + 32 * threadIdx.y;
  if (tid < P::R) {
    const int64_t row = row0 + tid;
    rowt[tid] = tid < nrow && (mask == nullptr || mask[row]) ? dst[row] : -1;
  }
}

// One block's part of the CTA's partial vector (K5's layout) from a
// backward sweep's accumulators: every warp's weight-gradient tiles, the
// per-channel sums of the row phase and of MVSiLU (the step's rows added
// in order) and the path weights.  All threads of the CTA call it, behind a
// barrier.
template <class A, int MAXT, class P = PTile<A>>
__device__ void write_pair_part(float* part, const PLayout& L,
                                const PBufs<A>& b,
                                const float (&wacc)[MAXT][4], int warp,
                                int lane) {
  constexpr int NG = A::NG, NP = A::NP, R = P::R, NL = P::NLOC;
  const int tid = lane + 32 * warp, c = L.c, cin = L.cin;
  const int64_t o1 = (int64_t)cin * NG * c, o2 = o1 + (int64_t)c * NG * c;
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
    const int d = b.wd[warp * 32 + j];
    if (d < 0) continue;
    const int which = d & 3, g = (d >> 2) & 7;
    const int m0 = 16 * ((d >> 5) & 1023), n0 = 8 * (d >> 15);
    const int mmax = which == 0 ? cin : c;
    float* dst = part + (which == 0 ? 0 : which == 1 ? o1 : o2);
#pragma unroll
    for (int p4 = 0; p4 < 4; ++p4) {
      const int m = m0 + pfrag_row(lane, p4), n = n0 + pfrag_col(lane, p4);
      if (m < mmax && n < c) dst[((int64_t)m * NG + g) * c + n] = wacc[j][p4];
    }
  }
  auto rsum = [&](const float* v, int stride) {   // sum over the R rows
    float a = 0.f;
    for (int r = 0; r < R; ++r) a += v[r * stride];
    return a;
  };
  float* loc = part + o2 + (int64_t)c * NG * c;
  for (int e = tid; e < loc_out<A>() * c; e += P::THREADS) {
    const int k = e / c, n = e % c;
    float v;
    if (k == 0) v = rsum(b.sacc + n, c);                          // b1
    else if (k <= NG) v = rsum(b.sacc + k * R * c + n, c);        // silu.a
    else if (k <= 2 * NG) v = rsum(b.sacc + k * R * c + n, c);    // silu.b
    else if (k <= 2 * NG + NP) v = b.gacc[(k - 1 - 2 * NG) * c + n];
    else if (k <= 3 * NG + NP)                        // d sigmoid(norm.a)
      v = rsum(b.loc + (2 + k - 1 - 2 * NG - NP) * c + n, NL * c);
    else if (k == 3 * NG + NP + 1) v = rsum(b.loc + c + n, NL * c);   // bL
    else v = rsum(b.loc + n, NL * c);                              // ln.a
    loc[e] = v;
  }
}

// The CTA's steps of R edge rows, strided over the grid: body(row0, nrow,
// next) with next the first row of the CTA's next step (past the end:
// none).
template <int R, class Body>
__device__ __forceinline__ void walk_steps(int64_t rows, Body body) {
  const int64_t n_steps = (rows + R - 1) / R;
  for (int64_t step = blockIdx.x; step < n_steps; step += gridDim.x) {
    const int64_t row0 = step * R;
    body(row0, rows - row0 < R ? (int)(rows - row0) : R,
         (step + gridDim.x) * R);
  }
}

// The rows [row0, row0 + nrow) of a bf16 scratch of `per` values a row
// into L2 (a hook run while the step's rows compute).
__device__ __forceinline__ void prefetch_rows(const bf16* p, int64_t row0,
                                              int nrow, int per, int threads) {
  const char* q = reinterpret_cast<const char*>(p + row0 * per);
  const int lines = (nrow * per * 2 + 127) / 128;
  for (int k = threadIdx.x + 32 * threadIdx.y; k < lines; k += threads)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(q + 128 * k));
}

template <class A, int MAXT, int SWEEP>
__global__ void __launch_bounds__(PSweep<A, SWEEP>::THREADS, 1)
fused_mp_pair_tile_kernel(const bf16* __restrict__ h,
                          const bf16* __restrict__ hj,
                          const bf16* __restrict__ attr,
                          const int* __restrict__ dst,
                          const uint8_t* __restrict__ mask,
                          const int64_t* __restrict__ bounds,
                          const float* __restrict__ dagg, Params p1,
                          Params p2, Tabs<A> tb,
                          const uint16_t* __restrict__ tabs, float* dx2,
                          bf16* x2s, float* __restrict__ partials, Geom gm) {
  using P = PSweep<A, SWEEP>;
  constexpr int NB = A::NB, R = P::R;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const int cm = gm.cm, ca = gm.ca, c = gm.c;
  size_t rowt_at;
  const PLayout L = pair_sweep_layout<A, SWEEP>(cm, ca, c, &rowt_at);
  const PBufs<A> b = carve_pbufs<A>(base, L);
  stage_pair_tile<A, SWEEP == 0 || SWEEP == 3, P>(
      SWEEP == 1 || SWEEP == 3 ? p2 : p1, tabs, b, L, base);
  int* rowt = reinterpret_cast<int*>(base + rowt_at);
  const int warp = threadIdx.y, lane = threadIdx.x;
  const int64_t rows = bounds[gm.n_win];   // every edge row
  const int out_w = c * NB, pd = dx2_pitch(NB, cm, ca, c);
  // a row's output, y = aln / mden * o, rounded to bf16, as [NB][C] at d
  auto put_row = [&](bf16* d, int r, float mden) {
    for (int n = lane; n < c; n += 32) {
      const float s = b.aln[n] / mden;
      const float* f = b.fa + r * (NB + 1) * L.fp + n;
#pragma unroll 8
      for (int j = 0; j < NB; ++j)
        d[j * c + n] = __float2bfloat16_rn(s * f[j * L.fp]);
    }
  };

  // ---- sweep 0: block 1's forward on the message tile; its output rows,
  // block 2's input rounded to bf16, to x2s ([E][NB][C])
  if constexpr (SWEEP == 0) {
    walk_steps<R>(rows, [&](int64_t row0, int nrow, int64_t next) {
      __syncthreads();   // the previous step's rows are written
      load_msg_pair_x<A, P>(h, hj, attr, dst, mask, row0, nrow, cm, ca, b, L);
      __syncthreads();
      pair_tile_block_forward<A, P>(
          b, L, tb, c, nrow, warp, lane,
          [&] {   // the CTA's next step's rows of hj into L2
            if (next < rows)
              prefetch_rows(hj, next, rows - next < R ? (int)(rows - next) : R,
                            cm * NB, P::THREADS);
          },
          [&](int r, float mden) { put_row(x2s + (row0 + r) * out_w, r, mden); });
    });
  }

  // ---- sweep 3: block 2's forward from x2s; the messages, rounded to
  // bf16, over x2s
  if constexpr (SWEEP == 3) {
    walk_steps<R>(rows, [&](int64_t row0, int nrow, int64_t next) {
      __syncthreads();   // the previous step's rows are written
      load_x2s_pair<A, P>(x2s, mask, row0, nrow, c, b, L);
      __syncthreads();
      pair_tile_block_forward<A, P>(
          b, L, tb, c, nrow, warp, lane,
          [&] {   // the CTA's next step's rows of x2s into L2
            if (next < rows)
              prefetch_rows(x2s, next, rows - next < R ? (int)(rows - next) : R,
                            out_w, P::THREADS);
          },
          [&](int r, float mden) { put_row(x2s + (row0 + r) * out_w, r, mden); });
    });
  }

  // ---- sweeps 1 and 2: a block's backward; the weight gradients in the
  // warps' register tiles for the CTA's whole walk, then the block's slice
  // of the CTA's partial vector
  if constexpr (SWEEP == 1 || SWEEP == 2) {
    const PWarp<A> w = make_pwarp<A, P>(b, tb);
    float wacc[MAXT][4];
#pragma unroll
    for (int j = 0; j < MAXT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) wacc[j][q] = 0.f;
    walk_steps<R>(rows, [&](int64_t row0, int nrow, int64_t) {
      __syncthreads();   // the previous step's tiles are consumed
      pair_tile_block_backward<A, MAXT, SWEEP == 1, P>(
          b, L, tb, w, c, nrow,
          [&] {
            if constexpr (SWEEP == 1)   // block 2's input rows from x2s
              load_x2s_pair<A, P>(x2s, mask, row0, nrow, c, b, L);
            else                        // block 1's: the message tile
              load_msg_pair_x<A, P>(h, hj, attr, dst, mask, row0, nrow, cm,
                                    ca, b, L);
            row_targets<P>(rowt, dst, mask, row0, nrow);
          },
          [&](int r) -> const float* {
            if (rowt[r] < 0) return nullptr;   // masked: a zero cotangent
            return SWEEP == 1 ? dagg + (int64_t)rowt[r] * out_w   // d(agg)
                              : dx2 + (row0 + r) * pd;   // block 2's dx
          },
          [&](int r, int i, int m, float v) {   // over the row's own dx2
            dx2[(row0 + r) * pd + m * NB + i] = v;
          },
          wacc);
    });
    __syncthreads();
    float* part = partials + (int64_t)blockIdx.x * slice_floats<A>(cm + ca, c);
    write_pair_part<A, MAXT, P>(
        SWEEP == 1 ? part + block_part_floats<A>(cm + ca, c) : part, L, b,
        wacc, warp, lane);
  }
}

// ---------------------------------------------------------------- host

// Shared-memory bytes of a window sum (K4p's: the window's rows and the
// offsets; K5p's: the offsets).
template <class A>
size_t pair_sum_bytes(int c, int wn, bool fwd) {
  return (fwd ? 4 * (size_t)wn * c * A::NB : 0) + 8 * (size_t)(wn + 1);
}

// Shared-memory bytes of the fast forward (sweeps 0 and 3, the message
// sum) or backward (sweeps 0, 1 and 2, the dmsg sum), the largest launch's;
// 0 where a launch does not take the widths.
template <class A>
size_t pair_tile_fwd_bytes(int cm, int ca, int c, int wn) {
  if (cm < 1 || ca < 0 || c < 1 || wn < 1) return 0;
  size_t n = pair_sweep_bytes<A, 0>(cm, ca, c);
  const size_t b3 = pair_sweep_bytes<A, 3>(cm, ca, c);
  const size_t bs = pair_sum_bytes<A>(c, wn, true);
  n = b3 > n ? b3 : n;
  n = bs > n ? bs : n;
  return n > kMaxSmem ? 0 : n;
}

// The weight-gradient tiles a warp of sweep 1 (block 2) or 2 (block 1).
template <class A>
int pair_sweep_maxt(int cm, int ca, int c, int sweep) {
  return pair_tile_maxt<A, PSweep<A, 1>>(sweep == 1 ? c : cm + ca, c);
}

template <class A>
size_t pair_tile_bwd_bytes(int cm, int ca, int c, int wn) {
  if (cm < 1 || ca < 0 || c < 1 || wn < 1 ||
      pair_sweep_maxt<A>(cm, ca, c, 1) == 0 ||
      pair_sweep_maxt<A>(cm, ca, c, 2) == 0)
    return 0;
  size_t n = pair_sweep_bytes<A, 0>(cm, ca, c);
  const size_t b1 = pair_sweep_bytes<A, 1>(cm, ca, c);
  const size_t b2 = pair_sweep_bytes<A, 2>(cm, ca, c);
  n = b1 > n ? b1 : n;
  n = b2 > n ? b2 : n;
  return n > kMaxSmem ? 0 : n;
}

// The pointers and sizes every launch takes.
struct PSweepArgs {
  const void *h, *hj, *attr;
  const int* dst;
  const uint8_t* mask;
  const int64_t* bounds;
  const float* dagg;
  Params p1, p2;
  const uint16_t* tabs;
  float* out;   // K4p: the sum; K5p: dh
  void *dhj, *dattr;
  float* dx2;
  void* x2s;
  float* partials;
  Geom gm;
  int grid;
  cudaStream_t st;
};

template <class A, int MAXT, int SWEEP>
int launch_pair_sweep(const PSweepArgs& a, const Tabs<A>& tb) {
  const size_t bytes = pair_sweep_bytes<A, SWEEP>(a.gm.cm, a.gm.ca, a.gm.c);
  auto kernel = fused_mp_pair_tile_kernel<A, MAXT, SWEEP>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  kernel<<<a.grid, dim3(32, PSweep<A, SWEEP>::WARPS), bytes, a.st>>>(
      static_cast<const bf16*>(a.h), static_cast<const bf16*>(a.hj),
      static_cast<const bf16*>(a.attr), a.dst, a.mask, a.bounds, a.dagg, a.p1,
      a.p2, tb, a.tabs, a.dx2, static_cast<bf16*>(a.x2s), a.partials, a.gm);
  return (int)cudaGetLastError();
}

// A backward sweep at the MAXT its block's weight-gradient tiles need.
template <class A, int SWEEP>
int launch_pair_sweep_maxt(const PSweepArgs& a, const Tabs<A>& tb) {
  switch (pair_sweep_maxt<A>(a.gm.cm, a.gm.ca, a.gm.c, SWEEP)) {
    case 16: return launch_pair_sweep<A, 16, SWEEP>(a, tb);
    case 24: return launch_pair_sweep<A, 24, SWEEP>(a, tb);
    default: return launch_pair_sweep<A, 32, SWEEP>(a, tb);
  }
}

// The window sums take a CTA a window.
inline int sum_grid(const Geom& gm) { return gm.n_win < 1 ? 1 : gm.n_win; }

// K4p fast: sweeps 0 and 3, then the message sum.
template <class A>
int launch_pair_tile_mp_fwd(const PSweepArgs& a, const Tabs<A>& tb) {
  int err = launch_pair_sweep<A, 16, 0>(a, tb);
  if (err == cudaSuccess) err = launch_pair_sweep<A, 16, 3>(a, tb);
  if (err != cudaSuccess) return err;
  const size_t bytes = pair_sum_bytes<A>(a.gm.c, a.gm.wn, true);
  cudaFuncSetAttribute(pair_msg_sum_kernel<A>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  pair_msg_sum_kernel<A><<<sum_grid(a.gm), SUM_THREADS, bytes, a.st>>>(
      static_cast<const bf16*>(a.x2s), a.dst, a.mask, a.bounds, a.out, a.gm);
  return (int)cudaGetLastError();
}

// K5p fast: sweeps 0, 1 and 2, then the dmsg sum; the caller reduces the
// partials.
template <class A>
int launch_pair_tile_mp_bwd(const PSweepArgs& a, const Tabs<A>& tb) {
  int err = launch_pair_sweep<A, 16, 0>(a, tb);
  if (err == cudaSuccess) err = launch_pair_sweep_maxt<A, 1>(a, tb);
  if (err == cudaSuccess) err = launch_pair_sweep_maxt<A, 2>(a, tb);
  if (err != cudaSuccess) return err;
  pair_dmsg_sum_kernel<A><<<sum_grid(a.gm), SUM_THREADS,
                            pair_sum_bytes<A>(a.gm.c, a.gm.wn, false),
                            a.st>>>(
      a.dx2, a.dst, a.mask, a.bounds, a.out, static_cast<bf16*>(a.dhj),
      static_cast<bf16*>(a.dattr), a.gm);
  return (int)cudaGetLastError();
}

}  // namespace
