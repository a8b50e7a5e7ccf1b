// K4p and K5p — the EGCL edge side in one pass, forward and backward, in
// the pair form, on Hopper (sm_90a), templated on the algebra
// (cemlp_pair.cuh's traits) and its row tile:
//     agg[v] = sum over unmasked edges e with dst[e] == v of
//              CEMLP_2(CEMLP_1([h[dst[e]] - hj[e], attr[e]]))
// with dst sorted ascending and hj the pre-gathered source rows.
// fused_egcl_pair.cu compiles them for Cl(5,0) (csmpn_fused_mp_pair_*),
// fused_egcl_pair_cl4.cu for Cl(4,0) (csmpn_fused_mp_pair_cl4_*); each
// source's header states its tile, its window and its bound.
//
// Replaces: csmpn_tpu/ops/fused_egcl.py, `_make_fwd_kernel` (K4, launched
// by `_mp_forward`) and `_make_bwd_kernel` (K5, launched by `_mp_backward`)
// in their pair form (nb 16/32: the blocks' `_post_linear_math` and
// `_post_linear_bwd` through `_gp_pair_fwd`).  The block math is
// cemlp_pair.cuh, the same device code as K2p/K3p.
//
// Design.  The ownership of K4/K5 (fused_egcl.cu): the wrapper cuts the
// target nodes into windows of wn nodes, a CTA walks over whole windows,
// so every edge row and every node row has one owner: no atomics, results
// bitwise equal from run to run.  In fast mode both kernels are sweeps of
// K2p's and K3p's row tiles over all edge rows and a window-sum kernel
// (fused_egcl_pair_tile.cuh: three launches for K4p, five for K5p with
// the reduce of the partials).  The exact kernels here keep the
// row layout of the exact K2p/K3p: a row's blades are a member's lanes (a
// warp at Cl(5), a half-warp at Cl(4)) and a team of members shares a row.
// Both blocks' fp32 parameters are staged once per CTA, which leaves room
// for few rows in flight and a small window:
//   * K4p: ROWS_F row slots; each team builds its row x = [h[dst] - hj,
//     attr] in shared memory, runs block 1, writes block 2's input over x,
//     runs block 2, and leaves the message in its slot; the CTA then adds
//     the tile's messages into the window's fp32 sum in row order (masked
//     rows are skipped), and writes the window once (an empty window
//     writes 0);
//   * K5p: ROWS_B row slots (the backward's row buffers are 2.5x the
//     forward's).  Holding both blocks' cotangent rows at once does not
//     fit, so a CTA sweeps its windows twice in one launch, as K5 does:
//     both forwards and the block-2 backward from d(agg) at the row's
//     target, block 2's dx rows to the scratch dx2; then block 1's forward
//     (recomputed) and backward from them, the message cotangent summed
//     into the window's d(h) in shared memory in row order, and dhj = -dmsg
//     and dattr written for every row (masked rows compute with a zero
//     cotangent and write exact zeros).  Per-channel and path-weight
//     gradients are per-slot / per-CTA slices in shared memory, the
//     channel-mixing ones the CTA's slice of global scratch, each entry
//     owned by one thread; after each sweep the CTA writes its block's
//     partial vector in K5's layout, and a second kernel sums the CTAs'
//     vectors in a fixed order.
//
// Precision: the row kernels are exact mode, fp32 throughout.  Fast mode
// (the tile sweeps) streams h, hj and attr as bf16, rounds block 1's
// input, block 2's input, each message row and d(agg) as K4/K5 do, rounds
// each pair product z_i * yn_k * w as K2p does (the path weight stays
// fp32), writes dhj and dattr as bf16, and accumulates in fp32.
#pragma once

#include "cemlp_pair.cuh"
#include "fused_egcl_pair_tile.cuh"
#include "fused_mp.cuh"

namespace {

// The row's block-1 input x = [h[dst] - hj, attr] at this lane's blade
// into xs ([m][RP]); the team splits the channels.
template <class A>
__device__ __forceinline__ void load_msg_row(
    const float* __restrict__ h, const float* __restrict__ hj,
    const float* __restrict__ attr, int64_t t, int64_t row, int cm, int ca,
    const Team& tm, int lane, float* xs) {
  constexpr int NB = A::NB;
  for (int m = tm.h; m < cm + ca; m += tm.nh)
    xs[m * A::RP + lane] =
        m < cm ? h[(t * cm + m) * NB + lane] - hj[(row * cm + m) * NB + lane]
               : attr[(row * ca + (m - cm)) * NB + lane];
}

// A block's output for the team member's own channel groups (those it
// wrote in row_forward), out[n * RP + lane] = rnd(aln[n] / m * os[n * RP +
// lane]); out may be os itself.
template <class A>
__device__ __forceinline__ void scale_row(const Smem& s, const Team& tm,
                                          int lane, float mden,
                                          const float* os, float* out,
                                          int c) {
  for (int n0 = 4 * tm.h; n0 < c; n0 += 4 * tm.nh)
    for (int n = n0; n < n0 + 4 && n < c; ++n)
      out[n * A::RP + lane] = s.aln[n] / mden * os[n * A::RP + lane];
}

// K4p in exact mode (fp32 throughout); the fast one is sweeps 0 and 3 and
// the message sum of fused_egcl_pair_tile.cuh.
template <class A, class K>
__global__ void __launch_bounds__(K::THREADS_F, 1)
fused_mp_pair_fwd_kernel(const float* __restrict__ h,
                         const float* __restrict__ hj,
                         const float* __restrict__ attr,
                         const int* __restrict__ dst,
                         const uint8_t* __restrict__ mask,
                         const int64_t* __restrict__ bounds, Params p1,
                         Params p2, Tabs<A> tb,
                         const uint16_t* __restrict__ tabs,
                         float* __restrict__ out, Geom gm) {
  constexpr int NB = A::NB, RP = A::RP, ROWS_F = K::ROWS_F;
  constexpr int THREADS_F = K::THREADS_F;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int cm = gm.cm, ca = gm.ca, cin1 = cm + ca, c = gm.c;
  const int c4 = pad4(c), mx = imax(cin1, c), per_node = c * NB;
  const int slot = (mx + 2 * c4) * RP;   // floats of a row slot
  Smem s1, s2;
  carve_params<A>(smem, cin1, c, s1);
  float* p2base = smem + params_floats<A>(cin1, c);
  carve_params<A>(p2base, c, c, s2);
  float* tail = p2base + params_floats<A>(c, c);
  uint16_t* t1 = reinterpret_cast<uint16_t*>(tail);    // T1 only
  float* sc = tail + NB * NB / 2;                      // [WARPS_F][32]
  float* xch = sc + K::WARPS_F * 32;                   // [ROWS_F][XCH]
  int* dloc = reinterpret_cast<int*>(xch + ROWS_F * A::XCH);   // [ROWS_F]
  float* acc = xch + ROWS_F * A::XCH + ROWS_F;         // [wn][c][NB]
  float* rowbuf = acc + gm.wn * per_node;              // [ROWS_F][slot]
  stage_params<A, false>(p1, s1, cin1, c, THREADS_F);
  stage_params<A, false>(p2, s2, c, c, THREADS_F);
  const int tid = threadIdx.x + 32 * threadIdx.y;
  for (int e = tid; e < NB * NB; e += THREADS_F) t1[e] = tabs[e];

  const Lane l = make_lane<A>(tb);
  const int lane = l.id;
  // warps TEAM_F * r ... share row slot r (named barrier 1 + r)
  const int w = threadIdx.y, r = w / K::TEAM_F;
  const Team tm = make_team<A>(w, K::TEAM_F, xch);
  float* xs = rowbuf + r * slot;     // block 1's input, then block 2's
  float* zs = xs + mx * RP;
  float* os = zs + c4 * RP;          // pre-norm output, then the message
  float* scw = sc + w * 32 + half_of_warp<A>() * NB;
  for (int win = blockIdx.x; win < gm.n_win; win += gridDim.x) {
    const int base = win * gm.wn;
    const int64_t e0 = bounds[win], e1 = bounds[win + 1];
    for (int e = tid; e < gm.wn * per_node; e += THREADS_F) acc[e] = 0.f;
    for (int64_t row0 = e0; row0 < e1; row0 += ROWS_F) {
      __syncthreads();   // staging done / previous tile summed
      const int64_t row = row0 + r;
      const bool keep = row < e1 && (mask == nullptr || mask[row]);
      if (tm.h == 0 && lane == 0) dloc[r] = keep ? dst[row] - base : -1;
      if (keep) {        // the whole team
        load_msg_row<A>(h, hj, attr, dst[row], row, cm, ca, tm, lane, xs);
        team_sync<A>(tm);
        const float m1 = row_forward<A, false>(s1, l, tm, t1, xs, zs, nullptr,
                                               os, scw, cin1, c);
        // block 2's input over x: the team is past every read of block 1's
        scale_row<A>(s1, tm, lane, m1, os, xs, c);
        team_sync<A>(tm);
        const float m2 = row_forward<A, false>(s2, l, tm, t1, xs, zs, nullptr,
                                               os, scw, c, c);
        scale_row<A>(s2, tm, lane, m2, os, os, c);
      }
      __syncthreads();
      const int nrow = (int)(e1 - row0 < ROWS_F ? e1 - row0 : ROWS_F);
      for (int e = tid; e < per_node; e += THREADS_F) {   // e = n * NB + i
        const int at = (mx + c4 + e / NB) * RP + e % NB;
        for (int rr = 0; rr < nrow; ++rr) {
          const int d = dloc[rr];
          if (d >= 0) acc[d * per_node + e] += rowbuf[rr * slot + at];
        }
      }
    }
    __syncthreads();
    const int nn = gm.n_nodes - base < gm.wn ? gm.n_nodes - base : gm.wn;
    for (int e = tid; e < nn * per_node; e += THREADS_F)
      out[(int64_t)base * per_node + e] = acc[e];
    __syncthreads();   // window written before the next one zeroes acc
  }
}

// Writes one block's part from the sweep's accumulators: mix (the padded
// [(m*NG+g)*C4 + n] channel-mixing sums, global), locs (per-slot
// [NLOC][C4] rows, added in slot order) and gacc ([NP][C4] path weights).
// All threads of the CTA call it.
template <class A, class K>
__device__ void write_block_part(float* part, const float* mix,
                                 const float* locs, const float* gacc,
                                 int cin, int c) {
  constexpr int NG = A::NG, NP = A::NP;
  const int tid = threadIdx.x + 32 * threadIdx.y, c4 = pad4(c);
  const int64_t n_mix = (int64_t)(cin + 2 * c) * NG * c;
  for (int64_t e = tid; e < n_mix; e += K::THREADS_B)
    part[e] = mix[(e / c) * c4 + e % c];
  float* loc = part + n_mix;
  for (int e = tid; e < loc_out<A>() * c; e += K::THREADS_B) {
    const int k = e / c, n = e % c;
    int row;   // the pair kernels' loc row of K5's row k (-1: a path weight)
    if (k == 0) row = A::L_B1;
    else if (k <= NG) row = A::L_SA + (k - 1);
    else if (k <= 2 * NG) row = A::L_SB + (k - 1 - NG);
    else if (k <= 2 * NG + NP) row = -1;
    else if (k <= 3 * NG + NP) row = A::L_NS + (k - 1 - 2 * NG - NP);
    else if (k == 3 * NG + NP + 1) row = A::L_BL;
    else row = A::L_ALN;
    float v = 0.f;
    if (row < 0) {
      v = gacc[(k - 1 - 2 * NG) * c4 + n];
    } else {
      for (int r = 0; r < K::ROWS_B; ++r)
        v += locs[(r * A::NLOC + row) * c4 + n];
    }
    loc[e] = v;
  }
}

// K5p in exact mode (fp32 throughout); the fast one is sweeps 0, 1 and 2
// and the dmsg sum of fused_egcl_pair_tile.cuh.
template <class A, class K>
__global__ void __launch_bounds__(K::THREADS_B, 1)
fused_mp_pair_bwd_kernel(const float* __restrict__ h,
                         const float* __restrict__ hj,
                         const float* __restrict__ attr,
                         const int* __restrict__ dst,
                         const uint8_t* __restrict__ mask,
                         const int64_t* __restrict__ bounds,
                         const float* __restrict__ dagg, Params p1,
                         Params p2, Tabs<A> tb,
                         const uint16_t* __restrict__ tabs,
                         float* __restrict__ dh,
                         float* __restrict__ dhj,
                         float* __restrict__ dattr,
                         float* __restrict__ dx2,
                         float* __restrict__ partials, Geom gm) {
  constexpr int NB = A::NB, NG = A::NG, NP = A::NP, NLOC = A::NLOC;
  constexpr int RP = A::RP, ROWS_B = K::ROWS_B, THREADS_B = K::THREADS_B;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int cm = gm.cm, ca = gm.ca, cin1 = cm + ca, c = gm.c;
  const int c4 = pad4(c), mx = imax(cin1, c), msg_w = cm * NB;
  const int rstride = (mx + 5 * c4) * RP;   // floats of a row slot
  const int gstride = mx * NB;              // floats of a slot's go/dx row
  Smem s1, s2;
  carve_params<A>(smem, cin1, c, s1);
  float* p2base = smem + params_floats<A>(cin1, c);
  carve_params<A>(p2base, c, c, s2);
  float* tail = p2base + params_floats<A>(c, c);
  uint16_t* tab = reinterpret_cast<uint16_t*>(tail);
  const uint16_t *t1 = tab, *t2 = tab + NB * NB, *t3 = tab + 2 * NB * NB;
  const uint16_t *list = tab + A::TAB_T, *off = list + NB * NB;
  float* sc = tail + A::TAB_FLOATS;               // [WARPS_B][32]
  float* xch = sc + K::WARPS_B * 32;              // [ROWS_B][XCH]
  int* dloc = reinterpret_cast<int*>(xch + ROWS_B * A::XCH);   // [ROWS_B]
  float* locs = xch + ROWS_B * A::XCH + ROWS_B;   // [ROWS_B][NLOC][C4]
  float* gacc = locs + ROWS_B * NLOC * c4;        // [NP][C4]
  float* dhw = gacc + NP * c4;                    // [wn][cm][NB] window d(h)
  float* gbuf = dhw + gm.wn * msg_w;              // [ROWS_B][mx][NB]
  float* rowbuf = gbuf + ROWS_B * gstride;        // [ROWS_B][rstride]

  float* part1 = partials + (int64_t)blockIdx.x * slice_floats<A>(cin1, c);
  float* part2 = part1 + block_part_floats<A>(cin1, c);
  float* mix = part2 + block_part_floats<A>(c, c);
  const int64_t n_mix = (int64_t)(mx + 2 * c) * NG * c4;

  const int tid = threadIdx.x + 32 * threadIdx.y;
  stage_params<A, false>(p1, s1, cin1, c, THREADS_B);
  stage_params<A, false>(p2, s2, c, c, THREADS_B);
  for (int e = tid; e < A::TAB_LEN; e += THREADS_B) tab[e] = tabs[e];
  for (int e = tid; e < ROWS_B * NLOC * c4; e += THREADS_B) locs[e] = 0.f;
  for (int e = tid; e < NP * c4; e += THREADS_B) gacc[e] = 0.f;
  for (int64_t e = tid; e < n_mix; e += THREADS_B) mix[e] = 0.f;

  const Lane l = make_lane<A>(tb);
  const int lane = l.id;
  // warps TEAM_B * r ... share row slot r (named barrier 1 + r) and its
  // per-channel gradient slice (each member adds only its own channels)
  const int w = threadIdx.y, r = w / K::TEAM_B;
  const Team tm = make_team<A>(w, K::TEAM_B, xch);
  float* slot = rowbuf + r * rstride;
  float* gb = gbuf + r * gstride;
  float* loc = locs + r * NLOC * c4;
  float* scw = sc + w * 32 + half_of_warp<A>() * NB;
  // ---- sweep 1 over the CTA's windows: both forwards and the block-2
  // backward from d(agg) at the row's target; block 2's dx rows go to the
  // scratch dx2, read back by the same team in sweep 2
  {
    const Rows b2 = carve_rows<A>(slot, c, c);
    float* x1 = b2.dz;   // block 1's input, over block 2's cotangent rows
    for (int win = blockIdx.x; win < gm.n_win; win += gridDim.x) {
      const int64_t e0 = bounds[win], e1 = bounds[win + 1];
      for (int64_t row0 = e0; row0 < e1; row0 += ROWS_B) {
        __syncthreads();   // staging and zeroing done / previous tile used
        const int64_t row = row0 + r;
        if (row < e1) {    // the whole team
          const int64_t t = dst[row];
          const bool keep = mask == nullptr || mask[row];
          load_msg_row<A>(h, hj, attr, t, row, cm, ca, tm, lane, x1);
          for (int n = tm.h; n < c; n += tm.nh)
            gb[n * NB + lane] = keep ? dagg[(t * c + n) * NB + lane] : 0.f;
          team_sync<A>(tm);
          const float m1 = row_forward<A, false>(s1, l, tm, t1, x1, b2.zs,
                                                 nullptr, b2.fs, scw, cin1, c);
          scale_row<A>(s1, tm, lane, m1, b2.fs, b2.xs, c);
          team_sync<A>(tm);
          row_backward<A, false>(s2, l, tm, t1, t2, t3, b2, scw, loc, gb,
                                 dx2 + row * c * NB, c, c);
        }
        __syncthreads();
        const int nrow = (int)(e1 - row0 < ROWS_B ? e1 - row0 : ROWS_B);
        float* aw = mix;
        mix_grads<A, THREADS_B>(rowbuf, rstride, nrow, c, c, c4, 0, aw);
        mix_grads<A, THREADS_B>(rowbuf, rstride, nrow, c, c, c4, 1,
                                aw + c * NG * c4);
        mix_grads<A, THREADS_B>(rowbuf, rstride, nrow, c, c, c4, 2,
                                aw + 2 * c * NG * c4);
        path_grads<A, THREADS_B>(rowbuf, rstride, nrow, c, c, c4, list, off,
                                 gacc);
      }
    }
    __syncthreads();
    write_block_part<A, K>(part2, mix, locs, gacc, c, c);
    __syncthreads();
    for (int e = tid; e < ROWS_B * NLOC * c4; e += THREADS_B) locs[e] = 0.f;
    for (int e = tid; e < NP * c4; e += THREADS_B) gacc[e] = 0.f;
    for (int64_t e = tid; e < n_mix; e += THREADS_B) mix[e] = 0.f;
  }
  // ---- sweep 2: block 1's forward and backward from block 2's dx; the
  // message cotangent summed into the window's d(h), rows in order, and
  // written out as dhj = -dmsg with dattr (masked rows zero)
  {
    const Rows b1 = carve_rows<A>(slot, cin1, c);
    for (int win = blockIdx.x; win < gm.n_win; win += gridDim.x) {
      const int base = win * gm.wn;
      const int64_t e0 = bounds[win], e1 = bounds[win + 1];
      for (int e = tid; e < gm.wn * msg_w; e += THREADS_B) dhw[e] = 0.f;
      for (int64_t row0 = e0; row0 < e1; row0 += ROWS_B) {
        __syncthreads();
        const int64_t row = row0 + r;
        if (row < e1) {
          const int64_t t = dst[row];
          if (tm.h == 0 && lane == 0)
            dloc[r] = (mask == nullptr || mask[row]) ? (int)(t - base) : -1;
          load_msg_row<A>(h, hj, attr, t, row, cm, ca, tm, lane, b1.xs);
          team_sync<A>(tm);
          row_backward<A, false>(s1, l, tm, t1, t2, t3, b1, scw, loc,
                                 dx2 + row * c * NB, gb, cin1, c);
        }
        __syncthreads();
        const int nrow = (int)(e1 - row0 < ROWS_B ? e1 - row0 : ROWS_B);
        float* aw = mix;
        mix_grads<A, THREADS_B>(rowbuf, rstride, nrow, cin1, c, c4, 0, aw);
        mix_grads<A, THREADS_B>(rowbuf, rstride, nrow, cin1, c, c4, 1,
                                aw + cin1 * NG * c4);
        mix_grads<A, THREADS_B>(rowbuf, rstride, nrow, cin1, c, c4, 2,
                                aw + (cin1 + c) * NG * c4);
        path_grads<A, THREADS_B>(rowbuf, rstride, nrow, cin1, c, c4, list,
                                 off, gacc);
        for (int e = tid; e < msg_w; e += THREADS_B)
          for (int rr = 0; rr < nrow; ++rr) {
            const int d = dloc[rr];
            if (d >= 0) dhw[d * msg_w + e] += gbuf[rr * gstride + e];
          }
        for (int e = tid; e < nrow * msg_w; e += THREADS_B) {
          const int rr = e / msg_w, k = e % msg_w;
          dhj[(row0 + rr) * msg_w + k] =
              dloc[rr] >= 0 ? -gbuf[rr * gstride + k] : 0.f;
        }
        if (ca > 0) {
          const int aw_w = ca * NB;
          for (int e = tid; e < nrow * aw_w; e += THREADS_B) {
            const int rr = e / aw_w, k = e % aw_w;
            dattr[(row0 + rr) * aw_w + k] =
                dloc[rr] >= 0 ? gbuf[rr * gstride + msg_w + k] : 0.f;
          }
        }
      }
      __syncthreads();
      const int nn = gm.n_nodes - base < gm.wn ? gm.n_nodes - base : gm.wn;
      for (int e = tid; e < nn * msg_w; e += THREADS_B)
        dh[(int64_t)base * msg_w + e] = dhw[e];
      __syncthreads();   // window written before the next one zeroes dhw
    }
    write_block_part<A, K>(part1, mix, locs, gacc, cin1, c);
  }
}

template <class A, class K>
size_t fwd_smem_bytes(int cm, int ca, int c, int wn) {
  const int cin1 = cm + ca, c4 = pad4(c), mx = imax(cin1, c);
  return sizeof(float) *
         ((size_t)params_floats<A>(cin1, c) + params_floats<A>(c, c) +
          A::NB * A::NB / 2 + K::WARPS_F * 32 + K::ROWS_F * A::XCH +
          K::ROWS_F + (size_t)wn * c * A::NB +
          (size_t)K::ROWS_F * (mx + 2 * c4) * A::RP);
}

template <class A, class K>
size_t bwd_smem_bytes(int cm, int ca, int c, int wn) {
  const int cin1 = cm + ca, c4 = pad4(c), mx = imax(cin1, c);
  return sizeof(float) *
         ((size_t)params_floats<A>(cin1, c) + params_floats<A>(c, c) +
          A::TAB_FLOATS + K::WARPS_B * 32 + K::ROWS_B * A::XCH + K::ROWS_B +
          (size_t)(K::ROWS_B * A::NLOC + A::NP) * c4 +
          (size_t)wn * cm * A::NB + (size_t)K::ROWS_B * mx * A::NB +
          (size_t)K::ROWS_B * (mx + 5 * c4) * A::RP);
}

inline bool widths_ok(int cm, int ca, int c, int wn) {
  return cm >= 1 && ca >= 0 && c >= 1 && wn >= 1;
}

inline Params params_at(const float* const* pp) {
  return Params{pp[0], pp[1], pp[2], pp[3], pp[4],
                pp[5], pp[6], pp[7], pp[8], pp[9]};
}

// h (N, cm, NB), hj (E, cm, NB), attr (E, ca, NB) or null: bf16 if fast,
// else fp32.  dst (E,) int32 ascending; mask (E,) bytes or null; bounds
// (n_win + 1,) int64 window edge offsets; params: host array of the 20
// device pointers of the two blocks (flax order, 10 each); bc: host
// quadratic-form coefficients; tabs: the packed tables on the device.  out
// (N, C, NB) fp32: the sum over unmasked edges.  Scratch (fast mode): x2s
// (E, NB, C) bf16, block 2's input rows, then the messages.  Fast mode: the
// tile sweeps 0 and 3 and the message sum; exact mode: the row kernel.
template <class A, class K>
int launch_fwd(const void* h, const void* hj, const void* attr,
               const int* dst, const uint8_t* mask, const int64_t* bounds,
               const float* const* params, const float* bc,
               const uint16_t* tabs, float* out, void* x2s, int n_nodes,
               int cm, int ca, int c, int wn, int n_win, int fast, int grid,
               void* stream) {
  const size_t bytes = fast ? pair_tile_fwd_bytes<A>(cm, ca, c, wn)
                            : fwd_smem_bytes<A, K>(cm, ca, c, wn);
  if (!widths_ok(cm, ca, c, wn) || bytes == 0 || bytes > kMaxSmem ||
      grid < 1 || (fast && x2s == nullptr))
    return (int)cudaErrorInvalidValue;
  Geom gm{n_nodes, cm, ca, c, wn, n_win};
  Tabs<A> tb = make_tabs<A>(bc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fast) {
    const PSweepArgs a{h, hj, attr, dst, mask, bounds, nullptr,
                       params_at(params), params_at(params + 10), tabs, out,
                       nullptr, nullptr, nullptr, x2s, nullptr, gm, grid, st};
    return launch_pair_tile_mp_fwd<A>(a, tb);
  }
  cudaFuncSetAttribute(fused_mp_pair_fwd_kernel<A, K>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  fused_mp_pair_fwd_kernel<A, K><<<grid, dim3(32, K::WARPS_F), bytes, st>>>(
      static_cast<const float*>(h), static_cast<const float*>(hj),
      static_cast<const float*>(attr), dst, mask, bounds, params_at(params),
      params_at(params + 10), tb, tabs, out, gm);
  return (int)cudaGetLastError();
}

// dagg (N, C, NB) fp32, the cotangent of the sum.  Outputs: dh (N, cm, NB)
// fp32; dhj (E, cm, NB) and dattr (E, ca, NB) in the stream type; grads
// (block_part_floats(cm + ca, c) + block_part_floats(c, c),) the summed
// vector.  Scratch: dx2 fp32, block 2's dx rows, (E, C, NB) in exact
// mode, rows of dx2_pitch floats in fast mode (block 1's dx rows go over
// them); x2s (E, NB, C) bf16, block 2's input rows (fast mode; null in
// exact); partials (grid, slice_floats).  Fast mode: the tile sweeps 0, 1
// and 2 and the dmsg sum; exact mode: the row kernel.
template <class A, class K>
int launch_bwd(const void* h, const void* hj, const void* attr,
               const int* dst, const uint8_t* mask, const int64_t* bounds,
               const float* dagg, const float* const* params,
               const float* bc, const uint16_t* tabs, float* dh, void* dhj,
               void* dattr, float* dx2, void* x2s, float* partials,
               float* grads, int n_nodes, int cm, int ca, int c, int wn,
               int n_win, int fast, int grid, void* stream) {
  const size_t bytes = fast ? pair_tile_bwd_bytes<A>(cm, ca, c, wn)
                            : bwd_smem_bytes<A, K>(cm, ca, c, wn);
  if (!widths_ok(cm, ca, c, wn) || bytes == 0 || bytes > kMaxSmem ||
      grid < 1 || (fast && x2s == nullptr))
    return (int)cudaErrorInvalidValue;
  Geom gm{n_nodes, cm, ca, c, wn, n_win};
  Tabs<A> tb = make_tabs<A>(bc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (fast) {
    const PSweepArgs a{h, hj, attr, dst, mask, bounds, dagg,
                       params_at(params), params_at(params + 10), tabs, dh,
                       dhj, dattr, dx2, x2s, partials, gm, grid, st};
    err = launch_pair_tile_mp_bwd<A>(a, tb);
  } else {
    cudaFuncSetAttribute(fused_mp_pair_bwd_kernel<A, K>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    fused_mp_pair_bwd_kernel<A, K><<<grid, dim3(32, K::WARPS_B), bytes,
                                     st>>>(
        static_cast<const float*>(h), static_cast<const float*>(hj),
        static_cast<const float*>(attr), dst, mask, bounds, dagg,
        params_at(params), params_at(params + 10), tb, tabs, dh,
        static_cast<float*>(dhj), static_cast<float*>(dattr), dx2, partials,
        gm);
    err = (int)cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  const int64_t n =
      block_part_floats<A>(cm + ca, c) + block_part_floats<A>(c, c);
  reduce_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      partials, grads, n, slice_floats<A>(cm + ca, c), grid);
  return (int)cudaGetLastError();
}

}  // namespace

// One set of C entry points per algebra, prefixed PREFIX, for traits ALG
// and row tile TILE; the arguments are launch_fwd's and launch_bwd's.
#define CSMPN_FUSED_PAIR_ENTRIES(PREFIX, ALG, TILE)                           \
  /* shared-memory bytes a launch of the exact row kernels needs (0 if the  \
     widths are not supported) */                                             \
  size_t PREFIX##_smem_bytes(int cm, int ca, int c, int wn, int backward) {   \
    if (!widths_ok(cm, ca, c, wn)) return 0;                                  \
    return backward ? bwd_smem_bytes<ALG, TILE>(cm, ca, c, wn)                \
                    : fwd_smem_bytes<ALG, TILE>(cm, ca, c, wn);               \
  }                                                                           \
  /* those of the fast mode's launches (tile sweeps and window sums), the   \
     largest of a direction's (0 where a launch does not take the widths) */  \
  size_t PREFIX##_tile_smem_bytes(int cm, int ca, int c, int wn) {            \
    return widths_ok(cm, ca, c, wn) ? pair_tile_bwd_bytes<ALG>(cm, ca, c, wn) \
                                    : 0;                                      \
  }                                                                           \
  size_t PREFIX##_fwd_tile_smem_bytes(int cm, int ca, int c, int wn) {        \
    return widths_ok(cm, ca, c, wn) ? pair_tile_fwd_bytes<ALG>(cm, ca, c, wn) \
                                    : 0;                                      \
  }                                                                           \
  /* the weight-gradient tiles a warp (the kernel instance) of the fast     \
     backward's sweep 1 or 2; 0 where the backward does not take the widths \
     (sweep 0 has none: 16) */                                                \
  int PREFIX##_tile_maxt(int cm, int ca, int c, int wn, int sweep) {          \
    if (!widths_ok(cm, ca, c, wn) ||                                          \
        pair_tile_bwd_bytes<ALG>(cm, ca, c, wn) == 0)                         \
      return 0;                                                               \
    return sweep == 0 ? 16 : pair_sweep_maxt<ALG>(cm, ca, c, sweep);          \
  }                                                                           \
  /* floats of one CTA's slice of the backward's scratch (the summed        \
     gradient vector is its first two blocks' parts) */                       \
  int64_t PREFIX##_partial_floats(int cm, int ca, int c) {                    \
    return slice_floats<ALG>(cm + ca, c);                                     \
  }                                                                           \
  void PREFIX##_tables(int* i_of_out, int* path_out, int* grade_out,          \
                       float* sign_out) {                                     \
    structural_tables<ALG>(i_of_out, path_out, grade_out, sign_out);          \
  }                                                                           \
  int PREFIX##_packed(uint16_t* out, int cap) {                               \
    if (cap < ALG::TAB_LEN) return -1;                                        \
    return make_packed<ALG>(out);                                             \
  }                                                                           \
  int PREFIX##_fwd(const void* h, const void* hj, const void* attr,           \
                   const int* dst, const uint8_t* mask,                       \
                   const int64_t* bounds, const float* const* params,         \
                   const float* bc, const uint16_t* tabs, float* out,         \
                   void* x2s, int n_nodes, int cm, int ca, int c, int wn,     \
                   int n_win, int fast, int grid, void* stream) {             \
    return launch_fwd<ALG, TILE>(h, hj, attr, dst, mask, bounds, params, bc,  \
                                 tabs, out, x2s, n_nodes, cm, ca, c, wn,      \
                                 n_win, fast, grid, stream);                  \
  }                                                                           \
  int PREFIX##_bwd(const void* h, const void* hj, const void* attr,           \
                   const int* dst, const uint8_t* mask,                       \
                   const int64_t* bounds, const float* dagg,                  \
                   const float* const* params, const float* bc,               \
                   const uint16_t* tabs, float* dh, void* dhj, void* dattr,   \
                   float* dx2, void* x2s, float* partials, float* grads,      \
                   int n_nodes, int cm, int ca, int c, int wn, int n_win,     \
                   int fast, int grid, void* stream) {                        \
    return launch_bwd<ALG, TILE>(h, hj, attr, dst, mask, bounds, dagg,        \
                                 params, bc, tabs, dh, dhj, dattr, dx2, x2s,  \
                                 partials, grads, n_nodes, cm, ca, c, wn,     \
                                 n_win, fast, grid, stream);                  \
  }
