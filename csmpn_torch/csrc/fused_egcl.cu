// K4 and K5 — the EGCL edge side in one pass, forward and backward, on
// Hopper (sm_90a), for Cl(3,0) (8 blades, up to 32 channels) and Cl(2,0)
// (4 blades, up to 64 channels by lanes; shared memory holds C = 40, the
// NBA task's width, at wn 32):
//     agg[v] = sum over unmasked edges e with dst[e] == v of
//              CEMLP_2(CEMLP_1([h[dst[e]] - hj[e], attr[e]]))
// with dst sorted ascending and hj the pre-gathered source rows.
//
// Replaces: csmpn_tpu/ops/fused_egcl.py, `_make_fwd_kernel` (K4, launched
// by `_mp_forward`, entry `fused_message_aggregate`) and `_make_bwd_kernel`
// (K5, launched by `_mp_backward`), dense form (nb 4 and 8).  The block math
// is cemlp_block.cuh, the same device code as K2/K3 (cemlp.cu), templated
// on the algebra: a lane owns one channel at Cl(3), two (n and n + 32) at
// Cl(2), so that a lane holds the same number of floats in both.  The pair
// form at Cl(5,0) is fused_egcl_pair.cu.
//
// Bound on this card: at the bench shape (E = 131,072 edges, N = 8,192
// nodes, 32 -> 32 channels, bf16 streams) K4 reads ~72 MB (hj, h, ids) and
// writes 8 MB, ~24 us at 3.35 TB/s, against ~17 GFLOP of block math, ~17 us
// at the bf16 tensor-core rate: bytes bound it.  K5 moves about twice the
// bytes and does three times the operations; at that rate the two bounds
// are close.  At Cl(2) (40 -> 40 channels, 4 blades) the bytes are ~0.6x
// and the block math ~0.7x Cl(3)'s at 32 channels.
//
// Design.  The TPU kernel gathers target rows and reduces messages with
// one-hot window matrix products, aligns its edge chunks down and repairs
// the overlaps with read-modify-write, relying on grid steps that run one
// after another.  None of that carries over.  Here:
//   * the wrapper cuts the target nodes into windows of wn nodes and finds
//     each window's edges (one contiguous, unaligned range, because dst is
//     sorted) with a searchsorted; a CTA walks over whole windows, so every
//     edge row and every node row has exactly one owner: no atomics, no
//     read-modify-write, results bitwise equal from run to run;
//   * a CTA takes its window's edges in tiles of ROWS rows, a warp per row
//     and a lane per output channel, two at Cl(2) (K2's layout): the
//     target gather is an
//     indexed load, the message tile x = [h[dst] - hj, attr] is built in
//     shared memory, and both blocks run from parameters staged once per
//     CTA;
//   * K4 adds each message row into the window's fp32 sum in shared memory,
//     rows in order, and writes the window once (an empty window writes 0);
//   * K5 recomputes both blocks, gathers d(agg) at the row's target, runs
//     the block-2 backward, then the block-1 backward, sums the message
//     cotangent into the window's d(h) in shared memory, and writes
//     dhj = -dmsg and dattr for every row of its range (masked rows get
//     exact zeros).  The parameter gradients are per-CTA partial vectors
//     (channel-mixing ones accumulated in the CTA's own slice of global
//     scratch, as shared memory is full; per-channel ones in registers),
//     summed over the CTAs in a fixed order by reduce_partials_kernel.
//     Holding both blocks' per-channel accumulators through one tile loop
//     needs more than 255 registers, so a CTA sweeps its windows twice in
//     the one launch: both forwards and the block-2 backward, which writes
//     block 2's dx rows to scratch; then block 1's forward (recomputed) and
//     backward from them.
//   * those are the exact-mode K4 and K5.  In fast mode both are the row
//     tiles of cemlp_tile.cuh: 16 edge rows of a window a step, the
//     channel-mixing linears (and K5's weight gradients) as bf16 mma.sync
//     products.  K4 (`fused_mp_fwd_tile_kernel`) runs both blocks' forwards
//     a step and adds the message rows into the window's sum as the row
//     kernel does.  K5 keeps its weight gradients in registers for a whole
//     sweep, so nothing is read back and written per tile in device
//     memory, and sweeps the windows three times, as three launches, each
//     CTA taking the same windows (see `fused_mp_bwd_tile_kernel`).
//
// Precision: exact mode is fp32 throughout.  Fast mode streams h, hj
// and attr as bf16, rounds the message before the first linear and block 1's
// output before the second (as K2 does), rounds each message row to bf16
// before the sum, gathers d(agg) bf16-rounded, writes dhj and dattr as
// bf16, and accumulates d(h) and the parameter gradients in fp32 — the TPU
// kernel's rounding points.

#include "cemlp_tile.cuh"
#include "fused_mp.cuh"

namespace {

// Block-1 input rows of a tile, x = [h[dst] - hj, attr], into shared memory
// as [r][i][m] (rows past `end` are zero), and each
// row's target offset in the window (-1 for a masked edge or a row past
// `end`).
template <class A>
__device__ void load_msg_tile(const float* __restrict__ h,
                              const float* __restrict__ hj,
                              const float* __restrict__ attr,
                              const int* __restrict__ dst,
                              const uint8_t* __restrict__ mask, int64_t row0,
                              int64_t end, int base, int cm, int ca,
                              float* xs, int* dloc) {
  constexpr int NB = A::NB;
  const int tid = threadIdx.x + 32 * threadIdx.y;
  const int cin = cm + ca, per_row = cin * NB;
  if (tid < ROWS) {
    const int64_t row = row0 + tid;
    dloc[tid] = (row < end && (mask == nullptr || mask[row]))
                    ? dst[row] - base : -1;
  }
  for (int e = tid; e < ROWS * per_row; e += THREADS) {
    const int r = e / per_row, rem = e % per_row;
    const int m = rem / NB, i = rem % NB;
    const int64_t row = row0 + r;
    float v = 0.f;
    if (row < end) {
      if (m < cm)
        v = h[(int64_t)dst[row] * cm * NB + rem] - hj[row * cm * NB + rem];
      else
        v = attr[row * ca * NB + (rem - cm * NB)];
    }
    xs[(r * NB + i) * cin + m] = v;
  }
}

// A block's output for this lane's channel slots:
// out[i * si + n * sn] = aln[n] / m * o[i] for every channel n < c it owns.
template <class A>
__device__ __forceinline__ void write_scaled(const Fwd<A> (&f)[A::SLOTS],
                                             const Smem& s, float* out,
                                             int si, int sn, int c,
                                             int lane) {
#pragma unroll
  for (int u = 0; u < A::SLOTS; ++u) {
    const int n = lane + 32 * u;
    if (n >= c) continue;
    const float scale = s.aln[n] / f[u].m;
#pragma unroll
    for (int i = 0; i < A::NB; ++i)
      out[i * si + n * sn] = scale * f[u].o[i];
  }
}

// K4 in exact mode (fp32 throughout); the fast one is
// fused_mp_fwd_tile_kernel.
template <class A>
__global__ void __launch_bounds__(THREADS, 1)
fused_mp_fwd_kernel(const float* __restrict__ h,
                    const float* __restrict__ hj,
                    const float* __restrict__ attr,
                    const int* __restrict__ dst,
                    const uint8_t* __restrict__ mask,
                    const int64_t* __restrict__ bounds, Params p1, Params p2,
                    Tabs<A> tb, float* __restrict__ out, Geom gm) {
  constexpr int NB = A::NB, S = A::SLOTS;
  extern __shared__ float smem[];
  const int cin1 = gm.cm + gm.ca, c = gm.c, per_node = c * NB;
  Smem s1, s2;
  carve_params<A>(smem, cin1, c, s1);
  float* p2base = smem + params_floats<A>(cin1, c);
  carve_params<A>(p2base, c, c, s2);
  float* xs1 = p2base + params_floats<A>(c, c);   // [ROWS][NB][cin1]
  float* zs = xs1 + ROWS * NB * cin1;          // [ROWS][NB][c]
  float* xs2 = zs + ROWS * NB * c;             // [ROWS][NB][c] block-2 input
  float* ys = xs2 + ROWS * NB * c;             // [ROWS][c][NB] messages
  float* acc = ys + ROWS * NB * c;             // [wn][c][NB] window sum
  int* dloc = reinterpret_cast<int*>(acc + gm.wn * per_node);   // [ROWS]
  stage_params<A>(p1, s1, cin1, c);
  stage_params<A>(p2, s2, c, c);

  const int tid = threadIdx.x + 32 * threadIdx.y;
  const int lane = threadIdx.x, r = threadIdx.y;
  for (int w = blockIdx.x; w < gm.n_win; w += gridDim.x) {
    const int base = w * gm.wn;
    const int64_t e0 = bounds[w], e1 = bounds[w + 1];
    for (int e = tid; e < gm.wn * per_node; e += THREADS) acc[e] = 0.f;
    for (int64_t row0 = e0; row0 < e1; row0 += ROWS) {
      __syncthreads();   // staging done / previous tile summed
      load_msg_tile<A>(
          h, hj, attr, dst, mask, row0, e1, base, gm.cm, gm.ca, xs1, dloc);
      __syncthreads();
      if (row0 + r < e1) {   // whole warp: no shuffle partner missing
        float* zt = zs + r * NB * c;
        float* xr2 = xs2 + r * NB * c;
        Fwd<A> f[S];
        block_forward<A>(f, s1, tb, xs1 + r * NB * cin1, zt, cin1, c,
                               lane);
        // block 2 reads its input rounded, as K2 does
        write_scaled<A>(f, s1, xr2, c, 1, c, lane);
        __syncwarp();
        block_forward<A>(f, s2, tb, xr2, zt, c, c, lane);
        write_scaled<A>(f, s2, ys + r * per_node, 1, NB, c, lane);
      }
      __syncthreads();
      const int nrow = (int)(e1 - row0 < ROWS ? e1 - row0 : ROWS);
      for (int e = tid; e < per_node; e += THREADS)
        for (int rr = 0; rr < nrow; ++rr) {
          const int d = dloc[rr];
          if (d >= 0) acc[d * per_node + e] += ys[rr * per_node + e];
        }
    }
    __syncthreads();
    const int nn = gm.n_nodes - base < gm.wn ? gm.n_nodes - base : gm.wn;
    for (int e = tid; e < nn * per_node; e += THREADS)
      out[(int64_t)base * per_node + e] = acc[e];
    __syncthreads();   // window written before the next one zeroes acc
  }
}

// Per-CTA partial gradient slice, two blocks one after the other, each
//   aw1 [(m*NG+g)*C + n] (Cin) | awr (C) | awl (C) | loc [Loc::N][C]
// with the loc rows of acc_to_loc.  The host maps the summed vector onto
// the flax parameter shapes.
template <class A>
__host__ __device__ inline int64_t block_part_floats(int cin, int c) {
  return (int64_t)(cin + 2 * c) * A::NG * c + (int64_t)Loc<A>::N * c;
}
template <class A>
__host__ __device__ inline int64_t part_floats(int cin1, int c) {
  return block_part_floats<A>(cin1, c) + block_part_floats<A>(c, c);
}

template <class A>
__global__ void __launch_bounds__(THREADS, 1)
fused_mp_bwd_kernel(const float* __restrict__ h,
                    const float* __restrict__ hj,
                    const float* __restrict__ attr,
                    const int* __restrict__ dst,
                    const uint8_t* __restrict__ mask,
                    const int64_t* __restrict__ bounds,
                    const float* __restrict__ dagg, Params p1, Params p2,
                    Tabs<A> tb, float* __restrict__ dh,
                    float* __restrict__ dhj,
                    float* __restrict__ dattr,
                    float* __restrict__ dx2, float* __restrict__ partials,
                    Geom gm) {
  constexpr int NB = A::NB, NG = A::NG, NLOC = Loc<A>::N, S = A::SLOTS;
  extern __shared__ float smem[];
  const int cm = gm.cm, ca = gm.ca, cin1 = cm + ca, c = gm.c;
  const int msg_w = cm * NB;   // floats of a message row
  Smem s1, s2;
  carve_params<A>(smem, cin1, c, s1);
  float* p2base = smem + params_floats<A>(cin1, c);
  carve_params<A>(p2base, c, c, s2);
  float* xs1 = p2base + params_floats<A>(c, c);   // [ROWS][NB][cin1]
  float* zs1 = xs1 + ROWS * NB * cin1;         // [ROWS][NB][c]
  float* xs2 = zs1 + ROWS * NB * c;            // block-2 input, rounded
  float* zs2 = xs2 + ROWS * NB * c;
  float* dfs = zs2 + ROWS * NB * c;            // d(first), either block
  float* drs = dfs + ROWS * NB * c;            // d(yr)
  float* dys = drs + ROWS * NB * c;            // d(y)
  float* dxs = dys + ROWS * NB * c;            // [ROWS][cin1][NB] dx rows
  float* dhw = dxs + ROWS * cin1 * NB;         // [wn][cm][NB] window d(h)
  float* loc = dhw + gm.wn * msg_w;            // [NLOC][C]
  int* dloc = reinterpret_cast<int*>(loc + NLOC * c);   // [ROWS]

  float* part = partials + (int64_t)blockIdx.x * part_floats<A>(cin1, c);
  float* aw1_1 = part;
  float* awr_1 = aw1_1 + cin1 * NG * c;
  float* awl_1 = awr_1 + c * NG * c;
  float* loc_1 = awl_1 + c * NG * c;
  float* aw1_2 = loc_1 + NLOC * c;
  float* awr_2 = aw1_2 + c * NG * c;
  float* awl_2 = awr_2 + c * NG * c;
  float* loc_2 = awl_2 + c * NG * c;

  stage_params<A>(p1, s1, cin1, c);
  stage_params<A>(p2, s2, c, c);
  const int tid = threadIdx.x + 32 * threadIdx.y;
  const int64_t n_part = part_floats<A>(cin1, c);
  for (int64_t e = tid; e < n_part; e += THREADS) part[e] = 0.f;
  for (int e = tid; e < NLOC * c; e += THREADS) loc[e] = 0.f;

  const int lane = threadIdx.x, r = threadIdx.y;
  float* xr1 = xs1 + r * NB * cin1;
  float* zt1 = zs1 + r * NB * c;
  float* xr2 = xs2 + r * NB * c;
  float* dft = dfs + r * NB * c;
  float* drt = drs + r * NB * c;
  float* dyt = dys + r * NB * c;
  // ---- sweep 1 over the CTA's windows: both forwards and the block-2
  // backward from d(agg) at the row's target; block 2's dx rows go to the
  // scratch dx2, read back by the same thread in sweep 2
  {
    Acc<A> a2[S];
    acc_zero<A>(a2);
    for (int w = blockIdx.x; w < gm.n_win; w += gridDim.x) {
      const int base = w * gm.wn;
      const int64_t e0 = bounds[w], e1 = bounds[w + 1];
      for (int64_t row0 = e0; row0 < e1; row0 += ROWS) {
        __syncthreads();   // staging and zeroing done / previous tile used
        load_msg_tile<A>(
            h, hj, attr, dst, mask, row0, e1, base, cm, ca, xs1, dloc);
        __syncthreads();
        const int64_t row = row0 + r;
        if (row < e1) {   // whole warp
          const int d = dloc[r];
          Fwd<A> f[S];
          block_forward<A>(f, s1, tb, xr1, zt1, cin1, c, lane);
          write_scaled<A>(f, s1, xr2, c, 1, c, lane);
          __syncwarp();
          block_forward<A>(f, s2, tb, xr2, zs2 + r * NB * c, c, c,
                                 lane);
          float go[S][NB];
#pragma unroll
          for (int u = 0; u < S; ++u) {
            const int n = lane + 32 * u;
#pragma unroll
            for (int i = 0; i < NB; ++i)
              go[u][i] = (n < c && d >= 0)
                  ? dagg[((int64_t)(base + d) * c + n) * NB + i]
                  : 0.f;
          }
          block_backward_row<A>(f, s2, tb, go, a2, dft, drt, dyt,
                                      dx2 + row * c * NB, c, c, lane);
        }
        __syncthreads();
        const int nrow = (int)(e1 - row0 < ROWS ? e1 - row0 : ROWS);
        weight_grads<A>(xs2, zs2, dfs, drs, dys, nrow, c, c, aw1_2, awr_2,
                        awl_2);
      }
    }
    acc_to_loc<A>(a2, loc, c, lane);
    for (int e = tid; e < NLOC * c; e += THREADS) {
      loc_2[e] = loc[e];
      loc[e] = 0.f;
    }
  }
  // ---- sweep 2: block 1's forward and backward from block 2's dx; the
  // message cotangent summed into the window's d(h), rows in order, and
  // written out as dhj = -dmsg with dattr (masked rows zero)
  {
    Acc<A> a1[S];
    acc_zero<A>(a1);
    for (int w = blockIdx.x; w < gm.n_win; w += gridDim.x) {
      const int base = w * gm.wn;
      const int64_t e0 = bounds[w], e1 = bounds[w + 1];
      for (int e = tid; e < gm.wn * msg_w; e += THREADS) dhw[e] = 0.f;
      for (int64_t row0 = e0; row0 < e1; row0 += ROWS) {
        __syncthreads();
        load_msg_tile<A>(
            h, hj, attr, dst, mask, row0, e1, base, cm, ca, xs1, dloc);
        __syncthreads();
        const int64_t row = row0 + r;
        if (row < e1) {
          Fwd<A> f[S];
          block_forward<A>(f, s1, tb, xr1, zt1, cin1, c, lane);
          float go[S][NB];
#pragma unroll
          for (int u = 0; u < S; ++u) {
            const int n = lane + 32 * u;
#pragma unroll
            for (int i = 0; i < NB; ++i)
              go[u][i] = n < c ? dx2[(row * c + n) * NB + i] : 0.f;
          }
          block_backward_row<A>(f, s1, tb, go, a1, dft, drt, dyt,
                                      dxs + r * cin1 * NB, cin1, c, lane);
        }
        __syncthreads();
        const int nrow = (int)(e1 - row0 < ROWS ? e1 - row0 : ROWS);
        weight_grads<A>(xs1, zs1, dfs, drs, dys, nrow, cin1, c, aw1_1, awr_1,
                        awl_1);
        for (int e = tid; e < msg_w; e += THREADS)
          for (int rr = 0; rr < nrow; ++rr) {
            const int dd = dloc[rr];
            if (dd >= 0) dhw[dd * msg_w + e] += dxs[rr * cin1 * NB + e];
          }
        for (int e = tid; e < nrow * msg_w; e += THREADS) {
          const int rr = e / msg_w, k = e % msg_w;
          const float v = dloc[rr] >= 0 ? -dxs[rr * cin1 * NB + k] : 0.f;
          stf(dhj + (row0 + rr) * msg_w + k, v);
        }
        if (ca > 0) {
          const int aw = ca * NB;
          for (int e = tid; e < nrow * aw; e += THREADS) {
            const int rr = e / aw, k = e % aw;
            const float v =
                dloc[rr] >= 0 ? dxs[rr * cin1 * NB + msg_w + k] : 0.f;
            stf(dattr + (row0 + rr) * aw + k, v);
          }
        }
      }
      __syncthreads();
      const int nn = gm.n_nodes - base < gm.wn ? gm.n_nodes - base : gm.wn;
      for (int e = tid; e < nn * msg_w; e += THREADS)
        dh[(int64_t)base * msg_w + e] = dhw[e];
      __syncthreads();   // window written before the next one zeroes dhw
    }
    acc_to_loc<A>(a1, loc, c, lane);
    for (int e = tid; e < NLOC * c; e += THREADS) loc_1[e] = loc[e];
  }
}

// K5 in fast mode: the row tiles of cemlp_tile.cuh, TROWS edge rows of a
// window a step.  Both blocks' parameters (bf16 weights) are staged once;
// the tiles are shared by the two blocks.  A CTA holds one block's
// weight-gradient tiles in registers at a time, and a kernel that ran a
// block's forward and another's backward in one step was twice the code
// and spilled, so the windows are swept three times, as three launches of
// one template (SWEEP, each CTA taking the same windows in each): block
// 1's forward, whose output rows go to the scratch x2s; block 2's backward
// from them, whose dx rows go to the scratch dx2; then block 1's backward
// from those, whose dx rows (the message cotangent) go straight from the
// fragments to dhj and dattr and into the sub-window's d(h) rows, each
// target's rows in order.  A window is taken in sub-windows of WSUB
// targets (each edge range found by a search in dst), which halves the
// d(h) sum's shared memory.  Each sweep writes its block's slice of the
// CTA's partial vector once, at its end.  A sweep stages one block's
// parameters and the tiles it uses, and no more.
constexpr int WSUB = 16;

// Weight-gradient tiles of sweep `sweep`'s block (none in sweep 0).
template <class A>
__host__ __device__ inline int sweep_tiles(int sweep, const TileGeom& t1,
                                           const TileGeom& t2) {
  return sweep == 0 ? 0 : wgrad_tiles<A>(sweep == 1 ? t2 : t1);
}

// Shared-memory bytes of sweep `sweep` (0, 1, 2), in the order the kernel
// carves them: the block's parameters, x1 (sweeps 0, 2), x2 (0, 1), the
// c-wide tiles, the sub-window's d(h) (2), the rows' targets (0, 2).
template <class A>
__host__ __device__ inline size_t tile_sweep_bytes(int sweep, int cm, int ca,
                                                   int c) {
  const int cin1 = cm + ca;
  const TileGeom t1 = tile_geom(cin1, c), t2 = tile_geom(c, c);
  size_t b = tparams_bytes<A>(sweep == 1 ? t2 : t1);
  if (sweep != 1) b += al16(2 * (size_t)A::NB * TROWS * t1.ldb);
  if (sweep != 2) b += al16(2 * (size_t)A::NB * TROWS * t2.ldb);
  b += tilebufs_bytes<A>(t2, sweep_tiles<A>(sweep, t1, t2));
  if (sweep == 2) b += al16(4 * (size_t)WSUB * cm * A::NB);
  if (sweep != 1) b += al16(4 * TROWS);
  return b;
}

// First edge in [lo, hi) whose target is >= v (dst ascending).
__device__ __forceinline__ int64_t lower_edge(const int* __restrict__ dst,
                                              int64_t lo, int64_t hi, int v) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;
    if (dst[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float4 ld_bf16x4(const bf16* p) {   // 8-byte aligned
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}

// A step's block-1 input rows, x = [h[dst] - hj, attr] rounded to bf16, as
// [NB][R][ldx]; each row's target offset in the sub-window (-1 for a
// masked edge or a row past nrow).
template <class A>
__device__ __forceinline__ void load_msg_tile_bf16(
    const bf16* __restrict__ h, const bf16* __restrict__ hj,
    const bf16* __restrict__ attr, const int* __restrict__ dst,
    const uint8_t* __restrict__ mask, int64_t row0, int nrow, int base,
    int cm, int ca, bf16* xb, int ldx, int* dloc) {
  constexpr int NB = A::NB;
  const int tid = threadIdx.x + 32 * threadIdx.y;
  const int per_row = (cm + ca) * NB;
  if (tid < TROWS) {
    const int64_t row = row0 + tid;
    dloc[tid] = (tid < nrow && (mask == nullptr || mask[row]))
                    ? dst[row] - base : -1;
  }
  // rows of h, hj and attr in runs of 4 bf16 (NB % 4 == 0)
  const int per4 = per_row / 4;
  copy_in4(
      TROWS * per4,
      [&](int e) {
        const int r = e / per4, rem = 4 * (e % per4);
        if (r >= nrow) return make_float4(0.f, 0.f, 0.f, 0.f);
        const int64_t row = row0 + r;
        float4 v;
        if (rem < cm * NB) {
          const float4 a = ld_bf16x4(h + (int64_t)dst[row] * cm * NB + rem);
          const float4 b = ld_bf16x4(hj + row * cm * NB + rem);
          v = make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
        } else {
          v = ld_bf16x4(attr + row * ca * NB + (rem - cm * NB));
        }
        return v;
      },
      [&](int e, float4 v) {
        const int r = e / per4, rem = 4 * (e % per4);
        bf16* d = xb + (size_t)((rem % NB) * TROWS + r) * ldx + rem / NB;
        const size_t step = (size_t)TROWS * ldx;
        d[0] = __float2bfloat16_rn(v.x);
        d[step] = __float2bfloat16_rn(v.y);
        d[2 * step] = __float2bfloat16_rn(v.z);
        d[3 * step] = __float2bfloat16_rn(v.w);
      });
}

// One block's slice of the CTA's partial vector, aw1 [(m*NG+g)*C + n]
// (Cin) | awr | awl | loc, from this sweep's accumulators.
template <class A, int MAXT>
__device__ __forceinline__ void write_slice(float* sl, int cin, int c,
                                            const float (&wacc)[MAXT][4],
                                            const TileGeom& t,
                                            const FragAcc<A>& fa,
                                            const TileBufs& b, int warp,
                                            int lane) {
  constexpr int NG = A::NG;
  const int tid = lane + 32 * warp;
  const int64_t o1 = (int64_t)cin * NG * c, o2 = o1 + (int64_t)c * NG * c;
  write_wgrads<A, MAXT>(wacc, t, warp, lane,
                        [&](int which, int m, int n, int g, float v) {
    sl[(which == 0 ? 0 : which == 1 ? o1 : o2) + ((int64_t)m * NG + g) * c +
       n] = v;
  });
  accs_to_loc<A>(fa, b, t, warp, lane);
  float* loc = sl + o2 + (int64_t)c * NG * c;
  for (int e = tid; e < Loc<A>::N * c; e += THREADS) loc[e] = b.loc[e];
}

template <class A, int MAXT, int SWEEP>
__global__ void __launch_bounds__(THREADS, 1)
fused_mp_bwd_tile_kernel(const bf16* __restrict__ h,
                         const bf16* __restrict__ hj,
                         const bf16* __restrict__ attr,
                         const int* __restrict__ dst,
                         const uint8_t* __restrict__ mask,
                         const int64_t* __restrict__ bounds,
                         const float* __restrict__ dagg, Params p1,
                         Params p2, Tabs<A> tb, float* __restrict__ dh,
                         bf16* __restrict__ dhj, bf16* __restrict__ dattr,
                         float* dx2, bf16* x2s, float* __restrict__ partials,
                         Geom gm) {
  constexpr int NB = A::NB;
  extern __shared__ float smem[];
  const int cm = gm.cm, ca = gm.ca, cin1 = cm + ca, c = gm.c;
  const int msg_w = cm * NB, out_w = c * NB;
  const TileGeom t1 = tile_geom(cin1, c), t2 = tile_geom(c, c);
  // carved as tile_sweep_bytes counts
  TParams sp;   // the sweep's block: 2 in sweep 1, else 1
  char* q = carve_tparams<A>(reinterpret_cast<char*>(smem),
                             SWEEP == 1 ? t2 : t1, sp);
  bf16* x1 = nullptr;   // [NB][TROWS][t1.ldb], the whole tile (one chunk)
  bf16* x2 = nullptr;   // [NB][TROWS][t2.ldb]
  if (SWEEP != 1) {
    x1 = reinterpret_cast<bf16*>(q);
    q += al16(2 * (size_t)NB * TROWS * t1.ldb);
  }
  if (SWEEP != 2) {
    x2 = reinterpret_cast<bf16*>(q);
    q += al16(2 * (size_t)NB * TROWS * t2.ldb);
  }
  TileBufs b;   // the c-wide geometry of both blocks is t2's
  q = carve_tilebufs<A>(q, t2, sweep_tiles<A>(SWEEP, t1, t2), b);
  b.go_rnd = SWEEP == 1;   // d(agg) enters rounded, as in the row kernel
  float* dhw = nullptr;     // [WSUB][cm][NB] d(h) rows
  if (SWEEP == 2) {
    dhw = reinterpret_cast<float*>(q);
    q += al16(4 * (size_t)WSUB * msg_w);
  }
  int* dloc = reinterpret_cast<int*>(q);      // [TROWS]
  if (SWEEP == 1)
    stage_tparams<A>(p2, sp, t2);
  else
    stage_tparams<A>(p1, sp, t1);
  if (x1 != nullptr) zero_bf16(x1, NB * TROWS * t1.ldb);
  if (x2 != nullptr) zero_bf16(x2, NB * TROWS * t2.ldb);
  zero_tilebufs<A>(b, t2);
  if (SWEEP == 1)
    build_wdesc<A>(b, t2, x2);
  else if (SWEEP == 2)
    build_wdesc<A>(b, t1, x1);
  auto no_load = [](int) {};   // x tiles are whole here

  const int warp = threadIdx.y, lane = threadIdx.x;
  const int tid = lane + 32 * warp;
  const int n_sub = gm.wn / WSUB + (gm.wn % WSUB ? 1 : 0);
  float* part = partials + (int64_t)blockIdx.x * part_floats<A>(cin1, c);

  // ---- sweep 0: block 1's forward; its output rows, block 2's input
  // rounded to bf16, to the scratch x2s ([E][NB][C])
  if constexpr (SWEEP == 0) {
    for (int w = blockIdx.x; w < gm.n_win; w += gridDim.x) {
      const int base = w * gm.wn;
      const int64_t e0 = bounds[w], e1 = bounds[w + 1];
      for (int64_t row0 = e0; row0 < e1; row0 += TROWS) {
        const int nrow = e1 - row0 < TROWS ? (int)(e1 - row0) : TROWS;
        __syncthreads();
        load_msg_tile_bf16<A>(h, hj, attr, dst, mask, row0, nrow, base, cm,
                              ca, x1, t1.ldb, dloc);
        __syncthreads();
        tile_block_forward<A, false>(sp, tb, x1, b, t1, nrow,
                                     Bf16TileSink<NB>{x2, t2.ldb}, no_load,
                                     warp, lane);
        for (int e = tid; e < nrow * out_w; e += THREADS) {
          const int r = e / out_w, i = (e / c) % NB, n = e % c;
          x2s[row0 * out_w + e] = x2[(size_t)(i * TROWS + r) * t2.ldb + n];
        }
      }
    }
  }
  // ---- sweep 1: block 2's backward from its input rows in x2s and d(agg)
  // at the row's target; block 2's dx rows (block 1's output cotangent)
  // to dx2
  if constexpr (SWEEP == 1) {
    FragAcc<A> fa;
    zero_accs<A>(fa, b, t2);
    float wacc[MAXT][4];
#pragma unroll
    for (int j = 0; j < MAXT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) wacc[j][k] = 0.f;
    for (int w = blockIdx.x; w < gm.n_win; w += gridDim.x) {
      const int64_t e0 = bounds[w], e1 = bounds[w + 1];
      for (int64_t row0 = e0; row0 < e1; row0 += TROWS) {
        const int nrow = e1 - row0 < TROWS ? (int)(e1 - row0) : TROWS;
        __syncthreads();
        for (int e = tid; e < TROWS * out_w; e += THREADS) {
          const int r = e / out_w, i = (e / c) % NB, n = e % c;
          x2[(size_t)(i * TROWS + r) * t2.ldb + n] =
              r < nrow ? x2s[row0 * out_w + e] : __float2bfloat16_rn(0.f);
        }
        if (tid < TROWS) {
          const int64_t row = row0 + tid;
          b.gor[tid] = tid < nrow && (mask == nullptr || mask[row])
                           ? dagg + (int64_t)dst[row] * out_w : nullptr;
        }
        __syncthreads();
        auto sink = [&](int r, int m, const float (&v)[NB]) {
          float4* d =
              reinterpret_cast<float4*>(dx2 + ((row0 + r) * c + m) * NB);
#pragma unroll
          for (int k = 0; k < NB / 4; ++k)
            d[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                               v[4 * k + 3]);
        };
        tile_block_backward<A, MAXT, false, false>(sp, tb, x2, b, t2, nrow,
                                                   sink, no_load, fa, wacc,
                                                   warp, lane);
      }
    }
    write_slice<A, MAXT>(part + block_part_floats<A>(cin1, c), c, c, wacc,
                         t2, fa, b, warp, lane);
  }
  // ---- sweep 2: block 1's backward from block 2's dx; the message
  // cotangent summed into the sub-window's d(h), each target's rows in
  // order, and written out as dhj = -dmsg with dattr (masked rows zero)
  if constexpr (SWEEP == 2) {
    FragAcc<A> fa;
    zero_accs<A>(fa, b, t2);
    float wacc[MAXT][4];
#pragma unroll
    for (int j = 0; j < MAXT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) wacc[j][k] = 0.f;
    const int aw = ca * NB;
    for (int w = blockIdx.x; w < gm.n_win; w += gridDim.x) {
      const int64_t we0 = bounds[w], we1 = bounds[w + 1];
      for (int sw = 0; sw < n_sub; ++sw) {
        const int base = w * gm.wn + sw * WSUB;
        if (base >= gm.n_nodes) break;
        const int64_t e0 =
            sw == 0 ? we0 : lower_edge(dst, we0, we1, base);
        const int64_t e1 =
            sw == n_sub - 1 ? we1 : lower_edge(dst, we0, we1, base + WSUB);
        __syncthreads();
        for (int e = tid; e < WSUB * msg_w; e += THREADS) dhw[e] = 0.f;
        for (int64_t row0 = e0; row0 < e1; row0 += TROWS) {
          const int nrow = e1 - row0 < TROWS ? (int)(e1 - row0) : TROWS;
          __syncthreads();
          load_msg_tile_bf16<A>(h, hj, attr, dst, mask, row0, nrow, base, cm,
                                ca, x1, t1.ldb, dloc);
          if (tid < TROWS)
            b.gor[tid] = tid < nrow ? dx2 + (row0 + tid) * out_w : nullptr;
          __syncthreads();
          // row r's message cotangent at input channel m, rows in order
          auto sink = [&](int r, int m, const float (&v)[NB]) {
            const int dd = dloc[r];
            if (m < cm) {
              st_bf16<NB>(dhj + (row0 + r) * msg_w + m * NB, v, -1.f,
                          dd >= 0);
              if (dd >= 0) {
                float4* d = reinterpret_cast<float4*>(dhw + dd * msg_w +
                                                      m * NB);
#pragma unroll
                for (int k = 0; k < NB / 4; ++k) {
                  float4 u = d[k];
                  u.x += v[4 * k];
                  u.y += v[4 * k + 1];
                  u.z += v[4 * k + 2];
                  u.w += v[4 * k + 3];
                  d[k] = u;
                }
              }
            } else {
              st_bf16<NB>(dattr + (row0 + r) * aw + (m - cm) * NB, v, 1.f,
                          dd >= 0);
            }
          };
          tile_block_backward<A, MAXT, true, false>(sp, tb, x1, b, t1, nrow,
                                                    sink, no_load, fa, wacc,
                                                    warp, lane);
        }
        __syncthreads();
        int nn = gm.n_nodes - base < WSUB ? gm.n_nodes - base : WSUB;
        nn = (w + 1) * gm.wn - base < nn ? (w + 1) * gm.wn - base : nn;
        for (int e = tid; e < nn * msg_w; e += THREADS)
          dh[(int64_t)base * msg_w + e] = dhw[e];
      }
    }
    write_slice<A, MAXT>(part, cin1, c, wacc, t1, fa, b, warp, lane);
  }
}

template <class A>
size_t fwd_smem_bytes(int cm, int ca, int c, int wn) {
  const int cin1 = cm + ca;
  return sizeof(float) * ((size_t)params_floats<A>(cin1, c) +
                          params_floats<A>(c, c) +
                          ROWS * A::NB * (size_t)(cin1 + 3 * c) +
                          (size_t)wn * c * A::NB) +
         sizeof(int) * ROWS;
}

template <class A>
size_t bwd_smem_bytes(int cm, int ca, int c, int wn) {
  const int cin1 = cm + ca;
  return sizeof(float) * ((size_t)params_floats<A>(cin1, c) +
                          params_floats<A>(c, c) +
                          ROWS * A::NB * (size_t)(2 * cin1 + 6 * c) +
                          (size_t)wn * cm * A::NB +
                          (size_t)Loc<A>::N * c) +
         sizeof(int) * ROWS;
}

template <class A>
bool widths_ok(int cm, int ca, int c, int wn) {
  return cm >= 1 && ca >= 0 && c >= 1 && c <= 32 * A::SLOTS && wn >= 1;
}

template <class A>
size_t smem_bytes(int cm, int ca, int c, int wn, int backward) {
  if (!widths_ok<A>(cm, ca, c, wn)) return 0;
  return backward ? bwd_smem_bytes<A>(cm, ca, c, wn)
                  : fwd_smem_bytes<A>(cm, ca, c, wn);
}

// Shared-memory bytes of the fast-mode backward's largest sweep (the row
// tiles), or 0 where it does not take the widths (see cemlp.cu's
// tile_plan; K5's x tiles are whole).  K5's backward sweeps are
// instantiated at 16, 24 and 32 weight-gradient tiles a warp.
template <class A>
int fused_maxt(int cin, int c) {
  const int m = tile_maxt<A>(tile_geom(cin, c));
  return m == 20 ? 24 : m == 40 ? 0 : m;
}

template <class A>
size_t tile_smem_bytes(int cm, int ca, int c, int wn) {
  if (!widths_ok<A>(cm, ca, c, wn) || c > 64) return 0;
  size_t bytes = 0;
  for (int sweep = 0; sweep < 3; ++sweep) {
    const size_t b = tile_sweep_bytes<A>(sweep, cm, ca, c);
    bytes = b > bytes ? b : bytes;
  }
  if (fused_maxt<A>(cm + ca, c) == 0 || fused_maxt<A>(c, c) == 0 ||
      bytes > kMaxSmem)
    return 0;
  return bytes;
}

// K4 in fast mode: the row tiles of cemlp_tile.cuh, TROWS edge rows of a
// window a step: the step's message tile (load_msg_tile_bf16), block 1's
// forward into the bf16 x2 tile (tile_block_forward: F1 and F2 on the
// tensor cores, the row phase a warp per row), block 2's forward from x2,
// whose output rows (the messages, rounded to bf16) it writes over x2
// once its F1 has read it; then each element of the message rows is added
// into the window's fp32 sum in shared memory by one thread, the step's
// rows in order.  Both blocks' parameters are staged once (bf16 weights).
// The sum is written once.  Where a whole window's sum does not fit in
// shared memory beside the rest (at Cl(2), C of 49 and more), a CTA takes
// its window in sub-windows of wsub targets, each edge range found by a
// search in dst and each sub-window's sum written once.

// Shared-memory bytes of the fast forward summing wsub targets at a time,
// in the order the kernel carves them.
template <class A>
__host__ __device__ inline size_t fwd_tile_bytes(int cm, int ca, int c,
                                                 int wsub) {
  const TileGeom t1 = tile_geom(cm + ca, c), t2 = tile_geom(c, c);
  return tparams_bytes<A>(t1) + tparams_bytes<A>(t2) +
         al16(2 * (size_t)A::NB * TROWS * t1.ldb) +      // x1
         2 * al16(2 * (size_t)A::NB * TROWS * t2.ldc) +  // z, x2
         2 * al16(4 * (size_t)A::NB * TROWS * t2.fp) +   // yr, first
         al16(4 * (size_t)wsub * A::NB * (c | 1)) +      // the sum
         al16(4 * TROWS);                                // the rows' targets
}

// The targets the fast forward sums at a time: the window's wn, else the
// widest of 16 and 8 that fits; 0 where none does.
template <class A>
int fwd_tile_wsub(int cm, int ca, int c, int wn) {
  if (!widths_ok<A>(cm, ca, c, wn) || c > 64) return 0;
  const int cand[3] = {wn, 16, 8};
  for (int k = 0; k < 3; ++k)
    if (cand[k] <= wn && fwd_tile_bytes<A>(cm, ca, c, cand[k]) <= kMaxSmem)
      return cand[k];
  return 0;
}

template <class A>
size_t fwd_tile_smem_bytes(int cm, int ca, int c, int wn) {
  const int wsub = fwd_tile_wsub<A>(cm, ca, c, wn);
  return wsub == 0 ? 0 : fwd_tile_bytes<A>(cm, ca, c, wsub);
}

template <class A>
__global__ void __launch_bounds__(THREADS, 1)
fused_mp_fwd_tile_kernel(const bf16* __restrict__ h,
                         const bf16* __restrict__ hj,
                         const bf16* __restrict__ attr,
                         const int* __restrict__ dst,
                         const uint8_t* __restrict__ mask,
                         const int64_t* __restrict__ bounds, Params p1,
                         Params p2, Tabs<A> tb, float* __restrict__ out,
                         Geom gm, int wsub) {
  constexpr int NB = A::NB;
  extern __shared__ float smem[];
  const int cm = gm.cm, ca = gm.ca, c = gm.c, cp = c | 1, out_w = c * NB;
  const TileGeom t1 = tile_geom(cm + ca, c), t2 = tile_geom(c, c);
  // carved as fwd_tile_bytes counts
  TParams s1, s2;
  char* q = carve_tparams<A>(reinterpret_cast<char*>(smem), t1, s1);
  q = carve_tparams<A>(q, t2, s2);
  bf16* x1 = reinterpret_cast<bf16*>(q);   // [NB][TROWS][t1.ldb]
  q += al16(2 * (size_t)NB * TROWS * t1.ldb);
  TileBufs b{};   // the forward's tiles, in t2's geometry: z, yr, first
  b.z = reinterpret_cast<bf16*>(q);
  q += al16(2 * (size_t)NB * TROWS * t2.ldc);
  bf16* x2 = reinterpret_cast<bf16*>(q);   // block 2's input, then output
  q += al16(2 * (size_t)NB * TROWS * t2.ldc);
  b.yr = reinterpret_cast<float*>(q);
  q += al16(4 * (size_t)NB * TROWS * t2.fp);
  b.ff = reinterpret_cast<float*>(q);
  q += al16(4 * (size_t)NB * TROWS * t2.fp);
  float* acc = reinterpret_cast<float*>(q);   // [wsub][NB][cp]
  q += al16(4 * (size_t)wsub * NB * cp);
  int* dloc = reinterpret_cast<int*>(q);      // [TROWS]
  stage_tparams<A>(p1, s1, t1);
  stage_tparams<A>(p2, s2, t2);
  zero_bf16(x1, NB * TROWS * t1.ldb);   // the padded columns stay zero
  zero_bf16(b.z, NB * TROWS * t2.ldc);
  zero_bf16(x2, NB * TROWS * t2.ldc);
  auto no_load = [](int) {};   // x tiles are whole here

  const int warp = threadIdx.y, lane = threadIdx.x;
  const int tid = lane + 32 * warp;
  const int n_sub = (gm.wn + wsub - 1) / wsub;
  for (int w = blockIdx.x; w < gm.n_win; w += gridDim.x) {
    const int64_t we0 = bounds[w], we1 = bounds[w + 1];
    for (int sw = 0; sw < n_sub; ++sw) {
      const int base = w * gm.wn + sw * wsub;
      if (base >= gm.n_nodes) break;
      const int64_t e0 = sw == 0 ? we0 : lower_edge(dst, we0, we1, base);
      const int64_t e1 =
          sw == n_sub - 1 ? we1 : lower_edge(dst, we0, we1, base + wsub);
      __syncthreads();   // staging done / the previous sum written
      for (int e = tid; e < wsub * NB * cp; e += THREADS) acc[e] = 0.f;
      for (int64_t row0 = e0; row0 < e1; row0 += TROWS) {
        const int nrow = e1 - row0 < TROWS ? (int)(e1 - row0) : TROWS;
        __syncthreads();   // the sum zeroed / the previous step's added
        load_msg_tile_bf16<A>(h, hj, attr, dst, mask, row0, nrow, base, cm,
                              ca, x1, t1.ldb, dloc);
        __syncthreads();
        tile_block_forward<A, false>(s1, tb, x1, b, t1, nrow,
                                     Bf16TileSink<NB>{x2, t2.ldb}, no_load,
                                     warp, lane);
        tile_block_forward<A, false>(s2, tb, x2, b, t2, nrow,
                                     Bf16TileSink<NB>{x2, t2.ldb}, no_load,
                                     warp, lane);
        // element (i, n) of every message row, by one thread, rows in order
        for (int e = tid; e < out_w; e += THREADS) {
          const int i = e / c, n = e % c;
          const bf16* m = x2 + (size_t)i * TROWS * t2.ldb + n;
          float* a = acc + i * cp + n;
          for (int r = 0; r < nrow; ++r) {
            const int d = dloc[r];
            if (d >= 0)
              a[d * NB * cp] += __bfloat162float(m[(size_t)r * t2.ldb]);
          }
        }
      }
      __syncthreads();
      int nn = gm.n_nodes - base < wsub ? gm.n_nodes - base : wsub;
      nn = (w + 1) * gm.wn - base < nn ? (w + 1) * gm.wn - base : nn;
      for (int e = tid; e < nn * out_w; e += THREADS) {
        const int v = e / out_w, n = (e / NB) % c, i = e % NB;
        out[(int64_t)base * out_w + e] = acc[(v * NB + i) * cp + n];
      }
    }
  }
}

Params params_at(const float* const* pp) {
  return Params{pp[0], pp[1], pp[2], pp[3], pp[4],
                pp[5], pp[6], pp[7], pp[8], pp[9]};
}

// Fast mode: the row tiles at the widest sum that fits; exact mode: the
// row kernel.
template <class A>
int launch_fwd(const void* h, const void* hj, const void* attr,
               const int* dst, const uint8_t* mask, const int64_t* bounds,
               const float* const* params, Tabs<A> tb, float* out, Geom gm,
               int fast, int grid, cudaStream_t st) {
  if (fast) {
    const int wsub = fwd_tile_wsub<A>(gm.cm, gm.ca, gm.c, gm.wn);
    const size_t bytes = fwd_tile_bytes<A>(gm.cm, gm.ca, gm.c, wsub);
    cudaFuncSetAttribute(fused_mp_fwd_tile_kernel<A>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    fused_mp_fwd_tile_kernel<A><<<grid, dim3(32, TWARPS), bytes, st>>>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(hj),
        static_cast<const bf16*>(attr), dst, mask, bounds, params_at(params),
        params_at(params + 10), tb, out, gm, wsub);
    return (int)cudaGetLastError();
  }
  const size_t bytes = fwd_smem_bytes<A>(gm.cm, gm.ca, gm.c, gm.wn);
  cudaFuncSetAttribute(fused_mp_fwd_kernel<A>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  fused_mp_fwd_kernel<A><<<grid, dim3(32, ROWS), bytes, st>>>(
      static_cast<const float*>(h), static_cast<const float*>(hj),
      static_cast<const float*>(attr), dst, mask, bounds, params_at(params),
      params_at(params + 10), tb, out, gm);
  return (int)cudaGetLastError();
}

template <class A, int MAXT, int SWEEP>
void launch_sweep(const void* h, const void* hj, const void* attr,
                  const int* dst, const uint8_t* mask, const int64_t* bounds,
                  const float* dagg, const float* const* params,
                  const Tabs<A>& tb, float* dh, void* dhj, void* dattr,
                  float* dx2, void* x2s, float* partials, Geom gm, int grid,
                  size_t bytes, cudaStream_t st) {
  cudaFuncSetAttribute(fused_mp_bwd_tile_kernel<A, MAXT, SWEEP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  fused_mp_bwd_tile_kernel<A, MAXT, SWEEP>
      <<<grid, dim3(32, TWARPS), bytes, st>>>(
          static_cast<const bf16*>(h), static_cast<const bf16*>(hj),
          static_cast<const bf16*>(attr), dst, mask, bounds, dagg,
          params_at(params), params_at(params + 10), tb, dh,
          static_cast<bf16*>(dhj), static_cast<bf16*>(dattr), dx2,
          static_cast<bf16*>(x2s), partials, gm);
}

// One sweep at the MAXT its block's weight-gradient tiles need.
template <class A, int SWEEP>
void launch_sweep_maxt(int maxt, const void* h, const void* hj,
                       const void* attr, const int* dst, const uint8_t* mask,
                       const int64_t* bounds, const float* dagg,
                       const float* const* params, const Tabs<A>& tb,
                       float* dh, void* dhj, void* dattr, float* dx2,
                       void* x2s, float* partials, Geom gm, int grid,
                       size_t bytes, cudaStream_t st) {
#define CSMPN_SWEEP(M)                                                        \
  launch_sweep<A, M, SWEEP>(h, hj, attr, dst, mask, bounds, dagg, params, tb, \
                            dh, dhj, dattr, dx2, x2s, partials, gm, grid,     \
                            bytes, st)
  if (maxt == 16)
    CSMPN_SWEEP(16);
  else if (maxt == 24)
    CSMPN_SWEEP(24);
  else
    CSMPN_SWEEP(32);
#undef CSMPN_SWEEP
}

template <class A>
int launch_bwd(const void* h, const void* hj, const void* attr,
               const int* dst, const uint8_t* mask, const int64_t* bounds,
               const float* dagg, const float* const* params, Tabs<A> tb,
               float* dh, void* dhj, void* dattr, float* dx2, void* x2s,
               float* partials, Geom gm, int fast, int grid,
               cudaStream_t st) {
  if (fast) {
    auto bytes = [&](int sweep) {
      return tile_sweep_bytes<A>(sweep, gm.cm, gm.ca, gm.c);
    };
    launch_sweep<A, 16, 0>(h, hj, attr, dst, mask, bounds, dagg, params, tb,
                           dh, dhj, dattr, dx2, x2s, partials, gm, grid,
                           bytes(0), st);
    launch_sweep_maxt<A, 1>(fused_maxt<A>(gm.c, gm.c), h, hj, attr,
                            dst, mask, bounds, dagg, params, tb, dh, dhj,
                            dattr, dx2, x2s, partials, gm, grid, bytes(1),
                            st);
    launch_sweep_maxt<A, 2>(fused_maxt<A>(gm.cm + gm.ca, gm.c), h,
                            hj, attr, dst, mask, bounds, dagg, params, tb, dh,
                            dhj, dattr, dx2, x2s, partials, gm, grid,
                            bytes(2), st);
    return (int)cudaGetLastError();
  }
  const size_t bytes = bwd_smem_bytes<A>(gm.cm, gm.ca, gm.c, gm.wn);
  cudaFuncSetAttribute(fused_mp_bwd_kernel<A>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  fused_mp_bwd_kernel<A><<<grid, dim3(32, ROWS), bytes, st>>>(
      static_cast<const float*>(h), static_cast<const float*>(hj),
      static_cast<const float*>(attr), dst, mask, bounds, dagg,
      params_at(params), params_at(params + 10), tb, dh,
      static_cast<float*>(dhj), static_cast<float*>(dattr), dx2, partials, gm);
  return (int)cudaGetLastError();
}

template <class A>
int fwd_entry(const void* h, const void* hj, const void* attr,
              const int* dst, const uint8_t* mask, const int64_t* bounds,
              const float* const* params, const float* bc, const float* sign,
              float* out, int n_nodes, int cm, int ca, int c, int wn,
              int n_win, int fast, int grid, void* stream) {
  const size_t bytes = fast ? fwd_tile_smem_bytes<A>(cm, ca, c, wn)
                            : fwd_smem_bytes<A>(cm, ca, c, wn);
  if (!widths_ok<A>(cm, ca, c, wn) || bytes == 0 || bytes > kMaxSmem ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  Geom gm{n_nodes, cm, ca, c, wn, n_win};
  Tabs<A> tb = make_tabs<A>(bc, sign);
  return launch_fwd<A>(h, hj, attr, dst, mask, bounds, params, tb, out, gm,
                       fast, grid, static_cast<cudaStream_t>(stream));
}

template <class A>
int bwd_entry(const void* h, const void* hj, const void* attr,
              const int* dst, const uint8_t* mask, const int64_t* bounds,
              const float* dagg, const float* const* params, const float* bc,
              const float* sign, float* dh, void* dhj, void* dattr,
              float* dx2, void* x2s, float* partials, float* grads,
              int n_nodes, int cm, int ca, int c, int wn, int n_win, int fast,
              int grid, void* stream) {
  const size_t bytes = fast ? tile_smem_bytes<A>(cm, ca, c, wn)
                            : bwd_smem_bytes<A>(cm, ca, c, wn);
  if (!widths_ok<A>(cm, ca, c, wn) || bytes == 0 || bytes > kMaxSmem ||
      grid < 1 || (fast && x2s == nullptr))
    return (int)cudaErrorInvalidValue;
  Geom gm{n_nodes, cm, ca, c, wn, n_win};
  Tabs<A> tb = make_tabs<A>(bc, sign);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_bwd<A>(h, hj, attr, dst, mask, bounds, dagg, params,
                                tb, dh, dhj, dattr, dx2, x2s, partials, gm,
                                fast, grid, st);
  if (err != (int)cudaSuccess) return err;
  const int64_t n = part_floats<A>(cm + ca, c);
  reduce_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      partials, grads, n, grid);
  return (int)cudaGetLastError();
}

}  // namespace

// One set of C entry points per algebra: csmpn_fused_mp_* (Cl(3,0)) and
// csmpn_fused_mp_cl2_* (Cl(2,0)).
//   smem_bytes: shared-memory bytes of a launch (0 if the widths are not
//     supported); tile_smem_bytes: those of the fast-mode backward;
//     fwd_tile_smem_bytes: those of the fast-mode forward, and
//     fwd_tile_wsub the targets it sums at a time (wn, or less where a
//     window's sum does not fit; 0 where none does);
//     tile_maxt: the weight-gradient tiles a warp (the kernel instance) of
//     its sweep `sweep` (0, 1, 2), 0 where it does not take the widths;
//   partial_floats: floats of one CTA's partial gradient slice (the layout
//     above);
//   fwd: h (N, cm, NB), hj (E, cm, NB), attr (E, ca, NB) or null, bf16 if
//     fast, else fp32; dst (E,) int32 ascending; mask (E,) bytes or null;
//     bounds (n_win + 1,) int64 window edge offsets; params: host array of
//     the 20 device pointers of the two blocks (flax order, 10 each); bc and
//     sign: host tables of the algebra.  out (N, C, NB) fp32: the sum over
//     unmasked edges;
//   bwd: dagg (N, C, NB) fp32, the cotangent of the sum.  Outputs: dh
//     (N, cm, NB) fp32; dhj (E, cm, NB) and dattr (E, ca, NB) in the stream
//     type; grads (partial_floats,) the summed slice.  Scratch: dx2
//     (E, C, NB) fp32, block 2's dx rows; x2s (E, NB, C) bf16, block 2's
//     input rows (fast mode; null in exact); partials (grid,
//     partial_floats);
//   tables: the structural tables the kernels assume (see
//     csmpn_cemlp_tables).
#define CSMPN_FUSED_MP_ENTRIES(PREFIX, ALG)                                   \
  size_t PREFIX##_smem_bytes(int cm, int ca, int c, int wn, int backward) {   \
    return smem_bytes<ALG>(cm, ca, c, wn, backward);                          \
  }                                                                           \
  size_t PREFIX##_tile_smem_bytes(int cm, int ca, int c, int wn) {            \
    return tile_smem_bytes<ALG>(cm, ca, c, wn);                               \
  }                                                                           \
  size_t PREFIX##_fwd_tile_smem_bytes(int cm, int ca, int c, int wn) {        \
    return fwd_tile_smem_bytes<ALG>(cm, ca, c, wn);                           \
  }                                                                           \
  int PREFIX##_fwd_tile_wsub(int cm, int ca, int c, int wn) {                 \
    return fwd_tile_wsub<ALG>(cm, ca, c, wn);                                 \
  }                                                                           \
  int PREFIX##_tile_maxt(int cm, int ca, int c, int wn, int sweep) {          \
    if (tile_smem_bytes<ALG>(cm, ca, c, wn) == 0) return 0;                   \
    return sweep == 0 ? 16 : fused_maxt<ALG>(sweep == 1 ? c : cm + ca, c);    \
  }                                                                           \
  int64_t PREFIX##_partial_floats(int cm, int ca, int c) {                    \
    return part_floats<ALG>(cm + ca, c);                                      \
  }                                                                           \
  int PREFIX##_fwd(const void* h, const void* hj, const void* attr,           \
                   const int* dst, const uint8_t* mask,                       \
                   const int64_t* bounds, const float* const* params,         \
                   const float* bc, const float* sign, float* out,            \
                   int n_nodes, int cm, int ca, int c, int wn, int n_win,     \
                   int fast, int grid, void* stream) {                        \
    return fwd_entry<ALG>(h, hj, attr, dst, mask, bounds, params, bc, sign,   \
                          out, n_nodes, cm, ca, c, wn, n_win, fast, grid,     \
                          stream);                                            \
  }                                                                           \
  int PREFIX##_bwd(const void* h, const void* hj, const void* attr,           \
                   const int* dst, const uint8_t* mask,                       \
                   const int64_t* bounds, const float* dagg,                  \
                   const float* const* params, const float* bc,               \
                   const float* sign, float* dh, void* dhj, void* dattr,      \
                   float* dx2, void* x2s, float* partials, float* grads,      \
                   int n_nodes, int cm, int ca, int c, int wn, int n_win,     \
                   int fast, int grid, void* stream) {                        \
    return bwd_entry<ALG>(h, hj, attr, dst, mask, bounds, dagg, params, bc,   \
                          sign, dh, dhj, dattr, dx2, x2s, partials, grads,    \
                          n_nodes, cm, ca, c, wn, n_win, fast, grid, stream); \
  }                                                                           \
  void PREFIX##_tables(int* i_of_out, int* path_out, int* grade_out) {        \
    structural_tables<ALG>(i_of_out, path_out, grade_out);                    \
  }

extern "C" {
CSMPN_FUSED_MP_ENTRIES(csmpn_fused_mp, Cl3)
CSMPN_FUSED_MP_ENTRIES(csmpn_fused_mp_cl2, Cl2)
}  // extern "C"
