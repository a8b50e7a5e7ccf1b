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
//
// Precision: FAST = false is fp32 throughout.  FAST = true streams h, hj
// and attr as bf16, rounds the message before the first linear and block 1's
// output before the second (as K2 does), rounds each message row to bf16
// before the sum, gathers d(agg) bf16-rounded, writes dhj and dattr as
// bf16, and accumulates d(h) and the parameter gradients in fp32 — the TPU
// kernel's rounding points.

#include "cemlp_block.cuh"
#include "fused_mp.cuh"

namespace {

// Block-1 input rows of a tile, x = [h[dst] - hj, attr], into shared memory
// as [r][i][m] (rounded in fast mode; rows past `end` are zero), and each
// row's target offset in the window (-1 for a masked edge or a row past
// `end`).
template <class A, typename T, bool FAST>
__device__ void load_msg_tile(const T* __restrict__ h, const T* __restrict__ hj,
                              const T* __restrict__ attr,
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
        v = ldf(h + (int64_t)dst[row] * cm * NB + rem) -
            ldf(hj + row * cm * NB + rem);
      else
        v = ldf(attr + row * ca * NB + (rem - cm * NB));
    }
    xs[(r * NB + i) * cin + m] = rnd<FAST>(v);
  }
}

// A block's output for this lane's channel slots, rounded in fast mode:
// out[i * si + n * sn] = aln[n] / m * o[i] for every channel n < c it owns.
template <class A, bool FAST>
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
      out[i * si + n * sn] = rnd<FAST>(scale * f[u].o[i]);
  }
}

template <class A, bool FAST>
__global__ void __launch_bounds__(THREADS, 1)
fused_mp_fwd_kernel(const typename Stream<FAST>::T* __restrict__ h,
                    const typename Stream<FAST>::T* __restrict__ hj,
                    const typename Stream<FAST>::T* __restrict__ attr,
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
  stage_params<A, FAST>(p1, s1, cin1, c);
  stage_params<A, FAST>(p2, s2, c, c);

  const int tid = threadIdx.x + 32 * threadIdx.y;
  const int lane = threadIdx.x, r = threadIdx.y;
  for (int w = blockIdx.x; w < gm.n_win; w += gridDim.x) {
    const int base = w * gm.wn;
    const int64_t e0 = bounds[w], e1 = bounds[w + 1];
    for (int e = tid; e < gm.wn * per_node; e += THREADS) acc[e] = 0.f;
    for (int64_t row0 = e0; row0 < e1; row0 += ROWS) {
      __syncthreads();   // staging done / previous tile summed
      load_msg_tile<A, typename Stream<FAST>::T, FAST>(
          h, hj, attr, dst, mask, row0, e1, base, gm.cm, gm.ca, xs1, dloc);
      __syncthreads();
      if (row0 + r < e1) {   // whole warp: no shuffle partner missing
        float* zt = zs + r * NB * c;
        float* xr2 = xs2 + r * NB * c;
        Fwd<A> f[S];
        block_forward<A, FAST>(f, s1, tb, xs1 + r * NB * cin1, zt, cin1, c,
                               lane);
        // block 2 reads its input rounded, as K2 does
        write_scaled<A, FAST>(f, s1, xr2, c, 1, c, lane);
        __syncwarp();
        block_forward<A, FAST>(f, s2, tb, xr2, zt, c, c, lane);
        write_scaled<A, FAST>(f, s2, ys + r * per_node, 1, NB, c, lane);
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

template <class A, bool FAST>
__global__ void __launch_bounds__(THREADS, 1)
fused_mp_bwd_kernel(const typename Stream<FAST>::T* __restrict__ h,
                    const typename Stream<FAST>::T* __restrict__ hj,
                    const typename Stream<FAST>::T* __restrict__ attr,
                    const int* __restrict__ dst,
                    const uint8_t* __restrict__ mask,
                    const int64_t* __restrict__ bounds,
                    const float* __restrict__ dagg, Params p1, Params p2,
                    Tabs<A> tb, float* __restrict__ dh,
                    typename Stream<FAST>::T* __restrict__ dhj,
                    typename Stream<FAST>::T* __restrict__ dattr,
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

  stage_params<A, FAST>(p1, s1, cin1, c);
  stage_params<A, FAST>(p2, s2, c, c);
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
        load_msg_tile<A, typename Stream<FAST>::T, FAST>(
            h, hj, attr, dst, mask, row0, e1, base, cm, ca, xs1, dloc);
        __syncthreads();
        const int64_t row = row0 + r;
        if (row < e1) {   // whole warp
          const int d = dloc[r];
          Fwd<A> f[S];
          block_forward<A, FAST>(f, s1, tb, xr1, zt1, cin1, c, lane);
          write_scaled<A, FAST>(f, s1, xr2, c, 1, c, lane);
          __syncwarp();
          block_forward<A, FAST>(f, s2, tb, xr2, zs2 + r * NB * c, c, c,
                                 lane);
          float go[S][NB];
#pragma unroll
          for (int u = 0; u < S; ++u) {
            const int n = lane + 32 * u;
#pragma unroll
            for (int i = 0; i < NB; ++i)
              go[u][i] = (n < c && d >= 0)
                  ? rnd<FAST>(dagg[((int64_t)(base + d) * c + n) * NB + i])
                  : 0.f;
          }
          block_backward_row<A, FAST>(f, s2, tb, go, a2, dft, drt, dyt,
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
        load_msg_tile<A, typename Stream<FAST>::T, FAST>(
            h, hj, attr, dst, mask, row0, e1, base, cm, ca, xs1, dloc);
        __syncthreads();
        const int64_t row = row0 + r;
        if (row < e1) {
          Fwd<A> f[S];
          block_forward<A, FAST>(f, s1, tb, xr1, zt1, cin1, c, lane);
          float go[S][NB];
#pragma unroll
          for (int u = 0; u < S; ++u) {
            const int n = lane + 32 * u;
#pragma unroll
            for (int i = 0; i < NB; ++i)
              go[u][i] = n < c ? dx2[(row * c + n) * NB + i] : 0.f;
          }
          block_backward_row<A, FAST>(f, s1, tb, go, a1, dft, drt, dyt,
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

Params params_at(const float* const* pp) {
  return Params{pp[0], pp[1], pp[2], pp[3], pp[4],
                pp[5], pp[6], pp[7], pp[8], pp[9]};
}

template <class A, bool FAST>
int launch_fwd(const void* h, const void* hj, const void* attr,
               const int* dst, const uint8_t* mask, const int64_t* bounds,
               const float* const* params, Tabs<A> tb, float* out, Geom gm,
               int grid, cudaStream_t st) {
  using T = typename Stream<FAST>::T;
  const size_t bytes = fwd_smem_bytes<A>(gm.cm, gm.ca, gm.c, gm.wn);
  cudaFuncSetAttribute(fused_mp_fwd_kernel<A, FAST>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  fused_mp_fwd_kernel<A, FAST><<<grid, dim3(32, ROWS), bytes, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(hj),
      static_cast<const T*>(attr), dst, mask, bounds, params_at(params),
      params_at(params + 10), tb, out, gm);
  return (int)cudaGetLastError();
}

template <class A, bool FAST>
int launch_bwd(const void* h, const void* hj, const void* attr,
               const int* dst, const uint8_t* mask, const int64_t* bounds,
               const float* dagg, const float* const* params, Tabs<A> tb,
               float* dh, void* dhj, void* dattr, float* dx2, float* partials,
               Geom gm, int grid, cudaStream_t st) {
  using T = typename Stream<FAST>::T;
  const size_t bytes = bwd_smem_bytes<A>(gm.cm, gm.ca, gm.c, gm.wn);
  cudaFuncSetAttribute(fused_mp_bwd_kernel<A, FAST>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  fused_mp_bwd_kernel<A, FAST><<<grid, dim3(32, ROWS), bytes, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(hj),
      static_cast<const T*>(attr), dst, mask, bounds, dagg,
      params_at(params), params_at(params + 10), tb, dh,
      static_cast<T*>(dhj), static_cast<T*>(dattr), dx2, partials, gm);
  return (int)cudaGetLastError();
}

template <class A>
int fwd_entry(const void* h, const void* hj, const void* attr,
              const int* dst, const uint8_t* mask, const int64_t* bounds,
              const float* const* params, const float* bc, const float* sign,
              float* out, int n_nodes, int cm, int ca, int c, int wn,
              int n_win, int fast, int grid, void* stream) {
  if (!widths_ok<A>(cm, ca, c, wn) ||
      fwd_smem_bytes<A>(cm, ca, c, wn) > kMaxSmem || grid < 1)
    return (int)cudaErrorInvalidValue;
  Geom gm{n_nodes, cm, ca, c, wn, n_win};
  Tabs<A> tb = make_tabs<A>(bc, sign);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return fast ? launch_fwd<A, true>(h, hj, attr, dst, mask, bounds, params,
                                    tb, out, gm, grid, st)
              : launch_fwd<A, false>(h, hj, attr, dst, mask, bounds, params,
                                     tb, out, gm, grid, st);
}

template <class A>
int bwd_entry(const void* h, const void* hj, const void* attr,
              const int* dst, const uint8_t* mask, const int64_t* bounds,
              const float* dagg, const float* const* params, const float* bc,
              const float* sign, float* dh, void* dhj, void* dattr,
              float* dx2, float* partials, float* grads, int n_nodes, int cm,
              int ca, int c, int wn, int n_win, int fast, int grid,
              void* stream) {
  if (!widths_ok<A>(cm, ca, c, wn) ||
      bwd_smem_bytes<A>(cm, ca, c, wn) > kMaxSmem || grid < 1)
    return (int)cudaErrorInvalidValue;
  Geom gm{n_nodes, cm, ca, c, wn, n_win};
  Tabs<A> tb = make_tabs<A>(bc, sign);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err =
      fast ? launch_bwd<A, true>(h, hj, attr, dst, mask, bounds, dagg, params,
                                 tb, dh, dhj, dattr, dx2, partials, gm, grid,
                                 st)
           : launch_bwd<A, false>(h, hj, attr, dst, mask, bounds, dagg,
                                  params, tb, dh, dhj, dattr, dx2, partials,
                                  gm, grid, st);
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
//     supported);
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
//     (E, C, NB) fp32, block 2's dx rows; partials (grid, partial_floats);
//   tables: the structural tables the kernels assume (see
//     csmpn_cemlp_tables).
#define CSMPN_FUSED_MP_ENTRIES(PREFIX, ALG)                                   \
  size_t PREFIX##_smem_bytes(int cm, int ca, int c, int wn, int backward) {   \
    return smem_bytes<ALG>(cm, ca, c, wn, backward);                          \
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
                   float* dx2, float* partials, float* grads, int n_nodes,    \
                   int cm, int ca, int c, int wn, int n_win, int fast,        \
                   int grid, void* stream) {                                  \
    return bwd_entry<ALG>(h, hj, attr, dst, mask, bounds, dagg, params, bc,   \
                          sign, dh, dhj, dattr, dx2, partials, grads,         \
                          n_nodes, cm, ca, c, wn, n_win, fast, grid, stream); \
  }                                                                           \
  void PREFIX##_tables(int* i_of_out, int* path_out, int* grade_out) {        \
    structural_tables<ALG>(i_of_out, path_out, grade_out);                    \
  }

extern "C" {
CSMPN_FUSED_MP_ENTRIES(csmpn_fused_mp, Cl3)
CSMPN_FUSED_MP_ENTRIES(csmpn_fused_mp_cl2, Cl2)
}  // extern "C"
