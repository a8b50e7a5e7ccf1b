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
// The per-row device code is cemlp_pair.cuh, shared with the pair-form
// fused message-passing kernels K4p/K5p (fused_egcl_pair.cu).
//
// Precision: FAST = false is fp32 throughout.  FAST = true rounds to bf16
// the operands of each product that the TPU kernel feeds its matrix unit
// (`_cast_pair`/`_dot*`), and accumulates in fp32.  In the pair form that
// includes the pair product z_i * yn_k * w (the operand of the S4 sum;
// the path weight w itself stays fp32), and in the backward the products
// (d(gp)_j * sign * yn_k) * w and (d(gp)_j * sign * z_i) * w.

#include "cemlp_pair.cuh"

namespace {

constexpr int ROWS_F = 8;      // rows per CTA at a time, forward
constexpr int TEAM_F = 2;      // warps per row, forward
constexpr int WARPS_F = ROWS_F * TEAM_F;
constexpr int THREADS_F = 32 * WARPS_F;
constexpr int ROWS_B = 4;      // rows per CTA tile, backward
constexpr int TEAM_B = 4;      // warps per row, backward
constexpr int WARPS_B = ROWS_B * TEAM_B;
constexpr int THREADS_B = 32 * WARPS_B;

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
    mix_grads<THREADS_B>(rowbuf, rstride, nrow, cin, c, c4, 0, aw1);
    mix_grads<THREADS_B>(rowbuf, rstride, nrow, cin, c, c4, 1, awr);
    mix_grads<THREADS_B>(rowbuf, rstride, nrow, cin, c, c4, 2, awl);
    path_grads<THREADS_B>(rowbuf, rstride, nrow, cin, c, c4, list, off, gacc);
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

size_t bwd_smem_bytes(int cin, int c) {
  return sizeof(float) *
         ((size_t)params_floats(cin, c) + TAB_FLOATS + WARPS_B * NB +
          (size_t)(ROWS_B * NLOC + NP) * pad4(c) + ROWS_B * XCH +
          (size_t)ROWS_B * row_floats(cin, c));
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
