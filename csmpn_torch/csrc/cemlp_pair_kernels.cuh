// K2p and K3p — one whole CEMLP block in its pair form, forward and
// backward, on Hopper (sm_90a), templated on the algebra (cemlp_pair.cuh's
// traits) and its row tile.  cemlp_pair.cu compiles them for Cl(5,0)
// (csmpn_cemlp_pair_*), cemlp_pair_cl4.cu for Cl(4,0)
// (csmpn_cemlp_pair_cl4_*); each source's header states its tile.
//
// Replaces: csmpn_tpu/ops/cemlp_kernel.py, `_fwd_kernel` (K2p, launched by
// `_pallas_fwd`) and `_bwd_kernel` (K3p, launched by `_fused_block_bwd`) in
// their pair form (`_pair_form`, nb 16/32: `_gp_pair_fwd` and the pair
// branch of `_post_linear_bwd`).  One block is
//     MVLinear -> MVSiLU -> SGP (right linear, grade-norm normalisation,
//     geometric product, + left linear, / sqrt 2) -> MVLayerNorm
// on (rows, Cin, NB) float32 activations, NB blades in short-lex order.
//
// Bound on this card: at C = 28 a row costs ~2*NB*C*(Cin + 2C) + 2*NB*NB*C
// FLOPs (three channel-mixing linears and the pair product) against
// 4*NB*(Cin + C) bytes, ~30 FLOP per byte at Cl(5) and ~21 at Cl(4):
// memory-bound against the tensor cores, near the fp32 FMA ridge (67
// TFLOP/s over 3.35 TB/s = 20 FLOP/byte).  The backward does about three
// times the forward's work on about twice the bytes.
//
// Design.  The TPU kernel folds the blade axis into 128-lane channel
// groups and expands the pair structure into 0/1 matrix products (Rz, Ry,
// S4).  Here a row's NB blades are NB lanes (a row member: a warp at
// Cl(5), a half-warp at Cl(4)), a lane owning one blade of every channel,
// and a team of members owns a row, each taking every nh-th group of four
// channels.  One CTA fits on an SM (the parameters and row buffers take
// most of its shared memory), so the teams are what puts 16 warps on an SM
// to hide the latency of the shared-memory loads and shuffles.
//   * the channel-mixing linears are FMA loops over the input channels,
//     reading the row from shared memory (lane-contiguous) and four output
//     channels' weights at once as one float4 (one address per grade: a
//     broadcast);
//   * the grade sums (grades are contiguous runs of blades) are read back
//     from a per-member scratch row, each lane summing its grade's run in a
//     fixed order;
//   * the geometric product out_j = sum_k sign * w[path] * z_i * yn_k,
//     i = i_of(j, k), is NB steps of a shuffle (yn_k) and a shared-memory
//     read (z_i) per lane, with (i, sign, path) from a packed table in
//     shared memory, for four channels at once (four independent chains);
//     the layer norm's channel mean is a blade sum per channel, and the
//     channel sums of a team meet in shared memory, added in member order;
//   * the block's parameters are staged once per CTA in shared memory.
// The backward recomputes the forward in the row (as the TPU kernel does),
// keeps the row's cotangents in shared memory, and writes dx per row.  Its
// parameter gradients: per-channel ones in a per-row shared-memory slice
// (each channel owned by one member of the team), the path weights' in a
// CTA slice owned entry by entry (pairs grouped by path), the
// channel-mixing weights' in the CTA's slice of global scratch (no room is
// left in shared memory), each entry owned by one thread.  CTAs write
// partial sums that a second kernel adds in a fixed order: no atomics,
// bitwise repeatable.  The per-row device code is cemlp_pair.cuh, shared
// with the pair-form fused message-passing kernels K4p/K5p.  These row
// kernels are K2p and K3p in exact mode; in fast mode K3p is the row tile
// kernel of cemlp_pair_tile.cuh (the linears and their weight gradients on
// the tensor cores) and K2p that of cemlp_pair_fwd_tile.cuh (the linears
// on the tensor cores, the pair product unrolled at compile time).
//
// Precision: exact mode is fp32 throughout.  Fast mode rounds to bf16
// the operands of each product that the TPU kernel feeds its matrix unit
// (`_cast_pair`/`_dot*`), and accumulates in fp32.  In the pair form that
// includes the pair product z_i * yn_k * w (the operand of the S4 sum;
// the path weight w itself stays fp32), and in the backward the products
// (d(gp)_j * sign * yn_k) * w and (d(gp)_j * sign * z_i) * w.
#pragma once

#include "cemlp_pair.cuh"
#include "cemlp_pair_fwd_tile.cuh"
#include "cemlp_pair_tile.cuh"

namespace {

// The exact forward (fp32 throughout); the fast one is the row tile kernel
// of cemlp_pair_fwd_tile.cuh.
template <class A, class K>
__global__ void __launch_bounds__(K::THREADS_F)
cemlp_pair_fwd_kernel(const float* __restrict__ x, Params p, Tabs<A> tb,
                      const uint16_t* __restrict__ tabs,
                      float* __restrict__ out, int rows, int cin, int c) {
  constexpr int NB = A::NB, RP = A::RP;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  Smem s;
  carve_params<A>(smem, cin, c, s);
  uint16_t* t1 = reinterpret_cast<uint16_t*>(smem + params_floats<A>(cin, c));
  float* sc = smem + params_floats<A>(cin, c) + A::TAB_FLOATS;  // [WARPS][32]
  float* xch = sc + K::WARPS_F * 32;                          // [ROWS][XCH]
  float* rowbuf = xch + K::ROWS_F * A::XCH;
  stage_params<A, false>(p, s, cin, c, K::THREADS_F);
  const int tid = threadIdx.x + 32 * threadIdx.y;
  for (int e = tid; e < NB * NB; e += K::THREADS_F) t1[e] = tabs[e];
  __syncthreads();

  const Lane l = make_lane<A>(tb);
  // warps TEAM_F * r ... share row slot r (named barrier 1 + r)
  const int w = threadIdx.y, r = w / K::TEAM_F;
  const Team tm = make_team<A>(w, K::TEAM_F, xch);
  float* xs = rowbuf + r * (cin + 2 * pad4(c)) * RP;
  float* zs = xs + cin * RP;
  float* os = zs + pad4(c) * RP;
  float* scw = sc + w * 32 + half_of_warp<A>() * NB;
  // row slots are independent after the staging
  for (int64_t row = (int64_t)blockIdx.x * K::ROWS_F + r; row < rows;
       row += (int64_t)gridDim.x * K::ROWS_F) {
    team_sync<A>(tm);   // the previous row's output is written
    for (int m = tm.h; m < cin; m += tm.nh)
      xs[m * RP + l.id] = x[(row * cin + m) * NB + l.id];
    team_sync<A>(tm);
    const float mden = row_forward<A, false>(s, l, tm, t1, xs, zs, nullptr,
                                             os, scw, cin, c);
    for (int n = tm.h; n < c; n += tm.nh)
      out[(row * c + n) * NB + l.id] = s.aln[n] / mden * os[n * RP + l.id];
  }
}

template <class A, class K>
size_t fwd_smem_bytes(int cin, int c) {
  return sizeof(float) * ((size_t)params_floats<A>(cin, c) + A::TAB_FLOATS +
                          K::WARPS_F * 32 + K::ROWS_F * A::XCH +
                          (size_t)K::ROWS_F * (cin + 2 * pad4(c)) * A::RP);
}

// The gradient vector's layout (flax order) is grad_floats in
// cemlp_pair_tile.cuh.

// One CTA's scratch: its partial gradient vector, then its channel-mixing
// accumulators.
template <class A>
__host__ __device__ inline int64_t partial_floats(int cin, int c) {
  return grad_floats<A>(cin, c) + (int64_t)(cin + 2 * c) * A::NG * pad4(c);
}

// The exact backward (fp32 throughout); the fast one is the row tile
// kernel of cemlp_pair_tile.cuh.
template <class A, class K>
__global__ void __launch_bounds__(K::THREADS_B)
cemlp_pair_bwd_kernel(const float* __restrict__ x,
                      const float* __restrict__ dout, Params p, Tabs<A> tb,
                      const uint16_t* __restrict__ tabs,
                      float* __restrict__ dx, float* __restrict__ partials,
                      int rows, int cin, int c) {
  constexpr int NB = A::NB, NG = A::NG, NP = A::NP, NLOC = A::NLOC;
  constexpr int ROWS_B = K::ROWS_B, THREADS_B = K::THREADS_B;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  Smem s;
  carve_params<A>(smem, cin, c, s);
  const int c4 = s.c4;
  uint16_t* tab = reinterpret_cast<uint16_t*>(smem + params_floats<A>(cin, c));
  const uint16_t *t1 = tab, *t2 = tab + NB * NB, *t3 = tab + 2 * NB * NB;
  const uint16_t *list = tab + A::TAB_T, *off = list + NB * NB;
  float* sc = smem + params_floats<A>(cin, c) + A::TAB_FLOATS;  // [WARPS][32]
  float* locs = sc + K::WARPS_B * 32;                // [ROWS_B][NLOC][C4]
  float* gacc = locs + ROWS_B * NLOC * c4;           // [NP][C4]
  float* xch = gacc + NP * c4;                       // [ROWS_B][XCH]
  float* rowbuf = xch + ROWS_B * A::XCH;             // [ROWS_B][rows]
  const int tid = threadIdx.x + 32 * threadIdx.y;
  stage_params<A, false>(p, s, cin, c, THREADS_B);
  for (int e = tid; e < A::TAB_LEN; e += THREADS_B) tab[e] = tabs[e];
  for (int e = tid; e < ROWS_B * NLOC * c4; e += THREADS_B) locs[e] = 0.f;
  for (int e = tid; e < NP * c4; e += THREADS_B) gacc[e] = 0.f;
  float* part = partials + (int64_t)blockIdx.x * partial_floats<A>(cin, c);
  float* aw1 = part + grad_floats<A>(cin, c);
  float* awr = aw1 + cin * NG * c4;
  float* awl = awr + c * NG * c4;
  const int rstride = row_floats<A>(cin, c);
  for (int e = tid; e < (cin + 2 * c) * NG * c4; e += THREADS_B) aw1[e] = 0.f;

  const Lane l = make_lane<A>(tb);
  // warps TEAM_B * r ... share row slot r (named barrier 1 + r) and its
  // per-channel gradient slice (each member adds only its own channels)
  const int w = threadIdx.y, r = w / K::TEAM_B;
  const Team tm = make_team<A>(w, K::TEAM_B, xch);
  const Rows b = carve_rows<A>(rowbuf + r * rstride, cin, c);
  float* loc = locs + r * NLOC * c4;
  float* scw = sc + w * 32 + half_of_warp<A>() * NB;
  const int n_tiles = (rows + ROWS_B - 1) / ROWS_B;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row = (int64_t)tile * ROWS_B + r;
    __syncthreads();   // staging done / previous tile consumed
    if (row < rows) {
      for (int m = tm.h; m < cin; m += tm.nh)
        b.xs[m * A::RP + l.id] = x[(row * cin + m) * NB + l.id];
      team_sync<A>(tm);
      row_backward<A, false>(s, l, tm, t1, t2, t3, b, scw, loc,
                            dout + row * c * NB, dx + row * cin * NB, cin, c);
    }
    __syncthreads();
    int nrow = rows - tile * ROWS_B;
    nrow = nrow < ROWS_B ? nrow : ROWS_B;
    mix_grads<A, THREADS_B>(rowbuf, rstride, nrow, cin, c, c4, 0, aw1);
    mix_grads<A, THREADS_B>(rowbuf, rstride, nrow, cin, c, c4, 1, awr);
    mix_grads<A, THREADS_B>(rowbuf, rstride, nrow, cin, c, c4, 2, awl);
    path_grads<A, THREADS_B>(rowbuf, rstride, nrow, cin, c, c4, list, off,
                             gacc);
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
  for (int e = tid; e < c; e += THREADS_B) part[o + e] = locsum(A::L_B1, e);
  o += c;
  for (int e = tid; e < c * NG; e += THREADS_B)
    part[o + e] = locsum(A::L_SA + e % NG, e / NG);
  o += NG * c;
  for (int e = tid; e < c * NG; e += THREADS_B)
    part[o + e] = locsum(A::L_SB + e % NG, e / NG);
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
    part[o + e] = locsum(A::L_NS + e % NG, e / NG);
  o += NG * c;
  for (int e = tid; e < c * c * NG; e += THREADS_B) {
    const int g = e % NG, m = (e / NG) % c, n = e / (NG * c);
    part[o + e] = awl[(m * NG + g) * c4 + n];
  }
  o += (int64_t)c * c * NG;
  for (int e = tid; e < c; e += THREADS_B) part[o + e] = locsum(A::L_BL, e);
  o += c;
  for (int e = tid; e < c; e += THREADS_B) part[o + e] = locsum(A::L_ALN, e);
}

template <class A, class K>
size_t bwd_smem_bytes(int cin, int c) {
  return sizeof(float) *
         ((size_t)params_floats<A>(cin, c) + A::TAB_FLOATS + K::WARPS_B * 32 +
          (size_t)(K::ROWS_B * A::NLOC + A::NP) * pad4(c) +
          K::ROWS_B * A::XCH + (size_t)K::ROWS_B * row_floats<A>(cin, c));
}

// Shared-memory bytes a launch needs (0 if the widths are not supported).
template <class A, class K>
size_t smem_bytes(int cin, int c, int backward) {
  if (c < 1 || cin < 1) return 0;
  const size_t n = backward ? bwd_smem_bytes<A, K>(cin, c)
                            : fwd_smem_bytes<A, K>(cin, c);
  return n > kMaxSmem ? 0 : n;
}

// Fast mode: the row tile kernel; exact mode: the row kernel.
template <class A, class K>
int launch_fwd(const float* x, Params p, const float* bc,
               const uint16_t* tabs, float* out, int rows, int cin, int c,
               int fast, int grid, void* stream) {
  Tabs<A> tb = make_tabs<A>(bc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fast)
    return launch_pair_tile_fwd<A>(x, p, tb, out, rows, cin, c, grid, st);
  const size_t bytes = smem_bytes<A, K>(cin, c, 0);
  if (bytes == 0) return (int)cudaErrorInvalidValue;
  if (rows > 0) {
    cudaFuncSetAttribute(cemlp_pair_fwd_kernel<A, K>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    cemlp_pair_fwd_kernel<A, K><<<grid, dim3(32, K::WARPS_F), bytes, st>>>(
        x, p, tb, tabs, out, rows, cin, c);
  }
  return (int)cudaGetLastError();
}

// partials: (grid, partial_floats) scratch; grads: (grad_floats,) output.
// Fast mode: the row tile kernel, partials (grid, grad_floats); exact mode:
// the row kernel, partials (grid, partial_floats).
template <class A, class K>
int launch_bwd(const float* x, const float* dout, Params p, const float* bc,
               const uint16_t* tabs, float* dx, float* partials,
               float* grads, int rows, int cin, int c, int fast, int grid,
               void* stream) {
  Tabs<A> tb = make_tabs<A>(bc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fast)
    return launch_pair_tile_bwd<A>(x, dout, p, tb, tabs, dx, partials, grads,
                                   rows, cin, c, grid, st);
  const size_t bytes = smem_bytes<A, K>(cin, c, 1);
  if (bytes == 0) return (int)cudaErrorInvalidValue;
  dim3 block(32, K::WARPS_B);
  cudaFuncSetAttribute(cemlp_pair_bwd_kernel<A, K>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  cemlp_pair_bwd_kernel<A, K><<<grid, block, bytes, st>>>(
      x, dout, p, tb, tabs, dx, partials, rows, cin, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = grad_floats<A>(cin, c);
  reduce_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      partials, grads, n, partial_floats<A>(cin, c), grid);
  return (int)cudaGetLastError();
}

}  // namespace

// One set of C entry points per algebra, prefixed PREFIX, for traits ALG
// and row tile TILE.  The 10 block parameters are device pointers in flax
// order (w1 b1 sa sb gw wr na wl bl aln); bc the host quadratic-form
// coefficients; tabs the packed tables on the device.  x (rows, cin, NB)
// fp32, out (rows, c, NB).  The backward writes dx (rows, cin, NB) and
// grads (grad_floats,), with partials as scratch: (grid, partial_floats)
// in exact mode, (grid, grad_floats) in fast mode.
#define CSMPN_PAIR_PARAMS_DECL                                                \
  const float *w1, const float *b1, const float *sa, const float *sb,         \
      const float *gw, const float *wr, const float *na, const float *wl,     \
      const float *bl, const float *aln
#define CSMPN_PAIR_PARAMS Params{w1, b1, sa, sb, gw, wr, na, wl, bl, aln}
#define CSMPN_CEMLP_PAIR_ENTRIES(PREFIX, ALG, TILE)                           \
  /* shared-memory bytes a launch needs (0 if the widths do not fit) */      \
  size_t PREFIX##_smem_bytes(int cin, int c, int backward) {                  \
    return smem_bytes<ALG, TILE>(cin, c, backward);                           \
  }                                                                           \
  /* floats of one CTA's slice of the exact backward's scratch */             \
  long long PREFIX##_partial_floats(int cin, int c) {                         \
    return (long long)partial_floats<ALG>(cin, c);                            \
  }                                                                           \
  /* shared-memory bytes of the fast backward (the row tiles; 0 if the      \
     widths do not fit) and the weight-gradient tiles a warp it holds */     \
  size_t PREFIX##_tile_smem_bytes(int cin, int c) {                           \
    return pair_tile_smem_bytes<ALG>(cin, c);                                 \
  }                                                                           \
  int PREFIX##_tile_maxt(int cin, int c) {                                    \
    return pair_tile_maxt<ALG>(cin, c);                                       \
  }                                                                           \
  /* shared-memory bytes of the fast forward (the row tiles; 0 if the       \
     widths do not fit) */                                                    \
  size_t PREFIX##_fwd_tile_smem_bytes(int cin, int c) {                       \
    return pair_fwd_tile_smem_bytes<ALG>(cin, c);                             \
  }                                                                           \
  /* the structure the kernels assume: i_of, path ids and signs of the       \
     pairs [j * NB + k], grades (NB), for the host to check */               \
  void PREFIX##_tables(int* i_of_out, int* path_out, int* grade_out,          \
                       float* sign_out) {                                     \
    structural_tables<ALG>(i_of_out, path_out, grade_out, sign_out);          \
  }                                                                           \
  /* the packed tables the kernels read (uint16); their length, or -1 if     \
     cap is too small */                                                      \
  int PREFIX##_packed(uint16_t* out, int cap) {                               \
    if (cap < ALG::TAB_LEN) return -1;                                        \
    return make_packed<ALG>(out);                                             \
  }                                                                           \
  int PREFIX##_fwd(const float* x, CSMPN_PAIR_PARAMS_DECL, const float* bc,   \
                   const uint16_t* tabs, float* out, int rows, int cin,       \
                   int c, int fast, int grid, void* stream) {                 \
    return launch_fwd<ALG, TILE>(x, CSMPN_PAIR_PARAMS, bc, tabs, out, rows,   \
                                 cin, c, fast, grid, stream);                 \
  }                                                                           \
  int PREFIX##_bwd(const float* x, const float* dout,                         \
                   CSMPN_PAIR_PARAMS_DECL, const float* bc,                   \
                   const uint16_t* tabs, float* dx, float* partials,          \
                   float* grads, int rows, int cin, int c, int fast,          \
                   int grid, void* stream) {                                  \
    return launch_bwd<ALG, TILE>(x, dout, CSMPN_PAIR_PARAMS, bc, tabs, dx,    \
                                 partials, grads, rows, cin, c, fast, grid,   \
                                 stream);                                     \
  }
