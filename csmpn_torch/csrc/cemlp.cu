// K2 and K3 — one whole CEMLP block, forward and backward, Cl(3,0), on
// Hopper (sm_90a).
//
// Replaces: csmpn_tpu/ops/cemlp_kernel.py, `_fwd_kernel` (K2, launched by
// `_pallas_fwd`, entry `apply_fused_cemlp`) and `_bwd_kernel` (K3,
// launched by `_fused_block_bwd`).  One block is
//     MVLinear -> MVSiLU -> SGP (right linear, grade-norm normalisation,
//     geometric product, + left linear, / sqrt 2) -> MVLayerNorm,
// the function of `_post_linear_math` and of the composed layers in
// csmpn_tpu/nn/modules.py.  The per-row block math is in cemlp_block.cuh,
// shared with the fused message-passing kernels (fused_egcl.cu).
//
// Bound on this card: at the motion task's widths (C = 28 channels, up to
// 59 input channels, 8 blades) a row costs ~2*8*C*(Cin + 2C) + 6*64*C
// FLOPs against 4*8*(Cin + C) bytes, ~40 FLOP/byte in fp32: memory-bound
// against the tensor cores, near the fp32 FMA ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte).  The backward does about three times the
// forward's work on the same bytes.
//
// Design: the TPU kernel turns the grade sums and the geometric product into
// MXU matrix products over lane tables (Bcat, Kcat, G, H), inflating the
// work 8-fold.  Here a warp owns one row and a lane owns one output
// channel (cemlp_block.cuh).  The block's parameters are staged once per
// CTA in shared memory, and a CTA walks over row tiles so the staging is
// amortised.  The backward recomputes the forward in the tile (as the TPU
// kernel does), writes dx per row, and accumulates the parameter
// gradients: per-channel ones in registers, channel-mixing ones in shared
// memory, each entry owned by one thread.  CUDA blocks run concurrently, so
// each CTA writes its partial sums to a scratch buffer and a second kernel
// reduces them in a fixed order: no atomics, deterministic results.
//
// Precision: FAST = false is fp32 throughout.  FAST = true rounds to bf16
// the operands of each product that the TPU kernel feeds its matrix unit
// (`_cast_pair`/`_dot*`), and accumulates in fp32.

#include "cemlp_block.cuh"

namespace {

template <bool FAST>
__global__ void __launch_bounds__(THREADS)
cemlp_fwd_kernel(const float* __restrict__ x, Params p, Tabs tb,
                 float* __restrict__ out, int rows, int cin, int c) {
  extern __shared__ float smem[];
  Smem s;
  carve_params(smem, cin, c, s);
  float* xs = smem + params_floats(cin, c);   // [ROWS][NB][cin]
  float* zs = xs + ROWS * NB * cin;           // [ROWS][NB][c]
  stage_params<FAST>(p, s, cin, c);

  const int lane = threadIdx.x, r = threadIdx.y;
  const bool act = lane < c;
  const int n = act ? lane : c - 1;
  const int n_tiles = (rows + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = (int64_t)tile * ROWS;
    __syncthreads();   // staging done / previous tile consumed
    load_x_tile<FAST>(x, xs, row0, rows, cin);
    __syncthreads();
    const int64_t row = row0 + r;
    if (row >= rows) continue;   // whole warp: no shuffle partner missing
    Fwd f;
    block_forward<FAST>(f, s, tb, xs + r * NB * cin, zs + r * NB * c, cin,
                        c, n, act);
    if (act) {
      const float scale = s.aln[n] / f.m;
      float* o = out + (row * c + n) * NB;
#pragma unroll
      for (int i = 0; i < NB; ++i) o[i] = scale * f.o[i];
    }
  }
}

// Gradient vector layout (flax parameter order and shapes):
//   dW1 (C, Cin, 4) | db1 (C) | dsilu_a (C, 4) | dsilu_b (C, 4) |
//   dgp_weight (C, 20) | dWr (C, C, 4) | dsigmoid(norm_a) (C, 4) |
//   dWL (C, C, 4) | dbL (C) | dln_a (C)
__host__ __device__ inline int64_t grad_floats(int cin, int c) {
  return (int64_t)c * cin * NG + c + 2 * NG * c + NP * c + c * c * NG +
         NG * c + c * c * NG + 2 * c;
}

template <bool FAST>
__global__ void __launch_bounds__(THREADS)
cemlp_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dout,
                 Params p, Tabs tb, float* __restrict__ dx,
                 float* __restrict__ partials, int rows, int cin, int c) {
  extern __shared__ float smem[];
  Smem s;
  carve_params(smem, cin, c, s);
  float* xs = smem + params_floats(cin, c);   // [ROWS][NB][cin]
  float* zs = xs + ROWS * NB * cin;           // [ROWS][NB][c], rounded z
  float* dfs = zs + ROWS * NB * c;            // d(first) = d(gp)
  float* drs = dfs + ROWS * NB * c;           // d(yr)
  float* dys = drs + ROWS * NB * c;           // d(y)
  float* aw1 = dys + ROWS * NB * c;           // [(m*4+g)*C + n]
  float* awr = aw1 + cin * NG * c;
  float* awl = awr + c * NG * c;
  float* loc = awl + c * NG * c;              // [NLOC][C]
  stage_params<FAST>(p, s, cin, c);
  const int tid = threadIdx.x + 32 * threadIdx.y;
  for (int e = tid; e < cin * NG * c; e += THREADS) aw1[e] = 0.f;
  for (int e = tid; e < c * NG * c; e += THREADS) { awr[e] = 0.f; awl[e] = 0.f; }
  for (int e = tid; e < NLOC * c; e += THREADS) loc[e] = 0.f;

  const int lane = threadIdx.x, r = threadIdx.y;
  const bool act = lane < c;
  const int n = act ? lane : c - 1;
  Acc a;   // per-channel gradient accumulators (this thread's rows)
  acc_zero(a);

  const int n_tiles = (rows + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = (int64_t)tile * ROWS;
    __syncthreads();
    load_x_tile<FAST>(x, xs, row0, rows, cin);
    __syncthreads();
    const int64_t row = row0 + r;
    if (row < rows) {
      Fwd f;
      block_forward<FAST>(f, s, tb, xs + r * NB * cin, zs + r * NB * c, cin,
                          c, n, act);
      float go[NB];
#pragma unroll
      for (int i = 0; i < NB; ++i)
        go[i] = act ? dout[(row * c + n) * NB + i] : 0.f;
      block_backward_row<FAST>(f, s, tb, go, a, dfs + r * NB * c,
                               drs + r * NB * c, dys + r * NB * c,
                               dx + row * cin * NB, cin, c, n, lane, act);
    }
    __syncthreads();
    int nrow = rows - (int)row0;
    nrow = nrow < ROWS ? nrow : ROWS;
    weight_grads(xs, zs, dfs, drs, dys, nrow, cin, c, aw1, awr, awl);
  }
  acc_to_loc(a, loc, c, n, act);
  // ---- this CTA's partial gradient vector, in flax layout
  float* part = partials + (int64_t)blockIdx.x * grad_floats(cin, c);
  int64_t o = 0;
  for (int e = tid; e < c * cin * NG; e += THREADS) {    // (n, m, g)
    const int g = e % NG, m = (e / NG) % cin, q = e / (NG * cin);
    part[o + e] = aw1[(m * NG + g) * c + q];
  }
  o += (int64_t)c * cin * NG;
  for (int e = tid; e < c; e += THREADS) part[o + e] = loc[0 * c + e];
  o += c;
  for (int e = tid; e < c * NG; e += THREADS)
    part[o + e] = loc[(1 + e % NG) * c + e / NG];
  o += NG * c;
  for (int e = tid; e < c * NG; e += THREADS)
    part[o + e] = loc[(5 + e % NG) * c + e / NG];
  o += NG * c;
  for (int e = tid; e < c * NP; e += THREADS)
    part[o + e] = loc[(9 + e % NP) * c + e / NP];
  o += NP * c;
  for (int e = tid; e < c * c * NG; e += THREADS) {
    const int g = e % NG, m = (e / NG) % c, q = e / (NG * c);
    part[o + e] = awr[(m * NG + g) * c + q];
  }
  o += (int64_t)c * c * NG;
  for (int e = tid; e < c * NG; e += THREADS)
    part[o + e] = loc[(29 + e % NG) * c + e / NG];
  o += NG * c;
  for (int e = tid; e < c * c * NG; e += THREADS) {
    const int g = e % NG, m = (e / NG) % c, q = e / (NG * c);
    part[o + e] = awl[(m * NG + g) * c + q];
  }
  o += (int64_t)c * c * NG;
  for (int e = tid; e < c; e += THREADS) part[o + e] = loc[33 * c + e];
  o += c;
  for (int e = tid; e < c; e += THREADS) part[o + e] = loc[34 * c + e];
}

size_t fwd_smem_bytes(int cin, int c) {
  return sizeof(float) *
         ((size_t)params_floats(cin, c) + ROWS * NB * (size_t)(cin + c));
}

size_t bwd_smem_bytes(int cin, int c) {
  return sizeof(float) *
         ((size_t)params_floats(cin, c) + ROWS * NB * (size_t)(cin + 4 * c) +
          (size_t)(cin + 2 * c) * NG * c + (size_t)NLOC * c);
}

}  // namespace

extern "C" {

// Shared-memory bytes a launch needs (0 if the widths are not supported).
size_t csmpn_cemlp_smem_bytes(int cin, int c, int backward) {
  if (c < 1 || c > 32 || cin < 1) return 0;
  return backward ? bwd_smem_bytes(cin, c) : fwd_smem_bytes(cin, c);
}

int csmpn_cemlp_fwd(const float* x, const float* w1, const float* b1,
                    const float* sa, const float* sb, const float* gw,
                    const float* wr, const float* na, const float* wl,
                    const float* bl, const float* aln, const float* bc,
                    const float* sign, float* out, int rows, int cin, int c,
                    int fast, int grid, void* stream) {
  const size_t bytes = fwd_smem_bytes(cin, c);
  if (c < 1 || c > 32 || bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  Params p{w1, b1, sa, sb, gw, wr, na, wl, bl, aln};
  Tabs tb = make_tabs(bc, sign);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 block(32, ROWS);
  if (rows > 0) {
    if (fast) {
      cudaFuncSetAttribute(cemlp_fwd_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      cemlp_fwd_kernel<true><<<grid, block, bytes, st>>>(x, p, tb, out, rows,
                                                         cin, c);
    } else {
      cudaFuncSetAttribute(cemlp_fwd_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      cemlp_fwd_kernel<false><<<grid, block, bytes, st>>>(x, p, tb, out, rows,
                                                          cin, c);
    }
  }
  return (int)cudaGetLastError();
}

// partials: (grid, grad_floats) scratch; grads: (grad_floats,) output.
int csmpn_cemlp_bwd(const float* x, const float* dout, const float* w1,
                    const float* b1, const float* sa, const float* sb,
                    const float* gw, const float* wr, const float* na,
                    const float* wl, const float* bl, const float* aln,
                    const float* bc, const float* sign, float* dx,
                    float* partials, float* grads, int rows, int cin, int c,
                    int fast, int grid, void* stream) {
  const size_t bytes = bwd_smem_bytes(cin, c);
  if (c < 1 || c > 32 || bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  Params p{w1, b1, sa, sb, gw, wr, na, wl, bl, aln};
  Tabs tb = make_tabs(bc, sign);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 block(32, ROWS);
  if (fast) {
    cudaFuncSetAttribute(cemlp_bwd_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    cemlp_bwd_kernel<true><<<grid, block, bytes, st>>>(x, dout, p, tb, dx,
                                                       partials, rows, cin, c);
  } else {
    cudaFuncSetAttribute(cemlp_bwd_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    cemlp_bwd_kernel<false><<<grid, block, bytes, st>>>(x, dout, p, tb, dx,
                                                        partials, rows, cin, c);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = grad_floats(cin, c);
  reduce_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      partials, grads, n, grid);
  return (int)cudaGetLastError();
}

// Structural tables the kernels assume, for the host to check against the
// algebra: i_of (64 ints), path ids (64 ints), grades (8 ints).
void csmpn_cemlp_tables(int* i_of_out, int* path_out, int* grade_out) {
  structural_tables(i_of_out, path_out, grade_out);
}

}  // extern "C"
