// K2 and K3 — one whole CEMLP block, forward and backward, dense form, on
// Hopper (sm_90a): Cl(3,0) (8 blades, up to 32 output channels) and
// Cl(2,0) (4 blades, up to 64 output channels).
//
// Replaces: csmpn_tpu/ops/cemlp_kernel.py, `_fwd_kernel` (K2, launched by
// `_pallas_fwd`, entry `apply_fused_cemlp`) and `_bwd_kernel` (K3,
// launched by `_fused_block_bwd`), in their dense form (nb <= 8).  One
// block is
//     MVLinear -> MVSiLU -> SGP (right linear, grade-norm normalisation,
//     geometric product, + left linear, / sqrt 2) -> MVLayerNorm,
// the function of `_post_linear_math` and of the composed layers in
// csmpn_tpu/nn/modules.py.  The per-row block math is in cemlp_block.cuh,
// templated on the algebra and shared with the fused message-passing
// kernels (fused_egcl.cu).
//
// Bound on this card: at the motion task's widths (C = 28 channels, up to
// 59 input channels, 8 blades) a row costs ~2*8*C*(Cin + 2C) + 6*64*C
// FLOPs against 4*8*(Cin + C) bytes, ~40 FLOP/byte in fp32: memory-bound
// against the tensor cores, near the fp32 FMA ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte).  At the NBA task's widths (Cl(2): C = 40,
// up to 83 input channels, 4 blades) the ratio is about the same (half the
// blades, wider rows).  The backward does about three times the forward's
// work on the same bytes.
//
// Design: the TPU kernel turns the grade sums and the geometric product into
// MXU matrix products over lane tables (Bcat, Kcat, G, H), inflating the
// work nb-fold.  Here a warp owns one row and a lane owns one output
// channel at Cl(3), two (n and n + 32) at Cl(2), so that a lane holds the
// same number of floats in both (cemlp_block.cuh).  The block's parameters
// are staged once per CTA in shared memory, and a CTA walks over row tiles
// so the staging is amortised.  The backward recomputes the forward in the
// tile (as the TPU kernel does), writes dx per row, and accumulates the
// parameter gradients: per-channel ones in registers, channel-mixing ones
// in shared memory, each entry owned by one thread.  CUDA blocks run
// concurrently, so each CTA writes its partial sums to a scratch buffer
// and a second kernel reduces them in a fixed order: no atomics,
// deterministic results.
//
// Precision: FAST = false is fp32 throughout.  FAST = true rounds to bf16
// the operands of each product that the TPU kernel feeds its matrix unit
// (`_cast_pair`/`_dot*`), and accumulates in fp32.

#include "cemlp_block.cuh"

namespace {

template <class A, bool FAST>
__global__ void __launch_bounds__(THREADS)
cemlp_fwd_kernel(const float* __restrict__ x, Params p, Tabs<A> tb,
                 float* __restrict__ out, int rows, int cin, int c) {
  constexpr int NB = A::NB, S = A::SLOTS;
  extern __shared__ float smem[];
  Smem s;
  carve_params<A>(smem, cin, c, s);
  float* xs = smem + params_floats<A>(cin, c);   // [ROWS][NB][cin]
  float* zs = xs + ROWS * NB * cin;              // [ROWS][NB][c]
  stage_params<A, FAST>(p, s, cin, c);

  const int lane = threadIdx.x, r = threadIdx.y;
  const int n_tiles = (rows + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = (int64_t)tile * ROWS;
    __syncthreads();   // staging done / previous tile consumed
    load_x_tile<A, FAST>(x, xs, row0, rows, cin);
    __syncthreads();
    const int64_t row = row0 + r;
    if (row >= rows) continue;   // whole warp: no shuffle partner missing
    Fwd<A> f[S];
    block_forward<A, FAST>(f, s, tb, xs + r * NB * cin, zs + r * NB * c, cin,
                           c, lane);
#pragma unroll
    for (int u = 0; u < S; ++u) {
      const int n = lane + 32 * u;
      if (n >= c) continue;
      const float scale = s.aln[n] / f[u].m;
      float* o = out + (row * c + n) * NB;
#pragma unroll
      for (int i = 0; i < NB; ++i) o[i] = scale * f[u].o[i];
    }
  }
}

// Gradient vector layout (flax parameter order and shapes):
//   dW1 (C, Cin, NG) | db1 (C) | dsilu_a (C, NG) | dsilu_b (C, NG) |
//   dgp_weight (C, NP) | dWr (C, C, NG) | dsigmoid(norm_a) (C, NG) |
//   dWL (C, C, NG) | dbL (C) | dln_a (C)
template <class A>
__host__ __device__ inline int64_t grad_floats(int cin, int c) {
  return (int64_t)c * cin * A::NG + c + 2 * A::NG * c + A::NP * c +
         c * c * A::NG + A::NG * c + c * c * A::NG + 2 * c;
}

template <class A, bool FAST>
__global__ void __launch_bounds__(THREADS)
cemlp_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dout,
                 Params p, Tabs<A> tb, float* __restrict__ dx,
                 float* __restrict__ partials, int rows, int cin, int c) {
  constexpr int NB = A::NB, NG = A::NG, NP = A::NP, S = A::SLOTS;
  using L = Loc<A>;
  extern __shared__ float smem[];
  Smem s;
  carve_params<A>(smem, cin, c, s);
  float* xs = smem + params_floats<A>(cin, c);   // [ROWS][NB][cin]
  float* zs = xs + ROWS * NB * cin;              // [ROWS][NB][c], rounded z
  float* dfs = zs + ROWS * NB * c;               // d(first) = d(gp)
  float* drs = dfs + ROWS * NB * c;              // d(yr)
  float* dys = drs + ROWS * NB * c;              // d(y)
  float* aw1 = dys + ROWS * NB * c;              // [(m*NG+g)*C + n]
  float* awr = aw1 + cin * NG * c;
  float* awl = awr + c * NG * c;
  float* loc = awl + c * NG * c;                 // [L::N][C]
  stage_params<A, FAST>(p, s, cin, c);
  const int tid = threadIdx.x + 32 * threadIdx.y;
  for (int e = tid; e < cin * NG * c; e += THREADS) aw1[e] = 0.f;
  for (int e = tid; e < c * NG * c; e += THREADS) { awr[e] = 0.f; awl[e] = 0.f; }
  for (int e = tid; e < L::N * c; e += THREADS) loc[e] = 0.f;

  const int lane = threadIdx.x, r = threadIdx.y;
  Acc<A> a[S];   // per-channel gradient accumulators (this thread's rows)
  acc_zero<A>(a);

  const int n_tiles = (rows + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = (int64_t)tile * ROWS;
    __syncthreads();
    load_x_tile<A, FAST>(x, xs, row0, rows, cin);
    __syncthreads();
    const int64_t row = row0 + r;
    if (row < rows) {
      Fwd<A> f[S];
      block_forward<A, FAST>(f, s, tb, xs + r * NB * cin, zs + r * NB * c,
                             cin, c, lane);
      float go[S][NB];
#pragma unroll
      for (int u = 0; u < S; ++u) {
        const int n = lane + 32 * u;
#pragma unroll
        for (int i = 0; i < NB; ++i)
          go[u][i] = n < c ? dout[(row * c + n) * NB + i] : 0.f;
      }
      block_backward_row<A, FAST>(f, s, tb, go, a, dfs + r * NB * c,
                                  drs + r * NB * c, dys + r * NB * c,
                                  dx + row * cin * NB, cin, c, lane);
    }
    __syncthreads();
    int nrow = rows - (int)row0;
    nrow = nrow < ROWS ? nrow : ROWS;
    weight_grads<A>(xs, zs, dfs, drs, dys, nrow, cin, c, aw1, awr, awl);
  }
  acc_to_loc<A>(a, loc, c, lane);
  // ---- this CTA's partial gradient vector, in flax layout
  float* part = partials + (int64_t)blockIdx.x * grad_floats<A>(cin, c);
  int64_t o = 0;
  for (int e = tid; e < c * cin * NG; e += THREADS) {    // (n, m, g)
    const int g = e % NG, m = (e / NG) % cin, q = e / (NG * cin);
    part[o + e] = aw1[(m * NG + g) * c + q];
  }
  o += (int64_t)c * cin * NG;
  for (int e = tid; e < c; e += THREADS) part[o + e] = loc[L::B1 * c + e];
  o += c;
  for (int e = tid; e < c * NG; e += THREADS)
    part[o + e] = loc[(L::SA + e % NG) * c + e / NG];
  o += NG * c;
  for (int e = tid; e < c * NG; e += THREADS)
    part[o + e] = loc[(L::SB + e % NG) * c + e / NG];
  o += NG * c;
  for (int e = tid; e < c * NP; e += THREADS)
    part[o + e] = loc[(L::GW + e % NP) * c + e / NP];
  o += NP * c;
  for (int e = tid; e < c * c * NG; e += THREADS) {
    const int g = e % NG, m = (e / NG) % c, q = e / (NG * c);
    part[o + e] = awr[(m * NG + g) * c + q];
  }
  o += (int64_t)c * c * NG;
  for (int e = tid; e < c * NG; e += THREADS)
    part[o + e] = loc[(L::NS + e % NG) * c + e / NG];
  o += NG * c;
  for (int e = tid; e < c * c * NG; e += THREADS) {
    const int g = e % NG, m = (e / NG) % c, q = e / (NG * c);
    part[o + e] = awl[(m * NG + g) * c + q];
  }
  o += (int64_t)c * c * NG;
  for (int e = tid; e < c; e += THREADS) part[o + e] = loc[L::BL * c + e];
  o += c;
  for (int e = tid; e < c; e += THREADS) part[o + e] = loc[L::ALN * c + e];
}

template <class A>
bool widths_ok(int cin, int c) {
  return cin >= 1 && c >= 1 && c <= 32 * A::SLOTS;
}

template <class A>
size_t fwd_smem_bytes(int cin, int c) {
  return sizeof(float) *
         ((size_t)params_floats<A>(cin, c) + ROWS * A::NB * (size_t)(cin + c));
}

template <class A>
size_t bwd_smem_bytes(int cin, int c) {
  return sizeof(float) *
         ((size_t)params_floats<A>(cin, c) +
          ROWS * A::NB * (size_t)(cin + 4 * c) +
          (size_t)(cin + 2 * c) * A::NG * c + (size_t)Loc<A>::N * c);
}

template <class A>
size_t smem_bytes(int cin, int c, int backward) {
  if (!widths_ok<A>(cin, c)) return 0;
  return backward ? bwd_smem_bytes<A>(cin, c) : fwd_smem_bytes<A>(cin, c);
}

template <class A>
int launch_fwd(const float* x, const Params& p, const float* bc,
               const float* sign, float* out, int rows, int cin, int c,
               int fast, int grid, void* stream) {
  const size_t bytes = fwd_smem_bytes<A>(cin, c);
  if (!widths_ok<A>(cin, c) || bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  Tabs<A> tb = make_tabs<A>(bc, sign);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 block(32, ROWS);
  if (rows > 0) {
    if (fast) {
      cudaFuncSetAttribute(cemlp_fwd_kernel<A, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      cemlp_fwd_kernel<A, true><<<grid, block, bytes, st>>>(x, p, tb, out,
                                                            rows, cin, c);
    } else {
      cudaFuncSetAttribute(cemlp_fwd_kernel<A, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      cemlp_fwd_kernel<A, false><<<grid, block, bytes, st>>>(x, p, tb, out,
                                                             rows, cin, c);
    }
  }
  return (int)cudaGetLastError();
}

template <class A>
int launch_bwd(const float* x, const float* dout, const Params& p,
               const float* bc, const float* sign, float* dx, float* partials,
               float* grads, int rows, int cin, int c, int fast, int grid,
               void* stream) {
  const size_t bytes = bwd_smem_bytes<A>(cin, c);
  if (!widths_ok<A>(cin, c) || bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  Tabs<A> tb = make_tabs<A>(bc, sign);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 block(32, ROWS);
  if (fast) {
    cudaFuncSetAttribute(cemlp_bwd_kernel<A, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    cemlp_bwd_kernel<A, true><<<grid, block, bytes, st>>>(x, dout, p, tb, dx,
                                                          partials, rows, cin, c);
  } else {
    cudaFuncSetAttribute(cemlp_bwd_kernel<A, false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    cemlp_bwd_kernel<A, false><<<grid, block, bytes, st>>>(x, dout, p, tb, dx,
                                                           partials, rows, cin, c);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = grad_floats<A>(cin, c);
  reduce_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      partials, grads, n, grid);
  return (int)cudaGetLastError();
}

}  // namespace

// One set of C entry points per algebra: csmpn_cemlp_* (Cl(3,0)) and
// csmpn_cemlp_cl2_* (Cl(2,0)).  The 10 block parameters are device
// pointers in flax order (w1 b1 sa sb gw wr na wl bl aln); x (rows, cin,
// NB) fp32, out (rows, c, NB).  The backward writes dx (rows, cin, NB) and
// grads (grad_floats,), with partials (grid, grad_floats) as scratch.  The
// smem entry gives a launch's shared-memory bytes (0 if the widths are not
// supported); the tables entry the structural tables the kernels assume,
// for the host to check against the algebra: i_of (NB^2 ints), path ids
// (NB^2 ints), grades (NB ints).
#define CSMPN_PARAMS_DECL                                                     \
  const float *w1, const float *b1, const float *sa, const float *sb,         \
      const float *gw, const float *wr, const float *na, const float *wl,     \
      const float *bl, const float *aln
#define CSMPN_PARAMS Params{w1, b1, sa, sb, gw, wr, na, wl, bl, aln}
#define CSMPN_CEMLP_ENTRIES(PREFIX, ALG)                                      \
  size_t PREFIX##_smem_bytes(int cin, int c, int backward) {                  \
    return smem_bytes<ALG>(cin, c, backward);                                 \
  }                                                                           \
  int PREFIX##_fwd(const float* x, CSMPN_PARAMS_DECL, const float* bc,        \
                   const float* sign, float* out, int rows, int cin, int c,   \
                   int fast, int grid, void* stream) {                        \
    return launch_fwd<ALG>(x, CSMPN_PARAMS, bc, sign, out, rows, cin, c,      \
                           fast, grid, stream);                               \
  }                                                                           \
  int PREFIX##_bwd(const float* x, const float* dout, CSMPN_PARAMS_DECL,      \
                   const float* bc, const float* sign, float* dx,             \
                   float* partials, float* grads, int rows, int cin, int c,   \
                   int fast, int grid, void* stream) {                        \
    return launch_bwd<ALG>(x, dout, CSMPN_PARAMS, bc, sign, dx, partials,     \
                           grads, rows, cin, c, fast, grid, stream);          \
  }                                                                           \
  void PREFIX##_tables(int* i_of_out, int* path_out, int* grade_out) {        \
    structural_tables<ALG>(i_of_out, path_out, grade_out);                    \
  }

extern "C" {
CSMPN_CEMLP_ENTRIES(csmpn_cemlp, Cl3)
CSMPN_CEMLP_ENTRIES(csmpn_cemlp_cl2, Cl2)
}  // extern "C"
