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
// work nb-fold.  Here both directions have two kernels, one a mode.
//
// Fast mode (the training default) runs the row tiles of cemlp_tile.cuh:
// a CTA stages the block's parameters once (the channel-mixing weights in
// bf16) and walks over steps of 16 rows, the three channel-mixing linears
// (and in the backward their transposes and weight gradients) as bf16
// mma.sync products, the rest of the block a warp a row and a lane a
// channel (two at Cl(2)).  The forward (`cemlp_fwd_tile_kernel`) writes
// the block's output from the row phase straight to global memory in
// fp32, a lane its channel's NB contiguous floats; it keeps only the
// forward's tiles (x, z, yr, first; yr and first over x), so that two
// CTAs share an SM at the task widths at 128 registers, and the wrapper
// sizes the grid by what an SM holds (`fwd_tile_blocks`).  A first
// launch (`pack_tparams_kernel`) lays the parameters out once in global
// memory as the CTAs' shared-memory image, which each CTA then copies in
// 16-byte pieces: staging them per CTA cost more than a step.  The
// backward (`cemlp_bwd_tile_kernel`) holds the weight gradients in
// registers over all of the CTA's steps.  Where a step's x tile does not
// fit whole, either holds the input channels in chunks (an instance of
// its own).
//
// Exact mode keeps the row kernels of cemlp_block.cuh (fp32 FFMA: neither
// bf16 nor TF32 products meet its 1e-5): a warp a row and a lane an output
// channel (two at Cl(2)), the parameters staged once per CTA in shared
// memory and row tiles walked so that the staging is amortised.  The
// exact backward recomputes the forward in the tile (as the TPU kernel
// does), writes dx per row, and accumulates the parameter gradients:
// per-channel ones in registers, channel-mixing ones in shared memory,
// each entry owned by one thread.
//
// CUDA blocks run concurrently, so each backward CTA writes its partial
// sums to a scratch buffer and a second kernel reduces them in a fixed
// order; every output element of the forward has one owner: no atomics,
// bitwise repeatable results.
//
// Precision: exact mode is fp32 throughout.  Fast mode rounds to bf16 the
// operands of each product that the TPU kernel feeds its matrix unit
// (`_cast_pair`/`_dot*`: x, the weights and the dense form's path weight,
// z, yn and the squared terms of the grade norms), accumulates in fp32 and
// writes the forward's output in fp32, as the TPU kernel does.

#include "cemlp_tile.cuh"

namespace {

// K2 in exact mode.
template <class A>
__global__ void __launch_bounds__(THREADS)
cemlp_fwd_kernel(const float* __restrict__ x, Params p, Tabs<A> tb,
                 float* __restrict__ out, int rows, int cin, int c) {
  constexpr int NB = A::NB, S = A::SLOTS;
  extern __shared__ float smem[];
  Smem s;
  carve_params<A>(smem, cin, c, s);
  float* xs = smem + params_floats<A>(cin, c);   // [ROWS][NB][cin]
  float* zs = xs + ROWS * NB * cin;              // [ROWS][NB][c]
  stage_params<A>(p, s, cin, c);

  const int lane = threadIdx.x, r = threadIdx.y;
  const int n_tiles = (rows + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = (int64_t)tile * ROWS;
    __syncthreads();   // staging done / previous tile consumed
    load_x_tile<A>(x, xs, row0, rows, cin);
    __syncthreads();
    const int64_t row = row0 + r;
    if (row >= rows) continue;   // whole warp: no shuffle partner missing
    Fwd<A> f[S];
    block_forward<A>(f, s, tb, xs + r * NB * cin, zs + r * NB * c,
                            cin, c, lane);
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

template <class A>
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
  stage_params<A>(p, s, cin, c);
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
    load_x_tile<A>(x, xs, row0, rows, cin);
    __syncthreads();
    const int64_t row = row0 + r;
    if (row < rows) {
      Fwd<A> f[S];
      block_forward<A>(f, s, tb, xs + r * NB * cin, zs + r * NB * c,
                             cin, c, lane);
      float go[S][NB];
#pragma unroll
      for (int u = 0; u < S; ++u) {
        const int n = lane + 32 * u;
#pragma unroll
        for (int i = 0; i < NB; ++i)
          go[u][i] = n < c ? dout[(row * c + n) * NB + i] : 0.f;
      }
      block_backward_row<A>(f, s, tb, go, a, dfs + r * NB * c,
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

// K3 in fast mode: the row tiles of cemlp_tile.cuh.  A CTA walks over
// steps of TROWS rows; its weight gradients stay in registers (MAXT tiles
// a warp) until the end, where the CTA writes its partial vector in the
// layout of grad_floats.
template <class A>
size_t tile_bwd_bytes(const TileGeom& t) {
  return tparams_bytes<A>(t) + al16(2 * (size_t)A::NB * TROWS * t.ldb) +
         tilebufs_bytes<A>(t, wgrad_tiles<A>(t));
}

// K2 in fast mode: the forward's tiles alone, carved in this order by
// cemlp_fwd_tile_kernel: parameters, z, then x and, over it, yr and
// first (x is read by F1 alone, before F2 writes yr and first; they are
// read by the row phase alone, before the next step's x comes in).
template <class A>
size_t tile_fwd_bytes(const TileGeom& t) {
  const size_t xb = al16(2 * (size_t)A::NB * TROWS * t.ldb),
               yf = 2 * al16(4 * (size_t)A::NB * TROWS * t.fp);
  return tparams_bytes<A>(t) + al16(2 * (size_t)A::NB * TROWS * t.ldc) +
         (xb > yf ? xb : yf);
}

// The launch's geometry, backward (K3) or forward (K2): the x tile whole
// where it fits, else cut into the fewest even chunks of input channels
// that fit.  Returns its shared-memory bytes, 0 where it does not take the
// widths: more than 64 output channels (8 warps of 8 channels), for the
// backward more weight-gradient tiles than 40 a warp, or more than one
// CTA's shared memory even at chunks of 16.
template <class A, bool BWD>
size_t tile_plan(int cin, int c, TileGeom* out) {
  if (cin < 1 || c < 1 || c > 32 * A::SLOTS || c > 64) return 0;
  TileGeom t = tile_geom(cin, c);
  if (BWD && tile_maxt<A>(t) == 0) return 0;
  for (int nch = 1; nch <= t.kin / 16; ++nch) {
    t = tile_geom(cin, c, up16((t.kin + nch - 1) / nch));
    const size_t bytes = BWD ? tile_bwd_bytes<A>(t) : tile_fwd_bytes<A>(t);
    if (bytes <= kMaxSmem) {
      if (out != nullptr) *out = t;
      return bytes;
    }
  }
  return 0;
}

// Chunk ch of a step's x rows (fp32 [rows][cin][NB] from row0; nrow of
// them) into the x tile as bf16 [NB][TROWS][ldb]: rows past nrow zero, and
// in the last of several chunks the padded columns zero.  Where !CHUNKED
// the tile is whole and the step's rows one contiguous run.
template <class A, bool CHUNKED>
__device__ __forceinline__ void load_x_chunk(const float* __restrict__ x,
                                             int64_t row0, int nrow,
                                             const TileGeom& t, int ch,
                                             bf16* xb) {
  constexpr int NB = A::NB;
  const int k0 = CHUNKED ? ch * t.kch : 0;
  const int kw = CHUNKED && t.cin - k0 > t.kch ? t.kch : t.cin - k0;
  const int per_row = t.cin * NB, run = kw * NB;
  // a row's chunk is a contiguous run of whole float4s (NB % 4 == 0)
  copy_in4(
      TROWS * run / 4,
      [&](int e) {
        if (!CHUNKED)
          return e < nrow * (run / 4)
                     ? reinterpret_cast<const float4*>(x + row0 * per_row)[e]
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        const int r = 4 * e / run, rem = 4 * e % run;
        return r < nrow ? *reinterpret_cast<const float4*>(
                              x + (row0 + r) * per_row + k0 * NB + rem)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      },
      [&](int e, float4 v) {
        const int r = 4 * e / run, rem = 4 * e % run;
        const int m = rem / NB, i0 = rem % NB;
        bf16* d = xb + (size_t)(i0 * TROWS + r) * t.ldb + m;
        const size_t step = (size_t)TROWS * t.ldb;
        d[0] = __float2bfloat16_rn(v.x);
        d[step] = __float2bfloat16_rn(v.y);
        d[2 * step] = __float2bfloat16_rn(v.z);
        d[3 * step] = __float2bfloat16_rn(v.w);
      });
  const int kp = t.kin - k0 < t.kch ? t.kin - k0 : t.kch;   // padded
  if (CHUNKED && t.nch > 1 && kw < kp) {
    const int tid = threadIdx.x + 32 * threadIdx.y, w = kp - kw;
    for (int e = tid; e < NB * TROWS * w; e += THREADS)
      xb[(size_t)(e / w) * t.ldb + kw + e % w] = __float2bfloat16_rn(0.f);
  }
}

// Writes the per-channel block loc ([Loc::N][C]) into a partial vector
// in flax layout.
template <class A>
__device__ inline void loc_to_flax(const float* loc, float* part, int cin,
                                   int c) {
  constexpr int NG = A::NG, NP = A::NP;
  using L = Loc<A>;
  const int tid = threadIdx.x + 32 * threadIdx.y;
  int64_t o = (int64_t)c * cin * NG;
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
  o += NP * c + (int64_t)c * c * NG;
  for (int e = tid; e < c * NG; e += THREADS)
    part[o + e] = loc[(L::NS + e % NG) * c + e / NG];
  o += NG * c + (int64_t)c * c * NG;
  for (int e = tid; e < c; e += THREADS) part[o + e] = loc[L::BL * c + e];
  o += c;
  for (int e = tid; e < c; e += THREADS) part[o + e] = loc[L::ALN * c + e];
}

template <class A, int MAXT, bool CHUNKED>
__global__ void __launch_bounds__(THREADS, 1)
cemlp_bwd_tile_kernel(const float* __restrict__ x,
                      const float* __restrict__ dout, Params p, Tabs<A> tb,
                      float* __restrict__ dx, float* __restrict__ partials,
                      int rows, TileGeom t) {
  constexpr int NB = A::NB, NG = A::NG, NP = A::NP;
  extern __shared__ float smem[];
  const int cin = t.cin, c = t.c;
  TParams s;
  char* q = carve_tparams<A>(reinterpret_cast<char*>(smem), t, s);
  bf16* xb = reinterpret_cast<bf16*>(q);   // [NB][TROWS][ldb]
  q += al16(2 * (size_t)NB * TROWS * t.ldb);
  TileBufs b;
  carve_tilebufs<A>(q, t, wgrad_tiles<A>(t), b);
  stage_tparams<A>(p, s, t);
  zero_bf16(xb, NB * TROWS * t.ldb);
  zero_tilebufs<A>(b, t);
  build_wdesc<A>(b, t, xb);

  const int warp = threadIdx.y, lane = threadIdx.x;
  const int tid = lane + 32 * warp;
  FragAcc<A> fa;
  zero_accs<A>(fa, b, t);
  float wacc[MAXT][4];
#pragma unroll
  for (int j = 0; j < MAXT; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) wacc[j][k] = 0.f;

  const int n_tiles = (rows + TROWS - 1) / TROWS;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = (int64_t)tile * TROWS;
    const int nrow = rows - row0 < TROWS ? (int)(rows - row0) : TROWS;
    __syncthreads();   // the previous step's tiles consumed
    load_x_chunk<A, CHUNKED>(x, row0, nrow, t, 0, xb);
    if (tid < TROWS)
      b.gor[tid] = tid < nrow ? dout + (row0 + tid) * c * NB : nullptr;
    __syncthreads();
    auto sink = [&](int r, int m, const float (&v)[NB]) {
      float4* d = reinterpret_cast<float4*>(dx + ((row0 + r) * cin + m) * NB);
#pragma unroll
      for (int k = 0; k < NB / 4; ++k)
        d[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    };
    auto load = [&](int ch) {
      load_x_chunk<A, CHUNKED>(x, row0, nrow, t, ch, xb);
    };
    tile_block_backward<A, MAXT, false, CHUNKED>(s, tb, xb, b, t, nrow, sink,
                                                 load, fa, wacc, warp, lane);
  }
  accs_to_loc<A>(fa, b, t, warp, lane);
  // ---- this CTA's partial gradient vector, in flax layout
  float* part = partials + (int64_t)blockIdx.x * grad_floats<A>(cin, c);
  const int64_t o_r = (int64_t)c * cin * NG + c + 2 * NG * c + NP * c;
  const int64_t o_l = o_r + (int64_t)c * c * NG + NG * c;
  write_wgrads<A, MAXT>(wacc, t, warp, lane,
                        [&](int which, int m, int n, int g, float v) {
    if (which == 0)
      part[((int64_t)n * cin + m) * NG + g] = v;
    else
      part[(which == 1 ? o_r : o_l) + ((int64_t)n * c + m) * NG + g] = v;
  });
  loc_to_flax<A>(b.loc, part, cin, c);
}

// K2 in fast mode, first launch: the block's parameter image, the bytes
// stage_tparams leaves in shared memory (write_tparams over a grid), built
// in global memory once a launch.  Staging it costs each CTA of the
// forward 16-byte copies alone, where staging the parameters themselves
// (write_tparams' index arithmetic, in each of up to 264 CTAs) took longer
// than a whole step of the small launches.
template <class A>
__global__ void __launch_bounds__(256)
pack_tparams_kernel(Params p, TileGeom t, char* __restrict__ img) {
  TParams s;
  carve_tparams<A>(img, t, s);
  write_tparams<A>(p, s, t, blockIdx.x * blockDim.x + threadIdx.x,
                   gridDim.x * blockDim.x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}

// K2 in fast mode: a CTA copies the parameter image into shared memory
// (16-byte async copies that overlap its first step's x load) and walks
// over steps of TROWS rows; a step rounds its x rows into the x tile
// (load_x_chunk, K3's loader) and runs tile_block_forward, whose row phase
// hands each (row, channel) of the output to a sink that writes its NB
// floats to global memory as 16-byte vectors (a warp's row one contiguous
// run of C * NB floats).  Each output element has one owner.  yr and
// first lie over the x tile (tile_fwd_bytes), so a whole x tile's padded
// columns are zeroed at each step.
template <class A, bool CHUNKED>
__global__ void __launch_bounds__(THREADS, 2)
cemlp_fwd_tile_kernel(const float* __restrict__ x,
                      const char* __restrict__ img, Tabs<A> tb,
                      float* __restrict__ out, int rows, TileGeom t) {
  constexpr int NB = A::NB;
  extern __shared__ float smem[];
  const int c = t.c;
  TParams s;   // carved as tile_fwd_bytes counts
  char* q = carve_tparams<A>(reinterpret_cast<char*>(smem), t, s);
  TileBufs b{};   // the forward's tiles: z, yr, first
  b.z = reinterpret_cast<bf16*>(q);
  q += al16(2 * (size_t)NB * TROWS * t.ldc);
  bf16* xb = reinterpret_cast<bf16*>(q);   // [NB][TROWS][ldb]
  b.yr = reinterpret_cast<float*>(q);
  b.ff = b.yr + al16(4 * (size_t)NB * TROWS * t.fp) / 4;
  const int warp = threadIdx.y, lane = threadIdx.x;
  const int tid = lane + 32 * warp, pad = t.kin - t.cin;
  const int n16 = (int)(tparams_bytes<A>(t) / 16);
  for (int e = tid; e < n16; e += THREADS)
    cp_async16(reinterpret_cast<char*>(smem) + 16 * (size_t)e,
               img + 16 * (size_t)e);
  asm volatile("cp.async.commit_group;\n" ::);
  zero_bf16(b.z, NB * TROWS * t.ldc);   // the padded columns stay zero

  const int n_tiles = (rows + TROWS - 1) / TROWS;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = (int64_t)tile * TROWS;
    const int nrow = rows - row0 < TROWS ? (int)(rows - row0) : TROWS;
    // the previous step ended behind a barrier: its tiles are read
    load_x_chunk<A, CHUNKED>(x, row0, nrow, t, 0, xb);
    if (!CHUNKED)   // (a chunked tile's loader zeroes its last chunk's)
      for (int e = tid; e < NB * TROWS * pad; e += THREADS)
        xb[(size_t)(e / pad) * t.ldb + t.cin + e % pad] =
            __float2bfloat16_rn(0.f);
    asm volatile("cp.async.wait_all;\n" ::: "memory");   // the image
    __syncthreads();
    auto sink = [&](int r, int n, const float (&v)[NB]) {
      if (r >= nrow) return;
      float4* d = reinterpret_cast<float4*>(out + ((row0 + r) * c + n) * NB);
#pragma unroll
      for (int k = 0; k < NB / 4; ++k)
        d[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    };
    auto load = [&](int ch) {
      load_x_chunk<A, CHUNKED>(x, row0, nrow, t, ch, xb);
    };
    tile_block_forward<A, CHUNKED>(s, tb, xb, b, t, nrow, sink, load, warp,
                                   lane);
  }
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

// The row kernels' shared-memory bytes a launch needs, 0 where the widths
// are not supported or the bytes exceed one CTA's.
template <class A>
size_t smem_bytes(int cin, int c, int backward) {
  if (!widths_ok<A>(cin, c)) return 0;
  const size_t n =
      backward ? bwd_smem_bytes<A>(cin, c) : fwd_smem_bytes<A>(cin, c);
  return n > kMaxSmem ? 0 : n;
}

// The kernel instance of a launch: whole x tiles at the weight-gradient
// tiles a warp that the widths need (16 to 32), chunked x tiles (or 40
// tiles a warp) at 40.
template <class A>
int tile_instance(const TileGeom& t) {
  const int m = tile_maxt<A>(t);
  return t.nch > 1 ? 40 : m;
}

template <class A, int MAXT, bool CHUNKED = false>
void launch_bwd_tile(const float* x, const float* dout, const Params& p,
                     const Tabs<A>& tb, float* dx, float* partials, int rows,
                     const TileGeom& t, int grid, size_t bytes,
                     cudaStream_t st) {
  cudaFuncSetAttribute(cemlp_bwd_tile_kernel<A, MAXT, CHUNKED>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  cemlp_bwd_tile_kernel<A, MAXT, CHUNKED>
      <<<grid, dim3(32, TWARPS), bytes, st>>>(x, dout, p, tb, dx, partials,
                                              rows, t);
}

template <class A, bool CHUNKED>
void launch_fwd_tile(const float* x, const Params& p, const Tabs<A>& tb,
                     float* out, char* img, int rows, const TileGeom& t,
                     int grid, size_t bytes, cudaStream_t st) {
  // a thread for each element of the widest of write_tparams' loops
  const int n = A::NG * t.kc * (t.ldx > t.ldc ? t.ldx : t.ldc);
  pack_tparams_kernel<A><<<(n + 255) / 256, 256, 0, st>>>(p, t, img);
  cudaFuncSetAttribute(cemlp_fwd_tile_kernel<A, CHUNKED>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  cemlp_fwd_tile_kernel<A, CHUNKED>
      <<<grid, dim3(32, TWARPS), bytes, st>>>(x, img, tb, out, rows, t);
}

// CTAs of the fast-mode forward's instance at (cin, c) that one SM holds
// at once (registers, shared memory and threads), 0 where it does not
// take the widths.
template <class A>
int fwd_tile_blocks(int cin, int c) {
  TileGeom t;
  const size_t bytes = tile_plan<A, false>(cin, c, &t);
  if (bytes == 0) return 0;
  void (*kernel)(const float*, const char*, Tabs<A>, float*, int,
                 TileGeom) =
      t.nch > 1 ? cemlp_fwd_tile_kernel<A, true>
                : cemlp_fwd_tile_kernel<A, false>;
  int n = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS,
                                                    bytes) != cudaSuccess)
    return 0;
  return n;
}

// Fast mode: the parameter image into img (tparams_bytes of the plan),
// then the row tiles, with the x tile in chunks where it does not fit
// whole; exact mode: the row kernel (img unused).
template <class A>
int launch_fwd(const float* x, const Params& p, const float* bc,
               const float* sign, float* out, char* img, int rows, int cin,
               int c, int fast, int grid, void* stream) {
  TileGeom t;
  const size_t bytes =
      fast ? tile_plan<A, false>(cin, c, &t) : fwd_smem_bytes<A>(cin, c);
  if (!widths_ok<A>(cin, c) || bytes == 0 || bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  Tabs<A> tb = make_tabs<A>(bc, sign);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    if (fast && t.nch > 1) {
      launch_fwd_tile<A, true>(x, p, tb, out, img, rows, t, grid, bytes, st);
    } else if (fast) {
      launch_fwd_tile<A, false>(x, p, tb, out, img, rows, t, grid, bytes,
                                st);
    } else {
      cudaFuncSetAttribute(cemlp_fwd_kernel<A>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
      cemlp_fwd_kernel<A><<<grid, dim3(32, ROWS), bytes, st>>>(x, p, tb, out,
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
  TileGeom t;
  const size_t bytes =
      fast ? tile_plan<A, true>(cin, c, &t) : bwd_smem_bytes<A>(cin, c);
  if (!widths_ok<A>(cin, c) || bytes == 0 || bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  Tabs<A> tb = make_tabs<A>(bc, sign);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fast) {
    switch (tile_instance<A>(t)) {
      case 16:
        launch_bwd_tile<A, 16>(x, dout, p, tb, dx, partials, rows, t, grid,
                               bytes, st);
        break;
      case 20:
        launch_bwd_tile<A, 20>(x, dout, p, tb, dx, partials, rows, t, grid,
                               bytes, st);
        break;
      case 24:
        launch_bwd_tile<A, 24>(x, dout, p, tb, dx, partials, rows, t, grid,
                               bytes, st);
        break;
      case 32:
        launch_bwd_tile<A, 32>(x, dout, p, tb, dx, partials, rows, t, grid,
                               bytes, st);
        break;
      default:   // chunked, or 40 tiles a warp
        launch_bwd_tile<A, 40, true>(x, dout, p, tb, dx, partials, rows, t,
                                     grid, bytes, st);
    }
  } else {
    cudaFuncSetAttribute(cemlp_bwd_kernel<A>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    cemlp_bwd_kernel<A><<<grid, dim3(32, ROWS), bytes, st>>>(
        x, dout, p, tb, dx, partials, rows, cin, c);
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
// NB) fp32, out (rows, c, NB); the fast forward's scratch img holds its
// parameter image (fwd_tile_plan's info[2] bytes).  The backward writes
// dx (rows, cin, NB) and grads (grad_floats,), with partials (grid,
// grad_floats) as scratch.  The
// smem entry gives a launch's shared-memory bytes (0 if the widths are not
// supported); tile_plan the fast-mode backward's bytes (0 where it does
// not take the widths) and, into info, its kernel instance (the
// weight-gradient tiles a warp it holds: 16 to 32 with the x tile whole,
// 40 with it in chunks), its x tile's chunks and their input channels;
// fwd_tile_plan the same of the fast-mode forward (info: its x tile's
// chunks, where more than one its chunked instance, their input channels,
// and the bytes of its parameter image, the scratch img of the forward
// entry), fwd_tile_blocks the CTAs of its instance an SM holds;
// the tables entry the structural tables the kernels assume,
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
  size_t PREFIX##_tile_smem_bytes(int cin, int c) {                           \
    return tile_plan<ALG, true>(cin, c, nullptr);                             \
  }                                                                           \
  size_t PREFIX##_fwd_tile_smem_bytes(int cin, int c) {                       \
    return tile_plan<ALG, false>(cin, c, nullptr);                            \
  }                                                                           \
  size_t PREFIX##_fwd_tile_plan(int cin, int c, int* info) {                  \
    TileGeom t;                                                               \
    const size_t bytes = tile_plan<ALG, false>(cin, c, &t);                   \
    info[0] = bytes ? t.nch : 0;                                              \
    info[1] = bytes ? t.kch : 0;                                              \
    info[2] = bytes ? (int)tparams_bytes<ALG>(t) : 0;                         \
    return bytes;                                                             \
  }                                                                           \
  int PREFIX##_fwd_tile_blocks(int cin, int c) {                              \
    return fwd_tile_blocks<ALG>(cin, c);                                      \
  }                                                                           \
  size_t PREFIX##_tile_plan(int cin, int c, int* info) {                      \
    TileGeom t;                                                               \
    const size_t bytes = tile_plan<ALG, true>(cin, c, &t);                    \
    info[0] = bytes ? tile_instance<ALG>(t) : 0;                              \
    info[1] = bytes ? t.nch : 0;                                              \
    info[2] = bytes ? t.kch : 0;                                              \
    return bytes;                                                             \
  }                                                                           \
  int PREFIX##_fwd(const float* x, CSMPN_PARAMS_DECL, const float* bc,        \
                   const float* sign, float* out, void* img, int rows,        \
                   int cin, int c, int fast, int grid, void* stream) {        \
    return launch_fwd<ALG>(x, CSMPN_PARAMS, bc, sign, out,                    \
                           static_cast<char*>(img), rows, cin, c, fast, grid, \
                           stream);                                           \
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
