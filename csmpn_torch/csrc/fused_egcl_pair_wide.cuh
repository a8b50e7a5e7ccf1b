// K4pw and K5pw — the EGCL edge side, forward and backward, pair form, on
// Hopper (sm_90a), at the widths K4p/K5p's plans (fused_egcl_pair.cuh and
// its tile sweeps) refuse: every C <= 64 channels and Cm + Ca <= 160
// message + attribute channels (K2pw/K3pw's range), at Cl(5,0) (32 blades)
// and Cl(4,0) (16 blades), in both modes:
//     agg[v] = sum over unmasked edges e with dst[e] == v of
//              CEMLP_2(CEMLP_1([h[dst[e]] - hj[e], attr[e]]))
// with dst sorted ascending and hj the pre-gathered source rows.  This
// header holds the device code and its host launchers, templated on the
// pair algebra traits of cemlp_pair.cuh; fused_egcl_pair_wide.cu (Cl(5,0))
// and fused_egcl_pair_wide_cl4.cu (Cl(4,0)) each instantiate one algebra's
// C entry points, so that the two build in parallel.
//
// Replaces: csmpn_tpu/ops/fused_egcl.py, `_make_fwd_kernel` (K4, launched
// by `_mp_forward`) and `_make_bwd_kernel` (K5, launched by
// `_mp_backward`), pair form (their blocks through `_post_linear_math` and
// `_post_linear_bwd`), at the widths the TPU kernel pads to 128 lanes and
// fused_egcl_pair.cuh's shared memory does not hold; the wrapper
// (ops/fused_egcl.fused_route) sends a call here only where K4p/K5p's size
// entries refuse its widths in either direction.
//
// Bound on this card: at the bench shape at hidden 64 (E = 131,072 edge
// rows, 64 -> 64 -> 64 channels, 32 blades) a row's two blocks cost 2 *
// (2*32*64*(64 + 2*64) + 2*32*32*64) FLOPs, ~1.8 MFLOP, against ~4 KB of
// bf16 rows: ~375 FLOP a byte, above even the bf16 tensor cores' ridge
// (989 TFLOP/s over 3.35 TB/s = 295 FLOP/byte), so these FFMA kernels are
// bound by operations (~3.6 ms at the fp32 peak; ~0.24 ms at the bf16
// rate).  The backward does about three times the forward's work.
//
// Design (simple first: FFMA products, K2pw/K3pw's device code, K4w/K5w's
// slabs):
//   * both blocks' parameters are laid out once a call as K2pw/K3pw's
//     images (`cemlp_pair_wide_pack_kernel`), the weight panels streamed
//     through shared memory as there;
//   * the edge rows are taken in slabs of pfw_slab<A>() rows, 2^19 (row,
//     blade) pairs: 16,384 rows at Cl(5), 32,768 at Cl(4).  A K5pw slab row
//     holds ~100 KB of scratch at the widest widths (x, d(agg)[dst], block
//     1's output, both dx and K3pw's five cotangent rows), so a slab keeps
//     K5pw's scratch near 1.3-1.7 GB.  A slab's window sums continue the
//     sums of the slab before it (fused_slabs.cuh), so each target's sum
//     runs over its edges in edge order whatever the slab boundaries;
//   * K4pw (`fused_pair_wide_fwd_kernel`), a sweep over a slab's rows: a
//     CTA step takes a row a member (a warp at Cl(5), a half-warp at
//     Cl(4)), a lane its blade of all C channels (K2pw's layout).  The step
//     gathers x = [h[dst] - hj, attr] a panel of input channels at a time
//     (PWGatherRows), runs block 1's forward on K2pw's row code, writes its
//     output row (rounded where block 2 rounds its input) over the member's
//     product tile, which pw_out has read, runs block 2's forward from it,
//     and writes the masked message row to the slab's scratch (bf16 in
//     fast mode, fp32 in exact).  The path weights in shared memory are
//     restaged before each block's forward: the last barrier of a block's
//     left linear lies after every member's product;
//   * the window sums: fused_slabs.cuh's `fused_wide_sum_kernel`, a warp a
//     target in edge order; no atomics, so two launches give the same bits;
//   * K5pw, per slab: fused_slabs.cuh's gather writes x (fp32) and the
//     gathered cotangent d(agg)[dst] (masked, rounded in fast mode); K2pw's
//     forward recomputes block 1's output from x; K3pw's row kernel, its
//     weight-gradient, path-weight-gradient and reduce kernels run block
//     2's backward, then block 1's (the reduce adds each slab's gradients
//     onto the slabs' before it, in slab order); fused_slabs.cuh's d(h)
//     kernel writes dhj, dattr and each target's d(h), a warp a target, in
//     edge order.  The 20 parameter gradients come out as two of K3pw's
//     flax-layout vectors, block 1's then block 2's.
//
// Precision: exact mode is fp32 throughout.  Fast mode streams h, hj and
// attr as bf16 and rounds where the plain fast version
// (`message_aggregate_plain`, ops/fused_egcl.py) rounds: x and block 2's
// input on load, every operand K2pw/K3pw round, the message before the
// sum and d(agg) before the backward; dx is rounded before it enters
// d(h), dhj and dattr, where the plain version's casts round it.  Sums are
// fp32.

#pragma once

#include "cemlp_pair_wide.cuh"
#include "fused_slabs.cuh"

namespace {

// Edge rows a slab: 2^19 (row, blade) pairs.
template <class A>
constexpr int pfw_slab() {
  return (1 << 19) / A::NB;
}

// K4pw's block-1 input: the step's nrow edge rows gathered, a chunk of kn
// input channels at a time into xs [slot][PW_KC][NB] (rounded in fast
// mode), rows past `end` zero.
template <class A, bool FAST, class T>
struct PWGatherRows {
  const T* __restrict__ h;
  const T* __restrict__ hj;
  const T* __restrict__ attr;
  const int* __restrict__ dst;
  int64_t row0, end;
  int nrow, cm, ca;
  __device__ __forceinline__ void load(float* xs, int k0, int kn) const {
    constexpr int NB = A::NB;
    const int tid = threadIdx.x + 32 * threadIdx.y, nt = 32 * blockDim.y;
    const int per4 = kn * NB / 4;
    for (int e = tid; e < nrow * per4; e += nt) {
      const int r = e / per4, q = e % per4;
      const int64_t row = row0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < end)
        v = slab_rnd4<FAST>(
            gather4<A, T>(h, hj, attr, dst, row, k0 * NB + 4 * q, cm, ca));
      reinterpret_cast<float4*>(xs + r * PW_KC * NB)[q] = v;
    }
  }
  __device__ __forceinline__ const float* at(const float* xs, int slot,
                                             int) const {
    return xs + slot * PW_KC * A::NB;
  }
};

// ----------------------------------------------------------------- K4pw

// A CTA walks over steps of a row a member of the slab [r0, r0 + rows):
// block 1's forward from the gathered rows; its output aln / mean * o,
// rounded, over the member's product tile; block 2's forward from that
// tile; the masked message row aln / mean * o (rounded) to msg, the slab's
// row r - r0.
template <class A, bool FAST, class T>
__global__ void __launch_bounds__(PW_THREADS, 1)
fused_pair_wide_fwd_kernel(const T* __restrict__ h, const T* __restrict__ hj,
                           const T* __restrict__ attr,
                           const int* __restrict__ dst,
                           const uint8_t* __restrict__ mask,
                           const float* __restrict__ img1,
                           const float* __restrict__ img2,
                           const uint16_t* __restrict__ tabs, Tabs<A> tb,
                           MsgT<FAST>* __restrict__ msg, int64_t r0,
                           int rows, int cm, int ca, PWLayout L1,
                           PWLayout L2) {
  constexpr int NB = A::NB;
  extern __shared__ float4 pw_smem4[];
  const int nrow = (int)blockDim.y * A::MW;
  const PWSmem sm =
      pw_carve<A>(reinterpret_cast<float*>(pw_smem4), L2, nrow);
  pw_stage_common<A>(sm, img1, tabs, L1, NB * NB);
  const PWLane ln = pw_lane<A>(tb);
  const int c = L2.c, c4 = L2.c4, nq = c4 / 4, b = ln.b;
  PWRow rw;
  rw.z = sm.tiles + (int64_t)ln.slot * c4 * NB;
  rw.yn = rw.gp = sm.tiles + ((int64_t)nrow + ln.slot) * c4 * NB;
  rw.yr = nullptr;
  rw.sc = sm.sc + ln.slot * NB * 4;
  const int n_tiles = (rows + nrow - 1) / nrow;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t lrow0 = (int64_t)tile * nrow, lrow = lrow0 + ln.slot;
    float acc[PW_Q][4];
    pw_stage4(sm.gws, img1 + L1.gw, c4 * L1.npp);
    const PWGatherRows<A, FAST, T> xr{
        h, hj, attr, dst, r0 + lrow0, r0 + rows, nrow, cm, ca};
    pw_front<A, FAST, false>(acc, xr, img1, L1, sm, rw, ln);
    float m = pw_out<A, FAST>(acc, img1, L1, rw.gp, ln);
#pragma unroll
    for (int q = 0; q < PW_Q; ++q) {
      if (q < nq) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int n = 4 * q + u;
          rw.gp[n * NB + b] =
              rnd<FAST>(__ldg(img1 + L1.aln + n) / m * acc[q][u]);
        }
      }
    }
    pw_stage4(sm.gws, img2 + L2.gw, c4 * L2.npp);
    pw_front<A, FAST, false>(acc, PWTileRows<A>{rw.gp}, img2, L2, sm, rw,
                             ln);
    m = pw_out<A, FAST>(acc, img2, L2, rw.gp, ln);
    if (lrow >= rows) continue;
    const bool keep = mask == nullptr || mask[r0 + lrow];
#pragma unroll
    for (int q = 0; q < PW_Q; ++q) {
      if (q < nq) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int n = 4 * q + u;
          if (n < c)
            msg[(lrow * c + n) * NB + b] = from_f<MsgT<FAST>>(
                keep ? rnd<FAST>(__ldg(img2 + L2.aln + n) / m * acc[q][u])
                     : 0.f);
        }
      }
    }
  }
}

// ------------------------------------------------------------------ host

Params pfw_params(const float* const* pp) {
  return Params{pp[0], pp[1], pp[2], pp[3], pp[4],
                pp[5], pp[6], pp[7], pp[8], pp[9]};
}

inline bool pfw_ok(int cm, int ca, int c) {
  return cm >= 1 && ca >= 0 && pw_ok(cm + ca, c);
}

// Shared-memory bytes of a launch of the direction: K4pw's sweep (K2pw's
// forward layout), or the largest of K5pw's K2pw forward and K3pw backward.
template <class A>
size_t pfw_smem_bytes(int cm, int ca, int c, int backward) {
  if (!pfw_ok(cm, ca, c)) return 0;
  const size_t f = pw_smem_bytes<A>(cm + ca, c, 0);
  const size_t b = backward ? pw_smem_bytes<A>(cm + ca, c, 1) : f;
  return f == 0 || b == 0 ? 0 : f > b ? f : b;
}

// The scratch of a call (floats from its base, each part 256-byte aligned).
struct PfwScratch {
  int64_t img1, img2;          // the two blocks' parameter images
  int64_t msg;                 // K4pw: a slab's message rows
  int64_t x, x2, g, dx2, dx1;  // K5pw: a slab's rows of x, block 2's input,
                               // d(agg)[dst], block 2's dx, block 1's dx
  int64_t cot;                 // K3pw's five cotangent rows
  int64_t lpart, wpart, ppart; // K3pw's partial slabs
  int64_t total;
};

template <class A>
PfwScratch pfw_scratch(int64_t n_edges, int cm, int ca, int c, int backward,
                       int sms) {
  constexpr int NB = A::NB;
  const int cin = cm + ca;
  const int64_t s = n_edges < pfw_slab<A>() ? n_edges : pfw_slab<A>();
  const bool bwd = backward != 0;
  PfwScratch f{};
  int64_t o = 0;
  f.img1 = o; o += fw_al(pw_layout<A>(cin, c, bwd).total);
  f.img2 = o; o += fw_al(pw_layout<A>(c, c, bwd).total);
  if (!bwd) {
    f.msg = o; o += fw_al(s * c * NB);   // fp32 room, bf16 in fast mode
  } else {
    const int nrow = pw_warps<A>(cin, c, 1) * A::MW;
    const int grid = fw_grid(s, nrow, sms, pw_smem_bytes<A>(cin, c, 1));
    const int splits1 = pw_splits((int)s, pw_wgrad_jobs<A>(cin, c), sms);
    const int splits2 = pw_splits((int)s, pw_wgrad_jobs<A>(c, c), sms);
    const int psplits = pw_splits((int)s, (c + PW_PG_C - 1) / PW_PG_C, sms);
    const int64_t wp1 = (int64_t)splits1 * pw_wpart_floats<A>(cin, c);
    const int64_t wp2 = (int64_t)splits2 * pw_wpart_floats<A>(c, c);
    f.x = o; o += fw_al(s * cin * NB);
    f.x2 = o; o += fw_al(s * c * NB);
    f.g = o; o += fw_al(s * c * NB);
    f.dx2 = o; o += fw_al(s * c * NB);
    f.dx1 = o; o += fw_al(s * cin * NB);
    f.cot = o; o += fw_al(5 * s * c * NB);
    f.lpart = o; o += fw_al((int64_t)grid * nrow * A::NLOC * c);
    f.wpart = o; o += fw_al(wp1 > wp2 ? wp1 : wp2);
    f.ppart = o; o += fw_al((int64_t)psplits * c * A::NP);
  }
  f.total = o;
  return f;
}

template <class A>
long long pfw_scratch_bytes(long long n_edges, int cm, int ca, int c,
                            int backward, int sms) {
  if (!pfw_ok(cm, ca, c) || n_edges < 0 || sms < 1) return 0;
  return (long long)sizeof(float) *
         pfw_scratch<A>(n_edges, cm, ca, c, backward, sms).total;
}

template <class A>
long long pfw_grad_floats(int cm, int ca, int c) {
  if (!pfw_ok(cm, ca, c)) return 0;
  return pw_grad_floats<A>(cm + ca, c) + pw_grad_floats<A>(c, c);
}

template <class A, bool FAST, class T>
void pfw_forward(const T* h, const T* hj, const T* attr, const int* dst,
                 const uint8_t* mask, const int64_t* bounds,
                 const float* const* pp, const Tabs<A>& tb,
                 const uint16_t* tabs, float* out, float* scratch,
                 int n_edges, int cm, int ca, int c, int sms,
                 cudaStream_t st) {
  const int cin = cm + ca;
  const PfwScratch f = pfw_scratch<A>(n_edges, cm, ca, c, 0, sms);
  const PWLayout L1 = pw_layout<A>(cin, c, false);
  const PWLayout L2 = pw_layout<A>(c, c, false);
  float* img1 = scratch + f.img1;
  float* img2 = scratch + f.img2;
  launch_pw_pack<A, FAST>(pfw_params(pp), L1, img1, st);
  launch_pw_pack<A, FAST>(pfw_params(pp + 10), L2, img2, st);
  MsgT<FAST>* msg = reinterpret_cast<MsgT<FAST>*>(scratch + f.msg);
  const int warps = pw_warps<A>(cin, c, 0);
  const size_t bytes = pw_smem_bytes<A>(cin, c, 0);
  cudaFuncSetAttribute(fused_pair_wide_fwd_kernel<A, FAST, T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  constexpr int SLAB = pfw_slab<A>();
  for (int64_t r0 = 0; r0 < n_edges; r0 += SLAB) {
    const int rows = (int)(n_edges - r0 < SLAB ? n_edges - r0 : SLAB);
    fused_pair_wide_fwd_kernel<A, FAST, T>
        <<<fw_grid(rows, warps * A::MW, sms, bytes), dim3(32, warps), bytes,
           st>>>(h, hj, attr, dst, mask, img1, img2, tabs, tb, msg, r0, rows,
                 cm, ca, L1, L2);
    fused_wide_sum_kernel<MsgT<FAST>><<<fw_sum_blocks(rows, sms), 256, 0,
                                        st>>>(msg, dst, bounds, out, r0,
                                              r0 + rows, c * A::NB);
  }
}

template <class A, bool FAST, class T>
void pfw_backward(const T* h, const T* hj, const T* attr, const int* dst,
                  const uint8_t* mask, const int64_t* bounds,
                  const float* dagg, const float* const* pp,
                  const Tabs<A>& tb, const uint16_t* tabs, float* dh, T* dhj,
                  T* dattr, float* scratch, float* grads, int n_edges, int cm,
                  int ca, int c, int sms, cudaStream_t st) {
  constexpr int NB = A::NB;
  const int cin = cm + ca;
  const PfwScratch f = pfw_scratch<A>(n_edges, cm, ca, c, 1, sms);
  // the backward's images; K2pw's forward reads their forward prefix
  const PWLayout L1 = pw_layout<A>(cin, c, true);
  const PWLayout L2 = pw_layout<A>(c, c, true);
  float* img1 = scratch + f.img1;
  float* img2 = scratch + f.img2;
  launch_pw_pack<A, FAST>(pfw_params(pp), L1, img1, st);
  launch_pw_pack<A, FAST>(pfw_params(pp + 10), L2, img2, st);
  float *x = scratch + f.x, *x2 = scratch + f.x2, *g = scratch + f.g;
  float *dx2 = scratch + f.dx2, *dx1 = scratch + f.dx1;
  float *cot = scratch + f.cot, *lpart = scratch + f.lpart;
  float *wpart = scratch + f.wpart, *ppart = scratch + f.ppart;
  float* grads1 = grads;
  float* grads2 = grads + pw_grad_floats<A>(cin, c);
  // a block's launches take the same warps and bytes at cin -> c and at
  // c -> c: they depend on the output width alone
  const int fwarps = pw_warps<A>(cin, c, 0), bwarps = pw_warps<A>(cin, c, 1);
  const size_t fbytes = pw_smem_bytes<A>(cin, c, 0);
  const size_t bbytes = pw_smem_bytes<A>(cin, c, 1);
  cudaFuncSetAttribute(cemlp_pair_wide_fwd_kernel<A, FAST>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)fbytes);
  cudaFuncSetAttribute(cemlp_pair_wide_bwd_kernel<A, FAST>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bbytes);
  // one block's backward over the slab's rows: K3pw's row kernel, its
  // weight and path-weight gradients, their reduction added onto the
  // slabs' before
  auto block_bwd = [&](const float* xin, const float* dout, float* dxo,
                       const float* img, const PWLayout& L, float* gv,
                       int rows, int accum) {
    const int nrow = bwarps * A::MW;
    const int grid = fw_grid(rows, nrow, sms, bbytes);
    const int splits = pw_splits(rows, pw_wgrad_jobs<A>(L.cin, c), sms);
    const int psplits = pw_splits(rows, (c + PW_PG_C - 1) / PW_PG_C, sms);
    cemlp_pair_wide_bwd_kernel<A, FAST>
        <<<grid, dim3(32, bwarps), bbytes, st>>>(xin, dout, img, tabs, tb,
                                                 dxo, cot, lpart, rows, L);
    const int chunk = (rows + splits - 1) / splits;
    cemlp_pair_wide_wgrad_kernel<A, FAST>
        <<<dim3(pw_wgrad_jobs<A>(L.cin, c), splits), 256, 0, st>>>(
            xin, cot, wpart, rows, L.cin, c, chunk < 1 ? 1 : chunk);
    const int pchunk = (rows + psplits - 1) / psplits;
    cemlp_pair_wide_pgrad_kernel<A>
        <<<dim3((c + PW_PG_C - 1) / PW_PG_C, psplits), 256, 0, st>>>(
            cot, tabs, ppart, rows, c, pchunk < 1 ? 1 : pchunk);
    const int64_t n = pw_grad_floats<A>(L.cin, c);
    cemlp_pair_wide_reduce_kernel<A>
        <<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
            wpart, splits, ppart, psplits, lpart, grid * nrow, gv, L.cin, c,
            accum);
  };
  const int gblocks = 8 * sms;
  constexpr int SLAB = pfw_slab<A>();
  for (int64_t r0 = 0; r0 < n_edges; r0 += SLAB) {
    const int rows = (int)(n_edges - r0 < SLAB ? n_edges - r0 : SLAB);
    const int accum = r0 > 0;
    fused_wide_gather_kernel<A, FAST, T><<<gblocks, 256, 0, st>>>(
        h, hj, attr, dst, mask, dagg, x, g, r0, rows, cm, ca, c);
    cemlp_pair_wide_fwd_kernel<A, FAST>
        <<<fw_grid(rows, fwarps * A::MW, sms, fbytes), dim3(32, fwarps),
           fbytes, st>>>(x, img1, tabs, tb, x2, rows, L1);
    block_bwd(x2, g, dx2, img2, L2, grads2, rows, accum);
    block_bwd(x, dx2, dx1, img1, L1, grads1, rows, accum);
    fused_wide_dh_kernel<FAST, T><<<fw_sum_blocks(rows, sms), 256, 0, st>>>(
        dx1, dst, bounds, dh, dhj, dattr, r0, r0 + rows, cm * NB, ca * NB);
  }
}

template <class A>
int pfw_fwd_entry(const void* h, const void* hj, const void* attr,
                  const int* dst, const uint8_t* mask, const int64_t* bounds,
                  const float* const* params, const float* bc,
                  const uint16_t* tabs, float* out, void* scratch,
                  int n_nodes, int n_edges, int cm, int ca, int c, int fast,
                  int sms, void* stream) {
  const size_t bytes = pfw_smem_bytes<A>(cm, ca, c, 0);
  if (bytes == 0 || bytes > kMaxSmem || sms < 1 || n_nodes < 0 ||
      n_edges < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(out, 0, sizeof(float) * (size_t)n_nodes * c * A::NB, st);
  if (n_edges > 0) {
    const Tabs<A> tb = make_tabs<A>(bc);
    float* s = static_cast<float*>(scratch);
    if (fast)
      pfw_forward<A, true>(static_cast<const fw_bf16*>(h),
                           static_cast<const fw_bf16*>(hj),
                           static_cast<const fw_bf16*>(attr), dst, mask,
                           bounds, params, tb, tabs, out, s, n_edges, cm, ca,
                           c, sms, st);
    else
      pfw_forward<A, false>(static_cast<const float*>(h),
                            static_cast<const float*>(hj),
                            static_cast<const float*>(attr), dst, mask,
                            bounds, params, tb, tabs, out, s, n_edges, cm,
                            ca, c, sms, st);
  }
  return (int)cudaGetLastError();
}

template <class A>
int pfw_bwd_entry(const void* h, const void* hj, const void* attr,
                  const int* dst, const uint8_t* mask, const int64_t* bounds,
                  const float* dagg, const float* const* params,
                  const float* bc, const uint16_t* tabs, float* dh,
                  void* dhj, void* dattr, void* scratch, float* grads,
                  int n_nodes, int n_edges, int cm, int ca, int c, int fast,
                  int sms, void* stream) {
  const size_t bytes = pfw_smem_bytes<A>(cm, ca, c, 1);
  if (bytes == 0 || bytes > kMaxSmem || sms < 1 || n_nodes < 0 ||
      n_edges < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(dh, 0, sizeof(float) * (size_t)n_nodes * cm * A::NB, st);
  cudaMemsetAsync(grads, 0,
                  sizeof(float) * (size_t)pfw_grad_floats<A>(cm, ca, c), st);
  if (n_edges > 0) {
    const Tabs<A> tb = make_tabs<A>(bc);
    float* s = static_cast<float*>(scratch);
    if (fast)
      pfw_backward<A, true>(
          static_cast<const fw_bf16*>(h), static_cast<const fw_bf16*>(hj),
          static_cast<const fw_bf16*>(attr), dst, mask, bounds, dagg, params,
          tb, tabs, dh, static_cast<fw_bf16*>(dhj),
          static_cast<fw_bf16*>(dattr), s, grads, n_edges, cm, ca, c, sms,
          st);
    else
      pfw_backward<A, false>(
          static_cast<const float*>(h), static_cast<const float*>(hj),
          static_cast<const float*>(attr), dst, mask, bounds, dagg, params,
          tb, tabs, dh, static_cast<float*>(dhj), static_cast<float*>(dattr),
          s, grads, n_edges, cm, ca, c, sms, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One set of C entry points per algebra: csmpn_fused_pair_wide_* (Cl(5,0),
// fused_egcl_pair_wide.cu) and csmpn_fused_pair_wide_cl4_* (Cl(4,0),
// fused_egcl_pair_wide_cl4.cu); as csmpn_fused_wide_*, with the packed
// pair tables in place of the Cayley signs:
//   smem_bytes: the largest shared-memory bytes of a launch of the
//     direction, 0 where the widths are outside C <= PW_MAX_C and
//     Cm + Ca <= PW_MAX_CIN, which the range entry writes (out[0] =
//     PW_MAX_C, out[1] = PW_MAX_CIN); slab_rows: the edge rows of a slab;
//   scratch_bytes: the device scratch of a call of n_edges rows on sms
//     SMs (both images, and a slab's rows: K4pw's messages, K5pw's x, block
//     2's input, d(agg)[dst], both dx, K3pw's cotangent rows and partial
//     slabs);
//   fwd: h (N, cm, NB), hj (E, cm, NB), attr (E, ca, NB) or null, bf16 if
//     fast, else fp32; dst (E,) int32 ascending in [0, N); mask (E,) bytes
//     or null; bounds (N + 1,) int64, bounds[v] the first edge row whose
//     target is >= v; params: host array of the 20 device pointers of the
//     two blocks (flax order, 10 each); bc: the host quadratic-form
//     coefficients; tabs: the packed pair tables on the device (the packed
//     entry's).  out (N, C, NB) fp32: the sum over unmasked edges;
//   bwd: dagg (N, C, NB) fp32, the cotangent of the sum.  Outputs: dh
//     (N, cm, NB) fp32; dhj (E, cm, NB) and dattr (E, ca, NB) in the stream
//     type; grads: two of cemlp_pair_wide's flax-layout gradient vectors,
//     block 1's then block 2's (as many floats as the 20 parameters);
//   tables / packed: as csmpn_cemlp_pair_tables / _packed.
#define CSMPN_FUSED_PAIR_WIDE_ENTRIES(PREFIX, ALG)                            \
  long long PREFIX##_smem_bytes(int cm, int ca, int c, int backward) {        \
    return (long long)pfw_smem_bytes<ALG>(cm, ca, c, backward);               \
  }                                                                           \
  void PREFIX##_range(int* out) {                                             \
    out[0] = PW_MAX_C;                                                        \
    out[1] = PW_MAX_CIN;                                                      \
  }                                                                           \
  long long PREFIX##_slab_rows() { return pfw_slab<ALG>(); }                  \
  long long PREFIX##_scratch_bytes(long long n_edges, int cm, int ca, int c,  \
                                   int backward, int sms) {                   \
    return pfw_scratch_bytes<ALG>(n_edges, cm, ca, c, backward, sms);         \
  }                                                                           \
  int PREFIX##_fwd(const void* h, const void* hj, const void* attr,           \
                   const int* dst, const uint8_t* mask,                       \
                   const int64_t* bounds, const float* const* params,         \
                   const float* bc, const uint16_t* tabs, float* out,         \
                   void* scratch, int n_nodes, int n_edges, int cm, int ca,   \
                   int c, int fast, int sms, void* stream) {                  \
    return pfw_fwd_entry<ALG>(h, hj, attr, dst, mask, bounds, params, bc,     \
                              tabs, out, scratch, n_nodes, n_edges, cm, ca,   \
                              c, fast, sms, stream);                          \
  }                                                                           \
  int PREFIX##_bwd(const void* h, const void* hj, const void* attr,           \
                   const int* dst, const uint8_t* mask,                       \
                   const int64_t* bounds, const float* dagg,                  \
                   const float* const* params, const float* bc,               \
                   const uint16_t* tabs, float* dh, void* dhj, void* dattr,   \
                   void* scratch, float* grads, int n_nodes, int n_edges,     \
                   int cm, int ca, int c, int fast, int sms, void* stream) {  \
    return pfw_bwd_entry<ALG>(h, hj, attr, dst, mask, bounds, dagg, params,   \
                              bc, tabs, dh, dhj, dattr, scratch, grads,       \
                              n_nodes, n_edges, cm, ca, c, fast, sms,         \
                              stream);                                        \
  }                                                                           \
  void PREFIX##_tables(int* i_of_out, int* path_out, int* grade_out,          \
                       float* sign_out) {                                     \
    structural_tables<ALG>(i_of_out, path_out, grade_out, sign_out);          \
  }                                                                           \
  int PREFIX##_packed(uint16_t* out, int cap) {                               \
    if (cap < ALG::TAB_LEN) return -1;                                        \
    return make_packed<ALG>(out);                                             \
  }
