// K4w and K5w — the EGCL edge side, forward and backward, dense form, on
// Hopper (sm_90a), at the widths K4/K5's plans (fused_egcl.cu) refuse:
// every C <= 128 channels and Cm + Ca <= 320 message + attribute channels
// (K2w/K3w's range), at Cl(3,0) and Cl(2,0), in both modes:
//     agg[v] = sum over unmasked edges e with dst[e] == v of
//              CEMLP_2(CEMLP_1([h[dst[e]] - hj[e], attr[e]]))
// with dst sorted ascending and hj the pre-gathered source rows.  This
// header holds the device code and its host launchers, templated on the
// algebra; fused_egcl_wide.cu (Cl(3,0)) and fused_egcl_wide_cl2.cu
// (Cl(2,0)) each instantiate one algebra's C entry points, so that the two
// build in parallel.
//
// Replaces: csmpn_tpu/ops/fused_egcl.py, `_make_fwd_kernel` (K4, launched
// by `_mp_forward`) and `_make_bwd_kernel` (K5, launched by
// `_mp_backward`), dense form, at the widths the TPU kernel tiles by VMEM
// and fused_egcl.cu's shared memory does not hold; the wrapper
// (ops/fused_egcl.fused_route) sends a call here only where K4/K5's size
// entries refuse its widths in either direction.
//
// Bound on this card: at the bench shape at hidden 64 (E = 131,072 edge
// rows, 64 -> 64 -> 64 channels, 8 blades) a row's two blocks cost ~2 *
// 2*8*64*(64 + 2*64) FLOPs of channel mixing against ~2 KB of bf16 rows,
// ~190 FLOP a byte: ten times the fp32 FFMA ridge (67 TFLOP/s over 3.35
// TB/s = 20 FLOP/byte), so these FFMA kernels are bound by operations.
// The backward does about three times the forward's work.
//
// Design (simple first: FFMA products, K2w/K3w's device code):
//   * both blocks' parameters are laid out once a call as K2w/K3w's images
//     (`cemlp_wide_pack_kernel`), the weight panels streamed through
//     shared memory as there;
//   * the edge rows are taken in slabs of FW_SLAB rows, so that the
//     scratch does not grow with the call (a streaming chunk holds ~1.25M
//     edge slots; K3w's cotangent rows alone are 16 KB an edge row at
//     C = 128).  A slab's window sums continue the sums of the slab before
//     it, so each target's sum runs over its edges in edge order whatever
//     the slab boundaries, with no host read of the targets;
//   * K4w (`fused_wide_fwd_kernel`), a sweep over a slab's rows: a CTA step
//     takes ROWS = 8 rows, a warp a row (K2w's layout: a lane the channels
//     lane, lane + 32, ...).  The step gathers x = [h[dst] - hj, attr] a
//     panel of input channels at a time (GatherRows), runs block 1's
//     forward, writes its output row (rounded where block 2 rounds its
//     input) into the warp's first-tile, runs block 2's forward from it,
//     and writes the masked message row to the slab's scratch (bf16 in
//     fast mode, fp32 in exact);
//   * the window sums (`fused_wide_sum_kernel`, fused_slabs.cuh, shared
//     with K4pw/K5pw): a warp a target, a lane a column of its (C, NB)
//     row, the target's message rows of the slab added in edge order onto
//     the target's sum so far (the output is zeroed first).  One owner a
//     value: no atomics, and two launches give the same bits;
//   * K5w, per slab (the gather and d(h) kernels in fused_slabs.cuh):
//     `fused_wide_gather_kernel` writes x (fp32) and the gathered
//     cotangent d(agg)[dst] (masked, rounded in fast mode); K2w's forward
//     recomputes block 1's output from x; K3w's row kernel, its
//     weight-gradient kernel and its reduce kernel run block 2's
//     backward, then block 1's (the reduce adds each slab's gradients
//     onto the slabs' before it, in slab order); `fused_wide_dh_kernel`
//     writes dhj = -dx[:, :Cm] and dattr = dx[:, Cm:] row by row and adds
//     dx[:, :Cm] onto each target's d(h), a warp a target, in edge order.
//     The 20 parameter gradients come out as two of K3w's flax-layout
//     vectors, block 1's then block 2's.
//
// Precision: exact mode is fp32 throughout.  Fast mode streams h, hj and
// attr as bf16 and rounds where the plain fast version
// (`message_aggregate_plain`, ops/fused_egcl.py) rounds: x and block 2's
// input on load, as K2w/K3w do, the message before the sum and d(agg)
// before the backward; dx is rounded before it enters d(h), dhj and dattr,
// where the plain version's casts round it.  Sums are fp32.

#pragma once

#include "cemlp_wide.cuh"
#include "fused_mp.cuh"
#include "fused_slabs.cuh"

namespace {

constexpr int FW_SLAB = 65536;   // edge rows a slab

// K4w's block-1 input: the step's edge rows gathered, a chunk of kn input
// channels at a time into xs [r][k][i] (rounded in fast mode), rows past
// `end` zero.
template <class A, bool FAST, class T>
struct GatherRows {
  const T* __restrict__ h;
  const T* __restrict__ hj;
  const T* __restrict__ attr;
  const int* __restrict__ dst;
  int64_t row0, end;
  int cm, ca;
  __device__ __forceinline__ void load(float* xs, int k0, int kn) const {
    constexpr int NB = A::NB;
    const int tid = threadIdx.x + 32 * threadIdx.y;
    const int per4 = kn * NB / 4;
    for (int e = tid; e < ROWS * per4; e += THREADS) {
      const int r = e / per4, q = e % per4;
      const int64_t row = row0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < end)
        v = gather4<A, T>(h, hj, attr, dst, row, k0 * NB + 4 * q, cm, ca);
      v.x = rnd<FAST>(v.x);
      v.y = rnd<FAST>(v.y);
      v.z = rnd<FAST>(v.z);
      v.w = rnd<FAST>(v.w);
      reinterpret_cast<float4*>(xs + r * KC * NB)[q] = v;
    }
  }
  __device__ __forceinline__ const float* at(const float* xs, int warp,
                                             int) const {
    return xs + warp * KC * A::NB;
  }
};

// ------------------------------------------------------------------ K4w

// A CTA walks over steps of ROWS edge rows of the slab [r0, r0 + rows):
// block 1's forward from the gathered rows; its output aln / mean * o,
// rounded, into the warp's first-tile (block 1's first and z are spent by
// then); block 2's forward from that tile; the masked message row
// aln / mean * o (rounded) to msg, the slab's row r - r0.
template <class A, bool FAST, class T>
__global__ void __launch_bounds__(THREADS, 2)
fused_wide_fwd_kernel(const T* __restrict__ h, const T* __restrict__ hj,
                      const T* __restrict__ attr,
                      const int* __restrict__ dst,
                      const uint8_t* __restrict__ mask,
                      const float* __restrict__ img1,
                      const float* __restrict__ img2, Tabs<A> tb,
                      MsgT<FAST>* __restrict__ msg, int64_t r0, int rows,
                      int cm, int ca, WLayout L1, WLayout L2) {
  constexpr int NB = A::NB;
  extern __shared__ __align__(16) float smem[];
  const WSmem sm = carve_wide<A>(smem, L2.cp, false);
  const int warp = threadIdx.y, lane = threadIdx.x, c = L2.c;
  float* fr = sm.fs + (int64_t)warp * L2.cp * NB;
  const int n_tiles = (rows + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t lrow0 = (int64_t)tile * ROWS, lrow = lrow0 + warp;
    float acc[WS][NB];
    wide_front<A, FAST, false>(
        acc,
        GatherRows<A, FAST, T>{h, hj, attr, dst, r0 + lrow0, r0 + rows, cm,
                               ca},
        img1, L1, tb, sm, warp, lane);
    float mean = wide_out<A, FAST>(acc, img1, L1, tb, sm, warp, lane);
#pragma unroll
    for (int u = 0; u < WS; ++u) {
      const int n = lane + 32 * u;
      if (u >= L1.s || n >= c) continue;
      const float scale = __ldg(img1 + L1.aln + n) / mean;
#pragma unroll
      for (int i = 0; i < NB; ++i)
        fr[n * NB + i] = rnd<FAST>(scale * acc[u][i]);
    }
    wide_front<A, FAST, false>(acc, TileRows<A>{fr}, img2, L2, tb, sm, warp,
                               lane);
    mean = wide_out<A, FAST>(acc, img2, L2, tb, sm, warp, lane);
    if (lrow >= rows) continue;
    const bool keep = mask == nullptr || mask[r0 + lrow];
#pragma unroll
    for (int u = 0; u < WS; ++u) {
      const int n = lane + 32 * u;
      if (u >= L2.s || n >= c) continue;
      const float scale = __ldg(img2 + L2.aln + n) / mean;
      MsgT<FAST>* d = msg + (lrow * c + n) * NB;
#pragma unroll
      for (int i = 0; i < NB; ++i)
        d[i] = from_f<MsgT<FAST>>(keep ? rnd<FAST>(scale * acc[u][i]) : 0.f);
    }
  }
}

// ------------------------------------------------------------------ host

Params fw_params(const float* const* pp) {
  return Params{pp[0], pp[1], pp[2], pp[3], pp[4],
                pp[5], pp[6], pp[7], pp[8], pp[9]};
}

template <class A>
bool fw_ok(int cm, int ca, int c) {
  return cm >= 1 && ca >= 0 && wide_ok<A>(cm + ca, c);
}

// Shared-memory bytes of a launch of the direction: K4w's sweep (K2w's
// forward layout), or the largest of K5w's K2w forward and K3w backward.
template <class A>
size_t fw_smem_bytes(int cm, int ca, int c, int backward) {
  if (!fw_ok<A>(cm, ca, c)) return 0;
  return wide_smem_bytes<A>(cm + ca, c, backward);
}

// The scratch of a call (floats from its base, each part 256-byte aligned).
struct FwScratch {
  int64_t img1, img2;          // the two blocks' parameter images
  int64_t msg;                 // K4w: a slab's message rows
  int64_t x, x2, g, dx2, dx1;  // K5w: a slab's rows of x, block 2's input,
                               // d(agg)[dst], block 2's dx, block 1's dx
  int64_t cot, lpart, wpart;   // K3w's cotangent rows and partial slabs
  int64_t total;
};

template <class A>
FwScratch fw_scratch(int64_t n_edges, int cm, int ca, int c, int backward,
                     int sms) {
  constexpr int NB = A::NB;
  const int cin = cm + ca;
  const int64_t s = n_edges < FW_SLAB ? n_edges : FW_SLAB;
  const bool bwd = backward != 0;
  FwScratch f{};
  int64_t o = 0;
  f.img1 = o; o += fw_al(wlayout<A>(cin, c, bwd).total);
  f.img2 = o; o += fw_al(wlayout<A>(c, c, bwd).total);
  if (!bwd) {
    f.msg = o; o += fw_al(s * c * NB);   // fp32 room, bf16 in fast mode
  } else {
    const int grid = fw_grid(s, ROWS, sms, wide_smem_bytes<A>(cin, c, 1));
    const int splits1 = wide_wgrad_splits<A>((int)s, cin, c, sms);
    const int splits2 = wide_wgrad_splits<A>((int)s, c, c, sms);
    const int64_t wp1 = (int64_t)splits1 * wide_wpart_floats<A>(cin, c);
    const int64_t wp2 = (int64_t)splits2 * wide_wpart_floats<A>(c, c);
    f.x = o; o += fw_al(s * cin * NB);
    f.x2 = o; o += fw_al(s * c * NB);
    f.g = o; o += fw_al(s * c * NB);
    f.dx2 = o; o += fw_al(s * c * NB);
    f.dx1 = o; o += fw_al(s * cin * NB);
    f.cot = o; o += fw_al(4 * s * c * NB);
    f.lpart = o; o += fw_al((int64_t)grid * ROWS * Loc<A>::N * c);
    f.wpart = o; o += fw_al(wp1 > wp2 ? wp1 : wp2);
  }
  f.total = o;
  return f;
}

template <class A>
long long fw_scratch_bytes(long long n_edges, int cm, int ca, int c,
                           int backward, int sms) {
  if (!fw_ok<A>(cm, ca, c) || n_edges < 0 || sms < 1) return 0;
  return (long long)sizeof(float) *
         fw_scratch<A>(n_edges, cm, ca, c, backward, sms).total;
}

template <class A>
long long fw_grad_floats(int cm, int ca, int c) {
  if (!fw_ok<A>(cm, ca, c)) return 0;
  return wide_grad_floats<A>(cm + ca, c) + wide_grad_floats<A>(c, c);
}

template <class A, bool FAST, class T>
void fw_forward(const T* h, const T* hj, const T* attr, const int* dst,
                const uint8_t* mask, const int64_t* bounds,
                const float* const* pp, const Tabs<A>& tb, float* out,
                float* scratch, int n_edges, int cm, int ca, int c, int sms,
                cudaStream_t st) {
  const int cin = cm + ca;
  const FwScratch f = fw_scratch<A>(n_edges, cm, ca, c, 0, sms);
  const WLayout L1 = wlayout<A>(cin, c, false), L2 = wlayout<A>(c, c, false);
  float* img1 = scratch + f.img1;
  float* img2 = scratch + f.img2;
  launch_pack<A, FAST>(fw_params(pp), L1, img1, st);
  launch_pack<A, FAST>(fw_params(pp + 10), L2, img2, st);
  MsgT<FAST>* msg = reinterpret_cast<MsgT<FAST>*>(scratch + f.msg);
  const size_t bytes = wide_smem_bytes<A>(cin, c, 0);
  cudaFuncSetAttribute(fused_wide_fwd_kernel<A, FAST, T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  for (int64_t r0 = 0; r0 < n_edges; r0 += FW_SLAB) {
    const int rows = (int)(n_edges - r0 < FW_SLAB ? n_edges - r0 : FW_SLAB);
    fused_wide_fwd_kernel<A, FAST, T>
        <<<fw_grid(rows, ROWS, sms, bytes), dim3(32, ROWS), bytes, st>>>(
            h, hj, attr, dst, mask, img1, img2, tb, msg, r0, rows, cm, ca,
            L1, L2);
    fused_wide_sum_kernel<MsgT<FAST>><<<fw_sum_blocks(rows, sms), 256, 0,
                                        st>>>(msg, dst, bounds, out, r0,
                                              r0 + rows, c * A::NB);
  }
}

template <class A, bool FAST, class T>
void fw_backward(const T* h, const T* hj, const T* attr, const int* dst,
                 const uint8_t* mask, const int64_t* bounds,
                 const float* dagg, const float* const* pp,
                 const Tabs<A>& tb, float* dh, T* dhj, T* dattr,
                 float* scratch, float* grads, int n_edges, int cm, int ca,
                 int c, int sms, cudaStream_t st) {
  constexpr int NB = A::NB;
  const int cin = cm + ca;
  const FwScratch f = fw_scratch<A>(n_edges, cm, ca, c, 1, sms);
  const WLayout L1 = wlayout<A>(cin, c, true), L2 = wlayout<A>(c, c, true);
  float* img1 = scratch + f.img1;
  float* img2 = scratch + f.img2;
  launch_pack<A, FAST>(fw_params(pp), L1, img1, st);
  launch_pack<A, FAST>(fw_params(pp + 10), L2, img2, st);
  float *x = scratch + f.x, *x2 = scratch + f.x2, *g = scratch + f.g;
  float *dx2 = scratch + f.dx2, *dx1 = scratch + f.dx1;
  float *cot = scratch + f.cot, *lpart = scratch + f.lpart;
  float* wpart = scratch + f.wpart;
  float* grads1 = grads;
  float* grads2 = grads + wide_grad_floats<A>(cin, c);
  const size_t fbytes = wide_smem_bytes<A>(cin, c, 0);
  const size_t bbytes1 = wide_smem_bytes<A>(cin, c, 1);
  const size_t bbytes2 = wide_smem_bytes<A>(c, c, 1);
  cudaFuncSetAttribute(cemlp_wide_fwd_kernel<A, FAST>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)fbytes);
  cudaFuncSetAttribute(cemlp_wide_bwd_kernel<A, FAST>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)(bbytes1 > bbytes2 ? bbytes1 : bbytes2));
  // one block's backward over the slab's rows: K3w's row kernel, its
  // weight gradients, their reduction added onto the slabs' before
  auto block_bwd = [&](const float* xin, const float* dout, float* dxo,
                       const float* img, const WLayout& L, size_t bytes,
                       float* gv, int rows, int accum) {
    const int grid = fw_grid(rows, ROWS, sms, bytes);
    const int splits = wide_wgrad_splits<A>(rows, L.cin, c, sms);
    cemlp_wide_bwd_kernel<A, FAST><<<grid, dim3(32, ROWS), bytes, st>>>(
        xin, dout, img, tb, dxo, cot, lpart, rows, L);
    const int chunk = (rows + splits - 1) / splits;
    cemlp_wide_wgrad_kernel<A, FAST>
        <<<dim3(wide_wgrad_jobs<A>(L.cin, c), splits), 256, 0, st>>>(
            xin, cot, wpart, rows, L.cin, c, chunk < 1 ? 1 : chunk);
    const int64_t n = wide_grad_floats<A>(L.cin, c);
    cemlp_wide_reduce_kernel<A><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        wpart, splits, lpart, grid * ROWS, gv, L.cin, c, accum);
  };
  const int gblocks = 8 * sms;
  for (int64_t r0 = 0; r0 < n_edges; r0 += FW_SLAB) {
    const int rows = (int)(n_edges - r0 < FW_SLAB ? n_edges - r0 : FW_SLAB);
    const int accum = r0 > 0;
    fused_wide_gather_kernel<A, FAST, T><<<gblocks, 256, 0, st>>>(
        h, hj, attr, dst, mask, dagg, x, g, r0, rows, cm, ca, c);
    cemlp_wide_fwd_kernel<A, FAST>
        <<<fw_grid(rows, ROWS, sms, fbytes), dim3(32, ROWS), fbytes, st>>>(
            x, img1, tb, x2, rows, L1);
    block_bwd(x2, g, dx2, img2, L2, bbytes2, grads2, rows, accum);
    block_bwd(x, dx2, dx1, img1, L1, bbytes1, grads1, rows, accum);
    fused_wide_dh_kernel<FAST, T><<<fw_sum_blocks(rows, sms), 256, 0, st>>>(
        dx1, dst, bounds, dh, dhj, dattr, r0, r0 + rows, cm * NB, ca * NB);
  }
}

template <class A>
int fw_fwd_entry(const void* h, const void* hj, const void* attr,
                 const int* dst, const uint8_t* mask, const int64_t* bounds,
                 const float* const* params, const float* bc,
                 const float* sign, float* out, void* scratch, int n_nodes,
                 int n_edges, int cm, int ca, int c, int fast, int sms,
                 void* stream) {
  const size_t bytes = fw_smem_bytes<A>(cm, ca, c, 0);
  if (bytes == 0 || bytes > kMaxSmem || sms < 1 || n_nodes < 0 ||
      n_edges < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(out, 0, sizeof(float) * (size_t)n_nodes * c * A::NB, st);
  if (n_edges > 0) {
    const Tabs<A> tb = make_tabs<A>(bc, sign);
    float* s = static_cast<float*>(scratch);
    if (fast)
      fw_forward<A, true>(static_cast<const fw_bf16*>(h),
                          static_cast<const fw_bf16*>(hj),
                          static_cast<const fw_bf16*>(attr), dst, mask,
                          bounds, params, tb, out, s, n_edges, cm, ca, c,
                          sms, st);
    else
      fw_forward<A, false>(static_cast<const float*>(h),
                           static_cast<const float*>(hj),
                           static_cast<const float*>(attr), dst, mask,
                           bounds, params, tb, out, s, n_edges, cm, ca, c,
                           sms, st);
  }
  return (int)cudaGetLastError();
}

template <class A>
int fw_bwd_entry(const void* h, const void* hj, const void* attr,
                 const int* dst, const uint8_t* mask, const int64_t* bounds,
                 const float* dagg, const float* const* params,
                 const float* bc, const float* sign, float* dh, void* dhj,
                 void* dattr, void* scratch, float* grads, int n_nodes,
                 int n_edges, int cm, int ca, int c, int fast, int sms,
                 void* stream) {
  const size_t bytes = fw_smem_bytes<A>(cm, ca, c, 1);
  if (bytes == 0 || bytes > kMaxSmem || sms < 1 || n_nodes < 0 ||
      n_edges < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(dh, 0, sizeof(float) * (size_t)n_nodes * cm * A::NB, st);
  cudaMemsetAsync(grads, 0,
                  sizeof(float) * (size_t)fw_grad_floats<A>(cm, ca, c), st);
  if (n_edges > 0) {
    const Tabs<A> tb = make_tabs<A>(bc, sign);
    float* s = static_cast<float*>(scratch);
    if (fast)
      fw_backward<A, true>(
          static_cast<const fw_bf16*>(h), static_cast<const fw_bf16*>(hj),
          static_cast<const fw_bf16*>(attr), dst, mask, bounds, dagg, params,
          tb, dh, static_cast<fw_bf16*>(dhj), static_cast<fw_bf16*>(dattr), s,
          grads, n_edges, cm, ca, c, sms, st);
    else
      fw_backward<A, false>(
          static_cast<const float*>(h), static_cast<const float*>(hj),
          static_cast<const float*>(attr), dst, mask, bounds, dagg, params,
          tb, dh, static_cast<float*>(dhj), static_cast<float*>(dattr), s,
          grads, n_edges, cm, ca, c, sms, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One set of C entry points per algebra: csmpn_fused_wide_* (Cl(3,0),
// fused_egcl_wide.cu) and csmpn_fused_wide_cl2_* (Cl(2,0),
// fused_egcl_wide_cl2.cu).
//   smem_bytes: the largest shared-memory bytes of a launch of the
//     direction, 0 where the widths are outside C <= WMAX_C and
//     Cm + Ca <= WMAX_CIN, which the range entry writes (out[0] = WMAX_C,
//     out[1] = WMAX_CIN); slab_rows: the edge rows of a slab;
//   scratch_bytes: the device scratch of a call of n_edges rows on sms
//     SMs (both images, and a slab's rows: K4w's messages, K5w's x, block
//     2's input, d(agg)[dst], both dx, K3w's cotangent rows and partial
//     slabs);
//   fwd: h (N, cm, NB), hj (E, cm, NB), attr (E, ca, NB) or null, bf16 if
//     fast, else fp32; dst (E,) int32 ascending in [0, N); mask (E,) bytes
//     or null; bounds (N + 1,) int64, bounds[v] the first edge row whose
//     target is >= v; params: host array of the 20 device pointers of the
//     two blocks (flax order, 10 each); bc and sign: host tables of the
//     algebra.  out (N, C, NB) fp32: the sum over unmasked edges;
//   bwd: dagg (N, C, NB) fp32, the cotangent of the sum.  Outputs: dh
//     (N, cm, NB) fp32; dhj (E, cm, NB) and dattr (E, ca, NB) in the stream
//     type; grads: two of cemlp_wide's flax-layout gradient vectors, block
//     1's then block 2's (as many floats as the 20 parameters);
//   tables: the structural tables the kernels assume (see
//     csmpn_cemlp_tables).
#define CSMPN_FUSED_WIDE_ENTRIES(PREFIX, ALG)                                 \
  long long PREFIX##_smem_bytes(int cm, int ca, int c, int backward) {        \
    return (long long)fw_smem_bytes<ALG>(cm, ca, c, backward);                \
  }                                                                           \
  void PREFIX##_range(int* out) {                                             \
    out[0] = WMAX_C;                                                          \
    out[1] = WMAX_CIN;                                                        \
  }                                                                           \
  long long PREFIX##_slab_rows() { return FW_SLAB; }                          \
  long long PREFIX##_scratch_bytes(long long n_edges, int cm, int ca, int c,  \
                                   int backward, int sms) {                   \
    return fw_scratch_bytes<ALG>(n_edges, cm, ca, c, backward, sms);          \
  }                                                                           \
  int PREFIX##_fwd(const void* h, const void* hj, const void* attr,           \
                   const int* dst, const uint8_t* mask,                       \
                   const int64_t* bounds, const float* const* params,         \
                   const float* bc, const float* sign, float* out,            \
                   void* scratch, int n_nodes, int n_edges, int cm, int ca,   \
                   int c, int fast, int sms, void* stream) {                  \
    return fw_fwd_entry<ALG>(h, hj, attr, dst, mask, bounds, params, bc,      \
                             sign, out, scratch, n_nodes, n_edges, cm, ca, c, \
                             fast, sms, stream);                              \
  }                                                                           \
  int PREFIX##_bwd(const void* h, const void* hj, const void* attr,           \
                   const int* dst, const uint8_t* mask,                       \
                   const int64_t* bounds, const float* dagg,                  \
                   const float* const* params, const float* bc,               \
                   const float* sign, float* dh, void* dhj, void* dattr,      \
                   void* scratch, float* grads, int n_nodes, int n_edges,     \
                   int cm, int ca, int c, int fast, int sms, void* stream) {  \
    return fw_bwd_entry<ALG>(h, hj, attr, dst, mask, bounds, dagg, params,    \
                             bc, sign, dh, dhj, dattr, scratch, grads,        \
                             n_nodes, n_edges, cm, ca, c, fast, sms, stream); \
  }                                                                           \
  void PREFIX##_tables(int* i_of_out, int* path_out, int* grade_out) {        \
    structural_tables<ALG>(i_of_out, path_out, grade_out);                    \
  }
