// What the wide fused message-passing kernels share whatever their block
// form (fused_egcl_wide.cuh, K4w/K5w, dense; fused_egcl_pair_wide.cuh,
// K4pw/K5pw, pair form): the edge rows taken in slabs, and the kernels of a
// slab that see the algebra only through its blade count A::NB:
//   * the window sums of the forward (`fused_wide_sum_kernel`): a warp a
//     target, a lane a column of its (C, NB) row, the target's message rows
//     of the slab added in edge order onto its sum so far;
//   * the backward's gather (`fused_wide_gather_kernel`): a slab's block-1
//     input rows x = [h[dst] - hj, attr] and the gathered cotangent
//     d(agg)[dst] (masked, rounded in fast mode);
//   * the backward's d(h) sums (`fused_wide_dh_kernel`): dhj = -dx[:, :Cm]
//     and dattr = dx[:, Cm:] row by row (dx rounded in fast mode), and
//     dx[:, :Cm] added onto each target's d(h), a warp a target, in edge
//     order.
// One owner a value and every sum in edge order, so a target's sum runs
// over its edges in the same order whatever the slab boundaries, and two
// launches give the same bits.  This header includes neither block
// header (their helpers share names), so it keeps its own rounding.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

using fw_bf16 = __nv_bfloat16;

template <bool FAST>
__device__ __forceinline__ float slab_rnd(float x) {
  if (FAST) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// The scratch's message rows: bf16 in fast mode, fp32 in exact.
template <bool FAST>
using MsgT = typename std::conditional<FAST, fw_bf16, float>::type;

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const fw_bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(fw_bf16 v) {
  return __bfloat162float(v);
}

template <class T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ fw_bf16 from_f<fw_bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// x = [h[dst] - hj, attr] of 4 blades from column q4 (a multiple of 4) of
// edge row `row`'s (Cm + Ca) x NB input.
template <class A, class T>
__device__ __forceinline__ float4 gather4(const T* __restrict__ h,
                                          const T* __restrict__ hj,
                                          const T* __restrict__ attr,
                                          const int* __restrict__ dst,
                                          int64_t row, int q4, int cm,
                                          int ca) {
  constexpr int NB = A::NB;
  const int m = q4 / NB, i = q4 % NB;
  if (m < cm) {
    const float4 a = load4(h + ((int64_t)dst[row] * cm + m) * NB + i);
    const float4 b = load4(hj + (row * cm + m) * NB + i);
    return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
  }
  return load4(attr + (row * ca + (m - cm)) * NB + i);
}

template <bool FAST>
__device__ __forceinline__ float4 slab_rnd4(float4 v) {
  return make_float4(slab_rnd<FAST>(v.x), slab_rnd<FAST>(v.y),
                     slab_rnd<FAST>(v.z), slab_rnd<FAST>(v.w));
}

// The targets of the slab [r0, r1) (dst sorted: dst[r0] .. dst[r1 - 1])
// are taken a warp each, grid stride; target v's edge rows in the slab
// are [lo, hi) (bounds[v]: its first edge row).
__device__ __forceinline__ int64_t first_target(const int* __restrict__ dst,
                                                int64_t r0) {
  return dst[r0] + (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
}

__device__ __forceinline__ int64_t target_stride() {
  return ((int64_t)gridDim.x * blockDim.x) >> 5;
}

__device__ __forceinline__ void slab_edges(const int64_t* __restrict__ bounds,
                                           int64_t v, int64_t r0, int64_t r1,
                                           int64_t& lo, int64_t& hi) {
  lo = bounds[v] > r0 ? bounds[v] : r0;
  hi = bounds[v + 1] < r1 ? bounds[v + 1] : r1;
}

// The forward's window sums: out[v] += the message rows of target v in
// the slab [r0, r1), in edge order (w = C * NB floats a row).
template <class M>
__global__ void __launch_bounds__(256)
fused_wide_sum_kernel(const M* __restrict__ msg,
                      const int* __restrict__ dst,
                      const int64_t* __restrict__ bounds,
                      float* __restrict__ out, int64_t r0, int64_t r1,
                      int w) {
  const int lane = threadIdx.x & 31;
  const int64_t v_end = (int64_t)dst[r1 - 1] + 1;
  for (int64_t v = first_target(dst, r0); v < v_end; v += target_stride()) {
    int64_t lo, hi;
    slab_edges(bounds, v, r0, r1, lo, hi);
    for (int e = lane; e < w; e += 32) {
      float acc = out[v * w + e];
      for (int64_t r = lo; r < hi; ++r) acc += to_f(msg[(r - r0) * w + e]);
      out[v * w + e] = acc;
    }
  }
}

// The backward's slab of block-1 input rows x (fp32, unrounded: the block
// kernels round on load) and block 2's output cotangent, d(agg)[dst]
// masked (rounded in fast mode), a thread 4 floats.
template <class A, bool FAST, class T>
__global__ void __launch_bounds__(256)
fused_wide_gather_kernel(const T* __restrict__ h, const T* __restrict__ hj,
                         const T* __restrict__ attr,
                         const int* __restrict__ dst,
                         const uint8_t* __restrict__ mask,
                         const float* __restrict__ dagg,
                         float* __restrict__ x, float* __restrict__ g,
                         int64_t r0, int rows, int cm, int ca, int c) {
  constexpr int NB = A::NB;
  const int wx = (cm + ca) * NB / 4, wg = c * NB / 4;
  const int64_t n = (int64_t)rows * (wx + wg);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int64_t lr = e / (wx + wg), row = r0 + lr;
    const int q = (int)(e % (wx + wg));
    if (q < wx) {
      reinterpret_cast<float4*>(x)[lr * wx + q] =
          gather4<A, T>(h, hj, attr, dst, row, 4 * q, cm, ca);
    } else {
      const int q2 = q - wx;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (mask == nullptr || mask[row])
        v = slab_rnd4<FAST>(__ldg(reinterpret_cast<const float4*>(dagg) +
                                  (int64_t)dst[row] * wg + q2));
      reinterpret_cast<float4*>(g)[lr * wg + q2] = v;
    }
  }
}

// From block 1's dx rows of the slab [r0, r1) ((Cm + Ca) x NB each,
// rounded in fast mode): dhj = -dx[:, :Cm] and dattr = dx[:, Cm:] of every
// row, and dh[v] += the rows' dx[:, :Cm] of target v in edge order.
template <bool FAST, class T>
__global__ void __launch_bounds__(256)
fused_wide_dh_kernel(const float* __restrict__ dx,
                     const int* __restrict__ dst,
                     const int64_t* __restrict__ bounds,
                     float* __restrict__ dh, T* __restrict__ dhj,
                     T* __restrict__ dattr, int64_t r0, int64_t r1, int wm,
                     int wa) {
  const int w = wm + wa, lane = threadIdx.x & 31;
  const int64_t v_end = (int64_t)dst[r1 - 1] + 1;
  for (int64_t v = first_target(dst, r0); v < v_end; v += target_stride()) {
    int64_t lo, hi;
    slab_edges(bounds, v, r0, r1, lo, hi);
    for (int e = lane; e < wm; e += 32) {
      float acc = dh[v * wm + e];
      for (int64_t r = lo; r < hi; ++r) {
        const float d = slab_rnd<FAST>(dx[(r - r0) * w + e]);
        acc += d;
        dhj[r * wm + e] = from_f<T>(-d);
      }
      dh[v * wm + e] = acc;
    }
    for (int e = lane; e < wa; e += 32)
      for (int64_t r = lo; r < hi; ++r)
        dattr[r * wa + e] =
            from_f<T>(slab_rnd<FAST>(dx[(r - r0) * w + wm + e]));
  }
}

// ------------------------------------------------------------------ host

// CTAs of a row launch of nrow rows a step: every SM holds as many as its
// shared memory allows (at most 8), each walks over steps.
inline int fw_grid(int64_t rows, int nrow, int sms, size_t bytes) {
  int per_sm = (int)((228 * 1024) / (bytes > 0 ? bytes : 1));
  per_sm = per_sm < 1 ? 1 : per_sm > 8 ? 8 : per_sm;
  const int64_t tiles = (rows + nrow - 1) / nrow;
  const int64_t g = (int64_t)sms * per_sm < tiles ? (int64_t)sms * per_sm
                                                   : tiles;
  return g < 1 ? 1 : (int)g;
}

// Floats rounded up to 256 bytes: the parts of a call's scratch.
inline int64_t fw_al(int64_t floats) { return (floats + 63) / 64 * 64; }

// The targets' sums of a slab: a warp a target, at most 8 CTAs an SM.
inline int fw_sum_blocks(int64_t rows, int sms) {
  const int64_t most = (int64_t)sms * 8;
  const int64_t want = (rows + 7) / 8;
  return (int)(want < most ? (want < 1 ? 1 : want) : most);
}

}  // namespace
