// What the fused message-passing kernels share whatever their block form
// (fused_egcl.cu, K4/K5; fused_egcl_pair.cu, K4p/K5p): the stream type of
// h, hj and attr (bf16 in fast mode, fp32 in exact), its loads and stores,
// and a call's geometry.
#pragma once

#include <cuda_bf16.h>

namespace {

template <bool FAST> struct Stream { using T = float; };
template <> struct Stream<true> { using T = __nv_bfloat16; };

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Geom {
  int n_nodes;   // N
  int cm, ca;    // message (node feature) and edge-attribute channels
  int c;         // hidden = output channels of both blocks
  int wn;        // target nodes per window
  int n_win;     // ceil(N / wn)
};

}  // namespace
