// What the fused message-passing kernels share whatever their block form
// (fused_egcl.cu, K4/K5; fused_egcl_pair.cu, K4p/K5p): a call's geometry,
// and a store of the exact K5's outputs.
#pragma once

#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ void stf(float* p, float v) { *p = v; }

struct Geom {
  int n_nodes;   // N
  int cm, ca;    // message (node feature) and edge-attribute channels
  int c;         // hidden = output channels of both blocks
  int wn;        // target nodes per window
  int n_win;     // ceil(N / wn)
};

}  // namespace
