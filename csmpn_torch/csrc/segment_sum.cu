// K1 — sorted segment sum on Hopper (sm_90a).
//
// Replaces: csmpn_tpu/ops/pallas_segment.py, `_kernel` (launched by
// `_forward`, entry `sorted_segment_sum_pallas`).  It computes
//     out[s] = sum_{e : ids[e] == s} data[e]        ids sorted ascending,
// optionally skipping rows whose mask byte is 0 and dividing by the number
// of rows kept (the masked mean of EGCL's "mean" aggregation).
//
// Bound on this card: memory.  Every input row is read once and every
// output row written once; there is one add per input element, so the
// arithmetic intensity is below 0.5 FLOP/byte, far under the H100's
// ridge point.  The least time is (E*D*sizeof(T) + N*D*4) / 3.35 TB/s.
//
// Design: the CSR offsets (offsets[s] = first row with id >= s) come from
// torch.searchsorted outside the kernel, as the TPU version computes its
// block bounds.  One warp owns one segment and one chunk of 128 columns
// (the grid's second dimension), so a wide D puts several warps on a
// segment at once; its lanes run along the chunk, 32 consecutive columns
// per lane group, so each row is read as coalesced 32-element runs and
// summed into fp32 registers.  Each output element is written exactly once
// by the warp that owns it: no atomics, so the result is deterministic.  The TPU's one-hot matrix product and its aligned-down
// chunking are not needed: a warp reads exactly its own rows.  Empty
// segments give 0.  Ids >= N (sentinels) lie past offsets[N] and are never
// read.  bf16 input is widened to fp32 before the add; in fast mode fp32
// input is rounded to bf16 first, as the TPU kernel feeds its matrix unit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;      // segments per CTA
constexpr int kUnroll = 4;     // 32-column groups per lane and pass
constexpr int kRows = 4;       // rows loaded together per step

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T, bool ROUND>
__global__ void __launch_bounds__(32 * kWarps)
segment_sum_kernel(const T* __restrict__ data,
                   const int64_t* __restrict__ offsets,
                   const uint8_t* __restrict__ mask,
                   float* __restrict__ out, float* __restrict__ counts,
                   int n_segments, int d, int mean) {
  const int lane = threadIdx.x;
  const int s = blockIdx.x * kWarps + threadIdx.y;
  if (s >= n_segments) return;
  const int64_t beg = offsets[s];
  const int64_t end = offsets[s + 1];

  // rows kept in this segment (mask applied), reduced across the warp
  float kept = 0.f;
  for (int64_t e = beg + lane; e < end; e += 32)
    kept += (mask == nullptr || mask[e]) ? 1.f : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    kept += __shfl_xor_sync(0xffffffffu, kept, off);
  const float scale = mean ? 1.f / fmaxf(kept, 1.f) : 1.f;
  if (counts != nullptr && lane == 0 && blockIdx.y == 0) counts[s] = kept;

  {
    const int d0 = blockIdx.y * 32 * kUnroll;
    float acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[u] = 0.f;
    // kRows rows in flight per step: their loads are issued together,
    // then added in row order (the sum order stays sequential)
    int64_t e = beg;
    for (; e < end; e += kRows) {
      float v[kRows][kUnroll];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bool keep =
            e + r < end && (mask == nullptr || mask[e + r] != 0);
        const T* row = data + (e + r) * (int64_t)d;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int c = d0 + u * 32 + lane;
          v[r][u] = (keep && c < d) ? load_f32(row + c) : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float x = v[r][u];
          if (ROUND) x = __bfloat162float(__float2bfloat16_rn(x));
          acc[u] += x;
        }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = d0 + u * 32 + lane;
      if (c < d) out[(int64_t)s * d + c] = acc[u] * scale;
    }
  }
}

template <typename T, bool ROUND>
cudaError_t launch(const void* data, const int64_t* offsets,
                   const uint8_t* mask, float* out, float* counts,
                   int n_segments, int d, int mean, cudaStream_t stream) {
  if (n_segments > 0) {
    dim3 block(32, kWarps);
    const int chunks = (d + 32 * kUnroll - 1) / (32 * kUnroll);
    dim3 grid((n_segments + kWarps - 1) / kWarps, chunks > 0 ? chunks : 1);
    segment_sum_kernel<T, ROUND><<<grid, block, 0, stream>>>(
        static_cast<const T*>(data), offsets, mask, out, counts, n_segments,
        d, mean);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  round_bf16 applies to float32 input.
// mask and counts may be null.  Returns cudaGetLastError().
extern "C" int csmpn_segment_sum(const void* data, int dtype, int round_bf16,
                                 const int64_t* offsets, const uint8_t* mask,
                                 float* out, float* counts, int n_segments,
                                 int d, int mean, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(data, offsets, mask, out, counts,
                                        n_segments, d, mean, st);
  if (round_bf16)
    return launch<float, true>(data, offsets, mask, out, counts, n_segments,
                               d, mean, st);
  return launch<float, false>(data, offsets, mask, out, counts, n_segments, d,
                              mean, st);
}
