// K1 — sorted segment sum on Hopper (sm_90a).
//
// Replaces: csmpn_tpu/ops/pallas_segment.py, `_kernel` (launched by
// `_forward`, entry `sorted_segment_sum_pallas`).  It computes
//     out[s] = sum_{e : ids[e] == s, mask[e]} data[e]   ids sorted ascending,
// with ids >= N as sentinels (never read), optionally dividing by the
// number of rows kept (the masked mean of EGCL's "mean" aggregation), and
// the kept-row counts.
//
// Bound on this card: memory.  Every kept input row is read once and every
// output row written once; there is one add per input element, so the
// arithmetic intensity is below 0.5 FLOP/byte, far under the H100's ridge
// point.  The least time is (rows * D * sizeof(T) + N * D * 4) / 3.35 TB/s.
//
// Design.  One warp owns one segment (all of its columns; rows wider than
// 256 vectors are cut into column chunks along the grid's y) and is the
// only writer of its output: no atomics, and the sum order is fixed, so
// two launches give the same bits.
//   * Segment bounds inside the kernel: the warp finds the first row of
//     its segment by a 32-way search of the sorted ids (32 probes a step,
//     one ballot), and the end by a ballot over the next 32 ids (another
//     search only for segments longer than 32 rows).  No offsets array, so
//     the wrapper launches one kernel a call.
//   * Rows are read as 16-byte vectors along D (8 bf16 or 4 fp32 a lane)
//     where the row's bytes and the base allow it, else one element a lane.
//     A row of V vectors:
//       - V <= 32: the warp covers P = 32 / V rows at once, lane l taking
//         vector l % V of row l / V (so D = 24 fp32, six vectors, keeps 30
//         lanes busy); four such row groups are loaded, without a branch
//         (a row not kept reads the segment's first row and adds 0),
//         before they are added.  At the end the P lanes of a column are
//         added in a fixed order by shuffles;
//       - V > 32: a lane takes vectors l, l + 32, ... (J slots, J = 2, 4 or
//         8), and 8 / J rows are loaded before they are added.
//   * A segment of more than kLong rows (a hub of a skewed graph) would
//     hold its warp long after the others: the CTA's eight warps sum it
//     together once their own segments are done, rows dealt out in turn,
//     and the owner adds their partial sums in warp order from shared
//     memory.
//   * The mask (a bool tensor read as its bytes) is counted once per
//     segment, 32 bytes a ballot.
// Each lane's fp32 sum runs over its rows in row order; bf16 input is
// widened to fp32 before the add; in fast mode fp32 input is rounded to
// bf16 first, as the TPU kernel feeds its matrix unit.  Empty segments give
// 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // segments per CTA
constexpr int kLong = 64;   // rows past which the CTA's warps share a segment

__device__ __forceinline__ int64_t id_at(const void* ids, int ids64,
                                         int64_t p) {
  return ids64 ? __ldg(static_cast<const int64_t*>(ids) + p)
               : (int64_t)__ldg(static_cast<const int32_t*>(ids) + p);
}

// The first p in [lo, hi) with ids[p] >= key (hi if none), by the warp:
// 32 probes a step narrow the range 32-fold.
__device__ int64_t lower_bound_warp(const void* ids, int ids64, int64_t lo,
                                    int64_t hi, int64_t key, int lane) {
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t p = lo + step * (lane + 1) - 1;
    const bool lt = p < hi && id_at(ids, ids64, p) < key;
    const int c = __popc(__ballot_sync(0xffffffffu, lt));
    const int64_t nlo = lo + step * c;
    const int64_t nhi = c < 32 ? lo + step * (c + 1) - 1 : hi;
    lo = nlo < hi ? nlo : hi;
    hi = nhi < hi ? nhi : hi;
  }
  const int64_t p = lo + lane;
  const bool lt = p < hi && id_at(ids, ids64, p) < key;
  return lo + __popc(__ballot_sync(0xffffffffu, lt));
}

// EPV elements of T from p (16 bytes when EPV > 1) as fp32.
template <typename T, int EPV>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[EPV]) {
  if constexpr (EPV == 1) {
    if constexpr (sizeof(T) == 4)
      v[0] = __ldg(reinterpret_cast<const float*>(p));
    else
      v[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  } else {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = __uint_as_float(w[q]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[2 * q] = __uint_as_float(w[q] << 16);
        v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
      }
    }
  }
}

template <int EPV>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[EPV],
                                          float scale) {
  if constexpr (EPV == 1) {
    p[0] = v[0] * scale;
  } else {
#pragma unroll
    for (int q = 0; q < EPV; q += 4)
      *reinterpret_cast<float4*>(p + q) =
          make_float4(v[q] * scale, v[q + 1] * scale, v[q + 2] * scale,
                      v[q + 3] * scale);
  }
}

template <bool ROUND>
__device__ __forceinline__ float widen(float x) {
  return ROUND ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Rows of V <= 32 vectors (J = 0 below): lane l takes vector col = l % V
// of rows first + l / V, first + l / V + step, ... below end (lanes past
// P * V idle), four at a time without a branch (a row not kept reads row
// `safe`, one of the segment's, and adds 0); the lane's fp32 sum is added
// into acc.
template <typename T, bool ROUND, int EPV>
__device__ __forceinline__ void walk_narrow(const T* __restrict__ data,
                                            const uint8_t* __restrict__ mask,
                                            int64_t first, int64_t step,
                                            int64_t end, int64_t safe, int d,
                                            int v, int lane,
                                            float (&acc)[EPV]) {
  constexpr int U = 4;
  const int p_rows = 32 / v, col = lane % v, rho = lane / v;
  if (rho >= p_rows) return;
  for (int64_t e0 = first + rho; e0 < end; e0 += U * step) {
    float x[U][EPV];
    bool keep[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t e = e0 + u * step;
      keep[u] = e < end && (mask == nullptr || mask[e] != 0);
      load_vec<T, EPV>(data + (keep[u] ? e : safe) * d + (int64_t)col * EPV,
                       x[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int q = 0; q < EPV; ++q)
        acc[q] += keep[u] ? widen<ROUND>(x[u][q]) : 0.f;
  }
}

// Rows of V > 32 vectors: lane l takes vectors c0 + l + 32 j (j < JJ) of
// rows first, first + step, ... below end, U rows at a time; the lane's
// fp32 sums are added into acc.
template <typename T, bool ROUND, int EPV, int JJ, int U>
__device__ __forceinline__ void walk_wide(const T* __restrict__ data,
                                          const uint8_t* __restrict__ mask,
                                          int64_t first, int64_t step,
                                          int64_t end, int d, int v, int c0,
                                          int lane, float (&acc)[JJ][EPV]) {
  for (int64_t e0 = first; e0 < end; e0 += U * step) {
    float x[U][JJ][EPV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t e = e0 + u * step;
      const bool keep = e < end && (mask == nullptr || mask[e] != 0);
#pragma unroll
      for (int j = 0; j < JJ; ++j) {
        const int c = c0 + lane + 32 * j;
        if (keep && c < v) {
          load_vec<T, EPV>(data + e * d + (int64_t)c * EPV, x[u][j]);
        } else {
#pragma unroll
          for (int q = 0; q < EPV; ++q) x[u][j][q] = 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < JJ; ++j)
#pragma unroll
        for (int q = 0; q < EPV; ++q) acc[j][q] += widen<ROUND>(x[u][j][q]);
  }
}

// The sums of the P lanes of each column of a narrow row walk, added in
// row-group order: lane col < V ends with its column's total.
template <int EPV>
__device__ __forceinline__ void narrow_total(float (&acc)[EPV], int v,
                                             int lane) {
  const int p_rows = 32 / v, col = lane % v;
  float tot[EPV];
#pragma unroll
  for (int q = 0; q < EPV; ++q) tot[q] = 0.f;
  for (int r = 0; r < p_rows; ++r)
#pragma unroll
    for (int q = 0; q < EPV; ++q)
      tot[q] += __shfl_sync(0xffffffffu, acc[q], col + r * v);
#pragma unroll
  for (int q = 0; q < EPV; ++q) acc[q] = tot[q];
}

// J = 0: rows of V <= 32 vectors; J > 0: J vector slots a lane.  d is the
// row's elements, v its vectors.  A segment longer than kLong rows is
// summed by all the CTA's warps after their own segments, rows dealt out
// in turn, their partial sums added in warp order in shared memory.
// Narrow rows keep the registers to 48 (five CTAs an SM: more rows in
// flight); wide rows need theirs.
template <typename T, bool ROUND, int EPV, int J>
__global__ void __launch_bounds__(32 * kWarps, J == 0 ? 5 : 1)
segment_sum_kernel(const T* __restrict__ data, const void* __restrict__ ids,
                   int ids64, const uint8_t* __restrict__ mask,
                   float* __restrict__ out, float* __restrict__ counts,
                   int64_t e_rows, int n_segments, int d, int v, int mean) {
  __shared__ int64_t long_beg[kWarps], long_end[kWarps];
  __shared__ float part[kWarps][32][EPV];
  const int lane = threadIdx.x, w = threadIdx.y;
  const int s = blockIdx.x * kWarps + w;
  const int c0 = blockIdx.y * 32 * (J > 0 ? J : 1);   // this CTA's columns
  int64_t beg = 0, end = 0;
  float scale = 1.f;
  if (s < n_segments) {
    beg = lower_bound_warp(ids, ids64, 0, e_rows, s, lane);
    const int64_t p = beg + lane;
    const bool lt = p < e_rows && id_at(ids, ids64, p) < s + 1;
    const int c = __popc(__ballot_sync(0xffffffffu, lt));
    end = c < 32 ? beg + c
                 : lower_bound_warp(ids, ids64, beg + 32, e_rows, s + 1, lane);
    // rows kept, counted once
    int kept = (int)(end - beg);
    if (mask != nullptr) {
      kept = 0;
      for (int64_t e0 = beg; e0 < end; e0 += 32) {
        const bool k = e0 + lane < end && mask[e0 + lane] != 0;
        kept += __popc(__ballot_sync(0xffffffffu, k));
      }
    }
    scale = mean ? 1.f / fmaxf((float)kept, 1.f) : 1.f;
    if (counts != nullptr && lane == 0 && blockIdx.y == 0)
      counts[s] = (float)kept;
  }
  const bool shared_seg = end - beg > kLong;
  if (lane == 0) {
    long_beg[w] = shared_seg ? beg : -1;
    long_end[w] = end;
  }
  float* orow = out + (int64_t)s * d;
  if (s < n_segments && !shared_seg) {   // the warp's own segment
    if constexpr (J == 0) {
      float acc[EPV] = {};
      walk_narrow<T, ROUND, EPV>(data, mask, beg, 32 / v, end, beg, d, v,
                                 lane, acc);
      narrow_total<EPV>(acc, v, lane);
      if (lane < v) store_vec<EPV>(orow + (int64_t)lane * EPV, acc, scale);
    } else {
      float acc[J][EPV] = {};
      walk_wide<T, ROUND, EPV, J, (J >= 8 ? 1 : 8 / J)>(
          data, mask, beg, 1, end, d, v, c0, lane, acc);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = c0 + lane + 32 * j;
        if (c < v) store_vec<EPV>(orow + (int64_t)c * EPV, acc[j], scale);
      }
    }
  }
  __syncthreads();
  // the CTA's long segments, one at a time (a uniform loop), 32 vectors a
  // pass: warp w sums rows lb + w, lb + w + kWarps, ...
  for (int o = 0; o < kWarps; ++o) {
    const int64_t lb = long_beg[o], le = long_end[o];
    if (lb < 0) continue;
    for (int j = 0; j < (J > 0 ? J : 1); ++j) {
      float acc[EPV] = {};
      if constexpr (J == 0) {
        const int p_rows = 32 / v;
        walk_narrow<T, ROUND, EPV>(data, mask, lb + (int64_t)w * p_rows,
                                   (int64_t)kWarps * p_rows, le, lb, d, v,
                                   lane, acc);
      } else {
        float a1[1][EPV] = {};
        walk_wide<T, ROUND, EPV, 1, 4>(data, mask, lb + w, kWarps, le, d, v,
                                       c0 + 32 * j, lane, a1);
#pragma unroll
        for (int q = 0; q < EPV; ++q) acc[q] = a1[0][q];
      }
#pragma unroll
      for (int q = 0; q < EPV; ++q) part[w][lane][q] = acc[q];
      __syncthreads();
      if (w == o) {   // the owner adds the warps' sums in order and writes
#pragma unroll
        for (int q = 0; q < EPV; ++q) {
          acc[q] = 0.f;
          for (int w2 = 0; w2 < kWarps; ++w2) acc[q] += part[w2][lane][q];
        }
        if constexpr (J == 0) {
          narrow_total<EPV>(acc, v, lane);
          if (lane < v) store_vec<EPV>(orow + (int64_t)lane * EPV, acc, scale);
        } else {
          const int c = c0 + 32 * j + lane;
          if (c < v) store_vec<EPV>(orow + (int64_t)c * EPV, acc, scale);
        }
      }
      __syncthreads();
    }
  }
}

// The launch's vector slots a lane: 0 for rows of at most 32 vectors,
// else 2, 4 or 8 (rows wider than 256 vectors take several CTAs along y).
inline int slots_of(int v) {
  if (v <= 32) return 0;
  const int j = (v + 31) / 32;
  return j <= 2 ? 2 : j <= 4 ? 4 : 8;
}

template <typename T, bool ROUND, int EPV>
cudaError_t launch_epv(const void* data, const void* ids, int ids64,
                       const uint8_t* mask, float* out, float* counts,
                       int64_t e_rows, int n_segments, int d, int mean,
                       cudaStream_t st) {
  const int v = d / EPV;
  const int j = slots_of(v);
  dim3 block(32, kWarps);
  dim3 grid((n_segments + kWarps - 1) / kWarps,
            j == 0 ? 1 : (v + 32 * j - 1) / (32 * j));
  const T* x = static_cast<const T*>(data);
#define CSMPN_K1_LAUNCH(JJ)                                                  \
  segment_sum_kernel<T, ROUND, EPV, JJ><<<grid, block, 0, st>>>(            \
      x, ids, ids64, mask, out, counts, e_rows, n_segments, d, v, mean)
  if (j == 0) CSMPN_K1_LAUNCH(0);
  else if (j == 2) CSMPN_K1_LAUNCH(2);
  else if (j == 4) CSMPN_K1_LAUNCH(4);
  else CSMPN_K1_LAUNCH(8);
#undef CSMPN_K1_LAUNCH
  return cudaGetLastError();
}

template <typename T, bool ROUND>
cudaError_t launch(const void* data, const void* ids, int ids64,
                   const uint8_t* mask, float* out, float* counts,
                   int64_t e_rows, int n_segments, int d, int mean,
                   cudaStream_t st) {
  if (n_segments <= 0 || d <= 0) return cudaGetLastError();
  constexpr int VEC = 16 / (int)sizeof(T);   // elements of a 16-byte vector
  const bool vec = d % VEC == 0 &&
                   reinterpret_cast<uintptr_t>(data) % 16 == 0;
  if (vec)
    return launch_epv<T, ROUND, VEC>(data, ids, ids64, mask, out, counts,
                                     e_rows, n_segments, d, mean, st);
  return launch_epv<T, ROUND, 1>(data, ids, ids64, mask, out, counts, e_rows,
                                 n_segments, d, mean, st);
}

}  // namespace

extern "C" {
// dtype: 0 = float32, 1 = bfloat16.  round_bf16 applies to float32 input.
// ids: (e_rows,) sorted ascending, int64 if ids64 else int32.  mask (bool
// bytes) and counts may be null.  out: (n_segments, d) float32.  Returns
// cudaGetLastError().
int csmpn_segment_sum(const void* data, int dtype, int round_bf16,
                      const void* ids, int ids64, const uint8_t* mask,
                      float* out, float* counts, long long e_rows,
                      int n_segments, int d, int mean, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(data, ids, ids64, mask, out, counts,
                                        e_rows, n_segments, d, mean, st);
  if (round_bf16)
    return launch<float, true>(data, ids, ids64, mask, out, counts, e_rows,
                               n_segments, d, mean, st);
  return launch<float, false>(data, ids, ids64, mask, out, counts, e_rows,
                              n_segments, d, mean, st);
}
}  // extern "C"
