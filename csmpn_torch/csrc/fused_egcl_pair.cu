// K4p and K5p at Cl(5,0) (32 blades): the edge side of the bench at
// --dim 5.  The kernels are fused_egcl_pair.cuh (design and precision are
// stated there); this source compiles them for Cl(5) as the entry points
// csmpn_fused_mp_pair_*.
//
// Bound on this card: at the bench shape at Cl(5) (E = 131,072 edges,
// N = 8,192 nodes, 28 -> 28 channels, bf16 streams) K4p reads ~250 MB (hj,
// h, ids) and writes 29 MB, ~83 us at 3.35 TB/s, against ~71 GFLOP of
// block math (two blocks of three channel-mixing linears, the 32 x 32 pair
// product and the elementwise steps), ~72 us at the bf16 tensor-core rate:
// bytes bound it, as for K4.  K5p moves about twice the bytes and does
// three times the operations, so operations bound it.
//
// Fast mode (fused_egcl_pair_tile.cuh): K2p's and K3p's row tiles, 8 rows
// a step on 8 warps for the forward sweeps and 4 rows on 12 warps for the
// backward ones (~171 KB of shared memory at 28 -> 28); the window sums
// take a CTA a window of wn = 4 targets.
//
// Exact mode, the row tile and window.  A row's 32 blades are a warp.  Both
// blocks' fp32 parameters take ~130 KB at 28 channels, which leaves:
//   * K4p: 4 row slots of 4 warps (16 warps), windows of wn = 4 targets
//     (3.5 KB each): 195,760 B at 28 -> 28;
//   * K5p: 2 row slots of 4 warps (8 warps): 219,080 B.
// 28 channels is the widest that fits; K5p takes Cm + Ca up to 39.

#include "fused_egcl_pair.cuh"

namespace {
using TileCl5 = RowTile<4, 4, 2, 4>;
}  // namespace

extern "C" {
CSMPN_FUSED_PAIR_ENTRIES(csmpn_fused_mp_pair, Cl5, TileCl5)
}  // extern "C"
