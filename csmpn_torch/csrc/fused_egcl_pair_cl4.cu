// K4p and K5p at Cl(4,0) (16 blades): the edge side of the bench at
// --dim 4.  The kernels are fused_egcl_pair.cuh (design and precision are
// stated there); this source compiles them for Cl(4) as the entry points
// csmpn_fused_mp_pair_cl4_*.
//
// Bound on this card: at the bench shape at Cl(4) (E = 131,072 edges,
// N = 8,192 nodes, 28 -> 28 channels, bf16 streams) K4p reads ~125 MB (hj,
// h, ids) and writes 15 MB, ~42 us at 3.35 TB/s, against ~30 GFLOP of
// block math (two blocks of three channel-mixing linears, the 16 x 16 pair
// product and the elementwise steps), ~30 us at the bf16 tensor-core rate:
// bytes bound it.  K5p moves about twice the bytes and does three times
// the operations, so operations bound it.
//
// Fast mode (fused_egcl_pair_tile.cuh): K2p's and K3p's row tiles, 16 rows
// a step on 16 warps for the forward sweeps and 8 rows on 8 warps for the
// backward ones (~158 KB of shared memory at 28 -> 28); the window sums
// take a CTA a window of wn = 16 targets.
//
// Exact mode, the row tile and window.  A row's 16 blades are a half-warp,
// so a warp holds two members of one row.  Both blocks' fp32 parameters
// take ~109 KB at 28 channels (5 grades, 35 paths), and a row slot about
// half of Cl(5)'s
// ((Cm + 2 C4) x 17 floats forward, (Cm + 5 C4) x 17 backward), which
// leaves:
//   * K4p: 8 row slots of 2 warps (16 warps, four members a row);
//   * K5p: 4 row slots of 4 warps (16 warps, eight members a row: twice
//     Cl(5)'s warps);
//   * windows of wn = 16 targets (a window's sum is 28 KB in K4p, its d(h)
//     28 KB in K5p): 512 windows at the bench's 8,192 targets, 3.9 a CTA,
//     so the last round of windows leaves few SMs idle.
// At 28 -> 28 that is 186,112 B (K4p) and 206,608 B (K5p); 28 channels is
// the widest that fits (29 pads to 32: 234 KB in K5p), and K5p takes
// Cm + Ca up to 51 at C = 28.  At 16 warps K5p is held to 128 registers and
// spills; on the H100 that ran 1.16x and 1.44x faster than K5p on 8 warps
// in 4 slots of 2 or 2 slots of 4 (255 registers, no spills).

#include "fused_egcl_pair.cuh"

namespace {
using TileCl4 = RowTile<8, 2, 4, 4>;
}  // namespace

extern "C" {
CSMPN_FUSED_PAIR_ENTRIES(csmpn_fused_mp_pair_cl4, Cl4, TileCl4)
}  // extern "C"
