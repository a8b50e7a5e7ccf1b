// K2p and K3p at Cl(4,0) (16 blades, 5 grades, 35 grade paths): the node
// side of the bench at --dim 4.  The kernels are cemlp_pair_kernels.cuh
// (design, bound and precision are stated there); this source compiles
// them for Cl(4) as the entry points csmpn_cemlp_pair_cl4_*.
//
// Row tile.  A row's 16 blades are a half-warp, so a warp holds two members
// of one row, each taking its own groups of four channels.  A row slot is
// (Cin + 2 C4) x 17 floats in the forward and (Cin + 5 C4) x 17 in the
// backward, about half of Cl(5)'s, and the parameters take ~70 KB at the
// bench's node block 0 (56 -> 28).  So the tile keeps Cl(5)'s 16 warps a
// CTA with more rows in flight:
//   * forward: 16 row slots of one warp (two members a row, no named
//     barrier): 197.5 KB at 56 -> 28;
//   * backward: 8 row slots of 2 warps (four members a row): 201.8 KB at
//     56 -> 28.
// Both leave one CTA an SM; the forward takes Cin up to 77 and the backward
// up to 83 at C = 28.  K3p on 16 warps (128 registers, small spills) ran
// 1.23x faster on the H100 than on 8 warps of a slot each.

#include "cemlp_pair_kernels.cuh"

namespace {
using TileCl4 = RowTile<16, 1, 8, 2>;
}  // namespace

extern "C" {
CSMPN_CEMLP_PAIR_ENTRIES(csmpn_cemlp_pair_cl4, Cl4, TileCl4)
}  // extern "C"
