// K2p and K3p at Cl(5,0) (32 blades, 6 grades, 56 grade paths): the
// hulls task's CEMLP blocks and the node side of the bench at --dim 5.
// The kernels are cemlp_pair_kernels.cuh (design, bound and precision are
// stated there); this source compiles them for Cl(5) as the entry points
// csmpn_cemlp_pair_*.
//
// Row tile.  A row's 32 blades are a warp; a CTA holds 8 row slots of 2
// warps in the forward and 4 of 4 warps in the backward (16 warps each).
// At the hulls widths (C = 28, Cin up to 59) the parameters take ~86 KB and
// the row slots the rest: 220 KB forward, 219 KB backward, one CTA an SM.

#include "cemlp_pair_kernels.cuh"

namespace {
using TileCl5 = RowTile<8, 2, 4, 4>;
}  // namespace

extern "C" {
CSMPN_CEMLP_PAIR_ENTRIES(csmpn_cemlp_pair, Cl5, TileCl5)
}  // extern "C"
