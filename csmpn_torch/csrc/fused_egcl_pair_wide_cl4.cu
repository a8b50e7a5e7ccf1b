// K4pw and K5pw at Cl(4,0): the C entry points csmpn_fused_pair_wide_cl4_*
// of the wide pair-form fused message-passing kernels of
// fused_egcl_pair_wide.cuh (its header comment has the design, the bound
// and the entries).  A row is a half-warp, so a CTA step takes two rows a
// warp.

#include "fused_egcl_pair_wide.cuh"

extern "C" {
CSMPN_FUSED_PAIR_WIDE_ENTRIES(csmpn_fused_pair_wide_cl4, Cl4)
}  // extern "C"
