// K4w and K5w at Cl(3,0): the C entry points csmpn_fused_wide_* of the
// wide dense fused message-passing kernels of fused_egcl_wide.cuh (its
// header comment has the design, the bound and the entries).

#include "fused_egcl_wide.cuh"

extern "C" {
CSMPN_FUSED_WIDE_ENTRIES(csmpn_fused_wide, Cl3)
}  // extern "C"
