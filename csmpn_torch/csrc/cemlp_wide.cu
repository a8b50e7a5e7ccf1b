// K2w and K3w at Cl(3,0): the C entry points csmpn_cemlp_wide_* of the
// wide dense block kernels of cemlp_wide.cuh (its header comment has the
// design, the bound and the entries).

#include "cemlp_wide.cuh"

extern "C" {
CSMPN_WIDE_ENTRIES(csmpn_cemlp_wide, Cl3)
}  // extern "C"
