// K2w and K3w at Cl(2,0): the C entry points csmpn_cemlp_wide_cl2_* of the
// wide dense block kernels of cemlp_wide.cuh (its header comment has the
// design, the bound and the entries).

#include "cemlp_wide.cuh"

extern "C" {
CSMPN_WIDE_ENTRIES(csmpn_cemlp_wide_cl2, Cl2)
}  // extern "C"
