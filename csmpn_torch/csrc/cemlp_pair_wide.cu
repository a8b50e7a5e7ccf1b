// K2pw and K3pw at Cl(5,0): the C entry points csmpn_cemlp_pair_wide_* of
// the wide pair-form block kernels of cemlp_pair_wide.cuh (its header
// comment has the design, the bound and the entries): the hulls task's
// CEMLP blocks at the widths K2p/K3p of cemlp_pair.cu do not take.

#include "cemlp_pair_wide.cuh"

extern "C" {
CSMPN_PAIR_WIDE_ENTRIES(csmpn_cemlp_pair_wide, Cl5)
}  // extern "C"
