// K2pw and K3pw at Cl(4,0): the C entry points csmpn_cemlp_pair_wide_cl4_*
// of the wide pair-form block kernels of cemlp_pair_wide.cuh (its header
// comment has the design, the bound and the entries): the CEMLP blocks of
// the flat stack's node side at --dim 4 and of the Python API at the
// widths K2p/K3p of cemlp_pair_cl4.cu do not take.  A row is a half-warp,
// so a CTA step takes two rows a warp.

#include "cemlp_pair_wide.cuh"

extern "C" {
CSMPN_PAIR_WIDE_ENTRIES(csmpn_cemlp_pair_wide_cl4, Cl4)
}  // extern "C"
