"""Writes ``csmpn_torch/csrc/pair_terms.cuh``, the Cayley pair terms that the
fast-mode K2p row tile forward (csrc/cemlp_pair_fwd_tile.cuh) unrolls at
compile time, from the port's algebra:

    python -m csmpn_torch.tools.pair_terms          # rewrite the header
    python -m csmpn_torch.tools.pair_terms --check  # exit 1 if it differs

For Cl(5,0) and Cl(4,0) every term of the pair-form geometric product
``gp_j = sum_k sign(j, k) * w[path(j, k)] * z_i * yn_k``, i = i_of(j, k),
is one int: ``j | k << 5 | i << 10 | neg << 15 | path << 16 | first <<
23``, the terms sorted by path, then j, then k; ``first`` marks the first
term of each path, where the kernel loads that path's weight.  The header
is a literal table because nvcc's host compiler once mis-evaluated a
table built by a constexpr loop (PERF.md); tests/test_torch_pair_tiles.py
holds it to this generator and to the reference's structural tables.
"""
from __future__ import annotations

import os
import sys

from ..algebra import get_algebra
from ..ops import _build

HEADER = os.path.join(_build.CSRC, "pair_terms.cuh")
DIMS = (5, 4)


def terms(dim: int):
    """The packed terms of Cl(dim, 0), in the kernel's order."""
    alg = get_algebra((1.0,) * dim)
    nb = alg.n_blades
    i_of, coeff = alg.gp_pair_tables
    path = alg.gp_pair_paths
    out, seen = [], set()
    for p, j, k in sorted((int(path[j, k]), j, k) for j in range(nb)
                          for k in range(nb)):
        neg = 1 if coeff[j, k] < 0 else 0
        first = 0 if p in seen else 1
        seen.add(p)
        out.append(j | k << 5 | int(i_of[j, k]) << 10 | neg << 15 | p << 16
                   | first << 23)
    return out


def decode(t: int):
    """(j, k, i, neg, path, first) of a packed term."""
    return (t & 31, (t >> 5) & 31, (t >> 10) & 31, (t >> 15) & 1,
            (t >> 16) & 127, (t >> 23) & 1)


def header_text() -> str:
    lines = [
        "// Generated by `python -m csmpn_torch.tools.pair_terms` from the",
        "// port's algebra (csmpn_torch/algebra); do not edit.  The Cayley",
        "// pair terms of the pair-form geometric product that the fast-mode",
        "// K2p row tile forward (cemlp_pair_fwd_tile.cuh) unrolls: term =",
        "// j | k << 5 | i << 10 | neg << 15 | path << 16 | first << 23,",
        "// sorted by path, j, k; `first` marks the first term of a path.",
        "#pragma once",
        "",
        "namespace {",
        "",
        "template <int NB>",
        "struct PairTerms;",
    ]
    for dim in DIMS:
        nb = 2 ** dim
        ts = terms(dim)
        lines += [
            "",
            f"// Cl({dim},0): {nb} blades",
            "template <>",
            f"struct PairTerms<{nb}> {{",
            f"  static constexpr int TERM[{len(ts)}] = {{",
        ]
        for a in range(0, len(ts), 6):
            lines.append("      " + ", ".join(f"0x{t:06x}" for t in ts[a:a + 6])
                         + ",")
        lines += [
            "  };",
            "  // a term at compile time in device code",
            "  __host__ __device__ static constexpr int term(int q) "
            "{ return TERM[q]; }",
            "};"]
    lines += ["", "}  // namespace", ""]
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    text = header_text()
    if "--check" in argv:
        with open(HEADER) as f:
            same = f.read() == text
        print(f"{HEADER}: {'up to date' if same else 'differs'}")
        return 0 if same else 1
    with open(HEADER, "w") as f:
        f.write(text)
    print(f"wrote {HEADER}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
