"""K2/K3 and K2p/K3p — one whole CEMLP block, forward and backward: CUDA
kernel wrappers, their plain versions, and the autograd wiring.

Port of ``csmpn_tpu/ops/cemlp_kernel.py`` (``apply_fused_cemlp``), in its
two forms:

  * dense, nb = 8 and nb = 4: K2/K3 in ``csrc/cemlp.cu``, compiled for
    Cl(3,0) (the motion and MD17 tasks, output width <= 32 channels) and
    for Cl(2,0) (the NBA task, output width <= 64 channels: a lane holds
    two 4-blade channels).  In fast mode both are row tile kernels of
    ``csrc/cemlp_tile.cuh`` (steps of 16 rows, the channel-mixing linears,
    and in K3 their weight gradients, as bf16 ``mma.sync`` products; the
    x tile in chunks of input channels where it does not fit whole); their
    widths are those whose tiles fit in one CTA (``_smem``); K2's grid is
    as many CTAs as the SMs hold at once, and its parameters reach the
    CTAs as one image built by a first launch (``_fwd_tile_launch``);
  * pair, nb = 32 and nb = 16: K2p/K3p, ``csrc/cemlp_pair_kernels.cuh``
    compiled for Cl(5,0) (``csrc/cemlp_pair.cu``, the hulls task) and for
    Cl(4,0) (``csrc/cemlp_pair_cl4.cu``, the bench at ``--dim 4``), where
    the weighted geometric product runs over the Cayley pairs (one left
    blade and one sign per (output j, right k)).  In fast mode K3p is the
    row tile kernel of ``csrc/cemlp_pair_tile.cuh`` (steps of 128 (row,
    blade) pairs, the channel-mixing linears and their weight gradients as
    bf16 ``mma.sync`` products), and K2p that of
    ``csrc/cemlp_pair_fwd_tile.cuh`` (the same steps and linears, the pair
    product a thread per (row, channel, group of output blades) over the
    Cayley terms of ``csrc/pair_terms.cuh``, unrolled at compile time).

At the widths whose dense block does not fit in one CTA of those kernels
(``_smem``, the lanes of a warp), every C <= 128 output and Cin <= 320
input channels, a dense block runs K2w/K3w (``csrc/cemlp_wide.cuh``, FFMA
products of weight panels streamed through shared memory from a parameter
image, the backward's weight gradients a kernel of their own over the
rows' cotangents); ``block_route`` picks a launch's kernels.  Likewise,
in the pair form, at the widths K2p/K3p's plans do not take, every C <= 64
output and Cin <= 160 input channels runs K2pw/K3pw
(``csrc/cemlp_pair_wide.cuh``, at Cl(5,0) and Cl(4,0): a lane a blade of
every channel, FFMA products of weight panels streamed from a parameter
image, the Cayley pairs from the packed tables, the backward's weight and
path-weight gradients kernels of their own over the rows' cotangents).
Wider blocks of either form raise NotImplementedError, as Cl(1) (nb = 2),
which the reference's dense form also serves, still does.  On a CUDA
tensor the wrappers launch the kernels (or raise); on a CPU tensor they
compute the plain versions:

  * ``block_forward_plain`` — the block in PyTorch, written per grade
    (the same function as ``_post_linear_math`` and the composed layers);
  * the plain K3/K3p is ``torch.autograd.grad`` of the plain K2/K2p, so
    the hand-derived backward of the kernel is checked independently.

The block's parameters are taken in their flax shapes, in this order:
``linear.weight (C, Cin, G), linear.bias (C, 1), silu.a (C, G),
silu.b (C, G), gp.weight (C, P), gp.linear_right.weight (C, C, G),
gp.normalization.a (C, G), gp.linear_left.weight (C, C, G),
gp.linear_left.bias (C, 1), norm.a (C,)`` with G grades and P nonzero
grade paths (3 and 10 at Cl(2), 4 and 20 at Cl(3), 5 and 35 at Cl(4), 6
and 56 at Cl(5)).

``exact=False`` (fast mode) rounds to bf16 the operands of every product
the TPU kernel feeds its matrix unit and accumulates in fp32.  The two
forms round the geometric product at different points, as the TPU kernel
does: the dense form rounds the path weight (an operand of the Kcat
product), the pair form rounds each pair's product ``z_i * yn_k * w``
(the operand of its signed S4 sum) and leaves the weight in fp32.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import _build

EPS = 1e-6
SQRT2_INV = 1.0 / math.sqrt(2.0)
FWD_LAUNCHES = _build.LaunchCounter("cemlp_block_fwd")
BWD_LAUNCHES = _build.LaunchCounter("cemlp_block_bwd")
CL2_FWD_LAUNCHES = _build.LaunchCounter("cemlp_cl2_fwd")
CL2_BWD_LAUNCHES = _build.LaunchCounter("cemlp_cl2_bwd")
PAIR_FWD_LAUNCHES = _build.LaunchCounter("cemlp_pair_fwd")
PAIR_BWD_LAUNCHES = _build.LaunchCounter("cemlp_pair_bwd")
PAIR_CL4_FWD_LAUNCHES = _build.LaunchCounter("cemlp_pair_cl4_fwd")
PAIR_CL4_BWD_LAUNCHES = _build.LaunchCounter("cemlp_pair_cl4_bwd")
WIDE_FWD_LAUNCHES = _build.LaunchCounter("cemlp_wide_fwd")
WIDE_BWD_LAUNCHES = _build.LaunchCounter("cemlp_wide_bwd")
WIDE_CL2_FWD_LAUNCHES = _build.LaunchCounter("cemlp_wide_cl2_fwd")
WIDE_CL2_BWD_LAUNCHES = _build.LaunchCounter("cemlp_wide_cl2_bwd")
PAIR_WIDE_FWD_LAUNCHES = _build.LaunchCounter("cemlp_pair_wide_fwd")
PAIR_WIDE_BWD_LAUNCHES = _build.LaunchCounter("cemlp_pair_wide_bwd")
PAIR_WIDE_CL4_FWD_LAUNCHES = _build.LaunchCounter("cemlp_pair_wide_cl4_fwd")
PAIR_WIDE_CL4_BWD_LAUNCHES = _build.LaunchCounter("cemlp_pair_wide_cl4_bwd")

_P = ctypes.c_void_p
_I = ctypes.c_int


@dataclass(frozen=True)
class BlockKernel:
    """What one pair of block kernels takes, and where it lives."""
    label: str
    source: str           # csrc/{source}.cu
    symbol: str           # prefix of its C entry points
    algebra: str
    n_blades: int
    n_grades: int
    n_paths: int
    max_channels: int     # output channels a row's warp holds (0: any)
    rows_fwd: int         # rows per CTA tile (csrc constants; 0: the
    rows_bwd: int         # library's warps entry, a row a member)
    fwd: _build.LaunchCounter
    bwd: _build.LaunchCounter
    # "dense": Cayley signs passed from the host; "pair": the packed pair
    # tables on the card, and the backward's channel-mixing scratch
    form: str = "dense"


DENSE = BlockKernel("K2/K3", "cemlp", "csmpn_cemlp", "Cl(3) (8 blades)", 8,
                    4, 20, 32, 8, 8, FWD_LAUNCHES, BWD_LAUNCHES)
DENSE_CL2 = BlockKernel("K2/K3 at Cl(2)", "cemlp", "csmpn_cemlp_cl2",
                        "Cl(2) (4 blades)", 4, 3, 10, 64, 8, 8,
                        CL2_FWD_LAUNCHES, CL2_BWD_LAUNCHES)
PAIR = BlockKernel("K2p/K3p", "cemlp_pair", "csmpn_cemlp_pair",
                   "Cl(5,0) (32 blades)", 32, 6, 56, 0, 8, 4,
                   PAIR_FWD_LAUNCHES, PAIR_BWD_LAUNCHES, form="pair")
PAIR_CL4 = BlockKernel("K2p/K3p at Cl(4)", "cemlp_pair_cl4",
                       "csmpn_cemlp_pair_cl4", "Cl(4,0) (16 blades)", 16, 5,
                       35, 0, 16, 8, PAIR_CL4_FWD_LAUNCHES,
                       PAIR_CL4_BWD_LAUNCHES, form="pair")

# the widths K2w/K3w take are their library's (block_route asks it)
WIDE = BlockKernel("K2w/K3w", "cemlp_wide", "csmpn_cemlp_wide",
                   "Cl(3) (8 blades)", 8, 4, 20, 0, 8, 8,
                   WIDE_FWD_LAUNCHES, WIDE_BWD_LAUNCHES)
WIDE_CL2 = BlockKernel("K2w/K3w at Cl(2)", "cemlp_wide_cl2",
                       "csmpn_cemlp_wide_cl2", "Cl(2) (4 blades)", 4, 3, 10,
                       0, 8, 8, WIDE_CL2_FWD_LAUNCHES, WIDE_CL2_BWD_LAUNCHES)
# the widths K2pw/K3pw take are their library's (block_route asks it)
PAIR_WIDE = BlockKernel("K2pw/K3pw", "cemlp_pair_wide",
                        "csmpn_cemlp_pair_wide", "Cl(5,0) (32 blades)", 32, 6,
                        56, 0, 0, 0, PAIR_WIDE_FWD_LAUNCHES,
                        PAIR_WIDE_BWD_LAUNCHES, form="pair")
PAIR_WIDE_CL4 = BlockKernel("K2pw/K3pw at Cl(4)", "cemlp_pair_wide_cl4",
                            "csmpn_cemlp_pair_wide_cl4", "Cl(4,0) (16 blades)",
                            16, 5, 35, 0, 0, 0, PAIR_WIDE_CL4_FWD_LAUNCHES,
                            PAIR_WIDE_CL4_BWD_LAUNCHES, form="pair")
# the wide kernels of each form, by blade count
WIDE_OF = {8: WIDE, 4: WIDE_CL2, 32: PAIR_WIDE, 16: PAIR_WIDE_CL4}
_WIDE_KERNELS = tuple(WIDE_OF.values())


def block_kernel(nb: int) -> BlockKernel:
    """The block kernels for nb blades, or NotImplementedError."""
    for k in (DENSE_CL2, DENSE, PAIR_CL4, PAIR):
        if k.n_blades == nb:
            return k
    raise NotImplementedError(
        f"no CEMLP block kernel for {nb} blades: K2/K3 take 2- and 3-dim "
        f"algebras (4 and 8 blades), K2p/K3p Cl(4,0) and Cl(5,0) (16 and 32 "
        f"blades); Cl(1) (2 blades, the dense form) is still to port "
        f"(ROADMAP Queue 2)")


def _rounder(exact: bool):
    if exact:
        return lambda t: t
    return lambda t: t.to(torch.bfloat16).to(torch.float32)


def block_params(cemlp, i: int) -> List[torch.Tensor]:
    """The 10 parameter tensors of block ``i`` of a CEMLP module; a block
    whose SGP has no normalization layer, which the kernels do not
    compute, raises ValueError."""
    lin = getattr(cemlp, f"linear_{i}")
    silu = getattr(cemlp, f"silu_{i}")
    gp = getattr(cemlp, f"gp_{i}")
    ln = getattr(cemlp, f"norm_{i}")
    if not hasattr(gp, "normalization"):
        raise ValueError(
            f"CEMLP block {i} has no normalization layer "
            f"(normalization_init=None): the block kernels compute the block "
            f"with it, so this block takes the composed route")
    return [lin.weight, lin.bias, silu.a, silu.b, gp.weight,
            gp.linear_right.weight, gp.normalization.a,
            gp.linear_left.weight, gp.linear_left.bias, ln.a]


# ------------------------------------------------------------ plain version

def block_forward_plain(x: torch.Tensor, params: Sequence[torch.Tensor],
                        alg, exact: bool = True) -> torch.Tensor:
    """One CEMLP block on (rows, Cin, nb) float32 -> (rows, C, nb)."""
    r = _rounder(exact)
    W1, b1, sa, sb, gw, Wr, na, WL, bL, aln = params
    dev = x.device
    g = alg.index("blade_to_grade", dev)
    bc = alg.const("_b_coeff", x)
    G = alg.const("grade_onehot", x)                    # (nb, n_grades)
    i_of = alg.index("pair_i_of", dev)
    coeff = alg.const("pair_coeff", x)
    path = alg.index("gp_pair_paths", dev)

    def linear(v, w):
        return torch.einsum("rmi,nmi->rni", v, r(w)[..., g])

    def bias0(v, b):
        return torch.cat([v[..., :1] + b, v[..., 1:]], dim=-1)

    y = bias0(linear(r(x), W1), b1)
    # MVSiLU: raw scalar blade at grade 0, squared magnitudes above
    sq = r(y * y * bc)
    v = torch.cat([r(y[..., :1]), sq[..., 1:]], dim=-1)
    inv = v @ G
    s = torch.sigmoid(r(sa) * inv + sb)
    z = s[..., g] * y
    zr = r(z)
    # SGP: right linear, grade-norm normalisation, pair-form product
    yr = linear(zr, Wr)
    qg = r(yr * yr * bc) @ G
    nr = torch.sqrt(torch.sqrt(qg * qg + 1e-16))
    den = torch.sigmoid(na) * (nr - 1.0) + 1.0 + EPS
    yn = yr / den[..., g]
    if alg.n_blades > 8:
        # pair form: each pair's product z_i * yn_k * w is one operand of
        # the signed pair sum (rounded in fast mode; w stays fp32)
        prod = (zr[..., i_of] * r(yn)[..., None, :]) * gw[:, path]
        gp = torch.sum(r(prod) * coeff, dim=-1)     # (rows, C, nb) [r,n,j]
    else:
        cw = coeff * r(gw)[:, path]                     # (C, nb, nb) [n,j,k]
        gp = torch.einsum("rnjk,njk,rnk->rnj", zr[..., i_of], cw, r(yn))
    first = bias0(linear(zr, WL), bL)
    o = (first + gp) * SQRT2_INV
    # MVLayerNorm
    qc = torch.sum(r(o * o * bc), dim=-1)
    nc = torch.sqrt(torch.sqrt(qc * qc + 1e-16))
    m = torch.mean(nc, dim=-1, keepdim=True) + EPS
    return aln[:, None] * o / m[..., None]


def block_backward_plain(x, dout, params, alg, exact=True):
    """Plain K3: autograd of the plain K2.  Returns (dx, param grads)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        ps = [p.detach().requires_grad_(True) for p in params]
        out = block_forward_plain(xg, ps, alg, exact)
        grads = torch.autograd.grad(out, [xg, *ps], dout)
    return grads[0], list(grads[1:])


# ------------------------------------------------------------ CUDA wrappers

def _fn(name, nargs_ptr, nargs_int, source):
    lib = _build.load(source)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [_P] * nargs_ptr + [_I] * nargs_int + [_P]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _alg_tables(metric: tuple, source: str = "", symbol: str = ""):
    """(bc, sign) host arrays for the kernels, after checking that the
    algebra's structure is the one compiled into the block kernels of its
    blade count (or into csrc/{source}.cu, whose entry points prefixed
    ``symbol`` include their device code): the left blade and the grade
    path of every Cayley pair (j, k), the grade of every blade and, for the
    pair kernels, which compute it, the pair's sign."""
    from ..algebra.clifford import get_algebra

    alg = get_algebra(metric)
    kern = block_kernel(alg.n_blades)
    nb = kern.n_blades
    source = source or kern.source
    symbol = symbol or kern.symbol
    if alg.n_product_paths != kern.n_paths:
        raise NotImplementedError(
            f"csrc/{source}.cu is compiled for {kern.algebra} with "
            f"{kern.n_paths} grade paths, got metric {metric}")
    lib = _build.load(source)
    fn = getattr(lib, f"{symbol}_tables")
    i_of = np.zeros(nb * nb, np.int32)
    path = np.zeros(nb * nb, np.int32)
    grade = np.zeros(nb, np.int32)
    sign = np.zeros(nb * nb, np.float32)
    checks = [("i_of", i_of, alg.gp_pair_tables[0]),
              ("path", path, alg.gp_pair_paths),
              ("grade", grade, alg.blade_to_grade)]
    if kern.form == "pair":
        fn.argtypes = [_P, _P, _P, _P]
        fn.restype = None
        fn(i_of.ctypes.data, path.ctypes.data, grade.ctypes.data,
           sign.ctypes.data)
        checks.append(("sign", sign, alg.gp_pair_tables[1]))
    else:
        fn.argtypes = [_P, _P, _P]
        fn.restype = None
        fn(i_of.ctypes.data, path.ctypes.data, grade.ctypes.data)
    for name, got, want in checks:
        if not np.array_equal(got, np.asarray(want).reshape(-1)):
            raise RuntimeError(
                f"csrc/{source}.cu table {name} {got.tolist()} disagrees with "
                f"the algebra's {np.asarray(want).reshape(-1).tolist()}")
    bc = np.ascontiguousarray(alg._b_coeff, dtype=np.float32)
    sign = np.ascontiguousarray(alg.gp_pair_tables[1].reshape(-1),
                                dtype=np.float32)
    return bc, sign


@functools.lru_cache(maxsize=None)
def _pair_tabs(metric: tuple, device: torch.device, source: str,
               symbol: str) -> torch.Tensor:
    """The packed Cayley-pair tables of the pair kernels in
    csrc/{source}.cu (entry points prefixed ``symbol``, built by the host
    code of cemlp_pair.cuh after `_alg_tables` checked their structure) on
    ``device``; each CTA copies them to shared memory."""
    _alg_tables(metric, source, symbol)
    fn = getattr(_build.load(source), f"{symbol}_packed")
    fn.argtypes = [_P, _I]
    fn.restype = ctypes.c_int
    buf = np.zeros(8192, np.uint16)
    n = fn(buf.ctypes.data, buf.size)
    if n <= 0:
        raise RuntimeError(f"csrc/{source}.cu: packed tables do not fit")
    return torch.from_numpy(buf[:n].view(np.int16).copy()).to(device)


def check_block_params(params, cin: int, c: int, device,
                       kern: BlockKernel = DENSE) -> None:
    """Raises unless ``params`` are one block's 10 float32 tensors of the
    flax shapes for cin -> c channels on ``device`` in ``kern``'s algebra,
    with c within what its kernels take."""
    g, p = kern.n_grades, kern.n_paths
    shapes = [(c, cin, g), (c, 1), (c, g), (c, g), (c, p), (c, c, g),
              (c, g), (c, c, g), (c, 1), (c,)]
    for t, s in zip(params, shapes):
        if tuple(t.shape) != s or t.dtype != torch.float32 \
                or t.device != device:
            raise ValueError(f"block parameter of shape {tuple(t.shape)} "
                             f"{t.dtype}, expected {s} float32 on {device}")
    if kern.max_channels and c > kern.max_channels:
        raise NotImplementedError(
            f"{kern.label} (a warp's lanes hold a row's output channels) "
            f"take at most {kern.max_channels} output channels, got {c}")


def block_route(kern: BlockKernel, cin: int, c: int, backward: bool,
                exact: bool) -> Tuple[BlockKernel, int]:
    """(The kernels of one launch of ``kern``'s algebra at cin -> c, the
    launch's shared-memory bytes where they are ``kern``'s own, else 0):
    ``kern``'s own where their plan takes the widths in this direction
    and mode (``_smem``), else the wide kernels of the same form and
    algebra (K2w/K3w for the dense form, K2pw/K3pw for the pair form)
    where their library's ``smem_bytes`` entry takes them;
    NotImplementedError beyond, naming the range of the library's
    ``range`` entry."""
    try:
        return kern, _smem(kern, cin, c, backward, exact)
    except NotImplementedError:
        pass
    wide = WIDE_OF[kern.n_blades]
    if _wide_size(wide, "smem_bytes", cin, c, int(backward)):
        return wide, 0
    max_c, max_cin = _wide_range(wide)
    form = "dense" if kern.form == "dense" else "pair-form"
    raise NotImplementedError(
        f"{kern.label}: {cin} -> {c} channels; the {form} block kernels take "
        f"at most {max_c} output and {max_cin} input channels")


def _check_block(x, params, backward: bool, exact: bool):
    nb = x.shape[-1] if x.dim() == 3 else -1
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"x must be (rows, Cin, nb) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    kern = block_kernel(nb)
    if x.shape[0] > _build.MAX_COUNT:
        raise NotImplementedError(
            f"{kern.label}: {x.shape[0]} rows in one call; the kernels take "
            f"at most {_build.MAX_COUNT}")
    cin = x.shape[1]
    c = params[0].shape[0]
    kern, smem = block_route(kern, cin, c, backward, exact)
    check_block_params(params, cin, c, x.device, kern)
    return kern, cin, c, smem


def _grid(rows: int, device, smem_bytes: int, rows_per_cta: int,
          per_sm: int = 0) -> int:
    """CTAs to launch: every SM holds ``per_sm`` CTAs or, where 0, as many
    as its shared memory allows (at most 8), and each CTA walks over row
    tiles."""
    props = torch.cuda.get_device_properties(device)
    per_sm = per_sm or max(1, min(8, (228 * 1024) // max(smem_bytes, 1)))
    n_tiles = -(-rows // rows_per_cta)
    return max(1, min(n_tiles, props.multi_processor_count * per_sm))


# rows a CTA step of the dense form's fast-mode backward takes: TROWS of
# csrc/cemlp_tile.cuh
TILE_ROWS = 16
# (row, blade) pairs a CTA step of the pair form's fast-mode backward takes:
# PT_PAIRS of csrc/cemlp_pair_tile.cuh (4 rows at Cl(5), 8 at Cl(4)); and
# of its forward, PT_FWD_PAIRS of csrc/cemlp_pair_fwd_tile.cuh (8 and 16)
PAIR_TILE_PAIRS = 128
PAIR_FWD_TILE_PAIRS = 256


def _tiled(kern: BlockKernel, backward: bool, exact: bool) -> bool:
    """Whether the launch is a row tile kernel: every fast-mode launch of
    either form and direction (K2, K3, K2p, K3p); exact mode keeps the
    row kernels."""
    return not exact


def _tile_rows(kern: BlockKernel, backward: bool = True) -> int:
    """Rows a CTA step of the fast-mode row tile backward (or forward)
    takes."""
    if kern.form == "dense":
        return TILE_ROWS
    return (PAIR_TILE_PAIRS if backward else PAIR_FWD_TILE_PAIRS) \
        // kern.n_blades


def _smem(kern: BlockKernel, cin, c, backward, exact=True):
    """Shared-memory bytes of a launch; NotImplementedError where the
    library's entry gives 0: the widths do not fit in one CTA's 227 KB
    (or, for the fast-mode K3 and K3p, in their register tiles, or in a
    warp's lanes).  Fast mode asks the row tiles' entry of the direction,
    exact mode the row kernels'."""
    lib = _build.load(kern.source)
    if _tiled(kern, backward, exact):
        entry = "tile_smem_bytes" if backward else "fwd_tile_smem_bytes"
        fn = getattr(lib, f"{kern.symbol}_{entry}")
        args = (cin, c)
    else:
        fn = getattr(lib, f"{kern.symbol}_smem_bytes")
        args = (cin, c, int(backward))
    if fn.argtypes is None:
        fn.argtypes = [_I] * len(args)
        fn.restype = ctypes.c_size_t
    n = int(fn(*args))
    if n == 0:
        raise NotImplementedError(
            f"{kern.label}: {cin} -> {c} channels do not fit in one CTA "
            f"({'backward' if backward else 'forward'}, "
            f"{'exact' if exact else 'fast'} mode)")
    return n


@functools.lru_cache(maxsize=None)
def _fwd_tile_launch(kern: BlockKernel, cin: int, c: int) -> Tuple[int, int]:
    """(CTAs of the fast-mode dense K2's instance at cin -> c that one SM
    holds at once, the CUDA occupancy of its registers, shared memory and
    threads; bytes of its parameter image, the forward's scratch) from the
    library's entries; raises where no CTA fits."""
    lib = _build.load(kern.source)
    blocks = getattr(lib, f"{kern.symbol}_fwd_tile_blocks")
    plan = getattr(lib, f"{kern.symbol}_fwd_tile_plan")
    if blocks.argtypes is None:
        blocks.argtypes = [_I, _I]
        blocks.restype = ctypes.c_int
    if plan.argtypes is None:
        plan.argtypes = [_I, _I, ctypes.POINTER(_I)]
        plan.restype = ctypes.c_size_t
    info = (_I * 3)()
    n = int(blocks(cin, c))
    if n <= 0 or int(plan(cin, c, info)) == 0:
        raise RuntimeError(f"{kern.label}: the fast-mode forward at {cin} -> "
                           f"{c} channels fits no CTA on an SM")
    return n, int(info[2])


def _tables(kern: BlockKernel, alg, device) -> Tuple[np.ndarray, int]:
    """(bc host array, pointer to the kernel's table operand): the Cayley
    signs on the host for the dense form (K2/K3, K2w/K3w), the packed pair
    tables on the card for the pair form (K2p/K3p, K2pw/K3pw)."""
    metric = tuple(alg.metric.tolist())
    bc, sign = _alg_tables(metric, kern.source, kern.symbol)
    if kern.form == "pair":
        return bc, _pair_tabs(metric, device, kern.source,
                              kern.symbol).data_ptr()
    return bc, sign.ctypes.data


def block_forward(x: torch.Tensor, params: Sequence[torch.Tensor], alg,
                  exact: bool = True) -> torch.Tensor:
    """K2 (nb = 4 or 8) or K2p (nb = 16 or 32): one CEMLP block, (rows,
    Cin, nb) float32 -> (rows, C, nb)."""
    if not x.is_cuda:
        return block_forward_plain(x, params, alg, exact)
    kern, cin, c, smem = _check_block(x, params, False, exact)
    x = x.contiguous()
    params = [p.contiguous() for p in params]
    rows, nb = x.shape[0], kern.n_blades
    out = torch.empty((rows, c, nb), dtype=torch.float32, device=x.device)
    if rows == 0:
        return out
    if kern in _WIDE_KERNELS:
        return _wide_forward(kern, x, params, alg, exact, out)
    bc, tabs = _tables(kern, alg, x.device)
    tiled = _tiled(kern, False, exact)
    rows_cta = _tile_rows(kern, False) if tiled else kern.rows_fwd
    dense = kern.form == "dense"
    per_sm, img_bytes = _fwd_tile_launch(kern, cin, c) if tiled and dense \
        else (0, 0)
    grid = _grid(rows, x.device, smem, rows_cta, per_sm)
    ptrs = [x.data_ptr(), *[p.data_ptr() for p in params], bc.ctypes.data,
            tabs, out.data_ptr()]
    if dense:   # K2's scratch: the fast mode's parameter image (else empty)
        img = torch.empty(img_bytes, dtype=torch.uint8, device=x.device)
        ptrs.append(img.data_ptr())
    fn = _fn(f"{kern.symbol}_fwd", len(ptrs), 5, kern.source)
    err = fn(*ptrs, rows, cin, c, 0 if exact else 1, grid,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"{kern.label} forward kernel")
    kern.fwd.add()
    return out


def _split_grads(flat: torch.Tensor, params) -> List[torch.Tensor]:
    out, o = [], 0
    for p in params:
        n = p.numel()
        out.append(flat[o:o + n].view(p.shape))
        o += n
    return out


def _partial_floats(kern: BlockKernel, cin: int, c: int, n_grad: int,
                    exact: bool = True) -> int:
    """Floats of one CTA's slice of the backward's scratch: its partial
    gradient vector, and for K3p's exact-mode row kernel also its
    channel-mixing accumulators."""
    if kern.form != "pair" or _tiled(kern, True, exact):
        return n_grad
    fn = getattr(_build.load(kern.source), f"{kern.symbol}_partial_floats")
    fn.argtypes = [_I, _I]
    fn.restype = ctypes.c_longlong
    return int(fn(cin, c))


def block_backward(x: torch.Tensor, dout: torch.Tensor,
                   params: Sequence[torch.Tensor], alg, exact: bool = True
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """K3 (nb = 4 or 8) or K3p (nb = 16 or 32): dx and the 10 parameter
    gradients of one CEMLP block."""
    if not x.is_cuda:
        return block_backward_plain(x, dout, params, alg, exact)
    kern, cin, c, smem = _check_block(x, params, True, exact)
    x = x.contiguous()
    dout = dout.to(torch.float32).contiguous()
    params = [p.contiguous() for p in params]
    rows, nb = x.shape[0], kern.n_blades
    if dout.shape != (rows, c, nb):
        raise ValueError(f"dout shape {tuple(dout.shape)} != {(rows, c, nb)}")
    n_grad = sum(p.numel() for p in params)
    if kern in _WIDE_KERNELS:
        flat, dx = _wide_backward(kern, x, dout, params, alg, exact, n_grad)
    else:
        flat, dx = _dense_backward(kern, x, dout, params, alg, exact, n_grad,
                                   smem)
    grads = _split_grads(flat, params)
    # the kernel returns d/d sigmoid(normalization.a); chain to a
    s = torch.sigmoid(params[6])
    grads[6] = grads[6] * s * (1.0 - s)
    return dx, grads


def _dense_backward(kern, x, dout, params, alg, exact, n_grad, smem):
    """K3 (K3p) with its reduction, smem bytes a CTA: (the flat gradient
    vector, dx)."""
    rows, cin, c = x.shape[0], x.shape[1], params[0].shape[0]
    bc, tabs = _tables(kern, alg, x.device)
    rows_cta = _tile_rows(kern) if _tiled(kern, True, exact) \
        else kern.rows_bwd
    grid = _grid(rows, x.device, smem, rows_cta)
    dx = torch.empty_like(x)
    partials = torch.empty((grid, _partial_floats(kern, cin, c, n_grad,
                                                  exact)),
                           dtype=torch.float32, device=x.device)
    flat = torch.empty(n_grad, dtype=torch.float32, device=x.device)
    fn = _fn(f"{kern.symbol}_bwd", 17, 5, kern.source)
    err = fn(x.data_ptr(), dout.data_ptr(),
             *[p.data_ptr() for p in params], bc.ctypes.data, tabs,
             dx.data_ptr(), partials.data_ptr(), flat.data_ptr(), rows, cin,
             c, 0 if exact else 1, grid,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"{kern.label} backward kernel")
    kern.bwd.add()
    return flat, dx


def _wide_size(kern: BlockKernel, name: str, *args) -> int:
    """A size entry of K2w/K3w's or K2pw/K3pw's library (int arguments,
    long long)."""
    fn = getattr(_build.load(kern.source), f"{kern.symbol}_{name}")
    if fn.argtypes is None:
        fn.argtypes = [_I] * len(args)
        fn.restype = ctypes.c_longlong
    return int(fn(*args))


def _wide_range(kern: BlockKernel) -> Tuple[int, int]:
    """(The most output, the most input channels) K2w/K3w (K2pw/K3pw)
    take, from their library's range entry."""
    fn = getattr(_build.load(kern.source), f"{kern.symbol}_range")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_I)]
        fn.restype = None
    out = (_I * 2)()
    fn(out)
    return out[0], out[1]


def _wide_rows(kern: BlockKernel, cin: int, c: int, backward: bool) -> int:
    """Rows a CTA step takes: K2w/K3w's csrc constant; for K2pw/K3pw a row
    a member (NB lanes) of the warps their library's entry gives."""
    if kern.form == "dense":
        return kern.rows_bwd if backward else kern.rows_fwd
    return (_wide_size(kern, "warps", cin, c, int(backward))
            * (32 // kern.n_blades))


def _wide_forward(kern, x, params, alg, exact, out):
    """K2w (K2pw): the parameter image, then the row steps."""
    rows, cin, c = x.shape[0], x.shape[1], out.shape[1]
    bc, tabs = _tables(kern, alg, x.device)
    img = torch.empty(_wide_size(kern, "img_floats", cin, c, 0),
                      dtype=torch.float32, device=x.device)
    grid = _grid(rows, x.device, _wide_size(kern, "smem_bytes", cin, c, 0),
                 _wide_rows(kern, cin, c, False))
    ptrs = [x.data_ptr(), *[p.data_ptr() for p in params], bc.ctypes.data,
            tabs, out.data_ptr(), img.data_ptr()]
    fn = _fn(f"{kern.symbol}_fwd", len(ptrs), 5, kern.source)
    err = fn(*ptrs, rows, cin, c, 0 if exact else 1, grid,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"{kern.label} forward kernel")
    kern.fwd.add()
    return out


def _wide_backward(kern, x, dout, params, alg, exact, n_grad):
    """K3w (K3pw): the parameter image, the row steps (dx, the cotangent
    rows, the per-channel partials), the weight gradients over the rows
    (and for K3pw the path weights'), and the reduction of every kind of
    partials: (the flat gradients, dx)."""
    rows, cin, nb = x.shape
    c = params[0].shape[0]
    dev = x.device
    pair = kern.form == "pair"
    bc, tabs = _tables(kern, alg, dev)
    nrow = _wide_rows(kern, cin, c, True)
    grid = _grid(rows, dev, _wide_size(kern, "smem_bytes", cin, c, 1), nrow)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = _wide_size(kern, "wgrad_splits", rows, cin, c, sms)
    f32 = dict(dtype=torch.float32, device=dev)
    img = torch.empty(_wide_size(kern, "img_floats", cin, c, 1), **f32)
    # the cotangent rows z, d(y), d(yr), d(first), and the pair form's yn
    scratch = torch.empty((5 if pair else 4) * rows * c * nb, **f32)
    lpart = torch.empty(grid * nrow * _wide_size(kern, "loc_floats", c),
                        **f32)
    wpart = torch.empty(splits * _wide_size(kern, "wpart_floats", cin, c),
                        **f32)
    flat = torch.empty(n_grad, **f32)
    dx = torch.empty_like(x)
    ptrs = [x.data_ptr(), dout.data_ptr(), *[p.data_ptr() for p in params],
            bc.ctypes.data, tabs, dx.data_ptr(), img.data_ptr(),
            scratch.data_ptr(), lpart.data_ptr(), wpart.data_ptr()]
    ints = [rows, cin, c, 0 if exact else 1, grid, splits]
    if pair:
        psplits = _wide_size(kern, "pgrad_splits", rows, c, sms)
        ppart = torch.empty(psplits * c * kern.n_paths, **f32)
        ptrs.append(ppart.data_ptr())
        ints.append(psplits)
    ptrs.append(flat.data_ptr())
    fn = _fn(f"{kern.symbol}_bwd", len(ptrs), len(ints), kern.source)
    err = fn(*ptrs, *ints, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"{kern.label} backward kernels")
    kern.bwd.add()
    return flat, dx


class _Block(torch.autograd.Function):
    """One CEMLP block whose forward is K2 (K2p) and backward K3 (K3p)."""

    @staticmethod
    def forward(ctx, x, alg, exact, *params):
        ctx.alg, ctx.exact = alg, exact
        ctx.save_for_backward(x, *params)
        return block_forward(x, params, alg, exact)

    @staticmethod
    def backward(ctx, dout):
        x, *params = ctx.saved_tensors
        dx, grads = block_backward(x, dout, params, ctx.alg, ctx.exact)
        return (dx, None, None, *grads)


def apply_fused_cemlp(cemlp, x: torch.Tensor) -> torch.Tensor:
    """A whole CEMLP, one K2 (K2p at Cl(4) and Cl(5)) launch per block
    forward and one K3 (K3p) launch per block backward, at Cl(2), Cl(3),
    Cl(4) or Cl(5).  x: (..., C_in, nb) -> (..., C_out, nb), in x's dtype
    (the blocks compute in float32)."""
    from .segment import aggregation_exact

    exact = aggregation_exact()
    lead = x.shape[:-2]
    rows = int(np.prod(lead)) if lead else 1
    h = x.reshape(rows, x.shape[-2], x.shape[-1]).to(torch.float32)
    for i in range(cemlp.n_layers):
        h = _Block.apply(h, cemlp.algebra, exact, *block_params(cemlp, i))
    return h.reshape(*lead, h.shape[1], h.shape[2]).to(x.dtype)
