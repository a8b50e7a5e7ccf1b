"""K2/K3 and K2p/K3p — one whole CEMLP block, forward and backward: CUDA
kernel wrappers, their plain versions, and the autograd wiring.

Port of ``csmpn_tpu/ops/cemlp_kernel.py`` (``apply_fused_cemlp``), in its
two forms:

  * dense, nb = 8 and nb = 4: K2/K3 in ``csrc/cemlp.cu``, compiled for
    Cl(3,0) (the motion and MD17 tasks, output width <= 32 channels) and
    for Cl(2,0) (the NBA task, output width <= 64 channels: a lane holds
    two 4-blade channels);
  * pair, nb = 32: K2p/K3p in ``csrc/cemlp_pair.cu`` (Cl(5,0), the hulls
    task), where the weighted geometric product runs over the Cayley
    pairs (one left blade and one sign per (output j, right k)).

Cl(4) (nb = 16), which the reference's pair form also serves, has no
kernel yet and raises.  Widths whose block does not fit in one CTA's
shared memory raise too.  On a CUDA tensor the wrappers launch the kernels
(or raise); on a CPU tensor they compute the plain versions:

  * ``block_forward_plain`` — the block in PyTorch, written per grade
    (the same function as ``_post_linear_math`` and the composed layers);
  * the plain K3/K3p is ``torch.autograd.grad`` of the plain K2/K2p, so
    the hand-derived backward of the kernel is checked independently.

The block's parameters are taken in their flax shapes, in this order:
``linear.weight (C, Cin, G), linear.bias (C, 1), silu.a (C, G),
silu.b (C, G), gp.weight (C, P), gp.linear_right.weight (C, C, G),
gp.normalization.a (C, G), gp.linear_left.weight (C, C, G),
gp.linear_left.bias (C, 1), norm.a (C,)`` with G grades and P nonzero
grade paths (3 and 10 at Cl(2), 4 and 20 at Cl(3), 6 and 56 at Cl(5)).

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
    rows_fwd: int         # rows per CTA tile (csrc constants)
    rows_bwd: int
    fwd: _build.LaunchCounter
    bwd: _build.LaunchCounter


DENSE = BlockKernel("K2/K3", "cemlp", "csmpn_cemlp", "Cl(3) (8 blades)", 8,
                    4, 20, 32, 8, 8, FWD_LAUNCHES, BWD_LAUNCHES)
DENSE_CL2 = BlockKernel("K2/K3 at Cl(2)", "cemlp", "csmpn_cemlp_cl2",
                        "Cl(2) (4 blades)", 4, 3, 10, 64, 8, 8,
                        CL2_FWD_LAUNCHES, CL2_BWD_LAUNCHES)
PAIR = BlockKernel("K2p/K3p", "cemlp_pair", "csmpn_cemlp_pair",
                   "Cl(5,0) (32 blades)", 32, 6, 56, 0, 8, 4,
                   PAIR_FWD_LAUNCHES, PAIR_BWD_LAUNCHES)


def block_kernel(nb: int) -> BlockKernel:
    """The block kernels for nb blades, or NotImplementedError."""
    for k in (DENSE_CL2, DENSE, PAIR):
        if k.n_blades == nb:
            return k
    raise NotImplementedError(
        f"no CEMLP block kernel for {nb} blades: K2/K3 take 2- and 3-dim "
        f"algebras (4 and 8 blades), K2p/K3p Cl(5,0) (32 blades); Cl(4) "
        f"(16 blades) is still to port (ROADMAP Queue 2)")


def _rounder(exact: bool):
    if exact:
        return lambda t: t
    return lambda t: t.to(torch.bfloat16).to(torch.float32)


def block_params(cemlp, i: int) -> List[torch.Tensor]:
    """The 10 parameter tensors of block ``i`` of a CEMLP module."""
    lin = getattr(cemlp, f"linear_{i}")
    silu = getattr(cemlp, f"silu_{i}")
    gp = getattr(cemlp, f"gp_{i}")
    ln = getattr(cemlp, f"norm_{i}")
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
def _alg_tables(metric: tuple, source: str = ""):
    """(bc, sign) host arrays for the kernels, after checking that the
    algebra's structure is the one compiled into the block kernels of its
    blade count (or into csrc/{source}.cu, which includes their device
    code): the left blade and the grade path of every Cayley pair (j, k),
    the grade of every blade and, for the pair kernels, which compute it,
    the pair's sign."""
    from ..algebra.clifford import get_algebra

    alg = get_algebra(metric)
    kern = block_kernel(alg.n_blades)
    nb = kern.n_blades
    source = source or kern.source
    if alg.n_product_paths != kern.n_paths:
        raise NotImplementedError(
            f"csrc/{source}.cu is compiled for {kern.algebra} with "
            f"{kern.n_paths} grade paths, got metric {metric}")
    symbol = kern.symbol if source == kern.source else f"csmpn_{source}"
    lib = _build.load(source)
    fn = getattr(lib, f"{symbol}_tables")
    i_of = np.zeros(nb * nb, np.int32)
    path = np.zeros(nb * nb, np.int32)
    grade = np.zeros(nb, np.int32)
    sign = np.zeros(nb * nb, np.float32)
    checks = [("i_of", i_of, alg.gp_pair_tables[0]),
              ("path", path, alg.gp_pair_paths),
              ("grade", grade, alg.blade_to_grade)]
    if kern is PAIR:
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
def _pair_tabs(metric: tuple, device: torch.device) -> torch.Tensor:
    """The pair kernels' packed Cayley-pair tables (built by
    csrc/cemlp_pair.cu's host code, after `_alg_tables` checked its
    structure) on ``device``; each CTA copies them to shared memory."""
    _alg_tables(metric)
    fn = _build.load("cemlp_pair").csmpn_cemlp_pair_packed
    fn.argtypes = [_P, _I]
    fn.restype = ctypes.c_int
    buf = np.zeros(8192, np.uint16)
    n = fn(buf.ctypes.data, buf.size)
    if n <= 0:
        raise RuntimeError("csrc/cemlp_pair.cu: packed tables do not fit")
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


def _check_block(x, params):
    nb = x.shape[-1] if x.dim() == 3 else -1
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"x must be (rows, Cin, nb) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    kern = block_kernel(nb)
    cin = x.shape[1]
    c = params[0].shape[0]
    check_block_params(params, cin, c, x.device, kern)
    return kern, cin, c


def _grid(rows: int, device, smem_bytes: int, rows_per_cta: int) -> int:
    """CTAs to launch: every SM holds as many CTAs as its shared memory
    allows (at most 8), and each CTA walks over row tiles."""
    props = torch.cuda.get_device_properties(device)
    per_sm = max(1, min(8, (228 * 1024) // max(smem_bytes, 1)))
    n_tiles = -(-rows // rows_per_cta)
    return max(1, min(n_tiles, props.multi_processor_count * per_sm))


def _smem(kern: BlockKernel, cin, c, backward):
    """Shared-memory bytes of a launch; NotImplementedError where the
    widths do not fit in one CTA's 227 KB."""
    fn = getattr(_build.load(kern.source), f"{kern.symbol}_smem_bytes")
    if fn.argtypes is None:
        fn.argtypes = [_I, _I, _I]
        fn.restype = ctypes.c_size_t
    n = int(fn(cin, c, int(backward)))
    if n == 0:
        raise NotImplementedError(
            f"{kern.label}: {cin} -> {c} channels do not fit in one CTA's "
            f"shared memory ({'backward' if backward else 'forward'})")
    return n


def _tables(kern: BlockKernel, alg, device) -> Tuple[np.ndarray, int]:
    """(bc host array, pointer to the kernel's table operand): the Cayley
    signs on the host for K2/K3, the packed pair tables on the card for
    K2p/K3p."""
    metric = tuple(alg.metric.tolist())
    bc, sign = _alg_tables(metric)
    if kern is PAIR:
        return bc, _pair_tabs(metric, device).data_ptr()
    return bc, sign.ctypes.data


def block_forward(x: torch.Tensor, params: Sequence[torch.Tensor], alg,
                  exact: bool = True) -> torch.Tensor:
    """K2 (nb = 4 or 8) or K2p (nb = 32): one CEMLP block, (rows, Cin, nb)
    float32 -> (rows, C, nb)."""
    if not x.is_cuda:
        return block_forward_plain(x, params, alg, exact)
    x = x.contiguous()
    params = [p.contiguous() for p in params]
    kern, cin, c = _check_block(x, params)
    rows, nb = x.shape[0], kern.n_blades
    out = torch.empty((rows, c, nb), dtype=torch.float32, device=x.device)
    if rows == 0:
        return out
    bc, tabs = _tables(kern, alg, x.device)
    grid = _grid(rows, x.device, _smem(kern, cin, c, False), kern.rows_fwd)
    fn = _fn(f"{kern.symbol}_fwd", 14, 5, kern.source)
    err = fn(x.data_ptr(), *[p.data_ptr() for p in params],
             bc.ctypes.data, tabs, out.data_ptr(), rows, cin, c,
             0 if exact else 1, grid,
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


def _partial_floats(kern: BlockKernel, cin: int, c: int, n_grad: int) -> int:
    """Floats of one CTA's slice of the backward's scratch: its partial
    gradient vector, and for K3p also its channel-mixing accumulators."""
    if kern is not PAIR:
        return n_grad
    fn = _build.load(kern.source).csmpn_cemlp_pair_partial_floats
    fn.argtypes = [_I, _I]
    fn.restype = ctypes.c_longlong
    return int(fn(cin, c))


def block_backward(x: torch.Tensor, dout: torch.Tensor,
                   params: Sequence[torch.Tensor], alg, exact: bool = True
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """K3 (nb = 4 or 8) or K3p (nb = 32): dx and the 10 parameter gradients
    of one CEMLP block."""
    if not x.is_cuda:
        return block_backward_plain(x, dout, params, alg, exact)
    x = x.contiguous()
    dout = dout.to(torch.float32).contiguous()
    params = [p.contiguous() for p in params]
    kern, cin, c = _check_block(x, params)
    rows, nb = x.shape[0], kern.n_blades
    if dout.shape != (rows, c, nb):
        raise ValueError(f"dout shape {tuple(dout.shape)} != {(rows, c, nb)}")
    bc, tabs = _tables(kern, alg, x.device)
    n_grad = sum(p.numel() for p in params)
    grid = _grid(rows, x.device, _smem(kern, cin, c, True), kern.rows_bwd)
    dx = torch.empty_like(x)
    partials = torch.empty((grid, _partial_floats(kern, cin, c, n_grad)),
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
    grads = _split_grads(flat, params)
    # the kernel returns d/d sigmoid(normalization.a); chain to a
    s = torch.sigmoid(params[6])
    grads[6] = grads[6] * s * (1.0 - s)
    return dx, grads


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
    """A whole CEMLP, one K2 (K2p at Cl(5)) launch per block forward and one
    K3 (K3p) launch per block backward, at Cl(2), Cl(3) or Cl(5).  x: (..., C_in, nb) -> (..., C_out, nb), in x's dtype
    (the blocks compute in float32)."""
    from .segment import aggregation_exact

    exact = aggregation_exact()
    lead = x.shape[:-2]
    rows = int(np.prod(lead)) if lead else 1
    h = x.reshape(rows, x.shape[-2], x.shape[-1]).to(torch.float32)
    for i in range(cemlp.n_layers):
        h = _Block.apply(h, cemlp.algebra, exact, *block_params(cemlp, i))
    return h.reshape(*lead, h.shape[1], h.shape[2]).to(x.dtype)
