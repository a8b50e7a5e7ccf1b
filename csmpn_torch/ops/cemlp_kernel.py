"""K2 and K3 — one whole CEMLP block, forward and backward: CUDA kernel
wrappers, their plain versions, and the autograd wiring.

Port of ``csmpn_tpu/ops/cemlp_kernel.py`` (``apply_fused_cemlp``).  The
kernels are ``csrc/cemlp.cu`` (Cl(3,0), the dense algebra of the motion
task, output width <= 32 channels).  On a CUDA tensor the wrappers launch
them (or raise); on a CPU tensor they compute the plain versions:

  * ``block_forward_plain`` — the block in PyTorch, written per grade
    (the same function as ``_post_linear_math`` and the composed layers);
  * the plain K3 is ``torch.autograd.grad`` of the plain K2, so the
    hand-derived backward of the kernel is checked independently.

The block's parameters are taken in their flax shapes, in this order:
``linear.weight (C, Cin, 4), linear.bias (C, 1), silu.a (C, 4),
silu.b (C, 4), gp.weight (C, P), gp.linear_right.weight (C, C, 4),
gp.normalization.a (C, 4), gp.linear_left.weight (C, C, 4),
gp.linear_left.bias (C, 1), norm.a (C,)``.

``exact=False`` (fast mode) rounds to bf16 the operands of every product
the TPU kernel feeds its matrix unit and accumulates in fp32.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import _build

EPS = 1e-6
SQRT2_INV = 1.0 / math.sqrt(2.0)
MAX_CHANNELS = 32     # a warp's lanes are a row's output channels
ROWS_PER_CTA = 8      # ROWS in csrc/cemlp.cu

FWD_LAUNCHES = _build.LaunchCounter("cemlp_block_fwd")
BWD_LAUNCHES = _build.LaunchCounter("cemlp_block_bwd")

_P = ctypes.c_void_p
_I = ctypes.c_int


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
    cw = coeff * r(gw)[:, path]                         # (C, nb, nb) [n,j,k]
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

def _fn(name, nargs_ptr, nargs_int):
    lib = _build.load("cemlp")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [_P] * nargs_ptr + [_I] * nargs_int + [_P]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _alg_tables(metric: tuple, source: str = "cemlp"):
    """(bc, sign) host arrays for the kernels, after checking that the
    algebra's structure is the one compiled into csrc/{source}.cu."""
    from ..algebra.clifford import get_algebra

    alg = get_algebra(metric)
    if alg.n_blades != 8 or alg.n_product_paths != 20:
        raise NotImplementedError(
            f"the CEMLP kernels are compiled for 3-dim algebras "
            f"(8 blades), got metric {metric}")
    lib = _build.load(source)
    fn = getattr(lib, f"csmpn_{source}_tables")
    fn.argtypes = [_P, _P, _P]
    fn.restype = None
    i_of = np.zeros(64, np.int32)
    path = np.zeros(64, np.int32)
    grade = np.zeros(8, np.int32)
    fn(i_of.ctypes.data, path.ctypes.data, grade.ctypes.data)
    for name, got, want in (("i_of", i_of, alg.gp_pair_tables[0]),
                            ("path", path, alg.gp_pair_paths),
                            ("grade", grade, alg.blade_to_grade)):
        if not np.array_equal(got, np.asarray(want).reshape(-1)):
            raise RuntimeError(
                f"csrc/{source}.cu table {name} {got.tolist()} disagrees with "
                f"the algebra's {np.asarray(want).reshape(-1).tolist()}")
    bc = np.ascontiguousarray(alg._b_coeff, dtype=np.float32)
    sign = np.ascontiguousarray(alg.gp_pair_tables[1].reshape(-1),
                                dtype=np.float32)
    return bc, sign


def check_block_params(params, cin: int, c: int, device) -> None:
    """Raises unless ``params`` are one block's 10 float32 tensors of the
    flax shapes for cin -> c channels on ``device``, with c within what the
    kernels take."""
    shapes = [(c, cin, 4), (c, 1), (c, 4), (c, 4), (c, 20), (c, c, 4),
              (c, 4), (c, c, 4), (c, 1), (c,)]
    for p, s in zip(params, shapes):
        if tuple(p.shape) != s or p.dtype != torch.float32 \
                or p.device != device:
            raise ValueError(f"block parameter of shape {tuple(p.shape)} "
                             f"{p.dtype}, expected {s} float32 on {device}")
    if c > MAX_CHANNELS:
        raise NotImplementedError(
            f"the CEMLP kernels take at most {MAX_CHANNELS} output "
            f"channels, got {c}")


def _check_block(x, params):
    if x.dtype != torch.float32 or x.dim() != 3 or x.shape[2] != 8:
        raise ValueError(f"x must be (rows, Cin, 8) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    cin = x.shape[1]
    c = params[0].shape[0]
    check_block_params(params, cin, c, x.device)
    return cin, c


def _grid(rows: int, device, smem_bytes: int) -> int:
    """CTAs to launch: every SM holds as many CTAs as its shared memory
    allows (at most 8), and each CTA walks over row tiles."""
    props = torch.cuda.get_device_properties(device)
    per_sm = max(1, min(8, (228 * 1024) // max(smem_bytes, 1)))
    n_tiles = -(-rows // ROWS_PER_CTA)
    return max(1, min(n_tiles, props.multi_processor_count * per_sm))


def _smem(cin, c, backward):
    fn = _build.load("cemlp").csmpn_cemlp_smem_bytes
    if fn.argtypes is None:
        fn.argtypes = [_I, _I, _I]
        fn.restype = ctypes.c_size_t
    return int(fn(cin, c, int(backward)))


def block_forward(x: torch.Tensor, params: Sequence[torch.Tensor], alg,
                  exact: bool = True) -> torch.Tensor:
    """K2: one CEMLP block, (rows, Cin, 8) float32 -> (rows, C, 8)."""
    if not x.is_cuda:
        return block_forward_plain(x, params, alg, exact)
    x = x.contiguous()
    params = [p.contiguous() for p in params]
    cin, c = _check_block(x, params)
    rows = x.shape[0]
    bc, sign = _alg_tables(tuple(alg.metric.tolist()))
    out = torch.empty((rows, c, 8), dtype=torch.float32, device=x.device)
    if rows == 0:
        return out
    grid = _grid(rows, x.device, _smem(cin, c, False))
    fn = _fn("csmpn_cemlp_fwd", 14, 5)
    err = fn(x.data_ptr(), *[p.data_ptr() for p in params],
             bc.ctypes.data, sign.ctypes.data, out.data_ptr(), rows, cin, c,
             0 if exact else 1, grid,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "cemlp forward kernel")
    FWD_LAUNCHES.add()
    return out


def _split_grads(flat: torch.Tensor, params) -> List[torch.Tensor]:
    out, o = [], 0
    for p in params:
        n = p.numel()
        out.append(flat[o:o + n].view(p.shape))
        o += n
    return out


def block_backward(x: torch.Tensor, dout: torch.Tensor,
                   params: Sequence[torch.Tensor], alg, exact: bool = True
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """K3: dx and the 10 parameter gradients of one CEMLP block."""
    if not x.is_cuda:
        return block_backward_plain(x, dout, params, alg, exact)
    x = x.contiguous()
    dout = dout.to(torch.float32).contiguous()
    params = [p.contiguous() for p in params]
    cin, c = _check_block(x, params)
    rows = x.shape[0]
    if dout.shape != (rows, c, 8):
        raise ValueError(f"dout shape {tuple(dout.shape)} != {(rows, c, 8)}")
    bc, sign = _alg_tables(tuple(alg.metric.tolist()))
    n_grad = sum(p.numel() for p in params)
    grid = _grid(rows, x.device, _smem(cin, c, True))
    dx = torch.empty_like(x)
    partials = torch.empty((grid, n_grad), dtype=torch.float32,
                           device=x.device)
    flat = torch.empty(n_grad, dtype=torch.float32, device=x.device)
    fn = _fn("csmpn_cemlp_bwd", 17, 5)
    err = fn(x.data_ptr(), dout.data_ptr(),
             *[p.data_ptr() for p in params], bc.ctypes.data,
             sign.ctypes.data, dx.data_ptr(), partials.data_ptr(),
             flat.data_ptr(), rows, cin, c, 0 if exact else 1, grid,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "cemlp backward kernel")
    BWD_LAUNCHES.add()
    grads = _split_grads(flat, params)
    # the kernel returns d/d sigmoid(normalization.a); chain to a
    s = torch.sigmoid(params[6])
    grads[6] = grads[6] * s * (1.0 - s)
    return dx, grads


class _Block(torch.autograd.Function):
    """One CEMLP block whose forward is K2 and backward is K3."""

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
    """A whole CEMLP, one K2 launch per block forward and one K3 launch per
    block backward.  x: (..., C_in, nb) -> (..., C_out, nb), in x's dtype
    (the blocks compute in float32)."""
    from .segment import aggregation_exact

    exact = aggregation_exact()
    lead = x.shape[:-2]
    rows = int(np.prod(lead)) if lead else 1
    h = x.reshape(rows, x.shape[-2], x.shape[-1]).to(torch.float32)
    for i in range(cemlp.n_layers):
        h = _Block.apply(h, cemlp.algebra, exact, *block_params(cemlp, i))
    return h.reshape(*lead, h.shape[1], h.shape[2]).to(x.dtype)
