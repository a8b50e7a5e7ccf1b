"""K4 and K5 — the EGCL edge side in one pass, forward and backward: CUDA
kernel wrappers, their plain versions, the autograd wiring and the
dispatch.

Port of ``csmpn_tpu/ops/fused_egcl.py``.  For a 2-block edge CEMLP whose
hidden width equals its output width,

    agg = reduce_dst(CEMLP_2(CEMLP_1([h[dst] - hj, attr])))

with ``dst`` sorted ascending, ``hj`` the pre-gathered source rows (their
cotangent flows back through the caller's gather), masked edges
contributing nothing, and the mean taken outside the kernel with the
masked in-degree (an empty segment gives 0).  The kernels are
``csrc/fused_egcl.cu``: K4 computes the sum without writing a message to
device memory; K5 recomputes both blocks and returns d(h), d(hj), d(attr)
and the 20 parameter gradients in one pass (the TPU kernel's 21 tables:
its block-1 input linear is split over message and attribute lanes; here
the message and the attributes are one input row, so it is one tensor of
the flax shape (C, Cm + Ca, 4)).

On a CUDA tensor the wrappers launch the kernels (or raise); on a CPU
tensor they compute the plain versions:

  * ``message_aggregate_plain`` — the same function in PyTorch, from
    ``block_forward_plain`` (ops/cemlp_kernel.py) twice;
  * the plain K5 is ``torch.autograd.grad`` of it, so the hand-derived
    backward of the kernel is checked independently.

``exact=False`` (fast mode) streams h, hj and attr as bf16, rounds the
operands of every product as K2 does, rounds each message row to bf16
before the sum and d(agg) before the backward, and accumulates in fp32.

The TPU kernel's one-hot window matrix products and their band switch
``CSMPN_ONEHOT_BANDS`` are a device of the TPU's matrix unit: on the card
the target gather is an indexed load and the reduce a sum in shared
memory, so the switch has no counterpart.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from . import _build
from .cemlp_kernel import (
    _alg_tables,
    _rounder,
    block_forward_plain,
    block_params,
    check_block_params,
)

FWD_LAUNCHES = _build.LaunchCounter("fused_mp_fwd")
BWD_LAUNCHES = _build.LaunchCounter("fused_mp_bwd")

WN = 32                 # target nodes per CTA window
NLOC = 35              # per-channel gradient rows, as in cemlp_block.cuh
MAX_SMEM = 232448       # 227 KB opt-in per block (kMaxSmem there)

_P = ctypes.c_void_p
_I = ctypes.c_int


# ------------------------------------------------------------ plain version

def message_aggregate_plain(params: Sequence[torch.Tensor], alg,
                            h: torch.Tensor, hj: torch.Tensor,
                            attr: Optional[torch.Tensor], dst: torch.Tensor,
                            mask: Optional[torch.Tensor] = None,
                            mean: bool = False,
                            exact: bool = True) -> torch.Tensor:
    """The edge side in PyTorch: (N, C, 8) float32.  ``params`` are the 20
    block parameters of the edge CEMLP (block 0, then block 1)."""
    r = _rounder(exact)
    n = h.shape[0]
    idx = dst.long()
    x = r(h.float()).index_select(0, idx) - r(hj.float())
    if attr is not None:
        x = torch.cat([x, r(attr.float())], dim=1)
    out = block_forward_plain(x, params[:10], alg, exact)
    msg = r(block_forward_plain(out, params[10:], alg, exact))
    keep = (torch.ones(idx.shape, dtype=torch.float32, device=h.device)
            if mask is None else mask.to(torch.float32))
    msg = msg * keep[:, None, None]
    agg = msg.new_zeros((n,) + tuple(msg.shape[1:])).index_add_(0, idx, msg)
    if mean:
        counts = keep.new_zeros(n).index_add_(0, idx, keep)
        agg = agg / torch.clamp(counts, min=1.0)[:, None, None]
    return agg


def message_aggregate_grad_plain(params, alg, h, hj, attr, dst, mask, dagg,
                                 exact: bool = True):
    """Plain K5: autograd of the plain sum.  Returns (dh, dhj, dattr or
    None, the 20 parameter gradients)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               for t in (h, hj) + ((attr,) if attr is not None else ())]
        ps = [p.detach().requires_grad_(True) for p in params]
        out = message_aggregate_plain(
            ps, alg, ins[0], ins[1], ins[2] if attr is not None else None,
            dst, mask, False, exact)
        grads = torch.autograd.grad(out, ins + ps, dagg)
    n_in = len(ins)
    dattr = grads[2] if attr is not None else None
    return grads[0], grads[1], dattr, list(grads[n_in:])


# ------------------------------------------------------------ CUDA wrappers

def _lib_fn(name: str, argtypes, restype=ctypes.c_int):
    fn = getattr(_build.load("fused_egcl"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


@functools.lru_cache(maxsize=None)
def _check_smem(cm: int, ca: int, c: int) -> None:
    """Raise unless the forward and backward fit in shared memory at WN."""
    fn = _lib_fn("csmpn_fused_mp_smem_bytes", [_I, _I, _I, _I, _I],
                 ctypes.c_size_t)
    sizes = [int(fn(cm, ca, c, WN, b)) for b in (0, 1)]
    if not 0 < max(sizes) <= MAX_SMEM:
        raise NotImplementedError(
            f"the fused message-passing kernels do not fit in shared memory "
            f"at {cm} message + {ca} attribute -> {c} channels")


@dataclass
class _Plan:
    """Window layout of one call, shared by its forward and backward."""
    n_win: int
    bounds: torch.Tensor          # (n_win + 1,) int64 window edge offsets
    dst: torch.Tensor             # (E,) int32
    mask: Optional[torch.Tensor]  # (E,) uint8 view of the bool mask
    grid: int


def window_bounds(dst: torch.Tensor, n_nodes: int, wn: int) -> torch.Tensor:
    """bounds[w] = first edge whose target is >= w * wn (dst ascending)."""
    n_win = -(-n_nodes // wn)
    starts = torch.arange(n_win + 1, device=dst.device, dtype=dst.dtype) * wn
    return torch.searchsorted(dst, starts, side="left")


def make_plan(dst, mask, n_nodes: int, cm: int, ca: int, c: int) -> _Plan:
    """The window layout of a call on the card (dst on the card)."""
    _check_smem(cm, ca, c)
    dst32 = dst.to(torch.int32).contiguous()
    bounds = window_bounds(dst32, n_nodes, WN).to(torch.int64).contiguous()
    n_win = bounds.shape[0] - 1
    m = (mask.to(torch.bool).contiguous().view(torch.uint8)
         if mask is not None else None)
    props = torch.cuda.get_device_properties(dst.device)
    grid = max(1, min(n_win, props.multi_processor_count))
    return _Plan(n_win, bounds, dst32, m, grid)


def _check(params, h, hj, attr, dst, mask):
    if h.dim() != 3 or h.shape[2] != 8 or hj.dim() != 3 \
            or hj.shape[1:] != h.shape[1:]:
        raise ValueError(f"h (N, Cm, 8) and hj (E, Cm, 8) expected, got "
                         f"{tuple(h.shape)} and {tuple(hj.shape)}")
    e, cm = hj.shape[0], h.shape[1]
    ca = 0 if attr is None else attr.shape[1]
    if attr is not None and (attr.shape != (e, ca, 8)
                             or attr.device != h.device):
        raise ValueError(f"attr (E, Ca, 8) expected, got {tuple(attr.shape)}")
    if dst.shape != (e,) or hj.device != h.device or dst.device != h.device:
        raise ValueError("dst (E,) and hj must lie on h's device")
    if mask is not None and (mask.shape != (e,) or mask.device != h.device):
        raise ValueError("mask (E,) must lie on h's device")
    if len(params) != 20:
        raise ValueError(f"20 block parameters expected, got {len(params)}")
    c = params[0].shape[0]
    check_block_params(params[:10], cm + ca, c, h.device)
    check_block_params(params[10:], c, c, h.device)
    return e, cm, ca, c


def _stream(t: Optional[torch.Tensor], exact: bool):
    if t is None:
        return None
    return t.to(torch.float32 if exact else torch.bfloat16).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _param_ptrs(params):
    return (ctypes.c_void_p * 20)(*[p.data_ptr() for p in params])


def mp_forward(params: Sequence[torch.Tensor], alg, h, hj, attr, dst,
               mask=None, exact: bool = True,
               plan: Optional[_Plan] = None) -> torch.Tensor:
    """K4: the sum over unmasked edges, (N, C, 8) float32."""
    if not h.is_cuda:
        return message_aggregate_plain(params, alg, h, hj, attr, dst, mask,
                                       False, exact)
    params = [p.contiguous() for p in params]
    e, cm, ca, c = _check(params, h, hj, attr, dst, mask)
    n = h.shape[0]
    if plan is None:
        plan = make_plan(dst, mask, n, cm, ca, c)
    bc, sign = _alg_tables(tuple(alg.metric.tolist()), "fused_egcl")
    h_s, hj_s, attr_s = (_stream(t, exact) for t in (h, hj, attr))
    out = torch.empty((n, c, 8), dtype=torch.float32, device=h.device)
    if n == 0:
        return out
    fn = _lib_fn("csmpn_fused_mp_fwd", [_P] * 10 + [_I] * 8 + [_P])
    err = fn(h_s.data_ptr(), hj_s.data_ptr(), _ptr(attr_s),
             plan.dst.data_ptr(), _ptr(plan.mask), plan.bounds.data_ptr(),
             _param_ptrs(params), bc.ctypes.data, sign.ctypes.data,
             out.data_ptr(), n, cm, ca, c, WN, plan.n_win,
             0 if exact else 1, plan.grid,
             torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(err, "fused message-passing forward kernel")
    FWD_LAUNCHES.add()
    return out


def _block_grads(v: torch.Tensor, cin: int, c: int, na: torch.Tensor
                 ) -> List[torch.Tensor]:
    """One block's slice of the summed partial vector -> its 10 gradients
    in flax shapes (layout in csrc/fused_egcl.cu)."""
    sizes = [cin * 4 * c, c * 4 * c, c * 4 * c, NLOC * c]
    aw1, awr, awl, loc = torch.split(v, sizes)

    def mix(t, m):   # [(m*4+g)*C + n] -> (C, m, 4)
        return t.view(m, 4, c).permute(2, 0, 1).contiguous()

    loc = loc.view(NLOC, c)
    s = torch.sigmoid(na)
    return [mix(aw1, cin), loc[0].reshape(c, 1), loc[1:5].t().contiguous(),
            loc[5:9].t().contiguous(), loc[9:29].t().contiguous(),
            mix(awr, c),
            # the kernel returns d/d sigmoid(normalization.a); chain to a
            loc[29:33].t() * s * (1.0 - s),
            mix(awl, c), loc[33].reshape(c, 1), loc[34].contiguous()]


def mp_backward(params: Sequence[torch.Tensor], alg, h, hj, attr, dst, mask,
                dagg: torch.Tensor, exact: bool = True,
                plan: Optional[_Plan] = None):
    """K5: (dh, dhj, dattr or None, the 20 parameter gradients) of the sum,
    given its cotangent ``dagg`` (N, C, 8).  dh, dhj and dattr come back in
    the dtypes of h, hj and attr."""
    if not h.is_cuda:
        return message_aggregate_grad_plain(params, alg, h, hj, attr, dst,
                                            mask, dagg, exact)
    params = [p.contiguous() for p in params]
    e, cm, ca, c = _check(params, h, hj, attr, dst, mask)
    n = h.shape[0]
    if dagg.shape != (n, c, 8):
        raise ValueError(f"dagg shape {tuple(dagg.shape)} != {(n, c, 8)}")
    if plan is None:
        plan = make_plan(dst, mask, n, cm, ca, c)
    bc, sign = _alg_tables(tuple(alg.metric.tolist()), "fused_egcl")
    h_s, hj_s, attr_s = (_stream(t, exact) for t in (h, hj, attr))
    dagg = dagg.to(torch.float32).contiguous()
    dev = h.device
    # the kernel writes every row of dh, dhj and dattr (zeros for masked
    # edges and empty windows)
    dh = torch.empty((n, cm, 8), dtype=torch.float32, device=dev)
    dhj = torch.empty_like(hj_s)
    dattr = torch.empty_like(attr_s) if attr_s is not None else None
    n_part = int(_lib_fn("csmpn_fused_mp_partial_floats", [_I, _I, _I],
                         ctypes.c_int64)(cm, ca, c))
    flat = torch.zeros(n_part, dtype=torch.float32, device=dev)
    if n > 0:
        dx2 = torch.empty((e, c, 8), dtype=torch.float32, device=dev)
        partials = torch.empty((plan.grid, n_part), dtype=torch.float32,
                               device=dev)
        fn = _lib_fn("csmpn_fused_mp_bwd", [_P] * 16 + [_I] * 8 + [_P])
        err = fn(h_s.data_ptr(), hj_s.data_ptr(), _ptr(attr_s),
                 plan.dst.data_ptr(), _ptr(plan.mask),
                 plan.bounds.data_ptr(), dagg.data_ptr(),
                 _param_ptrs(params), bc.ctypes.data, sign.ctypes.data,
                 dh.data_ptr(), dhj.data_ptr(), _ptr(dattr), dx2.data_ptr(),
                 partials.data_ptr(), flat.data_ptr(), n, cm, ca, c,
                 WN, plan.n_win, 0 if exact else 1, plan.grid,
                 torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "fused message-passing backward kernel")
        BWD_LAUNCHES.add()
    part1 = (cm + ca + 2 * c) * 4 * c + NLOC * c   # block 0's slice
    grads = (_block_grads(flat[:part1], cm + ca, c, params[6])
             + _block_grads(flat[part1:], c, c, params[16]))
    return (dh.to(h.dtype), dhj.to(hj.dtype),
            dattr.to(attr.dtype) if attr is not None else None, grads)


class _FusedMP(torch.autograd.Function):
    """The edge side's sum, whose forward is K4 and backward is K5."""

    @staticmethod
    def forward(ctx, h, hj, attr, dst, mask, plan, alg, exact, *params):
        ctx.plan, ctx.alg, ctx.exact = plan, alg, exact
        ctx.save_for_backward(h, hj, attr, dst, mask, *params)
        return mp_forward(params, alg, h, hj, attr, dst, mask, exact, plan)

    @staticmethod
    def backward(ctx, dagg):
        h, hj, attr, dst, mask, *params = ctx.saved_tensors
        dh, dhj, dattr, grads = mp_backward(params, ctx.alg, h, hj, attr,
                                            dst, mask, dagg, ctx.exact,
                                            ctx.plan)
        return (dh, dhj, dattr, None, None, None, None, None, *grads)


# ------------------------------------------------------------- public API

def fused_mp_supported(algebra, edge_model, x: torch.Tensor) -> bool:
    """K4/K5 serve the flat EGCL path on the card in fast mode, for the
    2-block edge CEMLP with hidden == out width; exact mode and the CPU
    keep the composed path.  On the card in fast mode an algebra or a width
    the kernels are not compiled for raises, as K2/K3 do."""
    from .segment import aggregation_exact

    if not x.is_cuda or aggregation_exact():
        return False
    if edge_model.n_layers != 2 \
            or edge_model.hidden_features != edge_model.out_features:
        return False
    if algebra.n_blades != 8:
        raise NotImplementedError(
            f"the fused message-passing kernels are compiled for 3-dim "
            f"algebras (8 blades), got {algebra.n_blades} blades")
    if edge_model.hidden_features > 32:
        raise NotImplementedError(
            f"the fused message-passing kernels take at most 32 channels, "
            f"got {edge_model.hidden_features}")
    return True


def fused_message_aggregate(edge_model, h: torch.Tensor, hj: torch.Tensor,
                            edge_attr: Optional[torch.Tensor],
                            dst: torch.Tensor,
                            edge_mask: Optional[torch.Tensor] = None, *,
                            mean: bool) -> torch.Tensor:
    """EGCL edge side — ``reduce_dst(edge_cemlp(h[dst] - hj ++ attr))`` —
    in one pass.  ``h``: (N, Cm, 8); ``hj``: (E, Cm, 8) pre-gathered source
    rows; ``dst``: (E,) sorted ascending.  Returns (N, C, 8) float32."""
    from .segment import aggregation_exact, segment_counts

    alg = edge_model.algebra
    exact = aggregation_exact()
    n, cm = h.shape[0], h.shape[1]
    ca = edge_model.in_features - cm
    if (ca > 0) != (edge_attr is not None):
        raise ValueError(f"edge model takes {ca} attribute channels, "
                         f"edge_attr is {edge_attr is not None}")
    params = block_params(edge_model, 0) + block_params(edge_model, 1)
    plan = (make_plan(dst, edge_mask, n, cm, ca, edge_model.hidden_features)
            if h.is_cuda else None)
    agg = _FusedMP.apply(h, hj, edge_attr, dst, edge_mask, plan, alg, exact,
                         *params)
    if mean:
        counts = segment_counts(dst, n, mask=edge_mask,
                                indices_are_sorted=True)
        agg = agg / torch.clamp(counts, min=1.0)[:, None, None]
    return agg
