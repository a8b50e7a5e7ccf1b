"""K4 and K5 — the EGCL edge side in one pass, forward and backward: CUDA
kernel wrappers, their plain versions, the autograd wiring and the
dispatch.

Port of ``csmpn_tpu/ops/fused_egcl.py``.  For a 2-block edge CEMLP whose
hidden width equals its output width,

    agg = reduce_dst(CEMLP_2(CEMLP_1([h[dst] - hj, attr])))

with ``dst`` sorted ascending, ``hj`` the pre-gathered source rows (their
cotangent flows back through the caller's gather), masked edges
contributing nothing, and the mean taken outside the kernel with the
masked in-degree (an empty segment gives 0).  K4 computes the sum without
writing a message to device memory; K5 recomputes both blocks and returns
d(h), d(hj), d(attr) and the 20 parameter gradients in one pass (the TPU
kernel's 21 tables: its block-1 input linear is split over message and
attribute lanes; here the message and the attributes are one input row,
so it is one tensor of the flax shape (C, Cm + Ca, G)).  One pair of
kernels per algebra (``FusedKernel``, ``fused_kernel``):

  * K4/K5, ``csrc/fused_egcl.cu``, dense form: Cl(3,0) (8 blades, up to 32
    channels) and Cl(2,0) (4 blades; a lane holds channels n and n + 32);
    in fast mode both are row tile kernels over ``csrc/cemlp_tile.cuh``:
    K4 runs both blocks' forwards on 16 edge rows a step, K5 is launched
    once for each of its three sweeps over the windows;
  * K4p/K5p, pair form, ``csrc/fused_egcl_pair.cuh`` compiled for Cl(5,0)
    (``csrc/fused_egcl_pair.cu``, 32 blades) and Cl(4,0)
    (``csrc/fused_egcl_pair_cl4.cu``, 16 blades), each up to 28 channels.
    In exact mode they are row kernels that stage both blocks' fp32
    parameters (attribute widths: Cm + Ca up to 39 at Cl(5), 51 at Cl(4),
    at 28 channels); in fast mode they are sweeps of K2p's and K3p's row
    tiles over all edge rows (``csrc/fused_egcl_pair_tile.cuh``), the
    window sums in kernels of their own: K4p block 1's forward to a bf16
    scratch ``x2s``, block 2's forward over it, the message sums; K5p
    block 1's forward to ``x2s``, block 2's backward to the fp32 scratch
    ``dx2``, block 1's backward over it, the d(h) sums with dhj and
    dattr.
In fast mode ``_check_tile_smem`` holds the tile kernels' widths for both
forms; at every width the exact kernels take, the fast ones take it too
(chip_smoke.py asserts it).

Cl(1) (2 blades), which the reference's dense form also serves, has no
kernel yet and raises, as do widths whose kernels do not fit.

On a CUDA tensor the wrappers launch the kernels (or raise); on a CPU
tensor they compute the plain versions:

  * ``message_aggregate_plain`` — the same function in PyTorch, from
    ``block_forward_plain`` (ops/cemlp_kernel.py) twice;
  * the plain K5 is ``torch.autograd.grad`` of it, so the hand-derived
    backward of the kernel is checked independently.

``exact=False`` (fast mode) streams h, hj and attr as bf16, rounds the
operands of every product as K2 (K2p) does, rounds each message row to
bf16 before the sum and d(agg) before the backward, and accumulates in
fp32.

The TPU kernel's one-hot window matrix products and their band switch
``CSMPN_ONEHOT_BANDS`` are a device of the TPU's matrix unit: on the card
the target gather is an indexed load and the reduce a sum in shared
memory, so the switch has no counterpart.  Its window of 128 targets is
``wn`` here, per kernel: 32 for K4/K5, 4 for K4p/K5p at Cl(5) (a window
sum takes 3.5 KB a target at 28 channels) and 16 at Cl(4) (1.75 KB a
target; 512 windows at the bench's 8,192 targets keep the last round of
windows short on 132 SMs); in both modes.
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
    _pair_tabs,
    _rounder,
    block_forward_plain,
    block_kernel,
    block_params,
    check_block_params,
)

FWD_LAUNCHES = _build.LaunchCounter("fused_mp_fwd")
BWD_LAUNCHES = _build.LaunchCounter("fused_mp_bwd")
CL2_FWD_LAUNCHES = _build.LaunchCounter("fused_mp_cl2_fwd")
CL2_BWD_LAUNCHES = _build.LaunchCounter("fused_mp_cl2_bwd")
PAIR_FWD_LAUNCHES = _build.LaunchCounter("fused_mp_pair_fwd")
PAIR_BWD_LAUNCHES = _build.LaunchCounter("fused_mp_pair_bwd")
PAIR_CL4_FWD_LAUNCHES = _build.LaunchCounter("fused_mp_pair_cl4_fwd")
PAIR_CL4_BWD_LAUNCHES = _build.LaunchCounter("fused_mp_pair_cl4_bwd")

MAX_SMEM = 232448       # 227 KB opt-in per block (kMaxSmem there)

_P = ctypes.c_void_p
_I = ctypes.c_int


@dataclass(frozen=True)
class FusedKernel:
    """What one pair of fused message-passing kernels takes, and where it
    lives."""
    label: str
    source: str           # csrc/{source}.cu
    symbol: str           # prefix of its C entry points
    n_blades: int
    n_grades: int
    n_paths: int
    max_channels: int     # output channels C the kernels take
    wn: int               # target nodes per CTA window
    fwd: _build.LaunchCounter
    bwd: _build.LaunchCounter
    # "dense": Cayley signs passed from the host; "pair": the packed pair
    # tables on the card
    form: str = "dense"

    @property
    def nloc(self) -> int:
        """Per-channel gradient rows of a block in K5's partial vector: b1,
        silu.a and silu.b (G each), gp.weight (P), d sigmoid(norm.a) (G),
        bL, ln.a."""
        return 3 + 3 * self.n_grades + self.n_paths


DENSE = FusedKernel("K4/K5", "fused_egcl", "csmpn_fused_mp", 8, 4, 20, 32, 32,
                    FWD_LAUNCHES, BWD_LAUNCHES)
DENSE_CL2 = FusedKernel("K4/K5 at Cl(2)", "fused_egcl", "csmpn_fused_mp_cl2",
                        4, 3, 10, 64, 32, CL2_FWD_LAUNCHES, CL2_BWD_LAUNCHES)
PAIR = FusedKernel("K4p/K5p", "fused_egcl_pair", "csmpn_fused_mp_pair", 32,
                   6, 56, 28, 4, PAIR_FWD_LAUNCHES, PAIR_BWD_LAUNCHES,
                   form="pair")
PAIR_CL4 = FusedKernel("K4p/K5p at Cl(4)", "fused_egcl_pair_cl4",
                       "csmpn_fused_mp_pair_cl4", 16, 5, 35, 28, 16,
                       PAIR_CL4_FWD_LAUNCHES, PAIR_CL4_BWD_LAUNCHES,
                       form="pair")


def fused_kernel(nb: int) -> FusedKernel:
    """The fused message-passing kernels for nb blades, or
    NotImplementedError."""
    for k in (DENSE_CL2, DENSE, PAIR_CL4, PAIR):
        if k.n_blades == nb:
            return k
    raise NotImplementedError(
        f"no fused message-passing kernel for {nb} blades: K4/K5 take 2- "
        f"and 3-dim algebras (4 and 8 blades), K4p/K5p Cl(4,0) and Cl(5,0) "
        f"(16 and 32 blades); Cl(1) (2 blades, the dense form) is still to "
        f"port (ROADMAP Queue 2, K2/K3 and K4/K5 at nb 2)")


# ------------------------------------------------------------ plain version

def message_aggregate_plain(params: Sequence[torch.Tensor], alg,
                            h: torch.Tensor, hj: torch.Tensor,
                            attr: Optional[torch.Tensor], dst: torch.Tensor,
                            mask: Optional[torch.Tensor] = None,
                            mean: bool = False,
                            exact: bool = True) -> torch.Tensor:
    """The edge side in PyTorch: (N, C, nb) float32.  ``params`` are the 20
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

def _lib_fn(kern: FusedKernel, name: str, argtypes, restype=ctypes.c_int):
    fn = getattr(_build.load(kern.source), f"{kern.symbol}_{name}")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


@functools.lru_cache(maxsize=None)
def _check_smem(kern: FusedKernel, cm: int, ca: int, c: int) -> None:
    """Raise unless the forward and backward fit in shared memory."""
    fn = _lib_fn(kern, "smem_bytes", [_I, _I, _I, _I, _I], ctypes.c_size_t)
    sizes = [int(fn(cm, ca, c, kern.wn, b)) for b in (0, 1)]
    if not 0 < max(sizes) <= MAX_SMEM:
        raise NotImplementedError(
            f"{kern.label}: the fused message-passing kernels do not fit in "
            f"shared memory at {cm} message + {ca} attribute -> {c} channels")


@functools.lru_cache(maxsize=None)
def _check_tile_smem(kern: FusedKernel, cm: int, ca: int, c: int,
                     backward: bool = True) -> None:
    """Raise unless the fast-mode backward (or forward) takes the widths:
    the row tiles of csrc/cemlp_tile.cuh (K4/K5) or the tile sweeps of
    csrc/fused_egcl_pair_tile.cuh (K4p/K5p), every sweep of the
    direction."""
    entry = "tile_smem_bytes" if backward else "fwd_tile_smem_bytes"
    fn = _lib_fn(kern, entry, [_I, _I, _I, _I], ctypes.c_size_t)
    if int(fn(cm, ca, c, kern.wn)) == 0:
        raise NotImplementedError(
            f"{kern.label}: the fast-mode "
            f"{'backward' if backward else 'forward'} does not fit in one CTA "
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


def check_counts(kern: FusedKernel, n_nodes: int, n_edges: int) -> None:
    """Raise before any launch unless the kernels index a call of
    n_nodes targets and n_edges edge rows correctly: their element offsets
    are 64-bit, but node and window counts reach them as C ints (ctypes
    wraps a wider value silently), so the windows must end below 2**31;
    the edge rows are held to the same count, the rows K2/K3 take on the
    composed route."""
    n_win = -(-n_nodes // kern.wn)
    if n_win * kern.wn > _build.MAX_COUNT or n_edges > _build.MAX_COUNT:
        raise NotImplementedError(
            f"{kern.label}: {n_nodes} targets and {n_edges} edge rows in one "
            f"call; the kernels take at most {_build.MAX_COUNT} of each "
            f"(windows of {kern.wn} included): split the edges into more "
            f"chunks")


def make_plan(dst, mask, n_nodes: int, cm: int, ca: int, c: int,
              nb: int = 8) -> _Plan:
    """The window layout of a call on the card (dst on the card) for the
    kernels of nb blades."""
    kern = fused_kernel(nb)
    _check_smem(kern, cm, ca, c)
    dst32 = dst.to(torch.int32).contiguous()
    bounds = window_bounds(dst32, n_nodes, kern.wn).to(torch.int64)
    n_win = bounds.shape[0] - 1
    m = (mask.to(torch.bool).contiguous().view(torch.uint8)
         if mask is not None else None)
    props = torch.cuda.get_device_properties(dst.device)
    grid = max(1, min(n_win, props.multi_processor_count))
    return _Plan(n_win, bounds.contiguous(), dst32, m, grid)


def _check(params, h, hj, attr, dst, mask):
    nb = h.shape[2] if h.dim() == 3 else -1
    if h.dim() != 3 or hj.dim() != 3 or hj.shape[1:] != h.shape[1:]:
        raise ValueError(f"h (N, Cm, nb) and hj (E, Cm, nb) expected, got "
                         f"{tuple(h.shape)} and {tuple(hj.shape)}")
    kern = fused_kernel(nb)
    e, cm = hj.shape[0], h.shape[1]
    ca = 0 if attr is None else attr.shape[1]
    if attr is not None and (attr.shape != (e, ca, nb)
                             or attr.device != h.device):
        raise ValueError(f"attr (E, Ca, {nb}) expected, got "
                         f"{tuple(attr.shape)}")
    if dst.shape != (e,) or hj.device != h.device or dst.device != h.device:
        raise ValueError("dst (E,) and hj must lie on h's device")
    if mask is not None and (mask.shape != (e,) or mask.device != h.device):
        raise ValueError("mask (E,) must lie on h's device")
    if len(params) != 20:
        raise ValueError(f"20 block parameters expected, got {len(params)}")
    check_counts(kern, h.shape[0], e)
    c = params[0].shape[0]
    block = block_kernel(nb)
    check_block_params(params[:10], cm + ca, c, h.device, block)
    check_block_params(params[10:], c, c, h.device, block)
    return kern, e, cm, ca, c


def _stream(t: Optional[torch.Tensor], exact: bool):
    if t is None:
        return None
    return t.to(torch.float32 if exact else torch.bfloat16).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _param_ptrs(params):
    return (ctypes.c_void_p * 20)(*[p.data_ptr() for p in params])


def _tables(kern: FusedKernel, alg, device):
    """(bc host array, pointer to the kernels' table operand): the Cayley
    signs on the host for K4/K5, the packed pair tables on the card for
    K4p/K5p, after checking the algebra against the compiled structure."""
    metric = tuple(alg.metric.tolist())
    bc, sign = _alg_tables(metric, kern.source, kern.symbol)
    if kern.form == "pair":
        return bc, _pair_tabs(metric, device, kern.source,
                              kern.symbol).data_ptr()
    return bc, sign.ctypes.data


def mp_forward(params: Sequence[torch.Tensor], alg, h, hj, attr, dst,
               mask=None, exact: bool = True,
               plan: Optional[_Plan] = None) -> torch.Tensor:
    """K4 (K4p at Cl(4) and Cl(5)): the sum over unmasked edges, (N, C,
    nb) float32."""
    if not h.is_cuda:
        return message_aggregate_plain(params, alg, h, hj, attr, dst, mask,
                                       False, exact)
    params = [p.contiguous() for p in params]
    kern, e, cm, ca, c = _check(params, h, hj, attr, dst, mask)
    n, nb = h.shape[0], kern.n_blades
    if plan is None:
        plan = make_plan(dst, mask, n, cm, ca, c, nb)
    if not exact:
        _check_tile_smem(kern, cm, ca, c, backward=False)
    bc, tabs = _tables(kern, alg, h.device)
    h_s, hj_s, attr_s = (_stream(t, exact) for t in (h, hj, attr))
    out = torch.empty((n, c, nb), dtype=torch.float32, device=h.device)
    if n == 0:
        return out
    pair = kern.form == "pair"
    # the pair form's fast forward keeps block 2's input rows (bf16; 235 MB
    # at the --dim 5 bench's 131,072 edges x 32 blades x 28 channels)
    x2s = (torch.empty((e, nb, c), dtype=torch.bfloat16, device=h.device)
           if pair and not exact else None)
    fn = _lib_fn(kern, "fwd", [_P] * (11 if pair else 10) + [_I] * 8 + [_P])
    err = fn(h_s.data_ptr(), hj_s.data_ptr(), _ptr(attr_s),
             plan.dst.data_ptr(), _ptr(plan.mask), plan.bounds.data_ptr(),
             _param_ptrs(params), bc.ctypes.data, tabs, out.data_ptr(),
             *((_ptr(x2s),) if pair else ()), n, cm, ca, c, kern.wn,
             plan.n_win, 0 if exact else 1, plan.grid,
             torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(err, f"{kern.label} forward kernel")
    kern.fwd.add()
    return out


def block_part_floats(kern: FusedKernel, cin: int, c: int) -> int:
    """Floats of one block's slice of K5's summed partial vector."""
    return (cin + 2 * c) * kern.n_grades * c + kern.nloc * c


def _block_grads(v: torch.Tensor, cin: int, c: int, na: torch.Tensor,
                 kern: FusedKernel = DENSE) -> List[torch.Tensor]:
    """One block's slice of the summed partial vector -> its 10 gradients
    in flax shapes.  The slice is
        aw1 [(m*G+g)*C + n] (Cin) | awr (C) | awl (C) | loc [nloc][C]
    with loc rows b1, silu.a (G), silu.b (G), gp.weight (P),
    d sigmoid(norm.a) (G), bL, ln.a (csrc/fused_egcl.cu and
    csrc/fused_egcl_pair.cu write it)."""
    ng, npath = kern.n_grades, kern.n_paths
    sizes = [cin * ng * c, c * ng * c, c * ng * c, kern.nloc * c]
    aw1, awr, awl, loc = torch.split(v, sizes)

    def mix(t, m):   # [(m*G+g)*C + n] -> (C, m, G)
        return t.view(m, ng, c).permute(2, 0, 1).contiguous()

    loc = loc.view(kern.nloc, c)
    sa, sb, gw = 1, 1 + ng, 1 + 2 * ng
    ns = gw + npath
    s = torch.sigmoid(na)
    return [mix(aw1, cin), loc[0].reshape(c, 1), loc[sa:sb].t().contiguous(),
            loc[sb:gw].t().contiguous(), loc[gw:ns].t().contiguous(),
            mix(awr, c),
            # the kernel returns d/d sigmoid(normalization.a); chain to a
            loc[ns:ns + ng].t() * s * (1.0 - s),
            mix(awl, c), loc[ns + ng].reshape(c, 1),
            loc[ns + ng + 1].contiguous()]


def mp_backward(params: Sequence[torch.Tensor], alg, h, hj, attr, dst, mask,
                dagg: torch.Tensor, exact: bool = True,
                plan: Optional[_Plan] = None):
    """K5 (K5p at Cl(4) and Cl(5)): (dh, dhj, dattr or None, the 20
    parameter gradients) of the sum, given its cotangent ``dagg`` (N, C,
    nb).  dh, dhj and dattr come back in the dtypes of h, hj and attr."""
    if not h.is_cuda:
        return message_aggregate_grad_plain(params, alg, h, hj, attr, dst,
                                            mask, dagg, exact)
    params = [p.contiguous() for p in params]
    kern, e, cm, ca, c = _check(params, h, hj, attr, dst, mask)
    n, nb = h.shape[0], kern.n_blades
    if dagg.shape != (n, c, nb):
        raise ValueError(f"dagg shape {tuple(dagg.shape)} != {(n, c, nb)}")
    if plan is None:
        plan = make_plan(dst, mask, n, cm, ca, c, nb)
    if not exact:
        _check_tile_smem(kern, cm, ca, c)
    bc, tabs = _tables(kern, alg, h.device)
    h_s, hj_s, attr_s = (_stream(t, exact) for t in (h, hj, attr))
    dagg = dagg.to(torch.float32).contiguous()
    dev = h.device
    # the kernel writes every row of dh, dhj and dattr (zeros for masked
    # edges and empty windows)
    dh = torch.empty((n, cm, nb), dtype=torch.float32, device=dev)
    dhj = torch.empty_like(hj_s)
    dattr = torch.empty_like(attr_s) if attr_s is not None else None
    part1 = block_part_floats(kern, cm + ca, c)      # block 0's slice
    flat = torch.zeros(part1 + block_part_floats(kern, c, c),
                       dtype=torch.float32, device=dev)
    if n > 0:
        n_slice = int(_lib_fn(kern, "partial_floats", [_I, _I, _I],
                              ctypes.c_int64)(cm, ca, c))
        # scratch: block 2's dx rows (fp32; the pair form's fast sweeps
        # write block 1's dx rows over them, so a row holds the wider of
        # the two) and, in fast mode, block 2's input rows (bf16): at the
        # --dim 5 bench's 131,072 edges x 32 blades x 28 channels 470 MB and
        # 235 MB, far inside the card
        wide = kern.form == "pair" and not exact
        dx2 = torch.empty((e, max(c, cm + ca) if wide else c, nb),
                          dtype=torch.float32, device=dev)
        x2s = (torch.empty((e, nb, c), dtype=torch.bfloat16, device=dev)
               if not exact else None)
        partials = torch.empty((plan.grid, n_slice), dtype=torch.float32,
                               device=dev)
        fn = _lib_fn(kern, "bwd", [_P] * 17 + [_I] * 8 + [_P])
        err = fn(h_s.data_ptr(), hj_s.data_ptr(), _ptr(attr_s),
                 plan.dst.data_ptr(), _ptr(plan.mask),
                 plan.bounds.data_ptr(), dagg.data_ptr(),
                 _param_ptrs(params), bc.ctypes.data, tabs,
                 dh.data_ptr(), dhj.data_ptr(), _ptr(dattr), dx2.data_ptr(),
                 _ptr(x2s), partials.data_ptr(), flat.data_ptr(), n, cm, ca, c,
                 kern.wn, plan.n_win, 0 if exact else 1, plan.grid,
                 torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, f"{kern.label} backward kernel")
        kern.bwd.add()
    grads = (_block_grads(flat[:part1], cm + ca, c, params[6], kern)
             + _block_grads(flat[part1:], c, c, params[16], kern))
    return (dh.to(h.dtype), dhj.to(hj.dtype),
            dattr.to(attr.dtype) if attr is not None else None, grads)


class _FusedMP(torch.autograd.Function):
    """The edge side's sum, whose forward is K4 (K4p) and backward K5
    (K5p)."""

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
    """The fused kernels serve the flat EGCL path on the card in fast mode,
    for the 2-block edge CEMLP with hidden == out width: K4/K5 at Cl(2) and
    Cl(3), K4p/K5p at Cl(4) and Cl(5).  Exact mode and the CPU keep the
    composed path, and so does an edge CEMLP with ``fused=False`` or
    without normalization layers (``normalization_init=None``: a block the
    kernels do not compute).  On the card in fast mode an algebra or a
    width the kernels are not compiled for raises, as K2/K3 do; it never
    falls back."""
    from .segment import aggregation_exact

    if not x.is_cuda or aggregation_exact():
        return False
    if edge_model.n_layers != 2 \
            or edge_model.hidden_features != edge_model.out_features \
            or edge_model.fused is False \
            or edge_model.normalization_init is None:
        return False
    kern = fused_kernel(algebra.n_blades)
    if edge_model.hidden_features > kern.max_channels:
        raise NotImplementedError(
            f"{kern.label} take at most {kern.max_channels} channels, got "
            f"{edge_model.hidden_features}")
    return True


def fused_message_aggregate(edge_model, h: torch.Tensor, hj: torch.Tensor,
                            edge_attr: Optional[torch.Tensor],
                            dst: torch.Tensor,
                            edge_mask: Optional[torch.Tensor] = None, *,
                            mean: bool,
                            plan: Optional[_Plan] = None,
                            counts: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """EGCL edge side — ``reduce_dst(edge_cemlp(h[dst] - hj ++ attr))`` —
    in one pass.  ``h``: (N, Cm, nb); ``hj``: (E, Cm, nb) pre-gathered
    source rows; ``dst``: (E,) sorted ascending.  A caller that keeps them
    passes ``plan``, the window plan of ``dst`` and ``edge_mask``
    (``make_plan``), and ``counts``, the masked in-degrees (N,) float32 of
    the mean.  Returns (N, C, nb) float32."""
    from .segment import aggregation_exact

    alg = edge_model.algebra
    exact = aggregation_exact()
    n, cm = h.shape[0], h.shape[1]
    ca = edge_model.in_features - cm
    if (ca > 0) != (edge_attr is not None):
        raise ValueError(f"edge model takes {ca} attribute channels, "
                         f"edge_attr is {edge_attr is not None}")
    params = block_params(edge_model, 0) + block_params(edge_model, 1)
    if plan is None and h.is_cuda:
        plan = make_plan(dst, edge_mask, n, cm, ca,
                         edge_model.hidden_features, alg.n_blades)
    agg = _FusedMP.apply(h, hj, edge_attr, dst, edge_mask, plan, alg, exact,
                         *params)
    if mean:
        agg = agg / _mean_divisor(dst, n, edge_mask, counts)
    return agg


def _mean_divisor(dst, n: int, edge_mask, counts) -> torch.Tensor:
    """The mean's divisor (N, 1, 1): the masked in-degree, at least 1."""
    if counts is None:
        from .segment import segment_counts

        counts = segment_counts(dst, n, mask=edge_mask,
                                indices_are_sorted=True)
    return torch.clamp(counts, min=1.0)[:, None, None]


def fused_message_aggregate_backward(edge_model, h: torch.Tensor,
                                     hj: torch.Tensor,
                                     edge_attr: Optional[torch.Tensor],
                                     dst: torch.Tensor,
                                     edge_mask: Optional[torch.Tensor],
                                     dagg: torch.Tensor, *, mean: bool,
                                     plan: Optional[_Plan] = None,
                                     counts: Optional[torch.Tensor] = None):
    """The backward of ``fused_message_aggregate`` from the cotangent
    ``dagg`` (N, C, nb) of its result, without its forward: the mean's
    division, then K5 (K5p).  Returns (d(h), d(hj), d(edge_attr) or None,
    the gradients of ``edge_model.parameters()`` in their order)."""
    from .segment import aggregation_exact

    if mean:
        dagg = dagg / _mean_divisor(dst, h.shape[0], edge_mask, counts)
    params = block_params(edge_model, 0) + block_params(edge_model, 1)
    dh, dhj, dattr, grads = mp_backward(
        params, edge_model.algebra, h, hj, edge_attr, dst, edge_mask, dagg,
        aggregation_exact(), plan)
    by_id = {id(p): gr for p, gr in zip(params, grads)}
    return dh, dhj, dattr, [by_id[id(p)] for p in edge_model.parameters()]
