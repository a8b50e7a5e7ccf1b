"""Segment (scatter/gather) reductions for simplicial message passing.

Port of ``csmpn_tpu/ops/segment.py``.  Edges are sorted by target simplex
at preprocessing time, so every reduction is a sorted segment sum, and the
backward of every row gather is one too.  On a CUDA tensor those sums run
in kernel K1 (``ops/segment_kernel.py``); on the CPU they take K1's plain
version in fp32, which is what the reference package computes off the TPU.

One deliberate difference from the reference: the batched task path's
(B, N, E) one-hot aggregation (a TPU matrix-unit device) is not ported.
On the card the aggregation goes through K1 directly, reading each
message row once; ``flatten_graph`` keeps the global targets ascending,
and the masked mean divides by the masked in-degree as the one-hot form
does.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .segment_kernel import segment_sum_plain
from .segment_kernel import sorted_segment_sum as _k1_kernel

# Global aggregation precision mode, as in the reference.  "exact": fp32
# sums.  "fast": bf16 operands with fp32 accumulation on the card (the
# training default of the task entry points).  The CPU path is fp32 in
# both modes, like the reference package off the TPU.
_AGGREGATION_MODE = "exact"


def set_aggregation_mode(mode: str) -> None:
    global _AGGREGATION_MODE
    if mode not in ("exact", "fast"):
        raise ValueError(f"unknown aggregation mode {mode!r}")
    _AGGREGATION_MODE = mode


def aggregation_exact() -> bool:
    return _AGGREGATION_MODE == "exact"


def _k1(flat, ids, n, exact, mask=None, mean=False):
    """K1 on the card; its plain version in fp32 on the CPU."""
    if flat.is_cuda:
        return _k1_kernel(flat, ids, n, exact, mask, mean)
    return segment_sum_plain(flat, ids, n, True, mask, mean)


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


# ---------------------------------------------------------------- core sums

class _SegmentReduce(torch.autograd.Function):
    """Sorted segment sum or masked mean; backward is a row gather."""

    @staticmethod
    def forward(ctx, data, ids, n, mask, mean):
        flat = data.reshape(data.shape[0], -1)
        exact = aggregation_exact()
        out, counts = _k1(flat, ids, n, exact, mask, mean)
        ctx.n, ctx.mean, ctx.exact = n, mean, exact
        ctx.shape, ctx.dtype = data.shape, data.dtype
        ctx.save_for_backward(ids, counts, mask if mask is not None
                              else torch.empty(0, dtype=torch.bool))
        return out.reshape((n,) + tuple(data.shape[1:])).to(
            torch.promote_types(data.dtype, torch.float32))

    @staticmethod
    def backward(ctx, g):
        ids, counts, mask = ctx.saved_tensors
        n = ctx.n
        gf = g.reshape(n, -1).to(torch.float32)
        if g.is_cuda and not ctx.exact:
            gf = _round_bf16(gf)
        if ctx.mean:
            gf = gf / torch.clamp(counts, min=1.0)[:, None]
        keep = ids < n
        if mask.numel():
            keep = keep & mask
        d = gf.index_select(0, torch.clamp(ids.long(), max=max(n - 1, 0)))
        d = d * keep[:, None].to(d.dtype)
        return d.reshape(ctx.shape).to(ctx.dtype), None, None, None, None


def sorted_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Segment sum for ids sorted ascending, in data's dtype."""
    return _SegmentReduce.apply(data, segment_ids, num_segments, None,
                                False).to(data.dtype)


def segment_counts(segment_ids: torch.Tensor, num_segments: int,
                   mask: Optional[torch.Tensor] = None,
                   indices_are_sorted: bool = True) -> torch.Tensor:
    """In-degree per segment (masked rows not counted), float32."""
    if indices_are_sorted and mask is None:
        r = torch.arange(num_segments, dtype=segment_ids.dtype,
                         device=segment_ids.device)
        ends = torch.searchsorted(segment_ids, r, side="right")
        starts = torch.searchsorted(segment_ids, r, side="left")
        return (ends - starts).to(torch.float32)
    keep = torch.ones(segment_ids.shape, dtype=torch.float32,
                      device=segment_ids.device)
    if mask is not None:
        keep = keep * mask.to(torch.float32)
    keep = keep * (segment_ids < num_segments).to(torch.float32)
    ids = torch.clamp(segment_ids.long(), max=num_segments)
    out = keep.new_zeros(num_segments + 1).index_add_(0, ids, keep)
    return out[:num_segments]


# ------------------------------------------------------- scatter-free take

class _TakeRows(torch.autograd.Function):
    """Row gather h[idx] whose backward is a sorted segment sum (K1)."""

    @staticmethod
    def forward(ctx, h, idx, order, idx_sorted, ids_ascending):
        ctx.n = h.shape[0]
        ctx.ids_ascending = ids_ascending
        ctx.save_for_backward(idx, order if order is not None
                              else torch.empty(0, dtype=torch.long),
                              idx_sorted if idx_sorted is not None
                              else torch.empty(0, dtype=idx.dtype))
        return h.index_select(0, idx.long())

    @staticmethod
    def backward(ctx, g):
        idx, order, idx_sorted = ctx.saved_tensors
        n = ctx.n
        flat = g.reshape(g.shape[0], -1)
        if ctx.ids_ascending:
            # the reference runs this one in exact mode
            d_h, _ = _k1(flat, idx, n, True)
        else:
            if not order.numel():
                order = torch.argsort(idx, stable=True)
                idx_sorted = idx.index_select(0, order)
            exact = aggregation_exact()
            if flat.is_cuda and not exact:
                flat = flat.to(torch.bfloat16)
            flat = flat.index_select(0, order.long())
            d_h, _ = _k1(flat, idx_sorted, n, exact)
        d_h = d_h.to(g.dtype).reshape((n,) + tuple(g.shape[1:]))
        return d_h, None, None, None, None


def take_rows(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather whose backward sorts the indices and runs K1."""
    return _TakeRows.apply(h, idx, None, None, False)


def take_rows_presorted(h: torch.Tensor, idx: torch.Tensor,
                        order: torch.Tensor,
                        idx_sorted: torch.Tensor) -> torch.Tensor:
    """Row gather with a precomputed sort of the gather indices
    (``idx[order] == idx_sorted``, ascending)."""
    return _TakeRows.apply(h, idx, order, idx_sorted, False)


def take_rows_sorted_idx(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather whose indices are already ascending (edge targets)."""
    return _TakeRows.apply(h, idx, None, None, True)


class _BatchedTake(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, idx):
        b, n = h.shape[0], h.shape[1]
        idx_flat = idx.reshape(b, -1).long()
        hf = h.reshape(b, n, -1)
        out = hf[torch.arange(b, device=h.device)[:, None], idx_flat]
        ctx.save_for_backward(idx_flat)
        ctx.h_shape = h.shape
        return out.reshape(tuple(idx.shape) + tuple(h.shape[2:]))

    @staticmethod
    def backward(ctx, g):
        (idx_flat,) = ctx.saved_tensors
        b, n = ctx.h_shape[0], ctx.h_shape[1]
        g_flat = g.reshape(b, idx_flat.shape[1], -1)
        onehot = F.one_hot(idx_flat, n).to(g_flat.dtype)      # (B, I, N)
        d_h = torch.bmm(onehot.transpose(1, 2), g_flat)
        return d_h.reshape(ctx.h_shape), None


def batched_take(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-sample row gather h[b, idx[b]] with a one-hot batched-matmul
    backward.  h: (B, N, ...); idx: (B, ...I) -> (B, ...I, ...)."""
    return _BatchedTake.apply(h, idx)


# ------------------------------------------------------------- public API

def _reduce(data, segment_ids, num_segments, indices_are_sorted, mask,
            mean):
    if data.is_cuda and not indices_are_sorted:
        order = torch.argsort(segment_ids, stable=True)
        data = data.index_select(0, order)
        segment_ids = segment_ids.index_select(0, order)
        mask = mask.index_select(0, order) if mask is not None else None
    if mask is not None:
        mask = mask.bool()
    return _SegmentReduce.apply(data, segment_ids, num_segments, mask, mean)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, indices_are_sorted: bool = False,
                mask: Optional[torch.Tensor] = None,
                batch_shape=None) -> torch.Tensor:
    """Masked segment sum, data (E, ...), segment_ids (E,).  ``batch_shape``
    (B, N, E) marks stacked small graphs; the sum is the same either way."""
    del batch_shape
    return _reduce(data, segment_ids, num_segments, indices_are_sorted,
                   mask, False)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, indices_are_sorted: bool = False,
                 mask: Optional[torch.Tensor] = None,
                 batch_shape=None) -> torch.Tensor:
    """Masked segment mean with PyG ``aggr="mean"`` semantics: divide by
    the masked in-degree; empty segments give 0."""
    del batch_shape
    return _reduce(data, segment_ids, num_segments, indices_are_sorted,
                   mask, True)


def masked_mean(data: torch.Tensor, mask: torch.Tensor,
                axis: int) -> torch.Tensor:
    """Mean over ``axis`` counting only masked-in entries."""
    mask = mask.to(data.dtype)
    mask = mask.reshape(tuple(mask.shape) + (1,) * (data.dim() - mask.dim()))
    total = torch.sum(data * mask, dim=axis)
    count = torch.clamp(torch.sum(mask, dim=axis), min=1.0)
    return total / count
