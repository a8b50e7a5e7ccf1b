"""Edge partition by target node, and one EGCL layer streamed over its
chunks on one card.

Port of the one-card part of ``csmpn_tpu/parallel/edge_partition.py``:
the host-side tables (``EdgePartition``, ``permute_edge_payload``,
``partition_edges``, ``make_synthetic_complex``; numpy, the same arrays
byte for byte) and ``streaming_egcl_apply``.  Chunk s owns the contiguous
node range [s * nps, (s + 1) * nps) and every edge that targets it, so a
chunk is a contiguous slab of the target-sorted edge list, padded to a
common length with masked edges.

``streaming_egcl_apply`` runs one EGCL layer over a complex whose edge
messages do not fit on the card: the chunks one after another, so the
card holds the node features and one chunk's edge rows.  Its chunk body
is the reference's: the source gather, ``EGCL.message_aggregate`` over
the chunk's own nodes (K4 forward and K5 backward on the card in fast
mode, the composed route elsewhere), ``EGCL.update``.

With ``remat=True`` (the default) the layer is one autograd function
over the chunks.  Its forward keeps only each chunk's aggregate (N, C,
nb) fp32; its backward walks the chunks again, recomputes the node update
under autograd and calls K5 directly with d(agg), so K4 runs once a chunk
and step.  (The reference wraps its chunk body in ``jax.checkpoint``, and
its fused backward recomputes the forward inside its tiles once more: K4
twice a chunk.)  The sources' cotangents d(h_j) are summed a chunk at a
time with K1 over the chunk's distinct sources and added into d(h) with
unique indices.  ``remat=False`` is plain autograd through every chunk,
which keeps every chunk's edge rows: for small complexes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import fused_egcl as fe
from ..ops.segment import aggregation_exact, segment_counts, take_rows
from ..ops.segment_kernel import sorted_segment_sum


@dataclass(frozen=True)
class EdgePartition:
    """Per-chunk edge slabs, stacked: arrays lead with the chunk axis."""

    edge_index: np.ndarray   # (n_shards * e_shard, 2) [source, target-global]
    edge_mask: np.ndarray    # (n_shards * e_shard,)
    n_shards: int
    e_shard: int
    nodes_per_shard: int
    # slab slot -> original edge id (-1 for padding): lets per-edge
    # payloads (edge_attr) follow their edges into slab order
    edge_perm: Optional[np.ndarray] = None


def permute_edge_payload(part: EdgePartition,
                         payload: np.ndarray) -> np.ndarray:
    """Reorder a per-edge payload (e.g. edge_attr, original edge order)
    into the partition's padded slab layout; padded slots are zero."""
    payload = np.asarray(payload)
    perm = part.edge_perm
    out = np.zeros((perm.shape[0],) + payload.shape[1:], payload.dtype)
    valid = perm >= 0
    out[valid] = payload[perm[valid]]
    return out


def partition_edges(edge_index: np.ndarray, n_nodes: int,
                    n_shards: int) -> EdgePartition:
    """Partition a (2, E) edge list into contiguous per-chunk slabs of the
    target-sorted list, padded to a common length (rounded up to 8)."""
    if n_nodes % n_shards:
        raise ValueError(f"pad nodes to a multiple of n_shards: {n_nodes} "
                         f"nodes, {n_shards} shards")
    nps = n_nodes // n_shards
    ei = np.asarray(edge_index)
    if ei.size and (ei.min() < 0 or ei.max() >= n_nodes):
        raise ValueError(f"node ids must lie in [0, {n_nodes})")
    # np.lexsort((src, dst))'s order, ties (repeated edges) in input order
    # (edge_perm keeps it): a stable sort of one int64 key, a tenth of the
    # lexsort's time
    order = np.argsort(ei[1].astype(np.int64) * n_nodes + ei[0],
                       kind="stable")
    ei = ei[:, order]
    # a slab is a contiguous range of the target-sorted list: searchsorted
    # boundaries, not a mask per slab (O(n_shards * E))
    starts = np.searchsorted(ei[1], np.arange(n_shards + 1) * nps,
                             side="left")
    slabs = [ei[:, starts[s]:starts[s + 1]] for s in range(n_shards)]
    perms = [order[starts[s]:starts[s + 1]] for s in range(n_shards)]
    e_shard = max(s.shape[1] for s in slabs)
    e_shard = int(-(-e_shard // 8) * 8)
    out = np.zeros((n_shards, e_shard, 2), dtype=np.int32)
    mask = np.zeros((n_shards, e_shard), dtype=bool)
    perm = np.full((n_shards, e_shard), -1, dtype=np.int64)
    for s, slab in enumerate(slabs):
        k = slab.shape[1]
        out[s, :k, 0] = slab[0]
        out[s, :k, 1] = slab[1]
        # padded edges target the slab's last node (masked out), so the
        # targets stay sorted within the slab: the window plan of K4/K5
        # and the sorted reduce search them
        out[s, k:, 1] = (s + 1) * nps - 1
        mask[s, :k] = True
        perm[s, :k] = perms[s]
    return EdgePartition(out.reshape(-1, 2), mask.reshape(-1), n_shards,
                         e_shard, nps, perm.reshape(-1))


def make_synthetic_complex(n_nodes: int, avg_degree: int, seed: int = 0,
                           locality: Optional[int] = None) -> np.ndarray:
    """Target-sorted synthetic incidence list (2, E) for the scaling
    benchmarks.  ``locality``: each source lies within +-locality of its
    target (mod n_nodes); None draws sources uniformly.  No self-loops: a
    self-loop's message input is exactly 0, the kink of the norm's smooth
    absolute value, where fp32 gradients are ill-conditioned."""
    rng = np.random.RandomState(seed)
    n_edges = n_nodes * avg_degree
    dst = rng.randint(0, n_nodes, size=n_edges, dtype=np.int64)
    if locality is None:
        src = rng.randint(0, n_nodes, size=n_edges, dtype=np.int64)
    else:
        off = rng.randint(-locality, locality + 1, size=n_edges)
        src = (dst + off) % n_nodes
    src = np.where(src == dst, (src + 1) % n_nodes, src)
    # the (src, dst) pairs in lexsort((src, dst)) order: repeated pairs are
    # equal, so sorting one int64 key a pair gives the same arrays
    keys = dst * n_nodes + src
    del src, dst
    keys.sort()
    return np.stack([keys % n_nodes, keys // n_nodes])


# ------------------------------------------------------------ device side

class StreamArrays:
    """The partition's (edge_index, edge_mask) on a device, and what each
    chunk needs that depends on them alone, built at first use and kept
    for later calls: its sources and local targets as int32, K4/K5's
    window plan, the masked in-degrees and the sort of its sources.
    Unpacks as the pair ``(edge_index, edge_mask)``."""

    def __init__(self, part: EdgePartition, edge_index: torch.Tensor,
                 edge_mask: torch.Tensor):
        n = part.n_shards * part.e_shard
        if tuple(edge_index.shape) != (n, 2) or tuple(edge_mask.shape) != (n,):
            raise ValueError(f"edge_index ({n}, 2) and edge_mask ({n},) "
                             f"expected, got {tuple(edge_index.shape)} and "
                             f"{tuple(edge_mask.shape)}")
        self.part = part
        self.edge_index = edge_index
        self.edge_mask = edge_mask.to(torch.bool)
        self._chunks: Dict[int, Tuple[torch.Tensor, ...]] = {}
        self._plans: Dict[tuple, object] = {}
        self._counts: Dict[int, torch.Tensor] = {}
        self._src_sort: Dict[int, Tuple[torch.Tensor, ...]] = {}

    @classmethod
    def of(cls, part: EdgePartition, device) -> "StreamArrays":
        return cls(part, torch.from_numpy(part.edge_index).to(device),
                   torch.from_numpy(part.edge_mask).to(device))

    def __iter__(self):
        return iter((self.edge_index, self.edge_mask))

    @property
    def device(self) -> torch.device:
        return self.edge_index.device

    def rows(self, s: int) -> slice:
        e2 = self.part.e_shard
        return slice(s * e2, (s + 1) * e2)

    def chunk(self, s: int):
        """(sources, targets local to the chunk, mask) of chunk s."""
        got = self._chunks.get(s)
        if got is None:
            ei = self.edge_index[self.rows(s)]
            base = s * self.part.nodes_per_shard
            got = (ei[:, 0].to(torch.int32).contiguous(),
                   (ei[:, 1] - base).to(torch.int32).contiguous(),
                   self.edge_mask[self.rows(s)])
            self._chunks[s] = got
        return got

    def plan(self, s: int, cm: int, ca: int, c: int, nb: int):
        """K4/K5's window plan of chunk s (on the card), else None."""
        if self.device.type != "cuda":
            return None
        key = (s, cm, ca, c, nb)
        plan = self._plans.get(key)
        if plan is None:
            _, dst, mask = self.chunk(s)
            plan = fe.make_plan(dst, mask, self.part.nodes_per_shard, cm, ca,
                                c, nb)
            self._plans[key] = plan
        return plan

    def counts(self, s: int) -> torch.Tensor:
        """Masked in-degree of chunk s's nodes, float32."""
        got = self._counts.get(s)
        if got is None:
            _, dst, mask = self.chunk(s)
            got = segment_counts(dst, self.part.nodes_per_shard, mask=mask,
                                 indices_are_sorted=True)
            self._counts[s] = got
        return got

    def src_sort(self, s: int):
        """(order, compact ids, distinct sources) of chunk s: the sources
        taken in ``order`` are ascending, ``compact`` numbers them 0..U-1
        and ``uniq`` holds the U distinct sources."""
        got = self._src_sort.get(s)
        if got is None:
            src = self.chunk(s)[0]
            order = torch.argsort(src, stable=True)
            uniq, compact = torch.unique_consecutive(
                src.index_select(0, order), return_inverse=True)
            got = (order.to(torch.int32), compact.to(torch.int32), uniq)
            self._src_sort[s] = got
        return got


def _stream_dtype(t: Optional[torch.Tensor], fused: bool):
    """Activation storage of the edge side, as ``EGCL.forward`` keeps it:
    bf16 on the card (or on the fused route) in fast mode."""
    if t is None or aggregation_exact() or not (fused or t.is_cuda):
        return t
    return t.to(torch.bfloat16)


def _slice(t: Optional[torch.Tensor], rows: slice):
    return None if t is None else t[rows]


@dataclass
class _Layer:
    """What the chunk loop of one call needs."""
    egcl: torch.nn.Module
    tabs: StreamArrays
    chunk_reduce: Optional[Callable]
    fused: bool

    @property
    def nps(self) -> int:
        return self.tabs.part.nodes_per_shard

    def own(self, s: int) -> slice:
        return slice(s * self.nps, (s + 1) * self.nps)

    def plan(self, s: int, h_s: torch.Tensor, ea: Optional[torch.Tensor]):
        em = self.egcl.edge_model
        ca = 0 if ea is None else ea.shape[1]
        return self.tabs.plan(s, h_s.shape[1], ca, em.hidden_features,
                              h_s.shape[2]) if self.fused else None

    def message_aggregate(self, s, h_s, h_j, ea_s):
        """``EGCL.message_aggregate`` of chunk s; on the fused route over
        the chunk's kept window plan and in-degrees."""
        _, dst, mask = self.tabs.chunk(s)
        h_own, ea = h_s[self.own(s)], _slice(ea_s, self.tabs.rows(s))
        if not self.fused:
            return self.egcl.message_aggregate(h_own, h_j, ea, dst, self.nps,
                                               mask)
        return fe.fused_message_aggregate(
            self.egcl.edge_model, h_own, h_j, ea, dst, mask,
            mean=self.egcl.aggr == "mean", plan=self.plan(s, h_s, ea_s),
            counts=self.tabs.counts(s))


def streaming_egcl_apply(egcl, h: torch.Tensor, part: EdgePartition,
                         arrays=None, remat: bool = True,
                         node_attr: Optional[torch.Tensor] = None,
                         edge_attr: Optional[torch.Tensor] = None,
                         chunk_reduce: Optional[Callable] = None
                         ) -> torch.Tensor:
    """One EGCL layer over the partition's chunks on h's device.

    ``h`` (N, C, nb) with N = n_shards * nodes_per_shard; ``arrays`` the
    partition's (edge_index, edge_mask) on h's device (a ``StreamArrays``
    keeps each chunk's tables for the next call); ``node_attr`` (N, C_n,
    nb); ``edge_attr`` in slab order (``permute_edge_payload``).  Returns
    (N, C_out, nb), or with ``chunk_reduce`` (a chunk's output -> a
    scalar) the float32 sum of the chunks' values, and the whole output is
    never held.  Gradients flow to the layer's parameters, ``h``,
    ``node_attr`` and ``edge_attr``."""
    if isinstance(arrays, StreamArrays):
        tabs = arrays
    elif arrays is None:
        tabs = StreamArrays.of(part, h.device)
    else:
        tabs = StreamArrays(part, *arrays)
    if tabs.part is not part and (
            (tabs.part.n_shards, tabs.part.e_shard, tabs.part.nodes_per_shard)
            != (part.n_shards, part.e_shard, part.nodes_per_shard)):
        raise ValueError("arrays were built for another partition")
    n = part.n_shards * part.nodes_per_shard
    if h.shape[0] != n or tabs.device != h.device:
        raise ValueError(f"h ({n}, C, nb) on the arrays' device expected, "
                         f"got {tuple(h.shape)} on {h.device}")
    layer = _Layer(egcl, tabs, chunk_reduce,
                   egcl._use_fused_mp(None, h))
    params = [*egcl.edge_model.parameters(), *egcl.node_model.parameters()]
    # the chunk loop alone where nothing needs a gradient: the remat
    # function would keep every chunk's aggregate for a backward
    if not remat or not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (h, node_attr, edge_attr, *params))):
        return _stream_autograd(layer, h, node_attr, edge_attr)
    return _StreamEGCL.apply(layer, h, node_attr, edge_attr, *params)


def _stream_autograd(layer: _Layer, h, node_attr, edge_attr):
    """remat=False, or no gradient needed: plain autograd through every
    chunk."""
    egcl, tabs = layer.egcl, layer.tabs
    h_s = _stream_dtype(h, layer.fused)
    ea_s = _stream_dtype(edge_attr, layer.fused)
    outs: List[torch.Tensor] = []
    acc = torch.zeros((), dtype=torch.float32, device=h.device)
    for s in range(tabs.part.n_shards):
        h_j = take_rows(h_s, tabs.chunk(s)[0])
        agg = layer.message_aggregate(s, h_s, h_j, ea_s)
        own = layer.own(s)
        out = egcl.update(h[own], agg, _slice(node_attr, own))
        if layer.chunk_reduce is not None:
            acc = acc + layer.chunk_reduce(out).to(torch.float32)
        else:
            outs.append(out)
    return acc if layer.chunk_reduce is not None else torch.cat(outs)


class _StreamEGCL(torch.autograd.Function):
    """remat=True: the forward keeps each chunk's aggregate; the backward
    recomputes each chunk's update under autograd and runs the edge side's
    backward from d(agg): K5 on the fused route, autograd of the recomputed
    composed route elsewhere."""

    @staticmethod
    def forward(ctx, layer: _Layer, h, node_attr, edge_attr, *params):
        egcl, tabs = layer.egcl, layer.tabs
        h_s = _stream_dtype(h, layer.fused)
        ea_s = _stream_dtype(edge_attr, layer.fused)
        aggs = out_all = None
        acc = torch.zeros((), dtype=torch.float32, device=h.device)
        for s in range(tabs.part.n_shards):
            h_j = h_s.index_select(0, tabs.chunk(s)[0])
            agg = layer.message_aggregate(s, h_s, h_j, ea_s)
            del h_j
            own = layer.own(s)
            if aggs is None:
                aggs = agg.new_empty((h.shape[0],) + tuple(agg.shape[1:]))
            aggs[own] = agg
            out = egcl.update(h[own], agg, _slice(node_attr, own))
            if layer.chunk_reduce is not None:
                acc += layer.chunk_reduce(out).to(torch.float32)
            else:
                if out_all is None:
                    out_all = out.new_empty((h.shape[0],)
                                            + tuple(out.shape[1:]))
                out_all[own] = out
        ctx.layer, ctx.aggs = layer, aggs
        ctx.save_for_backward(h, node_attr, edge_attr)
        return acc if layer.chunk_reduce is not None else out_all

    @staticmethod
    def backward(ctx, g):
        layer, aggs = ctx.layer, ctx.aggs
        egcl, tabs = layer.egcl, layer.tabs
        h, node_attr, edge_attr = ctx.saved_tensors
        need_h, need_na, need_ea = ctx.needs_input_grad[1:4]
        edge_params = list(egcl.edge_model.parameters())
        node_params = list(egcl.node_model.parameters())
        n_edge = len(edge_params)
        p_grads = [torch.zeros_like(p, dtype=torch.float32)
                   for p in edge_params + node_params]
        f32 = torch.float32
        dh = torch.zeros(h.shape, dtype=f32, device=h.device) \
            if need_h else None
        dna = torch.zeros(node_attr.shape, dtype=f32, device=h.device) \
            if need_na else None
        dea = torch.zeros(edge_attr.shape, dtype=f32, device=h.device) \
            if need_ea else None
        h_s = _stream_dtype(h, layer.fused)
        ea_s = _stream_dtype(edge_attr, layer.fused)
        for s in range(tabs.part.n_shards):
            own = layer.own(s)
            d_agg = _update_backward(layer, s, h, node_attr, aggs, g,
                                     node_params, p_grads[n_edge:], dh, dna)
            d_own, d_hj, d_ea = _edge_backward(layer, s, h_s, ea_s, d_agg,
                                               edge_params, p_grads[:n_edge],
                                               need_h, need_ea)
            if need_h:
                dh[own] += d_own.to(f32)
                _add_source_grads(tabs, s, d_hj, dh)
            if need_ea:
                dea[tabs.rows(s)] = d_ea.to(f32)
        ctx.aggs = None
        return (None,
                dh.to(h.dtype) if need_h else None,
                dna.to(node_attr.dtype) if need_na else None,
                dea.to(edge_attr.dtype) if need_ea else None,
                *p_grads)


def _update_backward(layer: _Layer, s: int, h, node_attr, aggs, g,
                     node_params, p_grads, dh, dna) -> torch.Tensor:
    """Recompute chunk s's update under autograd; add its node-side
    parameter gradients to ``p_grads``, d(h_own) to ``dh`` and d(node_attr)
    to ``dna``.  Returns d(agg)."""
    own = layer.own(s)
    with torch.enable_grad():
        agg = aggs[own].detach().requires_grad_(True)
        h_own = h[own].detach().requires_grad_(dh is not None)
        na = _slice(node_attr, own)
        if na is not None:
            na = na.detach().requires_grad_(dna is not None)
        out = layer.egcl.update(h_own, agg, na)
        if layer.chunk_reduce is not None:
            y, gy = layer.chunk_reduce(out), g
        else:
            y, gy = out, g[own]
        ins = [agg] + ([h_own] if dh is not None else []) \
            + ([na] if dna is not None else [])
        grads = torch.autograd.grad(y, ins + node_params, gy,
                                    allow_unused=True)
    for acc, gr in zip(p_grads, grads[len(ins):]):
        if gr is not None:
            acc += gr
    i = 1
    if dh is not None:
        dh[own] += grads[i].to(dh.dtype)
        i += 1
    if dna is not None:
        dna[own] = grads[i].to(dna.dtype)
    return grads[0]


def _edge_backward(layer: _Layer, s: int, h_s, ea_s, d_agg, edge_params,
                   p_grads, need_h: bool, need_ea: bool):
    """The edge side's backward of chunk s from d(agg): adds its parameter
    gradients to ``p_grads``; returns (d(h_own), d(h_j), d(edge_attr)), each
    None where not needed.  The source rows are gathered again as the
    forward gathered them."""
    egcl, tabs = layer.egcl, layer.tabs
    src, dst, mask = tabs.chunk(s)
    own, rows = layer.own(s), tabs.rows(s)
    h_own = h_s[own]
    h_j = h_s.index_select(0, src)
    ea = _slice(ea_s, rows)
    if layer.fused:
        # K5 over the window plan K4 used
        d_own, d_hj, d_ea, grads = fe.fused_message_aggregate_backward(
            egcl.edge_model, h_own, h_j, ea, dst, mask, d_agg,
            mean=egcl.aggr == "mean", plan=layer.plan(s, h_s, ea_s),
            counts=tabs.counts(s))
        for acc, gr in zip(p_grads, grads):
            acc += gr
        return d_own, d_hj, d_ea
    with torch.enable_grad():
        ins = [h_own.detach().requires_grad_(need_h),
               h_j.requires_grad_(need_h),
               ea.detach().requires_grad_(need_ea) if ea is not None
               else None]
        agg = egcl.message_aggregate(ins[0], ins[1], ins[2], dst,
                                     layer.nps, mask)
        leaves = [t for t in ins if t is not None and t.requires_grad]
        grads = torch.autograd.grad(agg, leaves + edge_params, d_agg,
                                    allow_unused=True)
    for acc, gr in zip(p_grads, grads[len(leaves):]):
        if gr is not None:
            acc += gr
    it = iter(grads[:len(leaves)])
    d_own, d_hj = (next(it), next(it)) if need_h else (None, None)
    d_ea = next(it) if need_ea and ea is not None else None
    return d_own, d_hj, d_ea


def _add_source_grads(tabs: StreamArrays, s: int, d_hj: torch.Tensor,
                      dh: torch.Tensor) -> None:
    """dh[src] += d(h_j) for chunk s: the rows taken in source order,
    summed by K1 over the chunk's distinct sources, added with unique
    indices (no colliding atomics, no (N, C, nb) tensor a chunk)."""
    order, compact, uniq = tabs.src_sort(s)
    flat = d_hj.reshape(d_hj.shape[0], -1).index_select(0, order)
    # rows rounded to bf16 on the card in fast mode, as the gather's own
    # backward (``take_rows``) sums them; fp32 on the CPU
    rows, _ = sorted_segment_sum(flat, compact, uniq.shape[0],
                                 aggregation_exact() or not flat.is_cuda)
    dh.view(dh.shape[0], -1).index_add_(0, uniq, rows)

