"""Edge partition by target node; one EGCL layer streamed over its chunks
on one card, and sharded over the ranks of a process group.

Port of ``csmpn_tpu/parallel/edge_partition.py``.  The host-side tables
(numpy, the reference's arrays byte for byte): ``EdgePartition``,
``permute_edge_payload``, ``partition_edges``, ``make_synthetic_complex``,
and the halo forms ``HaloPartition`` / ``partition_edges_halo`` and
``HaloStreamPartition`` / ``partition_edges_halo_stream``.  Chunk (or
shard) s owns the contiguous node range [s * nps, (s + 1) * nps) and every
edge that targets it, so it is a contiguous slab of the target-sorted
edge list, padded to a common length with masked edges.

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

Across ranks (one process per card, a ``torch.distributed`` group; the
reference's ``shard_map`` over a mesh axis): rank r holds shard r's
node rows and edge slab and exchanges features once a layer, as a
differentiable autograd function.  The halo exchange
(``sharded_egcl_apply_halo``, ``sharded_streaming_egcl_apply``) is one
``all_to_all_single`` of the rows other ranks read, with uneven splits,
so only real rows travel (the reference ships n_shards * h_max padded
rows a rank); the received rows land in the reference's padded [local |
halo] layout, which the remapped sources index.  The all-gather
(``sharded_egcl_apply``, ``sharded_streaming_egcl_apply_allgather``)
gathers every rank's rows; its backward is a reduce-scatter.  After the
exchange a rank runs the reference's shard body (``egcl_shard_body``), or
streams its chunks through the machinery above.  Parameters are
replicated, so their gradient is the sum of the ranks' terms
(``mesh.all_reduce_grads(..., reduce="sum")``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import fused_egcl as fe
from ..ops.segment import (
    aggregation_exact,
    segment_counts,
    take_rows,
    take_rows_sorted_idx,
)
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


def _ceil8(n: int) -> int:
    return int(-(-n // 8) * 8)


def _target_sorted(edge_index: np.ndarray, n_nodes: int, n_shards: int):
    """The (2, E) edge list sorted by (target, source), the sort's order
    and each slab's first row: (edges, order, starts, nodes a slab)."""
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
    return ei, order, starts, nps


def partition_edges(edge_index: np.ndarray, n_nodes: int,
                    n_shards: int) -> EdgePartition:
    """Partition a (2, E) edge list into contiguous per-chunk slabs of the
    target-sorted list, padded to a common length (rounded up to 8)."""
    ei, order, starts, nps = _target_sorted(edge_index, n_nodes, n_shards)
    e_shard = _ceil8(int(np.diff(starts).max()))
    out = np.zeros((n_shards, e_shard, 2), dtype=np.int32)
    mask = np.zeros((n_shards, e_shard), dtype=bool)
    perm = np.full((n_shards, e_shard), -1, dtype=np.int64)
    for s in range(n_shards):
        a, b = starts[s], starts[s + 1]
        k = b - a
        out[s, :k, 0] = ei[0, a:b]
        out[s, :k, 1] = ei[1, a:b]
        # padded edges target the slab's last node (masked out), so the
        # targets stay sorted within the slab: the window plan of K4/K5
        # and the sorted reduce search them
        out[s, k:, 1] = (s + 1) * nps - 1
        mask[s, :k] = True
        perm[s, :k] = order[a:b]
    return EdgePartition(out.reshape(-1, 2), mask.reshape(-1), n_shards,
                         e_shard, nps, perm.reshape(-1))


@dataclass(frozen=True)
class HaloPartition:
    """Edge partition by target shard with the tables of the halo exchange.

    Shard s owns nodes [s * nps, (s + 1) * nps).  ``send_idx[o, s]`` lists
    the local ids of the nodes shard o sends to shard s, ascending (padded
    with 0, masked by ``send_mask``).  Shard s sees what it receives in
    the padded layout (n_shards, h_max): row (o, p) is o's p-th node sent
    to s.  The slabs' sources are remapped into [local nodes | that
    layout]: a local source v -> v - s * nps, a remote one (o, p) -> nps +
    o * h_max + p; targets are local ids."""

    edge_index: np.ndarray    # (n_shards * e_shard, 2) [src_remapped, dst]
    edge_mask: np.ndarray     # (n_shards * e_shard,)
    send_idx: np.ndarray      # (n_shards, n_shards, h_max) local ids
    send_mask: np.ndarray     # (n_shards, n_shards, h_max)
    n_shards: int
    e_shard: int
    h_max: int
    nodes_per_shard: int
    # slab slot -> original edge id (-1 padding); see permute_edge_payload
    edge_perm: Optional[np.ndarray] = None


def partition_edges_halo(edge_index: np.ndarray, n_nodes: int,
                         n_shards: int) -> HaloPartition:
    """Partition edges by target shard and build the halo: for every
    (owner, consumer) pair the owner's nodes the consumer's edges read.
    The exchange then ships sum(|halo|) rows, not n_shards * N.

    The reference loops over every remote node and every remote edge in
    Python; here a consumer's remote ids come from one ``np.unique``
    (ascending, so an owner's ids are one contiguous run of them), a
    remote node's slot p is its rank within its owner's run, and the
    remote sources are remapped through a table of every node's slot."""
    ei, order, starts, nps = _target_sorted(edge_index, n_nodes, n_shards)
    e_shard = _ceil8(int(np.diff(starts).max()))
    owners = np.arange(n_shards) * nps
    remotes, runs = [], []     # per consumer: remote ids, each owner's start
    counts = np.zeros((n_shards, n_shards), dtype=np.int64)   # [o, s]
    for s in range(n_shards):
        src = ei[0, starts[s]:starts[s + 1]].astype(np.int64)
        lo = s * nps
        r = np.unique(src[(src < lo) | (src >= lo + nps)])
        runs.append(np.searchsorted(r, owners))
        counts[:, s] = np.diff(np.append(runs[-1], r.size))
        remotes.append(r)
    h_max = max(_ceil8(int(counts.max())), 8)
    send_idx = np.zeros((n_shards, n_shards, h_max), dtype=np.int32)
    send_mask = np.zeros((n_shards, n_shards, h_max), dtype=bool)
    out = np.zeros((n_shards, e_shard, 2), dtype=np.int32)
    mask = np.zeros((n_shards, e_shard), dtype=bool)
    perm = np.full((n_shards, e_shard), -1, dtype=np.int64)
    slot = np.zeros(n_nodes, dtype=np.int64)   # a remote node's halo slot
    for s, (r, run) in enumerate(zip(remotes, runs)):
        o = r // nps
        p = np.arange(r.size) - run[o]
        send_idx[o, s, p] = r - o * nps
        send_mask[o, s, p] = True
        slot[r] = nps + o * h_max + p
        a, b = starts[s], starts[s + 1]
        k, lo = b - a, s * nps
        src = ei[0, a:b].astype(np.int64)
        local = (src >= lo) & (src < lo + nps)
        remap = np.where(local, src - lo, 0)
        remap[~local] = slot[src[~local]]
        out[s, :k, 0] = remap
        out[s, :k, 1] = ei[1, a:b] - lo        # local target ids
        out[s, k:, 1] = nps - 1                # padded: the last local node
        mask[s, :k] = True
        perm[s, :k] = order[a:b]
    return HaloPartition(out.reshape(-1, 2), mask.reshape(-1), send_idx,
                         send_mask, n_shards, e_shard, h_max, nps,
                         perm.reshape(-1))


@dataclass(frozen=True)
class HaloStreamPartition:
    """Two-level partition: the nodes sharded over ``n_shards`` ranks with
    a halo exchange (as ``HaloPartition``), and each rank's slab cut into
    ``n_chunks`` target-contiguous chunk slabs that the rank streams.
    Rank s owns nodes [s * nps, (s + 1) * nps); its chunk c the local
    nodes [c * ncs, (c + 1) * ncs).  ``edge_index`` rows are [source in
    HaloPartition's [local | halo] layout, rank-local target], the
    targets ascending within each chunk slab."""

    edge_index: np.ndarray    # (n_shards * n_chunks * e_chunk, 2)
    edge_mask: np.ndarray     # (n_shards * n_chunks * e_chunk,)
    send_idx: np.ndarray      # (n_shards, n_shards, h_max) local ids
    send_mask: np.ndarray     # (n_shards, n_shards, h_max)
    n_shards: int
    n_chunks: int
    e_chunk: int
    h_max: int
    nodes_per_shard: int
    nodes_per_chunk: int
    # slab slot -> original edge id (-1 padding); see permute_edge_payload
    edge_perm: Optional[np.ndarray] = None


def partition_edges_halo_stream(edge_index: np.ndarray, n_nodes: int,
                                n_shards: int,
                                n_chunks: int) -> HaloStreamPartition:
    """``partition_edges_halo``, each rank's slab re-cut along its sorted
    local targets into ``n_chunks`` chunk slabs."""
    halo = partition_edges_halo(edge_index, n_nodes, n_shards)
    nps = halo.nodes_per_shard
    if nps % n_chunks:
        raise ValueError(f"pad nodes so that a shard's {nps} nodes are a "
                         f"multiple of n_chunks = {n_chunks}")
    ncs = nps // n_chunks
    e2 = halo.e_shard
    ei = halo.edge_index.reshape(n_shards, e2, 2)
    # a slab's real edges are its first rows
    k_s = halo.edge_mask.reshape(n_shards, e2).sum(1)
    starts = [np.searchsorted(ei[s, :k_s[s], 1], np.arange(n_chunks + 1)
                              * ncs, side="left") for s in range(n_shards)]
    e_chunk = max(_ceil8(int(max(np.diff(st).max() for st in starts))), 8)
    out = np.zeros((n_shards, n_chunks, e_chunk, 2), dtype=np.int32)
    omask = np.zeros((n_shards, n_chunks, e_chunk), dtype=bool)
    operm = np.full((n_shards, n_chunks, e_chunk), -1, dtype=np.int64)
    perm = halo.edge_perm.reshape(n_shards, e2)
    for s in range(n_shards):
        for c in range(n_chunks):
            a, b = starts[s][c], starts[s][c + 1]
            k = b - a
            out[s, c, :k] = ei[s, a:b]
            # padded targets: the chunk's last local node keeps the targets
            # ascending
            out[s, c, k:, 1] = (c + 1) * ncs - 1
            omask[s, c, :k] = True
            operm[s, c, :k] = perm[s, a:b]
    return HaloStreamPartition(
        out.reshape(-1, 2), omask.reshape(-1), halo.send_idx,
        halo.send_mask, n_shards, n_chunks, e_chunk, halo.h_max, nps, ncs,
        operm.reshape(-1))


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
        """The fused kernels' window plan of chunk s (on the card), else
        None: made for the route of these widths in the aggregation mode
        (K4/K5 or, past their widths, K4w/K5w), and kept by both."""
        if self.device.type != "cuda":
            return None
        exact = aggregation_exact()
        key = (s, cm, ca, c, nb, exact)
        plan = self._plans.get(key)
        if plan is None:
            _, dst, mask = self.chunk(s)
            plan = fe.make_plan(dst, mask, self.part.nodes_per_shard, cm, ca,
                                c, nb, exact)
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
    base: int = 0      # the row of the source features where node 0 lies

    @property
    def nps(self) -> int:
        return self.tabs.part.nodes_per_shard

    @property
    def n_own(self) -> int:
        """The nodes the chunks own: rows ``base`` on of the source
        features."""
        return self.tabs.part.n_shards * self.nps

    def own(self, s: int) -> slice:
        """Chunk s's nodes among the nodes the chunks own."""
        return slice(s * self.nps, (s + 1) * self.nps)

    def src_rows(self, s: int) -> slice:
        """Chunk s's nodes among the rows of the source features."""
        return slice(self.base + s * self.nps, self.base + (s + 1) * self.nps)

    def plan(self, s: int, h_s: torch.Tensor, ea: Optional[torch.Tensor]):
        em = self.egcl.edge_model
        ca = 0 if ea is None else ea.shape[1]
        return self.tabs.plan(s, h_s.shape[1], ca, em.hidden_features,
                              h_s.shape[2]) if self.fused else None

    def message_aggregate(self, s, h_s, h_j, ea_s):
        """``EGCL.message_aggregate`` of chunk s; on the fused route over
        the chunk's kept window plan and in-degrees."""
        _, dst, mask = self.tabs.chunk(s)
        h_own, ea = h_s[self.src_rows(s)], _slice(ea_s, self.tabs.rows(s))
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
    if h.shape[0] != n:
        raise ValueError(f"h ({n}, C, nb) expected, got {tuple(h.shape)}")
    return _stream_layer(egcl, h, tabs, remat, node_attr, edge_attr,
                         chunk_reduce)


def _stream_layer(egcl, h: torch.Tensor, tabs: StreamArrays, remat: bool,
                  node_attr, edge_attr, chunk_reduce, base: int = 0):
    """The chunk loop over ``tabs``: the sources index all of ``h``, the
    chunks own its ``n_shards * nodes_per_shard`` rows from ``base`` on
    (all of them on one card; a rank's own rows, before its halo or among
    every rank's rows, when sharded)."""
    if tabs.device != h.device:
        raise ValueError(f"h on {h.device}, the arrays on {tabs.device}")
    layer = _Layer(egcl, tabs, chunk_reduce,
                   egcl._use_fused_mp(None, h), base)
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
        out = egcl.update(h[layer.src_rows(s)], agg, _slice(node_attr, own))
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
            own, rows = layer.own(s), layer.src_rows(s)
            if aggs is None:
                aggs = agg.new_empty((layer.n_own,) + tuple(agg.shape[1:]))
            aggs[own] = agg
            out = egcl.update(h[rows], agg, _slice(node_attr, own))
            if layer.chunk_reduce is not None:
                acc += layer.chunk_reduce(out).to(torch.float32)
            else:
                if out_all is None:
                    out_all = out.new_empty((layer.n_own,)
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
            d_agg = _update_backward(layer, s, h, node_attr, aggs, g,
                                     node_params, p_grads[n_edge:], dh, dna)
            d_own, d_hj, d_ea = _edge_backward(layer, s, h_s, ea_s, d_agg,
                                               edge_params, p_grads[:n_edge],
                                               need_h, need_ea)
            if need_h:
                dh[layer.src_rows(s)] += d_own.to(f32)
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
        h_own = h[layer.src_rows(s)].detach().requires_grad_(dh is not None)
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
        dh[layer.src_rows(s)] += grads[i].to(dh.dtype)
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
    rows = tabs.rows(s)
    h_own = h_s[layer.src_rows(s)]
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



# ------------------------------------------------------------ across ranks

def group_rank(group=None) -> Tuple[int, int]:
    """(rank, world size) of this process in ``group`` (the default group
    when None).  Raises when no process group is up or this process is not
    in ``group``."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "edge-partitioned message passing needs a process group: launch "
            "one process per card with python -m torch.distributed.run "
            "--nproc_per_node N")
    rank = dist.get_rank(group)
    if rank < 0:
        raise RuntimeError("this process is not a member of the group")
    return rank, dist.get_world_size(group)


class ShardArrays:
    """One rank's share of a partition on its device, built at first use
    and kept for later calls.

    ``local``: the rank's edge rows as a partition of its own nodes (its
    chunks; one chunk when it does not stream), targets local to the rank,
    sources in the layout its exchange gives (``StreamArrays``).  The
    halo exchange's tables: ``send_ids`` (the local ids it sends, to rank
    0 first), ``send_counts`` and ``recv_counts`` (rows to and from each
    rank: only the real rows travel) and ``recv_slots`` (where the rows
    received land in [local nodes | the padded halo layout])."""

    def __init__(self, part, rank: int, n_ranks: int, device):
        if isinstance(part, EdgePartition):       # the all-gather forms
            if part.n_shards % n_ranks:
                raise ValueError(f"{part.n_shards} slabs do not split over "
                                 f"{n_ranks} ranks")
            k, e2, ncs = (part.n_shards // n_ranks, part.e_shard,
                          part.nodes_per_shard)
            ei = part.edge_index[rank * k * e2:(rank + 1) * k * e2].copy()
            ei[:, 1] -= rank * k * ncs
            self.halo = False
        else:
            if part.n_shards != n_ranks:
                raise ValueError(f"a partition of {part.n_shards} shards "
                                 f"over {n_ranks} ranks")
            if isinstance(part, HaloPartition):
                k, e2, ncs = 1, part.e_shard, part.nodes_per_shard
            else:
                k, e2, ncs = (part.n_chunks, part.e_chunk,
                              part.nodes_per_chunk)
            ei = part.edge_index[rank * k * e2:(rank + 1) * k * e2]
            self.halo = True
        rows = slice(rank * k * e2, (rank + 1) * k * e2)
        self.local = StreamArrays.of(
            EdgePartition(ei, part.edge_mask[rows], k, e2, ncs), device)
        self.rank, self.n_ranks, self.part = rank, n_ranks, part
        self.n_own = k * ncs
        # the row of the exchanged features where the rank's nodes begin
        self.base = 0 if self.halo else rank * self.n_own
        if not self.halo:
            return
        counts = part.send_mask.sum(-1)           # [owner, consumer]
        n, hm = part.n_shards, part.h_max
        self.send_counts = [int(c) for c in counts[rank]]
        self.recv_counts = [int(c) for c in counts[:, rank]]
        send = np.concatenate([part.send_idx[rank, s, :counts[rank, s]]
                               for s in range(n)]).astype(np.int64)
        slots = np.concatenate([o * hm + np.arange(counts[o, rank])
                                for o in range(n)]).astype(np.int64)
        self.send_ids = torch.from_numpy(send).to(device)
        self.recv_slots = torch.from_numpy(self.n_own + slots).to(device)
        self.n_ext = self.n_own + n * hm


class _HaloExchange(torch.autograd.Function):
    """[h_local | halo]: this rank's rows, then the rows the other ranks
    send it at their slots of the padded halo layout (zeros elsewhere).
    One ``all_to_all_single`` of the real rows with uneven splits; its
    backward sends the received slots' cotangents back the same way and
    adds them into d(h_local) at the ids sent."""

    @staticmethod
    def forward(ctx, h_local, tabs: ShardArrays, group):
        rest = tuple(h_local.shape[1:])
        send = h_local.index_select(0, tabs.send_ids)
        recv = h_local.new_empty((sum(tabs.recv_counts),) + rest)
        dist.all_to_all_single(recv, send, tabs.recv_counts,
                               tabs.send_counts, group=group)
        h_ext = h_local.new_zeros((tabs.n_ext,) + rest)
        h_ext[:tabs.n_own] = h_local
        h_ext.index_copy_(0, tabs.recv_slots, recv)
        ctx.tabs, ctx.group = tabs, group
        return h_ext

    @staticmethod
    def backward(ctx, g):
        tabs = ctx.tabs
        g_recv = g.index_select(0, tabs.recv_slots)
        g_send = g.new_empty((sum(tabs.send_counts),) + tuple(g.shape[1:]))
        dist.all_to_all_single(g_send, g_recv, tabs.send_counts,
                               tabs.recv_counts, group=ctx.group)
        dh = g[:tabs.n_own].to(torch.float32)
        dh.index_add_(0, tabs.send_ids, g_send.to(torch.float32))
        return dh.to(g.dtype), None, None


class _AllGather(torch.autograd.Function):
    """Every rank's rows, rank 0's first (``all_gather_into_tensor``); the
    backward sums the cotangents of this rank's rows over the ranks (a
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, h_local, group):
        world = dist.get_world_size(group)
        out = h_local.new_empty((world * h_local.shape[0],)
                                + tuple(h_local.shape[1:]))
        dist.all_gather_into_tensor(out, h_local.contiguous(), group=group)
        ctx.group, ctx.world = group, world
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = g.new_empty((g.shape[0] // ctx.world,) + tuple(g.shape[1:]))
        dist.reduce_scatter(out, list(g.chunk(ctx.world)),
                            op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None


class _SumOverRanks(torch.autograd.Function):
    """A scalar summed over the ranks, whose gradient on each rank is the
    cotangent itself: each rank backpropagates its own term, and an
    all-reduce of the cotangent would scale every gradient by the world
    size."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_ranks(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``group``, the same value on each;
    on each rank its gradient is the cotangent itself, as each rank
    backpropagates its own term."""
    return _SumOverRanks.apply(x, group)


def _shard_arrays(part, arrays, h_local: torch.Tensor, group
                  ) -> ShardArrays:
    rank, world = group_rank(group)
    if arrays is None:
        arrays = ShardArrays(part, rank, world, h_local.device)
    elif (arrays.part is not part or arrays.rank != rank
          or arrays.n_ranks != world):
        raise ValueError("arrays were built for another partition or rank")
    if h_local.shape[0] != arrays.n_own:
        raise ValueError(f"this rank's h ({arrays.n_own}, C, nb) expected, "
                         f"got {tuple(h_local.shape)}")
    return arrays


def exchange(h_local: torch.Tensor, tabs: ShardArrays, group=None
             ) -> torch.Tensor:
    """The rows this rank's edges read: [h_local | halo] or every rank's
    rows; differentiable."""
    if tabs.halo:
        return _HaloExchange.apply(h_local, tabs, group)
    return _AllGather.apply(h_local, group)


def egcl_shard_body(egcl, h_local: torch.Tensor, h_src: torch.Tensor,
                    src: torch.Tensor, dst: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    node_attr: Optional[torch.Tensor] = None,
                    edge_attr: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """One rank's EGCL layer after its exchange, the reference's shard
    function: the source rows gathered from ``h_src`` ([h_local | halo]
    or every rank's rows), the target rows from ``h_local`` (``dst``
    local and ascending), ``EGCL.message``, ``EGCL.aggregate`` (a masked
    mean or sum over the rank's nodes), ``EGCL.update``.  On the card in
    fast mode the gathers move bf16 rows, as ``EGCL.forward``'s composed
    route does; the edge CEMLP runs K2/K3, the aggregation K1."""
    if h_local.is_cuda and not aggregation_exact():
        hl_s, hs_s = h_local.to(torch.bfloat16), h_src.to(torch.bfloat16)
        ea_s = None if edge_attr is None else edge_attr.to(torch.bfloat16)
    else:
        hl_s, hs_s, ea_s = h_local, h_src, edge_attr
    h_i = take_rows_sorted_idx(hl_s, dst)
    h_j = take_rows(hs_s, src)
    msg = egcl.message(h_i, h_j, ea_s)
    agg = egcl.aggregate(msg, dst, h_local.shape[0], mask)
    return egcl.update(h_local, agg.to(h_local.dtype), node_attr)


def _apply(egcl, h_local, part, arrays, group, node_attr, edge_attr):
    tabs = _shard_arrays(part, arrays, h_local, group)
    if tabs.local.part.n_shards != 1:
        raise ValueError("a partition of one slab a rank expected; stream "
                         "one of several chunks a rank")
    src, dst, mask = tabs.local.chunk(0)
    return egcl_shard_body(egcl, h_local, exchange(h_local, tabs, group),
                           src, dst, mask, node_attr, edge_attr)


def sharded_egcl_apply(egcl, h_local: torch.Tensor, part: EdgePartition,
                       node_attr: Optional[torch.Tensor] = None,
                       edge_attr: Optional[torch.Tensor] = None,
                       arrays: Optional[ShardArrays] = None, group=None
                       ) -> torch.Tensor:
    """One EGCL layer over a complex whose nodes are sharded over the ranks
    of ``group``, one slab of ``part`` (``n_shards`` = the world size) a
    rank, exchanging features by an all-gather.

    Each rank passes its own rows: ``h_local`` (nps, C, nb), ``node_attr``
    (nps, C_n, nb), ``edge_attr`` its slab's rows in slab order
    (``permute_edge_payload``), and gets back its (nps, C_out, nb) rows.
    Gradients flow to every rank's ``h_local`` through the exchange; each
    rank's parameter gradients are its own term, so sum them over the
    ranks (``mesh.all_reduce_grads(..., reduce="sum")``).  ``arrays``: a
    ``ShardArrays`` kept from an earlier call."""
    return _apply(egcl, h_local, part, arrays, group, node_attr, edge_attr)


def sharded_egcl_apply_halo(egcl, h_local: torch.Tensor, part: HaloPartition,
                            node_attr: Optional[torch.Tensor] = None,
                            edge_attr: Optional[torch.Tensor] = None,
                            arrays: Optional[ShardArrays] = None, group=None
                            ) -> torch.Tensor:
    """``sharded_egcl_apply`` with the halo exchange: each rank receives
    only the rows of other ranks' nodes its edges read."""
    return _apply(egcl, h_local, part, arrays, group, node_attr, edge_attr)


def _apply_streamed(egcl, h_local, part, arrays, group, node_attr,
                    edge_attr, remat, chunk_reduce):
    tabs = _shard_arrays(part, arrays, h_local, group)
    out = _stream_layer(egcl, exchange(h_local, tabs, group), tabs.local,
                        remat, node_attr, edge_attr, chunk_reduce, tabs.base)
    return out if chunk_reduce is None else sum_over_ranks(out, group)


def sharded_streaming_egcl_apply(egcl, h_local: torch.Tensor,
                                 part: HaloStreamPartition,
                                 node_attr: Optional[torch.Tensor] = None,
                                 edge_attr: Optional[torch.Tensor] = None,
                                 arrays: Optional[ShardArrays] = None,
                                 remat: bool = True,
                                 chunk_reduce: Optional[Callable] = None,
                                 group=None) -> torch.Tensor:
    """One EGCL layer over a complex sharded over the ranks and streamed on
    each: the halo exchanged once, then the rank's chunks one after
    another as ``streaming_egcl_apply`` runs them (K4 forward and K5
    backward once a chunk on the card in fast mode), the sources read
    from [h_local | halo].  Arguments and gradients as
    ``sharded_egcl_apply``; ``edge_attr`` the rank's rows in chunk-slab
    order.  With ``chunk_reduce`` returns the float32 sum of every rank's
    chunk values (the same scalar on every rank; each rank's backward is
    its own term's) instead of the rank's rows."""
    return _apply_streamed(egcl, h_local, part, arrays, group, node_attr,
                           edge_attr, remat, chunk_reduce)


def sharded_streaming_egcl_apply_allgather(
        egcl, h_local: torch.Tensor, part: EdgePartition,
        node_attr: Optional[torch.Tensor] = None,
        edge_attr: Optional[torch.Tensor] = None,
        arrays: Optional[ShardArrays] = None, remat: bool = True,
        chunk_reduce: Optional[Callable] = None,
        group=None) -> torch.Tensor:
    """``sharded_streaming_egcl_apply`` with every rank's rows all-gathered
    once a layer: ``part`` from ``partition_edges`` with ``n_shards`` =
    world size x chunks a rank, so rank r streams slabs [r * k, (r + 1) *
    k) over global source ids."""
    return _apply_streamed(egcl, h_local, part, arrays, group, node_attr,
                           edge_attr, remat, chunk_reduce)
