"""Shared model machinery for the CSMPN task models.

Port of ``csmpn_tpu/models/common.py``:

  * the permutation-summed Clifford embedding of simplices — the ragged
    (d+1)! expansion is a static unrolled gather per dimension section;
  * simplex-type conditioning (one-hot or a learned embedding) at grade
    0, and the derived edge attributes;
  * the flattening of a batch of padded graphs to global ids, masked
    mean-centering and masked global mean pooling.
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..algebra.clifford import CliffordAlgebra
from ..data.batching import PaddingSpec, SimplicialBatch
from ..nn.modules import CEMLP, MVLinear, _normal_
from ..ops.segment import (
    batched_take,
    masked_mean,
    take_rows_presorted,
    take_rows_sorted_idx,
)


def section_slices(spec: PaddingSpec) -> List[slice]:
    off = spec.offsets
    return [slice(int(off[d]), int(off[d + 1]))
            for d in range(len(spec.counts_max))]


def gather_vertex_features(feat: torch.Tensor, x_ind: torch.Tensor,
                           d: int) -> torch.Tensor:
    """feat (B, N, ...) node-level; x_ind (B, N_d, >= d+1) vertex ids.
    Returns (B, N_d, d+1, ...)."""
    return batched_take(feat, x_ind[:, :, : d + 1])


def permutation_expand(x: torch.Tensor, d: int) -> torch.Tensor:
    """(B, S, d+1, ...) -> (B, S, P, d+1, ...) over all (d+1)! orders."""
    perms = torch.as_tensor(
        np.asarray(list(itertools.permutations(range(d + 1))),
                   dtype=np.int64), device=x.device)
    return x[:, :, perms]


class SimplexEmbedding(nn.Module):
    """Per-dimension Clifford feature embedding with permutation symmetry:
    for each simplex dimension d, every vertex-order permutation of the
    simplex's per-vertex features is embedded (grade given per feature),
    pushed through a per-dim network and summed over permutations.  The
    network is MVLinear for d = 0 and a CEMLP with d blocks above, this
    module's ``embed_{d}``; ``out_channels`` defaults to ``num_hidden``.
    With ``net_builder`` the network is ``net_builder(d, (d + 1) *
    num_input, out_channels)`` instead (NBA's embedding stack), owned by
    the builder's module: as in the flax tree, its parameters are the
    caller's, not this module's, so it is held here unregistered."""

    def __init__(self, algebra: CliffordAlgebra, spec: PaddingSpec,
                 feature_spec: Sequence[Tuple[str, int]], num_input: int,
                 num_hidden: int, max_dim: int = 2,
                 out_channels: Optional[int] = None,
                 net_builder: Optional[Callable[[int, int, int],
                                                nn.Module]] = None):
        super().__init__()
        self.algebra = algebra
        self.spec = spec
        self.feature_spec = tuple(feature_spec)
        self.max_dim = max_dim
        out_ch = out_channels or num_hidden
        secs = section_slices(spec)
        self.dims = [d for d in range(max_dim + 1)
                     if secs[d].start != secs[d].stop]
        self._built: Dict[int, nn.Module] = {}   # not registered
        for d in self.dims:
            if net_builder is not None:
                self._built[d] = net_builder(d, (d + 1) * num_input, out_ch)
            elif d == 0:
                self.embed_0 = MVLinear(algebra, num_input, out_ch,
                                        subspaces=False)
            else:
                setattr(self, f"embed_{d}", CEMLP(
                    algebra, (d + 1) * num_input, num_hidden, out_ch,
                    n_layers=d))

    def forward(self, batch: SimplicialBatch,
                features: Dict[str, torch.Tensor]) -> torch.Tensor:
        alg = self.algebra
        secs = section_slices(self.spec)
        outs = []
        for d in self.dims:
            x_ind_d = batch.x_ind[:, secs[d]]
            chans = []
            for name, grade in self.feature_spec:
                f = features[name]
                if f.dim() == 3:                     # (B, N, dim) -> (B, N, 1, dim)
                    f = f[:, :, None, :]
                g = gather_vertex_features(f, x_ind_d, d)  # (B,S,d+1,F,dim)
                g = permutation_expand(g, d)               # (B,S,P,d+1,F,dim)
                B, S, P = g.shape[:3]
                g = g.reshape(B, S, P, (d + 1) * g.shape[4], g.shape[5])
                chans.append(alg.embed_grade(g, grade))
            feats = torch.cat(chans, dim=-2)
            net = self._built.get(d) or getattr(self, f"embed_{d}")
            emb = net(feats).sum(dim=2)
            outs.append(emb)
        return torch.cat(outs, dim=1)                # (B, N, out_ch, nb)


class SimplexTypeConditioning(nn.Module):
    """Node/edge conditioning on the simplex dimension, at grade 0:
    ``mode="onehot"`` a one-hot code with no parameter (hulls),
    ``mode="embed"`` a learned embedding table (motion, MD17, NBA).
    Returns (node_attr_flat, edge_attr_flat) for the flattened big
    graph."""

    def __init__(self, algebra: CliffordAlgebra, num_types: int,
                 mode: str = "onehot"):
        super().__init__()
        if mode not in ("onehot", "embed"):
            raise ValueError(f"unknown conditioning mode {mode!r}")
        self.algebra = algebra
        self.num_types = num_types
        self.mode = mode
        if num_types and mode == "embed":
            self.embedding = nn.Parameter(torch.empty(num_types, num_types))
            self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        if self.num_types and self.mode == "embed":
            _normal_(self.embedding, 1.0, generator)

    def forward(self, node_types_flat: torch.Tensor,
                edge_index_flat: torch.Tensor, src_sort=None):
        if self.num_types == 0:
            return None, None
        if self.mode == "onehot":
            attr = torch.nn.functional.one_hot(
                node_types_flat.long(), self.num_types).to(torch.float32)
        else:
            attr = self.embedding.index_select(0, node_types_flat.long())
        node_attr = self.algebra.embed_grade(attr[..., None], 0)
        src, dst = edge_index_flat[0], edge_index_flat[1]
        gathered_src = (take_rows_presorted(node_attr, src, *src_sort)
                        if src_sort is not None
                        else node_attr.index_select(0, src.long()))
        edge_attr = torch.cat(
            [gathered_src, take_rows_sorted_idx(node_attr, dst)], dim=1)
        return node_attr, edge_attr


def flatten_graph(batch: SimplicialBatch):
    """Flatten the (B, N) node space and (B, E) edges to global ids.
    Per-sample offsets are static (b * N) and each sample's edges are
    target-sorted, so the global target column stays ascending.  Returns
    (edge_index (2, B*E), edge_mask (B*E,), src_sort (order, sorted src))."""
    B, N = batch.node_types.shape
    E = batch.edge_index.shape[1]
    dev = batch.edge_index.device
    ar = torch.arange(B, dtype=torch.int64, device=dev)
    ei = batch.edge_index.long() + (ar * N)[:, None, None]
    ei_flat = ei.reshape(B * E, 2).T.contiguous()
    edge_mask = batch.edge_mask.reshape(B * E)
    order = batch.edge_src_order.long() + (ar * E)[:, None]
    src_sorted = torch.gather(batch.edge_index[..., 0].long(), 1,
                              batch.edge_src_order.long()) + (ar * N)[:, None]
    src_sort = (order.reshape(B * E), src_sorted.reshape(B * E))
    return ei_flat, edge_mask, src_sort


def center_vertex_positions(pos: torch.Tensor, vertex_mask: torch.Tensor):
    """Subtract the per-graph mean vertex position.  pos (B, N, ..., D);
    mask (B, N).  Returns (centered positions for vertices, mean)."""
    mean = masked_mean(pos, vertex_mask, axis=1)
    centered = pos - mean[:, None]
    m = vertex_mask.reshape(tuple(vertex_mask.shape)
                            + (1,) * (pos.dim() - 2))
    return torch.where(m, centered, pos), mean


def global_mean_pool_masked(x: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """(B, N, ...) masked mean over the nodes of each graph."""
    return masked_mean(x, mask, axis=1)
