"""Human-motion prediction model, Cl(3,0).

Port of ``csmpn_tpu/models/motion.py``: pos+vel permutation-sum embedding,
learned simplex-type embedding conditioning, EGCL layers with mean
aggregation, vector-blade readout on the 0-simplices as a residual
displacement from the input positions, MSE.
"""
from __future__ import annotations

import torch
from torch import nn

from ..algebra.clifford import CliffordAlgebra, get_algebra
from ..data.batching import PaddingSpec, SimplicialBatch
from ..nn.egcl import EGCL
from ..nn.modules import MVLinear
from .common import (
    SimplexEmbedding,
    SimplexTypeConditioning,
    center_vertex_positions,
    flatten_graph,
)


class MotionModel(nn.Module):
    metric_names = ("loss",)

    def __init__(self, spec: PaddingSpec, max_dim: int = 2,
                 num_input: int = 2, num_hidden: int = 28, num_out: int = 1,
                 num_layers: int = 4, condition: bool = True,
                 n_vertices: int = 31):
        super().__init__()
        self.spec = spec
        self.max_dim = max_dim
        self.num_hidden = num_hidden
        self.num_layers = num_layers
        self.n_vertices = n_vertices
        alg = self.algebra
        num_types = max_dim + 1 if condition else 0
        self.cl_feature_embedding = SimplexEmbedding(
            alg, spec, (("pos", 1), ("vel", 1)), num_input=num_input,
            num_hidden=num_hidden, max_dim=max_dim)
        self.sim_type_embedding = SimplexTypeConditioning(alg, num_types,
                                                          mode="embed")
        for i in range(num_layers):
            setattr(self, f"egcl_{i}", EGCL(
                alg, num_hidden, num_hidden, num_hidden,
                edge_attr_features=2 * num_types,
                node_attr_features=num_types, aggr="mean",
                normalization_init=0.0, bf16_out=(i + 1 < num_layers)))
        self.projection = MVLinear(alg, num_hidden, num_out)

    @property
    def algebra(self) -> CliffordAlgebra:
        return get_algebra((1.0, 1.0, 1.0))

    def forward(self, batch: SimplicialBatch, step: int = 0,
                mode: str = "train"):
        alg = self.algebra
        B, N = batch.node_types.shape
        node_pos = batch.features["pos"][:, : self.n_vertices]

        vertex_mask = (batch.node_types == 0) & batch.node_mask
        pos, _ = center_vertex_positions(batch.features["pos"], vertex_mask)

        x = self.cl_feature_embedding(
            batch, {"pos": pos, "vel": batch.features["vel"]})
        x = x * batch.node_mask[..., None, None].to(x.dtype)
        x = x.reshape(B * N, self.num_hidden, alg.n_blades)

        ei_flat, edge_mask, src_sort = flatten_graph(batch)
        node_attr, edge_attr = self.sim_type_embedding(
            batch.node_types.reshape(-1), ei_flat, src_sort=src_sort)

        for i in range(self.num_layers):
            x = getattr(self, f"egcl_{i}")(
                x, ei_flat, edge_attr, node_attr, edge_mask=edge_mask,
                batch_shape=(B, N, batch.edge_index.shape[1]),
                src_sort=src_sort)

        out = x.reshape(B, N, self.num_hidden, alg.n_blades)
        out = out[:, : self.n_vertices]
        pred = self.projection(out)[..., 0, 1:4]     # vector blades
        pred = node_pos + pred                       # residual

        targets = batch.targets["y"]
        loss = torch.mean((pred - targets) ** 2, dim=-1).reshape(-1)
        return loss.mean(), {"loss": loss}
