"""Convex-hulls volume regression model, Cl(5,0).

Port of ``csmpn_tpu/models/hulls.py``: per-dimension permutation-sum
Clifford embedding of the vertex positions, one-hot simplex-type
conditioning, EGCL layers with mean aggregation, a scalar-blade
projection, a global mean pool over all simplices and an MSE loss.  The
constructor takes the flax module's field names, so
``convert.params_from_jax`` maps a flax tree onto it unchanged.

At Cl(5) every CEMLP block (edge and node models, the embedding) runs the
pair-form kernels K2p/K3p on the card (``ops/cemlp_kernel.py``).
"""
from __future__ import annotations

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
    global_mean_pool_masked,
)


class HullsModel(nn.Module):
    metric_names = ("loss",)

    def __init__(self, spec: PaddingSpec, in_features: int = 1,
                 hidden_features: int = 28, out_features: int = 1,
                 num_layers: int = 3, normalization_init: float = 0.0,
                 residual: bool = True, aggr: str = "mean",
                 condition: bool = True, max_dim: int = 2):
        super().__init__()
        self.spec = spec
        self.hidden_features = hidden_features
        self.out_features = out_features
        self.num_layers = num_layers
        alg = self.algebra
        num_types = max_dim + 1 if condition else 0
        self.cl_feature_embedding = SimplexEmbedding(
            alg, spec, (("input", 1),), num_input=in_features,
            num_hidden=hidden_features, max_dim=max_dim)
        self.sim_type = SimplexTypeConditioning(alg, num_types, mode="onehot")
        for i in range(num_layers):
            setattr(self, f"egcl_{i}", EGCL(
                alg, hidden_features, hidden_features, hidden_features,
                edge_attr_features=2 * num_types,
                node_attr_features=num_types, residual=residual,
                normalization_init=normalization_init, aggr=aggr,
                bf16_out=(i + 1 < num_layers)))
        self.projection = MVLinear(alg, hidden_features, out_features)

    @property
    def algebra(self) -> CliffordAlgebra:
        return get_algebra((1.0,) * 5)

    def forward(self, batch: SimplicialBatch, step: int = 0,
                mode: str = "train"):
        alg = self.algebra
        B, N = batch.node_types.shape

        vertex_mask = (batch.node_types == 0) & batch.node_mask
        pos, _ = center_vertex_positions(batch.features["input"],
                                         vertex_mask)

        x = self.cl_feature_embedding(batch, {"input": pos})
        x = x * batch.node_mask[..., None, None].to(x.dtype)
        x = x.reshape(B * N, self.hidden_features, alg.n_blades)

        ei_flat, edge_mask, src_sort = flatten_graph(batch)
        node_attr, edge_attr = self.sim_type(
            batch.node_types.reshape(-1), ei_flat, src_sort=src_sort)

        for i in range(self.num_layers):
            x = getattr(self, f"egcl_{i}")(
                x, ei_flat, edge_attr, node_attr, edge_mask=edge_mask,
                batch_shape=(B, N, batch.edge_index.shape[1]),
                src_sort=src_sort)

        pred = self.projection(x)
        pred = pred[:, :, 0].reshape(B, N, self.out_features)
        pred = global_mean_pool_masked(pred, batch.node_mask)   # (B, 1)

        target = batch.targets["target"]
        loss = (pred.squeeze(-1) - target) ** 2                 # (B,)
        return loss.mean(), {"loss": loss}
