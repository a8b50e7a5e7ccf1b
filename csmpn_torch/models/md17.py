"""MD17 atomic-motion prediction model, Cl(3,0).

Port of ``csmpn_tpu/models/md17.py``: a 10-frame position/velocity/charge
embedding (grades 1/1/0) of the positions centred on the per-graph mean
over vertices and frames, learned simplex-type conditioning, a feature
embedding, EGCL layers with sum aggregation, a one-block CEMLP and an
MVLinear projection to a 10-frame displacement readout added to the input
positions, with the mean squared error as the loss and ADE/FDE metrics.
The constructor takes the flax module's field names, so
``convert.params_from_jax`` maps a flax tree onto it unchanged.

Every CEMLP block runs K2/K3 at 8 blades on the card
(``ops/cemlp_kernel.py``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..algebra.clifford import CliffordAlgebra, get_algebra
from ..data.batching import PaddingSpec, SimplicialBatch
from ..nn.egcl import EGCL
from ..nn.modules import CEMLP, MVLinear
from ..ops.segment import masked_mean
from .common import SimplexEmbedding, SimplexTypeConditioning, flatten_graph


class MD17Model(nn.Module):
    metric_names = ("loss", "ade_loss", "fde_loss")

    def __init__(self, spec: PaddingSpec, n_vertices: int, max_dim: int = 2,
                 num_input: int = 30, num_hidden: int = 32,
                 num_out: int = 10, num_layers: int = 5,
                 condition: bool = True):
        super().__init__()
        self.spec = spec
        self.n_vertices = n_vertices
        self.num_hidden = num_hidden
        self.num_layers = num_layers
        alg = self.algebra
        num_types = max_dim + 1 if condition else 0
        self.cl_feature_embedding = SimplexEmbedding(
            alg, spec, (("pos", 1), ("vel", 1), ("charges", 0)),
            num_input=num_input, num_hidden=num_hidden, max_dim=max_dim)
        self.sim_type_embedding = SimplexTypeConditioning(alg, num_types,
                                                          mode="embed")
        self.feature_embedding = MVLinear(alg, num_hidden + num_types,
                                          num_hidden, subspaces=False)
        for i in range(num_layers):
            setattr(self, f"egcl_{i}", EGCL(
                alg, num_hidden, num_hidden, num_hidden,
                edge_attr_features=2 * num_types,
                node_attr_features=num_types, aggr="sum",
                normalization_init=0.0, bf16_out=(i + 1 < num_layers)))
        self.projection_mlp = CEMLP(alg, num_hidden, num_hidden, num_hidden,
                                    n_layers=1)
        self.projection = MVLinear(alg, num_hidden, num_out)

    @property
    def algebra(self) -> CliffordAlgebra:
        return get_algebra((1.0, 1.0, 1.0))

    def forward(self, batch: SimplicialBatch, step: int = 0,
                mode: str = "train"):
        alg = self.algebra
        B, N = batch.node_types.shape
        n0 = self.n_vertices

        loc = batch.features["loc"]                     # (B, N, 10, 3)
        loc_node = loc[:, :n0]                          # original positions
        # per-graph mean over vertices AND frames
        vertex_mask = (batch.node_types == 0) & batch.node_mask
        mean_nf = masked_mean(loc, vertex_mask, axis=1)  # (B, 10, 3)
        mean = torch.mean(mean_nf, dim=1, keepdim=True)  # (B, 1, 3)
        pos = loc - mean[:, None]

        x = self.cl_feature_embedding(
            batch, {"pos": pos, "vel": batch.features["vel"],
                    "charges": batch.features["charges"]})
        x = x * batch.node_mask[..., None, None].to(x.dtype)
        x = x.reshape(B * N, self.num_hidden, alg.n_blades)

        ei_flat, edge_mask, src_sort = flatten_graph(batch)
        node_attr, edge_attr = self.sim_type_embedding(
            batch.node_types.reshape(-1), ei_flat, src_sort=src_sort)
        x = self.feature_embedding(torch.cat([x, node_attr], dim=1))

        for i in range(self.num_layers):
            x = getattr(self, f"egcl_{i}")(
                x, ei_flat, edge_attr, node_attr, edge_mask=edge_mask,
                batch_shape=(B, N, batch.edge_index.shape[1]),
                src_sort=src_sort)

        out = x.reshape(B, N, self.num_hidden, alg.n_blades)[:, :n0]
        proj = self.projection(self.projection_mlp(out))
        pred = proj[..., 1:4]                            # (B, n0, 10, 3)
        loc_pred = loc_node + pred

        targets = batch.targets["y"]                     # (B, n0, 10, 3)
        err2 = torch.sum((loc_pred - targets) ** 2, dim=-1)  # (B, n0, 10)
        ade = torch.sqrt(err2).mean(dim=-1).mean(dim=-1)     # (B,)
        fde = torch.sqrt(err2[..., -1]).mean(dim=-1)         # (B,)
        loss = err2.reshape(B, -1).mean(dim=-1)              # (B,)
        return loss.mean(), {"loss": loss, "ade_loss": ade,
                             "fde_loss": fde}
