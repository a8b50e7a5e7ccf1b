"""NBA trajectory-prediction model, Cl(2,0).

Port of ``csmpn_tpu/models/nba.py``: a 10-frame 2-D position/velocity
embedding through the NBA-specific per-dimension stack (an MVLinear for
vertices, a one-block CEMLP for edges, two one-block CEMLPs ``a`` and
``b`` for triangles: the model's own ``embed_0/1/2``, as in the flax tree,
where they sit beside ``cl_feature_embedding`` and not in it), learned
simplex-type conditioning, a feature embedding, EGCL layers with sum
aggregation, and a 40-frame readout for the 5 players (the appended
reference point dropped), with ADE as the loss.  The constructor takes the flax module's field names, so
``convert.params_from_jax`` maps a flax tree onto it unchanged.

At Cl(2) every CEMLP block (edge and node models, the embedding) runs the
dense block kernels K2/K3 at 4 blades on the card (``ops/cemlp_kernel.py``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..algebra.clifford import CliffordAlgebra, get_algebra
from ..data.batching import PaddingSpec, SimplicialBatch
from ..nn.egcl import EGCL
from ..nn.modules import CEMLP, MVLinear
from .common import SimplexEmbedding, SimplexTypeConditioning, flatten_graph

OBS_FRAMES = 10
N_NODES = 6  # 5 players + reference point


class _TriangleEmbedding(nn.Module):
    """The triangle embedding: CEMLP ``a`` (3 * num_input -> num_hidden)
    then CEMLP ``b`` (num_hidden -> num_input), one block each."""

    def __init__(self, algebra: CliffordAlgebra, num_input: int,
                 num_hidden: int):
        super().__init__()
        self.a = CEMLP(algebra, 3 * num_input, num_hidden, num_hidden,
                       n_layers=1)
        self.b = CEMLP(algebra, num_hidden, num_hidden, num_input,
                       n_layers=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.b(self.a(x))


class NBAModel(nn.Module):
    metric_names = ("loss", "ade_loss", "fde_loss")

    def __init__(self, spec: PaddingSpec, max_dim: int = 2,
                 num_input: int = 20, num_hidden: int = 40,
                 num_out: int = 40, num_layers: int = 4,
                 condition: bool = True):
        super().__init__()
        self.spec = spec
        self.num_input = num_input
        self.num_hidden = num_hidden
        self.num_out = num_out
        self.num_layers = num_layers
        alg = self.algebra
        num_types = max_dim + 1 if condition else 0
        self.cl_feature_embedding = SimplexEmbedding(
            alg, spec, (("pos", 1), ("vel", 1)), num_input=num_input,
            num_hidden=num_hidden, max_dim=max_dim, out_channels=num_input,
            net_builder=self._embed_net)
        self.sim_type_embedding = SimplexTypeConditioning(alg, num_types,
                                                          mode="embed")
        self.feature_embedding = MVLinear(alg, num_input + num_types,
                                          num_hidden, subspaces=False)
        for i in range(num_layers):
            setattr(self, f"egcl_{i}", EGCL(
                alg, num_hidden, num_hidden, num_hidden,
                edge_attr_features=2 * num_types,
                node_attr_features=num_types, aggr="sum",
                normalization_init=0.0, bf16_out=(i + 1 < num_layers)))
        self.projection = MVLinear(alg, num_hidden, num_out)

    @property
    def algebra(self) -> CliffordAlgebra:
        return get_algebra((1.0, 1.0))

    def _embed_net(self, d: int, in_feats: int, out_ch: int) -> nn.Module:
        """The network of dimension d, registered as this model's
        ``embed_{d}``."""
        alg = self.algebra
        if d == 0:
            net = MVLinear(alg, self.num_input, self.num_input,
                           subspaces=False)
        elif d == 1:
            net = CEMLP(alg, 2 * self.num_input, self.num_hidden,
                        self.num_input, n_layers=1)
        else:
            net = _TriangleEmbedding(alg, self.num_input, self.num_hidden)
        setattr(self, f"embed_{d}", net)
        return net

    def forward(self, batch: SimplicialBatch, step: int = 0,
                mode: str = "train"):
        alg = self.algebra
        B, N = batch.node_types.shape

        x = self.cl_feature_embedding(
            batch, {"pos": batch.features["pos"],
                    "vel": batch.features["vel"]})
        x = x * batch.node_mask[..., None, None].to(x.dtype)
        x = x.reshape(B * N, self.num_input, alg.n_blades)

        ei_flat, edge_mask, src_sort = flatten_graph(batch)
        node_attr, edge_attr = self.sim_type_embedding(
            batch.node_types.reshape(-1), ei_flat, src_sort=src_sort)
        x = self.feature_embedding(torch.cat([x, node_attr], dim=1))

        for i in range(self.num_layers):
            x = getattr(self, f"egcl_{i}")(
                x, ei_flat, edge_attr, node_attr, edge_mask=edge_mask,
                batch_shape=(B, N, batch.edge_index.shape[1]),
                src_sort=src_sort)

        out = x.reshape(B, N, self.num_hidden, alg.n_blades)[:, :N_NODES]
        proj = self.projection(out)                    # (B, 6, 40, 4)
        pred = proj[..., 1:3]                          # (B, 6, 40, 2)
        # drop the appended reference point
        loc_pred = pred.reshape(B, N_NODES, OBS_FRAMES * 4, 2)[:, :-1]
        loc_pred = loc_pred.reshape(B, N_NODES - 1, self.num_out, 2)

        targets = batch.targets["y"]                   # (B, 5, 40, 2)
        err2 = torch.sum((loc_pred - targets) ** 2, dim=-1)   # (B, 5, 40)
        # ADE: the mean over groups of num_frames, then over the groups
        ade = torch.sqrt(err2).reshape(B, -1, OBS_FRAMES).mean(
            dim=-1).mean(dim=-1)
        # FDE: the last predicted frame per player, mean over players
        fde = torch.sqrt(err2[:, :, -1]).mean(dim=-1)
        loss = ade
        return loss.mean(), {"loss": loss, "ade_loss": ade,
                             "fde_loss": fde}
