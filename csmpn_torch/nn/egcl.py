"""EGCL — the Clifford-equivariant graph convolution layer.

Port of ``csmpn_tpu/nn/egcl.py``: an explicit gather -> edge CEMLP ->
sorted segment reduce -> node CEMLP pipeline over statically shaped,
padded big-graph arrays.

  * the message input is ``h_target - h_source`` (++ edge_attr);
  * "mean" aggregation divides by the in-degree, empty segments give 0;
  * the update input is ``concat(h, agg, node_attr)`` with a residual.

Where the reference asks whether it runs on the TPU, the port asks whether
the tensor is on the card: there, in fast mode, the gathers and the message
stream move bf16 rows and ``bf16_out`` hands bf16 features to the next
layer; on the CPU everything stays fp32, as in the reference off the TPU.

The flat big-graph path (``batch_shape is None``, edges sorted by target)
runs the edge side as one fused pass, K4 forward and K5 backward
(``ops/fused_egcl.py``), on the card in fast mode.  In exact mode and on
the CPU it composes the target gather, the edge CEMLP and the
aggregation, as the reference keeps the composed path in exact mode.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..algebra.clifford import CliffordAlgebra
from ..ops.segment import (
    aggregation_exact,
    segment_mean,
    segment_sum,
    take_rows,
    take_rows_presorted,
    take_rows_sorted_idx,
)
from .modules import CEMLP


class EGCL(nn.Module):
    def __init__(self, algebra: CliffordAlgebra, in_features: int,
                 hidden_features: int, out_features: int,
                 edge_attr_features: int = 0, node_attr_features: int = 0,
                 normalization_init: float = 0.0,
                 aggr: str = "mean", edges_sorted: bool = True,
                 bf16_out: bool = False, residual: bool = True):
        super().__init__()
        self.algebra = algebra
        self.aggr = aggr
        self.residual = residual
        self.edges_sorted = edges_sorted
        self.bf16_out = bf16_out
        self.edge_model = CEMLP(algebra, in_features + edge_attr_features,
                                hidden_features, out_features,
                                normalization_init=normalization_init)
        self.node_model = CEMLP(
            algebra, in_features + out_features + node_attr_features,
            hidden_features, out_features,
            normalization_init=normalization_init)

    def _use_fused_mp(self, batch_shape, x: torch.Tensor) -> bool:
        """K4/K5 on the flat big-graph path: on the card in fast mode, for
        the 2-block edge CEMLP with hidden == out width."""
        if not self.edges_sorted or batch_shape is not None:
            return False
        from ..ops.fused_egcl import fused_mp_supported

        return fused_mp_supported(self.algebra, self.edge_model, x)

    def message(self, h_i: torch.Tensor, h_j: torch.Tensor,
                edge_attr: Optional[torch.Tensor] = None) -> torch.Tensor:
        msg_in = h_i - h_j
        if edge_attr is not None:
            msg_in = torch.cat([msg_in, edge_attr], dim=1)
        return self.edge_model(msg_in)

    def aggregate(self, msg: torch.Tensor, dst: torch.Tensor, num_nodes: int,
                  edge_mask: Optional[torch.Tensor] = None,
                  indices_are_sorted: Optional[bool] = None,
                  batch_shape=None) -> torch.Tensor:
        sorted_ = (self.edges_sorted if indices_are_sorted is None
                   else indices_are_sorted)
        reduce = segment_mean if self.aggr == "mean" else segment_sum
        return reduce(msg, dst, num_nodes, indices_are_sorted=sorted_,
                      mask=edge_mask, batch_shape=batch_shape)

    def message_aggregate(self, h: torch.Tensor, h_j: torch.Tensor,
                          edge_attr: Optional[torch.Tensor],
                          dst: torch.Tensor, num_nodes: int,
                          edge_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """Edge side of the layer — ``reduce_dst(message(h[dst] - h_j))``
        — with ``dst`` sorted ascending and ``h_j`` pre-gathered: one fused
        pass where supported, the composed target-gather path otherwise."""
        if self._use_fused_mp(None, h):
            from ..ops.fused_egcl import fused_message_aggregate

            return fused_message_aggregate(
                self.edge_model, h, h_j, edge_attr, dst,
                edge_mask=edge_mask, mean=(self.aggr == "mean"))
        h_i = take_rows_sorted_idx(h, dst)
        msg = self.message(h_i, h_j, edge_attr)
        return self.aggregate(msg, dst, num_nodes, edge_mask)

    def update(self, h: torch.Tensor, agg: torch.Tensor,
               node_attr: Optional[torch.Tensor] = None) -> torch.Tensor:
        upd_in = [h, agg]
        if node_attr is not None:
            upd_in.append(node_attr)
        out = self.node_model(torch.cat(upd_in, dim=1))
        return h + out if self.residual else out

    def forward(self, h: torch.Tensor, edge_index: torch.Tensor,
                edge_attr: Optional[torch.Tensor] = None,
                node_attr: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None,
                batch_shape=None, src_sort=None) -> torch.Tensor:
        """h (N, C, nb); edge_index (2, E) rows [source, target];
        edge_attr (E, C_e, nb); node_attr (N, C_n, nb); edge_mask (E,)
        bool; src_sort a precomputed (order, sorted_ids) of the sources."""
        num_nodes = h.shape[0]
        src, dst = edge_index[0], edge_index[1]
        if self._use_fused_mp(batch_shape, h):
            from ..ops.fused_egcl import fused_message_aggregate

            # bf16 activation storage before the source gather (the kernels
            # round every use to bf16 anyway); the update sees h's type
            if aggregation_exact():     # forced-on dispatch (tests)
                h_s, ea_s = h, edge_attr
            else:
                h_s = h.to(torch.bfloat16)
                ea_s = (edge_attr.to(torch.bfloat16)
                        if edge_attr is not None else None)
            if src_sort is not None:
                h_j = take_rows_presorted(h_s, src, *src_sort)
            else:
                h_j = take_rows(h_s, src)
            agg = fused_message_aggregate(
                self.edge_model, h_s, h_j, ea_s, dst, edge_mask=edge_mask,
                mean=(self.aggr == "mean"))
            return self._finish(self.update(h, agg, node_attr))
        if h.is_cuda and not aggregation_exact():
            # bf16 activation storage: the gathers, their backward sums and
            # the message stream move bf16 rows; the update keeps h's type
            h_s = h.to(torch.bfloat16)
            ea_s = (edge_attr.to(torch.bfloat16) if edge_attr is not None
                    else None)
        else:
            h_s, ea_s = h, edge_attr
        if self.edges_sorted:
            h_i = take_rows_sorted_idx(h_s, dst)
        else:
            h_i = take_rows(h_s, dst)
        if src_sort is not None:
            h_j = take_rows_presorted(h_s, src, *src_sort)
        else:
            h_j = take_rows(h_s, src)
        msg = self.message(h_i, h_j, ea_s)
        agg = self.aggregate(msg, dst, num_nodes, edge_mask,
                             batch_shape=batch_shape)
        agg = agg.to(h.dtype)
        return self._finish(self.update(h, agg, node_attr))

    def _finish(self, out: torch.Tensor) -> torch.Tensor:
        """bf16 inter-layer hand-off on the card in fast mode."""
        if self.bf16_out and out.is_cuda and not aggregation_exact():
            return out.to(torch.bfloat16)
        return out
