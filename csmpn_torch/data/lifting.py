"""Simplicial complexes and their big-graph flattening.

Port of the parts of ``csmpn_tpu/data/lifting.py`` the motion task uses:
the ``SimplicialComplex`` container and ``flatten_complex`` into a
``BigGraph``.  The Rips, clique and hull lifts come with later tasks.
Host-side numpy; byte-identical to the reference on the same input.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np


@dataclass
class SimplicialComplex:
    """x: {dim: (n_d, dim+1) vertex-index matrix};
    adj: {(src_dim, dst_dim): (2, n)} with within-dim indices."""

    max_dim: int
    x: Dict[int, np.ndarray]
    adj: Dict[Tuple[int, int], np.ndarray]

    @property
    def counts(self) -> List[int]:
        return [len(self.x.get(d, ())) for d in range(self.max_dim + 1)]


@dataclass
class BigGraph:
    """One simplicial complex flattened into a single graph over all
    simplices."""

    edge_index: np.ndarray   # (2, E) int64, [source, target] big-graph ids
    edge_types: np.ndarray   # (E, 2) int64 [src_dim, dst_dim]
    node_types: np.ndarray   # (N,) int64 simplex dimension per node
    x_ind: np.ndarray        # (N, max_dim+1) int64 padded vertex indices
    counts: List[int] = field(default_factory=list)

    @property
    def num_nodes(self) -> int:
        return len(self.node_types)


def flatten_complex(cplx: SimplicialComplex) -> BigGraph:
    """Merge per-dim simplex sets into one node space with per-dim offsets,
    emitting edge_index over all adjacency relations (upward, downward,
    same-dim) plus x_ind / node_types."""
    max_dim = cplx.max_dim
    counts = cplx.counts
    offsets = np.concatenate([[0], np.cumsum(counts)])

    adj = dict(cplx.adj)
    # downward (coboundary) relations = transposed boundary relations
    for d in range(max_dim):
        if (d, d + 1) in adj:
            adj[(d + 1, d)] = adj[(d, d + 1)][[1, 0]].copy()

    edge_blocks, type_blocks = [], []
    for ds in range(max_dim + 1):
        for dt in range(max_dim + 1):
            if (ds, dt) in adj:
                block = adj[(ds, dt)].copy()
                block[0] += offsets[ds]
                block[1] += offsets[dt]
                edge_blocks.append(block)
                type_blocks.append(
                    np.tile([[ds], [dt]], (1, block.shape[1])).T)
    edge_index = (np.concatenate(edge_blocks, axis=1)
                  if edge_blocks else np.zeros((2, 0), dtype=np.int64))
    edge_types = (np.concatenate(type_blocks, axis=0)
                  if type_blocks else np.zeros((0, 2), dtype=np.int64))

    n = int(offsets[-1])
    node_types = np.zeros(n, dtype=np.int64)
    x_ind = np.zeros((n, max_dim + 1), dtype=np.int64)
    for d in range(max_dim + 1):
        sl = slice(int(offsets[d]), int(offsets[d + 1]))
        node_types[sl] = d
        if counts[d]:
            x_ind[sl, : d + 1] = cplx.x[d]
    return BigGraph(edge_index, edge_types, node_types, x_ind,
                    counts=list(counts))
