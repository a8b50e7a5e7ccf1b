"""Static-shape batching for simplicial big graphs.

Port of ``csmpn_tpu/data/batching.py``:

  * each big graph is laid out in per-dimension SECTIONS padded to
    dataset-wide maxima (vertices | edges | triangles), so every sample of
    a dataset has the same node layout;
  * edge lists are sorted by (target, source) and padded to a fixed E_max,
    so segment reductions run on sorted ids;
  * masks carry the ragged truth: ``node_mask`` / ``edge_mask``.

A batch stacks B padded samples; models flatten to (B*N, ...) with static
per-sample offsets (b * N).  ``SimplicialBatch`` holds numpy arrays on the
host and torch tensors after ``.to(device)``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .lifting import BigGraph


@dataclass(frozen=True)
class PaddingSpec:
    """Per-dataset static shape contract."""

    counts_max: Tuple[int, ...]   # max #simplices per dim, e.g. (32, 16, 8)
    e_max: int                    # max #edges of the big graph

    @property
    def n_total(self) -> int:
        return int(sum(self.counts_max))

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.counts_max)]).astype(
            np.int64)

    @property
    def node_types(self) -> np.ndarray:
        nt = np.zeros(self.n_total, dtype=np.int32)
        off = self.offsets
        for d in range(len(self.counts_max)):
            nt[off[d]:off[d + 1]] = d
        return nt


def spec_from_graphs(graphs: Sequence[BigGraph],
                     round_to: int = 8) -> PaddingSpec:
    """A PaddingSpec covering all samples, section sizes rounded up to
    multiples of ``round_to``."""
    max_dim = max(len(g.counts) for g in graphs) - 1

    def r(x):
        return int(-(-x // round_to) * round_to) if x else 0

    counts = tuple(
        r(max(g.counts[d] if d < len(g.counts) else 0 for g in graphs))
        for d in range(max_dim + 1))
    e_max = r(max(g.edge_index.shape[1] for g in graphs))
    return PaddingSpec(counts, e_max)


def _to(x, device):
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    return torch.as_tensor(x).to(device, non_blocking=True)


@dataclass
class SimplicialBatch:
    """A batch of padded big graphs (all arrays leading dim = B)."""

    edge_index: Any                 # (B, E, 2) int32 [source, target]
    edge_mask: Any                  # (B, E) bool
    edge_src_order: Any             # (B, E) int32: argsort of source ids
    node_mask: Any                  # (B, N) bool
    node_types: Any                 # (B, N) int32
    x_ind: Any                      # (B, N, max_dim+1) int32
    features: Dict[str, Any]        # each (B, N, ...) node-level
    targets: Dict[str, Any]         # per-graph targets, (B, ...)

    @property
    def batch_size(self) -> int:
        return self.edge_index.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.node_types.shape[1]

    def to(self, device) -> "SimplicialBatch":
        """Torch tensors on ``device`` (numpy arrays are converted)."""
        return SimplicialBatch(**{f.name: _to(getattr(self, f.name), device)
                                  for f in dataclasses.fields(self)})

    def replace(self, **changes) -> "SimplicialBatch":
        return dataclasses.replace(self, **changes)


def pad_big_graph(big: BigGraph, spec: PaddingSpec,
                  features: Dict[str, np.ndarray]) -> dict:
    """Pad one flattened big graph into the static section layout.
    ``features`` are node-level arrays aligned with the original big-graph
    node ids (vertices first); the zero-pad extends to the section maxima.
    """
    counts = list(big.counts) + [0] * (len(spec.counts_max) - len(big.counts))
    old_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    new_off = spec.offsets
    for d, c in enumerate(counts):
        if c > spec.counts_max[d]:
            raise ValueError(
                f"dim-{d} count {c} exceeds spec {spec.counts_max[d]}")

    n_new = spec.n_total
    remap = np.zeros(int(old_off[-1]), dtype=np.int64)
    node_mask = np.zeros(n_new, dtype=bool)
    for d, c in enumerate(counts):
        remap[old_off[d]:old_off[d + 1]] = np.arange(c) + new_off[d]
        node_mask[new_off[d]:new_off[d] + c] = True

    x_ind = np.zeros((n_new, len(spec.counts_max)), dtype=np.int32)
    width = big.x_ind.shape[1]
    x_ind[remap[: old_off[-1]], :width] = big.x_ind.astype(np.int32)

    # edges: remap endpoints, sort by (target, source), pad.  Padded edges
    # self-loop on the LAST node so the target column stays globally
    # ascending; their messages are masked out downstream.
    ei = remap[big.edge_index]
    order = np.lexsort((ei[0], ei[1]))
    ei = ei[:, order]
    e_real = ei.shape[1]
    if e_real > spec.e_max:
        raise ValueError(f"edge count {e_real} exceeds spec {spec.e_max}")
    last = n_new - 1
    edge_index = np.full((spec.e_max, 2), last, dtype=np.int32)
    edge_index[:e_real, 0] = ei[0]
    edge_index[:e_real, 1] = ei[1]
    edge_mask = np.zeros(spec.e_max, dtype=bool)
    edge_mask[:e_real] = True
    src_order = np.argsort(edge_index[:, 0], kind="stable").astype(np.int32)

    feats = {}
    for k, v in features.items():
        v = np.asarray(v)
        out = np.zeros((n_new,) + v.shape[1:], dtype=v.dtype)
        out[remap[: min(len(v), old_off[-1])]] = v[: old_off[-1]]
        feats[k] = out

    return dict(edge_index=edge_index, edge_mask=edge_mask,
                edge_src_order=src_order,
                node_mask=node_mask, node_types=spec.node_types.copy(),
                x_ind=x_ind, features=feats)


def collate(samples: List[dict],
            targets: List[Dict[str, np.ndarray]]) -> SimplicialBatch:
    """Stack padded samples into a SimplicialBatch of numpy arrays."""
    def stack(key):
        return np.stack([s[key] for s in samples])

    feat_keys = samples[0]["features"].keys()
    tgt_keys = targets[0].keys()
    return SimplicialBatch(
        edge_index=stack("edge_index"),
        edge_mask=stack("edge_mask"),
        edge_src_order=stack("edge_src_order"),
        node_mask=stack("node_mask"),
        node_types=stack("node_types"),
        x_ind=stack("x_ind"),
        features={k: np.stack([s["features"][k] for s in samples])
                  for k in feat_keys},
        targets={k: np.stack([t[k] for t in targets]) for k in tgt_keys},
    )
