"""Array-backed simplicial datasets and the batch loader.

Port of ``csmpn_tpu/data/loader.py``.  Every sample is pre-padded to the
dataset-wide :class:`PaddingSpec`, so a dataset is one
:class:`SimplicialBatch` of numpy arrays whose leading dimension is the
sample count, and batching is an index-take.

On-disk format (shared with the reference package, so a cache written by
either reads back identically): one ``.npz`` per split with the batch
fields verbatim plus ``spec_counts``/``spec_emax`` and ``feat_*``/``tgt_*``
entries for the feature/target dicts.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .batching import PaddingSpec, SimplicialBatch, collate


class SimplicialArrayDataset:
    """All samples of one split as stacked padded numpy arrays."""

    def __init__(self, arrays: SimplicialBatch, spec: PaddingSpec):
        self.arrays = arrays
        self.spec = spec

    def __len__(self) -> int:
        return int(self.arrays.edge_index.shape[0])

    @classmethod
    def from_samples(cls, samples: List[dict],
                     targets: List[Dict[str, np.ndarray]],
                     spec: PaddingSpec) -> "SimplicialArrayDataset":
        return cls(collate(samples, targets), spec)

    def select(self, idx: Sequence[int]) -> SimplicialBatch:
        idx = np.asarray(idx)
        a = self.arrays

        def take(x):
            return np.take(x, idx, axis=0)

        return SimplicialBatch(
            edge_index=take(a.edge_index),
            edge_mask=take(a.edge_mask),
            edge_src_order=take(a.edge_src_order),
            node_mask=take(a.node_mask),
            node_types=take(a.node_types),
            x_ind=take(a.x_ind),
            features={k: take(v) for k, v in a.features.items()},
            targets={k: take(v) for k, v in a.targets.items()},
        )

    # ------------------------------------------------------------- npz cache

    def save(self, path: str) -> None:
        a = self.arrays
        payload = dict(
            edge_index=a.edge_index, edge_mask=a.edge_mask,
            edge_src_order=a.edge_src_order, node_mask=a.node_mask,
            node_types=a.node_types, x_ind=a.x_ind,
            spec_counts=np.asarray(self.spec.counts_max, dtype=np.int64),
            spec_emax=np.int64(self.spec.e_max),
        )
        for k, v in a.features.items():
            payload[f"feat_{k}"] = v
        for k, v in a.targets.items():
            payload[f"tgt_{k}"] = v
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "SimplicialArrayDataset":
        with np.load(path) as z:
            spec = PaddingSpec(tuple(int(c) for c in z["spec_counts"]),
                               int(z["spec_emax"]))
            arrays = SimplicialBatch(
                edge_index=z["edge_index"], edge_mask=z["edge_mask"],
                edge_src_order=z["edge_src_order"],
                node_mask=z["node_mask"], node_types=z["node_types"],
                x_ind=z["x_ind"],
                features={k[5:]: z[k] for k in z.files
                          if k.startswith("feat_")},
                targets={k[4:]: z[k] for k in z.files
                         if k.startswith("tgt_")},
            )
        return cls(arrays, spec)


class Loader:
    """Minibatch iterator over a :class:`SimplicialArrayDataset`.  A
    shuffled (training) loader reshuffles every epoch (epoch e with
    ``seed + e`` when ``seed`` is given) and drops the last partial batch;
    an unshuffled one keeps it.  Rank sharding comes with scale-out."""

    def __init__(self, dataset: SimplicialArrayDataset, batch_size: int,
                 shuffle: bool = False, seed: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = shuffle
        self.seed = seed
        self._epoch = 0

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            if self.seed is not None:
                rng = np.random.RandomState(self.seed + self._epoch)
            else:
                rng = np.random.RandomState()
            rng.shuffle(idx)
        return idx

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self):
        idx = self._indices()
        self._epoch += 1
        n_full = len(idx) // self.batch_size
        for b in range(n_full):
            yield self.dataset.select(
                idx[b * self.batch_size:(b + 1) * self.batch_size])
        rem = len(idx) - n_full * self.batch_size
        if rem and not self.drop_last:
            yield self.dataset.select(idx[n_full * self.batch_size:])


def dataroot() -> str:
    """``$DATAROOT``, or ``./data`` when unset."""
    return os.environ.get("DATAROOT", "data")
