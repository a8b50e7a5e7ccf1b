"""Convex-hulls dataset: 5-D point clouds labelled with their Qhull hull
volume.

Port of ``csmpn_tpu/data/hulls.py``; on the same ``$DATAROOT`` it gives
byte-identical arrays, and the raw ``.npy`` files and ``.npz`` caches of
either package read back in the other.

  * 8 points ~ N(0, 1) in R^5 per sample, seeded per split (train 0,
    val 1, test 2), label ``ConvexHull(points).volume``;
  * the hull-face lift (``hull_lift``) flattened to one big graph per
    sample, padded to one spec shared by the three splits.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from .batching import pad_big_graph, spec_from_graphs
from .lifting import flatten_complex, hull_lift
from .loader import Loader, SimplicialArrayDataset, dataroot

_SPLIT_SEEDS = {"train": 0, "val": 1, "test": 2}


def generate_raw(root: str, split: str, num_samples: int,
                 n_points: int = 8, n_dim: int = 5
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Point clouds and hull volumes of a split, read from
    ``hulls_{split}_{input,target}.npy`` when those hold enough samples,
    else sampled and written there."""
    from scipy.spatial import ConvexHull

    inp_path = os.path.join(root, f"hulls_{split}_input.npy")
    tgt_path = os.path.join(root, f"hulls_{split}_target.npy")
    if os.path.exists(inp_path) and os.path.exists(tgt_path):
        inp = np.load(inp_path)
        tgt = np.load(tgt_path)
        if len(inp) >= num_samples:
            return inp[:num_samples], tgt[:num_samples]
    rng = np.random.RandomState(_SPLIT_SEEDS[split])
    points = rng.randn(num_samples, n_points, n_dim).astype(np.float32)
    volumes = np.asarray(
        [ConvexHull(p).volume for p in points], dtype=np.float32)
    os.makedirs(root, exist_ok=True)
    np.save(inp_path, points)
    np.save(tgt_path, volumes)
    return points, volumes


class ConvexHullDataset:
    """Train/val/test splits and their loaders.  The three splits share
    one PaddingSpec, so every batch of the task has one shape."""

    def __init__(self, num_samples: int = 16384, batch_size: int = 16,
                 num_val_samples: int = 16384, n_points: int = 8,
                 n_dim: int = 5, max_dim: int = 2):
        self.batch_size = int(batch_size)
        root = os.path.join(dataroot(), "hulls")
        counts = {"train": int(num_samples), "val": int(num_val_samples),
                  "test": int(num_val_samples)}
        cache = os.path.join(
            root, f"processed_{num_samples}_{num_val_samples}_{max_dim}")

        if all(os.path.exists(os.path.join(cache, f"{s}.npz"))
               for s in counts):
            datasets = {s: SimplicialArrayDataset.load(
                os.path.join(cache, f"{s}.npz")) for s in counts}
        else:
            raw = {s: generate_raw(root, s, n, n_points, n_dim)
                   for s, n in counts.items()}
            bigs = {s: [flatten_complex(hull_lift(p, max_dim)) for p in inp]
                    for s, (inp, _) in raw.items()}
            spec = spec_from_graphs(
                [g for graphs in bigs.values() for g in graphs])
            datasets = {}
            for s, (inp, tgt) in raw.items():
                samples = [pad_big_graph(b, spec, {"input": p})
                           for b, p in zip(bigs[s], inp)]
                targets = [{"target": np.float32(t)} for t in tgt]
                ds = SimplicialArrayDataset.from_samples(samples, targets,
                                                         spec)
                ds.save(os.path.join(cache, f"{s}.npz"))
                datasets[s] = ds

        self.train_dataset = datasets["train"]
        self.val_dataset = datasets["val"]
        self.test_dataset = datasets["test"]
        self.spec = self.train_dataset.spec

    def train_loader(self, seed: Optional[int] = None) -> Loader:
        return Loader(self.train_dataset, self.batch_size, shuffle=True,
                      seed=seed)

    def val_loader(self) -> Loader:
        return Loader(self.val_dataset, self.batch_size, shuffle=False)

    def test_loader(self) -> Loader:
        return Loader(self.test_dataset, self.batch_size, shuffle=False)
