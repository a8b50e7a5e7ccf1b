"""CMU human-motion dataset: 31-joint walking trials from GMN's
``motion.pkl``, with the hard-coded simplicial structure of the reference's
``ManualTransform``.

Port of ``csmpn_tpu/data/motion.py``; on the same ``$DATAROOT`` it gives
byte-identical arrays, and the ``.npz`` caches of either package read back
in the other.

  * velocity by frame diff, last frame dropped;
  * fixed case-id splits (11/6/6 trials) and a persisted random 100-frame
    sampling per case (``split.pkl``, seed 100, itv 300);
  * per-split sample selection ``each_len = max_samples // n_cases``,
    targets at ``+delta_frame``;
  * the skeleton's 1-hop + 2-hop (A, A @ A) 0-0 adjacency;
  * the manual 12-edge / 4-triangle tables and the boundary / coboundary /
    shared-coface adjacency derived from them.

If ``$DATAROOT/motion/motion.pkl`` is absent, a seeded synthetic pickle in
the exact on-disk format is generated next to a ``SYNTHETIC`` marker file.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from .batching import pad_big_graph, spec_from_graphs
from .lifting import SimplicialComplex, flatten_complex
from .loader import (Loader, SimplicialArrayDataset, dataroot,
                     write_atomic)

N_JOINTS = 31
TRAIN_CASES = [20, 1, 17, 13, 14, 9, 4, 2, 7, 5, 16]
VAL_CASES = [3, 8, 11, 12, 15, 18]
TEST_CASES = [6, 19, 21, 0, 22, 10]

# the reference's manual simplex tables (dataset facts:
# simplicial_data.py:289-294 — elbow/knee triangles of the 31-joint skeleton)
X1 = np.asarray([[6, 7], [7, 8], [6, 8], [1, 2], [2, 3], [1, 3],
                 [24, 25], [25, 26], [24, 26], [22, 23], [21, 22], [21, 23]],
                dtype=np.int64)
X2 = np.asarray([[6, 7, 8], [1, 2, 3], [24, 25, 26], [21, 22, 23]],
                dtype=np.int64)


class Motion:
    """Raw trial loader + frame sampler (reference Motion, motion.py:16-139).

    Exposes ``x_0``/``v_0``/``x_t``/``v_t`` sample arrays and the skeleton's
    1-hop/2-hop directed edge list (``edges_00``).
    """

    def __init__(self, partition: str, max_samples: int, delta_frame: int,
                 data_dir: str):
        with open(os.path.join(data_dir, "motion.pkl"), "rb") as f:
            edges, X = pickle.load(f)
        V = [x[1:] - x[:-1] for x in X]
        X = [x[:-1] for x in X]
        n = X[0].shape[1]

        split_path = os.path.join(data_dir, "split.pkl")
        if os.path.exists(split_path):
            with open(split_path, "rb") as f:
                split = pickle.load(f)
        else:
            # reference motion.py:49-67: seed 100, 100 frames out of the
            # first 300 per case, persisted so every run sees one sampling
            rng = np.random.RandomState(100)
            itv = 300
            split = tuple(
                {i: rng.choice(np.arange(itv), size=100, replace=False)
                 for i in cases}
                for cases in (TRAIN_CASES, VAL_CASES, TEST_CASES))
            write_atomic(split_path, lambda f: pickle.dump(split, f))

        mapping = {"train": split[0], "val": split[1],
                   "test": split[2]}[partition]
        each_len = max_samples // len(mapping)
        x_0, v_0, x_t, v_t = [], [], [], []
        for i in mapping:
            st = np.asarray(mapping[i][:each_len], dtype=np.int64)
            x_0.append(X[i][st])
            v_0.append(V[i][st])
            x_t.append(X[i][st + delta_frame])
            v_t.append(V[i][st + delta_frame])
        self.x_0 = np.concatenate(x_0).astype(np.float32)
        self.v_0 = np.concatenate(v_0).astype(np.float32)
        self.x_t = np.concatenate(x_t).astype(np.float32)
        self.v_t = np.concatenate(v_t).astype(np.float32)
        self.n_node = n

        # 1-hop adjacency from the pickled bone list; 2-hop = A @ A
        # (motion.py:101-127; the reference asserts the two sets are
        # disjoint for this skeleton)
        A = np.zeros((n, n), dtype=np.int64)
        for a, b in edges:
            A[a, b] = A[b, a] = 1
        A2 = A @ A
        pairs = []
        for i in range(n):
            for j in range(n):
                if i != j and (A[i, j] or A2[i, j]):
                    pairs.append((i, j))
        self.edges_00 = np.asarray(pairs, dtype=np.int64).T

    def __len__(self) -> int:
        return len(self.x_0)


def manual_complex(edges_00: np.ndarray,
                   n_joints: int = N_JOINTS) -> SimplicialComplex:
    """The ManualTransform structure as a SimplicialComplex: skeleton 0-0
    edges + boundary / shared-coface adjacency derived from the X1/X2
    tables (the reference hardcodes the derived blocks,
    simplicial_data.py:263-285)."""
    edge_idx = {tuple(sorted(e)): i for i, e in enumerate(X1.tolist())}
    adj: Dict[Tuple[int, int], List[Tuple[int, int]]] = {
        (0, 0): [tuple(p) for p in edges_00.T.tolist()],
        (0, 1): [], (1, 1): [], (1, 2): [],
    }
    for ei, (a, b) in enumerate(X1.tolist()):
        adj[(0, 1)] += [(a, ei), (b, ei)]
    for ti, (a, b, c) in enumerate(X2.tolist()):
        bnd = [edge_idx[t] for t in
               ((a, b), (a, c), (b, c))]
        adj[(1, 2)] += [(e, ti) for e in bnd]
        adj[(1, 1)] += [(e1, e2) for e1 in bnd for e2 in bnd if e1 != e2]
    x = {0: np.arange(n_joints, dtype=np.int64).reshape(-1, 1),
         1: X1.copy(), 2: X2.copy()}
    adj_np = {k: np.asarray(v, dtype=np.int64).T for k, v in adj.items()}
    return SimplicialComplex(2, x, adj_np)


def _synthesize_raw(root: str, seed: int = 7, n_trials: int = 23,
                    T: int = 331) -> None:
    """Seeded stand-in motion.pkl in the reference's exact pickle format
    (list of (T, 31, 3) trajectories + bone list); marked SYNTHETIC."""
    rng = np.random.RandomState(seed)
    edges = [(i, i + 1) for i in range(N_JOINTS - 1)]
    edges += [(6, 8), (1, 3), (24, 26), (21, 23)]
    base = rng.randn(N_JOINTS, 3)
    X = []
    for _ in range(n_trials):
        steps = 0.02 * rng.randn(T, N_JOINTS, 3)
        X.append((base[None] + np.cumsum(steps, axis=0)).astype(np.float64))
    os.makedirs(root, exist_ok=True)
    write_atomic(os.path.join(root, "motion.pkl"),
                 lambda f: pickle.dump((edges, X), f))
    write_atomic(os.path.join(root, "SYNTHETIC"), lambda f: f.write(
        b"generated stand-in data; drop the real GMN motion.pkl here to "
        b"train on it\n"))
    print("motion: no raw motion.pkl found -> generated SYNTHETIC stand-in")


class MotionDataset:
    """Dataset facade (reference MotionDataset, motion.py:243-312)."""

    def __init__(self, batch_size: int = 100,
                 num_training_samples: int = 200,
                 num_eval_samples: int = 600, delta_frame: int = 30):
        self.batch_size = int(batch_size)
        root = os.path.join(dataroot(), "motion")
        if not os.path.exists(os.path.join(root, "motion.pkl")):
            _synthesize_raw(root)
        raw_sz = os.path.getsize(os.path.join(root, "motion.pkl"))
        cache = os.path.join(
            root, f"processed_{num_training_samples}_{num_eval_samples}"
            f"_{delta_frame}_{raw_sz}")
        splits = ("train", "val", "test")
        if all(os.path.exists(os.path.join(cache, f"{s}.npz"))
               for s in splits):
            datasets = {s: SimplicialArrayDataset.load(
                os.path.join(cache, f"{s}.npz")) for s in splits}
        else:
            counts = {"train": int(num_training_samples),
                      "val": int(num_eval_samples),
                      "test": int(num_eval_samples)}
            raws = {s: Motion(s, counts[s], delta_frame, root)
                    for s in splits}
            big = flatten_complex(manual_complex(raws["train"].edges_00))
            spec = spec_from_graphs([big])
            datasets = {}
            for s, raw in raws.items():
                samples = [pad_big_graph(big, spec,
                                         {"pos": raw.x_0[i],
                                          "vel": raw.v_0[i]})
                           for i in range(len(raw))]
                targets = [{"y": raw.x_t[i]} for i in range(len(raw))]
                ds = SimplicialArrayDataset.from_samples(samples, targets,
                                                         spec)
                ds.save(os.path.join(cache, f"{s}.npz"))
                datasets[s] = ds
        self.train_dataset = datasets["train"]
        self.val_dataset = datasets["val"]
        self.test_dataset = datasets["test"]
        self.spec = self.train_dataset.spec

    def train_loader(self, seed: Optional[int] = None,
                     shard: Optional[Tuple[int, int]] = None) -> Loader:
        return Loader(self.train_dataset, self.batch_size, shuffle=True,
                      seed=seed, shard=shard)

    def val_loader(self,
                   shard: Optional[Tuple[int, int]] = None) -> Loader:
        return Loader(self.val_dataset, self.batch_size, shuffle=False,
                      shard=shard)

    def test_loader(self,
                    shard: Optional[Tuple[int, int]] = None) -> Loader:
        return Loader(self.test_dataset, self.batch_size, shuffle=False,
                      shard=shard)
