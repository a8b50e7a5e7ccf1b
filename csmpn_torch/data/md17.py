"""MD17 molecular-dynamics dataset.

Port of ``csmpn_tpu/data/md17.py``; on the same ``$DATAROOT`` it gives
byte-identical arrays, and the raw, split and ``processed_*`` files of
either package read back in the other.

  * ``preprocess_raw``: ``md17_<mol>.npz`` (keys R (T, N, 3), z (N,)), the
    last frame dropped, hydrogens dropped (z > 1), the bond structure as
    the frame-0 adjacency at distance < 1.6; 20-frame trajectories (frame
    gap 20, one every 20 frames) sliced out of contiguous 5:1:2
    train/val/test periods and shuffled with a fixed seed;
  * per sample: 10 past and 10 future frames; velocity by frame
    difference with frame 0 copying frame 1; charges repeated per frame;
  * the lift on the frame-0 positions: aspirin takes the clique lift of
    the kNN graph with k = int(dis) (edge and triangle thresholds), every
    other molecule Rips at scale ``dis``.

Without the raw ``md17_<mol>.npz`` a seeded stand-in with the molecule's
heavy-atom formula plus hydrogens is written (marked SYNTHETIC) and the
same path runs on it.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from .batching import pad_big_graph, spec_from_graphs
from .lifting import clique_lift, flatten_complex, rips_lift
from .loader import Loader, SimplicialArrayDataset, dataroot

PAST_FRAMES = 10
FUTURE_FRAMES = 10
FRAME_GAP = 20
SAMPLE_FREQ = 20
TRAJ_LEN = (PAST_FRAMES + FUTURE_FRAMES) * FRAME_GAP  # 400 raw frames

# heavy-atom formulas of the stand-in molecules (C = 6, O = 8)
_HEAVY_Z = {
    "aspirin": [6] * 9 + [8] * 4,          # C9H8O4
    "benzene2017": [6] * 6,                # C6H6
    "ethanol": [6, 6, 8],                  # C2H6O
    "malonaldehyde": [6, 6, 6, 8, 8],      # C3H4O2
}


def preprocess_raw(data_dir: str, molecule_type: str) -> bool:
    """Writes ``<mol>_{charges,structure,train,val,test}.npy`` from
    ``md17_<mol>.npz``.  Returns False when the raw file is absent."""
    raw = os.path.join(data_dir, f"md17_{molecule_type}.npz")
    if not os.path.exists(raw):
        return False
    data = np.load(raw)
    x = np.asarray(data["R"], dtype=np.float64)
    z = np.asarray(data["z"])
    x = x[:-1]                       # velocity diff drops the last frame
    x = x[:, z > 1]                  # hydrogens dropped
    z = z[z > 1]

    n = x.shape[1]
    d0 = np.sqrt(((x[0][:, None] - x[0][None]) ** 2).sum(-1))
    structure = ((d0 < 1.6) & ~np.eye(n, dtype=bool)).astype(np.float64)
    np.save(os.path.join(data_dir, f"{molecule_type}_charges.npy"), z)
    np.save(os.path.join(data_dir, f"{molecule_type}_structure.npy"),
            structure)

    total = x.shape[0]
    train_len = int(total * 5 / 8)
    val_len = int(total * 1 / 8)
    test_len = int(total * 2 / 8)
    periods = {
        "train": x[:train_len],
        "val": x[train_len:train_len + val_len],
        "test": x[train_len + val_len:train_len + val_len + test_len],
    }
    rng = np.random.RandomState(0)
    for split, period in periods.items():
        num = int((len(period) - TRAJ_LEN) / SAMPLE_FREQ)
        trajs = np.stack([
            period[SAMPLE_FREQ * j:SAMPLE_FREQ * j + TRAJ_LEN:FRAME_GAP]
            for j in range(num)]).astype(np.float32)
        rng.shuffle(trajs)
        np.save(os.path.join(data_dir,
                             f"{molecule_type}_{split}.npy"), trajs)
    return True


def _synthesize_raw(data_dir: str, molecule_type: str, seed: int = 11,
                    T: int = 120001) -> None:
    """Seeded stand-in ``md17_<mol>.npz`` in the raw key layout, with the
    molecule's heavy-atom formula plus hydrogens: T = 120001 frames give
    ~3000 sliced 20-frame trajectories."""
    rng = np.random.RandomState(seed)
    heavy = _HEAVY_Z.get(molecule_type, [6, 6, 8])
    z = np.asarray(heavy + [1] * len(heavy))
    base = rng.randn(len(z), 3) * 1.2
    t = np.arange(T, dtype=np.float64)[:, None, None]
    phase = rng.rand(len(z), 3) * 2 * np.pi
    R = base[None] + 0.08 * np.sin(0.013 * t + phase) \
        + 0.01 * rng.randn(T, len(z), 3)
    os.makedirs(data_dir, exist_ok=True)
    np.savez(os.path.join(data_dir, f"md17_{molecule_type}.npz"), R=R, z=z)
    with open(os.path.join(data_dir, "SYNTHETIC"), "w") as f:
        f.write("generated stand-in data; drop the real md17_<mol>.npz "
                "here to train on it\n")
    print(f"md17: no raw md17_{molecule_type}.npz found -> generated "
          "SYNTHETIC stand-in")


def knn_graph(points: np.ndarray, k: int) -> np.ndarray:
    """Directed kNN edge list (neighbour -> centre, no self loops), (2,
    n * min(k, n - 1)) int64, neighbours of each centre nearest first."""
    n = len(points)
    k = min(int(k), n - 1)
    d2 = ((points[:, None] - points[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nbrs = np.argsort(d2, axis=1)[:, :k]          # (n, k)
    src = nbrs.reshape(-1)
    dst = np.repeat(np.arange(n), k)
    return np.stack([src, dst]).astype(np.int64)


def lift_sample(init_pos: np.ndarray, molecule_type: str, dis: float,
                dim: int, edge_th: float, tri_th: float):
    """The simplicial complex of one sample from its frame-0 positions."""
    if molecule_type == "aspirin":
        ei = knn_graph(init_pos, int(dis))
        return clique_lift(init_pos, ei, edge_th=edge_th, tri_th=tri_th,
                           max_dim=dim)
    return rips_lift(init_pos, dim, float(dis))


class MD17Dataset:
    """Train/val/test splits and their loaders; ``model_kwargs`` gives the
    model the molecule's heavy-atom count."""

    def __init__(self, batch_size: int = 100,
                 molecule_type: str = "aspirin", dis: float = 2.5,
                 dim: int = 2, edge_th: float = 10000.0,
                 tri_th: float = 10000.0, num_train_samples: int = 5000,
                 num_eval_samples: int = 2000):
        self.batch_size = int(batch_size)
        root = os.path.join(dataroot(), "md17")
        splits = ("train", "val", "test")
        if not all(os.path.exists(
                os.path.join(root, f"{molecule_type}_{s}.npy"))
                for s in splits):
            if not preprocess_raw(root, molecule_type):
                _synthesize_raw(root, molecule_type)
                if not preprocess_raw(root, molecule_type):
                    raise RuntimeError(
                        f"md17: no md17_{molecule_type}.npz in {root}")

        charges = np.load(
            os.path.join(root, f"{molecule_type}_charges.npy"))
        n_heavy = len(charges)
        self.model_kwargs: Dict[str, int] = {"n_vertices": int(n_heavy)}

        counts = {"train": int(num_train_samples),
                  "val": int(num_eval_samples),
                  "test": int(num_eval_samples)}
        raw_sz = os.path.getsize(
            os.path.join(root, f"{molecule_type}_train.npy"))
        cache = os.path.join(
            root, f"processed_{molecule_type}_{float(dis)}_{dim}"
            f"_n{num_train_samples}_e{num_eval_samples}_{raw_sz}")
        if all(os.path.exists(os.path.join(cache, f"{s}.npz"))
               for s in splits):
            datasets = {s: SimplicialArrayDataset.load(
                os.path.join(cache, f"{s}.npz")) for s in splits}
        else:
            per_split = {}
            for s in splits:
                loc = np.load(os.path.join(
                    root, f"{molecule_type}_{s}.npy"))[:counts[s]]
                loc = loc.swapaxes(1, 2)          # (S, N, 20, 3)
                vel = np.zeros_like(loc)
                vel[:, :, 1:] = loc[:, :, 1:] - loc[:, :, :-1]
                vel[:, :, 0] = vel[:, :, 1]
                per_split[s] = (loc, vel)
            bigs = {s: [flatten_complex(lift_sample(
                        loc[i, :, 0], molecule_type, dis, dim, edge_th,
                        tri_th)) for i in range(len(loc))]
                    for s, (loc, _) in per_split.items()}
            spec = spec_from_graphs(
                [g for graphs in bigs.values() for g in graphs])
            ch = np.tile(charges.astype(np.float32)[:, None, None],
                         (1, PAST_FRAMES, 1))     # (N, 10, 1)
            datasets = {}
            for s, (loc, vel) in per_split.items():
                samples = [
                    pad_big_graph(bigs[s][i], spec, {
                        "loc": loc[i, :, :PAST_FRAMES].astype(np.float32),
                        "vel": vel[i, :, :PAST_FRAMES].astype(np.float32),
                        "charges": ch,
                    }) for i in range(len(loc))]
                targets = [
                    {"y": loc[i, :, PAST_FRAMES:PAST_FRAMES
                              + FUTURE_FRAMES].astype(np.float32)}
                    for i in range(len(loc))]
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
