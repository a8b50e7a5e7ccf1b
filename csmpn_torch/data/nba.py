"""NBA SportVU trajectory dataset.

Port of ``csmpn_tpu/data/nba.py``; on the same ``$DATAROOT`` it gives
byte-identical arrays, and the raw, split and ``processed_*`` files of
either package read back in the other.

  * ``preprocess_raw``: ``all_data.npy`` (plays, seq_len, ball + 10
    players, 4 columns); attacking team = player columns 1:6, defence =
    6:11; the ball dropped; the xy columns kept; x shifted by -45 (court
    origin); a 60/20/20 play split with ceil boundaries;
  * per sample: the 5 players' series, velocity by frame difference with
    frame 0 left zero, a constant (1, 1) reference point appended as a
    6th node to the positions AND the velocities; targets the 5 players'
    frames 10:50;
  * the lift: Rips at ``dis`` over the frame-0 positions (at the
    published dis = 10000 the complete 2-complex over 6 vertices).

Without the raw ``all_data.npy`` a seeded stand-in in the same on-disk
format is written (marked SYNTHETIC) and the same path runs on it.
"""
from __future__ import annotations

import os
from math import ceil
from typing import Optional

import numpy as np

from .batching import pad_big_graph, spec_from_graphs
from .lifting import flatten_complex, rips_lift
from .loader import Loader, SimplicialArrayDataset, dataroot

OBS_FRAMES = 10
PRED_FRAMES = 40
SEQ_LEN = OBS_FRAMES + PRED_FRAMES


def preprocess_raw(data_dir: str, mode: str = "atk",
                   train_pct: int = 60, val_pct: int = 20) -> bool:
    """Writes ``{mode}/trajectories_{split}.npy`` from ``all_data.npy``.
    Returns False when the raw file is absent."""
    raw = os.path.join(data_dir, "all_data.npy")
    if not os.path.exists(raw):
        return False
    data = np.load(raw, allow_pickle=True)
    if mode == "atk":
        data = data[:, :, 1:6, :]
    elif mode == "def":
        data = data[:, :, 6:, :]
    else:
        data = data[:, :, 1:, :]
    data = np.delete(data, [2, 3], axis=3)        # xy columns only
    data = np.array(data, dtype=np.float32)
    data[:, :, :, 0] -= 45.0                      # court-origin shift
    plays = data.shape[0]
    train_end = ceil(plays / 100 * train_pct)
    val_end = ceil(plays / 100 * (train_pct + val_pct))
    out = os.path.join(data_dir, mode)
    os.makedirs(out, exist_ok=True)
    np.save(os.path.join(out, "trajectories_train.npy"), data[:train_end])
    np.save(os.path.join(out, "trajectories_val.npy"),
            data[train_end:val_end])
    np.save(os.path.join(out, "trajectories_test.npy"), data[val_end:])
    return True


def _synthesize_raw(data_dir: str, seed: int = 3, plays: int = 40,
                    seq_len: int = SEQ_LEN) -> None:
    """Seeded stand-in ``all_data.npy``: (plays, seq_len, 11, 4), x in
    [45, 90] (the SportVU column layout).  Motion is an AR(1) velocity
    process (momentum 0.9), so the future frames are predictable from the
    observed ones."""
    rng = np.random.RandomState(seed)
    start = np.empty((plays, 1, 11, 4), dtype=np.float64)
    start[..., 0] = 45.0 + 45.0 * rng.rand(plays, 1, 11)
    start[..., 1] = 50.0 * rng.rand(plays, 1, 11)
    start[..., 2:] = rng.rand(plays, 1, 11, 2)
    vel = 0.5 * rng.randn(plays, 1, 11, 4)
    noise = 0.08 * rng.randn(plays, seq_len, 11, 4)
    steps = np.empty_like(noise)
    for t in range(seq_len):
        vel = 0.9 * vel + noise[:, t:t + 1]
        steps[:, t:t + 1] = vel
    steps[..., 2:] = 0.0
    data = (start + np.cumsum(steps, axis=1)).astype(np.float32)
    os.makedirs(data_dir, exist_ok=True)
    np.save(os.path.join(data_dir, "all_data.npy"), data)
    with open(os.path.join(data_dir, "SYNTHETIC"), "w") as f:
        f.write("generated stand-in data; drop the real SportVU "
                "all_data.npy here to train on it\n")
    print("nba: no raw all_data.npy found -> generated SYNTHETIC stand-in")


class NBADataset:
    """Train/val/test splits and their loaders.  ``synth_plays`` sizes the
    stand-in raw file when the real ``all_data.npy`` is absent (800 gives
    480/160/160 plays); ``max_samples`` cuts every split."""

    def __init__(self, batch_size: int = 100, mode: str = "atk",
                 dim: int = 2, dis: float = 10000.0,
                 max_samples: int = 0, synth_plays: int = 40):
        self.batch_size = int(batch_size)
        root = os.path.join(dataroot(), "nba")
        splits = ("train", "val", "test")
        mdir = os.path.join(root, mode)
        if not all(os.path.exists(
                os.path.join(mdir, f"trajectories_{s}.npy"))
                for s in splits):
            if not preprocess_raw(root, mode):
                _synthesize_raw(root, plays=int(synth_plays))
                if not preprocess_raw(root, mode):
                    raise RuntimeError(f"nba: no all_data.npy in {root}")

        raw_sz = os.path.getsize(
            os.path.join(mdir, "trajectories_train.npy"))
        cache = os.path.join(
            root, f"processed_{mode}_{float(dis)}_{dim}"
            f"_m{max_samples}_{raw_sz}")
        if all(os.path.exists(os.path.join(cache, f"{s}.npz"))
               for s in splits):
            datasets = {s: SimplicialArrayDataset.load(
                os.path.join(cache, f"{s}.npz")) for s in splits}
        else:
            per_split = {}
            for s in splits:
                traj = np.load(
                    os.path.join(mdir, f"trajectories_{s}.npy"))
                if max_samples:
                    traj = traj[:max_samples]
                traj = traj.swapaxes(1, 2)        # (S, 5, 50, 2)
                vel = np.zeros_like(traj)
                vel[:, :, 1:] = traj[:, :, 1:] - traj[:, :, :-1]
                # reference point (1, 1) appended to pos AND vel
                ref = np.ones(traj.shape[:1] + (1,) + traj.shape[2:],
                              dtype=traj.dtype)
                pos6 = np.concatenate([traj, ref], axis=1)  # (S, 6, 50, 2)
                vel6 = np.concatenate([vel, ref], axis=1)
                per_split[s] = (pos6, vel6, traj)
            bigs = {s: [flatten_complex(
                        rips_lift(pos6[i, :, 0], dim, float(dis)))
                        for i in range(len(pos6))]
                    for s, (pos6, _, _) in per_split.items()}
            spec = spec_from_graphs(
                [g for graphs in bigs.values() for g in graphs])
            datasets = {}
            for s, (pos6, vel6, traj) in per_split.items():
                samples = [
                    pad_big_graph(bigs[s][i], spec, {
                        "pos": pos6[i, :, :OBS_FRAMES].astype(np.float32),
                        "vel": vel6[i, :, :OBS_FRAMES].astype(np.float32),
                    }) for i in range(len(pos6))]
                targets = [
                    {"y": traj[i, :, OBS_FRAMES:SEQ_LEN].astype(np.float32)}
                    for i in range(len(traj))]
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
