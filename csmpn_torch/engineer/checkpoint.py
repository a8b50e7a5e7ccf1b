"""Best-metric checkpointing with resume.

Port of ``csmpn_tpu/engineer/checkpoint.py``.  A checkpoint is a directory
holding ``state.pt`` (``torch.save`` of the model and optimizer
``state_dict``s, where the reference uses orbax) and a ``meta.json``
sidecar with {metrics, epoch, step}.  An improvement of a tracked metric
saves ``best_<metric>`` and schedules a test pass; a stopped run saves
``last``.  ``Checkpoint(dir=path)`` reads the metadata at once and
restores the tensors when the trainer calls ``restore``.

In a process group (data parallel), ``torch.save`` is no collective, so
rank 0 alone writes (each file under a temporary name, then
``os.replace``) and removes stale checkpoints; then every rank meets at a
barrier.  So no rank goes on past a save before the files are whole, and
a restore loads the same file on every rank.  Every rank calls the saves
equally often: the metrics that decide them are gathered over the ranks.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import torch

from ..data.loader import write_atomic
from ..parallel.mesh import barrier, is_master


def _save(path: str, model, optimizer, trainer, best) -> None:
    os.makedirs(path, exist_ok=True)
    state = {"model": model.state_dict(),
             "optimizer": optimizer.state_dict()}
    meta = {"metrics": best, "epoch": trainer.current_epoch,
            "step": trainer.global_step}
    write_atomic(os.path.join(path, "state.pt"),
                 lambda f: torch.save(state, f))
    write_atomic(os.path.join(path, "meta.json"),
                 lambda f: f.write(json.dumps(meta).encode()))


class Checkpoint:
    def __init__(self, metrics=None, dir: Optional[str] = None):
        self.dir = dir
        self._restore_dir = None
        self._cached_epoch = None
        self._cached_step = None
        if dir is not None:
            metrics = self.load_checkpoint(dir)
        if isinstance(metrics, str):
            metrics = (metrics,)
        if isinstance(metrics, (list, tuple)):
            metrics = {m: float("inf") for m in metrics}
        self.best_metrics: Dict[str, float] = metrics or {}
        self.save_paths: Dict[str, str] = {}

    def load_checkpoint(self, path: str):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        self._restore_dir = path
        self._cached_epoch = meta["epoch"]
        self._cached_step = meta["step"]
        return meta["metrics"]

    def restore(self, trainer, model, optimizer) -> None:
        if self._restore_dir is not None:
            device = next(model.parameters()).device
            state = torch.load(os.path.join(self._restore_dir, "state.pt"),
                               map_location=device, weights_only=True)
            model.load_state_dict(state["model"])
            optimizer.load_state_dict(state["optimizer"])
            print(f"Successfully restored state from {self.dir}!")
        if self._cached_epoch is not None:
            trainer.current_epoch = self._cached_epoch
            print(f"Set current epoch to {self._cached_epoch}.")
        if self._cached_step is not None:
            trainer.global_step = self._cached_step
            print(f"Set global step to {self._cached_step}.")
        self._restore_dir = None
        self._cached_epoch = None
        self._cached_step = None

    def save_last(self, trainer, model, optimizer) -> None:
        """Write the latest state to ``<run dir>/last``."""
        if trainer.logger is None or trainer.logger.dir is None:
            return
        path = os.path.abspath(os.path.join(trainer.logger.dir, "last"))
        if is_master():
            _save(path, model, optimizer, trainer, self.best_metrics)
            print(f"Saved latest-state checkpoint to {path} "
                  f"(step {trainer.global_step}).")
        barrier()

    def on_test_end(self, trainer, model, optimizer, metrics) -> None:
        can_write = (trainer.logger is not None
                     and trainer.logger.dir is not None)
        for m, best in self.best_metrics.items():
            if m not in metrics:
                continue
            value = float(metrics[m])
            if value < best:
                self.best_metrics[m] = value
                if can_write:
                    alias = f"best_{m.replace('/', '_')}"
                    path = os.path.abspath(
                        os.path.join(trainer.logger.dir, alias))
                    if is_master():
                        _save(path, model, optimizer, trainer,
                              self.best_metrics)
                        stale = self.save_paths.get(m)
                        if stale is not None and stale != path \
                                and os.path.isdir(stale):
                            shutil.rmtree(stale)
                        print(f"Metric {m} improved to {value:.4f}; "
                              f"saved checkpoint to {path}. "
                              f"Scheduling test loop.")
                    barrier()
                    self.save_paths[m] = path
                trainer.should_test = True
