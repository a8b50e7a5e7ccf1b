"""Metric collections: append-only, computed at log/val boundaries.

Port of ``csmpn_tpu/engineer/metrics.py``.  In a process group of more
than one rank, ``compute`` first gathers every rank's collection and
concatenates them in rank order, as the reference's
``process_allgather(...).reshape(-1, ...)`` does, so each rank computes
the metric over all ranks' samples.  Ranks may hold collections of
different lengths.  ``compute`` is a collective there: every rank must
call it as often as the others.
"""
from __future__ import annotations

import warnings
from typing import Dict

import numpy as np
import torch.distributed as dist

from ..parallel.mesh import is_distributed


def _gather(arr: np.ndarray) -> np.ndarray:
    """``arr`` of every rank, concatenated on axis 0 in rank order."""
    if not is_distributed():
        return arr
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, arr)
    return np.concatenate(
        [np.asarray(p).reshape((-1,) + arr.shape[1:]) for p in parts], axis=0)


class Metric:
    def __init__(self):
        self.collection = []

    def empty(self) -> bool:
        return len(self.collection) == 0

    def update(self, value) -> None:
        self.collection.append(np.asarray(value))

    def reset(self) -> None:
        self.collection.clear()

    def _cat(self) -> np.ndarray:
        return _gather(np.concatenate(
            [np.atleast_1d(v) for v in self.collection], axis=0))

    def compute(self):
        raise NotImplementedError


class Loss(Metric):
    def compute(self):
        return self._cat().mean(axis=0)


class Accuracy(Metric):
    def compute(self):
        cat = self._cat()
        return cat.sum(axis=0) / cat.size


class RMSRE(Metric):
    def compute(self):
        return np.sqrt(self._cat().mean(axis=0))


class RRMSE(Metric):
    """Collects (error_squares, target_squares) pairs."""

    def update(self, value):
        err, tgt = value
        self.collection.append((np.asarray(err), np.asarray(tgt)))

    def compute(self):
        errs = _gather(np.concatenate([np.atleast_1d(e)
                                       for e, _ in self.collection]))
        tgts = _gather(np.concatenate([np.atleast_1d(t)
                                       for _, t in self.collection]))
        return np.sqrt(errs.mean(axis=0) / tgts.mean(axis=0))


def _clf_curve(preds: np.ndarray, target: np.ndarray, pos_label: int = 1):
    """(fps, tps, thresholds) at each distinct score, highest first: the
    false and true positives among the samples scoring at least the
    threshold (sklearn's ``confusion_matrix_at_thresholds``)."""
    order = np.argsort(-preds, kind="stable")
    preds, target = preds[order], target[order]
    distinct = np.where(np.diff(preds) != 0)[0]
    threshold_idxs = np.concatenate([distinct, [target.size - 1]])
    target = (target == pos_label).astype(np.int64)
    tps = np.cumsum(target)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    return fps, tps, preds[threshold_idxs]


def roc_curve(target: np.ndarray, preds: np.ndarray, pos_label: int = 1,
              drop_intermediate: bool = True):
    """(fpr, tpr, thresholds) as sklearn's ``roc_curve``: the points at
    each distinct score, without those collinear with their neighbours
    where ``drop_intermediate``, after a first point (0, 0) at threshold
    inf; fpr (tpr) is NaN throughout without negatives (positives)."""
    fps, tps, thresholds = _clf_curve(np.asarray(preds), np.asarray(target),
                                      pos_label)
    if drop_intermediate and fps.shape[0] > 2:
        keep = np.where(np.concatenate([
            [True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
            [True]]))[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    fps = np.concatenate([[0], fps])
    tps = np.concatenate([[0], tps])
    thresholds = np.concatenate([[np.inf], thresholds.astype(np.float64)])
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds


class BinaryAUROC(Metric):
    """Area under the ROC curve of (scores, binary targets) pairs, by the
    trapezoid rule over the curve's points at each distinct score."""

    def update(self, value):
        preds, target = value
        self.collection.append((np.asarray(preds), np.asarray(target)))

    @staticmethod
    def _roc(preds: np.ndarray, target: np.ndarray, pos_label: int = 1):
        fps, tps, _ = _clf_curve(preds, target, pos_label)
        tps = np.concatenate([[0], tps])
        fps = np.concatenate([[0], fps])
        fpr = fps / fps[-1] if fps[-1] > 0 else np.zeros_like(fps, float)
        tpr = tps / tps[-1] if tps[-1] > 0 else np.zeros_like(tps, float)
        return fpr, tpr

    def _cat_pairs(self):
        preds = _gather(np.concatenate([p for p, _ in self.collection]))
        target = _gather(np.concatenate([t for _, t in self.collection]))
        return preds, target

    def compute(self):
        fpr, tpr = self._roc(*self._cat_pairs())
        return np.trapezoid(tpr, fpr)


class LorentzMetric(BinaryAUROC):
    """AUC and the background rejection at fixed signal efficiency: the
    false-positive rate where the true-positive rate is nearest 0.3 and
    0.5 on ``roc_curve``'s points, as sklearn's ``roc_curve`` and
    ``roc_auc_score`` give them to the reference (which this package does
    not import).  Both classes must be present, as sklearn's AUC asks."""

    def compute(self):
        preds, target = self._cat_pairs()
        if np.unique(target).size != 2:
            raise ValueError("Only one class present in y_true. ROC AUC "
                             "score is not defined in that case.")
        fpr, tpr, _ = roc_curve(target, preds)
        idx = [int(np.argmin(np.abs(tpr - e))) for e in (0.3, 0.5)]
        full_fpr, full_tpr = self._roc(preds, target)
        return {"auc": np.trapezoid(full_tpr, full_fpr),
                "eB_0.3": fpr[idx[0]], "eB_0.5": fpr[idx[1]]}


class MetricCollection:
    def __init__(self, metrics: Dict[str, Metric]):
        self.metrics = metrics

    def empty(self) -> bool:
        return all(m.empty() for m in self.metrics.values())

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            if k not in self.metrics:
                raise ValueError(
                    f"Unknown metric {k}. Did you add it to the model "
                    f"metrics?")
            self.metrics[k].update(v)

    def compute(self) -> Dict[str, np.ndarray]:
        result = {}
        for name, metric in self.metrics.items():
            if metric.empty():
                warnings.warn(f"Metric {name} is empty.")
                continue
            value = metric.compute()
            if isinstance(value, dict):
                result.update(value)
            else:
                result[name] = value
        return result

    def reset(self) -> None:
        for m in self.metrics.values():
            m.reset()

    def keys(self):
        return self.metrics.keys()
