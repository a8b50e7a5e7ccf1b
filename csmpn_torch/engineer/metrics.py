"""Metric collections: append-only, computed at log/val boundaries
(single process; the multi-process all-gather comes with the scale-out
slice)."""
from __future__ import annotations

import warnings
from typing import Dict

import numpy as np


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
        return np.concatenate([np.atleast_1d(v) for v in self.collection],
                              axis=0)

    def compute(self):
        raise NotImplementedError


class Loss(Metric):
    def compute(self):
        return self._cat().mean(axis=0)


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
