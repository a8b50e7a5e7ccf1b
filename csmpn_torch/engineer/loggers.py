"""Console logger with a working save directory for checkpoints."""
from __future__ import annotations

import os
from typing import Dict, Optional


class ConsoleLogger:
    def __init__(self, dir: Optional[str] = None,
                 run_name: str = "run") -> None:
        self.metrics = []
        if dir is None:
            dir = os.path.join(os.environ.get("RUNDIR", "runs"), run_name)
        self.dir = dir

    def log_metrics(self, metrics: Dict, step: int) -> None:
        for m in metrics:
            if m not in self.metrics:
                print(f"Defined metric {m}.")
                self.metrics.append(m)
        print()
        for k, v in metrics.items():
            try:
                print(f"{k}: {float(v):.4f}")
            except (TypeError, ValueError):
                print(f"{k}: {v}")
        print()

    def save_model(self, file: str, alias: str) -> None:
        pass
