"""Console and Weights & Biases loggers, each with a save directory for
checkpoints.  ``wandb`` is imported only when a WANDBLogger is made."""
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


class WANDBLogger:
    """Logs metrics to the current wandb run (started here if there is
    none) and saves checkpoints as model artifacts; its directory is the
    run's."""

    def __init__(self, project: Optional[str] = None,
                 entity: Optional[str] = None, run_name: str = "run"):
        import wandb

        self._wandb = wandb
        if wandb.run is None:
            wandb.init(project=project, entity=entity, name=run_name)
        self.metrics = set()
        self.dir = wandb.run.dir

    @property
    def initialized(self) -> bool:
        return self._wandb.run is not None

    def log_metrics(self, metrics: Dict, step: int) -> None:
        if not self.initialized:
            return
        for m in metrics:
            if m not in self.metrics:
                self._wandb.define_metric(m, summary="max,min,last")
                self.metrics.add(m)
        self._wandb.log(metrics, step=step)

    def save_model(self, file: str, alias: str) -> None:
        if not self.initialized:
            return
        name = str(self._wandb.run.id) + "-model"
        artifact = self._wandb.Artifact(name, type="model")
        artifact.add_file(file)
        self._wandb.log_artifact(artifact, aliases=[alias])
