"""Step-based Trainer.

Port of ``csmpn_tpu/engineer/trainer.py``: step budget, periodic
validation at interval-boundary crossings, a test pass after each
checkpoint improvement, s_it timing, NaN detection and the max_time guard,
with the same stdout lines.  A step is an eager PyTorch forward, backward
and optimizer update on the model's device.

The reference's TPU-relay knobs (``mesh``, ``donate``, ``profile_dir``,
``profile_steps``, ``steps_per_dispatch``, ``eval_batches_per_dispatch``,
``max_rss_gb``, ``device_data``) are accepted at their defaults only; any
other value raises NotImplementedError (ROADMAP.md, Queue 1, "trainer
knobs").
"""
from __future__ import annotations

import datetime
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .checkpoint import Checkpoint
from .loggers import ConsoleLogger
from .metrics import Loss, MetricCollection

_KNOB_DEFAULTS = {
    "mesh": None, "donate": True, "profile_dir": None,
    "profile_steps": (8, 12), "steps_per_dispatch": 1,
    "eval_batches_per_dispatch": 1, "max_rss_gb": 0.0, "device_data": False,
}


def human_format(num: float) -> str:
    num = float(f"{num:.3g}")
    magnitude = 0
    while abs(num) >= 1000:
        magnitude += 1
        num /= 1000.0
    suffix = ["", "K", "M", "B", "T"][magnitude]
    return f"{num:f}".rstrip("0").rstrip(".") + suffix


def print_git_state() -> None:
    """Record the code state of the run."""
    import subprocess

    def run(cmd):
        try:
            return subprocess.run(cmd, shell=True, capture_output=True,
                                  text=True, timeout=5).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            return "?"

    print("\nGit state\n---")
    print(f"Branch: {run('git rev-parse --abbrev-ref HEAD')}")
    print(f"Commit: {run('git rev-parse HEAD')}")
    print(f"Message: {run('git log -1 --pretty=%B')}\n")


def _parse_max_time(time_str: Optional[str]):
    if time_str is None:
        return None
    days = 0
    if "-" in time_str:
        d, time_str = time_str.split("-")
        days = int(d)
    parts = [int(p) for p in time_str.split(":")]
    while len(parts) < 3:
        parts.insert(0, 0)
    h, m, s = parts
    return datetime.timedelta(days=days, hours=h, minutes=m, seconds=s)


def _to_host(outputs: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy() for k, v in outputs.items()}


class Trainer:
    def __init__(
        self,
        scheduler: Any = None,           # step -> lr (logged)
        logger: Any = None,
        max_steps: int = 0,
        max_time: Optional[str] = None,
        limit_val_batches: float = float("inf"),
        val_check_interval: int = 1024,
        print_interval: int = 32,
        fast_dev_run: bool = False,
        callbacks: Optional[list] = None,
        log_interval: int = 256,
        checkpoint: Any = None,
        test_only: bool = False,
        skip_initial_eval: bool = False,
        mesh: Any = None,
        donate: bool = True,
        profile_dir: Optional[str] = None,
        profile_steps: tuple = (8, 12),
        steps_per_dispatch: int = 1,
        eval_batches_per_dispatch: int = 1,
        max_rss_gb: float = 0.0,
        device_data: bool = False,
    ):
        given = dict(mesh=mesh, donate=donate, profile_dir=profile_dir,
                     profile_steps=tuple(profile_steps),
                     steps_per_dispatch=steps_per_dispatch,
                     eval_batches_per_dispatch=eval_batches_per_dispatch,
                     max_rss_gb=max_rss_gb, device_data=device_data)
        for k, default in _KNOB_DEFAULTS.items():
            if given[k] != default:
                raise NotImplementedError(
                    f"trainer.{k}={given[k]!r} is not ported yet (ROADMAP.md, "
                    f"Queue 1, trainer knobs); leave it at {default!r}")
        callbacks = list(callbacks or [])
        if logger is None:
            logger = ConsoleLogger()
        if any(isinstance(c, Checkpoint) for c in callbacks):
            if checkpoint is not None:
                raise ValueError("Checkpoint already in callbacks.")
            checkpoint = next(c for c in callbacks
                              if isinstance(c, Checkpoint))
        elif checkpoint is None:
            checkpoint = Checkpoint("val/loss")
            callbacks.append(checkpoint)
        elif isinstance(checkpoint, str):
            checkpoint = Checkpoint(dir=checkpoint)
            callbacks.append(checkpoint)

        if fast_dev_run:
            print("Development run: limiting to 1 step / 1 val batch.")
            max_steps = 1
            limit_val_batches = 1

        self.starting_time = datetime.datetime.now()
        self.max_time = _parse_max_time(max_time)
        self.checkpoint = checkpoint
        self.callbacks = callbacks
        self.scheduler = scheduler
        self.max_steps = max_steps
        self.limit_val_batches = limit_val_batches
        self.val_check_interval = val_check_interval
        self.logger = logger
        self.print_interval = print_interval
        self.log_interval = log_interval
        self.test_only = test_only
        self.skip_initial_eval = skip_initial_eval

        self.global_step = 0
        self.current_epoch = 0
        self.should_raise: Optional[Exception] = None
        self.should_test = False
        # host seconds of each training step (forward, backward, update,
        # and the loss read-back that waits for the device)
        self.step_seconds = []

    def _add_prefix(self, metrics: Dict, prefix: str) -> Dict:
        return {f"{prefix}/{k}": v for k, v in metrics.items()}

    def _make_metrics(self, model) -> MetricCollection:
        names = getattr(model, "metric_names", ("loss",))
        if callable(names):
            names = names()
        return MetricCollection({n: Loss() for n in names})

    @property
    def should_stop(self) -> bool:
        if (self.max_time is not None
                and self.max_time
                < datetime.datetime.now() - self.starting_time):
            print("Stopping due to max_time.")
            return True
        if self.max_steps is not None and self.global_step >= self.max_steps:
            print("Stopping due to max_steps.")
            return True
        return False

    def test_loop(self, test_loader, validation=False):
        metrics = self._test_metrics
        prefix = "val" if validation else "test"
        label = "Validation" if validation else "Testing"
        num_iterations = int(min(len(test_loader), self.limit_val_batches))
        t0 = time.time()
        self.model.eval()
        with torch.no_grad():
            for batch_idx, batch in enumerate(test_loader):
                if batch_idx >= self.limit_val_batches:
                    break
                _, outputs = self.model(batch.to(self.device), batch_idx,
                                        "val")
                metrics.update(**_to_host(outputs))
                if batch_idx % self.print_interval == 0:
                    print(f"Step: {self.global_step} ({label}) "
                          f"Batch: {batch_idx} / {num_iterations}")
        self.model.train()
        s_it = (time.time() - t0) / max(num_iterations, 1)
        computed = metrics.compute()
        metrics.reset()
        computed["s_it"] = s_it
        computed = self._add_prefix(computed, prefix)
        if self.logger:
            self.logger.log_metrics(computed, step=self.global_step)
        if validation:
            for callback in self.callbacks:
                callback.on_test_end(self, self.model, self.optimizer,
                                     computed)
        return computed

    def train_step(self, batch):
        t0 = time.perf_counter()
        batch = batch.to(self.device)
        loss, outputs = self.model(batch, self.global_step, "train")
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        loss_val = float(loss.detach())
        self.step_seconds.append(time.perf_counter() - t0)
        self._train_metrics.update(**_to_host(outputs))
        if np.isnan(loss_val):
            self.should_raise = ValueError("Loss is NaN.")
        if self.global_step % self.print_interval == 0:
            print(f"Step: {self.global_step} (Training) Loss: "
                  f"{loss_val:.4f}")

    def fit(self, model, optimizer, train_loader, val_loader=None,
            test_loader=None, lr_scheduler=None):
        """model: an nn.Module already on its device; optimizer over its
        parameters; lr_scheduler stepped once per training step."""
        self.model = model
        self.optimizer = optimizer
        self.lr_scheduler = lr_scheduler
        self.device = next(model.parameters()).device
        self._train_metrics = self._make_metrics(model)
        self._test_metrics = self._make_metrics(model)

        print_git_state()
        print("\nModel Summary\n---")
        print(model)
        n_params = sum(p.numel() for p in model.parameters())
        print(f"Total parameters: {human_format(n_params)}\n")

        if self.checkpoint:
            self.checkpoint.restore(self, model, optimizer)

        model.train()
        if self.test_only:
            print("Testing mode.")
            self.test_loop(test_loader, validation=False)
            return model

        t0 = time.time()
        last_global_step = self.global_step

        def next_boundary(step, interval, skip_zero=False):
            n = -(-step // interval) * interval
            if skip_zero and n == 0:
                n = interval
            return n

        self._next_log = next_boundary(self.global_step, self.log_interval)
        self._next_val = next_boundary(self.global_step,
                                       self.val_check_interval,
                                       self.skip_initial_eval)

        while not self.should_stop:
            for batch in train_loader:
                self.train_step(batch)

                if self.global_step >= self._next_log:
                    self._next_log = (
                        self.global_step // self.log_interval + 1
                    ) * self.log_interval
                    t1 = time.time()
                    train_metrics = self._train_metrics.compute()
                    self._train_metrics.reset()
                    denom = self.global_step + 1 - last_global_step
                    train_metrics["s_it"] = (t1 - t0) / max(denom, 1)
                    if self.scheduler is not None:
                        train_metrics["lr"] = float(
                            self.scheduler(self.global_step))
                    train_metrics["epoch"] = self.current_epoch
                    if self.logger:
                        self.logger.log_metrics(
                            self._add_prefix(train_metrics, "train"),
                            step=self.global_step)
                    t0 = time.time()
                    last_global_step = self.global_step

                if self.global_step >= self._next_val:
                    self._next_val = (
                        self.global_step // self.val_check_interval + 1
                    ) * self.val_check_interval
                    if val_loader is not None and self.limit_val_batches > 0:
                        self.test_loop(val_loader, validation=True)
                    t0 = time.time()
                    last_global_step = self.global_step
                    if self.should_test and test_loader is not None:
                        self.test_loop(test_loader, validation=False)
                        self.should_test = False

                self.global_step += 1
                if self.should_raise is not None:
                    raise self.should_raise
                if self.should_stop:
                    break
            self.current_epoch += 1
        if self.checkpoint is not None:
            self.checkpoint.save_last(self, model, optimizer)
        return model
