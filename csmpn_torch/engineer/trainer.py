"""Step-based Trainer.

Port of ``csmpn_tpu/engineer/trainer.py``: step budget, periodic
validation at interval-boundary crossings, a test pass after each
checkpoint improvement, s_it timing, NaN detection and the max_time guard,
with the same stdout lines.  A step is a PyTorch forward, backward and
optimizer update on the model's device.

The reference's knobs:

* ``steps_per_dispatch = K > 1``: the steps run in groups of K.  Losses
  and outputs are read back once a group, and NaN detection, the metrics
  and the "(Training) Loss:" lines (one a step) follow the read-back; log
  and val fire on interval-boundary crossings at group granularity; a
  group persists across epochs; a partial group at the stop is dropped.
  On a CUDA model the steps of a group replay a CUDA graph of ONE
  training step (forward, backward, optimizer step) on static input
  buffers, captured after ``WARMUP_STEPS`` eager steps (real steps, on a
  side stream); the optimizer must be ``capturable`` with a tensor lr
  (``engineer/optim.py``).  A capture or replay failure raises.  On the
  CPU, and at K = 1, the steps run eagerly.
* ``device_data``: the training split is moved to the model's device once
  and each step takes only its (B,) int32 sample indices from the
  loader's ``index_iter``; the batch is gathered on the device with
  ``index_select`` (inside the graph under K > 1).
* ``eval_batches_per_dispatch = K > 1``: eval outputs are read back once
  every K batches.  On a CUDA model each eval batch of the first batch
  shape replays a forward-only CUDA graph, captured after one eager batch;
  a batch of another shape (an unshuffled loader's partial last batch)
  runs eagerly.
* ``profile_dir`` / ``profile_steps = (start, stop)``: a ``torch.profiler``
  window (CPU and, on a card, CUDA activity) from step ``start`` to step
  ``stop``, checked at group starts; its Chrome trace goes to
  ``profile_dir``.
* ``max_rss_gb``: stop cleanly, as max_time does, once the host RSS passes
  the limit (0 = off).
* ``donate``: buffer donation has no PyTorch meaning; any bool is accepted
  and ignored.
* ``mesh`` (``parallel.mesh.Mesh``): data parallel, one process per card.
  ``fit`` broadcasts rank 0's parameters and buffers; every step, eager or
  replayed, all-reduces the gradients and the loss between ``backward``
  and the optimizer step (``parallel.mesh.all_reduce_grads``: one
  all-reduce a dtype of a flat buffer, which leaves the mean over the
  ranks), so the ranks stay identical and the printed loss and
  the NaN check read the mean over the ranks on every rank.  Under CUDA
  graphs the all-reduce is captured in the step's graph.  The stop
  decisions of ``max_time`` and ``max_rss_gb`` stay rank-local, as in the
  reference; ``max_steps`` stops every rank at the same step.

The trainer owns the learning-rate schedule: before every training step,
eager or replayed, it writes ``scheduler(step)`` into the optimizer's
param groups (``schedulers.set_lr``: in place into a tensor lr, so a
graph reads it).

After ``fit``, ``train_graph`` and ``eval_graph`` are the captured
graphs (``StepGraph``: replays, capture seconds, pool bytes; None where
none was captured) and ``step_losses`` the training losses read back.
A replay launches the kernels its capture recorded without calling their
wrappers, so the wrappers' launch counters count the warm-up and the
capture, and no replay.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data.batching import SimplicialBatch
from ..parallel.mesh import (Mesh, all_reduce_grads, is_distributed,
                             replicate)
from .checkpoint import Checkpoint
from .loggers import ConsoleLogger
from .metrics import Loss, MetricCollection
from .schedulers import set_lr

# eager steps before a training step is captured (torch.cuda.graphs asks
# for a warm-up on a side stream: lazy tables, kernel builds, Adam's state)
WARMUP_STEPS = 3
# the key under which a step's scalar loss rides with its outputs to the
# host (not a metric name)
_STEP_LOSS = "(step loss)"


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


def _squeue_time_limit() -> Optional[str]:
    """This SLURM job's TimeLimit from ``squeue`` (None outside a job, or
    where ``squeue`` is missing, fails or prints nothing), so a run without
    ``max_time`` stops before the scheduler kills it."""
    import subprocess

    if "SLURM_JOB_ID" not in os.environ:
        return None
    try:
        out = subprocess.run(
            ["squeue", "-j", os.environ["SLURM_JOB_ID"], "-h",
             "--Format", "TimeLimit"],
            capture_output=True, text=True, timeout=10).stdout
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if not lines:
        return None
    if len(lines) > 1:
        print("WARNING: squeue returned multiple jobs (array job?); "
              "using the first TimeLimit.")
    return lines[0]


def _parse_max_time(time_str: Optional[str]):
    if time_str is None:
        time_str = _squeue_time_limit()
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


def _to_host_group(items: List[Dict[str, torch.Tensor]]
                   ) -> List[Dict[str, np.ndarray]]:
    """The outputs of a group of steps or eval batches on the host, with
    one device-to-host copy a key for the whole group."""
    out: List[Dict[str, np.ndarray]] = [{} for _ in items]
    for k in items[0]:
        vs = [d[k] for d in items]
        flat = torch.cat([v.reshape(-1).float() for v in vs]).cpu().numpy()
        o = 0
        for d, v in zip(out, vs):
            d[k] = flat[o:o + v.numel()].reshape(tuple(v.shape))
            o += v.numel()
    return out


def _leaves(batch: SimplicialBatch) -> List[Any]:
    """A batch's arrays in a fixed order (the dicts' in insertion order)."""
    out = []
    for f in dataclasses.fields(batch):
        x = getattr(batch, f.name)
        out.extend(x.values() if isinstance(x, dict) else [x])
    return out


def _gather(data: SimplicialBatch, idx: torch.Tensor) -> SimplicialBatch:
    """The batch of samples ``idx`` of a split held on the device."""
    def take(x):
        return x.index_select(0, idx)

    return SimplicialBatch(**{
        f.name: ({k: take(v) for k, v in x.items()} if isinstance(x, dict)
                 else take(x))
        for f in dataclasses.fields(data)
        for x in [getattr(data, f.name)]})


def _copy_into(static, src) -> None:
    """Copy a batch (or an index tensor) into the static buffers of a
    graph, leaf by leaf; raises where a shape differs."""
    if isinstance(static, torch.Tensor):
        static.copy_(src)
        return
    for dst, s in zip(_leaves(static), _leaves(src)):
        dst.copy_(torch.as_tensor(s), non_blocking=True)


class _IndexIterView:
    """A Loader seen through its ``index_iter``: each item is a batch's
    int32 sample indices (the ``device_data`` path)."""

    def __init__(self, loader):
        self._loader = loader

    def __len__(self) -> int:
        return len(self._loader)

    def __iter__(self):
        return self._loader.index_iter()


class StepGraph:
    """One captured CUDA graph of ``body(static input)``, the capture's
    host seconds, the device memory its private pool holds
    (``torch.cuda.memory_reserved`` after the capture less before it), and
    the number of replays."""

    def __init__(self, body, static_in, stream: torch.cuda.Stream):
        device = stream.device
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            self.out = body(static_in)
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.static_in = static_in
        self.replays = 0

    def replay(self, src):
        _copy_into(self.static_in, src)
        self.graph.replay()
        self.replays += 1
        return self.out


class Trainer:
    def __init__(
        self,
        scheduler: Any = None,           # step -> lr, applied each step
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
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"trainer.mesh must be a csmpn_torch.parallel."
                            f"mesh.Mesh (make_mesh()), got {mesh!r}")
        if int(steps_per_dispatch) < 1 or int(eval_batches_per_dispatch) < 1:
            raise ValueError("steps_per_dispatch and "
                             "eval_batches_per_dispatch must be >= 1")
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
        self.max_rss_gb = max_rss_gb
        self.profile_dir = profile_dir
        self.profile_steps = tuple(profile_steps)
        self.steps_per_dispatch = int(steps_per_dispatch)
        self.eval_batches_per_dispatch = int(eval_batches_per_dispatch)
        self.device_data = bool(device_data)
        self.mesh = mesh

        self.global_step = 0
        self.current_epoch = 0
        self.should_raise: Optional[Exception] = None
        self.should_test = False
        # host seconds of each training step (forward, backward, update,
        # and the loss read-back that waits for the device); under
        # steps_per_dispatch = K, a group's wall time over K, K times
        self.step_seconds: List[float] = []
        # each training step's loss, as read back
        self.step_losses: List[float] = []
        self._profiler = None
        self._dev_data: Optional[SimplicialBatch] = None
        self.train_graph: Optional[StepGraph] = None
        self._warm_steps = 0
        self.eval_graph: Optional[StepGraph] = None
        self._eval_shape = None

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
        if self.max_rss_gb and self._rss_gb() > self.max_rss_gb:
            print(f"Stopping due to max_rss_gb "
                  f"({self._rss_gb():.1f} > {self.max_rss_gb} GB).")
            return True
        return False

    @staticmethod
    def _rss_gb() -> float:
        """This process's resident set size in GB (0 where unknown)."""
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS"):
                        return int(line.split()[1]) / 1e6
        except OSError:
            pass
        return 0.0

    # ------------------------------------------------------------- eval

    def _eval_batch(self, batch, batch_idx) -> Dict[str, torch.Tensor]:
        """One eval batch's outputs on the device (eval_batches_per_dispatch
        > 1): on a CUDA model a replay of the eval graph where the batch
        has its shape, else an eager forward."""
        batch = batch.to(self.device)

        def body(b):
            _, outputs = self.model(b, batch_idx, "val")
            return {k: v.detach() for k, v in outputs.items()}

        if self.device.type != "cuda":
            return body(batch)
        shape = [tuple(x.shape) for x in _leaves(batch)]
        if self.eval_graph is not None:
            if shape != self._eval_shape:     # another shape: eager
                return body(batch)
            out = self.eval_graph.replay(batch)
            return {k: v.clone() for k, v in out.items()}
        # the first batch warms up on a side stream, then the graph of
        # one eval batch is captured for the batches of its shape
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            out = body(batch)
            out = {k: v.clone() for k, v in out.items()}
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self.eval_graph = StepGraph(body, batch, stream)
        self._eval_shape = shape
        return out

    def test_loop(self, test_loader, validation=False):
        metrics = self._test_metrics
        prefix = "val" if validation else "test"
        label = "Validation" if validation else "Testing"
        num_iterations = int(min(len(test_loader), self.limit_val_batches))
        k = self.eval_batches_per_dispatch
        t0 = time.time()
        self.model.eval()
        pending = []
        with torch.no_grad():
            for batch_idx, batch in enumerate(test_loader):
                if batch_idx >= self.limit_val_batches:
                    break
                if k == 1:
                    _, outputs = self.model(batch.to(self.device),
                                            batch_idx, "val")
                    metrics.update(**_to_host_group([outputs])[0])
                    if batch_idx % self.print_interval == 0:
                        print(f"Step: {self.global_step} ({label}) "
                              f"Batch: {batch_idx} / {num_iterations}")
                    continue
                pending.append(self._eval_batch(batch, batch_idx))
                if len(pending) == k:
                    for out in _to_host_group(pending):
                        metrics.update(**out)
                    pending = []
                    print(f"Step: {self.global_step} ({label}) "
                          f"Batch: {batch_idx + 1} / {num_iterations}")
            if pending:                        # a trailing partial group
                for out in _to_host_group(pending):
                    metrics.update(**out)
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

    # --------------------------------------------------------- training

    def _maybe_profile(self) -> None:
        if self.profile_dir is None:
            return
        start, stop = self.profile_steps
        if self.global_step == start and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=activities)
            self._profiler.start()
            print(f"Profiler trace started -> {self.profile_dir}")
        elif self.global_step >= stop and self._profiler is not None:
            self._stop_profile()

    def _stop_profile(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir,
                            f"trace_steps_{self.profile_steps[0]}_"
                            f"{self.global_step}.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        print(f"Profiler trace written to {path}")

    def _batch(self, item) -> SimplicialBatch:
        """A step's batch on the device: gathered from the split held
        there (``device_data``, ``item`` = its indices) or copied."""
        if self._dev_data is not None:
            idx = torch.as_tensor(item).to(self.device)
            return _gather(self._dev_data, idx)
        return item.to(self.device)

    def _reduce(self, loss: torch.Tensor) -> torch.Tensor:
        """Under a mesh the gradients and ``loss`` averaged over the ranks
        (after ``backward``, before the optimizer step); the loss, detached,
        is returned."""
        if self.mesh is None:
            return loss.detach()
        return all_reduce_grads(self.model.parameters(), self.mesh, loss)

    def _eager_step(self, item, step):
        self._set_lr(step)
        batch = self._batch(item)
        loss, outputs = self.model(batch, step, "train")
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss = self._reduce(loss)
        self.optimizer.step()
        return loss, {k: v.detach() for k, v in outputs.items()}

    def _graph_body(self, static_in):
        """One training step on the graph's static input (a batch, or
        with device_data its indices); ``step`` is not read by the
        models, so the capture's value is the one baked in."""
        batch = (_gather(self._dev_data, static_in)
                 if self._dev_data is not None else static_in)
        loss, outputs = self.model(batch, self.global_step, "train")
        loss.backward()
        loss = self._reduce(loss)
        self.optimizer.step()
        return {_STEP_LOSS: loss,
                **{k: v.detach() for k, v in outputs.items()}}

    def _set_lr(self, step: int) -> None:
        if self.scheduler is not None:
            set_lr(self.optimizer, self.scheduler(step))

    def _graph_step(self, item, step) -> Dict[str, torch.Tensor]:
        """One training step under CUDA graphs: the first WARMUP_STEPS
        run eagerly on a side stream, the next captures the graph, and
        every step from there replays it."""
        self._set_lr(step)
        if self.train_graph is None:
            static_in = (item.clone() if isinstance(item, torch.Tensor)
                         else item.to(self.device))
            stream = self._side_stream
            current = torch.cuda.current_stream(self.device)
            stream.wait_stream(current)
            if self._warm_steps < WARMUP_STEPS:
                with torch.cuda.stream(stream):
                    self.optimizer.zero_grad(set_to_none=True)
                    out = self._graph_body(static_in)
                current.wait_stream(stream)
                self._warm_steps += 1
                return out
            self.optimizer.zero_grad(set_to_none=True)
            self.train_graph = StepGraph(self._graph_body, static_in, stream)
            current.wait_stream(stream)
        out = self.train_graph.replay(item)
        return {k: v.clone() for k, v in out.items()}

    def train_group(self, items) -> int:
        """len(items) optimizer steps from global_step on, read back once
        (a group of one: an eager step and its read-back); an item is a
        host batch or, with device_data, its indices.  Returns the number
        of steps."""
        self._maybe_profile()
        t0 = time.perf_counter()
        k, step0 = len(items), self.global_step
        results = []
        if self._graphs:
            if self._dev_data is not None:     # (K, B) indices, one copy
                items = list(torch.from_numpy(np.stack(items)).to(
                    self.device))
            for i, item in enumerate(items):
                results.append(self._graph_step(item, step0 + i))
        else:
            for i, item in enumerate(items):
                loss, outputs = self._eager_step(item, step0 + i)
                results.append({_STEP_LOSS: loss, **outputs})
        host = _to_host_group(results)
        dt = (time.perf_counter() - t0) / k
        losses = [float(h.pop(_STEP_LOSS)) for h in host]
        self.step_seconds.extend([dt] * k)
        self.step_losses.extend(losses)
        for out in host:
            self._train_metrics.update(**out)
        if np.isnan(losses).any():
            self.should_raise = ValueError("Loss is NaN.")
        for i, loss in enumerate(losses):
            if (step0 + i) % self.print_interval == 0:
                print(f"Step: {step0 + i} (Training) Loss: {loss:.4f}")
        return k

    def uses_graphs(self, device: torch.device) -> bool:
        """Whether the training steps of a model on ``device`` replay a
        CUDA graph (its optimizer must then be built ``capturable``)."""
        return device.type == "cuda" and self.steps_per_dispatch > 1

    @staticmethod
    def _check_graph_optimizer(optimizer) -> None:
        for group in optimizer.param_groups:
            if not (group.get("capturable")
                    and isinstance(group["lr"], torch.Tensor)):
                raise ValueError(
                    "steps_per_dispatch > 1 on a CUDA model needs an "
                    "optimizer built with capturable=True and a tensor lr "
                    "(csmpn_torch.engineer.optim)")

    def fit(self, model, optimizer, train_loader, val_loader=None,
            test_loader=None):
        """model: an nn.Module already on its device; optimizer over its
        parameters (``capturable`` where ``uses_graphs``)."""
        self.model = model
        self.optimizer = optimizer
        self.device = next(model.parameters()).device
        if self.mesh is not None and self.mesh.device != self.device:
            raise ValueError(f"the model is on {self.device}, the mesh's "
                             f"rank on {self.mesh.device}")
        self._graphs = self.uses_graphs(self.device)
        if self._graphs:
            self._check_graph_optimizer(optimizer)
            self._side_stream = torch.cuda.Stream(self.device)
        if self.device_data:
            if is_distributed():
                raise ValueError(
                    "trainer.device_data supports single-process runs only "
                    "(the split is placed on one device)")
            if not hasattr(train_loader, "index_iter"):
                raise ValueError(
                    "trainer.device_data needs a Loader over a "
                    "SimplicialArrayDataset (index_iter missing).")
            self._dev_data = train_loader.dataset.arrays.to(self.device)
            train_loader = _IndexIterView(train_loader)
        self._train_metrics = self._make_metrics(model)
        self._test_metrics = self._make_metrics(model)

        print_git_state()
        print("\nModel Summary\n---")
        print(model)
        n_params = sum(p.numel() for p in model.parameters())
        print(f"Total parameters: {human_format(n_params)}\n")

        if self.checkpoint:
            self.checkpoint.restore(self, model, optimizer)
        if self.mesh is not None:
            replicate(model, self.mesh)

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

        # a group persists across epochs, so an epoch shorter than a group
        # still reaches the log/val checks
        pending = []
        while not self.should_stop:
            for batch in train_loader:
                pending.append(batch)
                if len(pending) < self.steps_per_dispatch:
                    continue
                consumed = self.train_group(pending)
                pending = []
                # past the group's first k-1 steps; the checks below run
                # for its last
                self.global_step += consumed - 1

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
                    train_metrics["host_rss_gb"] = self._rss_gb()
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
        # batches fetched into a partial group when the stop fired were
        # never trained on: dropping them keeps global_step == steps trained
        if self._profiler is not None:
            self._stop_profile()
        if self.checkpoint is not None:
            self.checkpoint.save_last(self, model, optimizer)
        return model
