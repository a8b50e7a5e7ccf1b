"""Learning-rate schedules as plain ``step -> lr`` functions.  The trainer
writes ``schedule(step)`` into the optimizer with ``set_lr`` before every
step."""
from __future__ import annotations

import math

import torch


def cosine_annealing_schedule(base_lr: float, max_steps: int,
                              warmup_steps: int = 0, decay_steps: int = 0):
    """Cosine warmup -> plateau -> cosine decay (the reference's
    CosineAnnealingLR).  Returns ``step -> lr``."""
    stable_steps = max_steps - warmup_steps - decay_steps

    def schedule(step: int) -> float:
        step = float(step)
        if step < warmup_steps:
            s = (0.5 - 0.5 * math.cos(math.pi * step / max(warmup_steps, 1))
                 if warmup_steps > 0 else 1.0)
        elif step < warmup_steps + stable_steps:
            s = 1.0
        else:
            s = (0.5 + 0.5 * math.cos(
                math.pi * (step - warmup_steps - stable_steps)
                / max(decay_steps, 1)) if decay_steps > 0 else 1.0)
        return base_lr * s

    return schedule


def set_lr(optimizer, lr: float) -> None:
    """Sets every param group's lr to ``lr``: in place where the lr is a
    tensor (a capturable optimizer's, which a CUDA graph of the step
    reads), else by assignment."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(float(lr))
        else:
            group["lr"] = float(lr)
