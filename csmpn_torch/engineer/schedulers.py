"""Learning-rate schedules as plain ``step -> lr`` functions, applied per
optimizer step through ``torch.optim.lr_scheduler.LambdaLR``."""
from __future__ import annotations

import math


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


def lambda_lr(optimizer, schedule, base_lr: float):
    """A ``LambdaLR`` that sets the optimizer's lr to ``schedule(step)``."""
    import torch

    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: schedule(step) / base_lr)
