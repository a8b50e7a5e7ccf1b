"""Optimizer factories.

``adam`` is ``torch.optim.Adam``: L2 weight decay is added to the gradient
before the moment updates (coupled), as the reference's optax chain
``add_decayed_weights -> adam`` does.  ``adamw`` decays the weights
directly.  Each factory takes the model's parameters and returns the
optimizer; the trainer writes the learning-rate schedule's value into
it before every step (``schedulers.set_lr``).

``capturable=True`` builds the optimizer for a CUDA graph of the training
step: its step count and bias corrections stay on the card, and the lr
is a 0-d float32 tensor on the parameters' device, which the graph reads
and ``set_lr`` writes in place (``fill_``) before every replay.  A
Python-float lr would be baked into the graph and freeze the schedule.
"""
from __future__ import annotations

import torch


def _lr(lr: float, params, capturable: bool):
    if not capturable:
        return lr
    return torch.tensor(float(lr), dtype=torch.float32,
                        device=params[0].device)


def adam(params, lr: float = 1e-3, weight_decay: float = 0.0,
         betas=(0.9, 0.999), eps: float = 1e-8,
         capturable: bool = False) -> torch.optim.Optimizer:
    params = list(params)
    return torch.optim.Adam(params, lr=_lr(lr, params, capturable),
                            betas=tuple(betas), eps=eps,
                            weight_decay=weight_decay, capturable=capturable)


def adamw(params, lr: float = 1e-3, weight_decay: float = 0.01,
          betas=(0.9, 0.999), eps: float = 1e-8,
          capturable: bool = False) -> torch.optim.Optimizer:
    params = list(params)
    return torch.optim.AdamW(params, lr=_lr(lr, params, capturable),
                             betas=tuple(betas), eps=eps,
                             weight_decay=weight_decay, capturable=capturable)
