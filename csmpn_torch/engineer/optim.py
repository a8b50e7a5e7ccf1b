"""Optimizer factories.

``adam`` is ``torch.optim.Adam``: L2 weight decay is added to the gradient
before the moment updates (coupled), as the reference's optax chain
``add_decayed_weights -> adam`` does.  ``adamw`` decays the weights
directly.  Each factory takes the model's parameters and returns the
optimizer; the learning-rate schedule is applied per step by a
``LambdaLR`` built in ``tasks/common.py``.
"""
from __future__ import annotations

import torch


def adam(params, lr: float = 1e-3, weight_decay: float = 0.0,
         betas=(0.9, 0.999), eps: float = 1e-8) -> torch.optim.Optimizer:
    return torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=eps,
                            weight_decay=weight_decay)


def adamw(params, lr: float = 1e-3, weight_decay: float = 0.01,
          betas=(0.9, 0.999), eps: float = 1e-8) -> torch.optim.Optimizer:
    return torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=eps,
                             weight_decay=weight_decay)
