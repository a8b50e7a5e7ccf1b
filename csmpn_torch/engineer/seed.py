"""Deterministic seeding.

Seeds the host-side RNGs (python, numpy: data shuffling and generation)
and torch's global generator, and returns a seeded ``torch.Generator`` for
parameter initialisation.
"""
from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
