"""Experiment bootstrap: parse the config, print it, seed, and call the task.

Port of the single-process path of ``csmpn_tpu/engineer/fire.py``.  The
distributed bootstrap comes with the scale-out slice.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from .config import parse_args, pretty
from .seed import set_seed


def fire(function: Callable[[Dict], object],
         argv: Optional[List[str]] = None):
    """Parse ``argv`` (default ``sys.argv``), seed, and run ``function``
    on the config; returns what it returns."""
    config, name, experiment = parse_args(argv)
    print("\nConfiguration\n---")
    pretty(config)
    seed = config["seed"]
    if not isinstance(seed, int):
        raise TypeError(f"seed must be an int, got {seed!r}")
    config["generator"] = set_seed(seed)
    config["run_name"] = name
    config["experiment"] = experiment
    config["dist"] = None
    return function(config)
