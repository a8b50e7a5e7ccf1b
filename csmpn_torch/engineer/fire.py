"""Experiment bootstrap: parse the config, print it, seed, join the process
group of a distributed launch, and call the task.

Port of ``csmpn_tpu/engineer/fire.py``.  Where the JAX package calls
``jax.distributed.initialize``, the port joins a ``torch.distributed``
process group, one process per card: ``nccl`` when the run's ``--device``
is ``cuda`` (after ``torch.cuda.set_device(local_rank)``), ``gloo`` when it
is ``cpu``.  A launch is distributed under ``torchrun`` /
``python -m torch.distributed.run`` (``WORLD_SIZE``, ``RANK``,
``MASTER_ADDR``, ``MASTER_PORT``, or ``TORCHELASTIC_RUN_ID``) or in a SLURM
step of more than one task.  A failed rendezvous raises; the run never
carries on as one process.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Mapping, Optional

import torch

from .config import parse_args, pretty
from .seed import set_seed

_TORCHRUN_VARS = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")


def use_distributed(env: Optional[Mapping[str, str]] = None) -> bool:
    """Whether this process is one of a distributed launch: torchrun's
    variables, a torchelastic run id, or a SLURM step of several tasks."""
    env = os.environ if env is None else env
    if all(k in env for k in _TORCHRUN_VARS) or "TORCHELASTIC_RUN_ID" in env:
        return True
    try:
        return int(env.get("SLURM_NTASKS", "1")) > 1
    except ValueError:
        return False


def _first_int(env: Mapping[str, str], keys, default=None) -> int:
    for k in keys:
        if k in env:
            return int(env[k])
    if default is None:
        raise RuntimeError(f"distributed launch: none of {keys} is set")
    return default


def resolve_ranks(env: Optional[Mapping[str, str]] = None) -> Dict[str, int]:
    """{rank, world_size, local_rank} of this process: the explicit
    variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) first, then the
    SLURM step's (``SLURM_PROCID``, ``SLURM_NTASKS``, ``SLURM_LOCALID``)."""
    env = os.environ if env is None else env
    return {
        "rank": _first_int(env, ("RANK", "SLURM_PROCID")),
        "world_size": _first_int(env, ("WORLD_SIZE", "SLURM_NTASKS")),
        "local_rank": _first_int(env, ("LOCAL_RANK", "SLURM_LOCALID"), 0),
    }


def _dist_setup(device: str) -> Dict:
    """Joins the default process group (``MASTER_ADDR:MASTER_PORT``) as
    this process's rank, or checks that the group already joined in this
    process is that one.  Returns {rank, world_size, local_devices}."""
    import torch.distributed as dist

    ranks = resolve_ranks()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(ranks["local_rank"])
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (
                ranks["rank"], ranks["world_size"]):
            raise RuntimeError(
                f"a process group is already up as rank {dist.get_rank()} "
                f"of {dist.get_world_size()}, not {ranks}")
    else:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(f"distributed launch without {missing}: set "
                               f"the rendezvous address of rank 0")
        dist.init_process_group(
            backend="nccl" if cuda else "gloo",
            init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                         f"{os.environ['MASTER_PORT']}"),
            rank=ranks["rank"], world_size=ranks["world_size"])
    return {"rank": dist.get_rank(), "world_size": dist.get_world_size(),
            "local_devices": torch.cuda.device_count() if cuda else 1}


def fire(function: Callable[[Dict], object],
         argv: Optional[List[str]] = None):
    """Parse ``argv`` (default ``sys.argv``), seed, join the process group
    of a distributed launch, and run ``function`` on the config; returns
    what it returns."""
    config, name, experiment = parse_args(argv)
    print("\nConfiguration\n---")
    pretty(config)
    seed = config["seed"]
    if not isinstance(seed, int):
        raise TypeError(f"seed must be an int, got {seed!r}")
    config["generator"] = set_seed(seed)
    config["run_name"] = name
    config["experiment"] = experiment

    dist_cfg = None
    if use_distributed():
        dist_cfg = _dist_setup(config.get("device", "cuda"))
        print(f"Distributed: {dist_cfg}")
    config["dist"] = dist_cfg
    return function(config)
