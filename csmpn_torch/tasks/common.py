"""Shared task-entry composition: dataset, model, optimizer and schedule
from the config, then ``Trainer.fit``.

Port of ``csmpn_tpu/tasks/common.py``.  Two top-level config keys:

  * ``--device`` (default ``cuda``): where the model and its batches live.
    With ``cuda`` and no card present it raises; it never carries on on
    the CPU.  ``--device=cpu`` runs on the CPU (the tests ask for it).
  * ``--precision`` (default ``fast``): ``fast`` feeds the kernels bf16
    operands with fp32 accumulation and stores activations in bf16 on the
    card; ``exact`` is fp32 throughout.

Data parallel (``--data_parallel=true``, or any launch of more than one
process): one process per card under ``python -m torch.distributed.run
--nproc_per_node N`` (``engineer/fire.py`` joins the group), each rank on
``cuda:<local rank>`` with its own shard of every split and a
``parallel.mesh.Mesh`` for the trainer.  The global batch is N batches of
``--dataset.batch_size``, rank 0's first.  ``--data_parallel=true`` in a
process that is not part of a group runs unmeshed on its one card, as the
JAX package does on one device; if such a process sees several cards it
raises, since one torch process drives one card.  In a group of one it
all-reduces over that group (the JAX package would run unmeshed; the
result is the same).

The training shuffle is seeded from ``--seed``.  Where the trainer
replays a CUDA graph of the step (``Trainer.uses_graphs``:
``--trainer.steps_per_dispatch`` above 1 on the card) the optimizer is
built ``capturable`` (see ``engineer/optim.py``); the trainer applies the
schedule either way.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..engineer.config import load_module
from ..engineer.loggers import ConsoleLogger
from ..engineer.schedulers import cosine_annealing_schedule
from ..engineer.trainer import Trainer
from ..nn.modules import init_parameters
from ..ops.segment import set_aggregation_mode
from ..parallel.mesh import make_mesh


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass --device=cpu to run on the CPU")
    return device


def run_task(config: Dict) -> Trainer:
    dist_cfg = config.get("dist")
    world = dist_cfg["world_size"] if dist_cfg else 1
    # the config parser's rule for a boolean (engineer/config.py _coerce)
    data_parallel = str(config.get("data_parallel", False)).lower() == "true"
    device = resolve_device(config.get("device", "cuda"))
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if data_parallel and dist_cfg is None and cards > 1:
        raise ValueError(
            f"--data_parallel=true in one process that sees {cards} cards: "
            f"a process trains on one card, so launch one process per "
            f"card, python -m torch.distributed.run --nproc_per_node "
            f"{cards} -m <task> ..., or make one card visible "
            f"(CUDA_VISIBLE_DEVICES)")
    if dist_cfg and device.type == "cuda":
        # fire set the card of this rank (LOCAL_RANK)
        device = torch.device("cuda", torch.cuda.current_device())
    set_aggregation_mode(config.get("precision", "fast"))

    dataset_cfg = dict(config["dataset"])
    dataset = load_module(dataset_cfg.pop("module"))(**dataset_cfg)

    model_cfg = dict(config["model"])
    model_cls = load_module(model_cfg.pop("module"))
    model_kwargs = dict(getattr(dataset, "model_kwargs", {}))
    model_kwargs.update(model_cfg)
    model = model_cls(spec=dataset.spec, **model_kwargs)
    generator = config.get("generator")
    if generator is not None:
        init_parameters(model, generator)
    model = model.to(device)

    # the training shuffle follows --seed, so two runs of one config see
    # the same batches
    shard = (dist_cfg["rank"], world) if world > 1 else None
    train_loader = dataset.train_loader(seed=config.get("seed"), shard=shard)
    val_loader = dataset.val_loader(shard=shard)
    test_loader = dataset.test_loader(shard=shard)

    steps = config["trainer"]["max_steps"]
    opt_cfg = dict(config["optimizer"])
    base_lr = opt_cfg.get("lr", 1e-3)
    # cosine warmup (steps/64) -> plateau -> decay (last steps/4)
    schedule = cosine_annealing_schedule(
        base_lr, steps, warmup_steps=int(steps / 64),
        decay_steps=int(steps / 4))
    trainer_cfg = dict(config["trainer"])
    for k in ("module", "scheduler", "logger", "mesh"):
        trainer_cfg.pop(k, None)
    # data parallel when asked for or whenever the launch has several
    # processes (the reference wraps DDP under any distributed launch)
    mesh = (make_mesh(device) if (data_parallel or world > 1)
            and dist_cfg is not None else None)
    trainer = Trainer(
        scheduler=schedule,
        logger=ConsoleLogger(run_name=config.get("run_name", "run")),
        mesh=mesh,
        **trainer_cfg,
    )
    if trainer.uses_graphs(device):
        opt_cfg["capturable"] = True
    optimizer = load_module(opt_cfg.pop("module"))(model.parameters(),
                                                   **opt_cfg)
    trainer.fit(model, optimizer, train_loader, val_loader=val_loader,
                test_loader=test_loader)
    return trainer
