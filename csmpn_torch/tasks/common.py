"""Shared task-entry composition: dataset, model, optimizer and schedule
from the config, then ``Trainer.fit``.

Port of ``csmpn_tpu/tasks/common.py``.  Two top-level config keys:

  * ``--device`` (default ``cuda``): where the model and its batches live.
    With ``cuda`` and no card present it raises; it never carries on on
    the CPU.  ``--device=cpu`` runs on the CPU (the tests ask for it).
  * ``--precision`` (default ``fast``): ``fast`` feeds the kernels bf16
    operands with fp32 accumulation and stores activations in bf16 on the
    card; ``exact`` is fp32 throughout.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..engineer.config import load_module
from ..engineer.loggers import ConsoleLogger
from ..engineer.schedulers import cosine_annealing_schedule, lambda_lr
from ..engineer.trainer import Trainer
from ..nn.modules import init_parameters
from ..ops.segment import set_aggregation_mode


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass --device=cpu to run on the CPU")
    return device


def run_task(config: Dict) -> Trainer:
    device = resolve_device(config.get("device", "cuda"))
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

    train_loader = dataset.train_loader()
    val_loader = dataset.val_loader()
    test_loader = dataset.test_loader()

    steps = config["trainer"]["max_steps"]
    opt_cfg = dict(config["optimizer"])
    base_lr = opt_cfg.get("lr", 1e-3)
    # cosine warmup (steps/64) -> plateau -> decay (last steps/4)
    schedule = cosine_annealing_schedule(
        base_lr, steps, warmup_steps=int(steps / 64),
        decay_steps=int(steps / 4))
    optimizer = load_module(opt_cfg.pop("module"))(model.parameters(),
                                                   **opt_cfg)
    lr_scheduler = lambda_lr(optimizer, schedule, base_lr)

    trainer_cfg = dict(config["trainer"])
    for k in ("module", "scheduler", "logger"):
        trainer_cfg.pop(k, None)
    trainer = Trainer(
        scheduler=schedule,
        logger=ConsoleLogger(run_name=config.get("run_name", "run")),
        **trainer_cfg,
    )
    trainer.fit(model, optimizer, train_loader, val_loader=val_loader,
                test_loader=test_loader, lr_scheduler=lr_scheduler)
    return trainer
