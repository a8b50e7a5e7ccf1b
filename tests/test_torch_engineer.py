"""csmpn_torch.engineer against csmpn_tpu.engineer: the learning-rate
schedule, the Adam (coupled L2) and AdamW updates against optax, config
reflection of the port's modules, and a checkpoint round trip.

Tolerances: schedule values rtol 1e-5 / atol 1e-10 = 2e-7 of the base
lr (the reference evaluates it in fp32, the port in fp64, and the decay
tail cancels); optimizer trajectories rtol 1e-5 /
atol 1e-7 after 5 fp32 steps."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from csmpn_tpu.engineer import optim as joptim
from csmpn_tpu.engineer.schedulers import cosine_annealing_schedule as jsched
from csmpn_torch.engineer import optim as toptim
from csmpn_torch.engineer.config import parse_args
from csmpn_torch.engineer.schedulers import (cosine_annealing_schedule,
                                             lambda_lr)


@pytest.mark.parametrize("steps", [8, 640])
def test_schedule_matches_reference(steps):
    kw = dict(warmup_steps=int(steps / 64), decay_steps=int(steps / 4))
    t, j = cosine_annealing_schedule(5e-4, steps, **kw), jsched(5e-4, steps,
                                                                **kw)
    for s in range(steps + 1):
        np.testing.assert_allclose(t(s), float(j(s)), rtol=1e-5, atol=1e-10)


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_optimizer_steps_match_optax(name):
    """Five steps of a quadratic loss, with the per-step schedule."""
    rng = np.random.RandomState(0)
    w0 = rng.randn(6).astype(np.float32)
    target = rng.randn(6).astype(np.float32)
    lr, wd, steps = 1e-2, 1e-1, 5
    schedule = cosine_annealing_schedule(lr, steps, 1, 2)

    w = torch.tensor(w0, requires_grad=True)
    opt = getattr(toptim, name)([w], lr=lr, weight_decay=wd)
    sched = lambda_lr(opt, schedule, lr)
    for _ in range(steps):
        opt.zero_grad()
        ((w - torch.from_numpy(target)) ** 2).sum().backward()
        opt.step()
        sched.step()

    tx = getattr(joptim, name)(lr=lr, weight_decay=wd,
                               schedule=jsched(lr, steps, 1, 2))
    jw = jnp.asarray(w0)
    state = tx.init(jw)
    for _ in range(steps):
        g = 2.0 * (jw - jnp.asarray(target))
        upd, state = tx.update(g, state, jw)
        jw = optax.apply_updates(jw, upd)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw),
                               rtol=1e-5, atol=1e-7)


def test_config_reflects_port_modules():
    cfg, _, _ = parse_args([
        "csmpn_torch/tasks/motion.py",
        "--trainer.module=csmpn_torch.engineer.Trainer",
        "--optimizer.module=csmpn_torch.engineer.optim.adam",
        "--model.module=csmpn_torch.models.motion.MotionModel",
        "--trainer.max_steps=8", "--optimizer.lr=5e-4",
        "--optimizer.weight_decay=1e-4", "--model.num_hidden=28",
        "--device=cpu", "--precision=exact"])
    assert cfg["trainer"]["max_steps"] == 8
    assert cfg["trainer"]["steps_per_dispatch"] == 1
    assert cfg["optimizer"]["lr"] == 5e-4
    assert isinstance(cfg["optimizer"]["weight_decay"], float)
    assert cfg["model"]["num_hidden"] == 28 and cfg["model"]["num_layers"] == 4
    assert cfg["device"] == "cpu" and cfg["precision"] == "exact"


def test_checkpoint_roundtrip(tmp_path):
    from csmpn_torch.engineer.loggers import ConsoleLogger
    from csmpn_torch.engineer.trainer import Trainer

    model = torch.nn.Linear(3, 2)
    opt = toptim.adam(model.parameters(), lr=1e-3)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    tr = Trainer(logger=ConsoleLogger(dir=str(tmp_path)))
    tr.global_step, tr.current_epoch = 7, 2
    tr.checkpoint.on_test_end(tr, model, opt, {"val/loss": 0.5})
    assert tr.should_test
    path = tmp_path / "best_val_loss"
    assert (path / "state.pt").exists()

    model2 = torch.nn.Linear(3, 2)
    opt2 = toptim.adam(model2.parameters(), lr=1e-3)
    tr2 = Trainer(checkpoint=str(path), logger=ConsoleLogger(dir=str(tmp_path)))
    assert tr2.checkpoint.best_metrics == {"val/loss": 0.5}
    tr2.checkpoint.restore(tr2, model2, opt2)
    assert (tr2.global_step, tr2.current_epoch) == (7, 2)
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)
    assert opt2.state_dict()["state"][0]["step"] == 1
