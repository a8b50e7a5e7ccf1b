"""The port's motion slice against the reference package: the dataset
arrays, the model loss on the same weights and batch, and the task entry
point on the CPU; plus the import isolation of csmpn_torch.

Tolerances: rtol 2e-4 / atol 1e-5 in exact fp32 (the reference's parity
tolerance); dataset arrays are compared byte for byte."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-4, 1e-5
SPLITS = ("train_dataset", "val_dataset", "test_dataset")
DS_KW = dict(batch_size=4, num_training_samples=11, num_eval_samples=6)


def _arrays(ds):
    out = {}
    for s in SPLITS:
        a = getattr(ds, s).arrays
        for k in ("edge_index", "edge_mask", "edge_src_order", "node_mask",
                  "node_types", "x_ind"):
            out[f"{s}.{k}"] = getattr(a, k)
        out.update({f"{s}.feat_{k}": v for k, v in a.features.items()})
        out.update({f"{s}.tgt_{k}": v for k, v in a.targets.items()})
    return out


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Each package builds the motion data in its own DATAROOT."""
    from csmpn_tpu.data.motion import MotionDataset as JDataset
    from csmpn_torch.data.motion import MotionDataset as TDataset

    old = os.environ.get("DATAROOT")
    roots = {}
    try:
        for name, cls in (("jax", JDataset), ("torch", TDataset)):
            roots[name] = str(tmp_path_factory.mktemp(f"dataroot_{name}"))
            os.environ["DATAROOT"] = roots[name]
            roots[name + "_ds"] = cls(**DS_KW)
    finally:
        if old is None:
            os.environ.pop("DATAROOT", None)
        else:
            os.environ["DATAROOT"] = old
    return roots


def test_motion_dataset_byte_identical(datasets):
    ja, ta = _arrays(datasets["jax_ds"]), _arrays(datasets["torch_ds"])
    assert ja.keys() == ta.keys()
    for k in ja:
        assert ja[k].dtype == ta[k].dtype, k
        assert ja[k].tobytes() == ta[k].tobytes(), k
    js, ts = datasets["jax_ds"].spec, datasets["torch_ds"].spec
    assert (js.counts_max, js.e_max) == (ts.counts_max, ts.e_max)
    for f in ("motion.pkl", "split.pkl"):
        with open(os.path.join(datasets["jax"], "motion", f), "rb") as a, \
                open(os.path.join(datasets["torch"], "motion", f), "rb") as b:
            assert a.read() == b.read(), f


def test_motion_cache_written_by_reference_reads_back(datasets):
    """The port loads the reference package's npz cache identically."""
    from csmpn_torch.data.motion import MotionDataset

    old = os.environ.get("DATAROOT")
    os.environ["DATAROOT"] = datasets["jax"]
    try:
        ds = MotionDataset(**DS_KW)
    finally:
        if old is None:
            os.environ.pop("DATAROOT", None)
        else:
            os.environ["DATAROOT"] = old
    ja, ta = _arrays(datasets["jax_ds"]), _arrays(ds)
    for k in ja:
        assert ja[k].tobytes() == ta[k].tobytes(), k


def _models(datasets):
    from csmpn_tpu.models.motion import MotionModel as JModel
    from csmpn_torch.convert import params_to_jax
    from csmpn_torch.models.motion import MotionModel as TModel
    from csmpn_torch.nn.modules import init_parameters

    jds, tds = datasets["jax_ds"], datasets["torch_ds"]
    jb = jds.train_dataset.select(np.arange(4))
    tb = tds.train_dataset.select(np.arange(4)).to("cpu")
    # weights made by the port from a seed, moved off their constant
    # init, and handed to the flax model under the same names
    tm = TModel(spec=tds.spec, num_hidden=4, num_layers=1)
    gen = torch.Generator().manual_seed(0)
    init_parameters(tm, gen)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    params = jax.tree.map(jnp.asarray, params_to_jax(tm.state_dict()))
    jm = JModel(spec=jds.spec, num_hidden=4, num_layers=1)
    return jm, params, jb, tm, tb


def test_motion_model_loss_matches_jax(datasets):
    """Per-sample and backprop loss, num_hidden=4, num_layers=1, batch 4."""
    jm, params, jb, tm, tb = _models(datasets)
    j_loss, j_out = jax.jit(jm.apply)(params, jb)
    with torch.no_grad():
        t_loss, t_out = tm(tb)
    np.testing.assert_allclose(t_out["loss"].numpy(),
                               np.asarray(j_out["loss"]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=RTOL)


def test_motion_model_grads_match_jax(datasets):
    from csmpn_torch.convert import params_from_jax

    jm, params, jb, tm, tb = _models(datasets)
    g = jax.jit(jax.grad(lambda p: jm.apply(p, jb)[0]))(params)
    tm(tb)[0].backward()
    jg = params_from_jax(jax.tree.map(np.asarray, g))
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[k].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)


def test_motion_task_cli_on_cpu(tmp_path):
    """Six steps of the port's motion task through its entry point."""
    env = dict(os.environ, DATAROOT=str(tmp_path),
               RUNDIR=str(tmp_path / "runs"))
    cmd = [sys.executable, "-m", "csmpn_torch.tasks.motion",
           "--trainer.module=csmpn_torch.engineer.Trainer",
           "--trainer.max_steps=6", "--trainer.val_check_interval=3",
           "--trainer.print_interval=2", "--trainer.log_interval=3",
           "--trainer.limit_val_batches=1",
           "--optimizer.module=csmpn_torch.engineer.optim.adam",
           "--dataset.module=csmpn_torch.data.motion.MotionDataset",
           "--dataset.num_training_samples=11", "--dataset.batch_size=4",
           "--dataset.num_eval_samples=6",
           "--model.module=csmpn_torch.models.motion.MotionModel",
           "--model.num_hidden=4", "--model.num_layers=1", "--device=cpu"]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = proc.stdout
    for step in (0, 2, 4):
        assert f"Step: {step} (Training) Loss:" in out
    assert "Step: 1 (Training)" not in out
    assert "(Validation)" in out and "val/loss" in out
    assert "(Testing)" in out and "test/loss" in out
    assert "Stopping due to max_steps." in out
    assert os.path.exists(tmp_path / "runs")


def test_device_cuda_without_a_card_raises(monkeypatch):
    from csmpn_torch.tasks.common import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("knob,value", [
    ("steps_per_dispatch", 2), ("device_data", True), ("mesh", object()),
    ("max_rss_gb", 1.0), ("donate", False)])
def test_trainer_relay_knobs_raise(knob, value):
    from csmpn_torch.engineer.trainer import Trainer

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(**{knob: value})


def test_import_loads_no_jax_and_needs_no_nvcc(tmp_path):
    """Every csmpn_torch module imports with no jax, no csmpn_tpu and no
    nvcc (PATH and CUDA_HOME point nowhere)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import csmpn_torch\n"
        "for m in pkgutil.walk_packages(csmpn_torch.__path__, 'csmpn_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'csmpn_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('csmpn_torch')]))\n")
    env = {"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path),
           "HOME": str(tmp_path), "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")
