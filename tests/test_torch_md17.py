"""The port's MD17 slice against the reference package: the dataset
arrays and files byte for byte (each package in its own DATAROOT, and the
reference's cache read back by the port), the model's loss and every
gradient on the same weights and batch, and the task entry point on the
CPU.

Tolerances: rtol 2e-4 / atol 1e-5 in exact fp32 (the reference's parity
tolerance; gradients rtol 1e-3 as in tests/test_torch_hulls.py)."""
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
DS_KW = dict(batch_size=4, molecule_type="aspirin", dis=3,
             num_train_samples=6, num_eval_samples=4)
MODEL_KW = dict(num_hidden=8, num_layers=1)
RAW_FILES = ("md17_aspirin.npz", "aspirin_charges.npy",
             "aspirin_structure.npy", "aspirin_train.npy", "aspirin_val.npy",
             "aspirin_test.npy")


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


def _with_dataroot(root, fn):
    old = os.environ.get("DATAROOT")
    os.environ["DATAROOT"] = root
    try:
        return fn()
    finally:
        if old is None:
            os.environ.pop("DATAROOT", None)
        else:
            os.environ["DATAROOT"] = old


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Each package builds the MD17 data in its own DATAROOT."""
    from csmpn_tpu.data.md17 import MD17Dataset as JDataset
    from csmpn_torch.data.md17 import MD17Dataset as TDataset

    out = {}
    for name, cls in (("jax", JDataset), ("torch", TDataset)):
        root = str(tmp_path_factory.mktemp(f"dataroot_{name}"))
        out[name] = root
        out[name + "_ds"] = _with_dataroot(root, lambda: cls(**DS_KW))
    return out


def test_md17_dataset_byte_identical(datasets):
    ja, ta = _arrays(datasets["jax_ds"]), _arrays(datasets["torch_ds"])
    assert ja.keys() == ta.keys()
    for k in ja:
        assert ja[k].dtype == ta[k].dtype, k
        assert ja[k].tobytes() == ta[k].tobytes(), k
    js, ts = datasets["jax_ds"].spec, datasets["torch_ds"].spec
    assert (js.counts_max, js.e_max) == (ts.counts_max, ts.e_max)
    assert getattr(datasets["jax_ds"], "model_kwargs", None) == getattr(
        datasets["torch_ds"], "model_kwargs", None)
    for f in RAW_FILES:
        with open(os.path.join(datasets["jax"], "md17", f), "rb") as a, \
                open(os.path.join(datasets["torch"], "md17", f), "rb") as b:
            assert a.read() == b.read(), f


def test_md17_cache_written_by_reference_reads_back(datasets):
    from csmpn_torch.data.md17 import MD17Dataset

    ds = _with_dataroot(datasets["jax"], lambda: MD17Dataset(**DS_KW))
    ja, ta = _arrays(datasets["jax_ds"]), _arrays(ds)
    for k in ja:
        assert ja[k].tobytes() == ta[k].tobytes(), k


@pytest.fixture(scope="module")
def models(datasets):
    """The port's model on weights made from a seed and moved off their
    constant init, the flax model on the same weights under the same
    names, a batch of 4, and the reference's loss, outputs and gradients
    from one compiled value-and-grad (exact mode)."""
    from csmpn_tpu.models.md17 import MD17Model as JModel
    from csmpn_tpu.ops import segment as jseg
    from csmpn_torch.convert import params_to_jax
    from csmpn_torch.models.md17 import MD17Model as TModel
    from csmpn_torch.nn.modules import init_parameters
    from csmpn_torch.ops import segment as seg

    jseg.set_aggregation_mode("exact")
    seg.set_aggregation_mode("exact")
    jds, tds = datasets["jax_ds"], datasets["torch_ds"]
    kw = dict(getattr(tds, "model_kwargs", {}), **MODEL_KW)
    jb = jds.train_dataset.select(np.arange(4))
    tb = tds.train_dataset.select(np.arange(4)).to("cpu")
    tm = TModel(spec=tds.spec, **kw)
    gen = torch.Generator().manual_seed(0)
    init_parameters(tm, gen)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    params = jax.tree.map(jnp.asarray, params_to_jax(tm.state_dict()))
    jm = JModel(spec=jds.spec, **kw)
    (j_loss, j_out), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, jb), has_aux=True))(params)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jb)
    return dict(tm=tm, tb=tb, shapes=shapes, loss=j_loss, out=j_out,
                grads=j_grads)


def test_md17_model_loss_matches_jax(models):
    """Per-sample metrics and the backprop loss; the flax tree maps onto
    the port's state_dict with no key left over, the
    projection CEMLP included."""
    from csmpn_torch.convert import params_from_jax

    tm = models["tm"]
    flax_keys = params_from_jax(jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), models["shapes"]))
    assert set(flax_keys) == set(tm.state_dict())
    assert "projection_mlp.gp_0.weight" in flax_keys
    assert "sim_type_embedding.embedding" in flax_keys
    with torch.no_grad():
        t_loss, t_out = tm(models["tb"])
    assert set(t_out) == set(models["out"]) == set(tm.metric_names)
    for k in t_out:
        np.testing.assert_allclose(t_out[k].numpy(),
                                   np.asarray(models["out"][k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(float(t_loss), float(models["loss"]),
                               rtol=RTOL)


def test_md17_model_grads_match_jax(models):
    from csmpn_torch.convert import params_from_jax

    tm = models["tm"]
    tm.zero_grad()
    tm(models["tb"])[0].backward()
    jg = params_from_jax(jax.tree.map(np.asarray, models["grads"]))
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[k].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)


def test_md17_task_cli_on_cpu(tmp_path):
    """Three steps of the port's MD17 task through its entry point."""
    env = dict(os.environ, DATAROOT=str(tmp_path),
               RUNDIR=str(tmp_path / "runs"))
    cmd = [sys.executable, "-m", "csmpn_torch.tasks.md17",
           "--trainer.module=csmpn_torch.engineer.Trainer",
           "--trainer.max_steps=3", "--trainer.val_check_interval=2",
           "--trainer.print_interval=1", "--trainer.log_interval=2",
           "--trainer.limit_val_batches=1",
           "--optimizer.module=csmpn_torch.engineer.optim.adam",
           "--dataset.module=csmpn_torch.data.md17.MD17Dataset",
           "--dataset.batch_size=2", "--dataset.molecule_type=ethanol",
           "--dataset.num_train_samples=4", "--dataset.num_eval_samples=2",
           "--model.module=csmpn_torch.models.md17.MD17Model",
           "--model.num_hidden=4", "--model.num_layers=1",
           "--device=cpu"]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = proc.stdout
    for step in range(3):
        assert f"Step: {step} (Training) Loss:" in out
    assert "(Validation)" in out and "val/ade_loss" in out
    assert "(Testing)" in out and "test/fde_loss" in out
    assert "Stopping due to max_steps." in out
    assert os.path.exists(tmp_path / "md17" / "SYNTHETIC")
