"""The port's hulls slice against the reference package: the hull lift,
the dataset arrays, the one-hot conditioning and pooling, the model loss
and every gradient on the same weights and batch, the torch-reference
fixture, and the task entry point on the CPU.

Tolerances: rtol 2e-4 / atol 1e-5 in exact fp32 (the reference's parity
tolerance; gradients rtol 1e-3 as in tests/test_torch_motion.py); lifts
and dataset arrays are compared byte for byte."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
RTOL, ATOL = 2e-4, 1e-5
SPLITS = ("train_dataset", "val_dataset", "test_dataset")
DS_KW = dict(num_samples=12, batch_size=4, num_val_samples=8)


@pytest.mark.parametrize("seed,n_points,dim", [(0, 8, 2), (1, 8, 2),
                                                (2, 10, 1), (3, 6, 2)])
def test_hull_lift_matches_reference(seed, n_points, dim):
    """Simplices and every adjacency block, including the (0, 0) block's
    duplicated (hi, lo) pairs, array for array."""
    from csmpn_tpu.data.lifting import hull_lift as jlift
    from csmpn_torch.data.lifting import flatten_complex, hull_lift

    pts = np.random.RandomState(seed).randn(n_points, 5).astype(np.float32)
    want, got = jlift(pts, dim), hull_lift(pts, dim)
    assert got.max_dim == want.max_dim and got.counts == want.counts
    for d in want.x:
        assert got.x[d].dtype == want.x[d].dtype
        assert got.x[d].tobytes() == want.x[d].tobytes(), d
    assert list(got.adj) == list(want.adj)
    for k in want.adj:
        assert got.adj[k].tobytes() == want.adj[k].tobytes(), k
    # the augmentation: every ordered vertex pair once, plus the (hi, lo)
    # direction of each hull edge a second time
    n0, n1 = want.counts[0], want.counts[1]
    assert got.adj[(0, 0)].shape[1] == n0 * (n0 - 1) + 2 * n1 - n1
    big = flatten_complex(got)
    assert big.edge_index.shape[1] == sum(a.shape[1] for a in got.adj.values()
                                          ) + sum(got.adj[(d, d + 1)].shape[1]
                                                  for d in range(dim))


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
    """Each package builds the hulls data in its own DATAROOT."""
    from csmpn_tpu.data.hulls import ConvexHullDataset as JDataset
    from csmpn_torch.data.hulls import ConvexHullDataset as TDataset

    out = {}
    for name, cls in (("jax", JDataset), ("torch", TDataset)):
        root = str(tmp_path_factory.mktemp(f"dataroot_{name}"))
        out[name] = root
        out[name + "_ds"] = _with_dataroot(root, lambda: cls(**DS_KW))
    return out


def test_hulls_dataset_byte_identical(datasets):
    ja, ta = _arrays(datasets["jax_ds"]), _arrays(datasets["torch_ds"])
    assert ja.keys() == ta.keys()
    for k in ja:
        assert ja[k].dtype == ta[k].dtype, k
        assert ja[k].tobytes() == ta[k].tobytes(), k
    js, ts = datasets["jax_ds"].spec, datasets["torch_ds"].spec
    assert (js.counts_max, js.e_max) == (ts.counts_max, ts.e_max)
    for s in ("train", "val", "test"):
        for part in ("input", "target"):
            f = os.path.join("hulls", f"hulls_{s}_{part}.npy")
            with open(os.path.join(datasets["jax"], f), "rb") as a, \
                    open(os.path.join(datasets["torch"], f), "rb") as b:
                assert a.read() == b.read(), f


def test_hulls_cache_written_by_reference_reads_back(datasets):
    from csmpn_torch.data.hulls import ConvexHullDataset

    ds = _with_dataroot(datasets["jax"], lambda: ConvexHullDataset(**DS_KW))
    ja, ta = _arrays(datasets["jax_ds"]), _arrays(ds)
    for k in ja:
        assert ja[k].tobytes() == ta[k].tobytes(), k


def test_onehot_conditioning_and_pooling_match_reference():
    """mode="onehot" has no parameter (the flax tree has no sim_type
    entry) and gives the reference's attributes; the masked global pool
    matches."""
    from csmpn_tpu.algebra import get_algebra as jalg
    from csmpn_tpu.models.common import SimplexTypeConditioning as JCond
    from csmpn_tpu.models.common import global_mean_pool_masked as jpool
    from csmpn_torch.algebra import get_algebra
    from csmpn_torch.models.common import (SimplexTypeConditioning,
                                           global_mean_pool_masked)

    rng = np.random.RandomState(0)
    types = rng.randint(0, 3, size=12)
    ei = np.stack([rng.randint(0, 12, size=20), np.sort(rng.randint(0, 12,
                                                                    size=20))])
    cond = SimplexTypeConditioning(get_algebra((1.0,) * 5), 3, mode="onehot")
    assert list(cond.state_dict()) == []
    node, edge = cond(torch.from_numpy(types), torch.from_numpy(ei))
    jc = JCond(jalg((1.0,) * 5), 3, mode="onehot")
    variables = jc.init(jax.random.PRNGKey(0), jnp.asarray(types),
                        jnp.asarray(ei))
    assert not variables
    jn, je = jc.apply(variables, jnp.asarray(types), jnp.asarray(ei))
    np.testing.assert_array_equal(node.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(edge.numpy(), np.asarray(je))
    x = rng.randn(3, 7, 2).astype(np.float32)
    mask = rng.rand(3, 7) > 0.4
    np.testing.assert_allclose(
        global_mean_pool_masked(torch.from_numpy(x),
                                torch.from_numpy(mask)).numpy(),
        np.asarray(jpool(jnp.asarray(x), jnp.asarray(mask))), rtol=RTOL,
        atol=ATOL)


@pytest.fixture(scope="module")
def models(datasets):
    """The port's model (hidden 4, 1 layer) on weights made from a seed and
    moved off their constant init, the flax model on the same weights
    under the same names, a batch of 4, and the reference's loss, outputs
    and gradients from one compiled value-and-grad."""
    from csmpn_tpu.models.hulls import HullsModel as JModel
    from csmpn_torch.convert import params_to_jax
    from csmpn_torch.models.hulls import HullsModel as TModel
    from csmpn_torch.nn.modules import init_parameters

    jds, tds = datasets["jax_ds"], datasets["torch_ds"]
    jb = jds.train_dataset.select(np.arange(4))
    tb = tds.train_dataset.select(np.arange(4)).to("cpu")
    tm = TModel(spec=tds.spec, hidden_features=4, num_layers=1)
    gen = torch.Generator().manual_seed(0)
    init_parameters(tm, gen)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    params = jax.tree.map(jnp.asarray, params_to_jax(tm.state_dict()))
    jm = JModel(spec=jds.spec, hidden_features=4, num_layers=1)
    (j_loss, j_out), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, jb), has_aux=True))(params)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jb)
    return dict(jm=jm, jb=jb, tm=tm, tb=tb, shapes=shapes, loss=j_loss,
                out=j_out, grads=j_grads)


def test_hulls_model_loss_matches_jax(models):
    """Per-sample and backprop loss, hidden 4, 1 layer, batch 4; the flax
    tree maps onto the port's state_dict with no key left over."""
    from csmpn_torch.convert import params_from_jax

    tm = models["tm"]
    flax_keys = params_from_jax(jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), models["shapes"]))
    assert set(flax_keys) == set(tm.state_dict())
    with torch.no_grad():
        t_loss, t_out = tm(models["tb"])
    np.testing.assert_allclose(t_out["loss"].numpy(),
                               np.asarray(models["out"]["loss"]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(t_loss), float(models["loss"]),
                               rtol=RTOL)


def test_hulls_model_grads_match_jax(models):
    from csmpn_torch.convert import params_from_jax

    tm = models["tm"]
    tm.zero_grad()
    tm(models["tb"])[0].backward()
    jg = params_from_jax(jax.tree.map(np.asarray, models["grads"]))
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[k].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)


def _cemlp_state(z, prefix, out_prefix, n_layers=2):
    """A reference CEMLP state dict (``{prefix}layers.{i}.{j}.*``) as the
    port's keys under ``out_prefix``."""
    sd = {}
    for i in range(n_layers):
        b = f"{prefix}layers.{i}."
        o = f"{out_prefix}."
        sd[o + f"linear_{i}.weight"] = z[b + "0.weight"]
        sd[o + f"linear_{i}.bias"] = z[b + "0.bias"][0]
        sd[o + f"silu_{i}.a"] = z[b + "1.a"][0]
        sd[o + f"silu_{i}.b"] = z[b + "1.b"][0]
        sd[o + f"gp_{i}.weight"] = z[b + "2.weight"]
        sd[o + f"gp_{i}.linear_right.weight"] = z[b + "2.linear_right.weight"]
        sd[o + f"gp_{i}.linear_left.weight"] = z[b + "2.linear_left.weight"]
        sd[o + f"gp_{i}.linear_left.bias"] = z[b + "2.linear_left.bias"][0]
        sd[o + f"gp_{i}.normalization.a"] = z[b + "2.normalization.a"]
        sd[o + f"norm_{i}.a"] = z[b + "3.a"][0]
    return sd


def test_hulls_model_matches_reference_fixture():
    """The full model (embedding -> one-hot conditioning -> 3 EGCL ->
    projection -> global mean pool -> MSE) against the torch reference
    recorded in tests/fixtures/model_hulls.npz, as the reference package's
    test_hulls_model_parity does."""
    from csmpn_torch.data.batching import (collate, pad_big_graph,
                                           spec_from_graphs)
    from csmpn_torch.data.lifting import flatten_complex, hull_lift
    from csmpn_torch.models.hulls import HullsModel

    z = np.load(os.path.join(FIXDIR, "model_hulls.npz"))
    points = z["points"]
    bigs = [flatten_complex(hull_lift(p, 2)) for p in points]
    spec = spec_from_graphs(bigs)
    samples = [pad_big_graph(b, spec, {"input": p.astype(np.float32)})
               for b, p in zip(bigs, points)]
    tgts = [{"target": np.float32(t)} for t in z["target"]]
    batch = collate(samples, tgts).to("cpu")
    pre = "sd.cl_feature_embedding."
    sd = {"cl_feature_embedding.embed_0.weight": z[pre + "0.weight"],
          "cl_feature_embedding.embed_0.bias": z[pre + "0.bias"][0],
          "projection.weight": z["sd.projection.0.weight"],
          "projection.bias": z["sd.projection.0.bias"][0]}
    sd.update(_cemlp_state(z, pre + "1.", "cl_feature_embedding.embed_1", 1))
    sd.update(_cemlp_state(z, pre + "2.", "cl_feature_embedding.embed_2", 2))
    for i in range(3):
        for part in ("edge_model", "node_model"):
            sd.update(_cemlp_state(z, f"sd.layers.{i}.{part}.",
                                   f"egcl_{i}.{part}"))
    model = HullsModel(spec=spec, hidden_features=8)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32))
                           for k, v in sd.items()})
    with torch.no_grad():
        loss, out = model(batch)
    np.testing.assert_allclose(out["loss"].numpy(), z["loss"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(loss), float(z["backprop_loss"]),
                               rtol=RTOL)


def test_hulls_task_cli_on_cpu(tmp_path):
    """Three steps of the port's hulls task through its entry point."""
    env = dict(os.environ, DATAROOT=str(tmp_path),
               RUNDIR=str(tmp_path / "runs"))
    cmd = [sys.executable, "-m", "csmpn_torch.tasks.hulls",
           "--trainer.module=csmpn_torch.engineer.Trainer",
           "--trainer.max_steps=3", "--trainer.val_check_interval=2",
           "--trainer.print_interval=1", "--trainer.log_interval=2",
           "--trainer.limit_val_batches=1",
           "--optimizer.module=csmpn_torch.engineer.optim.adam",
           "--dataset.module=csmpn_torch.data.hulls.ConvexHullDataset",
           "--dataset.num_samples=6", "--dataset.batch_size=2",
           "--dataset.num_val_samples=2",
           "--model.module=csmpn_torch.models.hulls.HullsModel",
           "--model.hidden_features=4", "--model.num_layers=1",
           "--device=cpu"]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = proc.stdout
    for step in range(3):
        assert f"Step: {step} (Training) Loss:" in out
    assert "(Validation)" in out and "val/loss" in out
    assert "(Testing)" in out and "test/loss" in out
    assert "Stopping due to max_steps." in out
    assert os.path.exists(tmp_path / "hulls" / "hulls_train_input.npy")
