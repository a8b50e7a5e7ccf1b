"""csmpn_torch layers against the flax layers of csmpn_tpu (same weights,
through convert.params_from_jax) and against the torch-reference fixtures.

Tolerances: rtol 2e-4 / atol 1e-5 in exact fp32, the reference package's
parity tolerance (tests/test_reference_parity.py)."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from csmpn_tpu.algebra import get_algebra as jax_algebra
import csmpn_tpu.nn as jnn
from csmpn_torch.algebra import get_algebra
import csmpn_torch.nn as tnn
from csmpn_torch.convert import params_from_jax, params_to_jax

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
RTOL, ATOL = 2e-4, 1e-5
CL3 = (1.0, 1.0, 1.0)


def fixture(name):
    return np.load(os.path.join(FIXDIR, name))


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def perturbed(params, seed=0):
    """Flax params moved away from their (often constant) init."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + 0.1 * rng.randn(*p.shape)
                              .astype(np.float32)), params)


def ref_cemlp_sd(z, prefix, out_prefix, n_layers=2):
    """Reference CEMLP state dict (``{prefix}layers.{i}.{j}.*``) -> keys of
    the port's CEMLP under ``out_prefix``."""
    sd = {}
    for i in range(n_layers):
        b = f"{prefix}layers.{i}."
        o = f"{out_prefix}"
        sd[f"{o}linear_{i}.weight"] = z[b + "0.weight"]
        sd[f"{o}linear_{i}.bias"] = z[b + "0.bias"][0]
        sd[f"{o}silu_{i}.a"] = z[b + "1.a"][0]
        sd[f"{o}silu_{i}.b"] = z[b + "1.b"][0]
        sd[f"{o}gp_{i}.weight"] = z[b + "2.weight"]
        sd[f"{o}gp_{i}.linear_right.weight"] = z[b + "2.linear_right.weight"]
        sd[f"{o}gp_{i}.linear_left.weight"] = z[b + "2.linear_left.weight"]
        sd[f"{o}gp_{i}.linear_left.bias"] = z[b + "2.linear_left.bias"][0]
        sd[f"{o}gp_{i}.normalization.a"] = z[b + "2.normalization.a"]
        sd[f"{o}norm_{i}.a"] = z[b + "3.a"][0]
    return {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in sd.items()}


# --------------------------------------------------------------- fixtures

@pytest.mark.parametrize("layer", ["mvlinear", "mvsilu", "normalization",
                                   "mvlayernorm", "sgp"])
def test_layer_matches_fixture(layer):
    z = fixture(f"layer_{layer}.npz")
    alg = get_algebra(CL3)
    if layer == "mvlinear":
        m = tnn.MVLinear(alg, 4, 6)
        sd = {"weight": z["weight"], "bias": z["bias"][0]}
    elif layer == "mvsilu":
        m = tnn.MVSiLU(alg, 4)
        sd = {"a": z["a"][0], "b": z["b"][0]}
    elif layer == "normalization":
        m = tnn.NormalizationLayer(alg, 4)
        sd = {"a": z["a"]}
    elif layer == "mvlayernorm":
        m = tnn.MVLayerNorm(alg, 4)
        sd = {"a": z["a"][0]}
    else:
        m = tnn.SteerableGeometricProductLayer(alg, 4)
        sd = {"weight": z["weight"],
              "linear_right.weight": z["linear_right"],
              "linear_left.weight": z["linear_left"],
              "linear_left.bias": z["linear_left_bias"][0],
              "normalization.a": z["norm_a"]}
    m.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32))
                       for k, v in sd.items()})
    close(m(torch.from_numpy(z["x"])), z["out"], rtol=1e-4)


@pytest.mark.parametrize("tag,metric,feats", [
    ("cemlp", CL3, (4, 8, 6)), ("cemlp_cl5", (1.0,) * 5, (3, 4, 3))])
def test_cemlp_matches_fixture(tag, metric, feats):
    z = fixture(f"layer_{tag}.npz")
    m = tnn.CEMLP(get_algebra(metric), *feats, n_layers=2)
    m.load_state_dict(ref_cemlp_sd(z, "sd.", ""))
    close(m(torch.from_numpy(z["x"])), z["out"])


@pytest.mark.parametrize("aggr", ["mean", "sum"])
def test_egcl_matches_fixture(aggr):
    """Includes an isolated node (an empty segment)."""
    z = fixture(f"layer_egcl_{aggr}.npz")
    m = tnn.EGCL(get_algebra(CL3), 4, 8, 4, edge_attr_features=2,
                 node_attr_features=2, aggr=aggr, edges_sorted=False)
    sd = ref_cemlp_sd(z, "sd.edge_model.", "edge_model.")
    sd.update(ref_cemlp_sd(z, "sd.node_model.", "node_model."))
    m.load_state_dict(sd)
    out = m(torch.from_numpy(z["h"]),
            torch.from_numpy(z["edge_index"].astype(np.int64)),
            edge_attr=torch.from_numpy(z["edge_attr"]),
            node_attr=torch.from_numpy(z["node_attr"]))
    close(out, z["out"])


# ------------------------------------------------ against the flax layers

def _pair(name, alg_j, alg_t, feats):
    if name == "mvlinear":
        return jnn.MVLinear(alg_j, *feats), tnn.MVLinear(alg_t, *feats)
    if name == "mvlinear_nosub":
        return (jnn.MVLinear(alg_j, *feats, subspaces=False),
                tnn.MVLinear(alg_t, *feats, subspaces=False))
    if name == "mvsilu":
        return jnn.MVSiLU(alg_j, feats[0]), tnn.MVSiLU(alg_t, feats[0])
    if name == "normalization":
        return (jnn.NormalizationLayer(alg_j, feats[0]),
                tnn.NormalizationLayer(alg_t, feats[0]))
    if name == "mvlayernorm":
        return jnn.MVLayerNorm(alg_j, feats[0]), tnn.MVLayerNorm(alg_t,
                                                                 feats[0])
    if name == "sgp":
        return (jnn.SteerableGeometricProductLayer(alg_j, feats[0]),
                tnn.SteerableGeometricProductLayer(alg_t, feats[0]))
    return (jnn.CEMLP(alg_j, *feats, n_layers=2, fused=False),
            tnn.CEMLP(alg_t, *feats, n_layers=2))


@pytest.mark.parametrize("name,feats", [
    ("mvlinear", (5, 3)), ("mvlinear_nosub", (5, 3)), ("mvsilu", (4,)),
    ("normalization", (4,)), ("mvlayernorm", (4,)), ("sgp", (4,)),
    ("cemlp", (5, 6, 4))])
def test_layer_matches_flax(name, feats):
    alg_j, alg_t = jax_algebra(CL3), get_algebra(CL3)
    jm, tm = _pair(name, alg_j, alg_t, feats)
    rng = np.random.RandomState(3)
    x = rng.randn(7, feats[0], 8).astype(np.float32)
    params = perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    close(tm(torch.from_numpy(x)), jm.apply(params, jnp.asarray(x)))


def test_params_roundtrip():
    alg = get_algebra(CL3)
    m = tnn.CEMLP(alg, 3, 4, 2)
    back = params_from_jax(params_to_jax(m.state_dict()))
    assert set(back) == set(m.state_dict())
    for k, v in m.state_dict().items():
        assert torch.equal(back[k], v)


# ------------------------------------------------------- EGCL vs the JAX EGCL

def _graph(n=9, e=20, isolated=4, seed=0):
    rng = np.random.RandomState(seed)
    nodes = [i for i in range(n) if i != isolated]
    src = rng.choice(nodes, e)
    dst = rng.choice(nodes, e)
    order = np.lexsort((src, dst))
    ei = np.stack([src[order], dst[order]]).astype(np.int32)
    mask = rng.rand(e) > 0.2
    return ei, mask


@pytest.mark.parametrize("aggr", ["mean", "sum"])
def test_egcl_forward_and_grads_match_jax(aggr):
    """Forward, d/dh and every parameter gradient, with edge and node
    attributes, an edge mask and an isolated node."""
    alg_j, alg_t = jax_algebra(CL3), get_algebra(CL3)
    n, e = 9, 20
    ei, mask = _graph(n, e)
    rng = np.random.RandomState(1)
    h = rng.randn(n, 4, 8).astype(np.float32)
    ea = rng.randn(e, 2, 8).astype(np.float32)
    na = rng.randn(n, 3, 8).astype(np.float32)
    g = rng.randn(n, 4, 8).astype(np.float32)
    jm = jnn.EGCL(alg_j, 4, 6, 4, edge_attr_features=2,
                  node_attr_features=3, aggr=aggr, fused_mlp=False)
    args = (jnp.asarray(ei), jnp.asarray(ea), jnp.asarray(na),
            jnp.asarray(mask))
    params = perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(h), *args[:3],
                               edge_mask=args[3]))

    def f(p, hh):
        out = jm.apply(p, hh, args[0], args[1], args[2], edge_mask=args[3])
        return jnp.sum(out * jnp.asarray(g)), out

    (_, j_out), (j_gp, j_gh) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(h))

    tm = tnn.EGCL(alg_t, 4, 6, 4, edge_attr_features=2,
                  node_attr_features=3, aggr=aggr)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    th = torch.from_numpy(h).requires_grad_(True)
    t_out = tm(th, torch.from_numpy(ei.astype(np.int64)),
               torch.from_numpy(ea), torch.from_numpy(na),
               edge_mask=torch.from_numpy(mask))
    (t_out * torch.from_numpy(g)).sum().backward()
    close(t_out, j_out)
    close(th.grad, j_gh)
    j_grads = params_from_jax(jax.tree.map(np.asarray, j_gp))
    for k, p in tm.named_parameters():
        close(p.grad, j_grads[k].numpy(), msg=k)
