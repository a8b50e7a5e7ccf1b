"""The layer options of csmpn_torch against the flax layers of csmpn_tpu
(same weights through convert.params_from_jax, inputs from a numpy seed).

  * MVSiLU with ``invariant`` "mag2" and "norm";
  * the SGP at Cl(3) and Cl(5) over include_first_order x
    normalization_init {0.0, None} x impl {dense, pair}: output, d(x) and
    every parameter gradient against jax.grad, and the port's dense and
    pair forms against each other;
  * a CEMLP with normalization_init=None;
  * ``fused=True`` on the CPU (the block kernels' plain versions) against
    the reference's ``fused=True`` (its Pallas kernel in interpret mode),
    exact and fast; ``fused=True`` without normalization layers raises;
  * the EGCL with ``fused_mlp`` True and False, flat and batched;
  * the route a CEMLP takes (``cemlp_route``) and whether an EGCL takes the
    fused pass, for every option on a "cuda" and a "cpu" device type;
  * params_from_jax on trees without ``normalization`` and ``linear_left``.

Tolerances: rtol 2e-4 / atol 1e-5 in exact fp32 (the reference's parity
tolerance).  Fast mode, as tests/test_torch_kernels.py: both sides round
the same operands to bf16, and a different fp32 summation order can move a
value across a rounding boundary, so 1e-2 (forward) and 3e-2 (gradients)
of each tensor's largest magnitude.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import csmpn_tpu.nn as jnn
from csmpn_tpu.algebra import get_algebra as jax_algebra
from csmpn_tpu.ops import segment as jseg
import csmpn_torch.nn as tnn
from csmpn_torch.algebra import get_algebra
from csmpn_torch.convert import params_from_jax, params_to_jax
from csmpn_torch.nn.modules import cemlp_route
from csmpn_torch.ops import cemlp_kernel as ck
from csmpn_torch.ops import fused_egcl as fe
from csmpn_torch.ops import segment as seg

RTOL, ATOL = 2e-4, 1e-5
FAST_TOL = {"fwd": 1e-2, "bwd": 3e-2}
CL3 = (1.0, 1.0, 1.0)
CL5 = (1.0,) * 5


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def fast_close(got, want, kind, msg=""):
    got = got.detach().numpy()
    want = np.asarray(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= FAST_TOL[kind], f"{msg}: rel err {err:.3e}"


def perturbed(params, seed=0):
    """Flax params moved away from their (often constant) init."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + 0.1 * rng.randn(*p.shape)
                              .astype(np.float32)), params)


def load(tm, params):
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return tm


def grads_against_jax(jm, tm, params, x, g, close_fn=close):
    """Output, d(x) and every parameter gradient of ``sum(out * g)``."""
    def f(p, xx):
        out = jm.apply(p, xx)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, j_out), (j_gp, j_gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    t_out = tm(tx)
    (t_out * torch.from_numpy(g)).sum().backward()
    close_fn(t_out, j_out, msg="out")
    close_fn(tx.grad, j_gx, msg="dx")
    j_grads = params_from_jax(jax.tree.map(np.asarray, j_gp))
    names = [k for k, _ in tm.named_parameters()]
    assert sorted(names) == sorted(j_grads)
    for k, p in tm.named_parameters():
        close_fn(p.grad, j_grads[k].numpy(), msg=k)
    return t_out


# ------------------------------------------------------------- (a) MVSiLU

@pytest.mark.parametrize("invariant", ["mag2", "norm"])
def test_mvsilu_invariant_matches_flax(invariant):
    alg_j, alg_t = jax_algebra(CL3), get_algebra(CL3)
    rng = np.random.RandomState(11)
    x = rng.randn(7, 4, 8).astype(np.float32)
    g = rng.randn(7, 4, 8).astype(np.float32)
    jm = jnn.MVSiLU(alg_j, 4, invariant=invariant)
    params = perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tm = load(tnn.MVSiLU(alg_t, 4, invariant=invariant), params)
    assert tm.invariant == invariant
    grads_against_jax(jm, tm, params, x, g)


def test_mvsilu_unknown_invariant_raises():
    with pytest.raises(ValueError, match="not recognized"):
        tnn.MVSiLU(get_algebra(CL3), 4, invariant="abs")


# ----------------------------------------------------------------- (b) SGP

SGP_CASES = [(metric, first, norm, impl)
             for metric in (CL3, CL5)
             for first in (True, False)
             for norm in (0.0, None)
             for impl in ("dense", "pair")]


@pytest.mark.parametrize("metric,first,norm,impl", SGP_CASES, ids=[
    f"cl{len(m)}-{'first' if f else 'nofirst'}-"
    f"{'norm' if n is not None else 'nonorm'}-{i}"
    for m, f, n, i in SGP_CASES])
def test_sgp_options_match_flax(metric, first, norm, impl):
    alg_j, alg_t = jax_algebra(metric), get_algebra(metric)
    nb, c = alg_t.n_blades, 3
    rng = np.random.RandomState(len(metric) * 8 + int(first) * 4
                                + int(norm is None) * 2 + int(impl == "pair"))
    x = rng.randn(5, c, nb).astype(np.float32)
    g = rng.randn(5, c, nb).astype(np.float32)
    kw = dict(include_first_order=first, normalization_init=norm, impl=impl)
    jm = jnn.SteerableGeometricProductLayer(alg_j, c, **kw)
    params = perturbed(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    tm = load(tnn.SteerableGeometricProductLayer(alg_t, c, **kw), params)
    assert hasattr(tm, "normalization") == (norm is not None)
    assert hasattr(tm, "linear_left") == first
    out = grads_against_jax(jm, tm, params, x, g)
    # the other form on the same weights computes the same function
    other = "pair" if impl == "dense" else "dense"
    tm2 = tnn.SteerableGeometricProductLayer(
        alg_t, c, include_first_order=first, normalization_init=norm,
        impl=other)
    tm2.load_state_dict(tm.state_dict())
    close(tm2(torch.from_numpy(x)), out.detach().numpy(), msg=other)


def test_sgp_unknown_impl_raises():
    with pytest.raises(ValueError, match="impl"):
        tnn.SteerableGeometricProductLayer(get_algebra(CL3), 3, impl="sparse")


# ------------------------------------------------- (c, e) CEMLP without norm

def _cemlp_pair(metric, feats, norm, rows=9, seed=0, n_layers=2):
    alg_j, alg_t = jax_algebra(metric), get_algebra(metric)
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, feats[0], alg_t.n_blades).astype(np.float32)
    g = rng.randn(rows, feats[2], alg_t.n_blades).astype(np.float32)
    jm = jnn.CEMLP(alg_j, *feats, n_layers=n_layers,
                   normalization_init=norm, fused=False)
    params = perturbed(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x)),
                       seed)
    return alg_j, alg_t, jm, params, x, g


@pytest.mark.parametrize("metric", [CL3, CL5])
def test_cemlp_without_normalization_matches_flax(metric):
    _, alg_t, jm, params, x, g = _cemlp_pair(metric, (5, 4, 3), None)
    tm = load(tnn.CEMLP(alg_t, 5, 4, 3, normalization_init=None), params)
    assert not any("normalization" in k for k in tm.state_dict())
    assert cemlp_route(tm, "cpu") == "composed"
    grads_against_jax(jm, tm, params, x, g)


def test_fused_true_without_normalization_raises():
    alg = get_algebra(CL3)
    tm = tnn.CEMLP(alg, 5, 4, 3, normalization_init=None, fused=True)
    with pytest.raises(ValueError, match="normalization_init"):
        tm(torch.randn(4, 5, 8))
    # the kernels' own entry refuses such a block with a clear error too
    with pytest.raises(ValueError, match="normalization"):
        ck.block_params(tm, 0)


# ------------------------------------------------- (d) fused=True on the CPU

@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_fused_true_matches_reference_interpret(mode):
    """The port's fused=True CEMLP on a CPU tensor (the plain K2/K3 a
    block) against the reference's fused=True (its Pallas kernels in
    interpret mode), output, d(x) and every parameter gradient."""
    feats = (5, 4, 4)
    _, alg_t, _, params, x, g = _cemlp_pair(CL3, feats, 0.0, rows=11,
                                            seed=3)
    jm = jnn.CEMLP(jax_algebra(CL3), *feats, fused=True)
    tm = load(tnn.CEMLP(alg_t, *feats, fused=True), params)
    assert cemlp_route(tm, "cpu") == "kernels"
    fn = close if mode == "exact" else (
        lambda got, want, msg="": fast_close(
            got, want, "fwd" if msg == "out" else "bwd", msg))
    jseg.set_aggregation_mode(mode)
    seg.set_aggregation_mode(mode)
    try:
        grads_against_jax(jm, tm, params, x, g, close_fn=fn)
    finally:
        jseg.set_aggregation_mode("exact")
        seg.set_aggregation_mode("exact")


# ------------------------------------------------------------------ (f) EGCL

def _graph(b, n, e, seed):
    """``b`` graphs of ``n`` nodes and ``e`` edges each, stacked as the
    batching does (node ``g * n + i``), edges sorted by global target; the
    last node of each graph is isolated."""
    rng = np.random.RandomState(seed)
    src, dst = [], []
    for gi in range(b):
        s = rng.randint(0, n - 1, e) + gi * n
        d = rng.randint(0, n - 1, e) + gi * n
        o = np.lexsort((s, d))
        src.append(s[o])
        dst.append(d[o])
    ei = np.stack([np.concatenate(src), np.concatenate(dst)]).astype(np.int32)
    mask = rng.rand(b * e) > 0.2
    return ei, mask


@pytest.mark.parametrize("fused_mlp", [True, False])
@pytest.mark.parametrize("batched", [False, True])
def test_egcl_fused_mlp_matches_reference(fused_mlp, batched):
    b, n, e, c = 2, 6, 10, 4
    alg_j, alg_t = jax_algebra(CL3), get_algebra(CL3)
    ei, mask = _graph(b, n, e, seed=int(batched) * 2 + int(fused_mlp))
    rng = np.random.RandomState(5)
    h = rng.randn(b * n, c, 8).astype(np.float32)
    ea = rng.randn(b * e, 1, 8).astype(np.float32)
    g = rng.randn(b * n, c, 8).astype(np.float32)
    bs = (b, n, e) if batched else None
    kw = dict(edge_attr_features=1, aggr="mean", fused_mlp=fused_mlp)
    jm = jnn.EGCL(alg_j, c, c, c, **kw)
    args = (jnp.asarray(ei), jnp.asarray(ea))
    params = perturbed(jm.init(jax.random.PRNGKey(2), jnp.asarray(h), *args,
                               edge_mask=jnp.asarray(mask), batch_shape=bs))

    def f(p, hh):
        out = jm.apply(p, hh, *args, edge_mask=jnp.asarray(mask),
                       batch_shape=bs)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, j_out), (j_gp, j_gh) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(h))
    tm = load(tnn.EGCL(alg_t, c, c, c, **kw), params)
    assert tm.edge_model.fused is fused_mlp
    assert tm.node_model.fused is fused_mlp
    th = torch.from_numpy(h).requires_grad_(True)
    out = tm(th, torch.from_numpy(ei.astype(np.int64)), torch.from_numpy(ea),
             edge_mask=torch.from_numpy(mask), batch_shape=bs)
    (out * torch.from_numpy(g)).sum().backward()
    close(out, j_out, msg="out")
    close(th.grad, j_gh, msg="dh")
    j_grads = params_from_jax(jax.tree.map(np.asarray, j_gp))
    for k, p in tm.named_parameters():
        close(p.grad, j_grads[k].numpy(), msg=k)


# ---------------------------------------------------------- (g) the dispatch

ROUTES = [  # (normalization_init, fused, device type) -> route
    (0.0, None, "cuda", "kernels"),
    (0.0, None, "cpu", "composed"),
    (0.0, True, "cuda", "kernels"),
    (0.0, True, "cpu", "kernels"),
    (0.0, False, "cuda", "composed"),
    (0.0, False, "cpu", "composed"),
    (None, None, "cuda", "composed"),
    (None, None, "cpu", "composed"),
    (None, False, "cuda", "composed"),
    (None, False, "cpu", "composed"),
    (None, True, "cuda", ValueError),
    (None, True, "cpu", ValueError),
]


@pytest.mark.parametrize("norm,fused,device,want", ROUTES)
def test_cemlp_route(norm, fused, device, want):
    m = tnn.CEMLP(get_algebra(CL3), 3, 4, 4, normalization_init=norm,
                  fused=fused)
    if want is ValueError:
        with pytest.raises(ValueError, match="normalization_init=None"):
            cemlp_route(m, device)
    else:
        assert cemlp_route(m, device) == want


class _OnCard:
    """Stands in for a CUDA tensor in the fused-pass test (is_cuda)."""
    is_cuda = True


@pytest.mark.parametrize("norm,fused_mlp,device,mode,want", [
    (0.0, None, "cuda", "fast", True),
    (0.0, True, "cuda", "fast", True),
    (0.0, False, "cuda", "fast", False),
    (None, None, "cuda", "fast", False),
    (None, True, "cuda", "fast", False),
    (0.0, None, "cuda", "exact", False),
    (0.0, None, "cpu", "fast", False),
    (0.0, True, "cpu", "fast", False),
])
def test_egcl_fused_pass_dispatch(norm, fused_mlp, device, mode, want):
    """K4/K5 on the flat path only for an edge CEMLP the kernels compute,
    on the card in fast mode, and never with fused_mlp=False; the batched
    path never takes them."""
    m = tnn.EGCL(get_algebra(CL3), 4, 4, 4, normalization_init=norm,
                 fused_mlp=fused_mlp)
    x = _OnCard() if device == "cuda" else torch.zeros(1)
    seg.set_aggregation_mode(mode)
    try:
        assert m._use_fused_mp(None, x) is want
        assert m._use_fused_mp((1, 2, 3), x) is False
        assert fe.fused_mp_supported(m.algebra, m.edge_model, x) is want
    finally:
        seg.set_aggregation_mode("exact")


# --------------------------------------------------- (h) params_from_jax

@pytest.mark.parametrize("first,norm", [(True, None), (False, 0.0),
                                        (False, None)])
def test_params_from_jax_without_submodules(first, norm):
    """A flax tree that lacks ``normalization`` and/or ``linear_left``
    maps onto the port's state_dict unchanged, and back."""
    alg_j, alg_t = jax_algebra(CL3), get_algebra(CL3)
    x = jnp.zeros((2, 3, 8), jnp.float32)
    kw = dict(include_first_order=first, normalization_init=norm)
    tree = jnn.SteerableGeometricProductLayer(alg_j, 3, **kw).init(
        jax.random.PRNGKey(0), x)
    sd = params_from_jax(jax.tree.map(np.asarray, tree))
    tm = tnn.SteerableGeometricProductLayer(alg_t, 3, **kw)
    assert set(sd) == set(tm.state_dict())
    assert ("normalization.a" in sd) == (norm is not None)
    assert ("linear_left.weight" in sd) == first
    tm.load_state_dict(sd)      # strict
    back = params_from_jax(params_to_jax(tm.state_dict()))
    assert all(torch.equal(back[k], v) for k, v in tm.state_dict().items())
    # a CEMLP and an EGCL without normalization layers, through the tree
    jm = jnn.EGCL(alg_j, 3, 4, 3, normalization_init=None)
    ei = jnp.asarray(np.array([[0, 1], [1, 0]], np.int32))
    etree = jm.init(jax.random.PRNGKey(1), jnp.zeros((2, 3, 8)), ei)
    et = tnn.EGCL(alg_t, 3, 4, 3, normalization_init=None)
    et.load_state_dict(params_from_jax(jax.tree.map(np.asarray, etree)))
