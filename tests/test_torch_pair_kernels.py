"""The plain versions of the pair-form kernels K2p/K3p (one CEMLP block at
Cl(5,0), 32 blades) against the reference's pair-form block math, and the
CPU dispatch of their wrappers.

The reference's Pallas kernel is not run here (interpret mode at Cl(5) is
slow, tests/test_fused_cemlp.py is marked slow for that).  Instead the
plain-jnp function its kernel body runs, ``_forward_math`` with the
pair-form tables of ``block_tables``/``_structural_tables``, is called
directly, and ``jax.vjp`` of it gives the backward: the same rounding
points as the Pallas kernel, without Pallas.

Tolerances: rtol 2e-4 / atol 1e-5 in exact fp32 (the reference's parity
tolerance).  In fast mode both sides round the same operands to bf16 at
the same points, but a different fp32 summation order upstream can move a
value across a bf16 rounding boundary, which changes it by one bf16 step
(2^-8 relative); so fast mode is held to 1e-2 of the largest magnitude of
each tensor (K2p) and 3e-2 (K3p, whose cotangents are rounded too).
The CUDA kernels themselves are held to these plain versions on the card
by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from csmpn_tpu.algebra import get_algebra as jax_algebra
from csmpn_tpu.nn.modules import CEMLP as JCEMLP
from csmpn_tpu.ops import cemlp_kernel as jck
from csmpn_torch.algebra import get_algebra
from csmpn_torch.convert import params_from_jax, params_to_jax
from csmpn_torch.nn.modules import CEMLP, init_parameters
from csmpn_torch.ops import cemlp_kernel as ck
from csmpn_torch.ops import segment as seg

RTOL, ATOL = 2e-4, 1e-5
FAST_TOL = {"fwd": 1e-2, "bwd": 3e-2}
CL5 = (1.0,) * 5
NB = 32
SHAPES = [(11, 3, 4), (9, 28, 28)]   # (rows, Cin, C)


def _block(rows, cin, c, seed=0):
    """A one-block CEMLP at Cl(5) made by the port from a seed with its
    parameters moved off their constant init, the same parameters as a
    flax tree with the reference's module, an input and an output
    cotangent."""
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, cin, NB).astype(np.float32)
    g = rng.randn(rows, c, NB).astype(np.float32)
    t = CEMLP(get_algebra(CL5), cin, c, c, n_layers=1)
    gen = torch.Generator().manual_seed(seed)
    init_parameters(t, gen)
    with torch.no_grad():
        for p in t.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    params = jax.tree.map(jnp.asarray, params_to_jax(t.state_dict()))
    m = JCEMLP(jax_algebra(CL5), cin, c, c, n_layers=1, fused=False)
    return m, params, x, g, t


def _jax_pair_block(m, cin, c, exact):
    """params, x (rows, cin, 32) -> the block output through the pair-form
    body of the reference's kernel (``_forward_math``)."""
    lin_p = jck._round_up(cin * NB, 128)
    lp = jck._round_up(c * NB, 128)
    const = tuple(jnp.asarray(a) for a in
                  jck._structural_tables(5, CL5, c, lp))
    assert len(const) == 8            # (bc, ms, wm, G, H, S4, Rz, Ry)

    def run(params, x):
        rows = x.shape[0]
        xf = jnp.pad(x.reshape(rows, cin * NB),
                     ((0, 0), (0, lin_p - cin * NB)))

        def body(mod):
            refs = tuple(jck.block_tables(mod, 0, lin_p, lp)) + const
            return jck._forward_math(xf, refs, NB, exact)["out"]

        out = m.apply(params, method=body)
        return out[:, :c * NB].reshape(rows, c, NB)

    return run


def _close(got, want, exact, kind, msg=""):
    got = got.detach().numpy()
    want = np.asarray(want)
    if exact:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=msg)
    else:
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= FAST_TOL[kind], f"{msg}: rel err {err:.3e}"


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("rows,cin,c", SHAPES)
def test_plain_k2p_matches_jax_pair_math(rows, cin, c, exact):
    m, params, x, _, t = _block(rows, cin, c)
    want = jax.jit(_jax_pair_block(m, cin, c, exact))(params,
                                                      jnp.asarray(x))
    got = ck.block_forward_plain(torch.from_numpy(x), ck.block_params(t, 0),
                                 get_algebra(CL5), exact)
    _close(got, want, exact, "fwd")


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("rows,cin,c", SHAPES)
def test_plain_k3p_matches_jax_vjp(rows, cin, c, exact):
    """dx and all 10 parameter gradients, in the flax shapes (gp.weight is
    (C, 56) at Cl(5))."""
    m, params, x, g, t = _block(rows, cin, c, seed=1)
    fn = _jax_pair_block(m, cin, c, exact)
    j_gp, j_gx = jax.jit(lambda p, xx, gg: jax.vjp(fn, p, xx)[1](gg))(
        params, jnp.asarray(x), jnp.asarray(g))
    dx, grads = ck.block_backward(torch.from_numpy(x), torch.from_numpy(g),
                                  ck.block_params(t, 0), get_algebra(CL5),
                                  exact)
    _close(dx, j_gx, exact, "bwd", "dx")
    j_grads = params_from_jax(jax.tree.map(np.asarray, j_gp))
    names = [k for k, _ in t.named_parameters()]
    assert len(names) == len(grads) == 10
    assert tuple(grads[4].shape) == (c, 56)
    for k, gr in zip(names, grads):
        _close(gr, j_grads[k].numpy(), exact, "bwd", k)


def test_pair_chain_matches_composed_cemlp():
    """apply_fused_cemlp at Cl(5) (two blocks, the CPU plain versions)
    equals the reference's composed flax CEMLP."""
    x = np.random.RandomState(4).randn(6, 3, NB).astype(np.float32)
    t = CEMLP(get_algebra(CL5), 3, 5, 4, n_layers=2)
    init_parameters(t, torch.Generator().manual_seed(2))
    params = jax.tree.map(jnp.asarray, params_to_jax(t.state_dict()))
    m = JCEMLP(jax_algebra(CL5), 3, 5, 4, n_layers=2, fused=False)
    seg.set_aggregation_mode("exact")
    _close(ck.apply_fused_cemlp(t, torch.from_numpy(x)),
           jax.jit(m.apply)(params, jnp.asarray(x)), True, "fwd")


def test_pair_wrappers_on_cpu_take_plain_versions_and_count_nothing():
    counters = (ck.PAIR_FWD_LAUNCHES, ck.PAIR_BWD_LAUNCHES)
    for cnt in counters:
        cnt.reset()
    alg = get_algebra(CL5)
    x = torch.randn(5, 2, NB)
    t = CEMLP(alg, 2, 3, 3, n_layers=1)
    params = ck.block_params(t, 0)
    out = ck.block_forward(x, params, alg, exact=True)
    torch.testing.assert_close(out, ck.block_forward_plain(x, params, alg))
    dx, grads = ck.block_backward(x, torch.ones_like(out), params, alg)
    assert dx.shape == x.shape and len(grads) == 10
    assert [cnt.count for cnt in counters] == [0, 0]


def test_block_kernel_forms():
    """nb = 8 takes K2/K3, nb = 4 their Cl(2) build, nb = 32 K2p/K3p and
    nb = 16 their Cl(4) build, both in the pair form; nb = 2 (Cl(1), the
    next form to port) raises, names what each kernel takes and the
    ROADMAP item."""
    assert ck.block_kernel(8) is ck.DENSE
    assert ck.block_kernel(4) is ck.DENSE_CL2
    assert ck.block_kernel(32) is ck.PAIR
    assert ck.block_kernel(16) is ck.PAIR_CL4
    assert (ck.PAIR.n_grades, ck.PAIR.n_paths) == (
        get_algebra(CL5).n_subspaces, get_algebra(CL5).n_product_paths)
    assert [k.form for k in (ck.DENSE_CL2, ck.DENSE, ck.PAIR_CL4,
                             ck.PAIR)] == ["dense", "dense", "pair", "pair"]
    for nb in (2, 64):
        with pytest.raises(NotImplementedError,
                           match=r"32 blades.*ROADMAP Queue 2"):
            ck.block_kernel(nb)


def test_pair_block_params_checked_in_cl5_shapes():
    alg = get_algebra(CL5)
    t = CEMLP(alg, 2, 3, 3, n_layers=1)
    params = ck.block_params(t, 0)
    ck.check_block_params(params, 2, 3, torch.device("cpu"), ck.PAIR)
    with pytest.raises(ValueError, match=r"\(3, 56\)"):
        ck.check_block_params(params[:4] + [torch.zeros(3, 20)]
                              + params[5:], 2, 3, torch.device("cpu"),
                              ck.PAIR)
