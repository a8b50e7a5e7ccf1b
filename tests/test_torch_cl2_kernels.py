"""The plain versions of K2/K3 at Cl(2,0) (one CEMLP block, dense form, 4
blades, up to 64 output channels) against the reference package, and the
CPU dispatch of their wrappers.

  * plain K2 against the flat XLA oracle ``_block_flat_xla`` at nb = 4 and
    against the reference's Pallas kernel run in interpret mode (a flax
    CEMLP with ``fused=True``, whose ``apply_fused_cemlp`` interprets the
    kernel off the TPU), exact mode;
  * plain K2 and K3 in fast mode against the body of the reference's
    kernel (``_forward_math`` with the dense tables) and its ``jax.vjp``,
    the same rounding points without Pallas;
  * plain K3 against ``jax.grad`` of the composed flax CEMLP, including
    C = 40 > 32 output channels (two channel slots per lane on the card).

Tolerances: rtol 2e-4 / atol 1e-5 in exact fp32 (the reference's parity
tolerance).  Fast mode as tests/test_torch_pair_kernels.py: both sides
round the same operands to bf16, but a different fp32 summation order can
move a value across a bf16 rounding boundary, so 1e-2 (forward) and 3e-2
(backward) of each tensor's largest magnitude.  The CUDA kernels are held
to these plain versions on the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from csmpn_tpu.algebra import get_algebra as jax_algebra
from csmpn_tpu.nn.modules import CEMLP as JCEMLP
from csmpn_tpu.ops import cemlp_kernel as jck
from csmpn_tpu.ops import segment as jseg
from csmpn_torch.algebra import get_algebra
from csmpn_torch.convert import params_from_jax, params_to_jax
from csmpn_torch.nn.modules import CEMLP, init_parameters
from csmpn_torch.ops import cemlp_kernel as ck
from csmpn_torch.ops import segment as seg

RTOL, ATOL = 2e-4, 1e-5
FAST_TOL = {"fwd": 1e-2, "bwd": 3e-2}
CL2 = (1.0, 1.0)
NB = 4


def _block(rows, cin, c, seed=0, n_layers=1, hidden=None):
    """A CEMLP at Cl(2) made by the port from a seed with its parameters
    moved off their constant init, the same parameters as a flax tree, the
    reference's composed module, an input and an output cotangent."""
    hidden = hidden or c
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, cin, NB).astype(np.float32)
    g = rng.randn(rows, c, NB).astype(np.float32)
    t = CEMLP(get_algebra(CL2), cin, hidden, c, n_layers=n_layers)
    gen = torch.Generator().manual_seed(seed)
    init_parameters(t, gen)
    with torch.no_grad():
        for p in t.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    params = jax.tree.map(jnp.asarray, params_to_jax(t.state_dict()))
    return params, x, g, t


def _close(got, want, exact, kind, msg=""):
    got = got.detach().numpy()
    want = np.asarray(want)
    if exact:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=msg)
    else:
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= FAST_TOL[kind], f"{msg}: rel err {err:.3e}"


def _jax_dense_block(m, cin, c, exact):
    """params, x (rows, cin, 4) -> the block output through the body of
    the reference's kernel (``_forward_math``, dense tables)."""
    lin_p = jck._round_up(cin * NB, 128)
    lp = jck._round_up(c * NB, 128)
    const = tuple(jnp.asarray(a) for a in
                  jck._structural_tables(2, CL2, c, lp))
    assert len(const) == 6            # (bc, ms, wm, G, H, Bcat)

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


@pytest.mark.parametrize("rows,cin,c", [(11, 5, 4), (7, 46, 40)])
def test_plain_k2_cl2_matches_block_flat_xla(rows, cin, c):
    params, x, _, t = _block(rows, cin, c)
    m = JCEMLP(jax_algebra(CL2), cin, c, c, n_layers=1, fused=False)
    lin_p = jck._round_up(cin * NB, 128)
    lp = jck._round_up(c * NB, 128)
    tables = jck.block_tables(m.bind(params), 0, lin_p, lp)
    const = jck._structural_tables(2, CL2, c, lp)
    xf = np.zeros((rows, lin_p), np.float32)
    xf[:, :cin * NB] = x.reshape(rows, -1)
    want = np.asarray(jax.jit(jck._block_flat_xla, static_argnums=3)(
        jnp.asarray(xf), tables, tuple(jnp.asarray(a) for a in const), NB))
    want = want[:, :c * NB].reshape(rows, c, NB)
    got = ck.block_forward_plain(torch.from_numpy(x), ck.block_params(t, 0),
                                 get_algebra(CL2), exact=True)
    _close(got, want, True, "fwd")
    _close(got, jax.jit(m.apply)(params, jnp.asarray(x)), True, "fwd")


@pytest.mark.parametrize("cin,hidden,c,n_layers", [(7, 5, 3, 2),
                                                   (6, 40, 40, 1)])
def test_plain_k2_cl2_matches_pallas_interpret(cin, hidden, c, n_layers):
    """apply_fused_cemlp (one block per layer, CPU plain versions) equals
    the reference's fused Pallas kernel run in interpret mode, exact."""
    params, x, _, t = _block(5, cin, c, seed=2, n_layers=n_layers,
                             hidden=hidden)
    m = JCEMLP(jax_algebra(CL2), cin, hidden, c, n_layers=n_layers,
               fused=True)
    jseg.set_aggregation_mode("exact")
    want = m.apply(params, jnp.asarray(x))   # interpret mode off the TPU
    seg.set_aggregation_mode("exact")
    _close(ck.apply_fused_cemlp(t, torch.from_numpy(x)), want, True, "fwd")


@pytest.mark.parametrize("rows,cin,c", [(9, 6, 5), (5, 83, 40)])
def test_plain_k3_cl2_matches_jax_grad(rows, cin, c):
    """dx and all 10 parameter gradients of one block, exact; gp.weight is
    (C, 10) at Cl(2)."""
    params, x, g, t = _block(rows, cin, c, seed=1)
    m = JCEMLP(jax_algebra(CL2), cin, c, c, n_layers=1, fused=False)

    def f(p, xx):
        return jnp.sum(m.apply(p, xx) * jnp.asarray(g))

    j_gp, j_gx = jax.jit(jax.grad(f, argnums=(0, 1)))(params, jnp.asarray(x))
    dx, grads = ck.block_backward(torch.from_numpy(x), torch.from_numpy(g),
                                  ck.block_params(t, 0), get_algebra(CL2),
                                  exact=True)
    _close(dx, j_gx, True, "bwd", "dx")
    j_grads = params_from_jax(jax.tree.map(np.asarray, j_gp))
    names = [k for k, _ in t.named_parameters()]
    assert len(names) == len(grads) == 10
    assert tuple(grads[4].shape) == (c, 10)
    for k, gr in zip(names, grads):
        _close(gr, j_grads[k].numpy(), True, "bwd", k)


def _body_case(rows, cin, c, exact):
    return pytest.param(rows, cin, c, exact, id=f"{rows}-{cin}-{c}-"
                        f"{'exact' if exact else 'fast'}")


@pytest.mark.parametrize("rows,cin,c,exact", [
    _body_case(r, cin, c, e) for r, cin, c in
    [(11, 3, 4), (6, 40, 40), (7, 83, 4), (5, 83, 64)]
    for e in (True, False)] + [
    _body_case(11, 3, c, False) for c in (1, 2, 3)])
def test_plain_k2_k3_cl2_match_kernel_body(rows, cin, c, exact):
    """The block and its vjp against the reference kernel's body in both
    modes (the dense form rounds the path weight in fast mode), at the
    widths the fast row tiles take: C = 4 and 40, the widest input of the
    NBA blocks (83) at C = 4 and at the widest C (64, two channel slots a
    lane); and in fast mode at C = 1-3, where the layer norm spans 1-3
    channels (the limits of the Cl(3) test in test_torch_kernels.py)."""
    params, x, g, t = _block(rows, cin, c, seed=3)
    m = JCEMLP(jax_algebra(CL2), cin, c, c, n_layers=1, fused=False)
    fn = _jax_dense_block(m, cin, c, exact)
    want = jax.jit(fn)(params, jnp.asarray(x))
    alg = get_algebra(CL2)
    got = ck.block_forward_plain(torch.from_numpy(x), ck.block_params(t, 0),
                                 alg, exact)
    _close(got, want, exact, "fwd")
    j_gp, j_gx = jax.jit(lambda p, xx, gg: jax.vjp(fn, p, xx)[1](gg))(
        params, jnp.asarray(x), jnp.asarray(g))
    dx, grads = ck.block_backward(torch.from_numpy(x), torch.from_numpy(g),
                                  ck.block_params(t, 0), alg, exact)
    _close(dx, j_gx, exact, "bwd", "dx")
    j_grads = params_from_jax(jax.tree.map(np.asarray, j_gp))
    for (k, _), gr in zip(t.named_parameters(), grads):
        _close(gr, j_grads[k].numpy(), exact, "bwd", k)


def test_cl2_wrappers_on_cpu_take_plain_versions_and_count_nothing():
    counters = (ck.CL2_FWD_LAUNCHES, ck.CL2_BWD_LAUNCHES,
                ck.FWD_LAUNCHES, ck.BWD_LAUNCHES)
    for cnt in counters:
        cnt.reset()
    alg = get_algebra(CL2)
    x = torch.randn(5, 3, NB)
    t = CEMLP(alg, 3, 40, 40, n_layers=1)
    params = ck.block_params(t, 0)
    out = ck.block_forward(x, params, alg, exact=True)
    torch.testing.assert_close(out, ck.block_forward_plain(x, params, alg))
    dx, grads = ck.block_backward(x, torch.ones_like(out), params, alg)
    assert dx.shape == x.shape and len(grads) == 10
    assert [cnt.count for cnt in counters] == [0, 0, 0, 0]


def test_block_kernel_cl2():
    """nb = 4 takes the Cl(2) build of K2/K3 (its own counters, up to 64
    channels); Cl(3) keeps 32; nb = 16 takes the Cl(4) build of K2p/K3p;
    nb = 2 (Cl(1)) still raises."""
    k = ck.block_kernel(4)
    assert k is ck.DENSE_CL2 and k.source == "cemlp"
    assert (k.n_grades, k.n_paths) == (get_algebra(CL2).n_subspaces,
                                       get_algebra(CL2).n_product_paths)
    assert k.fwd is ck.CL2_FWD_LAUNCHES and k.bwd is ck.CL2_BWD_LAUNCHES
    assert (k.max_channels, ck.DENSE.max_channels) == (64, 32)
    assert ck.block_kernel(16) is ck.PAIR_CL4
    with pytest.raises(NotImplementedError, match=r"Cl\(1\) \(2 blades"):
        ck.block_kernel(2)


def test_cl2_block_params_checked_in_cl2_shapes():
    alg = get_algebra(CL2)
    params = ck.block_params(CEMLP(alg, 2, 40, 40, n_layers=1), 0)
    ck.check_block_params(params, 2, 40, torch.device("cpu"), ck.DENSE_CL2)
    with pytest.raises(ValueError, match=r"\(40, 10\)"):
        ck.check_block_params(params[:4] + [torch.zeros(40, 20)]
                              + params[5:], 2, 40, torch.device("cpu"),
                              ck.DENSE_CL2)
    wide = ck.block_params(CEMLP(alg, 2, 65, 65, n_layers=1), 0)
    with pytest.raises(NotImplementedError, match="at most 64"):
        ck.check_block_params(wide, 2, 65, torch.device("cpu"),
                              ck.DENSE_CL2)
