"""The port's pair form at Cl(4,0) (16 blades): K2p/K3p and K4p/K5p at
Cl(4), the flat EGCL path and the bench stack at ``--dim 4``, against the
reference package on the CPU.

  * the plain K2p/K3p at Cl(4) against the reference's pair-form block body
    ``_forward_math`` (the tables of ``block_tables`` and
    ``_structural_tables``) and ``jax.vjp`` of it: the rounding points of
    the Pallas kernel, without Pallas;
  * ``apply_fused_cemlp`` at Cl(4) against the reference's flax CEMLP;
  * the port's EGCL with the fused dispatch forced on, and
    ``bench.Stack(dim=4)``, against the reference's, as
    tests/test_torch_flat_algebras.py holds them at Cl(2) and Cl(5);
  * ``bench.workload(dim=4)``, the mapping of K5p's partial vector at
    nb = 16 (53 per-channel rows a block), the kernel tables, and the CPU
    dispatch (plain versions, no launch counted).

Tolerances: rtol 2e-4 / atol 1e-5 in exact fp32 (the reference's parity
tolerance).  In fast mode both sides round the same operands to bf16 at
the same points, but a different fp32 summation order upstream can move a
value across a bf16 rounding boundary (one bf16 step, 2^-8 relative), so
fast mode is held to 1e-2 of each tensor's largest magnitude (K2p) and
3e-2 (K3p, whose cotangents are rounded too).  The CUDA kernels are held
to these plain versions on the card by chip_smoke.py.
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_flat_algebras as flat
from csmpn_tpu.algebra import get_algebra as jax_algebra
from csmpn_tpu.nn.modules import CEMLP as JCEMLP
from csmpn_tpu.ops import cemlp_kernel as jck
from csmpn_tpu.ops import segment as jseg
from csmpn_torch import bench
from csmpn_torch.algebra import get_algebra
from csmpn_torch.convert import params_from_jax, params_to_jax
from csmpn_torch.nn.modules import CEMLP, init_parameters
from csmpn_torch.ops import _build
from csmpn_torch.ops import cemlp_kernel as ck
from csmpn_torch.ops import fused_egcl as fe
from csmpn_torch.ops import segment as seg
from csmpn_torch.ops import segment_kernel as sk

RTOL, ATOL = 2e-4, 1e-5
FAST_TOL = {"fwd": 1e-2, "bwd": 3e-2}
CL4 = (1.0,) * 4
NB = 16
SHAPES = [(11, 3, 4), (9, 28, 28)]   # (rows, Cin, C)
CL4_COUNTERS = (ck.PAIR_CL4_FWD_LAUNCHES, ck.PAIR_CL4_BWD_LAUNCHES,
                fe.PAIR_CL4_FWD_LAUNCHES, fe.PAIR_CL4_BWD_LAUNCHES)


@pytest.fixture(autouse=True)
def _exact_mode():
    seg.set_aggregation_mode("exact")
    jseg.set_aggregation_mode("exact")
    yield
    seg.set_aggregation_mode("exact")
    jseg.set_aggregation_mode("exact")


def _block(rows, cin, c, seed=0):
    """A one-block CEMLP at Cl(4) made by the port from a seed with its
    parameters moved off their constant init, the same parameters as a
    flax tree with the reference's module, an input and an output
    cotangent."""
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, cin, NB).astype(np.float32)
    g = rng.randn(rows, c, NB).astype(np.float32)
    t = CEMLP(get_algebra(CL4), cin, c, c, n_layers=1)
    gen = torch.Generator().manual_seed(seed)
    init_parameters(t, gen)
    with torch.no_grad():
        for p in t.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    params = jax.tree.map(jnp.asarray, params_to_jax(t.state_dict()))
    m = JCEMLP(jax_algebra(CL4), cin, c, c, n_layers=1, fused=False)
    return m, params, x, g, t


def _jax_pair_block(m, cin, c, exact):
    """params, x (rows, cin, 16) -> the block output through the pair-form
    body of the reference's kernel (``_forward_math``)."""
    lin_p = jck._round_up(cin * NB, 128)
    lp = jck._round_up(c * NB, 128)
    const = tuple(jnp.asarray(a) for a in
                  jck._structural_tables(4, CL4, c, lp))
    assert jck._pair_form(NB) and len(const) == 8   # the pair form's tables

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
def test_plain_k2p_cl4_matches_jax_pair_math(rows, cin, c, exact):
    m, params, x, _, t = _block(rows, cin, c)
    want = jax.jit(_jax_pair_block(m, cin, c, exact))(params,
                                                      jnp.asarray(x))
    got = ck.block_forward_plain(torch.from_numpy(x), ck.block_params(t, 0),
                                 get_algebra(CL4), exact)
    _close(got, want, exact, "fwd")


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("rows,cin,c", SHAPES)
def test_plain_k3p_cl4_matches_jax_vjp(rows, cin, c, exact):
    """dx and all 10 parameter gradients, in the flax shapes (gp.weight is
    (C, 35) at Cl(4))."""
    m, params, x, g, t = _block(rows, cin, c, seed=1)
    fn = _jax_pair_block(m, cin, c, exact)
    j_gp, j_gx = jax.jit(lambda p, xx, gg: jax.vjp(fn, p, xx)[1](gg))(
        params, jnp.asarray(x), jnp.asarray(g))
    dx, grads = ck.block_backward(torch.from_numpy(x), torch.from_numpy(g),
                                  ck.block_params(t, 0), get_algebra(CL4),
                                  exact)
    _close(dx, j_gx, exact, "bwd", "dx")
    j_grads = params_from_jax(jax.tree.map(np.asarray, j_gp))
    names = [k for k, _ in t.named_parameters()]
    assert len(names) == len(grads) == 10
    assert tuple(grads[4].shape) == (c, 35)
    for k, gr in zip(names, grads):
        _close(gr, j_grads[k].numpy(), exact, "bwd", k)


def test_pair_chain_cl4_matches_composed_cemlp():
    """apply_fused_cemlp at Cl(4) (two blocks, the CPU plain versions)
    equals the reference's composed flax CEMLP."""
    x = np.random.RandomState(4).randn(6, 3, NB).astype(np.float32)
    t = CEMLP(get_algebra(CL4), 3, 5, 4, n_layers=2)
    init_parameters(t, torch.Generator().manual_seed(2))
    params = jax.tree.map(jnp.asarray, params_to_jax(t.state_dict()))
    m = JCEMLP(jax_algebra(CL4), 3, 5, 4, n_layers=2, fused=False)
    _close(ck.apply_fused_cemlp(t, torch.from_numpy(x)),
           jax.jit(m.apply)(params, jnp.asarray(x)), True, "fwd")


def test_egcl_fused_dispatch_cl4_matches_reference(monkeypatch):
    """Both EGCLs with the fused dispatch forced on (exact mode, CPU) at
    Cl(4): edge and node attributes, a mask, forward and every gradient
    (test_torch_flat_algebras' case at dim 4)."""
    flat.test_egcl_fused_dispatch_matches_reference(4, monkeypatch)


def test_bench_stack_cl4_matches_reference_stack():
    """bench.Stack(dim=4) at hidden 4 on the bench's graph generator: loss
    and every gradient against a flax stack of the reference's EGCL at
    Cl(4) (test_torch_flat_algebras' case at dim 4)."""
    flat.test_bench_stack_matches_reference_stack(4)


def test_bench_workload_cl4():
    """--dim 4: features (N, 28, 16) at the bench's width for Cl(4), from
    the same stream after the same edges as at Cl(3)."""
    assert bench.WIDTHS[4][0] == 28 and "Cl(4,0)" in bench.WIDTHS[4][1]
    kw = dict(n_nodes=64, n_edges=256, batch=2)
    h, ei, _ = bench.workload("cpu", hidden=28, dim=4, **kw)
    _, ei3, _ = bench.workload("cpu", **kw)
    assert h.shape == (128, 28, 16) and h.dtype == torch.float32
    assert torch.equal(ei, ei3)


def test_partial_slice_maps_onto_flax_shapes_cl4():
    """K5p's summed partial vector at nb = 16 (5 grades, 35 paths: 53
    per-channel rows a block) maps onto the 10 flax-shaped gradients,
    d sigmoid(a) chained."""
    kern = fe.fused_kernel(NB)
    g, npath = kern.n_grades, kern.n_paths
    assert (g, npath, kern.nloc) == (5, 35, 53)
    rng = np.random.RandomState(0)
    cin, c = 5, 3
    grads = [rng.randn(*s).astype(np.float32) for s in
             [(c, cin, g), (c, 1), (c, g), (c, g), (c, npath), (c, c, g),
              (c, g), (c, c, g), (c, 1), (c,)]]
    na = torch.from_numpy(rng.randn(c, g).astype(np.float32))

    def internal(w):   # flax (C, m, G) -> [(m*G+g)*C + n]
        return np.transpose(w, (1, 2, 0)).reshape(-1)

    loc = np.concatenate([grads[1].T, grads[2].T, grads[3].T, grads[4].T,
                          grads[6].T, grads[8].T, grads[9][None]], axis=0)
    flat_v = np.concatenate([internal(grads[0]), internal(grads[5]),
                             internal(grads[7]), loc.reshape(-1)])
    assert flat_v.size == fe.block_part_floats(kern, cin, c)
    got = fe._block_grads(torch.from_numpy(flat_v), cin, c, na, kern)
    s = torch.sigmoid(na)
    want = [torch.from_numpy(x) for x in grads]
    want[6] = want[6] * s * (1 - s)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        torch.testing.assert_close(a, b, msg=f"gradient {i}")


def test_cl4_kernel_tables():
    """nb = 16 takes the Cl(4) builds of K2p/K3p and K4p/K5p: their own
    sources, entry points and launch counters, the pair form's tables,
    Cl(4)'s grades and paths, 28 channels with windows of 16 targets; both
    sources are built with the others."""
    alg = get_algebra(CL4)
    kb, kf = ck.block_kernel(NB), fe.fused_kernel(NB)
    assert kb is ck.PAIR_CL4 and kf is fe.PAIR_CL4
    assert (kb.source, kb.symbol, kb.form) == (
        "cemlp_pair_cl4", "csmpn_cemlp_pair_cl4", "pair")
    assert (kf.source, kf.symbol, kf.form) == (
        "fused_egcl_pair_cl4", "csmpn_fused_mp_pair_cl4", "pair")
    for k in (kb, kf):
        assert (k.n_grades, k.n_paths) == (alg.n_subspaces,
                                           alg.n_product_paths)
    assert (kb.fwd, kb.bwd) == (ck.PAIR_CL4_FWD_LAUNCHES,
                                ck.PAIR_CL4_BWD_LAUNCHES)
    assert (kf.fwd, kf.bwd) == (fe.PAIR_CL4_FWD_LAUNCHES,
                                fe.PAIR_CL4_BWD_LAUNCHES)
    assert (kb.rows_fwd, kb.rows_bwd) == (16, 8)
    assert (kf.max_channels, kf.wn) == (28, 16)
    assert {"cemlp_pair_cl4", "fused_egcl_pair_cl4"} <= set(_build.SOURCES)
    params = ck.block_params(CEMLP(alg, 2, 3, 3, n_layers=1), 0)
    ck.check_block_params(params, 2, 3, torch.device("cpu"), kb)
    with pytest.raises(ValueError, match=r"\(3, 35\)"):
        ck.check_block_params(params[:4] + [torch.zeros(3, 56)]
                              + params[5:], 2, 3, torch.device("cpu"), kb)


def test_cl4_wrappers_on_cpu_take_plain_versions_and_count_nothing():
    """On CPU tensors the Cl(4) wrappers compute the plain versions, and no
    counter moves through them or through the bench stack at --dim 4."""
    counters = CL4_COUNTERS + (ck.PAIR_FWD_LAUNCHES, ck.PAIR_BWD_LAUNCHES,
                               fe.PAIR_FWD_LAUNCHES, fe.PAIR_BWD_LAUNCHES,
                               sk.LAUNCHES)
    for cnt in counters:
        cnt.reset()
    alg = get_algebra(CL4)
    x = torch.randn(5, 2, NB)
    t = CEMLP(alg, 2, 3, 3)
    params = ck.block_params(t, 0)
    out = ck.block_forward(x, params, alg, exact=True)
    torch.testing.assert_close(out, ck.block_forward_plain(x, params, alg))
    dx, grads = ck.block_backward(x, torch.ones_like(out), params, alg)
    assert dx.shape == x.shape and len(grads) == 10
    on_card = types.SimpleNamespace(is_cuda=True)
    assert not fe.fused_mp_supported(alg, t, x)
    k = flat._case(4, seed=9, n=12, e=20, ca=0)
    ps = ck.block_params(k.tm, 0) + ck.block_params(k.tm, 1)
    args = (torch.from_numpy(k.h), torch.from_numpy(k.hj), None,
            torch.from_numpy(k.dst).long(), torch.from_numpy(k.mask))
    torch.testing.assert_close(fe.mp_forward(ps, alg, *args),
                               fe.message_aggregate_plain(ps, alg, *args))
    seg.set_aggregation_mode("fast")
    assert fe.fused_mp_supported(alg, t, on_card)
    res = bench.run("cpu", steps=1, windows=1, n_nodes=12, n_edges=30,
                    batch=1, hidden=4, dim=4)
    assert res["inputs"][0].shape == (12, 4, NB)
    assert all(np.isfinite(v) for v in res["losses"])
    assert [cnt.count for cnt in counters] == [0] * len(counters)
