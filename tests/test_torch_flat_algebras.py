"""The port's flat EGCL path at Cl(2), Cl(4) and Cl(5) against the
reference package, on the CPU.

  * the plain K4/K5 at Cl(2) and Cl(4) and the plain K4p/K5p at Cl(5) (the
    CPU dispatch of ``fused_message_aggregate``) against the reference's
    Pallas kernels in interpret mode: sum/mean x attr/no-attr, masked,
    exact mode, forward and every gradient; fast-mode forward;
  * the port's EGCL with the fused dispatch forced on against the
    reference EGCL with its own forced on, at Cl(2) and Cl(5);
  * ``bench.Stack(dim=2|5)`` against a flax stack of the reference's
    EGCL at the same algebra, loss and every gradient;
  * ``bench.workload``: unchanged at Cl(3), (N, hidden, 2**dim) from the
    same stream elsewhere; the width table;
  * the gate on a stand-in card tensor: the kernels' algebras and widths
    are taken, Cl(1) and wider layers raise.

Tolerances: rtol 2e-4 / atol 1e-5 in exact fp32 (the reference's parity
tolerance and tests/test_fused_egcl.py's gradient tolerance); fast-mode
forward within 2e-2 of the output's max, as test_fused_mp_fast_mode_close
allows the reference.  Interpret mode at Cl(5) is slow, so the graphs are
small (E <= 150, C = 4).  The CUDA kernels are held to these plain
versions on the card by chip_smoke.py.
"""
import types

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from csmpn_tpu.algebra import get_algebra as jax_algebra
from csmpn_tpu.nn.egcl import EGCL as JEGCL
from csmpn_tpu.nn.modules import CEMLP as JCEMLP
from csmpn_tpu.ops import fused_egcl as jfe
from csmpn_tpu.ops import segment as jseg
from csmpn_torch import bench
from csmpn_torch.algebra import get_algebra
from csmpn_torch.convert import params_from_jax
from csmpn_torch.nn import CEMLP, EGCL
from csmpn_torch.ops import fused_egcl as fe
from csmpn_torch.ops import segment as seg

RTOL, ATOL = 2e-4, 1e-5
CL = {2: (1.0, 1.0), 4: (1.0,) * 4, 5: (1.0,) * 5}


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(
        got.detach().float().numpy() if isinstance(got, torch.Tensor)
        else got, np.asarray(want, np.float32), rtol=rtol, atol=atol,
        err_msg=msg)


@pytest.fixture(autouse=True)
def _exact_mode():
    seg.set_aggregation_mode("exact")
    jseg.set_aggregation_mode("exact")
    yield
    seg.set_aggregation_mode("exact")
    jseg.set_aggregation_mode("exact")


def _perturbed(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + 0.1 * rng.randn(*p.shape)
                              .astype(np.float32)), params)


def _case(dim, seed=0, n=40, e=90, cm=3, ca=2, c=4):
    """Inputs from numpy (masked), a flax edge CEMLP at Cl(dim, 0)
    perturbed away from its init, and the same port CEMLP."""
    metric = CL[dim]
    nb = 2 ** dim
    rng = np.random.RandomState(seed)
    dst = np.sort(rng.randint(0, n, size=e)).astype(np.int32)
    h = rng.randn(n, cm, nb).astype(np.float32)
    hj = rng.randn(e, cm, nb).astype(np.float32)
    attr = rng.randn(e, ca, nb).astype(np.float32) if ca else None
    mask = rng.rand(e) > 0.2
    jm = JCEMLP(jax_algebra(metric), cm + ca, c, c, fused=False)
    x0 = jnp.zeros((e, cm + ca, nb), jnp.float32)
    params = _perturbed(jm.init(jax.random.PRNGKey(seed), x0), seed + 1)
    tm = CEMLP(get_algebra(metric), cm + ca, c, c)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    cot = rng.randn(n, c, nb).astype(np.float32)
    return types.SimpleNamespace(jm=jm, params=params, tm=tm, h=h, hj=hj,
                                 attr=attr, dst=dst, mask=mask, cot=cot)


def _jax_fused(k, mean):
    def f(p, h, hj, attr):
        out = k.jm.apply(
            p, h, hj, attr, jnp.asarray(k.dst), jnp.asarray(k.mask),
            method=lambda m, *a: jfe.fused_message_aggregate(
                m, a[0], a[1], a[2], a[3], edge_mask=a[4], mean=mean,
                interpret=True))
        return jnp.sum(out * jnp.asarray(k.cot)), out
    return f


def _port(k, mean, grad=True):
    h = torch.from_numpy(k.h).requires_grad_(grad)
    hj = torch.from_numpy(k.hj).requires_grad_(grad)
    attr = (torch.from_numpy(k.attr).requires_grad_(grad)
            if k.attr is not None else None)
    k.tm.zero_grad()
    out = fe.fused_message_aggregate(
        k.tm, h, hj, attr, torch.from_numpy(k.dst).long(),
        torch.from_numpy(k.mask), mean=mean)
    if grad:
        (out * torch.from_numpy(k.cot)).sum().backward()
    return out, h.grad, hj.grad, None if attr is None else attr.grad


# ------------------------------------------- against the reference kernels

LAYOUTS = ["sum-attr", "sum-noattr", "mean-attr", "mean-noattr"]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dim", [2, 4, 5])
def test_plain_fused_matches_reference_kernels_exact(dim, layout):
    """Forward and every gradient (params, h, hj, attr) of the port's
    fused edge side on the CPU against the reference's fused kernels in
    interpret mode (the dense form at Cl(2), the pair form at Cl(4) and
    Cl(5)), masked, exact mode."""
    aggr, attr = layout.split("-")
    mean = aggr == "mean"
    k = _case(dim, seed=dim, ca=2 if attr == "attr" else 0)
    args = (k.params, jnp.asarray(k.h), jnp.asarray(k.hj),
            None if k.attr is None else jnp.asarray(k.attr))
    argnums = (0, 1, 2, 3) if k.attr is not None else (0, 1, 2)
    (_, j_out), j_grads = jax.value_and_grad(
        _jax_fused(k, mean), argnums=argnums, has_aux=True)(*args)
    out, dh, dhj, dattr = _port(k, mean)
    close(out, j_out, msg="output")
    close(dh, j_grads[1], msg="dh")
    close(dhj, j_grads[2], msg="dhj")
    if k.attr is not None:
        close(dattr, j_grads[3], msg="dattr")
    j_params = params_from_jax(jax.tree.map(np.asarray, j_grads[0]))
    for name, p in k.tm.named_parameters():
        close(p.grad, j_params[name].numpy(), msg=name)


@pytest.mark.parametrize("dim", [2, 4, 5])
def test_plain_fused_fast_matches_reference_kernel_fast(dim):
    k = _case(dim, seed=10 + dim)
    jseg.set_aggregation_mode("fast")
    j_out = _jax_fused(k, mean=True)(
        k.params, jnp.asarray(k.h), jnp.asarray(k.hj),
        jnp.asarray(k.attr))[1]
    seg.set_aggregation_mode("fast")
    with torch.no_grad():
        out = _port(k, True, grad=False)[0]
    scale = float(np.abs(np.asarray(j_out)).max())
    err = float(np.abs(out.numpy() - np.asarray(j_out)).max())
    assert err < 2e-2 * max(scale, 1.0), (err, scale)


# --------------------------------------------------- EGCL, forced dispatch

@pytest.mark.parametrize("dim", [2, 5])
def test_egcl_fused_dispatch_matches_reference(dim, monkeypatch):
    """Both EGCLs with the fused dispatch forced on (exact mode, CPU) at
    Cl(2) and Cl(5): the full layer with edge and node attributes and a
    mask, forward and every gradient."""
    monkeypatch.setattr(jfe, "fused_mp_supported", lambda *a: True)
    monkeypatch.setattr(fe, "fused_mp_supported", lambda *a: True)
    metric, nb = CL[dim], 2 ** dim
    rng = np.random.RandomState(30 + dim)
    n, e, c = 30, 80, 4
    dst = np.sort(rng.randint(0, n, size=e)).astype(np.int32)
    src = rng.randint(0, n, size=e).astype(np.int32)
    ei = np.stack([src, dst])
    h = rng.randn(n, c, nb).astype(np.float32)
    attr = rng.randn(e, 2, nb).astype(np.float32)
    nattr = rng.randn(n, 2, nb).astype(np.float32)
    mask = rng.rand(e) > 0.2
    g = rng.randn(n, c, nb).astype(np.float32)
    jl = JEGCL(jax_algebra(metric), c, c, c, edge_attr_features=2,
               node_attr_features=2, aggr="mean")
    jargs = (jnp.asarray(ei), jnp.asarray(attr), jnp.asarray(nattr))
    params = _perturbed(jl.init(jax.random.PRNGKey(dim), jnp.asarray(h),
                                *jargs), 4)

    def f(p, hh):
        out = jl.apply(p, hh, *jargs, edge_mask=jnp.asarray(mask))
        return jnp.sum(out * jnp.asarray(g)), out

    (_, j_out), (j_gp, j_gh) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(h))
    tl = EGCL(get_algebra(metric), c, c, c, edge_attr_features=2,
              node_attr_features=2, aggr="mean")
    tl.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    th = torch.from_numpy(h).requires_grad_(True)
    t_out = tl(th, torch.from_numpy(ei).long(), torch.from_numpy(attr),
               torch.from_numpy(nattr), edge_mask=torch.from_numpy(mask))
    (t_out * torch.from_numpy(g)).sum().backward()
    close(t_out, j_out)
    close(th.grad, j_gh)
    j_grads = params_from_jax(jax.tree.map(np.asarray, j_gp))
    for name, p in tl.named_parameters():
        close(p.grad, j_grads[name].numpy(), msg=name)


# ------------------------------------------------------------ bench stack

class _JaxStack(fnn.Module):
    """bench.py's flax Stack (defined inside its _jax_bench), at any
    algebra."""
    hidden: int
    layers: int
    src_sort: tuple
    metric: tuple

    @fnn.compact
    def __call__(self, h, ei):
        for i in range(self.layers):
            h = JEGCL(jax_algebra(self.metric), self.hidden, self.hidden,
                      self.hidden, aggr="mean", bf16_out=(i + 1 < self.layers),
                      name=f"egcl_{i}")(h, ei, src_sort=self.src_sort)
        return h


@pytest.mark.parametrize("dim", [2, 5])
def test_bench_stack_matches_reference_stack(dim):
    """The port's bench stack at Cl(dim) and hidden 4 on the bench's graph
    generator (2 graphs x 16 nodes x 48 edges): loss and every gradient
    against a flax stack of the reference's EGCL, exact mode."""
    hidden, layers = 4, 3
    h, ei, src_sort = bench.workload("cpu", n_nodes=16, n_edges=48, batch=2,
                                     hidden=hidden, dim=dim)
    j_sort = (jnp.asarray(src_sort[0].numpy().astype(np.int32)),
              jnp.asarray(src_sort[1].numpy().astype(np.int32)))
    jm = _JaxStack(hidden, layers, j_sort, CL[dim])
    jh, jei = jnp.asarray(h.numpy()), jnp.asarray(ei.numpy().astype(np.int32))
    params = _perturbed(jm.init(jax.random.PRNGKey(dim), jh, jei), 5)
    j_loss, j_grads = jax.value_and_grad(
        lambda p: jnp.mean(jm.apply(p, jh, jei) ** 2))(params)
    tm = bench.Stack(hidden, layers, dim=dim)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    loss = bench.loss_fn(tm(h, ei, src_sort))
    loss.backward()
    close(loss, j_loss)
    j_flat = params_from_jax(jax.tree.map(np.asarray, j_grads))
    names = [name for name, _ in tm.named_parameters()]
    assert sorted(names) == sorted(j_flat)
    for name, p in tm.named_parameters():
        close(p.grad, j_flat[name].numpy(), msg=name)


@pytest.mark.parametrize("dim", [2, 3, 4, 5])
def test_bench_workload_by_algebra(dim):
    """At Cl(3) the workload is byte for byte the default one; elsewhere
    the features are (N, hidden, 2**dim) from the same stream, after the
    same edges."""
    kw = dict(n_nodes=64, n_edges=256, batch=2, hidden=5)
    h, ei, (order, src_sorted) = bench.workload("cpu", dim=dim, **kw)
    h3, ei3, (order3, src3) = bench.workload("cpu", **kw)
    for a, b in ((ei, ei3), (order, order3), (src_sorted, src3)):
        assert torch.equal(a, b)
    rng = np.random.RandomState(0)
    for b in range(2):
        bench.synthetic_edges(rng, 64, 256)
    want = rng.randn(128, 5, 2 ** dim).astype(np.float32)
    np.testing.assert_array_equal(h.numpy(), want)
    if dim == 3:
        assert torch.equal(h, h3)


def test_bench_width_table_and_line():
    """--dim takes the widths of the tasks at each algebra (at Cl(4),
    which no task runs, the other pair-form algebra's); the CPU run's JSON
    line names the algebra and the width away from Cl(3)."""
    assert {d: w for d, (w, _) in bench.WIDTHS.items()} == {3: 32, 2: 40,
                                                            5: 28, 4: 28}
    seg.set_aggregation_mode("fast")
    res = bench.run("cpu", steps=1, windows=1, n_nodes=12, n_edges=30,
                    batch=1, hidden=4, dim=5)
    assert res["inputs"][0].shape == (12, 4, 32)
    assert all(np.isfinite(v) for v in res["losses"])
    with pytest.raises(ValueError, match="--dim"):
        bench.main(["--device=cpu", "--dim", "1"])


# --------------------------------------------------------------- the gate

def test_fused_gate_takes_the_kernels_algebras_and_widths():
    """On a stand-in card tensor in fast mode: True for K4/K5 at Cl(2)
    (C = 40, the NBA width) and Cl(3), and for K4p/K5p at Cl(5) and Cl(4)
    (C = 28, the hulls width); Cl(1) raises, naming the ROADMAP item, as
    does a width above each kernel's limit; the kernel table holds each
    algebra's own launch counters."""
    on_card = types.SimpleNamespace(is_cuda=True)
    seg.set_aggregation_mode("fast")
    algs = {d: get_algebra(m) for d, m in CL.items()}
    algs[3] = get_algebra((1.0, 1.0, 1.0))
    algs[1] = get_algebra((1.0,))
    for dim, c in ((2, 40), (3, 32), (4, 28), (5, 28)):
        assert fe.fused_mp_supported(algs[dim], CEMLP(algs[dim], c, c, c),
                                     on_card)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fe.fused_mp_supported(algs[1], CEMLP(algs[1], 4, 4, 4), on_card)
    for dim, c in ((2, 65), (3, 33), (4, 29), (5, 29)):
        with pytest.raises(NotImplementedError, match="at most"):
            fe.fused_mp_supported(algs[dim], CEMLP(algs[dim], 4, c, c),
                                  on_card)
    assert fe.fused_kernel(4) is fe.DENSE_CL2
    assert fe.fused_kernel(8) is fe.DENSE
    assert fe.fused_kernel(32) is fe.PAIR
    assert fe.fused_kernel(16) is fe.PAIR_CL4
    assert (fe.DENSE_CL2.fwd, fe.DENSE_CL2.bwd) == (fe.CL2_FWD_LAUNCHES,
                                                    fe.CL2_BWD_LAUNCHES)
    assert (fe.PAIR.fwd, fe.PAIR.bwd) == (fe.PAIR_FWD_LAUNCHES,
                                          fe.PAIR_BWD_LAUNCHES)
    assert (fe.PAIR_CL4.fwd, fe.PAIR_CL4.bwd) == (fe.PAIR_CL4_FWD_LAUNCHES,
                                                  fe.PAIR_CL4_BWD_LAUNCHES)
    assert [k.nloc for k in (fe.DENSE_CL2, fe.DENSE, fe.PAIR_CL4,
                             fe.PAIR)] == [22, 35, 53, 77]
    seg.set_aggregation_mode("exact")
    assert not fe.fused_mp_supported(algs[5], CEMLP(algs[5], 4, 4, 4),
                                     on_card)
