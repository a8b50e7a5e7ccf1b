"""The port's fused message passing (K4/K5), its EGCL flat path and its
bench against the reference package, on the CPU.

  * the plain K4 and K5 (the CPU dispatch of ``fused_message_aggregate``)
    against the reference's Pallas kernels in interpret mode, exact mode
    forward and all gradients, and fast mode forward;
  * the same against the reference's composed path over the layouts of
    tests/test_fused_egcl.py (sum/mean x attr/no-attr, ids clustered at
    the ends, few edges over many windows);
  * the port's EGCL with the fused dispatch forced on against the
    reference EGCL with its own forced on;
  * the 3-layer bench stack against the reference bench's flax stack;
  * the CPU dispatch: plain versions, no launch counted, no build.

Tolerances: rtol 2e-4 / atol 1e-5 in exact fp32 (the reference's parity
tolerance and tests/test_fused_egcl.py's gradient tolerance); fast-mode
forward within 2e-2 of the output's max, as test_fused_mp_fast_mode_close
allows the reference.  The CUDA kernels themselves are held to these plain
versions on the card by chip_smoke.py.
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

import bench as jax_bench
from csmpn_tpu.algebra import get_algebra as jax_algebra
from csmpn_tpu.nn.egcl import EGCL as JEGCL
from csmpn_tpu.nn.modules import CEMLP as JCEMLP
from csmpn_tpu.ops import fused_egcl as jfe
from csmpn_tpu.ops import segment as jseg
from csmpn_torch import bench
from csmpn_torch.algebra import get_algebra
from csmpn_torch.convert import params_from_jax
from csmpn_torch.nn import CEMLP, EGCL
from csmpn_torch.ops import cemlp_kernel as ck
from csmpn_torch.ops import fused_egcl as fe
from csmpn_torch.ops import segment as seg
from csmpn_torch.ops import segment_kernel as sk

RTOL, ATOL = 2e-4, 1e-5
CL3 = (1.0, 1.0, 1.0)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _case(seed=0, n=150, e=300, cm=4, ca=2, c=4, dst=None, masked=True):
    """tests/test_fused_egcl.py's _setup: inputs from numpy, a flax edge
    CEMLP (perturbed away from its init) and the same port CEMLP."""
    alg = jax_algebra(CL3)
    rng = np.random.RandomState(seed)
    if dst is None:
        dst = np.sort(rng.randint(0, n, size=e))
    dst = dst.astype(np.int32)
    e = len(dst)
    h = rng.randn(n, cm, 8).astype(np.float32)
    hj = rng.randn(e, cm, 8).astype(np.float32)
    attr = rng.randn(e, ca, 8).astype(np.float32) if ca else None
    mask = (rng.rand(e) > 0.2) if masked else None
    jm = JCEMLP(alg, cm + ca, c, c, fused=False)
    x0 = jnp.zeros((e, cm + ca, 8), jnp.float32)
    params = _perturbed(jm.init(jax.random.PRNGKey(seed), x0), seed + 1)
    tm = CEMLP(get_algebra(CL3), cm + ca, c, c)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    cot = rng.randn(n, c, 8).astype(np.float32)
    return types.SimpleNamespace(jm=jm, params=params, tm=tm, h=h, hj=hj,
                                 attr=attr, dst=dst, mask=mask, cot=cot)


def _jax_fused(k, mean, interpret=True):
    def f(p, h, hj, attr):
        out = k.jm.apply(
            p, h, hj, attr, jnp.asarray(k.dst),
            None if k.mask is None else jnp.asarray(k.mask),
            method=lambda m, *a: jfe.fused_message_aggregate(
                m, a[0], a[1], a[2], a[3], edge_mask=a[4], mean=mean,
                interpret=interpret))
        return jnp.sum(out * jnp.asarray(k.cot)), out
    return f


def _jax_composed(k, mean):
    def f(p, h, hj, attr):
        dst = jnp.asarray(k.dst)
        x = h[dst] - hj
        if attr is not None:
            x = jnp.concatenate([x, attr], axis=1)
        reduce = jseg.segment_mean if mean else jseg.segment_sum
        out = reduce(k.jm.apply(p, x), dst, h.shape[0],
                     indices_are_sorted=True,
                     mask=None if k.mask is None else jnp.asarray(k.mask))
        return jnp.sum(out * jnp.asarray(k.cot)), out
    return f


def _jax_value_grads(f, k):
    args = (k.params, jnp.asarray(k.h), jnp.asarray(k.hj),
            None if k.attr is None else jnp.asarray(k.attr))
    argnums = (0, 1, 2, 3) if k.attr is not None else (0, 1, 2)
    (_, out), grads = jax.value_and_grad(f, argnums=argnums,
                                         has_aux=True)(*args)
    return out, grads


def _port_value_grads(k, mean):
    h = torch.from_numpy(k.h).requires_grad_(True)
    hj = torch.from_numpy(k.hj).requires_grad_(True)
    attr = (torch.from_numpy(k.attr).requires_grad_(True)
            if k.attr is not None else None)
    k.tm.zero_grad()
    out = fe.fused_message_aggregate(
        k.tm, h, hj, attr, torch.from_numpy(k.dst).long(),
        None if k.mask is None else torch.from_numpy(k.mask), mean=mean)
    (out * torch.from_numpy(k.cot)).sum().backward()
    return out, h.grad, hj.grad, None if attr is None else attr.grad


def _assert_grads_match(k, mean, j_grads):
    out, dh, dhj, dattr = _port_value_grads(k, mean)
    close(dh, j_grads[1], msg="dh")
    close(dhj, j_grads[2], msg="dhj")
    if k.attr is not None:
        close(dattr, j_grads[3], msg="dattr")
    j_params = params_from_jax(jax.tree.map(np.asarray, j_grads[0]))
    for name, p in k.tm.named_parameters():
        close(p.grad, j_params[name].numpy(), msg=name)
    return out


# ------------------------------------------- against the reference kernels

def test_plain_k4_k5_match_reference_kernels_exact():
    """Forward and every gradient (params, h, hj, attr) of the plain K4/K5
    against the reference's K4/K5 in interpret mode, mean, masked."""
    k = _case()
    j_out, j_grads = _jax_value_grads(_jax_fused(k, mean=True), k)
    out = _assert_grads_match(k, True, j_grads)
    close(out, j_out)


def test_plain_k4_fast_matches_reference_kernel_fast():
    k = _case()
    jseg.set_aggregation_mode("fast")
    j_out = _jax_fused(k, mean=True)(
        k.params, jnp.asarray(k.h), jnp.asarray(k.hj),
        jnp.asarray(k.attr))[1]
    seg.set_aggregation_mode("fast")
    with torch.no_grad():
        out = fe.fused_message_aggregate(
            k.tm, torch.from_numpy(k.h), torch.from_numpy(k.hj),
            torch.from_numpy(k.attr), torch.from_numpy(k.dst).long(),
            torch.from_numpy(k.mask), mean=True)
    scale = float(np.abs(np.asarray(j_out)).max())
    err = float(np.abs(out.numpy() - np.asarray(j_out)).max())
    assert err < 2e-2 * max(scale, 1.0), (err, scale)


# ---------------------------------- against the reference composed path

def _clustered():
    rng = np.random.RandomState(11)
    return np.sort(np.concatenate([rng.randint(0, 20, size=128),
                                   rng.randint(400 - 20, 400, size=128)]))


@pytest.mark.parametrize("layout", [
    "sum-attr", "sum-noattr", "mean-attr", "mean-noattr",
    "clustered-ids", "few-edges-many-windows"])
def test_plain_fused_matches_reference_composed(layout):
    if layout == "clustered-ids":      # windows in the middle are empty
        k, mean = _case(seed=11, n=400, ca=0, dst=_clustered(),
                        masked=False), False
    elif layout == "few-edges-many-windows":
        k, mean = _case(seed=23, n=900, e=60, ca=0, masked=False), False
    else:
        aggr, attr = layout.split("-")
        k, mean = _case(ca=2 if attr == "attr" else 0), aggr == "mean"
    j_out, j_grads = _jax_value_grads(jax.jit(_jax_composed(k, mean)), k)
    out = _assert_grads_match(k, mean, j_grads)
    close(out, j_out)


# --------------------------------------------------- EGCL, forced dispatch

def test_egcl_fused_dispatch_matches_reference(monkeypatch):
    """Both EGCLs with the fused dispatch forced on (exact mode, CPU): the
    full layer with edge and node attributes and a mask, forward and every
    gradient, and message_aggregate alone."""
    monkeypatch.setattr(jfe, "fused_mp_supported", lambda *a: True)
    monkeypatch.setattr(fe, "fused_mp_supported", lambda *a: True)
    rng = np.random.RandomState(3)
    n, e, c = 100, 260, 4
    dst = np.sort(rng.randint(0, n, size=e)).astype(np.int32)
    src = rng.randint(0, n, size=e).astype(np.int32)
    ei = np.stack([src, dst])
    h = rng.randn(n, c, 8).astype(np.float32)
    attr = rng.randn(e, 2, 8).astype(np.float32)
    nattr = rng.randn(n, 2, 8).astype(np.float32)
    mask = rng.rand(e) > 0.2
    g = rng.randn(n, c, 8).astype(np.float32)
    jl = JEGCL(jax_algebra(CL3), c, c, c, edge_attr_features=2,
               node_attr_features=2, aggr="mean")
    jargs = (jnp.asarray(ei), jnp.asarray(attr), jnp.asarray(nattr))
    params = _perturbed(jl.init(jax.random.PRNGKey(0), jnp.asarray(h),
                                *jargs), 4)

    def f(p, hh):
        out = jl.apply(p, hh, *jargs, edge_mask=jnp.asarray(mask))
        return jnp.sum(out * jnp.asarray(g)), out

    (_, j_out), (j_gp, j_gh) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(h))
    tl = EGCL(get_algebra(CL3), c, c, c, edge_attr_features=2,
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
    hj = h[src]
    j_ma = jl.apply(params, jnp.asarray(h), jnp.asarray(hj),
                    jnp.asarray(attr), jnp.asarray(dst), n,
                    jnp.asarray(mask), method=JEGCL.message_aggregate)
    with torch.no_grad():
        t_ma = tl.message_aggregate(torch.from_numpy(h), torch.from_numpy(hj),
                                    torch.from_numpy(attr),
                                    torch.from_numpy(dst).long(), n,
                                    torch.from_numpy(mask))
    close(t_ma, j_ma)


# ------------------------------------------------------------ bench stack

class _JaxStack(fnn.Module):
    """bench.py's flax Stack (defined inside its _jax_bench)."""
    hidden: int
    layers: int
    src_sort: tuple

    @fnn.compact
    def __call__(self, h, ei):
        for i in range(self.layers):
            h = JEGCL(jax_algebra(CL3), self.hidden, self.hidden,
                      self.hidden, aggr="mean", bf16_out=(i + 1 < self.layers),
                      name=f"egcl_{i}")(h, ei, src_sort=self.src_sort)
        return h


def test_bench_stack_matches_reference_stack():
    """The port's bench stack at hidden 4 on the bench's graph generator
    (2 graphs x 24 nodes x 90 edges): loss and every gradient against the
    reference bench's flax stack, exact mode."""
    hidden, layers = 4, 3
    h, ei, src_sort = bench.workload("cpu", n_nodes=24, n_edges=90, batch=2,
                                     hidden=hidden)
    j_sort = (jnp.asarray(src_sort[0].numpy().astype(np.int32)),
              jnp.asarray(src_sort[1].numpy().astype(np.int32)))
    jm = _JaxStack(hidden, layers, j_sort)
    jh, jei = jnp.asarray(h.numpy()), jnp.asarray(ei.numpy().astype(np.int32))
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jh, jei), 5)
    j_loss, j_grads = jax.value_and_grad(
        lambda p: jnp.mean(jm.apply(p, jh, jei) ** 2))(params)
    tm = bench.Stack(hidden, layers)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    loss = bench.loss_fn(tm(h, ei, src_sort))
    loss.backward()
    close(loss, j_loss)
    j_flat = params_from_jax(jax.tree.map(np.asarray, j_grads))
    names = [name for name, _ in tm.named_parameters()]
    assert sorted(names) == sorted(j_flat)
    for name, p in tm.named_parameters():
        close(p.grad, j_flat[name].numpy(), msg=name)


def test_bench_workload_is_the_reference_bench_graph():
    h, ei, (order, src_sorted) = bench.workload("cpu")
    rng = np.random.RandomState(0)
    ref = np.concatenate([jax_bench._synthetic_edges(rng, 2048, 32768)
                          + b * 2048 for b in range(4)], axis=1)
    np.testing.assert_array_equal(ei.numpy(), ref)
    np.testing.assert_array_equal(h.numpy(), rng.randn(4 * 2048, 32, 8)
                                  .astype(np.float32))
    np.testing.assert_array_equal(src_sorted.numpy(), ref[0][order.numpy()])
    assert np.all(np.diff(src_sorted.numpy()) >= 0)
    assert np.all(np.diff(ei[1].numpy()) >= 0)


def test_bench_on_cpu_gives_finite_edges_per_s():
    seg.set_aggregation_mode("fast")
    res = bench.run("cpu", steps=2, windows=2, n_nodes=16, n_edges=48,
                    batch=2, hidden=4)
    assert np.isfinite(res["edges_per_s"]) and res["edges_per_s"] > 0
    assert len(res["step_times_s"]) == 4
    assert all(np.isfinite(v) for v in res["losses"])
    assert bench.device_name(torch.device("cpu")) == "cpu"


def test_bench_main_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main([])


# --------------------------------------------------------------- dispatch

def test_cpu_dispatch_takes_plain_versions_and_counts_nothing():
    """On CPU tensors fused_mp_supported is false in both modes, the
    wrappers compute the plain versions, and no counter moves through a
    fused call, a forced fused EGCL layer or the bench stack at Cl(2),
    Cl(3), Cl(4) and Cl(5)."""
    counters = (fe.FWD_LAUNCHES, fe.BWD_LAUNCHES, fe.CL2_FWD_LAUNCHES,
                fe.CL2_BWD_LAUNCHES, fe.PAIR_FWD_LAUNCHES,
                fe.PAIR_BWD_LAUNCHES, fe.PAIR_CL4_FWD_LAUNCHES,
                fe.PAIR_CL4_BWD_LAUNCHES, sk.LAUNCHES, ck.FWD_LAUNCHES,
                ck.BWD_LAUNCHES, ck.CL2_FWD_LAUNCHES, ck.CL2_BWD_LAUNCHES,
                ck.PAIR_FWD_LAUNCHES, ck.PAIR_BWD_LAUNCHES,
                ck.PAIR_CL4_FWD_LAUNCHES, ck.PAIR_CL4_BWD_LAUNCHES)
    for cnt in counters:
        cnt.reset()
    alg = get_algebra(CL3)
    m = CEMLP(alg, 4, 4, 4)
    h = torch.randn(6, 4, 8)
    for mode in ("exact", "fast"):
        seg.set_aggregation_mode(mode)
        assert not fe.fused_mp_supported(alg, m, h)
    k = _case(n=20, e=40, ca=0)
    params = ck.block_params(k.tm, 0) + ck.block_params(k.tm, 1)
    args = (torch.from_numpy(k.h), torch.from_numpy(k.hj), None,
            torch.from_numpy(k.dst).long(), torch.from_numpy(k.mask))
    torch.testing.assert_close(
        fe.mp_forward(params, alg, *args),
        fe.message_aggregate_plain(params, alg, *args))
    dagg = torch.from_numpy(k.cot)
    got = fe.mp_backward(params, alg, *args, dagg)
    want = fe.message_aggregate_grad_plain(params, alg, *args, dagg)
    for a, b in zip(got[:2] + tuple(got[3]), want[:2] + tuple(want[3])):
        torch.testing.assert_close(a, b)
    seg.set_aggregation_mode("fast")
    for dim in (2, 3, 4, 5):
        bench.run("cpu", steps=1, windows=1, n_nodes=12, n_edges=30,
                  batch=1, hidden=4, dim=dim)
    assert [cnt.count for cnt in counters] == [0] * len(counters)


def test_fused_mp_supported_raises_on_the_card_for_other_algebras():
    """The gate gives way to the composed path only for an edge model the
    fused pass does not compute; an algebra or a width the kernels are not
    compiled for raises on the card (a stand-in tensor says it is on it):
    Cl(4) takes K4p/K5p at Cl(4), Cl(1) raises."""
    on_card = types.SimpleNamespace(is_cuda=True)
    seg.set_aggregation_mode("fast")
    alg3, alg4 = get_algebra(CL3), get_algebra((1.0,) * 4)
    alg1 = get_algebra((1.0,))
    assert fe.fused_mp_supported(alg3, CEMLP(alg3, 4, 4, 4), on_card)
    assert not fe.fused_mp_supported(alg3, CEMLP(alg3, 4, 6, 4), on_card)
    assert not fe.fused_mp_supported(alg3, CEMLP(alg3, 4, 4, 4, n_layers=3),
                                     on_card)
    assert fe.fused_mp_supported(alg4, CEMLP(alg4, 4, 4, 4), on_card)
    with pytest.raises(NotImplementedError):
        fe.fused_mp_supported(alg1, CEMLP(alg1, 4, 4, 4), on_card)
    with pytest.raises(NotImplementedError):
        fe.fused_mp_supported(alg3, CEMLP(alg3, 4, 40, 40), on_card)
    seg.set_aggregation_mode("exact")
    assert not fe.fused_mp_supported(alg3, CEMLP(alg3, 4, 4, 4), on_card)


@pytest.mark.parametrize("nb", [4, 8, 32])
def test_partial_slice_maps_onto_flax_shapes(nb):
    """K5's summed partial vector (layout in csrc/fused_egcl.cu and
    csrc/fused_egcl_pair.cu) maps onto the 10 flax-shaped gradients of each
    block, d sigmoid(a) chained, at Cl(2), Cl(3) and Cl(5) (G grades, P
    paths)."""
    kern = fe.fused_kernel(nb)
    g, npath = kern.n_grades, kern.n_paths
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
    assert loc.shape == (kern.nloc, c)
    flat = np.concatenate([internal(grads[0]), internal(grads[5]),
                           internal(grads[7]), loc.reshape(-1)])
    assert flat.size == fe.block_part_floats(kern, cin, c)
    got = fe._block_grads(torch.from_numpy(flat), cin, c, na, kern)
    s = torch.sigmoid(na)
    want = [torch.from_numpy(g) for g in grads]
    want[6] = want[6] * s * (1 - s)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        torch.testing.assert_close(a, b, msg=f"gradient {i}")


def test_fused_module_imports_and_runs_on_cpu_without_nvcc(tmp_path):
    code = (
        "import torch\n"
        "from csmpn_torch.algebra import get_algebra\n"
        "from csmpn_torch.nn import CEMLP\n"
        "from csmpn_torch.ops import fused_egcl as fe\n"
        "m = CEMLP(get_algebra((1.0, 1.0, 1.0)), 3, 4, 4)\n"
        "out = fe.fused_message_aggregate(m, torch.randn(5, 3, 8), "
        "torch.randn(7, 3, 8), None, torch.tensor([0, 0, 1, 2, 2, 4, 4]), "
        "mean=True)\n"
        "assert out.shape == (5, 4, 8) and bool(torch.isfinite(out).all())\n"
        "print('ok')\n")
    env = {"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path),
           "HOME": str(tmp_path), "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")
