"""The plain versions of the port's kernels K1, K2 and K3 against the
reference package's kernels and layers, and the CPU dispatch of their
wrappers.

  * K1 (sorted segment sum) against ``sorted_segment_sum_pallas`` in
    Pallas interpret mode, as tests/test_segment_ops.py runs it;
  * K2 (CEMLP block forward) against the flat XLA oracle
    ``_block_flat_xla`` and the composed flax CEMLP;
  * K3 (CEMLP block backward) against ``jax.grad`` of the composed CEMLP;
  * K2 and K3 in fast mode against the body of the reference's kernel
    (``_forward_math`` with the dense tables, the rounding points of
    ``_fwd_kernel`` without Pallas) and its ``jax.vjp``, at C = 1, 2, 3, 8
    and 32.

Tolerances: rtol 2e-4 / atol 1e-5 in exact fp32 (the reference's parity
tolerance); K1 against the interpret-mode kernel rtol/atol 1e-4 as in
tests/test_segment_ops.py.  Fast mode as tests/test_torch_cl2_kernels.py:
both sides round the same operands to bf16, but a different fp32
summation order can move a value across a bf16 rounding boundary, so
1e-2 (forward) and 3e-2 (backward) of each tensor's largest magnitude.
The CUDA kernels themselves are held to these plain versions on the card
by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from csmpn_tpu.algebra import get_algebra as jax_algebra
from csmpn_tpu.nn.modules import CEMLP as JCEMLP
from csmpn_tpu.ops import cemlp_kernel as jck
from csmpn_tpu.ops import segment as jseg
from csmpn_tpu.ops.pallas_segment import sorted_segment_sum_pallas
from csmpn_torch.algebra import get_algebra
from csmpn_torch.convert import params_from_jax
from csmpn_torch.nn.modules import CEMLP
from csmpn_torch.ops import cemlp_kernel as ck
from csmpn_torch.ops import segment as seg
from csmpn_torch.ops import segment_kernel as sk

RTOL, ATOL = 2e-4, 1e-5
FAST_TOL = {"fwd": 1e-2, "bwd": 3e-2}
CL3 = (1.0, 1.0, 1.0)


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


# ----------------------------------------------------------------- K1

@pytest.mark.parametrize("shape,lo,exact", [
    ((500, 37, 17), 0, True),
    ((2048, 300, 224), 0, True),
    ((300, 600, 8), 500, True),      # empty leading blocks
    ((500, 37, 17), 0, False),
])
def test_plain_k1_matches_pallas_interpret(shape, lo, exact):
    e, n, d = shape
    rng = np.random.RandomState(3)
    ids = np.sort(rng.randint(lo, n, size=e)).astype(np.int32)
    x = rng.randn(e, d).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = sorted_segment_sum_pallas(jnp.asarray(x), jnp.asarray(ids), n,
                                         128, 1024, exact)
    got, counts = sk.sorted_segment_sum(torch.from_numpy(x),
                                        torch.from_numpy(ids), n, exact)
    close(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(ids, minlength=n))


def test_plain_k1_sentinels_mask_and_mean():
    rng = np.random.RandomState(5)
    e, n, d = 200, 30, 6
    ids = np.sort(rng.randint(0, n, size=e))
    ids[-15:] = n + 3                                  # sentinels, dropped
    mask = rng.rand(e) > 0.3
    x = rng.randn(e, d).astype(np.float32)
    out, counts = sk.sorted_segment_sum(
        torch.from_numpy(x), torch.from_numpy(ids), n, True,
        torch.from_numpy(mask), mean=True)
    keep = mask & (ids < n)
    ref = np.zeros((n, d), np.float32)
    np.add.at(ref, ids[keep], x[keep])
    cnt = np.bincount(ids[keep], minlength=n)
    close(out, ref / np.maximum(cnt, 1)[:, None])
    np.testing.assert_array_equal(counts.numpy(), cnt)


# ------------------------------------------------------------- K2 / K3

def _flax_cemlp(cin, hid, cout, n_layers, rows=11, seed=0):
    alg = jax_algebra(CL3)
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, cin, 8).astype(np.float32)
    m = JCEMLP(alg, cin, hid, cout, n_layers=n_layers, fused=False)
    params = m.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    params = jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + 0.1 * rng.randn(*p.shape)
                              .astype(np.float32)), params)
    return alg, m, params, x


def _port_cemlp(cin, hid, cout, n_layers, params):
    t = CEMLP(get_algebra(CL3), cin, hid, cout, n_layers=n_layers)
    t.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return t


@pytest.mark.parametrize("cin,cout", [(5, 4), (9, 7)])
def test_plain_k2_matches_block_flat_xla(cin, cout):
    alg, m, params, x = _flax_cemlp(cin, cout, cout, 1)
    bound = m.bind(params)
    lin_p = jck._round_up(cin * 8, 128)
    lp = jck._round_up(cout * 8, 128)
    tables = jck.block_tables(bound, 0, lin_p, lp)
    const = jck._structural_tables(3, CL3, cout, lp)
    xf = np.zeros((x.shape[0], lin_p), np.float32)
    xf[:, :cin * 8] = x.reshape(x.shape[0], -1)
    want = np.asarray(jax.jit(jck._block_flat_xla, static_argnums=3)(
        jnp.asarray(xf), tables, tuple(jnp.asarray(c) for c in const), 8))
    want = want[:, :cout * 8].reshape(-1, cout, 8)
    t = _port_cemlp(cin, cout, cout, 1, params)
    got = ck.block_forward_plain(torch.from_numpy(x), ck.block_params(t, 0),
                                 get_algebra(CL3), exact=True)
    close(got, want)
    close(got, jax.jit(m.apply)(params, jnp.asarray(x)))


def test_plain_k2_chain_matches_composed_cemlp():
    """apply_fused_cemlp (one block per layer, CPU plain versions) equals
    the flax composed CEMLP."""
    _, m, params, x = _flax_cemlp(6, 5, 4, 2)
    t = _port_cemlp(6, 5, 4, 2, params)
    seg.set_aggregation_mode("exact")
    close(ck.apply_fused_cemlp(t, torch.from_numpy(x)),
          jax.jit(m.apply)(params, jnp.asarray(x)))


def test_plain_k3_matches_jax_grad():
    """dx and all 10 parameter gradients of one block."""
    cin, c = 5, 4
    _, m, params, x = _flax_cemlp(cin, c, c, 1)
    g = np.random.RandomState(9).randn(x.shape[0], c, 8).astype(np.float32)

    def f(p, xx):
        return jnp.sum(m.apply(p, xx) * jnp.asarray(g))

    j_gp, j_gx = jax.jit(jax.grad(f, argnums=(0, 1)))(params, jnp.asarray(x))
    t = _port_cemlp(cin, c, c, 1, params)
    dx, grads = ck.block_backward(torch.from_numpy(x), torch.from_numpy(g),
                                  ck.block_params(t, 0), get_algebra(CL3),
                                  exact=True)
    close(dx, j_gx)
    j_grads = params_from_jax(jax.tree.map(np.asarray, j_gp))
    names = [k for k, _ in t.named_parameters()]
    assert len(names) == len(grads) == 10
    for k, gr in zip(names, grads):
        close(gr, j_grads[k].numpy(), msg=k)


def _fast_close(got, want, kind, msg=""):
    got = got.detach().numpy()
    want = np.asarray(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= FAST_TOL[kind], f"{msg}: rel err {err:.3e}"


def _jax_kernel_body(m, cin, c):
    """params, x (rows, cin, 8) -> the block output through the body of the
    reference's kernel (``_forward_math``, dense tables), fast mode."""
    lin_p = jck._round_up(cin * 8, 128)
    lp = jck._round_up(c * 8, 128)
    const = tuple(jnp.asarray(a) for a in
                  jck._structural_tables(3, CL3, c, lp))

    def run(params, x):
        rows = x.shape[0]
        xf = jnp.pad(x.reshape(rows, cin * 8), ((0, 0), (0, lin_p - cin * 8)))

        def body(mod):
            refs = tuple(jck.block_tables(mod, 0, lin_p, lp)) + const
            return jck._forward_math(xf, refs, 8, False)["out"]

        out = m.apply(params, method=body)
        return out[:, :c * 8].reshape(rows, c, 8)

    return run


@pytest.mark.parametrize("c", [1, 2, 3, 8, 32])
def test_plain_k2_k3_fast_match_kernel_body(c):
    """Plain K2 and K3 at Cl(3) in fast mode (the default of motion, MD17
    and the Cl(3) bench) against the reference kernel's body and its vjp:
    the output, dx and all 10 parameter gradients, at narrow C too (where
    the layer norm spans 1-3 channels)."""
    cin, rows = 6, 13
    _, m, params, x = _flax_cemlp(cin, c, c, 1, rows=rows, seed=c)
    g = np.random.RandomState(10 + c).randn(rows, c, 8).astype(np.float32)
    fn = _jax_kernel_body(m, cin, c)
    alg = get_algebra(CL3)
    t = _port_cemlp(cin, c, c, 1, params)
    got = ck.block_forward_plain(torch.from_numpy(x), ck.block_params(t, 0),
                                 alg, exact=False)
    _fast_close(got, jax.jit(fn)(params, jnp.asarray(x)), "fwd", "out")
    j_gp, j_gx = jax.jit(lambda p, xx, gg: jax.vjp(fn, p, xx)[1](gg))(
        params, jnp.asarray(x), jnp.asarray(g))
    dx, grads = ck.block_backward(torch.from_numpy(x), torch.from_numpy(g),
                                  ck.block_params(t, 0), alg, exact=False)
    _fast_close(dx, j_gx, "bwd", "dx")
    j_grads = params_from_jax(jax.tree.map(np.asarray, j_gp))
    names = [k for k, _ in t.named_parameters()]
    assert len(names) == len(grads) == 10
    for k, gr in zip(names, grads):
        _fast_close(gr, j_grads[k].numpy(), "bwd", k)


def test_cpu_wrappers_take_plain_versions_and_count_nothing():
    counters = (sk.LAUNCHES, ck.FWD_LAUNCHES, ck.BWD_LAUNCHES)
    for c in counters:
        c.reset()
    alg = get_algebra(CL3)
    x = torch.randn(10, 3, 8)
    t = CEMLP(alg, 3, 4, 4, n_layers=1)
    params = ck.block_params(t, 0)
    out = ck.block_forward(x, params, alg, exact=True)
    torch.testing.assert_close(out, ck.block_forward_plain(x, params, alg))
    ck.block_backward(x, torch.ones_like(out), params, alg, exact=True)
    ids = torch.tensor([0, 0, 2, 3])
    sk.sorted_segment_sum(torch.randn(4, 5), ids, 4)
    assert [c.count for c in counters] == [0, 0, 0]


# ------------------------------------------------- segment ops vs reference

def test_segment_ops_and_gathers_match_reference():
    """segment_sum/mean with a mask, segment_counts and the take_rows
    family (forward and gradient) against csmpn_tpu.ops.segment."""
    rng = np.random.RandomState(0)
    e, n, d = 40, 9, 3
    ids = np.sort(rng.randint(0, n, size=e)).astype(np.int32)
    mask = rng.rand(e) > 0.25
    x = rng.randn(e, d, 2).astype(np.float32)
    h = rng.randn(n, d, 2).astype(np.float32)
    src = rng.randint(0, n, size=e).astype(np.int32)
    g = rng.randn(e, d, 2).astype(np.float32)
    tx, tids, tmask = (torch.from_numpy(x), torch.from_numpy(ids).long(),
                       torch.from_numpy(mask))
    jx, jids, jmask = jnp.asarray(x), jnp.asarray(ids), jnp.asarray(mask)
    for t_fn, j_fn in ((seg.segment_sum, jseg.segment_sum),
                       (seg.segment_mean, jseg.segment_mean)):
        close(t_fn(tx, tids, n, True, tmask), j_fn(jx, jids, n, True, jmask))
        close(t_fn(tx, tids, n, False, tmask),
              j_fn(jx, jids, n, False, jmask))
    close(seg.sorted_segment_sum(tx, tids, n),
          jseg.sorted_segment_sum(jx, jids, n))
    close(seg.segment_counts(tids, n, tmask),
          jseg.segment_counts(jids, n, jmask))
    close(seg.segment_counts(tids, n), jseg.segment_counts(jids, n))
    order = np.argsort(src, kind="stable")
    for name, t_fn, j_fn, idx in (
            ("take_rows", seg.take_rows, jseg.take_rows, src),
            ("take_rows_sorted_idx", seg.take_rows_sorted_idx,
             jseg.take_rows_sorted_idx, ids)):
        th = torch.from_numpy(h).requires_grad_(True)
        out = t_fn(th, torch.from_numpy(idx).long())
        (out * torch.from_numpy(g)).sum().backward()
        jg = jax.grad(lambda hh: jnp.sum(j_fn(hh, jnp.asarray(idx))
                                         * jnp.asarray(g)))(jnp.asarray(h))
        close(out, np.asarray(h)[idx], msg=name)
        close(th.grad, jg, msg=name)
    th = torch.from_numpy(h).requires_grad_(True)
    out = seg.take_rows_presorted(th, torch.from_numpy(src).long(),
                                  torch.from_numpy(order),
                                  torch.from_numpy(src[order]).long())
    (out * torch.from_numpy(g)).sum().backward()
    jg = jax.grad(lambda hh: jnp.sum(jseg.take_rows_presorted(
        hh, jnp.asarray(src), jnp.asarray(order.astype(np.int32)),
        jnp.asarray(src[order])) * jnp.asarray(g)))(jnp.asarray(h))
    close(th.grad, jg)
    # batched_take, with its one-hot product backward
    hb = rng.randn(3, 5, 2).astype(np.float32)
    ib = rng.randint(0, 5, size=(3, 4, 2)).astype(np.int32)
    gb = rng.randn(3, 4, 2, 2).astype(np.float32)
    th = torch.from_numpy(hb).requires_grad_(True)
    out = seg.batched_take(th, torch.from_numpy(ib))
    (out * torch.from_numpy(gb)).sum().backward()
    jg = jax.grad(lambda hh: jnp.sum(jseg.batched_take(hh, jnp.asarray(ib))
                                     * jnp.asarray(gb)))(jnp.asarray(hb))
    close(out, jseg.batched_take(jnp.asarray(hb), jnp.asarray(ib)))
    close(th.grad, jg)
