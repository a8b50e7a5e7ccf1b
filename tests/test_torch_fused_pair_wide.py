"""The EGCL edge side in its pair form at the widths K4p/K5p do not take
(K4pw and K5pw on the card: every C <= 64 channels and Cm + Ca <= 160
message + attribute channels, at Cl(5,0) and Cl(4,0)) against the
reference package, and the routing of a call between the K4p/K5p of
csrc/fused_egcl_pair.cuh and the wide ones.

  * the plain K4pw/K5pw (the CPU dispatch of ``fused_message_aggregate``)
    against the reference's fused kernels in interpret mode, exact mode,
    masked, the output and every gradient (h, hj, attr, the 20
    parameters): Cl(5) at Cm 36 + Ca 4 -> 36 (mean), Cl(4) at 64 -> 64
    (sum), Cl(5) at 28 + 12 -> 28 (mean; an attribute width K4p's exact
    plan refuses); the fast-mode forward at Cl(5) 36 -> 36 against the
    reference kernel's fast mode;
  * ``fused_route`` and ``fused_mp_supported`` for the pair form with the
    libraries' size entries stood in: K4p/K5p where every entry of the
    mode takes the widths in both directions, K4pw/K5pw where one refuses
    (up to 64 channels and 160 message + attribute channels),
    NotImplementedError naming the range at C = 65 and at Cm + Ca = 161;
  * the plan's window is the route's; a call on the card launches K4pw
    (K5pw) once and counts one; the CPU dispatch counts nothing.

Tolerances: rtol 2e-4 / atol 1e-5 in exact fp32 (the reference's parity
tolerance), atol taken of each tensor's largest magnitude where that
exceeds 1, as tests/test_torch_fused_wide.py; the fast-mode forward within
2e-2 of the output's max, as
test_plain_fused_fast_matches_reference_kernel_fast allows.  One reference
call in interpret mode at these widths takes several seconds, so the graphs
are small (24 targets, 64 edges).  The CUDA kernels are held to these plain
versions on the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_flat_algebras as flat
import test_torch_fused_wide as fw
from csmpn_torch.algebra import get_algebra
from csmpn_torch.convert import params_from_jax
from csmpn_torch.nn import CEMLP
from csmpn_torch.ops import fused_egcl as fe
from csmpn_torch.ops import segment as seg
from csmpn_tpu.ops import segment as jseg
from csmpn_torch.ops.cemlp_kernel import block_params

PAIRS = [fe.PAIR, fe.PAIR_CL4]
CL = {5: (1.0,) * 5, 4: (1.0,) * 4}


@pytest.fixture(autouse=True)
def _exact_mode():
    seg.set_aggregation_mode("exact")
    jseg.set_aggregation_mode("exact")
    yield
    seg.set_aggregation_mode("exact")
    jseg.set_aggregation_mode("exact")


@pytest.fixture(autouse=True)
def _fresh_caches():
    yield
    for f in (fe._check_smem, fe._check_tile_smem, fe._wide_range):
        f.cache_clear()


# ------------------------------------------- against the reference kernels

@pytest.mark.parametrize("dim,cm,ca,c,mean", [
    (5, 36, 4, 36, True), (4, 64, 0, 64, False), (5, 28, 12, 28, True)],
    ids=["cl5-36+4-mean", "cl4-64-sum", "cl5-28+12-mean"])
def test_plain_pair_wide_fused_matches_reference_kernels_exact(dim, cm, ca,
                                                               c, mean):
    """The output, dh, dhj, dattr and every parameter gradient of the
    port's edge side on the CPU against the reference's fused kernels in
    interpret mode under jax.value_and_grad, masked, exact mode."""
    k = flat._case(dim, seed=50 + c, n=24, e=64, cm=cm, ca=ca, c=c)
    args = (k.params, jnp.asarray(k.h), jnp.asarray(k.hj),
            None if k.attr is None else jnp.asarray(k.attr))
    argnums = (0, 1, 2, 3) if k.attr is not None else (0, 1, 2)
    (_, j_out), j_grads = jax.value_and_grad(
        flat._jax_fused(k, mean), argnums=argnums, has_aux=True)(*args)
    out, dh, dhj, dattr = flat._port(k, mean)
    fw.close(out, j_out, msg="output")
    fw.close(dh, j_grads[1], msg="dh")
    fw.close(dhj, j_grads[2], msg="dhj")
    if k.attr is not None:
        fw.close(dattr, j_grads[3], msg="dattr")
    j_params = params_from_jax(jax.tree.map(np.asarray, j_grads[0]))
    for name, p in k.tm.named_parameters():
        fw.close(p.grad, j_params[name].numpy(), msg=name)


def test_plain_pair_wide_fused_fast_matches_reference_kernel_fast():
    k = flat._case(5, seed=7, n=24, e=64, cm=36, ca=0, c=36)
    jseg.set_aggregation_mode("fast")
    j_out = flat._jax_fused(k, mean=True)(
        k.params, jnp.asarray(k.h), jnp.asarray(k.hj), None)[1]
    seg.set_aggregation_mode("fast")
    with torch.no_grad():
        out = flat._port(k, True, grad=False)[0]
    scale = float(np.abs(np.asarray(j_out)).max())
    err = float(np.abs(out.numpy() - np.asarray(j_out)).max())
    assert err < 2e-2 * max(scale, 1.0), (err, scale)


# ----------------------------------------------------------------- routing

ENTRIES = fw.ENTRIES


def _stand_in(monkeypatch, refuse=(), narrow_c=28):
    """Both libraries' entries: K4p/K5p's size entries take C <= narrow_c
    except the entries named in ``refuse``; K4pw/K5pw's take C <= 64 and
    Cm + Ca <= 160 and say so through their range entry; their fwd and
    bwd entries succeed.  Returns the wide entries by name."""
    def narrow(name):
        def size(cm, ca, c, wn, *backward):
            key = (f"{name}_{'bwd' if backward[0] else 'fwd'}"
                   if name == "smem_bytes" else name)
            return 0 if key in refuse or c > narrow_c else 1000
        return fw._Fn(size)

    def wide_range(out):
        out[0], out[1] = 64, 160

    wide = {"smem_bytes": fw._Fn(lambda cm, ca, c, b: 120_000
                                 if 1 <= c <= 64 and cm + ca <= 160 else 0),
            "range": fw._Fn(wide_range),
            "scratch_bytes": fw._Fn(lambda *a: 4096),
            "fwd": fw._Fn(lambda *a: 0), "bwd": fw._Fn(lambda *a: 0)}
    fns = {n: narrow(n) for n in ("smem_bytes", "fwd_tile_smem_bytes",
                                  "tile_smem_bytes")}
    monkeypatch.setattr(fe, "_lib_fn", lambda k, name, *a: (
        wide if k in fe._WIDE else fns)[name])
    for f in (fe._check_smem, fe._check_tile_smem, fe._wide_range):
        f.cache_clear()
    return wide


def test_pair_wide_kernels_share_the_algebra_and_count_apart():
    for kern in PAIRS:
        wide = fe.WIDE_OF[kern.n_blades]
        assert wide in fe._WIDE and wide.form == "pair"
        assert (wide.n_blades, wide.n_grades, wide.n_paths, wide.nloc) == (
            kern.n_blades, kern.n_grades, kern.n_paths, kern.nloc)
        assert (wide.max_channels, wide.wn) == (0, 1)
    assert (fe.PAIR_WIDE.fwd, fe.PAIR_WIDE.bwd) == (
        fe.PAIR_WIDE_FWD_LAUNCHES, fe.PAIR_WIDE_BWD_LAUNCHES)
    assert (fe.PAIR_WIDE_CL4.fwd, fe.PAIR_WIDE_CL4.bwd) == (
        fe.PAIR_WIDE_CL4_FWD_LAUNCHES, fe.PAIR_WIDE_CL4_BWD_LAUNCHES)
    names = {c.name for k in fe._WIDE for c in (k.fwd, k.bwd)}
    assert len(names) == 2 * len(fe._WIDE)


@pytest.mark.parametrize("kern", PAIRS, ids=lambda k: k.label)
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_route_keeps_k4p_k5p_where_every_entry_takes(monkeypatch, kern,
                                                     exact):
    _stand_in(monkeypatch)
    for cm, ca, c in [(28, 0, 28), (28, 6, 28), (4, 0, 1), (40, 9, 16)]:
        assert fe.fused_route(kern, cm, ca, c, exact) is kern


@pytest.mark.parametrize("kern", PAIRS, ids=lambda k: k.label)
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("refuse", ENTRIES)
def test_route_takes_k4pw_where_an_entry_refuses(monkeypatch, kern, exact,
                                                 refuse):
    """One entry of K4p/K5p refusing, in either direction, sends the call
    (forward and backward alike) to K4pw/K5pw of the same algebra; the
    tile entries are asked in fast mode only."""
    _stand_in(monkeypatch, refuse=(refuse,))
    asked = refuse.startswith("smem") or not exact
    assert fe.fused_route(kern, 28, 12, 28, exact) is (
        fe.WIDE_OF[kern.n_blades] if asked else kern)


@pytest.mark.parametrize("kern", PAIRS, ids=lambda k: k.label)
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_route_takes_k4pw_up_to_its_range_and_raises_past_it(monkeypatch,
                                                             kern, exact):
    _stand_in(monkeypatch)
    wide = fe.WIDE_OF[kern.n_blades]
    for cm, ca, c in [(29, 0, 29), (36, 4, 36), (64, 0, 64), (128, 0, 64),
                      (96, 64, 64), (150, 10, 40)]:
        assert fe.fused_route(kern, cm, ca, c, exact) is wide
    for cm, ca, c in [(65, 0, 65), (64, 0, 65), (158, 3, 64), (161, 0, 32)]:
        with pytest.raises(NotImplementedError,
                           match="K4pw/K5pw.* take at most 64 channels and "
                                 "160 message"):
            fe.fused_route(kern, cm, ca, c, exact)


def test_gate_takes_the_pair_form_up_to_the_range(monkeypatch):
    """fused_mp_supported on a stand-in card tensor in fast mode: the pair
    form at Cl(5) and Cl(4) up to K4pw/K5pw's 64 channels (their range
    entry stood in), NotImplementedError naming the range and the ROADMAP
    item past it."""
    _stand_in(monkeypatch)
    on_card = type("OnCard", (), {"is_cuda": True})()
    seg.set_aggregation_mode("fast")
    for dim in (5, 4):
        alg = get_algebra(CL[dim])
        for c in (28, 29, 36, 48, 64):
            assert fe.fused_mp_supported(alg, CEMLP(alg, 4, c, c), on_card)
        with pytest.raises(NotImplementedError,
                           match="take at most 64 channels \\(and 160 "
                                 "message.*ROADMAP Queue 2"):
            fe.fused_mp_supported(alg, CEMLP(alg, 4, 65, 65), on_card)


def _inputs(dim, cm, ca, c, n=70, e=40, seed=3):
    nb = 2 ** dim
    em = CEMLP(get_algebra(CL[dim]), cm + ca, c, c)
    params = [fw._on_card(p.detach()) for p in block_params(em, 0)
              + block_params(em, 1)]
    gen = torch.Generator().manual_seed(seed)
    dst = torch.sort(torch.randint(0, n, (e,), generator=gen)).values
    ins = [torch.randn(n, cm, nb, generator=gen),
           torch.randn(e, cm, nb, generator=gen),
           torch.randn(e, ca, nb, generator=gen) if ca else None, dst]
    dagg = torch.randn(n, c, nb, generator=gen)
    return (params, [None if t is None else fw._on_card(t) for t in ins],
            fw._on_card(dagg))


@pytest.mark.parametrize("dim", [5, 4])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_plan_window_is_the_routes(monkeypatch, dim, exact):
    """K4p/K5p's plan cuts the targets into windows of 4 (Cl(5)) or 16
    (Cl(4)), K4pw/K5pw's into single targets (bounds[v] is target v's
    first edge); each plan names its kernels, and a plan of one route is
    refused by the other's kernels."""
    _stand_in(monkeypatch)
    fw._card(monkeypatch)
    nb, n = 2 ** dim, 70
    kern = fe.fused_kernel(nb)
    dst = torch.sort(torch.randint(0, n, (200,),
                                   generator=torch.Generator()
                                   .manual_seed(1))).values
    narrow = fe.make_plan(dst, None, n, 28, 0, 28, nb, exact)
    wide = fe.make_plan(dst, None, n, 64, 0, 64, nb, exact)
    assert narrow.kern is kern and narrow.n_win == -(-n // kern.wn)
    assert wide.kern is fe.WIDE_OF[nb] and wide.n_win == n
    want = torch.searchsorted(dst.to(torch.int32),
                              torch.arange(n + 1, dtype=torch.int32))
    assert torch.equal(wide.bounds, want.to(torch.int64))
    params, (h, hj, attr, d), dagg = _inputs(dim, 64, 0, 64)
    with pytest.raises(ValueError, match="made for K4p/K5p"):
        fe.mp_forward(params, get_algebra(CL[dim]), h, hj, attr, d, None,
                      exact, narrow)
    params, (h, hj, attr, d), dagg = _inputs(dim, 28, 0, 28)
    with pytest.raises(ValueError, match="made for K4pw/K5pw"):
        fe.mp_backward(params, get_algebra(CL[dim]), h, hj, attr, d, None,
                       dagg, exact, wide)


@pytest.mark.parametrize("dim", [5, 4])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_card_pair_wide_calls_launch_once_and_count_one(monkeypatch, dim,
                                                        exact):
    """On the card a call past K4p/K5p's widths launches K4pw's (K5pw's)
    entry once with the call's counts, its scratch from the scratch entry,
    and counts one launch on its own counter alone; the backward's vector
    splits into the 20 gradients in flax shapes."""
    wide = _stand_in(monkeypatch)
    fw._card(monkeypatch)
    kern = fe.WIDE_OF[2 ** dim]
    params, (h, hj, attr, dst), dagg = _inputs(dim, 36, 5, 36)
    alg = get_algebra(CL[dim])
    counters = [c for k in fe._WIDE + tuple(PAIRS) for c in (k.fwd, k.bwd)]
    before = [cnt.count for cnt in counters]
    out = fe.mp_forward(params, alg, h, hj, attr, dst, None, exact)
    assert tuple(out.shape) == (70, 36, 2 ** dim)
    dh, dhj, dattr, grads = fe.mp_backward(params, alg, h, hj, attr, dst,
                                           None, dagg, exact)
    moved = [cnt.count - b for cnt, b in zip(counters, before)]
    assert moved == [int(cnt in (kern.fwd, kern.bwd)) for cnt in counters]
    # ... n_nodes, n_edges, cm, ca, c, fast, sms, stream
    for name, n_ptr in (("fwd", 11), ("bwd", 15)):
        assert wide[name].calls[0][-8:] == (70, 40, 36, 5, 36,
                                            int(not exact), 132, 77)
        assert len(wide[name].calls[0]) == n_ptr + 8
    assert wide["scratch_bytes"].calls == [(40, 36, 5, 36, 0, 132),
                                           (40, 36, 5, 36, 1, 132)]
    assert tuple(dh.shape) == (70, 36, 2 ** dim)
    assert dhj.shape == hj.shape and dattr.shape == attr.shape
    assert [tuple(g.shape) for g in grads] == [tuple(p.shape)
                                               for p in params]


@pytest.mark.parametrize("dim,c", [(5, 36), (4, 64)])
def test_cpu_dispatch_is_plain_and_counts_nothing(dim, c):
    """On CPU tensors the wrappers compute the plain versions, bit for bit,
    and launch nothing.  One thread: PyTorch's multithreaded CPU
    reductions let two autograd runs of the plain pair form part in the
    last bits at these widths."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _cpu_dispatch(dim, c)
    finally:
        torch.set_num_threads(threads)


def _cpu_dispatch(dim, c):
    counters = [cnt for k in fe._WIDE for cnt in (k.fwd, k.bwd)]
    for cnt in counters:
        cnt.reset()
    alg = get_algebra(CL[dim])
    em = CEMLP(alg, c + 2, c, c)
    params = [p.detach() for p in block_params(em, 0) + block_params(em, 1)]
    gen = torch.Generator().manual_seed(dim)
    nb, n, e = 2 ** dim, 9, 20
    dst = torch.sort(torch.randint(0, n, (e,), generator=gen)).values
    args = (torch.randn(n, c, nb, generator=gen),
            torch.randn(e, c, nb, generator=gen),
            torch.randn(e, 2, nb, generator=gen), dst,
            torch.rand(e, generator=gen) > 0.3)
    for exact in (True, False):
        got = fe.mp_forward(params, alg, *args, exact)
        assert torch.equal(got, fe.message_aggregate_plain(
            params, alg, *args, False, exact))
        dagg = torch.randn(n, c, nb, generator=gen)
        got = fe.mp_backward(params, alg, *args, dagg, exact)
        want = fe.message_aggregate_grad_plain(params, alg, *args, dagg,
                                               exact)
        for a, b in zip(got[:3] + tuple(got[3]), want[:3] + tuple(want[3])):
            assert torch.equal(a, b)
    assert [cnt.count for cnt in counters] == [0] * len(counters)
