"""The EGCL edge side at the widths the dense K4/K5 do not take (K4w and
K5w on the card: every C <= 128 channels and Cm + Ca <= 320 message +
attribute channels, at Cl(3,0) and Cl(2,0)) against the reference
package, the routing of a call between the K4/K5 of csrc/fused_egcl.cu and
the wide ones, and the bench_scaling entry point at --hidden 64.

  * the plain K4/K5 (the CPU dispatch of ``fused_message_aggregate``)
    against the reference's fused kernels in interpret mode, exact mode,
    masked, the output and every gradient (h, hj, attr, the 20
    parameters): Cl(3) at Cm 64 + Ca 8 -> 64 (mean), Cl(3) at 128 -> 128
    (sum), Cl(2) at Cm 72 + Ca 3 -> 72 (mean); the fast-mode forward at
    Cl(3) 64 -> 64 against the reference kernel's fast mode;
  * ``fused_route`` with the libraries' size entries stood in: K4/K5
    where every entry of the mode takes the widths in both directions,
    K4w/K5w where one refuses (up to 128 channels), NotImplementedError
    naming the range at C = 129 and at Cm + Ca = 321; the plan's window is
    the route's, a plan of one route is refused by the other's kernels;
    a call on the card launches K4w (K5w) once and counts one; the CPU
    dispatch counts nothing;
  * ``csmpn_torch.bench_scaling --device=cpu --hidden 64`` at a tiny size
    against the reference's EGCL on the same complex, features and
    weights: the loss and every parameter gradient.

Tolerances: rtol 2e-4 / atol 1e-5 in exact fp32 (the reference's parity
tolerance, as tests/test_torch_flat_algebras.py), atol taken of each
tensor's largest magnitude where that exceeds 1 (``close``); the fast-mode
forward
within 2e-2 of the output's max, as
test_plain_fused_fast_matches_reference_kernel_fast allows; the entry
point's gradients rtol 5e-4 / atol 1e-5, as tests/test_torch_streaming.py.
One reference call in interpret mode at these widths takes ~10 s, so the
graphs are small (24 targets, 64 edges).  The CUDA kernels are held to
these plain versions on the card by chip_smoke.py.
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from csmpn_tpu.algebra import get_algebra as jax_algebra
from csmpn_tpu.nn.egcl import EGCL as JEGCL
from csmpn_tpu.nn.modules import CEMLP as JCEMLP
from csmpn_tpu.ops import fused_egcl as jfe
from csmpn_tpu.ops import segment as jseg
from csmpn_tpu.parallel import edge_partition as jep
from csmpn_torch import bench_scaling
from csmpn_torch.algebra import get_algebra
from csmpn_torch.convert import params_from_jax, params_to_jax
from csmpn_torch.nn import CEMLP
from csmpn_torch.ops import fused_egcl as fe
from csmpn_torch.ops import segment as seg

RTOL, ATOL = 2e-4, 1e-5
METRIC = {3: (1.0, 1.0, 1.0), 2: (1.0, 1.0)}


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    """rtol, and atol of the larger of 1 and the tensor's largest
    magnitude: at these widths a gradient sums 64 edges of 128-wide
    products and reaches ~10, where two fp32 summation orders part by
    ~1e-5 at its smallest elements."""
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(
        got.detach().float().numpy() if isinstance(got, torch.Tensor)
        else got, want, rtol=rtol, atol=atol * scale, err_msg=msg)


@pytest.fixture(autouse=True)
def _exact_mode():
    seg.set_aggregation_mode("exact")
    jseg.set_aggregation_mode("exact")
    yield
    seg.set_aggregation_mode("exact")
    jseg.set_aggregation_mode("exact")


def _case(dim, seed, cm, ca, c, n=24, e=64):
    """Inputs from numpy (masked), a flax edge CEMLP at Cl(dim, 0) with
    its init perturbed, and the port's CEMLP on the same weights."""
    metric, nb = METRIC[dim], 2 ** dim
    rng = np.random.RandomState(seed)
    dst = np.sort(rng.randint(0, n, size=e)).astype(np.int32)
    h = rng.randn(n, cm, nb).astype(np.float32)
    hj = rng.randn(e, cm, nb).astype(np.float32)
    attr = rng.randn(e, ca, nb).astype(np.float32) if ca else None
    mask = rng.rand(e) > 0.2
    jm = JCEMLP(jax_algebra(metric), cm + ca, c, c, fused=False)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((e, cm + ca, nb), jnp.float32))
    params = jax.tree.map(lambda p: jnp.asarray(
        np.asarray(p) + 0.1 * rng.randn(*p.shape).astype(np.float32)),
        params)
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

@pytest.mark.parametrize("dim,cm,ca,c,mean", [
    (3, 64, 8, 64, True), (3, 128, 0, 128, False), (2, 72, 3, 72, True)],
    ids=["cl3-64+8-mean", "cl3-128-sum", "cl2-72+3-mean"])
def test_plain_wide_fused_matches_reference_kernels_exact(dim, cm, ca, c,
                                                          mean):
    """The output, dh, dhj, dattr and every parameter gradient of the
    port's edge side on the CPU against the reference's fused kernels in
    interpret mode under jax.value_and_grad, masked, exact mode."""
    k = _case(dim, 40 + c, cm, ca, c)
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


def test_plain_wide_fused_fast_matches_reference_kernel_fast():
    k = _case(3, 7, 64, 0, 64)
    jseg.set_aggregation_mode("fast")
    j_out = _jax_fused(k, mean=True)(
        k.params, jnp.asarray(k.h), jnp.asarray(k.hj), None)[1]
    seg.set_aggregation_mode("fast")
    with torch.no_grad():
        out = _port(k, True, grad=False)[0]
    scale = float(np.abs(np.asarray(j_out)).max())
    err = float(np.abs(out.numpy() - np.asarray(j_out)).max())
    assert err < 2e-2 * max(scale, 1.0), (err, scale)


# ----------------------------------------------------------------- routing

NARROW = [fe.DENSE, fe.DENSE_CL2]
ENTRIES = ["smem_bytes_fwd", "smem_bytes_bwd", "fwd_tile_smem_bytes",
           "tile_smem_bytes"]


class _Fn:
    """A C entry point stood in by a Python function, its calls kept."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.calls.append(args)
        return self.fn(*args)


def _stand_in(monkeypatch, refuse=(), narrow_c=32):
    """Both libraries' entries: K4/K5's size entries take C <= narrow_c
    except the entries named in ``refuse``; K4w/K5w's take C <= 128 and
    Cm + Ca <= 320 and say so through their range entry; their fwd and
    bwd entries succeed.  Returns the wide entries by name."""
    def narrow(name):
        def size(cm, ca, c, wn, *backward):
            key = (f"{name}_{'bwd' if backward[0] else 'fwd'}"
                   if name == "smem_bytes" else name)
            return 0 if key in refuse or c > narrow_c else 1000
        return _Fn(size)

    def wide_range(out):
        out[0], out[1] = 128, 320

    wide = {"smem_bytes": _Fn(lambda cm, ca, c, b: 90_000
                              if 1 <= c <= 128 and cm + ca <= 320 else 0),
            "range": _Fn(wide_range),
            "scratch_bytes": _Fn(lambda *a: 4096),
            "fwd": _Fn(lambda *a: 0), "bwd": _Fn(lambda *a: 0)}
    fns = {n: narrow(n) for n in ("smem_bytes", "fwd_tile_smem_bytes",
                                  "tile_smem_bytes")}
    monkeypatch.setattr(fe, "_lib_fn", lambda k, name, *a: (
        wide if k in fe._WIDE else fns)[name])
    for f in (fe._check_smem, fe._check_tile_smem, fe._wide_range):
        f.cache_clear()
    return wide


@pytest.fixture(autouse=True)
def _fresh_caches():
    yield
    for f in (fe._check_smem, fe._check_tile_smem, fe._wide_range):
        f.cache_clear()


@pytest.mark.parametrize("kern", NARROW, ids=lambda k: k.label)
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_route_keeps_k4_k5_where_every_entry_takes(monkeypatch, kern, exact):
    _stand_in(monkeypatch)
    for cm, ca, c in [(32, 0, 32), (28, 3, 28), (4, 0, 1), (40, 9, 16)]:
        assert fe.fused_route(kern, cm, ca, c, exact) is kern


@pytest.mark.parametrize("kern", NARROW, ids=lambda k: k.label)
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("refuse", ENTRIES)
def test_route_takes_k4w_where_an_entry_refuses(monkeypatch, kern, exact,
                                                refuse):
    """One entry of K4/K5 refusing, in either direction, sends the call
    (forward and backward alike) to K4w/K5w of the same algebra; the tile
    entries are asked in fast mode only."""
    _stand_in(monkeypatch, refuse=(refuse,))
    wide = fe.WIDE_OF[kern.n_blades]
    assert (wide.n_blades, wide.n_grades, wide.n_paths) == (
        kern.n_blades, kern.n_grades, kern.n_paths)
    asked = refuse.startswith("smem") or not exact
    assert fe.fused_route(kern, 28, 3, 28, exact) is (wide if asked
                                                      else kern)


@pytest.mark.parametrize("kern", NARROW, ids=lambda k: k.label)
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_route_takes_k4w_up_to_its_range_and_raises_past_it(monkeypatch,
                                                            kern, exact):
    _stand_in(monkeypatch)
    wide = fe.WIDE_OF[kern.n_blades]
    for cm, ca, c in [(33, 0, 33), (64, 0, 64), (46, 3, 46), (128, 0, 128),
                      (128, 192, 128), (310, 10, 40)]:
        assert fe.fused_route(kern, cm, ca, c, exact) is wide
    for cm, ca, c in [(129, 0, 129), (64, 0, 129), (318, 3, 128),
                      (321, 0, 64)]:
        with pytest.raises(NotImplementedError,
                           match="take at most 128 channels and 320 "
                                 "message"):
            fe.fused_route(kern, cm, ca, c, exact)


def test_pair_form_keeps_its_kernels(monkeypatch):
    """The pair form keeps K4p/K5p where their entries take the widths and,
    past them, takes K4pw/K5pw of its own algebra, as the dense form takes
    K4w/K5w."""
    _stand_in(monkeypatch, narrow_c=28)
    for kern in (fe.PAIR, fe.PAIR_CL4):
        assert fe.fused_route(kern, 28, 0, 28, False) is kern
        assert fe.fused_route(kern, 64, 0, 64, False) is fe.WIDE_OF[
            kern.n_blades]


class _Props:
    multi_processor_count = 132


class _Stream:
    cuda_stream = 77


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that the wrappers
    take their kernel path with a stand-in library."""

    @property
    def is_cuda(self):
        return True


def _on_card(t):
    return torch.Tensor._make_subclass(_OnCard, t)


def _inputs(dim, cm, ca, c, n=70, e=40, seed=3):
    nb = 2 ** dim
    em = CEMLP(get_algebra(METRIC[dim]), cm + ca, c, c)
    from csmpn_torch.ops.cemlp_kernel import block_params

    params = [_on_card(p.detach()) for p in block_params(em, 0)
              + block_params(em, 1)]
    gen = torch.Generator().manual_seed(seed)
    dst = torch.sort(torch.randint(0, n, (e,), generator=gen)).values
    ins = [torch.randn(n, cm, nb, generator=gen),
           torch.randn(e, cm, nb, generator=gen),
           torch.randn(e, ca, nb, generator=gen) if ca else None, dst]
    dagg = torch.randn(n, c, nb, generator=gen)
    return (params, [None if t is None else _on_card(t) for t in ins],
            _on_card(dagg))


def _card(monkeypatch):
    monkeypatch.setattr(fe, "_tables", lambda k, a, d: (np.zeros(
        k.n_blades, np.float32), 0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: _Props())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())


@pytest.mark.parametrize("dim", [3, 2])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_plan_window_is_the_routes(monkeypatch, dim, exact):
    """K4/K5's plan cuts the targets into windows of 32, K4w/K5w's into
    single targets (bounds[v] is target v's first edge); each plan names
    its kernels, and a plan of one route is refused by the other."""
    _stand_in(monkeypatch)
    _card(monkeypatch)
    nb = 2 ** dim
    n = 70
    dst = torch.sort(torch.randint(0, n, (200,),
                                   generator=torch.Generator()
                                   .manual_seed(1))).values
    narrow = fe.make_plan(dst, None, n, 28, 0, 28, nb, exact)
    wide = fe.make_plan(dst, None, n, 64, 0, 64, nb, exact)
    assert narrow.kern is fe.fused_kernel(nb) and narrow.n_win == 3
    assert wide.kern is fe.WIDE_OF[nb] and wide.n_win == n
    want = torch.searchsorted(dst.to(torch.int32),
                              torch.arange(n + 1, dtype=torch.int32))
    assert torch.equal(wide.bounds, want.to(torch.int64))
    params, (h, hj, attr, d), dagg = _inputs(dim, 64, 0, 64)
    with pytest.raises(ValueError, match="made for K4/K5"):
        fe.mp_forward(params, get_algebra(METRIC[dim]), h, hj, attr, d,
                      None, exact, narrow)
    params, (h, hj, attr, d), dagg = _inputs(dim, 28, 0, 28)
    with pytest.raises(ValueError, match="made for K4w/K5w"):
        fe.mp_backward(params, get_algebra(METRIC[dim]), h, hj, attr, d,
                       None, dagg, exact, wide)


@pytest.mark.parametrize("dim", [3, 2])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_card_wide_calls_launch_once_and_count_one(monkeypatch, dim, exact):
    """On the card a call past K4/K5's widths launches K4w's (K5w's) entry
    once with the call's counts, its scratch from the scratch entry, and
    counts one launch on the wide counter alone; the backward's vector
    splits into the 20 gradients in flax shapes."""
    wide = _stand_in(monkeypatch)
    _card(monkeypatch)
    kern = fe.WIDE_OF[2 ** dim]
    params, (h, hj, attr, dst), dagg = _inputs(dim, 64, 5, 64)
    alg = get_algebra(METRIC[dim])
    counters = [k.fwd for k in fe.WIDE_OF.values()] + [
        k.bwd for k in fe.WIDE_OF.values()] + [
        fe.FWD_LAUNCHES, fe.BWD_LAUNCHES, fe.CL2_FWD_LAUNCHES,
        fe.CL2_BWD_LAUNCHES]
    before = [cnt.count for cnt in counters]
    out = fe.mp_forward(params, alg, h, hj, attr, dst, None, exact)
    assert tuple(out.shape) == (70, 64, 2 ** dim)
    dh, dhj, dattr, grads = fe.mp_backward(params, alg, h, hj, attr, dst,
                                           None, dagg, exact)
    moved = [cnt.count - b for cnt, b in zip(counters, before)]
    want = [int(cnt in (kern.fwd, kern.bwd)) for cnt in counters]
    assert moved == want
    # ... n_nodes, n_edges, cm, ca, c, fast, sms, stream
    assert wide["fwd"].calls[0][-8:] == (70, 40, 64, 5, 64, int(not exact),
                                         132, 77)
    assert len(wide["fwd"].calls[0]) == 11 + 8
    assert wide["bwd"].calls[0][-8:] == (70, 40, 64, 5, 64, int(not exact),
                                         132, 77)
    assert len(wide["bwd"].calls[0]) == 15 + 8
    assert wide["scratch_bytes"].calls == [(40, 64, 5, 64, 0, 132),
                                           (40, 64, 5, 64, 1, 132)]
    assert tuple(dh.shape) == (70, 64, 2 ** dim)
    assert dhj.shape == hj.shape and dattr.shape == attr.shape
    assert [tuple(g.shape) for g in grads] == [tuple(p.shape)
                                               for p in params]


@pytest.mark.parametrize("dim,c", [(3, 40), (2, 72)])
def test_cpu_dispatch_is_plain_and_counts_nothing(dim, c):
    counters = [k.fwd for k in fe.WIDE_OF.values()] + [
        k.bwd for k in fe.WIDE_OF.values()]
    for cnt in counters:
        cnt.reset()
    alg = get_algebra(METRIC[dim])
    em = CEMLP(alg, c + 2, c, c)
    from csmpn_torch.ops.cemlp_kernel import block_params

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


# ------------------------------------------------------ the entry point

def test_bench_scaling_at_hidden_64_matches_reference():
    """bench_scaling's streamed layer at --hidden 64 (exact, CPU): its
    last step's loss and every parameter gradient against the reference's
    EGCL on the same complex, features and weights."""
    n, deg, hid = 64, 3, 64
    res = bench_scaling.main(["--device=cpu", "--simplices", str(n),
                              "--degree", str(deg), "--stream", "2",
                              "--steps", "1", "--hidden", str(hid),
                              "--precision", "exact"])
    egcl, h = res["egcl"], res["h"]
    ei = jep.make_synthetic_complex(n, deg, seed=0)
    jl = JEGCL(jax_algebra((1.0, 1.0, 1.0)), hid, hid, hid, aggr="mean")
    params = jax.tree.map(jnp.asarray, params_to_jax(egcl.state_dict()))

    def loss(p):
        out = jl.apply(p, jnp.asarray(h.numpy()), jnp.asarray(ei))
        return jnp.sum(out ** 2) / (n * hid * 8)

    j_loss, j_grads = jax.value_and_grad(loss)(params)
    close(float(res["loss"]), float(j_loss), msg="loss")
    want = params_from_jax(jax.tree.map(np.asarray, j_grads))
    for name, p in egcl.named_parameters():
        close(p.grad, want[name].numpy(), rtol=5e-4, atol=1e-5, msg=name)
