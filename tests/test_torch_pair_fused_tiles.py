"""Host-side code of the fast-mode K4p and K5p (the pair-form fused
message passing at Cl(5,0) and Cl(4,0) on the row tiles of K2p and K3p,
csrc/fused_egcl_pair_tile.cuh), and the plain pair form's fast backward
against the reference.

  * which entry points a call on the card asks (a stand-in library and
    tensors that say they lie on the card): in fast mode the tile sweeps'
    shared-memory entries and the fwd/bwd entries with the bf16 scratch
    x2s (E, nb, C); in exact mode the row kernels, without x2s;
  * the partial vector's block slices (K5's layout, as the tile sweeps
    write them) split into the flax shapes, every entry in place;
  * chip_smoke.py's width comparison of the two modes of K4p/K5p raises
    where a fast direction takes a narrower input, and its choice of the
    shapes at which it checks each sweep instance;
  * the plain pair form's fast-mode backward (``message_aggregate_grad_
    plain``) at Cl(4) and Cl(5) against ``jax.vjp`` of the reference's
    ``fused_message_aggregate`` in fast mode, its Pallas kernels in
    interpret mode.

The kernels themselves run only on the card; chip_smoke.py holds them to
the plain versions there.  Small widths throughout.
"""
import dataclasses
import importlib
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from csmpn_tpu.algebra import get_algebra as jax_algebra
from csmpn_tpu.nn.modules import CEMLP as JCEMLP
from csmpn_tpu.ops import fused_egcl as jfe
from csmpn_tpu.ops import segment as jseg
from csmpn_torch.algebra import get_algebra
from csmpn_torch.convert import params_from_jax
from csmpn_torch.nn import CEMLP
from csmpn_torch.ops import fused_egcl as fe
from csmpn_torch.ops import segment as seg
from csmpn_torch.ops.cemlp_kernel import block_params

PAIRS = [fe.PAIR, fe.PAIR_CL4]


def _smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that the wrapper
    takes its kernel path with a stand-in library."""

    @property
    def is_cuda(self):
        return True


class _Props:
    multi_processor_count = 132


class _Stream:
    cuda_stream = 77


def _inputs(kern, cm=3, ca=2, c=4, n=70, e=40, seed=7):
    """Parameters of the two blocks, h, hj, attr and dst, as card tensors,
    and d(agg)."""
    ng, npath, nb = kern.n_grades, kern.n_paths, kern.n_blades
    gen = torch.Generator().manual_seed(seed)
    params = []
    for cin in (cm + ca, c):
        shapes = [(c, cin, ng), (c, 1), (c, ng), (c, ng), (c, npath),
                  (c, c, ng), (c, ng), (c, c, ng), (c, 1), (c,)]
        params += [torch.randn(*s, generator=gen) for s in shapes]
    dst = torch.sort(torch.randint(0, n, (e,), generator=gen)).values
    ins = [torch.randn(n, cm, nb, generator=gen),
           torch.randn(e, cm, nb, generator=gen),
           torch.randn(e, ca, nb, generator=gen), dst]
    on = [torch.Tensor._make_subclass(_OnCard, t) for t in ins + params]
    dagg = torch.Tensor._make_subclass(
        _OnCard, torch.randn(n, c, nb, generator=gen))
    return on[4:], on[:4], dagg


def _stand_in(monkeypatch, kern, sizes):
    """The wrapper's entry points, recording their calls; sizes: name ->
    the value the entry returns."""
    calls = {name: [] for name in sizes}

    def fn(name):
        def entry(*args):
            calls[name].append(args)
            return sizes[name]
        return entry

    fns = {name: fn(name) for name in sizes}
    monkeypatch.setattr(fe, "_lib_fn", lambda k, name, *a: fns[name])
    monkeypatch.setattr(fe, "_tables", lambda k, a, d: (np.zeros(
        kern.n_blades, np.float32), 0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: _Props())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    fe._check_smem.cache_clear()
    fe._check_tile_smem.cache_clear()
    return calls


@pytest.mark.parametrize("kern", PAIRS, ids=lambda k: k.label)
@pytest.mark.parametrize("exact,tile_bytes", [(True, 2000), (False, 2000),
                                              (False, 0)])
def test_card_pair_mp_forward_launch(monkeypatch, kern, exact, tile_bytes):
    """On the card the fast K4p asks the tile sweeps' forward entry, then
    launches with the scratch x2s, (E, nb, C) bf16, as its eleventh
    pointer; it raises without a launch where the sweeps do not take the
    widths.  The exact K4p asks only the row kernels' entry and passes no
    scratch."""
    params, (h, hj, attr, dst), _ = _inputs(kern)
    nb, n, e = kern.n_blades, h.shape[0], hj.shape[0]
    cm, ca, c = h.shape[1], attr.shape[1], params[0].shape[0]
    calls = _stand_in(monkeypatch, kern, {
        "smem_bytes": 1000, "fwd_tile_smem_bytes": tile_bytes, "fwd": 0})
    empty = torch.empty
    scratch = []

    def spy_empty(*shape, **kw):
        t = empty(*shape, **kw)
        if kw.get("dtype") == torch.bfloat16:
            scratch.append(t)
        return t

    monkeypatch.setattr(torch, "empty", spy_empty)
    alg = get_algebra((1.0,) * (5 if nb == 32 else 4))
    before = (kern.fwd.count, kern.bwd.count)
    try:
        if tile_bytes == 0:
            with pytest.raises(NotImplementedError,
                               match="fast-mode forward"):
                fe.mp_forward(params, alg, h, hj, attr, dst, None, exact)
        else:
            out = fe.mp_forward(params, alg, h, hj, attr, dst, None, exact)
            assert tuple(out.shape) == (n, c, nb)
    finally:
        fe._check_smem.cache_clear()
        fe._check_tile_smem.cache_clear()
    launched = tile_bytes != 0
    assert (kern.fwd.count, kern.bwd.count) == (before[0] + launched,
                                                before[1])
    assert calls["fwd_tile_smem_bytes"] == ([] if exact
                                            else [(cm, ca, c, kern.wn)])
    assert len(calls["fwd"]) == int(launched)
    if launched:
        args = calls["fwd"][0]
        assert len(args) == 11 + 8 + 1
        if exact:
            assert args[10] is None and scratch == []
        else:
            assert [tuple(t.shape) for t in scratch] == [(e, nb, c)]
            assert args[10] == scratch[0].data_ptr()
        n_win = -(-n // kern.wn)   # ... wn, n_win, fast, grid, stream
        assert args[-9:-1] == (n, cm, ca, c, kern.wn, n_win, int(not exact),
                               min(n_win, 132))


@pytest.mark.parametrize("kern", PAIRS, ids=lambda k: k.label)
@pytest.mark.parametrize("exact,tile_bytes", [(True, 2000), (False, 2000),
                                              (False, 0)])
def test_card_pair_mp_backward_launch(monkeypatch, kern, exact, tile_bytes):
    """On the card the fast K5p asks the tile sweeps' backward entry and
    launches with 17 pointers, the scratch x2s (E, nb, C) bf16 the
    fifteenth, beside dx2 (E, max(C, Cm + Ca), nb) fp32 (block 1's dx rows
    go over block 2's) and the partials (grid, slice); it raises without
    a launch where the sweeps do not take the widths.  The exact K5p takes
    the row kernels with dx2 (E, C, nb) and a null x2s.  The summed vector
    splits into the 20 gradients in flax shapes."""
    params, (h, hj, attr, dst), dagg = _inputs(kern)
    nb, n, e = kern.n_blades, h.shape[0], hj.shape[0]
    cm, ca, c = h.shape[1], attr.shape[1], params[0].shape[0]
    calls = _stand_in(monkeypatch, kern, {
        "smem_bytes": 1000, "tile_smem_bytes": tile_bytes,
        "partial_floats": 999, "bwd": 0})
    empty = torch.empty
    made = []

    def spy_empty(*shape, **kw):
        t = empty(*shape, **kw)
        made.append((tuple(t.shape), t.dtype, t.data_ptr()))
        return t

    monkeypatch.setattr(torch, "empty", spy_empty)
    alg = get_algebra((1.0,) * (5 if nb == 32 else 4))
    before = (kern.fwd.count, kern.bwd.count)
    try:
        if tile_bytes == 0:
            with pytest.raises(NotImplementedError,
                               match="fast-mode backward"):
                fe.mp_backward(params, alg, h, hj, attr, dst, None, dagg,
                               exact)
            return
        dh, dhj, dattr, grads = fe.mp_backward(params, alg, h, hj, attr, dst,
                                               None, dagg, exact)
    finally:
        fe._check_smem.cache_clear()
        fe._check_tile_smem.cache_clear()
        assert calls["tile_smem_bytes"] == ([] if exact
                                            else [(cm, ca, c, kern.wn)])
    assert (kern.fwd.count, kern.bwd.count) == (before[0], before[1] + 1)
    args = calls["bwd"][0]
    assert len(args) == 17 + 8 + 1
    by_ptr = {ptr: (shape, dt) for shape, dt, ptr in made}
    assert cm + ca > c
    assert by_ptr[args[13]] == ((e, c if exact else cm + ca, nb),
                                torch.float32)   # dx2
    if exact:
        assert args[14] is None
    else:
        assert by_ptr[args[14]] == ((e, nb, c), torch.bfloat16)   # x2s
    n_win = -(-n // kern.wn)
    assert by_ptr[args[15]] == ((min(n_win, 132), 999), torch.float32)
    assert args[-9:-1] == (n, cm, ca, c, kern.wn, n_win, int(not exact),
                           min(n_win, 132))
    assert tuple(dh.shape) == (n, cm, nb) and tuple(dhj.shape) == (e, cm, nb)
    assert tuple(dattr.shape) == (e, ca, nb)
    for g, p in zip(grads, params):
        assert g.shape == p.shape


@pytest.mark.parametrize("kern", PAIRS, ids=lambda k: k.label)
def test_pair_part_maps_entries_where_the_tile_sweeps_write_them(kern):
    """A tile sweep writes weight-gradient entry (m, n, g) of its block at
    ((m * G + g) * C + n) of the block's slice, then the per-channel rows
    b1, silu.a (G), silu.b (G), gp.weight (P), d sigmoid(norm.a) (G), bL,
    ln.a; a vector holding each entry's own coordinates comes back in
    flax shapes with every entry in place, for block 1 and block 2."""
    cin, c, ng, npath = 5, 3, kern.n_grades, kern.n_paths
    assert kern.nloc == 3 + 3 * ng + npath
    for cin_b in (cin, c):
        n1, nc = cin_b * ng * c, c * ng * c
        v = np.zeros(fe.block_part_floats(kern, cin_b, c), np.float32)
        for which, m_max, off in ((0, cin_b, 0), (1, c, n1),
                                  (2, c, n1 + nc)):
            for m in range(m_max):
                for g in range(ng):
                    for n in range(c):
                        v[off + (m * ng + g) * c + n] = (
                            1000 * which + 100 * m + 10 * g + n)
        loc = np.arange(kern.nloc * c, dtype=np.float32) + 0.5
        v[n1 + 2 * nc:] = loc
        grads = fe._block_grads(torch.from_numpy(v), cin_b, c,
                                torch.zeros(c, ng), kern)
        for which, idx in ((0, 0), (1, 5), (2, 7)):
            t = grads[idx].numpy()
            for n in range(t.shape[0]):
                for m in range(t.shape[1]):
                    for g in range(ng):
                        assert t[n, m, g] == \
                            1000 * which + 100 * m + 10 * g + n
        loc = loc.reshape(kern.nloc, c)
        sa, sb, gw = 1, 1 + ng, 1 + 2 * ng
        ns = gw + npath
        np.testing.assert_array_equal(grads[1].numpy().reshape(-1), loc[0])
        np.testing.assert_array_equal(grads[2].numpy(), loc[sa:sb].T)
        np.testing.assert_array_equal(grads[3].numpy(), loc[sb:gw].T)
        np.testing.assert_array_equal(grads[4].numpy(), loc[gw:ns].T)
        np.testing.assert_allclose(grads[6].numpy(),
                                   loc[ns:ns + ng].T * 0.25, rtol=0, atol=0)
        np.testing.assert_array_equal(grads[8].numpy().reshape(-1),
                                      loc[ns + ng])
        np.testing.assert_array_equal(grads[9].numpy(), loc[-1])


def _width_lib(monkeypatch, fast_cap):
    """Stand-in entries, and both pair kernels cut to 6 channels: the
    exact mode takes Cm + Ca <= 40 - C at every C <= 6 (both directions);
    each fast direction takes Cm + Ca <= fast_cap(C, backward); 16 tiles
    a warp in sweep 1, 24 in sweep 2 where Cm > 15.  Returns the cut
    kernels."""
    def row(cm, ca, c, wn, bwd):
        return 1000 if c <= 6 and cm + ca <= 40 - c else 0

    def tile(bwd):
        return lambda cm, ca, c, wn: (
            1000 if cm + ca <= fast_cap(c, bwd) else 0)

    def maxt(cm, ca, c, wn, sweep):
        return 16 if sweep == 1 or cm <= 15 else 24

    fns = {"smem_bytes": row, "fwd_tile_smem_bytes": tile(False),
           "tile_smem_bytes": tile(True), "tile_maxt": maxt}
    monkeypatch.setattr(fe, "_lib_fn", lambda k, name, *a: fns[name])
    cut = [dataclasses.replace(k, max_channels=6) for k in PAIRS]
    monkeypatch.setattr(fe, "PAIR", cut[0])
    monkeypatch.setattr(fe, "PAIR_CL4", cut[1])
    return cut


@pytest.mark.parametrize("narrow", [None, "forward", "backward"])
def test_pair_fused_widths_fast_takes_what_exact_takes(monkeypatch, capsys,
                                                       narrow):
    """chip_smoke's comparison of the widest inputs of K4p/K5p: it passes
    where each fast direction takes every (Cm, Ca, C) the exact mode
    takes, and raises where a fast direction takes a narrower input at
    some C."""
    cs = _smoke()

    def fast_cap(c, bwd):
        if narrow == ("backward" if bwd else "forward") and c == 3:
            return 30
        return 50

    _width_lib(monkeypatch, fast_cap)
    if narrow is None:
        cs.print_pair_fused_widths()
        out = capsys.readouterr().out
        assert "1:39/50/50" in out and "6:34/50/50" in out
        assert out.count("take every attribute width") == 2
    else:
        with pytest.raises(AssertionError, match=r"\(C, Cm\) = \[\(3, 1\)"):
            cs.print_pair_fused_widths()


def test_pair_fused_instance_shapes(monkeypatch):
    """chip_smoke's shapes for the fast K4p/K5p on the stand-in library:
    one for each sweep instance (sweep 1: 16 tiles a warp; sweep 2: 16 up
    to Cm = 15, else 24), at the narrowest C >= c_min (or below, where
    none reaches c_min) and its widest Cm (Ca 0); then the widest input at
    the widest C (the largest Cm + Ca, then the largest Cm); each once
    (sweep 2's 24 falls on sweep 1's shape)."""
    cs = _smoke()
    kern = _width_lib(monkeypatch, lambda c, bwd: 50)[0]
    assert (cs.C_MIN, cs.FUSED_C_MIN) == (4, 8)
    assert cs.pair_fused_instance_shapes(kern, cs.C_MIN) == [
        (36, 0, 4, 16, 24),   # sweep 1's 16 (and sweep 2's 24)
        (15, 0, 4, 16, 16),   # sweep 2's 16
        (34, 0, 6, 16, 24)]   # the widest input
    # at FUSED_C_MIN, above every C the stand-in takes: the narrowest C
    assert cs.pair_fused_instance_shapes(kern) == [
        (39, 0, 1, 16, 24), (15, 0, 1, 16, 16), (34, 0, 6, 16, 24)]


# ------------------------------------- the plain pair form's fast backward

@pytest.fixture
def _fast_mode():
    seg.set_aggregation_mode("fast")
    jseg.set_aggregation_mode("fast")
    yield
    seg.set_aggregation_mode("exact")
    jseg.set_aggregation_mode("exact")


@pytest.mark.parametrize("dim", [4, 5])
def test_plain_pair_fast_backward_matches_reference(dim, _fast_mode):
    """The plain pair form's fast-mode backward (message_aggregate_grad_
    plain, exact=False) at Cl(dim, 0), C = 4, masked, with attributes,
    against jax.vjp of the reference's fused_message_aggregate in fast
    mode (its K4/K5 in interpret mode): dh, dhj, dattr and the 20
    parameter gradients, each within 3e-2 of its tensor's largest
    magnitude (the backward limit of test_torch_kernels.py's fast check
    of the dense form against the reference; the two fast versions round
    at the same points, but a rounding that a different fp32 order flips
    moves a bf16 operand by one unit).  A CPU run reads at most 1.46e-2
    at Cl(4) and 1.21e-2 at Cl(5)."""
    metric, nb = (1.0,) * dim, 2 ** dim
    rng = np.random.RandomState(40 + dim)
    n, e, cm, ca, c = 30, 70, 3, 2, 4
    dst = np.sort(rng.randint(0, n, size=e)).astype(np.int32)
    h = rng.randn(n, cm, nb).astype(np.float32)
    hj = rng.randn(e, cm, nb).astype(np.float32)
    attr = rng.randn(e, ca, nb).astype(np.float32)
    mask = rng.rand(e) > 0.2
    cot = rng.randn(n, c, nb).astype(np.float32)
    jm = JCEMLP(jax_algebra(metric), cm + ca, c, c, fused=False)
    params = jm.init(jax.random.PRNGKey(dim),
                     jnp.zeros((e, cm + ca, nb), jnp.float32))
    params = jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + 0.1 * rng.randn(*p.shape)
                              .astype(np.float32)), params)

    def f(p, hh, hhj, aa):
        return jm.apply(p, hh, hhj, aa, jnp.asarray(dst), jnp.asarray(mask),
                        method=lambda m, *a: jfe.fused_message_aggregate(
                            m, a[0], a[1], a[2], a[3], edge_mask=a[4],
                            mean=False, interpret=True))

    _, vjp = jax.vjp(f, params, jnp.asarray(h), jnp.asarray(hj),
                     jnp.asarray(attr))
    j_gp, j_dh, j_dhj, j_dattr = vjp(jnp.asarray(cot))
    tm = CEMLP(get_algebra(metric), cm + ca, c, c)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    ps = block_params(tm, 0) + block_params(tm, 1)
    dh, dhj, dattr, grads = fe.message_aggregate_grad_plain(
        ps, tm.algebra, torch.from_numpy(h), torch.from_numpy(hj),
        torch.from_numpy(attr), torch.from_numpy(dst).long(),
        torch.from_numpy(mask), torch.from_numpy(cot), exact=False)
    names = {id(p): name for name, p in tm.named_parameters()}
    j_named = params_from_jax(jax.tree.map(np.asarray, j_gp))
    pairs = [("dh", dh, j_dh), ("dhj", dhj, j_dhj), ("dattr", dattr, j_dattr)]
    pairs += [(names[id(p)], g, j_named[names[id(p)]].numpy())
              for p, g in zip(ps, grads)]
    assert len(pairs) == 23
    worst = 0.0
    for name, got, want in pairs:
        want = np.asarray(want, np.float32)
        got = got.detach().float().numpy().reshape(want.shape)
        scale = max(float(np.abs(want).max()), 1e-6)
        err = float(np.abs(got - want).max()) / scale
        worst = max(worst, err)
        assert err < 3e-2, (name, err)
    print(f"Cl({dim}) fast backward, worst relative error {worst:.2e}")
