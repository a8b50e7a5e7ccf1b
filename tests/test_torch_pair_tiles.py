"""Host-side code of the fast-mode row tiles of the pair form at Cl(5,0)
and Cl(4,0): the backward K3p (csrc/cemlp_pair_tile.cuh) and the forward
K2p (csrc/cemlp_pair_fwd_tile.cuh): which launches take the tile kernels,
the shared-memory entry points each launch asks, the CTA steps the grid is
cut for, the partial vector the backward writes and how it splits into the
flax shapes, that the CPU wrappers take the plain versions and count no
launch, the shapes at which chip_smoke.py checks each tile kernel instance
and the widths it compares between the modes; and the Cayley pair terms
that the forward unrolls (csrc/pair_terms.cuh) against their generator,
the port's pair tables and the reference's structural tables.

The kernels themselves run only on the card; chip_smoke.py holds them to
the plain versions there.  A stand-in library takes the place of the
compiled one where a wrapper asks it for sizes.  Small widths throughout.
"""
import ctypes
import importlib
import os
import sys

import numpy as np
import pytest
import torch

from csmpn_tpu.algebra import get_algebra as jax_algebra
from csmpn_tpu.ops import cemlp_kernel as jck
from csmpn_torch.algebra import get_algebra
from csmpn_torch.ops import _build
from csmpn_torch.ops import cemlp_kernel as ck
from csmpn_torch.tools import pair_terms as pt

PAIRS = [ck.PAIR, ck.PAIR_CL4]
ALL = [ck.DENSE, ck.DENSE_CL2, ck.PAIR, ck.PAIR_CL4]


def _smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


class _Entry:
    """A C entry point that records its calls and returns a fixed size."""

    def __init__(self, value):
        self.value, self.calls = value, []
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.calls.append(args)
        return self.value


class _Lib:
    def __init__(self, **entries):
        self.__dict__.update(entries)


@pytest.mark.parametrize("kern", ALL, ids=lambda k: k.label)
def test_pair_tiles_take_the_fast_backward_at_nb_32_and_16(kern):
    """Fast mode takes the row tiles for both directions of either form
    (the dense form's of csrc/cemlp_tile.cuh, the pair form's own);
    exact mode never."""
    assert ck._tiled(kern, True, False)
    assert not ck._tiled(kern, True, True)
    assert ck._tiled(kern, False, False)
    assert not ck._tiled(kern, False, True)
    if kern.form == "pair":
        assert kern.n_blades in (16, 32)
        assert ck._tile_rows(kern) * kern.n_blades == ck.PAIR_TILE_PAIRS
        assert ck._tile_rows(kern, False) * kern.n_blades == \
            ck.PAIR_FWD_TILE_PAIRS


SIZES = {"smem_bytes": 1000, "tile_smem_bytes": 2000,
         "fwd_tile_smem_bytes": 3000}


@pytest.mark.parametrize("kern", PAIRS, ids=lambda k: k.label)
@pytest.mark.parametrize("backward,exact,entry", [
    (True, False, "tile_smem_bytes"), (True, True, "smem_bytes"),
    (False, False, "fwd_tile_smem_bytes"), (False, True, "smem_bytes")])
def test_pair_smem_asks_the_entry_of_the_launch(monkeypatch, kern, backward,
                                                exact, entry):
    lib = _Lib(**{f"{kern.symbol}_{k}": _Entry(v) for k, v in SIZES.items()})
    monkeypatch.setattr(_build, "load", lambda name: lib)
    got = ck._smem(kern, 34, 28, backward, exact)
    called = getattr(lib, f"{kern.symbol}_{entry}")
    assert got == SIZES[entry]
    want = (34, 28) if entry != "smem_bytes" else (34, 28, int(backward))
    assert called.calls == [want]
    assert called.argtypes == [ctypes.c_int] * len(want)
    for k in SIZES:
        if k != entry:
            assert getattr(lib, f"{kern.symbol}_{k}").calls == []


@pytest.mark.parametrize("kern", PAIRS, ids=lambda k: k.label)
@pytest.mark.parametrize("backward", [True, False])
def test_pair_smem_raises_where_the_tiles_do_not_fit(monkeypatch, kern,
                                                     backward):
    lib = _Lib(**{f"{kern.symbol}_smem_bytes": _Entry(1000),
                  f"{kern.symbol}_tile_smem_bytes": _Entry(0),
                  f"{kern.symbol}_fwd_tile_smem_bytes": _Entry(0)})
    monkeypatch.setattr(_build, "load", lambda name: lib)
    with pytest.raises(NotImplementedError, match="fast mode"):
        ck._smem(kern, 500, 28, backward, False)
    assert ck._smem(kern, 500, 28, backward, True) == 1000


@pytest.mark.parametrize("kern,rows,want", [
    (ck.PAIR, 13_184, 132),       # hulls edge block: 3,296 steps of 4 rows
    (ck.PAIR, 1_024, 132),        # embed_1: 256 steps
    (ck.PAIR, 40, 10),            # fewer steps than SMs
    (ck.PAIR, 41, 11),            # a last step of one row
    (ck.PAIR_CL4, 8_192, 132),    # --dim 4 node block: 1,024 steps of 8
    (ck.PAIR_CL4, 40, 5),
])
def test_grid_is_cut_for_the_pair_steps(monkeypatch, kern, rows, want):
    class _Props:
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: _Props())
    assert ck._grid(rows, "cuda", 170_000, ck._tile_rows(kern)) == want


@pytest.mark.parametrize("kern", PAIRS, ids=lambda k: k.label)
def test_tile_partials_are_the_gradient_vector(monkeypatch, kern):
    """The tile kernel's CTA slice is its partial gradient vector alone;
    the exact row kernel's slice (channel-mixing scratch too) comes from
    the library."""
    entry = _Entry(12345)
    lib = _Lib(**{f"{kern.symbol}_partial_floats": entry})
    monkeypatch.setattr(_build, "load", lambda name: lib)
    assert ck._partial_floats(kern, 34, 28, 999, exact=False) == 999
    assert entry.calls == []
    assert ck._partial_floats(kern, 34, 28, 999, exact=True) == 12345
    assert entry.calls == [(34, 28)]


def _flax_vector(cin, c, ng, npath, rng):
    shapes = [(c, cin, ng), (c, 1), (c, ng), (c, ng), (c, npath),
              (c, c, ng), (c, ng), (c, c, ng), (c, 1), (c,)]
    parts = [rng.randn(*s).astype(np.float32) for s in shapes]
    return np.concatenate([p.reshape(-1) for p in parts]), parts


@pytest.mark.parametrize("nb,ng,npath", [(32, 6, 56), (16, 5, 35)])
def test_pair_partial_vector_splits_into_flax_shapes(nb, ng, npath):
    """The tile K3p writes its partials in grad_floats' (flax) layout,
    which _split_grads reads back tensor by tensor."""
    cin, c = 5, 3
    vec, parts = _flax_vector(cin, c, ng, npath, np.random.RandomState(nb))
    got = ck._split_grads(torch.from_numpy(vec),
                          [torch.empty(p.shape) for p in parts])
    for g, p in zip(got, parts):
        np.testing.assert_array_equal(g.numpy(), p)


def _block(alg, cin, c, rows, seed):
    ng = len(set(alg.blade_to_grade.tolist()))
    gen = torch.Generator().manual_seed(seed)
    shapes = [(c, cin, ng), (c, 1), (c, ng), (c, ng),
              (c, alg.n_product_paths), (c, c, ng), (c, ng), (c, c, ng),
              (c, 1), (c,)]
    params = [0.3 * torch.randn(*s, generator=gen) for s in shapes]
    x = torch.randn(rows, cin, alg.n_blades, generator=gen)
    dout = torch.randn(rows, c, alg.n_blades, generator=gen)
    return x, params, dout


@pytest.mark.parametrize("metric", [(1.0,) * 5, (1.0,) * 4],
                         ids=["Cl5", "Cl4"])
@pytest.mark.parametrize("exact", [True, False])
def test_cpu_pair_backward_is_plain_and_counts_no_launch(metric, exact):
    alg = get_algebra(metric)
    x, params, dout = _block(alg, 3, 2, 5, 7)
    kern = ck.block_kernel(alg.n_blades)
    before = (kern.fwd.count, kern.bwd.count)
    dx, grads = ck.block_backward(x, dout, params, alg, exact)
    rdx, rgrads = ck.block_backward_plain(x, dout, params, alg, exact)
    assert (kern.fwd.count, kern.bwd.count) == before
    assert torch.equal(dx, rdx)
    for g, r in zip(grads, rgrads):
        assert torch.equal(g, r)


@pytest.mark.parametrize("metric", [(1.0,) * 5, (1.0,) * 4],
                         ids=["Cl5", "Cl4"])
@pytest.mark.parametrize("exact", [True, False])
def test_cpu_pair_forward_is_plain_and_counts_no_launch(metric, exact):
    alg = get_algebra(metric)
    x, params, _ = _block(alg, 3, 2, 5, 8)
    kern = ck.block_kernel(alg.n_blades)
    before = (kern.fwd.count, kern.bwd.count)
    out = ck.block_forward(x, params, alg, exact)
    assert (kern.fwd.count, kern.bwd.count) == before
    assert torch.equal(out, ck.block_forward_plain(x, params, alg, exact))


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that the wrapper
    takes its kernel path with a stand-in library."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("metric,rows,grid", [((1.0,) * 5, 41, 11),
                                              ((1.0,) * 4, 41, 6)],
                         ids=["Cl5", "Cl4"])
@pytest.mark.parametrize("exact", [True, False])
def test_card_pair_backward_launch(monkeypatch, metric, rows, grid, exact):
    """On the card the fast backward asks the tile kernel's shared memory,
    cuts the grid for its steps and hands it a partial slice of the
    gradient vector's length; the exact one keeps the row kernel's."""
    alg = get_algebra(metric)
    kern = ck.block_kernel(alg.n_blades)
    x, params, dout = _block(alg, 3, 2, rows, 9)
    on = [torch.Tensor._make_subclass(_OnCard, t) for t in
          [x, dout] + params]
    calls, smem_asked = [], []

    def entry(*args):
        calls.append(args)
        return 0

    class _Props:
        multi_processor_count = 132

    class _Stream:
        cuda_stream = 77

    def smem(k, cin, c, backward, ex=True):
        smem_asked.append((cin, c, backward, ex))
        return 170_000

    monkeypatch.setattr(ck, "_fn", lambda *a: entry)
    monkeypatch.setattr(ck, "_tables", lambda k, a, d: (np.zeros(
        alg.n_blades, np.float32), 0))
    monkeypatch.setattr(ck, "_smem", smem)
    monkeypatch.setattr(ck, "_partial_floats",
                        lambda k, cin, c, n, ex=True: n if not ex else n + 5)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: _Props())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    empties = []
    real_empty = torch.empty

    def spy_empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        empties.append(tuple(t.shape))
        return t

    monkeypatch.setattr(torch, "empty", spy_empty)
    before = kern.bwd.count
    ck.block_backward(on[0], on[1], on[2:], alg, exact)
    assert kern.bwd.count == before + 1
    assert smem_asked == [(3, 2, True, exact)]
    n_grad = sum(p.numel() for p in params)
    want_grid = grid if not exact else min(132, -(-rows // kern.rows_bwd))
    assert calls[0][-2] == want_grid and calls[0][-3] == int(not exact)
    assert (want_grid, n_grad + (5 if exact else 0)) in empties


@pytest.mark.parametrize("metric,rows,grid", [((1.0,) * 5, 41, 6),
                                              ((1.0,) * 4, 41, 3)],
                         ids=["Cl5", "Cl4"])
@pytest.mark.parametrize("exact", [True, False])
def test_card_pair_forward_launch(monkeypatch, metric, rows, grid, exact):
    """On the card the fast forward asks the row tile forward's shared
    memory and cuts the grid for its steps (8 rows at Cl(5), 16 at Cl(4));
    the exact one keeps the row kernel's (8 and 16 rows a CTA tile)."""
    alg = get_algebra(metric)
    kern = ck.block_kernel(alg.n_blades)
    x, params, _ = _block(alg, 3, 2, rows, 10)
    on = [torch.Tensor._make_subclass(_OnCard, t) for t in [x] + params]
    calls, smem_asked = [], []

    def entry(*args):
        calls.append(args)
        return 0

    class _Props:
        multi_processor_count = 132

    class _Stream:
        cuda_stream = 77

    def smem(k, cin, c, backward, ex=True):
        smem_asked.append((cin, c, backward, ex))
        return 170_000

    monkeypatch.setattr(ck, "_fn", lambda *a: entry)
    monkeypatch.setattr(ck, "_tables", lambda k, a, d: (np.zeros(
        alg.n_blades, np.float32), 0))
    monkeypatch.setattr(ck, "_smem", smem)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: _Props())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    before = (kern.fwd.count, kern.bwd.count)
    out = ck.block_forward(on[0], on[1:], alg, exact)
    assert (kern.fwd.count, kern.bwd.count) == (before[0] + 1, before[1])
    assert tuple(out.shape) == (rows, 2, alg.n_blades)
    assert smem_asked == [(3, 2, False, exact)]
    want_grid = grid if not exact else -(-rows // kern.rows_fwd)
    assert calls[0][-2] == want_grid and calls[0][-3] == int(not exact)
    assert len(calls) == 1


def test_pair_terms_header_is_the_generators():
    """csrc/pair_terms.cuh is what tools/pair_terms.py writes today."""
    with open(pt.HEADER) as f:
        assert f.read() == pt.header_text()
    assert pt.main(["--check"]) == 0


@pytest.mark.parametrize("dim", pt.DIMS, ids=["Cl5", "Cl4"])
def test_pair_terms_are_the_pair_tables(dim):
    """Every Cayley pair (j, k) is one term, with the left blade, sign and
    grade path of the port's pair tables; the left blade and sign are the
    reference's structural pair table S4 (its first channel block) and the
    path the reference algebra's; the terms run in path order, `first` on
    the first of each path."""
    metric = (1.0,) * dim
    alg = get_algebra(metric)
    nb = alg.n_blades
    i_of, coeff = alg.gp_pair_tables
    terms = pt.terms(dim)
    assert len(terms) == nb * nb
    lp = jck._round_up(nb, 128)
    s4 = np.asarray(jck._structural_tables(dim, metric, 1, lp)[5])
    s0 = s4[:nb * nb, :nb]                      # [(i, k), j] -> sign
    assert np.count_nonzero(s0) == nb * nb
    jalg = jax_algebra(metric)
    g = np.asarray(jalg.blade_to_grade)
    idx = np.argwhere(jalg.geometric_product_paths)
    jpath = {tuple(t): p for p, t in enumerate(idx.tolist())}
    seen, prev, paths = set(), -1, set()
    for t in terms:
        j, k, i, neg, path, first = pt.decode(t)
        assert (j, k) not in seen
        seen.add((j, k))
        sign = -1.0 if neg else 1.0
        assert i == i_of[j, k] and sign == coeff[j, k]
        assert path == alg.gp_pair_paths[j, k]
        assert s0[i * nb + k, j] == sign
        assert path == jpath[(g[i], g[j], g[k])]
        assert path >= prev and first == (path not in paths)
        prev = path
        paths.add(path)
    assert len(seen) == nb * nb and len(paths) == alg.n_product_paths


def test_pair_instance_shapes_take_one_shape_per_instance(monkeypatch):
    """chip_smoke's choice of the shapes at which it holds each instance of
    the K3p row tiles to the plain version, on a stand-in library: the
    exact mode takes inputs up to 60 at C <= 20 and 30 at C 21-24, nothing
    past; the tiles hold 16 weight-gradient tiles a warp up to Cin 20, 24
    up to 45, else 32.  Each instance is taken at the narrowest C >= C_MIN
    at the widest input the exact mode takes there; then the widest C."""
    cs = _smoke()
    kb = ck.PAIR

    def row(cin, c, bwd):
        lim = 60 if c <= 20 else 30 if c <= 24 else 0
        return 1000 if cin <= lim else 0

    def maxt(cin, c):
        return 16 if cin <= 20 else 24 if cin <= 45 else 32

    lib = _Lib(**{f"{kb.symbol}_smem_bytes": row,
                  f"{kb.symbol}_tile_smem_bytes": lambda cin, c: 2000,
                  f"{kb.symbol}_tile_maxt": maxt})
    monkeypatch.setattr(_build, "load", lambda name: lib)
    assert cs.C_MIN == 4
    assert cs.pair_tile_instance_shapes(kb) == [
        (20, 4, True, 16), (45, 4, True, 24), (60, 4, True, 32),
        (30, 24, True, 24)]


@pytest.mark.parametrize("narrow", [False, True])
def test_pair_widths_fast_takes_what_exact_takes(monkeypatch, capsys,
                                                 narrow):
    """print_pair_smem compares both modes' widest inputs at every C and
    raises where the fast mode's is the narrower."""
    cs = _smoke()

    def lib_of(kb):
        def row(cin, c, bwd):
            return 1000 if c <= 3 and cin <= 50 else 0

        def tile(cin, c):
            lim = 40 if narrow and c == 2 else 70
            return 2000 if cin <= lim else 0

        return _Lib(**{f"{kb.symbol}_smem_bytes": row,
                       f"{kb.symbol}_tile_smem_bytes": tile,
                       f"{kb.symbol}_tile_maxt": lambda cin, c: 16})

    libs = {k.source: lib_of(k) for k in PAIRS}
    monkeypatch.setattr(_build, "load", lambda name: libs[name])
    monkeypatch.setattr(ck, "_smem", lambda k, cin, c, b, e=True: 1)
    assert cs.pair_caps(ck.PAIR) == {c: (50, 40 if narrow and c == 2 else 70)
                                     for c in (1, 2, 3)}
    if narrow:
        with pytest.raises(AssertionError, match=r"C = \[2\]"):
            cs.print_pair_smem([(5, 34, 28)])
    else:
        cs.print_pair_smem([(5, 34, 28), (4, 56, 28)])
        out = capsys.readouterr().out
        assert "Cl(5): at every C the fast-mode K3p takes" in out
        assert "Cl(4): at every C the fast-mode K3p takes" in out


@pytest.mark.parametrize("narrow", [False, True])
def test_pair_fwd_widths_fast_takes_what_exact_takes(monkeypatch, capsys,
                                                     narrow):
    """print_pair_fwd_widths compares the forward's two modes' widest
    inputs at every C, at Cl(5) and Cl(4), from the row kernel's forward
    entry and the row tile forward's, and raises where the fast mode's is
    the narrower."""
    cs = _smoke()

    def lib_of(kb):
        def row(cin, c, bwd):
            assert bwd == 0
            return 1000 if c <= 3 and cin <= 50 else 0

        def tile(cin, c):
            lim = 40 if narrow and c == 3 and kb is ck.PAIR_CL4 else 70
            return 2000 if cin <= lim else 0

        return _Lib(**{f"{kb.symbol}_smem_bytes": row,
                       f"{kb.symbol}_fwd_tile_smem_bytes": tile})

    libs = {k.source: lib_of(k) for k in PAIRS}
    monkeypatch.setattr(_build, "load", lambda name: libs[name])
    monkeypatch.setattr(ck, "_smem", lambda k, cin, c, b, e=True: 1)
    assert cs.pair_caps(ck.PAIR, backward=False) == {
        c: (50, 70) for c in (1, 2, 3)}
    if narrow:
        with pytest.raises(AssertionError, match=r"K2p at Cl\(4\).*C = \[3\]"):
            cs.print_pair_fwd_widths()
    else:
        cs.print_pair_fwd_widths()
        out = capsys.readouterr().out
        assert "Cl(5): at every C the fast-mode K2p takes" in out
        assert "Cl(4): at every C the fast-mode K2p takes" in out
    # the K2p shapes chip_smoke holds to the plain version: the widest
    # input at C_MIN and at the widest C
    if not narrow:
        caps = {c: (60 - c, 70) for c in range(1, 30)}
        monkeypatch.setattr(cs, "pair_caps", lambda kb, backward=True: caps)
        assert cs.pair_fwd_shapes(ck.PAIR) == [(56, 4), (31, 29)]


def test_tile_phases_marks_every_barrier_of_the_step():
    """tools/tile_phases.py marks each phase of the tile kernel's step at
    its barriers, in the step function (pair_tile_block_backward,
    pair_tile_block_forward) and in the kernel's step loop; the marks fit
    today's header (a structural change there makes the tool raise instead
    of mislabelling phases)."""
    from csmpn_torch.tools import tile_phases as tp

    with open(os.path.join(_build.CSRC, "cemlp_pair_tile.cuh")) as f:
        src = f.read()
    marked = tp.marked_header(src)
    barriers = len(tp.PHASES) - 1
    assert marked.count("__syncthreads(); PH_WAIT(") == barriers
    assert marked.count("PH_BUSY(%d);" % barriers) == 1   # the path phase
    assert marked.count("  PH_FLUSH();") == 1
    # phase 0 ends at the kernel loop's first barrier
    assert marked.index(tp.LOOP_MARK) < \
        marked.index("PH_BUSY(0); __syncthreads(); PH_WAIT(0);")
    step_f1 = "  pt_f1<A, P>(b, L, c, warp, lane);  // Y = X W1 -> fa\n"
    assert src.count(step_f1 + "  __syncthreads();\n") == 1
    with pytest.raises(RuntimeError, match="barriers"):
        tp.marked_header(src.replace(step_f1 + "  __syncthreads();\n",
                                     step_f1, 1))
    # the forward's step: a mark at each of its barriers, the flush at the
    # kernel's end, the marks defined by the backward's header only
    with open(os.path.join(_build.CSRC, "cemlp_pair_fwd_tile.cuh")) as f:
        fsrc = f.read()
    fmarked = tp.marked_header(fsrc, forward=True)
    assert fmarked.count("__syncthreads(); PH_WAIT(") == len(tp.FWD_PHASES)
    assert fmarked.count("  PH_FLUSH();") == 1
    assert "g_phase" not in fmarked and "g_phase" in marked
    with pytest.raises(RuntimeError, match="barriers"):
        tp.marked_header(fsrc.replace("    __syncthreads();\n", "", 1),
                         forward=True)
