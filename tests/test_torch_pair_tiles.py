"""Host-side code of the fast-mode row tile backward of the pair form (K3p
at Cl(5,0) and Cl(4,0), csrc/cemlp_pair_tile.cuh): which launches take the
tile kernel, the shared-memory entry points each launch asks, the CTA
steps the grid is cut for, the partial vector the tile kernel writes and
how it splits into the flax shapes, that the CPU wrapper takes the plain
version and counts no launch, and the shapes at which chip_smoke.py checks
each tile kernel instance and the widths it compares between the modes.

The kernel itself runs only on the card; chip_smoke.py holds it to the
plain version there.  A stand-in library takes the place of the compiled
one where a wrapper asks it for sizes.  Small widths throughout.
"""
import ctypes
import importlib
import os
import sys

import numpy as np
import pytest
import torch

from csmpn_torch.algebra import get_algebra
from csmpn_torch.ops import _build
from csmpn_torch.ops import cemlp_kernel as ck

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
    assert ck._tiled(kern, True, False)
    assert not ck._tiled(kern, True, True)
    assert not ck._tiled(kern, False, False)
    if kern.form == "pair":
        assert kern.n_blades in (16, 32)
        assert ck._tile_rows(kern) * kern.n_blades == ck.PAIR_TILE_PAIRS


@pytest.mark.parametrize("kern", PAIRS, ids=lambda k: k.label)
@pytest.mark.parametrize("backward,exact,entry", [
    (True, False, "tile_smem_bytes"), (True, True, "smem_bytes"),
    (False, False, "smem_bytes"), (False, True, "smem_bytes")])
def test_pair_smem_asks_the_entry_of_the_launch(monkeypatch, kern, backward,
                                                exact, entry):
    lib = _Lib(**{f"{kern.symbol}_smem_bytes": _Entry(1000),
                  f"{kern.symbol}_tile_smem_bytes": _Entry(2000)})
    monkeypatch.setattr(_build, "load", lambda name: lib)
    got = ck._smem(kern, 34, 28, backward, exact)
    called = getattr(lib, f"{kern.symbol}_{entry}")
    assert got == (2000 if entry == "tile_smem_bytes" else 1000)
    want = (34, 28) if entry == "tile_smem_bytes" else (34, 28, int(backward))
    assert called.calls == [want]
    assert called.argtypes == [ctypes.c_int] * len(want)


@pytest.mark.parametrize("kern", PAIRS, ids=lambda k: k.label)
def test_pair_smem_raises_where_the_tiles_do_not_fit(monkeypatch, kern):
    lib = _Lib(**{f"{kern.symbol}_smem_bytes": _Entry(1000),
                  f"{kern.symbol}_tile_smem_bytes": _Entry(0)})
    monkeypatch.setattr(_build, "load", lambda name: lib)
    with pytest.raises(NotImplementedError, match="fast mode"):
        ck._smem(kern, 500, 28, True, False)
    assert ck._smem(kern, 500, 28, True, True) == 1000


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


def test_tile_phases_marks_every_barrier_of_the_step():
    """tools/tile_phases.py marks each phase of the tile kernel's step at
    its barriers; the marks fit today's header (a structural change there
    makes the tool raise instead of mislabelling phases)."""
    from csmpn_torch.tools import tile_phases as tp

    with open(os.path.join(_build.CSRC, "cemlp_pair_tile.cuh")) as f:
        src = f.read()
    marked = tp.marked_header(src)
    barriers = len(tp.PHASES) - 1
    assert marked.count("__syncthreads(); PH_WAIT(") == barriers
    assert marked.count("PH_BUSY(%d);" % barriers) == 1   # the path phase
    assert marked.count("  PH_FLUSH();") == 1
    with pytest.raises(RuntimeError, match="barriers"):
        tp.marked_header(src.replace("    __syncthreads();\n", "", 1))
