"""Host-side code of the fast-mode row tile kernels of the dense form at
Cl(3,0) and Cl(2,0) over csrc/cemlp_tile.cuh: the block kernels K2 and
K3, the fused backward K5 and forward K4 (the pair form's K2p and K3p have
their own in tests/test_torch_pair_tiles.py): which launches take the
tile kernels, the shared-memory entry points they ask, the CTA steps the
grid is cut for (and, for K2, the CTAs an SM holds by the occupancy
entry), the partial layouts the tile kernels write, that the CPU wrappers
take the plain versions and count no launch, the shapes at which
chip_smoke.py checks each tile kernel instance and the widths it compares
between the modes.

The kernels themselves run only on the card; chip_smoke.py holds them to
the plain versions there.  A stand-in library takes the place of the
compiled one where a wrapper asks it for sizes.  Small widths throughout.
"""
import ctypes

import numpy as np
import pytest
import torch

from csmpn_torch.algebra import get_algebra
from csmpn_torch.ops import _build
from csmpn_torch.ops import cemlp_kernel as ck
from csmpn_torch.ops import fused_egcl as fe

KERNELS = [ck.DENSE, ck.DENSE_CL2, ck.PAIR, ck.PAIR_CL4]


@pytest.mark.parametrize("kern", KERNELS, ids=lambda k: k.label)
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("exact", [False, True])
def test_tiled_takes_only_the_fast_dense_backward(kern, backward, exact):
    """Every fast-mode launch of the block kernels is tiled, of both forms
    and directions (K2 and K3 on csrc/cemlp_tile.cuh, K2p and K3p on the
    pair form's tiles); every exact-mode launch keeps its row kernel."""
    assert ck._tiled(kern, backward, exact) == (not exact)


def test_dense_kernels_step_16_rows_in_fast_backward():
    assert ck.TILE_ROWS == 16
    for kern in (ck.DENSE, ck.DENSE_CL2):
        assert kern.rows_bwd == 8
        assert ck._tiled(kern, True, False)
        assert ck._tile_rows(kern) == 16
    # the pair form's tiles step over 128 (row, blade) pairs
    for kern, rows in ((ck.PAIR, 4), (ck.PAIR_CL4, 8)):
        assert ck._tiled(kern, True, False)
        assert ck._tile_rows(kern) == rows


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


class _Fn(_Entry):
    """A C entry point computed by a Python function."""

    def __init__(self, fn):
        super().__init__(None)
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)


@pytest.mark.parametrize("kern", [ck.DENSE, ck.DENSE_CL2],
                         ids=lambda k: k.label)
@pytest.mark.parametrize("backward,exact,entry", [
    (True, False, "tile_smem_bytes"), (True, True, "smem_bytes"),
    (False, False, "fwd_tile_smem_bytes"), (False, True, "smem_bytes")])
def test_smem_asks_the_entry_of_the_launch(monkeypatch, kern, backward,
                                           exact, entry):
    sizes = {"smem_bytes": 1000, "tile_smem_bytes": 2000,
             "fwd_tile_smem_bytes": 3000}
    lib = _Lib(**{f"{kern.symbol}_{k}": _Entry(v) for k, v in sizes.items()})
    monkeypatch.setattr(_build, "load", lambda name: lib)
    got = ck._smem(kern, 34, 28, backward, exact)
    assert got == sizes[entry]
    want_args = (34, 28) if entry != "smem_bytes" else (34, 28,
                                                        int(backward))
    for k in sizes:
        called = getattr(lib, f"{kern.symbol}_{k}")
        assert called.calls == ([want_args] if k == entry else [])
    called = getattr(lib, f"{kern.symbol}_{entry}")
    assert called.argtypes == [ctypes.c_int] * len(want_args)


def test_smem_raises_where_the_tile_backward_does_not_fit(monkeypatch):
    lib = _Lib(csmpn_cemlp_cl2_smem_bytes=_Entry(1000),
               csmpn_cemlp_cl2_tile_smem_bytes=_Entry(0))
    monkeypatch.setattr(_build, "load", lambda name: lib)
    with pytest.raises(NotImplementedError, match="fast mode"):
        ck._smem(ck.DENSE_CL2, 64, 64, True, False)
    assert ck._smem(ck.DENSE_CL2, 64, 64, True, True) == 1000


@pytest.mark.parametrize("kern", [fe.DENSE, fe.DENSE_CL2],
                         ids=lambda k: k.label)
@pytest.mark.parametrize("size,fits", [(200_000, True), (0, False)])
@pytest.mark.parametrize("backward", [True, False])
def test_fused_tile_check(monkeypatch, kern, size, fits, backward):
    """The fast-mode K5 (backward) and K4 (forward) each ask their own
    entry; 0 raises."""
    entry, other = _Entry(size), _Entry(size)
    name = "tile_smem_bytes" if backward else "fwd_tile_smem_bytes"
    rest = "fwd_tile_smem_bytes" if backward else "tile_smem_bytes"
    lib = _Lib(**{f"{kern.symbol}_{name}": entry,
                  f"{kern.symbol}_{rest}": other})
    monkeypatch.setattr(_build, "load", lambda name: lib)
    fe._check_tile_smem.cache_clear()
    try:
        if fits:
            fe._check_tile_smem(kern, 28, 3, 28, backward)
        else:
            with pytest.raises(NotImplementedError,
                               match="fast-mode " + ("backward" if backward
                                                     else "forward")):
                fe._check_tile_smem(kern, 28, 3, 28, backward)
    finally:
        fe._check_tile_smem.cache_clear()
    assert entry.calls == [(28, 3, 28, kern.wn)]
    assert other.calls == []


@pytest.mark.parametrize("rows,smem,per_cta,want", [
    (23_200, 160_000, 16, 132),    # one CTA an SM, 1,450 steps
    (40, 160_000, 16, 3),          # fewer steps than SMs
    (40, 160_000, 8, 5),
    (23_200, 50_000, 16, 528),     # four CTAs an SM
])
def test_grid_counts_steps_of_the_launch(monkeypatch, rows, smem, per_cta,
                                         want):
    class _Props:
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: _Props())
    assert ck._grid(rows, "cuda", smem, per_cta) == want


def _flax_vector(cin, c, ng, npath, rng):
    """A K3 partial vector of random entries and the 10 tensors it holds,
    in grad_floats' (flax) order."""
    shapes = [(c, cin, ng), (c, 1), (c, ng), (c, ng), (c, npath),
              (c, c, ng), (c, ng), (c, c, ng), (c, 1), (c,)]
    parts = [rng.randn(*s).astype(np.float32) for s in shapes]
    return np.concatenate([p.reshape(-1) for p in parts]), parts


@pytest.mark.parametrize("nb,ng,npath", [(8, 4, 20), (4, 3, 10)])
def test_k3_partial_vector_splits_into_flax_shapes(nb, ng, npath):
    """The tile K3 writes its partials in grad_floats' layout, which
    _split_grads reads back tensor by tensor."""
    cin, c = 5, 3
    vec, parts = _flax_vector(cin, c, ng, npath, np.random.RandomState(nb))
    shapes = [torch.empty(p.shape) for p in parts]
    got = ck._split_grads(torch.from_numpy(vec), shapes)
    for g, p in zip(got, parts):
        np.testing.assert_array_equal(g.numpy(), p)


@pytest.mark.parametrize("kern", [fe.DENSE, fe.DENSE_CL2],
                         ids=lambda k: k.label)
def test_k5_slice_maps_entries_where_the_tile_kernel_writes_them(kern):
    """The tile K5 writes weight-gradient entry (m, n, g) of a block at
    ((m * G + g) * C + n) of its slice, then the per-channel rows; a
    vector holding each entry's own coordinates comes back in flax shapes
    with every entry in place."""
    cin, c, ng = 5, 3, kern.n_grades
    n1, nc = cin * ng * c, c * ng * c
    v = np.zeros(fe.block_part_floats(kern, cin, c), np.float32)
    for which, m_max, off in ((0, cin, 0), (1, c, n1), (2, c, n1 + nc)):
        for m in range(m_max):
            for g in range(ng):
                for n in range(c):
                    v[off + (m * ng + g) * c + n] = (
                        1000 * which + 100 * m + 10 * g + n)
    loc = np.arange(kern.nloc * c, dtype=np.float32) + 0.5
    v[n1 + 2 * nc:] = loc
    na = torch.zeros(c, ng)
    grads = fe._block_grads(torch.from_numpy(v), cin, c, na, kern)
    for which, idx in ((0, 0), (1, 5), (2, 7)):
        t = grads[idx].numpy()
        for n in range(t.shape[0]):
            for m in range(t.shape[1]):
                for g in range(ng):
                    assert t[n, m, g] == 1000 * which + 100 * m + 10 * g + n
    loc = loc.reshape(kern.nloc, c)
    np.testing.assert_array_equal(grads[1].numpy().reshape(-1), loc[0])
    np.testing.assert_array_equal(grads[9].numpy(), loc[-1])
    # d sigmoid(a) chained to a at a = 0: times 1/4
    ns = 1 + 2 * ng + kern.n_paths
    np.testing.assert_allclose(grads[6].numpy(),
                               loc[ns:ns + ng].T * 0.25, rtol=0, atol=0)


@pytest.mark.parametrize("metric", [(1.0, 1.0, 1.0), (1.0, 1.0)],
                         ids=["Cl3", "Cl2"])
@pytest.mark.parametrize("exact", [True, False])
def test_cpu_block_backward_is_plain_and_counts_no_launch(metric, exact):
    alg = get_algebra(metric)
    nb, ng, npath = alg.n_blades, len(set(alg.blade_to_grade.tolist())), \
        alg.n_product_paths
    gen = torch.Generator().manual_seed(3)
    cin, c, rows = 5, 3, 19
    shapes = [(c, cin, ng), (c, 1), (c, ng), (c, ng), (c, npath),
              (c, c, ng), (c, ng), (c, c, ng), (c, 1), (c,)]
    params = [0.3 * torch.randn(*s, generator=gen) for s in shapes]
    x = torch.randn(rows, cin, nb, generator=gen)
    dout = torch.randn(rows, c, nb, generator=gen)
    kern = ck.block_kernel(nb)
    before = (kern.fwd.count, kern.bwd.count)
    dx, grads = ck.block_backward(x, dout, params, alg, exact)
    rdx, rgrads = ck.block_backward_plain(x, dout, params, alg, exact)
    assert (kern.fwd.count, kern.bwd.count) == before
    assert torch.equal(dx, rdx)
    for g, r in zip(grads, rgrads):
        assert torch.equal(g, r)


@pytest.mark.parametrize("metric", [(1.0, 1.0, 1.0), (1.0, 1.0)],
                         ids=["Cl3", "Cl2"])
@pytest.mark.parametrize("exact", [True, False])
def test_cpu_block_forward_is_plain_and_counts_no_launch(metric, exact):
    """On a CPU tensor K2's wrapper, in fast mode too, is its plain version
    and launches nothing (nor asks the library for sizes)."""
    alg = get_algebra(metric)
    nb, ng, npath = alg.n_blades, len(set(alg.blade_to_grade.tolist())), \
        alg.n_product_paths
    gen = torch.Generator().manual_seed(4)
    cin, c, rows = 5, 3, 19
    shapes = [(c, cin, ng), (c, 1), (c, ng), (c, ng), (c, npath),
              (c, c, ng), (c, ng), (c, c, ng), (c, 1), (c,)]
    params = [0.3 * torch.randn(*s, generator=gen) for s in shapes]
    x = torch.randn(rows, cin, nb, generator=gen)
    kern = ck.block_kernel(nb)
    before = (kern.fwd.count, kern.bwd.count)
    got = ck.block_forward(x, params, alg, exact)
    assert (kern.fwd.count, kern.bwd.count) == before
    assert torch.equal(got, ck.block_forward_plain(x, params, alg, exact))


@pytest.mark.parametrize("metric", [(1.0, 1.0, 1.0), (1.0, 1.0)],
                         ids=["Cl3", "Cl2"])
@pytest.mark.parametrize("exact", [True, False])
def test_cpu_mp_backward_is_plain_and_counts_no_launch(metric, exact):
    alg = get_algebra(metric)
    nb = alg.n_blades
    ng = len(set(alg.blade_to_grade.tolist()))
    npath = alg.n_product_paths
    gen = torch.Generator().manual_seed(5)
    cm, ca, c, n, e = 3, 1, 3, 6, 11
    params = []
    for cin in (cm + ca, c):
        shapes = [(c, cin, ng), (c, 1), (c, ng), (c, ng), (c, npath),
                  (c, c, ng), (c, ng), (c, c, ng), (c, 1), (c,)]
        params += [0.3 * torch.randn(*s, generator=gen) for s in shapes]
    h = torch.randn(n, cm, nb, generator=gen)
    hj = torch.randn(e, cm, nb, generator=gen)
    attr = torch.randn(e, ca, nb, generator=gen)
    dst = torch.sort(torch.randint(0, n, (e,), generator=gen)).values
    mask = torch.rand(e, generator=gen) > 0.3
    dagg = torch.randn(n, c, nb, generator=gen)
    kern = fe.fused_kernel(nb)
    before = (kern.fwd.count, kern.bwd.count)
    got = fe.mp_backward(params, alg, h, hj, attr, dst, mask, dagg, exact)
    want = fe.message_aggregate_grad_plain(params, alg, h, hj, attr, dst,
                                           mask, dagg, exact)
    assert (kern.fwd.count, kern.bwd.count) == before
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    for g, w in zip(got[3], want[3]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("metric", [(1.0, 1.0, 1.0), (1.0, 1.0)],
                         ids=["Cl3", "Cl2"])
@pytest.mark.parametrize("exact", [True, False])
def test_cpu_mp_forward_is_plain_and_counts_no_launch(metric, exact):
    alg = get_algebra(metric)
    nb = alg.n_blades
    ng = len(set(alg.blade_to_grade.tolist()))
    npath = alg.n_product_paths
    gen = torch.Generator().manual_seed(6)
    cm, ca, c, n, e = 3, 1, 3, 6, 11
    params = []
    for cin in (cm + ca, c):
        shapes = [(c, cin, ng), (c, 1), (c, ng), (c, ng), (c, npath),
                  (c, c, ng), (c, ng), (c, c, ng), (c, 1), (c,)]
        params += [0.3 * torch.randn(*s, generator=gen) for s in shapes]
    h = torch.randn(n, cm, nb, generator=gen)
    hj = torch.randn(e, cm, nb, generator=gen)
    attr = torch.randn(e, ca, nb, generator=gen)
    dst = torch.sort(torch.randint(0, n, (e,), generator=gen)).values
    mask = torch.rand(e, generator=gen) > 0.3
    kern = fe.fused_kernel(nb)
    before = (kern.fwd.count, kern.bwd.count)
    got = fe.mp_forward(params, alg, h, hj, attr, dst, mask, exact)
    want = fe.message_aggregate_plain(params, alg, h, hj, attr, dst, mask,
                                      False, exact)
    assert (kern.fwd.count, kern.bwd.count) == before
    assert torch.equal(got, want)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that the wrapper
    takes its kernel path with a stand-in library."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("kern", [ck.DENSE, ck.DENSE_CL2],
                         ids=lambda k: k.label)
@pytest.mark.parametrize("exact,blocks,grid", [
    (True, 2, 625),     # the row kernel: 8-row tiles, 8 CTAs an SM by smem
    (False, 2, 264),    # 313 steps of 16 rows, 2 CTAs an SM
    (False, 1, 132),
    (False, 0, 0)])     # no CTA fits an SM: raises, no launch
def test_card_block_forward_launch(monkeypatch, kern, exact, blocks, grid):
    """On the card the fast K2 asks the row tile forward's entries, its
    shared memory and the CTAs of its instance an SM holds (the occupancy
    entry), and launches once on that many CTAs an SM, cut to its steps;
    the exact K2 asks the row kernel's entry and sizes its grid by shared
    memory.  Each launch counts one."""
    alg = get_algebra((1.0,) * (3 if kern is ck.DENSE else 2))
    nb, ng, npath = alg.n_blades, kern.n_grades, kern.n_paths
    gen = torch.Generator().manual_seed(8)
    cin, c, rows = 5, 3, 5000
    shapes = [(c, cin, ng), (c, 1), (c, ng), (c, ng), (c, npath),
              (c, c, ng), (c, ng), (c, c, ng), (c, 1), (c,)]
    ins = [torch.randn(rows, cin, nb, generator=gen)] + [
        torch.randn(*s, generator=gen) for s in shapes]
    on = [torch.Tensor._make_subclass(_OnCard, t) for t in ins]
    def plan(cin_, c_, info):
        info[0], info[1], info[2] = 1, 16, 40_000
        return 90_000

    entries = {"smem_bytes": _Entry(1000), "fwd_tile_smem_bytes":
               _Entry(90_000), "fwd_tile_blocks": _Entry(blocks),
               "fwd_tile_plan": _Fn(plan), "fwd": _Entry(0)}
    lib = _Lib(**{f"{kern.symbol}_{k}": e for k, e in entries.items()})

    class _Props:
        multi_processor_count = 132

    class _Stream:
        cuda_stream = 77

    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(ck, "_tables", lambda k, a, d: (np.zeros(
        nb, np.float32), 0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: _Props())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    ck._fwd_tile_launch.cache_clear()
    before = (kern.fwd.count, kern.bwd.count)
    try:
        if grid == 0:
            with pytest.raises(RuntimeError, match="fits no CTA"):
                ck.block_forward(on[0], on[1:], alg, exact)
        else:
            out = ck.block_forward(on[0], on[1:], alg, exact)
            assert tuple(out.shape) == (rows, c, nb)
    finally:
        ck._fwd_tile_launch.cache_clear()
    assert (kern.fwd.count, kern.bwd.count) == (before[0] + (grid > 0),
                                                before[1])
    assert entries["smem_bytes"].calls == ([(cin, c, 0)] if exact else [])
    assert entries["fwd_tile_smem_bytes"].calls == ([] if exact
                                                    else [(cin, c)])
    assert entries["fwd_tile_blocks"].calls == ([] if exact else [(cin, c)])
    assert len(entries["fwd"].calls) == int(grid > 0)
    if grid:   # ... out, img, rows, cin, c, fast, grid, stream; img is the
        # fast K2's parameter image (the plan's bytes), else null
        args = entries["fwd"].calls[0]
        assert len(args) == 21
        assert args[-6:] == (rows, cin, c, int(not exact), grid, 77)
        assert (args[-7] == 0) == exact


@pytest.mark.parametrize("kern", [fe.DENSE, fe.DENSE_CL2],
                         ids=lambda k: k.label)
@pytest.mark.parametrize("exact,tile_bytes", [(True, 2000), (False, 2000),
                                              (False, 0)])
def test_card_mp_forward_launch(monkeypatch, kern, exact, tile_bytes):
    """On the card the fast K4 asks the row tile forward's entry (the
    exact one does not) before its one launch; where the tile forward does
    not take the widths the call routes to K4w/K5w, and with their entry
    refusing too it raises without a launch, naming both reasons; the grid
    is one CTA an SM at most, cut for the windows."""
    alg = get_algebra((1.0,) * (3 if kern is fe.DENSE else 2))
    nb = alg.n_blades
    ng, npath = kern.n_grades, kern.n_paths
    gen = torch.Generator().manual_seed(7)
    cm, ca, c, n, e = 3, 1, 3, 70, 40
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
    calls = {"smem_bytes": [], "fwd_tile_smem_bytes": [],
             "tile_smem_bytes": [], "fwd": []}

    def fn(name, value):
        def entry(*args):
            calls[name].append(args)
            return value
        return entry

    fns = {"smem_bytes": fn("smem_bytes", 1000),
           "fwd_tile_smem_bytes": fn("fwd_tile_smem_bytes", tile_bytes),
           "tile_smem_bytes": fn("tile_smem_bytes", 2000),
           "fwd": fn("fwd", 0)}

    def wide_range(out):
        out[0], out[1] = 128, 320

    # the wide kernels' library refuses these widths
    wide = {"smem_bytes": lambda *a: 0, "range": wide_range}

    class _Props:
        multi_processor_count = 132

    class _Stream:
        cuda_stream = 77

    monkeypatch.setattr(fe, "_lib_fn", lambda k, name, *a: (
        wide if k in fe._WIDE else fns)[name])
    monkeypatch.setattr(fe, "_tables", lambda k, a, d: (np.zeros(
        nb, np.float32), 0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: _Props())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    fe._check_smem.cache_clear()
    fe._check_tile_smem.cache_clear()
    fe._wide_range.cache_clear()
    before = (kern.fwd.count, kern.bwd.count)
    try:
        if tile_bytes == 0:
            with pytest.raises(NotImplementedError,
                               match="fast-mode forward.*take at most 128 "
                                     "channels and 320"):
                fe.mp_forward(on[4:], alg, *on[:4], None, exact)
        else:
            out = fe.mp_forward(on[4:], alg, *on[:4], None, exact)
            assert tuple(out.shape) == (n, c, nb)
    finally:
        fe._check_smem.cache_clear()
        fe._check_tile_smem.cache_clear()
        fe._wide_range.cache_clear()
    launched = tile_bytes != 0
    assert (kern.fwd.count, kern.bwd.count) == (before[0] + launched,
                                                before[1])
    assert calls["fwd_tile_smem_bytes"] == ([] if exact
                                            else [(cm, ca, c, kern.wn)])
    assert len(calls["fwd"]) == int(launched)
    if launched:   # ... n_nodes, cm, ca, c, wn, n_win, fast, grid, stream
        n_win = -(-n // kern.wn)
        assert calls["fwd"][0][-9:-1] == (n, cm, ca, c, kern.wn, n_win,
                                          int(not exact), n_win)


def _smoke():
    import importlib
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


def test_instance_shapes_take_one_shape_per_instance(monkeypatch):
    """chip_smoke's choice of the shapes at which it holds each tile
    kernel instance to its plain version, on a stand-in library: K3 takes
    inputs up to 100 (16 tiles a warp up to 30, 24 up to 60, else the
    chunked instance at 40), its exact mode up to 50; K5's sweeps take
    Cm up to 40 (sweep 1: 16 tiles a warp up to C = 20, else 24; sweep 2:
    16 up to Cm = 20, else 32), its exact mode Cm up to 30.  Each instance
    is taken at the narrowest C >= C_MIN at its widest input there,
    one the exact mode takes where there is one; a shape two instances
    share is taken once."""
    cs = _smoke()
    kb, kf = ck.DENSE, fe.DENSE

    def plan(cin, c, info):
        m = 16 if cin <= 30 else 24 if cin <= 60 else 40
        ok = cin <= 100
        info[0], info[1], info[2] = ((m, 2 if cin > 80 else 1, 64) if ok
                                     else (0, 0, 0))
        return 150_000 if ok else 0

    lib = _Lib(**{f"{kb.symbol}_smem_bytes":
                  lambda cin, c, bwd: 1000 if cin <= 50 else 0,
                  f"{kb.symbol}_tile_plan": plan})
    monkeypatch.setattr(_build, "load", lambda name: lib)

    def maxt5(cm, ca, c, wn, sweep):
        if cm > 40:
            return 0
        if sweep == 1:
            return 16 if c <= 20 else 24
        return 16 if cm <= 20 else 32

    fns = {"smem_bytes": lambda cm, ca, c, wn, bwd: 1000 if cm <= 30 else 0,
           "tile_maxt": maxt5}
    monkeypatch.setattr(fe, "_lib_fn", lambda k, name, *a: fns[name])
    shapes3, shapes5 = cs.tile_instance_shapes(kb, kf)
    assert cs.C_MIN == 4
    cmax = kb.max_channels
    assert shapes3 == [(30, 4, True, 16, 1, 64), (50, 4, True, 24, 1, 64),
                       (100, 4, False, 40, 2, 64),
                       (100, cmax, False, 40, 2, 64)]
    assert shapes5 == [(30, 4, 16, 32), (30, 21, 24, 32), (20, 4, 16, 16)]


@pytest.mark.parametrize("narrow", [False, True])
def test_k4_widths_fast_takes_what_exact_takes(monkeypatch, capsys, narrow):
    """k4_caps takes, at every C, the widest message width (Ca = 0) that
    the K4 wrapper takes in exact mode, where the row kernels of both
    directions must fit, and that of the fast row tile forward;
    print_k4_widths raises where the fast mode's is the narrower, and
    checks that chip_smoke's sub-window layout at Cl(2) sums fewer targets
    than a window."""
    cs = _smoke()

    def lib(kf):
        def row(cm, ca, c, wn, bwd):
            if c > 3:
                return 0
            return 1000 if cm <= (60 if bwd else 80) else 300_000

        def tile(cm, ca, c, wn):
            lim = 50 if narrow and c == 2 and kf is fe.DENSE_CL2 else 90
            return 2000 if cm <= lim else 0

        def wsub(cm, ca, c, wn):
            return 16 if (cm, ca, c) == cs.CL2_SUB or c == 3 else wn

        return {"smem_bytes": row, "fwd_tile_smem_bytes": tile,
                "fwd_tile_wsub": wsub}

    libs = {k.symbol: lib(k) for k in (fe.DENSE, fe.DENSE_CL2)}
    monkeypatch.setattr(fe, "_lib_fn",
                        lambda k, name, *a: libs[k.symbol][name])
    assert cs.k4_caps(fe.DENSE) == {c: (60, 90) for c in (1, 2, 3)}
    if narrow:
        with pytest.raises(AssertionError, match=r"K4 at Cl\(2\).*C = \[2\]"):
            cs.print_k4_widths()
    else:
        cs.print_k4_widths()
        out = capsys.readouterr().out
        assert "Cl(3): at every C the fast-mode K4 takes" in out
        assert "Cl(2): at every C the fast-mode K4 takes" in out
        assert "fewer than 32 targets at the widest Cm of C = [3]" in out


def _k2_lib(kb, narrow=False):
    """A stand-in K2 library: the exact row kernel takes inputs up to 50
    at every C; the fast row tiles up to 90 (with ``narrow``, 40 at C = 2),
    their x tile in chunks above 60 input channels or below C = 8."""
    def plan(cin, c, info):
        ok = cin <= (40 if narrow and c == 2 else 90)
        chunked = cin > 60 or c < 8
        info[0], info[1] = ((2, 48) if chunked else (1, 64)) if ok else (0, 0)
        info[2] = 40_000 if ok else 0
        return 150_000 if ok else 0

    return _Lib(**{
        f"{kb.symbol}_smem_bytes":
            _Fn(lambda cin, c, bwd: 1000 if cin <= 50 else 300_000),
        f"{kb.symbol}_fwd_tile_smem_bytes":
            _Fn(lambda cin, c: plan(cin, c, [0, 0, 0])),
        f"{kb.symbol}_fwd_tile_plan": _Fn(plan)})


@pytest.mark.parametrize("narrow", [False, True])
def test_k2_widths_fast_takes_what_exact_takes(monkeypatch, capsys, narrow):
    """k2_caps takes, at every C, the widest input the exact and the fast
    K2 take from their entries; print_k2_widths raises where the fast
    mode's is the narrower."""
    cs = _smoke()
    libs = {"cemlp": None}

    def load(name):
        return libs["cemlp"]

    monkeypatch.setattr(_build, "load", load)
    libs["cemlp"] = _k2_lib(ck.DENSE)
    assert cs.k2_caps(ck.DENSE) == {c: (50, 90) for c in range(1, 33)}
    assert cs.k2_plan(ck.DENSE, 90, 28) == (150_000, 2, 48)
    assert cs.k2_plan(ck.DENSE, 95, 28) == (0, 0, 0)

    class _Both:   # the two algebras' entries in one stand-in library
        def __init__(self):
            self.__dict__.update(_k2_lib(ck.DENSE).__dict__)
            self.__dict__.update(_k2_lib(ck.DENSE_CL2, narrow).__dict__)

    libs["cemlp"] = _Both()
    if narrow:
        with pytest.raises(AssertionError, match=r"K2 at Cl\(2\).*C = \[2\]"):
            cs.print_k2_widths()
    else:
        cs.print_k2_widths()
        out = capsys.readouterr().out
        assert "Cl(3): at every C the fast-mode K2 takes" in out
        assert "Cl(2): at every C the fast-mode K2 takes" in out
        assert "K2 at Cl(3) smem bytes exact/fast: 34->28 1000/150000" in out


def test_k2_instance_shapes_take_each_instance_once(monkeypatch):
    """chip_smoke holds the fast K2 to its plain version at each of its
    two instances (x tile whole, in chunks), at the narrowest C >= C_MIN
    whose widest exact input takes it, and at the widest C; on the
    stand-in library the tile is chunked below C = 8."""
    cs = _smoke()
    monkeypatch.setattr(_build, "load", lambda name: _k2_lib(ck.DENSE))
    assert cs.C_MIN == 4
    assert cs.k2_instance_shapes(ck.DENSE) == [(50, 8, 1, 64), (50, 4, 2, 48),
                                               (50, 32, 1, 64)]
