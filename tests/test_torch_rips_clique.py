"""The port's Rips and clique lifts and ``knn_graph`` against the reference
package, array for array: the python paths against the reference's python
paths, the default backends against each other (both take the native core
from the same source when it builds), and the port's native binding
against its python path (the same complex; the adjacency pairs compared
as multisets, as tests/test_native.py does, since the two list them in
different orders).  A test that needs the native core skips where
``g++`` cannot build it."""
import numpy as np
import pytest

from csmpn_tpu.data import lifting as jlift
from csmpn_tpu.data import md17 as jmd17
from csmpn_torch.data import lifting, md17, native


def _same(got, want):
    """Simplices and every adjacency block, byte for byte and in order."""
    assert got.max_dim == want.max_dim and got.counts == want.counts
    for d in want.x:
        assert got.x[d].dtype == want.x[d].dtype
        assert got.x[d].tobytes() == want.x[d].tobytes(), d
    assert list(got.adj) == list(want.adj)
    for k in want.adj:
        assert got.adj[k].tobytes() == want.adj[k].tobytes(), k


def _same_multiset(a, b):
    assert a.counts == b.counts
    for d in a.x:
        np.testing.assert_array_equal(a.x[d], b.x[d])
    assert set(a.adj) == set(b.adj)
    for k in a.adj:
        assert sorted(map(tuple, a.adj[k].T)) == sorted(map(tuple, b.adj[k].T))


@pytest.fixture()
def native_core():
    if not native.available():
        pytest.skip("native lifting core unavailable (no g++ build)")


def _points(seed, n, d=3, scale=1.5):
    return np.random.RandomState(seed).randn(n, d) * scale


RIPS_CASES = [(0, 10, 3, 2, 1.5), (1, 6, 2, 2, 1e4), (2, 12, 3, 2, 2.0),
              (3, 9, 3, 1, 1.8), (4, 5, 3, 2, 0.1)]


@pytest.mark.parametrize("seed,n,d,dim,dis", RIPS_CASES)
def test_rips_python_matches_reference(seed, n, d, dim, dis):
    pts = _points(seed, n, d)
    _same(lifting.rips_lift(pts, dim, dis, backend="python"),
          jlift.rips_lift(pts, dim, dis, backend="python"))


@pytest.mark.parametrize("seed,n,d,dim,dis", RIPS_CASES)
def test_rips_default_backend_matches_reference(seed, n, d, dim, dis):
    pts = _points(seed, n, d)
    _same(lifting.rips_lift(pts, dim, dis), jlift.rips_lift(pts, dim, dis))


CLIQUE_CASES = [(0, 13, 3, 1e4, 1e4), (1, 13, 4, 1.5, 1e4),
                (2, 10, 3, 1e4, 0.5), (3, 9, 5, 1.2, 0.8)]


@pytest.mark.parametrize("seed,n,k,edge_th,tri_th", CLIQUE_CASES)
def test_clique_python_matches_reference(seed, n, k, edge_th, tri_th):
    """Over kNN graphs, with thresholds that drop edges a surviving
    triangle resurrects."""
    pts = _points(seed, n)
    ei = md17.knn_graph(pts, k)
    _same(lifting.clique_lift(pts, ei, edge_th, tri_th, backend="python"),
          jlift.clique_lift(pts, ei, edge_th, tri_th, backend="python"))


@pytest.mark.parametrize("seed,n,k,edge_th,tri_th", CLIQUE_CASES)
def test_clique_default_backend_matches_reference(seed, n, k, edge_th,
                                                  tri_th):
    pts = _points(seed, n)
    ei = md17.knn_graph(pts, k)
    _same(lifting.clique_lift(pts, ei, edge_th, tri_th),
          jlift.clique_lift(pts, ei, edge_th, tri_th))


@pytest.mark.parametrize("seed,n,d,dim,dis", RIPS_CASES)
def test_rips_native_matches_python(native_core, seed, n, d, dim, dis):
    pts = _points(seed, n, d)
    _same_multiset(native.rips_lift_native(pts, dim, dis),
                   lifting.rips_lift(pts, dim, dis, backend="python"))


@pytest.mark.parametrize("seed,n,k,edge_th,tri_th", CLIQUE_CASES)
def test_clique_native_matches_python(native_core, seed, n, k, edge_th,
                                      tri_th):
    pts = _points(seed, n)
    ei = md17.knn_graph(pts, k)
    _same_multiset(
        native.clique_lift_native(pts, ei, edge_th, tri_th),
        lifting.clique_lift(pts, ei, edge_th, tri_th, backend="python"))


def test_no_native_env_takes_python_path(monkeypatch):
    """CSMPN_NO_NATIVE sends the default backend to the python path."""
    monkeypatch.setenv("CSMPN_NO_NATIVE", "1")
    pts = _points(7, 8)
    _same(lifting.rips_lift(pts, 2, 1.5),
          lifting.rips_lift(pts, 2, 1.5, backend="python"))


@pytest.mark.parametrize("n,k", [(13, 3), (6, 10), (9, 1)])
def test_knn_graph_matches_reference(n, k):
    pts = _points(n, n)
    got, want = md17.knn_graph(pts, k), jmd17.knn_graph(pts, k)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert got.shape == (2, n * min(k, n - 1))
