"""Simplicial complexes, the lifts, and the big-graph flattening.

Port of ``csmpn_tpu/data/lifting.py``: the simplex store (gudhi insert
semantics), the boundary and shared-coface adjacency with the
fully-connected 0-0 augmentation, the Vietoris-Rips lift (NBA, MD17), the
clique lift with edge-length and triangle-area thresholds (MD17 aspirin),
the hull lift (hulls), the ``SimplicialComplex`` container and
``flatten_complex`` into a ``BigGraph``.  Host-side numpy; byte-identical
to the reference on the same input.  The Rips and clique lifts run the
native C++ core (``data/native.py``) when it builds and the python path
otherwise, as the reference does.
"""
from __future__ import annotations

import itertools
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


class SimplexStore:
    """Simplices by dimension, as sorted vertex tuples.  Inserting a
    simplex inserts all of its faces; indices within a dimension follow
    the sorted order of the final set (assigned by ``freeze``)."""

    def __init__(self, max_dim: int = 2):
        self.max_dim = max_dim
        self._sets: List[set] = [set() for _ in range(max_dim + 1)]
        self._index: Optional[List[Dict[tuple, int]]] = None

    def insert(self, simplex) -> None:
        simplex = tuple(sorted(int(v) for v in simplex))
        d = len(simplex) - 1
        if d > self.max_dim:
            raise ValueError(f"simplex dim {d} > max_dim {self.max_dim}")
        for k in range(d + 1):
            for face in itertools.combinations(simplex, k + 1):
                self._sets[k].add(face)

    def freeze(self) -> None:
        self._index = [
            {s: i for i, s in enumerate(sorted(self._sets[d]))}
            for d in range(self.max_dim + 1)
        ]

    def simplices(self, d: int) -> List[tuple]:
        assert self._index is not None, "freeze() first"
        return sorted(self._sets[d])

    def index(self, simplex: tuple) -> int:
        return self._index[len(simplex) - 1][tuple(simplex)]


def _boundaries(simplex: tuple):
    if len(simplex) == 1:
        return
    for i in range(len(simplex)):
        yield simplex[:i] + simplex[i + 1:]


def generate_adjacencies(store: SimplexStore, fully_connect_nodes: bool
                         ) -> Dict[Tuple[int, int], np.ndarray]:
    """Boundary and upper (shared-coface) adjacency, {(dim_src, dim_dst):
    (2, n) int64}.  The downward relations are added by
    ``flatten_complex``."""
    adj: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}

    def add(key, pair):
        adj.setdefault(key, []).append(pair)

    max_dim = store.max_dim
    for d in range(max_dim + 1):
        # upper adjacency through shared codim-1 cofaces
        if d + 1 <= max_dim:
            for coface in store.simplices(d + 1):
                for s in _boundaries(coface):
                    s_idx = store.index(s)
                    for s2 in _boundaries(coface):
                        if s2 != s:
                            add((d, d), (store.index(s2), s_idx))
        # boundary adjacency (d-1 -> d)
        if d >= 1:
            for s in store.simplices(d):
                s_idx = store.index(s)
                for b in _boundaries(s):
                    add((d - 1, d), (store.index(b), s_idx))

    if fully_connect_nodes:
        # the reference tests membership against sorted pairs only, so
        # (i, j) is added unless i < j and {i, j} is an edge: the (hi, lo)
        # direction of a real edge comes twice, once from the cofaces
        n0 = len(store.simplices(0))
        edge_set = store._sets[1]
        for i in range(n0):
            for j in range(n0):
                if i != j and not (i < j and (i, j) in edge_set):
                    add((0, 0), (i, j))

    return {k: np.asarray(pairs, dtype=np.int64).T
            for k, pairs in adj.items()}


@dataclass
class SimplicialComplex:
    """x: {dim: (n_d, dim+1) vertex-index matrix};
    adj: {(src_dim, dst_dim): (2, n)} with within-dim indices."""

    max_dim: int
    x: Dict[int, np.ndarray]
    adj: Dict[Tuple[int, int], np.ndarray]

    @property
    def counts(self) -> List[int]:
        return [len(self.x.get(d, ())) for d in range(self.max_dim + 1)]


def _store_to_complex(store: SimplexStore,
                      fully_connect_nodes: bool) -> SimplicialComplex:
    store.freeze()
    x = {}
    for d in range(store.max_dim + 1):
        simp = store.simplices(d)
        x[d] = np.asarray(simp, dtype=np.int64).reshape(len(simp), d + 1)
    adj = generate_adjacencies(store, fully_connect_nodes)
    return SimplicialComplex(store.max_dim, x, adj)


def rips_lift(points: np.ndarray, dim: int, dis: float,
              backend: str = "auto") -> SimplicialComplex:
    """Vietoris-Rips flag complex up to ``dim`` at scale ``dis`` (edges =
    pairs within ``dis``, triangles = triples whose three edges exist),
    with the fully-connected 0-0 augmentation.  ``backend="auto"`` takes
    the native core when it is available (``CSMPN_NO_NATIVE`` turns it
    off), ``"python"`` the path below; both give the same complex."""
    if backend == "auto" and dim <= 2 and not os.environ.get(
            "CSMPN_NO_NATIVE"):
        from . import native
        if native.available():
            return native.rips_lift_native(points, dim, dis)
    points = np.asarray(points, dtype=np.float64)
    n = len(points)
    store = SimplexStore(dim)
    for v in range(n):
        store.insert((v,))
    d2 = np.sum((points[:, None] - points[None, :]) ** 2, axis=-1)
    within = d2 <= dis * dis
    iu, ju = np.triu_indices(n, k=1)
    edges = [(int(i), int(j)) for i, j in zip(iu, ju) if within[i, j]]
    for e in edges:
        store.insert(e)
    if dim >= 2:
        for i, j in edges:
            for k in range(j + 1, n):
                if within[i, k] and within[j, k]:
                    store.insert((i, j, k))
    return _store_to_complex(store, fully_connect_nodes=True)


def clique_lift(points: np.ndarray, edge_index: np.ndarray,
                edge_th: float = 1e4, tri_th: float = 1e4,
                max_dim: int = 2, backend: str = "auto") -> SimplicialComplex:
    """Clique lift of a graph with edge-length and triangle-area
    thresholds (MD17 aspirin).  A triangle that passes the area filter
    inserts its boundary edges even where the length filter dropped them
    (gudhi insert semantics).  No fully-connected 0-0 augmentation."""
    if backend == "auto" and max_dim == 2 and not os.environ.get(
            "CSMPN_NO_NATIVE"):
        from . import native
        if native.available():
            return native.clique_lift_native(points, edge_index, edge_th,
                                             tri_th, max_dim)
    points = np.asarray(points, dtype=np.float64)
    n = len(points)
    ei = np.asarray(edge_index)
    und = set()
    for s, t in zip(ei[0], ei[1]):
        if s != t:
            und.add((min(int(s), int(t)), max(int(s), int(t))))
    und = sorted(und)

    # triangles = 3-cliques of the undirected graph
    nbrs: Dict[int, set] = {v: set() for v in range(n)}
    for a, b in und:
        nbrs[a].add(b)
        nbrs[b].add(a)
    triangles = []
    for a, b in und:
        for c in sorted(nbrs[a] & nbrs[b]):
            if c > b:
                triangles.append((a, b, c))

    store = SimplexStore(max_dim)
    for v in range(n):
        store.insert((v,))
    for a, b in und:
        if np.linalg.norm(points[a] - points[b]) <= edge_th:
            store.insert((a, b))
    for a, b, c in triangles:
        v1 = points[b] - points[a]
        v2 = points[c] - points[a]
        if points.shape[1] == 3:
            area = 0.5 * np.linalg.norm(np.cross(v1, v2))
        else:
            gram = np.array([[v1 @ v1, v1 @ v2], [v1 @ v2, v2 @ v2]])
            area = 0.5 * np.sqrt(max(np.linalg.det(gram), 0.0))
        if area <= tri_th:
            store.insert((a, b, c))
    return _store_to_complex(store, fully_connect_nodes=False)


def hull_lift(points: np.ndarray, dim: int = 2) -> SimplicialComplex:
    """Convex-hull lift: all k-faces (k <= dim) of the Qhull facets, with
    the fully-connected 0-0 augmentation."""
    from scipy.spatial import ConvexHull

    points = np.asarray(points, dtype=np.float64)
    hull = ConvexHull(points)
    store = SimplexStore(dim)
    for v in range(len(points)):
        store.insert((v,))
    for k in range(1, dim + 1):
        faces = set()
        for facet in hull.simplices:
            for subset in itertools.combinations(sorted(map(int, facet)),
                                                 k + 1):
                faces.add(subset)
        for f in faces:
            store.insert(f)
    return _store_to_complex(store, fully_connect_nodes=True)


@dataclass
class BigGraph:
    """One simplicial complex flattened into a single graph over all
    simplices."""

    edge_index: np.ndarray   # (2, E) int64, [source, target] big-graph ids
    edge_types: np.ndarray   # (E, 2) int64 [src_dim, dst_dim]
    node_types: np.ndarray   # (N,) int64 simplex dimension per node
    x_ind: np.ndarray        # (N, max_dim+1) int64 padded vertex indices
    counts: List[int] = field(default_factory=list)

    @property
    def num_nodes(self) -> int:
        return len(self.node_types)


def flatten_complex(cplx: SimplicialComplex) -> BigGraph:
    """Merge per-dim simplex sets into one node space with per-dim offsets,
    emitting edge_index over all adjacency relations (upward, downward,
    same-dim) plus x_ind / node_types."""
    max_dim = cplx.max_dim
    counts = cplx.counts
    offsets = np.concatenate([[0], np.cumsum(counts)])

    adj = dict(cplx.adj)
    # downward (coboundary) relations = transposed boundary relations
    for d in range(max_dim):
        if (d, d + 1) in adj:
            adj[(d + 1, d)] = adj[(d, d + 1)][[1, 0]].copy()

    edge_blocks, type_blocks = [], []
    for ds in range(max_dim + 1):
        for dt in range(max_dim + 1):
            if (ds, dt) in adj:
                block = adj[(ds, dt)].copy()
                block[0] += offsets[ds]
                block[1] += offsets[dt]
                edge_blocks.append(block)
                type_blocks.append(
                    np.tile([[ds], [dt]], (1, block.shape[1])).T)
    edge_index = (np.concatenate(edge_blocks, axis=1)
                  if edge_blocks else np.zeros((2, 0), dtype=np.int64))
    edge_types = (np.concatenate(type_blocks, axis=0)
                  if type_blocks else np.zeros((0, 2), dtype=np.int64))

    n = int(offsets[-1])
    node_types = np.zeros(n, dtype=np.int64)
    x_ind = np.zeros((n, max_dim + 1), dtype=np.int64)
    for d in range(max_dim + 1):
        sl = slice(int(offsets[d]), int(offsets[d + 1]))
        node_types[sl] = d
        if counts[d]:
            x_ind[sl, : d + 1] = cplx.x[d]
    return BigGraph(edge_index, edge_types, node_types, x_ind,
                    counts=list(counts))
