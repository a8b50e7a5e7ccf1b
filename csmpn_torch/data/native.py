"""ctypes binding of the native (C++) lifting core ``native/csmpn_lift.cpp``:
the Vietoris-Rips and clique lifts with their adjacency, the same
complexes as the python paths of ``lifting.py``.

The library is compiled from that source at first use with
``g++ -O3 -fPIC -shared -std=c++17`` into ``build/native/`` at the root of
the checkout (listed in ``.gitignore``); its file name carries a hash of
the source and the flags, so a stale build is never loaded.  Without a
compiler, or with ``CSMPN_NO_NATIVE`` set, ``available()`` is False and
the lifts take their python paths.  The C ABI uses caller-allocated
buffers sized from the combinatorial maxima.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from math import comb
from typing import Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "csmpn_lift.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "native")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def lib_path() -> str:
    sha = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        sha.update(f.read())
    return os.path.join(BUILD_DIR, f"libcsmpn_lift_{sha.hexdigest()[:12]}.so")


def _compile() -> Optional[str]:
    """The library's path, compiling it first if it is missing; None when
    there is no compiler or the build fails."""
    out = lib_path()
    if os.path.exists(out):
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0:
        return None
    os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("CSMPN_NO_NATIVE") or not os.path.exists(SOURCE):
            return None
        path = _compile()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.csmpn_rips_lift.restype = ctypes.c_int
        lib.csmpn_rips_lift.argtypes = [
            f64p, ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
            ctypes.c_int32, ctypes.c_int32,
            i32p, i32p, ctypes.c_int32,
            i32p, i32p, ctypes.c_int32,
            i32p, i32p, ctypes.c_int32,
        ]
        lib.csmpn_clique_lift.restype = ctypes.c_int
        lib.csmpn_clique_lift.argtypes = [
            f64p, ctypes.c_int32, ctypes.c_int32,
            i32p, ctypes.c_int32,
            ctypes.c_double, ctypes.c_double,
            i32p, i32p, ctypes.c_int32,
            i32p, i32p, ctypes.c_int32,
            i32p, i32p, ctypes.c_int32,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native core is built and loaded (builds it if needed)."""
    return _load() is not None


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _buffers(n: int, fully_connect: bool):
    max_e = comb(n, 2)
    max_t = comb(n, 3)
    # 0-0 edge cofaces (2E) + 1-1 triangle cofaces (6T) + boundary 0->1
    # (2E) + boundary 1->2 (3T) + fully-connected fill (< n^2)
    max_adj = 4 * max_e + 9 * max_t + (n * n if fully_connect else 0)
    edges = np.empty((max_e, 2), dtype=np.int32)
    tris = np.empty((max_t, 3), dtype=np.int32)
    adj = np.empty((max_adj, 4), dtype=np.int32)
    return edges, tris, adj, max_e, max_t, max_adj


def _to_complex(n: int, edges: np.ndarray, n_e: int, tris: np.ndarray,
                n_t: int, adj: np.ndarray, n_adj: int, max_dim: int):
    from .lifting import SimplicialComplex

    x = {0: np.arange(n, dtype=np.int64).reshape(n, 1),
         1: edges[:n_e].astype(np.int64),
         2: tris[:n_t].astype(np.int64)}
    for d in range(max_dim + 1, 3):
        x.pop(d, None)
    adj_dict = {}
    quads = adj[:n_adj]
    keys = quads[:, 0] * 4 + quads[:, 1]
    for ds in range(max_dim + 1):
        for dt in range(max_dim + 1):
            sel = keys == ds * 4 + dt
            if sel.any():
                adj_dict[(ds, dt)] = quads[sel, 2:].astype(np.int64).T
    return SimplicialComplex(max_dim, x, adj_dict)


def _counts():
    return (np.zeros(1, np.int32), np.zeros(1, np.int32),
            np.zeros(1, np.int32))


def rips_lift_native(points: np.ndarray, dim: int, dis: float,
                     fully_connect: bool = True):
    lib = _load()
    if lib is None:
        raise RuntimeError("native lifting library unavailable")
    pts = np.ascontiguousarray(points, dtype=np.float64)
    n, d = pts.shape
    edges, tris, adj, max_e, max_t, max_adj = _buffers(n, fully_connect)
    n_e, n_t, n_a = _counts()
    rc = lib.csmpn_rips_lift(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n, d, float(dis), int(dim), int(fully_connect),
        _i32p(edges), _i32p(n_e), max_e,
        _i32p(tris), _i32p(n_t), max_t,
        _i32p(adj), _i32p(n_a), max_adj)
    if rc != 0:
        raise RuntimeError("csmpn_rips_lift: output buffer overflow")
    return _to_complex(n, edges, int(n_e[0]), tris, int(n_t[0]),
                       adj, int(n_a[0]), dim)


def clique_lift_native(points: np.ndarray, edge_index: np.ndarray,
                       edge_th: float = 1e4, tri_th: float = 1e4,
                       max_dim: int = 2):
    lib = _load()
    if lib is None:
        raise RuntimeError("native lifting library unavailable")
    pts = np.ascontiguousarray(points, dtype=np.float64)
    n, d = pts.shape
    ei = np.ascontiguousarray(np.asarray(edge_index, dtype=np.int32).T)
    edges, tris, adj, max_e, max_t, max_adj = _buffers(n, False)
    n_e, n_t, n_a = _counts()
    rc = lib.csmpn_clique_lift(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n, d, _i32p(ei), ei.shape[0],
        float(edge_th), float(tri_th),
        _i32p(edges), _i32p(n_e), max_e,
        _i32p(tris), _i32p(n_t), max_t,
        _i32p(adj), _i32p(n_a), max_adj)
    if rc != 0:
        raise RuntimeError("csmpn_clique_lift: output buffer overflow")
    return _to_complex(n, edges, int(n_e[0]), tris, int(n_t[0]),
                       adj, int(n_a[0]), max_dim)
