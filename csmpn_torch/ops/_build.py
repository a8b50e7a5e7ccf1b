"""Build and load the hand-written CUDA kernels under ``csmpn_torch/csrc``.

Each ``.cu`` source is compiled with ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes``.  The build happens at first
CUDA use, from the repository's sources only, into ``build/kernels/`` at
the root of the checkout (listed in ``.gitignore``).  A library's file name
carries a hash of its source, of the shared headers (``csrc/*.cuh``) and
of the flags, so a stale build is never loaded.  All sources are compiled
in parallel, one ``nvcc`` process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("segment_sum", "cemlp", "cemlp_pair", "fused_egcl", "envelope")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    cand = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc"), shutil.which("nvcc")]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of csmpn_torch "
        "are compiled from csmpn_torch/csrc at first CUDA use")


def _lib_path(name: str) -> str:
    sha = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            sha.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{sha.hexdigest()[:12]}.so")


def build_all() -> float:
    """Compile every source whose library is missing, all at once.
    Returns the wall seconds spent; raises with nvcc's output on failure."""
    todo = [n for n in SOURCES if not os.path.exists(_lib_path(n))]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.time()
    procs = []
    for name in todo:
        out = _lib_path(name)
        tmp = f"{out}.{os.getpid()}.tmp"
        log = open(os.path.join(BUILD_DIR, f"{name}.log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs.append((name, out, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    dt = time.time() - t0
    if failed:
        msgs = []
        for name in failed:
            with open(os.path.join(BUILD_DIR, f"{name}.log")) as f:
                msgs.append(f"--- {name}.cu\n{f.read()[-4000:]}")
        raise RuntimeError("nvcc failed:\n" + "\n".join(msgs))
    return dt


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)."""
    path = os.path.join(BUILD_DIR, f"{name}.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building all sources first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build_all()
            _libs[name] = ctypes.CDLL(_lib_path(name))
        return _libs[name]


class LaunchCounter:
    """Counts the launches of one kernel: its wrapper adds one where it
    launches the kernel, and nowhere else."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def add(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
