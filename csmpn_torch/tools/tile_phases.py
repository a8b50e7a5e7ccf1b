"""Where the fast-mode pair-form row tile kernels spend their time, phase
by phase, on one card:

    python -m csmpn_torch.tools.tile_phases

Copies ``csmpn_torch/csrc`` into ``build/phases/``, marks each phase of the
steps of ``cemlp_pair_bwd_tile_kernel`` (K3p, csrc/cemlp_pair_tile.cuh) and
``cemlp_pair_fwd_tile_kernel`` (K2p, csrc/cemlp_pair_fwd_tile.cuh) with
``clock64()`` at their barriers (every warp adds the cycles from one mark
to the next, before and after each barrier, into shared counters that go
to a device array at the end), compiles the marked ``cemlp_pair.cu`` and
``cemlp_pair_cl4.cu`` with the build's own flags, and runs the fast-mode
K3p and K2p through their wrappers at the hulls edge block 0 (Cl(5,0),
13,184 rows, 34 -> 28) and the ``--dim 4`` bench's node block 0 (Cl(4,0),
8,192 rows, 56 -> 28).  It prints, for each, the marked kernel's time per
launch and every phase's share of all warps' cycles: busy (up to the
barrier) and waiting (at it).  The marks cost registers and a few percent
of the time, so the shares, not the time, are the reading.  It needs a
CUDA card.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import torch

from ..algebra import get_algebra
from ..ops import _build
from ..ops import cemlp_kernel as ck

# the phases of a step, in the order of the barriers that end them
PHASES = ["B3 + B4 (and staging)", "x load", "F1", "S1 (MVSiLU)", "F2",
          "row phase", "B2", "S2 (MVSiLU backward)", "last B3 + B4",
          "path-weight gradients"]
PATH_MARK = "    // ---- B2: Y -> fa"
LOOP_MARK = "for (int step = blockIdx.x; step < n_steps"
END_MARK = "// ---- this CTA's partial gradient vector"
# the forward's phases (the last, a warp a row, runs on to the next step's
# first barrier); its step loop ends with the kernel
FWD_PHASES = ["pair, mean, y (and staging)", "x load", "F1", "S1 (MVSiLU)",
              "F2"]
FWD_END = "}"
PRE = r'''
__device__ unsigned long long g_phase[32];
#define PH_BUSY(k) do { long long t_ = clock64(); \
  if (lane == 0) ph_busy[warp][k] += t_ - ph_t; ph_t = t_; } while (0)
#define PH_WAIT(k) do { long long t_ = clock64(); \
  if (lane == 0) ph_wait[warp][k] += t_ - ph_t; ph_t = t_; } while (0)
#define PH_FLUSH() do { if (lane == 0) for (int k_ = 0; k_ < 16; ++k_) { \
  atomicAdd(&g_phase[k_], (unsigned long long)ph_busy[warp][k_]); \
  atomicAdd(&g_phase[16 + k_], (unsigned long long)ph_wait[warp][k_]); } \
  } while (0)
'''
READER = r'''
extern "C" void csmpn_tile_phases(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[32] = {0};
    cudaMemcpyToSymbol(g_phase, z, sizeof z);
  } else {
    cudaMemcpyFromSymbol(out, g_phase, sizeof(unsigned long long) * 32);
  }
}
'''


def marked_header(text: str, forward: bool = False) -> str:
    """The backward's tile header (or, where forward, the forward's) with
    the phase marks; raises where its structure is not the one the marks
    expect.  The backward's header defines the marks."""
    phases = FWD_PHASES if forward else PHASES
    barriers = len(phases) if forward else len(phases) - 1
    out, k, in_loop = [], 0, False
    for line in text.split("\n"):
        if LOOP_MARK in line:
            in_loop = True
        if in_loop and (line == FWD_END if forward
                        else line.strip().startswith(END_MARK)):
            in_loop = False
            out.append("  PH_FLUSH();")
        if in_loop and not forward and line.startswith(PATH_MARK):
            out.append(f"    PH_BUSY({len(PHASES) - 1});")
        if in_loop and line.strip().startswith("__syncthreads();"):
            pad = line[:len(line) - len(line.lstrip())]
            out.append(f"{pad}PH_BUSY({k}); __syncthreads(); PH_WAIT({k});")
            k += 1
            continue
        out.append(line)
    name = "cemlp_pair_fwd_tile.cuh" if forward else "cemlp_pair_tile.cuh"
    if k != barriers:
        raise RuntimeError(f"{name}: {k} barriers in the step loop, the "
                           f"marks expect {barriers}")
    text = "\n".join(out)
    if not forward:
        text = text.replace("namespace {\n", "namespace {\n" + PRE, 1)
    return text.replace(
        "  const int n_steps = (rows + R - 1) / R;\n",
        "  const int n_steps = (rows + R - 1) / R;\n"
        "  __shared__ long long ph_busy[16][16], ph_wait[16][16];\n"
        "  if (lane == 0)\n"
        "    for (int k_ = 0; k_ < 16; ++k_) ph_busy[warp][k_] = "
        "ph_wait[warp][k_] = 0;\n"
        "  long long ph_t = clock64();\n", 1)


def build_marked(out_dir: str) -> dict:
    """The marked libraries {source name: CDLL}."""
    src = os.path.join(out_dir, "src")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    for name, forward in (("cemlp_pair_tile.cuh", False),
                          ("cemlp_pair_fwd_tile.cuh", True)):
        header = os.path.join(src, name)
        with open(header) as f:
            text = marked_header(f.read(), forward)
        with open(header, "w") as f:
            f.write(text)
    libs, procs = {}, []
    for name in ("cemlp_pair", "cemlp_pair_cl4"):
        with open(os.path.join(src, f"{name}.cu"), "a") as f:
            f.write(READER)
        so = os.path.join(out_dir, f"lib{name}_phases.so")
        procs.append((name, so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so,
             os.path.join(src, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the marked {name}.cu:\n"
                               f"{log[-3000:]}")
        libs[name] = ctypes.CDLL(so)
    return libs


def block_inputs(rows, cin, c, nb, ng, npath, gen, dev):
    """Random input, block parameters and output cotangent."""
    def r(*shape, scale=1.0, base=0.0):
        return base + scale * torch.randn(*shape, generator=gen)

    params = [r(c, cin, ng, scale=cin ** -0.5), r(c, 1, scale=0.1),
              r(c, ng, scale=0.2, base=1.0), r(c, ng, scale=0.2),
              r(c, npath, scale=0.4), r(c, c, ng, scale=c ** -0.5),
              r(c, ng, scale=0.5), r(c, c, ng, scale=c ** -0.5),
              r(c, 1, scale=0.1), r(c, scale=0.1, base=1.0)]
    return (r(rows, cin, nb).to(dev), [p.to(dev) for p in params],
            r(rows, c, nb).to(dev))


def time_us(fn, iters=10):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("tile_phases: a CUDA card is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    _build.build_all()
    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), "phases")
    os.makedirs(out_dir, exist_ok=True)
    libs = build_marked(out_dir)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    for dim, rows, cin, c, source in ((5, 13184, 34, 28, "cemlp_pair"),
                                      (4, 8192, 56, 28, "cemlp_pair_cl4")):
        alg = get_algebra((1.0,) * dim)
        kern = ck.block_kernel(alg.n_blades)
        x, params, dout = block_inputs(rows, cin, c, kern.n_blades,
                                       kern.n_grades, kern.n_paths, gen, dev)
        plain = _build.load(source)
        _build._libs[source] = libs[source]
        runs = (("K3p", PHASES, lambda: ck.block_backward(
                    x, dout, params, alg, False)),
                ("K2p", FWD_PHASES, lambda: ck.block_forward(
                    x, params, alg, False)))
        try:
            for label, phases, fn in runs:
                counts = (ctypes.c_ulonglong * 32)()
                libs[source].csmpn_tile_phases(counts, 1)
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
                libs[source].csmpn_tile_phases(counts, 0)
                us = time_us(fn)
                total = sum(counts) or 1
                print(f"{label} fast, Cl({dim}), {rows} rows, {cin} -> {c}: "
                      f"{us:.1f} us per launch with the marks; share of all "
                      f"warps' cycles, busy / waiting:")
                for k, name in enumerate(phases):
                    busy, wait = counts[k] / total, counts[16 + k] / total
                    print(f"  {name:<24s} {100 * busy:6.2f}% / "
                          f"{100 * wait:6.2f}%")
                sys.stdout.flush()
        finally:
            _build._libs[source] = plain


if __name__ == "__main__":
    main()
