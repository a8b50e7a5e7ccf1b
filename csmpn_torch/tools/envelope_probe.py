"""The envelope probe of one CUDA card: copy bandwidth, tensor-core rate
and FMA rate, measured by the hand-written kernels P1-P3.

The port of ``tools/mxu_probe.py`` (same flags, defaults and inputs:
``np.random.RandomState(0)`` in the same draw order).  On the card:

  1. stream bandwidth: P1 (``o = x * 2`` over (rows, 256) float32) at the
     TPU probe's tile heights 256, 1024 and 4096 rows per CTA claim and at
     64, on a grid of one wave (TMA bulk copies through shared memory),
     beside ``x * 2`` and ``Tensor.copy_``;
  2. resident matrix-product rate: P2 (512 x 256 x 2048, ``reps`` times,
     operands held on chip) in bf16 and tf32 on the tensor cores
     (``wgmma``) and fp32 on the CUDA cores (FFMA), each beside
     ``torch.matmul`` at its operand type repeated ``reps`` times;
  3. FMA rate: P3, 256 dependent FMAs on (4096, 512) float32.

Each time is CUDA events around ``steps`` back-to-back launches behind a
sleep kernel, the minimum over ``repeats``.  The measured envelope is the
best copy bandwidth, the three P2 rates and the P3 rate.

    python -m csmpn_torch.tools.envelope_probe [--rows 131072] [--steps 16]
        [--repeats 3] [--reps 32] [--device cuda]

``--device=cpu`` runs the plain versions on the host clock (small sizes
via ``--mkn`` and ``--fma-shape``); its numbers are not the card's.
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..ops import probe_kernels as pk
from .perf_breakdown import card, timed_ms

COLS = 256                    # P1's row width (tools/mxu_probe.py:83)
TILES = (64, 256, 1024, 4096)  # rows a tile; 256-4096 are the TPU probe's
MKN = (512, 256, 2048)        # P2's M, K, N (tools/mxu_probe.py:107)
FMA_SHAPE = (4096, 512)       # P3's array (tools/mxu_probe.py:147)
FMA_STEPS = 256
# H100 SXM data sheet (dense): bytes/s, and FLOP/s by operand type
DATA_SHEET = {"copy": 3.35e12, "bf16": 989e12, "tf32": 495e12,
              "fp32": 67e12, "fma": 67e12}
# what P2 runs on in each mode
HOW = {"bf16": "wgmma m64n128k16 bf16, A from registers",
       "tf32": "wgmma m64n128k8 tf32, A from registers", "fp32": "FFMA"}


def inputs(rows: int = 131072, mkn: Sequence[int] = MKN,
           fma_shape: Sequence[int] = FMA_SHAPE):
    """x (rows, 256), a (M, K), b (K, N) and v (fma_shape), float32, drawn
    as tools/mxu_probe.py draws them."""
    rng = np.random.RandomState(0)
    x = rng.randn(rows, COLS).astype(np.float32)
    m, k, n = mkn
    a = rng.randn(m, k).astype(np.float32)
    b = rng.randn(k, n).astype(np.float32) / 16
    v = rng.randn(*fma_shape).astype(np.float32)
    return tuple(torch.from_numpy(t) for t in (x, a, b, v))


def work(rows: int = 131072, mkn: Sequence[int] = MKN, reps: int = 32,
         fma_shape: Sequence[int] = FMA_SHAPE, fma_steps: int = FMA_STEPS
         ) -> Dict[str, Dict[str, float]]:
    """Bytes each probe must move (inputs read once, outputs written once)
    and operations it must do: P2's matrix products (tensor cores or FFMA)
    and, apart, its perturbations (2 M K per rep after the first)."""
    m, k, n = mkn
    size = math.prod(fma_shape)
    return {
        "copy": {"bytes": 2 * rows * COLS * 4, "flops": rows * COLS},
        "resident": {"bytes": (m * k + k * n + m * n) * 4,
                     "flops": 2 * m * k * n * reps,
                     "elementwise": 2 * m * k * max(reps - 1, 0)},
        "fma": {"bytes": 2 * size * 4, "flops": 2 * size * fma_steps},
    }


def bound_ms(bytes_moved: float, flops: float, peak: float,
             elementwise: float = 0.0):
    """(least ms, "bytes" or "operations") at the data sheet's rates: the
    larger of the bytes over the memory rate and the operations over their
    peak rate (elementwise operations at the fp32 rate, added)."""
    t_b = bytes_moved / DATA_SHEET["copy"]
    t_f = flops / peak + elementwise / DATA_SHEET["fp32"]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def time_min_ms(fn: Callable, steps: int, repeats: int,
                device: torch.device) -> float:
    """ms per call, the minimum over ``repeats`` runs of ``steps`` calls,
    each after one untimed call: on the card ``perf_breakdown.timed_ms``
    (CUDA events behind a sleep kernel), on the CPU the host clock."""
    if device.type == "cuda":
        return min(timed_ms(fn, steps, warmup=1) for _ in range(repeats))
    fn()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        best = min(best, (time.perf_counter() - t0) * 1e3 / steps)
    return best


def measure(device="cuda", rows: int = 131072, steps: int = 16,
            repeats: int = 3, reps: int = 32, mkn: Sequence[int] = MKN,
            fma_shape: Sequence[int] = FMA_SHAPE, library: bool = True,
            out: Optional[Callable[[str], None]] = None) -> dict:
    """Runs P1-P3 (and, with ``library``, the PyTorch calls beside them)
    on ``device`` and returns their times and rates, the measured envelope
    and the card line.  ``out`` receives one line per measurement."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("the envelope probe measures a CUDA card; "
                           "torch.cuda.is_available() is False (pass "
                           "--device=cpu for the plain versions)")
    say = out or (lambda line: None)
    res = {"device": device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "card": card() if cuda else None,
           "work": work(rows, mkn, reps, fma_shape)}
    say(f"# {res['card']}" if cuda else "# cpu: the plain versions on the "
        "host clock; these are not device numbers")
    x, a, b, v = (t.to(device) for t in inputs(rows, mkn, fma_shape))

    what = "kernel" if cuda else "plain (cpu)"

    def timed(fn):
        return time_min_ms(fn, steps, repeats, device)

    # ---- 1. stream bandwidth
    gb = res["work"]["copy"]["bytes"] / 1e9
    copy = {"ms": {}, "gbps": {}, "library_ms": {}}
    for tile in TILES:
        t = timed(lambda: pk.copy_scale(x, tile))
        copy["ms"][tile], copy["gbps"][tile] = t, gb / t * 1e3
        label = ""
        if cuda:
            grid = pk.copy_grid(-(-rows // tile), pk.copy_slots(device))
            label = f" ({grid} CTAs)"
        say(f"copy {what} tile {tile:5d}{label}: {t:7.3f} ms  "
            f"{gb / t * 1e3:7.1f} GB/s")
    if library:
        y = torch.empty_like(x)
        for name, fn in (("x*2", lambda: x * 2.0),
                         ("copy_", lambda: y.copy_(x))):
            t = timed(fn)
            copy["library_ms"][name] = t
            say(f"copy library ({name}): {t:7.3f} ms  {gb / t * 1e3:7.1f} "
                f"GB/s")
    res["copy"] = copy

    # ---- 2. resident matrix-product rate by operand type
    fl = res["work"]["resident"]["flops"]
    resident = {"ms": {}, "tflops": {}, "library_ms": {}}
    for mode in pk.MODES:
        t = timed(lambda: pk.resident_matmul(a, b, reps, mode))
        resident["ms"][mode], resident["tflops"][mode] = t, fl / t / 1e9
        label = f" ({HOW[mode]})" if cuda else ""
        line = (f"resident matmul {mode} {what}{label}: {t:7.3f} ms  "
                f"{fl / t / 1e9:7.2f} TF/s")
        if library:
            dt = torch.bfloat16 if mode == "bf16" else torch.float32
            ad, bd = a.to(dt), b.to(dt)

            def lib():
                for _ in range(reps):
                    torch.matmul(ad, bd)

            with pk.tf32_matmul(mode == "tf32"):
                tl = timed(lib)
            resident["library_ms"][mode] = tl
            line += (f"  (torch.matmul x{reps}: {tl:7.3f} ms  "
                     f"{fl / tl / 1e9:7.2f} TF/s)")
        say(line)
    res["resident"] = resident

    # ---- 3. FMA rate: a dependent chain on every element
    t = timed(lambda: pk.fma_chain(v, FMA_STEPS))
    ops = res["work"]["fma"]["flops"]
    res["fma"] = {"ms": t, "tflops": ops / t / 1e9}
    say(f"fma chain {what} x{FMA_STEPS} on {tuple(fma_shape)}: {t:7.3f} ms  "
        f"{ops / t / 1e9:7.2f} TF/s")

    env = {"copy": max(copy["gbps"].values()) * 1e9,
           **{m: resident["tflops"][m] * 1e12 for m in pk.MODES},
           "fma": res["fma"]["tflops"] * 1e12}
    res["envelope"] = env
    rates = ", ".join(f"{m} {env[m] / 1e12:.2f} TF/s" + (
        f" ({env[m] / DATA_SHEET[m] * 100:.1f}% of "
        f"{DATA_SHEET[m] / 1e12:.0f})" if cuda else "")
        for m in ("bf16", "tf32", "fp32", "fma"))
    if cuda:
        share = env["copy"] / DATA_SHEET["copy"] * 100
        say(f"measured envelope vs the data sheet: copy "
            f"{env['copy'] / 1e9:.1f} GB/s ({share:.1f}% of 3350), {rates}")
    else:
        say(f"host rates of the plain versions: copy {env['copy'] / 1e9:.1f} "
            f"GB/s, {rates}")
    return res


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=131072)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--reps", type=int, default=32,
                    help="resident-matmul repetitions per kernel call")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mkn", default=",".join(map(str, MKN)),
                    help="P2's M,K,N")
    ap.add_argument("--fma-shape", default=",".join(map(str, FMA_SHAPE)),
                    help="P3's array shape")
    args = ap.parse_args(argv)
    mkn = tuple(int(s) for s in args.mkn.split(","))
    fma_shape = tuple(int(s) for s in args.fma_shape.split(","))
    return measure(args.device, args.rows, args.steps, args.repeats,
                   args.reps, mkn, fma_shape, out=print)


if __name__ == "__main__":
    main()
