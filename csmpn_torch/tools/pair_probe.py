"""Quick check and timing of the pair-form block kernels K2p/K3p on one
card, for iterating on them in a short call:

    python -m csmpn_torch.tools.pair_probe

Builds the kernels (printing K2p/K3p's registers and spills), holds K2p
and K3p against their plain versions at three shapes (tiny, the hulls
node block 0, the hulls edge block 0) in exact and fast mode with a
two-launch bitwise check, then times both at the hulls edge block 0
(13,184 rows, 34 -> 28 channels, fast) twice.  ``chip_smoke.py`` is the
full check; this is a subset of it.
"""
from __future__ import annotations

import subprocess

import torch

from ..algebra import get_algebra
from ..ops import _build
from ..ops import cemlp_kernel as ck

SHAPES = [(37, 3, 4), (1536, 59, 28), (13184, 34, 28)]   # (rows, Cin, C)


def block_inputs(rows, cin, c, gen, dev):
    """Random input, Cl(5) block parameters and output cotangent."""
    def r(*shape, scale=1.0, base=0.0):
        return base + scale * torch.randn(*shape, generator=gen)

    x = r(rows, cin, 32)
    params = [r(c, cin, 6, scale=cin ** -0.5), r(c, 1, scale=0.1),
              r(c, 6, scale=0.2, base=1.0), r(c, 6, scale=0.2),
              r(c, 56, scale=0.4), r(c, c, 6, scale=c ** -0.5),
              r(c, 6, scale=0.5), r(c, c, 6, scale=c ** -0.5),
              r(c, 1, scale=0.1), r(c, scale=0.1, base=1.0)]
    dout = r(rows, c, 32)
    return x.to(dev), [p.to(dev) for p in params], dout.to(dev)


def time_ms(fn, iters, warmup=3) -> float:
    """Device ms per call (CUDA events; a sleep kernel holds the stream
    while the host enqueues)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("pair_probe needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"build {_build.build_all():.1f} s")
    for line in _build.build_log("cemlp_pair").splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip()[-90:])
    alg = get_algebra((1.0,) * 5)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    for rows, cin, c in SHAPES:
        x, ps, d = block_inputs(rows, cin, c, gen, dev)
        for exact in (True, False):
            out = ck.block_forward(x, ps, alg, exact)
            ref = ck.block_forward_plain(x, ps, alg, exact)
            dx, gr = ck.block_backward(x, d, ps, alg, exact)
            dx2, gr2 = ck.block_backward(x, d, ps, alg, exact)
            rdx, rgr = ck.block_backward_plain(x, d, ps, alg, exact)
            errs = [rel(dx, rdx)] + [rel(a, b) for a, b in zip(gr, rgr)]
            same = torch.equal(dx, dx2) and all(
                torch.equal(a, b) for a, b in zip(gr, gr2))
            print(f"{rows} {cin} {c} {'exact' if exact else 'fast'} "
                  f"fwd {rel(out, ref):.2e} bwd max {max(errs):.2e} "
                  f"bitwise {same}")
    x, ps, d = block_inputs(*SHAPES[-1], gen, dev)
    for _ in range(2):
        fwd = time_ms(lambda: ck.block_forward(x, ps, alg, False), 20)
        bwd = time_ms(lambda: ck.block_backward(x, d, ps, alg, False), 10)
        print(f"K2p us {fwd * 1e3:.1f} K3p us {bwd * 1e3:.1f}")


if __name__ == "__main__":
    main()
