"""Per-stage timing of the flat EGCL path on the card, with roofline
accounting against the H100's data sheet.

The port of ``tools/perf_breakdown.py``.  Times each stage of the edge
pipeline at the bench shape (E = 131,072 edges, N = 8,192 nodes; by
default hidden 32 at Cl(3,0), so 256 values per row) with CUDA events
around a run of launches, after a warm-up:

  * the target gather (``take_rows``) and K1 (sorted segment sum);
  * MVLinear, MVSiLU and the SGP layer over E rows (plain layers);
  * the edge CEMLP (two K2 launches);
  * the EGCL layer forward (K4 on the edge side in fast mode) and forward
    + backward (K4 + K5).

``--dim`` (the port's own option, as the bench's) sets the algebra
Cl(dim, 0) and, unless ``--hidden`` is given, the bench's width for it
(``bench.WIDTHS``): at Cl(4) and Cl(5) the edge CEMLP runs K2p and the
EGCL layer K4p/K5p, and the geometric product counts nb^2 pair products
a channel where the dense form counts nb^3.

    python -m csmpn_torch.tools.perf_breakdown [--dim 2|3|4|5]
        [--hidden C] [--edges 131072] [--nodes 8192] [--iters 20]
        [--exact]

Fast mode (bf16 streams, the bench's mode) is the default; ``--exact``
runs fp32 and the composed edge side.  Each stage's least time is
reported twice: at the H100 SXM data sheet's rates (3.35 TB/s HBM3, 989
TFLOP/s bf16 dense, 67 TFLOP/s fp32) and at this card's measured
envelope, which ``tools/envelope_probe.measure`` takes once at start-up
(P1's best copy bandwidth, P2's bf16 mma.sync rate, P3's FMA rate).  The
card's name and power limit head the output.
"""
from __future__ import annotations

import argparse
import subprocess
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_FLOPS = 989e12           # tensor cores, dense
FP32_FLOPS = 67e12            # outside the tensor cores


def timed_ms(fn: Callable, iters: int = 20, warmup: int = 3) -> float:
    """Device ms per call: CUDA events around ``iters`` calls, with a sleep
    kernel holding the stream while the host enqueues them."""
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


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv: Optional[Sequence[str]] = None) -> List[tuple]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--hidden", type=int, default=None)
    ap.add_argument("--edges", type=int, default=131072)
    ap.add_argument("--nodes", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--exact", action="store_true",
                    help="fp32 and the composed edge side")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("perf_breakdown times the CUDA card; "
                           "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False

    from ..algebra import get_algebra
    from ..bench import WIDTHS
    from ..nn.egcl import EGCL
    from ..nn.modules import (CEMLP, MVLinear, MVSiLU,
                              SteerableGeometricProductLayer,
                              init_parameters)
    from ..ops import segment as seg

    from . import envelope_probe

    seg.set_aggregation_mode("exact" if args.exact else "fast")
    dev = torch.device("cuda", 0)
    env = envelope_probe.measure(dev, library=False)["envelope"]
    env_rate = {BF16_FLOPS: env["bf16"], FP32_FLOPS: env["fma"]}
    if args.dim not in WIDTHS:
        raise ValueError(f"--dim takes {sorted(WIDTHS)}, got {args.dim}")
    alg = get_algebra((1.0,) * args.dim)
    nb = alg.n_blades
    C = args.hidden or WIDTHS[args.dim][0]
    D = C * nb
    pair = nb > 8                  # K2p and K4p/K5p, the pair form
    gp = nb ** 2 if pair else nb ** 3   # product terms a channel
    k2, k4, k5 = ("K2p", "K4p", "K5p") if pair else ("K2", "K4", "K5")
    E, N = args.edges, args.nodes
    rng = np.random.RandomState(0)
    src = rng.randint(0, N, size=E)
    dst = np.sort(rng.randint(0, N, size=E))
    h = torch.from_numpy(rng.randn(N, C, nb).astype(np.float32)).to(dev)
    msg = torch.from_numpy(rng.randn(E, C, nb).astype(np.float32)).to(dev)
    dst_t = torch.from_numpy(dst.astype(np.int64)).to(dev)
    src_t = torch.from_numpy(src.astype(np.int64)).to(dev)
    fG = 4 if args.exact else 2   # bytes per streamed value
    print(f"# {card()}")
    print(f"# device={torch.cuda.get_device_name(dev)} E={E} N={N} C={C} "
          f"D={D} mode={'exact' if args.exact else 'fast'}")
    print(f"# measured envelope: copy {env['copy'] / 1e9:.1f} GB/s, bf16 "
          f"mma.sync {env['bf16'] / 1e12:.2f} TF/s, fp32 FMA "
          f"{env['fma'] / 1e12:.2f} TF/s")
    rows = []

    def report(name, ms, hbm_bytes, flops, peak):
        t_mem = hbm_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        bound = max(t_mem, t_ops)
        t_env = max(hbm_bytes / env["copy"], flops / env_rate[peak]) * 1e3
        rows.append((name, ms, hbm_bytes, flops, bound, t_env))
        bw = hbm_bytes / (ms * 1e-3) / 1e9
        fl = flops / (ms * 1e-3) / 1e12
        print(f"{name:34s} {ms:8.3f} ms  {bw:7.1f} GB/s "
              f"({bw / (HBM_BYTES_PER_S / 1e9) * 100:5.1f}% HBM)  "
              f"{fl:6.2f} TF/s  bound {bound:6.3f} ms "
              f"({'bytes' if t_mem >= t_ops else 'operations'}, "
              f"{ms / bound:6.1f}x data sheet)  envelope {t_env:6.3f} ms "
              f"({ms / t_env:6.1f}x measured)")

    peak = FP32_FLOPS if args.exact else BF16_FLOPS
    with torch.no_grad():
        t = timed_ms(lambda: seg.take_rows(h, dst_t) + msg, args.iters)
        report("gather h[dst] (+add)", t, 3 * E * D * 4, 0, peak)

        flat = msg.reshape(E, D)
        t = timed_ms(lambda: seg.sorted_segment_sum(flat, dst_t, N),
                     args.iters)
        report("sorted_segment_sum (K1)", t, E * D * fG + E * 8 + N * D * 4,
               E * D, FP32_FLOPS)

        gen = torch.Generator().manual_seed(0)
        lin = MVLinear(alg, C, C)
        silu = MVSiLU(alg, C)
        sgp = SteerableGeometricProductLayer(alg, C)
        mlp = CEMLP(alg, C, C, C)
        for m in (lin, silu, sgp, mlp):
            init_parameters(m, gen)
            m.to(dev)
        t = timed_ms(lambda: lin(msg), args.iters)
        report("MVLinear (E rows, plain)", t, 2 * E * D * 4,
               2 * E * C * C * nb, FP32_FLOPS)
        t = timed_ms(lambda: silu(msg), args.iters)
        report("MVSiLU (E rows, plain)", t, 2 * E * D * 4, 0, FP32_FLOPS)
        t = timed_ms(lambda: sgp(msg), args.iters)
        report("SGP (E rows, plain)", t, 2 * E * D * 4,
               2 * E * C * (2 * C * nb + nb ** 3), FP32_FLOPS)
        t = timed_ms(lambda: mlp(msg), args.iters)
        report(f"edge CEMLP fwd (2 blocks, {k2})", t, 2 * E * D * fG,
               2 * 2 * E * C * (3 * C * nb + gp), peak)

    egcl = EGCL(alg, C, C, C, aggr="mean")
    init_parameters(egcl, gen)
    egcl = egcl.to(dev)
    ei = torch.stack([src_t, dst_t])
    order = np.argsort(src, kind="stable")
    src_sort = (torch.from_numpy(order).to(dev),
                torch.from_numpy(src[order].astype(np.int64)).to(dev))
    egcl_flops = 2 * 2 * E * C * (3 * C * nb + gp) * 1.25
    egcl_bytes = (5 * E + 4 * N) * D * fG
    with torch.no_grad():
        t = timed_ms(lambda: egcl(h, ei, src_sort=src_sort), args.iters)
    report("EGCL fwd" + ("" if args.exact else f" ({k4})"), t, egcl_bytes,
           egcl_flops, peak)
    params = list(egcl.parameters())

    def step():
        out = egcl(h, ei, src_sort=src_sort)
        return torch.autograd.grad(torch.mean(out.float() ** 2), params)

    t = timed_ms(step, args.iters)
    report("EGCL fwd+bwd" + ("" if args.exact else f" ({k4} + {k5})"), t,
           3 * egcl_bytes, 3 * egcl_flops, peak)
    print("# columns: achieved bandwidth and its share of 3.35 TB/s, "
          "achieved TFLOP/s, the least time by the data sheet's rates "
          "(bytes or operations) and the multiple over it, the least time "
          "by the envelope measured at start-up and the multiple over it")
    return rows


if __name__ == "__main__":
    main()
