"""Scaling benchmark, one-card streaming mode: one EGCL layer over a
synthetic complex too large for its edge messages to fit on the card.

The port of ``bench_scaling.py --stream`` (``run_streaming``): the complex
of ``make_synthetic_complex(n, degree, seed=0, locality)`` with ``n =
(simplices // stream) * stream`` simplices, partitioned into ``--stream``
chunks by target; ``EGCL(Cl(3,0), hidden, hidden, hidden, aggr="mean")``
with weights from seed 0 streamed over them (``streaming_egcl_apply``) with
the loss ``sum over chunks of sum(out**2) / (n * hidden * 8)``, forward
and, unless ``--fwd-only``, backward to the layer's parameters.  On the
card in fast mode (the default) ``h`` is bf16 and each chunk's edge side
runs K4 forward and K5 backward, its node side K2 (and K3).

    python -m csmpn_torch.bench_scaling --stream 64 [--simplices 1000000]
        [--degree 16] [--locality 0] [--hidden 32] [--steps 5]
        [--fwd-only] [--precision fast|exact] [--device=cuda|cpu]

One untimed step first (it also builds each chunk's window plan and
in-degrees), then ``--steps`` steps ending in one read-back; prints the
reference's JSON line (edges/s = edges / step seconds, the peak of
``torch.cuda.max_memory_allocated`` over the steps as ``peak_hbm_gb``, in
GiB) with the device's name.  The default device is ``cuda``; without a
card it raises.  The mesh sweep (no ``--stream``) and sharded streaming
(``--devices`` above 1) are not ported yet.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Sequence

import torch

from .algebra import get_algebra
from .bench import device_name
from .nn.egcl import EGCL
from .nn.modules import init_parameters
from .ops.segment import aggregation_exact, set_aggregation_mode
from .parallel.edge_partition import (
    StreamArrays,
    make_synthetic_complex,
    partition_edges,
    streaming_egcl_apply,
)
from .tasks.common import resolve_device

METRIC = "streaming_edges_per_s"
N_BLADES = 8


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m csmpn_torch.bench_scaling")
    ap.add_argument("--simplices", type=int, default=1_000_000)
    ap.add_argument("--degree", type=int, default=16)
    ap.add_argument("--locality", type=int, default=0,
                    help="source window around the target (0: uniform)")
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--fwd-only", action="store_true")
    ap.add_argument("--precision", choices=["fast", "exact"], default="fast")
    ap.add_argument("--stream", type=int, default=0,
                    help="chunks of the one-card streaming mode")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(args: argparse.Namespace, device: torch.device) -> Dict:
    """The complex, its partition (host seconds of each), h, the layer
    and the step function of a streaming run."""
    n_chunks = args.stream
    n_nodes = (args.simplices // n_chunks) * n_chunks
    t0 = time.perf_counter()
    ei = make_synthetic_complex(n_nodes, args.degree, seed=0,
                                locality=args.locality or None)
    complex_s = time.perf_counter() - t0
    n_edges = ei.shape[1]
    t0 = time.perf_counter()
    part = partition_edges(ei, n_nodes, n_chunks)
    partition_s = time.perf_counter() - t0
    del ei
    arrays = StreamArrays.of(part, device)
    # on the card in fast mode h is stored bf16, as the reference stores
    # it; drawn on the device from a seeded generator
    fast = device.type == "cuda" and not aggregation_exact()
    gen = torch.Generator(device).manual_seed(0)
    h = torch.randn((n_nodes, args.hidden, N_BLADES), generator=gen,
                    device=device,
                    dtype=torch.bfloat16 if fast else torch.float32)
    egcl = EGCL(get_algebra((1.0, 1.0, 1.0)), args.hidden, args.hidden,
                args.hidden, aggr="mean")
    init_parameters(egcl, torch.Generator().manual_seed(0))
    egcl = egcl.to(device)
    n_elems = float(n_nodes) * args.hidden * N_BLADES

    def reduce(out: torch.Tensor) -> torch.Tensor:
        return torch.sum(out.float() ** 2)

    def loss() -> torch.Tensor:
        return streaming_egcl_apply(egcl, h, part, arrays=arrays,
                                    chunk_reduce=reduce) / n_elems

    if args.fwd_only:
        def step() -> torch.Tensor:
            with torch.no_grad():
                return loss()
    else:
        first = next(egcl.parameters())

        def step() -> torch.Tensor:
            egcl.zero_grad(set_to_none=True)
            loss().backward()
            return first.grad.reshape(-1)[0]

    return {"n_nodes": n_nodes, "n_edges": n_edges, "part": part,
            "arrays": arrays, "h": h, "egcl": egcl, "step": step,
            "complex_s": complex_s, "partition_s": partition_s}


def run_streaming(args: argparse.Namespace, device: torch.device) -> Dict:
    precision = args.precision
    set_aggregation_mode(precision)
    n_nodes = (args.simplices // args.stream) * args.stream
    print(f"# streaming: {n_nodes} simplices, ~{n_nodes * args.degree} "
          f"edges, {args.stream} chunks, precision={precision}", flush=True)
    res = build(args, device)
    print(f"# host: complex {res['complex_s']:.2f} s, partition "
          f"{res['partition_s']:.2f} s (e_chunk {res['part'].e_shard})",
          flush=True)
    step = res["step"]
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    float(step())                       # tables built, kernels loaded
    res["first_step_s"] = time.perf_counter() - t0
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    s = None
    for _ in range(args.steps):
        s = step()
    float(s)
    dt = (time.perf_counter() - t0) / args.steps
    peak = (round(torch.cuda.max_memory_allocated(device) / 2**30, 2)
            if cuda else None)
    res.update(step_s=dt, peak_gb=peak)
    res["line"] = {
        "metric": METRIC,
        "simplices": res["n_nodes"],
        "edges": res["n_edges"],
        "chunks": args.stream,
        "precision": precision,
        "mode": "fwd" if args.fwd_only else "fwd+bwd",
        "value": round(res["n_edges"] / dt, 1),
        "unit": "edges/s",
        "peak_hbm_gb": peak,
        "device": device_name(device),
    }
    print(json.dumps(res["line"]), flush=True)
    return res


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    if args.devices > 1:
        raise NotImplementedError(
            "sharded streaming over several cards (--devices > 1) is not "
            "ported yet: ROADMAP Queue 1 items 3-4 (S5b, S5c)")
    if not args.stream:
        raise NotImplementedError(
            "the mesh sweep (no --stream) is not ported yet: ROADMAP Queue 1 "
            "items 3-4 (S5b, S5c); pass --stream N for one-card streaming")
    return run_streaming(args, resolve_device(args.device))


if __name__ == "__main__":
    main()
