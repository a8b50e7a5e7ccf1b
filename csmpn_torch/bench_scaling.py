"""Scaling benchmark: one EGCL layer over a synthetic complex whose edges
are partitioned by target node.

The port of ``bench_scaling.py``.  The complex is
``make_synthetic_complex(n, degree, seed=0, locality)`` (n rounded down to
a multiple of the ranks and chunks), the layer ``EGCL(Cl(3,0), hidden,
hidden, hidden, aggr="mean")`` with weights from seed 0, and ``h`` the
global (n, hidden, 8) features drawn in fixed blocks of rows, each from
its own seeded generator on the device, so a rank draws its own rows and
the global ``h`` does not depend on the number of ranks.  The number of
ranks is the world size of the process group (``python -m
torch.distributed.run --nproc_per_node N``, one process per card; 1
without a group); ``--devices`` 0 means it, any other value must equal
it.

* The mesh sweep (no ``--stream``; needs a process group): for each mesh
  size n of ``--mesh-list`` (default 1..world, the sizes that divide the
  nodes) every rank calls ``dist.new_group(range(n))`` in the same order,
  and ranks 0..n-1 run ``sharded_egcl_apply_halo`` (``--exchange halo``)
  or ``sharded_egcl_apply`` (``allgather``) on their shard, forward and,
  unless ``--fwd-only``, backward of the global mean(out ** 2) to the
  parameters (each rank's gradients summed over the ranks); the others
  sit that size out.  Exact precision by default, as in the reference.
  Rank 0 prints the reference's line a size (edges/s = edges / step
  seconds; the exchanged rows and the padded rows the reference ships)
  and, where it ran mesh sizes 1 and world, the scaling efficiency.
* One-card streaming (``--stream K`` at world 1): ``streaming_egcl_apply``
  over K chunks with the loss ``sum over chunks of sum(out**2) / (n *
  hidden * 8)``.  On the card in fast mode (its default) ``h`` is bf16
  and each chunk's edge side runs K4 forward and K5 backward, its node
  side K2 (and K3).
* Sharded streaming (``--stream K`` at world > 1, ``run_sharded_streaming``):
  each rank exchanges once a layer (``--exchange``) and streams its K
  chunks (``sharded_streaming_egcl_apply`` or its all-gather form), the
  same loss summed over the ranks.  Fast by default.

    python -m csmpn_torch.bench_scaling --stream 64 [--simplices 1000000]
        [--degree 16] [--locality 0] [--hidden 32] [--steps 5]
        [--fwd-only] [--precision fast|exact] [--device=cuda|cpu]
    python -m torch.distributed.run --nproc_per_node N \\
        -m csmpn_torch.bench_scaling [--mesh-list 1,2,4]
        [--exchange halo|allgather] [--stream K] ...

One untimed step first (it also builds the tables kept on the device),
then ``--steps`` steps ending in one read-back; the peak of
``torch.cuda.max_memory_allocated`` over the steps is in GiB.  Rank 0
prints the lines, each with the device's name.  The default device is
``cuda``; without a card it raises.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from .algebra import get_algebra
from .bench import device_name
from .engineer.fire import _dist_setup, use_distributed
from .nn.egcl import EGCL
from .nn.modules import init_parameters
from .ops.segment import set_aggregation_mode
from .parallel.edge_partition import (
    ShardArrays,
    StreamArrays,
    group_rank,
    make_synthetic_complex,
    partition_edges,
    partition_edges_halo,
    partition_edges_halo_stream,
    sharded_egcl_apply,
    sharded_egcl_apply_halo,
    sharded_streaming_egcl_apply,
    sharded_streaming_egcl_apply_allgather,
    streaming_egcl_apply,
    sum_over_ranks,
)
from .parallel.mesh import Mesh, all_reduce_grads
from .tasks.common import resolve_device

METRIC = "streaming_edges_per_s"
N_BLADES = 8
# rows of h drawn from one seeded generator (block b from seed b)
ROW_BLOCK = 65536


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m csmpn_torch.bench_scaling")
    ap.add_argument("--simplices", type=int, default=1_000_000)
    ap.add_argument("--degree", type=int, default=16)
    ap.add_argument("--locality", type=int, default=0,
                    help="source window around the target (0: uniform)")
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks (0: the process group's world size)")
    ap.add_argument("--mesh-list", default="",
                    help="comma-separated mesh sizes of the sweep "
                         "(default: 1..world)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--fwd-only", action="store_true")
    ap.add_argument("--exchange", choices=["halo", "allgather"],
                    default="halo")
    ap.add_argument("--precision", choices=["fast", "exact"], default=None,
                    help="streaming defaults to fast, the mesh sweep to "
                         "exact")
    ap.add_argument("--stream", type=int, default=0,
                    help="chunks a rank streams (0: the mesh sweep)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def draw_h(n_nodes: int, hidden: int, lo: int, hi: int, dtype,
           device: torch.device) -> torch.Tensor:
    """Rows [lo, hi) of the global (n_nodes, hidden, 8) features: block b
    of ROW_BLOCK rows from a generator on ``device`` seeded with b."""
    out = torch.empty((hi - lo, hidden, N_BLADES), dtype=dtype,
                      device=device)
    for b in range(lo // ROW_BLOCK, -(-hi // ROW_BLOCK)):
        b0 = b * ROW_BLOCK
        rows = min(ROW_BLOCK, n_nodes - b0)
        gen = torch.Generator(device).manual_seed(b)
        blk = torch.randn((rows, hidden, N_BLADES), generator=gen,
                          device=device)
        a, z = max(lo, b0), min(hi, b0 + rows)
        out[a - lo:z - lo] = blk[a - b0:z - b0]
    return out


def make_layer(hidden: int, device: torch.device) -> EGCL:
    egcl = EGCL(get_algebra((1.0, 1.0, 1.0)), hidden, hidden, hidden,
                aggr="mean")
    init_parameters(egcl, torch.Generator().manual_seed(0))
    return egcl.to(device)


def sum_squares(out: torch.Tensor) -> torch.Tensor:
    return torch.sum(out.float() ** 2)


def make_step(egcl: EGCL, loss: Callable[[], torch.Tensor], fwd_only: bool,
              mesh: Optional[Mesh] = None, group=None) -> Callable:
    """The step: the loss under no_grad, or forward and backward with the
    first parameter's first gradient element returned; given a ``mesh``,
    the gradients summed over its ranks.  The last step's loss is in
    ``step.last["loss"]`` (a dict, so that no reference cycle keeps the
    step's tensors alive after its caller drops it)."""
    last: Dict[str, torch.Tensor] = {}
    if fwd_only:
        def step() -> torch.Tensor:
            with torch.no_grad():
                last["loss"] = loss()
            return last["loss"]
    else:
        first = next(egcl.parameters())

        def step() -> torch.Tensor:
            egcl.zero_grad(set_to_none=True)
            value = loss()
            value.backward()
            last["loss"] = value.detach()
            if mesh is not None:
                all_reduce_grads(egcl.parameters(), mesh, reduce="sum",
                                 group=group)
            return first.grad.reshape(-1)[0]
    step.last = last
    return step


def timed(res: Dict, steps: int, device: torch.device) -> Dict:
    """Runs res["step"] once untimed, then ``steps`` times ending in one
    read-back; adds first_step_s, step_s, peak_gb and the last step's
    loss to ``res``."""
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
    for _ in range(steps):
        s = step()
    float(s)
    res["step_s"] = (time.perf_counter() - t0) / steps
    res["peak_gb"] = (round(torch.cuda.max_memory_allocated(device) / 2**30,
                            2) if cuda else None)
    res["loss"] = step.last["loss"]
    return res


def build(args: argparse.Namespace, device: torch.device) -> Dict:
    """The complex, its partition (host seconds of each), h, the layer
    and the step function of a one-card streaming run."""
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
    # it
    fast = device.type == "cuda" and args.precision == "fast"
    h = draw_h(n_nodes, args.hidden, 0, n_nodes,
               torch.bfloat16 if fast else torch.float32, device)
    egcl = make_layer(args.hidden, device)
    n_elems = float(n_nodes) * args.hidden * N_BLADES

    def loss() -> torch.Tensor:
        return streaming_egcl_apply(egcl, h, part, arrays=arrays,
                                    chunk_reduce=sum_squares) / n_elems

    res = {"n_nodes": n_nodes, "n_edges": n_edges, "part": part,
           "arrays": arrays, "h": h, "egcl": egcl,
           "complex_s": complex_s, "partition_s": partition_s}
    res["step"] = make_step(egcl, loss, args.fwd_only)
    return res


def run_streaming(args: argparse.Namespace, device: torch.device) -> Dict:
    precision = args.precision = args.precision or "fast"
    set_aggregation_mode(precision)
    n_nodes = (args.simplices // args.stream) * args.stream
    print(f"# streaming: {n_nodes} simplices, ~{n_nodes * args.degree} "
          f"edges, {args.stream} chunks, precision={precision}", flush=True)
    res = build(args, device)
    print(f"# host: complex {res['complex_s']:.2f} s, partition "
          f"{res['partition_s']:.2f} s (e_chunk {res['part'].e_shard})",
          flush=True)
    timed(res, args.steps, device)
    print(f"# step {res['step_s']:.4f} s, loss {float(res['loss']):.8f}",
          flush=True)
    res["line"] = {
        "metric": METRIC,
        "simplices": res["n_nodes"],
        "edges": res["n_edges"],
        "chunks": args.stream,
        "precision": precision,
        "mode": "fwd" if args.fwd_only else "fwd+bwd",
        "value": round(res["n_edges"] / res["step_s"], 1),
        "unit": "edges/s",
        "peak_hbm_gb": res["peak_gb"],
        "device": device_name(device),
    }
    print(json.dumps(res["line"]), flush=True)
    return res


def run_sharded_streaming(args: argparse.Namespace, mesh: Mesh,
                          group=None) -> Dict:
    """The complex sharded over the ranks of ``mesh`` (``group``), each
    rank exchanging once a layer and streaming its ``--stream`` chunks,
    forward (and backward unless ``--fwd-only``) of the loss summed over
    the ranks.  Every rank returns its result; rank 0 prints."""
    precision = args.precision = args.precision or "fast"
    set_aggregation_mode(precision)
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    device, n_dev, n_chunks = mesh.device, mesh.world, args.stream
    n_nodes = (args.simplices // (n_dev * n_chunks)) * n_dev * n_chunks
    halo = args.exchange == "halo"
    say(f"# sharded streaming ({args.exchange}): {n_nodes} simplices, "
        f"~{n_nodes * args.degree} edges, {n_dev} devices x {n_chunks} "
        f"chunks, precision={precision}", flush=True)
    t0 = time.perf_counter()
    ei = make_synthetic_complex(n_nodes, args.degree, seed=0,
                                locality=args.locality or None)
    complex_s = time.perf_counter() - t0
    n_edges = ei.shape[1]
    t0 = time.perf_counter()
    if halo:
        part = partition_edges_halo_stream(ei, n_nodes, n_dev, n_chunks)
        partition_s = time.perf_counter() - t0
        say(f"# partition built in {partition_s:.1f}s: e_chunk="
            f"{part.e_chunk} h_max={part.h_max} "
            f"halo_rows={int(part.send_mask.sum())}", flush=True)
        apply = sharded_streaming_egcl_apply
    else:
        part = partition_edges(ei, n_nodes, n_dev * n_chunks)
        partition_s = time.perf_counter() - t0
        say(f"# partition built in {partition_s:.1f}s: "
            f"e_chunk={part.e_shard}", flush=True)
        apply = sharded_streaming_egcl_apply_allgather
    del ei
    tabs = ShardArrays(part, mesh.rank, n_dev, device)
    nps = n_nodes // n_dev
    fast = device.type == "cuda" and precision == "fast"
    h = draw_h(n_nodes, args.hidden, mesh.rank * nps, (mesh.rank + 1) * nps,
               torch.bfloat16 if fast else torch.float32, device)
    egcl = make_layer(args.hidden, device)
    n_elems = float(n_nodes) * args.hidden * N_BLADES

    def loss() -> torch.Tensor:
        return apply(egcl, h, part, arrays=tabs, chunk_reduce=sum_squares,
                     group=group) / n_elems

    res = {"n_nodes": n_nodes, "n_edges": n_edges, "part": part,
           "arrays": tabs, "h": h, "egcl": egcl,
           "complex_s": complex_s, "partition_s": partition_s}
    res["step"] = make_step(egcl, loss, args.fwd_only, mesh, group)
    timed(res, args.steps, device)
    feat_bytes = args.hidden * N_BLADES * (2 if fast else 4)
    if halo:
        sent_rows = int(part.send_mask.sum())
        padded_rows = part.n_shards * part.n_shards * part.h_max
    else:
        sent_rows = padded_rows = (n_dev - 1) * n_nodes
    res["line"] = {
        "metric": "sharded_streaming_edges_per_s",
        "exchange": args.exchange,
        "simplices": n_nodes,
        "edges": n_edges,
        "devices": n_dev,
        "chunks_per_device": n_chunks,
        "precision": precision,
        "mode": "fwd" if args.fwd_only else "fwd+bwd",
        "value": round(n_edges / res["step_s"], 1),
        "unit": "edges/s",
        "comm_rows": sent_rows,
        "comm_rows_padded": padded_rows,
        "comm_mb_per_layer": round(padded_rows * feat_bytes / 1e6, 2),
        "allgather_rows_equiv": (n_dev - 1) * n_nodes,
        "device": device_name(device),
    }
    say(f"# host: complex {complex_s:.2f} s, partition {partition_s:.2f} s;"
        f" step {res['step_s']:.4f} s; peak {res['peak_gb']} GiB on rank 0;"
        f" loss {float(res['loss']):.8f}", flush=True)
    say(json.dumps(res["line"]), flush=True)
    return res


def run_mesh_size(args: argparse.Namespace, mesh: Mesh, group, ei,
                  n_nodes: int, egcl: EGCL) -> Dict:
    """One mesh size of the sweep on this rank (``mesh`` the size's ranks,
    ``group`` their process group): the partition, the rank's rows of h,
    the step of the loss summed over the ranks, timed; the line."""
    n, device = mesh.world, mesh.device
    nps = n_nodes // n
    if args.exchange == "halo":
        part = partition_edges_halo(ei, n_nodes, n)
        apply = sharded_egcl_apply_halo
        # one feature row per (owner, consumer, boundary simplex)
        sent_rows = int(part.send_mask.sum())
        padded_rows = n * n * part.h_max
    else:
        part = partition_edges(ei, n_nodes, n)
        apply = sharded_egcl_apply
        sent_rows = padded_rows = (n - 1) * n_nodes
    tabs = ShardArrays(part, mesh.rank, n, device)
    h = draw_h(n_nodes, args.hidden, mesh.rank * nps, (mesh.rank + 1) * nps,
               torch.float32, device)
    n_elems = float(n_nodes) * args.hidden * N_BLADES

    def loss() -> torch.Tensor:
        return sum_over_ranks(sum_squares(apply(
            egcl, h, part, arrays=tabs, group=group)), group) / n_elems

    res = {"part": part, "arrays": tabs, "h": h, "egcl": egcl}
    res["step"] = make_step(egcl, loss, args.fwd_only, mesh, group)
    timed(res, args.steps, device)
    res["line"] = {
        "metric": "edge_partitioned_edges_per_s",
        "exchange": args.exchange,
        "mesh_devices": n,
        "value": round(ei.shape[1] / res["step_s"], 1),
        "unit": "edges/s",
        "comm_rows": sent_rows,
        "comm_rows_padded": padded_rows,
        "comm_mb": round(padded_rows * args.hidden * N_BLADES * 4 / 1e6, 2),
        "device": device_name(device),
    }
    return res


def run_sweep(args: argparse.Namespace, mesh: Mesh) -> Dict:
    """The mesh sweep (module docstring).  Returns, on every rank, the
    rates rank 0 measured at each size it ran and, under "sizes", each
    size's result this rank took part in."""
    precision = args.precision = args.precision or "exact"
    set_aggregation_mode(precision)
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    world, device = mesh.world, mesh.device
    n_nodes = (args.simplices // world) * world
    say(f"# building synthetic complex: {n_nodes} simplices, "
        f"~{n_nodes * args.degree} edges", flush=True)
    ei = make_synthetic_complex(n_nodes, args.degree, seed=0,
                                locality=args.locality or None)
    egcl = make_layer(args.hidden, device)
    sizes = ([int(x) for x in args.mesh_list.split(",") if x]
             if args.mesh_list else list(range(1, world + 1)))
    if any(n < 1 or n > world for n in sizes):
        raise ValueError(f"mesh sizes {sizes} outside 1..{world}")
    rates, out = {}, {}
    for n in sizes:
        if n_nodes % n:
            continue
        group = dist.new_group(list(range(n)))   # every rank, same order
        if mesh.rank >= n:
            continue
        res = run_mesh_size(args, Mesh(mesh.rank, n, device), group, ei,
                            n_nodes, egcl)
        rates[n] = ei.shape[1] / res["step_s"]
        say(f"# mesh {n}: step {res['step_s']:.4f} s, peak {res['peak_gb']} "
            f"GiB on rank 0, loss {float(res['loss']):.8f}", flush=True)
        say(json.dumps(res["line"]), flush=True)
        out[n] = res
    result = {"rates": rates, "sizes": out, "n_edges": ei.shape[1],
              "precision": precision}
    if 1 in rates and world in rates and world > 1:
        result["efficiency"] = {
            "metric": "edges_per_s_scaling_efficiency",
            "mesh_devices": world,
            "value": round(rates[world] / (rates[1] * world), 3),
            "unit": "fraction_of_linear",
            "device": device_name(device),
        }
        say(json.dumps(result["efficiency"]), flush=True)
    return result


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    joined = use_distributed() and not dist.is_initialized()
    if joined:
        _dist_setup(args.device)
    try:
        world = dist.get_world_size() if dist.is_initialized() else 1
        if args.devices not in (0, world):
            raise ValueError(
                f"--devices {args.devices}, but {world} rank(s): launch one "
                f"process per card with python -m torch.distributed.run "
                f"--nproc_per_node {args.devices}")
        if args.stream and world == 1:
            return run_streaming(args, device)
        rank, world = group_rank()
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = Mesh(rank=rank, world=world, device=device)
        if args.stream:
            return run_sharded_streaming(args, mesh)
        return run_sweep(args, mesh)
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
