"""Benchmark: simplicial message-passing training throughput (edges/s).

The port of ``bench.py``: the flat EGCL stack — 3 EGCL layers on Cl(3,0),
hidden 32, mean aggregation, ``bf16_out`` on every layer but the last —
trained with forward + backward + Adam on 4 graphs of 2,048 nodes and
32,768 target-sorted edges each (N = 8,192, E = 131,072), built by the
same generator from the same seed, with the host-precomputed source sort.
On the card in fast mode each layer's edge side runs the fused kernels K4
(forward) and K5 (backward); the node side runs K2/K3 and the source
gather's backward K1.

    python -m csmpn_torch.bench [--quick] [--device=cuda|cpu]
        [--dim 2|3|4|5]

``--dim`` (the port's own option; the reference bench builds Cl(3) only)
sets the stack's algebra Cl(dim, 0) and takes its width from the task
config of that algebra (``WIDTHS``): Cl(2,0) at hidden 40 (the NBA task)
runs K4/K5 at Cl(2) on the edge side and K2/K3 at Cl(2) on the node side;
Cl(5,0) at hidden 28 (the hulls task) runs their pair form, K4p/K5p and
K2p/K3p; Cl(4,0), which no task runs, at hidden 28, the width of the pair
form's other algebra, runs K4p/K5p and K2p/K3p at Cl(4).  The graph, the
seed and the random stream are the same; the features are (N, hidden,
2**dim).

Times windows of 10 steps (3 with ``--quick``), each ending on a loss
read-back, and reports the fastest of 3 windows as edges/s =
4 * 32,768 * 3 / step seconds, on one JSON line with the device's name
(and, away from Cl(3), the algebra and the width).  The default device is
``cuda``; without a card it raises.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .algebra import get_algebra
from .nn.egcl import EGCL
from .nn.modules import init_parameters
from .ops.segment import set_aggregation_mode
from .tasks.common import resolve_device

METRIC = "simplicial_aggregation_edges_per_s_per_chip"
N_NODES = 2048
N_EDGES = 32768
BATCH = 4
HIDDEN = 32
LAYERS = 3
STEPS = 10
WINDOWS = 3
DIM = 3
# --dim -> (hidden width, its source): the width of the task that runs
# that algebra
WIDTHS = {
    3: (HIDDEN, "bench.py"),
    2: (40, "configs/nba.yaml (model.num_hidden, NBA at Cl(2,0))"),
    5: (28, "HullsModel's default hidden_features (hulls at Cl(5,0))"),
    4: (28, "no task runs Cl(4,0): the width of the pair form's other "
            "algebra, HullsModel's default hidden_features (hulls at "
            "Cl(5,0))"),
}


def synthetic_edges(rng: np.random.RandomState, n_nodes: int,
                    n_edges: int) -> np.ndarray:
    """Sorted-by-target random edge list (degree-uniform), (2, E) int32
    rows [source, target]."""
    src = rng.randint(0, n_nodes, size=n_edges)
    dst = rng.randint(0, n_nodes, size=n_edges)
    order = np.lexsort((src, dst))
    return np.stack([src[order], dst[order]]).astype(np.int32)


def workload(device, n_nodes: int = N_NODES, n_edges: int = N_EDGES,
             batch: int = BATCH, hidden: int = HIDDEN, seed: int = 0,
             dim: int = DIM):
    """(h, edge_index, src_sort) of ``batch`` graphs flattened, as the
    reference bench makes them: edges, then features (N, hidden, 2**dim),
    from one numpy stream, and the stable sort of the sources on the
    host."""
    rng = np.random.RandomState(seed)
    ei = np.concatenate([synthetic_edges(rng, n_nodes, n_edges) + b * n_nodes
                         for b in range(batch)], axis=1)
    h = rng.randn(batch * n_nodes, hidden, 2 ** dim).astype(np.float32)
    order = np.argsort(ei[0], kind="stable")
    src_sort = (torch.from_numpy(order).to(device),
                torch.from_numpy(ei[0][order].astype(np.int64)).to(device))
    return (torch.from_numpy(h).to(device),
            torch.from_numpy(ei.astype(np.int64)).to(device), src_sort)


class Stack(nn.Module):
    """The bench model: EGCL layers ``egcl_{i}``, as the reference's flax
    ``Stack`` names them, so ``convert.params_from_jax`` carries it over."""

    def __init__(self, hidden: int = HIDDEN, layers: int = LAYERS,
                 dim: int = DIM):
        super().__init__()
        alg = get_algebra((1.0,) * dim)
        self.layers = layers
        for i in range(layers):
            setattr(self, f"egcl_{i}", EGCL(alg, hidden, hidden, hidden,
                                            aggr="mean",
                                            bf16_out=(i + 1 < layers)))

    def forward(self, h, edge_index, src_sort=None):
        for i in range(self.layers):
            h = getattr(self, f"egcl_{i}")(h, edge_index, src_sort=src_sort)
        return h


def loss_fn(out: torch.Tensor) -> torch.Tensor:
    return torch.mean(out.float() ** 2)


def train_step(model, opt, h, edge_index, src_sort) -> torch.Tensor:
    loss = loss_fn(model(h, edge_index, src_sort))
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


class _StepClock:
    """Step boundaries: CUDA events on the card (read after the window's
    read-back), the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks: List = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self) -> List[float]:
        if self.cuda:
            return [a.elapsed_time(b) / 1e3
                    for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def run(device, steps: int = STEPS, windows: int = WINDOWS,
        n_nodes: int = N_NODES, n_edges: int = N_EDGES, batch: int = BATCH,
        hidden: int = HIDDEN, layers: int = LAYERS, seed: int = 0,
        dim: int = DIM) -> Dict:
    """Builds the workload and the model (weights from ``seed``), runs one
    warm-up window, then ``windows`` timed windows of ``steps`` steps."""
    device = torch.device(device)
    h, ei, src_sort = workload(device, n_nodes, n_edges, batch, hidden, seed,
                               dim)
    model = Stack(hidden, layers, dim)
    init_parameters(model, torch.Generator().manual_seed(seed))
    model = model.to(device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def window(clock: Optional[_StepClock] = None):
        loss = None
        for _ in range(steps):
            if clock is not None:
                clock.mark()
            loss = train_step(model, opt, h, ei, src_sort)
        if clock is not None:
            clock.mark()
        return float(loss)

    window()
    best = float("inf")
    step_s: List[float] = []
    losses = []
    for _ in range(windows):
        clock = _StepClock(device)
        t0 = time.perf_counter()
        losses.append(window(clock))
        best = min(best, (time.perf_counter() - t0) / steps)
        step_s += clock.seconds()
    edges = batch * n_edges * layers
    return {"edges_per_s": edges / best, "step_s": best,
            "step_times_s": step_s, "losses": losses, "model": model,
            "optimizer": opt, "inputs": (h, ei, src_sort)}


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    quick = "--quick" in argv
    dev, dim = "cuda", DIM
    args = iter(argv)
    for a in args:
        if a.startswith("--device="):
            dev = a.split("=", 1)[1]
        elif a == "--dim":
            dim = int(next(args))
        elif a.startswith("--dim="):
            dim = int(a.split("=", 1)[1])
    if dim not in WIDTHS:
        raise ValueError(f"--dim takes {sorted(WIDTHS)}, got {dim}")
    device = resolve_device(dev)
    set_aggregation_mode("fast")
    hidden = WIDTHS[dim][0]
    res = run(device, steps=3 if quick else STEPS, hidden=hidden, dim=dim)
    res["line"] = {"metric": METRIC, "value": round(res["edges_per_s"], 1),
                   "unit": "edges/s", "device": device_name(device)}
    if dim != DIM:
        res["line"].update(algebra=f"Cl({dim},0)", hidden=hidden)
    print(json.dumps(res["line"]))
    return res


if __name__ == "__main__":
    main()
