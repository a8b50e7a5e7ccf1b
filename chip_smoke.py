"""Smoke run of csmpn_torch on one CUDA card (an H100).

    python3 chip_smoke.py            # from the root of a checkout

1. prints the card (nvidia-smi name and power limit) and builds the CUDA
   kernels from csmpn_torch/csrc, all sources in parallel, with each
   kernel's registers and spills; shows that the fast-mode row tile
   kernels take at every C at least the inputs their exact-mode row
   kernels take: the backwards of the dense form (K3 and K5) and of the
   pair form (K3p at Cl(5) and Cl(4)), the forwards of both forms (K2 at
   Cl(3) and Cl(2), whose fast mode holds the x tile in chunks where it
   does not fit whole, and K2p) and the dense fused forward (K4 at Cl(3)
   and Cl(2), whose fast mode sums sub-windows where a window's sum does
   not fit);
2. the envelope probe (P1 copy on TMA bulk copies, P2 resident matrix
   product in bf16 and tf32 on wgmma and fp32 FFMA, P3 FMA chain): the
   SASS of the built library (wgmma's HGMMA and no HMMA in P2's tensor-core
   kernels, the bulk copy UBLKCP in P1's), each kernel against its plain
   version at tools/mxu_probe.py's sizes (P1 bitwise at every tile height
   and at a ragged R = 131,109), two launches bitwise equal, then the
   probe through its entry point with its launches counted, the plain and
   library times, the bounds, and the measured envelope against the data
   sheet;
   every later bound is also given against that envelope;
3. holds each kernel against its plain PyTorch version on the card, in
   exact and fast mode, with stated tolerances: K1 (bf16 and fp32 rows,
   sum and masked mean, on the real batch's ids, with a sentinel tail,
   and on synthetic ids; bitwise repeatable) at the motion widths D = 224
   and 24 and, in the later phases, at every task's and every bench
   algebra's width (160, 256, 896, 448), timed beside
   torch.segment_reduce; K2 and K3 at the
   motion task's shapes and K2/K3 at the bench widths (K2 bitwise
   repeatable); K4 and K5 (fused
   message passing) over the bench graph and the stress layouts (empty
   windows, few edges over many windows, masked edges, ragged E and N,
   with and without edge attributes), bitwise repeatable, masked rows of
   d(hj) exactly 0; the same for K4/K5 at Cl(2) (C = 40, or 28 with
   attributes, 45 and 53, where the fast K4 sums sub-windows) and for
   K4p/K5p, the pair form at Cl(5) (C = 28, the
   layouts cut to at most 16,384 edges: the plain pair form holds
   (E, C, 32, 32) products) and at Cl(4) (C = 28, cut to at most 65,536
   edges: (E, C, 16, 16) products, a quarter of Cl(5)'s a row);
4. times each kernel, its plain version, a PyTorch library call where one
   computes the same function, and states the least time the card could
   take (bytes over 3.35 TB/s or operations over the peak rate); for K4
   and K5 also the composed route (gather, edge CEMLP on K2/K3,
   aggregation on K1) computing the same function, and so for K4/K5 at
   Cl(2) and K4p/K5p at Cl(5) and Cl(4) at the bench shape of their
   algebra (K4p/K5p held to the composed route there, their plain
   versions timed on the cut graph);
5. the layer options (phase_layer_options), exact and fast, each on the
   card against the CPU with its launches counted: a default CEMLP at the
   motion edge block widths launches K2 and K3 once a block; the same
   CEMLP with normalization_init=None or fused=False launches none, and
   with fused=True and normalization_init=None raises ValueError; an EGCL
   on a motion-size flat graph launches K4/K5 (fast) by default and none
   of K2-K5 with fused_mlp=False; the flat EGCL at the bench shape with
   normalization_init=None launches none of K2-K5; MVSiLU("norm") and the
   SGP with every option at Cl(3) and Cl(5) (no kernel); then checks the
   full-width motion model on the card against the same model on the CPU
   (loss and every gradient, exact mode);
6. runs the motion task through its entry point (fire -> run_task ->
   Trainer.fit) at the configs/motion.yaml widths for 8 training steps in
   the default fast precision, shows that K1, K2 and K3 ran, counts their
   launches in one training step (19 K2 and 19 K3) and profiles a few
   steps' device time, in which K2 is its row tile kernel
   (``cemlp_fwd_tile_kernel`` after ``pack_tparams_kernel``, never the
   exact-mode ``cemlp_fwd_kernel``; so at NBA, MD17 and the Cl(3) and
   Cl(2) benches); then starts the same task from its sweep file
   (phase_sweep: ``build_commands`` of csmpn_torch/configs/motion.yaml
   with the same overrides), once in-process through fire (K1-K3 counted,
   its losses against the direct run's) and once through ``python -m
   csmpn_torch.engineer.sweep`` as a child process (its printed losses
   against the in-process run's);
7. the hulls path (Cl(5,0), configs/hulls.yaml widths: hidden 28, 3 EGCL
   layers, batch 16) on a dataset cut to 512/256/256 samples: K1 at
   D = 896 on a real batch's ids; K2p and K3p (the pair-form block
   kernels) against their plain versions at every block shape of a hulls
   step, exact and fast, every gradient, two launches bitwise equal, and
   their times; the full-width hulls model on the card against the CPU
   (loss and every gradient, exact; fast loss against exact); then the
   hulls task through its entry point for 8 fast steps, with K1, K2p and
   K3p counted (15 K2p and 15 K3p launches per step) and a profile;
8. the NBA path (Cl(2,0), configs/nba.yaml widths: hidden 40, 3 EGCL
   layers, batch 100; stand-in data at 800 plays): K1 at D = 160 on a real
   batch's ids; K2 and K3 at Cl(2) (4 blades, up to 40 channels) against
   their plain versions at every block shape of an NBA step, exact and
   fast, every gradient, two launches bitwise equal, and their times; the
   full-width model card vs CPU; the task through its entry point for 8
   fast steps with 15 + 15 Cl(2) launches per step and a profile;
9. the MD17 path (aspirin, Cl(3,0), configs/md17.yaml widths: hidden 32,
   5 EGCL layers, batch 100, k = 3; samples cut to 500/200/200): the
   lift's backend and time, K1 at D = 256, K2 and K3 at every MD17 block
   shape (the 90 -> 32 backward, the widest, included) with the checks of
   8, the full-width model card vs CPU, the task for 8 fast steps with
   24 + 24 launches per step; then K3 and K5 at Cl(3) and Cl(2) against
   their plain versions at one shape of each instance of their fast-mode
   tile kernels (weight-gradient tiles a warp; K3's x tile whole and in
   chunks) and at K3's widest C, with the checks of 3 and 8, in both
   modes where the exact mode takes the shape; K2 likewise at one shape
   of each of its two fast-mode instances (x tile whole, in chunks) and
   at its widest C, and read (not held) at C = 1-3; and K3p at Cl(5) and Cl(4)
   at one shape of each instance of its fast-mode row tiles (16, 24, 32
   weight-gradient tiles a warp) and at its widest C, and K2p at C_MIN and
   its widest C (each at the widest input its exact mode takes), over
   1,001 rows;
    After its eager run, each of 6-9 runs its task under CUDA graphs
    through the entry point (``--trainer.steps_per_dispatch=8
    --trainer.device_data=True --trainer.eval_batches_per_dispatch=2``,
    16 steps, a profile window over the second group), with the eager
    step's profile first holding the kernel names that each launch
    counter stands for (``KERNEL_OF``) to the wrappers' counts: the graph
    runs' losses against eager K = 1 runs from the same seed (exact
    precision, the graph both copying host batches and gathering them in
    the graph with device_data: all 16 within 1e-5 of an eager run with
    the graph's capturable Adam, the first 8 within 1e-4 of today's eager
    path; fast precision, device_data: all 16 and the first 8 within
    1e-2 of the same two; the reasons at G_TOL), 13 replays of the
    captured step after 3 eager warm-up steps, the lr written before the
    last replay, the eval graph replayed, the trace written; the step
    times of both modes in turns (4 x 32 steps each: median, p10, p90); a
    profile of graph groups (no wrapper called in it, each kernel run as
    often a step as the eager step launches it, busy share, the
    hand-written kernels' device times beside the eager profile's, K2's
    row tile kernel); motion also trains 256 steps at
    ``steps_per_dispatch=128 eval_batches_per_dispatch=20 device_data``,
    the form of the reference's long runs: the wrappers' K3 launches only
    the warm-up's and the capture's, and the trainer's own trace of the
    second group's 128 replayed steps holding each kernel's runs a step to
    the eager step's launches;
    After the task phases, the data-parallel path (S5b): the motion task
    through its entry point with ``--data_parallel=true`` in an NCCL
    process group of one that ``engineer.fire`` joins from torchrun's
    variables, 8 eager steps and 16 at ``steps_per_dispatch=8`` (the
    all-reduce of the gradients and the loss inside the captured step):
    under ``torch.use_deterministic_algorithms`` the final parameters and
    losses bitwise equal to the same runs without data parallel; then,
    without it, its launches counted, a profile of each mode holding one
    NCCL all-reduce kernel a step besides K1, K2 and K3, and the step
    times with and without the all-reduce in turns, with the
    all-reduce's device time a step;
10. runs the bench path through its entry point (csmpn_torch.bench.main:
    3 EGCL layers, hidden 32, E = 131,072, N = 8,192, forward + backward +
    Adam), shows that K1-K5 ran and counts their launches in one step,
    profiles a few steps, holds its fast-mode loss to its exact-mode loss,
    and, in fast mode, its loss and every gradient on K4/K5 to the same
    stack on the composed route; then the same at ``--dim 2`` (Cl(2,0),
    hidden 40: K1 2, K2/K3 at Cl(2) 6 + 6, K4/K5 at Cl(2) 3 + 3 launches
    per step), ``--dim 5`` (Cl(5,0), hidden 28: K1 2, K2p/K3p 6 + 6,
    K4p/K5p 3 + 3) and ``--dim 4`` (Cl(4,0), hidden 28: K1 2, K2p/K3p at
    Cl(4) 6 + 6, K4p/K5p at Cl(4) 3 + 3, no Cl(5) launch), after K2p/K3p
    at Cl(4) are held to their plain versions at the bench's node-block
    shapes (8,192 rows, 56 -> 28 and 28 -> 28), a narrow one (3 -> 4) and
    one with attribute-width input (34 -> 28), as in 7, and timed;
11. the one-card streaming path (S5a): one EGCL layer (Cl(3,0), hidden
    32, mean) streamed over 16 chunks of a 262,144-simplex complex against
    the same layer unstreamed on the card, fast (K4/K5) and exact (the
    composed route): output (bitwise equal in fast mode), d(h) and every
    parameter gradient, and the streamed step's launches; K4/K5 (fast),
    K2/K3 (both modes) and K1 on a chunk of 10,000,000 edge rows (offsets
    past 2**31 elements) bitwise against the same kernels on its upper
    rows alone; then the reference's workload through
    ``csmpn_torch.bench_scaling.main --simplices 10000000 --degree 8
    --stream 64`` (80M edges, fwd+bwd, fast): its JSON line, the host
    times of the complex and the partition, the step time, the peak
    memory, the launches of a step (64 K4 and 64 K5) and a profiled
    step's device time by kernel; and the same workload forward only,
    whose peak must lie the saved aggregates' bytes below;
12. the edge-partitioned path (S5c) in an NCCL process group of one: at
    world 1 (262,144 simplices, in-degree 16, hidden 32) the halo and
    all-gather layers against the flat EGCL layer (exact: the same
    composed route; fast: K2/K3 and K1 against K4/K5), the two sharded
    streaming forms against ``streaming_egcl_apply`` on the same 16
    chunks, and the shard bodies of a 4-shard halo partition on one card
    (each shard's halo rows indexed from the full h) against the world-1
    halo layer: outputs, d(h) and every parameter gradient, with each
    form's launches a step asserted; then the entry points: the mesh
    sweep (``csmpn_torch.bench_scaling.main --mesh-list 1``, exact) in
    both exchanges with its lines, peaks and launches a step, and
    ``run_sharded_streaming`` at the reference's 10M-simplex, 80M-edge
    workload (64 chunks, fast, fwd+bwd): its line, host times, peak,
    launches a step, a profiled step and the exchanges' device ops alone;
    last the host tables of 8 shards x 8 chunks of the 10M complex at
    locality 4096 beside the reference's record;
13. prints each task's eager and graph step times beside the aims, the
    kernels JSON line (twenty kernels; beside each kernel's own path, its
    launches on the others: for a graph run the wrappers' launches in the
    run and, as ``launches_per_step_<task>_graph``, its runs a step in
    the profile of replays; ``launches_stream`` and
    ``launches_per_step_stream`` for the streaming run; ``launches_dp``
    and ``launches_dp_graph`` for the data-parallel runs;
    ``launches_sharded`` for the sharded entry points and
    ``launches_per_step_sharded`` for a sharded streaming step;
    ``launches_sweep`` for the sweep's in-process run and
    ``launches_layer_options`` for each case of phase_layer_options) and,
    last, the device JSON line.

Any failed check raises, so the script exits non-zero and prints no
result line.  It needs one card and imports nothing of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import io
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
MEM_BW = 3.35e12        # H100 SXM HBM3, bytes/s
FP32_PEAK = 67e12       # FP32 outside the tensor cores, FLOP/s
BF16_PEAK = 989e12      # bf16 tensor cores, dense, FLOP/s

# motion task at configs/motion.yaml widths: batch 100, N = 56 nodes and
# E_max = 232 edges per sample, hidden 28, 3 simplex types
B, N_PER, E_PER, HID = 100, 56, 232, 28
E_TOT, N_TOT = B * E_PER, B * N_PER
CEMLP_SHAPES = [            # (name, rows, Cin, C)
    ("edge_block0", E_TOT, HID + 6, HID),
    ("edge_block1", E_TOT, HID, HID),
    ("node_block0", N_TOT, 2 * HID + 3, HID),
    ("node_block1", N_TOT, HID, HID),
    ("embed_1", B * 16 * 2, 4, HID),
    ("embed_2_block0", B * 8 * 6, 6, HID),
    ("embed_2_block1", B * 8 * 6, HID, HID),
]
# the bench path (csmpn_torch.bench): 4 graphs x 2,048 nodes x 32,768
# edges, hidden 32; the node blocks run K2/K3, the edge blocks are the
# composed route's (compared with K4/K5 in phase_fused_time)
BN, BE, BH = 4 * 2048, 4 * 32768, 32
BENCH_SHAPES = [
    ("bench_node_block0", BN, 2 * BH, BH),
    ("bench_node_block1", BN, BH, BH),
    ("bench_edge_block0", BE, BH, BH),
    ("bench_edge_block1", BE, BH, BH),
]
TOL = {  # max |kernel - plain| allowed, relative to max |plain|: fp32
    # summation order in exact mode; in fast mode, bf16 rounding points
    # that a different fp32 order can flip (the plain backward rounds
    # cotangents where autograd meets the casts, the kernel before use)
    "k1": 1e-5, "k2_exact": 1e-5, "k2_fast": 1e-2,
    "k3_exact": 1e-4, "k3_fast": 3e-2,
    "k4_exact": 1e-5, "k4_fast": 1e-2,
    "k5_exact": 1e-4, "k5_fast": 3e-2,
    # the bench stack (phase_bench), readings on the H100 in PERF.md.  Its
    # fast-mode loss against its exact-mode loss: bf16 activation storage
    # through 3 residual layers, read 5.2e-5.  In fast mode, its loss and
    # gradients (worst tensor, relative to its max) on K4/K5 against the
    # composed route, which rounds at the same points: read 1.3e-5 and
    # 7.2e-3 (median 1.4e-3); the gradient limit is K5's own
    "bench_fast_loss": 1e-3, "bench_fused_loss": 3e-4,
    "bench_fused_grad": 3e-2,
    # K2p/K3p (the pair form at Cl(5)) against their plain versions over
    # the hulls launch shapes, readings on the H100 in PERF.md: exact
    # 3.9e-7 (forward) and 2.8e-6 (backward, fp32 summation order); fast
    # 1.5e-3 and 7.1e-3 (bf16 rounding points that a different fp32 order
    # upstream can flip; the plain backward rounds cotangents where
    # autograd meets the casts, the kernel before use)
    "k2p_exact": 2e-6, "k2p_fast": 5e-3, "k3p_exact": 2e-5, "k3p_fast": 2e-2,
    # the hulls model on the card against the CPU, exact (fp32 summation
    # order through 3 layers), and its fast-mode loss against the exact
    # CPU loss (bf16 operands and activation storage)
    "hulls_loss": 1e-4, "hulls_grad": 1e-3, "hulls_fast_loss": 5e-2,
    # the motion model, limits as before (readings on the H100 in PERF.md:
    # loss 6.9e-8, worst gradient 1.6e-6, fast loss 8.0e-3)
    "motion_loss": 1e-4, "motion_grad": 1e-3, "motion_fast_loss": 5e-2,
    # K2/K3 at Cl(2,0) against their plain versions over the NBA launch
    # shapes, set from the readings of the first runs on the H100
    # (PERF.md): exact 2.4e-7 (forward) and 5.8e-6 (backward, fp32
    # summation order); fast 1.1e-3 and 7.1e-3 (bf16 rounding points, as
    # K2/K3 at Cl(3)); no looser than K2/K3's limits
    "k2_cl2_exact": 2e-6, "k2_cl2_fast": 1e-2,
    "k3_cl2_exact": 5e-5, "k3_cl2_fast": 2e-2,
    # the NBA and MD17 models on the card against the CPU, as hulls
    "nba_loss": 1e-4, "nba_grad": 1e-3, "nba_fast_loss": 5e-2,
    "md17_loss": 1e-4, "md17_grad": 1e-3, "md17_fast_loss": 5e-2,
    # P2 and P3 (the envelope probe) against their plain versions at the
    # probe's sizes, relative to max |plain|: the products are exact in
    # fp32 after the same operand rounding, so only the order of the fp32
    # sum over K * reps = 8,192 terms differs; P3 rounds once a step
    # (fused), the plain version twice.  P1 is held bitwise.  Readings of
    # the first run on the H100 (PERF.md): bf16 1.3e-5, tf32 3.0e-5, fp32
    # 1.0e-5 (the FFMA sum against cuBLAS's order, as large as the tensor
    # cores' against it), P3 4.1e-6
    "p2_bf16": 5e-5, "p2_tf32": 1e-4, "p2_fp32": 3e-5, "p3": 1e-5,
    # K4/K5 at Cl(2) and K4p/K5p against their plain versions, K4's and
    # K5's limits; readings of the first run on the H100 (PERF.md): K4/K5
    # at Cl(2) exact 2.8e-7 / 1.1e-5, fast 4.6e-4 / 1.3e-2; K4p/K5p exact
    # 3.0e-7 / 3.1e-6, fast 5.5e-4 / 7.8e-3.  At the bench shape K4p/K5p
    # are held to the composed route with the same limits (read 2.2e-4 /
    # 1.1e-4)
    "k4_cl2_exact": 1e-5, "k4_cl2_fast": 1e-2,
    "k5_cl2_exact": 1e-4, "k5_cl2_fast": 3e-2,
    "k4p_exact": 1e-5, "k4p_fast": 1e-2, "k5p_exact": 1e-4, "k5p_fast": 3e-2,
    # the bench stack at Cl(2) and Cl(5), the Cl(3) stack's limits (first
    # run: fast vs exact loss 9.6e-6 and 3.4e-5; fused vs composed loss
    # 1.3e-5 and 7.1e-6, worst gradient 4.9e-3 and 2.7e-3)
    "bench_cl2_fast_loss": 1e-3, "bench_cl2_fused_loss": 3e-4,
    "bench_cl2_fused_grad": 3e-2,
    "bench_cl5_fast_loss": 1e-3, "bench_cl5_fused_loss": 3e-4,
    "bench_cl5_fused_grad": 3e-2,
    # the pair form at Cl(4): K2p/K3p and K4p/K5p against their plain
    # versions and the bench stack at --dim 4, the Cl(5) pair kernels' and
    # the Cl(5) stack's limits (the same rounding points, a grade sum over
    # runs of at most 6 blades instead of 10).  Readings of the first run
    # on the H100 (PERF.md): K2p/K3p exact 3.2e-7 / 3.3e-6, fast 1.6e-3 /
    # 7.0e-3; K4p/K5p exact 3.7e-7 / 6.5e-6, fast 6.4e-4 / 1.2e-2, against
    # the composed route at the bench shape 3.8e-4 / 1.6e-4; the stack's
    # fast vs exact loss 7.3e-5, fused vs composed loss 1.1e-5, worst
    # gradient 3.9e-3
    "k2p_cl4_exact": 2e-6, "k2p_cl4_fast": 5e-3,
    "k3p_cl4_exact": 2e-5, "k3p_cl4_fast": 2e-2,
    "k4p_cl4_exact": 1e-5, "k4p_cl4_fast": 1e-2,
    "k5p_cl4_exact": 1e-4, "k5p_cl4_fast": 3e-2,
    "bench_cl4_fast_loss": 1e-3, "bench_cl4_fused_loss": 3e-4,
    "bench_cl4_fused_grad": 3e-2,
    # the fast K5p's 20 parameter gradients against the composed route
    # (K2p/K3p row tiles, the message rounded, a masked sum) at the
    # instance shapes: both round at the same points, only the order of
    # fp32 sums differs (the partial vectors), K5's exact limit (readings
    # in PERF.md).  The sum, d(h) and the bf16 outputs dhj and dattr are
    # held at the fast limits, as at the bench shape: a bf16 message or dhj
    # element can round one unit apart where the two kernels' fp32 differ
    # in the last bit, and the route sums d(h) with atomics
    "k5p_route": 1e-4,
}
# the measured envelope of this card (phase_envelope): "bytes" (P1's best
# copy bandwidth, bytes/s), "bf16" (P2's bf16 wgmma rate) and "fp32"
# (P3's FMA rate), FLOP/s; bound() sets each kernel's least time by it
ENVELOPE = {}
# the hulls task (configs/hulls.yaml, HullsModel defaults): Cl(5,0),
# hidden 28, 3 EGCL layers, batch 16; the dataset cut from 16,384 samples
# per split to these (the padding spec comes from the data)
H_B, H_HID, H_TRAIN, H_VAL = 16, 28, 512, 256
# the K4p/K5p checks cut a layout to this many edges: the plain pair form
# holds (E, C, 32, 32) fp32 products, ~1.9 GB each at 28 channels; at
# Cl(4) (E, C, 16, 16), the same bytes at four times the edges
PAIR_MAX_EDGES = 16384
PAIR_MAX_EDGES_CL4 = 65536


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# (Cin, C) of every dense block shape the tasks and the bench run, and the
# fused forms' (Cm, Ca, C), for the shared-memory lines of the dense
# backwards (exact: the row kernels; fast: the row tiles)
SMEM_K3 = {3: [(34, 28), (59, 28), (4, 28), (6, 28), (28, 28), (38, 32),
               (67, 32), (60, 32), (90, 32), (32, 32), (64, 32)],
           2: [(46, 40), (83, 40), (40, 40), (40, 20), (60, 40)]}
CL2_MAX_C = 45    # the widest K5 at Cl(2) (shared memory, PR 6)
# (Cm, Ca, C) at Cl(2) where the fast K4's sum of a whole window does not
# fit beside its tiles, so that it sums sub-windows (print_k4_widths)
CL2_SUB = (4, 0, 53)
# (dim, Cin, C) of K3p's shapes on the main paths: the hulls blocks (Cl(5))
# and the bench's --dim 4 node blocks (Cl(4))
PAIR_SMEM_SHAPES = [(5, 34, 28), (5, 28, 28), (5, 59, 28), (5, 2, 28),
                    (5, 3, 28), (4, 56, 28), (4, 28, 28)]
SMEM_K5 = {3: [(32, 0, 32), (28, 3, 28)],
           2: [(40, 0, 40), (28, 3, 28), (CL2_MAX_C, 0, CL2_MAX_C)]}


def widest(fits, hi=4096):
    """The widest width w <= hi with fits(w), where fits holds up to a
    cap and fails above it (0: none)."""
    lo = 0
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return lo


def print_dense_smem():
    """Shared-memory bytes of K3 and K5 in both modes at every shape they
    run on the main path (0 would raise), and where the two modes' widest
    inputs differ; raises where the fast mode's is the narrower."""
    import ctypes
    from csmpn_torch.ops import _build
    from csmpn_torch.ops import cemlp_kernel as ck
    from csmpn_torch.ops import fused_egcl as fe

    ck_max = fe.MAX_SMEM

    for dim, kb, kf in ((3, ck.DENSE, fe.DENSE), (2, ck.DENSE_CL2,
                                                  fe.DENSE_CL2)):
        k3 = [f"{cin}->{c} {ck._smem(kb, cin, c, True, True)}/"
              f"{ck._smem(kb, cin, c, True, False)}"
              for cin, c in SMEM_K3[dim]]
        print(f"  K3 at Cl({dim}) smem bytes exact/fast: {', '.join(k3)}")
        row = fe._lib_fn(kf, "smem_bytes", [ctypes.c_int] * 5,
                         ctypes.c_size_t)
        tile = fe._lib_fn(kf, "tile_smem_bytes", [ctypes.c_int] * 4,
                          ctypes.c_size_t)
        k5 = [f"{cm}+{ca}->{c} {row(cm, ca, c, kf.wn, 1)}/"
              f"{tile(cm, ca, c, kf.wn)}" for cm, ca, c in SMEM_K5[dim]]
        print(f"  K5 at Cl({dim}) smem bytes exact/fast: {', '.join(k5)}")
        # the widest input each backward takes at each C, from the same
        # entry points (0: none): the row kernels' (exact) and the row
        # tiles' (fast); listed where they differ
        k3row = getattr(_build.load(kb.source), f"{kb.symbol}_smem_bytes")
        k3tile = getattr(_build.load(kb.source),
                         f"{kb.symbol}_tile_smem_bytes")
        k3row.argtypes, k3row.restype = [ctypes.c_int] * 3, ctypes.c_size_t
        k3tile.argtypes, k3tile.restype = [ctypes.c_int] * 2, ctypes.c_size_t
        diff3, diff5, narrower = [], [], []
        for c in range(1, kb.max_channels + 1):
            caps = (widest(lambda w: 0 < k3row(w, c, 1) <= ck_max),
                    widest(lambda w: 0 < k3tile(w, c) <= ck_max))
            if caps[0] != caps[1]:
                diff3.append(f"C={c} {caps[0]}/{caps[1]}")
            if caps[1] < caps[0]:
                narrower.append(f"K3 C={c}")
            caps = (widest(lambda w: 0 < row(w, 0, c, kf.wn, 1) <= ck_max),
                    widest(lambda w: 0 < tile(w, 0, c, kf.wn) <= ck_max))
            if caps[0] != caps[1]:
                diff5.append(f"C={c} {caps[0]}/{caps[1]}")
            if caps[1] < caps[0]:
                narrower.append(f"K5 C={c}")
        print(f"  K3 at Cl({dim}) widest Cin exact/fast where they differ: "
              f"{', '.join(diff3) or 'none'}")
        print(f"  K5 at Cl({dim}) widest Cm (Ca 0) exact/fast where they "
              f"differ: {', '.join(diff5) or 'none'}")
        if narrower:
            raise AssertionError(f"Cl({dim}): the fast-mode backward takes "
                                 f"narrower inputs than the exact one at "
                                 f"{', '.join(narrower)}")
        print(f"  Cl({dim}): at every C the fast-mode K3 and K5 take every "
              f"input width their exact modes take")


def k2_plan(kb, cin, c):
    """(bytes, chunks of the x tile, input channels a chunk) of the
    fast-mode K2 at cin -> c; bytes 0 where it does not take the widths."""
    import ctypes
    from csmpn_torch.ops import _build

    fn = getattr(_build.load(kb.source), f"{kb.symbol}_fwd_tile_plan")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_size_t
    info = (ctypes.c_int * 3)()   # chunks, their width, the image's bytes
    return (int(fn(cin, c, info)),) + tuple(info)[:2]


def k2_caps(kb):
    """{C: (widest Cin of the exact-mode row kernel, of the fast-mode row
    tiles)} for the dense K2 kb at every C <= kb.max_channels, from their
    shared-memory entry points (0: none)."""
    import ctypes
    from csmpn_torch.ops import _build
    from csmpn_torch.ops import fused_egcl as fe

    lib = _build.load(kb.source)
    row = getattr(lib, f"{kb.symbol}_smem_bytes")
    tile = getattr(lib, f"{kb.symbol}_fwd_tile_smem_bytes")
    row.argtypes, row.restype = [ctypes.c_int] * 3, ctypes.c_size_t
    tile.argtypes, tile.restype = [ctypes.c_int] * 2, ctypes.c_size_t
    return {c: (widest(lambda w: 0 < row(w, c, 0) <= fe.MAX_SMEM),
                widest(lambda w: 0 < tile(w, c) <= fe.MAX_SMEM))
            for c in range(1, kb.max_channels + 1)}


def print_k2_widths():
    """K2's shared-memory bytes in both modes at every dense block shape
    of the main paths and both modes' widest inputs at every C; raises
    where the fast mode takes the narrower inputs."""
    from csmpn_torch.ops import cemlp_kernel as ck

    for dim, kb in ((3, ck.DENSE), (2, ck.DENSE_CL2)):
        k2 = [f"{cin}->{c} {ck._smem(kb, cin, c, False, True)}/"
              f"{ck._smem(kb, cin, c, False, False)}"
              for cin, c in SMEM_K3[dim]]
        print(f"  K2 at Cl({dim}) smem bytes exact/fast: {', '.join(k2)}")
        caps = k2_caps(kb)
        print(f"  K2 at Cl({dim}) widest Cin exact/fast at C = 1.."
              f"{max(caps)}: "
              + ", ".join(f"{c}:{e}/{f}" for c, (e, f) in caps.items()))
        narrower = [c for c, (e, f) in caps.items() if f < e]
        if narrower:
            raise AssertionError(f"K2 at Cl({dim}): the fast-mode forward "
                                 f"takes narrower inputs than the exact one "
                                 f"at C = {narrower}")
        print(f"  Cl({dim}): at every C the fast-mode K2 takes every input "
              f"width its exact mode takes")


def k2_instance_shapes(kb):
    """(Cin, C, chunks, chunk width) at which the fast K2 is held to its
    plain version beyond the main paths' shapes: for each of its two
    instances (x tile whole, in chunks), the narrowest C >= C_MIN at whose
    widest exact-mode input the fast mode takes that instance, at that
    input; then the widest C at its widest exact-mode input; each once.
    Every shape is one the exact mode takes."""
    caps = k2_caps(kb)
    out = []
    for chunked in (False, True):
        for c in sorted(c for c in caps if c >= C_MIN and caps[c][0]):
            _, nch, kch = k2_plan(kb, caps[c][0], c)
            if (nch > 1) == chunked:
                out.append((caps[c][0], c, nch, kch))
                break
    c = max(c for c in caps if caps[c][0])
    last = (caps[c][0], c) + k2_plan(kb, caps[c][0], c)[1:]
    if last not in out:
        out.append(last)
    return out


def pair_caps(kb, backward=True):
    """{C: (widest Cin of the exact-mode row kernel, of the fast-mode row
    tiles)} for the pair kernels kb (K3p, or K2p where not backward), from
    their shared-memory entry points, at every C the row kernel takes at
    some input width."""
    import ctypes
    from csmpn_torch.ops import _build
    from csmpn_torch.ops import fused_egcl as fe

    lib = _build.load(kb.source)
    row = getattr(lib, f"{kb.symbol}_smem_bytes")
    tile = getattr(lib, f"{kb.symbol}_"
                        f"{'tile' if backward else 'fwd_tile'}_smem_bytes")
    row.argtypes, row.restype = [ctypes.c_int] * 3, ctypes.c_size_t
    tile.argtypes, tile.restype = [ctypes.c_int] * 2, ctypes.c_size_t
    caps, c = {}, 1
    while True:
        ex = widest(lambda w: 0 < row(w, c, int(backward)) <= fe.MAX_SMEM)
        if ex == 0:
            return caps
        caps[c] = (ex, widest(lambda w: 0 < tile(w, c) <= fe.MAX_SMEM))
        c += 1


def print_pair_fwd_widths():
    """K2p's shared-memory bytes in both modes at the hulls edge block 0
    and the --dim 4 node block 0, and both modes' widest inputs at every
    C; raises where the fast mode's (the row tile forward's) is the
    narrower."""
    from csmpn_torch.ops import cemlp_kernel as ck

    for dim, kb, (cin, c) in ((5, ck.PAIR, (34, 28)),
                              (4, ck.PAIR_CL4, (56, 28))):
        print(f"  K2p at Cl({dim}) smem bytes exact/fast at {cin}->{c}: "
              f"{ck._smem(kb, cin, c, False, True)}/"
              f"{ck._smem(kb, cin, c, False, False)}")
        caps = pair_caps(kb, backward=False)
        print(f"  K2p at Cl({dim}) widest Cin exact/fast at C = 1.."
              f"{max(caps)}: "
              + ", ".join(f"{c}:{e}/{f}" for c, (e, f) in caps.items()))
        narrower = [c for c, (e, f) in caps.items() if f < e]
        if narrower:
            raise AssertionError(f"K2p at Cl({dim}): the fast-mode forward "
                                 f"takes narrower inputs than the exact one "
                                 f"at C = {narrower}")
        print(f"  Cl({dim}): at every C the fast-mode K2p takes every input "
              f"width its exact mode takes")


def k4_caps(kf):
    """{C: (widest Cm at Ca = 0 that the K4 wrapper takes in exact mode,
    which asks the row kernels of both directions to fit (make_plan), and
    of the fast-mode row tile forward)} for the dense fused kernels kf, at
    every C <= kf.max_channels that the exact mode takes at some Cm."""
    import ctypes
    from csmpn_torch.ops import fused_egcl as fe

    row = fe._lib_fn(kf, "smem_bytes", [ctypes.c_int] * 5, ctypes.c_size_t)
    tile = fe._lib_fn(kf, "fwd_tile_smem_bytes", [ctypes.c_int] * 4,
                      ctypes.c_size_t)
    caps = {}
    for c in range(1, kf.max_channels + 1):
        ex = widest(lambda w: 0 < max(row(w, 0, c, kf.wn, 0),
                                      row(w, 0, c, kf.wn, 1)) <= fe.MAX_SMEM)
        if ex:
            caps[c] = (ex, widest(lambda w: 0 < tile(w, 0, c, kf.wn)
                                  <= fe.MAX_SMEM))
    return caps


def print_k4_widths():
    """K4's shared-memory bytes in both modes at the bench shapes, both
    modes' widest message widths at every C and where the fast forward
    sums fewer targets than a window at a time; raises where the fast
    mode's widest is the narrower, or where the sub-window layout of
    cl2_layouts does not take the sub-window path."""
    import ctypes
    from csmpn_torch.ops import fused_egcl as fe

    for dim, kf in ((3, fe.DENSE), (2, fe.DENSE_CL2)):
        row = fe._lib_fn(kf, "smem_bytes", [ctypes.c_int] * 5,
                         ctypes.c_size_t)
        tile = fe._lib_fn(kf, "fwd_tile_smem_bytes", [ctypes.c_int] * 4,
                          ctypes.c_size_t)
        wsub = fe._lib_fn(kf, "fwd_tile_wsub", [ctypes.c_int] * 4,
                          ctypes.c_int)
        k4 = [f"{cm}+{ca}->{c} {row(cm, ca, c, kf.wn, 0)}/"
              f"{tile(cm, ca, c, kf.wn)}" for cm, ca, c in SMEM_K5[dim]]
        print(f"  K4 at Cl({dim}) smem bytes exact/fast: {', '.join(k4)}")
        caps = k4_caps(kf)
        diff = [f"C={c} {e}/{f}" for c, (e, f) in caps.items() if e != f]
        print(f"  K4 at Cl({dim}) widest Cm (Ca 0) exact/fast where they "
              f"differ: {', '.join(diff) or 'none'}")
        sub = [c for c, (e, _) in caps.items() if wsub(e, 0, c, kf.wn) <
               kf.wn]
        print(f"  K4 at Cl({dim}) fast: sums of fewer than {kf.wn} targets "
              f"at the widest Cm of C = {sub or 'none'}")
        narrower = [c for c, (e, f) in caps.items() if f < e]
        if narrower:
            raise AssertionError(f"K4 at Cl({dim}): the fast-mode forward "
                                 f"takes narrower inputs than the exact one "
                                 f"at C = {narrower}")
        print(f"  Cl({dim}): at every C the fast-mode K4 takes every message "
              f"width its exact mode takes")
        if dim == 2:
            cm, ca, c = CL2_SUB
            if not 0 < wsub(cm, ca, c, kf.wn) < kf.wn:
                raise AssertionError(f"K4 at Cl(2) {cm}+{ca}->{c}: sums of "
                                     f"{wsub(cm, ca, c, kf.wn)} targets, "
                                     f"not a sub-window")


def pair_fused_caps(kf):
    """{C: [(Cm, widest Ca of the exact mode, of the fast forward, of the
    fast backward), ...]} for the pair-form fused kernels kf (K4p/K5p), at
    every C <= kf.max_channels and every Cm at which the exact mode takes
    Ca = 0; the exact mode's as the wrapper asks it (make_plan: both
    directions' row kernels fit), the fast directions' from their tile
    sweeps' entries; -1 where none."""
    import ctypes
    from csmpn_torch.ops import fused_egcl as fe

    ci, sz = [ctypes.c_int], ctypes.c_size_t
    row = fe._lib_fn(kf, "smem_bytes", ci * 5, sz)
    fwd = fe._lib_fn(kf, "fwd_tile_smem_bytes", ci * 4, sz)
    bwd = fe._lib_fn(kf, "tile_smem_bytes", ci * 4, sz)
    wn = kf.wn

    def exact(cm, ca, c):
        return 0 < max(row(cm, ca, c, wn, 0), row(cm, ca, c, wn, 1)) \
            <= fe.MAX_SMEM

    caps = {}
    for c in range(1, kf.max_channels + 1):
        rows, cm = [], 1
        while exact(cm, 0, c):
            rows.append((cm,) + tuple(
                widest(lambda w: fits(cm, w - 1, c)) - 1 for fits in (
                    exact,
                    lambda m, a, cc: 0 < fwd(m, a, cc, wn) <= fe.MAX_SMEM,
                    lambda m, a, cc: 0 < bwd(m, a, cc, wn) <= fe.MAX_SMEM)))
            cm += 1
        if rows:
            caps[c] = rows
    return caps


def print_pair_fused_widths():
    """Both modes' widest inputs of K4p and K5p at Cl(5) and Cl(4) at
    every (Cm, C) the exact mode takes; raises where a fast direction
    takes a narrower input than the exact mode at some (Cm, C)."""
    from csmpn_torch.ops import fused_egcl as fe

    for dim, kf in ((5, fe.PAIR), (4, fe.PAIR_CL4)):
        caps = pair_fused_caps(kf)
        print(f"  K4p/K5p at Cl({dim}) widest Cm + Ca exact/fast forward/"
              f"fast backward at C = 1..{max(caps)}: "
              + ", ".join(f"{c}:" + "/".join(
                  str(max(r[0] + r[k] for r in rows)) for k in (1, 2, 3))
                  for c, rows in caps.items()))
        narrower = [(c, cm) for c, rows in caps.items()
                    for cm, e, f, b in rows if min(f, b) < e]
        if narrower:
            raise AssertionError(f"K4p/K5p at Cl({dim}): a fast-mode "
                                 f"direction takes narrower inputs than the "
                                 f"exact mode at (C, Cm) = {narrower[:8]}")
        print(f"  Cl({dim}): at every (Cm, C) the fast-mode K4p and K5p take "
              f"every attribute width their exact modes take")


# the narrowest output width at which the fused pair instance checks hold
# the fast K4p/K5p to the plain version: at C = 4 and wide inputs block
# 1's bias gradient, summed over 5,003 rows, can part from it by more than
# the fast limit; where both are read, the composed route (K2p/K3p) parts
# from it as much as the kernel does (PERF.md §7.7; phase_pair_fused_
# instances prints both readings); below it the kernels are held to the
# composed route (TOL["k5p_route"])
FUSED_C_MIN = 8


def pair_fused_instance_shapes(kf, c_min=FUSED_C_MIN):
    """(Cm, Ca, C, sweep 1's tiles a warp, sweep 2's) at which the fast
    K4p/K5p are held to their plain versions: for each instance of the
    backward's sweeps (16, 24, 32 tiles a warp) that a width the exact
    mode takes reaches, the narrowest C >= c_min that reaches it (or
    below, where only that does) at its widest Cm there (Ca 0); then the
    widest input the exact mode takes at the widest C (the largest Cm +
    Ca, then the largest Cm); each shape once."""
    import ctypes
    from csmpn_torch.ops import fused_egcl as fe

    maxt = fe._lib_fn(kf, "tile_maxt", [ctypes.c_int] * 5, ctypes.c_int)
    caps = pair_fused_caps(kf)

    def shape(cm, ca, c):
        return (cm, ca, c, maxt(cm, ca, c, kf.wn, 1),
                maxt(cm, ca, c, kf.wn, 2))

    by_m = {}
    for c, rows in caps.items():
        for cm, _, _, _ in rows:
            for sweep in (1, 2):
                by_m.setdefault((sweep, maxt(cm, 0, c, kf.wn, sweep)),
                                {})[c] = cm
    out = []
    for _, by_c in sorted(by_m.items()):
        c = (min(c for c in by_c if c >= c_min) if max(by_c) >= c_min
             else min(by_c))
        if shape(by_c[c], 0, c) not in out:
            out.append(shape(by_c[c], 0, c))
    widest_c = max(caps)
    cm, ca = max(((cm, e) for cm, e, _, _ in caps[widest_c]),
                 key=lambda r: (r[0] + r[1], r[0]))
    if shape(cm, ca, widest_c) not in out:
        out.append(shape(cm, ca, widest_c))
    return out


def print_pair_smem(shapes):
    """K3p's shared-memory bytes in both modes at the main path's shapes
    ((dim, Cin, C)), and both modes' widest inputs at every C; raises where
    the fast mode's is the narrower."""
    import ctypes
    from csmpn_torch.ops import _build
    from csmpn_torch.ops import cemlp_kernel as ck

    for dim, kb in ((5, ck.PAIR), (4, ck.PAIR_CL4)):
        lib = _build.load(kb.source)
        maxt = getattr(lib, f"{kb.symbol}_tile_maxt")
        maxt.argtypes, maxt.restype = [ctypes.c_int] * 2, ctypes.c_int
        k3 = [f"{cin}->{c} {ck._smem(kb, cin, c, True, True)}/"
              f"{ck._smem(kb, cin, c, True, False)} ({maxt(cin, c)} tiles "
              f"a warp)" for d, cin, c in shapes if d == dim]
        print(f"  K3p at Cl({dim}) smem bytes exact/fast: {', '.join(k3)}")
        caps = pair_caps(kb)
        print(f"  K3p at Cl({dim}) widest Cin exact/fast at C = 1.."
              f"{max(caps)}: "
              + ", ".join(f"{c}:{e}/{f}" for c, (e, f) in caps.items()))
        narrower = [c for c, (e, f) in caps.items() if f < e]
        if narrower:
            raise AssertionError(f"K3p at Cl({dim}): the fast-mode backward "
                                 f"takes narrower inputs than the exact one "
                                 f"at C = {narrower}")
        print(f"  Cl({dim}): at every C the fast-mode K3p takes every input "
              f"width its exact mode takes")


def pair_tile_instance_shapes(kb):
    """One (Cin, C, exact takes it, tiles a warp) for each instance of the
    fast-mode K3p row tiles (weight-gradient tiles a warp: 16, 24, 32) that
    some width the exact mode takes reaches, at the narrowest C >= C_MIN
    that reaches it (or below, where only that does) and the widest input
    there that the exact mode takes; then the widest C at its widest input;
    each shape once."""
    import ctypes
    from csmpn_torch.ops import _build

    lib = _build.load(kb.source)
    maxt = getattr(lib, f"{kb.symbol}_tile_maxt")
    maxt.argtypes, maxt.restype = [ctypes.c_int] * 2, ctypes.c_int
    by_m = {}
    caps = pair_caps(kb)
    for c, (ex, _) in caps.items():
        for cin in range(1, ex + 1):
            by_m.setdefault(maxt(cin, c), {})[c] = (cin, c, True,
                                                    maxt(cin, c))
    out = []
    for m in sorted(by_m):
        by_c = by_m[m]
        c = (min(c for c in by_c if c >= C_MIN) if max(by_c) >= C_MIN
             else min(by_c))
        out.append(by_c[c])
    widest = max(caps)
    last = (caps[widest][0], widest, True, maxt(caps[widest][0], widest))
    if last not in out:
        out.append(last)
    return out


def tile_plan(kb, cin, c):
    """(bytes, weight-gradient tiles a warp, chunks of the x tile, input
    channels a chunk) of the fast-mode K3 at cin -> c; bytes 0 where it
    does not take the widths."""
    import ctypes
    from csmpn_torch.ops import _build

    fn = getattr(_build.load(kb.source), f"{kb.symbol}_tile_plan")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_size_t
    info = (ctypes.c_int * 3)()
    return (int(fn(cin, c, info)),) + tuple(info)


# the narrowest output width the instance checks take where a wider one
# reaches the instance: at C = 1-3 the layer norm spans so few channels
# that its backward cancels, and the fast-mode kernel and plain version,
# which round its cotangents at different points, part by more than the
# fast limits for reasons of the function, not of a kernel (PERF.md, PR 9)
C_MIN = 4


def tile_instance_shapes(kb, kf):
    """One shape for each instance of the fast-mode tile kernels of K3
    (weight-gradient tiles a warp, 16 to 40) and of K5's sweeps 1 and 2
    (16, 24, 32) that some width reaches, at the narrowest C >= C_MIN
    that reaches it (or below, where only that does) and its widest input
    there, one that the exact mode also takes where there is one: K3's as (Cin, C, exact takes it, tiles, chunks,
    chunk width), then K3 at its widest C at the widest input the fast
    mode takes; K5's as (Cm, C, sweep 1's tiles, sweep 2's), each once."""
    import ctypes
    from csmpn_torch.ops import _build
    from csmpn_torch.ops import fused_egcl as fe

    lib = _build.load(kb.source)
    k3row = getattr(lib, f"{kb.symbol}_smem_bytes")
    k3row.argtypes, k3row.restype = [ctypes.c_int] * 3, ctypes.c_size_t
    row5 = fe._lib_fn(kf, "smem_bytes", [ctypes.c_int] * 5, ctypes.c_size_t)
    maxt5 = fe._lib_fn(kf, "tile_maxt", [ctypes.c_int] * 5, ctypes.c_int)
    k3, k5 = {}, {}
    for c in range(1, kb.max_channels + 1):
        for cin in range(1, 1800):
            b, m, nch, kch = tile_plan(kb, cin, c)
            if b == 0:
                break
            ex = 0 < k3row(cin, c, 1) <= fe.MAX_SMEM
            k3.setdefault((m, ex), {})[c] = (cin, c, ex, m, nch, kch)
        for cm in range(1, 600):
            m1 = maxt5(cm, 0, c, kf.wn, 1)
            if m1 == 0:
                break
            if not 0 < row5(cm, 0, c, kf.wn, 1) <= fe.MAX_SMEM:
                continue
            m2 = maxt5(cm, 0, c, kf.wn, 2)
            for sweep, m in ((1, m1), (2, m2)):
                k5.setdefault((sweep, m), {})[c] = (cm, c, m1, m2)
    def narrowest(by_c):
        return by_c[min(c for c in by_c if c >= C_MIN)
                    if max(by_c) >= C_MIN else min(by_c)]

    out3 = []
    for m in sorted({m for m, _ in k3}):
        out3.append(narrowest(k3.get((m, True)) or k3[(m, False)]))
    widest = max(c for by_c in k3.values() for c in by_c)
    out3.append(max((v[widest] for v in k3.values() if widest in v),
                    key=lambda s: s[0]))
    out5 = []
    for _, by_c in sorted(k5.items()):
        if narrowest(by_c) not in out5:
            out5.append(narrowest(by_c))
    return out3, out5


def phase_tile_instances(dev, gen, results):
    """K3 and K5 (dense form, Cl(3) and Cl(2)) against their plain
    versions at the shapes of tile_instance_shapes: K3's dx and 10
    gradients, K5's output, dh, dhj and 20 gradients (over a ragged
    masked layout), two launches bitwise equal, in both modes where the
    exact mode takes the shape, in fast mode where only it does."""
    import numpy as np
    from csmpn_torch.algebra import get_algebra
    from csmpn_torch.ops import cemlp_kernel as ck
    from csmpn_torch.ops import fused_egcl as fe

    print("K2, K3 and K5 vs plain at one shape of each tile kernel "
          "instance")
    rng = np.random.RandomState(5)
    dst = np.sort(rng.randint(0, 1001, size=5003))
    chunked = False
    for dim, kb, kf, keys in ((3, ck.DENSE, fe.DENSE, ("k4", "k5")),
                              (2, ck.DENSE_CL2, fe.DENSE_CL2,
                               ("k4_cl2", "k5_cl2"))):
        alg = get_algebra((1.0,) * dim)
        k3key = "k3" if dim == 3 else "k3_cl2"
        k2key = "k2" if dim == 3 else "k2_cl2"
        k2_chunked = False
        for cin, c, nch, kch in k2_instance_shapes(kb):
            k2_chunked |= nch > 1
            x, params, _ = block_inputs(1001, cin, c, gen, dev,
                                        nb=alg.n_blades)
            for exact in (True, False):
                mode = "exact" if exact else "fast"
                tag = (f"K2 at Cl({dim}) {cin}->{c} (rows 1001; fast: x in "
                       f"{nch} chunk(s) of {kch}) {mode}")
                out = ck.block_forward(x, params, alg, exact)
                again = ck.block_forward(x, params, alg, exact)
                ref = ck.block_forward_plain(x, params, alg, exact)
                field = "max_abs_err" if exact else "max_abs_err_fast"
                results[k2key][field] = max(
                    results[k2key][field],
                    check(tag, out, ref, TOL[f"{k2key}_{mode}"]))
                if not torch.equal(out, again):
                    raise AssertionError(f"{tag}: two launches differ")
                del out, again, ref
            print(f"  K2 at Cl({dim}) {cin}->{c}: x in {nch} chunk(s) of "
                  f"{kch}; two launches bitwise equal (exact and fast)")
            del x, params
        if not k2_chunked:
            raise AssertionError(f"no K2 shape at Cl({dim}) took the chunked "
                                 f"x tile")
        # C = 1-3: read, not held (C_MIN; PERF.md §7.7)
        for c in (1, 2, 3):
            x, params, _ = block_inputs(1001, 6, c, gen, dev,
                                        nb=alg.n_blades)
            err, rel = rel_err(ck.block_forward(x, params, alg, False),
                               ck.block_forward_plain(x, params, alg, False))
            print(f"  K2 at Cl({dim}) 6->{c} fast vs plain (read, not "
                  f"held): max_abs {err:.3e}  rel {rel:.3e}")
        torch.cuda.empty_cache()
        shapes3, shapes5 = tile_instance_shapes(kb, kf)
        for cin, c, ex, m, nch, kch in shapes3:
            chunked |= nch > 1
            rows = 3000
            x, params, dout = block_inputs(rows, cin, c, gen, dev,
                                           nb=alg.n_blades)
            modes = (True, False) if ex else (False,)
            for exact in modes:
                mode = "exact" if exact else "fast"
                tag = (f"K3 at Cl({dim}) {cin}->{c} (rows {rows}; fast: "
                       f"{m} tiles a warp, x in {nch} chunk(s) of {kch}) "
                       f"{mode}")
                dx, grads = ck.block_backward(x, dout, params, alg, exact)
                dx2, grads2 = ck.block_backward(x, dout, params, alg, exact)
                rdx, rgrads = ck.block_backward_plain(x, dout, params, alg,
                                                      exact)
                for pn, g, g2, rg in zip(
                        ["dx"] + [f"d{b}" for b in BLOCK_NAMES],
                        [dx] + grads, [dx2] + grads2, [rdx] + rgrads):
                    err = check(f"{tag} {pn}", g, rg, TOL[f"{k3key}_{mode}"])
                    results[k3key]["max_abs_err" if exact else
                                   "max_abs_err_fast"] = max(
                        results[k3key]["max_abs_err" if exact else
                                       "max_abs_err_fast"], err)
                    if not torch.equal(g, g2):
                        raise AssertionError(f"{tag} {pn}: two launches "
                                             f"differ")
                del dx, grads, dx2, grads2, rdx, rgrads
            print(f"  K3 at Cl({dim}) {cin}->{c}: {m} tiles a warp, x in "
                  f"{nch} chunk(s) of {kch}; two launches bitwise equal "
                  f"({'exact and fast' if ex else 'fast; exact does not take it'})")
            torch.cuda.empty_cache()
        layouts = [(f"K5 at sweeps' tiles a warp {m1}/{m2}, ragged E=5003 "
                    f"N=1001", dst, 1001, cm, 0, c, True)
                   for cm, c, m1, m2 in shapes5]
        errs = check_fused_form(dev, gen, alg, layouts, keys)
        for k in keys:
            results[k]["max_abs_err"] = max(results[k]["max_abs_err"],
                                            errs[k]["exact"])
            results[k]["max_abs_err_fast"] = max(
                results[k]["max_abs_err_fast"], errs[k]["fast"])
    if not chunked:
        raise AssertionError("no K3 shape took the chunked x tile")


def pair_fwd_shapes(kb):
    """(Cin, C) at which the K2p row tile forward (one kernel instance an
    algebra) is held to its plain version: the widest input the exact
    mode takes at C_MIN and at its widest C."""
    caps = pair_caps(kb, backward=False)
    widest_c = max(caps)
    return [(caps[C_MIN][0], C_MIN), (caps[widest_c][0], widest_c)]


def phase_pair_tile_instances(dev, gen, results):
    """K3p at Cl(5) and Cl(4) against its plain version at the shapes of
    pair_tile_instance_shapes (one for each instance of the fast-mode row
    tiles, over 1,001 rows: a last step of fewer rows), dx and the 10
    gradients, two launches bitwise equal, in both modes; then K2p at
    the shapes of pair_fwd_shapes likewise."""
    from csmpn_torch.algebra import get_algebra
    from csmpn_torch.ops import cemlp_kernel as ck

    print("K3p vs plain at one shape of each row tile instance; K2p at its "
          "narrowest and widest C")
    rows = 1001
    for dim, kb, key in ((5, ck.PAIR, "k3p"), (4, ck.PAIR_CL4, "k3p_cl4")):
        alg = get_algebra((1.0,) * dim)
        k2key = key.replace("k3p", "k2p")
        for cin, c in pair_fwd_shapes(kb):
            x, params, _ = block_inputs(rows, cin, c, gen, dev,
                                        nb=alg.n_blades)
            for exact in (True, False):
                mode = "exact" if exact else "fast"
                tag = f"K2p at Cl({dim}) {cin}->{c} (rows {rows}) {mode}"
                out = ck.block_forward(x, params, alg, exact)
                again = ck.block_forward(x, params, alg, exact)
                ref = ck.block_forward_plain(x, params, alg, exact)
                field = "max_abs_err" if exact else "max_abs_err_fast"
                results[k2key][field] = max(
                    results[k2key][field],
                    check(tag, out, ref, TOL[f"{k2key}_{mode}"]))
                if not torch.equal(out, again):
                    raise AssertionError(f"{tag}: two launches differ")
                del out, again, ref
            print(f"  K2p at Cl({dim}) {cin}->{c}: two launches bitwise "
                  f"equal (exact and fast)")
            del x, params
            torch.cuda.empty_cache()
        for cin, c, ex, m in pair_tile_instance_shapes(kb):
            x, params, dout = block_inputs(rows, cin, c, gen, dev,
                                           nb=alg.n_blades)
            for exact in ((True, False) if ex else (False,)):
                mode = "exact" if exact else "fast"
                tag = (f"K3p at Cl({dim}) {cin}->{c} (rows {rows}; fast: {m} "
                       f"tiles a warp) {mode}")
                dx, grads = ck.block_backward(x, dout, params, alg, exact)
                dx2, grads2 = ck.block_backward(x, dout, params, alg, exact)
                rdx, rgrads = ck.block_backward_plain(x, dout, params, alg,
                                                      exact)
                field = "max_abs_err" if exact else "max_abs_err_fast"
                for pn, g, g2, rg in zip(
                        ["dx"] + [f"d{b}" for b in BLOCK_NAMES],
                        [dx] + grads, [dx2] + grads2, [rdx] + rgrads):
                    err = check(f"{tag} {pn}", g, rg, TOL[f"{key}_{mode}"])
                    results[key][field] = max(results[key][field], err)
                    if not torch.equal(g, g2):
                        raise AssertionError(f"{tag} {pn}: two launches "
                                             f"differ")
                del dx, grads, dx2, grads2, rdx, rgrads
            print(f"  K3p at Cl({dim}) {cin}->{c}: {m} tiles a warp; two "
                  f"launches bitwise equal (exact and fast)")
            del x, params, dout
            torch.cuda.empty_cache()


def fused_route(params, alg, h, hj, attr, dst, mask, dagg):
    """The fast edge side on the composed route: the message rows through
    two CEMLP blocks on K2p/K3p (fast mode), rounded to bf16, summed over
    the unmasked edges; returns (the sum, dh, dhj, dattr or None, the 20
    parameter gradients) by autograd with cotangent dagg."""
    from csmpn_torch.ops.cemlp_kernel import _Block

    ps = [p.detach().requires_grad_(True) for p in params]
    ins = [t.detach().float().requires_grad_(True)
           for t in (h, hj) + ((attr,) if attr is not None else ())]
    x = ins[0][dst] - ins[1]
    if attr is not None:
        x = torch.cat([x, ins[2]], dim=1)
    y = _Block.apply(_Block.apply(x, alg, False, *ps[:10]), alg, False,
                     *ps[10:])
    y = y.to(torch.bfloat16).to(torch.float32)
    if mask is not None:
        y = y * mask.to(torch.float32)[:, None, None]
    out = torch.zeros((h.shape[0],) + tuple(y.shape[1:]), device=y.device)
    out = out.index_add(0, dst, y)
    grads = torch.autograd.grad(out, ins + ps, dagg)
    n_in = len(ins)
    return (out.detach(), grads[0], grads[1],
            grads[2] if attr is not None else None, list(grads[n_in:]))


def phase_pair_fused_instances(dev, gen, results):
    """The fast K4p and K5p at Cl(5) and Cl(4) (exact beside them) against
    their plain versions at the shapes of pair_fused_instance_shapes (one
    for each instance of the backward's sweeps, and the widest input),
    over a ragged masked layout (E = 5,003, N = 1,001): outputs, dh, dhj,
    dattr and the 20 gradients, two launches bitwise equal, masked rows of
    dhj/dattr exactly 0.  Then the fast ones against the composed route
    (fused_route) at those shapes and at each instance's shape at C_MIN,
    the narrowest C held to the route only (FUSED_C_MIN)."""
    import numpy as np
    from csmpn_torch.algebra import get_algebra
    from csmpn_torch.ops import fused_egcl as fe
    from csmpn_torch.ops.segment import set_aggregation_mode

    print("K4p/K5p vs plain at one shape of each tile sweep instance and "
          "the widest input; fast vs the composed route there and at C = "
          f"{C_MIN}")
    dst_np = np.sort(np.random.RandomState(5).randint(0, 1001, size=5003))
    for dim, kf, keys in ((5, fe.PAIR, ("k4p", "k5p")),
                          (4, fe.PAIR_CL4, ("k4p_cl4", "k5p_cl4"))):
        alg = get_algebra((1.0,) * dim)
        shapes = pair_fused_instance_shapes(kf)
        layouts = [(f"Cl({dim}) sweeps' tiles a warp {m1}/{m2}, ragged "
                    f"E=5003 N=1001", dst_np, 1001, cm, ca, c, True)
                   for cm, ca, c, m1, m2 in shapes]
        errs = check_fused_form(dev, gen, alg, layouts, keys)
        for k in keys:
            results[k]["max_abs_err"] = max(results[k]["max_abs_err"],
                                            errs[k]["exact"])
            results[k]["max_abs_err_fast"] = max(
                results[k]["max_abs_err_fast"], errs[k]["fast"])
        narrow = [s for s in pair_fused_instance_shapes(kf, C_MIN)
                  if s not in shapes]
        dst = torch.from_numpy(dst_np.astype("int64")).to(dev)
        mask = (torch.rand(5003, generator=gen) > 0.2).to(dev)
        worst = [0.0, 0.0]
        for cm, ca, c, m1, m2 in shapes + narrow:
            nb = alg.n_blades
            h = torch.randn(1001, cm, nb, generator=gen).to(dev).bfloat16()
            hj = torch.randn(5003, cm, nb, generator=gen).to(dev).bfloat16()
            attr = (torch.randn(5003, ca, nb, generator=gen).to(dev)
                    .bfloat16() if ca else None)
            params = edge_params(cm + ca, c, gen, dev, nb)
            dagg = torch.randn(1001, c, nb, generator=gen).to(dev)
            tag = (f"Cl({dim}) Cm={cm} Ca={ca} C={c} (tiles a warp "
                   f"{m1}/{m2}) fast vs the composed route")
            set_aggregation_mode("fast")
            try:
                want = fused_route(params, alg, h, hj, attr, dst, mask, dagg)
            finally:
                set_aggregation_mode("exact")
            out = fe.mp_forward(params, alg, h, hj, attr, dst, mask, False)
            worst[0] = max(worst[0], check(f"{LABEL[keys[0]]} {tag}", out,
                                           want[0], TOL["k4p_fast"]))
            got = fe.mp_backward(params, alg, h, hj, attr, dst, mask, dagg,
                                 False)
            for pn, g, w in zip(
                    ["dh", "dhj", "dattr"] + [f"block{i} d{b}" for i in (1, 2)
                                              for b in BLOCK_NAMES],
                    list(got[:3]) + got[3], list(want[1:4]) + want[4]):
                if g is not None:
                    worst[1] = max(worst[1], check(
                        f"{LABEL[keys[1]]} {tag} {pn}", g.float(), w,
                        TOL["k5p_fast" if pn in ("dh", "dhj", "dattr")
                            else "k5p_route"]))
            if (cm, ca, c, m1, m2) in narrow:   # read, not held (FUSED_C_MIN)
                plain = fe.message_aggregate_grad_plain(
                    params, alg, h, hj, attr, dst, mask, dagg, False)
                flat = [(g.float(), w, p) for g, w, p in zip(
                    list(got[:3]) + got[3], list(want[1:4]) + want[4],
                    list(plain[:3]) + plain[3]) if g is not None]
                kp = max(rel_err(g, p)[1] for g, _, p in flat)
                rp = max(rel_err(w, p)[1] for _, w, p in flat)
                print(f"  {tag}: K5p vs plain {kp:.3e}, the composed route "
                      f"vs plain {rp:.3e} (relative, worst tensor)")
                del plain, flat
            del h, hj, attr, params, dagg, out, got, want
        torch.cuda.empty_cache()
        print(f"  Cl({dim}): fast K4p / K5p vs the composed route at "
              f"{len(shapes) + len(narrow)} shapes, worst max abs "
              f"{worst[0]:.3e} / {worst[1]:.3e}")


def kernel_name(ptxas_line: str) -> str:
    """'name<args>' from ptxas's 'Compiling entry function' line: the
    kernel's name (lower-case words ending in '_kernel', a word's digits
    after its letters, as in 'tf32', so that no digit of the mangled
    prefix can join), its algebra (Cl2E ... Cl5E), its bool (Lb0E / Lb1E)
    and int (Li16E) template arguments, in their order."""
    m = re.search(r"([a-z]+(?:_[a-z]+[0-9]*)*_kernel)(I\w*?Ev)?",
                  ptxas_line)
    if m is None:
        return ptxas_line.strip()[-40:]
    args = ["".join(a) for a in re.findall(r"(Cl\d)E|Lb([01])E|Li(\d+)E",
                                           m.group(2) or "")]
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def time_ms(fn, iters=50, warmup=3) -> float:
    """Device ms per call: a sleep kernel holds the stream while the host
    enqueues every call, so host issue time does not show."""
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


def rel_err(a: torch.Tensor, b: torch.Tensor):
    a, b = a.float(), b.float()
    err = (a - b).abs().max().item()
    return err, err / max(b.abs().max().item(), 1e-30)


def check(name: str, got, ref, tol: float):
    err, rel = rel_err(got, ref)
    ok = rel <= tol and torch.isfinite(got.float()).all().item()
    print(f"  {name:<44s} max_abs {err:.3e}  rel {rel:.3e}  tol {tol:.0e}"
          f"  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: rel err {rel:.3e} > {tol:.0e}")
    return err


def bound(bytes_moved: float, flops: float, peak: float):
    """(least ms at the data sheet's rates, "bytes" or "operations",
    least ms at the envelope measured in this run by phase_envelope:
    P1's copy bandwidth, P2's bf16 rate for bf16 work, P3's FMA rate for
    fp32 work)."""
    t_b, t_f = bytes_moved / MEM_BW, flops / peak
    rate = ENVELOPE["bf16"] if peak == BF16_PEAK else ENVELOPE["fp32"]
    env = max(bytes_moved / ENVELOPE["bytes"], flops / rate) * 1e3
    return (max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations"),
            env)


# ------------------------------------------------- P1-P3: the envelope probe

def sass_opcodes(lib: str) -> dict:
    """{kernel name: Counter of SASS opcodes (without modifiers)} of the
    kernels in the shared library ``lib``, read by cuobjdump -sass."""
    from csmpn_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(kernel_name(m.group(1)),
                                   collections.Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_]*)", line)
        if m and cur is not None:
            cur[m.group(1)] += 1
    return funcs


def check_envelope_sass():
    """P2's tensor-core kernels run on wgmma (HGMMA) and hold no mma.sync
    (HMMA); no kernel of envelope.cu holds HMMA; P1's kernel holds the
    bulk copy (UBLKCP)."""
    from csmpn_torch.ops import _build

    funcs = sass_opcodes(_build._lib_path("envelope"))
    wg = {k: c for k, c in funcs.items() if "resident_wgmma" in k}
    probe = ("resident_wgmma_bf16_kernel<4>", "resident_wgmma_tf32_kernel<4>")
    if not all(k in wg for k in probe):
        raise AssertionError(f"P2's wgmma kernels {probe} not found in "
                             f"libenvelope: {sorted(funcs)}")
    for name, ops in sorted(funcs.items()):
        if ops["HMMA"]:
            raise AssertionError(f"{name}: {ops['HMMA']} HMMA (mma.sync)")
        if name in wg and not ops["HGMMA"]:
            raise AssertionError(f"{name}: no HGMMA; opcodes "
                                 f"{sorted(ops)}")
    tma = [c for k, c in funcs.items() if k.startswith("copy_scale")]
    if len(tma) != 1 or not tma[0]["UBLKCP"]:
        uops = sorted(o for c in tma for o in c if o[0] == "U")
        raise AssertionError(f"P1 kernel: no UBLKCP; its U opcodes {uops}")
    for name in probe:   # K = 256, the probe's instances
        print(f"  SASS {name}: HGMMA x {wg[name]['HGMMA']}, HMMA x 0, "
              f"{sum(wg[name].values())} instructions")
    print(f"  SASS copy_scale_kernel: UBLKCP x {tma[0]['UBLKCP']}; "
          f"{len(wg)} P2 wgmma kernels hold HGMMA, none of "
          f"{len(funcs)} kernels HMMA")


def phase_envelope(dev, results):
    """P1-P3 against their plain versions at the envelope probe's default
    sizes (P1 bitwise at every tile height and at a ragged R), two
    launches bitwise equal, the SASS of the built kernels; then the probe
    through its entry point with every count set to 0 just before and read
    just after, the plain versions' times, the bounds, and the measured
    envelope, which sets ENVELOPE.  Returns the launches."""
    from csmpn_torch.ops import probe_kernels as pk
    from csmpn_torch.tools import envelope_probe as ep

    print("P1-P3 (envelope probe) vs plain at tools/mxu_probe.py's sizes")
    check_envelope_sass()
    reps = 32
    x, a, b, v = (t.to(dev) for t in ep.inputs())
    gen = torch.Generator().manual_seed(0)
    ragged = torch.randn(131109, ep.COLS, generator=gen).to(dev)
    for xx in (x, ragged):
        ref = pk.copy_scale_plain(xx)
        for tile in ep.TILES:
            out, again = pk.copy_scale(xx, tile), pk.copy_scale(xx, tile)
            if not (torch.equal(out, ref) and torch.equal(out, again)):
                raise AssertionError(
                    f"P1 tile {tile} R {xx.shape[0]}: not x * 2 bit for "
                    f"bit, or two launches differ")
        print(f"  P1 copy ({xx.shape[0]} x 256 fp32), tiles {ep.TILES}: "
              f"bitwise equal to x * 2, two launches bitwise equal")
    # P1's claim counters: launches on two streams at once, and a captured
    # launch replayed beside eager ones, each pair of its own
    ref = pk.copy_scale_plain(x)
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = pk.copy_scale(x, 64)
    torch.cuda.synchronize(dev)
    outs = []
    for i in range(8):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(pk.copy_scale(x, 64))
    for _ in range(3):
        with torch.cuda.stream(streams[0]):
            graph.replay()
        with torch.cuda.stream(streams[1]):
            outs.append(pk.copy_scale(x, 64))
    torch.cuda.synchronize(dev)
    if not all(torch.equal(o, ref) for o in outs + [captured]):
        raise AssertionError("P1 on two streams, or replayed beside an "
                             "eager launch: not x * 2 bit for bit")
    print("  P1 on two streams at once and replayed from a graph beside "
          "eager launches: bitwise equal to x * 2")
    del ragged, ref, outs, captured, graph
    errs = {}
    for mode in pk.MODES:
        out = pk.resident_matmul(a, b, reps, mode)
        again = pk.resident_matmul(a, b, reps, mode)
        ref = pk.resident_matmul_plain(a, b, reps, mode)
        errs[mode] = check(f"P2 resident matmul {mode} (512x256x2048, "
                           f"{reps} reps)", out, ref, TOL[f"p2_{mode}"])
        if not torch.equal(out, again):
            raise AssertionError(f"P2 {mode}: two launches differ")
    out, again = pk.fma_chain(v), pk.fma_chain(v)
    errs["p3"] = check("P3 fma chain x256 (4096x512)", out,
                       pk.fma_chain_plain(v), TOL["p3"])
    if not torch.equal(out, again):
        raise AssertionError("P3: two launches differ")
    print("  P2, P3: two launches bitwise equal")
    del out, again, ref

    counters = {"p1": pk.COPY_LAUNCHES, "p3": pk.FMA_LAUNCHES,
                **{f"p2_{m}": pk.RESIDENT_LAUNCHES[m] for m in pk.MODES}}
    print("envelope probe via csmpn_torch.tools.envelope_probe.main")
    for c in counters.values():
        c.reset()
    res = ep.main(["--device=cuda"])
    torch.cuda.synchronize()
    launches = {k: c.count for k, c in counters.items()}
    print(f"  launches during the run: {launches}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} never launched by the probe")
    env = res["envelope"]
    ENVELOPE.update(bytes=env["copy"], bf16=env["bf16"], fp32=env["fma"])

    work = res["work"]
    plain_copy = time_ms(lambda: pk.copy_scale_plain(x), iters=20)
    plain_p2 = {m: time_ms(lambda: pk.resident_matmul_plain(a, b, reps, m),
                           iters=3, warmup=1) for m in pk.MODES}
    plain_p3 = time_ms(lambda: pk.fma_chain_plain(v), iters=3, warmup=1)
    tile = max(res["copy"]["gbps"], key=res["copy"]["gbps"].get)
    copy_ms = res["copy"]["ms"][tile]
    p1_b, p1_by = ep.bound_ms(work["copy"]["bytes"], work["copy"]["flops"],
                              FP32_PEAK)
    p2_b = {m: ep.bound_ms(work["resident"]["bytes"],
                           work["resident"]["flops"], ep.DATA_SHEET[m],
                           elementwise=work["resident"]["elementwise"])
            for m in pk.MODES}
    p3_b, p3_by = ep.bound_ms(work["fma"]["bytes"], work["fma"]["flops"],
                              FP32_PEAK)
    print(f"  P1 copy tile {tile}: kernel {copy_ms * 1e3:.1f} us  plain "
          f"(x * 2) {plain_copy * 1e3:.1f} us  copy_ "
          f"{res['copy']['library_ms']['copy_'] * 1e3:.1f} us  bound "
          f"{p1_b * 1e3:.1f} us ({p1_by})")
    for m in pk.MODES:
        print(f"  P2 {m}: kernel {res['resident']['ms'][m] * 1e3:.1f} us  "
              f"plain {plain_p2[m] * 1e3:.1f} us  torch.matmul x{reps} "
              f"{res['resident']['library_ms'][m] * 1e3:.1f} us  bound "
              f"{p2_b[m][0] * 1e3:.1f} us ({p2_b[m][1]})")
    print(f"  P3: kernel {res['fma']['ms'] * 1e3:.1f} us  plain "
          f"{plain_p3 * 1e3:.1f} us  bound {p3_b * 1e3:.1f} us ({p3_by})")
    print(f"  measured envelope vs the data sheet: copy "
          f"{env['copy'] / 1e9:.1f} GB/s of {MEM_BW / 1e9:.0f}; bf16 "
          f"wgmma "
          f"{env['bf16'] / 1e12:.2f} TF/s of {BF16_PEAK / 1e12:.0f}; tf32 "
          f"{env['tf32'] / 1e12:.2f} of {ep.DATA_SHEET['tf32'] / 1e12:.0f}; "
          f"fp32 FFMA GEMM {env['fp32'] / 1e12:.2f} and FMA chain "
          f"{env['fma'] / 1e12:.2f} of {FP32_PEAK / 1e12:.0f}")
    src, line = "csmpn_torch/csrc/envelope.cu", "tools/mxu_probe.py:"
    results["p1"] = dict(
        name="copy_scale", route="cuda", source=src, replaces=line + "87",
        max_abs_err=0.0, ms=copy_ms, plain_ms=plain_copy, bound_ms=p1_b,
        bound_by=p1_by, library_ms=res["copy"]["library_ms"]["x*2"],
        library_copy_ms=res["copy"]["library_ms"]["copy_"],
        ms_by_tile=res["copy"]["ms"], gbps=env["copy"] / 1e9,
        shape=f"R=131072 x 256 fp32, {tile}-row tiles")
    results["p2"] = dict(
        name="resident_matmul", route="cuda", source=src,
        replaces=line + "112",
        max_abs_err=max(errs[m] for m in pk.MODES),
        max_abs_err_by_mode={m: errs[m] for m in pk.MODES},
        ms=res["resident"]["ms"]["bf16"], plain_ms=plain_p2["bf16"],
        bound_ms=p2_b["bf16"][0], bound_by=p2_b["bf16"][1],
        library_ms=res["resident"]["library_ms"]["bf16"],
        ms_by_mode=res["resident"]["ms"], plain_ms_by_mode=plain_p2,
        library_ms_by_mode=res["resident"]["library_ms"],
        bound_ms_by_mode={m: p2_b[m][0] for m in pk.MODES},
        tflops_by_mode=res["resident"]["tflops"],
        launches_by_mode={m: launches[f"p2_{m}"] for m in pk.MODES},
        shape=f"M, K, N = 512, 256, 2048, {reps} reps; "
              + ", ".join(f"{m} ({ep.HOW[m]})" for m in pk.MODES))
    results["p3"] = dict(
        name="fma_chain", route="cuda", source=src, replaces=line + "150",
        max_abs_err=errs["p3"], ms=res["fma"]["ms"], plain_ms=plain_p3,
        bound_ms=p3_b, bound_by=p3_by, library_ms=None,
        tflops=res["fma"]["tflops"], shape="(4096, 512) fp32, 256 steps")
    return {"p1": launches["p1"], "p3": launches["p3"],
            "p2": sum(launches[f"p2_{m}"] for m in pk.MODES)}


# ------------------------------------------------------------------- K1

def k1_ids(e, n, gen, dev):
    """Sorted synthetic ids over n segments with an empty run and a
    sentinel tail, and a mask."""
    ids = torch.sort(torch.randint(0, n, (e,), generator=gen)).values
    ids[: e // 50] = torch.clamp(ids[: e // 50], max=3)   # empty middle run
    ids = torch.sort(ids).values
    ids[-(e // 40):] = n + 7                               # sentinel tail
    mask = torch.rand(e, generator=gen) > 0.1
    return ids.to(dev), mask.to(dev)


def motion_ids(dataroot, dev):
    """Target ids, sorted source ids and edge mask of a real motion batch
    (batch 100), flattened as the model flattens them."""
    from csmpn_torch.data.motion import MotionDataset
    from csmpn_torch.models.common import flatten_graph

    os.environ["DATAROOT"] = dataroot
    with contextlib.redirect_stdout(io.StringIO()):
        ds = MotionDataset(batch_size=B, num_training_samples=200)
    batch = next(iter(ds.train_loader(seed=0))).to(dev)
    ei, mask, (_, src_sorted) = flatten_graph(batch)
    return ei[1].contiguous(), src_sorted.contiguous(), mask.contiguous()


def with_sentinels(ids, n):
    """ids with their last fortieth set past the last segment (sentinels,
    which K1 drops), still ascending."""
    out = ids.clone()
    out[-(ids.numel() // 40):] = n + 7
    return out


def check_k1(dev, gen, tag, id_sets, n, widths):
    """K1 against its plain version on each (name, ids, mask) of id_sets
    over n segments, at each width D: bf16 and fp32 rows, exact and fast,
    the sum and the masked mean (the mask given, or one drawn here), the
    counts exactly, two launches bitwise equal.  Returns the worst error."""
    from csmpn_torch.ops import segment_kernel as sk

    errs = []
    for d in widths:
        for name, ids, mask in id_sets:
            e = ids.numel()
            if mask is None:
                mask = (torch.rand(e, generator=gen) > 0.1).to(dev)
            for dtype in (torch.bfloat16, torch.float32):
                data = torch.randn(e, d, generator=gen).to(dtype).to(dev)
                for exact in (True, False):
                    for m, mean in ((None, False), (mask, True)):
                        out, cnt = sk.sorted_segment_sum(data, ids, n, exact,
                                                         m, mean)
                        out2, cnt2 = sk.sorted_segment_sum(data, ids, n,
                                                           exact, m, mean)
                        ref, rcnt = sk.segment_sum_plain(data, ids, n, exact,
                                                         m, mean)
                        what = (f"{tag} D={d} {name} {str(dtype)[6:]} "
                                f"{'exact' if exact else 'fast'} "
                                f"{'masked mean' if mean else 'sum'}")
                        err, rel = rel_err(out, ref)
                        if not (rel <= TOL["k1"]
                                and torch.isfinite(out).all().item()):
                            raise AssertionError(f"K1 {what}: rel err "
                                                 f"{rel:.3e} > {TOL['k1']:.0e}")
                        if not torch.equal(cnt, rcnt):
                            raise AssertionError(f"K1 {what}: counts differ")
                        if not (torch.equal(out, out2)
                                and torch.equal(cnt, cnt2)):
                            raise AssertionError(f"K1 {what}: two launches "
                                                 f"differ")
                        errs.append(err)
        print(f"  {tag} D={d}: {len(id_sets)} id sets x bf16/fp32 x "
              f"exact/fast x sum/masked mean within {TOL['k1']:.0e} of "
              f"plain, counts exact, bitwise repeatable")
    return max(errs)


def time_k1(tag, data, ids, n, exact=False):
    """K1's wrapper call, its plain version, torch.segment_reduce over the
    same rows (the segment lengths computed beforehand, outside the timing)
    and the bounds of one sum of data over ids.  Returns the fields of the
    kernels-line entry, prefixed by tag where tag is not empty."""
    from csmpn_torch.ops import segment_kernel as sk

    e, d = data.shape
    ms = time_ms(lambda: sk.sorted_segment_sum(data, ids, n, exact))
    plain = time_ms(lambda: sk.segment_sum_plain(data, ids, n, exact),
                    iters=10)
    lengths = torch.bincount(ids[ids < n], minlength=n)[:n]
    n_read = int(lengths.sum())
    kept = data[:n_read]
    lib = time_ms(lambda: torch.segment_reduce(kept, "sum", lengths=lengths,
                                               axis=0, unsafe=True))
    b_ms, b_by, b_env = bound(n_read * d * data.element_size() + n * d * 4
                              + e * ids.element_size(), n_read * d, FP32_PEAK)
    shape = f"E={e} N={n} D={d} {str(data.dtype)[6:]}"
    print(f"  K1 time {tag or 'motion'} ({shape}): kernel {ms*1e3:.1f} us  "
          f"plain {plain*1e3:.1f} us  segment_reduce {lib*1e3:.1f} us  "
          f"bound {b_ms*1e3:.1f} us ({b_by}), measured envelope "
          f"{b_env*1e3:.1f} us; kernel / segment_reduce {ms / lib:.3f}")
    pre = f"{tag}_" if tag else ""
    return {f"{pre}ms": ms, f"{pre}plain_ms": plain, f"{pre}library_ms": lib,
            f"{pre}bound_ms": b_ms, f"{pre}bound_by": b_by,
            f"{pre}bound_env_ms": b_env, f"{pre}shape": shape}


def phase_k1(dev, gen, results, real):
    print("K1 sorted segment sum vs plain (motion shapes)")
    dst, src_sorted, emask = real
    # the main path's widths on the real ids (and with a sentinel tail),
    # and on synthetic ids with an empty run and a sentinel tail
    syn, syn_mask = k1_ids(E_TOT, N_TOT, gen, dev)
    errs = [check_k1(dev, gen, "motion", [
        ("targets", dst, emask), ("sorted sources", src_sorted, None),
        ("targets + sentinels", with_sentinels(dst, N_TOT), emask),
        ("synthetic", syn, syn_mask)], N_TOT, (HID * 8, 3 * 8))]
    # timing at the main path's largest launch: the gradient of h (bf16
    # rows) over the real target ids, E edges into N nodes, D = 28 * 8
    d = HID * 8
    data = torch.randn(E_TOT, d, generator=gen).to(torch.bfloat16).to(dev)
    timed = time_k1("", data, dst, N_TOT)
    # the node-attribute gathers' backward: D = 3 types * 8 blades, fp32
    attr = torch.randn(E_TOT, 24, generator=gen).to(dev)
    t24 = time_k1("motion_d24", attr, dst, N_TOT, exact=True)
    print(f"  per training step (12 at D={d} bf16, 2 at D=24): "
          f"{12 * timed['ms'] + 2 * t24['motion_d24_ms']:.3f} ms")
    results["k1"] = dict(
        name="sorted_segment_sum", route="cuda",
        source="csmpn_torch/csrc/segment_sum.cu",
        replaces="csmpn_tpu/ops/pallas_segment.py:33",
        max_abs_err=max(errs), **timed, **t24)


# --------------------------------------------------------------- K2 / K3

def block_inputs(rows, cin, c, gen, dev, nb=8):
    """Random input, parameters and output cotangent of one block at
    nb = 4 (Cl(2): 3 grades, 10 paths), nb = 8 (Cl(3): 4, 20), nb = 16
    (Cl(4): 5, 35) or nb = 32 (Cl(5): 6, 56)."""
    ng, npath = {4: (3, 10), 8: (4, 20), 16: (5, 35), 32: (6, 56)}[nb]
    x = torch.randn(rows, cin, nb, generator=gen)

    def r(*shape, scale=1.0, base=0.0):
        return base + scale * torch.randn(*shape, generator=gen)

    params = [r(c, cin, ng, scale=cin ** -0.5), r(c, 1, scale=0.1),
              r(c, ng, scale=0.2, base=1.0), r(c, ng, scale=0.2),
              r(c, npath, scale=0.5 if nb <= 8 else 0.4),
              r(c, c, ng, scale=c ** -0.5), r(c, ng, scale=0.5),
              r(c, c, ng, scale=c ** -0.5), r(c, 1, scale=0.1),
              r(c, scale=0.1, base=1.0)]
    dout = torch.randn(rows, c, nb, generator=gen)
    return x.to(dev), [p.to(dev) for p in params], dout.to(dev)


def block_flops(rows, cin, c, nb=8):
    """Operations of one block forward: the three channel-mixing linears,
    the Cayley-pair product (two multiplies and an add per (n, j, k)) and
    ~40 elementwise operations per value."""
    per_row = (2 * nb * c * cin + 2 * 2 * nb * c * c + 3 * nb * nb * c
               + 40 * nb * c)
    return rows * per_row


BLOCK_NAMES = ["linear.weight", "linear.bias", "silu.a", "silu.b",
               "gp.weight", "linear_right.weight", "normalization.a",
               "linear_left.weight", "linear_left.bias", "norm.a"]


def block_bound(rows, cin, c, params, backward, nb=8):
    """bound() of one block launch, fast mode: K2 reads x and writes
    the output; K3 also reads d(out) and writes dx and the gradients."""
    pbytes = sum(p.numel() for p in params) * 4
    f2 = block_flops(rows, cin, c, nb)
    if backward:
        return bound(rows * (2 * cin + c) * nb * 4 + 2 * pbytes, 3 * f2,
                     BF16_PEAK)
    return bound(rows * (cin + c) * nb * 4 + pbytes, f2, BF16_PEAK)


def phase_cemlp(dev, gen, results):
    from csmpn_torch.algebra import get_algebra
    from csmpn_torch.ops import cemlp_kernel as ck

    alg = get_algebra((1.0, 1.0, 1.0))
    print("K2 CEMLP block forward / K3 backward vs plain (motion and bench "
          "shapes)")
    e2 = {"exact": [], "fast": []}
    e3 = {"exact": [], "fast": []}
    for name, rows, cin, c in CEMLP_SHAPES + BENCH_SHAPES:
        x, params, dout = block_inputs(rows, cin, c, gen, dev)
        for exact in (True, False):
            mode = "exact" if exact else "fast"
            out = ck.block_forward(x, params, alg, exact)
            again = ck.block_forward(x, params, alg, exact)
            ref = ck.block_forward_plain(x, params, alg, exact)
            e2[mode].append(check(f"K2 {name} {mode}", out, ref,
                                  TOL[f"k2_{mode}"]))
            if not torch.equal(out, again):
                raise AssertionError(f"K2 {name} {mode}: two launches "
                                     f"differ")
            del out, again, ref
            dx, grads = ck.block_backward(x, dout, params, alg, exact)
            rdx, rgrads = ck.block_backward_plain(x, dout, params, alg, exact)
            e3[mode].append(check(f"K3 {name} {mode} dx", dx, rdx,
                                  TOL[f"k3_{mode}"]))
            for pn, g, rg in zip(BLOCK_NAMES, grads, rgrads):
                e3[mode].append(check(f"K3 {name} {mode} d{pn}", g, rg,
                                      TOL[f"k3_{mode}"]))
            del dx, grads, rdx, rgrads
    # timing at the largest launch of the motion path: edge block 0, fast
    name, rows, cin, c = CEMLP_SHAPES[0]
    x, params, dout = block_inputs(rows, cin, c, gen, dev)
    fwd = time_ms(lambda: ck.block_forward(x, params, alg, False))
    fwd_plain = time_ms(lambda: ck.block_forward_plain(x, params, alg,
                                                       False), iters=10)
    bwd = time_ms(lambda: ck.block_backward(x, dout, params, alg, False),
                  iters=20)
    bwd_plain = time_ms(lambda: ck.block_backward_plain(x, dout, params, alg,
                                                        False), iters=5)
    b2, b2by, b2env = block_bound(rows, cin, c, params, False)
    b3, b3by, b3env = block_bound(rows, cin, c, params, True)
    shape = f"{name}: rows={rows} Cin={cin} C={c} fast"
    print(f"  time {shape}: fwd {fwd*1e3:.1f} us (plain {fwd_plain*1e3:.1f},"
          f" bound {b2*1e3:.1f} {b2by}); bwd {bwd*1e3:.1f} us (plain "
          f"{bwd_plain*1e3:.1f}, bound {b3*1e3:.1f} {b3by})")
    # every shape of a training step, fast mode; launches per step from
    # the models' structure (motion: 4 EGCL layers, the 1- and 2-block
    # embedding CEMLPs; bench: 3 EGCL layers, node blocks only, the edge
    # blocks being the composed route's)
    tot = {"motion": [0.0, 0.0], "bench": [0.0, 0.0]}
    times = {}
    for name, rows, cin, c in CEMLP_SHAPES + BENCH_SHAPES:
        x, params, dout = block_inputs(rows, cin, c, gen, dev)
        tf = time_ms(lambda: ck.block_forward(x, params, alg, False))
        tb = time_ms(lambda: ck.block_backward(x, dout, params, alg, False),
                     iters=20)
        times[name] = (tf, tb)
        bf, _, _ = block_bound(rows, cin, c, params, False)
        bb, _, _ = block_bound(rows, cin, c, params, True)
        if name.startswith("bench"):
            path, k = "bench", 3
        else:
            path, k = "motion", 1 if name.startswith("embed") else 4
        if not name.startswith("bench_edge"):
            tot[path][0] += k * tf
            tot[path][1] += k * tb
        print(f"  {name:<17s} rows={rows:<6d} Cin={cin:<3d} C={c}: K2 "
              f"{tf*1e3:7.1f} us (bound {bf*1e3:5.1f})  K3 {tb*1e3:7.1f} us "
              f"(bound {bb*1e3:5.1f})  x{k} per step")
    for path, (tf, tb) in tot.items():
        print(f"  per {path} training step: K2 {tf:.3f} ms, K3 {tb:.3f} ms")
    print("  K2 two launches bitwise equal at every shape (exact and fast)")
    results["k2"] = dict(
        name="cemlp_block_fwd", route="cuda", source="csmpn_torch/csrc/cemlp.cu",
        replaces="csmpn_tpu/ops/cemlp_kernel.py:430",
        max_abs_err=max(e2["exact"]), max_abs_err_fast=max(e2["fast"]),
        ms=fwd, plain_ms=fwd_plain, bound_ms=b2, bound_by=b2by,
        library_ms=None, bound_env_ms=b2env, shape=shape,
        bench_node_ms=[times["bench_node_block0"][0],
                       times["bench_node_block1"][0]])
    results["k3"] = dict(
        name="cemlp_block_bwd", route="cuda", source="csmpn_torch/csrc/cemlp.cu",
        replaces="csmpn_tpu/ops/cemlp_kernel.py:519",
        max_abs_err=max(e3["exact"]), max_abs_err_fast=max(e3["fast"]),
        ms=bwd, plain_ms=bwd_plain, bound_ms=b3, bound_by=b3by,
        library_ms=None, bound_env_ms=b3env, shape=shape,
        bench_node_ms=[times["bench_node_block0"][1],
                       times["bench_node_block1"][1]])


# --------------------------------------------------------------- K4 / K5

def fused_layouts():
    """(name, dst, n_nodes, Cm, Ca, C, masked) of the K4/K5 checks.  The
    last two have more windows of 32 targets than the card has SMs, so a
    CTA walks over several windows."""
    import numpy as np
    from csmpn_torch.bench import synthetic_edges

    rng = np.random.RandomState(11)
    clustered = np.concatenate([rng.randint(0, 20, size=128),
                                rng.randint(400 - 20, 400, size=128)])
    bench_rng = np.random.RandomState(0)     # the bench's 4 graphs' targets
    bench_dst = np.concatenate([synthetic_edges(bench_rng, 2048, 32768)[1]
                                + b * 2048 for b in range(4)])
    return [
        ("bench graph", synthetic_edges(np.random.RandomState(0), 2048,
                                        32768)[1], 2048, 32, 0, 32, False),
        ("bench graph, 20% masked, attrs", synthetic_edges(
            np.random.RandomState(0), 2048, 32768)[1], 2048, 28, 3, 28, True),
        ("clustered ids, empty windows", np.sort(clustered), 400, 32, 0, 32,
         False),
        ("60 edges over 900 nodes", np.sort(rng.randint(0, 900, size=60)),
         900, 28, 3, 28, True),
        ("ragged E=5003 N=1001", np.sort(rng.randint(0, 1001, size=5003)),
         1001, 32, 0, 32, True),
        ("bench ids, 4 graphs, 256 windows", bench_dst, 8192, 32, 0, 32,
         False),
        ("ragged E=60011 N=9001, 282 windows", np.sort(
            rng.randint(0, 9001, size=60011)), 9001, 28, 3, 28, True),
    ]


def edge_params(cin, c, gen, dev, nb=8):
    """Random parameters of a 2-block edge CEMLP (cin -> c -> c)."""
    _, p1, _ = block_inputs(1, cin, c, gen, dev, nb=nb)
    _, p2, _ = block_inputs(1, c, c, gen, dev, nb=nb)
    return p1 + p2


# the kernels' names in the lines chip_smoke prints
LABEL = {"k4": "K4", "k5": "K5", "k4_cl2": "K4 at Cl(2)",
         "k5_cl2": "K5 at Cl(2)", "k4p": "K4p", "k5p": "K5p",
         "k4p_cl4": "K4p at Cl(4)", "k5p_cl4": "K5p at Cl(4)"}


def check_fused_form(dev, gen, alg, layouts, keys):
    """Holds one form of the fused message-passing kernels (K4/K5 at Cl(3)
    or Cl(2), K4p/K5p) to their plain versions over ``layouts`` (name,
    dst, N, Cm, Ca, C, masked), exact and fast: the output, dh, dhj, dattr
    and all 20 gradients, two launches bitwise equal, masked rows of
    dhj/dattr exactly 0.  Returns the worst error per kernel and mode;
    ``keys`` name the forward and backward kernels (their tolerances are
    TOL[f"{key}_{mode}"])."""
    import torch as _t
    from csmpn_torch.ops import fused_egcl as fe

    nb = alg.n_blades
    kf, kb = keys
    errs = {k: {"exact": [], "fast": []} for k in keys}
    for name, dst_np, n, cm, ca, c, masked in layouts:
        e = len(dst_np)
        dst = _t.from_numpy(dst_np.astype("int64")).to(dev)
        mask = ((_t.rand(e, generator=gen) > 0.2).to(dev) if masked
                else None)
        h = _t.randn(n, cm, nb, generator=gen).to(dev)
        hj = _t.randn(e, cm, nb, generator=gen).to(dev)
        attr = _t.randn(e, ca, nb, generator=gen).to(dev) if ca else None
        params = edge_params(cm + ca, c, gen, dev, nb)
        dagg = _t.randn(n, c, nb, generator=gen).to(dev)
        for exact in (True, False):
            mode = "exact" if exact else "fast"
            dt = _t.float32 if exact else _t.bfloat16
            hs, hjs = h.to(dt), hj.to(dt)
            attrs = attr.to(dt) if attr is not None else None
            tag = f"{name} (Cm={cm} Ca={ca} C={c}, E={e} N={n}) {mode}"
            out = fe.mp_forward(params, alg, hs, hjs, attrs, dst, mask, exact)
            ref = fe.message_aggregate_plain(params, alg, hs, hjs, attrs, dst,
                                             mask, False, exact)
            errs[kf][mode].append(check(f"{LABEL[kf]} {tag}", out, ref,
                                        TOL[f"{kf}_{mode}"]))
            again = fe.mp_forward(params, alg, hs, hjs, attrs, dst, mask,
                                  exact)
            if not _t.equal(out, again):
                raise AssertionError(f"{LABEL[kf]} {tag}: two launches "
                                     f"differ")
            del out, ref, again
            got = fe.mp_backward(params, alg, hs, hjs, attrs, dst, mask, dagg,
                                 exact)
            want = fe.message_aggregate_grad_plain(params, alg, hs, hjs,
                                                   attrs, dst, mask, dagg,
                                                   exact)
            again = fe.mp_backward(params, alg, hs, hjs, attrs, dst, mask,
                                   dagg, exact)
            names = (["dh", "dhj", "dattr"]
                     + [f"block{i} d{pn}" for i in (1, 2)
                        for pn in BLOCK_NAMES])
            flat_got = [got[0], got[1], got[2]] + got[3]
            flat_want = [want[0], want[1], want[2]] + want[3]
            flat_again = [again[0], again[1], again[2]] + again[3]
            for pn, g, w, g2 in zip(names, flat_got, flat_want, flat_again):
                if g is None and w is None:
                    continue
                errs[kb][mode].append(check(f"{LABEL[kb]} {tag} {pn}", g, w,
                                            TOL[f"{kb}_{mode}"]))
                if not _t.equal(g, g2):
                    raise AssertionError(f"{LABEL[kb]} {tag} {pn}: two "
                                         f"launches differ")
            if mask is not None:
                off = ~mask
                zero = (got[1][off] == 0).all() and (
                    got[2] is None or (got[2][off] == 0).all())
                if not bool(zero):
                    raise AssertionError(f"{LABEL[kb]} {tag}: masked rows of "
                                         f"dhj or dattr are not 0")
            del got, want, again
        _t.cuda.empty_cache()
        plan = fe.make_plan(dst, mask, n, cm, ca, c, nb)
        print(f"  {name} ({plan.n_win} windows on {plan.grid} CTAs): both "
              f"launches bitwise equal"
              + ("; masked rows of dhj/dattr exactly 0" if masked else ""))
    return {k: {m: max(v) for m, v in e.items()} for k, e in errs.items()}


def fused_entry(key, fn, src, line, errs):
    return dict(name=fn, route="cuda", source=f"csmpn_torch/csrc/{src}",
                replaces=f"csmpn_tpu/ops/fused_egcl.py:{line}",
                max_abs_err=errs[key]["exact"],
                max_abs_err_fast=errs[key]["fast"])


def phase_fused(dev, gen, results):
    from csmpn_torch.algebra import get_algebra

    print("K4 fused message passing forward / K5 backward vs plain")
    errs = check_fused_form(dev, gen, get_algebra((1.0, 1.0, 1.0)),
                            fused_layouts(), ("k4", "k5"))
    results["k4"] = fused_entry("k4", "fused_mp_fwd", "fused_egcl.cu", 102,
                                errs)
    results["k5"] = fused_entry("k5", "fused_mp_bwd", "fused_egcl.cu", 405,
                                errs)


def cl2_layouts():
    """fused_layouts() at the NBA width: C = 40 (Cm 40), and Cm 28 + Ca 3
    -> C 28 where a layout has attributes; then the ragged layout at the
    widest C the kernels take at Cl(2) at Cm = C, 45, and at CL2_SUB,
    where the fast K4 sums sub-windows."""
    out = [(name, dst, n, cm if ca else N_HID, ca, c if ca else N_HID,
            masked) for name, dst, n, cm, ca, c, masked in fused_layouts()]
    name, dst, n, _, _, _, masked = out[4]
    return out + [(f"{name}, the widest C", dst, n, CL2_MAX_C, 0, CL2_MAX_C,
                   masked),
                  (f"{name}, C = {CL2_SUB[2]}: the fast K4 sums "
                   f"sub-windows", dst, n, *CL2_SUB, masked)]


def pair_layouts(max_edges=PAIR_MAX_EDGES):
    """fused_layouts() at the hulls width (C = 28, Cm 28, Ca as given),
    each cut to at most ``max_edges`` edges: the plain pair form builds
    (E, C, nb, nb) products, ~115 KB an edge at Cl(5) and ~29 KB at Cl(4).
    A cut layout keeps its edges into the first targets and its N, so its
    later windows are empty."""
    out = []
    for name, dst, n, _, ca, _, masked in fused_layouts():
        if len(dst) > max_edges:
            n_cut = int(dst[max_edges])
            dst = dst[dst < n_cut]
            name = f"{name}, cut to its {len(dst)} edges into targets < {n_cut}"
        out.append((name, dst, n, H_HID, ca, H_HID, masked))
    return out


def phase_fused_cl2(dev, gen, results):
    from csmpn_torch.algebra import get_algebra

    print("K4/K5 at Cl(2,0) (dense form, 4 blades) vs plain")
    errs = check_fused_form(dev, gen, get_algebra((1.0, 1.0)), cl2_layouts(),
                            ("k4_cl2", "k5_cl2"))
    results["k4_cl2"] = fused_entry("k4_cl2", "fused_mp_cl2_fwd",
                                    "fused_egcl.cu", 102, errs)
    results["k5_cl2"] = fused_entry("k5_cl2", "fused_mp_cl2_bwd",
                                    "fused_egcl.cu", 405, errs)


def phase_fused_pair(dev, gen, results):
    from csmpn_torch.algebra import get_algebra

    print(f"K4p/K5p (pair form, Cl(5,0)) vs plain, layouts cut to at most "
          f"{PAIR_MAX_EDGES} edges")
    errs = check_fused_form(dev, gen, get_algebra((1.0,) * 5),
                            pair_layouts(), ("k4p", "k5p"))
    results["k4p"] = fused_entry("k4p", "fused_mp_pair_fwd",
                                 "fused_egcl_pair.cu", 102, errs)
    results["k5p"] = fused_entry("k5p", "fused_mp_pair_bwd",
                                 "fused_egcl_pair.cu", 405, errs)


def phase_fused_pair_cl4(dev, gen, results):
    from csmpn_torch.algebra import get_algebra

    print(f"K4p/K5p at Cl(4,0) (pair form, 16 blades) vs plain, layouts cut "
          f"to at most {PAIR_MAX_EDGES_CL4} edges")
    errs = check_fused_form(dev, gen, get_algebra((1.0,) * 4),
                            pair_layouts(PAIR_MAX_EDGES_CL4),
                            ("k4p_cl4", "k5p_cl4"))
    results["k4p_cl4"] = fused_entry("k4p_cl4", "fused_mp_pair_cl4_fwd",
                                     "fused_egcl_pair_cl4.cu", 102, errs)
    results["k5p_cl4"] = fused_entry("k5p_cl4", "fused_mp_pair_cl4_bwd",
                                     "fused_egcl_pair_cl4.cu", 405, errs)


def phase_fused_time(dev, results, dim=3, keys=("k4", "k5")):
    """K4 and K5 (Cl(3), Cl(2)) or K4p and K5p (Cl(5), Cl(4)) at the bench
    shape of their algebra (E = 131,072, N = 8,192, bench.WIDTHS's width,
    fast mode), held to their plain versions and to the composed route,
    then timed beside both, with K1 at the source gather's width.  At Cl(5)
    the plain pair form would hold ~15 GB products at this shape (~3.8 GB
    at Cl(4)): K4p/K5p are held to the composed route here (and to the
    plain version on the cut layouts of phase_fused_pair and
    phase_fused_pair_cl4), and the plain times are taken on the bench
    graph's first PAIR_MAX_EDGES (Cl(4): PAIR_MAX_EDGES_CL4) edges."""
    import torch as _t
    from csmpn_torch.algebra import get_algebra
    from csmpn_torch.bench import WIDTHS, workload
    from csmpn_torch.nn.egcl import EGCL
    from csmpn_torch.nn.modules import init_parameters
    from csmpn_torch.ops import fused_egcl as fe
    from csmpn_torch.ops.cemlp_kernel import block_params
    from csmpn_torch.ops.segment import (set_aggregation_mode, take_rows,
                                         take_rows_sorted_idx)

    kf, kb = keys
    alg = get_algebra((1.0,) * dim)
    nb = alg.n_blades
    pair = nb > 8
    set_aggregation_mode("fast")
    h, ei, src_sort = workload(dev, hidden=WIDTHS[dim][0], dim=dim)
    src, dst = ei[0], ei[1]
    n, e, c = h.shape[0], dst.shape[0], h.shape[1]
    h_s = h.to(_t.bfloat16)
    hj = take_rows(h_s, src)
    # the same edge model for both routes; aggr "sum" so the composed
    # route computes K4's function
    layer = EGCL(alg, c, c, c, aggr="sum")
    init_parameters(layer, _t.Generator().manual_seed(1))
    layer = layer.to(dev)
    live = block_params(layer.edge_model, 0) + block_params(
        layer.edge_model, 1)
    params = [p.detach() for p in live]
    dagg = _t.randn(n, c, nb, device=dev)
    plan = fe.make_plan(dst, None, n, c, 0, c, nb)
    # the plain versions' inputs: the whole bench graph, or in the pair
    # form its edges into the first targets
    max_edges = PAIR_MAX_EDGES_CL4 if nb == 16 else PAIR_MAX_EDGES
    cut = int(dst[max_edges]) if pair else n
    pd = dst[dst < cut]
    phj = hj[: pd.shape[0]]

    def composed(hh, hhj):
        h_i = take_rows_sorted_idx(hh, dst)
        msg = layer.message(h_i, hhj)
        return layer.aggregate(msg, dst, n)

    def plain_fwd():
        return fe.message_aggregate_plain(params, alg, h_s, phj, None, pd,
                                          None, False, False)

    def plain_bwd():
        return fe.message_aggregate_grad_plain(params, alg, h_s, phj, None,
                                               pd, None, dagg, False)

    lf, lb = LABEL[kf], LABEL[kb]
    form = {3: "K4/K5", 2: "K4/K5 at Cl(2)", 5: "K4p/K5p",
            4: "K4p/K5p at Cl(4)"}[dim]
    print(f"{form} at the bench shape ({plan.n_win} windows on "
          f"{plan.grid} CTAs) vs their plain versions and the composed "
          f"route, fast")
    with _t.no_grad():
        fused_out = fe.mp_forward(params, alg, h_s, hj, None, dst, None, False,
                                  plan)
        again = fe.mp_forward(params, alg, h_s, hj, None, dst, None, False,
                              plan)
        comp_out = composed(h_s, hj)
        if not pair:
            results[kf]["max_abs_err_fast"] = max(
                results[kf]["max_abs_err_fast"],
                check(f"{lf} vs plain, bench shape", fused_out, plain_fwd(),
                      TOL[f"{kf}_fast"]))
    check(f"{lf} vs the composed route, bench shape", fused_out, comp_out,
          TOL[f"{kf}_fast"])
    if not _t.equal(fused_out, again):
        raise AssertionError(f"{lf} at the bench shape: two launches differ")
    del fused_out, again, comp_out
    got = fe.mp_backward(params, alg, h_s, hj, None, dst, None, dagg, False,
                         plan)
    again = fe.mp_backward(params, alg, h_s, hj, None, dst, None, dagg, False,
                           plan)
    if pair:     # the composed route's gradients, at the whole graph
        hh = h_s.detach().requires_grad_(True)
        hhj = hj.detach().requires_grad_(True)
        want = _t.autograd.grad(composed(hh, hhj), [hh, hhj] + live, dagg)
        want, what = [want[0], want[1]] + list(want[2:]), "the composed route"
    else:
        want = plain_bwd()
        want, what = [want[0], want[1]] + want[3], "plain"
    names = ["dh", "dhj"] + [f"block{i} d{pn}" for i in (1, 2)
                             for pn in BLOCK_NAMES]
    for pn, g, w, g2 in zip(names, [got[0], got[1]] + got[3], want,
                            [again[0], again[1]] + again[3]):
        err = check(f"{lb} vs {what}, bench shape, {pn}", g, w,
                    TOL[f"{kb}_fast"])
        if not pair:
            results[kb]["max_abs_err_fast"] = max(
                results[kb]["max_abs_err_fast"], err)
        if not _t.equal(g, g2):
            raise AssertionError(f"{lb} at the bench shape, {pn}: two "
                                 f"launches differ")
    print("  both launches bitwise equal")
    del got, again, want
    _t.cuda.empty_cache()
    it4, it5, itc = (5, 3, 3) if pair else (20, 10, 10)
    k4 = time_ms(lambda: fe.mp_forward(params, alg, h_s, hj, None, dst, None,
                                       False, plan), iters=it4)
    k4_plain = time_ms(plain_fwd, iters=3, warmup=1)
    with _t.no_grad():
        k4_comp = time_ms(lambda: composed(h_s, hj), iters=itc)
    k5 = time_ms(lambda: fe.mp_backward(params, alg, h_s, hj, None, dst, None,
                                        dagg, False, plan), iters=it5)
    k5_plain = time_ms(plain_bwd, iters=2, warmup=1)
    hh = h_s.detach().requires_grad_(True)
    hhj = hj.detach().requires_grad_(True)
    out = composed(hh, hhj)
    wrt = [hh, hhj] + list(layer.edge_model.parameters())
    k5_comp = time_ms(lambda: _t.autograd.grad(out, wrt, dagg,
                                               retain_graph=True), iters=itc)
    del out
    _t.cuda.empty_cache()
    # K1 on the bench path: the source gather's backward, bf16 rows of
    # D = C * nb over the sorted sources; checked at that width on the
    # bench graph's ids, and timed beside segment_reduce
    d = c * nb
    tag = "bench" if dim == 3 else f"bench_cl{dim}"
    print(f"K1 vs plain at the bench shape (E={e} N={n} D={d})")
    results["k1"]["max_abs_err"] = max(
        results["k1"]["max_abs_err"],
        check_k1(dev, _t.Generator().manual_seed(dim), tag, [
            ("sorted sources", src_sort[1], None),
            ("targets + sentinels", with_sentinels(dst, n), None)],
            n, (d,)))
    rows = _t.randn(e, d, device=dev).to(_t.bfloat16)
    results["k1"].update(time_k1(tag, rows, src_sort[1], n))
    del rows
    pbytes = sum(p.numel() for p in params) * 4
    flops = block_flops(e, c, c, nb) * 2
    in_bytes = n * c * nb * 2 + e * c * nb * 2 + e * 4   # h, hj bf16; ids
    b4, b4by, b4env = bound(in_bytes + pbytes + n * c * nb * 4, flops,
                            BF16_PEAK)
    # K5: also reads d(agg) fp32; writes dh fp32, dhj bf16, the gradients
    b5, b5by, b5env = bound(in_bytes + n * c * nb * 4 + 2 * pbytes
                            + n * c * nb * 4 + e * c * nb * 2, 3 * flops,
                            BF16_PEAK)
    shape = f"E={e} N={n} Cm=C={c} nb={nb} fast" if dim != 3 else \
        f"E={e} N={n} Cm=C={c} fast"
    plain_at = (f" (plain at the first {pd.shape[0]} edges, targets < "
                f"{cut})" if pair else "")
    print(f"{form} time at the bench shape ({shape}){plain_at}:")
    print(f"  {lf} {k4*1e3:.1f} us  plain {k4_plain*1e3:.1f} us  composed "
          f"route {k4_comp*1e3:.1f} us  bound {b4*1e3:.1f} us ({b4by})")
    print(f"  {lb} {k5*1e3:.1f} us  plain {k5_plain*1e3:.1f} us  composed "
          f"route {k5_comp*1e3:.1f} us  bound {b5*1e3:.1f} us ({b5by})")
    extra = ({"plain_shape": f"E={pd.shape[0]} N={n} (edges into targets "
                             f"< {cut})"} if pair else {})
    results[kf].update(ms=k4, plain_ms=k4_plain, bound_ms=b4, bound_by=b4by,
                       library_ms=None, bound_env_ms=b4env,
                       composed_ms=k4_comp, shape=shape, **extra)
    results[kb].update(ms=k5, plain_ms=k5_plain, bound_ms=b5, bound_by=b5by,
                       library_ms=None, bound_env_ms=b5env,
                       composed_ms=k5_comp, shape=shape, **extra)
    set_aggregation_mode("exact")


# ------------------------------------------------- model on card vs CPU

def phase_task_model(dev, ds, make, tag, batch_size):
    """A task's full-width model on the card against the same model on
    the CPU, exact: loss and every gradient (TOL[f"{tag}_loss"],
    TOL[f"{tag}_grad"]); then the card's fast-mode loss against the exact
    CPU loss (TOL[f"{tag}_fast_loss"])."""
    from csmpn_torch.nn.modules import init_parameters
    from csmpn_torch.ops.segment import set_aggregation_mode

    batch = ds.train_dataset.select(list(range(batch_size)))
    cpu = make()
    init_parameters(cpu, torch.Generator().manual_seed(3))
    card = make()
    card.load_state_dict(cpu.state_dict())
    card = card.to(dev)
    set_aggregation_mode("exact")
    lc, _ = cpu(batch.to("cpu"))
    lc.backward()
    lg, _ = card(batch.to(dev))
    lg.backward()
    check(f"{tag} loss", lg.detach().cpu(), lc.detach(), TOL[f"{tag}_loss"])
    errs = sorted(((rel_err(pg.grad.cpu(), pc.grad)[1], k) for
                   (k, pc), (_, pg) in zip(cpu.named_parameters(),
                                           card.named_parameters())),
                  reverse=True)
    worst = errs[0][0]
    print(f"  worst gradient rel err over {len(errs)} tensors: {worst:.3e} "
          f"({errs[0][1]}), median {statistics.median(e for e, _ in errs):.3e}"
          f"  tol {TOL[f'{tag}_grad']:.0e}")
    if worst > TOL[f"{tag}_grad"]:
        raise AssertionError(f"{tag} gradient mismatch {worst:.3e}")
    set_aggregation_mode("fast")
    card.zero_grad()
    lf, _ = card(batch.to(dev))
    check(f"{tag} fast-mode loss vs exact CPU loss", lf.detach().cpu(),
          lc.detach(), TOL[f"{tag}_fast_loss"])
    set_aggregation_mode("exact")


def phase_model(dev, dataroot):
    from csmpn_torch.data.motion import MotionDataset
    from csmpn_torch.models.motion import MotionModel

    print(f"motion model (hidden {HID}, 4 layers, batch 8): card vs CPU, "
          f"exact")
    os.environ["DATAROOT"] = dataroot
    with contextlib.redirect_stdout(io.StringIO()):
        ds = MotionDataset(batch_size=8, num_training_samples=200)
    phase_task_model(dev, ds, lambda: MotionModel(
        spec=ds.spec, num_hidden=HID, num_layers=4), "motion", 8)


# ------------------------------------------------- the layer options (S7)

# card against the CPU (fp32, the composed layers), relative to max |CPU|:
# (output, worst parameter or input gradient).  Exact: fp32 summation
# order through the kernels or the composed layers (TF32 off), the models'
# limits.  Fast: the block kernels round their products' operands to bf16,
# and the EGCL's composed route on the card stores h and the messages in
# bf16 (the gathers, the first linear's einsum, K1's rows), where the CPU
# computes fp32 throughout: bf16-sized (a CPU emulation of the bf16 input
# of a composed CEMLP read 5.9e-3 / 7.7e-3)
LO_TOL = {"exact": (1e-4, 1e-3), "fast": (5e-2, 5e-2)}
# an EGCL's d(h) in fast mode: where a message input is exactly zero (a
# self-loop of the bench's random graph without edge attributes: h_i - h_i)
# MVLayerNorm's gradient is ~1/EPS-sized, and the target and source
# gathers carry it with opposite signs into two gradient sums that the
# card stores in bf16 (h is bf16 there), so they cancel only to bf16
# precision.  A CPU run that stores h in bf16 as the card does read 0.136
# against the fp32 CPU at the bench shape, as the card did (PERF.md §6)
LO_EGCL_DH_FAST = 0.2
LO_KEYS = ("k1", "k2", "k3", "k4", "k5")
LO_CPU = {}     # (case, seed) -> the CPU's output, d(input), g, gradients


def lo_case(name, make, inputs, counters, dev, mode, want, seed,
            dx_tol=None):
    """One layer option: the module ``make()`` builds, its parameters from
    ``seed``, forward and backward of sum(out * g) on the CPU (exact, fp32)
    and then on the card in ``mode`` with every count set to 0 just before
    and read just after; the card against the CPU (LO_TOL) and the counts
    of K2-K5 against ``want`` (kernel -> launches; a kernel not named must
    be 0; K1's count is read, not held).
    ``inputs``: CPU tensors, the first of which takes a gradient; integer
    tensors and None pass as they are.  ``dx_tol``: the limit of that
    gradient where it is not LO_TOL's.  Returns the counts."""
    from csmpn_torch.nn.modules import init_parameters
    from csmpn_torch.ops.segment import set_aggregation_mode

    cpu = make()
    init_parameters(cpu, torch.Generator().manual_seed(seed))
    card = make()
    card.load_state_dict(cpu.state_dict())
    card = card.to(dev)

    def run(m, args, g=None):
        x = args[0].clone().requires_grad_(True)
        out = m(x, *args[1:])
        if g is None:
            g = torch.randn(out.shape, generator=torch.Generator()
                            .manual_seed(seed + 1))
        (out.float() * g.to(out.device)).sum().backward()
        return out.detach().float(), x.grad, g

    set_aggregation_mode("exact")
    key = (name, seed)
    if key not in LO_CPU:       # both modes hold the card to one CPU run
        LO_CPU[key] = run(cpu, inputs) + (
            [p.grad for p in cpu.parameters()],)
    ref, dx_ref, g, cpu_grads = LO_CPU[key]
    on_card = [t.to(dev) if isinstance(t, torch.Tensor) else t
               for t in inputs]
    set_aggregation_mode(mode)
    try:
        torch.cuda.synchronize()
        for c in counters.values():
            c.reset()
        out, dx, _ = run(card, on_card, g)
        torch.cuda.synchronize()
        got = {k: c.count for k, c in counters.items()}
    finally:
        set_aggregation_mode("exact")
    tol_out, tol_grad = LO_TOL[mode]
    check(f"{name} [{mode}] out", out.cpu(), ref, tol_out)
    check(f"{name} [{mode}] d(input)", dx.cpu(), dx_ref, dx_tol or tol_grad)
    errs = [(rel_err(pg.grad.cpu(), gc)[1], k) for gc, (k, pg) in
            zip(cpu_grads, card.named_parameters())]
    worst = max(errs)
    ok = worst[0] <= tol_grad
    print(f"  {name + f' [{mode}] grads':<44s} worst rel {worst[0]:.3e} "
          f"({worst[1]}) of {len(errs)}  tol {tol_grad:.0e}  "
          f"{'ok' if ok else 'FAIL'};  launches {got}")
    if not ok:
        raise AssertionError(f"{name} [{mode}]: gradient rel err "
                             f"{worst[0]:.3e} > {tol_grad:.0e}")
    for k in LO_KEYS[1:]:
        if got[k] != want.get(k, 0):
            raise AssertionError(f"{name} [{mode}]: {k} launched {got[k]} "
                                 f"times, expected {want.get(k, 0)}")
    return got


def egcl_bf16_dh(egcl, h, ei, g):
    """d(h) of sum(out * g) for the EGCL's composed route on the CPU with h
    stored in bf16 before the gathers, as the card stores it in fast mode
    (the card also rounds K1's message rows, this does not)."""
    from csmpn_torch.ops.segment import take_rows, take_rows_sorted_idx

    x = h.clone().requires_grad_(True)
    hs = x.to(torch.bfloat16)
    msg = egcl.message(take_rows_sorted_idx(hs, ei[1]),
                       take_rows(hs, ei[0]), None)
    agg = egcl.aggregate(msg, ei[1], h.shape[0], None).to(h.dtype)
    (egcl.update(x, agg) * g).sum().backward()
    return x.grad


def lo_graph(n, e, c, ca, seed):
    """A flat graph of ``n`` nodes and ``e`` edges sorted by target (the
    bench's generator), h (n, c, 8) and edge attributes (e, ca, 8) or
    None, on the CPU."""
    import numpy as np
    from csmpn_torch.bench import synthetic_edges

    rng = np.random.RandomState(seed)
    ei = synthetic_edges(rng, n, e)
    h = torch.from_numpy(rng.randn(n, c, 8).astype(np.float32))
    attr = (torch.from_numpy(rng.randn(e, ca, 8).astype(np.float32))
            if ca else None)
    return h, torch.from_numpy(ei.astype(np.int64)), attr


def phase_layer_options(dev, counters):
    """The layer options on the card, exact and fast (Cl(3,0)).

    1. CEMLPs at the motion edge block widths (34 -> 28 -> 28, 23,200
       rows): the default (K2 and K3 once a block), normalization_init=None
       and fused=False (the composed layers: no launch), each against the
       CPU; fused=True with normalization_init=None must raise ValueError.
    2. EGCLs on a flat graph of the motion task's size (5,600 nodes, 23,200
       edges, hidden 28, 6 attribute channels): the default (fast: K4/K5
       for the edge side, K2/K3 for the node blocks; exact: K2/K3 for all
       four blocks) and fused_mlp=False (composed: no K2-K5; K1 sums the
       aggregation and the gathers' backward).
    3. The flat EGCL at the bench shape (8,192 nodes, 131,072 edges, hidden
       32) with normalization_init=None: no K2-K5, the CPU's result.
    4. Standalone MVSiLU("norm") and the SGP with each option at Cl(3) and
       Cl(5) (2,048 rows, 28 channels): plain PyTorch on the card against
       the CPU, no kernel.
    Returns {kernel: {case: launches}}."""
    from csmpn_torch.algebra import get_algebra
    from csmpn_torch.nn.egcl import EGCL
    from csmpn_torch.nn.modules import (CEMLP, MVSiLU,
                                        SteerableGeometricProductLayer)

    alg = get_algebra((1.0, 1.0, 1.0))
    gen = torch.Generator().manual_seed(19)
    x = torch.randn(E_TOT, HID + 6, 8, generator=gen)
    print(f"layer options on the card against the CPU (Cl(3,0); CEMLP "
          f"{HID + 6} -> {HID} -> {HID} at {E_TOT} rows; tolerances "
          f"{LO_TOL})")
    blocks = {"k2": 2, "k3": 2}
    out = {k: {} for k in LO_KEYS}

    def record(case, got):
        for k in LO_KEYS:
            out[k][case] = got[k]

    h, ei, ea = lo_graph(N_TOT, E_TOT, HID, 6, 5)
    hb, eib, _ = lo_graph(BN, BE, BH, 0, 6)
    alg5 = get_algebra((1.0,) * 5)
    xs = torch.randn(2048, HID, 8, generator=gen)
    x5 = torch.randn(2048, HID, 32, generator=gen)
    for mode in ("exact", "fast"):
        dh_tol = LO_EGCL_DH_FAST if mode == "fast" else None
        record(f"cemlp default {mode}", lo_case(
            "CEMLP default", lambda: CEMLP(alg, HID + 6, HID, HID), [x],
            counters, dev, mode, blocks, 1))
        record(f"cemlp normalization_init=None {mode}", lo_case(
            "CEMLP normalization_init=None", lambda: CEMLP(
                alg, HID + 6, HID, HID, normalization_init=None), [x],
            counters, dev, mode, {}, 2))
        record(f"cemlp fused=False {mode}", lo_case(
            "CEMLP fused=False", lambda: CEMLP(alg, HID + 6, HID, HID,
                                               fused=False), [x],
            counters, dev, mode, {}, 3))
        bad = CEMLP(alg, HID + 6, HID, HID, normalization_init=None,
                    fused=True).to(dev)
        try:
            bad(x[:64].to(dev))
        except ValueError as err:
            print(f"  CEMLP fused=True normalization_init=None [{mode}]: "
                  f"ValueError ({str(err)[:60]}...), as it must")
        else:
            raise AssertionError("CEMLP(fused=True, normalization_init="
                                 "None) did not raise ValueError")
        # the default EGCL: fast, K4/K5 for the edge side and K2/K3 for
        # the node blocks; exact, the composed edge side on K2/K3 too
        record(f"egcl default {mode}", lo_case(
            "EGCL default, motion-size graph", lambda: EGCL(
                alg, HID, HID, HID, edge_attr_features=6), [h, ei, ea],
            counters, dev, mode, {"k2": 2, "k3": 2, "k4": 1, "k5": 1}
            if mode == "fast" else {"k2": 4, "k3": 4}, 4, dh_tol))
        record(f"egcl fused_mlp=False {mode}", lo_case(
            "EGCL fused_mlp=False, motion-size graph", lambda: EGCL(
                alg, HID, HID, HID, edge_attr_features=6, fused_mlp=False),
            [h, ei, ea], counters, dev, mode, {}, 5, dh_tol))
        bench_none = "EGCL bench shape, normalization_init=None"
        record(f"egcl bench normalization_init=None {mode}", lo_case(
            bench_none, lambda: EGCL(alg, BH, BH, BH,
                                     normalization_init=None), [hb, eib],
            counters, dev, mode, {}, 6, dh_tol))
        if mode == "fast":      # LO_EGCL_DH_FAST's reading, on the CPU
            from csmpn_torch.nn.modules import init_parameters

            m = EGCL(alg, BH, BH, BH, normalization_init=None)
            init_parameters(m, torch.Generator().manual_seed(6))
            ref, dx_ref, g, _ = LO_CPU[(bench_none, 6)]
            _, rel = rel_err(egcl_bf16_dh(m, hb, eib, g), dx_ref)
            print(f"  {bench_none}: d(h) of a CPU run storing h in bf16 as "
                  f"the card does, against the fp32 CPU: rel {rel:.3e}")
        record(f"mvsilu norm {mode}", lo_case(
            "MVSiLU invariant=norm", lambda: MVSiLU(alg, HID,
                                                    invariant="norm"),
            [xs], counters, dev, mode, {}, 7))
        for a, xa in ((alg, xs), (alg5, x5)):
            for first in (True, False):
                for norm in (0.0, None):
                    for impl in ("dense", "pair"):
                        tag = (f"SGP Cl({a.dim}) first={first} "
                               f"norm={norm} {impl}")
                        record(f"{tag} {mode}", lo_case(
                            tag, lambda: SteerableGeometricProductLayer(
                                a, HID, include_first_order=first,
                                normalization_init=norm, impl=impl),
                            [xa], counters, dev, mode, {}, 8))
    return out


# ------------------------------------------------ the sweep runner (S7)

# the sweep's in-process run against phase_task's run of the same config,
# per step, relative: the same launches and Adam, only the order of the
# models' atomic sums (index_select's backward) may differ between two
# runs, which in fast precision flips bf16 roundings (G_TOL's
# ("fast", "capturable") bound and reasons).  The child's printed losses
# (4 decimals) are held to the in-process run's at the same bound plus
# half a unit of the last printed digit
SWEEP_TOL = 1e-2
SWEEP_FILE = "csmpn_torch/configs/motion.yaml"


def sweep_losses(text):
    return [float(line.rsplit(":", 1)[1]) for line in text.splitlines()
            if "(Training) Loss:" in line]


def phase_sweep(dataroot, counters, direct):
    """The motion task started from its sweep file, as a user starts it:
    ``build_commands`` of csmpn_torch/configs/motion.yaml with
    chip_smoke's overrides (TASK_OVERRIDES: 8 steps, --device=cuda) after
    the file's grid.  The one command run in-process through fire (every
    count set to 0 just before, read just after: K1-K3 must run; its
    per-step losses against the fit of ``direct``, phase_task's trainer,
    SWEEP_TOL),
    then through ``python -m csmpn_torch.engineer.sweep`` (``main`` ->
    ``sweep_local``, which runs the command in a shell) as a child process
    with the same DATAROOT: its printed losses against the in-process
    run's.  Returns (the in-process run's launches, None)."""
    import importlib
    import shlex

    import yaml
    from csmpn_torch.engineer.sweep import build_commands

    with open(os.path.join(ROOT, SWEEP_FILE)) as f:
        cfg = yaml.safe_load(f)
    cmds = build_commands(cfg, TASK_OVERRIDES)
    if len(cmds) != 1:
        raise AssertionError(f"{SWEEP_FILE} expands to {len(cmds)} commands")
    print(f"sweep: {SWEEP_FILE} + {TASK_OVERRIDES} -> {cmds[0]}")
    words = shlex.split(cmds[0])
    module = words[words.index("-m") + 1]
    argv = [module.replace(".", "/") + ".py",
            *words[words.index("-m") + 2:]]
    main = importlib.import_module(module).main
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    tr, text = fire_quiet(main, argv, dataroot)
    dt = time.perf_counter() - t0
    launches = {k: c.count for k, c in counters.items()}
    # the direct run's fit is its trainer's first 8 losses (phase_graph
    # times more steps on that trainer afterwards)
    got, want = tr.step_losses, direct.step_losses[:8]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print(f"  in-process (fire): {len(got)} steps in {dt:.1f} s, launches "
          f"{launches}; losses {[round(v, 6) for v in got]}; against the "
          f"direct run: {'bitwise' if got == want else f'max rel {rel:.3e}'}"
          f"  tol {SWEEP_TOL:.0e}")
    if (len(got) != 8 or len(want) != 8 or rel > SWEEP_TOL
            or "Stopping due to max_steps." not in text
            or any(launches[k] <= 0 for k in ("k1", "k2", "k3"))):
        raise AssertionError("the sweep's in-process run failed")
    env = dict(os.environ, DATAROOT=dataroot,
               RUNDIR=os.path.join(dataroot, "runs_sweep"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "csmpn_torch.engineer.sweep", SWEEP_FILE,
         *TASK_OVERRIDES], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    dt = time.perf_counter() - t0
    child = sweep_losses(proc.stdout)
    printed = sweep_losses(text)
    diff = max((abs(a - b) for a, b in zip(child, printed)), default=0.0)
    print(f"  child (sweep_local): rc {proc.returncode} in {dt:.1f} s, "
          f"losses {child}; the in-process run printed {printed}; max "
          f"|diff| {diff:.1e}")
    ok = (proc.returncode == 0 and len(child) == 8
          and f"Running: {cmds[0]}" in proc.stdout
          and "Stopping due to max_steps." in proc.stdout
          and all(abs(a - b) <= SWEEP_TOL * abs(b) + 5e-5
                  for a, b in zip(child, got)))
    if not ok:
        print(proc.stdout[-3000:])
        print(proc.stderr[-3000:])
        raise AssertionError("the sweep's child run failed")
    return launches, None


# ------------------------------------------------------- the task itself

# K2/K3 launches a motion training step: 4 EGCL layers of two edge and two
# node blocks, the 1- and 2-block embedding CEMLPs
MOTION_PER_STEP = {"k2": 19, "k3": 19}


def motion_argv():
    """The motion task at configs/motion.yaml widths, 8 steps."""
    return task_argv("motion", "motion.MotionModel", "motion.MotionDataset", [
        "--model.num_hidden=28", "--model.num_layers=4",
        "--dataset.num_training_samples=200", "--dataset.batch_size=100",
        "--optimizer.lr=5e-4", "--optimizer.weight_decay=1e-4"])


def phase_task(dataroot, counters, runs):
    from csmpn_torch.data.motion import MotionDataset
    from csmpn_torch.tasks.motion import main

    argv = motion_argv()
    print("motion task via fire -> run_task -> Trainer.fit: hidden 28, "
          "4 layers, batch 100, 8 steps, fast precision")
    os.environ["DATAROOT"] = dataroot
    with contextlib.redirect_stdout(io.StringIO()):
        ds = MotionDataset(batch_size=100, num_training_samples=200)
    res = run_entry(main, argv, dataroot, counters, ds)
    check_per_step(res[1], MOTION_PER_STEP, "motion")
    check_k2_profile(res[5], "motion")
    graph = phase_graph("motion", main, argv, dataroot, counters, ds, res)
    runs["motion_k128"] = phase_motion_k128(main, argv, dataroot, counters,
                                            res[1])
    return res, graph


def phase_motion_k128(main, argv, dataroot, counters, eager, steps=256):
    """The motion task in the reference's form of a long run: 128 steps a
    group (one captured step replayed), eval 20 batches a read-back,
    device_data, validation after the first group, and the trainer's
    profile window over the second group.
    The wrappers launch only in the warm-up steps and the capture (K3, a
    training step's alone, 4 x 19 times); the trace's kernel runs over the
    window's 128 replayed steps are the eager step's launches (``eager``)
    128 times.  Returns (the wrappers' launches in the run, the kernels'
    runs a step in the window)."""
    from csmpn_torch.engineer.trainer import WARMUP_STEPS

    prof_dir = os.path.join(dataroot, "prof_motion_k128")
    out = [a for a in argv if not a.startswith((
        "--trainer.max_steps=", "--trainer.val_check_interval=",
        "--trainer.print_interval="))]
    # validation at the first group's end only (interval 256), so the
    # window holds training steps alone
    out += [f"--trainer.max_steps={steps}", "--trainer.val_check_interval=256",
            "--trainer.print_interval=32", "--trainer.steps_per_dispatch=128",
            "--trainer.eval_batches_per_dispatch=20",
            "--trainer.device_data=True", f"--trainer.profile_dir={prof_dir}",
            f"--trainer.profile_steps=[128,{steps}]"]
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    tr, text = fire_quiet(main, out, dataroot)
    dt = time.perf_counter() - t0
    launches = {k: c.count for k, c in counters.items()}
    window = steps - 128
    with open(os.path.join(prof_dir, f"trace_steps_128_{steps}.json")) as f:
        names = collections.Counter(e["name"] for e in json.load(f)[
            "traceEvents"] if e.get("cat") == "kernel")
    per_step = profiled_launches({k: n / window for k, n in names.items()},
                                 counters)
    losses = tr.step_losses
    print(f"motion at steps_per_dispatch=128 eval_batches_per_dispatch=20 "
          f"device_data: {steps} steps in {dt:.1f} s (entry point, set-up "
          f"and capture included), losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, {tr.train_graph.replays} replays, wrapper "
          f"launches {launches}, kernel runs a step in the trace of steps "
          f"128-{steps - 1} {per_step}, median step "
          f"{statistics.median(tr.step_seconds[128:]) * 1e3:.3f} ms "
          f"(second group, under the profiler)")
    ok = (len(losses) == steps and all(math.isfinite(v) for v in losses)
          and tr.train_graph.replays == steps - WARMUP_STEPS
          and launches["k3"] == (WARMUP_STEPS + 1) * eager["k3"]
          and all(abs(per_step[k] - eager[k]) < 1e-9 for k in eager)
          and "Stopping due to max_steps." in text)
    if not ok:
        raise AssertionError("motion at steps_per_dispatch=128 failed")
    return launches, {k: round(v) for k, v in per_step.items()}


# the overrides of every task run here (8 steps on the card), after the
# modules and before the task's own flags; phase_sweep appends them to the
# sweep file's command, whose own max_steps and val_check_interval they
# override (the parser keeps a repeated flag's last value)
TASK_OVERRIDES = ["--trainer.max_steps=8", "--trainer.val_check_interval=4",
                  "--trainer.limit_val_batches=1",
                  "--trainer.print_interval=1", "--trainer.log_interval=4",
                  "--device=cuda"]


def task_argv(task, model, dataset, extra):
    return [f"csmpn_torch/tasks/{task}.py",
            "--trainer.module=csmpn_torch.engineer.Trainer",
            f"--dataset.module=csmpn_torch.data.{dataset}",
            "--optimizer.module=csmpn_torch.engineer.optim.adam",
            f"--model.module=csmpn_torch.models.{model}",
            *TASK_OVERRIDES, *extra]


def check_per_step(per_step, want, tag):
    for k, n in want.items():
        if per_step[k] != n:
            raise AssertionError(f"{k} launches per {tag} step "
                                 f"{per_step[k]} != {n}")


def fire_quiet(main, argv, dataroot):
    """A task's entry point (fire -> run_task -> Trainer.fit) with its
    stdout kept; returns (the trainer, the text)."""
    from csmpn_torch.engineer.fire import fire

    os.environ["DATAROOT"] = dataroot
    os.environ["RUNDIR"] = os.path.join(dataroot, "runs")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        trainer = fire(main, argv)
    torch.cuda.synchronize()
    return trainer, buf.getvalue()


def run_entry(main, argv, dataroot, counters, ds, steps=8):
    """Runs a task's entry point (fire -> run_task -> Trainer.fit) with
    every launch count set to 0 just before and read just after, checks
    its ``steps`` training losses, then counts the launches of one more
    training step on a batch of ``ds`` and profiles a few steps.  Returns
    (launches in the run, launches per step, median step ms, busy ms,
    profiled wall ms, the profile's ms a step by kernel)."""
    for c in counters.values():
        c.reset()
    trainer, text = fire_quiet(main, argv, dataroot)
    launches = {k: c.count for k, c in counters.items()}
    for line in text.splitlines():
        if line.startswith(("Step:", "val/loss", "test/loss", "Stopping")):
            print("  " + line)
    losses = [float(l.rsplit(":", 1)[1]) for l in text.splitlines()
              if "(Training) Loss:" in l]
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"training losses not {steps} finite values: "
                             f"{losses}")
    if "Stopping due to max_steps." not in text:
        raise AssertionError("no 'Stopping due to max_steps.'")
    print(f"  launches during the run: {launches}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} never launched on the path")
    step_ms = statistics.median(trainer.step_seconds) * 1e3
    print(f"  training step: median {step_ms:.2f} ms over "
          f"{len(trainer.step_seconds)} steps "
          f"(all: {[round(s * 1e3, 2) for s in trainer.step_seconds]})")

    # launches of one training step, on the trained model
    model, opt = trainer.model, trainer.optimizer
    batch = next(iter(ds.train_loader(seed=0))).to(trainer.device)

    def step():
        loss, _ = model(batch)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return float(loss.detach())

    for c in counters.values():
        c.reset()
    step()
    torch.cuda.synchronize()
    per_step = {k: c.count for k, c in counters.items()}
    print(f"  launches per training step: {per_step}")
    busy_ms, wall_ms, kernels, runs = phase_profile(step)
    # KERNEL_OF is the map the graph phase reads replays through: hold it
    # to the wrappers' counts on the eager step
    seen = profiled_launches(runs, per_step)
    if seen != per_step:
        raise AssertionError(f"kernel runs a profiled step {seen} != the "
                             f"wrappers' launches {per_step}")
    return launches, per_step, step_ms, busy_ms, wall_ms, kernels, trainer


def phase_profile(step, steps=3, per_call=1):
    """Device busy time over a few training steps (torch.profiler), the
    kernels that take it, and how often each ran.  ``step`` runs
    ``per_call`` steps and reads their losses back; the numbers are per
    training step.  Returns (busy ms, wall ms, ms by kernel, runs by
    kernel)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    steps *= per_call
    wall_ms /= per_call
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith(("Optimizer.", "nccl:"))]  # spans
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    n_launch = sum(e.count for e in events) / steps
    print(f"  profile of {steps} steps: wall {wall_ms:.2f} ms/step, device "
          f"busy {busy_ms:.2f} ms/step ({100 * busy_ms / wall_ms:.1f}%), "
          f"{n_launch:.0f} device ops/step")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"    {e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
              f"{e.count // steps:5d}x  {e.key[:70]}")
    return (busy_ms, wall_ms,
            {e.key: e.self_device_time_total / 1e3 / steps for e in events},
            {e.key: e.count / steps for e in events})


# the device kernels each launch counter's wrapper launches once a call
# (K1's, K2's and K3's in both modes, at Cl(3) and Cl(2), and the pair
# form's): a profile's runs of them are the launches the card ran, whether
# a wrapper or a graph replay issued them
KERNEL_OF = {
    "k1": r"\bsegment_sum_kernel<",
    **dict.fromkeys(("k2", "k2_cl2"), r"\bcemlp_fwd(_tile)?_kernel<"),
    **dict.fromkeys(("k3", "k3_cl2"), r"\bcemlp_bwd(_tile)?_kernel<"),
    "k2p": r"\bcemlp_pair_fwd(_tile)?_kernel<",
    "k3p": r"\bcemlp_pair_bwd(_tile)?_kernel<",
}


def profiled_launches(runs, keys):
    """Launches a step by counter key, from a profile's runs by kernel
    name (``phase_profile``'s last result)."""
    return {k: sum(n for name, n in runs.items()
                   if re.search(KERNEL_OF[k], name)) for k in keys}


def check_k2_profile(kernels, tag):
    """The dense K2 of a fast-mode profile (kernel name -> ms a step) is
    its row tile kernel, after its parameter image's pack, and never the
    exact-mode row kernel; prints their ms a step."""
    def ms(pattern):
        names = [k for k in kernels if re.search(pattern, k)]
        return names, sum(kernels[k] for k in names)

    (tile, t_ms), (pack, p_ms), (row, _) = (
        ms(r"\bcemlp_fwd_tile_kernel<"), ms(r"\bpack_tparams_kernel<"),
        ms(r"\bcemlp_fwd_kernel<"))
    if not tile or not pack or row:
        raise AssertionError(f"{tag} profile: K2 kernels {tile + pack + row},"
                             f" want cemlp_fwd_tile_kernel and "
                             f"pack_tparams_kernel alone")
    print(f"  {tag}: K2 {t_ms + p_ms:.3f} ms a profiled step "
          f"(cemlp_fwd_tile_kernel {t_ms:.3f}, pack_tparams_kernel "
          f"{p_ms:.3f}); no cemlp_fwd_kernel")


# --------------------------------------- the task steps as a CUDA graph

# the graph phase of a task: G_STEPS training steps in groups of G_K (one
# captured training step replayed), device_data, eval read back every
# G_EVAL_K batches; an eager K = 1 run of as many steps (the schedule
# depends on max_steps) from the same seed (init and shuffle) beside it
G_STEPS, G_K, G_EVAL_K = 16, 8, 2
G_KNOBS = [f"--trainer.steps_per_dispatch={G_K}",
           "--trainer.device_data=True",
           f"--trainer.eval_batches_per_dispatch={G_EVAL_K}"]
# step times: T_ROUNDS turns of T_STEPS eager steps, then T_STEPS graph
# steps (T_STEPS / G_K groups), after warm-up; 4 x 32 = 128 steps a mode
T_ROUNDS, T_STEPS = 4, 32
# the graph runs' losses against eager K = 1 runs' from the same seed,
# relative: (precision, the eager run's Adam) -> (bound, steps held).
# "capturable": an eager run that builds the graph's optimizer
# (--optimizer.capturable=True), so the same launches and the same Adam
# arithmetic, held over all G_STEPS steps (the schedule's decay, steps
# 12-15, included); only the order of PyTorch's atomic sums (the backward
# of the models' index_select) may differ.  In exact precision both graph
# variants, host batches copied into the static buffers and device_data's
# gather inside the graph, are held to it at 1e-5.  "default": today's
# eager path (Adam not capturable), the first 8 losses.  Capturable
# Adam raises beta1 and beta2 to the step in fp32 on the card where the
# eager Adam does it in double on the host: 1 - 0.999^1 differs by 1.3e-5
# relative, so every parameter's first update differs by about 6e-6
# relative, which the early large moves of the models carry into the
# loss.  In fast precision such a difference, or an atomic sum's order,
# also flips bf16 roundings of operands and stored activations (2^-8
# relative each), and a loss that falls 27x in five steps (motion: 2.40
# -> 0.09) carries them on as a larger relative share.  The readings on
# the H100 are in PERF.md
G_TOL = {("exact", "capturable"): (1e-5, G_STEPS),
         ("exact", "default"): (1e-4, 8),
         ("fast", "capturable"): (1e-2, G_STEPS),
         ("fast", "default"): (1e-2, 8)}


# aims for the graph step's median (ms) and, but at hulls, the device busy
# share of a profiled window of graph steps
G_AIM_MS = {"motion": 8.0, "hulls": 23.0, "nba": 8.5, "md17": 14.0}
G_AIM_BUSY = 0.8


def print_graph_times(graph_times):
    print("training step, eager (K = 1) and graph (K = 8, device_data): "
          "median / p10 / p90 ms over the timed steps; graph device busy")
    for tag, ((_, e_busy, e_wall), (times, busy, wall)) in \
            graph_times.items():
        share = busy / wall
        met = times["graph"][0] <= G_AIM_MS[tag] and (
            tag == "hulls" or share >= G_AIM_BUSY)
        print(f"  {tag}: eager {'/'.join(f'{x:.3f}' for x in times['eager'])}"
              f", graph {'/'.join(f'{x:.3f}' for x in times['graph'])}; "
              f"graph busy {busy:.3f} of {wall:.3f} ms ({100 * share:.1f}%; "
              f"eager profile {100 * e_busy / e_wall:.1f}%); aim median <= "
              f"{G_AIM_MS[tag]} ms"
              f"{'' if tag == 'hulls' else ', busy >= 80%'}: "
              f"{'met' if met else 'missed'}")


def graph_argv(argv, precision, knobs=()):
    """A task's argv for the graph phase: G_STEPS steps, two eval batches,
    ``precision``, and ``knobs``."""
    out = [a for a in argv if not a.startswith(
        ("--trainer.max_steps=", "--trainer.limit_val_batches="))]
    out += [f"--trainer.max_steps={G_STEPS}",
            "--trainer.limit_val_batches=2", f"--precision={precision}"]
    return out + list(knobs)


def batch_stream(ds, seed, index):
    """Training batches (or with ``index`` their int32 indices) of ``ds``,
    epoch after epoch."""
    loader = ds.train_loader(seed=seed)
    while True:
        yield from (loader.index_iter() if index else loader)


def quantiles(xs_ms):
    q = statistics.quantiles(xs_ms, n=10)
    return statistics.median(xs_ms), q[0], q[-1]


def phase_graph(tag, main, argv, dataroot, counters, ds, eager, k2=True):
    """The task through its entry point under CUDA graphs (G_K steps a
    group, device_data, eval every G_EVAL_K batches) with every launch
    count set to 0 just before and read just after; its losses held to
    eager runs' in exact and fast precision; the step times of both modes
    in turns; a profile of graph groups in which no wrapper is called and
    each kernel runs as often a step as the eager step launches it
    (``eager``: run_entry's result).  Returns (the wrappers' launches in
    the run, the kernels' runs a step under replay, the timing and
    profile numbers)."""
    from csmpn_torch.engineer.trainer import WARMUP_STEPS

    print(f"{tag} under CUDA graphs: {G_STEPS} steps, "
          f"{' '.join(a[2:] for a in G_KNOBS)}")
    host_knobs = [k for k in G_KNOBS if "device_data" not in k]
    for precision in ("exact", "fast"):
        refs = {opt: fire_quiet(main, graph_argv(argv, precision, extra),
                                dataroot)[0]
                for opt, extra in (("default", []), ("capturable", [
                    "--optimizer.capturable=True"]))}
        # exact: the graph copying host batches into its static buffers
        # and gathering them from the split on the card; fast: the
        # latter, the phase's path
        variants = {"device_data": G_KNOBS}
        if precision == "exact":
            variants = {"host batches": host_knobs, **variants}
        for variant, knobs in variants.items():
            path = precision == "fast"
            if path:
                for c in counters.values():
                    c.reset()
            prof_dir = os.path.join(dataroot, f"prof_{tag}_{precision}_"
                                    f"{variant.replace(' ', '_')}")
            tr, text = fire_quiet(main, graph_argv(argv, precision, knobs + [
                f"--trainer.profile_dir={prof_dir}",
                f"--trainer.profile_steps=[{G_K},{G_STEPS}]"]), dataroot)
            if path:
                launches = {k: c.count for k, c in counters.items()}
            for opt, ref in refs.items():
                tol, n = G_TOL[precision, opt]
                a, b = tr.step_losses[:n], ref.step_losses[:n]
                rel = [abs(x - y) / abs(y) for x, y in zip(a, b)]
                print(f"  {precision}, {variant}: {n} graph losses vs "
                      f"eager ({opt} Adam), worst rel {max(rel):.2e} (tol "
                      f"{tol:.0e}); by step "
                      f"{' '.join(f'{r:.1e}' for r in rel)}")
                if len(a) != n or not max(rel) <= tol:
                    raise AssertionError(f"{tag} {precision} {variant}: "
                                         f"graph losses {a} vs eager "
                                         f"({opt} Adam) {b}")
            print(f"  {precision}, {variant}: graph losses "
                  f"{[round(x, 6) for x in tr.step_losses]}")
            g = tr.train_graph
            if (g is None or g.replays != G_STEPS - WARMUP_STEPS
                    or len(tr.step_losses) != G_STEPS
                    or "Stopping due to max_steps." not in text):
                raise AssertionError(
                    f"{tag} {precision} {variant}: {len(tr.step_losses)} "
                    f"steps, graph replays {g and g.replays}, not "
                    f"{G_STEPS} steps of which {G_STEPS - WARMUP_STEPS} "
                    f"replays")
            lr = float(tr.optimizer.param_groups[0]["lr"])
            if lr != float(torch.tensor(tr.scheduler(G_STEPS - 1))):
                raise AssertionError(f"{tag}: lr {lr} after the last "
                                     f"replay, not schedule({G_STEPS - 1})")
            e = tr.eval_graph
            if e is None or e.replays < 1:
                raise AssertionError(f"{tag}: the eval graph never replayed")
            traces = os.listdir(prof_dir) if os.path.isdir(prof_dir) else []
            if not traces:
                raise AssertionError(f"{tag}: no trace in {prof_dir}")
            print(f"  {precision}, {variant}: capture "
                  f"{g.capture_seconds * 1e3:.1f} ms, graph pool "
                  f"{g.pool_bytes / 2**20:.1f} MiB (training step); eval "
                  f"graph {e.capture_seconds * 1e3:.1f} ms, "
                  f"{e.pool_bytes / 2**20:.1f} MiB, {e.replays} replays; "
                  f"trace {traces[0]}")
    print(f"  launches during the run: {launches}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} never launched on the path")

    # step times in turns: eager K = 1 (host batches, a read-back a step)
    # and graph groups (one read-back a group of G_K)
    et = eager[6]
    host = batch_stream(ds, 2, False)
    idx = batch_stream(ds, 2, True)
    et.step_seconds.clear()
    tr.step_seconds.clear()
    with contextlib.redirect_stdout(io.StringIO()):
        for _ in range(T_ROUNDS):
            for _ in range(T_STEPS):
                et.train_group([next(host)])
            for _ in range(T_STEPS // G_K):
                tr.train_group(list(itertools.islice(idx, G_K)))
    times = {}
    for mode, t in (("eager", et), ("graph", tr)):
        ms = [x * 1e3 for x in t.step_seconds]
        times[mode] = quantiles(ms)
        print(f"  {mode} step: median {times[mode][0]:.3f} ms, p10 "
              f"{times[mode][1]:.3f}, p90 {times[mode][2]:.3f} over "
              f"{len(ms)} steps (turns of {T_STEPS})")

    # a profile of graph groups: the kernels' runs a step are the launches
    # the replays made; no wrapper may be called in it (no eager step, no
    # second capture)
    print("  profile of graph groups:")
    items = list(itertools.islice(batch_stream(ds, 1, True), G_K))

    def group():
        with contextlib.redirect_stdout(io.StringIO()):
            tr.train_group(items)

    for c in counters.values():
        c.reset()
    busy_ms, wall_ms, kernels, runs = phase_profile(group, steps=2,
                                                    per_call=G_K)
    called = {k: c.count for k, c in counters.items()}
    per_step = profiled_launches(runs, counters)
    print(f"  launches per training step under replay (kernel runs in the "
          f"profile): {per_step} (eager {eager[1]}); wrapper calls "
          f"{called}")
    if per_step != eager[1] or any(called.values()):
        raise AssertionError(f"{tag}: kernel runs a step under replay "
                             f"{per_step} != eager launches {eager[1]}, or "
                             f"wrappers called {called}")
    if k2:
        check_k2_profile(kernels, f"{tag} (graph)")
    mine = [k for k in kernels if re.search(
        r"\b(segment_sum|cemlp\w*|pack_tparams|reduce_partials)_kernel\b", k)]
    for k in sorted(mine, key=lambda k: -kernels[k]):
        e_ms = eager[5].get(k, float("nan"))
        print(f"    {k[:60]:60s} graph {kernels[k]:.4f} ms/step, eager "
              f"{e_ms:.4f} ({kernels[k] / e_ms:.3f}x)")
    return launches, per_step, times, busy_ms, wall_ms


# ------------------------------------------- data parallel (S5b)

# the device kernels of an NCCL all-reduce: a group of one runs ReduceOp.AVG
# as NCCL's one-rank kernel, larger groups as ncclDevKernel_AllReduce_*
NCCL_KERNEL = r"oneRankReduce|ncclDevKernel|ncclKernel"
DP_STEPS = {"eager": 8, "graph": 16}
DP_KNOBS = {"eager": [], "graph": [f"--trainer.steps_per_dispatch={G_K}"]}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_argv(mode, on):
    argv = [a for a in motion_argv() if not a.startswith(
        "--trainer.max_steps=")]
    return argv + [f"--trainer.max_steps={DP_STEPS[mode]}",
                   f"--data_parallel={'true' if on else 'false'}",
                   *DP_KNOBS[mode]]


def nccl_per_step(kernels, runs):
    """(all-reduce kernel runs a step, their device µs a step) from a
    profile's ms and runs by kernel name."""
    names = [k for k in runs if re.search(NCCL_KERNEL, k)]
    return (sum(runs[k] for k in names),
            sum(kernels[k] for k in names) * 1e3)


def phase_data_parallel(dataroot, counters, eager):
    """The motion task through its entry point with --data_parallel=true
    in an NCCL process group of one (this process, rank 0 of 1, joined by
    engineer.fire from torchrun's variables): the gradients and the loss
    all-reduced between backward and the optimizer step, eagerly and
    inside the captured step under steps_per_dispatch=8.

    1. Under torch.use_deterministic_algorithms (the models' index_select
       backward otherwise sums with atomics in a varying order): the
       final parameters and the losses of each mode bitwise equal to the
       same run without data parallel, from the same seed.
    2. Without it, the runs of the path with their launches counted (every
       count set to 0 just before and read just after), a profile of each
       mode (one NCCL all-reduce kernel a step besides K1, K2 and K3 as
       often as the eager step launches them; no wrapper called under
       replay) and the step times with and without the all-reduce in
       turns (eager: one trainer's steps with its mesh and without it;
       ``eager``: run_entry's motion result, whose launches a step the
       profiles must show).
    The group is destroyed and the variables restored at the end.
    Returns (the launches and runs a step of each mode, the times)."""
    import torch.distributed as dist
    from csmpn_torch.tasks.motion import main

    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    print(f"data parallel: motion via fire -> run_task -> Trainer.fit with "
          f"--data_parallel=true in an NCCL group of one; eager "
          f"{DP_STEPS['eager']} steps, graph {DP_STEPS['graph']} steps "
          f"(steps_per_dispatch={G_K}), fast precision")
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for mode in ("eager", "graph"):
                plain, _ = fire_quiet(main, dp_argv(mode, False), dataroot)
                dp, text = fire_quiet(main, dp_argv(mode, True), dataroot)
                check_dp_run(mode, plain, dp, text)
        finally:
            torch.use_deterministic_algorithms(False)
        if not (dist.is_initialized() and dist.get_backend() == "nccl"
                and dist.get_world_size() == 1):
            raise AssertionError("no NCCL group of one after the runs")

        out, trainers = {}, {}
        for mode in ("eager", "graph"):
            for c in counters.values():
                c.reset()
            dp, text = fire_quiet(main, dp_argv(mode, True), dataroot)
            launches = {k: c.count for k, c in counters.items()}
            check_dp_run(mode, None, dp, text)
            for k, v in launches.items():
                if v <= 0:
                    raise AssertionError(f"kernel {k} never launched on the "
                                         f"data-parallel path ({mode})")
            trainers[mode] = dp
            out[mode] = launches
        trainers["graph plain"], _ = fire_quiet(
            main, dp_argv("graph", False), dataroot)

        from csmpn_torch.data.motion import MotionDataset

        with contextlib.redirect_stdout(io.StringIO()):
            ds = MotionDataset(batch_size=B, num_training_samples=200)
        per_step, ar_us = {}, {}
        for mode in ("eager", "graph"):
            tr, k = trainers[mode], (1 if mode == "eager" else G_K)
            items = list(itertools.islice(batch_stream(ds, 1, False), k))

            def group():
                with contextlib.redirect_stdout(io.StringIO()):
                    tr.train_group(items)

            print(f"  profile of {mode} data-parallel steps:")
            for c in counters.values():
                c.reset()
            _, _, kernels, runs = phase_profile(group, steps=2 if k > 1
                                                else 3, per_call=k)
            called = {n: c.count for n, c in counters.items()}
            per_step[mode] = profiled_launches(runs, counters)
            n_ar, ar_us[mode] = nccl_per_step(kernels, runs)
            print(f"  {mode}: all-reduce kernels a step {n_ar:.3f} "
                  f"({ar_us[mode]:.2f} us a step: "
                  f"{[n[:60] for n in runs if re.search(NCCL_KERNEL, n)]}); "
                  f"K1-K3 runs a step {per_step[mode]} (eager step "
                  f"{eager[1]}); wrapper calls {called}")
            if abs(n_ar - 1) > 1e-9 or per_step[mode] != eager[1]:
                raise AssertionError(
                    f"data parallel {mode}: {n_ar} all-reduce kernels a "
                    f"step, kernel runs {per_step[mode]} != {eager[1]}")
            if mode == "graph" and any(called.values()):
                raise AssertionError(f"wrappers called under replay: "
                                     f"{called}")

        # step times in turns: eager steps of one trainer with its mesh
        # and with the mesh taken away (the step without the all-reduce),
        # then graph groups with / without it (two captured steps)
        secs = {m: [] for m in ("eager", "eager plain", "graph",
                                "graph plain")}
        streams = {m: batch_stream(ds, 2, False) for m in secs}
        et, mesh = trainers["eager"], trainers["eager"].mesh
        with contextlib.redirect_stdout(io.StringIO()):
            for _ in range(T_ROUNDS):
                for m in secs:
                    tr = trainers.get(m, et)
                    et.mesh = None if m == "eager plain" else mesh
                    n = len(tr.step_seconds)
                    for _ in range(T_STEPS // (G_K if tr is not et else 1)):
                        tr.train_group(list(itertools.islice(
                            streams[m], G_K if tr is not et else 1)))
                    secs[m] += tr.step_seconds[n:]
        et.mesh = mesh
        times = {m: quantiles([x * 1e3 for x in v]) for m, v in secs.items()}
        print(f"  step ms, median / p10 / p90 of {T_ROUNDS * T_STEPS} steps "
              f"a mode in turns (graph: K = {G_K}, host batches), on "
              f"{card_line()}:")
        for m in ("eager", "graph"):
            print(f"    {m}: with the all-reduce "
                  f"{'/'.join(f'{x:.3f}' for x in times[m])}, without "
                  f"{'/'.join(f'{x:.3f}' for x in times[m + ' plain'])}"
                  f"; all-reduce {ar_us[m]:.2f} us of device time a step")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return ((out["eager"], per_step["eager"]),
            (out["graph"], per_step["graph"]), times, ar_us)


def check_dp_run(mode, plain, dp, text):
    """A data-parallel run of ``mode``: a mesh of one NCCL rank, its steps
    and replays, and, given the same run without data parallel
    (``plain``), bitwise the same parameters and losses."""
    from csmpn_torch.engineer.trainer import WARMUP_STEPS

    mesh = dp.mesh
    steps = DP_STEPS[mode]
    ok = (mesh is not None and mesh.world == 1 and mesh.rank == 0
          and "Distributed: {'rank': 0, 'world_size': 1" in text
          and len(dp.step_losses) == steps
          and all(math.isfinite(v) for v in dp.step_losses)
          and "Stopping due to max_steps." in text)
    if mode == "graph":
        ok = ok and dp.train_graph is not None and \
            dp.train_graph.replays == steps - WARMUP_STEPS
    if not ok:
        raise AssertionError(f"data parallel {mode}: mesh {mesh}, "
                             f"{len(dp.step_losses)} losses {dp.step_losses}")
    if plain is None:
        return
    if plain.mesh is not None:
        raise AssertionError("--data_parallel=false built a mesh")
    diff = [n for (n, a), b in zip(plain.model.named_parameters(),
                                   dp.model.parameters())
            if not torch.equal(a, b)]
    same_loss = plain.step_losses == dp.step_losses
    print(f"  {mode}: {steps} steps, losses {dp.step_losses[0]:.6f} -> "
          f"{dp.step_losses[-1]:.6f}; parameters bitwise equal to the run "
          f"without data parallel: {not diff}; losses equal: {same_loss}")
    if diff or not same_loss:
        raise AssertionError(f"data parallel {mode}: parameters {diff[:5]} "
                             f"differ, or losses {dp.step_losses} != "
                             f"{plain.step_losses}")


# ---------------------------------------------------------- the hulls path

HULLS_PER_STEP = {"k2p": 15, "k3p": 15}


def hulls_dataset(dataroot):
    from csmpn_torch.data.hulls import ConvexHullDataset

    os.environ["DATAROOT"] = dataroot
    return ConvexHullDataset(num_samples=H_TRAIN, batch_size=H_B,
                             num_val_samples=H_VAL)


def hulls_shapes(spec):
    """(name, rows, Cin, C, launches per step) of every CEMLP block of a
    hulls training step at batch H_B, from the data's padding spec: the
    edge and node models of 3 EGCL layers (edge attributes 2 x 3 simplex
    types, node attributes 3) and the embeddings of edges (2 vertex
    orders) and triangles (6)."""
    counts, h = spec.counts_max, H_HID
    n, e = sum(counts), spec.e_max
    return [
        ("edge_block0", H_B * e, h + 6, h, 3),
        ("edge_block1", H_B * e, h, h, 3),
        ("node_block0", H_B * n, 2 * h + 3, h, 3),
        ("node_block1", H_B * n, h, h, 3),
        ("embed_1", H_B * counts[1] * 2, 2, h, 1),
        ("embed_2_block0", H_B * counts[2] * 6, 3, h, 1),
        ("embed_2_block1", H_B * counts[2] * 6, h, h, 1),
    ]


def phase_k1_task(dev, gen, ds, results, d, tag):
    """K1 at a task's width (D = hidden x blades) on a real batch's ids:
    hulls D = 28 x 32 = 896, NBA 40 x 4 = 160, MD17 32 x 8 = 256; checked
    as check_k1 does and timed as time_k1 does."""
    from csmpn_torch.models.common import flatten_graph

    batch = next(iter(ds.train_loader(seed=0))).to(dev)
    ei, emask, (_, src_sorted) = flatten_graph(batch)
    dst, src_sorted = ei[1].contiguous(), src_sorted.contiguous()
    n, e = batch.node_types.numel(), dst.numel()
    print(f"K1 vs plain at the {tag} shape (E={e} N={n} D={d}, a real "
          f"batch's ids)")
    err = check_k1(dev, gen, tag, [
        ("targets", dst, emask), ("sorted sources", src_sorted, None),
        ("targets + sentinels", with_sentinels(dst, n), emask)], n, (d,))
    data = torch.randn(e, d, generator=gen).to(torch.bfloat16).to(dev)
    results["k1"]["max_abs_err"] = max(results["k1"]["max_abs_err"], err)
    results["k1"].update(time_k1(tag, data, dst, n))


def check_block_form(dev, gen, alg, shapes, keys):
    """Holds one form of the block kernels (K2/K3 or K2p/K3p) to their
    plain versions at every launch shape (name, rows, Cin, C, launches per
    step), exact and fast: the output, dx and all 10 gradients, two
    launches bitwise equal.  Returns the worst error per kernel and mode;
    ``keys`` name the forward and backward kernels (their tolerances are
    TOL[f"{key}_{mode}"])."""
    from csmpn_torch.ops import cemlp_kernel as ck

    kf, kb = keys
    nb = alg.n_blades
    errs = {k: {"exact": [], "fast": []} for k in keys}
    for name, rows, cin, c, _ in shapes:
        x, params, dout = block_inputs(rows, cin, c, gen, dev, nb=nb)
        for exact in (True, False):
            mode = "exact" if exact else "fast"
            out = ck.block_forward(x, params, alg, exact)
            again = ck.block_forward(x, params, alg, exact)
            ref = ck.block_forward_plain(x, params, alg, exact)
            errs[kf][mode].append(check(f"{kf} {name} {mode}", out, ref,
                                        TOL[f"{kf}_{mode}"]))
            if not torch.equal(out, again):
                raise AssertionError(f"{kf} {name} {mode}: two launches "
                                     f"differ")
            del out, again, ref
            dx, grads = ck.block_backward(x, dout, params, alg, exact)
            dx2, grads2 = ck.block_backward(x, dout, params, alg, exact)
            rdx, rgrads = ck.block_backward_plain(x, dout, params, alg, exact)
            for pn, g, g2, rg in zip(["dx"] + [f"d{b}" for b in BLOCK_NAMES],
                                     [dx] + grads, [dx2] + grads2,
                                     [rdx] + rgrads):
                errs[kb][mode].append(check(f"{kb} {name} {mode} {pn}", g,
                                            rg, TOL[f"{kb}_{mode}"]))
                if not torch.equal(g, g2):
                    raise AssertionError(f"{kb} {name} {mode} {pn}: two "
                                         f"launches differ")
            del dx, grads, dx2, grads2, rdx, rgrads
        torch.cuda.empty_cache()
        print(f"  {name}: two launches bitwise equal ({kf} and {kb}, exact "
              f"and fast)")
    return {k: {m: max(v) for m, v in e.items()} for k, e in errs.items()}


def time_block_form(dev, gen, alg, shapes, keys, iters):
    """Times one form of the block kernels, fast mode: kernel, plain
    version and bound at the first (largest) shape, then the kernels at
    every shape with their launches per step.  ``iters`` = (kernel fwd,
    kernel bwd, plain fwd, plain bwd) iterations.  Returns the fields of
    the kernels-line entries of the two kernels."""
    from csmpn_torch.ops import cemlp_kernel as ck

    nb = alg.n_blades
    kf, kb = keys
    name, rows, cin, c, _ = shapes[0]
    x, params, dout = block_inputs(rows, cin, c, gen, dev, nb=nb)
    fwd = time_ms(lambda: ck.block_forward(x, params, alg, False),
                  iters=iters[0])
    fwd_plain = time_ms(lambda: ck.block_forward_plain(x, params, alg, False),
                        iters=iters[2], warmup=1)
    bwd = time_ms(lambda: ck.block_backward(x, dout, params, alg, False),
                  iters=iters[1])
    bwd_plain = time_ms(lambda: ck.block_backward_plain(x, dout, params, alg,
                                                        False),
                        iters=iters[3], warmup=1)
    b2, b2by, b2env = block_bound(rows, cin, c, params, False, nb=nb)
    b3, b3by, b3env = block_bound(rows, cin, c, params, True, nb=nb)
    shape = f"{name}: rows={rows} Cin={cin} C={c} nb={nb} fast"
    print(f"  time {shape}: {kf} {fwd*1e3:.1f} us (plain "
          f"{fwd_plain*1e3:.1f}, bound {b2*1e3:.1f} {b2by}); {kb} "
          f"{bwd*1e3:.1f} us (plain {bwd_plain*1e3:.1f}, bound "
          f"{b3*1e3:.1f} {b3by})")
    del x, params, dout
    torch.cuda.empty_cache()
    tot = [0.0, 0.0]
    for name, rows, cin, c, k in shapes:
        x, params, dout = block_inputs(rows, cin, c, gen, dev, nb=nb)
        tf = time_ms(lambda: ck.block_forward(x, params, alg, False),
                     iters=max(iters[0] // 2, 5))
        tb = time_ms(lambda: ck.block_backward(x, dout, params, alg, False),
                     iters=max(iters[1] // 2, 5))
        bf, _, _ = block_bound(rows, cin, c, params, False, nb=nb)
        bb, _, _ = block_bound(rows, cin, c, params, True, nb=nb)
        tot[0] += k * tf
        tot[1] += k * tb
        print(f"  {name:<15s} rows={rows:<6d} Cin={cin:<3d} C={c}: {kf} "
              f"{tf*1e3:8.1f} us (bound {bf*1e3:5.1f})  {kb} "
              f"{tb*1e3:8.1f} us (bound {bb*1e3:5.1f})  x{k} per step")
    print(f"  per training step: {kf} {tot[0]:.3f} ms, {kb} {tot[1]:.3f} ms")
    return {kf: dict(ms=fwd, plain_ms=fwd_plain, bound_ms=b2, bound_by=b2by,
                     library_ms=None, bound_env_ms=b2env, shape=shape,
                     per_step_ms=tot[0]),
            kb: dict(ms=bwd, plain_ms=bwd_plain, bound_ms=b3, bound_by=b3by,
                     library_ms=None, bound_env_ms=b3env, shape=shape,
                     per_step_ms=tot[1])}


def phase_block_form(dev, gen, results, shapes, metric, keys, name, src,
                     iters):
    """A form of the block kernels against its plain versions at every
    launch shape of its task's step, then its times; fills
    results[key] for both kernels."""
    from csmpn_torch.algebra import get_algebra

    alg = get_algebra(metric)
    errs = check_block_form(dev, gen, alg, shapes, keys)
    times = time_block_form(dev, gen, alg, shapes, keys, iters)
    for k, fn, line in ((keys[0], "fwd", 430), (keys[1], "bwd", 519)):
        results[k] = dict(
            name=f"{name}_{fn}", route="cuda",
            source=f"csmpn_torch/csrc/{src}",
            replaces=f"csmpn_tpu/ops/cemlp_kernel.py:{line}",
            max_abs_err=errs[k]["exact"], max_abs_err_fast=errs[k]["fast"],
            **times[k])


def phase_hulls(dev, gen, results, dataroot, counters):
    """The hulls path: K1 at its width, K2p/K3p at every launch shape of a
    step, the full-width model card vs CPU, then the task through its
    entry point for 8 fast steps with 15 + 15 pair-form launches per
    step."""
    from csmpn_torch.models.hulls import HullsModel
    from csmpn_torch.tasks.hulls import main

    ds = hulls_dataset(dataroot)
    phase_k1_task(dev, gen, ds, results, H_HID * 32, "hulls")
    print("K2p pair-form CEMLP block forward / K3p backward vs plain "
          "(Cl(5,0), hulls shapes)")
    phase_block_form(dev, gen, results, hulls_shapes(ds.spec), (1.0,) * 5,
                     ("k2p", "k3p"), "cemlp_pair", "cemlp_pair.cu",
                     (20, 10, 3, 2))
    print(f"hulls model (Cl(5,0), hidden {H_HID}, 3 layers, batch {H_B}): "
          f"card vs CPU, exact")
    phase_task_model(dev, ds, lambda: HullsModel(spec=ds.spec), "hulls",
                     H_B)

    argv = task_argv("hulls", "hulls.HullsModel", "hulls.ConvexHullDataset", [
        f"--dataset.num_samples={H_TRAIN}",
        f"--dataset.num_val_samples={H_VAL}",
        f"--dataset.batch_size={H_B}", "--optimizer.lr=1e-3"])
    print(f"hulls task via fire -> run_task -> Trainer.fit: Cl(5,0), "
          f"hidden {H_HID}, 3 layers, batch {H_B}, Adam lr 1e-3, 8 steps, "
          f"fast precision; dataset cut to {H_TRAIN} train / {H_VAL} val / "
          f"{H_VAL} test samples (configs/hulls.yaml: 16,384 each), padding "
          f"spec counts_max={tuple(ds.spec.counts_max)} "
          f"e_max={ds.spec.e_max}")
    res = run_entry(main, argv, dataroot, counters, ds)
    check_per_step(res[1], HULLS_PER_STEP, "hulls")
    return res, phase_graph("hulls", main, argv, dataroot, counters, ds,
                            res, k2=False)


# ------------------------------------------------- the NBA and MD17 paths

# the NBA task (configs/nba.yaml): Cl(2,0), hidden 40, 3 EGCL layers,
# batch 100, Adam 5e-3, the stand-in data at 800 plays (480/160/160)
N_B, N_HID, N_LAYERS, N_PLAYS = 100, 40, 3, 800
NBA_PER_STEP = {"k2_cl2": 15, "k3_cl2": 15}
# the MD17 task (configs/md17.yaml, aspirin): Cl(3,0), hidden 32, 5 EGCL
# layers, batch 100, k = int(dis) = 3 neighbours, Adam 3e-3; the samples
# cut from 5,000/2,000/2,000 to these
M_B, M_HID, M_LAYERS, M_DIS, M_TRAIN, M_EVAL = 100, 32, 5, 3, 500, 200
MD17_PER_STEP = {"k2": 24, "k3": 24}


def nba_dataset(dataroot):
    from csmpn_torch.data.nba import NBADataset

    os.environ["DATAROOT"] = dataroot
    with contextlib.redirect_stdout(io.StringIO()):
        return NBADataset(batch_size=N_B, synth_plays=N_PLAYS)


def nba_shapes(spec):
    """(name, rows, Cin, C, launches per step) of every CEMLP block of an
    NBA training step at batch N_B: the edge and node models of the EGCL
    layers (edge attributes 2 x 3 simplex types, node attributes 3) and
    the embeddings of edges (2 vertex orders, 2 x 20 -> 20 channels) and
    triangles (6 orders, 60 -> 40 -> 20)."""
    counts, h, ni, L = spec.counts_max, N_HID, 20, N_LAYERS
    n, e = sum(counts), spec.e_max
    return [
        ("edge_block0", N_B * e, h + 6, h, L),
        ("edge_block1", N_B * e, h, h, L),
        ("node_block0", N_B * n, 2 * h + 3, h, L),
        ("node_block1", N_B * n, h, h, L),
        ("embed_1", N_B * counts[1] * 2, 2 * ni, ni, 1),
        ("embed_2.a", N_B * counts[2] * 6, 3 * ni, h, 1),
        ("embed_2.b", N_B * counts[2] * 6, h, ni, 1),
    ]


def md17_dataset(dataroot):
    """The aspirin dataset, then the time of its lift alone: the kNN graph
    and the clique lift of every training sample, on the backend the
    dataset used."""
    import numpy as np
    from csmpn_torch.data import md17, native

    os.environ["DATAROOT"] = dataroot
    with contextlib.redirect_stdout(io.StringIO()):
        ds = md17.MD17Dataset(batch_size=M_B, molecule_type="aspirin",
                              dis=M_DIS, num_train_samples=M_TRAIN,
                              num_eval_samples=M_EVAL)
    loc = np.load(os.path.join(dataroot, "md17", "aspirin_train.npy"))
    loc = loc[:M_TRAIN].swapaxes(1, 2)
    t0 = time.perf_counter()
    for i in range(len(loc)):
        md17.lift_sample(loc[i, :, 0], "aspirin", M_DIS, 2, 1e4, 1e4)
    dt = time.perf_counter() - t0
    backend = ("native" if native.available()
               and not os.environ.get("CSMPN_NO_NATIVE") else "python")
    print(f"MD17 aspirin lift: kNN (k={M_DIS}) + clique lift of "
          f"{len(loc)} samples on the {backend} backend: {dt * 1e3:.1f} ms "
          f"({dt * 1e6 / len(loc):.1f} us per sample); padding spec "
          f"counts_max={tuple(ds.spec.counts_max)} e_max={ds.spec.e_max}")
    return ds


def md17_shapes(spec, n0):
    """(name, rows, Cin, C, launches per step) of every CEMLP block of an
    MD17 training step at batch M_B: the EGCL edge and node models, the
    edge (2 orders, 60 -> 32) and triangle (6 orders, 90 -> 32 -> 32)
    embeddings, and the projection CEMLP on the n0 heavy atoms."""
    counts, h, L = spec.counts_max, M_HID, M_LAYERS
    n, e = sum(counts), spec.e_max
    return [
        ("edge_block0", M_B * e, h + 6, h, L),
        ("edge_block1", M_B * e, h, h, L),
        ("node_block0", M_B * n, 2 * h + 3, h, L),
        ("node_block1", M_B * n, h, h, L),
        ("embed_1", M_B * counts[1] * 2, 60, h, 1),
        ("embed_2_block0", M_B * counts[2] * 6, 90, h, 1),
        ("embed_2_block1", M_B * counts[2] * 6, h, h, 1),
        ("projection_mlp", M_B * n0, h, h, 1),
    ]


def phase_md17_blocks(dev, gen, results, shapes):
    """K2/K3 (Cl(3)) at every MD17 launch shape, the widest backward
    (90 -> 32) included: the checks of the block forms, then the times."""
    from csmpn_torch.algebra import get_algebra

    alg = get_algebra((1.0, 1.0, 1.0))
    print("K2/K3 vs plain at the MD17 shapes (Cl(3,0), aspirin)")
    errs = check_block_form(dev, gen, alg, shapes, ("k2", "k3"))
    times = time_block_form(dev, gen, alg, shapes, ("k2", "k3"),
                            (50, 20, 10, 5))
    for k in ("k2", "k3"):
        results[k]["max_abs_err"] = max(results[k]["max_abs_err"],
                                        errs[k]["exact"])
        results[k]["max_abs_err_fast"] = max(results[k]["max_abs_err_fast"],
                                             errs[k]["fast"])
        results[k].update(md17_ms=times[k]["ms"],
                          md17_shape=times[k]["shape"],
                          md17_per_step_ms=times[k]["per_step_ms"])


def phase_nba(dev, gen, results, dataroot, counters):
    """The NBA path: K1 at its width, K2/K3 at Cl(2) at every launch shape
    of a step, the full-width model card vs CPU, then the task through its
    entry point for 8 fast steps with 15 + 15 Cl(2) launches per step."""
    from csmpn_torch.models.nba import NBAModel
    from csmpn_torch.tasks.nba import main

    ds = nba_dataset(dataroot)
    phase_k1_task(dev, gen, ds, results, N_HID * 4, "nba")
    print("K2/K3 at Cl(2,0) (dense form, 4 blades) vs plain (NBA shapes)")
    phase_block_form(dev, gen, results, nba_shapes(ds.spec), (1.0, 1.0),
                     ("k2_cl2", "k3_cl2"), "cemlp_cl2", "cemlp.cu",
                     (50, 20, 10, 5))
    print(f"NBA model (Cl(2,0), hidden {N_HID}, {N_LAYERS} layers, batch "
          f"16): card vs CPU, exact")
    phase_task_model(dev, ds, lambda: NBAModel(
        spec=ds.spec, num_hidden=N_HID, num_layers=N_LAYERS), "nba", 16)
    argv = task_argv("nba", "nba.NBAModel", "nba.NBADataset", [
        f"--model.num_hidden={N_HID}", f"--model.num_layers={N_LAYERS}",
        f"--dataset.batch_size={N_B}", f"--dataset.synth_plays={N_PLAYS}",
        "--optimizer.lr=5e-3"])
    print(f"NBA task via fire -> run_task -> Trainer.fit: Cl(2,0), hidden "
          f"{N_HID}, {N_LAYERS} layers, batch {N_B}, Adam 5e-3, 8 steps, "
          f"fast precision; stand-in data at {N_PLAYS} plays "
          f"({len(ds.train_dataset)}/{len(ds.val_dataset)}/"
          f"{len(ds.test_dataset)}), padding spec "
          f"counts_max={tuple(ds.spec.counts_max)} e_max={ds.spec.e_max}")
    res = run_entry(main, argv, dataroot, counters, ds)
    check_per_step(res[1], NBA_PER_STEP, "NBA")
    check_k2_profile(res[5], "NBA")
    return res, phase_graph("NBA", main, argv, dataroot, counters, ds, res)


def phase_md17(dev, gen, results, dataroot, counters):
    """The MD17 path (aspirin): K1 at its width, K2/K3 at every MD17
    launch shape, the full-width model card vs CPU, then the task through
    its entry point for 8 fast steps with 24 + 24 launches per step."""
    from csmpn_torch.models.md17 import MD17Model
    from csmpn_torch.tasks.md17 import main

    ds = md17_dataset(dataroot)
    n0 = ds.model_kwargs["n_vertices"]
    phase_k1_task(dev, gen, ds, results, M_HID * 8, "md17")
    phase_md17_blocks(dev, gen, results, md17_shapes(ds.spec, n0))
    print(f"MD17 model (Cl(3,0), hidden {M_HID}, {M_LAYERS} layers, batch "
          f"16): card vs CPU, exact")
    phase_task_model(dev, ds, lambda: MD17Model(
        spec=ds.spec, n_vertices=n0, num_hidden=M_HID,
        num_layers=M_LAYERS), "md17", 16)
    argv = task_argv("md17", "md17.MD17Model", "md17.MD17Dataset", [
        f"--model.num_hidden={M_HID}", f"--model.num_layers={M_LAYERS}",
        f"--dataset.batch_size={M_B}", "--dataset.molecule_type=aspirin",
        f"--dataset.dis={M_DIS}", f"--dataset.num_train_samples={M_TRAIN}",
        f"--dataset.num_eval_samples={M_EVAL}", "--optimizer.lr=3e-3",
        "--optimizer.weight_decay=1e-6"])
    print(f"MD17 task via fire -> run_task -> Trainer.fit: aspirin, "
          f"Cl(3,0), hidden {M_HID}, {M_LAYERS} layers, batch {M_B}, Adam "
          f"3e-3, 8 steps, fast precision; samples cut to {M_TRAIN}/"
          f"{M_EVAL}/{M_EVAL} (configs/md17.yaml: 5,000/2,000/2,000)")
    res = run_entry(main, argv, dataroot, counters, ds)
    check_per_step(res[1], MD17_PER_STEP, "MD17")
    check_k2_profile(res[5], "MD17")
    return res, phase_graph("MD17", main, argv, dataroot, counters, ds,
                            res)


# ------------------------------------------------------- the bench path

BENCH_PER_STEP = {"k1": 2, "k2": 6, "k3": 6, "k4": 3, "k5": 3}
BENCH_CL2_PER_STEP = {"k1": 2, "k2_cl2": 6, "k3_cl2": 6, "k4_cl2": 3,
                      "k5_cl2": 3}
BENCH_CL5_PER_STEP = {"k1": 2, "k2p": 6, "k3p": 6, "k4p": 3, "k5p": 3}
BENCH_CL4_PER_STEP = {"k1": 2, "k2p_cl4": 6, "k3p_cl4": 6, "k4p_cl4": 3,
                      "k5p_cl4": 3}
# the bench at --dim 4 (Cl(4,0), hidden 28): the node blocks K2p/K3p at
# Cl(4) run on its path (name, rows, Cin, C, launches per step), then a
# narrow block and one with the attribute-width input of a hulls edge
# block, which the kernels take too
BENCH_CL4_SHAPES = [
    ("node_block0", BN, 56, 28, 3),
    ("node_block1", BN, 28, 28, 3),
    ("narrow", 4099, 3, 4, 0),
    ("attr_width", BN, 34, 28, 0),
]


def phase_block_cl4(dev, gen, results):
    """K2p/K3p at Cl(4) against their plain versions at the bench's
    --dim 4 block shapes and two more, then their times."""
    print("K2p pair-form CEMLP block forward / K3p backward at Cl(4,0) vs "
          "plain (bench --dim 4 node blocks, narrow, attribute width)")
    phase_block_form(dev, gen, results, BENCH_CL4_SHAPES, (1.0,) * 4,
                     ("k2p_cl4", "k3p_cl4"), "cemlp_pair_cl4",
                     "cemlp_pair_cl4.cu", (20, 10, 3, 2))


def phase_bench(counters, dim=3, per_step_want=BENCH_PER_STEP, idle=None):
    """csmpn_torch.bench through its entry point at full width (``--dim``
    for Cl(2), Cl(4) and Cl(5)), then one step's launches, a profile, the
    fast-mode loss against exact, and the stack's loss and gradients on
    the fused kernels against the composed route.  The counters of
    ``idle`` (another algebra's kernels) must not move in the run or the
    step."""
    from csmpn_torch import bench
    from csmpn_torch.ops import fused_egcl as fe
    from csmpn_torch.ops.segment import set_aggregation_mode

    hidden = bench.WIDTHS[dim][0]
    tag = "" if dim == 3 else f"_cl{dim}"
    fused = {5: "K4p/K5p", 4: "K4p/K5p at Cl(4)"}.get(dim, "K4/K5")
    idle = idle or {}

    def check_idle(what):
        moved = {k: c.count for k, c in idle.items() if c.count}
        if moved:
            raise AssertionError(f"{what} at --dim {dim} launched another "
                                 f"algebra's kernels: {moved}")
    print(f"bench path via csmpn_torch.bench.main"
          f"{'' if dim == 3 else f' --dim {dim}'}: 3 EGCL layers"
          f"{'' if dim == 3 else f' at Cl({dim},0)'}, hidden {hidden}, "
          f"E=131072, N=8192, fast, 10 steps x 3 windows")
    for c in list(counters.values()) + list(idle.values()):
        c.reset()
    res = bench.main(["--device=cuda"]
                     + ([] if dim == 3 else ["--dim", str(dim)]))
    torch.cuda.synchronize()
    launches = {k: c.count for k, c in counters.items()}
    check_idle("the bench run")
    st = [t * 1e3 for t in res["step_times_s"]]
    print(f"  step: best window {res['step_s'] * 1e3:.3f} ms/step, median "
          f"{statistics.median(st):.3f} ms over {len(st)} steps (all: "
          f"{[round(t, 3) for t in st]})")
    print(f"  window losses {res['losses']}")
    print(f"  launches during the run: {launches}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} never launched on the bench "
                                 f"path")
    if not all(math.isfinite(v) for v in res["losses"]):
        raise AssertionError(f"bench losses not finite: {res['losses']}")
    model, opt = res["model"], res["optimizer"]
    h, ei, src_sort = res["inputs"]
    for c in counters.values():
        c.reset()
    bench.train_step(model, opt, h, ei, src_sort)
    torch.cuda.synchronize()
    per_step = {k: c.count for k, c in counters.items()}
    check_idle("a training step")
    print(f"  launches per training step: {per_step} (expected "
          f"{per_step_want})")
    if per_step != per_step_want:
        raise AssertionError(f"launches per bench step {per_step} != "
                             f"{per_step_want}")

    def step():
        return float(bench.train_step(model, opt, h, ei, src_sort))

    busy_ms, wall_ms, kernels, _ = phase_profile(step)
    if dim in (2, 3):
        check_k2_profile(kernels, f"bench{tag}")

    def loss_and_grads(mode, fused=True):
        set_aggregation_mode(mode)
        model.zero_grad(set_to_none=True)
        supported = fe.fused_mp_supported
        if not fused:     # the layer takes the composed route in fast mode
            fe.fused_mp_supported = lambda *args: False
        try:
            loss = bench.loss_fn(model(h, ei, src_sort))
            loss.backward()
        finally:
            fe.fused_mp_supported = supported
        return loss.detach().cpu(), [p.grad.detach().clone()
                                     for p in model.parameters()]

    lf, gf = loss_and_grads("fast")                # fused on the edge side
    lc, gc = loss_and_grads("fast", fused=False)   # the composed route
    le, _ = loss_and_grads("exact")
    check("bench stack: fast-mode loss vs exact-mode loss (card)", lf, le,
          TOL[f"bench{tag}_fast_loss"])
    check(f"bench stack, fast: loss on {fused} vs on the composed route", lf,
          lc, TOL[f"bench{tag}_fused_loss"])
    errs = sorted(((rel_err(a, b)[1], k) for a, b, (k, _) in
                   zip(gf, gc, model.named_parameters())), reverse=True)
    worst = errs[0][0]
    tol = TOL[f"bench{tag}_fused_grad"]
    ok = worst <= tol and all(torch.isfinite(g).all().item() for g in gf)
    print(f"  bench stack, fast: gradients on {fused} vs on the composed "
          f"route, worst of {len(gf)} tensors rel {worst:.3e}  tol "
          f"{tol:.0e}  {'ok' if ok else 'FAIL'}; median "
          f"{statistics.median(e for e, _ in errs):.3e}; worst "
          f"{[(k, round(e, 5)) for e, k in errs[:3]]}")
    if not ok:
        raise AssertionError(f"bench stack gradients: {fused} vs composed "
                             f"{worst:.3e}")
    return launches, per_step, res, busy_ms, wall_ms


# ------------------------------------- S5a: one EGCL layer streamed in chunks

# the streamed layer against the same layer unstreamed: 262,144 simplices,
# in-degree 8, 16 chunks (16,384 nodes a chunk, a multiple of K4/K5's
# window of 32 targets, so the two runs cut the targets into the same
# windows), hidden 32, Cl(3,0)
S_NODES, S_DEGREE, S_CHUNKS, S_HID = 262_144, 8, 16, 32
# the reference's workload (runs/queue_r5.sh:174-175): bench_scaling
# --simplices 10000000 --degree 8 --stream 64, fwd+bwd, fast
STREAM_ARGV = ["--simplices", "10000000", "--degree", "8", "--stream", "64",
               "--steps", "3", "--device=cuda"]
# wrapper launches a step.  Fast: a chunk launches K4 once (forward) and
# K5 once (backward, from d(agg)); K2 for the node CEMLP's two blocks in
# the forward and in the backward's recompute, K3 for both in the
# backward; K1 once for the sources' d(h_j) where h needs a gradient (the
# bench takes it for the parameters only).  Exact (the composed route, h
# needing a gradient): a chunk's K2 the edge and node blocks in the
# forward and again in the backward's recompute (8), K3 both CEMLPs' (4),
# K1 the aggregation in the forward and its recompute, the target
# gather's backward and the sources' d(h_j) (4)
STREAM_PER_STEP = {"k1": 0, "k2": 256, "k3": 128, "k4": 64, "k5": 64}
STREAM_CMP_PER_STEP = {
    "fast": {"k1": 16, "k2": 64, "k3": 32, "k4": 16, "k5": 16},
    "exact": {"k1": 64, "k2": 128, "k3": 64, "k4": 0, "k5": 0}}
# the offset checks: a chunk of the reference's workload cut into 8
# (10,000,000 edge rows, 1,250,000 targets): block 1's input rows hold
# 2.56e9 elements, past 2**31.  K4/K5 (fast) take them on the fused route;
# K2/K3 (both modes) and K1 (the aggregation, 256 columns) take them on
# the composed route of exact mode
BIG_EDGES, BIG_NODES = 10_000_000, 1_250_000
# forward only, the same workload: no aggregate is kept for a backward, so
# the peak lies at least the aggregates' bytes (N x 32 x 8 fp32) below the
# fwd+bwd run's
STREAM_FWD_ARGV = STREAM_ARGV[:-3] + ["--steps", "1", "--fwd-only",
                                      "--device=cuda"]
STREAM_TOL = {
    # streamed against unstreamed, relative to the largest magnitude.
    # The outputs: the same windows, edge rows in the same order and
    # row-local node blocks, so expected bitwise; the limit is for the
    # exact mode's composed route (K1's sums, the same rows in the same
    # order, are expected bitwise too).  Parameter gradients: the same
    # cotangents summed over 16 chunks instead of one launch's CTA
    # partials, fp32 order only.  d(h) in fast mode: the unstreamed
    # layer's gather backward returns the sources' and the targets' sums
    # as bf16 (the type of the gathered rows) and autograd adds them in
    # bf16; the streamed layer adds both in fp32, so they part by bf16
    # rounding of the node sums (2**-8 of the largest)
    "out": 1e-6, "param_grad": 1e-4, "h_grad_exact": 1e-4,
    "h_grad_fast": 1e-2,
}
STREAM_KERNELS = [      # (label, kernel names in a profile)
    ("K4", r"\bfused_mp_fwd"), ("K5", r"\bfused_mp_bwd"),
    ("K2", r"\bcemlp_fwd|\bpack_tparams_kernel"), ("K3", r"\bcemlp_bwd"),
    ("K3/K5 partial sums", r"\breduce_partials_kernel"),
    ("K1", r"\bsegment_sum_kernel"),
    ("source gather (index_select)", r"gather_kernel|indexSelect"),
    ("index_add_ (d(h))", r"indexFunc|index_add"),
]


def stream_compare(dev, counters, mode):
    """The streamed layer (remat) against the same layer unstreamed, on
    the card, in ``mode``: output, every parameter gradient and d(h) of
    sum(out * g); the streamed step's launches."""
    from csmpn_torch.algebra import get_algebra
    from csmpn_torch.nn.egcl import EGCL
    from csmpn_torch.nn.modules import init_parameters
    from csmpn_torch.ops.segment import set_aggregation_mode
    from csmpn_torch.parallel.edge_partition import (
        StreamArrays, make_synthetic_complex, partition_edges,
        streaming_egcl_apply)

    set_aggregation_mode(mode)
    ei = make_synthetic_complex(S_NODES, S_DEGREE, seed=0)
    part = partition_edges(ei, S_NODES, S_CHUNKS)
    arrays = StreamArrays.of(part, dev)
    layer = EGCL(get_algebra((1.0, 1.0, 1.0)), S_HID, S_HID, S_HID,
                 aggr="mean")
    init_parameters(layer, torch.Generator().manual_seed(3))
    layer = layer.to(dev)
    gen = torch.Generator(dev).manual_seed(3)
    h = torch.randn((S_NODES, S_HID, 8), generator=gen, device=dev)
    g = torch.randn((S_NODES, S_HID, 8), generator=gen, device=dev)

    def grads(run):
        hh = h.clone().requires_grad_(True)
        layer.zero_grad(set_to_none=True)
        out = run(hh)
        (out * g).sum().backward()
        return out.detach(), hh.grad, [p.grad for p in layer.parameters()]

    ei_t = torch.from_numpy(ei).to(dev)
    ref = grads(lambda hh: layer(hh, ei_t))
    streaming_egcl_apply(layer, h, part, arrays=arrays)   # tables built
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    got = grads(lambda hh: streaming_egcl_apply(layer, hh, part,
                                                arrays=arrays))
    torch.cuda.synchronize()
    per_step = {k: c.count for k, c in counters.items()}
    bitwise = torch.equal(got[0], ref[0])
    # a chunk's padded (masked) edges target its last node, so there K1's
    # segment is longer and its lanes sum in another order
    inner = torch.arange(S_NODES, device=dev) % part.nodes_per_shard \
        != part.nodes_per_shard - 1
    print(f"  {mode}: streamed output bitwise equal to unstreamed: "
          f"{bitwise}; at all but each chunk's last node: "
          f"{torch.equal(got[0][inner], ref[0][inner])}")
    check(f"stream {mode}: output, streamed vs unstreamed", got[0], ref[0],
          STREAM_TOL["out"])
    check(f"stream {mode}: d(h)", got[1], ref[1],
          STREAM_TOL[f"h_grad_{mode}"])
    names = [k for k, _ in layer.named_parameters()]
    errs = sorted(((rel_err(a, b)[1], k) for a, b, k in
                   zip(got[2], ref[2], names)), reverse=True)
    ok = errs[0][0] <= STREAM_TOL["param_grad"] and all(
        torch.isfinite(a).all().item() for a in got[2])
    print(f"  stream {mode}: parameter gradients, worst of {len(names)} "
          f"rel {errs[0][0]:.3e} ({errs[0][1]})  tol "
          f"{STREAM_TOL['param_grad']:.0e}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"stream {mode}: parameter gradients "
                             f"{errs[0]}")
    want = STREAM_CMP_PER_STEP[mode]
    print(f"  stream {mode}: launches of a streamed step {per_step} "
          f"(expected {want})")
    if per_step != want:
        raise AssertionError(f"stream {mode}: launches {per_step} != {want}")
    return bitwise


def same_upper(name, a, b):
    """Bitwise equality of a whole call's upper rows and the same rows
    computed alone."""
    same = torch.equal(a, b)
    print(f"  {name:<16s} of the upper rows, whole call vs alone: "
          f"{'bitwise equal' if same else 'DIFFER'}")
    if not same or not torch.isfinite(a.float()).all().item():
        raise AssertionError(f"{name}: offsets past 2**31 disagree")


def stream_offsets(dev):
    """K4 and K5 on one chunk past 2**31 elements (BIG_EDGES rows of 32
    channels x 8 blades, fast), K2 and K3 on those rows in both modes and
    K1 on BIG_EDGES rows of 256 columns, each against the same kernel on
    its upper rows alone, where every offset is small: the same windows,
    rows and order, so the results of those rows must be bitwise equal."""
    from csmpn_torch.algebra import get_algebra
    from csmpn_torch.ops import cemlp_kernel as ck
    from csmpn_torch.ops import fused_egcl as fe
    from csmpn_torch.ops import segment_kernel as sk

    c, nb = S_HID, 8
    alg = get_algebra((1.0, 1.0, 1.0))
    params = edge_params(c, c, torch.Generator().manual_seed(5), dev)
    g = torch.Generator(dev).manual_seed(5)
    dst = torch.sort(torch.randint(0, BIG_NODES, (BIG_EDGES,), generator=g,
                                   device=dev)).values.to(torch.int32)
    # the upper part starts at a window boundary, its rows from there
    base = (int(BIG_NODES * 0.7) // 32) * 32
    e0 = int(torch.searchsorted(dst, torch.tensor([base], device=dev,
                                                  dtype=torch.int32)))
    print(f"offsets past 2**31: {BIG_EDGES} edge rows x {c} x {nb} "
          f"= {BIG_EDGES * c * nb:.3e} elements, against the upper "
          f"{BIG_NODES - base} targets and {BIG_EDGES - e0} rows alone")

    def fused():
        h = torch.randn((BIG_NODES, c, nb), generator=g, device=dev,
                        dtype=torch.bfloat16)
        hj = torch.randn((BIG_EDGES, c, nb), generator=g, device=dev,
                         dtype=torch.bfloat16)
        dagg = torch.randn((BIG_NODES, c, nb), generator=g, device=dev)
        out = fe.mp_forward(params, alg, h, hj, None, dst, None, False)
        dh, dhj, _, _ = fe.mp_backward(params, alg, h, hj, None, dst, None,
                                       dagg, False)
        out, dh, dhj = out[base:], dh[base:], dhj[e0:]
        sub = (h[base:], hj[e0:], None, (dst[e0:] - base).contiguous())
        out2 = fe.mp_forward(params, alg, *sub, None, False)
        dh2, dhj2, _, _ = fe.mp_backward(params, alg, *sub, None,
                                         dagg[base:].contiguous(), False)
        torch.cuda.synchronize()
        for name, a, b in (("K4 sums", out, out2), ("K5 d(h)", dh, dh2),
                           ("K5 d(h_j)", dhj, dhj2)):
            same_upper(name, a, b)

    def blocks(exact):
        # a row tile boundary of every K2/K3 instance (16 or 64 rows)
        r0 = (int(BIG_EDGES * 0.7) // 64) * 64
        mode = "exact" if exact else "fast"
        x = torch.randn((BIG_EDGES, c, nb), generator=g, device=dev)
        out = ck.block_forward(x, params[:10], alg, exact)[r0:]
        same_upper(f"K2 {mode}", out,
                   ck.block_forward(x[r0:], params[:10], alg, exact))
        del out
        dout = torch.randn((BIG_EDGES, c, nb), generator=g, device=dev)
        dx = ck.block_backward(x, dout, params[:10], alg, exact)[0][r0:]
        dx2 = ck.block_backward(x[r0:], dout[r0:], params[:10], alg,
                                exact)[0]
        same_upper(f"K3 {mode} d(x)", dx, dx2)

    def segments(exact):
        data = torch.randn((BIG_EDGES, c * nb), generator=g, device=dev)
        out = sk.sorted_segment_sum(data, dst, BIG_NODES, exact)[0][base:]
        alone = sk.sorted_segment_sum(data[e0:], (dst[e0:] - base)
                                      .contiguous(), BIG_NODES - base,
                                      exact)[0]
        same_upper(f"K1 {'exact' if exact else 'fast'}", out, alone)

    for run in (fused, lambda: blocks(False), lambda: blocks(True),
                lambda: segments(False), lambda: segments(True)):
        run()
        torch.cuda.empty_cache()


def phase_streaming(dev, counters):
    """S5a: the streamed EGCL layer against the unstreamed one (fast and
    exact), K1-K5 past 2**31 elements, then the reference's 10M-simplex,
    80M-edge workload through csmpn_torch.bench_scaling.main: its line,
    host times, step time, peak memory, launches a step, a profiled
    step."""
    from csmpn_torch import bench_scaling

    print(f"streaming (S5a): the layer streamed in {S_CHUNKS} chunks vs "
          f"unstreamed on the card: {S_NODES} simplices, in-degree "
          f"{S_DEGREE}, hidden {S_HID}")
    bitwise = {m: stream_compare(dev, counters, m) for m in ("fast", "exact")}
    torch.cuda.empty_cache()
    stream_offsets(dev)
    torch.cuda.empty_cache()
    print(f"streaming via csmpn_torch.bench_scaling.main "
          f"{' '.join(STREAM_ARGV)} (fwd+bwd, fast)")
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    res = bench_scaling.main(STREAM_ARGV)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: c.count for k, c in counters.items()}
    print(f"  {card_line()}")
    print(f"  host: complex {res['complex_s']:.2f} s, partition "
          f"{res['partition_s']:.2f} s; first step {res['first_step_s']:.2f}"
          f" s; the entry point {run_s:.1f} s")
    print(f"  step {res['step_s']:.4f} s, {res['line']['value']} edges/s, "
          f"peak {res['peak_gb']} GiB (max_memory_allocated)")
    print(f"  launches during the run: {launches}")
    for k in ("k2", "k3", "k4", "k5"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the "
                                 f"streaming path")
    step = res["step"]
    for c in counters.values():
        c.reset()
    step()
    torch.cuda.synchronize()
    per_step = {k: c.count for k, c in counters.items()}
    print(f"  launches per step: {per_step} (expected {STREAM_PER_STEP})")
    if per_step != STREAM_PER_STEP:
        raise AssertionError(f"streaming launches a step {per_step} != "
                             f"{STREAM_PER_STEP}")
    grads = [p.grad for p in res["egcl"].parameters()]
    if not all(torch.isfinite(gr).all().item() for gr in grads):
        raise AssertionError("streaming parameter gradients not finite")
    busy_ms, wall_ms, kernels, runs = phase_profile(step, steps=1)
    rest = dict(kernels)
    for label, pattern in STREAM_KERNELS:
        names = [k for k in rest if re.search(pattern, k)]
        ms = sum(rest.pop(k) for k in names)
        n = sum(runs[k] for k in names)
        print(f"    {label:<30s} {ms:10.3f} ms  {100 * ms / busy_ms:5.1f}% "
              f"of busy  {n:6.0f} runs")
    print(f"    {'other':<30s} {sum(rest.values()):10.3f} ms  "
          f"{100 * sum(rest.values()) / busy_ms:5.1f}% of busy")
    agg_gib = res["n_nodes"] * S_HID * 8 * 4 / 2**30
    peak = res["peak_gb"]
    del res, step, grads
    torch.cuda.empty_cache()
    print(f"streaming forward only via csmpn_torch.bench_scaling.main "
          f"{' '.join(STREAM_FWD_ARGV)}")
    torch.cuda.reset_peak_memory_stats(dev)
    fwd = bench_scaling.main(STREAM_FWD_ARGV)
    print(f"  {card_line()}")
    print(f"  forward step {fwd['step_s']:.4f} s, {fwd['line']['value']} "
          f"edges/s, peak {fwd['peak_gb']} GiB; fwd+bwd peak {peak} GiB, "
          f"the aggregates {agg_gib:.2f} GiB")
    if not math.isfinite(float(fwd["line"]["value"])) \
            or fwd["peak_gb"] > peak - agg_gib:
        raise AssertionError(f"forward only: peak {fwd['peak_gb']} GiB not "
                             f"{agg_gib:.2f} below fwd+bwd {peak}")
    del fwd
    torch.cuda.empty_cache()
    return launches, per_step, bitwise


# ------------------------ S5c: edge-partitioned message passing across cards

# the world-1 comparisons: 262,144 simplices, in-degree 16, hidden 32; the
# streamed forms in 16 chunks as phase_streaming's; 4 shards on one card
SH_NODES, SH_DEGREE, SH_CHUNKS, SH_SHARDS = 262_144, 16, 16, 4
# the two exchanges' layers and the flat layer (or the streamed layers),
# world 1: outputs, d(h) and parameter gradients, relative to the largest
# magnitude.  Exact: the same composed route over the same rows in the
# same order, expected bitwise; the limits are fp32 order (a chunk's or a
# shard's padded edges lengthen its last node's K1 segment).  Fast: K2/K3
# and K1 against K4/K5 (the flat layer), the limits of K4 and K5 against
# their composed route; the streamed forms run the same kernels on the
# same chunks and keep the exact limits
SHARD_TOL = {"exact": {"out": 1e-6, "h_grad": 1e-4, "param_grad": 1e-4},
             "fast": {"out": 1e-2, "h_grad": 3e-2, "param_grad": 3e-2}}
# wrapper launches of one layer step of the exchanges' layers with d(h):
# K2 the edge and node CEMLPs' two blocks, K3 the same backward, K1 the
# aggregation and the two gathers' backward; without d(h) (the sweep) K1
# the aggregation alone.  The streamed forms: STREAM_CMP_PER_STEP
SHARD_PER_STEP = {"k1": 3, "k2": 4, "k3": 4, "k4": 0, "k5": 0}
SWEEP_PER_STEP = {"k1": 1, "k2": 4, "k3": 4, "k4": 0, "k5": 0}
# the mesh sweep through its entry point at the comparisons' size (exact,
# its default: the composed route holds every edge's rows at once)
SWEEP_ARGV = ["--mesh-list", "1", "--simplices", str(SH_NODES), "--degree",
              str(SH_DEGREE), "--steps", "3", "--device=cuda"]
# the reference's workload through run_sharded_streaming: 10M simplices,
# 80M edges, 64 chunks, fwd+bwd, fast, halo exchange (STREAM_ARGV)
# the host tables of RESULTS.md:44-47 (the reference's virtual 8-device
# run): 8 shards x 8 chunks of the 10M complex at locality 4096; the
# reference printed 49,397 halo rows and 200,704 padded slots
HOST_ARGS = (10_000_000, 8, 4096, 8, 8)
HOST_REFERENCE = (49_397, 200_704)


def shards_on_one_card(egcl, h, part, node_attr=None, edge_attr=None):
    """The shard body of each shard of the HaloPartition ``part`` on h's
    device, one shard after another, its [h_local | halo] taken by
    indexing the full ``h`` (slot (o, p) of shard s's halo is row o * nps
    + send_idx[o, s, p], zero where unsent) and its tables from
    ``ShardArrays``; ``edge_attr`` in slab order.  Returns the shards'
    outputs concatenated; autograd carries each halo row's cotangent back
    to the row it was taken from, as the exchange's backward does."""
    from csmpn_torch.parallel.edge_partition import (
        ShardArrays, egcl_shard_body)

    n, nps, e2 = part.n_shards, part.nodes_per_shard, part.e_shard
    base = torch.arange(n, device=h.device)[:, None] * nps
    outs = []
    for s in range(n):
        tabs = ShardArrays(part, s, n, h.device)
        rows = base + torch.from_numpy(part.send_idx[:, s]).to(h.device)
        sent = torch.from_numpy(part.send_mask[:, s]).to(h.device)
        halo = torch.where(sent.reshape(-1, 1, 1),
                           h.index_select(0, rows.reshape(-1)), 0.0)
        own = slice(s * nps, (s + 1) * nps)
        src, dst, mask = tabs.local.chunk(0)
        outs.append(egcl_shard_body(
            egcl, h[own], torch.cat([h[own], halo.to(h.dtype)]), src, dst,
            mask, None if node_attr is None else node_attr[own],
            None if edge_attr is None else edge_attr[s * e2:(s + 1) * e2]))
    return torch.cat(outs)


def compare_grads(tag, got, ref, tol):
    """Output, d(h) and every parameter gradient of ``got`` against
    ``ref`` (each (out, dh, [grads])); prints whether each is bitwise
    equal."""
    same = [torch.equal(got[0], ref[0]), torch.equal(got[1], ref[1]),
            all(torch.equal(a, b) for a, b in zip(got[2], ref[2]))]
    print(f"  {tag}: bitwise equal: output {same[0]}, d(h) {same[1]}, "
          f"parameter gradients {same[2]}")
    check(f"{tag}: output", got[0], ref[0], tol["out"])
    check(f"{tag}: d(h)", got[1], ref[1], tol["h_grad"])
    worst = max(rel_err(a, b)[1] for a, b in zip(got[2], ref[2]))
    ok = worst <= tol["param_grad"] and all(
        torch.isfinite(a).all().item() for a in got[2])
    print(f"  {tag}: parameter gradients, worst rel {worst:.3e}  tol "
          f"{tol['param_grad']:.0e}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: parameter gradients {worst}")
    return all(same)


def sharded_compare(dev, counters, mode):
    """World 1 on the card, in ``mode``: the halo and all-gather layers
    against the flat EGCL layer, the two streamed forms against
    streaming_egcl_apply on the same chunks, then the shard bodies of a
    4-shard halo partition on one card against the world-1 halo layer;
    the launches of each form's step."""
    from csmpn_torch.algebra import get_algebra
    from csmpn_torch.nn.egcl import EGCL
    from csmpn_torch.nn.modules import init_parameters
    from csmpn_torch.ops.segment import set_aggregation_mode
    from csmpn_torch.parallel import edge_partition as ep

    set_aggregation_mode(mode)
    tol = SHARD_TOL[mode]
    ei = ep.make_synthetic_complex(SH_NODES, SH_DEGREE, seed=0)
    layer = EGCL(get_algebra((1.0, 1.0, 1.0)), S_HID, S_HID, S_HID,
                 aggr="mean")
    init_parameters(layer, torch.Generator().manual_seed(3))
    layer = layer.to(dev)
    gen = torch.Generator(dev).manual_seed(3)
    h = torch.randn((SH_NODES, S_HID, 8), generator=gen, device=dev)
    g = torch.randn((SH_NODES, S_HID, 8), generator=gen, device=dev)

    def grads(run, want=None, tag=""):
        for c in counters.values():
            c.reset()
        hh = h.clone().requires_grad_(True)
        layer.zero_grad(set_to_none=True)
        out = run(hh)
        (out * g).sum().backward()
        torch.cuda.synchronize()
        per_step = {k: c.count for k, c in counters.items()}
        if want is not None:
            print(f"  {tag}: launches of a step {per_step} (expected "
                  f"{want})")
            if per_step != want:
                raise AssertionError(f"{tag}: launches {per_step} != "
                                     f"{want}")
        return (out.detach(), hh.grad,
                [p.grad.clone() for p in layer.parameters()])

    ei_t = torch.from_numpy(ei).to(dev)
    flat = grads(lambda hh: layer(hh, ei_t))
    forms = {"halo": (ep.partition_edges_halo, ep.sharded_egcl_apply_halo),
             "allgather": (ep.partition_edges, ep.sharded_egcl_apply)}
    bitwise = {}
    halo1 = None
    for form, (build, apply) in forms.items():
        part = build(ei, SH_NODES, 1)
        arrays = ep.ShardArrays(part, 0, 1, dev)
        got = grads(lambda hh: apply(layer, hh, part, arrays=arrays),
                    SHARD_PER_STEP, f"{mode} {form}")
        bitwise[form] = compare_grads(f"{mode} {form} vs the flat layer",
                                      got, flat, tol)
        halo1 = got if form == "halo" else halo1
        del got, arrays
    del flat
    part = ep.partition_edges(ei, SH_NODES, SH_CHUNKS)
    arrays = ep.StreamArrays.of(part, dev)
    streamed = grads(lambda hh: ep.streaming_egcl_apply(layer, hh, part,
                                                        arrays=arrays))
    del arrays
    stream_forms = {
        "stream_halo": (lambda: ep.partition_edges_halo_stream(
            ei, SH_NODES, 1, SH_CHUNKS), ep.sharded_streaming_egcl_apply),
        "stream_allgather": (lambda: ep.partition_edges(
            ei, SH_NODES, SH_CHUNKS),
            ep.sharded_streaming_egcl_apply_allgather)}
    for form, (build, apply) in stream_forms.items():
        part = build()
        arrays = ep.ShardArrays(part, 0, 1, dev)
        got = grads(lambda hh: apply(layer, hh, part, arrays=arrays),
                    STREAM_CMP_PER_STEP[mode], f"{mode} {form}")
        bitwise[form] = compare_grads(
            f"{mode} {form} vs streaming_egcl_apply", got, streamed,
            SHARD_TOL["exact"])
        del got, arrays
    del streamed
    part = ep.partition_edges_halo(ei, SH_NODES, SH_SHARDS)
    print(f"  {SH_SHARDS} shards on one card: h_max {part.h_max}, "
          f"{int(part.send_mask.sum())} halo rows")
    got = grads(lambda hh: shards_on_one_card(layer, hh, part))
    bitwise["4 shards"] = compare_grads(
        f"{mode} {SH_SHARDS} shards on one card vs the world-1 halo layer",
        got, halo1, tol if mode == "fast" else SHARD_TOL["exact"])
    return bitwise


def exchange_us(dev, h, part, group=None):
    """The device ops of one exchange of ``h`` over the partition's tables
    alone, under the profiler: µs by name (NCCL kernels, copies, the
    halo's gathers and scatters)."""
    from torch.profiler import ProfilerActivity, profile
    from csmpn_torch.parallel import edge_partition as ep

    arrays = ep.ShardArrays(part, 0, 1, dev)
    ep.exchange(h, arrays, group)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ep.exchange(h, arrays, group)
        torch.cuda.synchronize()
    return {e.key[:50]: round(e.self_device_time_total, 2)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("nccl:")}


def phase_sharded(dev, counters):
    """S5c in an NCCL group of one (this process, rank 0 of 1): the
    world-1 comparisons in both modes, then the entry points: the mesh
    sweep (mesh size 1) in both exchanges, and run_sharded_streaming at
    the reference's 10M-simplex, 80M-edge workload (its line, host times,
    peak, launches a step, a profiled step, the exchanges' NCCL device
    time); then the 8 x 8 host tables of the 10M complex at locality
    4096.  The group is destroyed at the end.  Returns (the launches of
    the entry points, the streamed step's launches, the comparisons'
    bitwise flags)."""
    import numpy as np
    import torch.distributed as dist
    from csmpn_torch import bench_scaling
    from csmpn_torch.parallel import edge_partition as ep
    from csmpn_torch.parallel.mesh import Mesh

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        print(f"sharded (S5c): world 1 in an NCCL group of one; {SH_NODES} "
              f"simplices, in-degree {SH_DEGREE}, hidden {S_HID}")
        bitwise = {m: sharded_compare(dev, counters, m)
                   for m in ("exact", "fast")}
        torch.cuda.empty_cache()
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        sweeps = {}
        for ex in ("halo", "allgather"):
            print(f"the mesh sweep via csmpn_torch.bench_scaling.main "
                  f"{' '.join(SWEEP_ARGV)} --exchange {ex}")
            sweeps[ex] = bench_scaling.main(SWEEP_ARGV + ["--exchange", ex])
            torch.cuda.synchronize()
        print(f"sharded streaming via csmpn_torch.bench_scaling."
              f"run_sharded_streaming {' '.join(STREAM_ARGV)} (fwd+bwd, "
              f"fast, halo)")
        args = bench_scaling.parse_args(STREAM_ARGV)
        res = bench_scaling.run_sharded_streaming(args, Mesh(0, 1, dev))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {k: c.count for k, c in counters.items()}
        print(f"  {card_line()}")
        print(f"  launches during the entry points ({run_s:.1f} s): "
              f"{launches}")
        for k in counters:
            if launches[k] <= 0:
                raise AssertionError(f"kernel {k} never launched on the "
                                     f"sharded path")
        for ex, sw in sweeps.items():
            line = sw["sizes"][1]["line"]
            print(f"  sweep {ex}: {line['value']} edges/s, step "
                  f"{sw['sizes'][1]['step_s']:.4f} s, peak "
                  f"{sw['sizes'][1]['peak_gb']} GiB, loss "
                  f"{float(sw['sizes'][1]['loss']):.8f}")
            for c in counters.values():
                c.reset()
            sw["sizes"][1]["step"]()
            torch.cuda.synchronize()
            per = {k: c.count for k, c in counters.items()}
            print(f"  sweep {ex}: launches a step {per} (expected "
                  f"{SWEEP_PER_STEP})")
            if per != SWEEP_PER_STEP:
                raise AssertionError(f"sweep {ex}: launches {per}")
        # the same layer, h and route: the exchanges differ in where the
        # source rows lie
        losses = [float(sw["sizes"][1]["loss"]) for sw in sweeps.values()]
        print(f"  sweep losses, halo / allgather: {losses}")
        if not (math.isfinite(losses[0])
                and abs(losses[0] - losses[1]) <= 1e-6 * abs(losses[0])):
            raise AssertionError(f"the sweep's losses differ: {losses}")
        del sweeps
        torch.cuda.empty_cache()
        print(f"  host: complex {res['complex_s']:.2f} s, partition "
              f"{res['partition_s']:.2f} s; first step "
              f"{res['first_step_s']:.2f} s")
        print(f"  step {res['step_s']:.4f} s, {res['line']['value']} "
              f"edges/s, peak {res['peak_gb']} GiB (max_memory_allocated)")
        step = res["step"]
        for c in counters.values():
            c.reset()
        step()
        torch.cuda.synchronize()
        per_step = {k: c.count for k, c in counters.items()}
        print(f"  launches per step: {per_step} (expected "
              f"{STREAM_PER_STEP})")
        if per_step != STREAM_PER_STEP:
            raise AssertionError(f"sharded streaming launches a step "
                                 f"{per_step} != {STREAM_PER_STEP}")
        grads = [p.grad for p in res["egcl"].parameters()]
        if not all(torch.isfinite(gr).all().item() for gr in grads):
            raise AssertionError("sharded streaming parameter gradients "
                                 "not finite")
        busy_ms, wall_ms, kernels, runs = phase_profile(step, steps=1)
        n_nccl, nccl_us = nccl_per_step(kernels, runs)
        names = [n[:60] for n in runs if re.search(NCCL_KERNEL, n)]
        print(f"  NCCL kernels in the profiled step: {n_nccl:.0f}, "
              f"{nccl_us:.2f} us ({names})")
        h = res["h"]
        # an edge-less partition of the nodes: the all-gather's tables
        for ex, part in (("halo", res["part"]),
                         ("allgather", ep.partition_edges(
                             np.zeros((2, 0), np.int64), h.shape[0], 1))):
            us = exchange_us(dev, h, part)
            nccl = sum(v for k, v in us.items() if re.search(NCCL_KERNEL, k))
            print(f"  the {ex} exchange of the 10M h alone: "
                  f"{sum(us.values()):.2f} us of device ops, "
                  f"{nccl:.2f} of them NCCL kernels: {us}")
        del res, step, grads, h
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    n, deg, loc, shards, chunks = HOST_ARGS
    t0 = time.perf_counter()
    ei = ep.make_synthetic_complex(n, deg, seed=0, locality=loc)
    t1 = time.perf_counter()
    part = ep.partition_edges_halo_stream(ei, n, shards, chunks)
    t2 = time.perf_counter()
    rows = int(part.send_mask.sum())
    slots = shards * shards * part.h_max
    print(f"host tables: {shards} shards x {chunks} chunks of {n} simplices "
          f"at locality {loc}: complex {t1 - t0:.2f} s, partition "
          f"{t2 - t1:.2f} s; {rows} halo rows, {slots} padded slots "
          f"(h_max {part.h_max}, e_chunk {part.e_chunk}); the reference's "
          f"record {HOST_REFERENCE[0]} and {HOST_REFERENCE[1]}")
    del ei, part
    return launches, per_step, bitwise


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; a CUDA card "
              "is required", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import csmpn_torch  # noqa: F401  (fails outside a checkout)
    from csmpn_torch.ops import _build
    from csmpn_torch.ops import cemlp_kernel as ck
    from csmpn_torch.ops import fused_egcl as fe
    from csmpn_torch.ops import segment_kernel as sk

    t_start = time.time()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    dt = _build.build_all()
    print(f"kernel build: {dt:.1f} s (nvcc, {len(_build.SOURCES)} sources "
          f"in parallel)")
    for name in _build.SOURCES:
        fn = ""
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                fn = kernel_name(line)
            elif ("registers" in line or "spill" in line
                  or "Performance Loss" in line):
                print(f"  {name}.cu {fn}: {line.split(':', 1)[-1].strip()}")
    print_dense_smem()
    print_k2_widths()
    print_pair_smem(PAIR_SMEM_SHAPES)
    print_pair_fwd_widths()
    print_k4_widths()
    print_pair_fused_widths()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    results = {}
    motion_counters = {"k1": sk.LAUNCHES, "k2": ck.FWD_LAUNCHES,
                       "k3": ck.BWD_LAUNCHES}
    counters = dict(motion_counters, k4=fe.FWD_LAUNCHES, k5=fe.BWD_LAUNCHES)
    hulls_counters = {"k1": sk.LAUNCHES, "k2p": ck.PAIR_FWD_LAUNCHES,
                      "k3p": ck.PAIR_BWD_LAUNCHES}
    nba_counters = {"k1": sk.LAUNCHES, "k2_cl2": ck.CL2_FWD_LAUNCHES,
                    "k3_cl2": ck.CL2_BWD_LAUNCHES}
    cl2_counters = dict(nba_counters, k4_cl2=fe.CL2_FWD_LAUNCHES,
                        k5_cl2=fe.CL2_BWD_LAUNCHES)
    cl5_counters = dict(hulls_counters, k4p=fe.PAIR_FWD_LAUNCHES,
                        k5p=fe.PAIR_BWD_LAUNCHES)
    cl4_counters = {"k1": sk.LAUNCHES, "k2p_cl4": ck.PAIR_CL4_FWD_LAUNCHES,
                    "k3p_cl4": ck.PAIR_CL4_BWD_LAUNCHES,
                    "k4p_cl4": fe.PAIR_CL4_FWD_LAUNCHES,
                    "k5p_cl4": fe.PAIR_CL4_BWD_LAUNCHES}
    cl5_pair = {k: c for k, c in cl5_counters.items() if k != "k1"}
    runs = {"envelope": (phase_envelope(dev, results), None)}
    graph_times = {}
    with tempfile.TemporaryDirectory() as dataroot:
        real = motion_ids(dataroot, dev)
        phase_k1(dev, gen, results, real)
        phase_cemlp(dev, gen, results)
        phase_fused(dev, gen, results)
        phase_fused_time(dev, results)
        phase_fused_cl2(dev, gen, results)
        phase_fused_time(dev, results, 2, ("k4_cl2", "k5_cl2"))
        phase_fused_pair(dev, gen, results)
        phase_fused_time(dev, results, 5, ("k4p", "k5p"))
        phase_fused_pair_cl4(dev, gen, results)
        phase_fused_time(dev, results, 4, ("k4p_cl4", "k5p_cl4"))
        phase_block_cl4(dev, gen, results)
        runs["layer_options"] = (phase_layer_options(dev, counters), None)
        phase_model(dev, dataroot)
        for tag, (res, graph) in (
                ("motion", phase_task(dataroot, motion_counters, runs)),
                ("hulls", phase_hulls(dev, gen, results, dataroot,
                                      hulls_counters)),
                ("nba", phase_nba(dev, gen, results, dataroot,
                                  nba_counters)),
                ("md17", phase_md17(dev, gen, results, dataroot,
                                    motion_counters))):
            runs[tag] = res[:2]
            runs[f"{tag}_graph"] = graph[:2]
            graph_times[tag] = (res[2:5], graph[2:])
            if tag == "motion":
                runs["sweep"] = phase_sweep(dataroot, motion_counters,
                                            res[6])
                runs["dp"], runs["dp_graph"] = phase_data_parallel(
                    dataroot, motion_counters, res)[:2]
        phase_tile_instances(dev, gen, results)
        phase_pair_tile_instances(dev, gen, results)
        phase_pair_fused_instances(dev, gen, results)
    runs["bench"] = phase_bench(counters)[:2]
    runs["bench_cl2"] = phase_bench(cl2_counters, 2, BENCH_CL2_PER_STEP)[:2]
    runs["bench_cl5"] = phase_bench(cl5_counters, 5, BENCH_CL5_PER_STEP)[:2]
    runs["bench_cl4"] = phase_bench(cl4_counters, 4, BENCH_CL4_PER_STEP,
                                    idle=cl5_pair)[:2]
    runs["stream"] = phase_streaming(dev, counters)[:2]
    runs["sharded"] = phase_sharded(dev, counters)[:2]
    # each kernel's launches on the path that runs it (the bench for
    # K1-K5, hulls for K2p/K3p, NBA for K2/K3 at Cl(2), the bench at
    # Cl(2), Cl(5) and Cl(4) for K4/K5 at Cl(2), K4p/K5p and the Cl(4)
    # pair kernels, the probe's own run for P1-P3, which has no training
    # step), the other paths' beside them
    home = {"k2p": "hulls", "k3p": "hulls", "k2_cl2": "nba",
            "k3_cl2": "nba", "k4_cl2": "bench_cl2", "k5_cl2": "bench_cl2",
            "k4p": "bench_cl5", "k5p": "bench_cl5",
            **{k: "bench_cl4" for k in ("k2p_cl4", "k3p_cl4", "k4p_cl4",
                                        "k5p_cl4")},
            "p1": "envelope", "p2": "envelope", "p3": "envelope"}
    kernels = []
    for k in ("k1", "k2", "k3", "k4", "k5", "k2p", "k3p", "k2_cl2",
              "k3_cl2", "k4_cl2", "k5_cl2", "k4p", "k5p", "k2p_cl4",
              "k3p_cl4", "k4p_cl4", "k5p_cl4", "p1", "p2", "p3"):
        entry = dict(results[k])
        own = home.get(k, "bench")
        entry["launches"] = runs[own][0][k]
        if runs[own][1] is not None:
            entry["launches_per_step"] = runs[own][1][k]
        for tag, (lc, ps) in runs.items():
            if tag != own and k in lc:
                entry[f"launches_{tag}"] = lc[k]
                if ps is not None:
                    entry[f"launches_per_step_{tag}"] = ps[k]
        kernels.append(entry)
    print_graph_times(graph_times)
    print(f"total {time.time() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
