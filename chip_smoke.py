"""Smoke run of csmpn_torch on one CUDA card (an H100).

    python3 chip_smoke.py            # from the root of a checkout

1. prints the card (nvidia-smi name and power limit) and builds the CUDA
   kernels from csmpn_torch/csrc, all sources in parallel, with each
   kernel's registers and spills; shows that the fast-mode row tile
   kernels take at every C at least the inputs their exact-mode row
   kernels take: the backwards of the dense form (K3 and K5) and of the
   pair form (K3p at Cl(5) and Cl(4)), the pair form's forward (K2p) and
   the dense fused forward (K4 at Cl(3) and Cl(2), whose fast mode sums
   sub-windows where a window's sum does not fit);
2. the envelope probe (P1 copy, P2 resident matrix product in bf16 and
   tf32 on the tensor cores and fp32 FFMA, P3 FMA chain): each kernel
   against its plain version at tools/mxu_probe.py's sizes (P1 bitwise at
   every tile height), two launches bitwise equal, then the probe through
   its entry point with its launches counted, the plain and library
   times, the bounds, and the measured envelope against the data sheet;
   every later bound is also given against that envelope;
3. holds each kernel against its plain PyTorch version on the card, in
   exact and fast mode, with stated tolerances: K1 (bf16 and fp32 rows,
   sum and masked mean, on the real batch's ids, with a sentinel tail,
   and on synthetic ids; bitwise repeatable) at the motion widths D = 224
   and 24 and, in the later phases, at every task's and every bench
   algebra's width (160, 256, 896, 448), timed beside
   torch.segment_reduce; K2 and K3 at the
   motion task's shapes and K2/K3 at the bench widths; K4 and K5 (fused
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
5. checks the full-width motion model on the card against the same model
   on the CPU (loss and every gradient, exact mode);
6. runs the motion task through its entry point (fire -> run_task ->
   Trainer.fit) at the configs/motion.yaml widths for 8 training steps in
   the default fast precision, shows that K1, K2 and K3 ran, counts their
   launches in one training step and profiles a few steps' device time;
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
   modes where the exact mode takes the shape; and K3p at Cl(5) and Cl(4)
   at one shape of each instance of its fast-mode row tiles (16, 24, 32
   weight-gradient tiles a warp) and at its widest C, and K2p at C_MIN and
   its widest C (each at the widest input its exact mode takes), over
   1,001 rows;
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
11. prints the kernels JSON line (twenty kernels) and, last, the device
    JSON line.

Any failed check raises, so the script exits non-zero and prints no
result line.  It needs one card and imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import io
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
# copy bandwidth, bytes/s), "bf16" (P2's bf16 mma.sync rate) and "fp32"
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

    print("K3 and K5 vs plain at one shape of each tile kernel instance")
    rng = np.random.RandomState(5)
    dst = np.sort(rng.randint(0, 1001, size=5003))
    chunked = False
    for dim, kb, kf, keys in ((3, ck.DENSE, fe.DENSE, ("k4", "k5")),
                              (2, ck.DENSE_CL2, fe.DENSE_CL2,
                               ("k4_cl2", "k5_cl2"))):
        alg = get_algebra((1.0,) * dim)
        k3key = "k3" if dim == 3 else "k3_cl2"
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
    kernel's name (lower-case words ending in '_kernel', which no digit of
    the mangled prefix can join), its algebra (Cl2E ... Cl5E), its bool
    (Lb0E / Lb1E) and int (Li16E) template arguments, in their order."""
    m = re.search(r"([a-z]+(?:_[a-z]+)*_kernel)(I\w*?Ev)?", ptxas_line)
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

def phase_envelope(dev, results):
    """P1-P3 against their plain versions at the envelope probe's default
    sizes (P1 bitwise at every tile height), two launches bitwise equal;
    then the probe through its entry point with every count set to 0 just
    before and read just after, the plain versions' times, the bounds, and
    the measured envelope, which sets ENVELOPE.  Returns the launches."""
    from csmpn_torch.ops import probe_kernels as pk
    from csmpn_torch.tools import envelope_probe as ep

    print("P1-P3 (envelope probe) vs plain at tools/mxu_probe.py's sizes")
    reps = 32
    x, a, b, v = (t.to(dev) for t in ep.inputs())
    ref = pk.copy_scale_plain(x)
    for tile in ep.TILES:
        out, again = pk.copy_scale(x, tile), pk.copy_scale(x, tile)
        if not (torch.equal(out, ref) and torch.equal(out, again)):
            raise AssertionError(f"P1 tile {tile}: not x * 2 bit for bit, or "
                                 f"two launches differ")
    print(f"  P1 copy (131072 x 256 fp32), tiles {ep.TILES}: bitwise equal "
          f"to x * 2, two launches bitwise equal")
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
          f"mma.sync "
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
        shape=f"M, K, N = 512, 256, 2048, {reps} reps; bf16 (mma.sync), "
              f"tf32 (mma.sync), fp32 (FFMA)")
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
            ref = ck.block_forward_plain(x, params, alg, exact)
            e2[mode].append(check(f"K2 {name} {mode}", out, ref,
                                  TOL[f"k2_{mode}"]))
            del out, ref
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


# ------------------------------------------------------- the task itself

def phase_task(dataroot, counters):
    from csmpn_torch.data.motion import MotionDataset
    from csmpn_torch.tasks.motion import main

    argv = task_argv("motion", "motion.MotionModel", "motion.MotionDataset", [
        "--model.num_hidden=28", "--model.num_layers=4",
        "--dataset.num_training_samples=200", "--dataset.batch_size=100",
        "--optimizer.lr=5e-4", "--optimizer.weight_decay=1e-4"])
    print("motion task via fire -> run_task -> Trainer.fit: hidden 28, "
          "4 layers, batch 100, 8 steps, fast precision")
    os.environ["DATAROOT"] = dataroot
    with contextlib.redirect_stdout(io.StringIO()):
        ds = MotionDataset(batch_size=100, num_training_samples=200)
    return run_entry(main, argv, dataroot, counters, ds)


def task_argv(task, model, dataset, extra):
    return [f"csmpn_torch/tasks/{task}.py",
            "--trainer.module=csmpn_torch.engineer.Trainer",
            f"--dataset.module=csmpn_torch.data.{dataset}",
            "--optimizer.module=csmpn_torch.engineer.optim.adam",
            f"--model.module=csmpn_torch.models.{model}",
            "--trainer.max_steps=8", "--trainer.val_check_interval=4",
            "--trainer.limit_val_batches=1", "--trainer.print_interval=1",
            "--trainer.log_interval=4", "--device=cuda", *extra]


def check_per_step(per_step, want, tag):
    for k, n in want.items():
        if per_step[k] != n:
            raise AssertionError(f"{k} launches per {tag} step "
                                 f"{per_step[k]} != {n}")


def run_entry(main, argv, dataroot, counters, ds, steps=8):
    """Runs a task's entry point (fire -> run_task -> Trainer.fit) with
    every launch count set to 0 just before and read just after, checks
    its ``steps`` training losses, then counts the launches of one more
    training step on a batch of ``ds`` and profiles a few steps.  Returns
    (launches in the run, launches per step, median step ms, busy ms,
    profiled wall ms)."""
    from csmpn_torch.engineer.fire import fire

    os.environ["DATAROOT"] = dataroot
    os.environ["RUNDIR"] = os.path.join(dataroot, "runs")
    for c in counters.values():
        c.reset()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        trainer = fire(main, argv)
    torch.cuda.synchronize()
    launches = {k: c.count for k, c in counters.items()}
    text = buf.getvalue()
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
    busy_ms, wall_ms = phase_profile(step)
    return launches, per_step, step_ms, busy_ms, wall_ms


def phase_profile(step, steps=3):
    """Device busy time over a few training steps (torch.profiler), and
    the kernels that take it.  ``step`` runs one step and reads its loss
    back."""
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
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith("Optimizer.")]  # annotation spans
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    n_launch = sum(e.count for e in events) / steps
    print(f"  profile of {steps} steps: wall {wall_ms:.2f} ms/step, device "
          f"busy {busy_ms:.2f} ms/step ({100 * busy_ms / wall_ms:.1f}%), "
          f"{n_launch:.0f} device ops/step")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"    {e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
              f"{e.count // steps:5d}x  {e.key[:70]}")
    return busy_ms, wall_ms


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
    return res


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
    return res


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
    return res


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

    busy_ms, wall_ms = phase_profile(step)

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
            elif "registers" in line or "spill" in line:
                print(f"  {name}.cu {fn}: {line.split(':', 1)[-1].strip()}")
    print_dense_smem()
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
        phase_model(dev, dataroot)
        runs["motion"] = phase_task(dataroot, motion_counters)[:2]
        runs["hulls"] = phase_hulls(dev, gen, results, dataroot,
                                    hulls_counters)[:2]
        runs["nba"] = phase_nba(dev, gen, results, dataroot,
                                nba_counters)[:2]
        runs["md17"] = phase_md17(dev, gen, results, dataroot,
                                  motion_counters)[:2]
        phase_tile_instances(dev, gen, results)
        phase_pair_tile_instances(dev, gen, results)
        phase_pair_fused_instances(dev, gen, results)
    runs["bench"] = phase_bench(counters)[:2]
    runs["bench_cl2"] = phase_bench(cl2_counters, 2, BENCH_CL2_PER_STEP)[:2]
    runs["bench_cl5"] = phase_bench(cl5_counters, 5, BENCH_CL5_PER_STEP)[:2]
    runs["bench_cl4"] = phase_bench(cl4_counters, 4, BENCH_CL4_PER_STEP,
                                    idle=cl5_pair)[:2]
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
                entry[f"launches_per_step_{tag}"] = ps[k]
        kernels.append(entry)
    print(f"total {time.time() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
