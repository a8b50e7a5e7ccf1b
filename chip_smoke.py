"""Smoke run of csmpn_torch on one CUDA card (an H100).

    python3 chip_smoke.py            # from the root of a checkout

1. prints the card (nvidia-smi name and power limit) and builds the CUDA
   kernels from csmpn_torch/csrc, all sources in parallel, with each
   kernel's registers and spills;
2. holds each kernel against its plain PyTorch version on the card, in
   exact and fast mode, with stated tolerances: K1, K2 and K3 at the
   motion task's shapes and K2/K3 at the bench widths; K4 and K5 (fused
   message passing) over the bench graph and the stress layouts (empty
   windows, few edges over many windows, masked edges, ragged E and N,
   with and without edge attributes), bitwise repeatable, masked rows of
   d(hj) exactly 0;
3. times each kernel, its plain version, a PyTorch library call where one
   computes the same function, and states the least time the card could
   take (bytes over 3.35 TB/s or operations over the peak rate); for K4
   and K5 also the composed route (gather, edge CEMLP on K2/K3,
   aggregation on K1) computing the same function;
4. checks the full-width motion model on the card against the same model
   on the CPU (loss and every gradient, exact mode);
5. runs the motion task through its entry point (fire -> run_task ->
   Trainer.fit) at the configs/motion.yaml widths for 8 training steps in
   the default fast precision, shows that K1, K2 and K3 ran, counts their
   launches in one training step and profiles a few steps' device time;
6. runs the bench path through its entry point (csmpn_torch.bench.main:
   3 EGCL layers, hidden 32, E = 131,072, N = 8,192, forward + backward +
   Adam), shows that K1-K5 ran and counts their launches in one step,
   profiles a few steps, holds its fast-mode loss to its exact-mode loss,
   and, in fast mode, its loss and every gradient on K4/K5 to the same
   stack on the composed route;
7. prints the kernels JSON line and, last, the device JSON line.

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
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def kernel_name(ptxas_line: str) -> str:
    """'name<flags>' from ptxas's 'Compiling entry function' line: the
    kernel's name (lower-case words ending in '_kernel', which no digit of
    the mangled prefix can join) and its bool template arguments (Lb0E /
    Lb1E)."""
    m = re.search(r"([a-z]+(?:_[a-z]+)*_kernel)(I\w*?Ev)?", ptxas_line)
    if m is None:
        return ptxas_line.strip()[-40:]
    flags = re.findall(r"Lb([01])E", m.group(2) or "")
    return m.group(1) + (f"<{','.join(flags)}>" if flags else "")


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
    t_b, t_f = bytes_moved / MEM_BW, flops / peak
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# ------------------------------------------------------------------- K1

def k1_inputs(e, n, d, dtype, gen, dev):
    ids = torch.sort(torch.randint(0, n, (e,), generator=gen)).values
    ids[: e // 50] = torch.clamp(ids[: e // 50], max=3)   # empty middle run
    ids = torch.sort(ids).values
    ids[-(e // 40):] = n + 7                               # sentinel tail
    data = torch.randn(e, d, generator=gen).to(dtype)
    mask = torch.rand(e, generator=gen) > 0.1
    return data.to(dev), ids.to(dev), mask.to(dev)


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


def phase_k1(dev, gen, results, real):
    from csmpn_torch.ops import segment_kernel as sk

    print("K1 sorted segment sum vs plain (motion shapes)")
    errs = []
    dst, src_sorted, emask = real
    for ids, m, mean, tag in ((dst, emask, True, "targets, masked mean"),
                              (dst, None, False, "targets, sum"),
                              (src_sorted, None, False, "sources, sum")):
        for d in (HID * 8, 3 * 8):
            for dtype, exact in ((torch.float32, True),
                                 (torch.bfloat16, True),
                                 (torch.float32, False)):
                data = torch.randn(E_TOT, d, generator=gen).to(dtype).to(dev)
                out, cnt = sk.sorted_segment_sum(data, ids, N_TOT, exact, m,
                                                 mean)
                ref, rcnt = sk.segment_sum_plain(data, ids, N_TOT, exact, m,
                                                 mean)
                name = (f"motion {tag} D={d} {str(dtype)[6:]} "
                        f"{'exact' if exact else 'fast'}")
                errs.append(check(name, out, ref, TOL["k1"]))
                check(name + " counts", cnt, rcnt, 0.0)
    for d in (224, 24):
        for dtype, exact in ((torch.float32, True), (torch.float32, False),
                             (torch.bfloat16, True)):
            data, ids, mask = k1_inputs(E_TOT, N_TOT, d, dtype, gen, dev)
            for m, mean in ((None, False), (mask, True)):
                out, cnt = sk.sorted_segment_sum(data, ids, N_TOT, exact, m,
                                                 mean)
                ref, rcnt = sk.segment_sum_plain(data, ids, N_TOT, exact, m,
                                                 mean)
                tag = (f"synthetic D={d} {str(dtype)[6:]} "
                       f"{'exact' if exact else 'fast'} "
                       f"{'masked mean' if mean else 'sum'}")
                errs.append(check(tag, out, ref, TOL["k1"]))
                check(tag + " counts", cnt, rcnt, 0.0)
    # timing at the main path's largest launch: the gradient of h (bf16
    # rows) over the real target ids, E edges into N nodes, D = 28 * 8
    d = HID * 8
    data = torch.randn(E_TOT, d, generator=gen).to(torch.bfloat16).to(dev)
    ids = dst
    ms = time_ms(lambda: sk.sorted_segment_sum(data, ids, N_TOT, False))
    plain = time_ms(lambda: sk.segment_sum_plain(data, ids, N_TOT, False))
    offsets = sk.csr_offsets(ids, N_TOT)
    lengths = (offsets[1:] - offsets[:-1])
    kept = data[: int(offsets[-1])]
    lib = time_ms(lambda: torch.segment_reduce(kept, "sum", lengths=lengths,
                                               axis=0, unsafe=True))
    n_read = int(offsets[-1])
    bytes_moved = n_read * d * 2 + N_TOT * d * 4 + E_TOT * 8
    b_ms, b_by = bound(bytes_moved, n_read * d, FP32_PEAK)
    print(f"  time (motion target ids) E={E_TOT} N={N_TOT} D={d} bf16: "
          f"kernel {ms*1e3:.1f} us"
          f"  plain {plain*1e3:.1f} us  segment_reduce {lib*1e3:.1f} us"
          f"  bound {b_ms*1e3:.1f} us ({b_by})")
    # the node-attribute gathers' backward: D = 3 types * 8 blades, fp32
    attr = torch.randn(E_TOT, 24, generator=gen).to(dev)
    ms24 = time_ms(lambda: sk.sorted_segment_sum(attr, ids, N_TOT, True))
    b24, _ = bound(n_read * 24 * 4 + N_TOT * 24 * 4 + E_TOT * 8, n_read * 24,
                   FP32_PEAK)
    print(f"  time E={E_TOT} N={N_TOT} D=24 fp32: kernel {ms24*1e3:.1f} us"
          f"  bound {b24*1e3:.1f} us; per training step (12 at D={d} bf16,"
          f" 2 at D=24): {12 * ms + 2 * ms24:.3f} ms")
    results["k1"] = dict(
        name="sorted_segment_sum", route="cuda",
        source="csmpn_torch/csrc/segment_sum.cu",
        replaces="csmpn_tpu/ops/pallas_segment.py:33",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib,
        shape=f"E={E_TOT} N={N_TOT} D={d} bf16")


# --------------------------------------------------------------- K2 / K3

def block_inputs(rows, cin, c, gen, dev):
    x = torch.randn(rows, cin, 8, generator=gen)

    def r(*shape, scale=1.0, base=0.0):
        return base + scale * torch.randn(*shape, generator=gen)

    params = [r(c, cin, 4, scale=cin ** -0.5), r(c, 1, scale=0.1),
              r(c, 4, scale=0.2, base=1.0), r(c, 4, scale=0.2),
              r(c, 20, scale=0.5), r(c, c, 4, scale=c ** -0.5),
              r(c, 4, scale=0.5), r(c, c, 4, scale=c ** -0.5),
              r(c, 1, scale=0.1), r(c, scale=0.1, base=1.0)]
    dout = torch.randn(rows, c, 8, generator=gen)
    return x.to(dev), [p.to(dev) for p in params], dout.to(dev)


def block_flops(rows, cin, c):
    per_row = (2 * 8 * c * cin + 2 * 2 * 8 * c * c + 3 * 64 * c
               + 40 * 8 * c)
    return rows * per_row


BLOCK_NAMES = ["linear.weight", "linear.bias", "silu.a", "silu.b",
               "gp.weight", "linear_right.weight", "normalization.a",
               "linear_left.weight", "linear_left.bias", "norm.a"]


def block_bound(rows, cin, c, params, backward):
    """(bound ms, by) of one block launch, fast mode: K2 reads x and writes
    the output; K3 also reads d(out) and writes dx and the gradients."""
    pbytes = sum(p.numel() for p in params) * 4
    f2 = block_flops(rows, cin, c)
    if backward:
        return bound(rows * (2 * cin + c) * 32 + 2 * pbytes, 3 * f2,
                     BF16_PEAK)
    return bound(rows * (cin + c) * 32 + pbytes, f2, BF16_PEAK)


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
    b2, b2by = block_bound(rows, cin, c, params, False)
    b3, b3by = block_bound(rows, cin, c, params, True)
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
        bf, _ = block_bound(rows, cin, c, params, False)
        bb, _ = block_bound(rows, cin, c, params, True)
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
        library_ms=None, shape=shape,
        bench_node_ms=[times["bench_node_block0"][0],
                       times["bench_node_block1"][0]])
    results["k3"] = dict(
        name="cemlp_block_bwd", route="cuda", source="csmpn_torch/csrc/cemlp.cu",
        replaces="csmpn_tpu/ops/cemlp_kernel.py:519",
        max_abs_err=max(e3["exact"]), max_abs_err_fast=max(e3["fast"]),
        ms=bwd, plain_ms=bwd_plain, bound_ms=b3, bound_by=b3by,
        library_ms=None, shape=shape,
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


def edge_params(cin, c, gen, dev):
    """Random parameters of a 2-block edge CEMLP (cin -> c -> c)."""
    _, p1, _ = block_inputs(1, cin, c, gen, dev)
    _, p2, _ = block_inputs(1, c, c, gen, dev)
    return p1 + p2


def phase_fused(dev, gen, results):
    import torch as _t
    from csmpn_torch.algebra import get_algebra
    from csmpn_torch.ops import fused_egcl as fe

    alg = get_algebra((1.0, 1.0, 1.0))
    print("K4 fused message passing forward / K5 backward vs plain")
    errs = {"k4": {"exact": [], "fast": []}, "k5": {"exact": [], "fast": []}}
    for name, dst_np, n, cm, ca, c, masked in fused_layouts():
        e = len(dst_np)
        dst = _t.from_numpy(dst_np.astype("int64")).to(dev)
        mask = ((_t.rand(e, generator=gen) > 0.2).to(dev) if masked
                else None)
        h = _t.randn(n, cm, 8, generator=gen).to(dev)
        hj = _t.randn(e, cm, 8, generator=gen).to(dev)
        attr = _t.randn(e, ca, 8, generator=gen).to(dev) if ca else None
        params = edge_params(cm + ca, c, gen, dev)
        dagg = _t.randn(n, c, 8, generator=gen).to(dev)
        for exact in (True, False):
            mode = "exact" if exact else "fast"
            dt = _t.float32 if exact else _t.bfloat16
            hs, hjs = h.to(dt), hj.to(dt)
            attrs = attr.to(dt) if attr is not None else None
            tag = f"{name} (Cm={cm} Ca={ca} C={c}, E={e} N={n}) {mode}"
            out = fe.mp_forward(params, alg, hs, hjs, attrs, dst, mask, exact)
            ref = fe.message_aggregate_plain(params, alg, hs, hjs, attrs, dst,
                                             mask, False, exact)
            errs["k4"][mode].append(check(f"K4 {tag}", out, ref,
                                          TOL[f"k4_{mode}"]))
            again = fe.mp_forward(params, alg, hs, hjs, attrs, dst, mask,
                                  exact)
            if not _t.equal(out, again):
                raise AssertionError(f"K4 {tag}: two launches differ")
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
                errs["k5"][mode].append(check(f"K5 {tag} {pn}", g, w,
                                              TOL[f"k5_{mode}"]))
                if not _t.equal(g, g2):
                    raise AssertionError(f"K5 {tag} {pn}: two launches "
                                         f"differ")
            if mask is not None:
                off = ~mask
                zero = (got[1][off] == 0).all() and (
                    got[2] is None or (got[2][off] == 0).all())
                if not bool(zero):
                    raise AssertionError(f"K5 {tag}: masked rows of dhj or "
                                         f"dattr are not 0")
        plan = fe.make_plan(dst, mask, n, cm, ca, c)
        print(f"  {name} ({plan.n_win} windows on {plan.grid} CTAs): both "
              f"launches bitwise equal"
              + ("; masked rows of dhj/dattr exactly 0" if masked else ""))
    results["k4"] = dict(
        name="fused_mp_fwd", route="cuda", source="csmpn_torch/csrc/fused_egcl.cu",
        replaces="csmpn_tpu/ops/fused_egcl.py:102",
        max_abs_err=max(errs["k4"]["exact"]),
        max_abs_err_fast=max(errs["k4"]["fast"]))
    results["k5"] = dict(
        name="fused_mp_bwd", route="cuda", source="csmpn_torch/csrc/fused_egcl.cu",
        replaces="csmpn_tpu/ops/fused_egcl.py:405",
        max_abs_err=max(errs["k5"]["exact"]),
        max_abs_err_fast=max(errs["k5"]["fast"]))


def phase_fused_time(dev, results):
    """K4, K5, their plain versions and the composed route at the bench
    shape (E = 131,072, N = 8,192, 32 -> 32, fast mode)."""
    import torch as _t
    from csmpn_torch.algebra import get_algebra
    from csmpn_torch.bench import workload
    from csmpn_torch.nn.egcl import EGCL
    from csmpn_torch.nn.modules import init_parameters
    from csmpn_torch.ops import fused_egcl as fe
    from csmpn_torch.ops.cemlp_kernel import block_params
    from csmpn_torch.ops.segment import (set_aggregation_mode, take_rows,
                                         take_rows_sorted_idx)

    alg = get_algebra((1.0, 1.0, 1.0))
    set_aggregation_mode("fast")
    h, ei, src_sort = workload(dev)
    src, dst = ei[0], ei[1]
    n, e, c = h.shape[0], dst.shape[0], h.shape[1]
    h_s = h.to(_t.bfloat16)
    hj = take_rows(h_s, src)
    # the same edge model for both routes; aggr "sum" so the composed
    # route computes K4's function
    layer = EGCL(alg, c, c, c, aggr="sum")
    init_parameters(layer, _t.Generator().manual_seed(1))
    layer = layer.to(dev)
    params = block_params(layer.edge_model, 0) + block_params(
        layer.edge_model, 1)
    params = [p.detach() for p in params]
    dagg = _t.randn(n, c, 8, device=dev)
    plan = fe.make_plan(dst, None, n, c, 0, c)

    def composed(hh, hhj):
        h_i = take_rows_sorted_idx(hh, dst)
        msg = layer.message(h_i, hhj)
        return layer.aggregate(msg, dst, n)

    print(f"K4/K5 at the bench shape ({plan.n_win} windows on {plan.grid} "
          f"CTAs) vs their plain versions and the composed route, fast")
    with _t.no_grad():
        fused_out = fe.mp_forward(params, alg, h_s, hj, None, dst, None, False,
                                  plan)
        again = fe.mp_forward(params, alg, h_s, hj, None, dst, None, False,
                              plan)
        plain_out = fe.message_aggregate_plain(params, alg, h_s, hj, None, dst,
                                               None, False, False)
        comp_out = composed(h_s, hj)
    results["k4"]["max_abs_err_fast"] = max(
        results["k4"]["max_abs_err_fast"],
        check("K4 vs plain, bench shape", fused_out, plain_out,
              TOL["k4_fast"]))
    check("K4 vs the composed route, bench shape", fused_out, comp_out,
          TOL["k4_fast"])
    if not _t.equal(fused_out, again):
        raise AssertionError("K4 at the bench shape: two launches differ")
    got = fe.mp_backward(params, alg, h_s, hj, None, dst, None, dagg, False,
                         plan)
    again = fe.mp_backward(params, alg, h_s, hj, None, dst, None, dagg, False,
                           plan)
    want = fe.message_aggregate_grad_plain(params, alg, h_s, hj, None, dst,
                                           None, dagg, False)
    names = ["dh", "dhj"] + [f"block{i} d{pn}" for i in (1, 2)
                             for pn in BLOCK_NAMES]
    for pn, g, w, g2 in zip(names, [got[0], got[1]] + got[3],
                            [want[0], want[1]] + want[3],
                            [again[0], again[1]] + again[3]):
        results["k5"]["max_abs_err_fast"] = max(
            results["k5"]["max_abs_err_fast"],
            check(f"K5 vs plain, bench shape, {pn}", g, w, TOL["k5_fast"]))
        if not _t.equal(g, g2):
            raise AssertionError(f"K5 at the bench shape, {pn}: two launches "
                                 f"differ")
    print("  both launches bitwise equal")
    del got, again, want
    k4 = time_ms(lambda: fe.mp_forward(params, alg, h_s, hj, None, dst, None,
                                       False, plan), iters=20)
    k4_plain = time_ms(lambda: fe.message_aggregate_plain(
        params, alg, h_s, hj, None, dst, None, False, False), iters=3,
        warmup=1)
    with _t.no_grad():
        k4_comp = time_ms(lambda: composed(h_s, hj), iters=10)
    k5 = time_ms(lambda: fe.mp_backward(params, alg, h_s, hj, None, dst, None,
                                        dagg, False, plan), iters=10)
    k5_plain = time_ms(lambda: fe.message_aggregate_grad_plain(
        params, alg, h_s, hj, None, dst, None, dagg, False), iters=2,
        warmup=1)
    hh = h_s.detach().requires_grad_(True)
    hhj = hj.detach().requires_grad_(True)
    out = composed(hh, hhj)
    wrt = [hh, hhj] + list(layer.edge_model.parameters())
    k5_comp = time_ms(lambda: _t.autograd.grad(out, wrt, dagg,
                                               retain_graph=True), iters=10)
    del out
    # K1 on the bench path: the source gather's backward, bf16 rows of
    # D = 256 over the sorted sources
    from csmpn_torch.ops import segment_kernel as sk

    rows = _t.randn(e, c * 8, device=dev).to(_t.bfloat16)
    k1 = time_ms(lambda: sk.sorted_segment_sum(rows, src_sort[1], n, False))
    b1, _ = bound(e * c * 16 + n * c * 32 + e * 8, e * c * 8, FP32_PEAK)
    print(f"K1 at the bench shape (E={e} N={n} D={c * 8} bf16, sorted "
          f"sources): {k1*1e3:.1f} us  bound {b1*1e3:.1f} us")
    results["k1"]["bench_ms"] = k1
    pbytes = sum(p.numel() for p in params) * 4
    flops = block_flops(e, c, c) * 2
    in_bytes = n * c * 16 + e * c * 16 + e * 4      # h, hj bf16; ids
    b4, b4by = bound(in_bytes + pbytes + n * c * 32, flops, BF16_PEAK)
    # K5: also reads d(agg) fp32; writes dh fp32, dhj bf16, the gradients
    b5, b5by = bound(in_bytes + n * c * 32 + 2 * pbytes + n * c * 32
                     + e * c * 16, 3 * flops, BF16_PEAK)
    shape = f"E={e} N={n} Cm=C={c} fast"
    print(f"K4/K5 time at the bench shape ({shape}):")
    print(f"  K4 {k4*1e3:.1f} us  plain {k4_plain*1e3:.1f} us  composed "
          f"route {k4_comp*1e3:.1f} us  bound {b4*1e3:.1f} us ({b4by})")
    print(f"  K5 {k5*1e3:.1f} us  plain {k5_plain*1e3:.1f} us  composed "
          f"route {k5_comp*1e3:.1f} us  bound {b5*1e3:.1f} us ({b5by})")
    results["k4"].update(ms=k4, plain_ms=k4_plain, bound_ms=b4, bound_by=b4by,
                         library_ms=None, composed_ms=k4_comp, shape=shape)
    results["k5"].update(ms=k5, plain_ms=k5_plain, bound_ms=b5, bound_by=b5by,
                         library_ms=None, composed_ms=k5_comp, shape=shape)
    set_aggregation_mode("exact")


# ------------------------------------------------- model on card vs CPU

def phase_model(dev, dataroot):
    from csmpn_torch.data.motion import MotionDataset
    from csmpn_torch.models.motion import MotionModel
    from csmpn_torch.nn.modules import init_parameters
    from csmpn_torch.ops.segment import set_aggregation_mode

    print("motion model (hidden 28, 4 layers, batch 8): card vs CPU, exact")
    os.environ["DATAROOT"] = dataroot
    with contextlib.redirect_stdout(io.StringIO()):
        ds = MotionDataset(batch_size=8, num_training_samples=200)
    batch = ds.train_dataset.select(list(range(8)))
    cpu = MotionModel(spec=ds.spec, num_hidden=HID, num_layers=4)
    init_parameters(cpu, torch.Generator().manual_seed(3))
    card = MotionModel(spec=ds.spec, num_hidden=HID, num_layers=4)
    card.load_state_dict(cpu.state_dict())
    card = card.to(dev)
    set_aggregation_mode("exact")
    lc, _ = cpu(batch.to("cpu"))
    lc.backward()
    lg, _ = card(batch.to(dev))
    lg.backward()
    check("loss", lg.detach().cpu(), lc.detach(), 1e-4)
    worst = 0.0
    for (k, pc), (_, pg) in zip(cpu.named_parameters(),
                                card.named_parameters()):
        worst = max(worst, rel_err(pg.grad.cpu(), pc.grad)[1])
    print(f"  worst gradient rel err over {len(list(cpu.parameters()))} "
          f"tensors: {worst:.3e}  tol 1e-03")
    if worst > 1e-3:
        raise AssertionError(f"gradient mismatch {worst:.3e}")
    set_aggregation_mode("fast")
    card.zero_grad()
    lf, _ = card(batch.to(dev))
    check("fast-mode loss vs exact CPU loss", lf.detach().cpu(), lc.detach(),
          5e-2)
    set_aggregation_mode("exact")


# ------------------------------------------------------- the task itself

def phase_task(dataroot, counters, device="cuda"):
    from csmpn_torch.data.motion import MotionDataset
    from csmpn_torch.engineer.fire import fire
    from csmpn_torch.tasks.motion import main

    argv = ["csmpn_torch/tasks/motion.py",
            "--trainer.module=csmpn_torch.engineer.Trainer",
            "--dataset.module=csmpn_torch.data.motion.MotionDataset",
            "--optimizer.module=csmpn_torch.engineer.optim.adam",
            "--model.module=csmpn_torch.models.motion.MotionModel",
            "--model.num_hidden=28", "--model.num_layers=4",
            "--dataset.num_training_samples=200", "--dataset.batch_size=100",
            "--optimizer.lr=5e-4", "--optimizer.weight_decay=1e-4",
            "--trainer.max_steps=8", "--trainer.val_check_interval=4",
            "--trainer.limit_val_batches=1", "--trainer.print_interval=1",
            "--trainer.log_interval=4", f"--device={device}"]
    os.environ["DATAROOT"] = dataroot
    os.environ["RUNDIR"] = os.path.join(dataroot, "runs")
    print("motion task via fire -> run_task -> Trainer.fit: hidden 28, "
          "4 layers, batch 100, 8 steps, fast precision")
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
    if len(losses) != 8 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"training losses not 8 finite values: {losses}")
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
    with contextlib.redirect_stdout(io.StringIO()):
        ds = MotionDataset(batch_size=100, num_training_samples=200)
    batch = next(iter(ds.train_loader(seed=0))).to(trainer.device)
    for c in counters.values():
        c.reset()
    loss, _ = model(batch)
    opt.zero_grad()
    loss.backward()
    opt.step()
    torch.cuda.synchronize()
    per_step = {k: c.count for k, c in counters.items()}
    print(f"  launches per training step: {per_step}")

    def step():
        loss, _ = model(batch)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return float(loss.detach())

    phase_profile(step)
    return launches, per_step, step_ms


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


# ------------------------------------------------------- the bench path

BENCH_PER_STEP = {"k1": 2, "k2": 6, "k3": 6, "k4": 3, "k5": 3}


def phase_bench(counters):
    """csmpn_torch.bench through its entry point at full width, then one
    step's launches, a profile, the fast-mode loss against exact, and the
    stack's loss and gradients on K4/K5 against the composed route."""
    from csmpn_torch import bench
    from csmpn_torch.ops import fused_egcl as fe
    from csmpn_torch.ops.segment import set_aggregation_mode

    print("bench path via csmpn_torch.bench.main: 3 EGCL layers, hidden 32, "
          "E=131072, N=8192, fast, 10 steps x 3 windows")
    for c in counters.values():
        c.reset()
    res = bench.main(["--device=cuda"])
    torch.cuda.synchronize()
    launches = {k: c.count for k, c in counters.items()}
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
    print(f"  launches per training step: {per_step} (expected "
          f"{BENCH_PER_STEP})")
    if per_step != BENCH_PER_STEP:
        raise AssertionError(f"launches per bench step {per_step} != "
                             f"{BENCH_PER_STEP}")

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

    lf, gf = loss_and_grads("fast")                # K4/K5 on the edge side
    lc, gc = loss_and_grads("fast", fused=False)   # the composed route
    le, _ = loss_and_grads("exact")
    check("bench stack: fast-mode loss vs exact-mode loss (card)", lf, le,
          TOL["bench_fast_loss"])
    check("bench stack, fast: loss on K4/K5 vs on the composed route", lf,
          lc, TOL["bench_fused_loss"])
    errs = sorted(((rel_err(a, b)[1], k) for a, b, (k, _) in
                   zip(gf, gc, model.named_parameters())), reverse=True)
    worst = errs[0][0]
    ok = worst <= TOL["bench_fused_grad"] and all(
        torch.isfinite(g).all().item() for g in gf)
    print(f"  bench stack, fast: gradients on K4/K5 vs on the composed "
          f"route, worst of {len(gf)} tensors rel {worst:.3e}  tol "
          f"{TOL['bench_fused_grad']:.0e}  {'ok' if ok else 'FAIL'}; median "
          f"{statistics.median(e for e, _ in errs):.3e}; worst "
          f"{[(k, round(e, 5)) for e, k in errs[:3]]}")
    if not ok:
        raise AssertionError(f"bench stack gradients: K4/K5 vs composed "
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
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    results = {}
    motion_counters = {"k1": sk.LAUNCHES, "k2": ck.FWD_LAUNCHES,
                       "k3": ck.BWD_LAUNCHES}
    counters = dict(motion_counters, k4=fe.FWD_LAUNCHES, k5=fe.BWD_LAUNCHES)
    with tempfile.TemporaryDirectory() as dataroot:
        real = motion_ids(dataroot, dev)
        phase_k1(dev, gen, results, real)
        phase_cemlp(dev, gen, results)
        phase_fused(dev, gen, results)
        phase_fused_time(dev, results)
        phase_model(dev, dataroot)
        m_launches, m_per_step, _ = phase_task(dataroot, motion_counters)
    launches, per_step, res, _, _ = phase_bench(counters)
    kernels = []
    for k in ("k1", "k2", "k3", "k4", "k5"):
        entry = dict(results[k])
        entry["launches"] = launches[k]
        entry["launches_per_step"] = per_step[k]
        if k in m_launches:
            entry["launches_motion"] = m_launches[k]
            entry["launches_per_step_motion"] = m_per_step[k]
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
