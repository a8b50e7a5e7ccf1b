"""Smoke run of csmpn_torch on one CUDA card (an H100).

    python3 chip_smoke.py            # from the root of a checkout

1. prints the card (nvidia-smi name and power limit) and builds the CUDA
   kernels from csmpn_torch/csrc, all sources in parallel, with each
   kernel's registers and spills;
2. the envelope probe (P1 copy, P2 resident matrix product in bf16 and
   tf32 on the tensor cores and fp32 FFMA, P3 FMA chain): each kernel
   against its plain version at tools/mxu_probe.py's sizes (P1 bitwise at
   every tile height), two launches bitwise equal, then the probe through
   its entry point with its launches counted, the plain and library
   times, the bounds, and the measured envelope against the data sheet;
   every later bound is also given against that envelope;
3. holds each kernel against its plain PyTorch version on the card, in
   exact and fast mode, with stated tolerances: K1, K2 and K3 at the
   motion task's shapes and K2/K3 at the bench widths; K4 and K5 (fused
   message passing) over the bench graph and the stress layouts (empty
   windows, few edges over many windows, masked edges, ragged E and N,
   with and without edge attributes), bitwise repeatable, masked rows of
   d(hj) exactly 0;
4. times each kernel, its plain version, a PyTorch library call where one
   computes the same function, and states the least time the card could
   take (bytes over 3.35 TB/s or operations over the peak rate); for K4
   and K5 also the composed route (gather, edge CEMLP on K2/K3,
   aggregation on K1) computing the same function;
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
   24 + 24 launches per step;
10. runs the bench path through its entry point (csmpn_torch.bench.main:
    3 EGCL layers, hidden 32, E = 131,072, N = 8,192, forward + backward +
    Adam), shows that K1-K5 ran and counts their launches in one step,
    profiles a few steps, holds its fast-mode loss to its exact-mode loss,
    and, in fast mode, its loss and every gradient on K4/K5 to the same
    stack on the composed route;
11. prints the kernels JSON line (twelve kernels) and, last, the
    device JSON line.

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
}
# the measured envelope of this card (phase_envelope): "bytes" (P1's best
# copy bandwidth, bytes/s), "bf16" (P2's bf16 mma.sync rate) and "fp32"
# (P3's FMA rate), FLOP/s; bound() sets each kernel's least time by it
ENVELOPE = {}
# the hulls task (configs/hulls.yaml, HullsModel defaults): Cl(5,0),
# hidden 28, 3 EGCL layers, batch 16; the dataset cut from 16,384 samples
# per split to these (the padding spec comes from the data)
H_B, H_HID, H_TRAIN, H_VAL = 16, 28, 512, 256


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def kernel_name(ptxas_line: str) -> str:
    """'name<args>' from ptxas's 'Compiling entry function' line: the
    kernel's name (lower-case words ending in '_kernel', which no digit of
    the mangled prefix can join), its algebra (Cl2E / Cl3E) and its bool
    template arguments (Lb0E / Lb1E)."""
    m = re.search(r"([a-z]+(?:_[a-z]+)*_kernel)(I\w*?Ev)?", ptxas_line)
    if m is None:
        return ptxas_line.strip()[-40:]
    args = (re.findall(r"(Cl\d)E", m.group(2) or "")
            + re.findall(r"Lb([01])E", m.group(2) or ""))
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
    b_ms, b_by, b_env = bound(bytes_moved, n_read * d, FP32_PEAK)
    print(f"  time (motion target ids) E={E_TOT} N={N_TOT} D={d} bf16: "
          f"kernel {ms*1e3:.1f} us"
          f"  plain {plain*1e3:.1f} us  segment_reduce {lib*1e3:.1f} us"
          f"  bound {b_ms*1e3:.1f} us ({b_by})")
    # the node-attribute gathers' backward: D = 3 types * 8 blades, fp32
    attr = torch.randn(E_TOT, 24, generator=gen).to(dev)
    ms24 = time_ms(lambda: sk.sorted_segment_sum(attr, ids, N_TOT, True))
    b24, _, _ = bound(n_read * 24 * 4 + N_TOT * 24 * 4 + E_TOT * 8,
                      n_read * 24, FP32_PEAK)
    print(f"  time E={E_TOT} N={N_TOT} D=24 fp32: kernel {ms24*1e3:.1f} us"
          f"  bound {b24*1e3:.1f} us; per training step (12 at D={d} bf16,"
          f" 2 at D=24): {12 * ms + 2 * ms24:.3f} ms")
    results["k1"] = dict(
        name="sorted_segment_sum", route="cuda",
        source="csmpn_torch/csrc/segment_sum.cu",
        replaces="csmpn_tpu/ops/pallas_segment.py:33",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib, bound_env_ms=b_env,
        shape=f"E={E_TOT} N={N_TOT} D={d} bf16")


# --------------------------------------------------------------- K2 / K3

def block_inputs(rows, cin, c, gen, dev, nb=8):
    """Random input, parameters and output cotangent of one block at
    nb = 4 (Cl(2): 3 grades, 10 paths), nb = 8 (Cl(3): 4, 20) or nb = 32
    (Cl(5): 6, 56)."""
    ng, npath = {4: (3, 10), 8: (4, 20), 32: (6, 56)}[nb]
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
    b1, _, _ = bound(e * c * 16 + n * c * 32 + e * 8, e * c * 8, FP32_PEAK)
    print(f"K1 at the bench shape (E={e} N={n} D={c * 8} bf16, sorted "
          f"sources): {k1*1e3:.1f} us  bound {b1*1e3:.1f} us")
    results["k1"]["bench_ms"] = k1
    pbytes = sum(p.numel() for p in params) * 4
    flops = block_flops(e, c, c) * 2
    in_bytes = n * c * 16 + e * c * 16 + e * 4      # h, hj bf16; ids
    b4, b4by, b4env = bound(in_bytes + pbytes + n * c * 32, flops,
                            BF16_PEAK)
    # K5: also reads d(agg) fp32; writes dh fp32, dhj bf16, the gradients
    b5, b5by, b5env = bound(in_bytes + n * c * 32 + 2 * pbytes
                            + n * c * 32 + e * c * 16, 3 * flops, BF16_PEAK)
    shape = f"E={e} N={n} Cm=C={c} fast"
    print(f"K4/K5 time at the bench shape ({shape}):")
    print(f"  K4 {k4*1e3:.1f} us  plain {k4_plain*1e3:.1f} us  composed "
          f"route {k4_comp*1e3:.1f} us  bound {b4*1e3:.1f} us ({b4by})")
    print(f"  K5 {k5*1e3:.1f} us  plain {k5_plain*1e3:.1f} us  composed "
          f"route {k5_comp*1e3:.1f} us  bound {b5*1e3:.1f} us ({b5by})")
    results["k4"].update(ms=k4, plain_ms=k4_plain, bound_ms=b4, bound_by=b4by,
                         library_ms=None, bound_env_ms=b4env,
                         composed_ms=k4_comp, shape=shape)
    results["k5"].update(ms=k5, plain_ms=k5_plain, bound_ms=b5, bound_by=b5by,
                         library_ms=None, bound_env_ms=b5env,
                         composed_ms=k5_comp, shape=shape)
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
    hulls D = 28 x 32 = 896, NBA 40 x 4 = 160, MD17 32 x 8 = 256."""
    from csmpn_torch.models.common import flatten_graph
    from csmpn_torch.ops import segment_kernel as sk

    batch = next(iter(ds.train_loader(seed=0))).to(dev)
    ei, emask, (_, src_sorted) = flatten_graph(batch)
    dst, src_sorted = ei[1].contiguous(), src_sorted.contiguous()
    n, e = batch.node_types.numel(), dst.numel()
    print(f"K1 vs plain at the {tag} shape (E={e} N={n} D={d}, a real "
          f"batch's ids)")
    errs = []
    for ids, m, mean, what in ((dst, emask, True, "targets, masked mean"),
                               (src_sorted, None, False, "sources, sum")):
        for dtype, exact in ((torch.bfloat16, False), (torch.float32, True)):
            data = torch.randn(e, d, generator=gen).to(dtype).to(dev)
            out, cnt = sk.sorted_segment_sum(data, ids, n, exact, m, mean)
            ref, rcnt = sk.segment_sum_plain(data, ids, n, exact, m, mean)
            name = (f"{tag} {what} {str(dtype)[6:]} "
                    f"{'exact' if exact else 'fast'}")
            errs.append(check(name, out, ref, TOL["k1"]))
            check(name + " counts", cnt, rcnt, 0.0)
    data = torch.randn(e, d, generator=gen).to(torch.bfloat16).to(dev)
    ms = time_ms(lambda: sk.sorted_segment_sum(data, dst, n, False))
    plain = time_ms(lambda: sk.segment_sum_plain(data, dst, n, False))
    offsets = sk.csr_offsets(dst, n)
    lengths = offsets[1:] - offsets[:-1]
    n_read = int(offsets[-1])
    kept = data[:n_read]
    lib = time_ms(lambda: torch.segment_reduce(kept, "sum", lengths=lengths,
                                               axis=0, unsafe=True))
    b_ms, b_by, b_env = bound(n_read * d * 2 + n * d * 4 + e * 8,
                              n_read * d, FP32_PEAK)
    print(f"  time ({tag} target ids) E={e} N={n} D={d} bf16: kernel "
          f"{ms*1e3:.1f} us  plain {plain*1e3:.1f} us  segment_reduce "
          f"{lib*1e3:.1f} us  bound {b_ms*1e3:.1f} us ({b_by})")
    results["k1"]["max_abs_err"] = max(results["k1"]["max_abs_err"], *errs)
    results["k1"].update({f"{tag}_ms": ms, f"{tag}_plain_ms": plain,
                          f"{tag}_library_ms": lib, f"{tag}_bound_ms": b_ms,
                          f"{tag}_bound_env_ms": b_env,
                          f"{tag}_shape": f"E={e} N={n} D={d} bf16"})


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
    hulls_counters = {"k1": sk.LAUNCHES, "k2p": ck.PAIR_FWD_LAUNCHES,
                      "k3p": ck.PAIR_BWD_LAUNCHES}
    nba_counters = {"k1": sk.LAUNCHES, "k2_cl2": ck.CL2_FWD_LAUNCHES,
                    "k3_cl2": ck.CL2_BWD_LAUNCHES}
    runs = {"envelope": (phase_envelope(dev, results), None)}
    with tempfile.TemporaryDirectory() as dataroot:
        real = motion_ids(dataroot, dev)
        phase_k1(dev, gen, results, real)
        phase_cemlp(dev, gen, results)
        phase_fused(dev, gen, results)
        phase_fused_time(dev, results)
        phase_model(dev, dataroot)
        runs["motion"] = phase_task(dataroot, motion_counters)[:2]
        runs["hulls"] = phase_hulls(dev, gen, results, dataroot,
                                    hulls_counters)[:2]
        runs["nba"] = phase_nba(dev, gen, results, dataroot,
                                nba_counters)[:2]
        runs["md17"] = phase_md17(dev, gen, results, dataroot,
                                  motion_counters)[:2]
    runs["bench"] = phase_bench(counters)[:2]
    # each kernel's launches on the path that runs it (the bench for
    # K1-K5, hulls for K2p/K3p, NBA for K2/K3 at Cl(2), the probe's own
    # run for P1-P3, which has no training step), the other paths' beside
    # them
    home = {"k2p": "hulls", "k3p": "hulls", "k2_cl2": "nba",
            "k3_cl2": "nba", "p1": "envelope", "p2": "envelope",
            "p3": "envelope"}
    kernels = []
    for k in ("k1", "k2", "k3", "k4", "k5", "k2p", "k3p", "k2_cl2",
              "k3_cl2", "p1", "p2", "p3"):
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
