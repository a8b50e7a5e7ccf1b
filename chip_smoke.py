"""Smoke run of csmpn_torch on one CUDA card (an H100).

    python3 chip_smoke.py            # from the root of a checkout

1. prints the card (nvidia-smi name and power limit) and builds the CUDA
   kernels from csmpn_torch/csrc, all sources in parallel;
2. holds each kernel against its plain PyTorch version on the card at the
   motion task's shapes, in exact and fast mode, with stated tolerances;
3. times each kernel, its plain version, a PyTorch library call where one
   computes the same function, and states the least time the card could
   take (bytes over 3.35 TB/s or operations over the peak rate);
4. checks the full-width motion model on the card against the same model
   on the CPU (loss and every gradient, exact mode);
5. runs the motion task through its entry point (fire -> run_task ->
   Trainer.fit) at the configs/motion.yaml widths for 8 training steps in
   the default fast precision, shows that K1, K2 and K3 ran, counts their
   launches in one training step and profiles a few steps' device time;
6. prints the kernels JSON line and, last, the device JSON line.

Any failed check raises, so the script exits non-zero and prints no
result line.  It needs one card and imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
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
TOL = {  # max |kernel - plain| allowed, relative to max |plain|: fp32
    # summation order in exact mode; in fast mode, bf16 rounding points
    # that a different fp32 order can flip (K3's plain version rounds
    # cotangents where autograd meets the casts, the kernel before use)
    "k1": 1e-5, "k2_exact": 1e-5, "k2_fast": 1e-2,
    "k3_exact": 1e-4, "k3_fast": 3e-2,
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


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


def phase_cemlp(dev, gen, results):
    from csmpn_torch.algebra import get_algebra
    from csmpn_torch.ops import cemlp_kernel as ck

    alg = get_algebra((1.0, 1.0, 1.0))
    print("K2 CEMLP block forward / K3 backward vs plain (motion shapes)")
    e2 = {"exact": [], "fast": []}
    e3 = {"exact": [], "fast": []}
    for name, rows, cin, c in CEMLP_SHAPES:
        x, params, dout = block_inputs(rows, cin, c, gen, dev)
        for exact in (True, False):
            mode = "exact" if exact else "fast"
            out = ck.block_forward(x, params, alg, exact)
            ref = ck.block_forward_plain(x, params, alg, exact)
            e2[mode].append(check(f"K2 {name} {mode}", out, ref,
                                  TOL[f"k2_{mode}"]))
            dx, grads = ck.block_backward(x, dout, params, alg, exact)
            rdx, rgrads = ck.block_backward_plain(x, dout, params, alg, exact)
            e3[mode].append(check(f"K3 {name} {mode} dx", dx, rdx,
                                  TOL[f"k3_{mode}"]))
            names = ["linear.weight", "linear.bias", "silu.a", "silu.b",
                     "gp.weight", "linear_right.weight", "normalization.a",
                     "linear_left.weight", "linear_left.bias", "norm.a"]
            for pn, g, rg in zip(names, grads, rgrads):
                e3[mode].append(check(f"K3 {name} {mode} d{pn}", g, rg,
                                      TOL[f"k3_{mode}"]))
    # timing at the largest launch of the main path: edge block 0, fast
    name, rows, cin, c = CEMLP_SHAPES[0]
    x, params, dout = block_inputs(rows, cin, c, gen, dev)
    fwd = time_ms(lambda: ck.block_forward(x, params, alg, False))
    fwd_plain = time_ms(lambda: ck.block_forward_plain(x, params, alg,
                                                       False), iters=10)
    bwd = time_ms(lambda: ck.block_backward(x, dout, params, alg, False),
                  iters=20)
    bwd_plain = time_ms(lambda: ck.block_backward_plain(x, dout, params, alg,
                                                        False), iters=5)
    pbytes = sum(p.numel() for p in params) * 4
    f2 = block_flops(rows, cin, c)
    b2, b2by = bound(rows * (cin + c) * 32 + pbytes, f2, BF16_PEAK)
    b3, b3by = bound(rows * (2 * cin + c) * 32 + 2 * pbytes, 3 * f2,
                     BF16_PEAK)
    shape = f"{name}: rows={rows} Cin={cin} C={c} fast"
    print(f"  time {shape}: fwd {fwd*1e3:.1f} us (plain {fwd_plain*1e3:.1f},"
          f" bound {b2*1e3:.1f} {b2by}); bwd {bwd*1e3:.1f} us (plain "
          f"{bwd_plain*1e3:.1f}, bound {b3*1e3:.1f} {b3by})")
    # every shape of a training step, fast mode; launches per step from
    # the motion model's structure (4 EGCL layers, the 1- and 2-block
    # embedding CEMLPs)
    per_step = {"edge": 4, "node": 4, "embed": 1}
    tot_f = tot_b = 0.0
    for name, rows, cin, c in CEMLP_SHAPES:
        x, params, dout = block_inputs(rows, cin, c, gen, dev)
        tf = time_ms(lambda: ck.block_forward(x, params, alg, False))
        tb = time_ms(lambda: ck.block_backward(x, dout, params, alg, False),
                     iters=20)
        f2 = block_flops(rows, cin, c)
        pbytes = sum(p.numel() for p in params) * 4
        bf, _ = bound(rows * (cin + c) * 32 + pbytes, f2, BF16_PEAK)
        bb, _ = bound(rows * (2 * cin + c) * 32 + 2 * pbytes, 3 * f2,
                      BF16_PEAK)
        k = per_step[name.split("_")[0]]
        tot_f += k * tf
        tot_b += k * tb
        print(f"  {name:<15s} rows={rows:<6d} Cin={cin:<3d} C={c}: K2 "
              f"{tf*1e3:7.1f} us (bound {bf*1e3:5.1f})  K3 {tb*1e3:7.1f} us "
              f"(bound {bb*1e3:5.1f})  x{k} per step")
    print(f"  per training step: K2 {tot_f:.3f} ms, K3 {tot_b:.3f} ms")
    results["k2"] = dict(
        name="cemlp_block_fwd", route="cuda", source="csmpn_torch/csrc/cemlp.cu",
        replaces="csmpn_tpu/ops/cemlp_kernel.py:430",
        max_abs_err=max(e2["exact"]), max_abs_err_fast=max(e2["fast"]),
        ms=fwd, plain_ms=fwd_plain, bound_ms=b2, bound_by=b2by,
        library_ms=None, shape=shape)
    results["k3"] = dict(
        name="cemlp_block_bwd", route="cuda", source="csmpn_torch/csrc/cemlp.cu",
        replaces="csmpn_tpu/ops/cemlp_kernel.py:519",
        max_abs_err=max(e3["exact"]), max_abs_err_fast=max(e3["fast"]),
        ms=bwd, plain_ms=bwd_plain, bound_ms=b3, bound_by=b3by,
        library_ms=None, shape=shape)


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
    phase_profile(model, opt, batch)
    return launches, per_step, step_ms


def phase_profile(model, opt, batch, steps=3):
    """Device busy time over a few training steps (torch.profiler), and
    the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile

    def step():
        loss, _ = model(batch)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return float(loss.detach())

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
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    results = {}
    counters = {"k1": sk.LAUNCHES, "k2": ck.FWD_LAUNCHES,
                "k3": ck.BWD_LAUNCHES}
    with tempfile.TemporaryDirectory() as dataroot:
        real = motion_ids(dataroot, dev)
        phase_k1(dev, gen, results, real)
        phase_cemlp(dev, gen, results)
        phase_model(dev, dataroot)
        launches, per_step, _ = phase_task(dataroot, counters)
    kernels = []
    for k in ("k1", "k2", "k3"):
        entry = dict(results[k])
        entry["launches"] = launches[k]
        entry["launches_per_step"] = per_step[k]
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
