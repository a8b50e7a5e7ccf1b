"""Times of the block and fused message-passing kernels of one checkout,
for comparing two trees on the same card:

    python3 csmpn_torch/tools/kernel_times.py [ROOT]

imports ``csmpn_torch`` from the checkout at ROOT (default: this one),
builds its kernels, and prints one line ``kernel_times {json}`` with the
device µs per launch, fast mode, and the card:

  * K2 and K3 at the motion edge block 0 (23,200 rows, 34 -> 28, Cl(3,0));
  * K2 and K3 at Cl(2,0) at the NBA edge block 0 (35,200 rows, 46 -> 40);
  * K2p and K3p at the hulls edge block 0 (13,184 rows, 34 -> 28,
    Cl(5,0)), and at Cl(4,0) at the bench's --dim 4 node block 0 (8,192
    rows, 56 -> 28);
  * K4 and K5 at the bench shape (E = 131,072, N = 8,192) of each algebra
    (bench.WIDTHS): Cl(3) 32 -> 32, Cl(2) 40 -> 40, K4p/K5p at Cl(5) and
    Cl(4) 28 -> 28.

A kernel the checkout at ROOT does not have (K2p/K3p and K4p/K5p at Cl(4)
before they were ported) is left out of its line.  Run it for two trees in
turns in one call (parent, change, change, parent): two calls may land on
two cards.  It needs a CUDA card.
"""
import json
import os
import sys


def main(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    from csmpn_torch.algebra import get_algebra
    from csmpn_torch.bench import WIDTHS, workload
    from csmpn_torch.nn.egcl import EGCL
    from csmpn_torch.nn.modules import CEMLP, init_parameters
    from csmpn_torch.ops import _build, cemlp_kernel as ck, fused_egcl as fe
    from csmpn_torch.ops.segment import set_aggregation_mode, take_rows

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: a CUDA card is required")
    _build.build_all()
    dev = torch.device("cuda")

    def time_us(fn, iters):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)   # host issue hidden behind it
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters * 1e3

    def has(nb):   # the checkout has kernels for nb blades
        try:
            ck.block_kernel(nb)
            return True
        except NotImplementedError:
            return False

    gen = torch.Generator().manual_seed(0)
    out = {"root": root, "card": torch.cuda.get_device_name(0)}
    # (key, dim, rows, Cin, C, forward iterations, backward iterations)
    blocks = [("k2", 3, 23200, 34, 28, 100, 40),
              ("k2_cl2", 2, 35200, 46, 40, 50, 20),
              ("k2p", 5, 13184, 34, 28, 40, 10),
              ("k2p_cl4", 4, 8192, 56, 28, 40, 10)]
    for key, dim, rows, cin, c, itf, itb in blocks:
        if not has(2 ** dim):
            continue
        alg = get_algebra((1.0,) * dim)
        nb = alg.n_blades
        x = torch.randn(rows, cin, nb, generator=gen).to(dev)
        cemlp = CEMLP(alg, cin, c, c, n_layers=1)
        init_parameters(cemlp, gen)
        params = [p.detach().to(dev) for p in ck.block_params(cemlp, 0)]
        dout = torch.randn(rows, c, nb, generator=gen).to(dev)
        kb = key.replace("k2", "k3", 1)
        out[f"{key}_us"] = time_us(
            lambda: ck.block_forward(x, params, alg, False), itf)
        out[f"{kb}_us"] = time_us(
            lambda: ck.block_backward(x, dout, params, alg, False), itb)
        del x, dout

    set_aggregation_mode("fast")
    # (forward key, dim, forward iterations, backward iterations)
    fused = [("k4", 3, 30, 15), ("k4_cl2", 2, 30, 15), ("k4p", 5, 5, 3),
             ("k4p_cl4", 4, 10, 5)]
    for key, dim, itf, itb in fused:
        if not has(2 ** dim):
            continue
        alg = get_algebra((1.0,) * dim)
        h, ei, _ = workload(dev, hidden=WIDTHS[dim][0], dim=dim)
        src, dst = ei[0], ei[1]
        n, c, nb = h.shape[0], h.shape[1], h.shape[2]
        h_s = h.to(torch.bfloat16)
        hj = take_rows(h_s, src)
        layer = EGCL(alg, c, c, c, aggr="sum")
        init_parameters(layer, torch.Generator().manual_seed(1))
        layer = layer.to(dev)
        ps = [p.detach() for p in ck.block_params(layer.edge_model, 0)
              + ck.block_params(layer.edge_model, 1)]
        dagg = torch.randn(n, c, nb, device=dev)
        plan = fe.make_plan(dst, None, n, c, 0, c, nb)
        kb = key.replace("k4", "k5", 1)
        out[f"{key}_us"] = time_us(lambda: fe.mp_forward(
            ps, alg, h_s, hj, None, dst, None, False, plan), itf)
        out[f"{kb}_us"] = time_us(lambda: fe.mp_backward(
            ps, alg, h_s, hj, None, dst, None, dagg, False, plan), itb)
        del h, h_s, hj, dagg
        torch.cuda.empty_cache()
    print("kernel_times " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
