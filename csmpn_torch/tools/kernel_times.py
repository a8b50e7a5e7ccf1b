"""Times of the Cl(3) block and fused message-passing kernels of one
checkout, for comparing two trees on the same card:

    python3 csmpn_torch/tools/kernel_times.py [ROOT]

imports ``csmpn_torch`` from the checkout at ROOT (default: this one),
builds its kernels, and prints one line ``kernel_times {json}`` with the
device µs per launch, fast mode, of K2 and K3 at the motion edge block 0
(23,200 rows, 34 -> 28 channels) and of K4 and K5 at the bench shape
(E = 131,072, N = 8,192, 32 -> 32), and the card.  Run it for two trees
in turns in one call (parent, change, change, parent): two calls may land
on two cards.  It needs a CUDA card.
"""
import json
import os
import sys


def main(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    from csmpn_torch.algebra import get_algebra
    from csmpn_torch.bench import workload
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

    alg = get_algebra((1.0, 1.0, 1.0))
    gen = torch.Generator().manual_seed(0)
    rows, cin, c = 23200, 34, 28
    x = torch.randn(rows, cin, 8, generator=gen).to(dev)
    cemlp = CEMLP(alg, cin, c, c, n_layers=1)
    init_parameters(cemlp, gen)
    params = [p.detach().to(dev) for p in ck.block_params(cemlp, 0)]
    dout = torch.randn(rows, c, 8, generator=gen).to(dev)
    out = {"root": root, "card": torch.cuda.get_device_name(0)}
    out["k2_us"] = time_us(lambda: ck.block_forward(x, params, alg, False),
                           100)
    out["k3_us"] = time_us(
        lambda: ck.block_backward(x, dout, params, alg, False), 40)

    set_aggregation_mode("fast")
    h, ei, _ = workload(dev)
    src, dst = ei[0], ei[1]
    n, c = h.shape[0], h.shape[1]
    h_s = h.to(torch.bfloat16)
    hj = take_rows(h_s, src)
    layer = EGCL(alg, c, c, c, aggr="sum")
    init_parameters(layer, torch.Generator().manual_seed(1))
    layer = layer.to(dev)
    ps = [p.detach() for p in ck.block_params(layer.edge_model, 0)
          + ck.block_params(layer.edge_model, 1)]
    dagg = torch.randn(n, c, 8, device=dev)
    plan = fe.make_plan(dst, None, n, c, 0, c)
    out["k4_us"] = time_us(lambda: fe.mp_forward(
        ps, alg, h_s, hj, None, dst, None, False, plan), 30)
    out["k5_us"] = time_us(lambda: fe.mp_backward(
        ps, alg, h_s, hj, None, dst, None, dagg, False, plan), 15)
    print("kernel_times " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
