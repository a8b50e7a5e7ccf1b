"""Times of the block and fused message-passing kernels of one checkout,
for comparing two trees on the same card:

    python3 csmpn_torch/tools/kernel_times.py [ROOT]

imports ``csmpn_torch`` from the checkout at ROOT (default: this one),
builds its kernels, and prints one line ``kernel_times {json}`` with the
device µs per launch, fast mode, and the card:

  * K2 and K3 at the motion edge block 0 (23,200 rows, 34 -> 28, Cl(3,0));
  * K2 and K3 at Cl(2,0) at the NBA edge block 0 (35,200 rows, 46 -> 40);
  * K2 and K3 at the widest inputs of the MD17 and NBA blocks: 90 -> 32
    (Cl(3,0), the triangle embedding) at 30,000 rows and 83 -> 40 (Cl(2,0),
    the node block) at 35,200 rows;
  * K2 and K3 at three small launches of Cl(3,0): the motion node block 0
    (5,600 rows, 59 -> 28) and embedding ``embed_1`` (3,200 rows, 4 -> 28),
    and the bench's node block 0 (8,192 rows, 64 -> 32);
  * K2p and K3p at the hulls edge block 0 (13,184 rows, 34 -> 28,
    Cl(5,0)), and at Cl(4,0) at the bench's --dim 4 node block 0 (8,192
    rows, 56 -> 28);
  * K2w and K3w (the dense form past K2/K3's widths) at the motion edge
    block at hidden 128 (23,200 rows, 134 -> 128, Cl(3,0)) and at NBA's
    node block at hidden 128 (23,200 rows, 259 -> 128, Cl(2,0));
  * K2pw and K3pw (the pair form past K2p/K3p's widths) at the hulls edge
    and node blocks 0 at hidden 64 (13,184 rows, 70 -> 64; 1,536 rows,
    131 -> 64; Cl(5,0)) and at Cl(4,0) at 8,192 rows, 131 -> 64;
  * K4 and K5 at the bench shape (E = 131,072, N = 8,192) of each algebra
    (bench.WIDTHS): Cl(3) 32 -> 32, Cl(2) 40 -> 40, K4p/K5p at Cl(5) and
    Cl(4) 28 -> 28;
  * K4w and K5w (the dense fused kernels past K4/K5's widths) at the
    bench shape at Cl(3,0), 64 -> 64 and 128 -> 128;
  * K4pw and K5pw (the pair-form fused kernels past K4p/K5p's widths) at
    the bench shape at Cl(5,0) and Cl(4,0), 64 -> 64;
  * K1 at the bench's node aggregation (E = 131,072 sorted ids over
    N = 8,192, D = 256 bf16, fast mode) and at each task's aggregation
    width and batch size (motion D = 224, E = 23,200, N = 5,600; NBA 160,
    35,200, 4,800; MD17 256, 39,200, 7,200; hulls 896, 13,184, 1,536; ids
    drawn uniformly), each beside torch.segment_reduce over the same rows
    (its lengths computed beforehand);
  * P2, the envelope probe's resident bf16 product at its default sizes
    (512 x 256 x 2048, 32 reps).

A kernel the checkout at ROOT does not have (K2p/K3p and K4p/K5p at Cl(4)
before they were ported, K2pw/K3pw, K4w/K5w and K4pw/K5pw before theirs:
those widths raise NotImplementedError) is null in its line.  Run it for
two trees in turns in one call (parent, change, change, parent): two calls
may land on two cards.  It needs a CUDA card.
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
              ("k2_md17", 3, 30000, 90, 32, 50, 20),
              ("k2_nba83", 2, 35200, 83, 40, 50, 20),
              ("k2_node_block0", 3, 5600, 59, 28, 100, 40),
              ("k2_embed_1", 3, 3200, 4, 28, 100, 40),
              ("k2_bench_node_block0", 3, 8192, 64, 32, 100, 40),
              ("k2p", 5, 13184, 34, 28, 40, 10),
              ("k2p_cl4", 4, 8192, 56, 28, 40, 10)]
    for key, dim, rows, cin, c, itf, itb in blocks:
        kb = key.replace("k2", "k3", 1)
        if not has(2 ** dim):
            out[f"{key}_us"] = out[f"{kb}_us"] = None
            continue
        alg = get_algebra((1.0,) * dim)
        nb = alg.n_blades
        x = torch.randn(rows, cin, nb, generator=gen).to(dev)
        cemlp = CEMLP(alg, cin, c, c, n_layers=1)
        init_parameters(cemlp, gen)
        params = [p.detach().to(dev) for p in ck.block_params(cemlp, 0)]
        dout = torch.randn(rows, c, nb, generator=gen).to(dev)
        out[f"{key}_us"] = time_us(
            lambda: ck.block_forward(x, params, alg, False), itf)
        out[f"{kb}_us"] = time_us(
            lambda: ck.block_backward(x, dout, params, alg, False), itb)
        del x, dout

    # K2w/K3w and K2pw/K3pw: (key, dim, rows, Cin, C, forward, backward
    # iterations)
    for key, dim, rows, cin, c, itf, itb in (
            ("k2w", 3, 23200, 134, 128, 20, 5),
            ("k2w_cl2", 2, 23200, 259, 128, 20, 5),
            ("k2pw", 5, 13184, 70, 64, 20, 5),
            ("k2pw_node", 5, 1536, 131, 64, 40, 10),
            ("k2pw_cl4", 4, 8192, 131, 64, 20, 5)):
        kb = key.replace("k2", "k3", 1)
        alg = get_algebra((1.0,) * dim)
        nb = alg.n_blades
        x = torch.randn(rows, cin, nb, generator=gen).to(dev)
        cemlp = CEMLP(alg, cin, c, c, n_layers=1)
        init_parameters(cemlp, gen)
        params = [p.detach().to(dev) for p in ck.block_params(cemlp, 0)]
        dout = torch.randn(rows, c, nb, generator=gen).to(dev)
        try:
            out[f"{key}_us"] = time_us(
                lambda: ck.block_forward(x, params, alg, False), itf)
            out[f"{kb}_us"] = time_us(
                lambda: ck.block_backward(x, dout, params, alg, False), itb)
        except NotImplementedError:
            out[f"{key}_us"] = out[f"{kb}_us"] = None
        del x, dout

    set_aggregation_mode("fast")
    # (forward key, dim, forward iterations, backward iterations)
    fused = [("k4", 3, 30, 15), ("k4_cl2", 2, 30, 15), ("k4p", 5, 5, 3),
             ("k4p_cl4", 4, 10, 5)]
    for key, dim, itf, itb in fused:
        kb = key.replace("k4", "k5", 1)
        if not has(2 ** dim):
            out[f"{key}_us"] = out[f"{kb}_us"] = None
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
        out[f"{key}_us"] = time_us(lambda: fe.mp_forward(
            ps, alg, h_s, hj, None, dst, None, False, plan), itf)
        out[f"{kb}_us"] = time_us(lambda: fe.mp_backward(
            ps, alg, h_s, hj, None, dst, None, dagg, False, plan), itb)
        del h, h_s, hj, dagg
        torch.cuda.empty_cache()
    # K4w/K5w and K4pw/K5pw: (forward key, dim, hidden, forward, backward
    # iterations)
    for key, dim, c, itf, itb in (("k4w_h64", 3, 64, 10, 4),
                                  ("k4w_h128", 3, 128, 5, 2),
                                  ("k4pw_h64", 5, 64, 3, 2),
                                  ("k4pw_cl4_h64", 4, 64, 5, 3)):
        kb = key.replace("k4", "k5", 1)
        alg = get_algebra((1.0,) * dim)
        h, ei, _ = workload(dev, hidden=c, dim=dim)
        src, dst = ei[0], ei[1]
        n, nb = h.shape[0], h.shape[2]
        h_s = h.to(torch.bfloat16)
        hj = take_rows(h_s, src)
        layer = EGCL(alg, c, c, c, aggr="sum")
        init_parameters(layer, torch.Generator().manual_seed(1))
        layer = layer.to(dev)
        ps = [p.detach() for p in ck.block_params(layer.edge_model, 0)
              + ck.block_params(layer.edge_model, 1)]
        dagg = torch.randn(n, c, nb, device=dev)
        try:
            plan = fe.make_plan(dst, None, n, c, 0, c, nb)
            out[f"{key}_us"] = time_us(lambda: fe.mp_forward(
                ps, alg, h_s, hj, None, dst, None, False, plan), itf)
            out[f"{kb}_us"] = time_us(lambda: fe.mp_backward(
                ps, alg, h_s, hj, None, dst, None, dagg, False, plan), itb)
        except NotImplementedError:
            out[f"{key}_us"] = out[f"{kb}_us"] = None
        del h, h_s, hj, dagg
        torch.cuda.empty_cache()
    from csmpn_torch.ops import probe_kernels as pk, segment_kernel as sk
    # (key, E, N, D): the bench's node aggregation, then each task's
    # aggregation width at its batch's edge and node counts
    for key, e, n, d in (("k1", 131072, 8192, 256),
                         ("k1_motion", 23200, 5600, 224),
                         ("k1_nba", 35200, 4800, 160),
                         ("k1_md17", 39200, 7200, 256),
                         ("k1_hulls", 13184, 1536, 896)):
        ids = torch.sort(torch.randint(0, n, (e,), generator=gen)).values
        ids = ids.to(dev)
        data = torch.randn(e, d, generator=gen).to(dev).to(torch.bfloat16)
        lengths = torch.bincount(ids, minlength=n)
        out[f"{key}_us"] = time_us(
            lambda: sk.sorted_segment_sum(data, ids, n, exact=False), 100)
        out[f"{key}_segment_reduce_us"] = time_us(
            lambda: torch.segment_reduce(data, "sum", lengths=lengths,
                                         axis=0, unsafe=True), 100)
    a = torch.randn(512, 256, generator=gen).to(dev)
    b = (torch.randn(256, 2048, generator=gen) / 16).to(dev)
    out["p2_bf16_us"] = time_us(lambda: pk.resident_matmul(a, b, 32, "bf16"),
                                50)
    print("kernel_times " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
