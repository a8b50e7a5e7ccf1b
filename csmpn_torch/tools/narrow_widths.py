"""K3 in fast mode at narrow output widths, against its plain versions.

    python3 csmpn_torch/tools/narrow_widths.py [ROOT]

imports ``csmpn_torch`` from the checkout at ROOT (default: this one) and,
for each (algebra, Cin, C) of ``SHAPES`` at 3,000 rows and three seeds,
prints the largest difference over dx and the 10 parameter gradients,
each relative to the max |.| of the reference, between the kernel and
the plain fast version (k-p), the plain fast and the plain exact version
(p-e), and the kernel and the plain exact version (k-e).  At C = 1-3
the layer norm spans so few channels that its backward cancels, and the
fast mode's bf16 rounding moves the gradients further than at wider C,
whichever implementation rounds them; run it at the parent's checkout
and at this one to compare.  Needs a CUDA card.
"""
import json
import os
import sys

# (dim, Cin, C): the widest input the exact row kernels take at C = 1-4
SHAPES = [(3, 791, 1), (3, 708, 2), (3, 640, 3), (3, 582, 4),
          (2, 1485, 1), (2, 896, 1), (2, 1282, 2), (2, 1003, 4)]
ROWS = 3000


def block_inputs(rows, cin, c, nb, gen):
    """Random input, output cotangent and parameters of one block (the
    scales of chip_smoke.py's block_inputs)."""
    import torch

    ng, npath = {4: (3, 10), 8: (4, 20)}[nb]
    x = torch.randn(rows, cin, nb, generator=gen)

    def r(*shape, scale=1.0, base=0.0):
        return base + scale * torch.randn(*shape, generator=gen)

    params = [r(c, cin, ng, scale=cin ** -0.5), r(c, 1, scale=0.1),
              r(c, ng, scale=0.2, base=1.0), r(c, ng, scale=0.2),
              r(c, npath, scale=0.5), r(c, c, ng, scale=c ** -0.5),
              r(c, ng, scale=0.5), r(c, c, ng, scale=c ** -0.5),
              r(c, 1, scale=0.1), r(c, scale=0.1, base=1.0)]
    dout = torch.randn(rows, c, nb, generator=gen)
    return x, params, dout


def main(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    from csmpn_torch.algebra import get_algebra
    from csmpn_torch.ops import cemlp_kernel as ck

    if not torch.cuda.is_available():
        raise SystemExit("narrow_widths: a CUDA card is required")
    dev = torch.device("cuda")

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    def worst(a, b):
        return max(rel(u, v) for u, v in zip(a, b))

    out = {"root": root, "card": torch.cuda.get_device_name(0), "rows": []}
    for dim, cin, c in SHAPES:
        alg = get_algebra((1.0,) * dim)
        for seed in (1, 2, 3):
            gen = torch.Generator().manual_seed(seed)
            x, params, dout = (t.to(dev) if torch.is_tensor(t)
                               else [p.to(dev) for p in t]
                               for t in block_inputs(ROWS, cin, c,
                                                     alg.n_blades, gen))
            k = ck.block_backward(x, dout, params, alg, False)
            p = ck.block_backward_plain(x, dout, params, alg, False)
            e = ck.block_backward_plain(x, dout, params, alg, True)
            k, p, e = ([t[0]] + list(t[1]) for t in (k, p, e))
            row = dict(dim=dim, cin=cin, c=c, seed=seed, k_p=worst(k, p),
                       p_e=worst(p, e), k_e=worst(k, e))
            out["rows"].append(row)
            print(f"Cl({dim}) {cin}->{c} seed {seed}: k-p {row['k_p']:.2e} "
                  f"p-e {row['p_e']:.2e} k-e {row['k_e']:.2e}", flush=True)
    print("narrow_widths " + json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
