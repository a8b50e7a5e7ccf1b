"""Clifford-equivariant neural layers as torch ``nn.Module``s.

Port of ``csmpn_tpu/nn/modules.py``: MVLinear, MVSiLU (``invariant`` "mag2"
or "norm"), NormalizationLayer, MVLayerNorm, SteerableGeometricProductLayer
(``include_first_order``, ``normalization_init`` or None, ``impl`` "dense" or
"pair") and CEMLP (``normalization_init``, ``fused``), with the parameter
names and shapes of the flax tree, so ``convert.params_from_jax`` maps one
onto the other by path: a submodule an option leaves out (an SGP's
``normalization`` or ``linear_left``) is missing from both.
Multivector activations are laid out as ``(..., channels, n_blades)`` with
the blade axis last.

A CEMLP takes one of two routes, decided by ``cemlp_route`` from its own
options and the input's device: the block kernels (``ops/cemlp_kernel.py``:
one hand-written kernel a block on the card, their plain versions on the
CPU), or the layers below composed.  ``fused=None`` takes the kernels on a
CUDA tensor when every block has its normalization layer (the block the
kernels compute) and composes otherwise; ``fused=True`` always takes the
kernels (the port's counterpart of the reference's Pallas kernel in
interpret mode off the TPU) and raises ValueError without normalization
layers; ``fused=False`` composes on either device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..algebra.clifford import CliffordAlgebra

EPS = 1e-6


def _normal_(t: torch.Tensor, std: float, generator=None) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=generator) * std)


class MVLinear(nn.Module):
    """Channel-mixing linear map on multivectors.  With ``subspaces=True``
    one weight per grade, shared by the blades of that grade."""

    def __init__(self, algebra: CliffordAlgebra, in_features: int,
                 out_features: int, subspaces: bool = True,
                 use_bias: bool = True):
        super().__init__()
        self.algebra = algebra
        self.in_features = in_features
        self.out_features = out_features
        self.subspaces = subspaces
        self.use_bias = use_bias
        shape = ((out_features, in_features, algebra.n_subspaces) if subspaces
                 else (out_features, in_features))
        self.weight = nn.Parameter(torch.empty(shape))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(out_features, 1))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        _normal_(self.weight, 1.0 / math.sqrt(self.in_features), generator)
        if self.use_bias:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.subspaces:
            w = self.weight[..., self.algebra.index("blade_to_grade",
                                                    x.device)]
            out = torch.einsum("...mi,nmi->...ni", x, w.to(x.dtype))
        else:
            out = torch.einsum("...mi,nm->...ni", x, self.weight.to(x.dtype))
        if self.use_bias:
            # scalar-blade bias embedded at blade 0
            out = torch.cat([out[..., :1] + self.bias, out[..., 1:]], dim=-1)
        return out


class MVSiLU(nn.Module):
    """Gated SiLU: sigmoid of an affine function of the per-grade
    invariants (scalar blade passthrough; above it the squared magnitudes,
    ``invariant="mag2"``, or the norms, ``"norm"``)."""

    def __init__(self, algebra: CliffordAlgebra, channels: int,
                 invariant: str = "mag2"):
        super().__init__()
        if invariant not in ("mag2", "norm"):
            raise ValueError(f"Invariant {invariant} not recognized.")
        self.algebra = algebra
        self.channels = channels
        self.invariant = invariant
        self.a = nn.Parameter(torch.ones(channels, algebra.dim + 1))
        self.b = nn.Parameter(torch.zeros(channels, algebra.dim + 1))

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.a)
        nn.init.zeros_(self.b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alg = self.algebra
        inv = alg.qs_cat(x) if self.invariant == "mag2" else alg.norms_cat(x)
        inv = torch.cat([x[..., :1], inv[..., 1:]], dim=-1)
        gate = self.a * inv + self.b
        return torch.sigmoid(alg.expand_per_grade(gate)) * x


class NormalizationLayer(nn.Module):
    """Per-grade norm normalisation with a learned interpolation gate."""

    def __init__(self, algebra: CliffordAlgebra, features: int,
                 init_scale: float = 0.0):
        super().__init__()
        self.algebra = algebra
        self.init_scale = init_scale
        self.a = nn.Parameter(torch.full((features, algebra.n_subspaces),
                                         float(init_scale)))

    def reset_parameters(self, generator=None) -> None:
        nn.init.constant_(self.a, float(self.init_scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norms = self.algebra.norms_cat(x)
        s_a = torch.sigmoid(self.a)
        norms = s_a * (norms - 1.0) + 1.0
        return x / (self.algebra.expand_per_grade(norms) + EPS)


class MVLayerNorm(nn.Module):
    """Divide by the channel-mean multivector norm; per-channel scale."""

    def __init__(self, algebra: CliffordAlgebra, channels: int):
        super().__init__()
        self.algebra = algebra
        self.a = nn.Parameter(torch.ones(channels))

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.a)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = self.algebra.norm(x)
        norm = torch.mean(norm, dim=-2, keepdim=True) + EPS
        return self.a[:, None] * x / norm


class SteerableGeometricProductLayer(nn.Module):
    """Fully parameterised geometric product ``x (x)_w normalize(W x)``,
    one weight per (channel, nonzero grade-triple path), plus the
    first-order term ``linear_left(x)`` and the division by sqrt(2) where
    ``include_first_order``.  ``normalization_init=None`` drops the
    normalisation of ``W x``.  ``impl="dense"`` contracts the weighted
    Cayley tensor (C, nb, nb, nb) in one einsum; ``"pair"`` sums over the
    Cayley pairs (one left blade and one sign per output j and right k),
    nb^2 work a channel."""

    def __init__(self, algebra: CliffordAlgebra, features: int,
                 include_first_order: bool = True,
                 normalization_init: Optional[float] = 0.0,
                 impl: str = "dense"):
        super().__init__()
        if impl not in ("dense", "pair"):
            raise ValueError(f"impl must be 'dense' or 'pair', got {impl!r}")
        self.algebra = algebra
        self.features = features
        self.include_first_order = include_first_order
        self.normalization_init = normalization_init
        self.impl = impl
        self.weight = nn.Parameter(torch.empty(features,
                                               algebra.n_product_paths))
        self.linear_right = MVLinear(algebra, features, features,
                                     use_bias=False)
        if normalization_init is not None:
            self.normalization = NormalizationLayer(algebra, features,
                                                    normalization_init)
        if include_first_order:
            self.linear_left = MVLinear(algebra, features, features,
                                        use_bias=True)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        _normal_(self.weight, 1.0 / math.sqrt(self.algebra.dim + 1),
                 generator)

    def weighted_cayley(self) -> torch.Tensor:
        """Blade-resolution weighted Cayley tensor (C, nb, nb, nb)."""
        alg = self.algebra
        d = alg.dim + 1
        idx = alg.index("product_path_index", self.weight.device)
        cube = self.weight.new_zeros(self.features, d * d * d)
        cube = cube.index_copy(1, idx, self.weight).reshape(
            self.features, d, d, d)
        g = alg.index("blade_to_grade", self.weight.device)
        w_blades = cube[:, g][:, :, g][:, :, :, g]
        return alg.const("cayley", self.weight) * w_blades

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alg = self.algebra
        x_right = self.linear_right(x)
        if self.normalization_init is not None:
            x_right = self.normalization(x_right)
        if self.impl == "dense":
            weighted = self.weighted_cayley().to(x.dtype)
            out = torch.einsum("...ni,nijk,...nk->...nj", x, weighted,
                               x_right)
        else:
            # out_j = sum_k coeff[j,k] w[n, path(j,k)] x[..., i_of[j,k]] xr_k
            path = alg.index("gp_pair_paths", x.device)
            cw = (alg.const("pair_coeff", self.weight)
                  * self.weight[:, path]).to(x.dtype)     # (C, nb, nb)
            xg = x[..., alg.index("pair_i_of", x.device)]
            out = torch.einsum("...njk,njk,...nk->...nj", xg, cw, x_right)
        if self.include_first_order:
            out = (self.linear_left(x) + out) / math.sqrt(2)
        return out


def cemlp_route(cemlp: "CEMLP", device_type: str) -> str:
    """The route of ``cemlp`` on a tensor of ``device_type``: "kernels"
    (``ops/cemlp_kernel.apply_fused_cemlp``: one kernel a block on the
    card, their plain versions on the CPU) or "composed" (the layers).
    The block kernels compute the block with its normalization layer, so
    a CEMLP built with ``normalization_init=None`` composes, or raises
    ValueError where ``fused=True`` asks for the kernels."""
    if cemlp.fused is False:
        return "composed"
    if cemlp.normalization_init is None:
        if cemlp.fused:
            raise ValueError(
                "CEMLP(fused=True) runs the block kernels, which compute the "
                "block with its normalization layer; normalization_init=None "
                "leaves it out (use fused=None or fused=False)")
        return "composed"
    if cemlp.fused or device_type == "cuda":
        return "kernels"
    return "composed"


class CEMLP(nn.Module):
    """Stack of [MVLinear -> MVSiLU -> SGP -> MVLayerNorm] blocks, the
    shared message/update network of EGCL and of the simplex embedding.
    ``fused``: None (the kernels on the card), True or False; see
    ``cemlp_route``."""

    def __init__(self, algebra: CliffordAlgebra, in_features: int,
                 hidden_features: int, out_features: int, n_layers: int = 2,
                 normalization_init: Optional[float] = 0.0,
                 fused: Optional[bool] = None):
        super().__init__()
        self.algebra = algebra
        self.in_features = in_features
        self.hidden_features = hidden_features
        self.out_features = out_features
        self.n_layers = n_layers
        self.normalization_init = normalization_init
        self.fused = fused
        self.widths = ([in_features] + [hidden_features] * (n_layers - 1)
                       + [out_features])
        for i in range(n_layers):
            f_in, f_out = self.widths[i], self.widths[i + 1]
            setattr(self, f"linear_{i}", MVLinear(algebra, f_in, f_out))
            setattr(self, f"silu_{i}", MVSiLU(algebra, f_out))
            setattr(self, f"gp_{i}", SteerableGeometricProductLayer(
                algebra, f_out, normalization_init=normalization_init))
            setattr(self, f"norm_{i}", MVLayerNorm(algebra, f_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if cemlp_route(self, x.device.type) == "kernels":
            from ..ops.cemlp_kernel import apply_fused_cemlp

            return apply_fused_cemlp(self, x)
        for i in range(self.n_layers):
            x = getattr(self, f"linear_{i}")(x)
            x = getattr(self, f"silu_{i}")(x)
            x = getattr(self, f"gp_{i}")(x)
            x = getattr(self, f"norm_{i}")(x)
        return x


def init_parameters(module: nn.Module, generator=None) -> None:
    """Re-initialise every submodule that has ``reset_parameters`` from
    ``generator`` (a seeded ``torch.Generator``), in module order."""
    for m in module.modules():
        fn = getattr(m, "reset_parameters", None)
        if fn is not None:
            fn(generator)
