"""Clifford-equivariant neural layers as torch ``nn.Module``s.

Port of ``csmpn_tpu/nn/modules.py``: MVLinear, MVSiLU, NormalizationLayer,
MVLayerNorm, SteerableGeometricProductLayer (dense form) and CEMLP, with the
parameter names and shapes of the flax tree, so ``convert.params_from_jax``
maps one onto the other by path.  Multivector activations are laid out as
``(..., channels, n_blades)`` with the blade axis last.

On a CUDA tensor a CEMLP runs each of its blocks as one hand-written kernel
(``ops/cemlp_kernel.py``); on the CPU it composes the layers below, as the
reference package does off the TPU.
"""
from __future__ import annotations

import math

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
    invariants (scalar blade passthrough, squared magnitudes above)."""

    def __init__(self, algebra: CliffordAlgebra, channels: int):
        super().__init__()
        self.algebra = algebra
        self.channels = channels
        self.a = nn.Parameter(torch.ones(channels, algebra.dim + 1))
        self.b = nn.Parameter(torch.zeros(channels, algebra.dim + 1))

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.a)
        nn.init.zeros_(self.b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alg = self.algebra
        inv = torch.cat([x[..., :1], alg.qs_cat(x)[..., 1:]], dim=-1)
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
    """Fully parameterised geometric product ``x (x)_w normalize(W x)``
    plus the first-order term: one weight per (channel, nonzero
    grade-triple path), contracted with the Cayley tensor in one einsum
    (the dense form)."""

    def __init__(self, algebra: CliffordAlgebra, features: int,
                 normalization_init: float = 0.0):
        super().__init__()
        self.algebra = algebra
        self.features = features
        self.weight = nn.Parameter(torch.empty(features,
                                               algebra.n_product_paths))
        self.linear_right = MVLinear(algebra, features, features,
                                     use_bias=False)
        self.normalization = NormalizationLayer(algebra, features,
                                                normalization_init)
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
        x_right = self.normalization(self.linear_right(x))
        weighted = self.weighted_cayley().to(x.dtype)
        out = torch.einsum("...ni,nijk,...nk->...nj", x, weighted, x_right)
        return (self.linear_left(x) + out) / math.sqrt(2)


class CEMLP(nn.Module):
    """Stack of [MVLinear -> MVSiLU -> SGP -> MVLayerNorm] blocks, the
    shared message/update network of EGCL and of the simplex embedding."""

    def __init__(self, algebra: CliffordAlgebra, in_features: int,
                 hidden_features: int, out_features: int, n_layers: int = 2,
                 normalization_init: float = 0.0):
        super().__init__()
        self.algebra = algebra
        self.in_features = in_features
        self.hidden_features = hidden_features
        self.out_features = out_features
        self.n_layers = n_layers
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
        if x.is_cuda:
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
