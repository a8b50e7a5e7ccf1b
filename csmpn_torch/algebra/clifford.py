"""Clifford algebra runtime on torch tensors.

Port of ``csmpn_tpu/algebra/clifford.py``.  The algebra object is a plain
host-side Python object: all tables are numpy constants built once per
metric signature.  Tensor methods take and return torch tensors, are
shape-polymorphic over leading batch dimensions, and keep the blade axis
last.

Conventions (identical to the reference package):
  * short-lex blade order (blades.BladeOrder)
  * geometric product contraction ``...i,ijk,...k->...j``
  * smooth-abs-sqrt ``(q^2 + 1e-16)^0.25`` for norms
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch

from .blades import BladeOrder, cayley_table


class CliffordAlgebra:
    """Clifford algebra Cl(metric) over R with a diagonal metric, e.g.
    ``(1.0, 1.0, 1.0)`` for Cl(3, 0)."""

    def __init__(self, metric: Sequence[float]):
        self.metric = np.asarray(metric, dtype=np.float64)
        self.dim = len(self.metric)
        self.n_blades = 2**self.dim
        self.bbo = BladeOrder(self.dim)
        self.cayley = cayley_table(self.bbo, self.metric).astype(np.float32)
        self.bbo_grades = self.bbo.grades
        self.grades = np.unique(self.bbo_grades)
        self.n_subspaces = len(self.grades)
        self.subspaces = np.asarray(
            [math.comb(self.dim, int(g)) for g in self.grades], dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(self.subspaces)])
        self.grade_to_slice = [
            slice(int(starts[g]), int(starts[g + 1])) for g in range(self.dim + 1)
        ]
        g = self.bbo_grades.astype(np.float64)
        self._alpha_signs = np.power(-1.0, g).astype(np.float32)
        self._beta_signs = np.power(-1.0, g * (g - 1) / 2).astype(np.float32)
        self._gamma_signs = np.power(-1.0, g * (g + 1) / 2).astype(np.float32)
        self.even_grades = (self.bbo_grades % 2 == 0)
        self.odd_grades = ~self.even_grades
        # blade_i * blade_k has a grade-0 component only when i == k, so
        # b(x, y)[..., 0] = sum_i beta_signs[i] * q_diag[i] * x_i * y_i
        self._q_diag = np.einsum("ii->i", self.cayley[:, 0, :]).copy()
        self._b_coeff = (self._beta_signs * self._q_diag).astype(np.float32)
        self.blade_to_grade = self.bbo_grades.astype(np.int64)
        self._consts = {}

    def const(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """A numpy table of this algebra as a tensor on ``like``'s device
        and dtype, cached so the hot path copies it to the device once."""
        key = (name, like.device, like.dtype)
        t = self._consts.get(key)
        if t is None:
            t = torch.as_tensor(getattr(self, name), device=like.device,
                                dtype=like.dtype)
            self._consts[key] = t
        return t

    def index(self, name: str, device) -> torch.Tensor:
        """An integer table (e.g. ``blade_to_grade``) on ``device``."""
        key = (name, torch.device(device), torch.int64)
        t = self._consts.get(key)
        if t is None:
            t = torch.as_tensor(np.asarray(getattr(self, name)),
                                dtype=torch.int64, device=device)
            self._consts[key] = t
        return t

    # ------------------------------------------------------------------ core

    def geometric_product(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum("...i,ijk,...k->...j", a, self.const("cayley", a), b)

    # -------------------------------------------------------- grade machinery

    def embed_grade(self, tensor: torch.Tensor, grade: int) -> torch.Tensor:
        s = self.grade_to_slice[grade]
        return torch.nn.functional.pad(tensor, (s.start, self.n_blades - s.stop))

    # ------------------------------------------------------------ involutions

    def alpha(self, mv: torch.Tensor) -> torch.Tensor:
        return mv * self.const("_alpha_signs", mv)

    def beta(self, mv: torch.Tensor) -> torch.Tensor:
        return mv * self.const("_beta_signs", mv)

    def gamma(self, mv: torch.Tensor) -> torch.Tensor:
        return mv * self.const("_gamma_signs", mv)

    # --------------------------------------------------------- quadratic form

    def b(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Scalar-blade bilinear form b(x, y) = <beta(x) y>_0, (..., 1)."""
        return torch.sum(self.const("_b_coeff", x) * x * y, dim=-1, keepdim=True)

    def q(self, mv: torch.Tensor) -> torch.Tensor:
        return self.b(mv, mv)

    @staticmethod
    def _smooth_abs_sqrt(x: torch.Tensor, eps: float = 1e-16) -> torch.Tensor:
        return (x**2 + eps) ** 0.25

    def norm(self, mv: torch.Tensor) -> torch.Tensor:
        return self._smooth_abs_sqrt(self.q(mv))

    def qs_cat(self, mv: torch.Tensor) -> torch.Tensor:
        """All per-grade squared magnitudes: (..., n_subspaces)."""
        sq = mv * mv * self.const("_b_coeff", mv)
        return sq @ self.const("grade_onehot", mv)

    def norms_cat(self, mv: torch.Tensor) -> torch.Tensor:
        """All per-grade norms: (..., n_subspaces)."""
        return self._smooth_abs_sqrt(self.qs_cat(mv))

    @functools.cached_property
    def grade_onehot(self) -> np.ndarray:
        m = np.zeros((self.n_blades, self.n_subspaces), dtype=np.float32)
        m[np.arange(self.n_blades), self.bbo_grades] = 1.0
        return m

    def expand_per_grade(self, per_grade: torch.Tensor) -> torch.Tensor:
        """(..., n_subspaces) -> (..., n_blades) by a static gather."""
        return per_grade[..., self.index("blade_to_grade", per_grade.device)]

    # ----------------------------------------------------------- versor tools

    def parity_is_odd(self, mv: torch.Tensor) -> bool:
        even = torch.as_tensor(self.even_grades, device=mv.device)
        odd = torch.as_tensor(self.odd_grades, device=mv.device)
        even_zero = bool(torch.all(mv[..., even] == 0))
        odd_zero = bool(torch.all(mv[..., odd] == 0))
        if even_zero ^ odd_zero:
            return even_zero
        raise ValueError("Not a homogeneous element.")

    def eta(self, w: torch.Tensor) -> float:
        return -1.0 if self.parity_is_odd(w) else 1.0

    def alpha_w(self, w: torch.Tensor, mv: torch.Tensor) -> torch.Tensor:
        even = torch.as_tensor(self.even_grades, dtype=mv.dtype, device=mv.device)
        odd = torch.as_tensor(self.odd_grades, dtype=mv.dtype, device=mv.device)
        return even * mv + self.eta(w) * odd * mv

    def inverse(self, mv: torch.Tensor) -> torch.Tensor:
        """Versor inverse beta(mv) / <mv beta(mv)>_0 — the corrected
        quadratic-form denominator, so that ``rho`` is an isometry."""
        return self.beta(mv) / self.q(mv)

    def sandwich(self, u, v, w):
        return self.geometric_product(self.geometric_product(u, v), w)

    def rho(self, w: torch.Tensor, mv: torch.Tensor) -> torch.Tensor:
        """Versor action of w on mv (twisted conjugation)."""
        return self.sandwich(w, self.alpha_w(w, mv), self.inverse(w))

    def random_vector(self, generator: torch.Generator, n: int = 1) -> torch.Tensor:
        v = torch.zeros((n, self.n_blades))
        v[:, self.grade_to_slice[1]] = torch.randn((n, self.dim),
                                                   generator=generator)
        return v

    def versor(self, generator: torch.Generator) -> torch.Tensor:
        """Random normalised rotor: the product of an even number of
        random vectors."""
        order = max(self.dim if self.dim % 2 == 0 else self.dim - 1, 2)
        vectors = self.random_vector(generator, order)
        out = vectors[0]
        for i in range(1, order):
            out = self.geometric_product(out, vectors[i])
        return out / self.norm(out)[..., :1]

    # ------------------------------------------------------ structural tables

    @functools.cached_property
    def geometric_product_paths(self) -> np.ndarray:
        """(dim+1)^3 bool table: which (grade_l, grade_out, grade_r) triples
        carry nonzero Cayley entries."""
        d = self.dim + 1
        paths = np.zeros((d, d, d), dtype=bool)
        for i in range(d):
            for j in range(d):
                for k in range(d):
                    block = self.cayley[self.grade_to_slice[i],
                                        self.grade_to_slice[j],
                                        self.grade_to_slice[k]]
                    paths[i, j, k] = bool((block != 0).any())
        return paths

    @functools.cached_property
    def n_product_paths(self) -> int:
        return int(self.geometric_product_paths.sum())

    @functools.cached_property
    def gp_pair_tables(self):
        """Sparse pair form of the geometric product: for every (output j,
        right k) exactly one left blade i = bitmap(j) ^ bitmap(k) carries a
        nonzero Cayley coefficient.  Returns (i_of, coeff), each (nb, nb),
        with (a * b)_j = sum_k coeff[j,k] * a[i_of[j,k]] * b[k]."""
        nb = self.n_blades
        btm = self.bbo.index_to_bitmap
        i_of = np.zeros((nb, nb), dtype=np.int32)
        coeff = np.zeros((nb, nb), dtype=np.float32)
        for j in range(nb):
            for k in range(nb):
                i = int(self.bbo.bitmap_to_index[btm[j] ^ btm[k]])
                i_of[j, k] = i
                coeff[j, k] = self.cayley[i, j, k]
        return i_of, coeff

    @property
    def pair_i_of(self) -> np.ndarray:
        return self.gp_pair_tables[0]

    @property
    def pair_coeff(self) -> np.ndarray:
        return self.gp_pair_tables[1]

    @functools.cached_property
    def gp_pair_paths(self) -> np.ndarray:
        """(nb, nb) int: index into an SGP weight row of the grade path of
        the pair (j, k), i.e. of (grade(i_of[j,k]), grade(j), grade(k))."""
        path_id = -np.ones((self.dim + 1,) * 3, dtype=np.int64)
        idx = np.argwhere(self.geometric_product_paths)
        path_id[idx[:, 0], idx[:, 1], idx[:, 2]] = np.arange(len(idx))
        i_of, _ = self.gp_pair_tables
        g = self.blade_to_grade
        return path_id[g[i_of], g[:, None], g[None, :]]

@functools.lru_cache(maxsize=None)
def get_algebra(metric: tuple) -> CliffordAlgebra:
    """Cached algebra instances keyed by metric tuple."""
    return CliffordAlgebra(tuple(float(m) for m in metric))
