"""Basis-blade combinatorics for Clifford algebras Cl(p, q, r).

Host-side (numpy) construction of the short-lex basis-blade order and the
geometric multiplication table (Cayley tensor).  This is pure combinatorics
executed once at model-construction time; the resulting dense numpy tables
become constant tensors of the layers and the kernels.

Capability parity with the reference blade/bitmap layer
(`csmpn/algebra/metric.py:18-120` in the reference repo): short-lex order over
the 2^n blades, sign-correct multiplication table.  The implementation here is
an independent, numpy-native derivation of the standard algorithm
("Geometric Algebra for Computer Science", ch. 19).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np


def _popcount(x: int) -> int:
    return bin(x).count("1")


def reordering_sign_euclidean(bitmap_a: int, bitmap_b: int) -> int:
    """Sign incurred by sorting the concatenation of blades a and b.

    Counts, for every basis vector in ``a``, how many lower-indexed basis
    vectors of ``b`` it has to commute past.  Equivalent semantics to the
    reference's ``canonical_reordering_sign_euclidean`` (metric.py:50-63).
    """
    a = bitmap_a >> 1
    total = 0
    while a != 0:
        total += _popcount(a & bitmap_b)
        a >>= 1
    return 1 if total % 2 == 0 else -1


def reordering_sign(bitmap_a: int, bitmap_b: int, metric: np.ndarray) -> float:
    """Full sign including metric contractions of repeated basis vectors."""
    sign = float(reordering_sign_euclidean(bitmap_a, bitmap_b))
    common = bitmap_a & bitmap_b
    i = 0
    while common != 0:
        if common & 1:
            sign *= float(metric[i])
        i += 1
        common >>= 1
    return sign


def blade_product(bitmap_a: int, bitmap_b: int, metric: np.ndarray):
    """Product of two basis blades: (output_bitmap, scalar_coefficient)."""
    return bitmap_a ^ bitmap_b, reordering_sign(bitmap_a, bitmap_b, metric)


@dataclass(frozen=True)
class BladeOrder:
    """Short-lex basis-blade order for an n-dimensional generating space.

    Blades are ordered by grade first, then lexicographically by the sorted
    tuple of generator indices — e.g. for n=3:
    ``1, e1, e2, e3, e12, e13, e23, e123``.
    """

    n_vectors: int
    index_to_bitmap: np.ndarray = field(init=False)
    bitmap_to_index: np.ndarray = field(init=False)
    grades: np.ndarray = field(init=False)

    def __post_init__(self):
        n = self.n_vectors
        index_to_bitmap = np.zeros(2**n, dtype=np.int64)
        bitmap_to_index = np.zeros(2**n, dtype=np.int64)
        grades = np.zeros(2**n, dtype=np.int64)
        gens = list(range(n))
        i = 0
        for g in range(n + 1):
            for combo in itertools.combinations(gens, g):
                bitmap = 0
                for c in combo:
                    bitmap |= 1 << c
                index_to_bitmap[i] = bitmap
                bitmap_to_index[bitmap] = i
                grades[i] = g
                i += 1
        object.__setattr__(self, "index_to_bitmap", index_to_bitmap)
        object.__setattr__(self, "bitmap_to_index", bitmap_to_index)
        object.__setattr__(self, "grades", grades)


def cayley_table(order: BladeOrder, metric: np.ndarray) -> np.ndarray:
    """Dense Cayley tensor C with ``(a * b)_j = sum_ik a_i C[i, j, k] b_k``.

    Index convention matches the reference's einsum ``...i,ijk,...k->...j``
    (cliffordalgebra.py:54): first axis = left blade, middle axis = output
    blade, last axis = right blade.
    """
    n = len(order.index_to_bitmap)
    table = np.zeros((n, n, n), dtype=np.float64)
    for i in range(n):
        bi = int(order.index_to_bitmap[i])
        for k in range(n):
            bk = int(order.index_to_bitmap[k])
            out_bitmap, coeff = blade_product(bi, bk, metric)
            j = int(order.bitmap_to_index[out_bitmap])
            table[i, j, k] += coeff
    return table
