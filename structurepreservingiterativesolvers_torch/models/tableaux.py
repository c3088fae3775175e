"""Butcher tableaux for collocation Runge–Kutta methods.

A copy of the JAX package's ``models/tableaux.py`` (numpy only).  Native
replacement for Irksome's ``GaussLegendre`` tableau provider
(reference ``lkdvRK/lkdvRK.py:28``).  Gauss–Legendre collocation is
symplectic and conserves quadratic invariants exactly — the property the
lkdvRK experiments rely on.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ButcherTableau(NamedTuple):
    A: np.ndarray  # (s, s)
    b: np.ndarray  # (s,)
    c: np.ndarray  # (s,)

    @property
    def num_stages(self) -> int:
        return len(self.b)


def gauss_legendre(s: int) -> ButcherTableau:
    """s-stage Gauss–Legendre collocation (order 2s)."""
    if s < 1:
        raise ValueError("need at least one stage")
    # nodes: roots of the shifted Legendre polynomial P_s(2t-1) on [0,1]
    x, w = np.polynomial.legendre.leggauss(s)
    c = 0.5 * (x + 1.0)
    b = 0.5 * w
    # a_ij = ∫_0^{c_i} ℓ_j(t) dt with ℓ_j the Lagrange basis at the nodes
    A = np.empty((s, s))
    for j in range(s):
        coeffs = np.zeros(s)
        coeffs[j] = 1.0
        # Lagrange basis via polynomial interpolation at the nodes
        lj = np.polynomial.polynomial.Polynomial.fit(c, coeffs, s - 1, domain=[0, 1], window=[0, 1])
        integ = lj.integ()
        A[:, j] = integ(c) - integ(0.0)
    return ButcherTableau(A=A, b=b, c=c)
