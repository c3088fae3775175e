"""1-D periodic finite-element assembly (pure numpy, host side).

A copy of the JAX package's ``models/fem1d.py``: importing that module
through its package would import JAX, which the port never does.

Rebuilds, without Firedrake, the operators the reference assembles for the
linear KdV problems (reference ``lkdv/lkdv.py:46-148``):

* mass matrix ``M`` on DG(q) or CG(q) over a periodic interval;
* the antisymmetric first-derivative operator ``G`` (the reference's
  ``gfunc``: ∫ u' v dx − Σ_facets [u]·n {v} dS, lkdv/lkdv.py:55-57) —
  antisymmetry is what makes momentum/energy quadratic invariants of the
  midpoint scheme;
* the integration vector ω (ω_a = ∫ φ_a dx);
* L2 projection of a callable onto the space (the reference's
  ``project``/``gfuncproject``, lkdv/lkdv.py:62-79).

Everything returns scipy CSR; device conversion happens in the model layer.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import scipy.sparse as sp


def lagrange_basis(q: int, pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Values and derivatives of the q+1 equispaced Lagrange basis on [-1,1]
    evaluated at ``pts``; returns (vals, derivs) of shape (q+1, len(pts))."""
    nodes = np.array([0.0]) if q == 0 else np.linspace(-1.0, 1.0, q + 1)
    nb = len(nodes)
    vals = np.empty((nb, len(pts)))
    ders = np.empty((nb, len(pts)))
    for a in range(nb):
        others = np.delete(nodes, a)
        denom = np.prod(nodes[a] - others) if nb > 1 else 1.0
        diffs = pts[None, :] - others[:, None]  # (nb-1, npts)
        vals[a] = np.prod(diffs, axis=0) / denom if nb > 1 else 1.0
        d = np.zeros(len(pts))
        for skip in range(nb - 1):
            d += np.prod(np.delete(diffs, skip, axis=0), axis=0)
        ders[a] = d / denom if nb > 1 else 0.0
    return vals, ders


class Space1D:
    """Periodic 1-D DG(q) or CG(q) Lagrange space on M equal elements."""

    def __init__(self, M: int, length: float, degree: int, kind: str = "DG"):
        if kind not in ("DG", "CG"):
            raise ValueError(f"space kind must be DG or CG, got {kind}")
        if kind == "CG" and degree < 1:
            raise ValueError("CG requires degree >= 1")
        self.M = M
        self.length = float(length)
        self.h = self.length / M
        self.q = degree
        self.kind = kind
        self.nloc = degree + 1
        self.ndof = M * self.nloc if kind == "DG" else M * degree

        # local->global map, (M, nloc)
        e = np.arange(M)[:, None]
        a = np.arange(self.nloc)[None, :]
        if kind == "DG":
            self.lg = e * self.nloc + a
        else:
            self.lg = (e * degree + a) % self.ndof

        # quadrature (exact for degree-2q integrands and products with data)
        xg, wg = np.polynomial.legendre.leggauss(max(self.q + 2, 3))
        self.xq, self.wq = xg, wg
        self.phi, self.dphi = lagrange_basis(self.q, xg)  # (nloc, nq)
        edge = lagrange_basis(self.q, np.array([-1.0, 1.0]))[0]
        self.eL, self.eR = edge[:, 0], edge[:, 1]

        # element matrices on the reference element
        self.Me = (self.h / 2.0) * (self.phi * wg) @ self.phi.T
        # ∫ u' v : rows test (v = phi_a), cols trial (u' = dphi_b); the h/2
        # Jacobian cancels the 2/h derivative scaling
        self.De = (self.phi * wg) @ self.dphi.T

    def _scatter(self, blocks: np.ndarray) -> sp.csr_matrix:
        """Sum (M, nloc, nloc) per-element blocks into a global CSR."""
        rows = np.repeat(self.lg, self.nloc, axis=1).ravel()
        cols = np.tile(self.lg, (1, self.nloc)).ravel()
        return sp.csr_matrix(
            (blocks.ravel(), (rows, cols)), shape=(self.ndof, self.ndof)
        )

    def mass(self) -> sp.csr_matrix:
        return self._scatter(np.broadcast_to(self.Me, (self.M, self.nloc, self.nloc)).copy())

    def gfunc(self) -> sp.csr_matrix:
        """The antisymmetric derivative operator G (volume + DG face terms)."""
        A = self._scatter(np.broadcast_to(self.De, (self.M, self.nloc, self.nloc)).copy())
        if self.kind == "DG":
            A = sp.lil_matrix(A)
            eL, eR = self.eL, self.eR
            for e in range(self.M):
                er = e + 1 if e + 1 < self.M else 0  # periodic right neighbour
                gl, gr = self.lg[e], self.lg[er]
                # −(u_L − u_R)·½(v_L + v_R) at the facet between e and er
                A[np.ix_(gl, gl)] += -0.5 * np.outer(eR, eR)
                A[np.ix_(gr, gl)] += -0.5 * np.outer(eL, eR)
                A[np.ix_(gl, gr)] += +0.5 * np.outer(eR, eL)
                A[np.ix_(gr, gr)] += +0.5 * np.outer(eL, eL)
            A = sp.csr_matrix(A)
        return A

    def omega(self) -> np.ndarray:
        w = np.zeros(self.ndof)
        elem = (self.h / 2.0) * (self.phi @ self.wq)  # (nloc,)
        np.add.at(w, self.lg.ravel(), np.tile(elem, self.M))
        return w

    def element_coords(self) -> np.ndarray:
        """Physical quadrature coordinates, (M, nq)."""
        left = np.arange(self.M)[:, None] * self.h
        return left + (self.xq[None, :] + 1.0) * (self.h / 2.0)

    def project(self, f: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
        """L2 projection: solve M u = (f, φ)."""
        x = self.element_coords()  # (M, nq)
        fx = f(x)
        rhs_loc = (fx * self.wq[None, :]) @ self.phi.T * (self.h / 2.0)  # (M, nloc)
        rhs = np.zeros(self.ndof)
        np.add.at(rhs, self.lg.ravel(), rhs_loc.ravel())
        import scipy.sparse.linalg as spla

        return spla.spsolve(self.mass(), rhs)
