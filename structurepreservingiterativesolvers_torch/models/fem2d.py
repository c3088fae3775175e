"""2-D P1 and P2 finite-element assembly on structured triangulations (pure
numpy, host side).

A copy of the JAX package's ``models/fem2d.py``: importing that module
through its package would import JAX, which the port never does.

Rebuilds the operators the reference obtains from Firedrake's
``UnitSquareMesh`` for the heat problem (reference ``heat/heat.py:35-121``):
P1 mass and stiffness matrices on an M×M square grid split into right
triangles, plus the integration vector and L2 projection.  Natural (Neumann)
boundary — no BC rows, matching the reference weak form.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import scipy.sparse as sp


class SpaceP1:
    """P1 Lagrange space on an M×M structured triangulation of [0,L]²."""

    def __init__(self, M: int, length: float = 1.0):
        self.M = M
        self.L = float(length)
        self.h = self.L / M
        self.nv = (M + 1) * (M + 1)

        # vertices
        ii, jj = np.meshgrid(np.arange(M + 1), np.arange(M + 1), indexing="ij")
        self.xy = np.stack([ii.ravel() * self.h, jj.ravel() * self.h], axis=1)

        # two triangles per cell, diagonal lower-left → upper-right
        ci, cj = np.meshgrid(np.arange(M), np.arange(M), indexing="ij")
        v00 = (ci * (M + 1) + cj).ravel()
        v10 = ((ci + 1) * (M + 1) + cj).ravel()
        v01 = (ci * (M + 1) + cj + 1).ravel()
        v11 = ((ci + 1) * (M + 1) + cj + 1).ravel()
        lower = np.stack([v00, v10, v11], axis=1)
        upper = np.stack([v00, v11, v01], axis=1)
        self.tri = np.empty((2 * M * M, 3), dtype=np.int64)
        self.tri[0::2] = lower
        self.tri[1::2] = upper

    def _geometry(self):
        # memoised: linforms touches geometry through mass/stiffness/omega/
        # project — five rebuilds cost ~3.6 s at M=1024 (~15 s at 2048)
        cached = getattr(self, "_geom_cache", None)
        if cached is not None:
            return cached
        p = self.xy[self.tri]  # (nt, 3, 2)
        d1 = p[:, 1] - p[:, 0]
        d2 = p[:, 2] - p[:, 0]
        det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
        area = 0.5 * np.abs(det)
        # gradients of barycentric basis: grad λ_a
        b = np.empty((len(self.tri), 3, 2))
        b[:, 0, 0] = p[:, 1, 1] - p[:, 2, 1]
        b[:, 0, 1] = p[:, 2, 0] - p[:, 1, 0]
        b[:, 1, 0] = p[:, 2, 1] - p[:, 0, 1]
        b[:, 1, 1] = p[:, 0, 0] - p[:, 2, 0]
        b[:, 2, 0] = p[:, 0, 1] - p[:, 1, 1]
        b[:, 2, 1] = p[:, 1, 0] - p[:, 0, 0]
        b /= det[:, None, None]
        self._geom_cache = (area, b)
        return area, b

    def _scatter(self, blocks: np.ndarray) -> sp.csr_matrix:
        rows = np.repeat(self.tri, 3, axis=1).ravel()
        cols = np.tile(self.tri, (1, 3)).ravel()
        return sp.csr_matrix((blocks.ravel(), (rows, cols)), shape=(self.nv, self.nv))

    def mass(self) -> sp.csr_matrix:
        # memoised: both linforms and project() need it (one CSR scatter
        # costs ~6.5 s at M=1024)
        cached = getattr(self, "_mass_cache", None)
        if cached is not None:
            return cached
        area, _ = self._geometry()
        Me = (np.ones((3, 3)) + np.eye(3)) / 12.0  # |T|·(2 diag, 1 off)/12
        self._mass_cache = self._scatter(area[:, None, None] * Me[None])
        return self._mass_cache

    def stiffness(self) -> sp.csr_matrix:
        area, b = self._geometry()
        Ke = np.einsum("tad,tbd->tab", b, b) * area[:, None, None]
        return self._scatter(Ke)

    def omega(self) -> np.ndarray:
        area, _ = self._geometry()
        w = np.zeros(self.nv)
        np.add.at(w, self.tri.ravel(), np.repeat(area / 3.0, 3))
        return w

    def _project_rhs_solve(self, rhs: np.ndarray) -> np.ndarray:
        import scipy.sparse.linalg as spla

        Mh = self.mass()
        dinv = 1.0 / Mh.diagonal()
        u, info = spla.cg(
            Mh, rhs, rtol=1e-14, maxiter=200,
            M=spla.LinearOperator(Mh.shape, lambda v: dinv * v),
        )
        return spla.spsolve(Mh, rhs) if info != 0 else u

    def project(self, f: Callable[[np.ndarray, np.ndarray], np.ndarray]) -> np.ndarray:
        """L2 projection via edge-midpoint quadrature (exact to degree 2)."""
        import scipy.sparse.linalg as spla

        area, _ = self._geometry()
        p = self.xy[self.tri]  # (nt, 3, 2)
        mids = 0.5 * (p + np.roll(p, -1, axis=1))  # (nt, 3, 2) edge midpoints
        fm = f(mids[..., 0], mids[..., 1])  # (nt, 3)
        # midpoint rule: ∫_T f φ_a = |T|/3 Σ_m f(m) φ_a(m); φ_a(midpoint) = ½
        # at the two midpoints adjacent to vertex a, 0 at the opposite one
        phi_m = 0.5 * (np.ones((3, 3)) - np.roll(np.eye(3), -1, axis=1).T)
        # phi_m[a, m] = φ_a at midpoint m (m = edge between vertices m, m+1)
        phi_m = np.zeros((3, 3))
        for a in range(3):
            for m in range(3):
                phi_m[a, m] = 0.5 * ((m == a) + ((m + 1) % 3 == a))
        rhs_loc = (area[:, None] / 3.0) * np.einsum("tm,am->ta", fm, phi_m)
        rhs = np.zeros(self.nv)
        np.add.at(rhs, self.tri.ravel(), rhs_loc.ravel())
        # the Pk mass matrix is exceptionally well conditioned: Jacobi-CG
        # reaches 1e-14 in ~30 iterations and beats a sparse LU by ~10× at
        # large n
        return self._project_rhs_solve(rhs)


# degree-4 symmetric quadrature on the reference triangle (6 points)
_QP_W = np.array([0.223381589678011] * 3 + [0.109951743655322] * 3)
_QP_A = 0.445948490915965
_QP_B = 0.091576213509771
_QP_BARY = np.array(
    [
        [1 - 2 * _QP_A, _QP_A, _QP_A],
        [_QP_A, 1 - 2 * _QP_A, _QP_A],
        [_QP_A, _QP_A, 1 - 2 * _QP_A],
        [1 - 2 * _QP_B, _QP_B, _QP_B],
        [_QP_B, 1 - 2 * _QP_B, _QP_B],
        [_QP_B, _QP_B, 1 - 2 * _QP_B],
    ]
)


class SpaceP2(SpaceP1):
    """P2 Lagrange space on the same structured triangulation: 3 vertex +
    3 edge-midpoint dofs per triangle (reference heat accepts a degree
    parameter, heat/heat.py:23-25; this provides degree 2)."""

    def __init__(self, M: int, length: float = 1.0):
        super().__init__(M, length)
        # unique edges (sorted vertex pairs) → edge dof ids after vertices
        e = np.concatenate(
            [self.tri[:, [0, 1]], self.tri[:, [1, 2]], self.tri[:, [0, 2]]]
        )
        e.sort(axis=1)
        uniq, inv = np.unique(e, axis=0, return_inverse=True)
        nt = len(self.tri)
        self.edge_of_tri = inv.reshape(3, nt).T  # local edges (01, 12, 02)
        self.nedge = len(uniq)
        self.edges = uniq
        self.ndof = self.nv + self.nedge
        # local dof order: v0 v1 v2, e01, e12, e02
        self.loc = np.concatenate(
            [self.tri, self.nv + self.edge_of_tri], axis=1
        )  # (nt, 6)

    @staticmethod
    def _basis(bary: np.ndarray):
        """P2 basis values and barycentric-gradient weights at barycentric
        points; returns (vals (npts,6), dcoef (npts,6,3)) where the physical
        gradient is Σ_c dcoef[...,c]·grad λ_c."""
        l0, l1, l2 = bary[:, 0], bary[:, 1], bary[:, 2]
        vals = np.stack(
            [
                l0 * (2 * l0 - 1), l1 * (2 * l1 - 1), l2 * (2 * l2 - 1),
                4 * l0 * l1, 4 * l1 * l2, 4 * l0 * l2,
            ],
            axis=1,
        )
        z = np.zeros_like(l0)
        dcoef = np.stack(
            [
                np.stack([4 * l0 - 1, z, z], axis=1),
                np.stack([z, 4 * l1 - 1, z], axis=1),
                np.stack([z, z, 4 * l2 - 1], axis=1),
                np.stack([4 * l1, 4 * l0, z], axis=1),
                np.stack([z, 4 * l2, 4 * l1], axis=1),
                np.stack([4 * l2, z, 4 * l0], axis=1),
            ],
            axis=1,
        )  # (npts, 6, 3)
        return vals, dcoef

    def _scatter6(self, blocks: np.ndarray) -> sp.csr_matrix:
        rows = np.repeat(self.loc, 6, axis=1).ravel()
        cols = np.tile(self.loc, (1, 6)).ravel()
        return sp.csr_matrix(
            (blocks.ravel(), (rows, cols)), shape=(self.ndof, self.ndof)
        )

    def mass(self) -> sp.csr_matrix:
        cached = getattr(self, "_mass_cache", None)
        if cached is not None:
            return cached
        area, _ = self._geometry()
        vals, _ = self._basis(_QP_BARY)  # (nq, 6)
        Me = np.einsum("q,qa,qb->ab", _QP_W, vals, vals)  # ∫ref scaled by |T|
        self._mass_cache = self._scatter6(area[:, None, None] * Me[None])
        return self._mass_cache

    def stiffness(self) -> sp.csr_matrix:
        area, gl = self._geometry()  # gl: (nt, 3, 2) grad λ
        _, dcoef = self._basis(_QP_BARY)  # (nq, 6, 3)
        # physical gradient of basis a at point q in triangle t:
        # G[t,q,a,:] = Σ_c dcoef[q,a,c] gl[t,c,:]
        G = np.einsum("qac,tcd->tqad", dcoef, gl)
        Ke = np.einsum("q,tqad,tqbd,t->tab", _QP_W, G, G, area)
        return self._scatter6(Ke)

    def omega(self) -> np.ndarray:
        area, _ = self._geometry()
        vals, _ = self._basis(_QP_BARY)
        elem = np.einsum("q,qa->a", _QP_W, vals)  # per unit area
        w = np.zeros(self.ndof)
        np.add.at(w, self.loc.ravel(), np.outer(area, elem).ravel())
        return w

    def project(self, f: Callable[[np.ndarray, np.ndarray], np.ndarray]) -> np.ndarray:
        area, _ = self._geometry()
        p = self.xy[self.tri]  # (nt, 3, 2)
        pts = np.einsum("qc,tcd->tqd", _QP_BARY, p)  # (nt, nq, 2)
        fx = f(pts[..., 0], pts[..., 1])  # (nt, nq)
        vals, _ = self._basis(_QP_BARY)
        rhs_loc = np.einsum("q,tq,qa,t->ta", _QP_W, fx, vals, area)
        rhs = np.zeros(self.ndof)
        np.add.at(rhs, self.loc.ravel(), rhs_loc.ravel())
        return self._project_rhs_solve(rhs)
