"""1-D linear KdV test problem (u_t + u_x + u_xxx = 0, periodic).

The port of the JAX package's ``models/lkdv.py`` (reference
``lkdv/lkdv.py``): a mixed 3-field (u, v, w) formulation on DG/CG degree q
with a midpoint step, assembled by the numpy code in ``fem1d`` into the
3×3 block system

    A = [[ M/dt ,  G  ,  0   ]        b = [ M/dt·u0            ]
         [ −½M  ,  M  , −½G  ]            [ ½M·u0 + ½G·w0      ]
         [ −G   ,  0  ,  M   ]]           [ 0                  ]

with invariants  mass = ω·u,  momentum = ½uᵀMu,  energy = ½wᵀMw − ½uᵀMu
(reference lkdv/lkdv.py:122-146, lkdv/LinearSolver.py:28-44).  The operators
land on the given device as DIA matrices.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..config import DEFAULT_DTYPE
from ..constraints.quadratic import QuadraticConstraint, target_dot, target_quad
from ..ops.sparse import from_scipy
from .fem1d import Space1D

MLENGTH = 40.0


@dataclasses.dataclass
class Problem:
    """Problem parameters (mirror of reference lkdv/lkdv.py:15-37)."""

    N: int = 100
    M: int = 50
    degree: int = 1
    space: str = "DG"
    T: float = 1.0
    mlength: float = MLENGTH
    dim: int = 3

    def fem(self) -> Space1D:
        return Space1D(self.M, self.mlength, self.degree, self.space)

    def exact(self, x: np.ndarray, t: float) -> np.ndarray:
        """Travelling-wave initial condition (lkdv/lkdv.py:29-37)."""
        alpha = 4.0
        beta = alpha * 2.0 * np.pi / self.mlength
        return np.sin(beta * (x - (1.0 - beta**2) * t)) + 1.0


@dataclasses.dataclass
class System:
    """Assembled linear system and invariant data on one device."""

    # step_update and the invariants split the state into its fields (u, v,
    # w), which a row split cuts (fused_evolve(mesh=) reads it)
    row_local: ClassVar[bool] = False
    A: object
    b: torch.Tensor
    z0: torch.Tensor
    Mmat: object  # scalar-space mass matrix
    Gmat: object  # antisymmetric derivative operator
    omega: torch.Tensor  # scalar-space integration vector
    m0: torch.Tensor
    mo0: torch.Tensor
    e0: torch.Tensor
    prob: Problem
    n0: int  # scalar-space dim
    # host-side CSR kept for oracles (direct solve / scipy cross-checks)
    A_csr: sp.csr_matrix = dataclasses.field(repr=False, default=None)

    def constraints(self):
        """[mass, momentum, energy] — ordered as the reference conlist
        (lkdv/LinearSolver.py:47)."""
        n0 = self.n0
        omega_full = torch.zeros(3 * n0, dtype=self.b.dtype, device=self.b.device)
        omega_full[:n0] = self.omega
        mass = QuadraticConstraint(M=None, v=omega_full, c=-self.m0, name="mass")
        momentum = QuadraticConstraint(
            M=_BlockDiag3(self.Mmat, (1.0, 0.0, 0.0)), v=None, c=-self.mo0,
            name="momentum",
        )
        energy = QuadraticConstraint(
            M=_BlockDiag3(self.Mmat, (-1.0, 0.0, 1.0)), v=None, c=-self.e0,
            name="energy",
        )
        return [mass, momentum, energy]

    def compute_invariants(self, z: torch.Tensor,
                           zold: Optional[torch.Tensor] = None) -> dict:
        """The invariants of z; ``zold`` is unread (heat's read it)."""
        u, v, w = torch.split(z, self.n0)
        return {
            "mass": torch.dot(self.omega, u),
            "momentum": 0.5 * torch.dot(u, self.Mmat @ u),
            "energy": 0.5 * torch.dot(w, self.Mmat @ w)
            - 0.5 * torch.dot(u, self.Mmat @ u),
        }

    def step_update(self, z_prev: torch.Tensor) -> "System":
        """The next step's system from a solution: b and the invariant
        targets re-seeded on the system's device, the operators reused (the
        reference reassembles the whole system every step,
        lkdv/Evolve.py:57-59).  The targets are f64 sums from an f32 state
        (``target_dot``)."""
        dt_step = self.prob.T / self.prob.N
        u0, _, w0 = torch.split(z_prev, self.n0)
        Mu0 = self.Mmat @ u0
        b = torch.cat([
            Mu0 / dt_step,
            0.5 * Mu0 + 0.5 * (self.Gmat @ w0),
            torch.zeros(self.n0, dtype=z_prev.dtype, device=z_prev.device),
        ])
        return dataclasses.replace(
            self,
            b=b,
            z0=z_prev,
            m0=target_dot(self.omega, u0),
            mo0=0.5 * target_quad(self.Mmat, u0, Mz=Mu0),
            e0=0.5 * target_quad(self.Mmat, w0)
            - 0.5 * target_quad(self.Mmat, u0, Mz=Mu0),
        )


@dataclasses.dataclass(frozen=True)
class _BlockDiag3:
    """blockdiag(c0·M, c1·M, c2·M) as an operator on the 3-field vector
    (or on the rows of a tall (3·n0, m) matrix)."""

    Mmat: object
    coeffs: tuple

    @property
    def shape(self):
        n = 3 * self.Mmat.shape[0]
        return (n, n)

    def __matmul__(self, x):
        parts = torch.tensor_split(x, 3, dim=0)
        return torch.cat(
            [c * (self.Mmat @ p) if c else torch.zeros_like(p)
             for c, p in zip(self.coeffs, parts)],
            dim=0,
        )

    def matvec_f64(self, x):
        """The product in f64 from f32 x (``ops/sparse.py::matvec_f64``), a
        field at a time, as the JAX package's ``dd_matvec``."""
        from ..ops.sparse import matvec_f64

        parts = torch.tensor_split(x, 3, dim=0)
        return torch.cat(
            [c * matvec_f64(self.Mmat, p) if c
             else torch.zeros_like(p, dtype=torch.float64)
             for c, p in zip(self.coeffs, parts)],
            dim=0,
        )

    def f64_supported(self) -> bool:
        from ..ops.sparse import f64_supported

        return f64_supported(self.Mmat)

    def todense(self):
        Md = self.Mmat.todense()
        n0 = Md.shape[0]
        out = torch.zeros((3 * n0, 3 * n0), dtype=Md.dtype, device=Md.device)
        for f, c in enumerate(self.coeffs):
            if c:
                out[f * n0:(f + 1) * n0, f * n0:(f + 1) * n0] = c * Md
        return out


def linforms(
    N: int = 100,
    M: int = 50,
    degree: int = 1,
    T: float = 1.0,
    space: str = "DG",
    zinit: Optional[np.ndarray] = None,
    dtype=DEFAULT_DTYPE,
    *,
    device,
) -> System:
    """Assemble the lkdv step system (reference lkdv/lkdv.py:46-148) on
    ``device``.

    ``zinit`` (flat 3-field vector) re-seeds u0/w0 from a previous step, as
    the reference's Evolve loop does (lkdv/Evolve.py:57-59).
    """
    prob = Problem(N=N, M=M, degree=degree, space=space, T=float(T))
    fem = prob.fem()
    n0 = fem.ndof
    dt_step = prob.T / prob.N

    Mh = fem.mass()
    Gh = fem.gfunc()
    omega_h = fem.omega()

    if zinit is None:
        u0 = fem.project(lambda x: prob.exact(x, 0.0))
        import scipy.sparse.linalg as spla

        w0 = spla.spsolve(Mh, Gh @ u0)  # gfuncproject (lkdv/lkdv.py:62-69)
        v0 = np.zeros(n0)
    else:
        zinit = np.asarray(zinit)
        u0, v0, w0 = np.split(zinit, 3)
        # reference re-seeds only u and w (lkdv/lkdv.py:80-82)
        v0 = np.zeros(n0)

    Z = sp.csr_matrix((n0, n0))
    A_csr = sp.bmat(
        [
            [Mh / dt_step, Gh, Z],
            [-0.5 * Mh, Mh, -0.5 * Gh],
            [-Gh, Z, Mh],
        ],
        format="csr",
    )
    b = np.concatenate([Mh @ u0 / dt_step, 0.5 * (Mh @ u0) + 0.5 * (Gh @ w0), np.zeros(n0)])

    m0 = omega_h @ u0
    mo0 = 0.5 * u0 @ (Mh @ u0)
    e0 = 0.5 * w0 @ (Mh @ w0) - 0.5 * u0 @ (Mh @ u0)

    z0 = np.concatenate([u0, v0, w0])

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return System(
        A=from_scipy(A_csr, dtype=dtype, device=device),
        b=dev(b),
        z0=dev(z0),
        Mmat=from_scipy(Mh, dtype=dtype, device=device),
        Gmat=from_scipy(Gh, dtype=dtype, device=device),
        omega=dev(omega_h),
        m0=dev(m0),
        mo0=dev(mo0),
        e0=dev(e0),
        prob=prob,
        n0=n0,
        A_csr=A_csr,
    )
