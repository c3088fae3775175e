"""2-D linear rotating shallow water (periodic square), midpoint step.

The port of the JAX package's ``models/swe.py`` (reference ``swe/swe.py``):
the linear rotating SWE

    u_t − f v + c² ρ_x = 0
    v_t + f u + c² ρ_y = 0
    ρ_t + u_x + v_y  = 0

on an Arakawa C-grid (u on x-edges, v on y-edges, ρ at centres) with the
energy-conserving 4-point Coriolis average, so the midpoint step conserves
mass (∫ρ) and energy (½∫|u|² + ½c²∫ρ²) exactly (swe/swe.py:104-107,
swe/LinearSolver.py:23-33).

System:  A = I/dt − ½S,   b = (I/dt + ½S) z0   (identity mass matrix).
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
from ..parallel.comm import mesh_of, pdot

MLENGTH = 40.0


@dataclasses.dataclass
class Problem:
    N: int = 100
    M: int = 50
    degree: int = 1
    T: float = 10.0
    mlength: float = MLENGTH
    c: float = 1.0  # wave speed (swe/swe.py:19)
    f: float = 0.1  # Coriolis parameter (swe/swe.py:20)

    @property
    def dt(self) -> float:
        return float(self.T) / self.N

    @property
    def h(self) -> float:
        return self.mlength / self.M

    def ic_rho(self, x, y):
        """Gaussian height anomaly at domain centre (swe/swe.py:34-40)."""
        return 10.0 * np.exp(-((x - 20.0) ** 2 + (y - 20.0) ** 2) / 20.0**2)


def _shift_op(M: int, di: int, dj: int) -> sp.csr_matrix:
    """Periodic shift operator on an M×M grid flattened row-major:
    (Su)[i,j] = u[i+di, j+dj]."""
    n = M * M
    idx = np.arange(n)
    i, j = idx // M, idx % M
    src = ((i + di) % M) * M + (j + dj) % M
    return sp.csr_matrix((np.ones(n), (idx, src)), shape=(n, n))


def _operators(prob: Problem):
    M, h = prob.M, prob.h
    n = M * M
    I = sp.identity(n, format="csr")
    Sx = _shift_op(M, 1, 0)  # sample at i+1
    Sy = _shift_op(M, 0, 1)
    # u-point (i,j) sits on the x-edge between centres (i-1,j) and (i,j):
    # gradient Gx ρ |_u(i,j) = (ρ[i,j] − ρ[i−1,j])/h
    Gx = (I - Sx.T) / h
    Gy = (I - Sy.T) / h
    # 4-point Coriolis average of v at u-points (energy-conserving pair)
    Av = 0.25 * (I + Sx.T + Sy + Sx.T @ Sy)
    return I, Gx, Gy, Av


@dataclasses.dataclass
class System:
    A: object
    b: torch.Tensor
    z0: torch.Tensor
    omega: torch.Tensor  # full-vector mass-integration weights (ρ block)
    Lfull: object  # energy matrix on the full vector (swe/swe.py:95-97)
    m0: torch.Tensor
    e0: torch.Tensor
    prob: Problem
    n0: int  # per-field dim (M²)
    A_csr: sp.csr_matrix = dataclasses.field(repr=False, default=None)
    # step_update and the invariants act row by row on the state (a row
    # split of the system keeps them local; fused_evolve(mesh=) reads it)
    row_local: ClassVar[bool] = True

    def constraints(self):
        mesh = mesh_of(self.A)
        mass = QuadraticConstraint(M=None, v=self.omega, c=-self.m0,
                                   name="mass", mesh=mesh)
        energy = QuadraticConstraint(M=self.Lfull, v=None, c=-self.e0,
                                     name="energy", mesh=mesh)
        return [mass, energy]

    def compute_invariants(self, z: torch.Tensor,
                           zold: Optional[torch.Tensor] = None) -> dict:
        """The invariants of z; ``zold`` is unread (heat's read it).  On a
        row-sharded system (``experiments/evolve.py::fused_evolve(mesh=)``)
        z is this rank's rows and the sums are all-reduced."""
        mesh = mesh_of(self.A)
        return {
            "mass": pdot(self.omega, z, mesh),
            "energy": 0.5 * pdot(z, self.Lfull @ z, mesh),
        }

    def step_update(self, z_prev: torch.Tensor) -> "System":
        """The next step's system on the system's device.  Since
        A = I/dt − S/2, b = (I/dt + S/2) z = 2z/dt − A z: one product, no
        reassembly.  The targets are f64 sums from an f32 state
        (``target_dot``)."""
        mesh = mesh_of(self.A)
        return dataclasses.replace(
            self,
            b=2.0 * z_prev / self.prob.dt - (self.A @ z_prev),
            z0=z_prev,
            m0=target_dot(self.omega, z_prev, mesh),
            e0=0.5 * target_quad(self.Lfull, z_prev, mesh),
        )


@dataclasses.dataclass(frozen=True)
class _EnergyDiag:
    """h²·diag(I, I, c²·I) as an operator (the reference's L matrix role),
    on a 3-field vector or the rows of a tall (3·n0, m) matrix."""

    scales: tuple  # per-block scalar weights
    n0: int  # per-field dimension

    def __matmul__(self, x):
        parts = torch.tensor_split(x, 3, dim=0)
        return torch.cat([s * p for s, p in zip(self.scales, parts)], dim=0)

    def matvec_f64(self, x):
        """The product in f64 from f32 x (``ops/sparse.py::matvec_f64``):
        the f64 scales times the upcast fields, as the JAX package's
        ``dd_matvec`` splits the scales exactly."""
        parts = torch.tensor_split(x.double(), 3, dim=0)
        return torch.cat([s * p for s, p in zip(self.scales, parts)], dim=0)

    def todense(self):
        diag = np.concatenate([np.full(self.n0, s) for s in self.scales])
        return torch.as_tensor(np.diag(diag))


def linforms(
    N: int = 100,
    M: int = 50,
    degree: int = 1,
    T: float = 10.0,
    zinit: Optional[np.ndarray] = None,
    dtype=DEFAULT_DTYPE,
    *,
    device,
) -> System:
    """Assemble the swe step system on ``device``."""
    prob = Problem(N=N, M=M, degree=degree, T=float(T))
    h, c, f, dt_step = prob.h, prob.c, prob.f, prob.dt
    n0 = M * M

    I, Gx, Gy, Av = _operators(prob)
    Z = sp.csr_matrix((n0, n0))
    # z_t = S z with skew-symmetric (in the energy product) S
    S = sp.bmat(
        [
            [Z, f * Av, -(c**2) * Gx],
            [-f * Av.T, Z, -(c**2) * Gy],
            [Gx.T, Gy.T, Z],
        ],
        format="csr",
    )
    A_csr = sp.csr_matrix(sp.identity(3 * n0) / dt_step - 0.5 * S)

    if zinit is None:
        idx = np.arange(n0)
        xc = (idx // M + 0.5) * h
        yc = (idx % M + 0.5) * h
        rho0 = prob.ic_rho(xc, yc)
        z0 = np.concatenate([np.zeros(n0), np.zeros(n0), rho0])
    else:
        z0 = np.asarray(zinit)

    b = z0 / dt_step + 0.5 * (S @ z0)

    omega = np.concatenate([np.zeros(2 * n0), np.full(n0, h * h)])
    m0 = omega @ z0
    Lfull = _EnergyDiag((h * h, h * h, h * h * c * c), n0)
    e0 = 0.5 * z0 @ (np.concatenate([h * h * z0[:n0], h * h * z0[n0 : 2 * n0], h * h * c * c * z0[2 * n0 :]]))

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return System(
        A=from_scipy(A_csr, dtype=dtype, device=device),
        b=dev(b),
        z0=dev(z0),
        omega=dev(omega),
        Lfull=Lfull,
        m0=dev(m0),
        e0=dev(e0),
        prob=prob,
        n0=n0,
        A_csr=A_csr,
    )
