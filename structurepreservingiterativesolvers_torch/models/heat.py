"""2-D heat equation test problem (u_t − Δu = 0, natural BC).

The port of the JAX package's ``models/heat.py`` (reference
``heat/heat.py``): P1 on a structured unit-square triangulation, midpoint
step, assembled by the numpy code in ``fem2d``.  System
(heat/heat.py:63-85):

    A = M/dt + ½K,     b = (M/dt − ½K) u0

Invariants (heat/heat.py:92-146, heat/LinearSolver.py:26-35):

* mass  ω·u  (conserved, Neumann BC);
* the *dissipation identity* — not a conservation law:
      ½u1ᵀMu1 − ½u0ᵀMu0 + dt·umidᵀK umid = 0
  expressed as the quadratic constraint with
      M_c = M + ½dt·K,  v = ½dt·K u0,  c = −(½u0ᵀMu0 − ¼dt·u0ᵀK u0).

``A`` lands on the device as a ``Stencil`` where the operator decomposes
into constants plus boundary strips (every even M, and odd M in f32), else
as a DIA; ``Mmat``, ``Lmat`` and the pre-combined ``Emat`` are DIA.  Degree
2 assembles into matrices that both packages store as ELL (width 19); the
structured AMG does not apply there, and the greedy host AMG
(``precond/amg.py``, built from ``A_csr``) preconditions it.
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
from ..ops.stencil import maybe_stencil
from ..parallel.comm import mesh_of, pdot
from .fem2d import SpaceP1


@dataclasses.dataclass
class Problem:
    N: int = 100
    M: int = 50
    degree: int = 1
    T: float = 10.0

    @property
    def dt(self) -> float:
        return float(self.T) / self.N

    def fem(self) -> SpaceP1:
        if self.degree == 1:
            return SpaceP1(self.M, 1.0)
        if self.degree == 2:
            from .fem2d import SpaceP2

            return SpaceP2(self.M, 1.0)
        raise NotImplementedError("degrees 1 and 2 supported")

    def ic(self, x, y):
        """1e3-scaled polynomial bump (heat/heat.py:30-32)."""
        return 1e3 * ((x * (x - 1.0)) ** 5 + (y * (y - 1.0)) ** 6)


@dataclasses.dataclass
class System:
    A: object
    b: torch.Tensor
    z0: torch.Tensor
    Mmat: object
    Lmat: object  # stiffness (the reference's L, heat/heat.py:86-90)
    Emat: object  # energy-constraint matrix M + ½dt·K, combined at assembly
    Lz0: torch.Tensor
    omega: torch.Tensor
    m0: torch.Tensor
    e0: torch.Tensor
    old_energy: torch.Tensor
    prob: Problem
    A_csr: sp.csr_matrix = dataclasses.field(repr=False, default=None)
    # step_update and the invariants act row by row on the state (a row
    # split of the system keeps them local; fused_evolve(mesh=) reads it)
    row_local: ClassVar[bool] = True

    def constraints(self):
        dt = self.prob.dt
        mesh = mesh_of(self.A)
        mass = QuadraticConstraint(M=None, v=self.omega, c=-self.m0,
                                   name="mass", mesh=mesh)
        # M + ½dt·K pre-combined on the host in f64 (M and K share their
        # sparsity pattern): one SpMV per constraint product, not two
        energy = QuadraticConstraint(
            M=self.Emat,
            v=0.5 * dt * self.Lz0,
            c=-self.old_energy,
            name="energy",
            mesh=mesh,
        )
        return [mass, energy]

    def compute_invariants(self, z: torch.Tensor,
                           zold: Optional[torch.Tensor] = None) -> dict:
        zold = self.z0 if zold is None else zold
        zmid = 0.5 * (z + zold)
        # on a row-sharded system each sum is all-reduced
        mesh = mesh_of(self.A)
        mass = pdot(self.omega, z, mesh)
        energy = (
            0.5 * pdot(z, self.Mmat @ z, mesh)
            - 0.5 * pdot(zold, self.Mmat @ zold, mesh)
            + self.prob.dt * pdot(zmid, self.Lmat @ zmid, mesh)
        )
        return {"mass": mass, "energy": energy}

    def step_update(self, z_prev: torch.Tensor) -> "System":
        """The next step's system from a solution, on the system's device:
        b, the energy constraint's linear term and the invariant targets
        re-seeded, the operators reused.  The targets are f64 sums from an
        f32 state (``target_dot``)."""
        dt_step = self.prob.dt
        Lz0 = self.Lmat @ z_prev
        Mu0 = self.Mmat @ z_prev
        mesh = mesh_of(self.A)
        return dataclasses.replace(
            self,
            b=Mu0 / dt_step - 0.5 * Lz0,
            z0=z_prev,
            Lz0=Lz0,
            m0=target_dot(self.omega, z_prev, mesh),
            old_energy=0.5 * target_quad(self.Mmat, z_prev, mesh, Mz=Mu0)
            - 0.25 * dt_step * target_quad(self.Lmat, z_prev, mesh, Mz=Lz0),
        )


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
    """Assemble the heat step system (reference heat/heat.py:35-121) on
    ``device``."""
    prob = Problem(N=N, M=M, degree=degree, T=float(T))
    fem = prob.fem()
    dt_step = prob.dt

    Mh = fem.mass()
    Kh = fem.stiffness()
    omega_h = fem.omega()

    if zinit is None:
        u0 = fem.project(prob.ic)
    else:
        u0 = np.asarray(zinit)

    A_csr = sp.csr_matrix(Mh / dt_step + 0.5 * Kh)
    b = (Mh @ u0) / dt_step - 0.5 * (Kh @ u0)

    Lz0 = Kh @ u0
    old_energy = 0.5 * u0 @ (Mh @ u0) - 0.25 * dt_step * u0 @ Lz0
    m0 = omega_h @ u0

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def dia(mat):
        return from_scipy(mat, dtype=dtype, device=device)

    return System(
        A=maybe_stencil(dia(A_csr)),
        b=dev(b),
        z0=dev(u0),
        Mmat=dia(Mh),
        Lmat=dia(Kh),
        Emat=dia(sp.csr_matrix(Mh + 0.5 * dt_step * Kh)),
        Lz0=dev(Lz0),
        omega=dev(omega_h),
        m0=dev(m0),
        e0=dev(0.0),
        old_energy=dev(old_energy),
        prob=prob,
        A_csr=A_csr,
    )
