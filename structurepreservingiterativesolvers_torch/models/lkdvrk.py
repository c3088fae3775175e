"""1-D linear KdV with Gauss–Legendre Runge–Kutta stepping (stage-coupled).

The port of the JAX package's ``models/lkdvrk.py`` (reference
``lkdvRK/lkdvRK.py``).  The weak form (lkdvRK/lkdvRK.py:107-111)

    F1 = Dt(u)·φ + G v,   F2 = (v−u)·ψ − G w,   F3 = w·χ − G u

is collocated at the s Gauss–Legendre stages: the unknowns are the stacked
stage derivatives k = (k_1,…,k_s), each a 3-field vector, with stage values
``z_s = z0 + dt Σ_j a_sj k_j``.  The block system is the Kronecker expansion
``I⊗blockdiag + dt·(a ⊗ coupling)`` of the 1-D operators, assembled on the
host by the numpy code in ``fem1d``.  The step reconstruction is
``z1 = z0 + dt Σ b_s k_s`` (``z1calc``, lkdvRK/lkdvRK.py:162-174); the
mass, momentum and energy constraints on z1 are composed through that affine
map into quadratic constraints on stage space (``stage_mapped``).

Consistent initial data: w0 = M⁻¹G u0, v0 = u0 + M⁻¹G w0 (the reference's
``w_finder``/``v_finder``, lkdvRK/lkdvRK.py:65-93).

On the device, A is what ``from_scipy`` picks, as in the JAX package: a
wrapped DIA (42 diagonals at degree 3 with 2 stages, so every ``A @ x``
runs the DIA kernel on the card), or an ELL at higher degree and stage
count.  The DG mass inverse ``Minv`` is a BSR of the element blocks.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ..config import DEFAULT_DTYPE
from ..constraints.quadratic import (
    QuadraticConstraint,
    stage_mapped,
    target_dot,
    target_quad,
)
from ..ops.sparse import bsr_from_scipy, from_scipy
from ..ops.stencil import maybe_stencil
from .fem1d import Space1D
from .lkdv import MLENGTH, _BlockDiag3
from .tableaux import ButcherTableau, gauss_legendre


@dataclasses.dataclass
class Problem:
    N: int = 100
    M: int = 50
    degree: int = 1
    tstages: int = 2
    space: str = "DG"
    T: float = 1.0
    mlength: float = MLENGTH
    dim: int = 3

    def __post_init__(self):
        self.tableau: ButcherTableau = gauss_legendre(self.tstages)
        self.ns = self.tableau.num_stages

    @property
    def dt(self) -> float:
        return float(self.T) / self.N

    def fem(self) -> Space1D:
        return Space1D(self.M, self.mlength, self.degree, self.space)

    def exact(self, x, t):
        alpha = 4.0
        beta = alpha * 2.0 * np.pi / self.mlength
        return np.sin(beta * (x - (1.0 - beta**2) * t)) + 1.0


@dataclasses.dataclass
class System:
    """The stage system and its invariant data on one device."""

    # step_update and the invariants split the state into its fields (u, v,
    # w), which a row split cuts (fused_evolve(mesh=) reads it)
    row_local: ClassVar[bool] = False
    A: object
    b: torch.Tensor
    z0: torch.Tensor  # (3n0,) the step's initial mixed vector
    Mmat: object
    Gmat: object
    Minv: object  # block-diagonal mass inverse (a BSR on DG)
    omega: torch.Tensor
    m0: torch.Tensor
    mo0: torch.Tensor
    e0: torch.Tensor
    prob: Problem
    n0: int
    fem: Space1D = dataclasses.field(repr=False, default=None)
    # host-side CSR kept for the direct solve and the block preconditioners
    A_csr: sp.csr_matrix = dataclasses.field(repr=False, default=None)
    Mh: sp.csr_matrix = dataclasses.field(repr=False, default=None)
    # the RK weights b_s (ns,) on the device, put there once (by
    # ``linforms``, or here for a system built field by field) and carried
    # by ``dataclasses.replace``: every stepped system's ``z1calc``,
    # constraints and invariants read this one tensor, so a step copies
    # nothing from the host (a CUDA graph capture takes no such copy) and
    # the stage-mapped constraints' M keeps its key across ``step_update``
    bw: torch.Tensor = dataclasses.field(repr=False, default=None)

    def __post_init__(self):
        if self.bw is None:
            self.bw = torch.as_tensor(self.prob.tableau.b, dtype=self.b.dtype,
                                      device=self.b.device)

    @property
    def dof(self) -> int:
        return 3 * self.n0

    def _weights(self) -> torch.Tensor:
        return self.bw

    def z1calc(self, zbig: torch.Tensor) -> torch.Tensor:
        """Step reconstruction z1 = z0 + dt Σ b_s k_s
        (reference lkdvRK/lkdvRK.py:162-174)."""
        ks = zbig.reshape(self.prob.ns, self.dof)
        return self.z0 + self.prob.dt * torch.tensordot(self._weights(), ks,
                                                        dims=1)

    def constraints(self):
        """Stage-space quadratic constraints equivalent to the reference's
        dict-form mass, momentum and energy (lkdvRK/LinearSolver.py:29-79)."""
        omega_full = torch.zeros(self.dof, dtype=self.b.dtype,
                                 device=self.b.device)
        omega_full[:self.n0] = self.omega
        inner = [
            QuadraticConstraint(M=None, v=omega_full, c=-self.m0, name="mass"),
            QuadraticConstraint(
                M=_BlockDiag3(self.Mmat, (1.0, 0.0, 0.0)), v=None, c=-self.mo0,
                name="momentum",
            ),
            QuadraticConstraint(
                M=_BlockDiag3(self.Mmat, (-1.0, 0.0, 1.0)), v=None, c=-self.e0,
                name="energy",
            ),
        ]
        bw = self._weights()
        return [stage_mapped(c, bw, self.prob.dt, self.prob.ns, self.z0)
                for c in inner]

    def compute_invariants(self, zbig: torch.Tensor,
                           zold: Optional[torch.Tensor] = None) -> dict:
        """The invariants of the step's end state; ``zold`` is unread
        (heat's read it)."""
        u, v, w = torch.split(self.z1calc(zbig), self.n0)
        Mu = self.Mmat @ u
        return {
            "mass": torch.dot(self.omega, u),
            "momentum": 0.5 * torch.dot(u, Mu),
            "energy": 0.5 * torch.dot(w, self.Mmat @ w) - 0.5 * torch.dot(u, Mu),
        }

    def step_update(self, zbig_prev: torch.Tensor) -> "System":
        """The next step's stage system from the previous stage solution:
        z1 reconstructed, the auxiliary fields made consistent on the device
        (w = M⁻¹G u, v = u + M⁻¹G w, the reference's per-step
        ``v_finder``/``w_finder``, lkdvRK/lkdvRK.py:65-93, through the block
        mass inverse), b and the invariant targets re-seeded.  With
        consistent fields the algebraic stage rows have a zero right-hand
        side, so b = [−G v0; 0; 0] per stage."""
        n0 = self.n0
        u1 = self.z1calc(zbig_prev)[:n0]
        w0 = self.Minv @ (self.Gmat @ u1)
        v0 = u1 + self.Minv @ (self.Gmat @ w0)
        b_stage = torch.cat([-(self.Gmat @ v0),
                             torch.zeros(2 * n0, dtype=u1.dtype,
                                         device=u1.device)])
        Mu = self.Mmat @ u1
        # the targets: f64 sums from an f32 state (``target_dot``)
        return dataclasses.replace(
            self,
            b=b_stage.repeat(self.prob.ns),
            z0=torch.cat([u1, v0, w0]),
            m0=target_dot(self.omega, u1),
            mo0=0.5 * target_quad(self.Mmat, u1, Mz=Mu),
            e0=0.5 * target_quad(self.Mmat, w0)
            - 0.5 * target_quad(self.Mmat, u1, Mz=Mu),
        )

    def compute_error(self, zbig: torch.Tensor, t: float) -> float:
        """L2(u) error against the exact travelling wave at time t
        (reference lkdvRK/lkdvRK.py:223-240), on the host."""
        u1 = self.z1calc(zbig)[:self.n0].cpu().numpy()
        e = u1 - self.fem.project(lambda x: self.prob.exact(x, t))
        return float(np.sqrt(e @ (self.Mh @ e)))


def _mass_inverse(Mh: sp.csr_matrix, fem: Space1D) -> sp.csr_matrix:
    """Explicit sparse mass inverse: block-diagonal per element on DG, a
    dense inverse of the banded mass on CG (assembly time only)."""
    if fem.kind == "DG":
        blocks = [np.linalg.inv(Mh[idx][:, idx].toarray()) for idx in fem.lg]
        return sp.csr_matrix(sp.block_diag(blocks))
    return sp.csr_matrix(np.linalg.inv(Mh.toarray()))


def element_block_preconditioner(system: System, elems_per_block: int = 2,
                                 overlap: int = 0):
    """Block preconditioner coupling all fields and stages of
    ``elems_per_block`` adjacent elements, the stand-in for the reference's
    SuperLU ILU (lkdvRK/Evolve.py:51-52): dense block inverses built on the
    host, applied as one batched product on the device.  ``overlap`` > 0
    makes it restricted additive Schwarz with that many halo elements per
    side (periodic)."""
    from ..precond.jacobi import block_jacobi, ras

    n0, prob = system.n0, system.prob
    nloc = prob.degree + 1
    ne = n0 // nloc
    if ne % elems_per_block:
        raise ValueError("elems_per_block must divide the element count")
    device, dtype = system.b.device, system.b.dtype

    def elem_dofs(elems):
        idx = []
        for st in range(prob.ns):
            for f in range(3):
                base = st * 3 * n0 + f * n0
                for e in elems:
                    e = e % ne
                    idx.extend(range(base + e * nloc, base + (e + 1) * nloc))
        return np.asarray(idx)

    if overlap == 0:
        blocks = [elem_dofs(range(e0, e0 + elems_per_block))
                  for e0 in range(0, ne, elems_per_block)]
        return block_jacobi(system.A_csr, blocks, dtype=dtype, device=device)

    width = elems_per_block + 2 * overlap
    # ownership: the central elems_per_block elements of every field/stage
    mask1 = np.zeros(width * nloc, dtype=bool)
    mask1[overlap * nloc:(overlap + elems_per_block) * nloc] = True
    own = np.tile(mask1, prob.ns * 3)
    blocks = [elem_dofs(range(e0 - overlap, e0 + elems_per_block + overlap))
              for e0 in range(0, ne, elems_per_block)]
    return ras(system.A_csr, blocks, [own] * len(blocks), dtype=dtype,
               device=device)


def linforms(
    N: int = 100,
    M: int = 50,
    degree: int = 1,
    tstages: int = 2,
    T: float = 1.0,
    space: str = "DG",
    zinit: Optional[np.ndarray] = None,
    dtype=DEFAULT_DTYPE,
    *,
    device,
) -> System:
    """Assemble the lkdvRK stage system (reference lkdvRK/lkdvRK.py:46-148)
    on ``device``."""
    prob = Problem(N=N, M=M, degree=degree, tstages=tstages, space=space,
                   T=float(T))
    fem = prob.fem()
    n0 = fem.ndof
    ns, dt_step = prob.ns, prob.dt
    a = prob.tableau.A

    Mh = fem.mass()
    Gh = fem.gfunc()
    omega_h = fem.omega()

    if zinit is None:
        u0 = fem.project(lambda x: prob.exact(x, 0.0))
    else:
        u0 = np.split(np.asarray(zinit), 3)[0]
    w0 = spla.spsolve(Mh, Gh @ u0)
    v0 = u0 + spla.spsolve(Mh, Gh @ w0)

    Z = sp.csr_matrix((n0, n0))
    blocks = []
    for s in range(ns):
        row = []
        for j in range(ns):
            d = 1.0 if s == j else 0.0
            asj = dt_step * a[s, j]
            row.append(sp.bmat([
                [d * Mh if d else Z, asj * Gh, Z],
                [-asj * Mh, asj * Mh, -asj * Gh],
                [-asj * Gh, Z, asj * Mh],
            ]))
        blocks.append(row)
    A_csr = sp.csr_matrix(sp.bmat(blocks))

    b_stage = np.concatenate(
        [-(Gh @ v0), Mh @ u0 - Mh @ v0 + Gh @ w0, Gh @ u0 - Mh @ w0])

    def dev(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    Minv = _mass_inverse(Mh, fem)
    return System(
        A=maybe_stencil(from_scipy(A_csr, dtype=dtype, device=device)),
        b=dev(np.tile(b_stage, ns)),
        z0=dev(np.concatenate([u0, v0, w0])),
        Mmat=from_scipy(Mh, dtype=dtype, device=device),
        Gmat=from_scipy(Gh, dtype=dtype, device=device),
        Minv=(bsr_from_scipy(Minv, prob.degree + 1, dtype=dtype, device=device)
              if fem.kind == "DG"
              else from_scipy(Minv, dtype=dtype, device=device)),
        omega=dev(omega_h),
        m0=dev(omega_h @ u0),
        mo0=dev(0.5 * u0 @ (Mh @ u0)),
        e0=dev(0.5 * w0 @ (Mh @ w0) - 0.5 * u0 @ (Mh @ u0)),
        prob=prob,
        n0=n0,
        fem=fem,
        A_csr=A_csr,
        Mh=Mh,
        bw=dev(prob.tableau.b),
    )
