"""Polynomial preconditioners: Chebyshev and truncated Neumann.

The port of the JAX package's ``precond/chebyshev.py`` (``Chebyshev``,
``Neumann``, ``power_bounds``, ``chebyshev()`` and ``neumann()``).  A fixed
short recurrence in A is an admissible right preconditioner for flexible
GMRES, and it replaces the reference's ILU/AMG triangular machinery
(reference heat/TimedSolve.py:30-31).

* ``chebyshev(A, lmin, lmax, degree)``: the Chebyshev approximation of A⁻¹
  on a positive spectrum interval (SPD systems, e.g. heat), the bounds
  estimated by power iteration on A when not given.
* ``neumann(A, degree, omega)``: the truncated Neumann series of the
  Jacobi-scaled system.
* ``power_bounds(A)``: a spectral-interval estimate of D⁻¹A.
* ``neumann_composite(A, inner, degree)``: the Neumann acceleration
  Σ_{i≤degree} (I − B A)^i B of an inner preconditioner B (RAS on lkdvRK),
  a chain of ``A @ z`` products and inner applies, never kernel #4.
* ``skew_normal_chebyshev(A, a)``: the polynomial approximate inverse of a
  shifted-skew operator A = aI − K (the swe midpoint step), a chain of
  2·degree + 1 products ``A @ v`` (on the card through the DIA kernel).

``fused`` keeps its JAX meaning.  ``False`` runs the unfused recurrence, p
products ``A @ x`` (on the card through the DIA or stencil kernel) and the
vector updates between them.  ``None`` or ``True`` runs the whole degree-p
apply as one launch of the fused kernel (``kernels/poly_apply.py``, kernels
#3 and #4) on a CUDA operator with ``degree >= 2``; on a CPU operator
``None`` keeps the unfused recurrence, and ``True`` takes the kernel's plain
twin, the same recurrence.

Left out: the JAX builders' TPU tiling knobs (``block_rows``,
``interpret``, the pre-gathered ``datawin``/``dinvwin`` windows and the
VMEM fit of ``_fuse_block_rows``), which the card's kernels do not need.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..kernels.poly_apply import (
    cheb_apply,
    cheb_recurrence,
    neumann_apply,
    neumann_recurrence,
)
from .base import apply_preconditioner
from .jacobi import diagonal


@dataclasses.dataclass(frozen=True)
class Chebyshev:
    """Chebyshev polynomial approximation of A⁻¹ on [lmin, lmax] applied via
    the standard three-term recurrence (one ``A @ x`` per degree), or as one
    fused launch when ``fused``."""

    A: object
    lmin: float
    lmax: float
    degree: int
    fused: bool = False

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        theta = 0.5 * (self.lmax + self.lmin)
        delta = 0.5 * (self.lmax - self.lmin)
        sigma = theta / delta
        if self.fused:
            return cheb_apply(self.A, self.degree, theta, delta, sigma, v)
        return cheb_recurrence(lambda x: self.A @ x, self.degree, theta, delta,
                               sigma, v)

    def solve(self, v: torch.Tensor) -> torch.Tensor:
        return self(v)


@dataclasses.dataclass(frozen=True)
class Neumann:
    """Truncated Neumann series for (D⁻¹A) with damping ω:
    p(A) = ω Σ_{i<degree} (I − ω D⁻¹A)^i D⁻¹, or one fused launch when
    ``fused``."""

    A: object
    dinv: torch.Tensor
    omega: float
    degree: int
    fused: bool = False

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return neumann_apply(self.A, self.dinv, self.degree, self.omega, v)
        return neumann_recurrence(lambda x: self.A @ x, self.dinv, self.degree,
                                  self.omega, v)

    def solve(self, v: torch.Tensor) -> torch.Tensor:
        return self(v)


@dataclasses.dataclass(frozen=True)
class NeumannComposite:
    """Neumann acceleration of an inner preconditioner B:

        M⁻¹ = Σ_{i≤degree} (I − B A)^i B

    each degree one ``A @ z`` and one inner apply (JAX
    ``precond/chebyshev.py:120-149``).  With a RAS inner it reaches the
    iteration counts of the reference's SuperLU ILU on the lkdvRK stage
    systems (docs/ILU_PARITY.md)."""

    A: object
    inner: object
    degree: int

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        z = apply_preconditioner(self.inner, v)
        acc = z
        for _ in range(self.degree):
            z = z - apply_preconditioner(self.inner, self.A @ z)
            acc = acc + z
        return acc

    def solve(self, v: torch.Tensor) -> torch.Tensor:
        return self(v)


def neumann_composite(A, inner, degree: int = 2) -> NeumannComposite:
    return NeumannComposite(A=A, inner=inner, degree=int(degree))


@dataclasses.dataclass(frozen=True)
class SkewNormalChebyshev:
    """Polynomial approximate inverse for shifted-skew systems A = aI − K
    with K skew in some inner product: the swe midpoint operator
    A = I/dt − S/2 (reference swe/swe.py:61-66, which pairs it with SuperLU
    spilu).

    A·(2aI − A) = a²I − K² =: N is SPD in that inner product, with spectrum
    in [a², a² + ρ(K)²], so A⁻¹ = (2aI − A)·N⁻¹ ≈ (2aI − A)·q(N) with q the
    degree-``degree`` Chebyshev approximation of the inverse on
    [lmin, lmax].  Each N-apply is two products ``A @ v``: the whole apply is
    a chain of 2·degree + 1, in the JAX package's order."""

    A: object
    a: float  # the shift: A = aI − K
    lmin: float  # lower spectral bound of N (a²)
    lmax: float  # upper bound (a² + ρ(K)², with margin)
    degree: int

    def _N(self, v: torch.Tensor) -> torch.Tensor:
        # N v = A (2a v − A v) = (a²I − K²) v
        return self.A @ (2.0 * self.a * v - self.A @ v)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        theta = 0.5 * (self.lmax + self.lmin)
        delta = 0.5 * (self.lmax - self.lmin)
        sigma = theta / delta
        rho = 1.0 / sigma
        x = v / theta
        r = v - self._N(x)
        d = (2.0 * rho / delta) * r
        for _ in range(self.degree - 1):
            x = x + d
            r = r - self._N(d)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
            rho = rho_new
        u = x + d if self.degree >= 1 else x
        return 2.0 * self.a * u - self.A @ u

    def solve(self, v: torch.Tensor) -> torch.Tensor:
        return self(v)


def skew_normal_chebyshev(A, a: float, rho_k: Optional[float] = None,
                          degree: Optional[int] = None,
                          target: float = 0.03) -> SkewNormalChebyshev:
    """Build a SkewNormalChebyshev for A = aI − K (K skew).

    ``rho_k``, the spectral radius of K, is estimated when not given by 30
    steps of power iteration on K = aI − A from a fixed random start (one
    host read per step), taking the largest norm of steps 25–29 and a 1.1
    margin, as the JAX package does.  ``degree=None`` picks the smallest
    degree whose Chebyshev min-max error on [a², a² + ρ(K)²] is at most
    ``target``."""
    if rho_k is None:
        n = A.shape[0]
        d = diagonal(A)
        v = torch.as_tensor(np.random.default_rng(0).standard_normal(n),
                            dtype=d.dtype, device=d.device)
        v = v / torch.linalg.norm(v)
        est = 0.0
        for it in range(30):
            w = a * v - A @ v  # K v
            nw = float(torch.linalg.norm(w))
            if it >= 25:
                est = max(est, nw)
            v = w / nw
        rho_k = 1.1 * est
    lmin = float(a) ** 2
    lmax = lmin + float(rho_k) ** 2
    if degree is None:
        kappa = lmax / lmin
        factor = (math.sqrt(kappa) - 1.0) / (math.sqrt(kappa) + 1.0)
        if factor <= 0:
            degree = 1
        else:
            degree = max(1, math.ceil(math.log(2.0 / target)
                                      / math.log(1.0 / factor)))
    return SkewNormalChebyshev(A=A, a=float(a), lmin=lmin, lmax=lmax,
                               degree=int(degree))


def power_bounds(A, iters: int = 30, seed: int = 0):
    """Estimate the spectral interval of D⁻¹A by power iteration.
    Returns (lmin_est, lmax_est) with safety margins."""
    n = A.shape[0]
    d = diagonal(A)
    dinv = 1.0 / torch.where(d == 0, 1.0, d)
    v = torch.as_tensor(np.random.default_rng(seed).standard_normal(n),
                        dtype=dinv.dtype, device=dinv.device)
    v = v / torch.linalg.norm(v)
    lmax = 1.0
    for _ in range(iters):
        w = dinv * (A @ v)
        lmax = torch.linalg.norm(w)
        v = w / torch.where(lmax == 0, 1.0, lmax)
    lmax = float(lmax)
    return 0.05 * lmax, 1.1 * lmax


def _fuse(A, degree: int, fused: Optional[bool]) -> bool:
    """The fused-kernel gate: an explicit ``False`` or a degree below 2
    (nothing to fuse) keeps the unfused recurrence; otherwise ``True``
    fuses, and ``None`` fuses on a CUDA operator."""
    if fused is False or degree < 2:
        return False
    return bool(fused) or A.device.type == "cuda"


def chebyshev(A, lmin: Optional[float] = None, lmax: Optional[float] = None,
              degree: int = 8, scale_by_diag: bool = True,
              fused: Optional[bool] = None) -> Chebyshev:
    """Build a Chebyshev preconditioner; bounds estimated if not given.

    As in the JAX package, A itself is preconditioned with bounds from the
    growth of plain power iteration (30 steps from a fixed random start),
    and an explicit bound of 0.0 counts as not given; ``scale_by_diag`` is
    accepted and unused there too."""
    if lmin is None or lmax is None:
        n = A.shape[0]
        rng = np.random.default_rng(0)
        d = diagonal(A)
        v = torch.as_tensor(rng.standard_normal(n), dtype=d.dtype,
                            device=d.device)
        v = v / torch.linalg.norm(v)
        est = 1.0
        for _ in range(30):
            w = A @ v
            est = float(torch.linalg.norm(w))
            v = w / est
        lmax = lmax or 1.1 * est
        lmin = lmin or 0.03 * est
    return Chebyshev(A=A, lmin=float(lmin), lmax=float(lmax),
                     degree=int(degree), fused=_fuse(A, degree, fused))


def neumann(A, degree: int = 4, omega: float = 0.8,
            fused: Optional[bool] = None) -> Neumann:
    d = diagonal(A)
    dinv = 1.0 / torch.where(d == 0, 1.0, d)
    return Neumann(A=A, dinv=dinv, omega=float(omega), degree=int(degree),
                   fused=_fuse(A, degree, fused))
