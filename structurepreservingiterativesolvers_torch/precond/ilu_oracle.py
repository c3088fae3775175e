"""Host-factored ILU *oracle* preconditioner (validation only).

The port of the JAX package's ``precond/ilu_oracle.py``.  The reference
preconditions lkdvRK and swe with SuperLU's incomplete LU
(``scipy.sparse.linalg.spilu(A, drop_tol=1e-4, fill_factor=10)``,
reference lkdvRK/Evolve.py:51-52, swe/TimedSolve.py:23-24).  Sparse
triangular solves are sequential, so the production path uses block-Jacobi
/ RAS / polynomial preconditioners (``jacobi.py``, ``chebyshev.py``)
instead.

This module materialises the ILU factors' inverse action as a dense
operator (M⁻¹ = U⁻¹ L⁻¹ applied to the identity, on the host), so the exact
reference preconditioner runs inside a device solve at test sizes, one
dense product an apply, and the preconditioned iteration counts of the
stand-ins can be compared against it.  Dense n×n storage makes it a
small-n validation oracle, not a production preconditioner.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DenseApply:
    """Dense preconditioner apply: v ↦ Minv @ v, for a vector or for each
    column of a block (n, B)."""

    Minv: torch.Tensor

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return self.Minv @ v

    def solve(self, v: torch.Tensor) -> torch.Tensor:
        return self(v)


def ilu_oracle(A_csr, drop_tol: float = 1e-4, fill_factor: float = 10.0,
               dtype=None, *, device) -> DenseApply:
    """spilu with the reference's exact parameters, densified on the host
    and placed on ``device``."""
    import scipy.sparse.linalg as spla

    A_csr = A_csr.tocsc()
    n = A_csr.shape[0]
    ilu = spla.spilu(A_csr, drop_tol=drop_tol, fill_factor=fill_factor)
    Minv = ilu.solve(np.eye(n))
    return DenseApply(Minv=torch.as_tensor(
        Minv, dtype=dtype or torch.float64, device=device))


def direct_oracle(A_csr, dtype=None, *, device) -> DenseApply:
    """Exact-inverse preconditioner (the quality ceiling: 1-2 iterations)."""
    import scipy.sparse.linalg as spla

    n = A_csr.shape[0]
    Minv = spla.spsolve(A_csr.tocsc(), np.eye(n))
    return DenseApply(Minv=torch.as_tensor(
        np.asarray(Minv), dtype=dtype or torch.float64, device=device))
