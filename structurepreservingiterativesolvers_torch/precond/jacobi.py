"""Point-Jacobi preconditioner.

The port of the JAX package's ``precond/jacobi.py`` (``diagonal``, ``Jacobi``
and ``jacobi``).  ``diagonal`` also feeds the Neumann series and the bound
estimate of ``chebyshev.py``.  ``BlockJacobi``, ``RAS`` and the diagonal of
an ELL operator arrive with the lkdvRK slice: the port has no ELL format, so
any operator that is neither a DIA, a ``Stencil`` nor a dense tensor raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.sparse import DIA
from ..ops.stencil import as_dia


def diagonal(A) -> torch.Tensor:
    """The main diagonal of a device operator (zeros where a DIA has no 0
    offset, as the JAX package returns)."""
    A = as_dia(A)  # Stencil → its explicit-matrix DIA view
    if isinstance(A, DIA):
        if 0 in A.offsets:
            return A.data[A.offsets.index(0)]
        return torch.zeros(A.shape[0], dtype=A.dtype, device=A.device)
    if isinstance(A, torch.Tensor):
        return torch.diagonal(A)
    raise NotImplementedError(
        f"no diagonal of a {type(A).__name__} in the port: the ELL format "
        f"arrives with the lkdvRK slice")


@dataclasses.dataclass(frozen=True)
class Jacobi:
    """Diagonal-inverse preconditioner."""

    dinv: torch.Tensor

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return self.dinv * v

    def solve(self, v: torch.Tensor) -> torch.Tensor:
        return self.dinv * v


def jacobi(A) -> Jacobi:
    d = diagonal(A)
    safe = torch.where(d == 0, 1.0, d)
    return Jacobi(dinv=torch.where(d == 0, 1.0, 1.0 / safe))
