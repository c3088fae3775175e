"""Preconditioned conjugate gradients (SPD systems).

The port of the JAX package's ``solvers/cg.py``.  The reference ships no CG
(its systems are mildly nonsymmetric); the JAX package adds it for the SPD
paths (the heat operator M/dt + ½K is SPD).  The iteration runs on the host,
the vectors and the scalars of the recurrence on the operands' device: each
step reads only its residual norm on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import check_storage
from ..precond.base import as_preconditioner
from .gmres import as_operand


def cg(A, b: torch.Tensor, x0=None, k: int = 100, tol: float = 1e-8,
       pre=None):
    """Solve SPD ``A x = b``; returns ``(x, info)`` on the common contract:
    ``info`` holds ``name='cg'``, the per-iteration residuals ``res`` and
    ``steps``.

    The residuals follow the CG recurrence (r is b − A x up to roundoff);
    the last entry is replaced by the recomputed true residual, as the JAX
    package does, without an extra product per iteration."""
    check_storage(b)
    x0 = as_operand(x0, b)
    x = torch.zeros_like(b) if x0 is None else x0
    prefunc = as_preconditioner(pre)
    r = b - A @ x
    z = prefunc(r)
    p = z
    rz = torch.dot(r, z)
    res = np.full(k, np.inf)
    j, done = 0, float(torch.linalg.norm(r)) < tol
    while j < k and not done:
        Ap = A @ p
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prefunc(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        res[j] = float(torch.linalg.norm(r))
        done = res[j] < tol
        j += 1
    res[max(j - 1, 0)] = float(torch.linalg.norm(A @ x - b))
    return x, {"name": "cg", "res": res[: max(j, 1)], "steps": j}
