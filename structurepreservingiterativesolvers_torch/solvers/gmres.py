"""Flexible GMRES (FGMRES).

The port of the JAX package's ``solvers/gmres.py`` (reference
``solvers.py:58-127``): right preconditioning with the flexible Z-basis
reconstruction, CGS2 Arnoldi (``ortho='cgs2_fused'`` for its middle pair
through the fused kernel, ``ortho='mgs'`` for the reference's sequential
recurrence; see ``arnoldi_step``), the true residual ‖Ax−b‖ every iteration,
breakdown detection, and the reference's ``(x, info)`` contract.  With
``loop="host"`` (the default) the iteration loop runs on the host and each
step reads its residual there; with ``loop="while"`` the solve runs on the
device core of CGMRES (``solvers/cgmres.py::DeviceCore``, each step a CUDA
graph on the card), the JAX package's default loop, as CGMRES without
constraints whose gate is open from the first step: each step is the
Arnoldi step and the iterate from the LSQ coefficients, with its true
residual, until it is below ``tol``.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..config import CTOL, check_storage
from ..precond.base import as_preconditioner
from ..parallel.comm import mesh_of, pnorm
from .arnoldi import arnoldi_step, init_state, iterate, lsq_coeffs


def as_operand(x0, b: torch.Tensor):
    """x0 as a tensor like b (dtype, device), or None."""
    if x0 is None:
        return None
    return torch.as_tensor(x0, dtype=b.dtype, device=b.device)


def warn_breakdown() -> None:
    warnings.warn(
        "GMRES broke down, either initial guess is exact or, more likely, "
        "something has gone wrong."
    )


def _gmres_device(A, b, x0, k, tol, pre, history, ortho):
    """GMRES on the device core: CGMRES without constraints, its gate open
    from the first step (``contol`` infinite)."""
    from .cgmres import _run_device

    x, info = _run_device(A, b, x0, k, tol, math.inf, (), pre, CTOL, history,
                          False, ortho)
    out = {"name": "gmres", "res": info["res"], "steps": info["steps"],
           "breakdown": info["breakdown"]}
    if history:
        out["x"] = info["x"]
    return x, out


def gmres(
    A,
    b: torch.Tensor,
    x0=None,
    k: int = 30,
    tol: float = 1e-50,
    pre=None,
    history: bool = False,
    ortho: str = "cgs2",
    loop: str = "host",
):
    """Solve ``A x = b`` with right-preconditioned flexible GMRES.

    Returns ``(x, info)``: ``info`` holds ``name``, the per-iteration true
    residuals ``res`` (numpy, trimmed to the steps taken), ``steps``,
    ``breakdown`` and, when ``history=True``, the iterate history ``x``
    whose row 0 holds the initial residual vector (reference quirk,
    solvers.py:75-80).  ``loop``: ``"host"`` or ``"while"`` (the device
    core).
    """
    check_storage(b)
    x0 = as_operand(x0, b)
    if loop == "while":
        return _gmres_device(A, b, x0, k, tol, pre, history, ortho)
    if loop != "host":
        raise ValueError(f"loop={loop!r}: use 'host' or 'while'")
    if x0 is None:
        x0 = torch.zeros_like(b)
    prefunc = as_preconditioner(pre)
    mesh = mesh_of(A)
    r0 = b - A @ x0
    beta = float(pnorm(r0, mesh))
    st = init_state(r0, beta, k)
    res = np.full(k, np.inf)
    xs = None
    if history:
        xs = torch.zeros((k + 1, b.shape[0]), dtype=b.dtype, device=b.device)
        xs[0] = r0

    x, j, done, brk = x0, 0, beta < tol, False
    while j < k and not done:
        hlast = arnoldi_step(A, prefunc, st, j, ortho)
        brk_now = hlast == 0
        x = iterate(st, lsq_coeffs(st, j), j, x0)
        r = float(pnorm(A @ x - b, mesh))
        res[j] = r
        if history:
            xs[j + 1] = x
        done = r < tol or brk_now
        brk = brk or brk_now
        j += 1
    if brk:
        warn_breakdown()
    info = {"name": "gmres", "res": res[:j], "steps": j, "breakdown": brk}
    if history:
        info["x"] = xs[: j + 1]
    return x, info
