"""Problem-agnostic solver wrappers (parity with the per-problem
``LinearSolver.py`` modules of the reference).

``cgmres_wrapper`` uses the tolerance-driven CGMRES for realistic
tolerances and the prototypical constraint-by-constraint solver when the
tolerance is unrealistically small (``tol <= 1e-20``; reference
lkdv/LinearSolver.py:50-59).  ``exact`` is the direct-solver oracle
(SuperLU in the reference, lkdv/LinearSolver.py:76-83) — host scipy, for
validation only.

``reduction_mode`` picks the in-loop reduction arithmetic for f32 storage,
as the JAX package's; ``cgmres_wrapper`` applies it.

Both wrappers pass ``**solver_opts`` (``ortho`` among them) to the solver.
The JAX ``gmres_wrapper`` takes none: its fused orthogonalisation is
switched by an environment variable, the port's by ``ortho="cgs2_fused"``.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..solvers import cgmres, cgmres_p, gmres

PROTOTYPICAL_TOL = 1e-20


def reduction_mode(system, tol) -> dict:
    """Solver options for the in-loop constraint reduction's arithmetic
    (JAX ``wrappers.py:24-55``).

    The f32 (snap-first) reduction perturbs the constraint manifold by
    ~eps32·|c|, raising the attainable constrained residual; where ``tol``
    lies between the plain f32 residual floor (≈ eps32·‖A‖·‖x‖, below which
    nothing terminates and the choice is only speed) and that elevation
    (≈ 100·eps32·max|c|; swe's |e0| ≈ 2.9e4 puts it at ~5e-3), the f32
    reduction blocks termination and the solver runs to k: switch to the
    f64 reduction there.  With f64 storage there is nothing to choose."""
    if system.b.dtype != torch.float32:
        return {}
    from ..ops.stencil import as_dia

    scale = max([abs(float(c.c)) for c in system.constraints()
                 if c.c is not None] or [0.0])
    eps32 = float(np.finfo(np.float32).eps)
    elevation = 100.0 * eps32 * scale
    try:
        anorm = float(as_dia(system.A).data.abs().sum(0).max())
        xnorm = float(torch.linalg.norm(system.z0))
        floor = eps32 * anorm * xnorm
    except (AttributeError, TypeError):
        floor = 0.0  # no DIA view or no z0: allow the f64 reduction
    if floor < tol < elevation:
        return {"f32_reduce": False}
    return {}


def cgmres_wrapper(system, x0=None, k=20, tol=1e-50, contol=10.0, pre=None,
                   timing=None, history=False, **solver_opts):
    cons = system.constraints()
    if tol > PROTOTYPICAL_TOL:
        opts = {**reduction_mode(system, tol), **solver_opts}
        return cgmres(system.A, system.b, x0, k=k, tol=tol, contol=contol,
                      constraints=cons, pre=pre, timing=bool(timing),
                      history=history, **opts)
    if timing:
        raise NotImplementedError(
            "Timings are not available for the prototypical solver"
        )
    return cgmres_p(system.A, system.b, x0, k=k, constraints=cons, pre=pre,
                    history=history, **solver_opts)


def gmres_wrapper(system, x0=None, k=20, tol=1e-50, contol=None, pre=None,
                  history=False, **solver_opts):
    if contol is not None:
        warnings.warn("contol is ignored as not used in GMRES")
    return gmres(system.A, system.b, x0, k=k, tol=tol, pre=pre, history=history,
                 **solver_opts)


def exact(system, x0=None, k=None, tol=None, pre=None, contol=None):
    """Direct-solve oracle via host sparse LU; returns (x, -1) like the
    reference's exact wrapper.  x lands on the system's device."""
    import scipy.sparse.linalg as spla

    x = spla.spsolve(system.A_csr, system.b.cpu().numpy().astype(np.float64))
    return torch.as_tensor(x, dtype=system.b.dtype, device=system.b.device), -1
