"""Problem-agnostic solver wrappers (parity with the per-problem
``LinearSolver.py`` modules of the reference).

``cgmres_wrapper`` uses the tolerance-driven CGMRES for realistic
tolerances and the prototypical constraint-by-constraint solver when the
tolerance is unrealistically small (``tol <= 1e-20``; reference
lkdv/LinearSolver.py:50-59).  ``exact`` is the direct-solver oracle
(SuperLU in the reference, lkdv/LinearSolver.py:76-83) — host scipy, for
validation only.

The JAX package's ``reduction_mode`` picks the in-loop reduction arithmetic
for f32 storage; the port stores f64 only, so it has no counterpart.

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


def cgmres_wrapper(system, x0=None, k=20, tol=1e-50, contol=10.0, pre=None,
                   timing=None, history=False, **solver_opts):
    cons = system.constraints()
    if tol > PROTOTYPICAL_TOL:
        return cgmres(system.A, system.b, x0, k=k, tol=tol, contol=contol,
                      constraints=cons, pre=pre, timing=bool(timing),
                      history=history, **solver_opts)
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
