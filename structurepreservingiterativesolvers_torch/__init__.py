"""structurepreservingiterativesolvers_torch — the PyTorch/CUDA port of
``structurepreservingiterativesolvers_tpu``.

Constraint-satisfying Krylov solvers (CGMRES, CGMRES-p, GMRES) for
structure-preserving discretisations, in PyTorch for an NVIDIA H100, with
the DIA sparse matrix-vector product as a hand-written CUDA kernel.  The
JAX package stays the reference; module names follow it.  The port imports
torch, numpy and scipy, and never JAX.

Quick start::

    import structurepreservingiterativesolvers_torch as spt
    sys = spt.models.lkdv.linforms(M=50, degree=1, device="cuda")
    x, info = spt.solvers.cgmres(sys.A, sys.b, k=30, tol=1e-8,
                                 constraints=sys.constraints())

Importing the package builds and loads no kernel, starts no process group
and needs neither pandas nor matplotlib: each is reached at first use.
"""

from . import config  # noqa: F401
from . import constraints, kernels, ops, precond, solvers  # noqa: F401
from . import models, parallel, experiments, utils  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "config",
    "ops",
    "solvers",
    "constraints",
    "precond",
    "models",
    "parallel",
    "experiments",
    "utils",
    "kernels",
]
