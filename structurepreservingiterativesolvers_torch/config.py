"""Global settings of the PyTorch port.

The port computes in float64 by default: the constraint deviations it
certifies sit at the 1e-12 level (the reference's hard-coded ``ctol``,
reference ``solvers.py:138``), and the card has native f64.  A caller may
store the n-sized vectors in float32 instead, through the models'
``dtype=`` argument: the JAX package's TPU mode (its ``default_dtype`` on
a TPU).  The k-sized constraint and KKT state then stays in f64
(``cdtype``), and the returned iterate is projected onto the invariants
(``constraints/projection.py``).  There is no device default: every public
entry point takes ``device=`` explicitly.
"""

from __future__ import annotations

import torch

DEFAULT_DTYPE = torch.float64

# the storage dtypes the solvers take
STORAGE = (torch.float64, torch.float32)

# where the solvers keep their k-sized state (Hessenberg matrix, Givens QR,
# reduced constraints, KKT); the n-sized state stays on the operands' device
HOST = torch.device("cpu")

# Tolerance of the constraint-enforcement minimisation problem; mirrors the
# reference's hard-coded ctol (reference solvers.py:138).
CTOL = 1e-12


def check_storage(*tensors: torch.Tensor) -> None:
    """The solvers store vectors in f64 or f32 (the JAX package's f32
    storage mode); any other dtype is refused."""
    for t in tensors:
        if t is not None and t.dtype not in STORAGE:
            raise NotImplementedError(
                f"solver storage dtype {t.dtype} is not supported; the port "
                "solves in float64 or float32")


def cdtype(dt: torch.dtype, mixed: bool = True) -> torch.dtype:
    """The dtype of the k-sized constraint and KKT state for storage ``dt``:
    f64 when the storage is f32 and ``mixed`` (the JAX package's
    ``cdtype``, ``solvers/cgmres.py:172`` there), else the storage dtype."""
    return torch.float64 if mixed and dt == torch.float32 else dt
