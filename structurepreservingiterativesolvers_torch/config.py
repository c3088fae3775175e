"""Global settings of the PyTorch port.

The port computes in float64 by default: the constraint deviations it
certifies sit at the 1e-12 level (the reference's hard-coded ``ctol``,
reference ``solvers.py:138``), and the card has native f64.  There is no
device default: every public entry point takes ``device=`` explicitly.
"""

from __future__ import annotations

import torch

DEFAULT_DTYPE = torch.float64

# where the solvers keep their k-sized state (Hessenberg matrix, Givens QR,
# reduced constraints, KKT); the n-sized state stays on the operands' device
HOST = torch.device("cpu")

# Tolerance of the constraint-enforcement minimisation problem; mirrors the
# reference's hard-coded ctol (reference solvers.py:138).
CTOL = 1e-12


def require_f64(*tensors: torch.Tensor) -> None:
    """The solvers store vectors in f64 only.  The JAX package's f32 storage
    path (mixed-precision reduction, double-f32 arithmetic, invariant snap)
    exists for f64-poor hardware and is not part of the port."""
    for t in tensors:
        if t is not None and t.dtype != torch.float64:
            raise NotImplementedError(
                f"solver storage dtype {t.dtype} is not supported; the port "
                "solves in float64 (f32 storage: ROADMAP.md, Queue 1, item 2)"
            )
