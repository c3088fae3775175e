"""Preconditioner protocol.

The reference accepts ``pre`` as either an object with ``.solve`` (an ILU
factor, a PyAMG preconditioner) or something supporting ``pre @ v``, with
``None`` meaning identity (reference ``solvers.py:60-73``).  Here a
preconditioner is anything callable on a device vector; this adapter
normalises the accepted spellings.
"""

from __future__ import annotations

from typing import Callable


def _identity(v):
    return v


def as_preconditioner(pre) -> Callable:
    if pre is None:
        return _identity
    if callable(pre) and not hasattr(pre, "__matmul__"):
        return pre
    if hasattr(pre, "solve"):
        return pre.solve
    if hasattr(pre, "__matmul__"):
        return lambda v: pre @ v
    raise ValueError(f"Preconditioner not supported: {type(pre)!r}")


def apply_preconditioner(pre, v):
    """Apply any accepted preconditioner spelling to a vector."""
    return as_preconditioner(pre)(v)


class IdentityPreconditioner:
    """Explicit identity (for API symmetry with the reference's
    ``sps.identity`` placeholder, solvers.py:62)."""

    def __call__(self, v):
        return v

    def solve(self, v):
        return v
