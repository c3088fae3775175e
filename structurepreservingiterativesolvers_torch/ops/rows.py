"""Operations on the rows of a block (B, n): the vectors of a batch of
solves that share their operators (the device core's batch axis,
``solvers/cgmres.py::DeviceCore``).

Each is one call for the whole block.  Where B is 1 it is the single
solve's own operation on the row (``A @ x`` through kernel #1, a
matrix-vector product over the basis), so that the single solve runs the
products it ran before the core had a batch axis; where B is more, the
operator takes the (n, B) view of the block (``A @ X`` through the batched
kernel #1 for a DIA, read without a copy) and the basis products are
batched matrix products.
"""

from __future__ import annotations

from typing import Callable

import torch


def rows(op: Callable[[torch.Tensor], torch.Tensor],
         V: torch.Tensor) -> torch.Tensor:
    """``op`` on each row of V (B, n), (B, n): on the (n, B) view ``V.T``,
    which an operator takes as the JAX package's tall operand."""
    if V.shape[0] == 1:
        return op(V[0])[None]
    return op(V.T).T


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The dot products of the rows of a and b (B, n), (B,)."""
    if a.shape[0] == 1:
        return torch.dot(a[0], b[0])[None]
    return torch.linalg.vecdot(a, b)


def basis_mv(Q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Q_b w_b for each b: Q (B, m, n), w (B, n), (B, m)."""
    if Q.shape[0] == 1:
        return (Q[0] @ w[0])[None]
    return (Q @ w[:, :, None])[:, :, 0]


def basis_rmv(h: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """h_b Q_b for each b: h (B, m), Q (B, m, n), (B, n)."""
    if Q.shape[0] == 1:
        return (h[0] @ Q[0])[None]
    return (h[:, None, :] @ Q)[:, 0]
