"""Point- and block-Jacobi preconditioners.

The port of the JAX package's ``precond/jacobi.py``: ``diagonal``,
``Jacobi`` and ``jacobi``; and the stand-ins for the reference's SuperLU ILU
(lkdvRK/Evolve.py:51-52), ``BlockJacobi`` and restricted additive Schwarz
(``RAS``), whose dense block inverses are built on the host with numpy and
applied on the device as a gather, one batched product (``torch.bmm``) and a
scatter.  Each takes a vector (n,) or a block (n, B), the (n, B) view of a
batch's rows as the batched device core hands it over: the gather makes
(nb, bs, B), one ``torch.bmm`` applies every block inverse to the B vectors
at once (the inverses read once for the block, what ``jax.vmap`` makes of
the JAX package's apply), and the scatter writes the rows.
``diagonal`` also feeds the Neumann series and the bound estimate of
``chebyshev.py``; it takes a DIA, a ``Stencil``, an ELL (the slots whose
column is the row, as the JAX package reads them) and a dense tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..config import DEFAULT_DTYPE
from ..ops.sparse import DIA, ELL
from ..ops.stencil import as_dia


def diagonal(A) -> torch.Tensor:
    """The main diagonal of a device operator (zeros where a DIA has no 0
    offset, as the JAX package returns)."""
    A = as_dia(A)  # Stencil → its explicit-matrix DIA view
    if isinstance(A, DIA):
        if 0 in A.offsets:
            return A.data[A.offsets.index(0)]
        return torch.zeros(A.shape[0], dtype=A.dtype, device=A.device)
    if isinstance(A, ELL):
        # the (r, n) transposed layout: slot s of row i at [s, i]; the hit
        # of cols == row where the value is not 0, as the JAX package
        rows = torch.arange(A.shape[0], device=A.device)[None, :]
        hit = (A.cols == rows) & (A.vals != 0)
        return torch.where(hit, A.vals, 0.0).sum(0)
    if isinstance(A, torch.Tensor):
        return torch.diagonal(A)
    raise NotImplementedError(
        f"no diagonal of a {type(A).__name__}: the port's operators are "
        "DIA, Stencil, ELL and dense tensors")


@dataclasses.dataclass(frozen=True)
class Jacobi:
    """Diagonal-inverse preconditioner, on a vector or on each column of a
    block (n, B)."""

    dinv: torch.Tensor

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return (self.dinv if v.dim() == 1 else self.dinv[:, None]) * v

    def solve(self, v: torch.Tensor) -> torch.Tensor:
        return self(v)


def jacobi(A) -> Jacobi:
    d = diagonal(A)
    safe = torch.where(d == 0, 1.0, d)
    return Jacobi(dinv=torch.where(d == 0, 1.0, 1.0 / safe))


def _block_solve(inv: torch.Tensor, idx: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """inv_p @ v[idx_p] for every block p, as one batched product: v (n,)
    or (n, B), the result (nb, bs) or (nb, bs, B)."""
    if v.dim() == 1:
        return torch.bmm(inv, v[idx].unsqueeze(-1)).squeeze(-1)
    return torch.bmm(inv, v[idx])


@dataclasses.dataclass(frozen=True)
class BlockJacobi:
    """Dense-inverse block Jacobi: y[idx_p] = inv_p @ v[idx_p].  Every dof
    belongs to exactly one block, and the blocks have one size."""

    idx: torch.Tensor  # (nb, bs) int64
    inv: torch.Tensor  # (nb, bs, bs)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        out = torch.zeros_like(v)  # a block keeps its layout
        out[self.idx.reshape(-1)] = _block_solve(self.inv, self.idx,
                                                 v).reshape(-1, *v.shape[1:])
        return out

    def solve(self, v: torch.Tensor) -> torch.Tensor:
        return self(v)


@dataclasses.dataclass(frozen=True)
class RAS:
    """Restricted additive Schwarz: overlapping dense block solves, each dof
    taking its value only from the block that owns it.  The scatter parks
    the non-owned rows in a spare slot past the end, as the JAX package does
    (``precond/jacobi.py:126-131`` there)."""

    idx: torch.Tensor  # (nb, bs) int64, overlapping blocks
    inv: torch.Tensor  # (nb, bs, bs)
    own: torch.Tensor  # (nb, bs) bool, the owned positions

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        n, rest = v.shape[0], v.shape[1:]
        own = self.own.reshape(*self.own.shape, *(1,) * len(rest))
        solved = torch.where(own, _block_solve(self.inv, self.idx, v), 0.0)
        # a block's result in the layout of the core's batch: the (n, B)
        # view of B rows, which the next product reads without a copy
        out = (v.new_zeros(n + 1) if not rest
               else v.new_zeros((rest[0], n + 1)).T)
        out[torch.where(self.own, self.idx, n).reshape(-1)] = solved.reshape(
            -1, *rest)
        return out[:-1]

    def solve(self, v: torch.Tensor) -> torch.Tensor:
        return self(v)


def _inverses(A_csr, blocks: Sequence[np.ndarray], dtype, device):
    """The stacked dense inverses of A's diagonal blocks (host numpy), and
    the block indices, on ``device``."""
    import scipy.sparse as sp

    A_csr = sp.csr_matrix(A_csr)
    blocks = [np.asarray(b) for b in blocks]
    if any(len(b) != len(blocks[0]) for b in blocks):
        raise ValueError("blocks must have uniform size")
    inv = np.stack([np.linalg.inv(A_csr[b][:, b].toarray()) for b in blocks])
    return (torch.as_tensor(np.stack(blocks), dtype=torch.int64, device=device),
            torch.as_tensor(inv, dtype=dtype or DEFAULT_DTYPE, device=device))


def block_jacobi(A_csr, blocks: Sequence[np.ndarray], dtype=None, *,
                 device) -> BlockJacobi:
    """Block Jacobi from a host CSR and equal-size index blocks."""
    idx, inv = _inverses(A_csr, blocks, dtype, device)
    return BlockJacobi(idx=idx, inv=inv)


def contiguous_blocks(n: int, bs: int) -> list:
    """Partition [0, n) into contiguous blocks of size bs."""
    if n % bs:
        raise ValueError(f"n={n} not divisible by block size {bs}")
    return list(np.arange(n).reshape(n // bs, bs))


def ras(A_csr, blocks: Sequence[np.ndarray], owned: Sequence[np.ndarray],
        dtype=None, *, device) -> RAS:
    """Restricted additive Schwarz from overlapping index blocks and their
    ownership masks (one per block, of its length)."""
    idx, inv = _inverses(A_csr, blocks, dtype, device)
    own = torch.as_tensor(np.stack([np.asarray(o, dtype=bool) for o in owned]),
                          device=device)
    return RAS(idx=idx, inv=inv, own=own)
