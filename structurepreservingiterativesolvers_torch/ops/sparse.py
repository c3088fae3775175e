"""Sparse matrices on the device: the DIA format.

``DIA`` stores a matrix by diagonals, optionally periodic (wrapping).  The
FEM operators on structured periodic meshes (lkdv, swe) have a small fixed
set of diagonals, so ``A @ x`` is one DIA SpMV: on a CUDA tensor the
hand-written kernel (``kernels/dia_spmv.py``), with the operator's live
plan where it pays, on a CPU tensor its plain twin.  ``A @ X`` for a tall
matrix stays plain PyTorch, as it stays outside any Pallas kernel in the JAX
package.

Conversion from scipy runs on the host and copies the wrap auto-detection
of the JAX package exactly (``ops/sparse.py:354-425`` there).  Where that
package would pick its padded-row ELL format, this one raises: ELL arrives
with the AMG slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_DTYPE
from ..kernels.dia_spmv import (
    DiaLaunch,
    LivePlan,
    dia_launch,
    dia_spmv as _dia_spmv,
    launch,
    live_chunk,
    live_plan,
    shift as _shift,
)


@dataclasses.dataclass(frozen=True)
class DIA:
    """Diagonal sparse matrix.

    ``data[d, i]`` holds ``A[i, i + offsets[d]]`` (row-aligned).  When
    ``wrap`` is true the column index is taken mod n (periodic meshes);
    otherwise out-of-range positions are structural zeros.

    The operator's live plan (``live``) and the kernel's launch, in the
    design the plan picks, are built on its first product on the card and
    kept here, so they belong to one ``data`` tensor: no code of the port
    writes ``data`` in place, and a DIA with new data (``astype``,
    ``dataclasses.replace``) starts without them.
    """

    data: torch.Tensor  # (ndiag, n)
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    wrap: bool
    _plan: Optional[LivePlan] = dataclasses.field(default=None, init=False,
                                                  repr=False, compare=False)
    _launch: Optional[DiaLaunch] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def astype(self, dtype) -> "DIA":
        return dataclasses.replace(self, data=self.data.to(dtype))

    def live(self) -> LivePlan:
        """The live plan of the DIA kernel, built on the data's device on the
        first call and kept."""
        if self._plan is None:
            object.__setattr__(self, "_plan",
                               live_plan(self.data, live_chunk(self.dtype)))
        return self._plan

    def __matmul__(self, other: torch.Tensor) -> torch.Tensor:
        if other.dim() == 1:
            return dia_spmv(self, other)
        return dia_spmm(self, other)

    def todense(self) -> torch.Tensor:
        n, m = self.shape
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        rows = torch.arange(n, device=self.device)
        for d, off in enumerate(self.offsets):
            cols = rows + off
            if self.wrap:
                out.index_put_((rows, cols % m), self.data[d], accumulate=True)
            else:
                valid = (cols >= 0) & (cols < m)
                out.index_put_((rows[valid], cols[valid]), self.data[d][valid],
                               accumulate=True)
        return out


def dia_spmv(A: DIA, x: torch.Tensor) -> torch.Tensor:
    """``A @ x``: on CUDA tensors the DIA kernel, with A's live plan where
    the plan pays (``LivePlan.pays``; an Inf or NaN of x that only skipped
    zero segments read does not reach y there) and in the dense design
    elsewhere, through the launch A keeps (resolved again for an x of
    another dtype or device); on CPU tensors its plain twin."""
    if x.device.type != "cuda":
        return _dia_spmv(A.data, A.offsets, A.wrap, x)
    rec = A._launch
    if rec is None or not rec.takes(x):
        plan = A.live()
        rec = dia_launch(A.data, A.offsets, A.wrap, x,
                         plan if plan.pays else None)
        object.__setattr__(A, "_launch", rec)
    return launch(rec, x)


def dia_spmm(A: DIA, X: torch.Tensor) -> torch.Tensor:
    """``A @ X`` for a tall (n, m) X: one shifted copy per diagonal."""
    dtype = torch.promote_types(A.dtype, X.dtype)
    Y = torch.zeros((A.shape[0], X.shape[1]), dtype=dtype, device=X.device)
    for d, off in enumerate(A.offsets):
        Y = Y + A.data[d][:, None] * _shift(X, off, A.wrap)
    return Y


def dia_from_scipy(A, wrap: Optional[bool] = None, dtype=None, *,
                   device) -> DIA:
    """Convert, auto-detecting periodic (wrapping) diagonal structure.

    For periodic meshes, entries at (i, j) with j-i ≡ off (mod n) for small
    signed |off| are stored on wrapped diagonals; this keeps e.g. a periodic
    1-D stencil to a handful of diagonals instead of O(n) corner diagonals.
    """
    import scipy.sparse as sp

    A = sp.coo_matrix(A)
    A.sum_duplicates()
    n, m = A.shape
    if n != m:
        raise ValueError("DIA requires a square matrix")
    raw = A.col.astype(np.int64) - A.row.astype(np.int64)
    wrapped = ((raw + n // 2) % n) - n // 2
    if wrap is None:
        wrap = len(np.unique(wrapped)) < len(np.unique(raw))
    offs = wrapped if wrap else raw
    uniq = np.unique(offs)
    data = np.zeros((len(uniq), n), A.dtype)
    np.add.at(data, (np.searchsorted(uniq, offs), A.row), A.data)
    return DIA(
        torch.as_tensor(data, dtype=dtype or DEFAULT_DTYPE, device=device),
        tuple(int(o) for o in uniq), (n, m), bool(wrap),
    )


def from_scipy(A, dtype=None, max_diags: int = 64, min_fill: float = 0.2, *,
               device) -> DIA:
    """DIA when the matrix concentrates on few (possibly periodic) diagonals
    that are reasonably full; the JAX package's ELL otherwise, which this
    slice does not have."""
    import scipy.sparse as sp

    Ac = sp.coo_matrix(A)
    n, m = Ac.shape
    if n == m and Ac.nnz:
        raw = Ac.col.astype(np.int64) - Ac.row.astype(np.int64)
        wrapped = ((raw + n // 2) % n) - n // 2
        ndiag = min(len(np.unique(raw)), len(np.unique(wrapped)))
        fill = Ac.nnz / (ndiag * n)
        if ndiag <= min(max_diags, max(n // 4, 1)) and fill >= min_fill:
            return dia_from_scipy(A, dtype=dtype, device=device)
    raise NotImplementedError(
        "matrix is not diagonally structured; the ELL format is not ported yet"
    )


def to_scipy(A: DIA):
    import scipy.sparse as sp

    return sp.csr_matrix(A.todense().cpu().numpy())
