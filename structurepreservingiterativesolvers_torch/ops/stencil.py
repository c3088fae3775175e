"""Constant-stencil (matrix-free) operator for structured-grid FEM matrices.

The port of the JAX package's ``ops/stencil.py``.  Away from the boundary
every row of a structured-mesh operator is the same stencil, so
``A = C + E``: ``C`` has one constant per diagonal and ``E`` touches only the
boundary strips of the (R, C) grid view of the flat index.  ``A @ x`` then
reads no matrix data on the constant part.  On a CUDA tensor it is one
launch of the hand-written kernel ``kernels/stencil_spmv.py``, which also
applies ``E``; on a CPU tensor its plain twin.  ``A @ X`` for a tall (n, B)
X is one launch of the kernel's block form (#2b), each column bit-equal to
``A @ x`` on that vector.

``maybe_stencil`` performs the host-side decomposition at assembly time,
exactly as the JAX package does (the constant of each diagonal is its mode
over in-range rows; the residual must lie on the grid's boundary strips),
and returns the ``DIA`` unchanged otherwise.  ``Stencil`` mirrors the DIA
operator surface and keeps the full ``DIA`` as a field for the consumers
that need explicit matrix values (AMG set-up, oracles).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.stencil_spmv import (
    StencilLaunch,
    launch,
    launch_many,
    stencil_launch,
    stencil_spmm_torch,
    stencil_spmv as _stencil_spmv,
)
from .sparse import DIA


@dataclasses.dataclass(frozen=True)
class Stencil:
    """``A = C + E``: per-diagonal constants ``const`` (host floats, which
    the kernel takes by value) plus boundary-strip residuals on the (R, C)
    grid view (``grid_c`` = C; 0 when the matrix is exactly constant and no
    correction exists).  ``dia`` is the full operator.  The kernel's launch
    (``_launch``) is resolved on the first product on the card and kept, as
    the ``DIA`` keeps its live plan; a stencil with new data starts without
    one."""

    dia: DIA
    const: Tuple[float, ...]  # (ndiag,)
    top_vals: Optional[torch.Tensor]  # (ndiag, C) resid on rows [0, C)
    bot_vals: Optional[torch.Tensor]  # (ndiag, C) resid on rows [n-C, n)
    left_vals: Optional[torch.Tensor]  # (ndiag, R) resid on rows r*C
    right_vals: Optional[torch.Tensor]  # (ndiag, R) resid on rows r*C + C-1
    grid_c: int = 0
    _launch: Optional[StencilLaunch] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    # -- DIA-compatible surface -------------------------------------------
    @property
    def data(self) -> torch.Tensor:
        return self.dia.data

    @property
    def offsets(self) -> Tuple[int, ...]:
        return self.dia.offsets

    @property
    def shape(self) -> Tuple[int, int]:
        return self.dia.shape

    @property
    def wrap(self) -> bool:
        return self.dia.wrap

    @property
    def dtype(self) -> torch.dtype:
        return self.dia.dtype

    @property
    def device(self) -> torch.device:
        return self.dia.device

    @property
    def strips(self):
        if not self.grid_c:
            return None
        return self.top_vals, self.bot_vals, self.left_vals, self.right_vals

    def astype(self, dtype) -> "Stencil":
        """The operator in ``dtype``; the constants stay host floats, which
        the kernels round to ``dtype``."""
        cast = lambda t: None if t is None else t.to(dtype)  # noqa: E731
        return dataclasses.replace(
            self, dia=self.dia.astype(dtype), top_vals=cast(self.top_vals),
            bot_vals=cast(self.bot_vals), left_vals=cast(self.left_vals),
            right_vals=cast(self.right_vals))

    def __matmul__(self, other: torch.Tensor) -> torch.Tensor:
        if other.dim() == 1:
            return stencil_spmv(self, other)
        return stencil_spmm(self, other)

    def todense(self) -> torch.Tensor:
        return self.dia.todense()


def as_dia(A):
    """The explicit-matrix view of an operator (identity for plain DIA)."""
    return A.dia if isinstance(A, Stencil) else A


def _strip_cover(resid: np.ndarray, n: int, C: int):
    """Extract boundary-strip residuals for grid row length C, or None if
    nonzero residuals exist outside the strips."""
    if C < 2 or n % C or n // C < 3:
        return None
    R = n // C
    corr = np.any(resid != 0.0, axis=0)
    in_strip = np.zeros(n, bool)
    in_strip[:C] = True
    in_strip[n - C:] = True
    in_strip[::C] = True
    in_strip[C - 1::C] = True
    if np.any(corr & ~in_strip):
        return None
    top = resid[:, :C].copy()
    bot = resid[:, n - C:].copy()
    left = resid[:, ::C].copy()
    right = resid[:, C - 1::C].copy()
    # corner grid rows are fully covered by the top/bottom strips
    left[:, 0] = left[:, R - 1] = 0.0
    right[:, 0] = right[:, R - 1] = 0.0
    return top, bot, left, right


def maybe_stencil(A):
    """Decompose a DIA matrix into constant stencil + boundary-strip residual.

    The constant for each diagonal is its *mode* over in-range rows.  The
    SpMV is exact on uncorrected rows (``E`` is identically zero there); on
    corrected rows ``C·x + E·x`` differs from ``A·x`` only by one extra
    rounding of the split product.  Returns ``A`` unchanged when the
    corrected rows are not the boundary strips of a tensor-product grid,
    when a corrected operator wraps (periodic grids have no boundary
    strips), or when ``A`` is not a DIA.
    """
    if not isinstance(A, DIA):
        return A
    data = A.data.cpu().numpy()
    ndiag, n = data.shape
    const = np.zeros((ndiag,), data.dtype)
    resid = np.zeros_like(data)
    for d, off in enumerate(A.offsets):
        if A.wrap:
            inr = slice(0, n)
        else:
            inr = slice(max(0, -off), min(n, n - off))
        col = data[d, inr]
        if col.size == 0:
            continue
        vals, counts = np.unique(col, return_counts=True)
        const[d] = vals[np.argmax(counts)]
        resid[d, inr] = col - const[d]
        # out-of-range positions are structural zeros: the shifted read is 0
        # there regardless of the coefficient, so C never contributes and E
        # stays 0 — nothing to correct.
    const = tuple(float(c) for c in const)
    if not np.any(resid != 0.0):
        return Stencil(dia=A, const=const, top_vals=None, bot_vals=None,
                       left_vals=None, right_vals=None, grid_c=0)
    if A.wrap:
        return A
    # candidate grid row lengths: near the large offsets, and √n
    cands = []
    for off in A.offsets:
        a = abs(off)
        if a > 1:
            cands += [a - 1, a, a + 1]
    cands += [int(round(np.sqrt(n)))]
    seen = set()
    for C in cands:
        if C in seen:
            continue
        seen.add(C)
        strips = _strip_cover(resid, n, C)
        if strips is not None:
            top, bot, left, right = (
                torch.as_tensor(s, dtype=A.dtype, device=A.device)
                for s in strips)
            return Stencil(dia=A, const=const, top_vals=top, bot_vals=bot,
                           left_vals=left, right_vals=right, grid_c=int(C))
    return A


def _resolved(S: Stencil, x: torch.Tensor) -> StencilLaunch:
    """The launch S keeps for x's dtype and device (resolved again for
    another); x is a vector or a block (n, B)."""
    rec = S._launch
    if rec is None or not rec.takes(x):
        like = x if x.dim() == 1 else x.new_empty(x.shape[0])
        rec = stencil_launch(S.const, S.offsets, S.wrap, S.grid_c, S.strips,
                             like)
        object.__setattr__(S, "_launch", rec)
    return rec


def stencil_spmv(S: Stencil, x: torch.Tensor) -> torch.Tensor:
    """``S @ x``: the stencil kernel on CUDA tensors, through the launch S
    keeps (resolved again for an x of another dtype or device); its plain
    twin on CPU ones."""
    if x.device.type != "cuda":
        return _stencil_spmv(S.const, S.offsets, S.wrap, S.grid_c, S.strips, x)
    return launch(_resolved(S, x), x)


def stencil_spmm(S: Stencil, X: torch.Tensor) -> torch.Tensor:
    """``S @ X`` for a tall (n, B) X: on CUDA tensors the block form of
    the stencil kernel (#2b) through the launch S keeps, its result an
    (n, B) view of a (B, n) block; on CPU tensors the plain product on each
    column."""
    if X.device.type != "cuda":
        return stencil_spmm_torch(S.const, S.offsets, S.wrap, S.grid_c,
                                  S.strips, X)
    return launch_many(_resolved(S, X), X)
