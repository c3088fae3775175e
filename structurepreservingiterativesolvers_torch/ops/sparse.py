"""Sparse matrices on the device: the DIA, ELL and BSR formats.

``DIA`` stores a matrix by diagonals, optionally periodic (wrapping).  The
FEM operators on structured periodic meshes (lkdv, swe, lkdvRK's stage
systems of degree 3 and 2 stages) have a small fixed set of diagonals, so
``A @ x`` is one DIA SpMV: on a CUDA tensor the hand-written kernel
(``kernels/dia_spmv.py``), with the operator's live plan where it pays, on a
CPU tensor its plain twin.  ``A @ X`` for a tall (n, B) X, the JAX package's
convention, is the batched kernel on the card (the counterpart of the JAX
package's ``dia_spmv_pallas`` under ``jax.vmap``), through the same plan and
launch, and its plain twin on the CPU.  Under autograd or
a ``torch.func`` transform ``A @ x`` is differentiable (``_DiaProduct``):
the general constraints differentiate through it.

``ELL`` (fixed-width padded rows, the general fallback) and ``BSR`` (dense
blocks at block-sparse positions) are plain XLA in the JAX package, a
gather and a row sum, and a batched block product with a segment sum; here
they are the same torch ops.

Conversion from scipy runs on the host and copies the JAX package's
(``ops/sparse.py:354-425`` there): DIA, with its wrap auto-detection, where
the matrix concentrates on few reasonably full diagonals, ELL otherwise.
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
    dia_spmm_torch,
    dia_spmv as _dia_spmv,
    dia_spmv_mixed_torch,
    launch,
    launch_many,
    launch_mixed,
    live_chunk,
    live_plan,
    shift as _shift,
)


def _traced(x: torch.Tensor) -> bool:
    """x takes part in autograd or in a ``torch.func`` transform."""
    return x.requires_grad or torch._C._functorch.is_functorch_wrapped_tensor(x)


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
    _transpose: Optional["DIA"] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    _upcast: Optional["DIA"] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    # this DIA is another's kept upcast operator: its launches count in
    # ``kernels.UPCAST`` too
    _is_upcast: bool = dataclasses.field(
        default=False, init=False, repr=False, compare=False)

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

    def transpose(self) -> "DIA":
        """Aᵀ as a DIA on the same device, built on the first call and kept:
        ``Aᵀ[i, i − off] = A[i − off, i]``, the diagonal of offset ``−off``
        is that of ``off`` read ``off`` rows back."""
        if self._transpose is None:
            order = sorted(range(len(self.offsets)),
                           key=lambda d: -self.offsets[d])
            data = torch.stack([_shift(self.data[d], -self.offsets[d],
                                       self.wrap) for d in order])
            At = DIA(data, tuple(-self.offsets[d] for d in order), self.shape,
                     self.wrap)
            object.__setattr__(self, "_transpose", At)
        return self._transpose

    def upcast(self) -> "DIA":
        """The operator in f64 (itself where it is f64), built on the first
        call and kept, with its own plan and launch: the f64 kernel #1 on
        an f64 vector from f32 storage (a stage map's P x) runs with a plan
        and copies no operator per product."""
        if self.dtype == torch.float64:
            return self
        if self._upcast is None:
            up = self.astype(torch.float64)
            object.__setattr__(up, "_is_upcast", True)
            object.__setattr__(self, "_upcast", up)
        return self._upcast

    def __matmul__(self, other: torch.Tensor) -> torch.Tensor:
        if _traced(other):
            return _DiaProduct.apply(other, self)
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


def _resolved(A: DIA, x: torch.Tensor) -> DiaLaunch:
    """The launch A keeps for x's dtype and device (resolved again for
    another): the live design where A's plan pays, the dense one
    elsewhere."""
    rec = A._launch
    if rec is None or not rec.takes(x):
        plan = A.live()
        like = x if x.dim() == 1 else x.new_empty(x.shape[0])
        rec = dia_launch(A.data, A.offsets, A.wrap, like,
                         plan if plan.pays else None)
        if A._is_upcast:
            rec = dataclasses.replace(rec, upcast=True)
        object.__setattr__(A, "_launch", rec)
    return rec


def dia_spmv(A: DIA, x: torch.Tensor) -> torch.Tensor:
    """``A @ x``: on CUDA tensors the DIA kernel, with A's live plan where
    the plan pays (``LivePlan.pays``; an Inf or NaN of x that only skipped
    zero segments read does not reach y there) and in the dense design
    elsewhere, through the launch A keeps (resolved again for an x of
    another dtype or device); on CPU tensors its plain twin."""
    if x.device.type != "cuda":
        return _dia_spmv(A.data, A.offsets, A.wrap, x)
    return launch(_resolved(A, x), x)


class _DiaProduct(torch.autograd.Function):
    """``A @ x`` under autograd or a ``torch.func`` transform (the general
    constraints' ``grad`` and ``hessian``), for a vector or a block x: the
    value is ``dia_spmv`` or ``dia_spmm`` (the kernels on the card), its
    derivatives are products with A (forward mode) and Aᵀ (reverse mode),
    and a batch of x (``vmap``) is one product with the block, its batch
    folded into the columns.  A transform's wrapper never reaches a kernel,
    which reads storage: a product of a tensor that another transform still
    wraps comes back here, one level down."""

    @staticmethod
    def forward(x, A):
        # Aᵀ is built here, below every transform: built inside one (in the
        # backward), its data would be a transform's wrapper, which has no
        # storage for the kernel to read
        A.transpose()
        return dia_spmv(A, x) if x.dim() == 1 else dia_spmm(A, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.A = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return ctx.A.transpose() @ grad, None

    @staticmethod
    def jvp(ctx, x_dot, _):
        return ctx.A @ x_dot

    @staticmethod
    def vmap(info, in_dims, x, A):
        X = x.movedim(in_dims[0], -1)
        return (A @ X.reshape(X.shape[0], -1)).reshape(X.shape), X.dim() - 1


def dia_spmm(A: DIA, X: torch.Tensor) -> torch.Tensor:
    """``A @ X`` for a tall (n, B) X: on CUDA tensors the batched kernel
    through the launch A keeps, its result an (n, B) view of a (B, n)
    block (read without a copy where X is such a view, ``launch_many``); on
    CPU tensors its plain twin, one shifted copy per diagonal."""
    if X.device.type != "cuda":
        return dia_spmm_torch(A.data, A.offsets, A.wrap, X)
    return launch_many(_resolved(A, X), X)


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


@dataclasses.dataclass(frozen=True)
class ELL:
    """Padded-row (ELLPACK) sparse matrix, stored transposed as in the JAX
    package: ``cols[s, i]`` / ``vals[s, i]`` hold slot ``s`` of row ``i``.
    Every row has ``row_width`` slots; padding points at column 0 with
    value 0, so no mask is needed."""

    cols: torch.Tensor  # (r, n) int64
    vals: torch.Tensor  # (r, n)
    shape: Tuple[int, int]

    @property
    def row_width(self) -> int:
        return self.cols.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def astype(self, dtype) -> "ELL":
        return dataclasses.replace(self, vals=self.vals.to(dtype))

    def __matmul__(self, other: torch.Tensor) -> torch.Tensor:
        if other.dim() == 1:
            return ell_spmv(self, other)
        return ell_spmm(self, other)

    def todense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        rows = torch.arange(self.shape[0], device=self.device).expand_as(self.cols)
        return out.index_put_((rows, self.cols), self.vals, accumulate=True)


@dataclasses.dataclass(frozen=True)
class BSR:
    """Block-sparse-row matrix: ``blocks[p]`` is the dense (bs × bs) block at
    block row ``block_rows[p]`` and block column ``block_cols[p]``."""

    blocks: torch.Tensor  # (p, bs, bs)
    block_rows: torch.Tensor  # (p,) int64
    block_cols: torch.Tensor  # (p,) int64
    shape: Tuple[int, int]

    @property
    def block_size(self) -> int:
        return self.blocks.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.dtype

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    def astype(self, dtype) -> "BSR":
        return dataclasses.replace(self, blocks=self.blocks.to(dtype))

    def __matmul__(self, other: torch.Tensor) -> torch.Tensor:
        if other.dim() == 1:
            return bsr_spmv(self, other)
        return bsr_spmm(self, other)

    def todense(self) -> torch.Tensor:
        bs = self.block_size
        nbr, nbc = self.shape[0] // bs, self.shape[1] // bs
        out = torch.zeros((nbr, nbc, bs, bs), dtype=self.dtype,
                          device=self.device)
        out.index_put_((self.block_rows, self.block_cols), self.blocks,
                       accumulate=True)
        return out.transpose(1, 2).reshape(self.shape)


def ell_spmv(A: ELL, x: torch.Tensor) -> torch.Tensor:
    """A gather of x at every slot, then the weighted slot sum."""
    return (A.vals * x[A.cols]).sum(0)


def ell_spmm(A: ELL, X: torch.Tensor) -> torch.Tensor:
    """One slot at a time, as the JAX ``lax.scan`` does, so that no
    (r, n, m) array is built.  Where X is the (m, B) view of the rows of a
    block (B, m) (each column contiguous: a batch as the device core hands
    it over), each slot gathers along the rows and adds its products in
    place (one multiply-add), and the result is the (n, B) view of a
    (B, n) block: the same sums in the same order, to the rounding of a
    fused multiply-add, without gathering a strided view and without a
    copy."""
    dtype = torch.promote_types(A.dtype, X.dtype)
    if X.shape[1] > 1 and X.stride(0) == 1:
        R = X.T
        Y = torch.zeros((R.shape[0], A.shape[0]), dtype=dtype,
                        device=X.device)
        for cols, vals in zip(A.cols, A.vals):
            Y.addcmul_(vals, torch.index_select(R, 1, cols))
        return Y.T
    Y = torch.zeros((A.shape[0], X.shape[1]), dtype=dtype, device=X.device)
    for cols, vals in zip(A.cols, A.vals):
        Y = Y + vals[:, None] * X[cols]
    return Y


def bsr_spmv(A: BSR, x: torch.Tensor) -> torch.Tensor:
    return bsr_spmm(A, x[:, None])[:, 0]


def bsr_spmm(A: BSR, X: torch.Tensor) -> torch.Tensor:
    """A batched product of every block with its block of X, summed into
    the block rows."""
    bs = A.block_size
    dtype = torch.promote_types(A.dtype, X.dtype)
    Xb = X.to(dtype).reshape(A.shape[1] // bs, bs, -1)
    prods = torch.bmm(A.blocks.to(dtype), Xb[A.block_cols])
    out = torch.zeros((A.shape[0] // bs, bs, X.shape[1]), dtype=dtype,
                      device=X.device)
    return out.index_add_(0, A.block_rows, prods).reshape(A.shape[0], -1)


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for any format of the port, or a dense matrix."""
    return A @ x


# --- f64 products from f32 storage ---------------------------------------------


def matvec_f64(M, x: torch.Tensor) -> torch.Tensor:
    """``M @ x`` in f64 from f32 storage (f32 M and x): f32 loads, f64
    products and f64 sums, the counterpart of the JAX package's double-f32
    ``constraints/quadratic.py::_dd_matvec``.  An f32 by f32 product is
    exact in f64, so this is at least as accurate as the pairs (unit
    roundoff 2^-53 against 2^-48).  The operator is the stored one: its
    f32-rounded entries are the operator the certificate holds.

    A DIA takes the mixed kernel #1 on the card (``launch_mixed``, in the
    design its live plan picks), its plain twin on the CPU, and an f64 x
    (a stage map's P x) the f64 kernel #1 on its kept upcast operator
    (``DIA.upcast``); an ELL an
    upcast gather; a dense matrix an upcast product; an operator with a
    ``matvec_f64`` method (``MatComb``, ``StageKron``, the models' block
    operators) its own, a term at a time.  A tall x (n, B) is taken a column
    at a time.  With f64 storage it is the plain product."""
    if x.dim() == 2:
        return torch.stack([matvec_f64(M, c) for c in x.unbind(1)], dim=1)
    if hasattr(M, "matvec_f64"):
        return M.matvec_f64(x)
    if isinstance(M, DIA):
        if M.dtype == torch.float64:
            return M @ x.double()
        if x.dtype == torch.float64:
            # an f64 vector (a stage map's P x): the upcast operator, kept
            return M.upcast() @ x
        if x.device.type != "cuda":
            return dia_spmv_mixed_torch(M.data, M.offsets, M.wrap, x)
        return launch_mixed(_resolved(M, x), x)
    if isinstance(M, ELL):
        return (M.vals.double() * x.double()[M.cols]).sum(0)
    if isinstance(M, torch.Tensor) and M.dim() == 2:
        return M.double() @ x.double()
    raise TypeError(f"no f64 product for operator type {type(M).__name__}; "
                    "gate with f64_supported()")


def f64_supported(M) -> bool:
    """``matvec_f64`` takes M (None, the zero operator, included): the
    counterpart of the JAX package's ``dd_supported``."""
    if M is None or isinstance(M, (DIA, ELL)):
        return True
    if hasattr(M, "matvec_f64"):
        ok = getattr(M, "f64_supported", None)
        return True if ok is None else ok()
    return isinstance(M, torch.Tensor) and M.dim() == 2


def spmm(A, X: torch.Tensor) -> torch.Tensor:
    """``A @ X`` for a tall X, for any format of the port, or a dense
    matrix."""
    if isinstance(A, DIA):
        return dia_spmm(A, X)
    if isinstance(A, ELL):
        return ell_spmm(A, X)
    if isinstance(A, BSR):
        return bsr_spmm(A, X)
    return A @ X


def ell_from_scipy(A, dtype=None, *, device) -> ELL:
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    A.sum_duplicates()
    n, m = A.shape
    widths = np.diff(A.indptr)
    r = max(int(widths.max()), 1)
    cols = np.zeros((r, n), np.int64)
    vals = np.zeros((r, n), A.dtype)
    # entry t of the CSR stream lands in slot t − indptr[row] of its row
    rows_per_nz = np.repeat(np.arange(n), widths)
    slots = np.arange(A.nnz) - A.indptr[rows_per_nz]
    cols[slots, rows_per_nz] = A.indices
    vals[slots, rows_per_nz] = A.data
    return ELL(torch.as_tensor(cols, device=device),
               torch.as_tensor(vals, dtype=dtype or DEFAULT_DTYPE,
                               device=device), (n, m))


def bsr_from_scipy(A, block_size: int, dtype=None, *, device) -> BSR:
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    n, m = A.shape
    bs = block_size
    if n % bs or m % bs:
        raise ValueError(f"shape {A.shape} not divisible by block size {bs}")
    Ab = sp.bsr_matrix(A, blocksize=(bs, bs))
    Ab.sort_indices()
    rows = np.repeat(np.arange(n // bs), np.diff(Ab.indptr))
    return BSR(
        torch.as_tensor(np.asarray(Ab.data), dtype=dtype or DEFAULT_DTYPE,
                        device=device),
        torch.as_tensor(rows, dtype=torch.int64, device=device),
        torch.as_tensor(Ab.indices, dtype=torch.int64, device=device),
        (n, m),
    )


def from_scipy(A, dtype=None, max_diags: int = 64, min_fill: float = 0.2, *,
               device):
    """DIA when the matrix concentrates on few (possibly periodic) diagonals
    that are reasonably full, else ELL: the JAX package's choice."""
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
    return ell_from_scipy(A, dtype=dtype, device=device)


def to_scipy(A):
    import scipy.sparse as sp

    return sp.csr_matrix(A.todense().cpu().numpy())
