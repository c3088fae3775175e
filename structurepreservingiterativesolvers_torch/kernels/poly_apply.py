"""Fused polynomial preconditioner applies: the hand-written Hopper kernels,
their plain PyTorch twins, and the wrappers that pick between them by the
device of the tensors.

``cheb_apply``: the degree-p Chebyshev three-term recurrence p(A) v, given
``theta``, ``delta`` and ``sigma = theta / delta`` of the spectral interval.
``neumann_apply``: the truncated Neumann series
``omega * sum_{i<p} (I - omega D^-1 A)^i D^-1 v``.  Both in the order and
with the roundings of the JAX package's unfused recurrences
(``precond/chebyshev.py``: ``Chebyshev.__call__``, ``Neumann.__call__``).

``A`` is either operator form of the port: a DIA (``data``, ``offsets``,
``wrap``) or a ``Stencil`` (``const``, ``offsets``, ``wrap``, ``grid_c`` and
``strips``), told apart by its ``const`` field.  The kernels replace the JAX
package's ``ops/pallas_poly.py::cheb_apply_fused`` and
``::neumann_apply_fused``, in two designs, each source saying what bounds
it and how it is laid out:

* tiled (``csrc/poly_tiled.cu``): a stencil with boundary strips on its
  (R, C) grid whose ascending offsets stay within one grid row and one grid
  column (heat's seven points).  One block per 2-D tile runs all p steps
  in shared memory on the tile and a halo of p points, and writes only y.
  ``tile_plan`` sizes the tile on the host.
* flat (``csrc/poly_apply.cu``): every other operator (the DIA form, a
  stencil without a grid or beyond that box) and every degree whose halo no
  tile holds.  One
  cooperative launch sweeps the whole vector p times, with grid-wide
  barriers between the sweeps and the recurrence vectors in scratch.

The design follows from the shapes alone (``poly_plan``), before the
launch; each design counts its own launches.

The block forms, "#3b" and "#4b": every wrapper takes a block v (n, B),
the JAX package's tall operand, and applies the polynomial to each column
in one launch of the same design with one more grid axis over the vectors
(the kernels under ``jax.vmap``).  The vectors are the rows of a (B, n)
block, read through its (n, B) view without a copy at any row stride; the
result is the (n, B) view of a new (B, n) block, each column bit-equal to
the single apply on that vector.  They count in ``<kind>_apply_many_cuda``
and ``<kind>_apply_many_<design>_cuda``, apart from the single applies.  The wrappers take the plain
version for CPU tensors only.  A CUDA tensor is launched through a kernel,
or the wrapper raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import torch

from . import count_f32
from .dia_spmv import dia_spmm_torch, dia_spmv_torch
from .stencil_spmv import (  # noqa: F401
    in_box,
    split_offsets,
    stencil_spmm_torch,
    stencil_spmv_torch,
)

MAX_DIAGS = 64  # POLY_MAX_DIAGS in csrc/poly_apply.cu
MAX_DEGREE = 64  # POLY_MAX_DEGREE
MAX_VECTORS = 65535  # POLY_MAX_VECTORS, TILED_MAX_VECTORS: a block launch

# The tiled design's plan on an H100 (csrc/poly_tiled.cu): the tile sides
# tried; a block's threads (TILED_THREADS), shared memory (TILED_MAX_SMEM)
# and registers a thread (capped by TILED_BLOCKS_PER_SM; ptxas, sm_90a);
# an SM's shared memory and what it keeps per resident block, its
# registers, threads and SMs
TILE_SIDES = (8, 16, 32, 64)
TILE_THREADS = 256
TILE_MAX_SMEM = 232_448
TILE_REGS = 80
SM_SMEM, SM_SMEM_PER_BLOCK = 233_472, 1024
SM_REGS, SM_THREADS = 65_536, 2048
SMS = 132
# the resident warps an SM needs to hide the latency of the sweeps' chains
# of dependent multiply-adds; fewer are charged in proportion
SM_BUSY_WARPS = 16


def _is_stencil(A) -> bool:
    return hasattr(A, "const")


def _matvec_torch(A, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` through the plain twin of A's SpMV kernel, for a vector or
    a block (n, B)."""
    if _is_stencil(A):
        twin = stencil_spmv_torch if x.dim() == 1 else stencil_spmm_torch
        return twin(A.const, A.offsets, A.wrap, A.grid_c, A.strips, x)
    if x.dim() == 2:
        return dia_spmm_torch(A.data, A.offsets, A.wrap, x)
    return dia_spmv_torch(A.data, A.offsets, A.wrap, x)


def cheb_coefficients(degree: int, delta: float, sigma: float):
    """The recurrence's scalars, in the JAX package's float arithmetic:
    ``c0 = 2 rho / delta`` for the first step, and for step k = 1 … p−1
    ``a_k = rho' rho`` and ``b_k = 2 rho' / delta``."""
    rho = 1.0 / sigma
    c0 = 2.0 * rho / delta
    a, b = [], []
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        a.append(rho_new * rho)
        b.append(2.0 * rho_new / delta)
        rho = rho_new
    return c0, a, b


def cheb_recurrence(matvec, degree: int, theta: float, delta: float,
                    sigma: float, v: torch.Tensor) -> torch.Tensor:
    """p(A) v by the Chebyshev three-term recurrence, one ``matvec`` per
    degree: the JAX package's unfused ``Chebyshev.__call__``, line for
    line."""
    rho = 1.0 / sigma
    x = v / theta
    r = v - matvec(x)
    d = (2.0 * rho / delta) * r
    for _ in range(degree - 1):
        x = x + d
        r = r - matvec(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
        rho = rho_new
    return x + d if degree >= 1 else x


def neumann_recurrence(matvec, dinv: torch.Tensor, degree: int, omega: float,
                       v: torch.Tensor) -> torch.Tensor:
    """The truncated Neumann series, one ``matvec`` per degree past the
    first: the JAX package's unfused ``Neumann.__call__``, line for line.
    On a block v (n, B) the diagonal scales each column."""
    if v.dim() == 2:
        dinv = dinv[:, None]
    z = omega * (dinv * v)
    acc = z
    for _ in range(degree - 1):
        z = z - omega * (dinv * matvec(z))
        acc = acc + z
    return acc


def cheb_apply_torch(A, degree: int, theta: float, delta: float,
                     sigma: float, v: torch.Tensor) -> torch.Tensor:
    """The plain version of the Chebyshev apply: the recurrence through the
    plain twin of A's SpMV."""
    return cheb_recurrence(functools.partial(_matvec_torch, A), degree, theta,
                           delta, sigma, v)


def neumann_apply_torch(A, dinv: torch.Tensor, degree: int, omega: float,
                        v: torch.Tensor) -> torch.Tensor:
    """The plain version of the Neumann apply."""
    return neumann_recurrence(functools.partial(_matvec_torch, A), dinv,
                              degree, omega, v)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """A tile of the tiled design: an interior of ``tile_r`` x ``tile_c``
    grid points (cut at the grid's last row and column), read with a halo of
    ``sweeps`` points on each side; ``tiles`` blocks in all, ``smem_bytes``
    of shared memory each, ``blocks_per_sm`` of them resident on an SM, and
    the planner's estimate of its time, ``cost``: waves of resident blocks
    times a block's steps (the steps of its warps down their runs of rows,
    and its load), over the share of ``SM_BUSY_WARPS`` that its resident
    warps make."""

    tile_r: int
    tile_c: int
    sweeps: int
    smem_bytes: int
    tiles: int
    blocks_per_sm: int
    cost: int

    @functools.cached_property
    def c_args(self):
        """The plan as the kernel's entry point takes it."""
        return (ctypes.c_int * 2)(self.tile_r, self.tile_c)


def sweeps(kind: str, degree: int) -> int:
    """The sweeps of an apply that read a shifted vector: p for Chebyshev
    (its first reads x = v / theta), p - 1 for Neumann."""
    return degree if kind == "cheb" else degree - 1


def tile_candidates(n: int, grid_c: int, offsets: tuple, n_sweeps: int,
                    itemsize: int) -> list:
    """Every tile of ``TILE_SIDES`` (cut to the grid) that fits ``n_sweeps``
    sweeps of the stencil with these flat ``offsets`` on a grid of
    ``n / grid_c`` rows of ``grid_c``: a halo no wider than the tile and a
    grid row, and shared memory within a block's.  None fits a stencil
    whose offsets, in ascending order, leave the 3 x 3 box of one grid row
    and one grid column."""
    if grid_c < 2 or n % grid_c or n // grid_c < 3 or n_sweeps < 0:
        return []
    R, C = n // grid_c, grid_c
    if not in_box(offsets, C) or n_sweeps > C:
        return []
    warps = TILE_THREADS // 32
    out = []
    for tile_r in sorted({min(t, R) for t in TILE_SIDES}):
        for tile_c in sorted({min(t, C) for t in TILE_SIDES}):
            if n_sweeps > min(tile_r, tile_c):
                continue
            rows, cols = tile_r + 2 * n_sweeps, tile_c + 2 * n_sweeps
            smem = (3 * rows * cols + tile_r * tile_c) * itemsize
            if smem > TILE_MAX_SMEM:
                continue
            # each warp's steps down its runs of rows in each sweep, and the
            # steps of the load
            work = warps * sum(
                -(-h // max(1, TILE_THREADS // w)) + 2
                for h, w in ((rows - 2 * k, cols - 2 * k)
                             for k in range(1, n_sweeps + 1)))
            work += rows * cols // 32
            per_sm = min(SM_THREADS // TILE_THREADS,
                         SM_REGS // (TILE_THREADS * TILE_REGS),
                         SM_SMEM // (smem + SM_SMEM_PER_BLOCK))
            tiles = -(-R // tile_r) * -(-C // tile_c)
            waves = math.ceil(tiles / (per_sm * SMS))
            busy = min(1.0, per_sm * warps / SM_BUSY_WARPS)
            out.append(TilePlan(tile_r, tile_c, n_sweeps, smem, tiles, per_sm,
                                round(waves * per_sm * work / busy)))
    return out


@functools.lru_cache(maxsize=256)
def tile_plan(n: int, grid_c: int, offsets: tuple, n_sweeps: int,
              itemsize: int) -> Optional[TilePlan]:
    """The tile of the tiled design: of ``tile_candidates``, the least
    ``cost`` (the larger tile on a tie); None where no tile fits."""
    return min(tile_candidates(n, grid_c, offsets, n_sweeps, itemsize),
               key=lambda p: (p.cost, -p.tile_r * p.tile_c, -p.tile_c),
               default=None)


def poly_plan(A, kind: str, degree: int,
              dtype: torch.dtype) -> Optional[TilePlan]:
    """The design of an apply, from shapes alone: the tile plan where the
    tiled design takes it (a stencil with boundary strips within the 3 x 3
    box, and a tile that fits), else None for the flat design."""
    if not _is_stencil(A) or not A.grid_c or A.wrap:
        return None
    itemsize = 8 if dtype == torch.float64 else 4
    return tile_plan(A.shape[0], int(A.grid_c), tuple(A.offsets),
                     sweeps(kind, degree), itemsize)


def poly_design(A, kind: str, degree: int, dtype: torch.dtype) -> str:
    """``"tiled"`` or ``"flat"``: the design that ``cheb_apply`` (kind
    ``"cheb"``) or ``neumann_apply`` (``"neumann"``) launches on the card."""
    return "flat" if poly_plan(A, kind, degree, dtype) is None else "tiled"


def _operands(A):
    """The tensors of A that the kernel reads."""
    if _is_stencil(A):
        return tuple(A.strips) if A.grid_c else ()
    return (A.data,)


def _check(A, degree: int, v: torch.Tensor, dinv=None) -> None:
    if v.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"polynomial kernels take f64 or f32; got v {v.dtype}")
    if not (v.dim() == 1 and v.is_contiguous()) and v.dim() != 2:
        raise ValueError(f"v must be a contiguous vector or a block (n, B), "
                         f"got {tuple(v.shape)}")
    n, ndiag = v.shape[0], len(A.offsets)
    if tuple(A.shape) != (n, n):
        raise ValueError(f"operator of shape {tuple(A.shape)} for v of {n}")
    if ndiag > MAX_DIAGS or any(abs(int(o)) >= n for o in A.offsets):
        raise ValueError(f"offsets {tuple(A.offsets)} must be at most "
                         f"{MAX_DIAGS} and lie in (-{n}, {n})")
    if not 1 <= degree <= MAX_DEGREE:
        raise ValueError(f"degree {degree} outside [1, {MAX_DEGREE}]")
    tensors = _operands(A) + (() if dinv is None else (dinv,))
    for t in tensors:
        if t.device != v.device or t.dtype != v.dtype:
            raise TypeError(f"operand {t.dtype} on {t.device}; v is {v.dtype} "
                            f"on {v.device}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if dinv is not None and tuple(dinv.shape) != (n,):
        raise ValueError(f"dinv of shape {tuple(dinv.shape)} for v of {n}")
    if _is_stencil(A) and A.grid_c:
        R = n // A.grid_c
        if A.wrap or n % A.grid_c or R < 3 or A.grid_c < 2:
            raise ValueError(
                f"strips need a non-wrapping operator on a grid of >= 3 rows "
                f"of grid_c = {A.grid_c} >= 2 (n = {n}, wrap = {A.wrap})")
        for s, m in zip(A.strips, (A.grid_c, A.grid_c, R, R)):
            if tuple(s.shape) != (ndiag, m):
                raise ValueError(f"strip of shape {tuple(s.shape)}, expected "
                                 f"({ndiag}, {m})")
    elif not _is_stencil(A) and tuple(A.data.shape) != (ndiag, n):
        raise ValueError(f"DIA data of shape {tuple(A.data.shape)} for "
                         f"{ndiag} offsets and n = {n}")


_OP_ARGTYPES = [ctypes.c_longlong, ctypes.c_int,
                ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
                ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p]
_TILED_OP_ARGTYPES = [ctypes.c_longlong, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_longlong),
                      ctypes.POINTER(ctypes.c_double), ctypes.c_longlong,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
_VP, _INT, _DBL = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_DBLS = ctypes.POINTER(ctypes.c_double)
# after the operator: the vectors, the flat design's scratch, the scalars
# (v, y, scratch, the vectors and their strides, degree, scalars)
_LL = ctypes.c_longlong
_ROWS = [_INT, _LL, _LL]
_ARGTYPES = {
    ("cheb", "flat"): [_VP, _VP, _VP, *_ROWS, _INT, _DBL, _DBL, _DBLS, _DBLS],
    ("cheb", "tiled"): [_VP, _VP, *_ROWS, _INT, _DBL, _DBL, _DBLS, _DBLS],
    ("neumann", "flat"): [_VP, _VP, _VP, _VP, *_ROWS, _INT, _DBL],
    ("neumann", "tiled"): [_VP, _VP, _VP, *_ROWS, _INT, _DBL],
}


@functools.lru_cache(maxsize=None)
def _entry(kind: str, design: str, dtype: torch.dtype):
    """The C entry point ``<kind>_apply_<f64|f32>`` of ``poly_apply.cu``
    (flat) or ``<kind>_tiled_<f64|f32>`` of ``poly_tiled.cu`` (tiled), built
    and loaded on first use."""
    from .build import load

    tag = "f64" if dtype == torch.float64 else "f32"
    if design == "flat":
        fn = getattr(load("poly_apply.cu"), f"{kind}_apply_{tag}")
        head = _OP_ARGTYPES
    else:
        fn = getattr(load("poly_tiled.cu"), f"{kind}_tiled_{tag}")
        head = _TILED_OP_ARGTYPES
    fn.argtypes = head + _ARGTYPES[kind, design] + [_INT, _VP]
    fn.restype = ctypes.c_int
    return fn


def _doubles(values):
    return (ctypes.c_double * max(len(values), 1))(*[float(x) for x in values])


@functools.lru_cache(maxsize=64)
def _c_operator(offsets: tuple, const: Optional[tuple]):
    """The offsets and the stencil's constants (None for a DIA) as the
    entry points take them, built once per operator."""
    offs = (ctypes.c_longlong * max(len(offsets), 1))(*offsets)
    return offs, None if const is None else _doubles(const)


@functools.lru_cache(maxsize=64)
def _c_cheb(degree: int, delta: float, sigma: float):
    """``c0`` and the arrays of ``a_k`` and ``b_k``, built once per
    preconditioner."""
    c0, a, b = cheb_coefficients(degree, delta, sigma)
    return c0, _doubles(a), _doubles(b)


def _op_args(A, n: int) -> list:
    offs, consts = _c_operator(tuple(A.offsets), getattr(A, "const", None))
    head = [n, len(A.offsets), offs, int(bool(A.wrap))]
    if not _is_stencil(A):
        return head + [A.data.data_ptr(), None, 0, None, None, None, None]
    strips = [s.data_ptr() for s in A.strips] if A.grid_c else [None] * 4
    return head + [None, consts, int(A.grid_c), *strips]


def _tiled_op_args(A, n: int, plan: TilePlan) -> list:
    offs, consts = _c_operator(tuple(A.offsets), A.const)
    return [n, len(A.offsets), offs, consts, int(A.grid_c),
            *[s.data_ptr() for s in A.strips], plan.c_args]


def _on_card(v: torch.Tensor, who: str) -> None:
    if v.device.type != "cuda":
        raise ValueError(f"{who} needs CUDA tensors, got {v.device}")


def _rows(v: torch.Tensor):
    """v as the kernels read it, and (nvec, ldv): a vector as one row; a
    block (n, B) as B rows of n values ``v.stride(1)`` apart where
    ``v.stride(0)`` is 1 and the rows do not overlap (the view X.T of a
    (B, n) block, at any row stride), any other layout copied into that
    one first."""
    n = v.shape[0]
    if v.dim() == 1:
        return v, 1, n
    nvec = v.shape[1]
    if nvec > MAX_VECTORS:
        raise ValueError(f"a block of {nvec} vectors: at most {MAX_VECTORS}")
    if n > 1 and (v.stride(0) != 1 or (nvec > 1 and v.stride(1) < n)):
        v = v.T.contiguous().T
    return v, nvec, v.stride(1)


# scratch vectors a flat launch needs per vector, by kind, and the degree
# from which it needs them
_SCRATCH = {"cheb": (4, 2), "neumann": (3, 3)}


def _launch(kind: str, design: str, A, plan: Optional[TilePlan], degree: int,
            v: torch.Tensor, dinv, scalars: tuple, counters: tuple):
    """One launch of ``kind`` in ``design`` on v (n,) or a block (n, B):
    y of v's shape, a block's as the (n, B) view of a new (B, n) block.
    ``scalars`` follow the degree (theta, c0, a, b; omega); each of
    ``counters`` counts the launch."""
    who = f"{kind}_apply ({design}{', block' if v.dim() == 2 else ''})"
    _on_card(v, who)
    _check(A, degree, v, dinv)
    if plan is not None and plan.sweeps != sweeps(kind, degree):
        raise ValueError(f"a plan of {plan.sweeps} sweeps for degree {degree}")
    n = v.shape[0]
    v, nvec, ldv = _rows(v)
    y = (torch.empty_like(v) if v.dim() == 1
         else torch.empty((nvec, n), dtype=v.dtype, device=v.device))
    vecs = [v.data_ptr()] + ([] if dinv is None else [dinv.data_ptr()])
    vecs.append(y.data_ptr())
    if design == "flat":
        per, from_degree = _SCRATCH[kind]
        scratch = (torch.empty(per * n * nvec, dtype=v.dtype, device=v.device)
                   if degree >= from_degree else None)
        vecs.append(None if scratch is None else scratch.data_ptr())
        head = _op_args(A, n)
    else:
        head = _tiled_op_args(A, n, plan)
    if nvec:
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = _entry(kind, design, v.dtype)(
            *head, *vecs, nvec, ldv, n, degree, *scalars,
            v.device.index or 0, stream)
        if err != 0:
            raise RuntimeError(f"{who} kernel launch failed: cudaError {err}")
    for counter in counters:
        counter.launches += 1
    count_f32(f"{kind}_apply", v.dtype)
    return y if v.dim() == 1 else y.T


def _cheb_scalars(theta, delta, sigma, degree):
    c0, a, b = _c_cheb(degree, float(delta), float(sigma))
    return float(theta), c0, a, b


def cheb_apply_flat_cuda(A, degree: int, theta: float, delta: float,
                         sigma: float, v: torch.Tensor) -> torch.Tensor:
    """Launch the flat design of kernel #3 (on a block, #3b) on PyTorch's
    current stream; does not synchronise."""
    return _launch("cheb", "flat", A, None, degree, v, None,
                   _cheb_scalars(theta, delta, sigma, degree),
                   _counters("cheb", "flat", v))


def cheb_apply_tiled_cuda(A, plan: TilePlan, degree: int, theta: float,
                          delta: float, sigma: float,
                          v: torch.Tensor) -> torch.Tensor:
    """Launch the tiled design of kernel #3 (on a block, #3b) with ``plan``
    on PyTorch's current stream; does not synchronise.  It allocates only
    y."""
    return _launch("cheb", "tiled", A, plan, degree, v, None,
                   _cheb_scalars(theta, delta, sigma, degree),
                   _counters("cheb", "tiled", v))


def neumann_apply_flat_cuda(A, dinv: torch.Tensor, degree: int, omega: float,
                            v: torch.Tensor) -> torch.Tensor:
    """Launch the flat design of kernel #4 (on a block, #4b) on PyTorch's
    current stream; does not synchronise."""
    return _launch("neumann", "flat", A, None, degree, v, dinv,
                   (float(omega),), _counters("neumann", "flat", v))


def neumann_apply_tiled_cuda(A, plan: TilePlan, dinv: torch.Tensor,
                             degree: int, omega: float,
                             v: torch.Tensor) -> torch.Tensor:
    """Launch the tiled design of kernel #4 (on a block, #4b) with ``plan``
    on PyTorch's current stream; does not synchronise.  It allocates only
    y."""
    return _launch("neumann", "tiled", A, plan, degree, v, dinv,
                   (float(omega),), _counters("neumann", "tiled", v))


def cheb_apply_cuda(A, degree: int, theta: float, delta: float, sigma: float,
                    v: torch.Tensor) -> torch.Tensor:
    """Launch kernel #3 (on a block, #3b) in the design ``poly_plan`` picks
    from the shapes."""
    plan = poly_plan(A, "cheb", degree, v.dtype)
    if plan is None:
        return cheb_apply_flat_cuda(A, degree, theta, delta, sigma, v)
    return cheb_apply_tiled_cuda(A, plan, degree, theta, delta, sigma, v)


def neumann_apply_cuda(A, dinv: torch.Tensor, degree: int, omega: float,
                       v: torch.Tensor) -> torch.Tensor:
    """Launch kernel #4 (on a block, #4b) in the design ``poly_plan`` picks
    from the shapes."""
    plan = poly_plan(A, "neumann", degree, v.dtype)
    if plan is None:
        return neumann_apply_flat_cuda(A, dinv, degree, omega, v)
    return neumann_apply_tiled_cuda(A, plan, dinv, degree, omega, v)


class _Launches:
    """A launch counter of the block forms, which have no wrapper of their
    own: the vector's wrappers take a block."""

    def __init__(self):
        self.launches = 0


# kernel launches of each design and of either, for one vector (#3, #4)
# and for a block (#3b, #4b: ``<kind>_apply_many``); reset them to count a
# run
cheb_apply_cuda.launches = neumann_apply_cuda.launches = 0
cheb_apply_flat_cuda.launches = cheb_apply_tiled_cuda.launches = 0
neumann_apply_flat_cuda.launches = neumann_apply_tiled_cuda.launches = 0
cheb_apply_many_cuda = _Launches()
cheb_apply_many_tiled_cuda = _Launches()
cheb_apply_many_flat_cuda = _Launches()
neumann_apply_many_cuda = _Launches()
neumann_apply_many_tiled_cuda = _Launches()
neumann_apply_many_flat_cuda = _Launches()


# the counters by (kind, block, design), design None for the kind's own
_COUNTERS = {
    ("cheb", False, None): cheb_apply_cuda,
    ("cheb", False, "flat"): cheb_apply_flat_cuda,
    ("cheb", False, "tiled"): cheb_apply_tiled_cuda,
    ("cheb", True, None): cheb_apply_many_cuda,
    ("cheb", True, "flat"): cheb_apply_many_flat_cuda,
    ("cheb", True, "tiled"): cheb_apply_many_tiled_cuda,
    ("neumann", False, None): neumann_apply_cuda,
    ("neumann", False, "flat"): neumann_apply_flat_cuda,
    ("neumann", False, "tiled"): neumann_apply_tiled_cuda,
    ("neumann", True, None): neumann_apply_many_cuda,
    ("neumann", True, "flat"): neumann_apply_many_flat_cuda,
    ("neumann", True, "tiled"): neumann_apply_many_tiled_cuda,
}


def _counters(kind: str, design: str, v: torch.Tensor) -> tuple:
    """The counters a launch on v counts in: its kind's and its design's,
    of the single form for a vector and of the block form for a block."""
    block = v.dim() == 2
    return _COUNTERS[kind, block, None], _COUNTERS[kind, block, design]


def cheb_apply(A, degree: int, theta: float, delta: float, sigma: float,
               v: torch.Tensor) -> torch.Tensor:
    """The wrapper, for a vector v (n,) or a block (n, B): CUDA tensors go
    through kernel #3 (a block through its block form #3b, in one launch),
    CPU tensors through the plain version."""
    if v.device.type == "cuda":
        return cheb_apply_cuda(A, degree, theta, delta, sigma, v)
    if v.device.type == "cpu":
        _check(A, degree, v)
        return cheb_apply_torch(A, degree, theta, delta, sigma, v)
    raise ValueError(f"no Chebyshev apply for device {v.device}")


def neumann_apply(A, dinv: torch.Tensor, degree: int, omega: float,
                  v: torch.Tensor) -> torch.Tensor:
    """The wrapper, for a vector v (n,) or a block (n, B): CUDA tensors go
    through kernel #4 (a block through its block form #4b, in one launch),
    CPU tensors through the plain version."""
    if v.device.type == "cuda":
        return neumann_apply_cuda(A, dinv, degree, omega, v)
    if v.device.type == "cpu":
        _check(A, degree, v, dinv)
        return neumann_apply_torch(A, dinv, degree, omega, v)
    raise ValueError(f"no Neumann apply for device {v.device}")
