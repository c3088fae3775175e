"""Constant-stencil SpMV: the hand-written Hopper kernel, its plain PyTorch
twin, and the wrapper that picks between them by the device of the tensors.

``y[i] = sum_d const[d] * x[i + offsets[d]]`` (flat shifts, taken mod n when
``wrap`` is true and zero outside ``[0, n)`` otherwise), plus, when
``grid_c`` is not 0, the boundary-strip correction ``E x`` of an operator
``A = C + E`` on an (R, C) grid (``ops/stencil.py``).  ``strips`` is then
``(top, bot, left, right)``: the residuals on the first and last grid rows,
shaped ``(ndiag, C)``, and on the first and last grid columns, shaped
``(ndiag, R)``.

The kernel (``csrc/stencil_spmv.cu``) replaces the JAX package's
``ops/pallas_spmv.py::stencil_spmv_pallas`` and folds in the strip pass
that follows it there (``ops/stencil.py::_apply_strips``); its source says
what bounds it and how it is laid out.  It has two designs, picked from the
shapes alone before the launch (``stencil_plan``), each counting its own
launches (``stencil_spmv_cuda.launches`` counts both):

* tiled (``stencil_spmv_tiled_cuda``): a stencil with boundary strips whose
  ascending offsets stay within one grid row and one grid column (heat's
  seven points), on 2-D tiles of the (R, C) grid;
* flat (``stencil_spmv_flat_cuda``): every other stencil, one thread per
  flat row.

The two give the same bits.  ``stencil_launch`` resolves a stencil's
design and arguments once, and ``ops/stencil.py::Stencil`` keeps them, so a
product costs the host one C call (``launch``).  The wrapper takes the plain
version for CPU tensors only.  A CUDA tensor is launched through the kernel, or the wrapper
raises: there is no fallback.

The block form, "#2b" (``stencil_spmm``, ``launch_many``): the product with
each vector of a block X (n, B), the JAX package's tall operand, in one
launch of either design with one more grid axis over the vectors (the
kernel under ``jax.vmap``).  The vectors are the rows of a (B, n) block,
read through its (n, B) view ``X`` (``X.stride(0) == 1``) without a copy at
any row stride, odd ones too; the result is the (n, B) view of a new
(B, n) block.  Each column is bit-equal to kernel #2 on that vector.  Its
launches count in ``stencil_spmm_cuda`` and its design's
``stencil_spmm_{tiled,flat}_cuda``.  Its plain twin is the plain product
on each column.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import count_f32
from .dia_spmv import shift

MAX_DIAGS = 64  # STENCIL_MAX_DIAGS in csrc/stencil_spmv.cu
MAX_VECTORS = 65535  # STENCIL_MAX_VECTORS: vectors of one block launch
# The tiled design's tile: TX columns by TY x RUN rows of interior grid
# points, a block of TX x TY threads, each down a run of RUN rows, and a
# buffer of (TY RUN + 2) (TX + 2) values in shared memory (at most 48 KB in
# f64).  TILE is the fastest of TILES at heat M=1024 on an H100
# (chip_smoke.py times them all); every tile gives the same bits.
TILES = tuple((tx, ty, run) for tx in (32, 64, 128)
              for ty in (128 // tx, 256 // tx) for run in (4, 8, 16))
TILE = (32, 4, 4)

Strips = Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]


def _window(x: torch.Tensor, start: int, length: int) -> torch.Tensor:
    """x[start : start + length] with zero fill outside [0, n)."""
    n = x.shape[0]
    lo, hi = max(start, 0), min(start + length, n)
    if hi <= lo:
        return torch.zeros(length, dtype=x.dtype, device=x.device)
    return F.pad(x[lo:hi], (lo - start, start + length - hi))


def _apply_strips(offsets: Sequence[int], grid_c: int, strips, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """Add the boundary-strip correction to the constant-part product, in the
    JAX package's order (``ops/stencil.py::_apply_strips``): every strip
    term reads the flat shifted x, a column of the (R, C) view shifted by
    whole grid rows."""
    top_vals, bot_vals, left_vals, right_vals = strips
    n = x.shape[0]
    C = grid_c
    R = n // C
    top = bot = lcorr = rcorr = None
    for d, off in enumerate(offsets):
        tt = top_vals[d] * _window(x, off, C)
        bb = bot_vals[d] * _window(x, n - C + off, C)
        top = tt if top is None else top + tt
        bot = bb if bot is None else bot + bb
    X = x.reshape(R, C)
    for d, off in enumerate(offsets):
        # rows r·C + base read x[r·C + base + off] = X[r + q, rem]
        q, rem = divmod(off, C)
        term = left_vals[d] * _window(X[:, rem], q, R)
        lcorr = term if lcorr is None else lcorr + term
        q, rem = divmod(C - 1 + off, C)
        term = right_vals[d] * _window(X[:, rem], q, R)
        rcorr = term if rcorr is None else rcorr + term
    corr = (
        F.pad(top[None, :], (0, 0, 0, R - 1))
        + F.pad(bot[None, :], (0, 0, R - 1, 0))
        + F.pad(lcorr[:, None], (0, C - 1))
        + F.pad(rcorr[:, None], (C - 1, 0))
    )
    return (y.reshape(R, C) + corr).reshape(n)


def stencil_spmv_torch(const: Sequence[float], offsets: Sequence[int],
                       wrap: bool, grid_c: int, strips: Strips,
                       x: torch.Tensor) -> torch.Tensor:
    """The plain version: the constant chain, one shifted copy of x per
    diagonal in diagonal order, then the strip pass (as
    ``ops/stencil.py::stencil_spmv`` of the JAX package on its XLA path)."""
    y = torch.zeros_like(x)
    for c, off in zip(const, offsets):
        y = y + c * shift(x, int(off), wrap)
    if grid_c:
        y = _apply_strips(offsets, grid_c, strips, x, y)
    return y


def stencil_spmm_torch(const: Sequence[float], offsets: Sequence[int],
                       wrap: bool, grid_c: int, strips: Strips,
                       X: torch.Tensor) -> torch.Tensor:
    """The plain version of the block form: the plain product on each
    column of X (n, B)."""
    return torch.stack([stencil_spmv_torch(const, offsets, wrap, grid_c,
                                           strips, X[:, b])
                        for b in range(X.shape[1])], dim=1)


def split_offsets(offsets, grid_c: int) -> tuple:
    """Each flat offset as ``(dr, dc)``, ``offset = dr * grid_c + dc`` with
    ``-grid_c/2 <= dc < grid_c/2``: the rows and columns of the (R, C) grid
    that it shifts by (as ``box_cell`` in ``csrc/stencil_row.cuh`` splits
    it)."""
    half = grid_c // 2
    out = []
    for off in offsets:
        dr, rem = divmod(int(off) + half, grid_c)
        out.append((dr, rem - half))
    return tuple(out)


def in_box(offsets, grid_c: int) -> bool:
    """The offsets, in ascending order, each within the 3 x 3 box of one
    grid row and one grid column."""
    return (all(max(abs(dr), abs(dc)) <= 1
                for dr, dc in split_offsets(offsets, grid_c))
            and all(a < b for a, b in zip(offsets, offsets[1:])))


@dataclasses.dataclass(frozen=True)
class StencilTile:
    """A tile of the tiled design: ``tx`` interior columns by ``ty * run``
    interior rows, a block of ``tx`` x ``ty`` threads."""

    tx: int
    ty: int
    run: int

    @functools.cached_property
    def c_args(self):
        """The plan as the kernel's entry point takes it."""
        return (ctypes.c_int * 3)(self.tx, self.ty, self.run)


def stencil_tiles(n: int, grid_c: int, offsets: tuple, wrap: bool) -> list:
    """Every tile of ``TILES`` for the tiled design, which takes a
    non-wrapping stencil with strips on a grid of at least 3 x 3 whose
    ascending offsets lie in the 3 x 3 box (at most 9 of them); none
    otherwise."""
    if (wrap or grid_c < 3 or n % grid_c or n // grid_c < 3
            or not 1 <= len(offsets) <= 9 or not in_box(offsets, grid_c)):
        return []
    return [StencilTile(*t) for t in TILES]


@functools.lru_cache(maxsize=256)
def stencil_plan(n: int, grid_c: int, offsets: tuple,
                 wrap: bool) -> Optional[StencilTile]:
    """The design of a product, from shapes alone: the tile ``TILE`` where
    the tiled design takes the stencil (``grid_c`` 0 means no strips), else
    None for the flat design."""
    if not grid_c or not stencil_tiles(n, grid_c, offsets, wrap):
        return None
    return StencilTile(*TILE)


def _check(const, offsets, wrap, grid_c, strips, x) -> None:
    if x.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"stencil kernel takes f64 or f32; got x {x.dtype}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous vector, got {tuple(x.shape)}")
    ndiag, n = len(offsets), x.shape[0]
    if len(const) != ndiag or ndiag > MAX_DIAGS:
        raise ValueError(
            f"{len(const)} constants for {ndiag} offsets (at most {MAX_DIAGS})")
    if any(abs(int(o)) >= n for o in offsets):
        raise ValueError(f"offsets {tuple(offsets)} must lie in (-{n}, {n})")
    if not grid_c:
        if strips is not None:
            raise ValueError("strips given without a grid row length")
        return
    if wrap or n % grid_c or n // grid_c < 3 or grid_c < 2:
        raise ValueError(
            f"strips need a non-wrapping operator on a grid of >= 3 rows of "
            f"grid_c = {grid_c} >= 2 (n = {n}, wrap = {wrap})")
    R = n // grid_c
    for name, s, m in zip(("top", "bot", "left", "right"), strips,
                          (grid_c, grid_c, R, R)):
        if s.device != x.device or s.dtype != x.dtype:
            raise TypeError(f"{name} strip is {s.dtype} on {s.device}; x is "
                            f"{x.dtype} on {x.device}")
        if tuple(s.shape) != (ndiag, m) or not s.is_contiguous():
            raise ValueError(f"{name} strip must be contiguous ({ndiag}, {m}), "
                             f"got {tuple(s.shape)}")


@functools.lru_cache(maxsize=None)
def _entry(design: str, dtype: torch.dtype):
    """The C entry point of ``design`` for ``dtype``, built and loaded on
    first use."""
    from .build import load

    tag = "f64" if dtype == torch.float64 else "f32"
    lib = load("stencil_spmv.cu")
    # x, y, the vectors and their strides, then the operator
    head = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_double)]
    strips = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p]
    if design == "flat":
        fn = getattr(lib, f"stencil_spmv_{tag}")
        fn.argtypes = head + [ctypes.c_int] + strips + [ctypes.c_int,
                                                         ctypes.c_void_p]
    else:
        fn = getattr(lib, f"stencil_tiled_{tag}")
        fn.argtypes = head + strips + [ctypes.POINTER(ctypes.c_int),
                                       ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@dataclasses.dataclass(frozen=True)
class StencilLaunch:
    """A stencil's launches of the kernel, resolved once: the design (and the
    tile of the tiled one), the operator as the design's entry point takes
    it (``args``, which hold the strips' addresses; ``strips`` keeps them
    alive), and the x it takes.  ``ops/stencil.py::Stencil`` keeps its own,
    so a product costs the host one C call and the check of x."""

    design: str  # "tiled" or "flat"
    tile: Optional[StencilTile]
    n: int
    dtype: torch.dtype
    device: torch.device
    args: tuple
    strips: Strips

    def takes(self, x: torch.Tensor) -> bool:
        return x.dtype == self.dtype and x.device == self.device


def stencil_launch(const: Sequence[float], offsets: Sequence[int],
                   wrap: bool, grid_c: int, strips: Strips, x: torch.Tensor,
                   design: Optional[str] = None,
                   tile: Optional[StencilTile] = None) -> StencilLaunch:
    """Check the stencil against x (a CUDA vector) and resolve its launch: in
    ``design``, by default the one ``stencil_plan`` picks from the shapes;
    the tiled design with ``tile``, by default the plan's."""
    if x.device.type != "cuda":
        raise ValueError(f"the stencil kernel needs CUDA tensors, got "
                         f"{x.device}")
    _check(const, offsets, wrap, grid_c, strips, x)
    n, offsets = x.shape[0], tuple(int(o) for o in offsets)
    plan = stencil_plan(n, int(grid_c), offsets, bool(wrap))
    design = design or ("flat" if plan is None else "tiled")
    if design == "tiled":
        if plan is None:
            raise ValueError(f"the tiled design does not take offsets "
                             f"{offsets} on grid_c = {grid_c}, wrap = {wrap}")
        tile = tile or plan
    elif design == "flat":
        tile = None
    else:
        raise ValueError(f"no stencil design {design!r}")
    ndiag = max(len(offsets), 1)
    operator = (n, len(offsets), (ctypes.c_longlong * ndiag)(*offsets),
                (ctypes.c_double * ndiag)(*map(float, const)))
    ptrs = tuple(s.data_ptr() for s in strips) if grid_c else (None,) * 4
    if design == "flat":
        args = operator + (int(bool(wrap)), int(grid_c)) + ptrs
    else:
        args = operator + (int(grid_c),) + ptrs + (tile.c_args,)
    return StencilLaunch(design, tile, n, x.dtype, x.device, args, strips)


def launch(rec: StencilLaunch, x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel as ``rec`` resolved it, on PyTorch's current
    stream; does not synchronise.  The launch counts in its design's counter
    and in ``stencil_spmv_cuda``'s."""
    if (not rec.takes(x) or x.dim() != 1 or x.shape[0] != rec.n
            or not x.is_contiguous()):
        raise ValueError(f"the launch takes a contiguous {rec.dtype} vector "
                         f"of {rec.n} on {rec.device}; got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    y = torch.empty_like(x)
    if rec.n:
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry(rec.design, rec.dtype)(
            x.data_ptr(), y.data_ptr(), 1, rec.n, rec.n, *rec.args,
            rec.device.index or 0, stream)
        if err != 0:
            raise RuntimeError(f"stencil_spmv kernel launch failed "
                               f"({rec.design}): cudaError {err}")
    counter = (stencil_spmv_tiled_cuda if rec.design == "tiled"
               else stencil_spmv_flat_cuda)
    counter.launches += 1
    stencil_spmv_cuda.launches += 1
    count_f32("stencil_spmv", rec.dtype)
    return y


def launch_many(rec: StencilLaunch, X: torch.Tensor) -> torch.Tensor:
    """Launch the block form as ``rec`` resolved it on X (n, B), on
    PyTorch's current stream; returns A X as the (n, B) view of a new
    (B, n) block.  X is read as B rows of n values ``X.stride(1)`` apart
    where ``X.stride(0)`` is 1 and the rows do not overlap (the view X.T of
    a (B, n) block, at any row stride); any other layout is copied into
    that one first.  A block the kernel does not take (another dtype or
    device, n rows other than the operator's, more than ``MAX_VECTORS``
    vectors) raises; so does a launch it refuses.  The launch counts in
    ``stencil_spmm_cuda`` and its design's counter; does not
    synchronise."""
    if (not rec.takes(X) or X.dim() != 2 or X.shape[0] != rec.n
            or X.shape[1] > MAX_VECTORS):
        raise ValueError(f"the block launch takes a {rec.dtype} block of "
                         f"{rec.n} rows and at most {MAX_VECTORS} vectors on "
                         f"{rec.device}; got {X.dtype} {tuple(X.shape)} on "
                         f"{X.device}")
    nvec = X.shape[1]
    if rec.n > 1 and (X.stride(0) != 1 or (nvec > 1 and X.stride(1) < rec.n)):
        X = X.T.contiguous().T
    Y = torch.empty((nvec, rec.n), dtype=X.dtype, device=X.device)
    if nvec and rec.n:
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = _entry(rec.design, rec.dtype)(
            X.data_ptr(), Y.data_ptr(), nvec, X.stride(1), rec.n, *rec.args,
            rec.device.index or 0, stream)
        if err != 0:
            raise RuntimeError(f"stencil_spmm kernel launch failed "
                               f"({rec.design}, {nvec} vectors): cudaError "
                               f"{err}")
    counter = (stencil_spmm_tiled_cuda if rec.design == "tiled"
               else stencil_spmm_flat_cuda)
    counter.launches += 1
    stencil_spmm_cuda.launches += 1
    count_f32("stencil_spmm", rec.dtype)
    return Y.T


def stencil_spmv_flat_cuda(const: Sequence[float], offsets: Sequence[int],
                           wrap: bool, grid_c: int, strips: Strips,
                           x: torch.Tensor) -> torch.Tensor:
    """Launch the flat design on PyTorch's current stream; does not
    synchronise."""
    return launch(stencil_launch(const, offsets, wrap, grid_c, strips, x,
                                 "flat"), x)


def stencil_spmv_tiled_cuda(const: Sequence[float], offsets: Sequence[int],
                            grid_c: int, strips: Strips, plan: StencilTile,
                            x: torch.Tensor) -> torch.Tensor:
    """Launch the tiled design with the tile ``plan`` on PyTorch's current
    stream; does not synchronise."""
    return launch(stencil_launch(const, offsets, False, grid_c, strips, x,
                                 "tiled", plan), x)


def stencil_spmv_cuda(const: Sequence[float], offsets: Sequence[int],
                      wrap: bool, grid_c: int, strips: Strips,
                      x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel in the design ``stencil_plan`` picks from the
    shapes."""
    return launch(stencil_launch(const, offsets, wrap, grid_c, strips, x), x)


def stencil_spmm_flat_cuda(const: Sequence[float], offsets: Sequence[int],
                           wrap: bool, grid_c: int, strips: Strips,
                           X: torch.Tensor) -> torch.Tensor:
    """Launch the flat design of the block form on PyTorch's current
    stream; does not synchronise."""
    return launch_many(stencil_launch(const, offsets, wrap, grid_c, strips,
                                      _like(X), "flat"), X)


def stencil_spmm_tiled_cuda(const: Sequence[float], offsets: Sequence[int],
                            grid_c: int, strips: Strips, plan: StencilTile,
                            X: torch.Tensor) -> torch.Tensor:
    """Launch the tiled design of the block form with the tile ``plan`` on
    PyTorch's current stream; does not synchronise."""
    return launch_many(stencil_launch(const, offsets, False, grid_c, strips,
                                      _like(X), "tiled", plan), X)


def stencil_spmm_cuda(const: Sequence[float], offsets: Sequence[int],
                      wrap: bool, grid_c: int, strips: Strips,
                      X: torch.Tensor) -> torch.Tensor:
    """Launch the block form in the design ``stencil_plan`` picks."""
    return launch_many(stencil_launch(const, offsets, wrap, grid_c, strips,
                                      _like(X)), X)


def _like(X: torch.Tensor) -> torch.Tensor:
    """A vector of X's rows, dtype and device, for ``stencil_launch``."""
    if X.dim() != 2:
        raise ValueError(f"a block is (n, B), got {tuple(X.shape)}")
    return X.new_empty(X.shape[0])


# kernel launches of each design, and of either, for one vector and for a
# block; reset them to count a run
stencil_spmv_flat_cuda.launches = stencil_spmv_tiled_cuda.launches = 0
stencil_spmv_cuda.launches = 0
stencil_spmm_flat_cuda.launches = stencil_spmm_tiled_cuda.launches = 0
stencil_spmm_cuda.launches = 0


def stencil_spmv(const: Sequence[float], offsets: Sequence[int], wrap: bool,
                 grid_c: int, strips: Strips, x: torch.Tensor) -> torch.Tensor:
    """The wrapper: CUDA tensors go through the kernel, CPU tensors through
    the plain version."""
    if x.device.type == "cuda":
        return stencil_spmv_cuda(const, offsets, wrap, grid_c, strips, x)
    if x.device.type == "cpu":
        return stencil_spmv_torch(const, offsets, wrap, grid_c, strips, x)
    raise ValueError(f"no stencil SpMV for device {x.device}")


def stencil_spmm(const: Sequence[float], offsets: Sequence[int], wrap: bool,
                 grid_c: int, strips: Strips, X: torch.Tensor) -> torch.Tensor:
    """The block form's wrapper: CUDA tensors go through the kernel, CPU
    tensors through the plain version."""
    if X.device.type == "cuda":
        return stencil_spmm_cuda(const, offsets, wrap, grid_c, strips, X)
    if X.device.type == "cpu":
        return stencil_spmm_torch(const, offsets, wrap, grid_c, strips, X)
    raise ValueError(f"no stencil SpMM for device {X.device}")
