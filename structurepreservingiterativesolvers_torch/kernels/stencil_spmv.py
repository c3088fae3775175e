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
what bounds it and how it is laid out.  The wrapper takes the plain version
for CPU tensors only.  A CUDA tensor is launched through the kernel, or the
wrapper raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .dia_spmv import shift

MAX_DIAGS = 64  # STENCIL_MAX_DIAGS in csrc/stencil_spmv.cu

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
def _entry(dtype: torch.dtype):
    """The C entry point for ``dtype``, built and loaded on first use."""
    from .build import load

    lib = load("stencil_spmv.cu")
    fn = lib.stencil_spmv_f64 if dtype == torch.float64 else lib.stencil_spmv_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
                   ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def stencil_spmv_cuda(const: Sequence[float], offsets: Sequence[int],
                      wrap: bool, grid_c: int, strips: Strips,
                      x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on PyTorch's current stream; does not synchronise."""
    if x.device.type != "cuda":
        raise ValueError(f"stencil_spmv_cuda needs CUDA tensors, got {x.device}")
    _check(const, offsets, wrap, grid_c, strips, x)
    n, ndiag = x.shape[0], len(offsets)
    y = torch.empty_like(x)
    if n == 0:
        return y
    fn = _entry(x.dtype)
    offs = (ctypes.c_longlong * max(ndiag, 1))(*[int(o) for o in offsets])
    cs = (ctypes.c_double * max(ndiag, 1))(*[float(c) for c in const])
    ptrs = [s.data_ptr() for s in strips] if grid_c else [None] * 4
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), y.data_ptr(), n, ndiag, offs, cs, int(bool(wrap)),
             int(grid_c), *ptrs, x.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"stencil_spmv kernel launch failed: cudaError {err}")
    stencil_spmv_cuda.launches += 1
    return y


stencil_spmv_cuda.launches = 0  # kernel launches; reset it to count a run


def stencil_spmv(const: Sequence[float], offsets: Sequence[int], wrap: bool,
                 grid_c: int, strips: Strips, x: torch.Tensor) -> torch.Tensor:
    """The wrapper: CUDA tensors go through the kernel, CPU tensors through
    the plain version."""
    if x.device.type == "cuda":
        return stencil_spmv_cuda(const, offsets, wrap, grid_c, strips, x)
    if x.device.type == "cpu":
        return stencil_spmv_torch(const, offsets, wrap, grid_c, strips, x)
    raise ValueError(f"no stencil SpMV for device {x.device}")
