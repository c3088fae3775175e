"""DIA SpMV: the hand-written Hopper kernel, its plain PyTorch twin, and the
wrapper that picks between them by the device of the tensors.

``y[i] = sum_d data[d, i] * x[i + offsets[d]]``, with the column taken mod n
when ``wrap`` is true and treated as a structural zero outside ``[0, n)``
otherwise.  The kernel (``csrc/dia_spmv.cu``) replaces the JAX package's
``ops/pallas_spmv.py::dia_spmv_pallas``; its source says what bounds it and
how it is laid out.

The wrapper takes the plain version for CPU tensors only.  A CUDA tensor is
launched through the kernel, or the wrapper raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

MAX_DIAGS = 64  # DIA_MAX_DIAGS in csrc/dia_spmv.cu; from_scipy caps ndiag here


def shift(x: torch.Tensor, off: int, wrap: bool) -> torch.Tensor:
    """Row-aligned read of x at an offset: out[i] = x[i + off] (0 out of
    range unless wrapping).  Works along dim 0 of a vector or a matrix."""
    if off == 0:
        return x
    rolled = torch.roll(x, -off, dims=0)
    if wrap:
        return rolled
    n = x.shape[0]
    idx = torch.arange(n, device=x.device) + off
    valid = (idx >= 0) & (idx < n)
    if x.dim() > 1:
        valid = valid[:, None]
    return torch.where(valid, rolled, torch.zeros((), dtype=x.dtype, device=x.device))


def dia_spmv_torch(data: torch.Tensor, offsets: Sequence[int], wrap: bool,
                   x: torch.Tensor) -> torch.Tensor:
    """The plain version: one shifted copy of x per diagonal, summed in
    diagonal order (as ``ops/sparse.py::dia_spmv`` of the JAX package)."""
    dtype = torch.promote_types(data.dtype, x.dtype)
    y = torch.zeros(data.shape[1], dtype=dtype, device=x.device)
    for d, off in enumerate(offsets):
        y = y + data[d] * shift(x, int(off), wrap)
    return y


def _check(data: torch.Tensor, offsets: Sequence[int], x: torch.Tensor) -> None:
    if data.device != x.device:
        raise ValueError(f"data on {data.device} but x on {x.device}")
    if x.dtype not in (torch.float64, torch.float32) or data.dtype != x.dtype:
        raise TypeError(
            f"DIA kernel takes f64 or f32 with data and x alike; got data "
            f"{data.dtype}, x {x.dtype}"
        )
    if data.dim() != 2 or x.dim() != 1 or data.shape[1] != x.shape[0]:
        raise ValueError(
            f"shapes: data {tuple(data.shape)} must be (ndiag, n) and x "
            f"{tuple(x.shape)} must be (n,)"
        )
    if data.shape[0] != len(offsets) or len(offsets) > MAX_DIAGS:
        raise ValueError(
            f"{len(offsets)} offsets for {data.shape[0]} diagonals "
            f"(at most {MAX_DIAGS})"
        )
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("DIA kernel needs contiguous data and x")
    n = x.shape[0]
    if any(abs(int(o)) >= n for o in offsets):
        raise ValueError(f"offsets {tuple(offsets)} must lie in (-{n}, {n})")


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    """The C entry point for ``dtype``, built and loaded on first use."""
    from .build import load

    lib = load("dia_spmv.cu")
    fn = lib.dia_spmv_f64 if dtype == torch.float64 else lib.dia_spmv_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dia_spmv_cuda(data: torch.Tensor, offsets: Sequence[int], wrap: bool,
                  x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on PyTorch's current stream; does not synchronise."""
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmv_cuda needs CUDA tensors, got {x.device}")
    _check(data, offsets, x)
    n = x.shape[0]
    y = torch.empty_like(x)
    if n == 0:
        return y
    fn = _entry(x.dtype)
    offs = (ctypes.c_longlong * max(len(offsets), 1))(*[int(o) for o in offsets])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(data.data_ptr(), x.data_ptr(), y.data_ptr(), n, len(offsets),
             offs, int(bool(wrap)), x.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"dia_spmv kernel launch failed: cudaError {err}")
    dia_spmv_cuda.launches += 1
    return y


dia_spmv_cuda.launches = 0  # kernel launches; reset it to count a run


def dia_spmv(data: torch.Tensor, offsets: Sequence[int], wrap: bool,
             x: torch.Tensor) -> torch.Tensor:
    """The wrapper: CUDA tensors go through the kernel, CPU tensors through
    the plain version."""
    if data.device != x.device:
        raise ValueError(f"data on {data.device} but x on {x.device}")
    if x.device.type == "cuda":
        return dia_spmv_cuda(data, offsets, wrap, x)
    if x.device.type == "cpu":
        return dia_spmv_torch(data, offsets, wrap, x)
    raise ValueError(f"no DIA SpMV for device {x.device}")
