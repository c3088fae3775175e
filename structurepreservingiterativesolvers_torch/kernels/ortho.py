"""The middle pair of CGS2 in one read of the basis: the hand-written Hopper
kernel, its plain PyTorch twin, and the wrapper that picks between them by
the device of the tensors.

Given the active Krylov basis ``Q`` (m rows of length n), a vector ``w`` and
its first projection ``h = Q w``::

    w1 = w − hᵀQ,    u2 = Q w1

The kernel (``csrc/ortho_fused.cu``) replaces the JAX package's
``ops/pallas_ortho.py::fused_update_matvec``; its source says what bounds it
and how it is laid out.  The JAX package switches it on with the
environment variable ``SPIS_ORTHO_ENGINE=pallas`` (f32 only, a gate whose
size threshold ``MIN_N`` is never read); the port has no gate: the caller
asks for it explicitly (``ortho="cgs2_fused"`` in the solvers).

The wrapper takes the plain version for CPU tensors only.  A CUDA tensor is
launched through the kernel, or the wrapper raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import count_f32

MAX_ROWS = 128  # ORTHO_MAX_ROWS in csrc/ortho_fused.cu: a basis of k ≤ 127
# the largest grid of the kernel: the scratch of per-block partial sums of
# u2 is (MAX_BLOCKS, m); the kernel launches as many blocks as stay resident
# on the card at once (at most 8 per SM at 256 threads: 1,056 on an H100)
MAX_BLOCKS = 2048


def fused_update_matvec_torch(Q: torch.Tensor, w: torch.Tensor,
                              h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version, and the definition: ``w1 = w − h @ Q``, then
    ``u2 = Q @ w1`` (two reads of Q)."""
    w1 = w - h @ Q
    return w1, Q @ w1


def _check(Q: torch.Tensor, w: torch.Tensor, h: torch.Tensor) -> None:
    if not (Q.device == w.device == h.device):
        raise ValueError(
            f"Q on {Q.device}, w on {w.device}, h on {h.device}: one device")
    if Q.dtype not in (torch.float64, torch.float32) or not (
            Q.dtype == w.dtype == h.dtype):
        raise TypeError(
            f"the fused CGS2 kernel takes f64 or f32 with Q, w and h alike; "
            f"got {Q.dtype}, {w.dtype}, {h.dtype}")
    if Q.dim() != 2 or w.dim() != 1 or h.dim() != 1 \
            or Q.shape != (h.shape[0], w.shape[0]):
        raise ValueError(
            f"shapes: Q {tuple(Q.shape)} must be (m, n) with w "
            f"{tuple(w.shape)} (n,) and h {tuple(h.shape)} (m,)")
    if not 1 <= Q.shape[0] <= MAX_ROWS:
        raise ValueError(f"{Q.shape[0]} basis rows: the kernel takes 1 to "
                         f"{MAX_ROWS}")
    if not (Q.is_contiguous() and w.is_contiguous() and h.is_contiguous()):
        raise ValueError("the fused CGS2 kernel needs contiguous Q, w and h")


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    """The C entry point for ``dtype``, built and loaded on first use."""
    from .build import load

    lib = load("ortho_fused.cu")
    fn = (lib.fused_update_matvec_f64 if dtype == torch.float64
          else lib.fused_update_matvec_f32)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_update_matvec_cuda(Q: torch.Tensor, w: torch.Tensor,
                             h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel (and its fixed-order sum of the blocks' partials) on
    PyTorch's current stream; does not synchronise."""
    if Q.device.type != "cuda":
        raise ValueError(
            f"fused_update_matvec_cuda needs CUDA tensors, got {Q.device}")
    _check(Q, w, h)
    m, n = Q.shape
    w1 = torch.empty_like(w)
    u2 = torch.empty_like(h)
    partial = torch.empty(MAX_BLOCKS * m, dtype=Q.dtype, device=Q.device)
    stream = torch.cuda.current_stream(Q.device).cuda_stream
    # contiguous rows: the row stride is n
    err = _entry(Q.dtype)(Q.data_ptr(), n, w.data_ptr(),
                          h.data_ptr(), w1.data_ptr(), u2.data_ptr(),
                          partial.data_ptr(), MAX_BLOCKS, m, n,
                          Q.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_update_matvec kernel launch failed: cudaError {err}")
    fused_update_matvec_cuda.launches += 1
    count_f32("fused_update_matvec", Q.dtype)
    return w1, u2


fused_update_matvec_cuda.launches = 0  # kernel launches; reset it to count a run


def fused_update_matvec(Q: torch.Tensor, w: torch.Tensor,
                        h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wrapper: ``(w − hᵀQ, Q (w − hᵀQ))``.  CUDA tensors go through the
    kernel, CPU tensors through the plain version; both refuse what the
    kernel does not take."""
    if Q.device.type == "cuda":
        return fused_update_matvec_cuda(Q, w, h)
    _check(Q, w, h)
    if Q.device.type == "cpu":
        return fused_update_matvec_torch(Q, w, h)
    raise ValueError(f"no fused CGS2 update for device {Q.device}")
