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
``strips``), told apart by its ``const`` field.  The kernels
(``csrc/poly_apply.cu``) replace the JAX package's
``ops/pallas_poly.py::cheb_apply_fused`` and ``::neumann_apply_fused``; the
source says what bounds them and how they are laid out: one cooperative
launch per apply, with grid-wide barriers between the p sweeps.  The
recurrence vectors are scratch that the wrapper allocates.

The wrappers take the plain version for CPU tensors only.  A CUDA tensor is
launched through the kernel, or the wrapper raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .dia_spmv import dia_spmv_torch
from .stencil_spmv import stencil_spmv_torch

MAX_DIAGS = 64  # POLY_MAX_DIAGS in csrc/poly_apply.cu
MAX_DEGREE = 64  # POLY_MAX_DEGREE


def _is_stencil(A) -> bool:
    return hasattr(A, "const")


def _matvec_torch(A, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` through the plain twin of A's SpMV kernel."""
    if _is_stencil(A):
        return stencil_spmv_torch(A.const, A.offsets, A.wrap, A.grid_c,
                                  A.strips, x)
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
    first: the JAX package's unfused ``Neumann.__call__``, line for line."""
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


def _operands(A):
    """The tensors of A that the kernel reads."""
    if _is_stencil(A):
        return tuple(A.strips) if A.grid_c else ()
    return (A.data,)


def _check(A, degree: int, v: torch.Tensor, dinv=None) -> None:
    if v.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"polynomial kernels take f64 or f32; got v {v.dtype}")
    if v.dim() != 1 or not v.is_contiguous():
        raise ValueError(f"v must be a contiguous vector, got {tuple(v.shape)}")
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


@functools.lru_cache(maxsize=None)
def _entry(kind: str, dtype: torch.dtype):
    """The C entry point ``<kind>_apply_<f64|f32>``, built and loaded on
    first use."""
    from .build import load

    lib = load("poly_apply.cu")
    tag = "f64" if dtype == torch.float64 else "f32"
    fn = getattr(lib, f"{kind}_apply_{tag}")
    if kind == "cheb":
        rest = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_double, ctypes.c_double,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double)]
    else:
        rest = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_double]
    fn.argtypes = _OP_ARGTYPES + rest + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _doubles(values):
    return (ctypes.c_double * max(len(values), 1))(*[float(x) for x in values])


def _op_args(A, n: int) -> list:
    offs = (ctypes.c_longlong * max(len(A.offsets), 1))(
        *[int(o) for o in A.offsets])
    head = [n, len(A.offsets), offs, int(bool(A.wrap))]
    if not _is_stencil(A):
        return head + [A.data.data_ptr(), None, 0, None, None, None, None]
    strips = [s.data_ptr() for s in A.strips] if A.grid_c else [None] * 4
    return head + [None, _doubles(A.const), int(A.grid_c), *strips]


def cheb_apply_cuda(A, degree: int, theta: float, delta: float, sigma: float,
                    v: torch.Tensor) -> torch.Tensor:
    """Launch kernel #3 on PyTorch's current stream; does not synchronise."""
    if v.device.type != "cuda":
        raise ValueError(f"cheb_apply_cuda needs CUDA tensors, got {v.device}")
    _check(A, degree, v)
    n = v.shape[0]
    y = torch.empty_like(v)
    # x, r and two buffers of d
    scratch = (torch.empty(4 * n, dtype=v.dtype, device=v.device)
               if degree > 1 else None)
    c0, a, b = cheb_coefficients(degree, delta, sigma)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    err = _entry("cheb", v.dtype)(
        *_op_args(A, n), v.data_ptr(), y.data_ptr(),
        None if scratch is None else scratch.data_ptr(), degree, float(theta), c0,
        _doubles(a), _doubles(b), v.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"cheb_apply kernel launch failed: cudaError {err}")
    cheb_apply_cuda.launches += 1
    return y


cheb_apply_cuda.launches = 0  # kernel launches; reset it to count a run


def neumann_apply_cuda(A, dinv: torch.Tensor, degree: int, omega: float,
                       v: torch.Tensor) -> torch.Tensor:
    """Launch kernel #4 on PyTorch's current stream; does not synchronise."""
    if v.device.type != "cuda":
        raise ValueError(f"neumann_apply_cuda needs CUDA tensors, got {v.device}")
    _check(A, degree, v, dinv)
    n = v.shape[0]
    y = torch.empty_like(v)
    # acc and two buffers of z
    scratch = (torch.empty(3 * n, dtype=v.dtype, device=v.device)
               if degree > 2 else None)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    err = _entry("neumann", v.dtype)(
        *_op_args(A, n), v.data_ptr(), dinv.data_ptr(), y.data_ptr(),
        None if scratch is None else scratch.data_ptr(), degree, float(omega),
        v.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"neumann_apply kernel launch failed: cudaError {err}")
    neumann_apply_cuda.launches += 1
    return y


neumann_apply_cuda.launches = 0  # kernel launches; reset it to count a run


def cheb_apply(A, degree: int, theta: float, delta: float, sigma: float,
               v: torch.Tensor) -> torch.Tensor:
    """The wrapper: CUDA tensors go through kernel #3, CPU tensors through
    the plain version."""
    if v.device.type == "cuda":
        return cheb_apply_cuda(A, degree, theta, delta, sigma, v)
    if v.device.type == "cpu":
        _check(A, degree, v)
        return cheb_apply_torch(A, degree, theta, delta, sigma, v)
    raise ValueError(f"no Chebyshev apply for device {v.device}")


def neumann_apply(A, dinv: torch.Tensor, degree: int, omega: float,
                  v: torch.Tensor) -> torch.Tensor:
    """The wrapper: CUDA tensors go through kernel #4, CPU tensors through
    the plain version."""
    if v.device.type == "cuda":
        return neumann_apply_cuda(A, dinv, degree, omega, v)
    if v.device.type == "cpu":
        _check(A, degree, v, dinv)
        return neumann_apply_torch(A, dinv, degree, omega, v)
    raise ValueError(f"no Neumann apply for device {v.device}")
