"""General (callable) constraints: invariants not written as an explicit
quadratic form.

The port of the JAX package's ``constraints/general.py`` (reference
lkdvRK/LinearSolver.py:29-79, the dict-form ``{'func': ..., 'jac': ...}``
callables over Krylov coefficients).  The user supplies one scalar function
``g(x)`` of the full-space vector, written in torch operations; its
reduction onto the Krylov coefficients, its gradient and its Hessian come
from ``torch.func``.  The solver handles each general constraint as a
quadratic Taylor model about the warm coefficients, built afresh every
constrained iteration (exact where g is quadratic, as every invariant of
the reference is), and its safety latch checks the true g at the accepted
iterate.  The host loop reads the model into host buffers
(``taylor_buffers``); the device core writes it into its own buffers inside
a step's graph (``taylor_model``), as the JAX core builds it inside its
loop.

A DIA product ``A @ x`` inside g is differentiable: on the card its value
is the DIA kernel's and its derivatives are products with A and Aᵀ
(``ops/sparse.py::_DiaProduct``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..config import HOST
from .quadratic import ReducedBuffers


@dataclasses.dataclass(frozen=True)
class GeneralConstraint:
    """g(x) = 0, ``func`` a scalar function of the full-space vector x."""

    func: Callable
    name: str = "general"

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.func(x)


def taylor_model(con: GeneralConstraint, y0: torch.Tensor, Z: torch.Tensor,
                 x0: torch.Tensor, cdtype: torch.dtype = None):
    """The quadratic model of the reduced constraint about y0,
    g̃(y) ≈ t0 + t1·y + yᵀ T2 y, as tensors on the solve's device: t0
    (0-dim), t1 (k,) and T2 (k, k), from y0 (k,), the basis ``Z`` (k, n)
    and ``x0`` (n,).  No host read and no host copy: the device core runs
    it inside its ``kkt_start`` graph, where the value's ``A @ x`` is
    kernel #1 and the Hessian's vmapped products one launch of #1b at width
    k (``ops/sparse.py::_DiaProduct``).

    g, its gradient and its Hessian are taken in the storage dtype (over
    f32 storage, through the f32 kernels) and the model is formed in
    ``cdtype`` (the solver's k-sized dtype, f64 over f32 storage; None:
    the storage's), as the JAX package's mixed core builds its kinds
    ``"g"`` (``constraints/general.py:45-66`` there)."""
    cd = cdtype or Z.dtype

    def reduced(y):
        return con.func(x0 + y @ Z)

    y0s = y0.to(Z.dtype)
    val = reduced(y0s).to(cd)
    grad = torch.func.grad(reduced)(y0s).to(cd)
    hess = torch.func.hessian(reduced)(y0s).to(cd)
    y0 = y0.to(cd)
    hy = hess @ y0
    t0 = val - torch.dot(grad, y0) + 0.5 * torch.dot(y0, hy)
    return t0, grad - hy, 0.5 * hess


def taylor_buffers(con: GeneralConstraint, y0: torch.Tensor, Z: torch.Tensor,
                   x0: torch.Tensor, cdtype: torch.dtype = None
                   ) -> ReducedBuffers:
    """``taylor_model`` for the host loop: ``y0`` (k,) lies on the host,
    the basis ``Z`` (k, n) and ``x0`` on the solve's device; the buffers
    land on the host in ``cdtype``, read in one copy."""
    k = y0.shape[0]
    t0, t1, T2 = taylor_model(con, y0.to(Z.device), Z, x0, cdtype)
    host = torch.cat([t0.reshape(1), t1, T2.reshape(-1)]).to(HOST)
    return ReducedBuffers(t0=host[0], t1=host[1:k + 1],
                          T2=host[k + 1:].reshape(k, k))


def true_value(con: GeneralConstraint, y: torch.Tensor, Z: torch.Tensor,
               x0: torch.Tensor) -> torch.Tensor:
    """g at the iterate of the coefficients y (on the host)."""
    return con.func(x0 + y.to(Z.device, Z.dtype) @ Z)
