"""Quadratic invariant constraints and their reduction onto Krylov coefficients.

A structure constraint is ``g(x) = ½ xᵀ M x + vᵀ x + c = 0`` (mass is the
linear special case M = 0).  The reference compiles such a constraint onto
the Krylov coefficient space by forming ``M @ Z`` from scratch at every
constrained iteration (reference ``solvers.py:21-53``).  As in the JAX
package, the reduction here is incremental: each Arnoldi step appends one
vector ``z_j``, so the reduced data gains

* ``t1[j]  = v·z_j + (M z_j)·x0``            — one SpMV + two dots
* ``T2[:,j] = T2[j,:] = ½ Z (M z_j)``        — one tall matvec

and the reduced constraint is the tiny dense form
``g(y) = t0 + t1·y + yᵀ T2 y`` with Jacobian ``t1 + 2 T2 y`` (M symmetric).
Entering the constrained endgame mid-flight catches up with one SpMM over
the existing basis.

``M`` may be a sparse or dense matrix, a linear combination of matrices
(``MatComb``), or a stage-mapped operator (``StageKron``): the Runge–Kutta
reconstruction ``z1 = z0 + dt Σ b_s X_s`` composed into a quadratic on the
stacked stage vector (``stage_mapped``; reference lkdvRK/lkdvRK.py:162-189,
lkdvRK/LinearSolver.py:29-76).

The n-sized work runs where the basis lives.  For the host loop the reduced
buffers (a scalar, a k-vector and a k×k matrix) live on the host, beside the
Hessenberg matrix and the KKT solve that consume them; for the device core
(``solvers/cgmres.py::DeviceCore``) they live on the basis' device and are
updated in place under a mask (``fold_column``, ``catch_up``), as the JAX
package keeps them.

With f32 storage (the JAX package's TPU mode) the buffers are f64 (the
solver's ``cdtype``) and the n-sized work runs in one of two arithmetics,
the JAX package's reduction modes: the f64 reduction (``f64=True``: f32
loads, f64 products and sums, ``ops/sparse.py::matvec_f64``, where the JAX
package computes in double-f32 pairs) or the snap-first plain f32 one
(``f64=False``), whose small results are cast to f64.  ``value_f64`` is
the f64 value of g at an f32 point: the certificate (the JAX package's
``dd_constraint_value``).  With f64 storage both modes are the plain f64
reduction.

On row-sharded data (``parallel/mesh.py::shard_constraint``) a constraint
carries the mesh, and each of its n-length reductions is all-reduced over
it (``parallel/comm.py::psum``), the products of one fold or catch-up in
one all-reduce; without a mesh the reductions are the unsharded ones, bit
for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch

from ..config import HOST
from ..ops.sparse import f64_supported, matvec_f64
from ..ops.rows import basis_mv as rows_mv, dot as rows_dot, rows
from ..parallel.comm import pdot, psum


@dataclasses.dataclass(frozen=True)
class MatComb:
    """Linear combination  Σ coeff_i · A_i  as a matrix-free operator."""

    coeffs: Tuple[float, ...]
    mats: Tuple[Any, ...]

    def __matmul__(self, x):
        out = self.coeffs[0] * (self.mats[0] @ x)
        for c, A in zip(self.coeffs[1:], self.mats[1:]):
            out = out + c * (A @ x)
        return out

    def matvec_f64(self, x):
        """The product in f64 from f32 storage, a term at a time
        (``ops/sparse.py::matvec_f64``)."""
        out = None
        for c, A in zip(self.coeffs, self.mats):
            term = float(c) * matvec_f64(A, x)
            out = term if out is None else out + term
        return out

    def f64_supported(self) -> bool:
        return all(f64_supported(A) for A in self.mats)

    def todense(self):
        out = self.coeffs[0] * self.mats[0].todense()
        for c, A in zip(self.coeffs[1:], self.mats[1:]):
            out = out + c * A.todense()
        return out


@dataclasses.dataclass(frozen=True)
class StageKron:
    """Pᵀ M P, where P maps a stacked stage vector X (ns·n0,) to
    ``dt Σ_s b_s X_s`` (n0,): the linear part of the RK reconstruction
    z1 = z0 + dt Σ b_s X_s (reference lkdvRK/lkdvRK.py:162-174).  A product
    takes one inner-space product whatever the stage count, for a vector and
    for a tall (ns·n0, m) block alike."""

    inner: Any  # operator on the n0 space
    b: torch.Tensor  # (ns,) RK weights
    dt: float
    ns: int

    @property
    def shape(self):
        n = self.ns * self.inner.shape[0]
        return (n, n)

    def __matmul__(self, X):
        Xs = X.reshape(self.ns, -1, *X.shape[1:])
        PX = self.dt * torch.tensordot(self.b, Xs, dims=1)
        MPX = self.inner @ PX
        bw = self.b.reshape(-1, *([1] * MPX.dim()))
        return (self.dt * bw * MPX[None]).reshape(X.shape)

    def matvec_f64(self, X):
        """The product in f64 from f32 storage: P, the inner product and Pᵀ
        each in f64 (``ops/sparse.py::matvec_f64``), the map's weights the
        f64 product of the stored b and dt.  (The JAX package's
        ``_dd_matvec`` rounds b·dt to f32 first, 1.5e-8 off relative: an
        offset of the quadratic term that at lkdvRK M=400 is above the
        projection's certificate floor.)  The inner operator takes the f64
        vector P x (an f32 DIA on its kept upcast operator,
        ``DIA.upcast``)."""
        bd = self.b.double() * self.dt
        Xs = X.double().reshape(self.ns, -1, *X.shape[1:])
        w = matvec_f64(self.inner, torch.tensordot(bd, Xs, dims=1))
        return (bd.reshape(-1, *([1] * w.dim())) * w[None]).reshape(X.shape)

    def f64_supported(self) -> bool:
        return f64_supported(self.inner)

    def todense(self):
        # (PᵀMP)[(s,i),(t,j)] = dt² b_s b_t M[i,j] (stage-major stacking)
        Md = self.inner.todense()
        bb = torch.outer(self.b, self.b) * self.dt**2
        return torch.kron(bb.to(Md.dtype), Md)


@dataclasses.dataclass(frozen=True)
class QuadraticConstraint:
    """g(x) = ½ xᵀ M x + vᵀ x + c.  ``M``/``v`` may be None (zero); ``c`` is
    a 0-dim tensor on the device of x.  ``mesh``: the mesh of row-sharded
    M, v and x, over which the inner products are all-reduced (None:
    unsharded)."""

    M: Optional[Any]
    v: Optional[torch.Tensor]
    c: torch.Tensor
    name: str = "constraint"
    mesh: Any = dataclasses.field(default=None, compare=False)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        out = self.c.to(x.dtype)
        if self.v is not None:
            out = out + pdot(self.v, x, self.mesh)
        if self.M is not None:
            out = out + 0.5 * pdot(x, self.M @ x, self.mesh)
        return out

    def value_and_scale(self, x: torch.Tensor):
        """g(x) and its roundoff scale, the sum of the magnitudes of its
        three terms: near a point where g vanishes the value is a
        cancellation and cannot be certified below O(eps)·scale."""
        terms = []
        if self.v is not None:
            terms.append(torch.dot(self.v, x))
        if self.M is not None:
            terms.append(0.5 * torch.dot(x, self.M @ x))
        terms = torch.stack([self.c.to(x.dtype),
                             *(psum(torch.stack(terms), self.mesh)
                               if terms else ())])
        return terms.sum(), terms.abs().sum()

    def grad(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros_like(x)
        if self.v is not None:
            out = out + self.v
        if self.M is not None:
            out = out + self.M @ x  # symmetric M
        return out


def stage_mapped(inner: QuadraticConstraint, b: torch.Tensor, dt: float,
                 ns: int, z0: torch.Tensor) -> QuadraticConstraint:
    """A quadratic constraint on z1-space composed with the affine RK map
    ``z1 = z0 + P X``: the equivalent quadratic on stage space, in place of
    the reference's dict-form constraints that re-evaluate ``z1calc`` in
    every SLSQP call (lkdvRK/LinearSolver.py:29-76)."""
    Mz0 = inner.M @ z0 if inner.M is not None else torch.zeros_like(z0)
    v_in = inner.v if inner.v is not None else torch.zeros_like(z0)
    Pt_w = (dt * torch.outer(b, Mz0 + v_in)).reshape(-1)
    # g(z0): in f64 from an f32 z0 (``target_dot``), so that X = 0 meets
    # the inner constraint's f64 target
    c = (inner.c + target_dot(v_in, z0, inner.mesh)
         + 0.5 * target_quad(inner.M, z0, inner.mesh, Mz=Mz0))
    M = (StageKron(inner.M, b, float(dt), int(ns))
         if inner.M is not None else None)
    return QuadraticConstraint(M=M, v=Pt_w, c=c, name=inner.name,
                               mesh=inner.mesh)


class ReducedBuffers(NamedTuple):
    """Per-constraint reduced data over the Krylov coefficient space, on the
    host."""

    t0: torch.Tensor  # 0-dim
    t1: torch.Tensor  # (k,)
    T2: torch.Tensor  # (k, k)


def _arith(f64: bool):
    """A reduction's upcast and product with M: in f64 from f32 storage
    (``matvec_f64``), else in the storage dtype."""
    if f64:
        return (lambda t: t.double()), matvec_f64
    return (lambda t: t), (lambda M, z: M @ z)


def value_and_scale_f64(con: QuadraticConstraint, x: torch.Tensor):
    """``value_and_scale`` in f64 from f32 storage: each term from f32 loads
    with f64 products and sums (``matvec_f64``), the terms summed in f64.
    With f64 storage it is ``value_and_scale``."""
    terms = []
    if con.v is not None:
        terms.append(torch.dot(con.v.double(), x.double()))
    if con.M is not None:
        terms.append(0.5 * torch.dot(x.double(), matvec_f64(con.M, x)))
    terms = torch.stack([con.c.double(),
                         *(psum(torch.stack(terms), con.mesh)
                           if terms else ())])
    return terms.sum(), terms.abs().sum()


def target_dot(a: torch.Tensor, z: torch.Tensor, mesh=None) -> torch.Tensor:
    """``a·z`` for an invariant target taken from the state z: from f32
    storage the f64 sum of the upcast vectors, as ``value_f64`` evaluates
    a linear term, so that the next step's warm start z meets its own
    target to f64 roundoff; from f64 storage ``pdot``, bit for bit."""
    if z.dtype == torch.float32:
        return pdot(a.double(), z.double(), mesh)
    return pdot(a, z, mesh)


def target_quad(M, z: torch.Tensor, mesh=None,
                Mz: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``z·(M z)`` for an invariant target taken from the state z: from f32
    storage in f64 (``matvec_f64``, an f64 sum), as ``value_f64``
    evaluates a quadratic term (zero for M None); from f64 storage
    ``pdot(z, Mz)``, with ``Mz`` the product where the caller has it."""
    if z.dtype == torch.float32:
        if M is None:
            return torch.zeros((), dtype=torch.float64, device=z.device)
        return pdot(z.double(), matvec_f64(M, z), mesh)
    return pdot(z, M @ z if Mz is None else Mz, mesh)


def value_f64(con: QuadraticConstraint, x: torch.Tensor) -> torch.Tensor:
    """g(x) in f64 at an f32 (or f64) x: the certified value, the
    counterpart of the JAX package's ``dd_constraint_value``
    (``quadratic.py:467-483`` there).  The constraint is the stored one:
    its f32 c, v and M."""
    return value_and_scale_f64(con, x)[0]


def init_buffers(con: QuadraticConstraint, x0: torch.Tensor, k: int,
                 x0_zero: bool = False, cdtype=None,
                 f64_value: bool = False) -> ReducedBuffers:
    """``x0_zero`` skips the g(x0) evaluation: t0 = c exactly.  ``cdtype``:
    the buffers' dtype (x0's by default); ``f64_value`` evaluates g(x0) in
    f64 from f32 x0 (``value_f64``; the JAX package's ``dd_value``)."""
    if x0_zero:
        t0 = con.c
    elif f64_value:
        t0 = value_f64(con, x0)
    else:
        t0 = con(x0)
    cd = cdtype or x0.dtype
    return ReducedBuffers(
        t0=t0.to(HOST, cd), t1=torch.zeros(k, dtype=cd),
        T2=torch.zeros((k, k), dtype=cd),
    )


def value_scale(con: QuadraticConstraint, x0: torch.Tensor,
                x0_zero: bool = False, cdtype=None,
                f64_value: bool = False) -> torch.Tensor:
    """The roundoff scale of t0 = g(x0) on the host, the sum of its terms'
    magnitudes (``value_and_scale``; in f64 with ``f64_value``): from a warm
    start t0 is a cancellation (swe's mass, 9e3, to 0.0), and |t0| would put
    the floor below the roundoff of every evaluation of g; from x0 = 0 it is
    |c|."""
    if x0_zero:
        s0 = con.c.abs()
    elif f64_value:
        s0 = value_and_scale_f64(con, x0)[1]
    else:
        s0 = con.value_and_scale(x0)[1]
    return s0.to(HOST, cdtype or x0.dtype)


def update_buffers(con: QuadraticConstraint, buf: ReducedBuffers,
                   Z: torch.Tensor, x0: torch.Tensor, j: int,
                   x0_zero: bool = False, f64: bool = False) -> ReducedBuffers:
    """Fold the new basis vector Z[j] into the reduced constraint.  Rows of Z
    beyond j are zero, so only the prefix Z[:j+1] is read.  ``f64``: the f64
    reduction from f32 storage (the JAX package's ``dd_reduce``); else the
    storage dtype's, cast to the buffers' (``f32_reduce`` there)."""
    up, mv = _arith(f64)
    zj = Z[j]
    t1j = torch.zeros((), dtype=up(zj).dtype, device=Z.device)
    if con.v is not None:
        t1j = t1j + torch.dot(up(con.v), up(zj))
    w = None
    if con.M is not None:
        u = mv(con.M, zj)
        if not x0_zero:
            t1j = t1j + torch.dot(u, up(x0))
        w = 0.5 * (up(Z[: j + 1]) @ u)
    # one all-reduce (under a mesh) and one device→host copy for the scalar
    # and the new column
    host = psum(torch.cat([t1j.reshape(1)] + ([w] if w is not None else [])),
                con.mesh).to(HOST)
    t1 = buf.t1.clone()
    t1[j] = host[0]
    T2 = buf.T2
    if w is not None:
        T2 = T2.clone()
        T2[j, : j + 1] = host[1:]
        T2[: j + 1, j] = host[1:]
    return ReducedBuffers(t0=buf.t0, t1=t1, T2=T2)


def catchup_buffers(con: QuadraticConstraint, buf: ReducedBuffers,
                    Z: torch.Tensor, x0: torch.Tensor, jmax: int,
                    x0_zero: bool = False, f64: bool = False) -> ReducedBuffers:
    """Recompute the full reduction over the first ``jmax`` basis vectors in
    one batched pass (phase-entry catch-up): one SpMM and one (j, n)·(n, j)
    matmul.  Rows of Z from ``jmax`` on are zero, so they reduce to zero.
    ``f64`` as in ``update_buffers`` (its product with M a column at a
    time, ``matvec_f64``: once a solve)."""
    k = buf.t1.shape[0]
    dt = buf.t1.dtype
    t1 = torch.zeros(k, dtype=dt)
    T2 = torch.zeros((k, k), dtype=dt)
    if jmax == 0:
        return ReducedBuffers(t0=buf.t0, t1=t1, T2=T2)
    up, mv = _arith(f64)
    Zc = up(Z[:jmax])
    t1_dev = torch.zeros(jmax, dtype=Zc.dtype, device=Z.device)
    if con.v is not None:
        t1_dev = t1_dev + Zc @ up(con.v)
    parts = [t1_dev[:, None]]
    if con.M is not None:
        U = mv(con.M, Z[:jmax].T)  # (n, jmax)
        if not x0_zero:
            t1_dev = t1_dev + U.T @ up(x0)
        parts = [t1_dev[:, None], 0.5 * (Zc @ U)]
    # one all-reduce under a mesh: t1 beside T2's columns
    red = psum(torch.cat(parts, dim=1), con.mesh).to(HOST)
    t1[:jmax] = red[:, 0]
    if con.M is not None:
        T2[:jmax, :jmax] = red[:, 1:]
    return ReducedBuffers(t0=buf.t0, t1=t1, T2=T2)


# --- the device core's buffers: on the basis' device, written in place ----
#
# For a batch of B solves that share the operators M (the device core's batch
# axis): every buffer has a leading axis of B, and so have each constraint's
# v (B, n) and c (B,); ``live`` (B,) masks the writes per solve.


def device_buffers(k: int, like: torch.Tensor, batch: int = 1,
                   dtype=None) -> ReducedBuffers:
    """Zeroed reduced buffers of ``batch`` solves on the device of ``like``,
    in ``dtype`` (like's by default): t0 (B,), t1 (B, k), T2 (B, k, k)."""
    def z(*shape):
        return torch.zeros((batch, *shape), dtype=dtype or like.dtype,
                           device=like.device)

    return ReducedBuffers(t0=z(), t1=z(k), T2=z(k, k))


def value_and_scale_rows(con: QuadraticConstraint, X: torch.Tensor,
                         f64: bool = False):
    """``value_and_scale`` at each row of X (B, n), for a constraint whose
    v (B, n) and c (B,) are per row: the values and scales, (B,) each; in
    f64 from f32 storage with ``f64`` (``value_and_scale_f64``)."""
    up, mv = _arith(f64)
    terms = []
    if con.v is not None:
        terms.append(rows_dot(up(con.v), up(X)))
    if con.M is not None:
        terms.append(0.5 * rows_dot(up(X), rows(lambda z: mv(con.M, z), X)))
    terms = torch.stack([up(con.c).to(up(X).dtype),
                         *(psum(torch.stack(terms), con.mesh)
                           if terms else ())], dim=-1)
    return terms.sum(-1), terms.abs().sum(-1)


def fold_column(con: QuadraticConstraint, buf: ReducedBuffers,
                Z: torch.Tensor, x0: torch.Tensor, j: int, live: torch.Tensor,
                x0_zero: bool = False, f64: bool = False) -> None:
    """``update_buffers`` in place on the device, where ``live``: the new
    basis vectors Z[:, j] (of Z (B, k, n)) folded into t1[:, j] and row and
    column j of T2; one product with M for the batch (``f64``: the f64
    reduction from f32 storage, a vector at a time)."""
    up, mv = _arith(f64)
    zj = Z[:, j]
    t1j = torch.zeros(Z.shape[0], dtype=up(zj).dtype, device=Z.device)
    if con.v is not None:
        t1j = t1j + rows_dot(up(con.v), up(zj))
    if con.M is None:
        t1j = psum(t1j, con.mesh)
    else:
        u = rows(lambda z: mv(con.M, z), zj)
        if not x0_zero:
            t1j = t1j + rows_dot(u, up(x0))
        w = 0.5 * rows_mv(up(Z[:, : j + 1]), u)
        if con.mesh is not None:
            # one all-reduce: t1[:, j] beside the new column
            red = psum(torch.cat([t1j[:, None], w], dim=1), con.mesh)
            t1j, w = red[:, 0], red[:, 1:]
        lv = live[:, None]
        buf.T2[:, j, : j + 1] = torch.where(lv, w, buf.T2[:, j, : j + 1])
        buf.T2[:, : j + 1, j] = torch.where(lv, w, buf.T2[:, : j + 1, j])
    buf.t1[:, j] = torch.where(live, t1j, buf.t1[:, j])


def catch_up(con: QuadraticConstraint, buf: ReducedBuffers, Z: torch.Tensor,
             x0: torch.Tensor, jmax: int, live: torch.Tensor,
             x0_zero: bool = False, f64: bool = False) -> None:
    """``catchup_buffers`` in place on the device, where ``live``: the
    reduction over the first ``jmax`` basis vectors of each solve in one
    batched pass, one product with M for a solve's ``jmax`` vectors (the
    (n, jmax) view of its basis rows).  Only the leading ``jmax`` entries
    are written; the endgame reads no further than the columns folded in
    since.  ``f64`` as in ``fold_column``."""
    up, mv = _arith(f64)
    for b in range(Z.shape[0]):
        Zc = up(Z[b, :jmax])
        t1 = torch.zeros(jmax, dtype=Zc.dtype, device=Z.device)
        if con.v is not None:
            t1 = t1 + Zc @ up(con.v[b])
        if con.M is None:
            t1 = psum(t1, con.mesh)
        else:
            U = mv(con.M, Z[b, :jmax].T)  # (n, jmax)
            if not x0_zero:
                t1 = t1 + U.T @ up(x0[b])
            T2 = 0.5 * (Zc @ U)
            if con.mesh is not None:
                # one all-reduce: t1 beside T2's columns
                red = psum(torch.cat([t1[:, None], T2], dim=1), con.mesh)
                t1, T2 = red[:, 0], red[:, 1:]
            buf.T2[b, :jmax, :jmax] = torch.where(live[b], T2,
                                                  buf.T2[b, :jmax, :jmax])
        buf.t1[b, :jmax] = torch.where(live[b], t1, buf.t1[b, :jmax])


# The reduced forms below take y of shape (k,) or a batch (T, k).  T2 from a
# catch-up is symmetric only up to rounding, so T2 is applied as T2 @ y, as
# the JAX package does.


def reduced_value(buf: ReducedBuffers, y: torch.Tensor) -> torch.Tensor:
    T2y = y @ buf.T2.T
    return buf.t0 + y @ buf.t1 + (y * T2y).sum(-1)


def reduced_grad(buf: ReducedBuffers, y: torch.Tensor) -> torch.Tensor:
    return buf.t1 + 2.0 * (y @ buf.T2.T)


def reduced_hess(buf: ReducedBuffers) -> torch.Tensor:
    return 2.0 * buf.T2


def reduced_scale(buf: ReducedBuffers, y: torch.Tensor,
                  s0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Roundoff scale of the reduced constraint evaluation: the sum of the
    magnitudes of its summands.  |g(y)| cannot be certified below
    O(eps)·scale in finite precision — e.g. an O(1e4) energy invariant can
    only be enforced to ~1e-12 absolute in f64.  The safety latch uses this
    floor.  ``s0``, the scale of g(x0) (``value_scale``), stands for |t0|
    where given."""
    return (
        (torch.abs(buf.t0) if s0 is None else s0)
        + torch.sum(torch.abs(buf.t1 * y))
        + torch.sum(torch.abs(y[:, None] * buf.T2 * y[None, :]))
    )


def constraint_checker(x: torch.Tensor,
                       cons: Sequence[QuadraticConstraint]) -> torch.Tensor:
    """Maximum absolute constraint deviation at x.

    The reference's checker takes a signed max (reference solvers.py:14-18);
    the absolute value is strictly safer for the safety latch.
    """
    return torch.max(torch.stack([torch.abs(c(x)) for c in cons]))
