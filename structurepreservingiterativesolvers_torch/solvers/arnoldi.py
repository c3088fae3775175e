"""Flexible Arnoldi building blocks shared by GMRES/CGMRES.

The port of the JAX package's ``solvers/arnoldi.py``.  The workspace is
allocated at the maximum iteration count ``k`` and updated in place.  The
iteration index is a host integer, so every n-sized operation reads only
the active prefix of the basis: rows beyond it are zero in the JAX package
and contribute nothing there either.

The host loop's state (``ArnoldiState``) lives on two devices:

* the n-sized basis ``Q`` and preconditioned vectors ``Z`` live with the
  operands (the card, in production);
* the k-sized Hessenberg matrix and its incremental Givens QR live on the
  host.  Every step reads the new Hessenberg column and the residual
  estimate on the host anyway, and a rotation is a handful of scalar
  operations: on the host they cost nanoseconds, on the card one launch
  each.

The device core's state (``DeviceArnoldi``, the JAX package's fixed-shape
``ArnoldiState``) lives on the operands' device whole, so that a step reads
nothing on the host and can be captured in a CUDA graph
(``solvers/graphs.py``).  It carries a batch of solves on a leading axis
(the JAX package's state under ``jax.vmap``); its steps write every entry
under a mask ``live`` per solve: a step taken after a solve is done changes
nothing of it.

Under a mesh (row-sharded A and vectors, ``parallel/``) the basis rows are
this rank's rows, and every n-length reduction (the projections, the norm)
is all-reduced over the operator's mesh (``parallel/comm.py::psum``); the
k-sized work runs the same on every rank.  Without a mesh the reductions
are the unsharded ones, bit for bit.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import torch

from ..config import HOST
from ..kernels.ortho import fused_update_matvec
from ..ops.rows import basis_mv as rows_mv, basis_rmv as rows_rmv, rows
from ..parallel.comm import mesh_of, pnorm, psum

# the orthogonalisations of ``arnoldi_step``; "cgs2_xla" is the JAX
# package's name of the plain form
ORTHO = ("cgs2", "cgs2_fused", "cgs2_xla", "mgs")


class ArnoldiState(NamedTuple):
    """Workspace for a k-step flexible Arnoldi factorisation.

    Q : (k+1, n) orthonormal Krylov basis (rows), on the operands' device.
    Z : (k,   n) preconditioned vectors; flexible GMRES reconstructs the
        iterate from Z, not Q (reference solvers.py:111-115).
    H : (k+1, k) Hessenberg matrix, on the host.
    R, Rinv, cs, sn, g : incremental Givens QR of H, on the host — R upper
        triangular with its explicit inverse, (cs, sn) the rotation pairs,
        g the rotated β·e1.  |g[j+1]| is the least-squares residual estimate.
    """

    Q: torch.Tensor
    Z: torch.Tensor
    H: torch.Tensor
    R: torch.Tensor
    Rinv: torch.Tensor
    cs: torch.Tensor
    sn: torch.Tensor
    g: torch.Tensor


def init_state(r0: torch.Tensor, beta: float, k: int) -> ArnoldiState:
    n = r0.shape[0]
    dt = r0.dtype
    Q = torch.zeros((k + 1, n), dtype=dt, device=r0.device)
    Q[0] = r0 / (1.0 if beta == 0 else beta)
    g = torch.zeros(k + 1, dtype=dt)
    g[0] = beta
    return ArnoldiState(
        Q=Q,
        Z=torch.zeros((k, n), dtype=dt, device=r0.device),
        H=torch.zeros((k + 1, k), dtype=dt),
        R=torch.zeros((k, k), dtype=dt),
        Rinv=torch.zeros((k, k), dtype=dt),
        cs=torch.zeros(k, dtype=dt),
        sn=torch.zeros(k, dtype=dt),
        g=g,
    )


def _mgs(Q: torch.Tensor, w: torch.Tensor, j: int,
         mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Modified Gram-Schmidt of w against rows Q[0..j]; returns (w⊥, h[:j+1]).
    Sequential; kept for strict reference parity (reference
    solvers.py:97-99).  Each projection is all-reduced over ``mesh``."""
    hs = []
    for i in range(j + 1):
        hij = psum(torch.dot(Q[i], w), mesh)
        w = w - hij * Q[i]
        hs.append(hij)
    return w, torch.stack(hs)


def _cgs2(Q: torch.Tensor, w: torch.Tensor, j: int,
          fused: bool = False, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Classical Gram-Schmidt with reorthogonalisation (CGS2) against rows
    Q[0..j]: two passes of two tall matvecs; returns (w⊥, h[:j+1]).

    With ``fused`` the middle pair (the first update and the second
    projection) runs as one read of the basis, ``kernels/ortho.py`` (the
    kernel on a CUDA basis, its plain twin on the CPU); the outer two stay
    matrix products, as in the JAX package.  Under ``mesh`` both
    projections are all-reduced: the fused kernel runs on the local rows
    and its ``u2`` is all-reduced before the second update (the JAX
    package does not use its kernel on sharded operands)."""
    Qa = Q[: j + 1]
    h1 = psum(Qa @ w, mesh)
    if fused:
        w1, h2 = fused_update_matvec(Qa, w, h1)
        h2 = psum(h2, mesh)
    else:
        w1 = w - h1 @ Qa
        h2 = psum(Qa @ w1, mesh)
    w2 = w1 - h2 @ Qa
    return w2, h1 + h2


def arnoldi_step(
    A,
    prefunc: Callable[[torch.Tensor], torch.Tensor],
    st: ArnoldiState,
    j: int,
    ortho: str = "cgs2",
) -> float:
    """One flexible-Arnoldi iteration, in place; returns h[j+1, j].

    ``ortho``: ``"cgs2"`` (the plain form, four matrix products; the JAX
    package's ``"cgs2_xla"`` is the same), ``"cgs2_fused"`` (its middle pair
    through the fused kernel #5 on a CUDA basis, the kernel's plain twin on
    the CPU) or ``"mgs"`` (the reference's sequential recurrence).  The
    explicit ``"cgs2_fused"`` stands in for the JAX package's environment
    variable ``SPIS_ORTHO_ENGINE=pallas``.

    h[j+1, j] == 0 signals breakdown (reference solvers.py:101-106).
    """
    if ortho not in ORTHO:
        raise ValueError(f"unknown ortho {ortho!r}; use one of {ORTHO}")
    mesh = mesh_of(A)
    z = prefunc(st.Q[j])
    w = A @ z
    if ortho == "mgs":
        w, h = _mgs(st.Q, w, j, mesh)
    else:
        w, h = _cgs2(st.Q, w, j, fused=ortho == "cgs2_fused", mesh=mesh)
    # one device→host copy per step: the Hessenberg column and its last entry
    host = torch.cat([h, pnorm(w, mesh).reshape(1)]).to(HOST)
    hlast = float(host[-1])
    hcol = torch.zeros(st.H.shape[0], dtype=st.H.dtype)
    hcol[: j + 1] = host[:-1]
    hcol[j + 1] = hlast
    if hlast > 0:
        st.Q[j + 1] = w / hlast
    st.Z[j] = z
    st.H[:, j] = hcol
    _givens_update(st, hcol, j)
    return hlast


def _givens_update(st: ArnoldiState, hcol: torch.Tensor, j: int) -> None:
    """Fold column j of H into the running QR factorisation, in place."""
    h = hcol.tolist()
    cs, sn = st.cs.tolist(), st.sn.tolist()
    for i in range(j):
        hi, hi1 = h[i], h[i + 1]
        h[i] = cs[i] * hi + sn[i] * hi1
        h[i + 1] = -sn[i] * hi + cs[i] * hi1
    a, b = h[j], h[j + 1]
    denom = math.sqrt(a * a + b * b)
    c, s = (1.0, 0.0) if denom == 0 else (a / denom, b / denom)
    h[j] = denom

    gj = float(st.g[j])
    st.g[j] = c * gj
    st.g[j + 1] = -s * gj
    k = st.R.shape[0]
    # incremental explicit inverse of the triangular factor: appending
    # column j to R extends R⁻¹ by one column, so every coefficient solve
    # (lsq_coeffs) is one matvec
    hk = torch.tensor(h[:k], dtype=st.R.dtype)
    rjj = torch.finfo(st.R.dtype).tiny if denom == 0 else denom
    upper = torch.where(torch.arange(k) < j, hk, 0.0)
    newcol = -torch.sum(st.Rinv * upper[None, :], dim=1) / rjj
    newcol[j] = 1.0 / rjj
    st.R[:, j] = hk
    st.Rinv[:, j] = newcol
    st.cs[j] = c
    st.sn[j] = s


def lsq_coeffs(st: ArnoldiState, j: int) -> torch.Tensor:
    """Least-squares coefficients y (k,) on the host, with y[j+1:] = 0.

    Solves min ‖β e1 − H[:, :j+1] y‖ through the Givens QR as one masked
    matvec with R⁻¹: the leading blocks of a triangular inverse are the
    inverses of the leading blocks.  Replaces the reference's
    np.linalg.lstsq (solvers.py:113).
    """
    k = st.R.shape[0]
    rhs = torch.where(torch.arange(k) <= j, st.g[:k], 0.0)
    return torch.sum(st.Rinv * rhs[None, :], dim=1)


def lsq_residual_estimate(st: ArnoldiState, j: int) -> float:
    """|g[j+1]| — the exact LSQ residual of the projected problem."""
    return abs(float(st.g[j + 1]))


def iterate(st: ArnoldiState, y: torch.Tensor, j: int, x0: torch.Tensor) -> torch.Tensor:
    """x = x0 + Σ_{i≤j} y_i z_i, on the basis' device."""
    return y[: j + 1].to(st.Z.device) @ st.Z[: j + 1] + x0


# --- the fixed-shape state on the operands' device ---------------------------


class DeviceArnoldi(NamedTuple):
    """The JAX package's ``ArnoldiState`` (``arnoldi.py:16-57`` there), all
    on the operands' device, for a batch of B solves (the leading axis of
    every field: the JAX package's state under ``jax.vmap``), with ``G``,
    the product of the Givens rotations so far, (B, k+1, k+1), the identity
    beyond the active rows, in place of its R, cs and sn, which nothing here
    reads: ``G @ H[:, :j+1]`` is R and ``G @ (β e1) = g``."""

    Q: torch.Tensor  # (B, k+1, n)
    Z: torch.Tensor  # (B, k, n)
    H: torch.Tensor  # (B, k+1, k)
    Rinv: torch.Tensor  # (B, k, k)
    g: torch.Tensor  # (B, k+1)
    G: torch.Tensor  # (B, k+1, k+1)


def device_state(n: int, k: int, dtype, device, batch: int = 1) -> DeviceArnoldi:
    def z(*shape):
        return torch.zeros((batch, *shape), dtype=dtype, device=device)

    return DeviceArnoldi(Q=z(k + 1, n), Z=z(k, n), H=z(k + 1, k),
                         Rinv=z(k, k), g=z(k + 1), G=z(k + 1, k + 1))


def start(st: DeviceArnoldi, r0: torch.Tensor, beta: torch.Tensor) -> None:
    """Reset the state for the solves from the residuals r0 (B, n),
    ‖r0‖ = beta (B,): the first basis rows and β e1; the k-sized factors
    are cleared (the n-sized rows beyond the first are written before they
    are read)."""
    st.Q[:, 0] = r0 / torch.where(beta == 0, 1.0, beta)[:, None]
    for t in (st.H, st.Rinv, st.g):
        t.zero_()
    st.g[:, 0] = beta
    st.G.copy_(torch.eye(st.G.shape[-1], dtype=st.G.dtype,
                         device=st.G.device).expand_as(st.G))


def _cgs2_block(Q: torch.Tensor, w: torch.Tensor, j: int,
                mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_cgs2`` for each solve of a batch: Q (B, k+1, n), w (B, n); its
    four tall products as batched matrix products over the (B, j+1, n)
    active basis, outside any kernel, as in the JAX package; both
    projections all-reduced over ``mesh``."""
    Qa = Q[:, : j + 1]
    h1 = psum(rows_mv(Qa, w), mesh)
    w1 = w - rows_rmv(h1, Qa)
    h2 = psum(rows_mv(Qa, w1), mesh)
    w2 = w1 - rows_rmv(h2, Qa)
    return w2, h1 + h2


def arnoldi_step_masked(A, prefunc, st: DeviceArnoldi, j: int, ortho: str,
                        live: torch.Tensor) -> torch.Tensor:
    """``arnoldi_step`` on the device state of B solves, with no host read:
    returns h[j+1, j] (B,) on the device.  Where ``live`` (B,) is false
    nothing of that solve is written.  The preconditioner and A take the
    (n, B) block of the solves' vectors (``ops/rows.py``); a single solve
    (B = 1) runs the products of ``arnoldi_step`` on its vector, and only
    there may ``ortho`` be ``"cgs2_fused"`` (the fused kernel #5 takes one
    vector) or ``"mgs"``."""
    if ortho not in ORTHO:
        raise ValueError(f"unknown ortho {ortho!r}; use one of {ORTHO}")
    B = st.Q.shape[0]
    if B > 1 and ortho not in ("cgs2", "cgs2_xla"):
        raise NotImplementedError(
            f"ortho={ortho!r} under a batch: the batched core runs 'cgs2', as "
            "the JAX package's cgmres_many builds its core")
    mesh = mesh_of(A)
    z = rows(prefunc, st.Q[:, j])
    w = rows(A.__matmul__, z)
    if B > 1:
        w, h = _cgs2_block(st.Q, w, j, mesh)
    elif ortho == "mgs":
        w, h = (t[None] for t in _mgs(st.Q[0], w[0], j, mesh))
    else:
        w, h = (t[None] for t in _cgs2(st.Q[0], w[0], j,
                                       fused=ortho == "cgs2_fused",
                                       mesh=mesh))
    hlast = pnorm(w, mesh, dim=-1)
    k1 = st.H.shape[1]
    hcol = torch.cat([h, hlast[:, None], h.new_zeros(B, k1 - j - 2)], dim=1)
    safe = torch.where(hlast == 0, 1.0, hlast)[:, None]
    qnext = torch.where((hlast > 0)[:, None], w / safe, 0.0)
    lv = live[:, None]
    st.Q[:, j + 1] = torch.where(lv, qnext, st.Q[:, j + 1])
    st.Z[:, j] = torch.where(lv, z, st.Z[:, j])
    st.H[:, :, j] = torch.where(lv, hcol, st.H[:, :, j])
    givens_update_masked(st, hcol, j, live)
    return hlast


def givens_update_masked(st: DeviceArnoldi, hcol: torch.Tensor, j: int,
                         live: torch.Tensor) -> None:
    """Fold column j of H, hcol (B, k+1), into the running QR
    factorisations, as the JAX package's ``_givens_update``
    (``arnoldi.py:140-177`` there) with its incremental R⁻¹, on the device:
    the j earlier rotations act on the column as one product with their
    running product ``G`` (the JAX package applies them one by one, 2j
    dependent operations); then the new rotation, which updates rows j and
    j+1 of ``G``.  Where ``live`` (B,) is false nothing is written."""
    B, k = st.Rinv.shape[0], st.Rinv.shape[-1]
    rot = (st.G[:, : j + 1, : j + 1] @ hcol[:, : j + 1, None])[:, :, 0]
    a, b = rot[:, j], hcol[:, j + 1]
    denom = torch.sqrt(a * a + b * b)
    safe = torch.where(denom == 0, 1.0, denom)
    c = torch.where(denom == 0, 1.0, a / safe)
    s = torch.where(denom == 0, 0.0, b / safe)
    gj = st.g[:, j]
    g_j, g_j1 = c * gj, -s * gj
    rjj = torch.where(denom == 0, torch.finfo(st.Rinv.dtype).tiny, denom)
    rest = hcol.new_zeros(B, k - j - 1)
    upper = (st.Rinv[:, :j, :j] @ rot[:, :j, None])[:, :, 0]
    newcol = torch.cat([-upper / rjj[:, None], (1.0 / rjj)[:, None], rest],
                       dim=1)
    c, s = c[:, None], s[:, None]
    Gj = c * st.G[:, j] + s * st.G[:, j + 1]
    Gj1 = -s * st.G[:, j] + c * st.G[:, j + 1]
    lv = live[:, None]
    st.g[:, j] = torch.where(live, g_j, gj)
    st.g[:, j + 1] = torch.where(live, g_j1, st.g[:, j + 1])
    st.Rinv[:, :, j] = torch.where(lv, newcol, st.Rinv[:, :, j])
    st.G[:, j] = torch.where(lv, Gj, st.G[:, j])
    st.G[:, j + 1] = torch.where(lv, Gj1, st.G[:, j + 1])


def lsq_coeffs_device(st: DeviceArnoldi, j: int) -> torch.Tensor:
    """``lsq_coeffs`` on the device: one product with the active columns of
    R⁻¹, (B, k) with y[:, j+1:] = 0 (rows of R⁻¹ below its diagonal are
    zero)."""
    return (st.Rinv[:, :, : j + 1] @ st.g[:, : j + 1, None])[:, :, 0]
