"""Equality-constrained least squares over Krylov coefficients.

The port of the JAX package's ``solvers/kkt.py``, which replaces the
reference's SLSQP (reference ``solvers.py:231,251,274,411,420``) with a
damped Lagrange–Newton (SQP) iteration on the KKT conditions of

    min_y ‖β e1 − H y‖²   s.t.   g_i(y) = 0,  i = 1..m

where each g_i is the reduced quadratic ``t0 + t1·y + yᵀT2 y``.  The
problem is tiny (k ≤ ~60 coefficients, m ≤ 3 constraints) and runs on the
host, beside the Hessenberg matrix it reads.  ``torch.linalg.inv`` of the
(k+m)² KKT matrix replaces the JAX package's Gauss–Jordan, which exists
there only because XLA:TPU has no f64 LU.

With f32 storage the Hessenberg matrix and the starts come in f32 and the
reduced constraints in f64 (the solver's ``cdtype``): the KKT runs in the
buffers' dtype, its inputs upcast (JAX ``kkt.py:60``), and every floor and
tolerance here takes that dtype's eps.

Masking: coefficients beyond the active Arnoldi prefix and constraints not
yet enforced (the prototypical solver enforces them one by one, reference
``solvers.py:413``) are pinned via unit diagonal rows, so every solve has
the same shape.

The device core (``solvers/cgmres.py::DeviceCore``) runs the same
modified Newton on the card, with no host read inside a step, from the
functions at the end of this module: the JAX package's ``gj_inverse`` and
``solve_dense`` (``kkt.py:55-125`` there) and ``constrained_lsq``
(``:127-293``) cut into a start, one iteration and a re-factorisation, so
that the host decides between the steps from a flag; for a batch of solves,
each with its two starts (warm and fresh).  There the active
prefix is a Python constant, so the problem is set up on the active
coefficients alone: pinned coefficients have unit rows in the JAX
package's KKT matrix and do not change its active block.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constraints.quadratic import (
    ReducedBuffers,
    reduced_grad,
    reduced_scale,
    reduced_value,
)


class KKTResult(NamedTuple):
    y: torch.Tensor  # (k,) minimiser (inactive coords zero)
    lam: torch.Tensor  # (m,) multipliers
    deviation: float  # max |g_i(y)| over enforced constraints
    scale: float  # roundoff scale of the worst constraint evaluation
    kkt_norm: float  # final KKT residual norm
    iters: int
    Kinv: torch.Tensor  # (k+m, k+m) last KKT inverse (reusable warm start)
    refacts: int  # factorisations performed


def _constraint_eval(bufs, y, con_mask):
    """Masked values (…, m) and Jacobians (…, m, k) at y of shape (…, k)."""
    g = torch.stack([reduced_value(b, y) for b in bufs], dim=-1)
    J = torch.stack([reduced_grad(b, y) for b in bufs], dim=-2)
    return g * con_mask, J * con_mask[:, None]


# the backtracking candidates, all evaluated in one batched pass
_ALPHAS = 2.0 ** -np.arange(14, dtype=np.float64)


def constrained_lsq(
    H: torch.Tensor,  # (k+1, k); columns beyond active prefix are zero
    beta: float,
    bufs: Tuple[ReducedBuffers, ...],
    y0: torch.Tensor,  # (k,) warm start (inactive coords zero)
    active: torch.Tensor,  # (k,) bool — active coefficient mask
    con_mask: torch.Tensor,  # (m,) float — 1 for enforced constraints
    maxiter: int = 40,
    kkt_tol: float = 1e-13,
    lam_ws: torch.Tensor = None,  # (m,) multiplier warm start (or None)
    Kinv_ws: torch.Tensor = None,  # (k+m, k+m) inverse warm start (or None)
    have_ws: bool = None,  # whether the warm starts are valid
    max_refacts: int = 4,
    pin: torch.Tensor = None,  # (m,) bool — constraints pinned (``pins``)
    s0: Sequence = None,  # (m,) roundoff scales of g(x0), or None each
    eps: float = None,  # the entry floor's eps (None: the buffers' dtype's)
) -> KKTResult:
    """Modified-Newton SQP on the KKT conditions.

    The KKT matrix is inverted once and kept frozen: every Newton step is
    then two matvecs plus one batched Armijo search over 14 step lengths.
    When the search cannot decrease ‖r‖² fast enough the matrix is
    re-factored at the current point (up to ``max_refacts`` times) before
    giving up.  ``lam_ws``/``Kinv_ws``/``have_ws`` let the caller carry the
    multipliers and the factorisation across gated CGMRES iterations.

    Two repairs of a warm start, the device core's (not in the JAX
    package): ``s0`` gives each constraint's roundoff scale at x0 in place
    of |t0| (``value_scale``), and ``pin`` (``pins``) takes constraints out
    of the Newton, as the device core's ``kkt_start`` takes them: their
    reduced gradients are zero there, so their values stay t0, and their
    multipliers get a one on the KKT matrix's diagonal.  The result's
    deviation and scale are judged on the unpinned constraints.
    """
    k = H.shape[1]
    m = len(bufs)
    # the constraints' dtype (f64 over f32 storage): the KKT's
    dt = bufs[0].t1.dtype if bufs else H.dtype
    H, y0 = H.to(dt), y0.to(dt)
    act = active.to(dt)
    alphas = torch.as_tensor(_ALPHAS, dtype=dt)
    judged = bufs
    pin_d = torch.zeros((m, m), dtype=dt)
    if pin is not None and bool(pin.any()):
        bufs = tuple(b._replace(t1=torch.zeros_like(b.t1)) if p else b
                     for b, p in zip(bufs, pin.tolist()))
        pin_d = torch.diag(pin.to(dt))

    G2 = 2.0 * (H.T @ H)  # objective Hessian
    bf = 2.0 * beta * H[0, :]  # 2 Hᵀ (β e1)

    def kkt_residual(y, lam):
        g, J = _constraint_eval(bufs, y, con_mask)
        grad_f = y @ G2.T - bf
        rL = (grad_f + torch.einsum("...mk,...m->...k", J, lam)) * act
        return torch.cat([rL, g], dim=-1), g, J

    def factor(y, lam):
        _, _, J = kkt_residual(y, lam)
        W = G2
        for i, b in enumerate(bufs):
            W = W + (2.0 * lam[i] * con_mask[i]) * b.T2
        # pin inactive coefficients
        W = act[:, None] * W * act[None, :] + torch.diag(1.0 - act)
        Jm = J * act[None, :]
        # pin multipliers of unenforced and of pinned constraints
        D = torch.diag(1.0 - con_mask) + pin_d
        K = torch.cat([torch.cat([W, Jm.T], dim=1), torch.cat([Jm, D], dim=1)])
        return torch.linalg.inv_ex(K).inverse

    eps = torch.finfo(dt).eps if eps is None else eps

    s0 = [None] * m if s0 is None else list(s0)

    def scales_at(y):
        return torch.stack([reduced_scale(b, y, s) for b, s in zip(judged, s0)])

    def floor_at(y):
        scales = scales_at(y) * con_mask
        return max(10.0 * kkt_tol, 32.0 * eps * float(torch.max(scales)))

    # relative threshold for the Lagrangian-gradient part; feasibility is
    # judged absolutely against the ctol/roundoff floor
    thresh = kkt_tol * (1.0 + float(torch.linalg.norm(bf)))

    y = y0 * act
    # least-squares multiplier estimate λ0 = argmin ‖∇f + Jᵀλ‖ from the m×m
    # normal equations; one constraint evaluation (at λ=0) serves both the
    # estimate and the initial residual
    r_zero, g_0, J_0 = kkt_residual(y, torch.zeros(m, dtype=dt))
    gf0 = r_zero[:k]
    Jm0 = J_0 * act[None, :]
    S = Jm0 @ Jm0.T + torch.diag(1.0 - con_mask) + pin_d
    lam = -torch.linalg.solve_ex(S, Jm0 @ gf0).result * con_mask
    lam = torch.where(torch.isfinite(lam), lam, 0.0)
    if have_ws is not None and lam_ws is not None and have_ws:
        lam = lam_ws * con_mask
    r = torch.cat([gf0 + (J_0.T @ lam) * act, g_0])
    if have_ws is not None and Kinv_ws is not None and have_ws:
        Kinv, refacts, fresh = Kinv_ws, 0, False
    else:
        Kinv, refacts, fresh = factor(y, lam), 1, True

    rnorm = float(torch.linalg.norm(r))
    floor0 = floor_at(y)
    it, give_up = 0, False
    while ((rnorm > thresh or float(torch.max(torch.abs(r[k:]))) - floor0 > 0)
           and it < maxiter and not give_up):
        step = Kinv @ (-r)
        dy, dlam = step[:k] * act, step[k:] * con_mask
        phi0 = rnorm * rnorm
        ys = y[None, :] + alphas[:, None] * dy[None, :]
        ls = lam[None, :] + alphas[:, None] * dlam[None, :]
        rn = kkt_residual(ys, ls)[0]
        phin = torch.sum(rn * rn, dim=1).numpy()
        ok = phin <= (1.0 - 1e-4 * _ALPHAS) * phi0
        # largest Armijo-acceptable alpha; if none, the best-decrease trial
        idx = int(np.argmax(ok)) if ok.any() else int(np.argmin(phin))
        phi_acc = float(phin[idx])
        r = rn[idx]
        y = y + alphas[idx] * dy
        lam = lam + alphas[idx] * dlam
        # slow progress (< 4× decrease) means the frozen operator is stale:
        # re-factor.  Stagnation (< 0.5% decrease) with a fresh factor means
        # the attainable floor is reached — give up (SLSQP's ftol exit,
        # reference solvers.py:234-235)
        slow = phi_acc > 0.25 * phi0
        stalled = phi_acc > 0.995 * phi0
        give_up = (stalled and fresh) or (stalled and refacts >= max_refacts)
        refact = slow and not give_up and refacts < max_refacts
        if refact:
            Kinv = factor(y, lam)
        rnorm = math.sqrt(phi_acc)
        it += 1
        refacts += int(refact)
        fresh = refact
    g, _ = _constraint_eval(judged, y, con_mask)
    scales = scales_at(y) * con_mask
    return KKTResult(
        y=y,
        lam=lam,
        deviation=float(torch.max(torch.abs(g))),
        scale=float(torch.max(scales)),
        kkt_norm=rnorm,
        iters=it,
        Kinv=Kinv,
        refacts=refacts,
    )


def pins(bufs: Tuple[ReducedBuffers, ...], s0: Sequence,
         linear: torch.Tensor, starts: torch.Tensor, con_mask: torch.Tensor,
         kkt_tol: float, eps: float = None) -> torch.Tensor:
    """The constraints a modified Newton from the starts (S, k) pins, as
    ``kkt_start`` pins them on the device: a ``linear`` (m,) constraint
    whose value at every start, summand by summand, lies within the
    smallest of the starts' entry floors is satisfied by every iterate near
    them, and its Jacobian row is zero to roundoff (from a warm start swe's
    Krylov vectors carry no mass).  ``eps``: the floors' (None: the
    buffers' dtype's)."""
    starts = starts.to(bufs[0].t1.dtype)
    eps = torch.finfo(starts.dtype).eps if eps is None else eps
    floor0 = min(
        max(10.0 * kkt_tol, 32.0 * eps * float(torch.max(torch.stack(
            [reduced_scale(b, y, s) for b, s in zip(bufs, s0)]) * con_mask)))
        for y in starts)
    ymax = starts.abs().amax(0)
    reach = torch.stack([b.t0.abs() + b.t1.abs() @ ymax for b in bufs])
    return linear & (reach <= floor0)


# --- the device form: a start, one iteration and a re-factorisation ----------


def gj_inverse(K: torch.Tensor) -> torch.Tensor:
    """Inverse of each (n, n) matrix of K (..., n, n) by Gauss–Jordan with
    partial pivoting on [K | I], in tensor operations with no host read: the
    JAX package's ``gj_inverse`` (``kkt.py:55-125`` there).  The pivot of
    column c is the largest unused entry of the column; it eliminates the
    column from every other row, so no back substitution follows.  Ten
    operations a column."""
    n = K.shape[-1]
    eye = torch.eye(n, dtype=K.dtype, device=K.device).expand(K.shape)
    M = torch.cat([K, eye], dim=-1)
    batch = K.shape[:-2]
    used = torch.zeros((*batch, n), dtype=torch.bool, device=K.device)
    perm = torch.zeros((*batch, n), dtype=torch.long, device=K.device)
    tiny = torch.finfo(K.dtype).tiny
    for c in range(n):
        col = M[..., :, c]
        piv = torch.where(used, -1.0, col.abs()).argmax(-1, keepdim=True)
        pivrow = torch.take_along_dim(M, piv[..., None], dim=-2)
        pivval = pivrow[..., 0, c : c + 1]
        pivval = torch.where(pivval == 0, tiny, pivval)
        factors = (col / pivval).scatter(-1, piv, 0.0)
        M = torch.addcmul(M, factors[..., :, None], pivrow, value=-1.0)
        used = used.scatter(-1, piv, True)
        perm[..., c] = piv[..., 0]
    # row p(c) of the eliminated system is pivval_c (e_c, K⁻¹[c, :])
    rows = torch.take_along_dim(M, perm[..., None], dim=-2)
    diag = torch.diagonal(rows[..., :n], dim1=-2, dim2=-1)
    diag = torch.where(diag == 0, tiny, diag)
    return rows[..., n:] / diag[..., None]


def solve_dense(K: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """K x = rhs for each (n, n) K of a batch by Gauss–Jordan; rhs (..., n)."""
    return (gj_inverse(K) @ rhs[..., None])[..., 0]


class KKTModel(NamedTuple):
    """The KKT problems of one constrained step of B solves on the active
    coefficients: each solve's objective Hessian and gradient term and its m
    reduced constraints stacked, each on the ``ka`` active coefficients,
    with the roundoff scales s0 of their values at x0.  Every field has the
    batch shape (B, 1) in front, the 1 the axis of a solve's starts, so
    that a model broadcasts against the starts (B, S, ...) of ``KKTWork``
    (``lifted`` adds one more axis, for the candidates of a line search)."""

    G2: torch.Tensor  # (B, 1, ka, ka)  2 Hᵀ H
    bf: torch.Tensor  # (B, 1, ka)      2 β H[0, :]
    t0: torch.Tensor  # (B, 1, m)
    s0: torch.Tensor  # (B, 1, m)
    t1: torch.Tensor  # (B, 1, m, ka)
    T2: torch.Tensor  # (B, 1, m, ka, ka)
    # (B, 1, m) bool: constraints pinned for this step (``kkt_start``), whose
    # Jacobian rows are zero and multipliers held at zero
    pin: Optional[torch.Tensor] = None


def kkt_model(H: torch.Tensor, beta: torch.Tensor,
              bufs: Tuple[ReducedBuffers, ...], ka: int,
              s0: torch.Tensor) -> KKTModel:
    """The model on the first ``ka`` coefficients of each of B solves: H
    (B, k+1, k), beta (B,), the device buffers of ``device_buffers``, and
    ``s0`` (B, m) the roundoff scales of the constraints' values at x0
    (``value_and_scale``).  The model is in the buffers' dtype (f64 over
    f32 storage), H and beta upcast."""
    cd = bufs[0].t1.dtype
    Ha, beta = H[:, : ka + 1, :ka].to(cd), beta.to(cd)
    return KKTModel(
        G2=2.0 * (Ha.mT @ Ha)[:, None], bf=(2.0 * beta[:, None] * Ha[:, 0])[:, None],
        t0=torch.stack([b.t0 for b in bufs], dim=-1)[:, None],
        s0=s0[:, None],
        t1=torch.stack([b.t1[:, :ka] for b in bufs], dim=1)[:, None],
        T2=torch.stack([b.T2[:, :ka, :ka] for b in bufs], dim=1)[:, None])


def lifted(mod: KKTModel) -> KKTModel:
    """The model with one more axis after its batch axes, to broadcast
    against the candidates (B, S, C, ...) of a line search."""
    return KKTModel(*(None if t is None else t.unsqueeze(2) for t in mod))


def pinned(mod: KKTModel, pin: torch.Tensor) -> KKTModel:
    """The model with the constraints of ``pin`` (B, m) taken out of the
    Newton: their reduced gradients set to zero (they are linear), so their
    values stay t0 and the KKT matrix gets a one on their multipliers'
    diagonal."""
    pin = pin[:, None]
    return mod._replace(t1=torch.where(pin[..., None], 0.0, mod.t1), pin=pin)


def kkt_values(mod: KKTModel, y: torch.Tensor):
    """The constraints' values g (..., m) and Jacobians J (..., m, ka) at
    the coefficients y (..., ka), whose leading axes the model's batch axes
    broadcast against."""
    T2y = (mod.T2 @ y[..., None, :, None])[..., 0]
    g = (mod.t0 + (mod.t1 @ y[..., :, None])[..., 0]
         + (y[..., None, :] * T2y).sum(-1))
    return g, mod.t1 + 2.0 * T2y


def kkt_scale(mod: KKTModel, y: torch.Tensor) -> torch.Tensor:
    """The largest roundoff scale of the constraints at y (..., ka): the
    ``reduced_scale`` of each, then the maximum, with the scale s0 of the
    value at x0 in place of |t0|.  From a warm start t0 = g(x0) is a
    cancellation (swe's mass, 9e3, to 0.0), and |t0| would put the floor
    below the roundoff of every evaluation of g."""
    scales = (mod.s0 + (mod.t1 * y[..., None, :]).abs().sum(-1)
              + (y[..., None, :, None] * mod.T2 * y[..., None, None, :])
              .abs().sum((-1, -2)))
    return scales.amax(-1)


def kkt_residual(mod: KKTModel, y: torch.Tensor, lam: torch.Tensor):
    """The KKT residual [g, ∇f + Jᵀλ] (..., m + ka) at (y, λ), the
    multipliers first, with g and J."""
    g, J = kkt_values(mod, y)
    rL = ((mod.G2 @ y[..., None])[..., 0] - mod.bf
          + torch.einsum("...mk,...m->...k", J, lam))
    return torch.cat([g, rL], dim=-1), g, J


def kkt_factor(mod: KKTModel, y: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """The inverse of the KKT matrix [[0, J], [Jᵀ, W]] at (y, λ) for each of
    a batch (B, S, ka), (B, S, m), with W = 2HᵀH + Σ 2λ_i T2_i."""
    _, J = kkt_values(mod, y)
    W = mod.G2 + (2.0 * lam[..., None, None] * mod.T2).sum(-3)
    m = lam.shape[-1]
    zero = torch.zeros((*lam.shape, m), dtype=W.dtype, device=W.device)
    if mod.pin is not None:
        zero = zero + torch.diag_embed(mod.pin.to(W.dtype))
    K = torch.cat([torch.cat([zero, J], dim=-1),
                   torch.cat([J.transpose(-1, -2), W], dim=-1)], dim=-2)
    return gj_inverse(K)


class KKTWork(NamedTuple):
    """The modified Newton's state for S starts of each of B solves, in
    buffers of the largest size: coefficients (B, S, k), multipliers
    (B, S, m), the KKT residual (B, S, m + k) and inverse
    (B, S, m + k, m + k), whose leading m + ka entries a step uses, and per
    start its norm, its entry floor, its counts and its flags; the pins
    (B, m) of the step (``kkt_start``)."""

    y: torch.Tensor
    lam: torch.Tensor
    r: torch.Tensor
    Kinv: torch.Tensor
    rnorm: torch.Tensor
    floor0: torch.Tensor
    it: torch.Tensor
    refacts: torch.Tensor
    fresh: torch.Tensor
    give_up: torch.Tensor
    cond: torch.Tensor
    refact: torch.Tensor
    pin: torch.Tensor


def kkt_work(B: int, S: int, k: int, m: int, like: torch.Tensor) -> KKTWork:
    def z(*shape, dtype=like.dtype):
        return torch.zeros(shape, dtype=dtype, device=like.device)

    flag = dict(dtype=torch.bool)
    return KKTWork(y=z(B, S, k), lam=z(B, S, m), r=z(B, S, m + k),
                   Kinv=z(B, S, m + k, m + k), rnorm=z(B, S), floor0=z(B, S),
                   it=z(B, S, dtype=torch.long),
                   refacts=z(B, S, dtype=torch.long), fresh=z(B, S, **flag),
                   give_up=z(B, S, **flag), cond=z(B, S, **flag),
                   refact=z(B, S, **flag), pin=z(B, m, **flag))


def _going(mod, work, na, m, kkt_tol, maxiter):
    """Whether each start iterates on: its residual is above the (relative)
    threshold or its constraints above the entry floor, within the
    iteration cap and not given up."""
    r = work.r[..., :na]
    thresh = kkt_tol * (1.0 + torch.linalg.norm(mod.bf, dim=-1))
    return (((work.rnorm > thresh)
             | (r[..., :m].abs().amax(-1) - work.floor0 > 0))
            & (work.it < maxiter) & ~work.give_up)


def kkt_start(mod: KKTModel, work: KKTWork, y0: torch.Tensor,
              have: torch.Tensor, lam_ws: torch.Tensor, Kinv_ws: torch.Tensor,
              kkt_tol: float, linear: torch.Tensor, live: torch.Tensor,
              maxiter: int = 40, eps: float = None) -> None:
    """Set up the modified Newton of each of B solves from its starts y0
    (B, S, ka): the least-squares multiplier estimate, the residual and the
    factorisation, or, where ``have`` (B, S), the solve's warm multipliers
    ``lam_ws`` (B, m) and inverse ``Kinv_ws`` (B, m + ka, m + ka); as
    ``constrained_lsq`` begins.  Only the solves of ``live`` (B,) go on
    (``work.cond``).

    Then the pins (``work.pin``; not in the JAX package): a ``linear`` (m,)
    constraint whose value at a solve's starts, summand by summand, lies
    within the entry floor is satisfied by every iterate near them, and its
    Jacobian row is zero to roundoff.  (From a warm start swe's Krylov
    vectors carry no mass: the mass row is 1e-13 of its scale and the KKT
    matrix singular, so the Newton stalls and the solve runs to k.)  A
    pinned constraint leaves the Newton (``pinned``); ``kkt_step`` and
    ``kkt_refactor`` take the model with ``work.pin``, and the caller judges
    the result on the unpinned values.  ``eps``: the entry floor's (None:
    y0's dtype's)."""
    B, S, ka = y0.shape
    m = mod.t0.shape[-1]
    na = m + ka
    eps = torch.finfo(y0.dtype).eps if eps is None else eps
    work.floor0.copy_(torch.clamp(32.0 * eps * kkt_scale(mod, y0),
                                  min=10.0 * kkt_tol))
    reach = mod.t0.abs() + (mod.t1.abs() @ y0.abs().amax(1)[:, None, :, None])[..., 0]
    work.pin.copy_(linear & (reach[:, 0] <= work.floor0.amin(-1, keepdim=True)))
    mod = pinned(mod, work.pin)
    r_zero, g0, J0 = kkt_residual(mod, y0, y0.new_zeros(B, S, m))
    gf0 = r_zero[..., m:]
    S_ = J0 @ J0.transpose(-1, -2) + torch.diag_embed(mod.pin.to(y0.dtype))
    lam0 = -solve_dense(S_, (J0 @ gf0[..., None])[..., 0])
    lam0 = torch.where(torch.isfinite(lam0), lam0, 0.0)
    lam = torch.where(have[..., None], lam_ws[:, None], lam0)
    r = torch.cat([g0, gf0 + torch.einsum("...mk,...m->...k", J0, lam)], dim=-1)
    Kinv = torch.where(have[..., None, None], Kinv_ws[:, None],
                       kkt_factor(mod, y0, lam))
    work.y[..., :ka] = y0
    work.lam.copy_(lam)
    work.r[..., :na] = r
    work.Kinv[..., :na, :na] = Kinv
    work.rnorm.copy_(torch.linalg.norm(r, dim=-1))
    work.it.zero_()
    work.refacts.copy_(torch.where(have, 0, 1))
    work.fresh.copy_(~have)
    work.give_up.zero_()
    work.refact.zero_()
    work.cond.copy_(_going(mod, work, na, m, kkt_tol, maxiter) & live[:, None])


# the backtracking candidates of one iteration, all evaluated at once
def _alphas(like: torch.Tensor) -> torch.Tensor:
    return torch.pow(2.0, -torch.arange(14, dtype=like.dtype,
                                        device=like.device))


def kkt_step(mod: KKTModel, work: KKTWork, kkt_tol: float, maxiter: int = 40,
             max_refacts: int = 4) -> None:
    """One modified-Newton iteration of each start still going
    (``work.cond``), as the body of ``constrained_lsq``: the frozen
    inverse's step, a batched Armijo search over 14 step lengths, and the
    re-factorisation decision (``work.refact``; ``kkt_refactor`` does it).
    A start that has stopped is left as it is."""
    mod = pinned(mod, work.pin)
    ka = mod.G2.shape[-1]
    m = mod.t0.shape[-1]
    na = m + ka
    go = work.cond
    y, lam, r = work.y[..., :ka], work.lam, work.r[..., :na]
    step = -(work.Kinv[..., :na, :na] @ r[..., None])[..., 0]
    dlam, dy = step[..., :m], step[..., m:]
    phi0 = work.rnorm * work.rnorm
    alphas = _alphas(y)
    ys = y[..., None, :] + alphas[:, None] * dy[..., None, :]
    ls = lam[..., None, :] + alphas[:, None] * dlam[..., None, :]
    rn = kkt_residual(lifted(mod), ys, ls)[0]
    phin = (rn * rn).sum(-1)
    ok = phin <= (1.0 - 1e-4 * alphas) * phi0[..., None]
    # the largest Armijo-acceptable step, else the best decrease
    idx = torch.where(ok.any(-1), ok.to(torch.uint8).argmax(-1),
                      phin.argmin(-1))
    alpha = alphas[idx]
    phi_acc = torch.take_along_dim(phin, idx[..., None], dim=-1)[..., 0]
    r_acc = torch.take_along_dim(rn, idx[..., None, None], dim=-2)[..., 0, :]
    slow = phi_acc > 0.25 * phi0
    stalled = phi_acc > 0.995 * phi0
    give_up = (stalled & work.fresh) | (stalled & (work.refacts >= max_refacts))
    refact = go & slow & ~give_up & (work.refacts < max_refacts)
    g1 = go[..., None]
    work.y[..., :ka] = torch.where(g1, y + alpha[..., None] * dy, y)
    work.lam.copy_(torch.where(g1, lam + alpha[..., None] * dlam, lam))
    work.r[..., :na] = torch.where(g1, r_acc, r)
    work.rnorm.copy_(torch.where(go, torch.sqrt(phi_acc), work.rnorm))
    work.it.add_(go.long())
    work.refacts.add_(refact.long())
    work.fresh.copy_(torch.where(go, refact, work.fresh))
    work.give_up.copy_(torch.where(go, give_up, work.give_up))
    work.refact.copy_(refact)
    work.cond.copy_(_going(mod, work, na, m, kkt_tol, maxiter) & work.cond)


def kkt_refactor(mod: KKTModel, work: KKTWork) -> None:
    """Re-factor the KKT matrix at the current point of each start that
    asked for it (``work.refact``)."""
    mod = pinned(mod, work.pin)
    ka = mod.G2.shape[-1]
    na = mod.t0.shape[-1] + ka
    Kinv = work.Kinv[..., :na, :na]
    work.Kinv[..., :na, :na] = torch.where(
        work.refact[..., None, None],
        kkt_factor(mod, work.y[..., :ka], work.lam), Kinv)
