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

Masking: coefficients beyond the active Arnoldi prefix and constraints not
yet enforced (the prototypical solver enforces them one by one, reference
``solvers.py:413``) are pinned via unit diagonal rows, so every solve has
the same shape.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

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
) -> KKTResult:
    """Modified-Newton SQP on the KKT conditions.

    The KKT matrix is inverted once and kept frozen: every Newton step is
    then two matvecs plus one batched Armijo search over 14 step lengths.
    When the search cannot decrease ‖r‖² fast enough the matrix is
    re-factored at the current point (up to ``max_refacts`` times) before
    giving up.  ``lam_ws``/``Kinv_ws``/``have_ws`` let the caller carry the
    multipliers and the factorisation across gated CGMRES iterations.
    """
    k = H.shape[1]
    m = len(bufs)
    dt = H.dtype
    act = active.to(dt)
    alphas = torch.as_tensor(_ALPHAS, dtype=dt)

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
        D = torch.diag(1.0 - con_mask)  # pin multipliers of unenforced constraints
        K = torch.cat([torch.cat([W, Jm.T], dim=1), torch.cat([Jm, D], dim=1)])
        return torch.linalg.inv_ex(K).inverse

    eps = torch.finfo(dt).eps

    def floor_at(y):
        scales = torch.stack([reduced_scale(b, y) for b in bufs]) * con_mask
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
    S = Jm0 @ Jm0.T + torch.diag(1.0 - con_mask)
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
    g, _ = _constraint_eval(bufs, y, con_mask)
    scales = torch.stack([reduced_scale(b, y) for b in bufs]) * con_mask
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
