"""CGMRES — constraint-satisfying flexible GMRES.

The port of the JAX package's ``solvers/cgmres.py``, which reproduces the
decisive semantics of the reference solver (reference
``solvers.py:131-323``): run plain FGMRES while far from convergence, and
once ``residual ≤ contol·tol`` (or at the final iteration) switch the
coefficient solve to an equality-constrained minimisation so the returned
iterate satisfies the problem's invariants; refuse to terminate until the
iterate both meets ``tol`` and satisfies every constraint to ``ctol``
(safety latch, reference solvers.py:262-297).  A constrained solve that
returns NaN falls back to the unconstrained coefficients for that
iteration, as the reference falls back to unconstrained SLSQP
(solvers.py:271-278).

The JAX package's ``lax.while_loop``s are host loops here.  Each step reads
its residual (and, in the endgame, the KKT's scalars) on the host: one
synchronisation per read.  The n-sized work — SpMV, orthogonalisation,
iterate assembly, constraint reduction — runs on the operands' device; the
k-sized work (Givens QR, reduced constraints, KKT) on the host.

``cgmres_p`` is the prototypical variant enforcing constraints cumulatively
(iteration j enforces the first j constraints, reference solvers.py:328-445).

A constraint is quadratic (``QuadraticConstraint``), reduced incrementally,
or general (``GeneralConstraint``, a callable), which gets a fresh
``torch.func`` Taylor model about the warm coefficients at every
constrained iteration; the safety latch then checks the true g at the
accepted coefficients (JAX ``solvers/cgmres.py:157-158``, ``:288-293``,
``:410``).

Solvers take f64 storage only; the JAX package's f32 storage path
(mixed-precision reduction, double-f32 arithmetic, invariant snap) is not
ported.
"""

from __future__ import annotations

import time
import warnings
from typing import Sequence, Union

import numpy as np
import torch

from ..config import CTOL, require_f64
from ..constraints.general import GeneralConstraint, taylor_buffers, true_value
from ..constraints.quadratic import (
    QuadraticConstraint,
    catchup_buffers,
    init_buffers,
    reduced_scale,
    reduced_value,
    update_buffers,
)
from ..precond.base import as_preconditioner
from .arnoldi import (
    arnoldi_step,
    init_state,
    iterate,
    lsq_coeffs,
    lsq_residual_estimate,
)
from .gmres import as_operand, warn_breakdown
from .kkt import constrained_lsq

_SAFETY_NONE, _SAFETY_OK, _SAFETY_BAD = 0, 1, 2

Constraint = Union[QuadraticConstraint, GeneralConstraint]


# a dual-start candidate whose roundoff scale exceeds the fallback's by this
# factor is a diverged Newton iterate, not a constrained minimiser
DIVERGED_SCALE = 1e8


def _take_fresh(warm, fresh, r_warm: float, r_fresh: float, scale_fb: float,
                ctol: float, dt: torch.dtype) -> bool:
    """The dual start's choice: whether the candidate from the fresh LSQ
    start replaces the one from the previous coefficients.  Feasible first,
    then the smaller Hessenberg residual; a NaN candidate is never taken.

    Both candidates are judged against ONE floor, built from the roundoff
    scale ``scale_fb`` of the fallback (unconstrained) coefficients, as the
    far-branch rejection builds its own, and a candidate whose scale is
    ``DIVERGED_SCALE`` times that or more is infeasible.  The JAX package
    judges each candidate against its own scale (``cgmres.py:331-337``), so
    there a diverged candidate, whose inflated scale inflates its floor past
    its deviation, counts as feasible and can displace a sane one."""
    floor = max(ctol, 32.0 * torch.finfo(dt).eps * scale_fb)
    cap = DIVERGED_SCALE * max(scale_fb, torch.finfo(dt).tiny)

    def merit(kk, r):
        nan = bool(torch.any(torch.isnan(kk.y)))
        feasible = not nan and kk.deviation <= floor and kk.scale < cap
        return (np.inf if nan else r), feasible, nan

    r_a, feas_a, _ = merit(warm, r_warm)
    r_b, feas_b, nan_b = merit(fresh, r_fresh)
    take = feas_b if feas_a != feas_b else r_b < r_a
    return take and not nan_b


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Solve:
    """The state of one CGMRES solve; ``run`` drives it to the end."""

    def __init__(self, A, b, x0, k, tol, contol, cons, pre, ctol, history,
                 prototypical, ortho):
        self.A, self.b, self.k = A, b, int(k)
        self.tol, self.contol, self.ctol = float(tol), float(contol), float(ctol)
        self.cons = tuple(cons)
        self.m = len(self.cons)
        self.general = tuple(isinstance(c, GeneralConstraint) for c in cons)
        # the quadratic constraints, whose reduction the solve keeps
        self.quad = tuple(c for c, g in zip(cons, self.general) if not g)
        self.prefunc = as_preconditioner(pre)
        self.history, self.prototypical, self.ortho = history, prototypical, ortho
        self.x0_zero = x0 is None
        self.x0 = torch.zeros_like(b) if x0 is None else x0
        self.dt = b.dtype

    # --- coefficient solves -------------------------------------------------

    def _constrained(self, st, j, yk, y_unc, bufs, safety, lamc, Kinvc, haveK):
        """The endgame at step j: returns (y, safety, deviation, kkt iters,
        fell back, multipliers, KKT inverse, warm start valid)."""
        k, m, dt = self.k, self.m, self.dt
        if m == 0:
            # no constraints: the constrained solve IS the LSQ and the latch
            # is vacuously satisfied
            return y_unc, _SAFETY_OK, 0.0, 0, 0, lamc, Kinvc, haveK
        active = torch.arange(k) <= j
        con_mask = ((torch.arange(m) < j) if self.prototypical
                    else torch.ones(m, dtype=torch.bool)).to(dt)
        kkt_tol = max(self.ctol * 0.1, 100.0 * torch.finfo(dt).eps)
        beta, H = self.beta, st.H
        # the kept reductions of the quadratic constraints, and a Taylor
        # model about the warm coefficients for each general one
        quad = iter(bufs)
        bufs = tuple(
            taylor_buffers(c, yk, st.Z, self.x0) if g else next(quad)
            for c, g in zip(self.cons, self.general))
        # multipliers and the KKT inverse are carried across gated
        # iterations; prototypical mode re-factors because its enforced set
        # changes every iteration
        kkt = constrained_lsq(
            H, beta, bufs, yk, active, con_mask, kkt_tol=kkt_tol,
            lam_ws=lamc, Kinv_ws=Kinvc,
            have_ws=False if self.prototypical else haveK,
        )
        e1 = (torch.arange(k + 1) == 0).to(dt)

        def residual(kk):
            return float(torch.linalg.norm(beta * e1 - H @ kk.y))

        if not self.prototypical:
            # the roundoff scale and deviation at the fallback
            # (unconstrained) coefficients: the dual start's one floor, and
            # the kept point's numbers if the far branch rejects the
            # constrained one
            dev_fb = float(torch.max(torch.stack(
                [torch.abs(reduced_value(bf, y_unc)) for bf in bufs]) * con_mask))
            scale_fb = float(torch.max(torch.stack(
                [reduced_scale(bf, y_unc) for bf in bufs]) * con_mask))
            # dual-start Newton: the nonconvex constraints have several
            # feasible basins and neither start dominates, so solve from the
            # fresh LSQ start too and keep the better candidate
            kkt_f = constrained_lsq(H, beta, bufs, y_unc, active, con_mask,
                                    kkt_tol=kkt_tol)
            if _take_fresh(kkt, kkt_f, residual(kkt), residual(kkt_f),
                           scale_fb, self.ctol, dt):
                kkt = kkt_f
        bad = bool(torch.any(torch.isnan(kkt.y)))
        # far-branch rejection: the Newton-KKT iteration can converge to a
        # far feasible point, one whose residual exceeds the initial one;
        # keep the unconstrained coefficients and trip the latch there, as
        # the reference's SLSQP checker does (reference solvers.py:256-284)
        res_kkt = residual(kkt)
        res_unc = lsq_residual_estimate(st, j)
        far = (not bad) and res_kkt > 0.5 * beta and res_kkt > 1e3 * res_unc
        deviation, scale = kkt.deviation, kkt.scale
        if self.prototypical:
            # no termination semantics: keep the feasible point (reference
            # cgmres_p enforces the cumulative constraints unconditionally)
            far = False
        elif far:
            # the roundoff scale must describe the KEPT point
            deviation, scale = dev_fb, scale_fb
        y = y_unc if (bad or far) else kkt.y
        # the Taylor model is exact for a quadratic g; a general g is checked
        # at the accepted coefficients
        for c, g, on in zip(self.cons, self.general, con_mask.tolist()):
            if g and on:
                deviation = max(deviation,
                                abs(float(true_value(c, y, st.Z, self.x0))))
        # NaN fallback leaves the latch untouched; success sets it; a
        # deviation above the tolerance trips it.  The tolerance is floored
        # at the evaluation-roundoff scale of the constraint
        floor = max(self.ctol, 32.0 * torch.finfo(dt).eps * scale)
        if not bad:
            safety = _SAFETY_BAD if deviation > floor else _SAFETY_OK
        return (y, safety, deviation, kkt.iters, int(bad), kkt.lam, kkt.Kinv,
                not bad and not far)

    # --- the solve ------------------------------------------------------------

    def run(self, timing: bool):
        A, b, k, m, x0 = self.A, self.b, self.k, self.m, self.x0
        dev = b.device
        t_start = time.perf_counter()
        r0 = b - A @ x0
        self.beta = beta = float(torch.linalg.norm(r0))
        st = init_state(r0, beta, k)
        bufs = tuple(init_buffers(c, x0, k, x0_zero=self.x0_zero)
                     for c in self.quad)
        res = np.full(k, np.inf)
        xs = None
        if self.history:
            xs = torch.zeros((k + 1, b.shape[0]), dtype=b.dtype, device=dev)
            xs[0] = r0

        j, x, yk, r_prev, brk = 0, x0, torch.zeros(k, dtype=self.dt), beta, False

        def step_residual(y, j):
            x = iterate(st, y, j, x0)
            r = float(torch.linalg.norm(A @ x - b))
            res[j] = r
            if self.history:
                xs[j + 1] = x
            return x, r

        # phase 1: the lean unconstrained loop, while the reference gate
        # (solvers.py:230) cannot trigger — no constraint machinery at all
        if not self.prototypical:
            while j < k - 1 and r_prev > self.contol * self.tol and not brk:
                brk = arnoldi_step(A, self.prefunc, st, j, self.ortho) == 0 or brk
                yk = lsq_coeffs(st, j)
                x, r_prev = step_residual(yk, j)
                j += 1
            j1 = j
            if timing:
                _sync(dev)
                t_phase1 = time.perf_counter()
            # one-time batched catch-up over the phase-1 basis; the loop
            # below only folds in fresh columns
            bufs = tuple(catchup_buffers(c, bf, st.Z, x0, j1,
                                         x0_zero=self.x0_zero)
                         for c, bf in zip(self.quad, bufs))
            if timing:
                _sync(dev)
                t_build = time.perf_counter()

        safety, ncon, done = _SAFETY_NONE, 0, brk
        dev_j, kkt_it, nfb = np.inf, 0, 0
        lamc = torch.zeros(m, dtype=self.dt)
        Kinvc = torch.zeros((k + m, k + m), dtype=self.dt)
        haveK = False
        while j < k and not done:
            hlast = arnoldi_step(A, self.prefunc, st, j, self.ortho)
            brk_now = hlast == 0
            y_unc = lsq_coeffs(st, j)
            if self.prototypical:
                gate = True
            else:
                # reference gating (solvers.py:230): unconstrained only while
                # residual > contol·tol, not at the last iteration, and the
                # safety latch untouched
                gate = not (r_prev > self.contol * self.tol and j < k - 1
                            and safety == _SAFETY_NONE)
            if gate:
                bufs = tuple(update_buffers(c, bf, st.Z, x0, j,
                                            x0_zero=self.x0_zero)
                             for c, bf in zip(self.quad, bufs))
                (y, safety, dev_j, kit, fb, lamc, Kinvc,
                 haveK) = self._constrained(st, j, yk, y_unc, bufs, safety,
                                            lamc, Kinvc, haveK)
                kkt_it += kit
                nfb += fb
                ncon += 1
            else:
                y, dev_j = y_unc, np.inf
            x, r_prev = step_residual(y, j)
            yk = y
            if self.prototypical:
                done = brk_now
            else:
                done = (r_prev < self.tol and safety == _SAFETY_OK) or brk_now
            brk = brk or brk_now
            j += 1
        _sync(dev)
        t_end = time.perf_counter()

        info = self._info(j, ncon, safety, dev_j, brk, kkt_it, nfb, res, xs)
        if timing:
            nunc = max(j - ncon, 0)
            p1 = t_phase1 - t_start
            info["timings"] = {
                "constrained_steps": ncon,
                "unconstrained_steps": nunc,
                "runtime": t_end - t_start,
                "iter_time_unconstrained": np.nan if j1 == 0 else p1 / j1,
                "iter_time_constrained": np.nan if ncon == 0
                else (t_end - t_build) / ncon,
                "constraint_building": t_build - t_phase1,
                "phase1_steps_measured": j1,
                "method": "measured: host clock around phase 1, the "
                          "constraint catch-up and the endgame loop, with a "
                          "device synchronisation at each boundary",
            }
        else:
            info["timings"] = None
        return x, info

    def _info(self, steps, ncon, safety, dev_j, brk, kkt_it, nfb, res, xs):
        # host-side warnings mirroring the reference's UX
        # (solvers.py:104-106, 267-273)
        if brk:
            warn_breakdown()
        if nfb > 0:
            warnings.warn(
                f"Constrained solve failed on {nfb} iteration(s), defaulted "
                "to standard solve. Problem likely overconstrained, a smaller "
                "solver tolerance may be required."
            )
        if safety == _SAFETY_BAD and not self.prototypical:
            warnings.warn(
                f"Constrained solve failed to preserve constraints (deviation "
                f"{dev_j:.3e}); problem likely overconstrained — a smaller "
                "solver tolerance may be required.",
                RuntimeWarning,
            )
        info = {
            "name": "geosolve" if self.prototypical else "cgmres",
            "res": res[:steps],
            "steps": steps,
            "constrained_steps": ncon,
            "safety": {0: None, 1: True, 2: False}[safety],
            "deviation": float(dev_j),
            "breakdown": brk,
            "kkt_iters": kkt_it,
            "fallbacks": nfb,
        }
        if self.history:
            info["x"] = xs[: steps + 1]
        return info


def _run(A, b, x0, k, tol, contol, constraints, pre, ctol, history, timing,
         prototypical, ortho="cgs2"):
    require_f64(b)
    x0 = as_operand(x0, b)
    if timing and prototypical:
        raise NotImplementedError("timing is measured for cgmres only")
    solve = _Solve(A, b, x0, k, tol, contol, constraints, pre, ctol, history,
                   prototypical, ortho)
    return solve.run(bool(timing))


def cgmres(
    A,
    b: torch.Tensor,
    x0=None,
    k: int = 30,
    tol: float = 1e-8,
    contol: float = 10.0,
    constraints: Sequence[Constraint] = (),
    pre=None,
    ctol: float = CTOL,
    history: bool = False,
    timing: bool = False,
    ortho: str = "cgs2",
):
    """Constraint-satisfying FGMRES; returns ``(x, info)``.

    Matches the reference output contract (solvers.py:316-322): ``info`` has
    ``name='cgmres'``, per-iteration true residuals ``res``, ``steps``, and a
    ``timings`` entry when ``timing=True`` — plus ``deviation``, ``safety``,
    ``constrained_steps``, ``kkt_iters`` and ``fallbacks``.  ``ortho`` is
    the Arnoldi orthogonalisation (``arnoldi_step``).
    """
    return _run(A, b, x0, k, tol, contol, constraints, pre, ctol, history,
                timing, prototypical=False, ortho=ortho)


def cgmres_p(
    A,
    b: torch.Tensor,
    x0=None,
    k: int = 20,
    constraints: Sequence[Constraint] = (),
    pre=None,
    ctol: float = CTOL,
    history: bool = False,
    ortho: str = "cgs2",
):
    """Prototypical CGMRES: fixed ``k`` iterations, constraints enforced
    cumulatively (iteration j enforces the first j), no stopping tolerance
    (reference solvers.py:328-445; info name 'geosolve')."""
    return _run(A, b, x0, k, tol=0.0, contol=0.0, constraints=constraints,
                pre=pre, ctol=ctol, history=history, timing=False,
                prototypical=True, ortho=ortho)
