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

Two loops drive the solve (``cgmres(..., loop=...)``):

* ``"host"`` (the default): the JAX package's ``lax.while_loop``s are host
  loops.  Each step reads its residual (and, in the endgame, the KKT's
  scalars) on the host: one synchronisation per read.  The n-sized work —
  SpMV, orthogonalisation, iterate assembly, constraint reduction — runs on
  the operands' device; the k-sized work (Givens QR, reduced constraints,
  KKT) on the host.
* ``"while"``: the device core (``DeviceCore``), the counterpart of the JAX
  package's ``_build_core`` (``cgmres.py:147`` there).  All state, the
  k-sized too, lives in fixed-shape tensors on the operands' device; each
  step is a function of static shapes with no host read, captured as a
  CUDA graph on the card and replayed (``solvers/graphs.py``), run eagerly
  on the CPU.  The host loop over the steps replays one graph and reads
  two flags (the next step's gate and ``done``) per step; a gated step
  replays the endgame's graphs, one Newton iteration each, with a flag read
  after each.  Quadratic and general constraints, and ``history``, as the
  JAX core takes them.  The same core carries a batch of solves on a
  leading axis (``experiments/batched.py::cgmres_many``, the JAX package's
  vmapped core, quadratic constraints only); a single solve is its batch
  of one.

``cgmres_p`` is the prototypical variant enforcing constraints cumulatively
(iteration j enforces the first j constraints, reference solvers.py:328-445).

A constraint is quadratic (``QuadraticConstraint``), reduced incrementally,
or general (``GeneralConstraint``, a callable), which gets a fresh
``torch.func`` Taylor model about the warm coefficients at every
constrained iteration; the safety latch then checks the true g at the
accepted coefficients (JAX ``solvers/cgmres.py:157-158``, ``:288-293``,
``:410``).

Storage is f64 (the default) or f32, the JAX package's TPU mode
(``resolve_modes``, JAX ``cgmres.py:567-627``): with f32 vectors and basis
the constraint reduction, the KKT endgame and the latch run in f64
(``mixed``, the k-sized ``cdtype``); the in-loop reduction is the f64 one
(f32 loads, f64 products and sums: where the JAX package computes in
double-f32 pairs) or, from a zero start, the plain f32 one (``f32_reduce``,
the snap-first mode, whose latch floor is eps32's); and the returned
iterate is projected onto the invariants (``snap``,
``constraints/projection.py``) where the latch is OK, its ``deviation``
then the certified f64 value at the returned x.  From a given start with
the projection (``floor_eps``), the endgame's floors are eps32's and that
certificate, against ``certified_floor``, sets the latch.  With f64
storage all three resolve off and nothing changes.

Both loops take row-sharded operands (``parallel/``): the solver finds the
mesh on A, every n-length reduction is all-reduced over it
(``parallel/comm.py``), and the host's flags, tolerance tests and latch,
all derived from all-reduced values, take the same branch on every rank.
The device core's graphs capture the collectives: one all-reduce runs on
the capture stream before the first capture (``_first_use``), which
creates the communicator.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import time
import warnings
from typing import NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import CTOL, cdtype, check_storage
from ..constraints.general import (
    GeneralConstraint,
    taylor_buffers,
    taylor_model,
    true_value,
)
from ..constraints.projection import (
    certified_floor,
    snap as snap_iterate,
    snap_supported,
)
from ..constraints.quadratic import (
    QuadraticConstraint,
    catch_up,
    catchup_buffers,
    device_buffers,
    fold_column,
    init_buffers,
    reduced_scale,
    reduced_value,
    update_buffers,
    value_and_scale_rows,
    value_scale,
)
from ..ops.sparse import matvec_f64
from ..ops.rows import basis_mv as rows_mv, basis_rmv as rows_rmv, rows
from ..parallel.comm import mesh_of, pnorm, psum
from ..precond.base import as_preconditioner
from .arnoldi import (
    arnoldi_step,
    arnoldi_step_masked,
    device_state,
    init_state,
    iterate,
    lsq_coeffs,
    lsq_coeffs_device,
    lsq_residual_estimate,
    start,
)
from .gmres import as_operand, warn_breakdown
from .graphs import GraphRunner
from .kkt import (
    constrained_lsq,
    kkt_model,
    kkt_refactor,
    kkt_scale,
    kkt_start,
    kkt_step,
    kkt_values,
    kkt_work,
    pins,
)

_SAFETY_NONE, _SAFETY_OK, _SAFETY_BAD = 0, 1, 2

Constraint = Union[QuadraticConstraint, GeneralConstraint]


# a dual-start candidate whose roundoff scale exceeds the fallback's by this
# factor is a diverged Newton iterate, not a constrained minimiser
DIVERGED_SCALE = 1e8


def _take_fresh(warm, fresh, r_warm: float, r_fresh: float, scale_fb: float,
                ctol: float, dt: torch.dtype, eps: float = None) -> bool:
    """The dual start's choice: whether the candidate from the fresh LSQ
    start replaces the one from the previous coefficients.  Feasible first,
    then the smaller Hessenberg residual; a NaN candidate is never taken.

    Both candidates are judged against ONE floor, built from the roundoff
    scale ``scale_fb`` of the fallback (unconstrained) coefficients, as the
    far-branch rejection builds its own, and a candidate whose scale is
    ``DIVERGED_SCALE`` times that or more is infeasible.  The JAX package
    judges each candidate against its own scale (``cgmres.py:331-337``), so
    there a diverged candidate, whose inflated scale inflates its floor past
    its deviation, counts as feasible and can displace a sane one.
    ``eps``: the floor's (None: ``dt``'s; ``floor_eps``)."""
    eps = torch.finfo(dt).eps if eps is None else eps
    floor = max(ctol, 32.0 * eps * scale_fb)
    cap = DIVERGED_SCALE * max(scale_fb, torch.finfo(dt).tiny)

    def merit(kk, r):
        nan = bool(torch.any(torch.isnan(kk.y)))
        feasible = not nan and kk.deviation <= floor and kk.scale < cap
        return (np.inf if nan else r), feasible, nan

    r_a, feas_a, _ = merit(warm, r_warm)
    r_b, feas_b, nan_b = merit(fresh, r_fresh)
    take = feas_b if feas_a != feas_b else r_b < r_a
    return take and not nan_b


def resolve_modes(dt: torch.dtype, cons, mixed=None, snap=None,
                  f32_reduce=None, prototypical: bool = False):
    """The f32 storage modes of a solve as the JAX package's ``_run``
    resolves them (``cgmres.py:567-627`` there): ``(mixed, snap,
    f32_reduce)``.

    * ``mixed`` (default: storage f32): the k-sized constraint and KKT state
      in f64 (``config.cdtype``);
    * ``snap`` (default: f32 storage, not prototypical, and every constraint
      quadratic with an f64 product, ``snap_supported``): project the
      returned iterate onto the invariants.  An explicit ``snap=True`` with
      a general constraint, or one ``matvec_f64`` does not take, raises
      ``ValueError`` naming it;
    * ``f32_reduce`` (default: mixed and snap): the in-loop reduction in
      plain f32 (the snap-first mode); it applies from a zero start only
      (the caller's ``x0 is None``).

    With f64 storage all three are off.  A general constraint over f32
    storage resolves to mixed with the projection off, as in the JAX
    package: no f64 evaluation certifies a callable, so its Taylor model
    (``constraints/general.py``) is held in f64 and the latch checks the
    true g at the accepted coefficients."""
    cons = tuple(cons)
    f32 = dt == torch.float32
    general = [c.name for c in cons if isinstance(c, GeneralConstraint)]
    if snap:
        if general:
            raise ValueError(
                f"snap=True requires quadratic constraints; {general[0]!r} "
                "is a general (callable) constraint")
        bad = [c.name for c in cons if not snap_supported((c,))]
        if bad:
            raise ValueError(
                f"snap=True but constraint operator(s) {bad} have no f64 "
                "product (constraints/projection.py::snap_supported)")
    mixed = f32 if mixed is None else bool(mixed) and f32
    if snap is None:
        snap = (f32 and not prototypical and len(cons) > 0 and not general
                and snap_supported(cons))
    snap = bool(snap) and f32
    if f32_reduce is None:
        f32_reduce = mixed and snap
    return mixed, snap, bool(f32_reduce) and mixed and snap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def floor_eps(cd: torch.dtype, f32r: bool,
              warm32: bool) -> Tuple[float, float]:
    """The eps of the endgame's roundoff floors (32·eps·scale): the Newton's
    entry floor, the pins and the dual start's, then the latch's.  cdtype's
    with f64 storage and from a zero start; under the f32 reduction
    (``f32r``, zero starts only) the JAX package's (the latch at eps32, the
    rest at cdtype's: ``cgmres.py:426-428`` there); and, the port's, every
    one at eps32 over f32 storage with the projection from a given start
    (``warm32``): an f32 Krylov basis carries the invariants to f32 roundoff
    only (a warm start's vectors leak swe's mass at eps32), so no
    coefficients meet an f64 floor there.  The latch then says only that
    the reduced problem was solved to f32 roundoff: the solve judges the
    returned iterate after the projection instead, by its f64 certificate
    (``constraints/projection.py::certified_floor``)."""
    e32, e = torch.finfo(torch.float32).eps, torch.finfo(cd).eps
    return (e32 if warm32 else e), (e32 if warm32 or f32r else e)


class _Solve:
    """The state of one CGMRES solve; ``run`` drives it to the end."""

    def __init__(self, A, b, x0, k, tol, contol, cons, pre, ctol, history,
                 prototypical, ortho, modes=(False, False, False)):
        self.A, self.b, self.k = A, b, int(k)
        self.mesh = mesh_of(A)
        self.tol, self.contol, self.ctol = float(tol), float(contol), float(ctol)
        self.cons = tuple(cons)
        self.m = len(self.cons)
        self.general = tuple(isinstance(c, GeneralConstraint) for c in cons)
        # the quadratic constraints, whose reduction the solve keeps
        self.quad = tuple(c for c, g in zip(cons, self.general) if not g)
        # the linear ones, which the endgame may pin (``pins``)
        self.linear = torch.tensor([not g and c.M is None
                                    for c, g in zip(cons, self.general)])
        self.prefunc = as_preconditioner(pre)
        self.history, self.prototypical, self.ortho = history, prototypical, ortho
        self.x0_zero = x0 is None
        self.x0 = torch.zeros_like(b) if x0 is None else x0
        self.dt = b.dtype
        mixed, self.snap, f32_reduce = modes
        # the k-sized constraint and KKT state's dtype; the f32 reduction
        # from a zero start only; else, with f32 storage, the f64 one
        self.cd = cdtype(self.dt, mixed)
        self.f32r = f32_reduce and self.x0_zero
        self.f64 = self.dt == torch.float32 and mixed and not self.f32r
        self.f64_value = self.dt == torch.float32 and mixed
        self.warm32 = (self.dt == torch.float32 and self.snap
                       and not self.x0_zero)
        self.kkt_eps, self.latch_eps = floor_eps(self.cd, self.f32r,
                                                 self.warm32)

    # --- coefficient solves -------------------------------------------------

    def _constrained(self, st, j, yk, y_unc, bufs, safety, lamc, Kinvc, haveK):
        """The endgame at step j: returns (y, safety, deviation, kkt iters,
        fell back, multipliers, KKT inverse, warm start valid)."""
        k, m, dt, cd = self.k, self.m, self.dt, self.cd
        if m == 0:
            # no constraints: the constrained solve IS the LSQ and the latch
            # is vacuously satisfied
            return y_unc, _SAFETY_OK, 0.0, 0, 0, lamc, Kinvc, haveK
        active = torch.arange(k) <= j
        con_mask = ((torch.arange(m) < j) if self.prototypical
                    else torch.ones(m, dtype=torch.bool)).to(cd)
        kkt_tol = max(self.ctol * 0.1, 100.0 * torch.finfo(cd).eps)
        # the KKT in cdtype: f64 over f32 storage (JAX cgmres.py:285)
        beta, H = self.beta, st.H.to(cd)
        yk, y_unc = yk.to(cd), y_unc.to(cd)
        # the kept reductions of the quadratic constraints, and a Taylor
        # model about the warm coefficients for each general one
        quad = iter(bufs)
        bufs = tuple(
            taylor_buffers(c, yk, st.Z, self.x0, cd) if g else next(quad)
            for c, g in zip(self.cons, self.general))
        # the roundoff scales at x0 of the quadratic constraints (|t0| for
        # a general one's Taylor model), and the pins of the device core's
        # kkt_start, from both starts: a linear constraint that every
        # iterate satisfies leaves the Newton
        s0 = iter(self.s0)
        s0 = [None if g else next(s0) for g in self.general]
        pin = None
        if not self.prototypical:
            pin = pins(bufs, s0, self.linear, torch.stack([yk, y_unc]),
                       con_mask, kkt_tol, eps=self.kkt_eps)
        # multipliers and the KKT inverse are carried across gated
        # iterations; prototypical mode re-factors because its enforced set
        # changes every iteration
        kkt = constrained_lsq(
            H, beta, bufs, yk, active, con_mask, kkt_tol=kkt_tol,
            eps=self.kkt_eps,
            lam_ws=lamc, Kinv_ws=Kinvc,
            have_ws=False if self.prototypical else haveK, pin=pin, s0=s0,
        )
        e1 = (torch.arange(k + 1) == 0).to(cd)

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
                [reduced_scale(bf, y_unc, s) for bf, s in zip(bufs, s0)])
                * con_mask))
            # dual-start Newton: the nonconvex constraints have several
            # feasible basins and neither start dominates, so solve from the
            # fresh LSQ start too and keep the better candidate
            kkt_f = constrained_lsq(H, beta, bufs, y_unc, active, con_mask,
                                    kkt_tol=kkt_tol, pin=pin, s0=s0,
                                    eps=self.kkt_eps)
            if _take_fresh(kkt, kkt_f, residual(kkt), residual(kkt_f),
                           scale_fb, self.ctol, cd, eps=self.kkt_eps):
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
        y = (y_unc if (bad or far) else kkt.y).to(dt)
        # the Taylor model is exact for a quadratic g; a general g is checked
        # at the accepted coefficients
        for c, g, on in zip(self.cons, self.general, con_mask.tolist()):
            if g and on:
                deviation = max(deviation,
                                abs(float(true_value(c, y, st.Z, self.x0))))
        # NaN fallback leaves the latch untouched; success sets it; a
        # deviation above the tolerance trips it.  The tolerance is floored
        # at the evaluation-roundoff scale of the constraint (``floor_eps``)
        floor = max(self.ctol, 32.0 * self.latch_eps * scale)
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
        self.beta = beta = float(pnorm(r0, self.mesh))
        st = init_state(r0, beta, k)
        bufs = tuple(init_buffers(c, x0, k, x0_zero=self.x0_zero,
                                  cdtype=self.cd, f64_value=self.f64_value)
                     for c in self.quad)
        self.s0 = [value_scale(c, x0, x0_zero=self.x0_zero, cdtype=self.cd,
                               f64_value=self.f64_value) for c in self.quad]
        res = np.full(k, np.inf)
        xs = None
        if self.history:
            xs = torch.zeros((k + 1, b.shape[0]), dtype=b.dtype, device=dev)
            xs[0] = r0

        j, x, yk, r_prev, brk = 0, x0, torch.zeros(k, dtype=self.dt), beta, False

        def step_residual(y, j):
            x = iterate(st, y, j, x0)
            r = float(pnorm(A @ x - b, self.mesh))
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
                                         x0_zero=self.x0_zero, f64=self.f64)
                         for c, bf in zip(self.quad, bufs))
            if timing:
                _sync(dev)
                t_build = time.perf_counter()

        safety, ncon, done = _SAFETY_NONE, 0, brk
        dev_j, kkt_it, nfb = np.inf, 0, 0
        lamc = torch.zeros(m, dtype=self.cd)
        Kinvc = torch.zeros((k + m, k + m), dtype=self.cd)
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
                                            x0_zero=self.x0_zero, f64=self.f64)
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
        t_snap = 0.0
        if self.snap and m > 0 and safety == _SAFETY_OK:
            # the projection epilogue (JAX cgmres.py:544-560): the returned
            # iterate onto the invariants, its deviation the certified f64
            # value there
            _sync(dev)
            t_snap = time.perf_counter()
            x, g = snap_iterate(x, self.quad)
            dev_j = float(g.abs().max())
            if self.warm32:
                # the latch's floors were eps32's: the certificate decides
                held = g.abs() <= certified_floor(self.quad, x, self.ctol)
                safety = _SAFETY_OK if bool(held.all()) else _SAFETY_BAD
            t_snap = time.perf_counter() - t_snap
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
            if self.snap:
                # the projection epilogue's wall (f32 storage)
                info["timings"]["time_snap"] = t_snap
        else:
            info["timings"] = None
        return x, info

    def _info(self, steps, ncon, safety, dev_j, brk, kkt_it, nfb, res, xs):
        info = _info(self.prototypical, steps, ncon, safety, dev_j, brk,
                     kkt_it, nfb, res)
        if self.history:
            info["x"] = xs[: steps + 1]
        return info


def _info(prototypical, steps, ncon, safety, dev_j, brk, kkt_it, nfb, res):
    """The info dict of a solve, and the host-side warnings mirroring the
    reference's UX (solvers.py:104-106, 267-273)."""
    if brk:
        warn_breakdown()
    if nfb > 0:
        warnings.warn(
            f"Constrained solve failed on {nfb} iteration(s), defaulted "
            "to standard solve. Problem likely overconstrained, a smaller "
            "solver tolerance may be required."
        )
    if safety == _SAFETY_BAD and not prototypical:
        warnings.warn(
            f"Constrained solve failed to preserve constraints (deviation "
            f"{dev_j:.3e}); problem likely overconstrained — a smaller "
            "solver tolerance may be required.",
            RuntimeWarning,
        )
    return {
        "name": "geosolve" if prototypical else "cgmres",
        "res": res[:steps],
        "steps": steps,
        "constrained_steps": ncon,
        "safety": {0: None, 1: True, 2: False}[safety],
        "deviation": float(dev_j),
        "breakdown": brk,
        "kkt_iters": kkt_it,
        "fallbacks": nfb,
    }


# --- the device core -----------------------------------------------------------


class CgmresResult(NamedTuple):
    """The device core's result, as device tensors (the JAX package's
    ``CgmresResult``, whose ``xs`` stays in the core's ``xs`` buffer, kept
    with ``history``)."""

    x: torch.Tensor
    res: torch.Tensor
    steps: torch.Tensor
    constrained_steps: torch.Tensor
    safety: torch.Tensor
    deviation: torch.Tensor
    breakdown: torch.Tensor
    kkt_iters: torch.Tensor
    fallbacks: torch.Tensor


class DeviceCore:
    """CGMRES as fixed-shape steps on the operands' device: the counterpart
    of the JAX package's ``_build_core`` (``cgmres.py:147-470`` there, its
    ``loop="while"`` form with the true residual each step), for one solve
    or for a batch of B solves that share A, the preconditioner and the
    constraints' operators M (the JAX package's core under ``jax.vmap``,
    ``experiments/batched.py::cgmres_many``).

    A constraint is quadratic, whose reduction the core keeps in its
    buffers (folded in a column a step), or, for a single solve, general
    (``GeneralConstraint``), as the JAX core's ``kinds``: ``kkt_start``
    writes a fresh Taylor model about the warm coefficients into its
    buffers, which both starts of the dual start share, and ``kkt_finish``
    re-checks the true g at the accepted coefficients and keeps the larger
    deviation (JAX ``cgmres.py:278-296``, ``:410-420``).  ``history``
    (single solve) keeps the JAX core's ``xs``: r0, then each step's
    iterate.

    Everything a solve reads or writes is a tensor allocated here, on the
    device of ``like`` (its *static buffers*), with a leading axis of B: the
    inputs ``b``, ``x0`` and each constraint's ``c`` and ``v`` (``load``
    copies them in), the Arnoldi state, the reduced constraints, the KKT's
    carried multipliers and inverse, the latch and the counts.  Each step
    below is a Python function of a static Arnoldi index j that reads and
    writes only those, with no host read, every write masked per solve;
    ``runner`` runs it (captured and replayed on the card, eagerly on the
    CPU).  ``solve`` drives the steps from the flags they write:

    * ``init``: r0, β, the state and the buffers' t0; the gates of step 0;
    * ``arnoldi`` j: the Arnoldi step and the LSQ coefficients;
    * ``advance`` j, for the solves whose gate is shut: the iterate from the
      LSQ coefficients, its true residual, ``done``, the next gate;
    * for the solves whose gate is open: ``catchup`` j for those whose gate
      opened at j (the reduction over the basis so far, the JAX package's
      catch-up after its phase 1), then ``kkt_start`` j (column j folded
      into the buffers; the dual start, warm and fresh, as a batch of two
      starts a solve), ``kkt_step`` j while a start goes on, ``kkt_refactor``
      j where one asks, and ``kkt_finish`` j: the choice between the starts
      (the port's dual-start merit, ``_take_fresh``), the far-branch
      rejection, the latch, and the iterate as in ``advance``.

    The solves of a batch run in lockstep: j is shared, so the active
    prefix stays a Python constant, and a solve that is done, or whose gate
    is the other one, is masked out of a step.  So each solve takes the
    steps its single solve takes (the JAX package's vmapped ``lax.cond``s
    become these masks, and its ``while_loop`` runs until every solve is
    done).  The host reads the B gates and the B ``done`` flags once a step
    (``flags``, [gates, dones]).  The n-sized products take the (n, B)
    block of the solves' vectors (``ops/rows.py``): ``A @ X`` through the
    batched kernel #1 on a DIA; a single solve (B = 1) runs them on its
    vector, as before the batch axis.

    ``like`` is a vector (n,) for a single solve, whose inputs and results
    have no batch axis, or a block (B, n) for a batch.

    The dual-start merit keeps the port's repair (``_take_fresh``,
    ``DIVERGED_SCALE``): both candidates are judged against the floor of
    the fallback point.

    Two repairs of a warm start (x0 ≠ 0) are the port's, not the JAX
    package's: the floor takes the roundoff scale of each constraint's value
    at x0 (``value_and_scale``; |t0| is a cancellation there), and
    ``kkt_start`` pins a linear constraint that every iterate satisfies
    (swe's mass, whose Krylov vectors carry none), so the KKT matrix stays
    regular.  From x0 = 0 neither changes a bit.

    With f32 storage (``like`` f32) the core takes the modes of
    ``resolve_modes``: the reduced buffers, the KKT's state and work, the
    roundoff scales and the deviations in ``cdtype`` (f64 when ``mixed``),
    the reduction in f64 or, from a zero start with ``f32_reduce``, in f32,
    and, with ``snap``, one more step after the loop, ``snap``: the
    projection of each solve's iterate whose latch is OK, its deviation the
    certified value there (a CUDA graph of its own on the card)."""

    def __init__(self, A, pre, k: int, constraints, *, like: torch.Tensor,
                 tol: float, contol: float = 10.0, ctol: float = CTOL,
                 ortho: str = "cgs2", x0_zero: bool = False,
                 history: bool = False, runner: GraphRunner = None,
                 mixed: bool = False, snap: bool = False,
                 f32_reduce: bool = False):
        cons = tuple(constraints)
        check_storage(like)
        self.batched = like.dim() == 2
        B = like.shape[0] if self.batched else 1
        # each constraint's kind, as the JAX core's ``kinds``
        self.general = tuple(isinstance(c, GeneralConstraint) for c in cons)
        if B > 1 and ortho not in ("cgs2", "cgs2_xla"):
            raise NotImplementedError(
                f"ortho={ortho!r} under a batch: the batched core runs "
                "'cgs2', as the JAX package's cgmres_many builds its core")
        if B > 1 and (any(self.general) or history):
            raise NotImplementedError(
                "a general constraint or history under a batch: the JAX "
                "package's cgmres_many builds its core with quadratic "
                "constraints only (kinds ('q',) * m) and without history")
        self.A, self.pre, self.prefunc = A, pre, as_preconditioner(pre)
        self.mesh = mesh_of(A)
        if self.mesh is not None and any(self.general):
            raise NotImplementedError(
                "a GeneralConstraint under a mesh: the JAX package's "
                "shard_constraint builds QuadraticConstraints only")
        self.B, self.k, self.m = B, int(k), len(cons)
        self.tol, self.contol, self.ctol = float(tol), float(contol), float(ctol)
        self.ortho, self.x0_zero = ortho, bool(x0_zero)
        self.runner = GraphRunner(like.device) if runner is None else runner
        n, dt, k, m = like.shape[-1], like.dtype, self.k, self.m
        # the k-sized constraint and KKT state's dtype; the reduction's
        # arithmetic (as the host loop's ``_Solve``)
        self.cd = cd = cdtype(dt, mixed)
        self.snap = bool(snap) and m > 0
        self.f32r = bool(f32_reduce) and self.x0_zero
        self.f64 = dt == torch.float32 and mixed and not self.f32r
        self.f64_value = dt == torch.float32 and mixed
        self.warm32 = dt == torch.float32 and self.snap and not self.x0_zero
        self.kkt_eps, self.latch_eps = floor_eps(cd, self.f32r, self.warm32)
        self.kkt_tol = max(self.ctol * 0.1, 100.0 * torch.finfo(cd).eps)

        def z(*shape, dtype=dt):
            return torch.zeros((B, *shape), dtype=dtype, device=like.device)

        self.b, self.x0 = z(n), z(n)
        # a quadratic constraint's c and v are loaded into static buffers; a
        # general one is its function, which the steps call.  Over f32
        # storage c is held in f64: a target the models sum in f64 from an
        # f32 state (``constraints/quadratic.py::target_dot``) keeps its bits
        cdt = torch.float64 if dt == torch.float32 else dt
        self.cons = tuple(
            c if g else QuadraticConstraint(
                M=c.M, v=None if c.v is None else z(n), c=z(dtype=cdt),
                name=c.name, mesh=c.mesh)
            for c, g in zip(cons, self.general))
        self.st = device_state(n, k, dt, like.device, B)
        self.bufs = tuple(device_buffers(k, like, B, dtype=cd) for _ in cons)
        self.x, self.yk, self.y_unc, self.res = z(n), z(k), z(k), z(k)
        self.xs = z(k + 1, n) if history else None
        self.beta, self.r_prev, self.dev = z(), z(), z(dtype=cd)
        (self.safety, self.steps, self.ncon, self.kkt_it,
         self.nfb) = (z(dtype=torch.long) for _ in range(5))
        # the gate of the running step; whether a solve has entered its
        # endgame (its catch-up is done)
        (self.done, self.brk, self.brk_now, self.haveK, self.gate,
         self.started) = (z(dtype=torch.bool) for _ in range(6))
        # the roundoff scale of each constraint's value at x0
        self.lamc, self.Kinvc, self.s0 = (z(m, dtype=cd),
                                          z(m + k, m + k, dtype=cd),
                                          z(m, dtype=cd))
        # [the gates of the next step, done], B each; [a KKT start goes on,
        # a start asks for a re-factorisation], over the batch
        self.flags = torch.zeros(2 * B, dtype=torch.long, device=like.device)
        self.kflags = torch.zeros(2, dtype=torch.long, device=like.device)
        self.work = (kkt_work(B, 2, k, m, torch.empty(0, dtype=cd,
                                                      device=like.device))
                     if m else None)
        self.linear = torch.tensor(
            [not g and c.M is None for c, g in zip(cons, self.general)],
            dtype=torch.bool, device=like.device)
        self.runner.warmup(self._first_use)

    def _first_use(self):
        """What the steps do the first time they meet the card, on scratch
        tensors: the kernel builds and loads, each DIA's live plan and
        resolved launch (the AMG's levels and smoothers among them: one
        preconditioner apply on the core's block), the polynomial kernels'
        plans and shared-memory attribute, the cuBLAS handles on the
        capture stream, and the fused CGS2 kernel's scratch (its blocks'
        partials and ticket counter, allocated once a device and dtype) and
        shared-memory attribute at every basis size; and one Taylor model of each general constraint, which
        builds the transposes, plans and launches its derivatives take.
        Under a mesh, first one all-reduce, which creates the collectives'
        communicator on this stream: a communicator is not created inside a
        capture."""
        V = torch.ones_like(self.b)
        psum(V.new_ones(1), self.mesh)
        rows(self.A.__matmul__, rows(self.prefunc, V))
        for c, g in zip(self.cons, self.general):
            if g:
                Z = torch.ones((2, V.shape[1]), dtype=V.dtype, device=V.device)
                taylor_model(c, Z[:, 0], Z, V[0])
            elif c.M is not None:
                rows(c.M.__matmul__, V)
                c.M @ torch.ones((V.shape[1], 2), dtype=V.dtype, device=V.device)
                if self.f64_value:
                    # the f64 products of the reduction and the projection
                    # (the mixed kernel #1 for a DIA)
                    matvec_f64(c.M, V[0])
        basis = torch.ones((self.B, 2, V.shape[1]), dtype=V.dtype,
                           device=V.device)
        pnorm(rows_rmv(psum(rows_mv(basis, V), self.mesh), basis), self.mesh)
        if self.ortho == "cgs2_fused":
            from ..kernels.ortho import fused_update_matvec

            Q = torch.ones((self.k + 1, 256), dtype=V.dtype, device=V.device)
            for nrows in range(1, self.k + 2):
                fused_update_matvec(Q[:nrows], Q[0], Q[:nrows, 0].contiguous())

    # --- inputs and results -----------------------------------------------------

    def load(self, b: torch.Tensor, x0, constraints) -> None:
        """Copy the solves' inputs into the static buffers: b, x0 (None:
        zero, as the core was built for), each constraint's c and v, with a
        leading batch axis where the core has one (a field of a batch's
        constraints may be shared, without it: ``batch_constraints``).  The
        constraints must have the core's operators M, and its general
        constraints be the ones it was built for."""
        cons = tuple(constraints)
        if len(cons) != self.m or any(
                _con_key(c) != _con_key(mine)
                for c, mine in zip(cons, self.cons)):
            raise ValueError("these constraints are not the ones the core "
                             "was built for")
        if (x0 is None) != self.x0_zero:
            raise ValueError("x0 given to a core built for x0=None, or the "
                             "other way round")
        self.b.copy_(b)
        if x0 is not None:
            self.x0.copy_(x0)
        for c, mine, g in zip(cons, self.cons, self.general):
            if g:
                continue
            mine.c.copy_(c.c)
            if mine.v is not None:
                mine.v.copy_(c.v)

    def result(self) -> CgmresResult:
        """Copies of the last solve's results (the static buffers are
        overwritten by the next solve), without the batch axis for a core
        built for one solve."""
        out = CgmresResult(
            x=self.x.clone(), res=self.res.clone(), steps=self.steps.clone(),
            constrained_steps=self.ncon.clone(), safety=self.safety.clone(),
            deviation=self.dev.clone(), breakdown=self.brk.clone(),
            kkt_iters=self.kkt_it.clone(), fallbacks=self.nfb.clone())
        return out if self.batched else CgmresResult(*(t[0] for t in out))

    # --- the host loop -------------------------------------------------------

    def _read_flags(self):
        vals = self.runner.read(self.flags)
        return vals[: self.B], vals[self.B:]

    def solve(self) -> dict:
        """Run the solves on the loaded inputs; returns the host's timings:
        ``runtime`` (wall, captures left out), ``time_capture``, the phase-1
        steps and wall (until the first gate opens), the first catch-up's
        and the rest's walls, and the steps with an endgame.  The results
        stay in the static buffers (``result``)."""
        R, k, B = self.runner, self.k, self.B
        cap0 = R.time_capture
        t_start = time.perf_counter()
        R.run("init", self._init)
        gate, done = self._read_flags()
        started = [False] * B
        j, j1, gated = 0, None, 0
        t_phase1 = t_build = None
        cap_phase1 = cap_build = 0.0
        while j < k and not all(done):
            live = [not d for d in done]
            opened = [lv and g for lv, g in zip(live, gate)]
            shut = [lv and not g for lv, g in zip(live, gate)]
            catchup = (j > 0 and self.m > 0
                       and any(o and not st for o, st in zip(opened, started)))
            if any(opened) and j1 is None:
                # the end of phase 1: the first catch-up, and a read that
                # waits for it, so the host clock times it
                j1, t_phase1 = j, time.perf_counter()
                cap_phase1 = R.time_capture - cap0
                if catchup:
                    R.run(("catchup", j), functools.partial(self._catchup, j))
                    catchup = False
                R.read(self.flags)
                t_build = time.perf_counter()
                cap_build = R.time_capture - cap0
            if catchup:
                R.run(("catchup", j), functools.partial(self._catchup, j))
            R.run(("arnoldi", j), functools.partial(self._arnoldi, j))
            if any(shut):
                R.run(("advance", j), functools.partial(self._advance, j))
            if any(opened):
                self._endgame(j)
                gated += 1
                started = [st or o for st, o in zip(started, opened)]
            gate, done = self._read_flags()
            j += 1
        t_loop, cap_loop = time.perf_counter(), R.time_capture - cap0
        if self.snap:
            # the projection epilogue, and a read that waits for it
            R.run("snap", self._snap)
            R.read(self.flags)
        t_end = time.perf_counter()
        cap = R.time_capture - cap0
        if j1 is None:
            j1, t_phase1, t_build, cap_phase1, cap_build = j, t_end, t_end, cap, cap
        return {
            "runtime": t_end - t_start - cap,
            "time_capture": cap,
            "phase1_steps_measured": j1,
            "phase1": t_phase1 - t_start - cap_phase1,
            "constraint_building": t_build - t_phase1 - (cap_build - cap_phase1),
            "endgame": t_end - t_build - (cap - cap_build),
            "snap": t_end - t_loop - (cap - cap_loop),
            "gated_steps": gated,
        }

    def _endgame(self, j: int) -> None:
        R = self.runner
        if self.m == 0:
            R.run(("finish0", j), functools.partial(self._finish0, j))
            return
        R.run(("kkt_start", j), functools.partial(self._kkt_start, j))
        more, _ = R.read(self.kflags)
        while more:
            R.run(("kkt_step", j), functools.partial(self._kkt_step, j))
            more, refact = R.read(self.kflags)
            if refact:
                R.run(("kkt_refactor", j),
                      functools.partial(self._kkt_refactor, j))
        R.run(("kkt_finish", j), functools.partial(self._kkt_finish, j))

    # --- the steps -------------------------------------------------------------

    def _set_flags(self, j_next: int) -> None:
        """[the gates of step j_next, done]: the reference's gate
        (solvers.py:230) is shut while the residual is above contol·tol, the
        step is not the last and the latch is untouched."""
        if j_next < self.k - 1:
            gate = ~((self.r_prev > self.contol * self.tol)
                     & (self.safety == _SAFETY_NONE))
        else:
            gate = torch.ones_like(self.done)
        self.flags.copy_(torch.cat([gate, self.done]).long())

    def _shut(self) -> torch.Tensor:
        """The solves that take the unconstrained step j."""
        return ~self.done & ~self.gate

    def _open(self) -> torch.Tensor:
        """The solves that take the endgame at step j."""
        return ~self.done & self.gate

    def _init(self) -> None:
        r0 = self.b - rows(self.A.__matmul__, self.x0)
        beta = pnorm(r0, self.mesh, dim=-1)
        start(self.st, r0, beta)
        self.beta.copy_(beta)
        self.r_prev.copy_(beta)
        self.x.copy_(self.x0)
        self.res.fill_(float("inf"))
        self.dev.fill_(float("inf"))
        for t in (self.yk, self.safety, self.steps, self.ncon, self.kkt_it,
                  self.nfb, self.done, self.brk, self.brk_now, self.haveK,
                  self.lamc, self.started):
            t.zero_()
        self.Kinvc.copy_(torch.eye(self.Kinvc.shape[-1], dtype=self.Kinvc.dtype,
                                   device=self.Kinvc.device)
                         .expand_as(self.Kinvc))
        if self.xs is not None:
            self.xs[:, 0] = r0
        for i, (con, buf, g) in enumerate(zip(self.cons, self.bufs,
                                              self.general)):
            if g:
                # its Taylor model and scale come at each gated step
                continue
            if self.x0_zero:
                buf.t0.copy_(con.c)
                self.s0[:, i] = con.c.abs()
            else:
                t0, self.s0[:, i] = value_and_scale_rows(
                    con, self.x0, f64=self.f64_value)
                buf.t0.copy_(t0)
            buf.t1.zero_()
            buf.T2.zero_()
        self._set_flags(0)

    def _arnoldi(self, j: int) -> None:
        self.gate.copy_(self.flags[: self.B].bool())
        live = ~self.done
        hlast = arnoldi_step_masked(self.A, self.prefunc, self.st, j,
                                    self.ortho, live)
        self.brk_now.copy_(live & (hlast == 0))
        self.y_unc.copy_(lsq_coeffs_device(self.st, j))

    def _iterate(self, j: int, y: torch.Tensor) -> torch.Tensor:
        """The iterates x0 + y Z of the coefficients y (B, k) at step j."""
        return rows_rmv(y[:, : j + 1], self.st.Z[:, : j + 1]) + self.x0

    def _finish(self, j: int, y: torch.Tensor, mask: torch.Tensor,
                gated: bool, x: torch.Tensor = None) -> None:
        """The iterates of the solves of ``mask`` from the coefficients y
        (B, k) (``x`` where the caller has formed them), their true
        residuals, the history, the counts, ``done`` and the next step's
        flags."""
        if x is None:
            x = self._iterate(j, y)
        r = pnorm(rows(self.A.__matmul__, x) - self.b, self.mesh, dim=-1)
        mk = mask[:, None]
        self.x.copy_(torch.where(mk, x, self.x))
        if self.xs is not None:
            self.xs[:, j + 1] = torch.where(mk, x, self.xs[:, j + 1])
        self.res[:, j] = torch.where(mask, r, self.res[:, j])
        self.r_prev.copy_(torch.where(mask, r, self.r_prev))
        self.yk.copy_(torch.where(mk, y, self.yk))
        done = ((r < self.tol) & (self.safety == _SAFETY_OK)) | self.brk_now
        self.brk.copy_(self.brk | (mask & self.brk_now))
        self.steps.add_(mask.long())
        if gated:
            self.ncon.add_(mask.long())
        self.done.copy_(self.done | (mask & done))
        self._set_flags(j + 1)

    def _advance(self, j: int) -> None:
        mask = self._shut()
        self.dev.copy_(torch.where(mask, float("inf"), self.dev))
        self._finish(j, self.y_unc, mask, gated=False)

    def _finish0(self, j: int) -> None:
        """A gated step without constraints: the constrained solve is the
        LSQ and the latch is vacuously satisfied."""
        mask = self._open()
        self.safety.copy_(torch.where(mask, _SAFETY_OK, self.safety))
        self.dev.copy_(torch.where(mask, 0.0, self.dev))
        self.started.copy_(self.started | mask)
        self._finish(j, self.y_unc, mask, gated=True)

    def _catchup(self, j1: int) -> None:
        """The reduction over the first j1 basis vectors, for the solves
        whose gate opened at step j1 (read from ``flags``: it runs before
        the step's ``arnoldi``)."""
        mask = ~self.done & self.flags[: self.B].bool() & ~self.started
        for con, buf, g in zip(self.cons, self.bufs, self.general):
            if not g:
                catch_up(con, buf, self.st.Z, self.x0, j1, mask, self.x0_zero,
                         f64=self.f64)

    def _model(self, j: int):
        return kkt_model(self.st.H, self.beta, self.bufs, j + 1, self.s0)

    def _set_kflags(self) -> None:
        self.kflags.copy_(torch.stack([self.work.cond.any(),
                                       self.work.refact.any()]).long())

    def _kkt_start(self, j: int) -> None:
        mask = self._open()
        ka, na = j + 1, self.m + j + 1
        for i, (con, buf, g) in enumerate(zip(self.cons, self.bufs,
                                              self.general)):
            if not g:
                fold_column(con, buf, self.st.Z, self.x0, j, mask,
                            self.x0_zero, f64=self.f64)
                continue
            # a fresh Taylor model about the warm coefficients, which both
            # starts share (B = 1), with |t0| as its value's scale
            t0, t1, T2 = taylor_model(con, self.yk[0, :ka],
                                      self.st.Z[0, :ka], self.x0[0], self.cd)
            buf.t0.copy_(torch.where(mask, t0, buf.t0))
            buf.t1[:, :ka] = torch.where(mask[:, None], t1, buf.t1[:, :ka])
            buf.T2[:, :ka, :ka] = torch.where(mask[:, None, None], T2,
                                              buf.T2[:, :ka, :ka])
            self.s0[:, i] = torch.where(mask, t0.abs(), self.s0[:, i])
        self.started.copy_(self.started | mask)
        y0 = torch.stack([self.yk[:, :ka], self.y_unc[:, :ka]],
                         dim=1).to(self.cd)
        have = torch.stack([self.haveK, torch.zeros_like(self.haveK)], dim=1)
        kkt_start(self._model(j), self.work, y0, have, self.lamc,
                  self.Kinvc[:, :na, :na], self.kkt_tol, self.linear, mask,
                  eps=self.kkt_eps)
        self._set_kflags()

    def _kkt_step(self, j: int) -> None:
        kkt_step(self._model(j), self.work, self.kkt_tol)
        self._set_kflags()

    def _kkt_refactor(self, j: int) -> None:
        kkt_refactor(self._model(j), self.work)

    def _kkt_finish(self, j: int) -> None:
        mask = self._open()
        mod, w, dt, cd = self._model(j), self.work, self.b.dtype, self.cd
        ka, na, k, B = j + 1, self.m + j + 1, self.k, self.B
        # the dual start's floor (JAX cgmres.py:335; ``floor_eps``)
        eps, tiny = self.kkt_eps, torch.finfo(cd).tiny
        Y, y_unc, beta = (w.y[..., :ka], self.y_unc[:, :ka].to(cd),
                          self.beta.to(cd))
        dev_c = kkt_values(mod, Y)[0].abs().amax(-1)
        scale_c = kkt_scale(mod, Y)
        # the roundoff scale and deviation at the fallback (unconstrained)
        # coefficients: the dual start's one floor, and the kept point's
        # numbers if the far branch rejects the constrained one
        dev_fb = kkt_values(mod, y_unc[:, None])[0].abs().amax(-1)[:, 0]
        scale_fb = kkt_scale(mod, y_unc[:, None])[:, 0]
        be1 = torch.cat([beta[:, None], Y.new_zeros(B, ka)], dim=-1)
        Ha = self.st.H[:, : ka + 1, :ka].to(cd)
        resid = torch.linalg.norm(be1[:, None] - Y @ Ha.mT, dim=-1)
        # the dual start's choice (``_take_fresh``): feasible first, then the
        # smaller Hessenberg residual, against one floor; never a NaN
        nan = torch.isnan(Y).any(-1)
        floor_fb = torch.clamp(32.0 * eps * scale_fb, min=self.ctol)
        cap = DIVERGED_SCALE * torch.clamp(scale_fb, min=tiny)
        feas = (~nan & (dev_c <= floor_fb[:, None])
                & (scale_c < cap[:, None]))
        rr = torch.where(nan, float("inf"), resid)
        take = (torch.where(feas[:, 0] != feas[:, 1], feas[:, 1],
                            rr[:, 1] < rr[:, 0]) & ~nan[:, 1])

        def chosen(t):
            return torch.where(take.reshape(B, *([1] * (t.dim() - 2))),
                               t[:, 1], t[:, 0])

        y_kkt, bad, res_kkt = chosen(Y), chosen(nan), chosen(resid)
        # far-branch rejection (reference solvers.py:256-284): a constrained
        # point whose residual exceeds the initial one keeps the LSQ
        # coefficients and the fallback's numbers, and trips the latch
        res_unc = self.st.g[:, j + 1].abs()
        far = ~bad & (res_kkt > 0.5 * beta) & (res_kkt > 1e3 * res_unc)
        deviation = torch.where(far, dev_fb, chosen(dev_c))
        scale = torch.where(far, scale_fb, chosen(scale_c))
        y = torch.cat([torch.where((bad | far)[:, None], y_unc, y_kkt),
                       Y.new_zeros(B, k - ka)], dim=-1).to(dt)
        x = self._iterate(j, y)
        for con, g in zip(self.cons, self.general):
            if g:
                # the Taylor model is exact for a quadratic g; a general g
                # is checked at the accepted coefficients (B = 1)
                deviation = torch.maximum(deviation, con.func(x[0]).abs())
        # the latch's floor (``floor_eps``)
        floor = torch.clamp(32.0 * self.latch_eps * scale, min=self.ctol)
        safety = torch.where(bad, self.safety, torch.where(
            deviation > floor, _SAFETY_BAD, _SAFETY_OK))
        self.safety.copy_(torch.where(mask, safety, self.safety))
        self.dev.copy_(torch.where(mask, deviation, self.dev))
        self.kkt_it.add_(torch.where(mask, chosen(w.it), 0))
        self.nfb.add_((mask & bad).long())
        self.lamc.copy_(torch.where(mask[:, None], chosen(w.lam), self.lamc))
        self.Kinvc[:, :na, :na] = torch.where(
            mask[:, None, None], chosen(w.Kinv[..., :na, :na]),
            self.Kinvc[:, :na, :na])
        self.haveK.copy_(torch.where(mask, ~bad & ~far, self.haveK))
        self._finish(j, y, mask, gated=True, x=x)


    def _snap(self) -> None:
        """The projection epilogue of each solve whose latch is OK (JAX
        ``cgmres.py:544-560``): its iterate onto the invariants of its
        loaded targets, its deviation the certified f64 value at the
        returned x; the others keep theirs.  From a given start
        (``warm32``) the certificate then sets the latch
        (``certified_floor``)."""
        ok = self.safety == _SAFETY_OK
        for b in range(self.B):
            cons = [QuadraticConstraint(
                M=c.M, v=None if c.v is None else c.v[b], c=c.c[b],
                name=c.name, mesh=c.mesh) for c in self.cons]
            x_sn, g = snap_iterate(self.x[b], cons)
            self.x[b] = torch.where(ok[b], x_sn, self.x[b])
            self.dev[b] = torch.where(ok[b], g.abs().amax(), self.dev[b])
            if self.warm32:
                held = (g.abs() <= certified_floor(cons, x_sn,
                                                   self.ctol)).all()
                self.safety[b] = torch.where(ok[b] & ~held, _SAFETY_BAD,
                                             self.safety[b])


def _con_key(c):
    """What a cached core keeps of a constraint: a quadratic one's operator
    M and whether it has v (its c and v are loaded per solve); a general
    one itself (its function is called inside the steps)."""
    if isinstance(c, GeneralConstraint):
        return ("general", _key(c))
    return (_key(c.M), c.v is None)


def _key(obj):
    """A key of an operator (or preconditioner) for the cache of device
    cores: a tensor by its storage, shape, strides, dtype and device; a
    dataclass by its type and compared fields; a tuple or list by its items;
    a number, string or None by itself; anything else by its identity.  A
    cached core keeps the objects of its key alive, so a storage address
    stays theirs while it is cached."""
    if isinstance(obj, torch.Tensor):
        return ("tensor", obj.data_ptr(), tuple(obj.shape), obj.stride(),
                obj.dtype, str(obj.device))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj), tuple(_key(getattr(obj, f.name))
                                 for f in dataclasses.fields(obj) if f.compare))
    if isinstance(obj, (tuple, list)):
        return tuple(_key(o) for o in obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return ("id", id(obj))


# the device cores of the last ``CORE_CACHE`` keys that ``cgmres`` and
# ``gmres`` with ``loop="while"`` and ``cgmres_many`` ran, with their
# captured graphs, by what each was built for, the most recent last: two,
# so that a GMRES and a CGMRES solve of one system (``time_cgmres``) each
# keep theirs; a call with a new key drops the oldest
CORE_CACHE = 2
_CORES: "collections.OrderedDict" = collections.OrderedDict()


def clear_core_cache() -> None:
    """Drop the cached device cores (their buffers and graphs), CG's
    (``solvers/cg.py``) too."""
    from .cg import _CORES as cg_cores

    _CORES.clear()
    cg_cores.clear()


def last_core() -> DeviceCore:
    """The device core of the last device-core solve."""
    return next(reversed(_CORES.values()))


def _core_for(A, b, x0, k, tol, contol, cons, pre, ctol, ortho,
              history=False, modes=(False, False, False)) -> DeviceCore:
    """The cached device core for these operators and options (``modes``:
    ``resolve_modes``'s), built (and cached, dropping the oldest past
    ``CORE_CACHE``) if none is."""
    key = (_key(A), _key(pre), int(k), float(tol), float(contol), float(ctol),
           ortho, x0 is None, bool(history), tuple(b.shape), b.dtype,
           str(b.device), tuple(_con_key(c) for c in cons), tuple(modes))
    core = _CORES.get(key)
    if core is None:
        while len(_CORES) >= CORE_CACHE:
            # the oldest core's buffers go before the new ones come
            _CORES.popitem(last=False)
        mixed, snap, f32_reduce = modes
        core = _CORES[key] = DeviceCore(
            A, pre, k, cons, like=b, tol=tol, contol=contol, ctol=ctol,
            ortho=ortho, x0_zero=x0 is None, history=bool(history),
            mixed=mixed, snap=snap, f32_reduce=f32_reduce)
    _CORES.move_to_end(key)
    return core


def _run_device(A, b, x0, k, tol, contol, constraints, pre, ctol, history,
                timing, ortho, modes=(False, False, False)):
    cons = tuple(constraints)
    t0 = time.perf_counter()
    core = _core_for(A, b, x0, k, tol, contol, cons, pre, ctol, ortho,
                     history, modes)
    core.load(b, x0, cons)
    t_setup = time.perf_counter() - t0
    times = core.solve()
    out = core.result()
    # one device-to-host copy for every scalar the info dict needs
    host = torch.stack([t.double() for t in (
        out.steps, out.constrained_steps, out.safety, out.deviation,
        out.breakdown, out.kkt_iters, out.fallbacks)]).tolist()
    steps, ncon, safety, dev_j, brk, kkt_it, nfb = host
    steps, ncon = int(steps), int(ncon)
    info = _info(False, steps, ncon, int(safety), dev_j, bool(brk),
                 int(kkt_it), int(nfb), out.res.cpu().numpy())
    if history:
        info["x"] = core.xs[0, : steps + 1].clone()
    if timing:
        j1 = times["phase1_steps_measured"]
        info["timings"] = {
            "constrained_steps": ncon,
            "unconstrained_steps": max(steps - ncon, 0),
            "runtime": times["runtime"],
            "time_capture": times["time_capture"],
            "time_setup": t_setup,
            "iter_time_unconstrained": np.nan if j1 == 0
            else times["phase1"] / j1,
            "iter_time_constrained": np.nan if ncon == 0
            else times["endgame"] / ncon,
            "constraint_building": times["constraint_building"],
            "phase1_steps_measured": j1,
            "method": "measured: host clock around the replays of phase 1, "
                      "the catch-up and the endgame, each ending in a flag "
                      "read; captures left out (time_capture)",
        }
        if core.snap:
            # the projection's graph and the read that waits for it
            info["timings"]["time_snap"] = times["snap"]
    else:
        info["timings"] = None
    return out.x, info


def _run(A, b, x0, k, tol, contol, constraints, pre, ctol, history, timing,
         prototypical, ortho="cgs2", loop="host", mixed=None, snap=None,
         f32_reduce=None):
    check_storage(b)
    x0 = as_operand(x0, b)
    constraints = tuple(constraints)
    modes = resolve_modes(b.dtype, constraints, mixed, snap, f32_reduce,
                          prototypical)
    if timing and prototypical:
        raise NotImplementedError("timing is measured for cgmres only")
    if loop == "while" and not prototypical:
        return _run_device(A, b, x0, k, tol, contol, constraints, pre, ctol,
                           history, timing, ortho, modes)
    if loop != "host":
        raise ValueError(
            f"loop={loop!r}: use 'host' or, for cgmres, 'while' (the JAX "
            "package's 'fori' is not ported)")
    solve = _Solve(A, b, x0, k, tol, contol, constraints, pre, ctol, history,
                   prototypical, ortho, modes)
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
    loop: str = "host",
    mixed=None,
    snap=None,
    f32_reduce=None,
):
    """Constraint-satisfying FGMRES; returns ``(x, info)``.

    Matches the reference output contract (solvers.py:316-322): ``info`` has
    ``name='cgmres'``, per-iteration true residuals ``res``, ``steps``, and a
    ``timings`` entry when ``timing=True`` — plus ``deviation``, ``safety``,
    ``constrained_steps``, ``kkt_iters`` and ``fallbacks``.  ``ortho`` is
    the Arnoldi orthogonalisation (``arnoldi_step``).

    ``loop``: ``"host"`` (the default) runs the host loop; ``"while"`` the
    device core (``DeviceCore``), captured as CUDA graphs on the card, eager
    on the CPU.  The last ``CORE_CACHE`` cores are kept, on the operators,
    the preconditioner, ``k``, the tolerances, ``ortho``, ``history``, the
    constraints' operators and the general constraints
    (``clear_core_cache`` drops them), so a second solve with new b, x0 or
    targets replays the first one's graphs; its ``timings`` add
    ``time_capture``, the seconds spent capturing, which ``runtime`` leaves
    out.

    ``mixed``, ``snap`` and ``f32_reduce`` are the f32 storage modes
    (``resolve_modes``; None: the JAX package's defaults, all off with f64
    storage).
    """
    return _run(A, b, x0, k, tol, contol, constraints, pre, ctol, history,
                timing, prototypical=False, ortho=ortho, loop=loop,
                mixed=mixed, snap=snap, f32_reduce=f32_reduce)


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
    mixed=None,
):
    """Prototypical CGMRES: fixed ``k`` iterations, constraints enforced
    cumulatively (iteration j enforces the first j), no stopping tolerance
    (reference solvers.py:328-445; info name 'geosolve').  With f32 storage
    it runs without the projection, as the JAX package's, and mixed unless
    ``mixed=False`` (``resolve_modes``)."""
    return _run(A, b, x0, k, tol=0.0, contol=0.0, constraints=constraints,
                pre=pre, ctol=ctol, history=history, timing=False,
                prototypical=True, ortho=ortho, mixed=mixed)
