"""GMRES, CGMRES and CGMRES-p of the PyTorch port against the JAX package,
on the CPU in f64, on identical operands (the JAX systems handed over
through ``interop``).

The configurations are those of ``tests/test_cgmres_lkdv.py`` (lkdv easy and
hard, the SingleSolve settings included) and the swe f64 dynamics setting at
M=32 (k=60, tol=1e-9).  On each:

* ``steps``, ``constrained_steps`` and ``safety`` equal the JAX package's;
* the iterate and the residual trace agree as far as the reference itself
  is reproducible.  On the lkdv Krylov plateaus rounding is amplified: a
  1e-15 relative perturbation of b moves the JAX package's own iterate by
  up to 5e-5 (lkdv hard) and its residual trace by up to 20% (lkdv easy).
  So each bound is measured: the JAX package is run again on a perturbed b,
  x must agree to max(1e-8, 10·its own drift), and the residual trace to
  1e-6 relative on the prefix where the perturbed reference still agrees
  with itself to 1e-6;
* where the JAX package certifies the solve (safety=True), the port's
  invariant deviations are at most 1e-10, or the roundoff floor 64·eps·|c|
  of an invariant of size |c| where that is larger (swe's are ~1e4).

The committed JAX record (``reference/slice1.json``), which the card run is
held against, is regenerated here for its lkdv and swe M=64 entries.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch import solvers as tsol
from structurepreservingiterativesolvers_tpu import solvers as jsol
from structurepreservingiterativesolvers_tpu.models import lkdv as jlkdv
from structurepreservingiterativesolvers_tpu.models import swe as jswe

SYSTEMS = {
    "easy": lambda: jlkdv.linforms(**torch_parity.LKDV_EASY),
    "hard": lambda: jlkdv.linforms(**torch_parity.LKDV_HARD),
    "swe32": lambda: jswe.linforms(M=32),
}

# case -> (system, solver, k, tol, x0 = zeros (else None), history)
CASES = {
    # the reference SingleSolve: tol below 1e-20 selects CGMRES-p
    "easy-gmres": ("easy", "gmres", 20, 1e-50, True, True),
    "easy-cgmres_p": ("easy", "cgmres_p", 20, None, True, True),
    "easy-cgmres": ("easy", "cgmres", 30, 1e-10, False, False),
    "hard-gmres": ("hard", "gmres", 50, 1e-6, False, False),
    "hard-cgmres": ("hard", "cgmres", 50, 1e-6, False, False),
    "hard-cgmres_p": ("hard", "cgmres_p", 20, None, False, False),
    "swe32-gmres": ("swe32", "gmres", 60, 1e-9, False, False),
    "swe32-cgmres": ("swe32", "cgmres", 60, 1e-9, False, False),
    "swe32-cgmres_p": ("swe32", "cgmres_p", 20, None, False, False),
}


@pytest.fixture(scope="module")
def systems():
    """(JAX system, port twin) per configuration, built on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            js = SYSTEMS[name]()
            cache[name] = (js, torch_parity.to_port(js))
        return cache[name]

    return get


def _solve(pkg, solver, s, k, tol, zero_x0, history, b=None):
    mod = jsol if pkg == "jax" else tsol
    zeros = jnp.zeros_like if pkg == "jax" else torch.zeros_like
    b = s.b if b is None else b
    kw = dict(k=k, history=history)
    if solver != "cgmres_p":
        kw["tol"] = tol
    if solver != "gmres":
        kw["constraints"] = s.constraints()
    return getattr(mod, solver)(s.A, b, zeros(b) if zero_x0 else None, **kw)


def _deviations(s, x):
    inv = s.compute_invariants(x)
    out = {}
    for key, val in inv.items():
        target = float(getattr(s, {"mass": "m0", "momentum": "mo0",
                                   "energy": "e0"}[key]))
        out[key] = (float(val) - target, target)
    return out


def _reproducible_prefix(res_ref, res_pert, beta):
    """Indices up to the first where the reference, rerun on a perturbed b,
    departs from itself by more than 1e-6 relative."""
    n = min(len(res_ref), len(res_pert))
    for i in range(n):
        if res_ref[i] <= 1e-12 * beta or (
                abs(res_pert[i] - res_ref[i]) > 1e-6 * res_ref[i]):
            return i
    return n


@pytest.mark.parametrize("case", list(CASES))
def test_solver_matches_jax(systems, case):
    name, solver, k, tol, zero_x0, history = CASES[case]
    js, ts = systems(name)
    xj, ij = _solve("jax", solver, js, k, tol, zero_x0, history)
    xp, ip = _solve("jax", solver, js, k, tol, zero_x0, history,
                    b=jnp.asarray(torch_parity.perturbed(js.b)))
    xt, it = _solve("port", solver, ts, k, tol, zero_x0, history)

    for key in ("steps", "constrained_steps", "safety", "breakdown"):
        if key in ij:
            assert it[key] == ij[key], key

    drift = torch_parity.rel_max(xp, xj)
    assert torch_parity.rel_max(xt.numpy(), xj) <= max(1e-8, 10.0 * drift)

    if ij.get("safety") is not False:
        # (an over-constrained solve, which the reference itself refuses to
        # certify, returns best-effort KKT points whose line-search choices
        # flip under rounding: only its counts and iterate are compared)
        beta = float(jnp.linalg.norm(js.b))
        upto = _reproducible_prefix(ij["res"], ip["res"], beta)
        assert upto >= min(5, len(ij["res"]))
        np.testing.assert_allclose(it["res"][:upto], ij["res"][:upto],
                                   rtol=1e-6)

    if history:
        # info["x"][0] is the initial residual vector; consumers index from 1
        # (reference quirk, solvers.py:75-80)
        r0 = ts.b - ts.A @ torch.zeros_like(ts.b)
        torch.testing.assert_close(it["x"][0], r0, rtol=1e-12, atol=0)
        torch.testing.assert_close(it["x"][it["steps"]], xt, rtol=1e-12, atol=0)
        assert it["x"].shape == (it["steps"] + 1, ts.b.shape[0])

    if ij.get("safety") is True:
        for key, (dev, target) in _deviations(ts, xt).items():
            floor = max(1e-10, 64 * np.finfo(np.float64).eps * abs(target))
            assert abs(dev) <= floor, (key, dev)


def test_cgmres_beats_gmres_on_invariants(systems):
    """The headline property in the port: at equal budget and tolerance,
    CGMRES invariant deviations are ≥2× smaller than GMRES's on every
    invariant (tests/test_cgmres_lkdv.py:63-74)."""
    _, ts = systems("hard")
    xg, _ = tsol.gmres(ts.A, ts.b, k=50, tol=1e-6)
    xc, ic = tsol.cgmres(ts.A, ts.b, k=50, tol=1e-6, constraints=ts.constraints())
    dg = np.array([abs(d) for d, _ in _deviations(ts, xg).values()])
    dc = np.array([abs(d) for d, _ in _deviations(ts, xc).values()])
    assert ic["safety"] is True
    assert dc.max() < 1e-10
    assert np.all(dc * 2.0 <= dg + 1e-16)


def test_cgmres_timing(systems):
    """timing=True measures the phases on the host clock."""
    _, ts = systems("easy")
    _, info = tsol.cgmres(ts.A, ts.b, k=30, tol=1e-10,
                          constraints=ts.constraints(), timing=True)
    t = info["timings"]
    assert t["constrained_steps"] == info["constrained_steps"]
    assert t["constrained_steps"] + t["unconstrained_steps"] == info["steps"]
    assert t["runtime"] > 0 and t["constraint_building"] >= 0
    assert t["phase1_steps_measured"] == info["steps"] - info["constrained_steps"]
    assert math.isfinite(t["iter_time_unconstrained"])
    assert math.isfinite(t["iter_time_constrained"])


def test_ortho_and_preconditioner_spellings(systems):
    """MGS takes the same steps as CGS2; an identity preconditioner in each
    accepted spelling (callable, ``.solve``, ``@``) changes nothing."""
    _, ts = systems("swe32")
    x, info = tsol.gmres(ts.A, ts.b, k=60, tol=1e-9)
    xm, im = tsol.gmres(ts.A, ts.b, k=60, tol=1e-9, ortho="mgs")
    assert im["steps"] == info["steps"]
    assert torch_parity.rel_max(xm.numpy(), x.numpy()) <= 1e-10

    class Solve:
        def solve(self, v):
            return v

    class MatMul:
        def __matmul__(self, v):
            return v

    for pre in (lambda v: v, Solve(), MatMul()):
        xp, ip = tsol.cgmres(ts.A, ts.b, k=60, tol=1e-9, pre=pre,
                             constraints=ts.constraints())
        assert ip["steps"] == info["steps"]
        assert torch.equal(xp, tsol.cgmres(ts.A, ts.b, k=60, tol=1e-9,
                                           constraints=ts.constraints())[0])
    with pytest.raises(ValueError):
        tsol.gmres(ts.A, ts.b, k=5, ortho="householder")


def test_solvers_refuse_f32_storage(systems):
    """The solvers take f32 storage (``tests/test_torch_f32*.py``); a
    storage dtype other than f64 and f32 is refused, on both loops."""
    _, ts = systems("easy")
    b16 = ts.b.to(torch.float16)
    for loop in ("host", "while"):
        with pytest.raises(NotImplementedError):
            tsol.gmres(ts.A, b16, k=5, loop=loop)
        with pytest.raises(NotImplementedError):
            tsol.cgmres(ts.A, b16, k=5, constraints=ts.constraints(),
                        loop=loop)


def _same_summary(new, rec, beta):
    for key in ("steps", "constrained_steps", "safety"):
        assert new.get(key) == rec.get(key), key
    for key in ("res", "true_residual"):
        assert math.isclose(new[key], rec[key], rel_tol=1e-6,
                            abs_tol=1e-12 * beta), key
    if "deviation" in rec:
        assert math.isclose(new["deviation"], rec["deviation"], rel_tol=1e-6,
                            abs_tol=1e-12), "deviation"
    for key, val in rec["invariants"].items():
        assert math.isclose(new["invariants"][key], val, rel_tol=1e-12), key


@pytest.mark.parametrize("name", ["lkdv_easy", "lkdv_hard", "swe_M64"])
def test_reference_record_is_current(systems, name):
    """Regenerate an entry of the committed JAX record and compare."""
    script = torch_parity.reference_script()
    sys_name = {"lkdv_easy": "easy", "lkdv_hard": "hard"}.get(name)
    s = systems(sys_name)[0] if sys_name else None
    new = script.record(name, s=s)
    rec = script.load(name)[name]
    assert new["config"]["k"] == rec["config"]["k"]
    assert new["n"] == rec["n"]
    for solver in ("gmres", "cgmres"):
        _same_summary(new[solver], rec[solver], rec["beta"])


def _candidate(y, deviation, scale):
    from structurepreservingiterativesolvers_torch.solvers.kkt import KKTResult

    return KKTResult(y=torch.tensor(y, dtype=torch.float64), lam=torch.zeros(2),
                     deviation=deviation, scale=scale, kkt_norm=0.0, iters=1,
                     Kinv=torch.zeros(4, 4), refacts=0)


def test_dual_start_merit_rejects_a_diverged_candidate():
    """The dual start judges both candidates against the fallback's floor.
    The JAX package's merit judges each against its own scale
    (cgmres.py:331-337): a diverged fresh-start candidate, whose scale
    (2.5e287, as observed) lifts its floor past its deviation, counts as
    feasible there and displaces a sane warm-start candidate that is not
    feasible yet.  The port keeps the sane one."""
    from structurepreservingiterativesolvers_torch.solvers.cgmres import (
        _take_fresh,
    )

    eps, ctol, scale_fb = np.finfo(np.float64).eps, 1e-12, 3e4
    warm = _candidate([1.0, 0.5], deviation=1e-6, scale=3e4)
    diverged = _candidate([1e140, -1e140], deviation=1e270, scale=2.5e287)

    def jax_feasible(kk):  # the JAX package's rule
        return kk.deviation <= max(ctol, 32.0 * eps * kk.scale)

    assert jax_feasible(diverged) and not jax_feasible(warm)
    assert not _take_fresh(warm, diverged, 1e-6, 1e139, scale_fb, ctol,
                           torch.float64)
    # a diverged scale alone makes a candidate infeasible
    inflated = _candidate([1.0, 0.4], deviation=1e-13, scale=1e13)
    sane = _candidate([1.0, 0.4], deviation=1e-13, scale=3e4)
    assert not _take_fresh(warm, inflated, 1e-6, 1e-6, scale_fb, ctol,
                           torch.float64)
    assert _take_fresh(warm, sane, 1e-6, 1e-6, scale_fb, ctol, torch.float64)
    # otherwise unchanged: feasible first, then the smaller residual, and a
    # NaN candidate never
    done = _candidate([1.0, 0.5], deviation=1e-14, scale=3e4)
    assert not _take_fresh(done, sane, 1e-6, 2e-6, scale_fb, ctol,
                           torch.float64)
    assert _take_fresh(done, sane, 2e-6, 1e-6, scale_fb, ctol, torch.float64)
    nan = _candidate([float("nan"), 0.0], deviation=float("nan"), scale=3e4)
    assert not _take_fresh(warm, nan, 1e-6, float("nan"), scale_fb, ctol,
                           torch.float64)


@pytest.mark.slow
def test_reference_record_swe_m512():
    """The largest entry (n = 786,432), which the card run is held to."""
    script = torch_parity.reference_script()
    new = script.record("swe_M512")
    rec = script.load("swe_M512")["swe_M512"]
    for solver in ("gmres", "cgmres"):
        _same_summary(new[solver], rec[solver], rec["beta"])
