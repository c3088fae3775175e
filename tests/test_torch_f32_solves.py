"""The port's f32 storage mode on the CPU against the JAX package's runs of
the same configurations (``reference/slice15.json``, written by
``scripts/make_torch_reference.py`` with the JAX package on the CPU in f32
storage):

* lkdv M=50 (degree 1, k=20, tol=1e-5), from zero and from the warm start
  of the JAX package's ``tests/test_solver_options.py:35-60``, with
  ``cgmres`` on both loops;
* the TimedSolve pairs through the wrappers (``reduction_mode``, x0=None):
  swe M=64 with the skew-normal Chebyshev (tol 4e-7·||b||) and heat M=32
  with the structured AMG (tol 1e-6·||b||), on both loops.

Each CGMRES solve: the latch equal to the record's, the steps within one,
the certified deviation of the returned iterate at most max(10x the
record's, 1e-12 of the invariants' scale), x within max(1e-5·max|x|, 10x
the JAX package's own drift under a one-ulp change of b); on swe, CGMRES's
gain over GMRES above 100 on each invariant (JAX
``tests/test_projection.py:79``).  And with f64 storage nothing changes:
an explicit ``mixed``, ``snap`` or ``f32_reduce`` resolves off.

The JAX package is not run here: the records are its runs.
"""

import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch.experiments import wrappers
from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
    certified_deviations,
    default_pre_builder,
)
from structurepreservingiterativesolvers_torch.experiments.single_solve import (
    get_model,
)
from structurepreservingiterativesolvers_torch.models import lkdv as tlkdv
from structurepreservingiterativesolvers_torch.solvers import cgmres
from structurepreservingiterativesolvers_torch.solvers.cgmres import (
    resolve_modes,
)

SCRIPT = torch_parity.reference_script()
REC = SCRIPT.load("lkdv_M50_f32")
F32 = torch.float32


def run_record(name, loop):
    """The port's CGMRES on the record's configuration: the system in f32,
    its preconditioner, the solve (and, for a TimedSolve pair, GMRES)."""
    kind, problem, params, k, tol, tol_mode, start, pre_spec = \
        SCRIPT.SLICE15[name]
    s = get_model(problem).linforms(device="cpu", dtype=F32, **params)
    pre = None if pre_spec is None else default_pre_builder(problem)(s)
    rec = REC[name]
    tol_abs = rec["tol_abs"]
    if kind == "timed":
        x, info = wrappers.cgmres_wrapper(s, k=k, tol=tol_abs, pre=pre,
                                          loop=loop)
        xg, _ = wrappers.gmres_wrapper(s, k=k, tol=tol_abs, pre=pre,
                                       loop=loop)
        return s, x, info, xg
    x0 = None
    if start == "warm":
        rng = np.random.default_rng(3)
        x0 = torch.as_tensor(s.b.double().numpy() + 1e-3 * rng.standard_normal(
            s.b.shape[0]), dtype=F32)
    x, info = cgmres(s.A, s.b, x0=x0, k=k, tol=tol_abs,
                     constraints=s.constraints(), pre=pre, loop=loop)
    return s, x, info, None


CASES = [("lkdv_M50_f32", "host"), ("lkdv_M50_f32", "while"),
         ("lkdv_M50_f32_warm", "host"), ("swe_M64_snc_f32", "host"),
         ("swe_M64_snc_f32", "while"), ("heat_M32_amg_f32", "host"),
         ("heat_M32_amg_f32", "while")]


@pytest.mark.parametrize("name,loop", CASES,
                         ids=[f"{n}-{lp}" for n, lp in CASES])
def test_f32_solve_matches_record(name, loop):
    rec = REC[name]
    rc = rec["cgmres"]
    s, x, info, xg = run_record(name, loop)
    assert x.dtype == F32
    assert info["safety"] == rc["safety"]
    assert abs(info["steps"] - rc["steps"]) <= 1, (info["steps"], rc["steps"])
    scale = max([abs(v) for v in rec["targets"].values()] + [1.0])
    dev = certified_deviations(s, x)
    bar = max(10.0 * max(rc["certified"].values()), 1e-12 * scale)
    assert max(dev.values()) <= bar, (dev, rc["certified"])
    # the reported deviation is the certified value at the returned x
    assert info["deviation"] == pytest.approx(max(dev.values()), rel=1e-6,
                                              abs=1e-300)
    xr = np.asarray(rc["x"])
    gap = np.abs(x.double().numpy() - xr).max()
    assert gap <= max(1e-5, 10.0 * rec["own_drift"]) * np.abs(xr).max(), gap
    if xg is not None and name.startswith("swe"):
        devg = certified_deviations(s, xg)
        for nm in devg:
            assert devg[nm] / max(dev[nm], 1e-16) > 100.0, nm


def test_f64_storage_resolves_modes_off():
    """With f64 storage ``mixed``, ``snap`` and ``f32_reduce`` resolve off
    whatever the caller asks (JAX ``cgmres.py:575-623``), so a solve with
    them is the default solve bit for bit."""
    s = tlkdv.linforms(M=50, degree=1, device="cpu")
    cons = s.constraints()
    assert resolve_modes(torch.float64, cons, True, True, True) == (
        False, False, False)
    assert resolve_modes(F32, cons) == (True, True, True)
    assert resolve_modes(F32, cons, mixed=False) == (False, True, False)
    x1, i1 = cgmres(s.A, s.b, k=20, tol=1e-8, constraints=cons, loop="while")
    x2, i2 = cgmres(s.A, s.b, k=20, tol=1e-8, constraints=cons, loop="while",
                    mixed=True, snap=True, f32_reduce=True)
    assert torch.equal(x1, x2)
    assert (i1["steps"], i1["safety"]) == (i2["steps"], i2["safety"])
