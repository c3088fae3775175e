"""heat on the port's device core, on the CPU in f64, held to the JAX
package's record of the same runs (``reference/slice11.json``, written by
``scripts/make_torch_reference.py`` with the JAX package on the CPU) and to
the port's host loop:

* ``cgmres(loop="while")`` on heat M=64 (n = 4,225, tol=1e-7 absolute) with
  each of heat's preconditioners: the structured AMG (k=20), the
  Chebyshev polynomial of degree 8 and the Neumann series of degree 4
  (k=60, as ``slice3.json``'s M=64 anchors) and Jacobi (k=60): the latch
  equal to the record's, the steps within one, the KKT deviation at most
  1e-10 and the true residual below tol where the record certifies (the
  record's true residual to 1e-6 where it does not: Jacobi stalls), the
  polynomial's bounds to 1e-10, and x within 1e-10 of the host loop's;
* ``time_cgmres(loop="while")`` and ``gmres(loop="while")``: the device
  core's row against the host loop's;
* ``fused_evolve("heat", N=3, M=64)`` with the AMG, warm-started as the
  JAX package's: per step the steps and latch equal to the JAX
  ``fused_evolve``'s, no KKT fallback (a singular KKT matrix of a
  warm-started heat step would show here), and the mass and energy series
  within 1e-10 of the record's.  heat's energy is a dissipation identity
  between a step's solution and the previous one, so the series also holds
  the evolution to the JAX step's ``zold``.

The JAX package is not run here: the records are its runs.
"""

import importlib
import math

import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch import precond as tprecond
from structurepreservingiterativesolvers_torch.experiments.evolve import (
    fused_evolve,
)
from structurepreservingiterativesolvers_torch.models import heat as theat
from structurepreservingiterativesolvers_torch.solvers import gmres

# the module (the experiments package exports a function of the same name,
# as the JAX package's does)
tts = importlib.import_module(
    "structurepreservingiterativesolvers_torch.experiments.timed_solve")

# the module (the solvers package exports a function of the same name)
tcgmres = importlib.import_module(
    "structurepreservingiterativesolvers_torch.solvers.cgmres")

REF = torch_parity.reference_script()
TOL = 1e-7
# the port's builders of the preconditioners the records name
BUILDERS = {
    "amg": tts.default_pre_builder("heat"),
    "cheb8": lambda s: tprecond.chebyshev(s.A, degree=8),
    "neu4": lambda s: tprecond.neumann(s.A, degree=4),
    "jacobi": lambda s: tprecond.jacobi(s.A),
}


@pytest.fixture(scope="module")
def heat64():
    return theat.linforms(M=64, device="cpu")


@pytest.mark.parametrize("pre", ["amg", "cheb8", "neu4", "jacobi"])
def test_device_core_matches_record(heat64, pre):
    name = f"heat_M64_{pre}_while"
    rec = REF.load(name)[name]
    k = rec["config"]["k"]
    s = heat64
    p = BUILDERS[pre](s)
    for key in ("lmin", "lmax"):
        if key in rec:
            assert math.isclose(getattr(p, key), rec[key], rel_tol=1e-10), key
    if pre == "amg":
        assert [L.A.shape[0] for L in p.levels] == rec["amg_levels"]
    kw = dict(k=k, tol=TOL, pre=p, constraints=s.constraints())
    xh, ih = tcgmres.cgmres(s.A, s.b, **kw)
    xd, idv = tcgmres.cgmres(s.A, s.b, loop="while", **kw)
    r = rec["cgmres"]
    assert idv["safety"] == r["safety"] == ih["safety"]
    assert abs(idv["steps"] - r["steps"]) <= 1
    true_res = float(torch.linalg.norm(s.A @ xd - s.b))
    if r["safety"] and r["true_residual"] < TOL:
        assert idv["deviation"] <= 1e-10 and true_res < TOL
    else:
        assert math.isclose(true_res, r["true_residual"], rel_tol=1e-6)
    assert torch_parity.rel_max(xd.numpy(), xh.numpy()) <= 1e-10
    for nm, v in r["invariants"].items():
        got = float(s.compute_invariants(xd)[nm])
        assert math.isclose(got, v, rel_tol=1e-9, abs_tol=1e-12), nm


def test_time_cgmres_on_the_device_core():
    """The TimedSolve row at heat M=32 with the AMG on the device core
    (both solvers, as the JAX package's ``time_cgmres``): its keys are the
    host loop's and the device core's timings, its counts and latch the
    host loop's, and it certifies; ``gmres`` on the
    device core takes the host loop's steps and iterate."""
    rows = {loop: tts.time_cgmres("heat", M=32, device="cpu", loop=loop)
            for loop in ("host", "while")}
    host, dev = rows["host"], rows["while"]
    assert set(dev) - set(host) == {"time_capture", "time_setup"}
    for key in ("steps", "gmres_steps", "constrained_steps", "safety"):
        assert dev[key] == host[key], key
    assert dev["safety"] is True and dev["res_final"] < TOL
    assert dev["time_capture"] == 0.0  # nothing to capture on the CPU
    rec = REF.load("heat_M32")["heat_M32"]
    assert dev["gmres_steps"] == rec["gmres"]["steps"]
    assert abs(dev["steps"] - rec["cgmres"]["steps"]) <= 1
    s = theat.linforms(M=32, device="cpu")
    p = BUILDERS["amg"](s)
    xh, ih = gmres(s.A, s.b, k=20, tol=TOL, pre=p)
    xd, idv = gmres(s.A, s.b, k=20, tol=TOL, pre=p, loop="while")
    assert idv["steps"] == ih["steps"] and idv["breakdown"] == ih["breakdown"]
    np.testing.assert_allclose(idv["res"], ih["res"], rtol=1e-8)
    assert torch_parity.rel_max(xd.numpy(), xh.numpy()) <= 1e-10
    # the device core records the history too (r0, then each iterate)
    _, ihh = gmres(s.A, s.b, k=20, tol=TOL, pre=p, history=True)
    _, idh = gmres(s.A, s.b, k=20, tol=TOL, pre=p, loop="while", history=True)
    assert idh["x"].shape == ihh["x"].shape == (ih["steps"] + 1, s.b.shape[0])
    assert torch_parity.rel_max(idh["x"].numpy(), ihh["x"].numpy()) <= 1e-10


def test_fused_evolve_heat_matches_record():
    name = "heat_M64_amg_fused"
    rec = REF.load(name)[name]
    problem, params, k, tol, _ = REF.FUSED[name]
    s0 = theat.linforms(device="cpu", **params)
    pre = BUILDERS["amg"](s0)
    out = fused_evolve(problem, k=k, tol=tol, pre=pre, device="cpu", **params)
    assert list(map(int, out["steps"])) == rec["steps"]
    assert list(map(int, out["safety"])) == rec["safety"] == [1, 1, 1]
    assert not out["fallbacks"].any()
    np.testing.assert_allclose(out["time"], rec["time"], rtol=1e-14)
    for key in ("mass", "energy"):
        np.testing.assert_allclose(out[key], rec["series"][key], rtol=0,
                                   atol=1e-10)
    for key in ("dm", "de"):
        np.testing.assert_allclose(out[key], rec["drift"][key], rtol=0,
                                   atol=1e-10)
    assert math.isclose(float(out["sol"].abs().max()), rec["sol_max"],
                        rel_tol=1e-10)
    # against the same steps' invariants taken from the initial state, as
    # an evolution that passes no zold would: heat's energy moves
    z, old = s0.z0, []
    for _ in range(len(rec["steps"])):
        s = s0.step_update(z)
        x, info = tcgmres.cgmres(s.A, s.b, z, k=k, tol=tol, pre=pre,
                                 constraints=s.constraints())
        old.append(float(s0.compute_invariants(x)["energy"]))
        z = x
    np.testing.assert_allclose(old[0], rec["series"]["energy"][0], atol=1e-10)
    assert max(abs(a - b) for a, b in zip(old[1:],
                                         rec["series"]["energy"][1:])) > 1e-6
