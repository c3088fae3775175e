"""The Jacobi and polynomial preconditioners of the PyTorch port
(``precond/jacobi.py``, ``precond/chebyshev.py``) against the JAX package,
on the CPU in f64, and the third slice at a small size: the heat TimedSolve
row with a Chebyshev or Neumann pre-builder.

Tolerances:

* the diagonal and the Jacobi inverse are copies: equal to rounding;
* the spectral bounds come from the same 30 power iterations from the same
  start, with norms summed in another order: 1e-12 relative;
* solves: ``steps``, ``constrained_steps`` and ``safety`` equal; residuals
  and the KKT deviation to 1e-6 relative (above a 1e-12 floor, as the
  record check has it), invariants to 1e-12;
* the JAX package's own bars of ``tests/test_precond.py``.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import torch_parity
from structurepreservingiterativesolvers_torch import precond as tpre
from structurepreservingiterativesolvers_torch import solvers as tsol
from structurepreservingiterativesolvers_torch.experiments import wrappers as twr
from structurepreservingiterativesolvers_torch.ops import sparse as tsp
from structurepreservingiterativesolvers_tpu import precond as jpre
from structurepreservingiterativesolvers_tpu import solvers as jsol
from structurepreservingiterativesolvers_tpu.experiments import wrappers as jwr
from structurepreservingiterativesolvers_tpu.ops import sparse as jsp
from structurepreservingiterativesolvers_tpu.precond.chebyshev import (
    power_bounds as jpower_bounds,
)

# the module (the experiments package exports a function of the same name,
# as the JAX package's does)
tts = importlib.import_module(
    "structurepreservingiterativesolvers_torch.experiments.timed_solve")

# the JAX package's experiments namespace exports a function of this name
jts = importlib.import_module(
    "structurepreservingiterativesolvers_tpu.experiments.timed_solve")

TOL = 1e-7
BUILDERS = {  # name -> (JAX builder, port builder), as a user writes them
    "cheb8": (lambda s: jpre.chebyshev(s.A, degree=8),
              lambda s: tpre.chebyshev(s.A, degree=8)),
    "neu4": (lambda s: jpre.neumann(s.A, degree=4),
             lambda s: tpre.neumann(s.A, degree=4)),
}


@pytest.fixture(scope="module")
def systems():
    """Getters of (JAX system, port twin, JAX preconditioner) per heat M."""
    return {name: torch_parity.heat_systems(jb)
            for name, (jb, _) in BUILDERS.items()}


def test_jacobi_diagonal_extraction():
    A = sp.csr_matrix(sp.diags([1.0, 5.0, 1.0], [-1, 0, 1], shape=(32, 32)))
    Aj, At = jsp.dia_from_scipy(A), tsp.dia_from_scipy(A, device="cpu")
    np.testing.assert_allclose(tpre.diagonal(At).numpy(), A.diagonal())
    v = np.random.default_rng(7).standard_normal(32)
    y = tpre.jacobi(At)(torch.as_tensor(v)).numpy()
    np.testing.assert_allclose(y, v / 5.0)
    np.testing.assert_array_equal(y, np.asarray(jpre.jacobi(Aj)(jnp.asarray(v))))


def test_diagonal_of_heat_and_of_no_main_diagonal(systems):
    js, ts, _ = systems["cheb8"](16)
    assert type(ts.A).__name__ == "Stencil"
    np.testing.assert_array_equal(tpre.diagonal(ts.A).numpy(),
                                  np.asarray(jpre.diagonal(js.A)))
    np.testing.assert_array_equal(tpre.jacobi(ts.A).dinv.numpy(),
                                  np.asarray(jpre.jacobi(js.A).dinv))
    # no 0 offset: zeros, and a Jacobi of ones
    A = sp.csr_matrix(sp.diags([1.0, 1.0], [-1, 1], shape=(8, 8)))
    At = tsp.dia_from_scipy(A, device="cpu")
    assert not tpre.diagonal(At).any()
    assert bool((tpre.jacobi(At).dinv == 1.0).all())
    with pytest.raises(NotImplementedError):  # not an operator of the port
        tpre.diagonal(object())


def test_bounds_match_jax(systems):
    js, ts, pj = systems["cheb8"](32)
    pt = tpre.chebyshev(ts.A, degree=8)
    for key in ("lmin", "lmax"):
        assert math.isclose(getattr(pt, key), getattr(pj, key), rel_tol=1e-12)
    for a, b in zip(tpre.power_bounds(ts.A), jpower_bounds(js.A)):
        assert math.isclose(a, b, rel_tol=1e-12)
    # where a bound is missing and the estimate runs, an explicit 0.0 counts
    # as not given; with both given, nothing is estimated: as in the JAX
    # package
    q = tpre.chebyshev(ts.A, lmin=0.0)
    assert math.isclose(q.lmin, pj.lmin, rel_tol=1e-12)
    assert math.isclose(q.lmax, pj.lmax, rel_tol=1e-12)
    q, qj = (tpre.chebyshev(ts.A, lmin=0.0, lmax=5.0),
             jpre.chebyshev(js.A, lmin=0.0, lmax=5.0))
    assert (q.lmin, q.lmax) == (qj.lmin, qj.lmax) == (0.0, 5.0)
    assert pt.fused is False  # a CPU operator keeps the unfused recurrence
    assert tpre.chebyshev(ts.A, 0.1, 5.0, fused=True).fused is True


def test_chebyshev_accelerates_heat(systems):
    js, ts, pj = systems["cheb8"](32)
    pre = tpre.chebyshev(ts.A, degree=8)
    _, plain = tsol.gmres(ts.A, ts.b, k=30, tol=TOL)
    _, cheb = tsol.gmres(ts.A, ts.b, k=30, tol=TOL, pre=pre)
    assert cheb["res"][-1] < TOL
    assert cheb["res"][-1] < plain["res"][-1] * 1e-2
    _, ref = jsol.gmres(js.A, js.b, k=30, tol=TOL, pre=pj)
    assert cheb["steps"] == ref["steps"]
    assert math.isclose(cheb["res"][-1], float(ref["res"][-1]), rel_tol=1e-6)


def test_neumann_valid_preconditioner(systems):
    js, ts, pj = systems["neu4"](16)
    x, info = tsol.gmres(ts.A, ts.b, k=40, tol=1e-9, pre=tpre.neumann(ts.A))
    x_dir = spla.spsolve(ts.A_csr, ts.b.numpy())
    np.testing.assert_allclose(x.numpy(), x_dir, rtol=1e-5, atol=1e-8)
    _, ref = jsol.gmres(js.A, js.b, k=40, tol=1e-9, pre=pj)
    assert info["steps"] == ref["steps"]


def _check_solve(it, ij, xt, xj, ts, js):
    for key in ("steps", "constrained_steps", "safety"):
        if key in ij:
            assert it[key] == ij[key], key
    assert math.isclose(it["res"][-1], float(ij["res"][-1]), rel_tol=1e-6,
                        abs_tol=1e-12)
    if "deviation" in ij:
        assert math.isclose(it["deviation"], float(ij["deviation"]),
                            rel_tol=1e-6, abs_tol=1e-12)
    inv_t, inv_j = ts.compute_invariants(xt), js.compute_invariants(xj)
    for key in inv_j:
        assert math.isclose(float(inv_t[key]), float(inv_j[key]),
                            rel_tol=1e-12, abs_tol=1e-14), key


@pytest.mark.parametrize("name,M,k", [("cheb8", 32, 30), ("neu4", 16, 30)])
def test_slice_matches_jax(systems, name, M, k):
    """GMRES and CGMRES with the polynomial preconditioner, and the
    TimedSolve row through ``time_cgmres(pre_builder=...)``, as a JAX user
    runs them."""
    js, ts, pj = systems[name](M)
    jb, tb = BUILDERS[name]
    pt = tb(ts)
    for jcall, tcall in ((jwr.gmres_wrapper, twr.gmres_wrapper),
                         (jwr.cgmres_wrapper, twr.cgmres_wrapper)):
        xj, ij = jcall(js, k=k, tol=TOL, pre=pj)
        xt, it = tcall(ts, k=k, tol=TOL, pre=pt)
        _check_solve(it, ij, xt, xj, ts, js)
    out_j = jts.time_cgmres("heat", M=M, k=k, tol=TOL, pre_builder=jb)
    out_t = tts.time_cgmres("heat", M=M, k=k, tol=TOL, pre_builder=tb,
                            device="cpu")
    assert set(out_t) == set(out_j)
    for key in ("steps", "gmres_steps", "constrained_steps", "safety"):
        assert out_t[key] == out_j[key], key
    for key in ("res_final", "gmres_res_final"):
        assert math.isclose(out_t[key], out_j[key], rel_tol=1e-6)
    assert out_t["safety"] is True and out_t["res_final"] < TOL
