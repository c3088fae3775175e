"""swe's skew-normal Chebyshev preconditioner in the PyTorch port against
the JAX package, on the CPU in f64: the builder and its apply, and the swe
TimedSolve row it serves against ``reference/slice4.json``."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch import precond as tprecond
from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
    default_pre_builder,
    time_cgmres,
)
from structurepreservingiterativesolvers_torch.models import swe as tswe
from structurepreservingiterativesolvers_tpu import precond as jprecond
from structurepreservingiterativesolvers_tpu.models import swe as jswe

SCRIPT = torch_parity.reference_script()


@pytest.mark.parametrize("params", [dict(M=16, N=5, T=1.0), dict(M=32)],
                         ids=["M16_dt0.2", "M32_dt0.1"])
def test_skew_normal_chebyshev_matches_jax(params):
    """Degree, bounds and the apply of the port's builder on the port's twin
    of the operator, against the JAX package's on its own."""
    js = jswe.linforms(**params)
    ts = torch_parity.to_port(js)
    a = 1.0 / js.prob.dt
    jpre = jprecond.skew_normal_chebyshev(js.A, a=a)
    tpre = tprecond.skew_normal_chebyshev(ts.A, a=a)
    assert tpre.degree == jpre.degree
    for key in ("a", "lmin", "lmax"):
        assert math.isclose(getattr(tpre, key), getattr(jpre, key),
                            rel_tol=1e-12), key
    v = np.random.default_rng(0).standard_normal(ts.b.shape[0])
    torch_parity.close(tpre(torch.from_numpy(v)).numpy(),
                       np.asarray(jpre(jnp.asarray(v))), 1e-12)
    # a fixed degree and a given ρ(K) are taken as they are
    fixed = tprecond.skew_normal_chebyshev(ts.A, a=a, rho_k=3.0, degree=4)
    assert fixed.degree == 4 and fixed.lmax == a * a + 9.0


def test_swe_timed_row_matches_record():
    """``default_pre_builder("swe")`` and the TimedSolve row of the port at
    M=32, against the JAX record ``swe_M32_snc`` (the fused orthogonalisation
    takes its plain twin here)."""
    rec = SCRIPT.load("swe_M32_snc")["swe_M32_snc"]
    pre = default_pre_builder("swe")(tswe.linforms(M=32, device="cpu"))
    assert isinstance(pre, tprecond.SkewNormalChebyshev)
    assert pre.degree == rec["degree"]
    for key in ("lmin", "lmax"):
        assert math.isclose(getattr(pre, key), rec[key], rel_tol=1e-12), key
    out = time_cgmres("swe", M=32, k=20, tol=1e-7, device="cpu",
                      ortho="cgs2_fused")
    assert out["gmres_steps"] == rec["gmres"]["steps"]
    assert out["steps"] == rec["cgmres"]["steps"]
    assert out["constrained_steps"] == rec["cgmres"]["constrained_steps"]
    assert out["safety"] is rec["cgmres"]["safety"] is True
    beta = rec["beta"]
    for got, want in ((out["res_final"], rec["cgmres"]["res"]),
                      (out["gmres_res_final"], rec["gmres"]["res"])):
        assert math.isclose(got, want, rel_tol=1e-6, abs_tol=1e-12 * beta)
    for nm in out["invariant_names"]:
        assert out["conservation"][f"cgmres_{nm}"] <= 1e-10
