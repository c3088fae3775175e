"""The port's f32 storage arithmetic against the JAX package's, on the CPU:

* ``ops/sparse.py::matvec_f64`` (f32 loads, f64 products and sums; the
  plain version of the mixed kernel #1 here) against the JAX package's
  double-f32 ``_dd_matvec``, and ``constraints/quadratic.py::value_f64``
  against its ``dd_constraint_value``, at the same f32 x (made with numpy
  from a seed), within 1e-12 of the sum of the magnitudes of the terms;
* ``constraints/projection.py::snap`` from the perturbed swe M=64 point of
  the JAX package's ``tests/test_projection.py::
  test_snap_reaches_near_ulp_deviation``: the certified deviations at most
  1e-11 of the invariants' scale and never above the entry, the
  displacement below 1e-2·||x||, the reported values those of an
  independent f64 evaluation at the returned x;
* the refusals: ``snap=True`` with a general constraint raises
  ``ValueError`` naming it (JAX ``tests/test_solver_options.py:80-98``);
  f32 storage with a general constraint or lkdvRK's stage-mapped
  constraints, refused before the seventeenth slice, now solves.

The JAX package runs live here, in f32 storage, at M ≤ 64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structurepreservingiterativesolvers_torch.constraints import (
    projection as tproj,
)
from structurepreservingiterativesolvers_torch.constraints.general import (
    GeneralConstraint as TGeneral,
)
from structurepreservingiterativesolvers_torch.constraints.quadratic import (
    value_and_scale_f64,
    value_f64,
)
from structurepreservingiterativesolvers_torch.models import heat as theat
from structurepreservingiterativesolvers_torch.models import lkdv as tlkdv
from structurepreservingiterativesolvers_torch.models import lkdvrk as tlkdvrk
from structurepreservingiterativesolvers_torch.models import swe as tswe
from structurepreservingiterativesolvers_torch.ops.sparse import matvec_f64
from structurepreservingiterativesolvers_torch.solvers import cgmres
from structurepreservingiterativesolvers_tpu.constraints import quadratic as jq
from structurepreservingiterativesolvers_tpu.models import heat as jheat
from structurepreservingiterativesolvers_tpu.models import lkdv as jlkdv
from structurepreservingiterativesolvers_tpu.models import swe as jswe
from structurepreservingiterativesolvers_tpu.ops import dd

F32 = torch.float32
# the bar on an f64 value against the double-f32 one: of the sum of the
# magnitudes of its terms (both are within 2^-48 of it)
VALUE_RTOL = 1e-12
MODELS = {"swe": (tswe, jswe, dict(M=16)), "heat": (theat, jheat, dict(M=16)),
          "lkdv": (tlkdv, jlkdv, dict(M=50, degree=1))}


def _pair(name):
    """The port's and the JAX package's f32 systems of ``MODELS[name]``."""
    tmod, jmod, params = MODELS[name]
    return (tmod.linforms(device="cpu", dtype=F32, **params),
            jmod.linforms(dtype=jnp.float32, **params))


def _x32(s, seed=0, size=1e-3):
    """z0 plus noise, rounded to f32 (numpy, from a seed)."""
    z0 = s.z0.double().numpy()
    g = np.random.default_rng(seed).standard_normal(z0.shape[0])
    return (z0 + size * np.abs(z0).max() * g).astype(np.float32)


@pytest.mark.parametrize("name,field", [("swe", "A"), ("heat", "Emat"),
                                        ("lkdv", "energy")])
def test_matvec_f64_matches_dd_matvec(name, field):
    """M @ x in f64 from f32 storage against the JAX double-f32 product on
    the same f32 operator and x: swe's wrapped A (DIA), heat's energy
    matrix (DIA, zero-filled) and lkdv's energy operator (the block
    operator's own product, a field at a time)."""
    ts, js = _pair(name)
    if field == "energy":
        tM, jM = ts.constraints()[2].M, js.constraints()[2].M
    else:
        tM, jM = getattr(ts, field), getattr(js, field)
    x = _x32(ts)
    y = matvec_f64(tM, torch.from_numpy(x))
    assert y.dtype == torch.float64
    ref = np.asarray(dd.to_f64(jq._dd_matvec(jM, dd.from_f32(jnp.asarray(x)))))
    terms = (tM.todense().double().abs() @ torch.from_numpy(x).double().abs())
    assert np.all(np.abs(y.numpy() - ref) <= VALUE_RTOL * terms.numpy() + 1e-300)


@pytest.mark.parametrize("name", list(MODELS))
def test_value_f64_matches_dd_constraint_value(name):
    """Each constraint's value at an f32 x, in f64, against the JAX
    ``dd_constraint_value`` of the same stored constraint; and its scale is
    the sum of the terms' magnitudes."""
    ts, js = _pair(name)
    x = _x32(ts, seed=1)
    for tc, jc in zip(ts.constraints(), js.constraints()):
        val, scale = value_and_scale_f64(tc, torch.from_numpy(x))
        assert float(val) == float(value_f64(tc, torch.from_numpy(x)))
        ref = float(jq.dd_constraint_value(jc, dd.from_f32(jnp.asarray(x))))
        assert abs(float(val) - ref) <= VALUE_RTOL * float(scale), tc.name


def _independent(s, x):
    """swe's mass and energy at x in numpy f64, from the system's stored
    f32 fields (ω and the energy scales as the constraint holds them)."""
    x = np.asarray(x, np.float64)
    n0 = s.n0
    omega = s.omega.double().numpy()
    scales = np.concatenate([np.full(n0, sc) for sc in s.Lfull.scales])
    return {"mass": float(omega @ x - float(s.m0)),
            "energy": float(0.5 * x @ (scales * x) - float(s.e0))}


def test_snap_reaches_near_ulp_deviation():
    """From the JAX test's perturbed f32 point near the swe M=64 solution,
    the projection certifies deviations of at most 1e-11 of the invariants'
    scale, never above the entry's, with a roundoff-sized displacement; its
    entry deviations are the JAX package's double-f32 ones."""
    ts = tswe.linforms(M=64, device="cpu", dtype=F32)
    js = jswe.linforms(M=64, dtype=jnp.float32)
    pert = np.random.default_rng(3).standard_normal(ts.b.shape[0]) * 1e-4
    x = ts.z0 + torch.as_tensor(pert, dtype=F32)
    cons = tuple(ts.constraints())
    scale = max(abs(float(ts.e0)), abs(float(ts.m0)))
    g0 = tproj._deviations(cons, x)
    jx = js.z0 + jnp.asarray(pert, jnp.float32)
    assert np.array_equal(np.asarray(jx), x.numpy())
    jg0 = [float(jq.dd_constraint_value(c, dd.from_f32(jx)))
           for c in js.constraints()]
    assert np.all(np.abs(g0.numpy() - jg0) <= 1e-12 * scale)
    x_sn, g = tproj.snap(x, cons)
    assert x_sn.dtype == F32
    assert bool((g.abs() <= g0.abs()).all())
    assert float(g.abs().max()) < 1e-11 * scale
    assert float(torch.linalg.norm(x_sn - x)) < 1e-2 * float(torch.linalg.norm(x))
    indep = _independent(ts, x_sn.numpy())
    for c, gi in zip(cons, g.tolist()):
        assert abs(gi - indep[c.name]) <= 1e-13 * scale, c.name


def test_refusals():
    """``snap=True`` with a general constraint raises ``ValueError`` naming
    it, before anything runs (JAX ``test_solver_options.py:80-98``); f32
    storage with a general constraint (without the snap) and with lkdvRK's
    stage-mapped constraints, which earlier slices refused, solves: the
    general one (the unit sphere, which ten Krylov steps cannot meet in f64
    either) as its f64 twin does, its latch tripped at the twin's
    deviation, and lkdvRK certified; with f64 storage the modes resolve
    off and an explicit ``snap=True`` changes nothing."""
    s = theat.linforms(M=16, device="cpu", dtype=F32)
    gen = TGeneral(func=lambda x: torch.dot(x, x) - 1.0, name="unit-sphere")
    with pytest.raises(ValueError, match="unit-sphere"):
        cgmres(s.A, s.b, k=10, tol=1e-5, constraints=(gen,), snap=True)
    s64 = theat.linforms(M=16, device="cpu")
    with pytest.warns(RuntimeWarning, match="failed to preserve"):
        x32, i32 = cgmres(s.A, s.b, k=10, tol=1e-5, constraints=(gen,))
        _, i64 = cgmres(s64.A, s64.b, k=10, tol=1e-5, constraints=(gen,))
    assert x32.dtype == F32
    assert (i32["steps"], i32["safety"]) == (i64["steps"], i64["safety"])
    assert abs(i32["deviation"] - i64["deviation"]) <= 1e-3 * i64["deviation"]
    rk = tlkdvrk.linforms(M=20, degree=3, tstages=2, device="cpu", dtype=F32)
    x, info = cgmres(rk.A, rk.b, k=10, tol=1e-5, constraints=rk.constraints())
    assert x.dtype == F32 and info["safety"] is True
    assert info["deviation"] <= 1e-8
    s64 = tlkdv.linforms(M=50, degree=1, device="cpu")
    x1, i1 = cgmres(s64.A, s64.b, k=20, tol=1e-8,
                    constraints=s64.constraints())
    x2, i2 = cgmres(s64.A, s64.b, k=20, tol=1e-8,
                    constraints=s64.constraints(), snap=True, mixed=True)
    assert torch.equal(x1, x2) and i1["steps"] == i2["steps"]
    assert i1["deviation"] == i2["deviation"]
