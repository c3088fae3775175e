"""The port's f32 storage mode on heat P2 (the unstructured operator, ELL
of width 19, with the JAX package's greedy host AMG), on the CPU, against
the JAX package's f32 runs (``reference/slice17.json``: ``amg(A_csr,
dtype=float32)``, ``cgmres_wrapper`` at k=60 and tol 1e-6, 1e-5 and
1e-4 times ||b||; the JAX package is not run here):

* the hierarchy built in f64 on the host and cast (``precond/amg.py``):
  its levels' sizes, formats and widths the record's, every level in f32;
* CGMRES on both loops at the records' tolerances: the latch equal, the
  steps within one (at 1e-5 and 1e-6·||b|| the JAX solve runs to k, the
  f32 residual floor, and so does the port's), the certified deviation at
  most max(10x the record's, 1e-12 of the invariants' scale), the true
  residual below tol where the record's is, x within max(1e-5·max|x|, 10x
  the JAX package's own drift under a one-ulp change of b);
* the ELL's f64 product from f32 storage (``ops/sparse.py::matvec_f64``)
  against the recorded double-f32 ``_dd_matvec`` (1e-14 of max|y|);
* ``cgmres_many`` in f32 at B = 3 (item i ``step_update(z0 + 0.02 i·p)``)
  against each item's single f32 device-core solve: the same steps and
  latch, x within 1e-5 of max|x|;
* the projection's Newton step on a window where two constraints'
  gradients are nearly parallel (lkdvRK's momentum and energy over a
  stage's u field): bounded, and lowering the deviations it can reach,
  where the JAX package's 1e-12 Tikhonov floor gives a step that raises
  them by orders;
* the projection from deviations whose dense Newton steps are a sixth of
  an f32 ulp (a model of heat P2's two invariants at n = 10^6, where the
  projection stalled): certified to 1e-12, where rounding each step to
  the nearest f32 moves nothing.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch.constraints import projection
from structurepreservingiterativesolvers_torch.constraints.quadratic import (
    QuadraticConstraint,
)
from structurepreservingiterativesolvers_torch.experiments import wrappers
from structurepreservingiterativesolvers_torch.experiments.batched import (
    cgmres_many,
)
from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
    certified_deviations,
    default_pre_builder,
)
from structurepreservingiterativesolvers_torch.models import heat
from structurepreservingiterativesolvers_torch.ops.sparse import DIA, ELL, matvec_f64
from structurepreservingiterativesolvers_torch.solvers import cgmres

SCRIPT = torch_parity.reference_script()
REC = SCRIPT.load("heat_P2_M16_f32")
F32 = torch.float32


def _system(M):
    s = heat.linforms(M=M, degree=2, device="cpu", dtype=F32)
    return s, default_pre_builder("heat")(s)


@pytest.mark.parametrize("M", [16, 32])
def test_p2_f32_hierarchy_matches_record(M):
    rec = REC[f"heat_P2_M{M}_f32"]
    s, pre = _system(M)
    assert torch_parity.operator_format(s.A) == rec["operator"]
    levels = [{"n": int(L.A.shape[0]), **torch_parity.operator_format(L.A)}
              for L in pre.levels]
    assert levels == rec["amg_levels"]
    assert all(L.A.dtype == F32 for L in pre.levels)
    assert all(t.vals.dtype == F32 for L in pre.levels[:-1]
               for t in (L.P, L.R))
    assert pre.coarse_inv.dtype == F32


@pytest.mark.parametrize("loop", ["host", "while"])
def test_p2_f32_solve_matches_record(loop):
    rec = REC["heat_P2_M16_f32"]
    s, pre = _system(16)
    scale = max(max(abs(float(c.c)) for c in s.constraints()), 1.0)
    for tol, r in rec["solves"].items():
        tol_abs = r["tol_abs"]
        assert abs(tol_abs - float(tol) * rec["beta"]) <= 1e-12 * tol_abs
        assert wrappers.reduction_mode(s, tol_abs) == r["reduction_mode"]
        x, info = wrappers.cgmres_wrapper(s, k=rec["config"]["k"],
                                          tol=tol_abs, pre=pre, loop=loop)
        assert x.dtype == F32
        assert info["safety"] == r["safety"], tol
        assert abs(info["steps"] - r["steps"]) <= 1, (tol, info["steps"])
        dev = certified_deviations(s, x)
        bar = max(10.0 * max(r["certified"].values()), 1e-12 * scale)
        assert max(dev.values()) <= bar, (tol, dev, r["certified"])
        if r["true_residual"] < tol_abs:
            assert float(torch.linalg.norm((s.A @ x - s.b).double())) < tol_abs
        ref = np.asarray(r["x"])
        err = np.abs(x.double().numpy() - ref).max()
        assert err <= max(1e-5, 10.0 * r["own_drift"]) * np.abs(ref).max()


def test_ell_matvec_f64_matches_dd_matvec():
    rec = REC["dd_matvec_f32"]["ops"]["ELL"]
    s = heat.linforms(M=16, degree=2, device="cpu", dtype=F32)
    assert isinstance(s.Emat, ELL) and s.Emat.dtype == F32
    x = np.random.default_rng(rec["seed"]).standard_normal(
        rec["n"]).astype(np.float32)
    y = matvec_f64(s.Emat, torch.from_numpy(x))
    ref = np.asarray(rec["y"])
    assert y.dtype == torch.float64
    assert np.abs(y.numpy() - ref).max() <= 1e-14 * np.abs(ref).max()


def test_p2_f32_batch_matches_single_solves():
    s, pre = _system(16)
    field = torch.as_tensor(SCRIPT.heat_p2_field(s.prob.fem(),
                                                 s.z0.double().numpy()),
                            dtype=F32)
    items = [s.step_update(s.z0 + 0.02 * i * field) for i in range(3)]
    tol = 1e-4 * REC["heat_P2_M16_f32"]["beta"]
    cons = [t.constraints() for t in items]
    X, info = cgmres_many(s.A, torch.stack([t.b for t in items]), cons,
                          k=60, tol=tol, pre=pre)
    assert X.dtype == F32
    for i, t in enumerate(items):
        x, single = cgmres(s.A, t.b, k=60, tol=tol, constraints=cons[i],
                           pre=pre, loop="while", snap=False,
                           f32_reduce=False)
        assert int(info["steps"][i]) == single["steps"]
        assert int(info["safety"][i]) == 1 and single["safety"] is True
        assert (X[i] - x).abs().max() <= 1e-5 * x.abs().max()


def test_projection_window_step_on_parallel_gradients():
    """Two gradients parallel to 1e-9 over the window (the f32 Gram
    matrix's rounding is 1e-7 of its trace): the step keeps the linear
    model's residual below the entry deviation and stays small."""
    rng = np.random.default_rng(9)
    n = 2048
    a = rng.standard_normal(n) * 1e-4
    b = rng.standard_normal(n) * 1e-4
    D = torch.as_tensor(np.stack([a, -a + 1e-9 * b]), dtype=F32)
    g = torch.tensor([2.35e-9, -2.68e-9], dtype=torch.float64)
    x = torch.zeros(n, dtype=F32)
    step = projection._newton_direction(D, x, g)
    after = g + (D.double() @ step.double())
    assert step.abs().max() < 1e-5
    assert after.abs().max() < 0.2 * g.abs().max()



def test_projection_sub_ulp_dense_steps():
    """heat P2's projection stall at n ≥ 5.9e5, on a model of its two
    invariants at n = 10^6: a mass with weights 1/n and an energy ½xᵀEx
    whose E couples neighbours 5e4 times more strongly than it weighs them
    (as heat P2's M + ½dt·K does), at an f32 x in [-0.45, -0.3], the
    deviations g = (-5e-9, 3e-10).  A dense Newton step is then about
    5e-9 a component, a sixth of an ulp: rounded to the nearest f32 it
    moves nothing, and a window's step raises the energy through E's
    coupling (the projection stalls near 1e-9).  The dithered rounding of
    the dense stages (``projection._dithered``) realises it: both
    deviations end at most 1e-12 and within the certified floor."""
    n = 10 ** 6
    i = torch.arange(n, dtype=torch.float64)
    w = torch.full((n,), 1.0 / n, dtype=torch.float64)
    side = torch.full((n,), -0.05, dtype=torch.float64)
    E = DIA(torch.stack([side, w + 0.1, side]).to(F32), (-1, 0, 1), (n, n),
            True)
    x = (-0.3 - 0.15 * torch.sin(2 * np.pi * i / n) ** 2).to(F32)
    zero = torch.zeros((), dtype=torch.float64)
    cons = []
    for con, off in ((QuadraticConstraint(M=None, v=w.to(F32), c=zero), -5e-9),
                     (QuadraticConstraint(M=E, v=None, c=zero), 3e-10)):
        # c in f64: g(x) = off to f64 roundoff
        cons.append(dataclasses.replace(
            con, c=off - projection.value_f64(con, x)))
    xs, g = projection.snap(x, cons)
    assert xs.dtype == F32
    assert g.abs().max() <= 1e-12
    assert bool((g.abs() <= projection.certified_floor(cons, xs, 1e-12)).all())
    assert torch.equal(g, projection._deviations(cons, xs))
