"""The port's f32 storage mode on its device core, on the CPU: the graph
runner's steps run eagerly here, so these hold the core's arithmetic and
control flow, held to the host loop and to the JAX package's runs
(``reference/slice15.json``):

* ``cgmres(loop="while")`` takes the host loop's steps and latch, and an
  iterate within the f32 rounding of the host loop's (lkdv M=50 from its
  warm start, heat M=32 with the AMG);
* ``cgmres_many`` in f32 (mixed by default, no projection, as the JAX
  package's): each item's steps equal to its single device-core solve's in
  the same modes, and the latch and certified deviation (within max(10x,
  1e-12 of the scale)) of the record's items (swe M=16 with the
  skew-normal Chebyshev, heat M=32 with the AMG, B = 3); the steps within
  one of the record's where the record's item stopped before k, else at
  most k.  (On swe M=16 two of the JAX package's items stall at a
  constrained residual of 7e-4-1e-3, above tol, and run to k=20; the
  port's reach 1e-4, the f32 floor of the unconstrained residual, and
  stop at step 3, certified, with the assembly's deviations of the same
  size as the record's.)
* a 3-step f32 ``fused_evolve`` on swe M=16: per step at most one step
  more than the JAX ``fused_evolve``'s, and certified on every step (each
  step warm-started): the port takes each step's targets as f64 sums of
  the upcast f32 state and, from a warm start over f32 storage, takes the
  endgame's roundoff floors at eps32 and lets the projection's f64
  certificate at the returned iterate set the latch, where the JAX record
  trips its first step's latch;
* a warm-started 3-step f32 ``evolve`` and ``fused_evolve`` on swe M=16
  certify every step, with f64 targets from ``step_update``, each host
  step's deviations, recomputed in numpy, within the certificate's floor;
* from a warm start the certificate decides the latch on both loops: a
  projection that leaves the iterate where it was trips it;
* the command line's ``--dtype float32``.
"""

import contextlib
import importlib
import io

import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch.constraints.quadratic import (
    value_f64,
)
from structurepreservingiterativesolvers_torch.experiments import wrappers
from structurepreservingiterativesolvers_torch.experiments.batched import (
    cgmres_many,
)
from structurepreservingiterativesolvers_torch.experiments.cli import main
from structurepreservingiterativesolvers_torch.experiments.evolve import (
    evolve,
    fused_evolve,
)
from structurepreservingiterativesolvers_torch.experiments.single_solve import (
    get_model,
)
from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
    certified_deviations,
    default_pre_builder,
)
from structurepreservingiterativesolvers_torch.solvers import cgmres

CG = importlib.import_module(
    "structurepreservingiterativesolvers_torch.solvers.cgmres")
SCRIPT = torch_parity.reference_script()
REC = SCRIPT.load("lkdv_M50_f32")
F32 = torch.float32


@pytest.mark.parametrize("name", ["lkdv_M50_f32_warm", "heat_M32_amg_f32"])
def test_device_core_matches_host_loop(name):
    kind, problem, params, k, tol, tol_mode, start, pre_spec = \
        SCRIPT.SLICE15[name]
    s = get_model(problem).linforms(device="cpu", dtype=F32, **params)
    pre = None if pre_spec is None else default_pre_builder(problem)(s)
    x0 = None
    if start == "warm":
        rng = np.random.default_rng(3)
        x0 = torch.as_tensor(s.b.double().numpy() + 1e-3 * rng.standard_normal(
            s.b.shape[0]), dtype=F32)
    tol_abs = REC[name]["tol_abs"]
    runs = {loop: cgmres(s.A, s.b, x0=x0, k=k, tol=tol_abs,
                         constraints=s.constraints(), pre=pre, loop=loop)
            for loop in ("host", "while")}
    (xh, ih), (xw, iw) = runs["host"], runs["while"]
    assert (iw["steps"], iw["safety"]) == (ih["steps"], ih["safety"])
    assert iw["constrained_steps"] == ih["constrained_steps"]
    torch_parity.close(xw.double().numpy(), xh.double().numpy(), 1e-4)


@pytest.mark.parametrize("name", ["swe_M16_B3_f32", "heat_M32_B3_f32"])
def test_batched_f32_matches_singles_and_record(name):
    kind, problem, params, k, tol, tol_mode, B, pre_spec = SCRIPT.SLICE15[name]
    rec = REC[name]
    s = get_model(problem).linforms(device="cpu", dtype=F32, **params)
    pre = default_pre_builder(problem)(s)
    z0 = s.z0.double().numpy()
    states = z0[None] + 0.02 * np.arange(B)[:, None] * SCRIPT.smooth_field(
        params["M"], z0, problem)[None]
    items = [s.step_update(torch.as_tensor(z, dtype=F32)) for z in states]
    X, info = cgmres_many(s.A, torch.stack([t.b for t in items]),
                          [t.constraints() for t in items], k=k,
                          tol=rec["tol_abs"], pre=pre)
    assert X.dtype == F32
    scale = max([abs(v) for v in rec["targets"].values()] + [1.0])
    for i, (t, ri) in enumerate(zip(items, rec["items"])):
        _, single = cgmres(s.A, t.b, k=k, tol=rec["tol_abs"],
                           constraints=t.constraints(), pre=pre, loop="while",
                           snap=False, f32_reduce=False)
        assert int(info["steps"][i]) == single["steps"], i
        assert int(info["safety"][i]) == ri["safety"], i
        if ri["steps"] < k:
            assert abs(int(info["steps"][i]) - ri["steps"]) <= 1, i
        assert int(info["steps"][i]) <= ri["steps"], i
        # no projection in the batch: the certified deviation is the f32
        # assembly's, as the record's
        dev = certified_deviations(t, X[i])
        bar = max(10.0 * max(ri["certified"].values()), 1e-12 * scale)
        assert max(dev.values()) <= bar, (i, dev, ri["certified"])


def test_fused_evolve_f32_matches_record():
    name = "swe_M16_fused_f32"
    kind, problem, params, k, tol, tol_mode, start, pre_spec = \
        SCRIPT.SLICE15[name]
    rec = REC[name]
    s = get_model(problem).linforms(device="cpu", dtype=F32, **params)
    pre = default_pre_builder(problem)(s)
    out = fused_evolve(problem, k=k, tol=rec["tol_abs"], pre=pre,
                       device="cpu", dtype=F32, **params)
    assert out["sol"].dtype == F32
    for got, want in zip(out["steps"].tolist(), rec["steps"]):
        assert got <= want + 1, (out["steps"], rec["steps"])
    # every step starts from the previous solution: each is certified, the
    # projection's f64 certificate at the returned iterate setting the latch
    assert out["safety"].tolist() == [1] * len(rec["safety"]), out["safety"]
    assert bool(torch.isfinite(out["sol"]).all())


def _certify_np(system, x):
    """swe's deviations (mass, energy) at the f32 iterate x and their
    floors, in numpy f64 from the system's fields: g = v·x − m0 and
    ½ x·(L x) − e0; the floor the largest of 1e-12, 32·eps64 times the
    sum of g's terms' magnitudes and 16·eps32·max_i |x_i ∂g/∂x_i|
    (``constraints/projection.py::certified_floor``)."""
    xd = x.double().numpy()
    v = system.omega.double().numpy()
    lx = np.concatenate([sc * p for sc, p in zip(
        system.Lfull.scales, np.split(xd, 3))])
    out = []
    for terms, grad in (((v @ xd, -float(system.m0)), v),
                        ((0.5 * xd @ lx, -float(system.e0)), lx)):
        g = sum(terms)
        floor = max(1e-12, 32 * np.finfo(np.float64).eps
                    * sum(abs(t) for t in terms),
                    16 * np.finfo(np.float32).eps * np.abs(xd * grad).max())
        out.append((abs(g), floor))
    return out


def test_f32_warm_evolutions_certify_every_step():
    """swe M=16 in f32, 3 steps, every step warm-started from the last
    solution: ``step_update``'s targets are the f64 sums of the upcast f32
    state (the certificate's own arithmetic), and both evolutions certify
    every step; each host step's mass and energy deviations at its returned
    iterate, recomputed in numpy f64, lie within the certificate's floor,
    and the reported deviation is their largest."""
    kind, problem, params, k, tol, tol_mode, start, pre_spec = \
        SCRIPT.SLICE15["swe_M16_fused_f32"]
    tol_abs = REC["swe_M16_fused_f32"]["tol_abs"]
    s = get_model(problem).linforms(device="cpu", dtype=F32, **params)
    s1 = s.step_update(s.z0)
    assert s1.m0.dtype == s1.e0.dtype == torch.float64
    assert float(s1.m0) == float(s.omega.double() @ s.z0.double())
    pre = default_pre_builder(problem)(s)
    fused = fused_evolve(problem, k=k, tol=tol_abs, pre=pre, device="cpu",
                         dtype=F32, **params)
    assert fused["safety"].tolist() == [1, 1, 1], fused["safety"]
    seen = []

    def solver(system, **kw):
        x, info = wrappers.cgmres_wrapper(system, **kw)
        seen.append((system, x, info))
        return x, info

    hosted = evolve(problem, k=k, tol=tol_abs, pre=pre, warm_start=True,
                    device="cpu", dtype=F32, solver=solver, **params)
    assert hosted["safety"] == [True, True, True], hosted["safety"]
    assert max(hosted["steps"]) <= k and max(fused["steps"].tolist()) <= k
    assert hosted["sol"].dtype == fused["sol"].dtype == F32
    for system, x, info in seen:
        devs = _certify_np(system, x)
        assert all(d <= f for d, f in devs), devs
        assert abs(info["deviation"] - max(d for d, _ in devs)) <= 1e-12 * max(
            abs(float(system.e0)), 1.0), (info["deviation"], devs)


@pytest.mark.parametrize("loop", ["host", "while"])
def test_f32_warm_certificate_sets_the_latch(loop, monkeypatch):
    """A warm-started f32 solve (swe M=32, k=20, tol 4e-7·||b||, the
    skew-normal Chebyshev, the first step from z0): with the projection the
    latch is OK; with a projection that leaves the iterate where it was,
    the assembly's rounding lies above the certificate's floor and the
    latch trips, on both loops."""
    s = get_model("swe").linforms(M=32, N=3, T=0.3, device="cpu", dtype=F32)
    pre = default_pre_builder("swe")(s)
    tol = 4e-7 * float(torch.linalg.norm(s.b.double()))
    s1 = s.step_update(s.z0)

    def solve():
        x, info = cgmres(s1.A, s1.b, x0=s1.z0, k=20, tol=tol,
                         constraints=s1.constraints(), pre=pre, loop=loop)
        return max(d / f for d, f in _certify_np(s1, x)), info["safety"]

    ratio, safety = solve()
    assert safety is True and ratio <= 1.0, (ratio, safety)
    monkeypatch.setattr(
        CG, "snap_iterate", lambda x, cons: (x, torch.stack(
            [value_f64(c, x) for c in cons])))
    with pytest.warns(RuntimeWarning, match="failed to preserve"):
        ratio, safety = solve()
    assert safety is False and ratio > 1.0, (ratio, safety)


def test_cli_dtype_float32():
    """``timed --dtype float32`` runs the row in f32 storage and prints the
    table with a certified CGMRES."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["timed", "--problem", "swe", "--sizes", "16", "--tol", "4e-7",
              "--tol-mode", "rhs", "--dtype", "float32", "--device", "cpu"])
    row = [line for line in buf.getvalue().splitlines()
           if line.startswith("| 16 |")]
    assert row and row[0].split("|")[2].strip() == "True"
