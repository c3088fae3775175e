"""General (callable) constraints in the port's solvers, and lkdv's
TimedSolve row, in f64 on the CPU.

A ``GeneralConstraint`` gets a ``torch.func`` Taylor model about the warm
coefficients at every constrained iteration; for a quadratic g that model
is exact, so the solves must match the quadratic path: the same safety, the
invariant deviations within 1e-10 and the iterate within 1e-6 relative
(the bars of tests/test_cgmres_lkdv.py::
test_general_constraint_matches_quadratic).  The lkdv TimedSolve row,
which the JAX package runs unpreconditioned, is held against the JAX
record (``reference/slice7.json``): steps within one, the same safety.
"""

import importlib
import json

import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch.constraints import GeneralConstraint
from structurepreservingiterativesolvers_torch.experiments.cli import main
from structurepreservingiterativesolvers_torch.models import lkdv, lkdvrk
from structurepreservingiterativesolvers_torch.solvers import cgmres, cgmres_p

# the module (the experiments package exports a function of the same name,
# as the JAX package's does)
tts = importlib.import_module(
    "structurepreservingiterativesolvers_torch.experiments.timed_solve")

RECORD = (torch_parity.ROOT / "structurepreservingiterativesolvers_torch"
          / "reference" / "slice7.json")


def _energy(s, z):
    """The energy deviation of a 3-field vector z of system s."""
    u, _, w = torch.split(z, s.n0)
    return (0.5 * torch.dot(w, s.Mmat @ w) - 0.5 * torch.dot(u, s.Mmat @ u)
            - s.e0)


def _deviations(s, x):
    inv = s.compute_invariants(x)
    return np.array([float(inv[k] - getattr(s, a)) for k, a in
                     (("mass", "m0"), ("momentum", "mo0"), ("energy", "e0"))])


def test_stage_energy_as_general_constraint():
    """The reference's dict-form energy on the lkdvRK stage system (the
    energy of the reconstructed z1, lkdvRK/LinearSolver.py:29-76) as a
    callable, against its stage-mapped quadratic, with the RAS + Neumann
    composite."""
    s = lkdvrk.linforms(N=10, M=50, degree=3, tstages=2, device="cpu")
    pre = tts.default_pre_builder("lkdvrk")(s)
    mass, mom, energy_q = s.constraints()
    gen = GeneralConstraint(func=lambda X: _energy(s, s.z1calc(X)),
                            name="energy")
    kw = dict(k=50, tol=1e-8, pre=pre)
    xq, iq = cgmres(s.A, s.b, constraints=[mass, mom, energy_q], **kw)
    xg, ig = cgmres(s.A, s.b, constraints=[mass, mom, gen], **kw)
    assert ig["safety"] is iq["safety"] is True
    assert ig["steps"] == iq["steps"]
    dq, dg = _deviations(s, xq), _deviations(s, xg)
    assert np.abs(dg).max() < 1e-10 and np.abs(dg - dq).max() <= 1e-10
    np.testing.assert_allclose(xg.numpy(), xq.numpy(), rtol=1e-6, atol=1e-12)


def test_prototypical_cgmres_takes_general_constraints():
    """CGMRES-p enforces a general constraint cumulatively as it does a
    quadratic one (the reference SingleSolve, lkdv/SingleSolve.py:31-34)."""
    s = lkdv.linforms(degree=1, M=50, N=100, device="cpu")
    mass, mom, energy_q = s.constraints()
    gen = GeneralConstraint(func=lambda x: _energy(s, x), name="energy")
    xq, iq = cgmres_p(s.A, s.b, k=20, constraints=[mass, mom, energy_q])
    xg, ig = cgmres_p(s.A, s.b, k=20, constraints=[mass, mom, gen])
    assert ig["name"] == "geosolve" and ig["steps"] == iq["steps"] == 20
    dq, dg = _deviations(s, xq), _deviations(s, xg)
    assert np.abs(dg).max() < 1e-10 and np.abs(dg - dq).max() <= 1e-10


def test_timed_lkdv_matches_jax_record(capsys):
    """``timed --problem lkdv`` runs unpreconditioned, as the JAX package's
    ``default_pre_builder`` gives it, and reports the JAX record's steps
    and safety."""
    rec = json.loads(RECORD.read_text())["lkdv_M50_timed"]
    assert rec["config"]["k"] == 20 and rec["config"]["tol"] == 1e-7
    out = tts.time_cgmres("lkdv", M=50, device="cpu")
    assert abs(out["gmres_steps"] - rec["gmres"]["steps"]) <= 1
    assert abs(out["steps"] - rec["cgmres"]["steps"]) <= 1
    assert abs(out["constrained_steps"] - rec["cgmres"]["constrained_steps"]) <= 1
    assert out["safety"] is rec["cgmres"]["safety"] is True
    main(["timed", "--problem", "lkdv", "--sizes", "50", "--device", "cpu"])
    row = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("| 50 |")]
    assert len(row) == 1 and row[0].split("|")[2].strip() == "True"


@pytest.mark.parametrize("problem", ["lkdvrk", "lkdvRK"])
def test_get_model_knows_lkdvrk(problem):
    from structurepreservingiterativesolvers_torch.experiments.single_solve import (
        get_model,
        single_solve,
    )

    assert get_model(problem) is lkdvrk
    out = single_solve(problem, k=20, M=20, degree=1, N=10, device="cpu",
                       verbose=False)
    assert max(abs(d) for d in out["deviations"]["cgmres"].values()) < 1e-10
