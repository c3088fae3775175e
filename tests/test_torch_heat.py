"""The heat TimedSolve path of the PyTorch port against the JAX package, on
the CPU in f64: assembly, GMRES and CGMRES with the structured AMG,
``time_cgmres`` and ``timed_solve``, and the committed JAX record of heat
M=32.  The AMG itself is held against the JAX package's in
``tests/test_torch_amg.py``.

Tolerances:

* assembly: both packages assemble in numpy/scipy, so they agree to
  rounding (1e-14 relative);
* solves: ``steps``, ``constrained_steps`` and ``safety`` equal; the
  iterate agrees to max(1e-8, 10× the JAX package's own drift under a
  1e-15 relative perturbation of b).
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch import solvers as tsol
from structurepreservingiterativesolvers_torch.models import heat as theat
from structurepreservingiterativesolvers_torch.ops.stencil import Stencil
from structurepreservingiterativesolvers_tpu import solvers as jsol
from structurepreservingiterativesolvers_tpu.models import heat as jheat

# the module (the experiments package exports a function of the same name,
# as the JAX package's does)
tts = importlib.import_module(
    "structurepreservingiterativesolvers_torch.experiments.timed_solve")

# the JAX package's experiments namespace exports a function of this name
jts = importlib.import_module(
    "structurepreservingiterativesolvers_tpu.experiments.timed_solve")

K, TOL = 20, 1e-7  # time_cgmres's defaults
_close = torch_parity.close


@pytest.fixture(scope="module")
def systems():
    return torch_parity.heat_systems()


def test_assembly_matches_jax():
    js, ts = jheat.linforms(M=16), theat.linforms(M=16, device="cpu")
    assert isinstance(ts.A, Stencil) and ts.A.grid_c == js.A.grid_c == 17
    assert ts.A.offsets == js.A.offsets
    _close(ts.A.data.numpy(), np.asarray(js.A.data), 1e-14)
    _close(np.asarray(ts.A.const), np.asarray(js.A.const), 1e-14)
    for label in ("Mmat", "Lmat", "Emat"):
        Aj, At = getattr(js, label), getattr(ts, label)
        assert At.offsets == Aj.offsets and At.wrap == Aj.wrap, label
        _close(At.data.numpy(), np.asarray(Aj.data), 1e-14)
    for field in ("b", "z0", "Lz0", "omega"):
        _close(getattr(ts, field).numpy(), np.asarray(getattr(js, field)), 1e-14)
    for field in ("m0", "e0", "old_energy"):
        _close(float(getattr(ts, field)), float(getattr(js, field)), 1e-14)
    z = np.random.default_rng(0).standard_normal(js.b.shape[0])
    inv_j = js.compute_invariants(jnp.asarray(z))
    inv_t = ts.compute_invariants(torch.as_tensor(z))
    assert set(inv_j) == set(inv_t) == {"mass", "energy"}
    for key in inv_j:
        _close(float(inv_t[key]), float(inv_j[key]), 1e-14)
    for cj, ct in zip(js.constraints(), ts.constraints()):
        assert ct.name == cj.name
        _close(float(ct(torch.as_tensor(z))), float(cj(jnp.asarray(z))), 1e-14)


def test_degree_two_needs_ell():
    """Degree 2 assembles into matrices that both packages store as ELL;
    the port's equal the JAX package's."""
    js = jheat.linforms(M=4, degree=2)
    ts = theat.linforms(M=4, degree=2, device="cpu")
    for name in ("A", "Mmat", "Lmat", "Emat"):
        Aj, At = getattr(js, name), getattr(ts, name)
        assert type(Aj).__name__ == type(At).__name__ == "ELL"
        np.testing.assert_array_equal(At.cols.numpy(), np.asarray(Aj.cols))
        np.testing.assert_array_equal(At.vals.numpy(), np.asarray(Aj.vals))
    np.testing.assert_array_equal(ts.b.numpy(), np.asarray(js.b))


def _solve(pkg, solver, s, pre, b=None):
    mod = jsol if pkg == "jax" else tsol
    b = s.b if b is None else b
    kw = {} if solver == "gmres" else {"constraints": s.constraints()}
    return getattr(mod, solver)(s.A, b, k=K, tol=TOL, pre=pre, **kw)


@pytest.mark.parametrize("solver", ["gmres", "cgmres"])
def test_solver_with_amg_matches_jax(systems, solver):
    js, ts, pj = systems(32)
    pt = tts.default_pre_builder("heat")(ts)
    xj, ij = _solve("jax", solver, js, pj)
    xp, _ = _solve("jax", solver, js, pj,
                   b=jnp.asarray(torch_parity.perturbed(js.b)))
    xt, it = _solve("port", solver, ts, pt)
    for key in ("steps", "constrained_steps", "safety", "breakdown"):
        if key in ij:
            assert it[key] == ij[key], key
    drift = torch_parity.rel_max(xp, xj)
    assert torch_parity.rel_max(xt.numpy(), xj) <= max(1e-8, 10.0 * drift)
    assert it["res"][-1] < TOL
    if solver == "cgmres":
        assert it["safety"] is True and it["deviation"] <= 1e-10


def test_time_cgmres_returns_jax_keys(systems):
    js, _, _ = systems(32)
    out_j = jts.time_cgmres("heat", M=32)
    out_t = tts.time_cgmres("heat", M=32, device="cpu")
    assert set(out_t) == set(out_j)
    assert set(out_t["conservation"]) == set(out_j["conservation"])
    for key in ("steps", "gmres_steps", "constrained_steps", "safety"):
        assert out_t[key] == out_j[key], key
    assert out_t["res_final"] < TOL and math.isfinite(out_t["time_pre"])


def test_timed_solve_prints_markdown(capsys):
    rows = tts.timed_solve("heat", sizes=[16], device="cpu")
    table = capsys.readouterr().out
    assert len(rows) == 1 and rows[0]["safety"] is True
    assert table.startswith("| M | safety |") and "Gain in energy" in table


@pytest.mark.parametrize("name", ["heat_M32"])
def test_reference_record_is_current(systems, name):
    """Regenerate a heat entry of the committed JAX record and compare
    (heat_M64 in tests/test_torch_amg.py)."""
    script = torch_parity.reference_script()
    M = script.CONFIGS[name][1]["M"]
    new = script.record(name, s=systems(M)[0])
    torch_parity.check_record(new, script.load(name)[name])


@pytest.mark.slow
def test_reference_record_heat_m1024():
    """The entry the card run is held to (n = 1,050,625; minutes on the
    CPU)."""
    script = torch_parity.reference_script()
    torch_parity.check_record(script.record("heat_M1024"),
                              script.load("heat_M1024")["heat_M1024"])
