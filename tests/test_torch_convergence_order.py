"""The convergence-order claim on the PyTorch port: the port's twin of
``tests/test_convergence_order.py`` at its CI size, on the CPU in f64.

The lkdvRK error pipeline exists to show that CGMRES keeps the
discretisation's convergence order while it enforces the invariants
(reference lkdvRK/ErrorGenerator.py:32-34).  As in the JAX test: a
dt-refinement at degree 5, M=60, one GL stage (temporal order 2), N = 4
and 8, tol=1e-11, asserted for Exact and CGMRES (CGMRES on the device
core, ``loop="while"``, eager here), with CGMRES ≤ 1.05 × Exact at every
level; and the reference grid's (3, 2) point at M=100, N=10, tol=1e-9
(host loop), where CGMRES < 2 × Exact.  Each error is held to the JAX
package's at the same point (``reference/slice18.json``, written by
``scripts/make_torch_reference.py slice18``): Exact within 1e-9 relative,
CGMRES within 1e-6 relative.  The evolutions run through
``scripts/run_error_order_torch.py::final_error``, the study's own.
"""

import importlib.util
import json
import math
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
RECORD = json.loads((ROOT / "structurepreservingiterativesolvers_torch"
                     / "reference" / "slice18.json").read_text())
EXACT_RTOL, CGMRES_RTOL = 1e-9, 1e-6
# name in the record: (degree, tstages, M, tol), the loop of CGMRES
POINTS = {"order_deg5_s1_M60": ((5, 1, 60, 1e-11), "while"),
          "order_deg3_s2_M100": ((3, 2, 100, 1e-9), "host")}


def _script():
    spec = importlib.util.spec_from_file_location(
        "run_error_order_torch", ROOT / "scripts" / "run_error_order_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def final_err():
    """err(T) of one port evolution, each run once a module."""
    study, cache = _script(), {}

    def get(name, solver, N, loop=None):
        (degree, tstages, M, tol), default = POINTS[name]
        key = (name, solver, N, loop or default)
        if key not in cache:
            cache[key] = study.final_error(
                solver, N, tstages, M=M, degree=degree, tol=tol,
                loop=key[3], device="cpu")
        return cache[key]

    return get


@pytest.mark.parametrize("solver", ["Exact", "CGMRES"])
def test_observed_temporal_order(final_err, solver):
    e4 = final_err("order_deg5_s1_M60", solver, 4)[0]
    e8 = final_err("order_deg5_s1_M60", solver, 8)[0]
    order = math.log2(e4 / e8)
    assert abs(order - 2.0) < 0.4, (solver, e4, e8, order)


def test_cgmres_tracks_exact_error(final_err):
    for N in (4, 8):
        ee = final_err("order_deg5_s1_M60", "Exact", N)[0]
        ce = final_err("order_deg5_s1_M60", "CGMRES", N)[0]
        assert ce < 1.05 * ee, (N, ee, ce)


def test_reference_grid_point_order_resolving_tolerance(final_err):
    """At the reference's (3, 2) point, a tolerance below the
    discretisation error makes CGMRES track Exact (the JAX doc's 1.000 at
    M=400; M=100 here)."""
    ee = final_err("order_deg3_s2_M100", "Exact", 10)[0]
    ce = final_err("order_deg3_s2_M100", "CGMRES", 10)[0]
    assert ce < 2.0 * ee, (ee, ce)


@pytest.mark.parametrize("name", sorted(POINTS))
def test_errors_match_jax_records(final_err, name):
    """Every error of the study at the JAX package's: the direct solve's
    within 1e-9 relative (the same discrete problem), CGMRES's within 1e-6
    (a solve to tol)."""
    runs = RECORD[name]["runs"]
    for key, ref in runs.items():
        solver, N = key.split("_N")
        err = final_err(name, solver, int(N))[0]
        rtol = EXACT_RTOL if solver == "Exact" else CGMRES_RTOL
        assert abs(err - ref["err"][-1]) <= rtol * ref["err"][-1], (key, err)


def test_device_core_evolution_is_the_host_loops(final_err):
    """CGMRES's refinement evolution on the device core takes the host
    loop's solver steps at every time step, to the same err(T) within
    1e-12 relative."""
    for N in (4, 8):
        ew, ow = final_err("order_deg5_s1_M60", "CGMRES", N, "while")
        eh, oh = final_err("order_deg5_s1_M60", "CGMRES", N, "host")
        assert list(ow["steps"]) == list(oh["steps"])
        assert abs(ew - eh) <= 1e-12 * eh


def test_record_holds_the_chip_points():
    """The record of the points ``chip_smoke.py`` runs on the card (degree
    5, M=120, one stage, N = 4 and 8) shows the claim in the JAX package:
    order within 0.4 of 2 for both solvers, CGMRES ≤ 1.05 × Exact."""
    runs = RECORD["order_deg5_s1_M120"]["runs"]
    err = {key: run["err"][-1] for key, run in runs.items()}
    for solver in ("Exact", "CGMRES"):
        order = math.log2(err[f"{solver}_N4"] / err[f"{solver}_N8"])
        assert abs(order - 2.0) < 0.4, (solver, order)
    for N in (4, 8):
        assert err[f"CGMRES_N{N}"] < 1.05 * err[f"Exact_N{N}"]
