"""Record what the JAX package computes on the configurations of the PyTorch
port's slices, so a run of the port on a machine without JAX can be held
against it.

Runs the JAX package on the CPU in f64 and writes, under
``structurepreservingiterativesolvers_torch/reference/``, ``slice1.json``
(lkdv and swe, unpreconditioned), ``slice2.json`` (heat with the structured
AMG of the TimedSolve pre-builder), ``slice3.json`` (heat with the
Chebyshev and Neumann polynomial preconditioners) and ``slice4.json`` (swe
with the skew-normal Chebyshev preconditioner of the TimedSolve
pre-builder, and time evolutions) and ``slice7.json`` (lkdvRK with the RAS +
Neumann composite of the TimedSolve pre-builder at the reference's M=400
error-sweep grid and at M=50, its evolutions and error sweep, and lkdv's
TimedSolve row), ``slice8.json`` (the JAX package's ``fused_evolve``),
``slice9.json`` (the JAX package's batched ``cgmres_many``, ``BATCHED``) and
``slice11.json`` (heat on the JAX package's device core: ``cgmres`` on its
default loop with each of heat's four preconditioners, ``cgmres_many`` on
heat with each of them, and ``fused_evolve`` on heat with the AMG) and
``slice12.json`` (lkdvRK on the JAX package's device core, ``SLICE12``:
``evolve`` and ``fused_evolve`` of one small evolution, the chained record
and the one with the JAX ``fused_evolve``'s state fault; ``cgmres_many``
with the RAS + Neumann composite and with RAS alone; ``cgmres`` with a
general constraint and with ``history``) and ``slice13.json`` (heat P2,
the unstructured heat operator, with the JAX package's greedy host AMG,
``SLICE13``: ``time_cgmres`` at M=16, 32 and 64 with the hierarchy's level
sizes and formats, the greedy aggregate counts per level, ``cgmres_many``
at M=16 with a batch of 3; and the reporting and oracle modules:
``tabulator``'s columns on lkdv M=20, ``single_solve("lkdvrk",
pre="auto")``, and GMRES's steps with the ILU and direct oracles on lkdvRK
M=50) and ``slice14.json`` (the row-sharded solves of the JAX package's
``tests/test_parallel.py`` on an 8-device CPU mesh, ``SLICE14``: each
configuration single-device and sharded, with x in full) and
``slice15.json`` (the JAX package's f32 storage mode, ``SLICE15``: solves,
TimedSolve pairs, a ``fused_evolve`` and ``cgmres_many`` with f32 vectors,
``record_f32``) and ``slice18.json`` (the convergence-order study's points,
``SLICE18``: lkdvRK evolutions' L2 errors with the direct solve and with
CGMRES, ``record_order``; ``python scripts/make_torch_reference.py
slice18`` writes them all, in under a minute):
for each solve configuration, GMRES and
CGMRES through the experiment wrappers, with their steps, constrained
steps, safety latch, KKT deviation, final true residual and the invariants
of the returned iterate; with the AMG also its level sizes, with a
Chebyshev preconditioner also its spectral bounds (and, skew-normal, its
degree).  For each evolution (``EVOLVES``), ``experiments.evolve`` with
CGMRES: per step the solver's steps, constrained steps, safety and KKT
deviation, and the invariant series with their drifts.  For lkdvRK also
the format of A (DIA with its diagonal count, or ELL with its row width)
and the RAS block shape, and for each lkdvRK evolution (``SWEEPS``, through
``experiments.error_sweep``) the per-step L2 errors, solver steps and
drifts.  For each ``fused_evolve`` (``FUSED``) per step the solver's steps
and latch, the invariant series and their drifts, and the max-norm of the
last solution.

    python scripts/make_torch_reference.py            # every configuration
    python scripts/make_torch_reference.py swe_M64    # only the named ones

``swe_M512`` (n = 786,432), ``swe_M512_snc``, ``swe_M512_snc_evolve`` and
``heat_M1024`` (n = 1,050,625) take a few minutes each on the CPU,
``heat_M1024_cheb8`` and ``heat_M1024_neu4`` one to two.  The lkdvRK rows
at M=400 build their RAS inverses on the host (0.29, 1.02 and 2.60 GB in
f64) and take from one to several minutes each.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "structurepreservingiterativesolvers_torch" / "reference"

# name -> (problem, linforms parameters, k, tol, x0 is zeros (else None),
# history, preconditioner).  lkdv_easy is the reference SingleSolve (tol
# below 1e-20 selects the prototypical CGMRES); lkdv_hard is the
# configuration of tests/test_cgmres_lkdv.py::
# test_cgmres_beats_gmres_on_invariants; swe is the f64 dynamics
# configuration, unpreconditioned.  heat is the reference's TimedSolve
# (tol=1e-7 absolute): at k=20 with the structured AMG that
# experiments/timed_solve.py::default_pre_builder pairs it with, and with
# the polynomial preconditioners (builder name, parameters) that a
# pre_builder of precond.chebyshev or precond.neumann gives.  At M=1024 the
# polynomial rows stall and end uncertified; M=256 and M=64 at k=60 are the
# certified anchors, M=32 at k=30 the size of the CPU parity tests.  swe with
# "snc" is the swe TimedSolve row (k=20, tol=1e-7 absolute) with the
# skew-normal Chebyshev preconditioner that default_pre_builder("swe")
# builds, at full size and at the sizes of the CPU tests.
CHEB8 = ("chebyshev", dict(degree=8))
NEU4 = ("neumann", dict(degree=4))
JACOBI = ("jacobi", {})
CONFIGS = {
    "lkdv_easy": ("lkdv", dict(degree=1, M=50, N=100), 20, 1e-50, True, True,
                  None),
    "lkdv_hard": ("lkdv", dict(degree=3, M=100, N=100), 50, 1e-6, False,
                  False, None),
    "swe_M64": ("swe", dict(M=64), 60, 1e-9, False, False, None),
    "swe_M512": ("swe", dict(M=512), 60, 1e-9, False, False, None),
    "heat_M32": ("heat", dict(M=32), 20, 1e-7, False, False, "amg"),
    "heat_M64": ("heat", dict(M=64), 20, 1e-7, False, False, "amg"),
    "heat_M1024": ("heat", dict(M=1024), 20, 1e-7, False, False, "amg"),
    "heat_M1024_cheb8": ("heat", dict(M=1024), 20, 1e-7, False, False, CHEB8),
    "heat_M1024_neu4": ("heat", dict(M=1024), 20, 1e-7, False, False, NEU4),
    "heat_M256_cheb8": ("heat", dict(M=256), 60, 1e-7, False, False, CHEB8),
    "heat_M64_cheb8": ("heat", dict(M=64), 60, 1e-7, False, False, CHEB8),
    "heat_M64_neu4": ("heat", dict(M=64), 60, 1e-7, False, False, NEU4),
    "heat_M32_cheb8": ("heat", dict(M=32), 30, 1e-7, False, False, CHEB8),
    "swe_M32_snc": ("swe", dict(M=32), 20, 1e-7, False, False, "snc"),
    "swe_M64_snc": ("swe", dict(M=64), 20, 1e-7, False, False, "snc"),
    "swe_M512_snc": ("swe", dict(M=512), 20, 1e-7, False, False, "snc"),
    # the seventh slice: lkdv's TimedSolve row (no preconditioner, as
    # default_pre_builder gives it) and lkdvRK with the RAS + Neumann
    # composite of default_pre_builder("lkdvrk") at each row of the
    # reference's error-sweep grid (lkdvRK/ErrorGenerator.py:28-39: M=400,
    # N=10, k=50, the row's tol) and at M=50, the size of the CPU tests
    "lkdv_M50_timed": ("lkdv", dict(M=50), 20, 1e-7, False, False, "default"),
    "lkdvrk_M50_deg3_s2": ("lkdvrk", dict(M=50, N=10, degree=3, tstages=2),
                           50, 1e-3, False, False, "default"),
    "lkdvrk_M400_deg3_s2": ("lkdvrk", dict(M=400, N=10, degree=3, tstages=2),
                            50, 1e-3, False, False, "default"),
    "lkdvrk_M400_deg4_s3": ("lkdvrk", dict(M=400, N=10, degree=4, tstages=3),
                            50, 1e-5, False, False, "default"),
    "lkdvrk_M400_deg5_s4": ("lkdvrk", dict(M=400, N=10, degree=5, tstages=4),
                            50, 1e-7, False, False, "default"),
    # the eleventh slice: heat M=64 (the TimedSolve row's tol=1e-7
    # absolute) through the JAX cgmres on its default loop, the device
    # core, with each of heat's four preconditioners (k=20 with the AMG, as
    # the row; k=60 with the others, as slice3.json's M=64 anchors)
    "heat_M64_amg_while": ("heat", dict(M=64), 20, 1e-7, False, False,
                           "amg"),
    "heat_M64_cheb8_while": ("heat", dict(M=64), 60, 1e-7, False, False,
                             CHEB8),
    "heat_M64_neu4_while": ("heat", dict(M=64), 60, 1e-7, False, False, NEU4),
    "heat_M64_jacobi_while": ("heat", dict(M=64), 60, 1e-7, False, False,
                              JACOBI),
}

# the configurations whose records go to slice11.json
SLICE11 = {"heat_M64_amg_while", "heat_M64_cheb8_while",
           "heat_M64_neu4_while", "heat_M64_jacobi_while",
           "heat_M64_amg_fused", "heat_M32_amg_B3", "heat_M32_cheb8_B3",
           "heat_M32_neu4_B3", "heat_M32_jacobi_B3"}

# the configurations whose records go to slice12.json: lkdvRK M=20, (3, 2)
# (n = 480), four steps of dt = 0.1 with the composite of
# default_pre_builder("lkdvrk") built on the first system, at k=50,
# tol=1e-8, through the JAX evolve (the chained stepped systems) and the
# JAX fused_evolve (each step from sys0.step_update of the stage vector:
# from the third step on the initial state plus the last increment); the
# same system's batches of 3 (``BATCHED``, items ``stages``); lkdv degree 3,
# M=50 with the energy as a GeneralConstraint, and lkdv degree 2, M=50 with
# history (``CORE``)
SLICE12 = {"lkdvrk_M20_evolve", "lkdvrk_M20_fused", "lkdvrk_M20_B3",
           "lkdvrk_M20_ras_B3", "lkdv_M50_general", "lkdv_M50_history"}
LKDVRK_SMALL = dict(M=20, N=4, degree=3, tstages=2, T=0.4)

# the configurations whose records go to slice13.json.  heat P2 (degree 2,
# n = (2M+1)², its operator an ELL of width 19) at the TimedSolve row's
# tol=1e-7 absolute and k=60, preconditioned by the JAX package's greedy
# host AMG, amg(s.A_csr, dtype=np.float64): the path its amg keeps for
# unstructured operators (its default pre-builder hands the ELL operator
# to the structured setup, which raises); name -> M
P2_TIMED = {"heat_P2_M16": 16, "heat_P2_M32": 32, "heat_P2_M64": 64}
P2_K, P2_TOL = 60, 1e-7
# the reporting and oracle records: the greedy aggregates of heat P2 at
# M=16 and 64; tabulator on lkdv M=20 (degree 1), GMRES and the
# prototypical CGMRES at k=10 with history; single_solve on lkdvRK M=20
# with pre="auto"; GMRES (k=60, tol=1e-8) with the ILU and direct oracles
# on lkdvRK M=50, (3, 2), the configuration of tests/test_ilu_parity.py
REPORTS = {
    "heat_P2_aggregates": dict(M=(16, 64)),
    "lkdv_M20_table": dict(M=20, degree=1, k=10),
    "lkdvrk_M20_single_auto": dict(M=20),
    "lkdvrk_M50_ilu": dict(M=50, degree=3, tstages=2, k=60, tol=1e-8),
}
SLICE13 = {*P2_TIMED, *REPORTS, "heat_P2_M16_B3"}

# the JAX cgmres on its default loop (the device core): name -> (linforms
# parameters of lkdv, k, tol, what it records: "general" (the energy as a
# GeneralConstraint) or "history")
CORE = {
    "lkdv_M50_general": (dict(M=50, degree=3, N=100), 50, 1e-6, "general"),
    "lkdv_M50_history": (dict(M=50, degree=2, N=100), 50, 1e-8, "history"),
}

# evolutions: name -> (problem, evolve/linforms parameters, k, tol,
# preconditioner built on the evolution's first system).  swe at M=512 runs
# three steps of dt = T/N = 0.1, the dt of the TimedSolve row; swe M=16 is
# the configuration of tests/test_experiments.py::test_fused_evolve_swe with
# its preconditioner, lkdv that of test_evolve_lkdv_drift_suppression, heat
# that of test_evolve_heat_runs.
EVOLVES = {
    "swe_M512_snc_evolve": ("swe", dict(M=512, N=3, T=0.3), 20, 1e-7, "snc"),
    "swe_M16_evolve": ("swe", dict(M=16, N=5, T=1.0), 20, 1e-7, "snc"),
    "lkdv_M50_evolve": ("lkdv", dict(M=50, N=10, degree=2), 30, 1e-6, None),
    "heat_M16_cheb8_evolve": ("heat", dict(M=16, N=5), 25, 1e-8, CHEB8),
    "lkdvrk_M20_evolve": ("lkdvrk", LKDVRK_SMALL, 50, 1e-8, "default"),
}


# the JAX package's fused_evolve (its whole evolution as one lax.scan over
# the CGMRES core, warm-started by default): name -> (problem,
# fused_evolve/linforms parameters, k, tol, preconditioner built on the
# evolution's first system).  swe M=512 is swe_M512_snc_evolve's row; swe
# M=16 and lkdv M=50 are the configurations of
# tests/test_experiments.py::test_fused_evolve_swe and
# ::test_fused_evolve_matches_host_loop.
FUSED = {
    "swe_M512_snc_fused": ("swe", dict(M=512, N=3, T=0.3), 20, 1e-7, "snc"),
    "swe_M16_fused": ("swe", dict(M=16, N=5, T=1.0), 20, 1e-7, None),
    "lkdv_M50_fused": ("lkdv", dict(M=50, N=10, degree=2), 30, 1e-6, None),
    # heat M=64, three steps of the default dt (T=10, N=3), with the AMG of
    # the TimedSolve row built on the first system, at the row's k and tol
    "heat_M64_amg_fused": ("heat", dict(M=64, N=3), 20, 1e-7, "amg"),
    "lkdvrk_M20_fused": ("lkdvrk", LKDVRK_SMALL, 50, 1e-8, "default"),
}


# lkdvRK evolutions through the error sweep: name -> the arguments of
# ``run_sweep`` (one grid row and its solvers).  The first is the (3, 2)
# row of the reference's grid, preconditioned CGMRES; the second the same
# at M=50; the third the configuration of
# tests/test_experiments.py::test_error_sweep_serial.
SWEEPS = {
    "lkdvrk_M400_deg3_s2_evolve": dict(grid=[(3, 2, 1e-3)],
                                       solvers=("CGMRES",), N=10, M=400,
                                       k=50),
    "lkdvrk_M50_deg3_s2_evolve": dict(grid=[(3, 2, 1e-3)],
                                      solvers=("CGMRES",), N=10, M=50, k=50),
    "lkdvrk_M50_sweep": dict(grid=[(2, 2, 1e-7)], solvers=("Exact", "CGMRES"),
                             N=3, M=50, k=60),
}


# the JAX package's batched solve, ``experiments/batched.py::cgmres_many``:
# name -> (problem, linforms parameters, batch size, k, tol, preconditioner
# built on the unperturbed system, the items' states).  Item i is the
# system's ``step_update(z_i)``, with z_i from ``batch_states``.  lkdv M=50
# is the batch of tests/test_experiments.py::test_vmapped_batched_cgmres,
# swe M=32 with the skew-normal Chebyshev a batch whose items stop at
# different steps, both the size of the CPU tests; swe M=512 carries slice
# 1's row (no preconditioner) and slice 4's TimedSolve row (the skew-normal
# Chebyshev) at a batch of 8: an ensemble of forecasts from perturbed
# initial states, stepped together with one operator.
BATCHED = {
    "lkdv_M50_B3": ("lkdv", dict(M=50, degree=1), 3, 20, 1e-8, None,
                    "scaled"),
    "swe_M32_snc_B4": ("swe", dict(M=32), 4, 20, 1e-7, "snc", "noise"),
    "swe_M512_B8": ("swe", dict(M=512), 8, 60, 1e-9, None, "smooth"),
    "swe_M512_snc_B8": ("swe", dict(M=512), 8, 20, 1e-7, "snc", "smooth"),
    # the eleventh slice: heat M=32 at B = 3 with each of heat's four
    # preconditioners, built on the unperturbed system (the k of the
    # single rows: 20 with the AMG, 30 with a polynomial as heat_M32_cheb8,
    # 60 with Jacobi)
    "heat_M32_amg_B3": ("heat", dict(M=32), 3, 20, 1e-7, "amg", "smooth"),
    "heat_M32_cheb8_B3": ("heat", dict(M=32), 3, 30, 1e-7, CHEB8, "smooth"),
    "heat_M32_neu4_B3": ("heat", dict(M=32), 3, 30, 1e-7, NEU4, "smooth"),
    "heat_M32_jacobi_B3": ("heat", dict(M=32), 3, 60, 1e-7, JACOBI,
                           "smooth"),
    # the twelfth slice: lkdvRK M=20, (3, 2) at B = 3 with the RAS +
    # Neumann composite of default_pre_builder("lkdvrk") and with its RAS
    # alone, item i the stepped system of ``lkdvrk_stage_states``
    "lkdvrk_M20_B3": ("lkdvrk", dict(M=20, degree=3, tstages=2, N=4, T=0.4),
                      3, 50, 1e-8, "default", "stages"),
    "lkdvrk_M20_ras_B3": ("lkdvrk", dict(M=20, degree=3, tstages=2, N=4,
                                         T=0.4),
                          3, 50, 1e-8, "ras", "stages"),
    # the thirteenth slice: heat P2 M=16 at B = 3 with the greedy AMG
    # built on the unperturbed system, at the P2 rows' k and tol, item i
    # the stepped z0 + 0.02 i·p with p at the P2 nodes (``heat_p2_field``)
    "heat_P2_M16_B3": ("heat", dict(M=16, degree=2), 3, P2_K, P2_TOL,
                       "amg_greedy", "smooth_p2"),
}


def smooth_field(M: int, z0, problem: str = "swe"):
    """A smooth perturbation of a swe state on the M x M grid: on each of
    the three fields (u, v, rho), the real part of the lowest 3 x 3 Fourier
    modes with complex amplitudes drawn N(0, 1) from numpy's generator of
    seed 0, the whole scaled so that max|p| = max|z0|.  For heat, the one
    field on the (M + 1) x (M + 1) vertex grid of the unit square: the
    lowest 3 x 3 cosine modes cos(pi kx x) cos(pi ky y) (the modes of its
    natural boundary) with amplitudes drawn N(0, 1) from the same
    generator, scaled the same way."""
    import numpy as np

    if problem == "heat":
        return heat_smooth_field(M, z0)
    amp = np.random.default_rng(0).standard_normal((3, 3, 3, 2))
    idx = np.arange(M * M)
    ix, iy = idx // M, idx % M
    fields = []
    for f in range(3):
        p = np.zeros(M * M)
        for kx in range(3):
            for ky in range(3):
                phase = 2.0 * np.pi * (kx * ix + ky * iy) / M
                a, b = amp[f, kx, ky]
                p += a * np.cos(phase) - b * np.sin(phase)
        fields.append(p)
    p = np.concatenate(fields)
    z0 = np.asarray(z0, dtype=np.float64)
    return p * (np.abs(z0).max() / np.abs(p).max())


def heat_smooth_field(M: int, z0):
    """``smooth_field`` for heat: vertex (i, j) of the grid at flat index
    i (M + 1) + j, at x = i / M, y = j / M (``models/fem2d.py`` numbers
    the vertices so)."""
    import numpy as np

    amp = np.random.default_rng(0).standard_normal((3, 3))
    t = np.arange(M + 1) / M
    p = sum(amp[kx, ky] * np.outer(np.cos(np.pi * kx * t),
                                   np.cos(np.pi * ky * t))
            for kx in range(3) for ky in range(3)).reshape(-1)
    z0 = np.asarray(z0, dtype=np.float64)
    return p * (np.abs(z0).max() / np.abs(p).max())


def heat_p2_field(fem, z0):
    """``heat_smooth_field`` at the nodes of a P2 space (``fem``, either
    package's ``SpaceP2``, as ``Problem(degree=2).fem()`` gives it): the
    vertices, then the edge midpoints in the space's numbering of its
    edges; the lowest 3 x 3 cosine modes cos(pi kx x) cos(pi ky y) with
    amplitudes drawn N(0, 1) from numpy's generator of seed 0, scaled so
    that max|p| = max|z0|."""
    import numpy as np

    amp = np.random.default_rng(0).standard_normal((3, 3))
    xy = np.asarray(fem.xy, dtype=np.float64)
    e = np.asarray(fem.edges)
    xy = np.concatenate([xy, 0.5 * (xy[e[:, 0]] + xy[e[:, 1]])])
    x, y = xy[:, 0], xy[:, 1]
    p = sum(amp[kx, ky] * np.cos(np.pi * kx * x) * np.cos(np.pi * ky * y)
            for kx in range(3) for ky in range(3))
    z0 = np.asarray(z0, dtype=np.float64)
    return p * (np.abs(z0).max() / np.abs(p).max())


def lkdvrk_field(fem, mlength, u0):
    """A smooth periodic perturbation of an lkdvRK u field: the projection
    onto ``fem`` (either package's ``Space1D``) of the lowest 3 Fourier
    modes of the periodic interval [0, mlength), a_m cos(2 pi m x / L) -
    b_m sin(2 pi m x / L) for m = 0, 1, 2, with (a_m, b_m) drawn N(0, 1)
    from numpy's generator of seed 0, scaled so that max|p| = max|u0|."""
    import numpy as np

    amp = np.random.default_rng(0).standard_normal((3, 2))

    def f(x):
        return sum(a * np.cos(2.0 * np.pi * m * x / mlength)
                   - b * np.sin(2.0 * np.pi * m * x / mlength)
                   for m, (a, b) in enumerate(amp))

    p = np.asarray(fem.project(f), dtype=np.float64)
    return p * (np.abs(np.asarray(u0)).max() / np.abs(p).max())


def lkdvrk_stage_states(p, B, ns, n0, dt):
    """The stage vectors zbig_i (B, ns·3·n0) whose ``step_update`` gives
    the items of an lkdvRK batch: 0.02 i·p/dt in every stage's u block and
    zeros elsewhere, so that u1 = u0 + 0.02 i·p (the weights sum to one)."""
    import numpy as np

    Z = np.zeros((B, ns, 3, n0))
    Z[:, :, 0] = 0.02 * np.arange(B)[:, None, None] * np.asarray(p) / dt
    return Z.reshape(B, -1)


def batch_states(name, z0, fem=None):
    """The states z_i (B, n) whose ``step_update`` gives the items of
    ``BATCHED[name]``, from the system's z0 (numpy, f64): ``scaled``
    z0·(1 + 0.01 i); ``noise`` z0 + 0.05 i·g with g ~ N(0, 1) of numpy's
    generator of seed 0; ``smooth`` z0 + 0.02 i·p with p = ``smooth_field``;
    ``smooth_p2`` z0 + 0.02 i·p with p = ``heat_p2_field`` of ``fem``."""
    import numpy as np

    problem, params, B, _, _, _, kind = BATCHED[name]
    z0 = np.asarray(z0, dtype=np.float64)
    i = np.arange(B, dtype=np.float64)[:, None]
    if kind == "scaled":
        return z0[None] * (1.0 + 0.01 * i)
    if kind == "noise":
        g = np.random.default_rng(0).standard_normal(z0.shape[0])
        return z0[None] + 0.05 * i * g[None]
    if kind == "smooth":
        return z0[None] + 0.02 * i * smooth_field(params["M"], z0,
                                                  problem)[None]
    if kind == "smooth_p2":
        return z0[None] + 0.02 * i * heat_p2_field(fem, z0)[None]
    raise ValueError(f"unknown kind of batch {kind!r}")


# the configurations whose records go to slice14.json: the cases of the JAX
# package's tests/test_parallel.py at their sizes, each run on one device
# and row-sharded over an 8-device CPU mesh (XLA's host platform forced to
# 8 devices): swe M=8 unpreconditioned and with the skew-normal Chebyshev,
# the ELL tridiagonal under GMRES, the halo SpMV (offsets +-2 wrapped, and
# the tridiagonal unwrapped) and the halo operator under GMRES, heat M=31
# with the structured AMG (replicate_below=512), and fused_evolve on swe M=8
SLICE14 = {"swe_M8_sharded", "swe_M8_snc_sharded", "ell_tridiag_n128",
           "halo_n256", "halo_gmres_n256", "heat_M31_amg_sharded",
           "swe_M8_fused_sharded"}
MESH_DEVICES = 8


def halo_matrices(n: int = 256):
    """The halo SpMV's two operators and its x, as the JAX test builds them
    (numpy seeds 5 and 6): five wrapped random diagonals at offsets -2..2,
    and the unwrapped tridiagonal (-1, 2, -1)."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(5)
    rows, cols, vals = [], [], []
    for off in (-2, -1, 0, 1, 2):
        rows.append(np.arange(n))
        cols.append((np.arange(n) + off) % n)
        vals.append(rng.standard_normal(n))
    Ah = sp.csr_matrix((np.concatenate(vals),
                        (np.concatenate(rows), np.concatenate(cols))),
                       shape=(n, n))
    Ah2 = sp.csr_matrix(sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)))
    x = np.random.default_rng(6).standard_normal(n)
    return Ah, Ah2, x


def tridiag(n: int, diag: float = 4.0):
    import scipy.sparse as sp

    return sp.csr_matrix(sp.diags([-1.0, diag, -1.0], [-1, 0, 1],
                                  shape=(n, n)))


def _vec(v):
    import numpy as np

    return [float(t) for t in np.asarray(v)]


def _solve_info(info):
    out = {"steps": int(info["steps"])}
    for key in ("safety", "deviation", "constrained_steps"):
        if key in info:
            v = info[key]
            out[key] = None if v is None else (
                bool(v) if key == "safety" else float(v) if key == "deviation"
                else int(v))
    return out


def record_parallel(name):
    """Run one case of the JAX package's tests/test_parallel.py single-device
    and row-sharded over ``MESH_DEVICES`` CPU devices; returns its entry:
    the configuration, each run's x (n <= 1,024) and solver info, or the
    halo products, or the fused evolutions' steps, latch and drifts."""
    _jax_cpu()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from structurepreservingiterativesolvers_tpu import precond
    from structurepreservingiterativesolvers_tpu.models import heat, swe
    from structurepreservingiterativesolvers_tpu.ops import (
        dia_from_scipy,
        ell_from_scipy,
    )
    from structurepreservingiterativesolvers_tpu.parallel import (
        HaloDia,
        dia_spmv_halo,
        make_mesh,
        shard_matrix,
        shard_preconditioner,
        shard_system,
        shard_vector,
    )
    from structurepreservingiterativesolvers_tpu.solvers import cgmres, gmres

    if len(jax.devices()) < MESH_DEVICES:
        raise RuntimeError(f"{len(jax.devices())} JAX devices; the record "
                           f"needs {MESH_DEVICES} (XLA_FLAGS "
                           "--xla_force_host_platform_device_count)")
    mesh = make_mesh(MESH_DEVICES)
    rec = {"mesh_devices": MESH_DEVICES}
    if name in ("swe_M8_sharded", "swe_M8_snc_sharded", "heat_M31_amg_sharded"):
        if name == "heat_M31_amg_sharded":
            from structurepreservingiterativesolvers_tpu.precond.amg import amg

            M, k, tol = 31, 25, 1e-8
            s = heat.linforms(M=M)
            pre = amg(s.A, grid=(M + 1, M + 1))
            rec["config"] = {"problem": "heat", "params": {"M": M}, "k": k,
                             "tol": tol, "pre": "amg(grid=(M+1, M+1))",
                             "replicate_below": 512}
            rec["amg_levels"] = [int(L.A.shape[0]) for L in pre.levels]
            pre_sh = lambda m: shard_preconditioner(pre, m, replicate_below=512)
        else:
            k, tol = 15, 1e-8
            s = swe.linforms(M=8, N=100)
            pre = (precond.skew_normal_chebyshev(s.A, a=1.0 / s.prob.dt)
                   if name == "swe_M8_snc_sharded" else None)
            rec["config"] = {"problem": "swe", "params": {"M": 8, "N": 100},
                             "k": k, "tol": tol,
                             "pre": None if pre is None else "snc"}
            if pre is not None:
                rec["snc"] = {"degree": int(pre.degree), "lmin": float(pre.lmin),
                              "lmax": float(pre.lmax)}
            pre_sh = lambda m: None if pre is None else shard_preconditioner(pre, m)
        x1, i1 = cgmres(s.A, s.b, k=k, tol=tol, constraints=s.constraints(),
                        pre=pre)
        A, b, x0, cons = shard_system(s.A, s.b, jnp.zeros_like(s.b),
                                      s.constraints(), mesh)
        x8, i8 = cgmres(A, b, x0, k=k, tol=tol, constraints=cons,
                        pre=pre_sh(mesh))
        rec.update(n=int(s.b.shape[0]), single={"x": _vec(x1), **_solve_info(i1)},
                   sharded={"x": _vec(x8), **_solve_info(i8)})
    elif name == "ell_tridiag_n128":
        n, k, tol = 128, 60, 1e-10
        Ah = tridiag(n)
        b = np.random.default_rng(0).standard_normal(n)
        x1, i1 = gmres(ell_from_scipy(Ah), jnp.asarray(b), k=k, tol=tol)
        x8, i8 = gmres(shard_matrix(ell_from_scipy(Ah), mesh),
                       shard_vector(jnp.asarray(b), mesh), k=k, tol=tol)
        rec.update(n=n, config={"matrix": "tridiag(-1, 4, -1)", "b": "rng(0)",
                                "k": k, "tol": tol, "solver": "gmres"},
                   single={"x": _vec(x1), **_solve_info(i1)},
                   sharded={"x": _vec(x8), **_solve_info(i8)})
    elif name == "halo_n256":
        Ah, Ah2, x = halo_matrices()
        xs = shard_vector(jnp.asarray(x), mesh)
        y = dia_spmv_halo(shard_matrix(dia_from_scipy(Ah), mesh), xs, mesh)
        y2 = dia_spmv_halo(shard_matrix(dia_from_scipy(Ah2), mesh), xs, mesh)
        rec.update(n=256, config={"wrapped": "offsets -2..2, rng(5)",
                                  "unwrapped": "tridiag(-1, 2, -1)",
                                  "x": "rng(6)"},
                   wrapped={"y": _vec(y), "y_scipy": _vec(Ah @ x)},
                   unwrapped={"y": _vec(y2), "y_scipy": _vec(Ah2 @ x)})
    elif name == "halo_gmres_n256":
        import scipy.sparse.linalg as spla

        n, k, tol = 256, 80, 1e-10
        Ah = tridiag(n)
        b = np.random.default_rng(2).standard_normal(n)
        A_halo = HaloDia(shard_matrix(dia_from_scipy(Ah), mesh), mesh)
        x8, i8 = gmres(A_halo, shard_vector(jnp.asarray(b), mesh), k=k, tol=tol)
        rec.update(n=n, config={"matrix": "tridiag(-1, 4, -1)", "b": "rng(2)",
                                "k": k, "tol": tol, "solver": "gmres"},
                   sharded={"x": _vec(x8), **_solve_info(i8)},
                   spsolve=_vec(spla.spsolve(Ah, b)))
    elif name == "swe_M8_fused_sharded":
        from structurepreservingiterativesolvers_tpu.experiments.evolve import (
            fused_evolve,
        )

        params = dict(N=4, M=8, k=20, tol=1e-7, T=1.0)
        rec["config"] = {"problem": "swe", **params}
        for key, m in (("single", None), ("sharded", mesh)):
            out = fused_evolve("swe", mesh=m, **params)
            rec[key] = {"steps": [int(i) for i in out["steps"]],
                        "safety": [int(i) for i in out["safety"]],
                        "de": [float(v) for v in out["de"]],
                        "dm": [float(v) for v in out["dm"]],
                        "sol": _vec(out["sol"])}
    else:
        raise ValueError(f"no parallel record {name!r}")
    return rec


# the fifteenth slice: the JAX package in its f32 storage mode (the models'
# dtype=float32: mixed, the snap, the reduction mode of its wrappers).  name
# -> (kind, problem, linforms parameters, k, tol, tol mode, start or batch,
# preconditioner).  "solve": cgmres on its default loop from zero or from
# the warm start of tests/test_solver_options.py:35-60; "timed": the
# TimedSolve pair (the wrappers, x0=None); "fused": a 3-step fused_evolve;
# "batched": cgmres_many on the items of ``batch_states`` (kind "smooth").
# tol mode "rhs" scales tol by ||b|| (of the first system for "fused" and
# "batched").  The M=512 and M=1024 rows are the chip rows' sizes.
SLICE15 = {
    "lkdv_M50_f32": ("solve", "lkdv", dict(M=50, degree=1), 20, 1e-5, "abs",
                     "zero", None),
    "lkdv_M50_f32_warm": ("solve", "lkdv", dict(M=50, degree=1), 20, 1e-5,
                          "abs", "warm", None),
    "swe_M64_snc_f32": ("timed", "swe", dict(M=64), 20, 4e-7, "rhs", "zero",
                        "snc"),
    "heat_M32_amg_f32": ("timed", "heat", dict(M=32), 20, 1e-6, "rhs", "zero",
                         "amg"),
    "swe_M16_fused_f32": ("fused", "swe", dict(M=16, N=3, T=0.3), 20, 4e-7,
                          "rhs", "zero", "snc"),
    "swe_M16_B3_f32": ("batched", "swe", dict(M=16), 20, 4e-7, "rhs", 3,
                       "snc"),
    "heat_M32_B3_f32": ("batched", "heat", dict(M=32), 20, 1e-6, "rhs", 3,
                        "amg"),
    "heat_M256_cheb8_f32": ("solve", "heat", dict(M=256), 60, 1e-7, "abs",
                            "zero", CHEB8),
    "heat_M64_neu4_f32": ("solve", "heat", dict(M=64), 60, 1e-7, "abs",
                          "zero", NEU4),
    "swe_M512_snc_f32": ("timed", "swe", dict(M=512), 20, 4e-7, "rhs", "zero",
                         "snc"),
    "heat_M1024_amg_f32": ("timed", "heat", dict(M=1024), 20, 1e-6, "rhs",
                           "zero", "amg"),
    "heat_M1024_amg_abs_f32": ("timed", "heat", dict(M=1024), 20, 1e-7,
                               "abs", "zero", "amg"),
    "swe_M512_fused_f32": ("fused", "swe", dict(M=512, N=3, T=0.3), 20, 4e-7,
                           "rhs", "zero", "snc"),
}


# the largest n whose iterate a f32 record keeps whole
X_KEEP = 20_000


def record_f32(name):
    """Run the JAX package in f32 storage on ``SLICE15[name]``.  For each
    solve: steps, constrained steps, safety, the reported deviation, the
    residual trace, the certified (double-f32) deviations of the returned
    iterate, x's max-norm and sum, and the JAX package's own drift: max|Δx|
    / max|x| when b is moved by one f32 ulp (b·(1 + eps32·g), g ~ N(0, 1)
    of numpy's generator of seed 0).  "timed" adds GMRES's steps and
    certified deviations; "fused" the per-step steps, latch and drifts;
    "batched" the per-item steps, latch, deviation and x's max-norm and
    sum.  Where n ≤ ``X_KEEP`` a CGMRES solve's iterate is kept whole."""
    _jax_cpu()
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from structurepreservingiterativesolvers_tpu.experiments import wrappers
    from structurepreservingiterativesolvers_tpu.experiments.single_solve import (
        get_model,
    )
    from structurepreservingiterativesolvers_tpu.experiments.timed_solve import (
        certified_deviations,
        default_pre_builder,
    )
    from structurepreservingiterativesolvers_tpu.solvers import cgmres

    kind, problem, params, k, tol, tol_mode, start, pre_spec = SLICE15[name]
    f32 = jnp.float32
    eps32 = float(np.finfo(np.float32).eps)
    s = get_model(problem).linforms(dtype=f32, **params)
    if pre_spec is None:
        build = None
    elif pre_spec in ("amg", "snc"):
        build = default_pre_builder(problem)
    else:
        from structurepreservingiterativesolvers_tpu import precond

        builder, kwargs = pre_spec
        build = lambda t: getattr(precond, builder)(t.A, **kwargs)  # noqa: E731
    pre = None if build is None else build(s)
    beta = float(np.linalg.norm(np.asarray(s.b, np.float64)))
    tol_abs = tol * beta if tol_mode == "rhs" else tol
    out = {"config": {"kind": kind, "problem": problem, "params": params,
                      "k": k, "tol": tol, "tol_mode": tol_mode,
                      "start": start, "pre": pre_spec, "dtype": "float32"},
           "n": int(s.b.shape[0]), "beta": beta, "tol_abs": tol_abs,
           "targets": {kk: float(getattr(s, a)) for kk, a in
                       (("mass", "m0"), ("momentum", "mo0"),
                        ("energy", "e0")) if hasattr(s, a)}}

    def stats(x, keep=False):
        """x's max-norm and sum, and, with ``keep``, x itself where n is
        small (the CPU tests' sizes)."""
        x = np.asarray(x, np.float64)
        out = {"x_max": float(np.abs(x).max()), "x_sum": float(x.sum())}
        if keep and x.shape[0] <= X_KEEP:
            out["x"] = [float(v) for v in x]
        return out

    def solve_info(info):
        return {"steps": int(info["steps"]),
                "constrained_steps": int(info.get("constrained_steps", 0)),
                "safety": info.get("safety"),
                "deviation": float(info.get("deviation", np.nan)),
                "res": [float(v) for v in np.asarray(info["res"])]}

    if kind in ("solve", "timed"):
        x0 = None
        if start == "warm":
            rng = np.random.default_rng(3)
            x0 = jnp.asarray(np.asarray(s.b, np.float64)
                             + 1e-3 * rng.standard_normal(s.b.shape[0]), f32)

        def run(sys_):
            if kind == "timed":
                return wrappers.cgmres_wrapper(sys_, k=k, tol=tol_abs,
                                               pre=pre)
            return cgmres(sys_.A, sys_.b, x0=x0, k=k, tol=tol_abs,
                          constraints=sys_.constraints(), pre=pre)

        x, info = run(s)
        xv = np.asarray(x, np.float64)
        noise = np.random.default_rng(0).standard_normal(s.b.shape[0])
        sp_ = dataclasses.replace(
            s, b=(s.b * (1.0 + eps32 * jnp.asarray(noise))).astype(f32))
        xp = np.asarray(run(sp_)[0], np.float64)
        out["cgmres"] = {**solve_info(info), **stats(x, keep=True),
                         "certified": certified_deviations(s, x),
                         "true_residual": float(np.linalg.norm(
                             np.asarray(s.A @ x - s.b, np.float64)))}
        out["own_drift"] = float(np.abs(xp - xv).max() / np.abs(xv).max())
        if kind == "timed":
            xg, ig = wrappers.gmres_wrapper(s, k=k, tol=tol_abs, pre=pre)
            out["gmres"] = {**solve_info(ig), **stats(xg),
                            "certified": certified_deviations(s, xg)}
            out["reduction_mode"] = wrappers.reduction_mode(s, tol_abs)
        return out
    if kind == "fused":
        from structurepreservingiterativesolvers_tpu.experiments.evolve import (
            fused_evolve,
        )

        run = fused_evolve(problem, k=k, tol=tol_abs, pre=pre, dtype=f32,
                           **params)
        out["steps"] = [int(v) for v in run["steps"]]
        out["safety"] = [int(v) for v in run["safety"]]
        for key in ("dm", "de", "mass", "energy"):
            out[key] = [float(v) for v in run[key]]
        out.update(stats(run["sol"]))
        return out
    if kind == "batched":
        from structurepreservingiterativesolvers_tpu.experiments.batched import (
            cgmres_many,
        )

        B = start
        z0 = np.asarray(s.z0, np.float64)
        states = z0[None] + 0.02 * np.arange(B)[:, None] * smooth_field(
            params["M"], z0, problem)[None]
        items = [s.step_update(jnp.asarray(z, f32)) for z in states]
        X, info = cgmres_many(s.A, jnp.stack([t.b for t in items]),
                              [t.constraints() for t in items], k=k,
                              tol=tol_abs, pre=pre)
        out["items"] = [{"steps": int(info["steps"][i]),
                         "safety": int(info["safety"][i]),
                         "deviation": float(info["deviation"][i]),
                         **stats(X[i]),
                         "certified": certified_deviations(items[i], X[i])}
                        for i in range(B)]
        return out
    raise ValueError(f"unknown f32 record {name!r}")


# the seventeenth slice: the JAX package in f32 storage on the paths the
# fifteenth left out.  name -> (kind, arguments).  "timed": lkdvRK through
# its wrappers (``cgmres_wrapper``, ``gmres_wrapper``) with the default
# RAS + Neumann composite, built in f32 as the JAX ``ras(...,
# dtype=system.b.dtype)`` does; "general": lkdv with its energy as a
# ``GeneralConstraint`` (``CORE["lkdv_M50_general"]``), the projection off;
# "p2": heat P2 with ``amg(A_csr, dtype=float32)`` at each of ``P2_F32_TOLS``
# (times ||b||), k=60; "sweep": the error sweep in f32
# (``SPIS_FORCE_DTYPE=float32``, which the JAX package's ``default_dtype``
# reads) beside the same sweep in f64; "dd": ``_dd_matvec`` of a
# ``StageKron``, a ``MatComb``, lkdv's ``_BlockDiag3`` and an ELL at seeded
# f32 vectors; "mesh": the f32 solve on one device and row-sharded over
# ``MESH17`` CPU devices (the error kept where the JAX package raises).
SLICE17 = {
    "lkdvrk_M20_f32": ("timed", dict(M=20, N=10, degree=3, tstages=2), 50,
                       1e-3),
    "lkdvrk_M20_deg5_s4_f32": ("timed", dict(M=20, N=10, degree=5,
                                             tstages=4), 50, 1e-7),
    "lkdv_M50_general_f32": ("general", dict(M=50, degree=3, N=100), 50,
                             1e-6),
    "heat_P2_M16_f32": ("p2", 16),
    "heat_P2_M32_f32": ("p2", 32),
    "heat_P2_M64_f32": ("p2", 64),
    "lkdvrk_M20_sweep_f32": ("sweep", dict(grid=[(3, 2, 1e-3)],
                                           solvers=("CGMRES",), N=3, M=20,
                                           k=50)),
    "dd_matvec_f32": ("dd",),
    "swe_M16_snc_sharded_f32": ("mesh", "swe", 16, 20, 4e-7),
    "heat_M31_amg_sharded_f32": ("mesh", "heat", 31, 20, 1e-6),
}
P2_F32_TOLS = (1e-6, 1e-5, 1e-4)
MESH17 = 2


def record_slice17(name):
    """Run the JAX package in f32 storage on ``SLICE17[name]``; returns its
    entry.  A solve's entry: steps, constrained steps, latch, reported
    deviation, residual trace, the certified deviations of the returned
    iterate (double-f32, ``certified_deviations``; for the general solve
    the f64 invariants of x), its true residual, x whole (n ≤ ``X_KEEP``)
    and the JAX package's own drift under a one-ulp change of b (as
    ``record_f32``)."""
    _jax_cpu()
    import dataclasses
    import tempfile
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from structurepreservingiterativesolvers_tpu.experiments import wrappers
    from structurepreservingiterativesolvers_tpu.experiments.timed_solve import (
        certified_deviations,
        default_pre_builder,
    )
    from structurepreservingiterativesolvers_tpu.solvers import cgmres

    kind, *args = SLICE17[name]
    f32 = jnp.float32
    eps32 = float(np.finfo(np.float32).eps)
    t_start = time.perf_counter()

    def vec(x):
        return [float(v) for v in np.asarray(x, np.float64)]

    def solve_info(info):
        return {"steps": int(info["steps"]),
                "constrained_steps": int(info.get("constrained_steps", 0)),
                "safety": info.get("safety"),
                "deviation": float(info.get("deviation", np.nan)),
                "res": [float(v) for v in np.asarray(info["res"])]}

    def solved(s, run, certify=True):
        """The entry of ``run(s)``, with its drift under b·(1 + eps32·g)."""
        x, info = run(s)
        xv = np.asarray(x, np.float64)
        noise = np.random.default_rng(0).standard_normal(s.b.shape[0])
        sp_ = dataclasses.replace(
            s, b=(s.b * (1.0 + eps32 * jnp.asarray(noise))).astype(f32))
        xp = np.asarray(run(sp_)[0], np.float64)
        out = {**solve_info(info), "x_max": float(np.abs(xv).max()),
               "x_sum": float(xv.sum()),
               "true_residual": float(np.linalg.norm(
                   np.asarray(s.A @ x - s.b, np.float64))),
               "own_drift": float(np.abs(xp - xv).max() / np.abs(xv).max())}
        if certify:
            out["certified"] = certified_deviations(s, x)
        if xv.shape[0] <= X_KEEP:
            out["x"] = vec(xv)
        return out

    if kind == "timed":
        from structurepreservingiterativesolvers_tpu.models import lkdvrk

        params, k, tol = args
        s = lkdvrk.linforms(dtype=f32, **params)
        pre = default_pre_builder("lkdvrk")(s)
        out = {"config": {"kind": kind, "problem": "lkdvrk", "params": params,
                          "k": k, "tol": tol, "pre": "default",
                          "dtype": "float32"},
               "n": int(s.b.shape[0]), "operator": operator_format(s.A),
               "ras_blocks": list(pre.inner.idx.shape),
               "ras_dtype": str(pre.inner.inv.dtype),
               "reduction_mode": wrappers.reduction_mode(s, tol)}
        out["cgmres"] = solved(s, lambda t: wrappers.cgmres_wrapper(
            t, k=k, tol=tol, pre=pre))
        xg, ig = wrappers.gmres_wrapper(s, k=k, tol=tol, pre=pre)
        out["gmres"] = {**solve_info(ig),
                        "certified": certified_deviations(s, xg)}
    elif kind == "general":
        from structurepreservingiterativesolvers_tpu.constraints.general import (
            GeneralConstraint,
        )
        from structurepreservingiterativesolvers_tpu.models import lkdv

        params, k, tol = args
        s = lkdv.linforms(dtype=f32, **params)
        Mmat, e0 = s.Mmat, s.e0

        def energy(x):
            u, _, w = jnp.split(x, 3)
            return (0.5 * jnp.dot(w, Mmat @ w) - 0.5 * jnp.dot(u, Mmat @ u)
                    - e0)

        cons = list(s.constraints())
        cons[2] = GeneralConstraint(func=energy, name="energy")

        def run(t):
            return cgmres(t.A, t.b, k=k, tol=tol, constraints=cons)

        out = {"config": {"kind": kind, "problem": "lkdv", "params": params,
                          "k": k, "tol": tol, "dtype": "float32",
                          "loop": "while"},
               "n": int(s.b.shape[0]),
               "targets": {"mass": float(s.m0), "momentum": float(s.mo0),
                           "energy": float(s.e0)}}
        out["cgmres"] = solved(s, run, certify=False)
        x = np.asarray(out["cgmres"]["x"])
        n0 = x.shape[0] // 3
        Mh = np.asarray(s.Mmat.todense(), np.float64)
        om = np.asarray(s.omega, np.float64)
        u, w = x[:n0], x[2 * n0:]
        out["cgmres"]["invariants"] = {
            "mass": float(om @ u), "momentum": float(0.5 * u @ Mh @ u),
            "energy": float(0.5 * w @ Mh @ w - 0.5 * u @ Mh @ u)}
    elif kind == "p2":
        from structurepreservingiterativesolvers_tpu.models import heat
        from structurepreservingiterativesolvers_tpu.precond.amg import amg

        (M,) = args
        s = heat.linforms(M=M, degree=2, dtype=f32)
        pre = amg(s.A_csr, dtype=f32)
        beta = float(np.linalg.norm(np.asarray(s.b, np.float64)))
        out = {"config": {"kind": kind, "problem": "heat",
                          "params": {"M": M, "degree": 2}, "k": P2_K,
                          "tols": list(P2_F32_TOLS), "tol_mode": "rhs",
                          "pre": "amg(A_csr, dtype=float32)",
                          "dtype": "float32"},
               "n": int(s.b.shape[0]), "beta": beta,
               "operator": operator_format(s.A),
               "amg_levels": amg_levels(pre), "solves": {}}
        for tol in P2_F32_TOLS:
            tol_abs = tol * beta
            out["solves"][repr(tol)] = {
                "tol_abs": tol_abs,
                "reduction_mode": wrappers.reduction_mode(s, tol_abs),
                **solved(s, lambda t: wrappers.cgmres_wrapper(
                    t, k=P2_K, tol=tol_abs, pre=pre))}
    elif kind == "sweep":
        from structurepreservingiterativesolvers_tpu.experiments.error_sweep import (
            run_sweep,
        )

        (sweep,) = args
        out = {"config": {**sweep, "grid": [list(g) for g in sweep["grid"]],
                          "solvers": list(sweep["solvers"]),
                          "force_dtype": "float32"}}
        for key, forced in (("f32", "float32"), ("f64", None)):
            old = os.environ.pop("SPIS_FORCE_DTYPE", None)
            if forced:
                os.environ["SPIS_FORCE_DTYPE"] = forced
            try:
                with tempfile.TemporaryDirectory() as tmpdir:
                    runs = run_sweep(tmpdir=tmpdir, **sweep)
            finally:
                os.environ.pop("SPIS_FORCE_DTYPE", None)
                if old is not None:
                    os.environ["SPIS_FORCE_DTYPE"] = old
            out[key] = {
                f"{r['solver']}_{r['degree']}_{r['tstages']}": {
                    "time": [float(t) for t in r["time"]],
                    "steps": [int(i) for i in r["steps"]],
                    **{k2: [float(v) for v in np.asarray(r[k2])]
                       for k2 in ("err", "dm", "dmo", "de")}}
                for r in runs}
    elif kind == "dd":
        from structurepreservingiterativesolvers_tpu.constraints import (
            quadratic as jq,
        )
        from structurepreservingiterativesolvers_tpu.models import heat, lkdvrk
        from structurepreservingiterativesolvers_tpu.ops import dd

        rk = lkdvrk.linforms(M=20, N=10, degree=3, tstages=2, dtype=f32)
        p2 = heat.linforms(M=16, degree=2, dtype=f32)
        ops = {"StageKron": rk.constraints()[2].M,
               "BlockDiag3": rk.constraints()[2].M.inner,
               "MatComb": jq.MatComb((1.0, -0.5), (rk.Mmat, rk.Gmat)),
               "ELL": p2.Emat}
        out = {"config": {"lkdvrk": dict(M=20, N=10, degree=3, tstages=2),
                          "heat_p2": dict(M=16, degree=2),
                          "x": "z0-free: numpy default_rng(seed 11) normal, "
                               "rounded to f32"},
               "ops": {}}
        sizes = {"StageKron": rk.b.shape[0], "BlockDiag3": 3 * rk.n0,
                 "MatComb": rk.n0, "ELL": p2.b.shape[0]}
        for i, (key, M) in enumerate(ops.items()):
            n = int(sizes[key])
            x = np.random.default_rng(11 + i).standard_normal(n).astype(
                np.float32)
            y = np.asarray(dd.to_f64(jq._dd_matvec(M, dd.from_f32(
                jnp.asarray(x)))), np.float64)
            out["ops"][key] = {"seed": 11 + i, "n": n, "y": vec(y)}
    elif kind == "mesh":
        from structurepreservingiterativesolvers_tpu import precond
        from structurepreservingiterativesolvers_tpu.models import heat, swe
        from structurepreservingiterativesolvers_tpu.parallel import (
            make_mesh,
            shard_preconditioner,
            shard_system,
        )

        problem, M, k, tol = args
        if len(jax.devices()) < MESH17:
            raise RuntimeError(f"{len(jax.devices())} JAX devices; the record "
                               f"needs {MESH17}")
        mesh = make_mesh(MESH17)
        if problem == "swe":
            s = swe.linforms(M=M, N=100, dtype=f32)
            pre = precond.skew_normal_chebyshev(s.A, a=1.0 / s.prob.dt)
            shard_pre = lambda: shard_preconditioner(pre, mesh)  # noqa: E731
        else:
            from structurepreservingiterativesolvers_tpu.precond.amg import amg

            s = heat.linforms(M=M, dtype=f32)
            pre = amg(s.A, grid=(M + 1, M + 1))
            shard_pre = lambda: shard_preconditioner(  # noqa: E731
                pre, mesh, replicate_below=512)
        beta = float(np.linalg.norm(np.asarray(s.b, np.float64)))
        tol_abs = tol * beta
        opts = wrappers.reduction_mode(s, tol_abs)
        out = {"config": {"kind": kind, "problem": problem,
                          "params": {"M": M}, "k": k, "tol": tol,
                          "tol_mode": "rhs", "mesh_devices": MESH17,
                          "dtype": "float32", "reduction_mode": opts},
               "n": int(s.b.shape[0]), "beta": beta, "tol_abs": tol_abs}
        x1, i1 = cgmres(s.A, s.b, k=k, tol=tol_abs,
                        constraints=s.constraints(), pre=pre, **opts)
        out["single"] = {**solve_info(i1), "x": vec(x1),
                         "certified": certified_deviations(s, x1)}
        try:
            A, b, x0, cons = shard_system(s.A, s.b, jnp.zeros_like(s.b),
                                          s.constraints(), mesh)
            x2, i2 = cgmres(A, b, x0, k=k, tol=tol_abs, constraints=cons,
                            pre=shard_pre(), **opts)
            out["sharded"] = {**solve_info(i2), "x": vec(x2)}
        except Exception as exc:  # the JAX package's refusal, kept
            out["sharded"] = {"error": f"{type(exc).__name__}: {exc}"}
    else:
        raise ValueError(f"unknown slice-17 record {name!r}")
    out["seconds"] = time.perf_counter() - t_start
    return out


# the convergence-order study's points (``tests/test_convergence_order.py``
# and ``scripts/run_error_order.py`` there): lkdvRK evolutions to T=1 with
# k=50, the iterative solver CGMRES through the JAX package's wrapper (its
# default loop) with the TimedSolve pre-builder's composite built on the
# first system, beside the direct solve; name: (degree, tstages, M, tol,
# Ns).  ``slice18`` names them all.
SLICE18 = {
    "order_deg5_s1_M60": (5, 1, 60, 1e-11, (4, 8)),
    "order_deg3_s2_M100": (3, 2, 100, 1e-9, (10,)),
    "order_deg5_s1_M120": (5, 1, 120, 1e-11, (4, 8)),
}


def record_order(name):
    """Run the JAX package's lkdvRK evolutions of ``SLICE18[name]``;
    returns, per solver (Exact, CGMRES) and N, the L2 error series (its
    last entry the study's err(T)) and the solver's steps per step."""
    _jax_cpu()
    import time

    import numpy as np

    from structurepreservingiterativesolvers_tpu.experiments import wrappers
    from structurepreservingiterativesolvers_tpu.experiments.evolve import evolve
    from structurepreservingiterativesolvers_tpu.experiments.timed_solve import (
        default_pre_builder,
    )
    from structurepreservingiterativesolvers_tpu.models import lkdvrk

    degree, tstages, M, tol, Ns = SLICE18[name]
    t0 = time.perf_counter()
    runs = {}
    for solver in ("Exact", "CGMRES"):
        for N in Ns:
            if solver == "Exact":
                def fn(system, x0=None, k=50, tol=tol, pre=None):
                    return wrappers.exact(system)[0], {"steps": -1}
                pre = None
            else:
                s0 = lkdvrk.linforms(N=N, M=M, degree=degree,
                                     tstages=tstages, T=1.0)
                pre = default_pre_builder("lkdvrk")(s0)
                fn = wrappers.cgmres_wrapper
            out = evolve("lkdvrk", N=N, M=M, degree=degree, tstages=tstages,
                         T=1.0, k=50, tol=tol, solver=fn, pre=pre,
                         compute_error=True)
            runs[f"{solver}_N{N}"] = {
                "err": [float(e) for e in np.asarray(out["err"])],
                "steps": [int(i) for i in np.asarray(out["steps"])]}
    return {"config": {"degree": degree, "tstages": tstages, "M": M,
                       "tol": tol, "N": list(Ns), "k": 50, "T": 1.0},
            "runs": runs, "seconds": time.perf_counter() - t0}


def out_path(name) -> Path:
    """The record file that holds configuration ``name``: by its
    preconditioner (none, the AMG, a polynomial, the skew-normal
    Chebyshev), and evolutions with the skew-normal slice; the seventh
    slice's entries in their own file."""
    if name in SLICE18:
        return REFERENCE / "slice18.json"
    if name in SLICE17:
        return REFERENCE / "slice17.json"
    if name in SLICE15:
        return REFERENCE / "slice15.json"
    if name in SLICE14:
        return REFERENCE / "slice14.json"
    if name in SLICE13:
        return REFERENCE / "slice13.json"
    if name in SLICE12:
        return REFERENCE / "slice12.json"
    if name in SLICE11:
        return REFERENCE / "slice11.json"
    if name in BATCHED:
        return REFERENCE / "slice9.json"
    if name in FUSED:
        return REFERENCE / "slice8.json"
    if name in SWEEPS or CONFIGS.get(name, (None,) * 7)[6] == "default":
        return REFERENCE / "slice7.json"
    if name in EVOLVES:
        return REFERENCE / "slice4.json"
    pre = CONFIGS[name][6]
    if pre is None:
        return REFERENCE / "slice1.json"
    if pre == "snc":
        return REFERENCE / "slice4.json"
    return REFERENCE / ("slice2.json" if pre == "amg" else "slice3.json")


def _jax_cpu():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def system(name):
    """The JAX package's system of configuration ``name``."""
    _jax_cpu()
    from structurepreservingiterativesolvers_tpu.experiments.single_solve import (
        get_model,
    )

    problem, params = CONFIGS[name][:2]
    return get_model(problem).linforms(**params)


def pre_builder(name):
    """The JAX package's preconditioner builder of configuration or
    evolution ``name`` (a function of the system), or None."""
    spec = EVOLVES.get(name) or FUSED.get(name)
    if name in BATCHED:
        problem, pre = BATCHED[name][0], BATCHED[name][5]
    elif spec is not None:
        problem, pre = spec[0], spec[4]
    else:
        problem, pre = CONFIGS[name][0], CONFIGS[name][6]
    if pre is None:
        return None
    from structurepreservingiterativesolvers_tpu import precond
    from structurepreservingiterativesolvers_tpu.experiments.timed_solve import (
        default_pre_builder,
    )

    if pre == "amg_greedy":  # the greedy host AMG of the scipy matrix
        import numpy as np

        from structurepreservingiterativesolvers_tpu.precond.amg import amg

        return lambda s: amg(s.A_csr, dtype=np.float64)
    if pre in ("amg", "snc", "default"):
        return default_pre_builder(problem)
    if pre == "ras":  # the composite's inner RAS alone
        return lambda s: default_pre_builder(problem)(s).inner
    builder, kwargs = pre
    return lambda s: getattr(precond, builder)(s.A, **kwargs)


def _summary(s, measure, x, info):
    import numpy as np

    inv, true_residual = measure(x)
    targets = {"mass": s.m0, "momentum": getattr(s, "mo0", None), "energy": s.e0}
    out = {
        "steps": int(info["steps"]),
        "res": float(np.asarray(info["res"])[-1]),
        "true_residual": float(true_residual),
        "invariants": {kk: float(v) for kk, v in inv.items()},
        "deviations": {kk: float(v - targets[kk]) for kk, v in inv.items()},
    }
    for key in ("constrained_steps", "safety", "deviation"):
        if key in info:
            out[key] = info[key]
    return out


def record(name, s=None):
    """Run GMRES and CGMRES on configuration ``name`` with the JAX package;
    returns the configuration's entry of the record."""
    _jax_cpu()
    import jax
    import jax.numpy as jnp

    from structurepreservingiterativesolvers_tpu.experiments import wrappers

    problem, params, k, tol, zero_x0, history, pre_spec = CONFIGS[name]
    s = system(name) if s is None else s
    build = pre_builder(name)
    pre = None if build is None else build(s)
    # the invariants and the true residual of an iterate, as one program
    measure = jax.jit(lambda x: (s.compute_invariants(x),
                                 jnp.linalg.norm(s.A @ x - s.b)))
    x0 = jnp.zeros_like(s.b) if zero_x0 else None
    xg, ig = wrappers.gmres_wrapper(s, x0=x0, k=k, tol=tol, pre=pre,
                                    history=history)
    xc, ic = wrappers.cgmres_wrapper(s, x0=x0, k=k, tol=tol, pre=pre,
                                     history=history)
    out = {
        "config": {"problem": problem, "params": params, "k": k, "tol": tol,
                   "x0": "zeros" if zero_x0 else None, "history": history},
        "n": int(s.b.shape[0]),
        "beta": float(jnp.linalg.norm(s.b)),
        "targets": {kk: float(getattr(s, a)) for kk, a in
                    (("mass", "m0"), ("momentum", "mo0"), ("energy", "e0"))
                    if hasattr(s, a)},
        "gmres": _summary(s, measure, xg, ig),
        "cgmres": _summary(s, measure, xc, ic),
    }
    if name in SLICE11:
        out["config"]["loop"] = "while"
    if pre_spec == "amg":
        out["config"]["pre"] = "amg"
        out["amg_levels"] = [int(L.A.shape[0]) for L in pre.levels]
    elif pre_spec == "default":
        out["config"]["pre"] = "default"
        if problem == "lkdvrk":
            out.update(operator_format(s.A))
            out["ras_blocks"] = list(pre.inner.idx.shape)
            out["neumann_degree"] = int(pre.degree)
    elif pre_spec is not None:
        _pre_fields(out, pre_spec, pre)
    return out


def operator_format(A) -> dict:
    """The device format of an operator: DIA with its diagonal count or
    ELL with its row width."""
    if hasattr(A, "offsets"):
        return {"format": "DIA", "width": len(A.offsets), "wrap": bool(A.wrap)}
    return {"format": "ELL", "width": int(A.row_width)}


def _pre_fields(out, pre_spec, pre):
    """The preconditioner's name and parameters into ``out["config"]``, its
    spectral bounds (and, skew-normal, its degree) into ``out``."""
    if pre_spec == "snc":
        out["config"]["pre"] = "skew_normal_chebyshev"
        out["degree"] = int(pre.degree)
    else:
        builder, kwargs = pre_spec
        out["config"]["pre"] = {"name": builder, **kwargs}
    if hasattr(pre, "lmin"):
        out["lmin"], out["lmax"] = float(pre.lmin), float(pre.lmax)


def record_evolve(name):
    """Run the JAX package's ``evolve`` with CGMRES on evolution ``name``;
    returns its entry of the record."""
    _jax_cpu()
    import numpy as np

    from structurepreservingiterativesolvers_tpu.experiments import wrappers
    from structurepreservingiterativesolvers_tpu.experiments.evolve import evolve
    from structurepreservingiterativesolvers_tpu.experiments.single_solve import (
        get_model,
    )

    problem, params, k, tol, pre_spec = EVOLVES[name]
    s = get_model(problem).linforms(**params)
    build = pre_builder(name)
    pre = None if build is None else build(s)
    infos = []

    def solver(system, **kw):
        x, info = wrappers.cgmres_wrapper(system, **kw)
        infos.append(info)
        return x, info

    out = evolve(problem, k=k, tol=tol, pre=pre, solver=solver, **params)
    rec = {
        "config": {"problem": problem, "params": params, "k": k, "tol": tol,
                   "solver": "cgmres"},
        "n": int(s.b.shape[0]),
        "time": [float(t) for t in out["time"]],
        "steps": [int(i["steps"]) for i in infos],
        "constrained_steps": [int(i["constrained_steps"]) for i in infos],
        "safety": [i["safety"] for i in infos],
        "deviation": [float(i["deviation"]) for i in infos],
        "series": {key: [float(v) for v in np.asarray(out[key])]
                   for key in ("mass", "momentum", "energy") if key in out},
        "drift": {key: [float(v) for v in np.asarray(out[key])]
                  for key in ("dm", "dmo", "de") if key in out},
    }
    if pre_spec == "default":
        rec["config"]["pre"] = "default"
    elif pre_spec is not None:
        _pre_fields(rec, pre_spec, pre)
    return rec


def record_fused(name):
    """Run the JAX package's ``fused_evolve`` (CGMRES, warm-started) on
    ``FUSED[name]``; returns its entry of the record: per step the solver's
    steps and latch, the invariant series and their drifts, and the
    max-norm of the last solution."""
    _jax_cpu()
    import numpy as np

    from structurepreservingiterativesolvers_tpu.experiments.evolve import (
        fused_evolve,
    )
    from structurepreservingiterativesolvers_tpu.experiments.single_solve import (
        get_model,
    )

    problem, params, k, tol, pre_spec = FUSED[name]
    s = get_model(problem).linforms(**params)
    build = pre_builder(name)
    pre = None if build is None else build(s)
    out = fused_evolve(problem, k=k, tol=tol, pre=pre, **params)
    rec = {
        "config": {"problem": problem, "params": params, "k": k, "tol": tol,
                   "solver": "fused_evolve", "warm_start": True},
        "n": int(s.b.shape[0]),
        "time": [float(t) for t in out["time"]],
        "steps": [int(i) for i in out["steps"]],
        "safety": [int(i) for i in out["safety"]],
        "series": {key: [float(v) for v in np.asarray(out[key])]
                   for key in ("mass", "momentum", "energy") if key in out},
        "drift": {key: [float(v) for v in np.asarray(out[key])]
                  for key in ("dm", "dmo", "de") if key in out},
        "sol_max": float(np.abs(np.asarray(out["sol"])).max()),
    }
    if pre_spec == "amg":
        rec["config"]["pre"] = "amg"
        rec["amg_levels"] = [int(L.A.shape[0]) for L in pre.levels]
    elif pre_spec == "default":
        rec["config"]["pre"] = "default"
    elif pre_spec is not None:
        _pre_fields(rec, pre_spec, pre)
    return rec


def record_core(name):
    """Run the JAX ``cgmres`` on its default loop (the device core) on
    ``CORE[name]``: with the energy as a ``GeneralConstraint`` (beside the
    quadratic mass and momentum), or with ``history``.  Returns its entry:
    the steps, constrained steps, latch, KKT deviation, residual trace, the
    invariants' deviations of x and x itself; with history the max-norm of
    each row of ``xs`` (row 0 is r0).  Each with its own drift
    (``own_drift``): how far the same solve moves x (and, with history,
    each row's max-norm), max|Δ| / max|·|, when b is perturbed by
    ``DRIFT_SIZE`` relative (seed 0).  The general solve runs to k without
    reaching tol, where that drift is far above the rounding."""
    _jax_cpu()
    import jax.numpy as jnp
    import numpy as np

    from structurepreservingiterativesolvers_tpu.constraints.general import (
        GeneralConstraint,
    )
    from structurepreservingiterativesolvers_tpu.models import lkdv
    from structurepreservingiterativesolvers_tpu.solvers import cgmres

    params, k, tol, kind = CORE[name]
    s = lkdv.linforms(**params)
    cons = list(s.constraints())
    if kind == "general":
        Mmat, e0 = s.Mmat, s.e0

        def energy(x):
            u, _, w = jnp.split(x, 3)
            return (0.5 * jnp.dot(w, Mmat @ w) - 0.5 * jnp.dot(u, Mmat @ u)
                    - e0)

        cons[2] = GeneralConstraint(func=energy, name="energy")
    x, info = cgmres(s.A, s.b, k=k, tol=tol, constraints=cons,
                     history=kind == "history")
    noise = np.random.default_rng(0).standard_normal(s.b.shape[0])
    xp, infop = cgmres(s.A, s.b * (1.0 + DRIFT_SIZE * jnp.asarray(noise)),
                       k=k, tol=tol, constraints=cons,
                       history=kind == "history")

    def drift(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return float(np.abs(a - b).max() / np.abs(b).max())
    inv = s.compute_invariants(x)
    targets = {"mass": s.m0, "momentum": s.mo0, "energy": s.e0}
    out = {
        "config": {"problem": "lkdv", "params": params, "k": k, "tol": tol,
                   "kind": kind, "loop": "while"},
        "n": int(s.b.shape[0]),
        "steps": int(info["steps"]),
        "constrained_steps": int(info["constrained_steps"]),
        "safety": info["safety"],
        "deviation": float(info["deviation"]),
        "res": [float(v) for v in np.asarray(info["res"])],
        "deviations": {kk: float(inv[kk] - targets[kk]) for kk in inv},
        "x": [float(v) for v in np.asarray(x)],
        "own_drift": {"x": drift(xp, x)},
    }
    if kind == "history":
        xs_max = np.abs(np.asarray(info["x"])).max(axis=1)
        out["xs_max"] = [float(v) for v in xs_max]
        out["own_drift"]["xs_max"] = drift(
            np.abs(np.asarray(infop["x"])).max(axis=1), xs_max)
    return out


# the perturbations of b whose effect on an evolution's error series is
# recorded as its own drift: relative size, and the seeds
DRIFT_SIZE, DRIFT_SEEDS = 1e-15, (0, 1, 2)


def own_drift(run, N, M, k, tol):
    """How far the JAX package moves one preconditioned evolution's L2 error
    series when each step's b is perturbed by ``DRIFT_SIZE`` relative:
    max|Δerr| / max|err| against the unperturbed ``run``, the largest over
    ``DRIFT_SEEDS``.  A solve that stops a few steps in, at a tolerance far
    above the rounding, carries such a change into every later step; no
    port can be held closer to the record than this."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from structurepreservingiterativesolvers_tpu.experiments import wrappers
    from structurepreservingiterativesolvers_tpu.experiments.evolve import evolve
    from structurepreservingiterativesolvers_tpu.experiments.timed_solve import (
        default_pre_builder,
    )
    from structurepreservingiterativesolvers_tpu.models import lkdvrk

    params = dict(N=N, M=M, degree=run["degree"], tstages=run["tstages"])
    pre = default_pre_builder("lkdvrk")(lkdvrk.linforms(T=1.0, **params))
    solve = {"GMRES": wrappers.gmres_wrapper,
             "CGMRES": wrappers.cgmres_wrapper}[run["solver"]]
    err = np.asarray(run["err"])
    drift = 0.0
    for seed in DRIFT_SEEDS:
        rng = np.random.default_rng(seed)

        def perturbed(system, **kw):
            noise = rng.standard_normal(system.b.shape[0])
            b = system.b * (1.0 + DRIFT_SIZE * jnp.asarray(noise))
            return solve(dataclasses.replace(system, b=b), **kw)

        out = evolve("lkdvrk", k=k, tol=tol, solver=perturbed, pre=pre,
                     compute_error=True, T=1.0, **params)
        drift = max(drift, float(np.abs(np.asarray(out["err"]) - err).max()
                                 / np.abs(err).max()))
    return drift


def record_sweep(name):
    """Run the JAX package's error sweep on ``SWEEPS[name]`` (serial, in a
    scratch directory); returns its entry of the record: per run the time
    points, the L2 errors, the solver steps per step and the drifts, and
    for the iterative solvers the error series' own drift
    (``own_drift``)."""
    _jax_cpu()
    import tempfile

    import numpy as np

    from structurepreservingiterativesolvers_tpu.experiments.error_sweep import (
        run_sweep,
    )

    args = SWEEPS[name]
    with tempfile.TemporaryDirectory() as tmpdir:
        merged = run_sweep(tmpdir=tmpdir, **args)
    runs = {}
    for run in merged:
        key = f"{run['solver']}_{run['degree']}_{run['tstages']}"
        runs[key] = {
            "time": [float(t) for t in run["time"]],
            "steps": [int(i) for i in run["steps"]],
            **{key2: [float(v) for v in np.asarray(run[key2])]
               for key2 in ("err", "dm", "dmo", "de", "mass", "momentum",
                            "energy")},
        }
        if run["solver"] != "Exact":
            (_, _, tol), = [g for g in args["grid"]
                            if tuple(g[:2]) == (run["degree"], run["tstages"])]
            runs[key]["own_drift"] = own_drift(run, args["N"], args["M"],
                                               args["k"], tol)
    return {"config": {**args, "grid": [list(g) for g in args["grid"]],
                       "solvers": list(args["solvers"]),
                       "drift": {"size": DRIFT_SIZE,
                                 "seeds": list(DRIFT_SEEDS)}},
            "runs": runs}


def batch_systems(name, s):
    """The items of ``BATCHED[name]``: the JAX system ``s``'s
    ``step_update`` of each state of ``batch_states``, or, for lkdvRK
    (``stages``), of each stage vector of ``lkdvrk_stage_states``."""
    import jax.numpy as jnp
    import numpy as np

    if BATCHED[name][6] == "stages":
        B, p = BATCHED[name][2], lkdvrk_field(s.fem, s.prob.mlength,
                                              np.asarray(s.z0)[:s.n0])
        states = lkdvrk_stage_states(p, B, s.prob.ns, s.n0, s.prob.dt)
    else:
        fem = s.prob.fem() if BATCHED[name][6] == "smooth_p2" else None
        states = batch_states(name, np.asarray(s.z0), fem=fem)
    return [s.step_update(jnp.asarray(z)) for z in states]


def record_batched(name):
    """Run the JAX package's ``cgmres_many`` on ``BATCHED[name]``; returns
    its entry of the record: per item the constraints' targets c (as the
    JAX ``step_update`` sums them), the steps, latch, KKT deviation, the
    residual trace of the steps taken, the true residual and x's max-norm
    and sum; the seconds the solve took.  For swe also the JAX package's
    own spread (``spread``): each item solved by the JAX ``cgmres`` with
    its targets summed by numpy (the sums a port's ``step_update`` takes in
    another order: swe's mass and energy targets move by up to 6e-14
    relative) and with ``ortho="mgs"`` (the same algorithm in another
    rounding), their steps, latches, deviations and true residuals.  On
    swe M=512 at tol=1e-9 these change an item's steps by up to 20: the
    endgame's constrained residual levels off near tol."""
    _jax_cpu()
    import time

    import jax.numpy as jnp
    import numpy as np

    from structurepreservingiterativesolvers_tpu.experiments.batched import (
        cgmres_many,
    )
    from structurepreservingiterativesolvers_tpu.experiments.single_solve import (
        get_model,
    )

    problem, params, B, k, tol, pre_spec, kind = BATCHED[name]
    s = get_model(problem).linforms(**params)
    build = pre_builder(name)
    pre = None if build is None else build(s)
    items = batch_systems(name, s)
    t0 = time.perf_counter()
    X, info = cgmres_many(
        s.A, jnp.stack([t.b for t in items]),
        constraints_list=[t.constraints() for t in items], k=k, tol=tol,
        pre=pre)
    X = np.asarray(X)
    steps = [int(v) for v in info["steps"]]
    safety = [int(v) for v in info["safety"]]
    deviation = [float(v) for v in info["deviation"]]
    res = [np.asarray(r)[:st] for r, st in zip(info["res"], steps)]
    secs = time.perf_counter() - t0
    true_res = [float(jnp.linalg.norm(t.A @ jnp.asarray(x) - t.b))
                for t, x in zip(items, X)]
    out = {
        "config": {"problem": problem, "params": params, "batch": B, "k": k,
                   "tol": tol, "items": kind,
                   "solver": "cgmres_many"},
        "n": int(s.b.shape[0]),
        "seconds": secs,
        "targets": [[float(c.c) for c in t.constraints()] for t in items],
        "steps": steps,
        "safety": safety,
        "deviation": deviation,
        "res": [[float(v) for v in r] for r in res],
        "true_residual": true_res,
        "x_max": [float(np.abs(x).max()) for x in X],
        "x_sum": [float(x.sum()) for x in X],
    }
    if problem == "swe":
        out["spread"] = _spread(items, batch_states(name, np.asarray(s.z0)),
                                k, tol, pre)
    if pre_spec in ("amg", "amg_greedy"):
        out["config"]["pre"] = pre_spec
        if pre_spec == "amg_greedy":
            out["amg_levels"] = amg_levels(pre)
    elif pre_spec in ("default", "ras"):
        out["config"]["pre"] = pre_spec
        out["x"] = [[float(v) for v in x] for x in X]
    elif pre_spec is not None:
        _pre_fields(out, pre_spec, pre)
    return out


def _spread(items, states, k, tol, pre):
    """The JAX ``cgmres`` on each item with its targets summed by numpy,
    and with ``ortho="mgs"``: per run the steps, latch, deviation and true
    residual of every item."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from structurepreservingiterativesolvers_tpu.solvers import cgmres

    def numpy_targets(t, z):
        cons = []
        for c in t.constraints():
            terms = 0.0
            if c.v is not None:
                terms += float(np.dot(np.asarray(c.v), z))
            if c.M is not None:
                terms += 0.5 * float(np.dot(z, np.asarray(c.M @ jnp.asarray(z))))
            cons.append(dataclasses.replace(c, c=jnp.asarray(-terms)))
        return cons

    runs = {}
    for label in ("numpy_targets", "mgs"):
        run = {"steps": [], "safety": [], "deviation": [], "true_residual": []}
        for t, z in zip(items, states):
            if label == "mgs":
                cons, kw = t.constraints(), dict(ortho="mgs")
            else:
                cons, kw = numpy_targets(t, z), {}
            x, info = cgmres(t.A, t.b, k=k, tol=tol, pre=pre,
                             constraints=cons, **kw)
            run["steps"].append(int(info["steps"]))
            run["safety"].append({None: 0, True: 1, False: 2}[info["safety"]])
            run["deviation"].append(float(info["deviation"]))
            run["true_residual"].append(
                float(jnp.linalg.norm(t.A @ x - t.b)))
        runs[label] = run
    return runs


def amg_levels(pre) -> list:
    """Each level of an AMG hierarchy: its size and ``operator_format``."""
    return [{"n": int(L.A.shape[0]), **operator_format(L.A)}
            for L in pre.levels]


def record_p2(name):
    """Run the JAX package's ``time_cgmres`` on heat P2 at ``P2_TIMED[name]``
    with the greedy host AMG; returns the row's entry: the operator's format
    and width, the hierarchy's levels, GMRES's and CGMRES's steps, CGMRES's
    constrained steps and latch, both final residuals, and the deviations
    of the mass and energy of both iterates."""
    _jax_cpu()
    from structurepreservingiterativesolvers_tpu.experiments.timed_solve import (
        time_cgmres,
    )

    M, seen = P2_TIMED[name], {}
    build = pre_builder("heat_P2_M16_B3")

    def builder(s):
        seen["system"], seen["pre"] = s, build(s)
        return seen["pre"]

    row = time_cgmres("heat", M=M, degree=2, k=P2_K, tol=P2_TOL,
                      pre_builder=builder)
    s = seen["system"]
    return {
        "config": {"problem": "heat", "params": {"M": M, "degree": 2},
                   "k": P2_K, "tol": P2_TOL, "pre": "amg_greedy",
                   "runner": "time_cgmres"},
        "n": int(s.b.shape[0]),
        "operator": operator_format(s.A),
        "amg_levels": amg_levels(seen["pre"]),
        "gmres_steps": int(row["gmres_steps"]),
        "steps": int(row["steps"]),
        "constrained_steps": int(row["constrained_steps"]),
        "safety": row["safety"],
        "res_final": float(row["res_final"]),
        "gmres_res_final": float(row["gmres_res_final"]),
        "conservation": {kk: (bool(v) if kk.startswith("floor") else float(v))
                         for kk, v in row["conservation"].items()},
    }


def record_report(name):
    """The reporting and oracle records of ``REPORTS[name]``, from the JAX
    package."""
    _jax_cpu()
    import hashlib

    import jax.numpy as jnp
    import numpy as np

    cfg = REPORTS[name]
    out = {"config": cfg}
    if name == "heat_P2_aggregates":
        from structurepreservingiterativesolvers_tpu.models import heat
        from structurepreservingiterativesolvers_tpu.ops.sparse import (
            to_scipy,
        )
        from structurepreservingiterativesolvers_tpu.precond.amg import (
            _aggregate,
            amg,
        )

        for M in cfg["M"]:
            s = heat.linforms(M=M, degree=2)
            pre = amg(s.A_csr, dtype=np.float64)
            levels = []
            for L in pre.levels[:-1]:
                agg = _aggregate(to_scipy(L.A))
                levels.append({
                    "n": int(L.A.shape[0]), "aggregates": int(agg.max()) + 1,
                    "sha256": hashlib.sha256(
                        agg.astype(np.int64).tobytes()).hexdigest()})
            out[f"M{M}"] = levels
        return out
    if name == "lkdv_M20_table":
        from structurepreservingiterativesolvers_tpu.experiments import (
            report,
            wrappers,
        )
        from structurepreservingiterativesolvers_tpu.models import lkdv

        s = lkdv.linforms(M=cfg["M"], degree=cfg["degree"])
        kw = dict(x0=jnp.zeros_like(s.b), k=cfg["k"], tol=1e-50,
                  history=True)
        _, ig = wrappers.gmres_wrapper(s, **kw)
        _, ic = wrappers.cgmres_wrapper(s, **kw)
        table = report.tabulator(s, [ig, ic])
        out["names"] = table["names"]
        out["columns"] = list(table["df"].columns)
        out["values"] = {col: [float(v) for v in table["df"][col]]
                         for col in out["columns"]}
        return out
    if name == "lkdvrk_M20_single_auto":
        from structurepreservingiterativesolvers_tpu.experiments.single_solve import (
            single_solve,
        )

        import dataclasses

        from structurepreservingiterativesolvers_tpu.experiments import (
            wrappers,
        )
        from structurepreservingiterativesolvers_tpu.models import lkdvrk

        run = single_solve("lkdvrk", M=cfg["M"], pre="auto", verbose=False)
        out.update({key: run[key] for key in ("gmres_error", "cgmres_error",
                                              "deviations")})
        out["steps"] = {"gmres": int(run["gmres"][1]["steps"]),
                        "cgmres": int(run["cgmres"][1]["steps"])}
        x = {label: np.asarray(run[label][0]) for label in ("gmres", "cgmres")}
        out["x"] = {label: [float(v) for v in xv] for label, xv in x.items()}
        # the prototypical CGMRES enforces the constraints at every step
        # and stagnates near a residual of 5e-5 with this preconditioner:
        # its iterate moves by percents under a change of b at the
        # rounding level; how far, max|Δx| / max|x| over DRIFT_SEEDS
        s = run["system"]
        pre = lkdvrk.element_block_preconditioner(s)
        kw = dict(x0=jnp.zeros_like(s.b), k=20, tol=1e-50, pre=pre,
                  history=True)
        drift = {"gmres": 0.0, "cgmres": 0.0}
        for seed in DRIFT_SEEDS:
            noise = np.random.default_rng(seed).standard_normal(
                s.b.shape[0])
            sp_ = dataclasses.replace(
                s, b=s.b * (1.0 + DRIFT_SIZE * jnp.asarray(noise)))
            for label, solve in (("gmres", wrappers.gmres_wrapper),
                                 ("cgmres", wrappers.cgmres_wrapper)):
                xp = np.asarray(solve(sp_, **kw)[0])
                drift[label] = max(drift[label], float(
                    np.abs(xp - x[label]).max() / np.abs(x[label]).max()))
        out["own_drift"] = drift
        return out
    if name == "lkdvrk_M50_ilu":
        from structurepreservingiterativesolvers_tpu.models import lkdvrk
        from structurepreservingiterativesolvers_tpu.precond.ilu_oracle import (
            direct_oracle,
            ilu_oracle,
        )
        from structurepreservingiterativesolvers_tpu.solvers import gmres

        s = lkdvrk.linforms(M=cfg["M"], degree=cfg["degree"],
                            tstages=cfg["tstages"])
        for label, oracle in (("ilu", ilu_oracle), ("direct", direct_oracle)):
            _, info = gmres(s.A, s.b, k=cfg["k"], tol=cfg["tol"],
                            pre=oracle(s.A_csr))
            out[label] = {"steps": int(info["steps"]),
                          "res": float(np.asarray(info["res"])[-1])}
        return out
    raise ValueError(f"unknown record {name!r}")


def load(name):
    """The record file that holds configuration ``name``, as a dict."""
    return json.loads(out_path(name).read_text())


def main(names):
    import jax

    for name in names or [*CONFIGS, *EVOLVES, *FUSED, *SWEEPS, *BATCHED,
                          *CORE, *P2_TIMED, *REPORTS, *sorted(SLICE14),
                          *SLICE15, *SLICE17, *SLICE18]:
        path = out_path(name)
        rec = load(name) if path.exists() else {}
        rec["_about"] = (
            "JAX package on the CPU in "
            + ("f32 storage" if name in SLICE15 or name in SLICE17
               else "f64")
            + " (jax " + jax.__version__ + "); "
            "written by scripts/make_torch_reference.py"
        )
        rec[name] = (record_evolve(name) if name in EVOLVES
                     else record_fused(name) if name in FUSED
                     else record_sweep(name) if name in SWEEPS
                     else record_batched(name) if name in BATCHED
                     else record_core(name) if name in CORE
                     else record_p2(name) if name in P2_TIMED
                     else record_report(name) if name in REPORTS
                     else record_parallel(name) if name in SLICE14
                     else record_f32(name) if name in SLICE15
                     else record_slice17(name) if name in SLICE17
                     else record_order(name) if name in SLICE18
                     else record(name))
        print(name, json.dumps(rec[name]), flush=True)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(rec, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    if not sys.argv[1:] or (SLICE14 | {n for n, v in SLICE17.items()
                                       if v[0] == "mesh"}) & set(sys.argv[1:]):
        # the sharded records need the 8-device CPU mesh, set before JAX
        # starts; no other record reads past the first device
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={MESH_DEVICES}"
            ).strip()
    _jax_cpu()
    # ``slice18``: every convergence-order point of ``SLICE18``
    main([n for a in sys.argv[1:]
          for n in (sorted(SLICE18) if a == "slice18" else [a])])
