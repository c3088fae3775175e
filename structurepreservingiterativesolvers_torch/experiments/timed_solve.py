"""TimedSolve benchmark harness: size sweep, GMRES vs timed CGMRES.

The port of the JAX package's ``experiments/timed_solve.py`` (reference
heat/TimedSolve.py:25-162): for each mesh size, build a preconditioner
(timed separately), run GMRES and CGMRES with ``timing=True``, check the
conservation gain (≥2× expected — the reference's warning,
heat/TimedSolve.py:75-80), and print a markdown table of per-phase timings
and gains.  Times are host-clock walls that end in a device
synchronisation.
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from . import wrappers
from .single_solve import get_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def default_pre_builder(problem: str):
    """Preconditioner choice per problem, as the JAX package pairs them:
    heat → smoothed-aggregation AMG built on the operator's device: on a
    DIA or ``Stencil`` operator (P1) the structured setup on the (M+1)×(M+1)
    vertex grid; on an ELL operator (P2) the greedy host setup of the
    system's scipy matrix, the path the JAX ``amg`` keeps for unstructured
    operators (the JAX package's own default hands the ELL to its
    structured setup, which cannot convert it and raises); swe → the
    skew-normal Chebyshev polynomial of its shifted-skew operator
    A = I/dt − S/2 (a = 1/dt);
    lkdvRK → RAS over about 5 blocks of elements (halo max(2, eb // 5)
    elements a side, inverses built on the host) with a degree-3 Neumann
    acceleration; any other problem (lkdv) → none."""
    if problem == "heat":
        from ..ops.sparse import ELL
        from ..precond.amg import amg

        def build(system):
            if isinstance(system.A, ELL):
                return amg(system.A_csr, dtype=system.b.dtype,
                           device=system.b.device)
            C = system.prob.M + 1
            return amg(system.A, dtype=system.b.dtype, grid=(C, C))

        return build
    if problem == "swe":
        from ..precond.chebyshev import skew_normal_chebyshev

        return lambda system: skew_normal_chebyshev(system.A,
                                                    a=1.0 / system.prob.dt)
    if problem.lower() == "lkdvrk":
        from ..models import lkdvrk
        from ..precond.chebyshev import neumann_composite

        def build(system):
            ne = system.n0 // (system.prob.degree + 1)
            target = max(ne // 5, 2)
            eb = max(d for d in range(1, target + 1) if ne % d == 0)
            inner = lkdvrk.element_block_preconditioner(
                system, elems_per_block=eb, overlap=max(2, eb // 5))
            return neumann_composite(system.A, inner, degree=3)

        return build
    return lambda system: None


def certified_deviations(system, x) -> dict:
    """|g(x)| per constraint, evaluated without f32 noise (JAX
    ``timed_solve.py:76-95``): with f32 storage in f64 from the f32 loads
    (``value_f64``, the solver's certificate; the constraint is the stored
    one), with f64 storage the plain evaluation."""
    from ..constraints.quadratic import value_f64

    return {con.name: abs(float(value_f64(con, x) if x.dtype == torch.float32
                                else con(x)))
            for con in system.constraints()}


def time_cgmres(
    problem: str = "heat",
    M: int = 2**4,
    degree: int = 1,
    tol: float = 1e-7,
    k: int = 20,
    pre_builder: Optional[Callable] = None,
    tol_mode: str = "abs",
    *,
    device,
    ortho: str = "cgs2",
    loop: str = "host",
    **params,
):
    """One row of the sweep.  ``tol_mode='rhs'`` scales ``tol`` by ‖b‖;
    ``ortho`` is both solvers' Arnoldi orthogonalisation
    (``solvers.arnoldi.arnoldi_step``); ``loop`` both solvers' loop:
    ``"host"`` (the default, every earlier record's) or ``"while"``, the
    device core, the JAX package's default (its ``time_cgmres`` runs
    both solvers there).  ``dtype=torch.float32`` (through ``params`` to the
    model) runs the row in f32 storage: CGMRES takes its reduction mode
    from ``wrappers.reduction_mode`` and projects its iterate
    (``resolve_modes``), and the deviations are the f64 certificates.  On
    the device core the warm-up captures the graphs, so the timed solves
    replay them; the row's ``time_capture`` is the timed CGMRES solve's (0
    after the warm-up)."""
    model = get_model(problem)
    system = model.linforms(M=M, degree=degree, device=device, **params)
    dev = system.b.device
    # the zero start (reference heat/TimedSolve.py:43) as None, so that the
    # solvers know it: with f32 storage the snap-first reduction applies
    # from a zero start only (JAX timed_solve.py:183-189)
    x0 = None
    if tol_mode == "rhs":
        tol = tol * float(torch.linalg.norm(system.b))
    elif tol_mode != "abs":
        raise ValueError(f"tol_mode must be 'abs' or 'rhs', got {tol_mode!r}")

    pre_builder = pre_builder or default_pre_builder(problem)
    start_pre = time.perf_counter()
    pre = pre_builder(system)
    _sync(dev)
    end_pre = time.perf_counter()
    # the second build is the recurring cost the reference's "pre build"
    # column measures (PyAMG setup runs per call, heat/TimedSolve.py:30-37);
    # the first also pays one-time library and allocator set-up
    start_pre2 = time.perf_counter()
    pre = pre_builder(system)
    _sync(dev)
    end_pre2 = time.perf_counter()

    # warm up both solvers so the reported times are steady-state
    kw = dict(x0=x0, k=k, tol=tol, pre=pre, ortho=ortho, loop=loop)
    t0 = time.perf_counter()
    wrappers.gmres_wrapper(system, **kw)
    wrappers.cgmres_wrapper(system, timing=True, **kw)
    _sync(dev)
    compile_time = time.perf_counter() - t0

    start_gmres = time.perf_counter()
    gmres_x, solvedict = wrappers.gmres_wrapper(system, **kw)
    _sync(dev)
    end_gmres = time.perf_counter()

    cgmres_x, geodict = wrappers.cgmres_wrapper(system, timing=True, **kw)

    # conservation-gain check (reference heat/TimedSolve.py:67-80)
    names = []
    conservation = {}
    devs_g = certified_deviations(system, gmres_x)
    devs_c = certified_deviations(system, cgmres_x)
    for con in system.constraints():
        nm = con.name
        names.append(nm)
        scale = max(abs(float(con.c)), 1.0)
        dg, dc = devs_g[nm], devs_c[nm]
        conservation[f"gmres_{nm}"] = dg
        conservation[f"cgmres_{nm}"] = dc
        # floor-dominated: GMRES is already at the invariant's roundoff
        # floor, so the gain ratio certifies nothing
        conservation[f"floor_{nm}"] = dg < 1e-12 * scale
        if not (dc < 0.5 * dg or conservation[f"floor_{nm}"]):
            warnings.warn(
                f"CGMRES does not lead to a significant improvement in {nm} "
                f"with M={M} and tol={tol}"
            )

    out = dict(geodict["timings"])
    out["steps"] = geodict["steps"]
    out["unconstrained_steps"] = geodict["steps"] - out["constrained_steps"]
    out["time_pre"] = end_pre2 - start_pre2
    out["time_pre_first"] = end_pre - start_pre
    out["time_gmres"] = end_gmres - start_gmres
    out["gmres_steps"] = solvedict["steps"]
    out["compile_time"] = compile_time
    out["conservation"] = conservation
    out["invariant_names"] = names
    out["safety"] = geodict["safety"]
    out["res_final"] = float(np.asarray(geodict["res"])[-1])
    out["gmres_res_final"] = float(np.asarray(solvedict["res"])[-1])
    out["tol_effective"] = tol
    return out


def _markdown(rows) -> str:
    cols = list(rows[0])

    def fmt(col, v):
        if isinstance(v, float) and ("time" in col.lower() or "Gain" in col
                                     or "deviation" in col or "residual" in col):
            return f"{v:.2e}"
        return str(v)

    lines = ["| " + " | ".join(cols) + " |",
             "|" + "|".join("---" for _ in cols) + "|"]
    lines += ["| " + " | ".join(fmt(c, r[c]) for c in cols) + " |" for r in rows]
    return "\n".join(lines)


def timed_solve(
    problem: str = "heat",
    sizes: Optional[Sequence[int]] = None,
    degree: int = 1,
    tol: float = 1e-7,
    k: int = 20,
    pre_builder: Optional[Callable] = None,
    to_markdown: bool = True,
    tol_mode: str = "abs",
    *,
    device,
    ortho: str = "cgs2",
    loop: str = "host",
    **params,
):
    """Size sweep (reference: heat M=2⁴..2¹¹, swe M=2⁴..2⁹).  Returns one
    dict per size and prints them as a markdown table like the reference.
    ``loop`` as in ``time_cgmres``."""
    if sizes is None:
        sizes = [2**i for i in range(4, 9)]

    rows = []
    for M in sizes:
        out = time_cgmres(problem, M=M, degree=degree, tol=tol, k=k,
                          pre_builder=pre_builder, tol_mode=tol_mode,
                          device=device, ortho=ortho, loop=loop, **params)
        con = out["conservation"]
        row = {
            "M": M,
            "safety": out["safety"],
            "CGMRES final residual": out["res_final"],
            "GMRES final residual": out["gmres_res_final"],
            "GMRES iterations": out["gmres_steps"],
            "Preconditioning time": out["time_pre"],
            "GMRES run time": out["time_gmres"],
            "CGMRES run time": out["runtime"],
            "Average unconstrained iteration time": out["iter_time_unconstrained"],
            "Number of unconstrained iterations": out["unconstrained_steps"],
            "Average overhead from building constraints": out["constraint_building"],
            "Average constrained iteration time": out["iter_time_constrained"],
            "Number of constrained iterations": out["constrained_steps"],
        }
        for nm in out["invariant_names"]:
            gain = max(con[f"gmres_{nm}"], 1e-16) / max(con[f"cgmres_{nm}"], 1e-16)
            row[f"Gain in {nm} conservation"] = gain
            row[f"{nm} deviation (GMRES)"] = con[f"gmres_{nm}"]
            row[f"{nm} deviation (CGMRES)"] = con[f"cgmres_{nm}"]
            row[f"{nm} floor-dominated"] = con[f"floor_{nm}"]
        rows.append(row)

    if to_markdown:
        print(_markdown(rows))
        if any(r.get(f"{nm} floor-dominated")
               for r in rows for nm in out["invariant_names"]):
            print(
                "\nfloor-dominated: GMRES already sits at the invariant's "
                "roundoff floor for this row, so the gain ratio certifies "
                "nothing (there was no deviation left to remove)."
            )
    return rows
