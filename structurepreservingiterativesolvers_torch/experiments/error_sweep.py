"""Convergence-order error sweep with a process fan-out.

The port of the JAX package's ``experiments/error_sweep.py`` (reference
lkdvRK/ErrorGenerator.py:11-80 → subcall.py:16-67 → ErrorPlotter.py:11-46):
Exact, GMRES and CGMRES lkdvRK evolutions over a (degree, tstages, tol)
grid, one pickle per run keyed by its parameters, merged with failed runs
skipped (reference ErrorGenerator.py:62-74), and a plot of the L2 error
against time.

Every run pins its device.  ``run_sweep`` runs the grid in this process by
default; ``parallel=True`` starts one worker process per run, at most
``max_processes`` at a time (the reference's CPU pool), each running
``python -m structurepreservingiterativesolvers_torch.experiments.error_sweep``
on the same device.  ``loop`` is the iterative solvers' loop: ``"host"``
(the default, every earlier record's) or ``"while"``, the device core, the
JAX package's default; there one cached core serves every step of an
evolution (the stepped systems share A, the preconditioner and the
constraints' operators), so on the card its graphs are captured once and
replayed for every step.  ``dtype`` is the storage dtype (f64, or f32:
the JAX package's TPU mode, its ``SPIS_FORCE_DTYPE=float32`` read by
``default_dtype()``): the models', the preconditioner's, and the solvers'
f32 modes; each run's pickle names it, and the merged file of an f32 sweep
is ``error_float32.pickle``, so f32 and f64 sweeps never overwrite each
other.

    python -m structurepreservingiterativesolvers_torch sweep --M 400 --N 10
    python -m structurepreservingiterativesolvers_torch sweep --M 50 --N 3 --device cpu
    python -m structurepreservingiterativesolvers_torch sweep --M 50 --N 3 --loop while --device cpu
    python -m structurepreservingiterativesolvers_torch sweep --M 50 --N 3 --dtype float32 --device cpu
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from typing import List, Optional, Sequence, Tuple

import torch

# the reference's grid (lkdvRK/ErrorGenerator.py:28-39)
DEFAULT_GRID: Sequence[Tuple[int, int, float]] = (
    (3, 2, 1e-3),
    (4, 3, 1e-5),
    (5, 4, 1e-7),
)
SOLVERS = ("Exact", "GMRES", "CGMRES")


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _pickle_path(tmpdir, solver, tstages, degree, tol, N, M,
                 dtype=torch.float64):
    return os.path.join(
        tmpdir,
        f"error{solver}{tstages}{degree}{tol}{N}{M}{_dtype_name(dtype)}.pickle"
    )


def _merged_path(tmpdir, dtype=torch.float64):
    """``error.pickle`` for an f64 sweep, ``error_float32.pickle`` for an
    f32 one."""
    name = _dtype_name(dtype)
    return os.path.join(tmpdir, "error.pickle" if name == "float64"
                        else f"error_{name}.pickle")


def run_single(
    solver: str,
    degree: int,
    tstages: int,
    tol: float,
    N: int = 10,
    M: int = 400,
    k: int = 50,
    tmpdir: str = "tmp",
    precondition: bool = True,
    loop: str = "host",
    dtype=torch.float64,
    *,
    device,
) -> dict:
    """One evolution on ``device`` (the reference's ``subcall``) in storage
    ``dtype``, with the RAS + Neumann composite of the TimedSolve
    pre-builder built once on its first system (its inverses in ``dtype``),
    each step's solve on ``loop``; the result is pickled and returned."""
    from ..models import lkdvrk
    from . import wrappers
    from .evolve import evolve
    from .timed_solve import default_pre_builder

    os.makedirs(tmpdir, exist_ok=True)
    pre = None
    if precondition and solver != "Exact":
        sys0 = lkdvrk.linforms(N=N, M=M, degree=degree, tstages=tstages,
                               T=1.0, dtype=dtype, device=device)
        pre = default_pre_builder("lkdvrk")(sys0)

    if solver == "Exact":
        def step_solver(system, x0=None, k=k, tol=tol, pre=None):
            return wrappers.exact(system)[0], {"steps": -1}
    else:
        solve = {"GMRES": wrappers.gmres_wrapper,
                 "CGMRES": wrappers.cgmres_wrapper}[solver]

        def step_solver(system, x0=None, k=k, tol=tol, pre=pre):
            return solve(system, x0=x0, k=k, tol=tol, pre=pre, loop=loop)

    out = evolve("lkdvrk", N=N, M=M, degree=degree, tstages=tstages, T=1.0,
                 k=k, tol=tol, solver=step_solver, pre=pre,
                 compute_error=True, dtype=dtype, device=device)
    out.pop("sol", None)  # a device tensor; the pickles stay portable
    out.update(degree=degree, tstages=tstages, solver=solver,
               dtype=_dtype_name(dtype))
    with open(_pickle_path(tmpdir, solver, tstages, degree, tol, N, M, dtype),
              "wb") as fh:
        pickle.dump(out, fh)
    return out


def run_sweep(
    grid: Sequence[Tuple[int, int, float]] = DEFAULT_GRID,
    solvers: Sequence[str] = SOLVERS,
    N: int = 10,
    M: int = 400,
    k: int = 50,
    tmpdir: str = "tmp",
    parallel: bool = False,
    max_processes: int = 12,
    loop: str = "host",
    dtype=torch.float64,
    *,
    device,
) -> List[dict]:
    """The whole sweep on ``device`` in storage ``dtype``, the iterative
    solvers on ``loop``; the merged results are written to
    ``<tmpdir>/error.pickle`` (f64; ``error_float32.pickle`` in f32) and
    returned."""
    os.makedirs(tmpdir, exist_ok=True)
    runs = [(solver, degree, tstages, tol)
            for degree, tstages, tol in grid for solver in solvers]
    if parallel:
        procs: List[subprocess.Popen] = []
        for solver, degree, tstages, tol in runs:
            if len(procs) >= max_processes:
                procs.pop(0).wait()
            procs.append(subprocess.Popen([
                sys.executable, "-m",
                "structurepreservingiterativesolvers_torch.experiments.error_sweep",
                solver, str(degree), str(tstages), str(tol), str(N), str(M),
                str(k), tmpdir, str(device), loop, _dtype_name(dtype)]))
        for proc in procs:
            proc.wait()
    else:
        for solver, degree, tstages, tol in runs:
            run_single(solver, degree, tstages, tol, N=N, M=M, k=k,
                       tmpdir=tmpdir, loop=loop, dtype=dtype, device=device)

    # merge, skipping the runs that failed (reference ErrorGenerator.py:62-74)
    merged = []
    for solver in solvers:
        for degree, tstages, tol in grid:
            path = _pickle_path(tmpdir, solver, tstages, degree, tol, N, M,
                                dtype)
            try:
                with open(path, "rb") as fh:
                    merged.append(pickle.load(fh))
            except (OSError, pickle.UnpicklingError, EOFError) as e:
                print(f"Loading {path} failed with: {e}")
    with open(_merged_path(tmpdir, dtype), "wb") as fh:
        pickle.dump(merged, fh)
    return merged


def error_plot(tmpdir: str = "tmp", filename: Optional[str] = None,
               dtype=torch.float64):
    """L2 error against time per solver and configuration (reference
    ErrorPlotter.py), of the sweep in ``dtype``.  Needs matplotlib, which
    raises ``ImportError`` where it is not installed."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(_merged_path(tmpdir, dtype), "rb") as fh:
        data = pickle.load(fh)

    styles = {"Exact": "solid", "GMRES": "dotted", "CGMRES": "dashed"}
    colors = ["r", "b", "k", "g", "m"]
    fig, ax = plt.subplots(figsize=(7, 5))
    for i, dic in enumerate(data):
        ax.semilogy(
            dic["time"], dic["err"], lw=2, linestyle=styles[dic["solver"]],
            color=colors[i % len(colors)],
            label=f"{dic['solver']}: q={dic['degree']}, s={dic['tstages']}",
        )
    ax.set_xlabel("t")
    ax.set_ylabel("L2 error")
    ax.legend(loc="best", fontsize="small", ncol=3)
    fig.tight_layout()
    out = filename or os.path.join("plots", "lkdvRKError.pdf")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    fig.savefig(out)
    plt.close(fig)
    print(f"Figure saved as {out}")
    return out


if __name__ == "__main__":
    # a worker of the fan-out: solver degree tstages tol N M k tmpdir device
    # loop dtype
    a = sys.argv[1:]
    run_single(a[0], int(a[1]), int(a[2]), float(a[3]), int(a[4]), int(a[5]),
               int(a[6]), a[7], loop=a[9], dtype=getattr(torch, a[10]),
               device=a[8])
