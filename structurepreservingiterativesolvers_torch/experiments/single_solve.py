"""SingleSolve experiment: one time-step, three solvers, full comparison.

Parity with the reference per-problem scripts (reference
lkdv/SingleSolve.py:14-64 etc.): run GMRES and (prototypical) CGMRES at an
unreachably small tolerance with k iterations, compare both against the
direct solve, print relative errors and every invariant deviation, then
optionally tabulate and plot (``report``: pandas and matplotlib, imported
only then).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import report, wrappers


def get_model(name: str):
    from ..models import heat, lkdv, lkdvrk, swe

    return {"lkdv": lkdv, "lkdvrk": lkdvrk, "lkdvRK": lkdvrk, "heat": heat,
            "swe": swe}[name]


def single_solve(
    problem: str = "lkdv",
    k: int = 20,
    tol: float = 1e-50,
    pre=None,
    plot: bool = False,
    filename: Optional[str] = None,
    verbose: bool = True,
    *,
    device,
    ortho: str = "cgs2",
    **params,
):
    """One step of ``problem`` on ``device`` by GMRES, CGMRES and the direct
    solve.  ``pre="auto"`` picks the reference SingleSolve drivers'
    preconditioner: lkdvRK's element-block preconditioner (the stand-in for
    its ILU factor, lkdvRK/SingleSolve.py:19-21), none for the other
    problems (heat's AMG is built but disabled there,
    heat/SingleSolve.py:33-36).  ``plot`` tabulates both solvers' histories
    (``report.tabulator``, ``filename`` + ``.tex``/``.csv`` where given)
    and draws the convergence figure (``filename`` + ``.pdf``, else
    ``plots/convergence.pdf``)."""
    model = get_model(problem)
    system = model.linforms(device=device, **params)
    x0 = torch.zeros_like(system.b)

    if pre == "auto":
        if problem.lower() == "lkdvrk":
            pre = model.element_block_preconditioner(system)
        else:
            pre = None

    kw = dict(x0=x0, k=k, tol=tol, pre=pre, history=True, ortho=ortho)
    x, solvedict = wrappers.gmres_wrapper(system, **kw)
    x_con, geodict = wrappers.cgmres_wrapper(system, **kw)
    x_dir, _ = wrappers.exact(system)

    def rel_error(v):
        return float(torch.max(torch.abs(v - x_dir) / torch.abs(x_dir)))

    out = {
        "system": system,
        "gmres": (x, solvedict),
        "cgmres": (x_con, geodict),
        "direct": x_dir,
        "gmres_error": rel_error(x),
        "cgmres_error": rel_error(x_con),
    }

    devs = {}
    for label, vec in (("gmres", x), ("cgmres", x_con), ("direct", x_dir)):
        inv = system.compute_invariants(vec)
        targets = report._targets(system, list(inv.keys()))
        devs[label] = {kk: float(inv[kk]) - targets[kk] for kk in inv}
    out["deviations"] = devs

    if verbose:
        print(f"cgmres error = {out['cgmres_error']:.6e}")
        print(f"gmres error = {out['gmres_error']:.6e}")
        for label in ("gmres", "cgmres", "direct"):
            for inv, d in devs[label].items():
                print(f"{label} {inv} deviation = {d:.6e}")

    if plot:
        table = report.tabulator(system, [solvedict, geodict],
                                 filename=filename)
        out["table"] = table
        report.convergence_plot(
            table,
            filename=(filename + ".pdf") if filename else None,
            title=problem,
        )
    return out
