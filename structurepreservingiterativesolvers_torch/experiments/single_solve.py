"""SingleSolve experiment: one time-step, three solvers, full comparison.

Parity with the reference per-problem scripts (reference
lkdv/SingleSolve.py:14-64 etc.): run GMRES and (prototypical) CGMRES at an
unreachably small tolerance with k iterations, compare both against the
direct solve, and print relative errors and every invariant deviation.
"""

from __future__ import annotations

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
    verbose: bool = True,
    *,
    device,
    ortho: str = "cgs2",
    **params,
):
    model = get_model(problem)
    system = model.linforms(device=device, **params)
    x0 = torch.zeros_like(system.b)

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
    return out
