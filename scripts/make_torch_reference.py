"""Record what the JAX package computes on the configurations of the PyTorch
port's slices, so a run of the port on a machine without JAX can be held
against it.

Runs the JAX package on the CPU in f64 and writes, under
``structurepreservingiterativesolvers_torch/reference/``, ``slice1.json``
(lkdv and swe, unpreconditioned) and ``slice2.json`` (heat with the
structured AMG of the TimedSolve pre-builder): for each configuration,
GMRES and CGMRES through the experiment wrappers, with their steps,
constrained steps, safety latch, KKT deviation, final true residual and the
invariants of the returned iterate; for heat also the AMG level sizes.

    python scripts/make_torch_reference.py            # every configuration
    python scripts/make_torch_reference.py swe_M64    # only the named ones

``swe_M512`` (n = 786,432) and ``heat_M1024`` (n = 1,050,625) take a few
minutes each on the CPU.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "structurepreservingiterativesolvers_torch" / "reference"

# name -> (problem, linforms parameters, k, tol, x0 is zeros (else None),
# history).  lkdv_easy is the reference SingleSolve (tol below 1e-20 selects
# the prototypical CGMRES); lkdv_hard is the configuration of
# tests/test_cgmres_lkdv.py::test_cgmres_beats_gmres_on_invariants; swe is
# the f64 dynamics configuration, unpreconditioned.  heat is the reference's
# TimedSolve (k=20, tol=1e-7 absolute) with the structured AMG that
# experiments/timed_solve.py::default_pre_builder pairs it with.
CONFIGS = {
    "lkdv_easy": ("lkdv", dict(degree=1, M=50, N=100), 20, 1e-50, True, True),
    "lkdv_hard": ("lkdv", dict(degree=3, M=100, N=100), 50, 1e-6, False, False),
    "swe_M64": ("swe", dict(M=64), 60, 1e-9, False, False),
    "swe_M512": ("swe", dict(M=512), 60, 1e-9, False, False),
    "heat_M32": ("heat", dict(M=32), 20, 1e-7, False, False),
    "heat_M64": ("heat", dict(M=64), 20, 1e-7, False, False),
    "heat_M1024": ("heat", dict(M=1024), 20, 1e-7, False, False),
}


def out_path(name) -> Path:
    """The record file that holds configuration ``name``."""
    heat = CONFIGS[name][0] == "heat"
    return REFERENCE / ("slice2.json" if heat else "slice1.json")


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
    from structurepreservingiterativesolvers_tpu.models import heat, lkdv, swe

    problem, params = CONFIGS[name][:2]
    return {"lkdv": lkdv, "swe": swe, "heat": heat}[problem].linforms(**params)


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
    from structurepreservingiterativesolvers_tpu.experiments.timed_solve import (
        default_pre_builder,
    )

    problem, params, k, tol, zero_x0, history = CONFIGS[name]
    s = system(name) if s is None else s
    pre = default_pre_builder(problem)(s) if problem == "heat" else None
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
    if pre is not None:
        out["config"]["pre"] = "amg"
        out["amg_levels"] = [int(L.A.shape[0]) for L in pre.levels]
    return out


def load(name):
    """The record file that holds configuration ``name``, as a dict."""
    return json.loads(out_path(name).read_text())


def main(names):
    import jax

    for name in names or list(CONFIGS):
        path = out_path(name)
        rec = load(name) if path.exists() else {}
        rec["_about"] = (
            "JAX package on the CPU in f64 (jax " + jax.__version__ + "); "
            "written by scripts/make_torch_reference.py"
        )
        rec[name] = record(name)
        print(name, json.dumps(rec[name]), flush=True)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(rec, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    _jax_cpu()
    main(sys.argv[1:])
