"""Shared helpers of the parity tests between the JAX package and its
PyTorch port (``tests/test_torch_*.py``).

Both packages compute on identical operands: a problem is assembled by the
JAX package, exported as numpy arrays, and rebuilt in the port through
``structurepreservingiterativesolvers_torch.interop``.  Everything runs on
the CPU in f64.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import numpy as np
import torch

from structurepreservingiterativesolvers_torch import interop

# the suite runs several pytest workers side by side
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

LKDV_EASY = dict(degree=1, M=50, N=100)
LKDV_HARD = dict(degree=3, M=100, N=100)


def dia_triple(A):
    """A JAX DIA as the (data, offsets, wrap) triple the interop takes."""
    return np.asarray(A.data), tuple(A.offsets), bool(A.wrap)


def export_lkdv(s) -> dict:
    p = s.prob
    return {
        "A": dia_triple(s.A), "Mmat": dia_triple(s.Mmat),
        "Gmat": dia_triple(s.Gmat), "b": np.asarray(s.b),
        "z0": np.asarray(s.z0), "omega": np.asarray(s.omega),
        "m0": float(s.m0), "mo0": float(s.mo0), "e0": float(s.e0),
        "n0": s.n0, "N": p.N, "M": p.M, "degree": p.degree, "space": p.space,
        "T": p.T, "A_csr": s.A_csr,
    }


def export_swe(s) -> dict:
    p = s.prob
    return {
        "A": dia_triple(s.A), "b": np.asarray(s.b), "z0": np.asarray(s.z0),
        "omega": np.asarray(s.omega), "energy_scales": s.Lfull.scales,
        "m0": float(s.m0), "e0": float(s.e0), "n0": s.n0, "N": p.N,
        "M": p.M, "degree": p.degree, "T": p.T, "A_csr": s.A_csr,
    }


def export_heat(s) -> dict:
    p = s.prob
    return {
        "A": dia_triple(getattr(s.A, "dia", s.A)), "Mmat": dia_triple(s.Mmat),
        "Lmat": dia_triple(s.Lmat), "Emat": dia_triple(s.Emat),
        "b": np.asarray(s.b), "z0": np.asarray(s.z0), "Lz0": np.asarray(s.Lz0),
        "omega": np.asarray(s.omega), "m0": float(s.m0), "e0": float(s.e0),
        "old_energy": float(s.old_energy), "N": p.N, "M": p.M,
        "degree": p.degree, "T": p.T, "A_csr": s.A_csr,
    }


def export_lkdvrk(s) -> dict:
    p = s.prob
    return {
        "A_csr": s.A_csr, "Mmat": s.Mh, "Gmat": s.fem.gfunc(),
        "Minv": (np.asarray(s.Minv.blocks), s.Minv.block_rows,
                 s.Minv.block_cols),
        "b": np.asarray(s.b), "z0": np.asarray(s.z0),
        "omega": np.asarray(s.omega), "m0": float(s.m0),
        "mo0": float(s.mo0), "e0": float(s.e0), "n0": s.n0, "N": p.N,
        "M": p.M, "degree": p.degree, "tstages": p.tstages, "space": p.space,
        "T": p.T,
    }


def export_amg(pre) -> dict:
    """A JAX AMG hierarchy as the arguments of ``interop.amg_hierarchy``."""
    levels = []
    for L in pre.levels:
        lv = {"A": (np.asarray(L.A.data), tuple(L.A.offsets)),
              "dinv": np.asarray(L.dinv), "omega": L.omega}
        if L.P is not None:
            lv.update(SP=np.asarray(L.P.S.data), SR=np.asarray(L.R.S.data),
                      C1=L.P.C1, C2=L.P.C2, Cc1=L.P.Cc1, Cc2=L.P.Cc2,
                      box=L.P.b)
        levels.append(lv)
    return {"levels": levels, "coarse_inv": np.asarray(pre.coarse_inv),
            "nu": pre.nu}


def to_port(jax_system):
    """The port's twin of a JAX lkdv, lkdvrk, swe or heat system, on the
    CPU."""
    if hasattr(jax_system, "Minv"):
        return interop.lkdvrk_system(export_lkdvrk(jax_system), device="cpu")
    if hasattr(jax_system, "Lmat"):
        return interop.heat_system(export_heat(jax_system), device="cpu")
    if hasattr(jax_system, "Mmat"):
        return interop.lkdv_system(export_lkdv(jax_system), device="cpu")
    return interop.swe_system(export_swe(jax_system), device="cpu")


def rel_max(a, b) -> float:
    """max|a − b| / max|b|."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def perturbed(b, seed=0, size=1e-15):
    """b with a relative perturbation at the rounding level: the reference's
    own reproducibility under it sets the scale of the parity bounds."""
    b = np.asarray(b)
    rng = np.random.default_rng(seed)
    return b * (1.0 + size * rng.standard_normal(b.shape))


def close(a, b, rtol):
    """max|a − b| ≤ rtol · max|b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.max(np.abs(b))), 1e-300)
    assert np.max(np.abs(a - b)) <= rtol * scale


def heat_systems(pre_builder=None):
    """A getter of (JAX system, port twin, JAX preconditioner) per heat M,
    each built on first use.  The preconditioner is ``pre_builder``'s of the
    JAX system, by default the AMG of the TimedSolve pre-builder."""
    import importlib

    from structurepreservingiterativesolvers_tpu.models import heat as jheat

    # the JAX package's experiments namespace exports a function of this name
    jts = importlib.import_module(
        "structurepreservingiterativesolvers_tpu.experiments.timed_solve")
    build = pre_builder or jts.default_pre_builder("heat")
    cache = {}

    def get(M):
        if M not in cache:
            js = jheat.linforms(M=M)
            cache[M] = (js, to_port(js), build(js))
        return cache[M]

    return get


def reference_script():
    """``scripts/make_torch_reference.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_reference", ROOT / "scripts" / "make_torch_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_record(new, rec):
    """A regenerated entry of the JAX record against the committed one:
    configuration and counts equal, residuals and deviations to 1e-6,
    invariants and spectral bounds to 1e-12."""
    assert new["n"] == rec["n"]
    assert new.get("amg_levels") == rec.get("amg_levels")
    assert new["config"] == rec["config"]
    for key in ("lmin", "lmax"):
        if key in rec:
            assert math.isclose(new[key], rec[key], rel_tol=1e-12), key
    beta = rec["beta"]
    for solver in ("gmres", "cgmres"):
        n, r = new[solver], rec[solver]
        for key in ("steps", "constrained_steps", "safety"):
            assert n.get(key) == r.get(key), (solver, key)
        for key in ("res", "true_residual"):
            assert math.isclose(n[key], r[key], rel_tol=1e-6,
                                abs_tol=1e-12 * beta), (solver, key)
        if "deviation" in r:
            assert math.isclose(n["deviation"], r["deviation"], rel_tol=1e-6,
                                abs_tol=1e-12), (solver, "deviation")
        for key, val in r["invariants"].items():
            assert math.isclose(n["invariants"][key], val, rel_tol=1e-12,
                                abs_tol=1e-14), (solver, key)


def slice7() -> dict:
    """The JAX record of the lkdvRK slice (``reference/slice7.json``)."""
    import json

    return json.loads((ROOT / "structurepreservingiterativesolvers_torch"
                       / "reference" / "slice7.json").read_text())


def operator_format(A) -> dict:
    """DIA with its diagonal count, or ELL with its row width."""
    if hasattr(A, "offsets"):
        return {"format": "DIA", "width": len(A.offsets)}
    return {"format": "ELL", "width": A.row_width}


def check_lkdvrk_row(name, loop="host"):
    """``time_cgmres`` with the default lkdvRK pre-builder, both solvers on
    ``loop``, against the record's entry ``name``; returns the row.  CGMRES is held as the device core is held
    (``tests/test_torch_fused.py``): certified where the record certifies,
    in at most the record's steps and constrained steps.  The port pins a
    linear constraint whose value every iterate keeps within its floor
    (``solvers/kkt.py::pins``): lkdvRK's stage-mapped mass is 0 at the start
    to roundoff and its Krylov vectors carry none, so the JAX package's KKT
    matrix is singular there and its endgame takes more steps (5 against
    2 at M=50, (3, 2))."""
    # the module (the experiments package exports a function of the same
    # name, as the JAX package's does)
    tts = importlib.import_module(
        "structurepreservingiterativesolvers_torch.experiments.timed_solve")

    rec = slice7()[name]
    cfg = rec["config"]
    seen = {}

    def builder(system):
        pre = tts.default_pre_builder("lkdvrk")(system)
        seen.update(operator_format(system.A),
                    ras_blocks=list(pre.inner.idx.shape))
        return pre

    out = tts.time_cgmres("lkdvrk", k=cfg["k"], tol=cfg["tol"],
                          pre_builder=builder, device="cpu", loop=loop,
                          **cfg["params"])
    assert seen == {"format": rec["format"], "width": rec["width"],
                    "ras_blocks": rec["ras_blocks"]}
    assert abs(out["gmres_steps"] - rec["gmres"]["steps"]) <= 1
    assert out["steps"] <= rec["cgmres"]["steps"]
    assert out["constrained_steps"] <= rec["cgmres"]["constrained_steps"]
    assert out["safety"] is rec["cgmres"]["safety"] is True
    assert max(out["conservation"][f"cgmres_{nm}"]
               for nm in out["invariant_names"]) <= 1e-10
    return out


def slice12() -> dict:
    """The JAX record of lkdvRK on the device core
    (``reference/slice12.json``)."""
    import json

    return json.loads((ROOT / "structurepreservingiterativesolvers_torch"
                       / "reference" / "slice12.json").read_text())


def check_lkdvrk_runs(merged, name, floor=1e-8):
    """An error sweep's runs against the record's entry ``name``: the
    errors of every run within max(``floor``, 10× the record's own drift
    of that run's series under a 1e-15 change of b), relative; the steps
    within one, the mass drift at most 1e-9."""
    runs = slice7()[name]["runs"]
    assert len(merged) == len(runs)
    for run in merged:
        rec = runs[f"{run['solver']}_{run['degree']}_{run['tstages']}"]
        np.testing.assert_allclose(run["time"], rec["time"], rtol=1e-15)
        close(run["err"], rec["err"],
              max(floor, 10.0 * rec.get("own_drift", 0.0)))
        assert all(abs(a - b) <= 1 for a, b in zip(run["steps"], rec["steps"]))
        assert max(run["dm"]) <= 1e-9
