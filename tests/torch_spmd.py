"""A gloo job of the PyTorch port on the CPU, for the sharded-solve tests:
``run_job(world, cases, tmp)`` starts ``world`` processes (this file as a
script, one rank each), which meet at a ``FileStore`` under ``tmp``, run
the named cases of ``CASES`` in order on the mesh of the world, and pickle
their results; it returns the results of every rank, or raises with the
ranks' output where a rank fails or outlives the timeout.

Imports torch, numpy, scipy and the port only: the ranks never import JAX.
Each rank runs one thread (``torch.set_num_threads(1)``).
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def run_job(world: int, cases, tmp, timeout: float = 240.0) -> list:
    tmp = Path(tmp)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(world), str(rank), str(tmp),
         ",".join(cases)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for rank in range(world)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + "\n(killed at the timeout)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        logs = "\n".join(f"--- rank {r} (exit {p.returncode}):\n{o[-3000:]}"
                         for r, (p, o) in enumerate(zip(procs, outs)))
        raise RuntimeError(f"the gloo job of {world} ranks failed:\n{logs}")
    return [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


# --- the ranks' side ------------------------------------------------------


def _np(t):
    return t.detach().cpu().numpy().copy()


def _info(info) -> dict:
    out = {"steps": int(info["steps"]), "res": np.asarray(info["res"])}
    for key in ("safety", "deviation", "constrained_steps"):
        if key in info:
            out[key] = info[key]
    return out


def tridiag(n: int, diag: float):
    import scipy.sparse as sp

    return sp.csr_matrix(sp.diags([-1.0, diag, -1.0], [-1, 0, 1],
                                  shape=(n, n)))


def halo_matrices(n: int = 256):
    """The halo SpMV's operators and x, from the JAX test's numpy seeds
    (scripts/make_torch_reference.py::halo_matrices builds the same)."""
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
    return Ah, tridiag(n, 2.0), np.random.default_rng(6).standard_normal(n)


def _solve_pair(solver, full, sharded, mesh, loops=("host", "while"), **kw):
    """The unsharded and the sharded solve on each loop: x (the sharded one
    gathered) and the info of each."""
    from structurepreservingiterativesolvers_torch.parallel import gather

    out = {}
    for loop in loops:
        xr, ir = solver(*full, loop=loop, **kw)
        A, b, x0, extra = sharded
        xs, i_s = solver(A, b, x0, loop=loop, **{**kw, **extra})
        out[loop] = {"x": _np(gather(xs, mesh)), "x_ref": _np(xr),
                     "info": _info(i_s), "info_ref": _info(ir)}
    return out


def case_swe(mesh):
    """swe M=8 (n = 192, 48 rows a rank at four ranks, offsets +-79: the
    window is wider than a shard), CGMRES k=15, tol=1e-8, both loops, and
    the host loop with the fused CGS2 twin."""
    import torch

    from structurepreservingiterativesolvers_torch.models import swe
    from structurepreservingiterativesolvers_torch.parallel import shard_system
    from structurepreservingiterativesolvers_torch.solvers import cgmres

    s = swe.linforms(M=8, N=100, device="cpu")
    A, b, x0, cons = shard_system(s.A, s.b, torch.zeros_like(s.b),
                                  s.constraints(), mesh)
    out = _solve_pair(cgmres, (s.A, s.b, None), (A, b, x0, {"constraints": cons}),
                      mesh, k=15, tol=1e-8, constraints=s.constraints())
    out["fused"] = _solve_pair(
        cgmres, (s.A, s.b, None), (A, b, x0, {"constraints": cons}), mesh,
        loops=("host",), k=15, tol=1e-8, constraints=s.constraints(),
        ortho="cgs2_fused")["host"]
    out["window"] = (A.lo, A.hi, A.n_local, A.xchg.peers)
    return out


def case_ell(mesh):
    """The ELL tridiagonal (-1, 4, -1), n = 128, GMRES k=60, tol=1e-10."""
    import torch

    from structurepreservingiterativesolvers_torch.ops import ell_from_scipy
    from structurepreservingiterativesolvers_torch.parallel import (
        shard_matrix,
        shard_vector,
    )
    from structurepreservingiterativesolvers_torch.solvers import gmres

    A = ell_from_scipy(tridiag(128, 4.0), device="cpu")
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(128))
    return _solve_pair(gmres, (A, b, None),
                       (shard_matrix(A, mesh), shard_vector(b, mesh), None, {}),
                       mesh, k=60, tol=1e-10)


def case_halo(mesh):
    """The halo SpMV at n = 256 (offsets +-2 wrapped; the tridiagonal
    unwrapped), and the sharded product with a block of three vectors."""
    import torch

    from structurepreservingiterativesolvers_torch.ops import dia_from_scipy
    from structurepreservingiterativesolvers_torch.parallel import (
        dia_spmv_halo,
        gather,
        shard_matrix,
        shard_vector,
    )

    Ah, Ah2, x = halo_matrices()
    xt = torch.as_tensor(x)
    xs = shard_vector(xt, mesh)
    out = {}
    for key, M in (("wrapped", Ah), ("unwrapped", Ah2)):
        A = dia_from_scipy(M, device="cpu")
        Ash = shard_matrix(A, mesh)
        X = torch.stack([xt, 2.0 * xt, -xt], dim=1)
        out[key] = {"y": _np(gather(dia_spmv_halo(Ash, xs, mesh), mesh)),
                    "y_local": _np(A @ xt),
                    "Y": _np(gather(Ash @ shard_vector(X, mesh), mesh)),
                    "Y_local": _np(A @ X), "peers": Ash.xchg.peers}
    return out


def case_halo_gmres(mesh):
    """GMRES with the halo operator, the tridiagonal (-1, 4, -1), n = 256,
    k=80, tol=1e-10, both loops."""
    import torch

    from structurepreservingiterativesolvers_torch.ops import dia_from_scipy
    from structurepreservingiterativesolvers_torch.parallel import (
        HaloDia,
        shard_matrix,
        shard_vector,
    )
    from structurepreservingiterativesolvers_torch.solvers import gmres

    A = dia_from_scipy(tridiag(256, 4.0), device="cpu")
    b = torch.as_tensor(np.random.default_rng(2).standard_normal(256))
    H = HaloDia(shard_matrix(A, mesh), mesh)
    return _solve_pair(gmres, (A, b, None), (H, shard_vector(b, mesh), None, {}),
                       mesh, k=80, tol=1e-10)


def case_heat_amg(mesh):
    """heat M=31 (n = 1,024) with the structured AMG, the fine level
    sharded and the coarser ones whole (replicate_below=512), CGMRES k=25,
    tol=1e-8, both loops."""
    import torch

    from structurepreservingiterativesolvers_torch.models import heat
    from structurepreservingiterativesolvers_torch.parallel import (
        shard_preconditioner,
        shard_system,
    )
    from structurepreservingiterativesolvers_torch.parallel.sharded import (
        ShardedDIA,
    )
    from structurepreservingiterativesolvers_torch.precond.amg import amg
    from structurepreservingiterativesolvers_torch.solvers import cgmres

    M = 31
    s = heat.linforms(M=M, device="cpu")
    pre = amg(s.A, grid=(M + 1, M + 1))
    A, b, x0, cons = shard_system(s.A, s.b, torch.zeros_like(s.b),
                                  s.constraints(), mesh)
    pre_sh = shard_preconditioner(pre, mesh, replicate_below=512)
    out = _solve_pair(cgmres, (s.A, s.b, None),
                      (A, b, x0, {"constraints": cons, "pre": pre_sh}), mesh,
                      k=25, tol=1e-8, constraints=s.constraints(), pre=pre)
    out["levels"] = [(int(L.A.shape[0]), isinstance(L.A, ShardedDIA))
                     for L in pre_sh.levels]
    return out


def case_cg(mesh):
    """heat M=31 (n = 1,024) with the structured AMG, the fine level
    sharded and the coarser ones whole (replicate_below=512), CG k=200,
    tol=1e-8, both loops: every inner product and norm over the mesh."""
    import torch

    from structurepreservingiterativesolvers_torch.models import heat
    from structurepreservingiterativesolvers_torch.parallel import (
        shard_preconditioner,
        shard_system,
    )
    from structurepreservingiterativesolvers_torch.precond.amg import amg
    from structurepreservingiterativesolvers_torch.solvers import cg

    M = 31
    s = heat.linforms(M=M, device="cpu")
    pre = amg(s.A, grid=(M + 1, M + 1))
    A, b, x0, _ = shard_system(s.A, s.b, torch.zeros_like(s.b),
                               s.constraints(), mesh)
    pre_sh = shard_preconditioner(pre, mesh, replicate_below=512)
    return _solve_pair(cg, (s.A, s.b, None), (A, b, x0, {"pre": pre_sh}),
                       mesh, k=200, tol=1e-8, pre=pre)


def case_snc(mesh):
    """swe M=8 with the skew-normal Chebyshev, sharded as chained sharded
    products, CGMRES k=15, tol=1e-8, both loops."""
    import torch

    from structurepreservingiterativesolvers_torch import precond
    from structurepreservingiterativesolvers_torch.models import swe
    from structurepreservingiterativesolvers_torch.parallel import (
        shard_preconditioner,
        shard_system,
    )
    from structurepreservingiterativesolvers_torch.solvers import cgmres

    s = swe.linforms(M=8, N=100, device="cpu")
    pre = precond.skew_normal_chebyshev(s.A, a=1.0 / s.prob.dt)
    A, b, x0, cons = shard_system(s.A, s.b, torch.zeros_like(s.b),
                                  s.constraints(), mesh)
    return _solve_pair(cgmres, (s.A, s.b, None),
                       (A, b, x0, {"constraints": cons,
                                   "pre": shard_preconditioner(pre, mesh)}),
                       mesh, k=15, tol=1e-8, constraints=s.constraints(),
                       pre=pre)


def case_fused(mesh):
    """fused_evolve("swe", N=4, M=8, k=20, tol=1e-7, T=1.0), unsharded and
    on the mesh."""
    from structurepreservingiterativesolvers_torch.experiments.evolve import (
        fused_evolve,
    )

    out = {}
    for key, m in (("single", None), ("sharded", mesh)):
        r = fused_evolve("swe", N=4, M=8, k=20, tol=1e-7, T=1.0, mesh=m,
                         device="cpu")
        out[key] = {k: np.asarray(r[k]) for k in ("steps", "safety", "de", "dm")}
        out[key]["sol"] = _np(r["sol"])
    return out


def case_fused_fields(mesh):
    """``fused_evolve`` on lkdv (M=20, degree 2, N=3, k=30, tol=1e-6) and
    lkdvRK ((3, 2), M=20, N=2, T=0.4, k=50, tol=1e-8, its default
    pre-builder), whose states split into fields: every rank holds the
    system whole, the solve runs sharded; unsharded and on the mesh."""
    from structurepreservingiterativesolvers_torch.experiments.evolve import (
        fused_evolve,
    )
    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        default_pre_builder,
    )
    from structurepreservingiterativesolvers_torch.models import lkdvrk

    rk = dict(N=2, M=20, degree=3, tstages=2, T=0.4)
    runs = {"lkdv": (dict(N=3, M=20, degree=2, k=30, tol=1e-6), None),
            "lkdvrk": (dict(k=50, tol=1e-8, **rk), default_pre_builder(
                "lkdvrk")(lkdvrk.linforms(device="cpu", **rk)))}
    out = {}
    for problem, (kw, pre) in runs.items():
        for key, m in (("single", None), ("sharded", mesh)):
            r = fused_evolve(problem, mesh=m, pre=pre, device="cpu", **kw)
            out[(problem, key)] = {k: np.asarray(r[k]) for k in (
                "steps", "safety", "dm", "dmo", "de")}
            out[(problem, key)]["sol"] = _np(r["sol"])
    return out


def case_refusals(mesh):
    """What the JAX package refuses under a mesh, and the halo operator's
    conditions: each as (type name, message)."""
    import scipy.sparse as sp
    import torch

    from structurepreservingiterativesolvers_torch.constraints.general import (
        GeneralConstraint,
    )
    from structurepreservingiterativesolvers_torch.ops import (
        bsr_from_scipy,
        dia_from_scipy,
    )
    from structurepreservingiterativesolvers_torch.parallel import (
        dia_spmv_halo,
        shard_constraint,
        shard_matrix,
        shard_vector,
    )

    out = {}

    def attempt(key, fn):
        try:
            fn()
            out[key] = None
        except Exception as e:  # noqa: BLE001 - the refusal is the result
            out[key] = (type(e).__name__, str(e))

    n = 64
    attempt("bsr", lambda: shard_matrix(
        bsr_from_scipy(tridiag(n, 4.0), 2, device="cpu"), mesh))
    attempt("general", lambda: shard_constraint(
        GeneralConstraint(func=lambda x: x.sum(), name="g"), mesh))
    wide = dia_from_scipy(sp.csr_matrix(sp.diags(
        [1.0, 4.0, 1.0], [-(n // 2 + 1), 0, n // 2 + 1], shape=(n, n))),
        wrap=False, device="cpu")
    x = shard_vector(torch.ones(n, dtype=torch.float64), mesh)
    attempt("halo_wide", lambda: dia_spmv_halo(shard_matrix(wide, mesh), x,
                                               mesh))
    attempt("indivisible", lambda: shard_vector(torch.ones(n + 1), mesh))
    return out


def case_meshes(mesh):
    """The global meshes of the job, seen from this rank."""
    from structurepreservingiterativesolvers_torch.parallel import (
        global_mesh,
        host_chip_mesh,
        is_coordinator,
    )

    g, hc = global_mesh(), host_chip_mesh()
    return {"global": (g.size, g.rank, g.shape), "host_chip": hc.shape,
            "ranks": hc.devices.tolist(), "coordinator": is_coordinator()}


def case_f32(mesh):
    """f32 storage under the mesh: swe M=16 with the skew-normal Chebyshev
    (k=20, tol 4e-7·||b||) and heat M=31 with the structured AMG (k=20,
    tol 1e-6·||b||, the levels of 512 rows or more sharded), each on both
    loops beside the unsharded f32 solve, with the wrappers' reduction
    mode; heat M=31's energy matrix and operator's f64 products from f32
    storage sharded (the windowed mixed form) and not; and a 3-step f32
    ``fused_evolve`` on swe M=16 (tol 4e-7·||b|| of its first system),
    unsharded and on the mesh."""
    import torch

    from structurepreservingiterativesolvers_torch import precond
    from structurepreservingiterativesolvers_torch.experiments.evolve import (
        fused_evolve,
    )
    from structurepreservingiterativesolvers_torch.experiments.wrappers import (
        reduction_mode,
    )
    from structurepreservingiterativesolvers_torch.models import heat, swe
    from structurepreservingiterativesolvers_torch.parallel import (
        shard_preconditioner,
        shard_system,
    )
    from structurepreservingiterativesolvers_torch.precond.amg import amg
    from structurepreservingiterativesolvers_torch.solvers import cgmres

    f32 = torch.float32
    out = {}
    for key, M, tol in (("swe", 16, 4e-7), ("heat", 31, 1e-6)):
        if key == "swe":
            s = swe.linforms(M=M, N=100, device="cpu", dtype=f32)
            pre = precond.skew_normal_chebyshev(s.A, a=1.0 / s.prob.dt)
            pre_sh = shard_preconditioner(pre, mesh)
        else:
            s = heat.linforms(M=M, device="cpu", dtype=f32)
            pre = amg(s.A, dtype=f32, grid=(M + 1, M + 1))
            pre_sh = shard_preconditioner(pre, mesh, replicate_below=512)
        tol_abs = tol * float(torch.linalg.norm(s.b.double()))
        opts = reduction_mode(s, tol_abs)
        A, b, x0, cons = shard_system(s.A, s.b, torch.zeros_like(s.b),
                                      s.constraints(), mesh)
        # from x0 None on both sides: a given zero start changes the f32
        # modes (the f32 reduction applies from x0 None only)
        out[key] = _solve_pair(
            cgmres, (s.A, s.b, None),
            (A, b, None, {"constraints": cons, "pre": pre_sh}), mesh, k=20,
            tol=tol_abs, constraints=s.constraints(), pre=pre, **opts)
        out[key]["tol_abs"] = tol_abs
    # the f64 products from f32 storage of the sharded operators (a
    # ShardedDIA's through the windowed mixed form), gathered, beside the
    # unsharded ones
    from structurepreservingiterativesolvers_torch.ops.sparse import (
        matvec_f64,
    )
    from structurepreservingiterativesolvers_torch.parallel import (
        gather,
        shard_matrix,
        shard_vector,
    )

    h = heat.linforms(M=31, device="cpu", dtype=f32)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(
        h.b.shape[0]), dtype=f32)
    out["f64_products"] = {
        key: (_np(gather(shard_matrix(M, mesh).matvec_f64(
            shard_vector(x, mesh)), mesh)), _np(matvec_f64(M, x)))
        for key, M in (("Emat", h.Emat), ("A", h.A.dia))}
    s = swe.linforms(M=16, device="cpu", dtype=f32)
    tol_abs = 4e-7 * float(torch.linalg.norm(s.b.double()))
    for key, m in (("single", None), ("sharded", mesh)):
        r = fused_evolve("swe", N=3, M=16, k=20, tol=tol_abs, T=0.3, mesh=m,
                         dtype=f32, device="cpu")
        out[("fused", key)] = {k: np.asarray(r[k]) for k in (
            "steps", "safety", "de", "dm")}
        out[("fused", key)]["sol"] = _np(r["sol"])
    return out


CASES = {"swe": case_swe, "ell": case_ell, "halo": case_halo,
         "halo_gmres": case_halo_gmres, "heat_amg": case_heat_amg,
         "cg": case_cg,
         "snc": case_snc, "fused": case_fused,
         "fused_fields": case_fused_fields, "refusals": case_refusals,
         "meshes": case_meshes, "f32": case_f32}


def main(world: int, rank: int, tmp: Path, cases) -> None:
    import time

    import torch
    import torch.distributed as dist

    from structurepreservingiterativesolvers_torch.parallel import (
        init_distributed,
        make_mesh,
    )

    torch.set_num_threads(1)
    init_distributed("file://" + str(tmp / "store"), world, rank, device="cpu")
    mesh = make_mesh()
    results = {}
    for name in cases:
        t0 = time.perf_counter()
        results[name] = CASES[name](mesh)
        results.setdefault("_seconds", {})[name] = time.perf_counter() - t0
    dist.barrier()
    dist.destroy_process_group()
    (tmp / f"rank{rank}.pkl").write_bytes(pickle.dumps(results))


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]),
         sys.argv[4].split(","))
