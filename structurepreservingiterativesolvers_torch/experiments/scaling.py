"""Multi-device scaling measurements: SpMV throughput and solve time against
the number of devices (the port of the JAX package's
``experiments/scaling.py``).

The port runs one process per device, so a device count is a number of
ranks.  The row of the current world's size runs in this process (a world
of one process where none is set up); a row of another count runs as a
spawned job of that many processes (``dist-bench``, ``spawn_local``), one
device each: on one card only the one-device row runs.  Times are host
clocks around work that ends in a device synchronisation, medians of the
repetitions.

``dist_bench_worker`` is one process of a distributed job (every process
runs it with the same arguments; the coordinator prints one ``DIST_RESULT
{json}`` line with the JAX package's keys), ``dist_efficiency`` spawns a
job per process count and reports the strong-scaling efficiency
t₁·d₁ / (t_N·d_N) of the solve and of the SpMV.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

_DIST_TAG = "DIST_RESULT "


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _med(fn, device, reps=10, warmup=2) -> float:
    """The median wall of ``fn`` over ``reps`` calls, each ended by a
    device synchronisation, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    _sync(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _world(device: str) -> int:
    """The size of the current distributed world, set up (one process on
    ``device``: NCCL on the card, which must be present, or gloo with
    ``"cpu"``) if it is not."""
    import torch.distributed as dist

    from ..parallel import init_distributed

    if not dist.is_initialized():
        init_distributed(device=device)
    return dist.get_world_size()


def _counts(n: int, device: str, device_counts) -> list:
    if device_counts is not None:
        return list(device_counts)
    avail = (torch.cuda.device_count() if device == "cuda"
             else os.cpu_count() or 1)
    return [d for d in (1, 2, 4, 8, 16) if d <= avail and n % d == 0]


def _spawned(d: int, problem: str, M: int, k: int, tol: float,
             device: str) -> dict:
    """The ``DIST_RESULT`` of a ``dist-bench`` job of d processes."""
    return _dist_job(d, ["dist-bench", "--problem", problem, "--M", str(M),
                         "--k", str(k), "--tol", str(tol), "--device", device],
                     device)


def spmv_scaling(problem: str = "swe", M: int = 64,
                 device_counts: Optional[Sequence[int]] = None,
                 device: str = "cuda", **params):
    """The sharded SpMV's time against the number of devices: the world's
    own size in this process, any other as a spawned job.  ``device``: the
    card (NCCL), or ``"cpu"`` (gloo) where the caller asks for it."""
    from ..parallel import make_mesh, shard_matrix, shard_vector
    from .single_solve import get_model

    world = _world(device)
    s = get_model(problem).linforms(M=M, device=device, **params)
    nnz, n = s.A_csr.nnz, s.b.shape[0]
    rows, t1 = [], None
    for d in _counts(n, device, device_counts):
        if d == world:
            mesh = make_mesh()
            A, x = shard_matrix(s.A, mesh), shard_vector(s.b, mesh)
            t = _med(lambda: A @ x, mesh.device)
        else:
            t = _spawned(d, problem, M, 20, 1e-7, device)["spmv_time_s"]
        t1 = t if t1 is None else t1
        rows.append({"devices": d, "time_s": t, "nnz_per_s": nnz / t,
                     "speedup": t1 / t, "efficiency": t1 / t / d})
    return rows


def solve_scaling(problem: str = "swe", M: int = 64, k: int = 20,
                  tol: float = 1e-7,
                  device_counts: Optional[Sequence[int]] = None,
                  device: str = "cuda", **params):
    """The sharded CGMRES solve's time on the device core against the
    number of devices: the world's own size in this process, any other as
    a spawned ``dist-bench`` job.  ``device``: the card (NCCL), or
    ``"cpu"`` (gloo) where the caller asks for it."""
    from ..parallel import make_mesh, shard_system
    from ..solvers import cgmres
    from .single_solve import get_model

    world = _world(device)
    s = get_model(problem).linforms(M=M, device=device, **params)
    n = s.b.shape[0]
    rows, t1 = [], None
    for d in _counts(n, device, device_counts):
        if d == world:
            mesh = make_mesh()
            A, b, x0, cons = shard_system(s.A, s.b, torch.zeros_like(s.b),
                                          s.constraints(), mesh)

            def run():
                cgmres(A, b, x0, k=k, tol=tol, constraints=cons,
                       loop="while")

            t = _med(run, mesh.device, reps=5, warmup=1)
        else:
            t = _spawned(d, problem, M, k, tol, device)["solve_time_s"]
        t1 = t if t1 is None else t1
        rows.append({"devices": d, "time_s": t, "speedup": t1 / t,
                     "efficiency": t1 / t / d})
    return rows


def report(rows, cols: Optional[Sequence[str]] = None) -> str:
    """The rows as a markdown table (``cols``: the columns, every key of
    the first row by default)."""
    cols = list(cols or rows[0])

    def cell(v):
        return f"{v:.6g}" if isinstance(v, float) else str(v)

    lines = ["| " + " | ".join(cols) + " |",
             "|" + "|".join("---" for _ in cols) + "|"]
    lines += ["| " + " | ".join(cell(r.get(c)) for c in cols) + " |"
              for r in rows]
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# distributed jobs: a worker, and the spawner of one job per process count


def dist_bench_worker(problem: str = "swe", M: int = 32, k: int = 20,
                      tol: float = 1e-6, reps: int = 3,
                      device: str = "cuda"):
    """One process of a distributed benchmark job.  Every process runs this
    with the same arguments (SPMD); the coordinator prints one
    ``DIST_RESULT {json}`` line with the solve's and the SpMV's times on
    the global mesh, the latency of one all-reduce of a tiny vector (the
    shape of every inner product), and the solve's steps, deviation and
    latch.  ``hosts`` is the number of processes (the JAX package's
    ``process_count``), ``devices`` the mesh's (one a process).  The solve
    runs on the device core; ``device`` is the card (NCCL), or ``"cpu"``
    (gloo) where the caller asks for it."""
    from ..parallel import (
        global_mesh,
        init_distributed,
        is_coordinator,
        psum,
        shard_system,
        shard_vector,
    )
    from ..solvers import cgmres
    from .single_solve import get_model

    init_distributed(device=device)
    mesh = global_mesh()
    nd = mesh.size
    s = get_model(problem).linforms(M=M, device=mesh.device)
    n = s.b.shape[0]
    if n % nd:
        raise ValueError(f"n={n} not divisible by {nd} global devices")
    nnz = s.A_csr.nnz
    A, b, x0, cons = shard_system(s.A, s.b, torch.zeros_like(s.b),
                                  s.constraints(), mesh)
    xs = shard_vector(s.b, mesh)
    t_spmv = _med(lambda: A @ xs, mesh.device, reps=max(reps, 5))
    tiny = torch.ones(8, dtype=s.b.dtype, device=mesh.device)
    t_coll = _med(lambda: psum(tiny.clone(), mesh), mesh.device,
                  reps=max(reps, 5))

    def solve():
        return cgmres(A, b, x0, k=k, tol=tol, constraints=cons,
                      loop="while")

    solve()  # the first solve builds (and on the card captures) the core
    t_solve = _med(solve, mesh.device, reps=reps, warmup=0)
    _, info = solve()
    result = {
        "problem": problem,
        "M": M,
        "n": int(n),
        "nnz": int(nnz),
        "hosts": int(nd),
        "devices": int(nd),
        "spmv_time_s": t_spmv,
        "spmv_nnz_per_s": nnz / t_spmv,
        "collective_latency_s": t_coll,
        "solve_time_s": t_solve,
        "steps": info["steps"],
        "deviation": info["deviation"],
        "safety": info["safety"],
    }
    if is_coordinator():
        print(_DIST_TAG + json.dumps(result), flush=True)
    return result


def _dist_job(nproc: int, argv, device: str) -> dict:
    """Spawn a job of ``nproc`` processes of the CLI, print its
    coordinator's ``DIST_RESULT`` line and return it; raises with the
    processes' output where a process fails or none prints it."""
    from ..parallel import spawn_local

    outs = spawn_local(nproc, argv, device=device)
    res = None
    for rc, out in outs:
        for line in out.splitlines():
            if line.startswith(_DIST_TAG):
                print(line, flush=True)
                res = json.loads(line[len(_DIST_TAG):])
    if res is None or any(rc != 0 for rc, _ in outs):
        logs = "\n".join(f"(exit {rc}) {o[-2000:]}" for rc, o in outs)
        raise RuntimeError(
            f"distributed job with {nproc} processes failed:\n{logs}")
    return res


def dist_efficiency(problem: str = "swe", M: int = 32, k: int = 20,
                    tol: float = 1e-6, process_counts=(1, 2),
                    device: str = "cuda", to_markdown: bool = True):
    """Strong-scaling efficiency across process counts: one spawned job per
    count (``dist-bench``; one card a process, or gloo ranks with
    ``device="cpu"``), efficiency = t₁·d₁ / (t_N·d_N) for the solve and
    the SpMV; prints the table with ``to_markdown``."""
    argv = ["dist-bench", "--problem", problem, "--M", str(M), "--k", str(k),
            "--tol", str(tol), "--device", device]
    rows = [_dist_job(np_, argv, device) for np_ in process_counts]
    base = rows[0]
    for r in rows:
        scale = r["devices"] / base["devices"]
        r["solve_efficiency"] = base["solve_time_s"] / (r["solve_time_s"] * scale)
        r["spmv_efficiency"] = base["spmv_time_s"] / (r["spmv_time_s"] * scale)
    if to_markdown:
        print(report(rows, ["hosts", "devices", "spmv_time_s", "spmv_nnz_per_s",
                            "collective_latency_s", "solve_time_s", "steps",
                            "deviation", "safety", "spmv_efficiency",
                            "solve_efficiency"]), flush=True)
    return rows
