"""Evolve experiment: time stepping with invariant-drift tracking.

The port of the JAX package's ``experiments/evolve.py`` (reference
lkdv/Evolve.py:18-114, swe/Evolve.py:18-99, and heat, which the reference
has no Evolve for).  Unlike the reference, which reassembles the whole
system every step, the loop re-seeds b and the invariant targets on the
system's device (``System.step_update``) and reuses the operators.

lkdvRK (reference lkdvRK/Evolve.py:19-146) warm-starts each stage solve
from the previous one and can record the L2 error against the exact wave
per step (``compute_error``).

``fused_evolve`` is the JAX package's whole evolution as one program (a
jitted ``lax.scan`` over its CGMRES core there): here the device core
(``solvers/cgmres.py::DeviceCore``) with a prologue and an epilogue step,
captured as CUDA graphs once and replayed every time step on the card.  On
lkdvRK it chains the stepped systems as ``evolve`` does, where the JAX
``fused_evolve`` steps every system from the first one's state (ROADMAP.md,
Queue 3).

``deviation_plotter`` runs GMRES and CGMRES evolutions and draws their
drifts (``report.deviation_plot``, matplotlib imported only there).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..config import CTOL
from ..utils.profiling import span
from . import wrappers
from .single_solve import get_model

# each invariant's target attribute on the system, and its drift key in the
# result
TARGETS = {"mass": "m0", "momentum": "mo0", "energy": "e0"}
DRIFT_KEYS = {"mass": "dm", "momentum": "dmo", "energy": "de"}


def evolve(
    problem: str = "lkdv",
    N: int = 100,
    M: int = 50,
    degree: int = 1,
    k: int = 50,
    tol: float = 1e-6,
    contol: float = 10.0,
    solver=wrappers.cgmres_wrapper,
    pre=None,
    warm_start: Optional[bool] = None,
    compute_error: bool = False,
    checkpoint: Optional[str] = None,
    checkpoint_every: int = 50,
    *,
    device,
    **params,
):
    """Run N time steps on ``device``; returns the time points, the solver's
    steps per step, the final solution, and per invariant its series and its
    drift from the initial value (``dm``, ``dmo``, ``de``).

    ``solver(system, x0=, k=, tol=, pre=)`` solves each step, by default
    CGMRES through its wrapper; ``functools.partial`` passes it options such
    as ``ortho``.  ``params`` go to the model's ``linforms`` (``T`` and,
    for lkdvRK, ``tstages`` among them).  As in the JAX package, each step
    starts from zero unless ``warm_start``, which is on for lkdvRK only when
    not given (the reference zeroes x0 for lkdv and swe, lkdv/Evolve.py:43-45,
    and warm-starts lkdvRK from the previous stage vector, lkdvRK/Evolve.py:37,
    61; its first step from z0 tiled over the stages); ``contol`` is
    accepted and unused.  Where the solver reports them, ``safety`` and
    ``constrained_steps`` per step are returned too, and with
    ``compute_error`` the L2 error of each step (``err``, lkdvRK only).

    ``checkpoint``: an ``.npz`` path; the state is saved every
    ``checkpoint_every`` steps and at the last, and the run resumes from the
    file if it exists."""
    model = get_model(problem)
    system = model.linforms(N=N, M=M, degree=degree, device=device, **params)
    is_rk = problem.lower() == "lkdvrk"
    if warm_start is None:
        warm_start = is_rk
    x = system.z0.repeat(system.prob.ns) if is_rk else system.z0
    names = [nm for nm, attr in TARGETS.items() if hasattr(system, attr)]
    targets0 = torch.stack([getattr(system, TARGETS[nm])
                            for nm in names]).cpu().tolist()
    series = {nm: [v] for nm, v in zip(names, targets0)}
    time_pts = [0.0]
    steps_hist, safety_hist, constrained_hist = [], [], []
    compute_error = compute_error and hasattr(system, "compute_error")
    errs = [0.0]

    start_step = 1
    if checkpoint:
        from ..utils.checkpoint import load_state, save_state

        resume = load_state(checkpoint)
        if resume is not None:
            start_step, z_saved, saved_series = resume
            x = torch.as_tensor(z_saved, dtype=system.b.dtype,
                                device=system.b.device)
            for nm in names:
                if nm in saved_series:
                    series[nm] = list(saved_series[nm])
            time_pts = list(saved_series.get("time", [0.0]))
            errs = list(saved_series.get("err", errs))
            if start_step > 1:
                system = system.step_update(x)
            start_step += 1

    dt_step = float(system.prob.T) / N
    for i in range(start_step, N + 1):
        x0 = x if warm_start else torch.zeros_like(system.b)
        x, info = solver(system, x0=x0, k=k, tol=tol, pre=pre)
        steps_hist.append(info.get("steps", -1) if isinstance(info, dict) else -1)
        if isinstance(info, dict) and "safety" in info:
            safety_hist.append(info["safety"])
            constrained_hist.append(info["constrained_steps"])
        # one host read of the invariants per step
        inv = system.compute_invariants(x)
        values = torch.stack([inv[nm] for nm in names]).cpu().tolist()
        for nm, v in zip(names, values):
            series[nm].append(v)
        time_pts.append(dt_step * i)
        if compute_error:
            errs.append(system.compute_error(x, t=dt_step * i))
        if checkpoint and (i % checkpoint_every == 0 or i == N):
            payload = {**series, "time": time_pts}
            if compute_error:
                payload["err"] = errs
            save_state(checkpoint, i, x, payload)
        if i < N:
            system = system.step_update(x)

    out = {"time": np.asarray(time_pts), "steps": steps_hist, "sol": x}
    if safety_hist:
        out["safety"] = safety_hist
        out["constrained_steps"] = constrained_hist
    for nm in names:
        arr = np.asarray(series[nm])
        out[DRIFT_KEYS[nm]] = np.abs(arr - arr[0])
        out[nm] = arr
    if compute_error:
        out["err"] = np.asarray(errs)
    return out


def fused_evolve(
    problem: str = "lkdv",
    N: int = 100,
    M: int = 50,
    degree: int = 1,
    k: int = 30,
    tol: float = 1e-6,
    contol: float = 10.0,
    ctol: float = CTOL,
    pre=None,
    warm_start: bool = True,
    mesh=None,
    loop: str = "while",
    *,
    device,
    ortho: str = "cgs2",
    **params,
):
    """The whole time evolution on ``device`` as replays of one device core
    (the JAX package's ``fused_evolve``, ``evolve.py:140-254`` there): each
    step re-seeds the system on the device (``System.step_update`` of the
    previous solution), solves it with CGMRES from the previous solution
    (``warm_start``) or from zero, and records the solver's steps, its
    latch and the invariants of the solution in device buffers; the host
    fetches them once, at the end.

    The step's prologue (``step_update`` and the copy of b, x0 and the
    targets into the core's static buffers) and epilogue (the invariants
    and the records) are steps of the core's graph runner: on the card each
    is captured once, as the core's steps are, and replayed every step.

    Returns, as the JAX package does, ``time`` (the N step times), ``steps``
    and ``safety`` (0 untouched, 1 certified, 2 tripped) per step, ``sol``
    (the last solution, on ``device``), and per invariant its series and
    its drift from the initial value (``dm``, ``dmo``, ``de``), each step's
    invariants taken against its previous solution where the model's read
    one (heat); the port adds ``fallbacks`` per step (the endgame's
    iterations whose KKT solve failed and fell back to the unconstrained
    coefficients); and
    ``timings``: each step's wall (``step_wall``, from one step's start to
    the next's, the last to the fetch) and the seconds of it spent
    capturing (``step_capture``, in all ``time_capture``), and the kernel
    launches per replay of each kind of graph (``launches_per_replay``) and
    of all replays (``launches``).  The steps and the fetch run
    inside the span ``fused_evolve steps``.  ``ortho``
    is the Arnoldi orthogonalisation (``arnoldi_step``); the JAX package
    runs ``cgs2`` there.  With f32 storage (``dtype=torch.float32``
    through ``params``) the core runs the JAX package's f32 mode: mixed,
    the projection of each step's solution as one more graph of the core's
    solve, the reduction in f64.  lkdv, swe, heat and lkdvRK run; no model's
    operator changes with ``step_update``, so a preconditioner built on the
    first system (``pre``: the AMG, a polynomial, Jacobi, lkdvRK's RAS +
    Neumann composite) serves every step, as in the JAX package.

    On lkdvRK the solve's unknown is the stage vector (ns·3·n0), which
    starts from zeros, as in the JAX package, and is each step's warm
    start; ``sol`` is the last one.  The step's state (3·n0, the stepped
    system's z0) is carried too, in a static buffer: each step's system is
    the previous step's stepped by its solution, as ``evolve`` chains them,
    and its invariants are taken on that system.  (The JAX ``fused_evolve``
    steps ``sys0`` by each stage vector, so from the third step on it
    restarts from the initial state plus the last step's increment.)

    ``mesh`` (``parallel/``): the evolution runs row-sharded over it, as
    the JAX package's (``evolve.py:177-189`` there), with ``pre``, built on
    the whole first system, through ``shard_preconditioner``, and ``sol``
    the whole last solution.  On a row-local system (swe, heat) every DIA,
    ELL and Stencil field of the system goes through ``shard_matrix``,
    every 1-D tensor longer than 16 through ``shard_vector`` and swe's
    energy matrix by its rows, and the invariants and targets are
    all-reduced sums.  A system
    whose ``step_update`` and invariants are not row-local (its class's
    ``row_local``: lkdv's and lkdvRK's split the state into its fields u,
    v, w, which a row split cuts) is held whole on every rank: the solve
    runs sharded (A, b, x and the constraints by their rows), the prologue
    and the epilogue on the gathered solution.
    ``loop="fori"`` is not ported."""
    if loop != "while":
        raise NotImplementedError(
            f"loop={loop!r}: only 'while' is ported ('fori' is a TPU "
            "workaround, not ported on purpose)")
    from ..parallel import gather, shard_constraint, shard_matrix, shard_vector
    from ..solvers.cgmres import DeviceCore, resolve_modes

    sys0 = get_model(problem).linforms(N=N, M=M, degree=degree, device=device,
                                       **params)
    # the mesh of a sharded solve on a system every rank holds whole
    whole = None
    if mesh is not None and not type(sys0).row_local:
        whole = mesh
    elif mesh is not None:
        sys0 = _shard_fields(sys0, mesh)
    if mesh is not None:
        from ..parallel import shard_preconditioner

        pre = shard_preconditioner(pre, mesh)

    def local(v):
        return v if whole is None else shard_vector(v, whole)

    def full(v):
        return v if whole is None else gather(v, whole)

    def constraints(s):
        cons = s.constraints()
        return cons if whole is None else [shard_constraint(c, whole)
                                           for c in cons]

    A = sys0.A if whole is None else shard_matrix(sys0.A, whole)
    # f32 storage: mixed, with the projection inside the core's solve, the
    # in-loop reduction in f64 (x0 is a tensor every step, as the JAX
    # package's scan passes it: evolve.py:192-206 there)
    cons0 = constraints(sys0)
    mixed, snap, f32_reduce = resolve_modes(sys0.b.dtype, cons0)
    core = DeviceCore(A, pre, k, cons0, like=local(sys0.b),
                      tol=tol, contol=contol, ctol=ctol, ortho=ortho,
                      mixed=mixed, snap=snap, f32_reduce=f32_reduce)
    runner = core.runner
    names = [nm for nm, attr in TARGETS.items() if hasattr(sys0, attr)]
    is_rk = problem.lower() == "lkdvrk"
    # the solution: lkdvRK's stage vector from zeros, every other model's
    # state from the initial one; lkdvRK's state, the stepped system's z0
    z = torch.zeros_like(local(sys0.b)) if is_rk else local(sys0.z0).clone()
    state = sys0.z0.clone()
    row = torch.zeros(1, dtype=torch.long, device=z.device)
    inv = torch.zeros((N, len(names)), dtype=z.dtype, device=z.device)
    counts = torch.zeros((N, 3), dtype=torch.long, device=z.device)

    def stepped():
        """The step's system before its solve: on lkdvRK the one at the
        carried state (which ``prologue`` has advanced), else ``sys0``,
        whose ``step_update`` replaces the whole state."""
        return dataclasses.replace(sys0, z0=state) if is_rk else sys0

    def prologue():
        s = stepped().step_update(full(z))
        if is_rk:
            state.copy_(s.z0)
        core.load(local(s.b), z if warm_start else torch.zeros_like(z),
                  constraints(s))

    def epilogue():
        # the core's buffers of its one solve (its batch axis is 1); z still
        # holds the step's previous solution, which heat's dissipation
        # identity reads (the JAX step evaluates it on the stepped system)
        x = core.x[0]
        values = stepped().compute_invariants(full(x), zold=full(z))
        inv.index_copy_(0, row, torch.stack([values[nm] for nm in names])[None])
        counts.index_copy_(0, row, torch.stack(
            [core.steps[0], core.safety[0], core.nfb[0]])[None])
        z.copy_(x)
        row.add_(1)

    runner.warmup(lambda: (sys0.step_update(full(z)),
                           sys0.compute_invariants(full(z), zold=full(z))))
    starts, captured = [], []
    with span("fused_evolve steps", z.device):
        for _ in range(N):
            starts.append(time.perf_counter())
            captured.append(runner.time_capture)
            runner.run("prologue", prologue)
            core.solve()
            runner.run("epilogue", epilogue)
        # one fetch at the end
        series, counts = inv.cpu().numpy(), counts.cpu().numpy()
    starts.append(time.perf_counter())
    captured.append(runner.time_capture)
    targets = torch.stack([getattr(sys0, TARGETS[nm]) for nm in names]).tolist()
    if mesh is not None:
        z = gather(z, mesh)
    out = {"time": np.linspace(0.0, float(sys0.prob.T), N + 1)[1:],
           "steps": counts[:, 0], "safety": counts[:, 1],
           "fallbacks": counts[:, 2], "sol": z,
           "timings": {
               "step_wall": np.diff(starts), "time_capture": runner.time_capture,
               "step_capture": np.diff(captured),
               "launches_per_replay": runner.launches(),
               "launches": runner.replayed_launches()}}
    for i, (nm, target) in enumerate(zip(names, targets)):
        out[DRIFT_KEYS[nm]] = np.abs(series[:, i] - target)
        out[nm] = series[:, i]
    return out


def _shard_fields(sys0, mesh):
    """The first system of a sharded row-local evolution (swe, heat): the
    operators (DIA, ELL, Stencil, and swe's diagonal energy matrix) by their
    rows, the vectors longer than 16 by their rows, the scalars whole."""
    from ..ops.sparse import DIA, ELL
    from ..ops.stencil import Stencil
    from ..parallel.mesh import _shard_operator, shard_matrix, shard_vector

    updates = {}
    for f in dataclasses.fields(sys0):
        val = getattr(sys0, f.name)
        if isinstance(val, (DIA, ELL, Stencil)):
            updates[f.name] = shard_matrix(val, mesh)
        elif isinstance(val, torch.Tensor) and val.dim() == 1 and val.numel() > 16:
            updates[f.name] = shard_vector(val, mesh)
        elif dataclasses.is_dataclass(val) and hasattr(val, "__matmul__"):
            updates[f.name] = _shard_operator(val, mesh)
    return dataclasses.replace(sys0, **updates)


def deviation_plotter(problem: str = "lkdv", tol: float = 1e-6,
                      filename: Optional[str] = None, *, device, **kwargs):
    """GMRES against CGMRES invariant drift (reference DeviationPlotter):
    both evolutions and their figure (``report.deviation_plot``, which
    needs matplotlib; ``filename``, else ``plots/evolve.pdf``),
    ``{"GMRES": ..., "CGMRES": ..., "figure": path}``."""
    from . import report

    standard = evolve(problem, tol=tol, solver=wrappers.gmres_wrapper,
                      device=device, **kwargs)
    conserved = evolve(problem, tol=tol, solver=wrappers.cgmres_wrapper,
                       device=device, **kwargs)
    path = report.deviation_plot(
        {"GMRES": standard, "CGMRES": conserved}, filename=filename)
    return {"GMRES": standard, "CGMRES": conserved, "figure": path}
