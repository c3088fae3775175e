"""The device-resident CGMRES core of the PyTorch port and ``fused_evolve``
against the JAX package, on the CPU in f64, where the core runs its steps
eagerly (on the card each is a CUDA graph, ``tests/test_torch_cuda.py`` and
``chip_smoke.py``).

* ``fused_evolve`` against the JAX ``fused_evolve`` from the same exported
  system, at the configurations of ``tests/test_experiments.py``: steps per
  step within one, every latch certified, the JAX tests' drift bars, and
  the last solution within 1e-8, or, at lkdv, where most steps run to k,
  10× the JAX package's own drift under a 1e-15 change of the start.  At
  swe M=16 with the default warm start every Krylov vector has zero mass
  (r0 = S z0, and the scheme conserves mass), so the mass constraint's
  row of the KKT Jacobian is zero to roundoff and the JAX package's KKT
  matrix singular: its Newton stalls and its ``fused_evolve`` takes 8 to
  10 steps a step, a number that a 1e-15 change of the start moves.  The
  port's device core pins that constraint (``solvers/kkt.py::kkt_start``)
  and certifies at the step where the JAX ``gmres`` from the same warm
  start reaches tol (6), so its steps are held to those, and to at most
  the JAX ``fused_evolve``'s; the latches, the drift bars and the last
  solution to the JAX ``fused_evolve``.
* The device core, ``cgmres(loop="while")``, against the host loop and the
  JAX ``cgmres`` on lkdv degree 3, M=100 (``LKDV_HARD``).
* Steps taken after ``done`` change nothing; a step reads nothing on the
  host (it runs on ``meta`` tensors); ``utils/profiling.py``'s counters
  give the JAX package's numbers.
"""

import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch.constraints.quadratic import (
    QuadraticConstraint,
)
from structurepreservingiterativesolvers_torch.solvers.graphs import GraphRunner
from structurepreservingiterativesolvers_torch.utils import profiling as tprof
from structurepreservingiterativesolvers_tpu.experiments import (
    wrappers as jwrappers,
)
from structurepreservingiterativesolvers_tpu.experiments.evolve import (
    evolve as jax_evolve,
    fused_evolve as jax_fused_evolve,
)
from structurepreservingiterativesolvers_tpu.models import lkdv as jlkdv
from structurepreservingiterativesolvers_tpu.models import swe as jswe
from structurepreservingiterativesolvers_tpu.solvers import cgmres as jax_cgmres
from structurepreservingiterativesolvers_tpu.utils import profiling as jprof

# the modules (their packages export functions of the same names)
tevolve = importlib.import_module(
    "structurepreservingiterativesolvers_torch.experiments.evolve")
tcgmres = importlib.import_module(
    "structurepreservingiterativesolvers_torch.solvers.cgmres")

LKDV = dict(N=10, M=50, degree=2, k=30, tol=1e-6)
SWE = dict(N=5, M=16, k=20, tol=1e-7, T=1.0)


def _port_fused(monkeypatch, jax_system, problem, **kw):
    """The port's ``fused_evolve`` on the port's twin of ``jax_system``."""
    port = torch_parity.to_port(jax_system)
    monkeypatch.setattr(tevolve, "get_model", lambda name: types.SimpleNamespace(
        linforms=lambda **_: port))
    return tevolve.fused_evolve(problem, device="cpu", **kw)


def _check_drift(out, e_scale=None):
    """The bars of tests/test_experiments.py: mass (and, lkdv, energy)
    drift at every step, swe's energy relative to its O(3e4) size."""
    assert np.all(out["dm"] < (1e-9 if e_scale else 1e-10))
    if e_scale:
        assert np.all(out["de"] / e_scale < 1e-13)
    else:
        assert np.all(out["de"] < 1e-8)


def _check_against(out, ref, sol_rtol=1e-8, steps=None):
    """Steps within one of ``steps`` (the reference's when None), every
    latch certified in both, the times, and the last solution."""
    steps = ref["steps"] if steps is None else steps
    assert np.all(np.abs(np.asarray(out["steps"]) - np.asarray(steps)) <= 1)
    assert np.all(out["safety"] == 1) and np.all(np.asarray(ref["safety"]) == 1)
    np.testing.assert_allclose(out["time"], ref["time"], rtol=1e-12)
    torch_parity.close(out["sol"].numpy(), np.asarray(ref["sol"]), sol_rtol)


def test_fused_evolve_lkdv_matches_jax(monkeypatch):
    """Most steps run to k=30 and stop above tol, so the last solution is
    held to max(1e-8, 10× the JAX package's own drift under a 1e-15 change
    of the initial state), as ``test_torch_cgmres.py`` holds lkdv's
    iterates: that drift is about 2e-3 here."""
    js = jlkdv.linforms(M=LKDV["M"], N=LKDV["N"], degree=LKDV["degree"])
    ref = jax_fused_evolve("lkdv", **LKDV)
    z = torch_parity.perturbed(js.z0)
    own = torch_parity.rel_max(jax_fused_evolve("lkdv", zinit=z, **LKDV)["sol"],
                               ref["sol"])
    out = _port_fused(monkeypatch, js, "lkdv", **LKDV)
    _check_against(out, ref, sol_rtol=max(1e-8, 10.0 * own))
    _check_drift(out)
    assert set(out) >= {"time", "steps", "safety", "sol", "dm", "dmo", "de",
                        "mass", "momentum", "energy"}


def test_fused_evolve_swe_cold_start_matches_jax(monkeypatch):
    js = jswe.linforms(M=SWE["M"], N=SWE["N"], T=SWE["T"])
    ref = jax_fused_evolve("swe", warm_start=False, **SWE)
    out = _port_fused(monkeypatch, js, "swe", warm_start=False, **SWE)
    _check_against(out, ref)
    _check_drift(out, e_scale=3e4)


def test_fused_evolve_swe_warm_start(monkeypatch):
    """The default warm start against the JAX ``fused_evolve``; the steps
    against the JAX ``gmres`` from the same start, and at most the JAX
    ``fused_evolve``'s (see the module's docstring)."""
    js = jswe.linforms(M=SWE["M"], N=SWE["N"], T=SWE["T"])
    ref = jax_fused_evolve("swe", **SWE)
    gm = jax_evolve("swe", solver=jwrappers.gmres_wrapper, warm_start=True,
                    **SWE)
    out = _port_fused(monkeypatch, js, "swe", **SWE)
    _check_against(out, ref, steps=gm["steps"])
    assert np.all(np.asarray(out["steps"]) <= np.asarray(ref["steps"]))
    _check_drift(out, e_scale=3e4)


def test_device_core_matches_host_loop_and_jax():
    js = jlkdv.linforms(**torch_parity.LKDV_HARD)
    s = torch_parity.to_port(js)
    kw = dict(k=50, tol=1e-6)
    xj, ij = jax_cgmres(js.A, js.b, constraints=js.constraints(), **kw)
    xh, ih = tcgmres.cgmres(s.A, s.b, constraints=s.constraints(), **kw)
    xd, idv = tcgmres.cgmres(s.A, s.b, constraints=s.constraints(),
                             loop="while", timing=True, **kw)
    for ref in (ih, ij):
        for key in ("steps", "constrained_steps", "safety"):
            assert idv[key] == ref[key], key
    assert idv["deviation"] <= 1e-10
    torch_parity.close(xd.numpy(), xh.numpy(), 1e-10)
    # against the JAX package as tests/test_torch_cgmres.py holds the host
    # loop: within 10× its own drift under a 1e-15 change of b
    xp, _ = jax_cgmres(js.A, jnp.asarray(torch_parity.perturbed(js.b)),
                       constraints=js.constraints(), **kw)
    own = torch_parity.rel_max(xp, xj)
    torch_parity.close(xd.numpy(), np.asarray(xj), max(1e-8, 10.0 * own))
    np.testing.assert_allclose(idv["res"], ih["res"], rtol=1e-6)
    assert idv["timings"]["time_capture"] == 0.0  # nothing captured on the CPU
    # a second solve, with new constraint objects, reuses the cached core
    # and gives the same bits
    cores = len(tcgmres._CORES)
    x2, i2 = tcgmres.cgmres(s.A, s.b.clone(), constraints=s.constraints(),
                            loop="while", **kw)
    assert len(tcgmres._CORES) == cores and torch.equal(x2, xd)
    # with history the core keeps r0 (= b from x0 = 0) and each iterate
    xs = tcgmres.cgmres(s.A, s.b, constraints=s.constraints(), loop="while",
                        history=True, **kw)[1]["x"]
    assert xs.shape == (idv["steps"] + 1, s.b.shape[0])
    assert torch.equal(xs[0], s.b) and torch.equal(xs[-1], xd)
    with pytest.raises(ValueError):
        tcgmres.cgmres(s.A, s.b, loop="fori", **kw)


def test_steps_after_done_change_nothing():
    """Every write of a step is masked by ``~done``: replaying the remaining
    steps, and an endgame, after the solve ended leaves every result bit for
    bit."""
    s = torch_parity.to_port(jswe.linforms(M=16))
    k = 30
    core = tcgmres.DeviceCore(s.A, None, k, s.constraints(), like=s.b,
                              tol=1e-9, x0_zero=True)
    core.load(s.b, None, s.constraints())
    core.solve()
    before = core.result()
    steps = int(before.steps)
    assert steps < k and bool(core.done) and int(before.constrained_steps) > 0
    for j in range(steps, k):
        core._arnoldi(j)
        core._advance(j)
        core._kkt_start(j)
        core._kkt_step(j)
        core._kkt_refactor(j)
        core._kkt_finish(j)
    after = core.result()
    for a, b in zip(before, after):
        assert torch.equal(a, b)


def test_core_step_reads_nothing_on_the_host():
    """Every step of the core runs on ``meta`` tensors, which hold no
    values: a host read (``float``, ``.item()``, ``if`` on a tensor) there
    raises.  (The kernel wrappers refuse ``meta`` tensors, so A is dense
    and the orthogonalisation plain.)"""
    n, k = 40, 6
    meta = dict(dtype=torch.float64, device="meta")
    A = torch.empty((n, n), **meta)
    b = torch.empty(n, **meta)
    cons = [QuadraticConstraint(M=None, v=torch.empty(n, **meta),
                                c=torch.empty((), **meta)),
            QuadraticConstraint(M=A, v=None, c=torch.empty((), **meta))]
    core = tcgmres.DeviceCore(A, None, k, cons, like=b, tol=1e-8,
                              x0_zero=True,
                              runner=GraphRunner("meta", capture=False))
    core.load(b, None, cons)
    core._init()
    for j in (0, 3):
        core._arnoldi(j)
        core._advance(j)
        core._catchup(j)
        core._kkt_start(j)
        core._kkt_step(j)
        core._kkt_refactor(j)
        core._kkt_finish(j)
        core._finish0(j)
    assert core.x.device.type == "meta" and core.flags.shape == (2,)


def test_profiling_counters_match_jax():
    info = {"steps": 37}
    for nnz, seconds in ((786_432 * 21, 0.0123), (1_050_625 * 7, 2.5)):
        assert tprof.spmv_throughput(nnz, seconds) == jprof.spmv_throughput(
            nnz, seconds)
        assert tprof.solve_throughput(info, nnz, seconds) == \
            jprof.solve_throughput(info, nnz, seconds)
    assert tprof.spmv_throughput(5, 0.0) == jprof.spmv_throughput(5, 0.0)
    assert tprof.solve_throughput({}, 5, 1.0) == jprof.solve_throughput({}, 5, 1.0)
    watch = tprof.Stopwatch()
    assert watch.mark("a") >= 0.0 and set(watch.marks) == {"a"}


def test_fused_evolve_refusals():
    # heat and lkdvRK run (tests/test_torch_heat_graph.py,
    # tests/test_torch_lkdvrk_graph.py), and every model sharded (mesh=,
    # tests/test_torch_parallel.py, tests/test_torch_distributed.py): the
    # TPU's loop="fori" is the one refusal left
    with pytest.raises(NotImplementedError):
        tevolve.fused_evolve("swe", N=1, M=8, device="cpu", loop="fori")
