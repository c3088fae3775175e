"""CG on the port's device core (``cg(loop="while")``, ``solvers/cg.py::
CgCore``; eager here, no capture) against the JAX package's ``cg`` (one
``lax.while_loop``) run live on the CPU, and against the port's host loop;
and ``cgmres_p(mixed=)``, which the JAX package's prototypical solver takes.

heat M=32 (n = 1,089), f64 unless stated, with Jacobi (as
``tests/test_experiments.py::test_cg_on_heat``) and with the structured
AMG of each package's TimedSolve pre-builder.  Bars: against the JAX
``cg`` equal steps, x within 1e-10 of its max-norm, the residual trace
within 1e-6 relative; the port's two loops equal steps and x within 1e-12;
in f32 steps within 1 and x within 1e-4 of the max-norm.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch import precond as tprecond
from structurepreservingiterativesolvers_torch.models import heat as theat
from structurepreservingiterativesolvers_torch.models import lkdv as tlkdv
from structurepreservingiterativesolvers_torch.solvers import cg, cgmres_p
from structurepreservingiterativesolvers_torch.solvers.cgmres import (
    clear_core_cache,
)
from structurepreservingiterativesolvers_tpu import precond as jprecond
from structurepreservingiterativesolvers_tpu.models import heat as jheat
from structurepreservingiterativesolvers_tpu.models import lkdv as jlkdv
from structurepreservingiterativesolvers_tpu.solvers import cg as jcg
from structurepreservingiterativesolvers_tpu.solvers import (
    cgmres_p as jcgmres_p,
)

# the modules (each experiments package exports a function of this name)
tts = importlib.import_module(
    "structurepreservingiterativesolvers_torch.experiments.timed_solve")
jts = importlib.import_module(
    "structurepreservingiterativesolvers_tpu.experiments.timed_solve")
# the solvers package exports the function ``cg`` under the module's name
tcg = importlib.import_module(
    "structurepreservingiterativesolvers_torch.solvers.cg")

M, K, TOL = 32, 200, 1e-10


@pytest.fixture(scope="module")
def heat32():
    js = jheat.linforms(M=M)
    return js, torch_parity.to_port(js)


def _pres(kind, js, ts):
    if kind == "jacobi":
        return jprecond.jacobi(js.A), tprecond.jacobi(ts.A)
    return (jts.default_pre_builder("heat")(js),
            tts.default_pre_builder("heat")(ts))


@pytest.mark.parametrize("kind", ["jacobi", "amg"])
def test_device_core_matches_jax_cg(heat32, kind):
    """``cg(loop="while")`` against the JAX ``cg`` on the same system and
    preconditioner: equal steps, x within 1e-10, the residual trace
    within 1e-6 relative (its last entry, the recomputed true residual,
    within roundoff)."""
    js, ts = heat32
    pj, pt = _pres(kind, js, ts)
    xj, ij = jcg(js.A, js.b, k=K, tol=TOL, pre=pj)
    x, info = cg(ts.A, ts.b, k=K, tol=TOL, pre=pt, loop="while")
    assert info["name"] == "cg"
    assert info["steps"] == ij["steps"] < K
    torch_parity.close(x.numpy(), np.asarray(xj), 1e-10)
    res, ref = info["res"], np.asarray(ij["res"])
    np.testing.assert_allclose(res[:-1], ref[:-1], rtol=1e-6)
    # the last entry is the true residual recomputed near 1e-11, where the
    # two frameworks' sums differ by roundoff: within 1e-14 of ||b||
    bnorm = float(torch.linalg.norm(ts.b))
    np.testing.assert_allclose(res[-1], ref[-1], rtol=1e-6,
                               atol=1e-14 * bnorm)
    assert res[-1] < TOL


def test_two_loops_agree(heat32):
    """The host loop and the device core take the same steps, with the
    same residual trace and x within 1e-12 of its max-norm, with Jacobi
    and with the AMG."""
    js, ts = heat32
    for kind in ("jacobi", "amg"):
        _, pt = _pres(kind, js, ts)
        xh, ih = cg(ts.A, ts.b, k=K, tol=TOL, pre=pt)
        xw, iw = cg(ts.A, ts.b, k=K, tol=TOL, pre=pt, loop="while")
        assert ih["steps"] == iw["steps"]
        np.testing.assert_allclose(iw["res"], ih["res"], rtol=1e-12)
        torch_parity.close(xw.numpy(), xh.numpy(), 1e-12)


def test_f32_against_jax_cg():
    """f32 storage, a plain f32 recurrence as the JAX ``cg`` runs it:
    heat M=32 with Jacobi at tol 1e-5·‖b‖, both loops of the port against
    the JAX ``cg`` on its f32 system: steps within 1, x within 1e-4 of its
    max-norm; the port's loops take equal steps."""
    js = jheat.linforms(M=M, dtype=jnp.float32)
    ts = theat.linforms(M=M, device="cpu", dtype=torch.float32)
    tol = 1e-5 * float(np.linalg.norm(np.asarray(js.b, np.float64)))
    xj, ij = jcg(js.A, js.b, k=K, tol=tol, pre=jprecond.jacobi(js.A))
    pt = tprecond.jacobi(ts.A)
    xh, ih = cg(ts.A, ts.b, k=K, tol=tol, pre=pt)
    xw, iw = cg(ts.A, ts.b, k=K, tol=tol, pre=pt, loop="while")
    assert xw.dtype == torch.float32 and ih["steps"] == iw["steps"] < K
    for x, info in ((xh, ih), (xw, iw)):
        assert abs(info["steps"] - int(ij["steps"])) <= 1
        torch_parity.close(x.numpy(), np.asarray(xj), 1e-4)
        assert info["res"][-1] < 2 * tol


def test_x0_and_k_reached(heat32):
    """A given x0 (the direct solve's x plus noise): both loops take equal
    steps from it, fewer than from zero; and k reached (k=5 with Jacobi):
    five steps on both loops, no more, the last entry the true residual."""
    _, ts = heat32
    pt = tprecond.jacobi(ts.A)
    x_ref, i_ref = cg(ts.A, ts.b, k=K, tol=TOL, pre=pt)
    noise = torch.as_tensor(np.random.default_rng(0).standard_normal(
        ts.b.shape[0]))
    x0 = x_ref + 1e-6 * x_ref.abs().max() * noise
    xh, ih = cg(ts.A, ts.b, x0=x0, k=K, tol=TOL, pre=pt)
    xw, iw = cg(ts.A, ts.b, x0=x0, k=K, tol=TOL, pre=pt, loop="while")
    assert ih["steps"] == iw["steps"] < i_ref["steps"]
    torch_parity.close(xw.numpy(), xh.numpy(), 1e-12)
    for loop in ("host", "while"):
        x, info = cg(ts.A, ts.b, k=5, tol=TOL, pre=pt, loop=loop)
        assert info["steps"] == 5 and info["res"].shape == (5,)
        true = float(torch.linalg.norm(ts.A @ x - ts.b))
        assert info["res"][-1] == pytest.approx(true, rel=1e-12)


def test_converged_b_and_bad_loop(heat32):
    """b that x0 already solves (b = A x0): no step on either loop, a trace
    of one entry, the true residual, and x0 returned; ``loop="fori"``
    raises ``ValueError`` (the JAX package's fori loop is not ported)."""
    _, ts = heat32
    x0 = torch.as_tensor(np.random.default_rng(1).standard_normal(
        ts.b.shape[0]))
    b = ts.A @ x0
    for loop in ("host", "while"):
        x, info = cg(ts.A, b, x0=x0, k=K, tol=1e-8, pre=None, loop=loop)
        assert info["steps"] == 0 and info["res"].shape == (1,)
        assert info["res"][0] < 1e-8
        assert torch.equal(x, x0)
    with pytest.raises(ValueError, match="fori"):
        cg(ts.A, ts.b, k=K, tol=TOL, loop="fori")


def test_core_cached_across_right_hand_sides(heat32):
    """One core serves two right-hand sides and two tolerances of the same
    A, preconditioner and k: the second solve reuses the first's core (its
    buffers and, on the card, its graphs), and each solve equals the host
    loop's."""
    _, ts = heat32
    pt = tprecond.jacobi(ts.A)
    clear_core_cache()
    assert not tcg._CORES
    cg(ts.A, ts.b, k=K, tol=TOL, pre=pt, loop="while")
    core = tcg.last_core()
    b2 = ts.b + 0.5 * (ts.A @ torch.ones_like(ts.b))
    for b, tol in ((b2, 1e-8), (ts.b, TOL)):
        xw, iw = cg(ts.A, b, k=K, tol=tol, pre=pt, loop="while")
        xh, ih = cg(ts.A, b, k=K, tol=tol, pre=pt)
        assert tcg.last_core() is core and len(tcg._CORES) == 1
        assert iw["steps"] == ih["steps"]
        torch_parity.close(xw.numpy(), xh.numpy(), 1e-12)
    clear_core_cache()
    assert not tcg._CORES


def test_cgmres_p_mixed_false_f32():
    """``cgmres_p(mixed=False)`` over f32 storage keeps the k-sized
    constraint and KKT state in f32, as the JAX ``cgmres_p(mixed=False)``:
    lkdv M=20 (degree 1), k=20, both packages take 20 steps to x within
    1e-4 of its max-norm, the final residual within 1e-3 relative, and an
    f32 KKT's deviation (above 1e-8, where the default mixed solve
    certifies at 1e-12 or below)."""
    ts = tlkdv.linforms(M=20, degree=1, device="cpu", dtype=torch.float32)
    js = jlkdv.linforms(M=20, degree=1, dtype=jnp.float32)
    x, info = cgmres_p(ts.A, ts.b, k=20, constraints=ts.constraints(),
                       mixed=False)
    xj, ij = jcgmres_p(js.A, js.b, k=20, constraints=js.constraints(),
                       mixed=False)
    assert info["steps"] == int(ij["steps"]) == 20
    torch_parity.close(x.numpy(), np.asarray(xj), 1e-4)
    np.testing.assert_allclose(info["res"][-1], float(ij["res"][-1]),
                               rtol=1e-3)
    assert info["deviation"] > 1e-8 and float(ij["deviation"]) > 1e-8
    _, mixed = cgmres_p(ts.A, ts.b, k=20, constraints=ts.constraints())
    assert mixed["deviation"] <= 1e-12
