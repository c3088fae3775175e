"""``cgmres_many`` on heat, and the block forms of what its steps apply,
on the CPU in f64 against the JAX package:

* ``cgmres_many`` on heat M=32 (n = 1,089) at B = 3 with each of heat's
  preconditioners (the structured AMG, cheb8, neu4, Jacobi), item i the
  system's ``step_update(z0 + 0.02 i·p)`` with p a smooth field of the
  lowest 3 x 3 cosine modes (``scripts/make_torch_reference.py``,
  ``heat_smooth_field``): each item's steps and latch equal to the JAX
  ``cgmres_many``'s record (``reference/slice11.json``), its x's max-norm
  and sum within 1e-8 of the record's, and x within 1e-10 of the port's
  single ``cgmres(loop="while")`` of that item;
* the AMG's V-cycle on a block (n, B) against the single V-cycle column by
  column (within 1e-14: its coarse solve is one matrix product for the
  block; its transfers bit-equal) and against the JAX ``jax.vmap`` of its apply at heat
  M=16, on the JAX hierarchy, within 1e-13;
* the plain twins of the block forms #2b (the stencil product), #3b and #4b
  (the Chebyshev and Neumann applies) on a block at heat M=16: each column
  bit-equal to the single twin, and within 1e-13 of the JAX ``Stencil``
  product and polynomial applies under ``jax.vmap`` (f64: the JAX
  package's XLA recurrences).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch import interop
from structurepreservingiterativesolvers_torch import precond as tprecond
from structurepreservingiterativesolvers_torch.experiments.batched import (
    cgmres_many,
)
from structurepreservingiterativesolvers_torch.kernels import poly_apply as tpa
from structurepreservingiterativesolvers_torch.kernels import stencil_spmv as tks
from structurepreservingiterativesolvers_torch.models import heat as theat
from structurepreservingiterativesolvers_tpu import precond as jprecond
from structurepreservingiterativesolvers_tpu.models import heat as jheat

# the module (the experiments package exports a function of the same name,
# as the JAX package's does)
tts = importlib.import_module(
    "structurepreservingiterativesolvers_torch.experiments.timed_solve")

# the module (the solvers package exports a function of the same name)
tcgmres = importlib.import_module(
    "structurepreservingiterativesolvers_torch.solvers.cgmres")

REF = torch_parity.reference_script()
RTOL = 1e-13


def _port_pre(pre_spec, s, rec):
    """The port's preconditioner of a record's spec, on the port system s:
    the Chebyshev polynomial on the record's bounds, so both packages
    apply one polynomial."""
    if pre_spec == "amg":
        return tts.default_pre_builder("heat")(s)
    builder, kw = pre_spec
    if builder == "chebyshev":
        return tprecond.chebyshev(s.A, lmin=rec["lmin"], lmax=rec["lmax"], **kw)
    return getattr(tprecond, builder)(s.A, **kw)


@pytest.mark.parametrize("pre", ["amg", "cheb8", "neu4", "jacobi"])
def test_cgmres_many_heat_matches_record(pre):
    name = f"heat_M32_{pre}_B3"
    rec = REF.load(name)[name]
    problem, params, B, k, tol, pre_spec, _ = REF.BATCHED[name]
    s = theat.linforms(device="cpu", **params)
    states = REF.batch_states(name, s.z0.numpy())
    items = [s.step_update(torch.as_tensor(z)) for z in states]
    assert len(items) == B
    for t, targets in zip(items, rec["targets"]):
        np.testing.assert_allclose([float(c.c) for c in t.constraints()],
                                   targets, rtol=1e-12, atol=1e-15)
    p = _port_pre(pre_spec, s, rec)
    X, info = cgmres_many(s.A, torch.stack([t.b for t in items]),
                          [t.constraints() for t in items], k=k, tol=tol,
                          pre=p)
    assert list(map(int, info["steps"])) == rec["steps"]
    assert list(map(int, info["safety"])) == rec["safety"]
    np.testing.assert_allclose(X.abs().max(1).values.numpy(), rec["x_max"],
                               rtol=1e-8)
    np.testing.assert_allclose(X.sum(1).numpy(), rec["x_sum"], rtol=1e-8)
    for i, t in enumerate(items):
        x, it = tcgmres.cgmres(t.A, t.b, k=k, tol=tol, pre=p,
                               constraints=t.constraints(), loop="while")
        assert it["steps"] == info["steps"][i] and int(it["safety"]) == \
            info["safety"][i]
        assert torch_parity.rel_max(X[i].numpy(), x.numpy()) <= 1e-10
        if rec["safety"][i] == 1 and rec["true_residual"][i] < tol:
            assert info["deviation"][i] <= 1e-10
            assert float(torch.linalg.norm(t.A @ X[i] - t.b)) < tol


@pytest.fixture(scope="module")
def heat16():
    """heat M=16 in both packages, the JAX AMG and its port, and a block of
    3 vectors as the rows of a (3, n + 1) block (rows n + 1 apart)."""
    js = jheat.linforms(M=16)
    ps = torch_parity.to_port(js)
    jamg = jprecond.amg(js.A, grid=(17, 17))
    pamg = interop.amg_hierarchy(**torch_parity.export_amg(jamg), device="cpu")
    n = js.b.shape[0]
    V = np.random.default_rng(5).standard_normal((3, n + 1))[:, :n]
    return js, ps, jamg, pamg, V


def test_block_vcycle_matches_columns_and_jax_vmap(heat16):
    js, ps, jamg, pamg, V = heat16
    X = torch.as_tensor(V).T  # rows n + 1 apart
    Y = pamg(X)
    assert Y.shape == X.shape
    for b in range(X.shape[1]):
        # the coarse solve is one matrix product for the block, a
        # matrix-vector product for one vector: the same sums, in another
        # order
        torch_parity.close(Y[:, b].numpy(),
                           pamg(X[:, b].contiguous()).numpy(), 1e-14)
    ref = jax.vmap(jprecond.as_preconditioner(jamg))(jnp.asarray(V))
    torch_parity.close(Y.T.numpy(), np.asarray(ref), RTOL)
    # the transfers on a block: the box repeat and the box sum per column
    L = pamg.levels[0]
    E = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (L.P.Cc1 * L.P.Cc2, 3)))
    PE, RX = L.P @ E, L.R @ X
    for b in range(3):
        assert torch.equal(PE[:, b], L.P @ E[:, b].contiguous())
        assert torch.equal(RX[:, b], L.R @ X[:, b].contiguous())


def test_block_twins_match_columns_and_jax_vmap(heat16):
    js, ps, _, _, V = heat16
    X = torch.as_tensor(V).T  # rows n + 1 apart
    S = ps.A
    ops = (S.const, S.offsets, S.wrap, S.grid_c, S.strips)
    jcheb = jprecond.chebyshev(js.A, degree=8)
    jneu = jprecond.neumann(js.A, degree=4)
    theta = 0.5 * (float(jcheb.lmax) + float(jcheb.lmin))
    delta = 0.5 * (float(jcheb.lmax) - float(jcheb.lmin))
    dinv = torch.as_tensor(np.array(jneu.dinv))
    twins = {
        "stencil": (lambda v: tks.stencil_spmm_torch(*ops, v),
                    lambda v: tks.stencil_spmv_torch(*ops, v),
                    lambda v: js.A @ v),
        "cheb8": (lambda v: tpa.cheb_apply(S, 8, theta, delta, theta / delta,
                                           v),
                  lambda v: tpa.cheb_apply_torch(S, 8, theta, delta,
                                                 theta / delta, v),
                  jcheb),
        "neu4": (lambda v: tpa.neumann_apply(S, dinv, 4, float(jneu.omega), v),
                 lambda v: tpa.neumann_apply_torch(S, dinv, 4,
                                                   float(jneu.omega), v),
                 jneu),
    }
    for name, (block, single, jfn) in twins.items():
        Y = block(X)
        assert Y.shape == X.shape, name
        for b in range(X.shape[1]):
            assert torch.equal(Y[:, b], single(X[:, b].contiguous())), name
        ref = jax.vmap(jfn)(jnp.asarray(V))
        torch_parity.close(Y.T.numpy(), np.asarray(ref), RTOL)
    assert torch.equal(S @ X, twins["stencil"][0](X))
