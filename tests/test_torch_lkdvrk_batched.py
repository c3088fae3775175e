"""The port's batched solve on lkdvRK (``experiments/batched.py::
cgmres_many``) with the RAS + Neumann composite and with RAS alone, and the
block applies of ``RAS``, ``BlockJacobi`` and ``NeumannComposite`` on an
(n, B) block, in f64 on the CPU.

* ``cgmres_many`` at lkdvRK M=20, (3, 2), B = 3 (item i the system stepped
  by ``lkdvrk_stage_states``: u1 = u0 + 0.02 i·p) against the JAX record
  (``reference/slice12.json``): every item certified, in at most the
  record's steps (the port's device core pins the stage-mapped mass, which
  every Krylov vector keeps, where the JAX package's KKT matrix is
  singular: ``solvers/kkt.py::kkt_start``), its true residual below tol;
  and against each item's single device-core solve: the same steps and
  latch, x within 1e-10 of max|x|.
* The block applies against their columns (1e-13 relative) and against the
  JAX apply under ``jax.vmap`` on the JAX package's own preconditioner.
* ``batch_constraints`` shares the stage-mapped M (one ``StageKron``) and
  stacks v and c; a general constraint under a batch is refused, as the
  JAX ``cgmres_many`` builds its core for quadratic constraints only.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch import interop
from structurepreservingiterativesolvers_torch.constraints import GeneralConstraint
from structurepreservingiterativesolvers_torch.experiments.batched import (
    batch_constraints,
    cgmres_many,
)
from structurepreservingiterativesolvers_torch.models import lkdvrk
from structurepreservingiterativesolvers_torch.precond.chebyshev import (
    neumann_composite,
)
from structurepreservingiterativesolvers_tpu.models import lkdvrk as jlkdvrk

# the module (the experiments package exports a function of the same name,
# as the JAX package's does)
tts = importlib.import_module(
    "structurepreservingiterativesolvers_torch.experiments.timed_solve")

# the modules (their packages export functions of the same names)
tcgmres = importlib.import_module(
    "structurepreservingiterativesolvers_torch.solvers.cgmres")
jts = importlib.import_module(
    "structurepreservingiterativesolvers_tpu.experiments.timed_solve")
REC = torch_parity.slice12()
SCRIPT = torch_parity.reference_script()


def _batch(name):
    """The port's system, its items and the record's preconditioner."""
    rec = REC[name]
    cfg = rec["config"]
    s = lkdvrk.linforms(device="cpu", **cfg["params"])
    pre = tts.default_pre_builder("lkdvrk")(s)
    if cfg["pre"] == "ras":
        pre = pre.inner
    p = SCRIPT.lkdvrk_field(s.fem, s.prob.mlength, s.z0[:s.n0].numpy())
    states = SCRIPT.lkdvrk_stage_states(p, cfg["batch"], s.prob.ns, s.n0,
                                        s.prob.dt)
    items = [s.step_update(torch.as_tensor(z)) for z in states]
    return rec, s, pre, items


@pytest.mark.parametrize("name", ["lkdvrk_M20_B3", "lkdvrk_M20_ras_B3"])
def test_cgmres_many_matches_record_and_single_solves(name):
    rec, s, pre, items = _batch(name)
    k, tol = rec["config"]["k"], rec["config"]["tol"]
    cons = [t.constraints() for t in items]
    # the stage-mapped targets are cancellations, 0 to roundoff
    np.testing.assert_allclose([[float(c.c) for c in cs] for cs in cons],
                               rec["targets"], rtol=0, atol=1e-12)
    X, info = cgmres_many(s.A, torch.stack([t.b for t in items]), cons,
                          k=k, tol=tol, pre=pre)
    assert np.all(info["safety"] == 1) and np.all(info["deviation"] <= 1e-10)
    assert np.all(info["steps"] <= np.asarray(rec["steps"]))
    for i, t in enumerate(items):
        assert float(torch.linalg.norm(t.A @ X[i] - t.b)) < tol
        torch_parity.close(X[i].numpy(), rec["x"][i], 1e-6)
        x1, i1 = tcgmres.cgmres(t.A, t.b, k=k, tol=tol, pre=pre,
                                constraints=cons[i], loop="while")
        assert int(info["steps"][i]) == i1["steps"] and i1["safety"] is True
        torch_parity.close(X[i].numpy(), x1.numpy(), 1e-10)


@pytest.fixture(scope="module")
def twins():
    """The JAX system of the records, the port's twin, and each package's
    composite, its RAS and a block Jacobi (two elements a block), the
    port's built from the JAX package's index blocks and inverses."""
    params = REC["lkdvrk_M20_B3"]["config"]["params"]
    js = jlkdvrk.linforms(**params)
    ps = torch_parity.to_port(js)
    jcomp = jts.default_pre_builder("lkdvrk")(js)
    jbj = jlkdvrk.element_block_preconditioner(js, 2, 0)
    ras = interop.ras_from_arrays(np.asarray(jcomp.inner.idx),
                                  np.asarray(jcomp.inner.inv),
                                  np.asarray(jcomp.inner.own), device="cpu")
    bj = interop.block_jacobi_from_arrays(np.asarray(jbj.idx),
                                          np.asarray(jbj.inv), device="cpu")
    port = {"RAS": ras, "BlockJacobi": bj,
            "NeumannComposite": neumann_composite(ps.A, ras, jcomp.degree)}
    jax_pre = {"RAS": jcomp.inner, "BlockJacobi": jbj,
               "NeumannComposite": jcomp}
    return ps, port, jax_pre


@pytest.mark.parametrize("kind", ["RAS", "BlockJacobi", "NeumannComposite"])
def test_block_apply_matches_columns_and_jax_vmap(twins, kind):
    """On the (n, B) view of a (B, n) block, as the batched core hands it
    over, and in that layout."""
    ps, port, jax_pre = twins
    B, n = 4, ps.b.shape[0]
    rows = torch.as_tensor(np.random.default_rng(5).standard_normal((B, n)))
    X = rows.T
    Y = port[kind](X)
    assert Y.shape == (n, B) and Y.stride(0) == 1
    cols = torch.stack([port[kind](rows[b]) for b in range(B)], 1)
    torch_parity.close(Y.numpy(), cols.numpy(), 1e-13)
    ref = jax.vmap(jax_pre[kind], in_axes=1, out_axes=1)(jnp.asarray(X.numpy()))
    torch_parity.close(Y.numpy(), np.asarray(ref), 1e-12)


def test_batch_constraints_and_refusals():
    _, s, _, items = _batch("lkdvrk_M20_B3")
    cons = [t.constraints() for t in items]
    batched, axes = batch_constraints(cons)
    for bc, ax, col in zip(batched, axes, zip(*cons)):
        if col[0].M is not None:
            # the stage-mapped M of every item: one StageKron, shared by
            # value (each item's is a new object on the one weights tensor)
            assert bc.M is col[0].M and ax.M is None
            assert all(c.M.b is s.bw for c in col)
            # its v = Pᵀ M z0 is each item's own, stacked
            assert ax.v == 0 and bc.v.shape == (len(items), s.b.shape[0])
        else:  # the mass: the same v for every item, shared
            assert ax.v is None and bc.v.shape == (s.b.shape[0],)
    general = [[*c[:2], GeneralConstraint(func=lambda x: x.sum(), name="g")]
               for c in cons]
    with pytest.raises(NotImplementedError, match="cgmres_many"):
        cgmres_many(s.A, torch.stack([t.b for t in items]), general, k=5)
    like = torch.stack([t.b for t in items])
    with pytest.raises(NotImplementedError, match="cgmres_many"):
        tcgmres.DeviceCore(s.A, None, 5, cons[0], like=like, tol=1e-8,
                           history=True)
