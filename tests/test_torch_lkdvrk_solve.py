"""The lkdvRK preconditioners and solves of the PyTorch port against the JAX
package, in f64 on the CPU, at M=50, degree 3, 2 stages (n = 1,200): the
block Jacobi, RAS and Neumann-composite applies (the inverses carried
across by ``interop``), the TimedSolve pre-builder, GMRES and CGMRES with
the composite, and the ILU parity bar of ``tests/test_ilu_parity.py``
with scipy's ``spilu`` as the oracle.

Tolerances: the applies sum the same products in another order (1e-12
relative); the solves give steps and constrained steps within one, the same
safety, a KKT deviation of at most 1e-10 and iterates within 1e-8
relative.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import torch_parity
from structurepreservingiterativesolvers_torch import interop
from structurepreservingiterativesolvers_torch import precond as tpre
from structurepreservingiterativesolvers_torch import solvers as tsol
from structurepreservingiterativesolvers_torch.models import lkdvrk as tlkdvrk
from structurepreservingiterativesolvers_tpu import precond as jpre
from structurepreservingiterativesolvers_tpu import solvers as jsol
from structurepreservingiterativesolvers_tpu.experiments.timed_solve import (
    default_pre_builder as j_pre_builder,
)
from structurepreservingiterativesolvers_tpu.models import lkdvrk as jlkdvrk
from structurepreservingiterativesolvers_tpu.precond.base import (
    apply_preconditioner as j_apply,
)

# the module (the experiments package exports a function of the same name,
# as the JAX package's does)
tts = importlib.import_module(
    "structurepreservingiterativesolvers_torch.experiments.timed_solve")

PARAMS = dict(N=10, M=50, degree=3, tstages=2)
K, TOL = 60, 1e-8  # tests/test_ilu_parity.py's solves
close = torch_parity.close


@pytest.fixture(scope="module")
def systems():
    js = jlkdvrk.linforms(**PARAMS)
    return js, torch_parity.to_port(js), j_pre_builder("lkdvrk")(js)


def test_block_preconditioners_match_jax(systems):
    js, ts, jp = systems
    v = np.random.default_rng(2).standard_normal(ts.b.shape[0])
    vj, vt = jnp.asarray(v), torch.as_tensor(v)
    bj = jlkdvrk.element_block_preconditioner(js, elems_per_block=5)
    bt = interop.block_jacobi_from_arrays(np.asarray(bj.idx), np.asarray(bj.inv),
                                          device="cpu")
    close(bt(vt).numpy(), np.asarray(bj(vj)), 1e-12)
    rt = interop.ras_from_arrays(np.asarray(jp.inner.idx),
                                 np.asarray(jp.inner.inv),
                                 np.asarray(jp.inner.own), device="cpu")
    close(rt(vt).numpy(), np.asarray(jp.inner(vj)), 1e-12)
    ct = tpre.neumann_composite(ts.A, rt, degree=jp.degree)
    close(ct(vt).numpy(), np.asarray(jp(vj)), 1e-12)
    close(tpre.apply_preconditioner(ct, vt).numpy(),
          np.asarray(j_apply(jp, vj)), 1e-12)


def test_pre_builder_matches_jax(systems):
    """The port builds the same blocks, masks and host inverses as the JAX
    package; lkdv has no preconditioner in either."""
    js, ts, jp = systems
    tp = tts.default_pre_builder("lkdvrk")(ts)
    assert isinstance(tp, tpre.NeumannComposite) and tp.degree == jp.degree == 3
    assert isinstance(tp.inner, tpre.RAS)
    assert tuple(tp.inner.idx.shape) == tuple(jp.inner.idx.shape) == (5, 336)
    np.testing.assert_array_equal(tp.inner.idx.numpy(), np.asarray(jp.inner.idx))
    np.testing.assert_array_equal(tp.inner.own.numpy(), np.asarray(jp.inner.own))
    close(tp.inner.inv.numpy(), np.asarray(jp.inner.inv), 1e-13)
    bt = tlkdvrk.element_block_preconditioner(ts, elems_per_block=5)
    assert isinstance(bt, tpre.BlockJacobi) and tuple(bt.idx.shape) == (10, 120)
    # block Jacobi over contiguous index blocks, in both packages
    bj = jpre.block_jacobi(js.A_csr, jpre.contiguous_blocks(1200, 240))
    bc = tpre.block_jacobi(ts.A_csr, tpre.contiguous_blocks(1200, 240),
                           device="cpu")
    np.testing.assert_array_equal(bc.idx.numpy(), np.asarray(bj.idx))
    close(bc.inv.numpy(), np.asarray(bj.inv), 1e-13)
    assert tts.default_pre_builder("lkdv")(ts) is None
    assert j_pre_builder("lkdv")(js) is None


def test_solvers_with_the_composite_match_jax(systems):
    js, ts, jp = systems
    tp = tts.default_pre_builder("lkdvrk")(ts)
    cons_j, cons_t = js.constraints(), ts.constraints()
    for name in ("gmres", "cgmres"):
        kw = dict(k=K, tol=TOL)
        if name == "cgmres":
            xj, ij = jsol.cgmres(js.A, js.b, constraints=cons_j, pre=jp, **kw)
            xt, it = tsol.cgmres(ts.A, ts.b, constraints=cons_t, pre=tp, **kw)
            assert abs(it["constrained_steps"] - ij["constrained_steps"]) <= 1
            assert it["safety"] is ij["safety"] is True
            assert it["deviation"] <= 1e-10
        else:
            xj, ij = jsol.gmres(js.A, js.b, pre=jp, **kw)
            xt, it = tsol.gmres(ts.A, ts.b, pre=tp, **kw)
        assert abs(it["steps"] - ij["steps"]) <= 1
        close(xt.numpy(), np.asarray(xj), 1e-8)


@pytest.mark.parametrize("M", [50, 100])
def test_ras_neumann_matches_ilu(M):
    """The RAS + Neumann(3) composite against the reference's
    ``spilu(A, drop_tol=1e-4, fill_factor=10)`` (lkdvRK/Evolve.py:51-52):
    at most 1.5 × its GMRES steps, and CGMRES certifies with it."""
    s = tlkdvrk.linforms(M=M, degree=3, tstages=2, device="cpu")
    ilu = spla.spilu(s.A_csr.tocsc(), drop_tol=1e-4, fill_factor=10)

    def ilu_pre(v):
        return torch.as_tensor(ilu.solve(v.numpy()))

    def steps(pre):
        _, info = tsol.gmres(s.A, s.b, k=K, tol=TOL, pre=pre)
        assert info["res"][-1] < TOL
        return info["steps"]

    inner = tlkdvrk.element_block_preconditioner(
        s, elems_per_block=M // 5, overlap=2 * (M // 50))
    ours = tpre.neumann_composite(s.A, inner, degree=3)
    assert steps(ours) <= math.ceil(1.5 * steps(ilu_pre))
    _, info = tsol.cgmres(s.A, s.b, k=K, tol=TOL, pre=ours,
                          constraints=s.constraints())
    assert info["safety"] is True and info["deviation"] < 1e-10
