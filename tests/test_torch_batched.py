"""The port's batched solve (``experiments/batched.py``: ``batch_constraints``
and ``cgmres_many`` on the batched device core) against the JAX package's,
on the CPU in f64, where the core runs its steps eagerly and every DIA
product with a block takes the batched kernel's plain twin (on the card the
steps are CUDA graphs and the products the kernel,
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).

* ``batch_constraints`` on the lkdv items of
  ``tests/test_experiments.py::test_vmapped_batched_cgmres``: the same
  fields shared and stacked as the JAX one's, with the same values.
* ``cgmres_many`` on that test's batch (lkdv M=50, degree 1, k=20,
  tol=1e-8) and on a swe M=32 batch with the skew-normal Chebyshev whose
  items stop at different steps (4, 5, 5, 5 in the JAX package), against
  the JAX ``cgmres_many`` on the same items; and the JAX runs against the
  committed record ``reference/slice9.json``, which ``chip_smoke.py``
  holds the card to at M=512.
* The batched core against the port's single ``cgmres(loop="while")``,
  item by item; a solve that is done stays bit-equal while the others go
  on; every step reads nothing on the host.
* The plain twin of the batched DIA kernel against the JAX ``dia_spmm``.
* What the batched core refuses.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch import precond as tprecond
from structurepreservingiterativesolvers_torch.constraints.general import (
    GeneralConstraint,
)
from structurepreservingiterativesolvers_torch.constraints.quadratic import (
    QuadraticConstraint,
)
from structurepreservingiterativesolvers_torch.experiments.batched import (
    batch_constraints,
    cgmres_many,
)
from structurepreservingiterativesolvers_torch.kernels.dia_spmv import (
    dia_spmm_torch,
)
from structurepreservingiterativesolvers_torch.ops import sparse as tsparse
from structurepreservingiterativesolvers_torch.ops.sparse import DIA
from structurepreservingiterativesolvers_torch.solvers.graphs import GraphRunner
from structurepreservingiterativesolvers_tpu import precond as jprecond
from structurepreservingiterativesolvers_tpu.experiments import batched as jbatched
from structurepreservingiterativesolvers_tpu.models import heat as jheat
from structurepreservingiterativesolvers_tpu.models import lkdv as jlkdv
from structurepreservingiterativesolvers_tpu.models import lkdvrk as jlkdvrk
from structurepreservingiterativesolvers_tpu.models import swe as jswe
from structurepreservingiterativesolvers_tpu.ops import sparse as jsparse

# the module (the solvers package exports a function of the same name)
tcgmres = importlib.import_module(
    "structurepreservingiterativesolvers_torch.solvers.cgmres")

REF = torch_parity.reference_script()


def _batch(name):
    """The JAX system, its port twin, the items of ``BATCHED[name]`` in
    both packages, and the preconditioners (the port's with the JAX one's
    bounds and degree, so both apply one polynomial)."""
    problem, params, _, k, tol, pre_spec, _ = REF.BATCHED[name]
    js = {"lkdv": jlkdv, "swe": jswe}[problem].linforms(**params)
    ps = torch_parity.to_port(js)
    states = REF.batch_states(name, np.asarray(js.z0))
    jitems = [js.step_update(jnp.asarray(z)) for z in states]
    pitems = [ps.step_update(torch.as_tensor(z)) for z in states]
    jpre = ppre = None
    if pre_spec == "snc":
        jpre = jprecond.skew_normal_chebyshev(js.A, a=1.0 / js.prob.dt)
        ppre = tprecond.SkewNormalChebyshev(
            A=ps.A, a=float(jpre.a), lmin=float(jpre.lmin),
            lmax=float(jpre.lmax), degree=int(jpre.degree))
    return js, ps, jitems, pitems, jpre, ppre, k, tol


def _many(ps, pitems, ppre, k, tol):
    return cgmres_many(ps.A, torch.stack([t.b for t in pitems]),
                       [t.constraints() for t in pitems], k=k, tol=tol,
                       pre=ppre)


def _check_jax_against_record(name, X, info):
    """The JAX package's run of ``BATCHED[name]`` against its entry of
    ``reference/slice9.json``: the record is current."""
    rec = REF.load(name)[name]
    assert list(map(int, info["steps"])) == rec["steps"]
    assert list(map(int, info["safety"])) == rec["safety"]
    X = np.asarray(X)
    np.testing.assert_allclose(np.abs(X).max(1), rec["x_max"], rtol=1e-12)
    np.testing.assert_allclose(X.sum(1), rec["x_sum"], rtol=1e-12)


def test_batch_constraints_matches_jax():
    js, ps, jitems, pitems, *_ = _batch("lkdv_M50_B3")
    jcons, jaxes = jbatched.batch_constraints([t.constraints() for t in jitems])
    pcons, paxes = batch_constraints([t.constraints() for t in pitems])
    assert len(pcons) == len(jcons) == 3
    for jc, ja, pc, pa in zip(jcons, jaxes, pcons, paxes):
        assert pc.name == jc.name and (pc.M is None) == (jc.M is None)
        for field in ("v", "c"):
            assert getattr(pa, field) == getattr(ja, field), (pc.name, field)
            jv, pv = getattr(jc, field), getattr(pc, field)
            assert (pv is None) == (jv is None)
            if pv is not None:
                assert pv.shape == tuple(jv.shape)
                torch_parity.close(pv.numpy(), np.asarray(jv), 1e-14)
    # the targets vary with the items, the mass weights do not
    assert [a.c for a in paxes] == [0, 0, 0] and paxes[0].v is None


def test_cgmres_many_lkdv_matches_jax():
    """The batch of the JAX package's own test, held to its tolerance."""
    js, ps, jitems, pitems, _, _, k, tol = _batch("lkdv_M50_B3")
    Xj, ij = jbatched.cgmres_many(
        js.A, jnp.stack([t.b for t in jitems]),
        constraints_list=[t.constraints() for t in jitems], k=k, tol=tol)
    _check_jax_against_record("lkdv_M50_B3", Xj, ij)
    Xp, ip = _many(ps, pitems, None, k, tol)
    assert Xp.shape == (3, ps.b.shape[0])
    np.testing.assert_array_equal(ip["steps"], ij["steps"])
    np.testing.assert_array_equal(ip["safety"], ij["safety"])
    assert list(ip["safety"]) == [1, 1, 1]
    np.testing.assert_allclose(Xp.numpy(), np.asarray(Xj), rtol=1e-8,
                               atol=1e-11)


def test_cgmres_many_swe_snc_matches_jax():
    """Items that stop at different steps: the lockstep core masks each
    out once it is done, as the JAX package's vmapped loop does."""
    js, ps, jitems, pitems, jpre, ppre, k, tol = _batch("swe_M32_snc_B4")
    Xj, ij = jbatched.cgmres_many(
        js.A, jnp.stack([t.b for t in jitems]),
        constraints_list=[t.constraints() for t in jitems], k=k, tol=tol,
        pre=jpre)
    _check_jax_against_record("swe_M32_snc_B4", Xj, ij)
    assert list(ij["steps"]) == [4, 5, 5, 5]
    Xp, ip = _many(ps, pitems, ppre, k, tol)
    np.testing.assert_array_equal(ip["steps"], ij["steps"])
    np.testing.assert_array_equal(ip["safety"], ij["safety"])
    rj = np.asarray(ij["res"])
    finite = np.isfinite(rj)
    np.testing.assert_array_equal(np.isfinite(ip["res"]), finite)
    for i in range(4):
        torch_parity.close(ip["res"][i][finite[i]], rj[i][finite[i]], 1e-10)
    torch_parity.close(Xp.numpy(), np.asarray(Xj), 1e-10)
    assert np.all(ip["deviation"] <= 1e-10)


class _Snapshots(GraphRunner):
    """An eager runner that keeps a copy of the core's results for each
    solve right after the step that finished it."""

    def __init__(self):
        super().__init__("cpu", capture=False)
        self.core, self.at_done = None, {}

    def run(self, key, fn):
        fn()
        if self.core is not None and key[0] in ("advance", "kkt_finish"):
            res = self.core.result()
            for i, d in enumerate(self.core.done.tolist()):
                if d and i not in self.at_done:
                    self.at_done[i] = [t[i].clone() for t in res]


def test_batched_core_matches_single_solves():
    """Each item of the batched core against the port's single device core
    (``cgmres(loop="while")``) within 1e-12; an item that is done is left
    bit for bit while the others take their last steps."""
    _, ps, _, pitems, _, ppre, k, tol = _batch("swe_M32_snc_B4")
    Bs = torch.stack([t.b for t in pitems])
    cons, _ = batch_constraints([t.constraints() for t in pitems])
    runner = _Snapshots()
    core = tcgmres.DeviceCore(ps.A, ppre, k, cons, like=Bs, tol=tol,
                              x0_zero=True, runner=runner)
    runner.core = core
    core.load(Bs, None, cons)
    core.solve()
    out = core.result()
    assert out.steps.tolist() == [4, 5, 5, 5]
    for i, t in enumerate(pitems):
        x1, i1 = tcgmres.cgmres(t.A, t.b, k=k, tol=tol, pre=ppre,
                                constraints=t.constraints(), loop="while")
        assert i1["steps"] == int(out.steps[i])
        assert i1["safety"] is True and int(out.safety[i]) == 1
        torch_parity.close(out.x[i].numpy(), x1.numpy(), 1e-12)
        for a, b in zip(runner.at_done[i], out):
            assert torch.equal(a, b[i])
    # x0 given: the same answers, the core built anew for it
    X, info = cgmres_many(ps.A, Bs, [t.constraints() for t in pitems],
                          X0s=torch.zeros_like(Bs), k=k, tol=tol, pre=ppre)
    assert list(info["steps"]) == [4, 5, 5, 5]
    torch_parity.close(X.numpy(), out.x.numpy(), 1e-12)


def _operators():
    """DIA operators of the three models at small sizes, wrapped and
    zero-filled: swe's A, heat's mass matrix and lkdvRK (3, 2)'s A."""
    swe = jswe.linforms(M=8).A
    heat = jheat.linforms(M=8).Mmat
    rk = jlkdvrk.linforms(M=10, N=10, degree=3, tstages=2).A
    ops = {"swe_A": swe, "heat_Mmat": heat, "lkdvrk_A": rk}
    assert swe.wrap and rk.wrap and not heat.wrap
    ops["swe_A_zero_filled"] = dataclasses.replace(swe, wrap=False)
    return ops


def test_dia_spmm_twin_matches_jax(monkeypatch):
    """The batched kernel's plain twin, ``A @ X`` on the CPU (on a block and
    on the (n, B) view of a (B, n) block, as the batched core passes it),
    and ``_DiaProduct.vmap`` (a ``torch.func.vmap`` of ``A @ x``) against
    the JAX ``dia_spmm`` on the same operators and block, B = 1, 3, 8.
    Under ``torch.func`` (a general constraint's Hessian) no transform's
    wrapper reaches the products that run as kernels on the card."""
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    seen = []

    def leaf(fn):
        def product(data, offsets, wrap, x):
            seen.append(wrapped(x))
            return fn(data, offsets, wrap, x)
        return product

    monkeypatch.setattr(tsparse, "_dia_spmv", leaf(tsparse._dia_spmv))
    monkeypatch.setattr(tsparse, "dia_spmm_torch",
                        leaf(tsparse.dia_spmm_torch))
    rng = np.random.default_rng(0)
    for label, jA in _operators().items():
        assert isinstance(jA, jsparse.DIA), label
        n = jA.shape[0]
        A = DIA(torch.as_tensor(np.array(jA.data)), tuple(jA.offsets),
                tuple(jA.shape), bool(jA.wrap))
        spmm = jax.jit(jsparse.dia_spmm)
        for B in (1, 3, 8):
            X = rng.standard_normal((n, B))
            ref = np.asarray(spmm(jA, jnp.asarray(X)))
            Xt = torch.as_tensor(X)
            for got in (dia_spmm_torch(A.data, A.offsets, A.wrap, Xt),
                        A @ Xt, A @ Xt.T.contiguous().T,
                        torch.func.vmap(lambda x: A @ x)(Xt.T).T):
                assert got.shape == (n, B)
                torch_parity.close(got.numpy(), ref, 1e-14)
    x0 = torch.as_tensor(rng.standard_normal(n))
    hess = torch.func.hessian(lambda x: 0.5 * torch.dot(x, A @ x))(x0)
    dense = A.todense()
    torch_parity.close(hess.numpy(), (0.5 * (dense + dense.T)).numpy(), 1e-14)
    jac = torch.func.jacrev(lambda X: A @ X)(torch.as_tensor(X))
    torch_parity.close(jac.sum((1, 3)).numpy(), (B * dense).numpy(), 1e-14)
    assert seen and not any(seen)


def test_batched_core_step_reads_nothing_on_the_host():
    """Every step of the batched core runs on ``meta`` tensors, which hold
    no values: a host read there raises."""
    B, n, k = 3, 40, 6
    meta = dict(dtype=torch.float64, device="meta")
    A = torch.empty((n, n), **meta)
    Bs = torch.empty((B, n), **meta)
    cons = [QuadraticConstraint(M=None, v=torch.empty((B, n), **meta),
                                c=torch.empty(B, **meta)),
            QuadraticConstraint(M=A, v=None, c=torch.empty(B, **meta))]
    core = tcgmres.DeviceCore(A, None, k, cons, like=Bs, tol=1e-8,
                              runner=GraphRunner("meta", capture=False))
    core.load(Bs, torch.empty((B, n), **meta), cons)
    core._init()
    for j in (0, 3):
        core._catchup(j)
        core._arnoldi(j)
        core._advance(j)
        core._kkt_start(j)
        core._kkt_step(j)
        core._kkt_refactor(j)
        core._kkt_finish(j)
        core._finish0(j)
    assert core.x.shape == (B, n) and core.flags.shape == (2 * B,)
    assert core.x.device.type == "meta"


def test_refusals():
    _, ps, _, pitems, _, _, k, tol = _batch("swe_M32_snc_B4")
    Bs = torch.stack([t.b for t in pitems])
    cons = [t.constraints() for t in pitems]
    kw = dict(k=k, tol=tol)
    # a storage dtype other than f64 and f32 (f32 storage, mixed, runs:
    # tests/test_torch_f32_core.py)
    with pytest.raises(NotImplementedError):
        cgmres_many(ps.A, Bs.half(), cons, **kw)
    # heat's and lkdvRK's preconditioners run under a batch
    # (tests/test_torch_heat_batched.py, tests/test_torch_lkdvrk_batched.py);
    # one that does not apply to a block is refused, inside a composite too
    for pre in (lambda v: v, tprecond.neumann_composite(ps.A, lambda v: v, 2)):
        with pytest.raises(NotImplementedError, match="batched core takes"):
            cgmres_many(ps.A, Bs, cons, pre=pre, **kw)
    # a general constraint, as the JAX package's cgmres_many refuses it
    general = [[GeneralConstraint(func=lambda x: x.sum(), name="sum")]
               for _ in pitems]
    with pytest.raises(NotImplementedError, match="cgmres_many"):
        cgmres_many(ps.A, Bs, general, **kw)
    with pytest.raises(NotImplementedError):
        tcgmres.DeviceCore(ps.A, None, k, cons[0], like=Bs, tol=tol,
                           ortho="cgs2_fused")
    varying = [[dataclasses.replace(c[1], M=dataclasses.replace(
        c[1].M, scales=tuple(s * (1 + i) for s in c[1].M.scales)))]
        for i, c in enumerate(cons)]
    with pytest.raises(ValueError):
        batch_constraints(varying)
