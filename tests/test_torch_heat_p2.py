"""heat P2 (degree 2: n = (2M+1)², the operator and the constraint matrices
ELL of width 19) with the greedy host AMG, on the CPU in f64, against the
JAX package's record ``reference/slice13.json`` (the JAX ``time_cgmres``
with ``amg(s.A_csr, dtype=np.float64)`` and the JAX ``cgmres_many``):

* ``time_cgmres`` at M=16 and 32 on both loops with the port's default
  heat pre-builder, which builds the greedy hierarchy on an ELL operator:
  the hierarchy's levels and formats equal to the record's, GMRES's and
  CGMRES's steps and CGMRES's constrained steps within one of the
  record's (the zero start pins no constraint), the latch equal, the mass
  and energy deviations of CGMRES at most 1e-10;
* the two loops on one system and preconditioner: the same steps and
  latch, x within 1e-10;
* the default pre-builder's hierarchy against the JAX ``amg(s.A_csr)``;
  the JAX package's own default pre-builder raises on P2 (a fault of the
  reference, ROADMAP.md Queue 3);
* ``cgmres_many`` at M=16, B = 3: steps and latch the record's, x's
  max-norm and sum within 1e-10, each item within 1e-10 of its single
  device-core solve;
* the M=16 entry of the record is current.
"""

import importlib

import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch.experiments.batched import (
    cgmres_many,
)
from structurepreservingiterativesolvers_torch.models import heat as theat
from structurepreservingiterativesolvers_torch.ops.sparse import ELL

# the module (the experiments package exports a function of the same name,
# as the JAX package's does)
tts = importlib.import_module(
    "structurepreservingiterativesolvers_torch.experiments.timed_solve")

# the module (the solvers package exports a function of the same name)
tcgmres = importlib.import_module(
    "structurepreservingiterativesolvers_torch.solvers.cgmres")

REF = torch_parity.reference_script()
DEV_MAX = 1e-10


def _levels(pre):
    return [{"n": L.A.shape[0], **torch_parity.operator_format(L.A)}
            for L in pre.levels]


@pytest.mark.parametrize("M", [16, 32])
def test_time_cgmres_on_both_loops_matches_record(M):
    name = f"heat_P2_M{M}"
    rec = REF.load(name)[name]
    for loop in ("host", "while"):
        seen = {}

        def builder(system):
            seen["pre"] = tts.default_pre_builder("heat")(system)
            seen["A"] = system.A
            return seen["pre"]

        row = tts.time_cgmres("heat", M=M, degree=2, k=rec["config"]["k"],
                              tol=rec["config"]["tol"], pre_builder=builder,
                              device="cpu", loop=loop)
        assert torch_parity.operator_format(seen["A"]) == rec["operator"]
        assert _levels(seen["pre"]) == rec["amg_levels"]
        assert abs(row["gmres_steps"] - rec["gmres_steps"]) <= 1
        assert abs(row["steps"] - rec["steps"]) <= 1
        assert abs(row["constrained_steps"] - rec["constrained_steps"]) <= 1
        assert row["safety"] is rec["safety"] is True
        for nm in row["invariant_names"]:
            assert row["conservation"][f"cgmres_{nm}"] <= DEV_MAX
            # GMRES's drift is the record's, well above the certificate
            assert row["conservation"][f"gmres_{nm}"] == pytest.approx(
                rec["conservation"][f"gmres_{nm}"], rel=1e-3)
        assert row["res_final"] < rec["config"]["tol"]


def test_loops_agree():
    s = theat.linforms(M=32, degree=2, device="cpu")
    assert isinstance(s.A, ELL) and isinstance(s.Emat, ELL)
    pre = tts.default_pre_builder("heat")(s)
    kw = dict(k=60, tol=1e-7, pre=pre, constraints=s.constraints())
    xh, ih = tcgmres.cgmres(s.A, s.b, **kw)
    xw, iw = tcgmres.cgmres(s.A, s.b, loop="while", **kw)
    assert (ih["steps"], ih["constrained_steps"], ih["safety"]) == (
        iw["steps"], iw["constrained_steps"], iw["safety"])
    assert iw["safety"] is True and iw["deviation"] <= DEV_MAX
    assert torch_parity.rel_max(xw.numpy(), xh.numpy()) <= 1e-10
    tcgmres.clear_core_cache()


def test_default_pre_builder_is_the_jax_greedy_amg():
    """The port's default heat pre-builder on P2 builds what the JAX
    ``amg(s.A_csr)`` builds; the JAX package's own default pre-builder
    hands the ELL to its structured setup and raises."""
    from structurepreservingiterativesolvers_tpu.models import heat as jheat

    jamg = importlib.import_module(
        "structurepreservingiterativesolvers_tpu.precond.amg")
    jts = importlib.import_module(
        "structurepreservingiterativesolvers_tpu.experiments.timed_solve")
    js = jheat.linforms(M=32, degree=2)
    ts = theat.linforms(M=32, degree=2, device="cpu")
    pj = jamg.amg(js.A_csr, dtype=np.float64)
    pt = tts.default_pre_builder("heat")(ts)
    assert [L.A.shape[0] for L in pt.levels] == [int(L.A.shape[0])
                                                for L in pj.levels]
    for Lt, Lj in zip(pt.levels, pj.levels):
        assert type(Lt.A).__name__ == type(Lj.A).__name__
        torch_parity.close(Lt.dinv.numpy(), np.asarray(Lj.dinv), 1e-12)
    torch_parity.close(pt.coarse_inv.numpy(), np.asarray(pj.coarse_inv),
                       1e-12)
    with pytest.raises(ValueError):
        jts.default_pre_builder("heat")(jheat.linforms(M=8, degree=2))


def test_cgmres_many_matches_record():
    name = "heat_P2_M16_B3"
    rec = REF.load(name)[name]
    problem, params, B, k, tol, _, _ = REF.BATCHED[name]
    s = theat.linforms(device="cpu", **params)
    states = REF.batch_states(name, s.z0.numpy(), fem=s.prob.fem())
    items = [s.step_update(torch.as_tensor(z)) for z in states]
    for t, targets in zip(items, rec["targets"]):
        np.testing.assert_allclose([float(c.c) for c in t.constraints()],
                                   targets, rtol=1e-12, atol=1e-15)
    pre = tts.default_pre_builder("heat")(s)
    assert _levels(pre) == rec["amg_levels"]
    X, info = cgmres_many(s.A, torch.stack([t.b for t in items]),
                          [t.constraints() for t in items], k=k, tol=tol,
                          pre=pre)
    assert list(map(int, info["steps"])) == rec["steps"]
    assert list(map(int, info["safety"])) == rec["safety"] == [1] * B
    assert max(info["deviation"]) <= DEV_MAX
    np.testing.assert_allclose(X.abs().max(1).values.numpy(), rec["x_max"],
                               rtol=1e-10)
    np.testing.assert_allclose(X.sum(1).numpy(), rec["x_sum"], rtol=1e-10)
    for i, t in enumerate(items):
        x, it = tcgmres.cgmres(t.A, t.b, k=k, tol=tol, pre=pre,
                               constraints=t.constraints(), loop="while")
        assert it["steps"] == info["steps"][i]
        assert torch_parity.rel_max(X[i].numpy(), x.numpy()) <= 1e-10
        assert float(torch.linalg.norm(t.A @ X[i] - t.b)) < tol
    tcgmres.clear_core_cache()


def test_reference_record_is_current():
    """Regenerate the heat_P2_M16 entry of the committed JAX record and
    compare: the counts and formats equal, the residuals and GMRES's
    deviations to 1e-6."""
    new = REF.record_p2("heat_P2_M16")
    rec = REF.load("heat_P2_M16")["heat_P2_M16"]
    for key in ("config", "n", "operator", "amg_levels", "gmres_steps",
                "steps", "constrained_steps", "safety"):
        assert new[key] == rec[key], key
    for key in ("res_final", "gmres_res_final"):
        assert new[key] == pytest.approx(rec[key], rel=1e-6)
    for key, val in rec["conservation"].items():
        if key.startswith("gmres"):
            assert new["conservation"][key] == pytest.approx(val, rel=1e-6)
        elif key.startswith("cgmres"):
            assert new["conservation"][key] <= DEV_MAX


def test_ell_block_product_on_rows():
    """``A @ X`` for an ELL and the (n, B) view of a (B, n) block (the
    batched core's operand, and the block V-cycle's) gathers along the
    block's rows and adds each slot in one multiply-add: the product on a
    contiguous (n, B) block to rounding, rows at an odd stride the same
    bits, the result the (n, B) view of a (B, n) block; within 1e-14 of
    the JAX ``ell_spmm``."""
    import jax.numpy as jnp

    from structurepreservingiterativesolvers_torch.ops.sparse import to_scipy
    from structurepreservingiterativesolvers_tpu.ops.sparse import (
        ell_from_scipy as jell,
    )
    from structurepreservingiterativesolvers_tpu.ops.sparse import (
        ell_spmm as jspmm,
    )

    s = theat.linforms(M=16, degree=2, device="cpu")
    pre = tts.default_pre_builder("heat")(s)
    rng = np.random.default_rng(7)
    for op in (s.A, pre.levels[0].P, pre.levels[0].R):
        m = op.shape[1]
        Z = torch.as_tensor(rng.standard_normal((3, m + 1)))[:, 1:]
        Y = op @ Z.T
        assert Y.T.is_contiguous()
        assert torch.equal(Y, op @ Z.contiguous().T)
        torch_parity.close(Y.numpy(), (op @ Z.T.contiguous()).numpy(), 1e-15)
        Yj = np.asarray(jspmm(jell(to_scipy(op)), jnp.asarray(Z.T.numpy())))
        torch_parity.close(Y.numpy(), Yj, 1e-14)
